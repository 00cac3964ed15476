"""Plain PyTorch version of the bitmap kernel.

torch has no popcount and, on the CPU, no shifts of ``uint32``: the rows
are ANDed through an int32 view (the AND is sign-agnostic) and counted with
the SWAR bit trick in int64 — the reference Pallas kernel's own popcount.
"""
from __future__ import annotations

import torch


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (any 32-bit integer dtype), i32."""
    x = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def bitmap_and_popcount_ref(bitmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bitmaps u32[d, W] → (anded u32[W], counts i32[W])."""
    rows = bitmaps.view(torch.int32)
    acc = rows[0].clone()
    for i in range(1, rows.shape[0]):
        acc = acc & rows[i]
    return acc.view(torch.uint32), popcount_u32(acc)
