"""Public wrappers of the bitmap kernel (port of
``repro/kernels/bitmap_filter/ops.py``).

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback between the two.  No query path calls these:
``conjunction_block_prefilter`` is the block-bitmap conjunction prefilter
over the rows an index builds with ``n_bitmap_terms``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitmap_filter.kernel import (
    bitmap_and_popcount_cuda,
    conjunction_count_cuda,
)
from repro_torch.kernels.bitmap_filter.ref import bitmap_and_popcount_ref
from repro_torch.kernels.build import check_tensor


def _check(bitmaps: torch.Tensor) -> str:
    """Raise unless ``bitmaps`` is a contiguous u32[d ≥ 1, W ≥ 1] tensor
    on the card or the CPU; its device type."""
    dev = bitmaps.device
    check_tensor("bitmaps", bitmaps, (torch.uint32,), (None, None), dev)
    if bitmaps.shape[0] < 1 or bitmaps.shape[1] < 1:
        raise ValueError(f"bitmaps: at least one row and one word are needed, got "
                         f"{tuple(bitmaps.shape)}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"bitmap_and_popcount runs on cuda or cpu tensors, got {dev}")
    return dev.type


def bitmap_and_popcount(bitmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AND the d term bitmaps (u32[d, W]) and popcount each word:
    (anded u32[W], counts i32[W])."""
    if _check(bitmaps) == "cuda":
        bitmap_and_popcount.launches += 1
        return bitmap_and_popcount_cuda(bitmaps)
    return bitmap_and_popcount_ref(bitmaps)


bitmap_and_popcount.launches = 0


def conjunction_block_prefilter(term_bitmaps: torch.Tensor) -> torch.Tensor:
    """Survivor-document count of the conjunction of the gathered rows
    (u32[d, W]): a scalar i64 tensor.  On the card one launch of the
    kernel's count-only mode (counted as a ``bitmap_and_popcount`` launch);
    on the CPU the plain version's ``counts.sum()``."""
    if _check(term_bitmaps) == "cuda":
        bitmap_and_popcount.launches += 1
        return conjunction_count_cuda(term_bitmaps)
    return bitmap_and_popcount_ref(term_bitmaps)[1].sum()
