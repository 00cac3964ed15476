"""Plain PyTorch version of the geo_score kernel (same arithmetic order).

Slot by slot ``acc + (w*h)*qa`` over the ``Q_MAX`` zero-padded query rects,
then ``× amp`` — the kernel's order, so on the card the two agree bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.geo_score.kernel import Q_MAX


def geo_score_toeprints_ref(
    rects: torch.Tensor,  # f32[B, T, 4]
    amps: torch.Tensor,  # f32[B, T]
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4] (zero padded)
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
) -> torch.Tensor:
    """out[b, t] = amp[b, t] · Σ_j area(rect[b, t] ∩ q[b, j]) · q_amp[b, j]."""
    x0, y0, x1, y1 = rects.float().unbind(-1)
    acc = torch.zeros_like(x0)
    for j in range(Q_MAX):
        q = q_rects[:, j, :, None]  # [B, 4, 1] broadcasts over T
        w = torch.clamp(torch.minimum(x1, q[:, 2]) - torch.maximum(x0, q[:, 0]), min=0.0)
        h = torch.clamp(torch.minimum(y1, q[:, 3]) - torch.maximum(y0, q[:, 1]), min=0.0)
        acc = acc + (w * h) * q_amps[:, j, None]
    return acc * amps.float()
