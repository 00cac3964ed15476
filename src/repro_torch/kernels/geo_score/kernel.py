"""Launcher of the hand-written CUDA geo_score kernel (``csrc/geo_score.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/geo_score/kernel.py::
geo_score_planar``.  Inputs are checked by ``ops.py``; this module only
passes pointers and the current stream to the C entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library

Q_MAX = 8


def geo_score_cuda(
    rects: torch.Tensor,  # f32[B, T, 4] contiguous, CUDA
    amps: torch.Tensor,  # f32[B, T]
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4]
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
) -> torch.Tensor:
    """One launch for the whole batch: f32[B, T]."""
    B, T = amps.shape
    out = torch.empty((B, T), dtype=torch.float32, device=rects.device)
    err = library().geo_score_launch(
        rects.data_ptr(), amps.data_ptr(), q_rects.data_ptr(), q_amps.data_ptr(),
        out.data_ptr(), max(T, 1), B * T,
        torch.cuda.current_stream(rects.device).cuda_stream,
    )
    check_launch("geo_score_launch", err)
    return out
