"""Launcher of the hand-written CUDA geo_score kernel (``csrc/geo_score.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/geo_score/kernel.py::
geo_score_planar``.  Inputs are checked by ``ops.py``; this module passes
pointers, the shape and the current stream to the C entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library, raw_stream

Q_MAX = 8


def geo_score_cuda(
    rects: torch.Tensor,  # f32[B, T, 4] contiguous, CUDA
    amps: torch.Tensor,  # f32[B, T]
    q_rects: torch.Tensor,  # f32[B, Q, 4], Q <= Q_MAX (slots past Q: zero padding)
    q_amps: torch.Tensor,  # f32[B, Q]
) -> torch.Tensor:
    """One launch for the whole batch: f32[B, T].  The host work is one
    allocation, the pointers, the stream and one ``ctypes`` call."""
    B, T = amps.shape
    out = torch.empty_like(amps)
    err = library().geo_score_launch(
        rects.data_ptr(), amps.data_ptr(), q_rects.data_ptr(), q_amps.data_ptr(),
        out.data_ptr(), B, T, q_amps.shape[1], raw_stream(amps.device),
    )
    check_launch("geo_score_launch", err)
    return out
