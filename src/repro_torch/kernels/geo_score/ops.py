"""Public wrappers of the geo_score kernel (port of
``repro/kernels/geo_score/ops.py``, with an explicit batch axis).

CUDA tensors go to the hand-written kernel — one launch per batch, the
query read unpadded — and CPU tensors to its plain version over the
zero-padded query; there is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.geo_score.kernel import Q_MAX, geo_score_cuda
from repro_torch.kernels.geo_score.ref import geo_score_toeprints_ref


def pad_query(q_rects: torch.Tensor, q_amps: torch.Tensor):
    """Zero-pad ``[B, Q, 4]`` / ``[B, Q]`` query rects to ``Q_MAX`` slots
    (zero-amp rects contribute exactly nothing)."""
    B, Q = q_amps.shape
    if Q > Q_MAX:
        raise ValueError(f"at most {Q_MAX} query rects per pass, got {Q}")
    qr = torch.zeros((B, Q_MAX, 4), dtype=torch.float32, device=q_rects.device)
    qa = torch.zeros((B, Q_MAX), dtype=torch.float32, device=q_rects.device)
    qr[:, :Q] = q_rects.float()
    qa[:, :Q] = q_amps.float()
    return qr, qa


def geo_score_toeprints(
    rects: torch.Tensor,  # f32[B, T, 4]
    amps: torch.Tensor,  # f32[B, T]
    q_rects: torch.Tensor,  # f32[B, Q, 4], Q <= Q_MAX
    q_amps: torch.Tensor,  # f32[B, Q]
) -> torch.Tensor:
    """Per-toe-print geo scores f32[B, T]; the ``k_sweep`` ``tp_scorer``."""
    dev = rects.device
    B, T = amps.shape
    check_tensor("rects", rects, (torch.float32,), (B, T, 4), dev)
    check_tensor("amps", amps, (torch.float32,), (B, T), dev)
    check_tensor("q_amps", q_amps, (torch.float32,), (B, None), dev)
    check_tensor("q_rects", q_rects, (torch.float32,), (B, q_amps.shape[1], 4), dev)
    if q_amps.shape[1] > Q_MAX:
        raise ValueError(f"at most {Q_MAX} query rects per pass, got {q_amps.shape[1]}")
    if dev.type == "cuda":  # the kernel reads the slots past Q as zero padding
        geo_score_toeprints.launches += 1
        return geo_score_cuda(rects, amps, q_rects, q_amps)
    if dev.type != "cpu":
        raise ValueError(f"geo_score runs on cuda or cpu tensors, got {dev}")
    return geo_score_toeprints_ref(rects, amps, *pad_query(q_rects, q_amps))


geo_score_toeprints.launches = 0


def geo_score_docs(
    doc_rects: torch.Tensor,  # f32[B, C, R, 4]
    doc_amps: torch.Tensor,  # f32[B, C, R]
    q_rects: torch.Tensor,  # f32[B, Q, 4]
    q_amps: torch.Tensor,  # f32[B, Q]
) -> torch.Tensor:
    """Per-document geo scores f32[B, C]: the kernel over the flattened rect
    set, summed per document."""
    B, C, R, _ = doc_rects.shape
    flat = geo_score_toeprints(
        doc_rects.reshape(B, C * R, 4).contiguous(),
        doc_amps.reshape(B, C * R).contiguous(),
        q_rects,
        q_amps,
    )
    return flat.reshape(B, C, R).sum(dim=2)
