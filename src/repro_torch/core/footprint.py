"""Geographic footprint scores (port of ``repro/core/footprint.py``).

    g(fD, fq) = Σ_{r∈fD} Σ_{s∈fq} area(r ∩ s) · amp(r) · amp(s)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import geometry
from repro_torch.core.ranking import fma32


@dataclass(frozen=True)
class FootprintBatch:
    """A batch of footprints as padded rect sets.

    rects: f32[..., R, 4]   (padding rows encoded as empty rects)
    amps:  f32[..., R]      (padding rows have amp 0)
    """

    rects: torch.Tensor
    amps: torch.Tensor

    @property
    def max_rects(self) -> int:
        return self.rects.shape[-2]


def make_footprint_np(
    rects: np.ndarray, amps: np.ndarray, max_rects: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a single footprint's (n,4)/(n,) arrays to (max_rects, …): the
    first ``max_rects`` rects kept, the rest of the rows ``EMPTY_RECT`` with
    amp 0."""
    n = min(len(rects), max_rects)
    out_r = np.tile(geometry.EMPTY_RECT, (max_rects, 1)).astype(np.float32)
    out_a = np.zeros((max_rects,), dtype=np.float32)
    out_r[:n] = rects[:n]
    out_a[:n] = amps[:n]
    return out_r, out_a


def geo_score(
    doc_rects: torch.Tensor,  # f32[..., R, 4]
    doc_amps: torch.Tensor,  # f32[..., R]
    query_rects: torch.Tensor,  # f32[..., Q, 4] (leading dims broadcast)
    query_amps: torch.Tensor,  # f32[..., Q]
) -> torch.Tensor:
    """Amplitude-weighted intersection score, f32[...].

    The query's leading dims broadcast against the docs' (the batched port
    passes ``[B, 1, Q, 4]`` against ``[B, C, R, 4]``).  The terms are added
    elementwise, so a doc's score never depends on the shape of the batch
    it is scored in, and a doc with no overlap scores exactly 0.  They are
    added in the order of the reference's compiled reduction on the CPU,
    each product added as a fused multiply-add
    (:func:`~repro_torch.core.ranking.fma32`): with one query rect, one
    chain over the doc rects; with more, one chain over the query rects per
    doc rect ``r``, and those lanes then added pairwise, halves first
    (``(l0 + l2) + (l1 + l3)`` for four doc rects).
    """
    R, Q = doc_rects.shape[-2], query_rects.shape[-2]
    lanes = [None] * (1 if Q == 1 else R)
    for r in range(R):
        d = doc_rects[..., r, :].float()
        da = doc_amps[..., r].float()
        lane = 0 if Q == 1 else r
        for q in range(Q):
            inter = geometry.rect_intersection_area(d, query_rects[..., q, :].float())
            w = da * query_amps[..., q].float()
            acc = lanes[lane]
            lanes[lane] = w * inter if acc is None else fma32(w, inter, acc)
    while len(lanes) > 1:
        if len(lanes) % 2:
            lanes.append(torch.zeros_like(lanes[0]))
        h = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + h] for i in range(h)]
    return lanes[0]


def geo_score_upper_bound(
    doc_mbr: torch.Tensor,
    doc_mass: torch.Tensor,
    query_rects: torch.Tensor,
    query_amps: torch.Tensor,
) -> torch.Tensor:
    """Cheap upper bound on :func:`geo_score` from the footprint MBR only:
    ``Σ_q min(area(mbr ∩ q), mass_D) · amp_q``, where ``doc_mass = Σ_r
    area(r)·amp(r)`` is precomputed (the reference's lossy-footprint
    early-termination bound; no caller in either package).

    doc_mbr f32[..., 4], doc_mass f32[...], query_rects f32[Q, 4],
    query_amps f32[Q] → f32[...].
    """
    inter = geometry.rect_intersection_area(
        doc_mbr[..., None, :], query_rects[None, :, :]
    )  # [..., Q]
    bound = torch.minimum(inter, doc_mass[..., None]) * query_amps[None, :]
    return torch.sum(bound, dim=-1)


def query_mass(query_rects: torch.Tensor, query_amps: torch.Tensor) -> torch.Tensor:
    """Σ area·amp of the query footprint (normalizer)."""
    return torch.sum(geometry.rect_area(query_rects) * query_amps, dim=-1)


def footprint_mbr_np(rects: np.ndarray) -> np.ndarray:
    """MBRs over the non-empty rects of ``rects [..., R, 4]`` → f32[..., 4];
    a footprint with no non-empty rect gets ``EMPTY_RECT``."""
    valid = rects[..., 2] > rects[..., 0]
    inf = np.float32(np.inf)
    mbr = np.stack(
        [
            np.where(valid, rects[..., 0], inf).min(axis=-1),
            np.where(valid, rects[..., 1], inf).min(axis=-1),
            np.where(valid, rects[..., 2], -inf).max(axis=-1),
            np.where(valid, rects[..., 3], -inf).max(axis=-1),
        ],
        axis=-1,
    ).astype(np.float32)
    mbr[~valid.any(axis=-1)] = geometry.EMPTY_RECT
    return mbr
