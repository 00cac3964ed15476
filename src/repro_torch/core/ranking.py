"""Ranking: F(D, q) = w_g·g(fD, fq) + w_p·pr(D) + w_t·Ftext(D, q)
(port of ``repro/core/ranking.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RankWeights:
    w_text: float = 1.0
    w_geo: float = 1.0
    w_pr: float = 0.2


def combine_scores(
    weights: RankWeights,
    text_score: torch.Tensor,
    geo_score: torch.Tensor,
    pagerank: torch.Tensor,
    query_mass: torch.Tensor,
    require_geo: bool = True,
) -> torch.Tensor:
    """Combined relevance; −inf for documents with empty footprint overlap.

    ``query_mass`` broadcasts against the scores (``[B, 1]`` for ``[B, C]``).
    The ``require_geo`` gate is exact because every caller passes a geo
    score computed directly from each doc's own rect rows (see the
    reference's exactness contract).  Each weighted term is added as XLA
    contracts it, a multiply-add rounded once (:func:`fma32`).
    """
    norm = torch.clamp(query_mass, min=1e-12)
    geo = weights.w_geo * geo_score / norm
    score = fma32(weights.w_text, text_score, geo)
    score = fma32(weights.w_pr, pagerank, score)
    if require_geo:
        score = torch.where(geo_score > 0.0, score, -torch.inf)
    return score


def fma32(a: "torch.Tensor | float", b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 (a Python ``a`` is first rounded
    to float32, as the reference's weak-typed weights are).  XLA contracts
    the reference's ``a * b + c`` into a fused multiply-add, so its scores,
    score bounds and modeled byte counters are rounded once.  The product
    of two float32 values is exact in float64; the float64 sum is exact for
    the byte counters and carries 29 spare bits for scores, so rounding it
    to float32 differs from one rounding only at a float32 tie."""
    a = a.double() if isinstance(a, torch.Tensor) else float(np.float32(a))
    return (a * b.double() + c.double()).float()


def select_top(values: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: among equal values the lower
    *position* wins (a stable descending sort; ``torch.topk`` promises no
    tie order).  Returns (values, positions)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k(scores: torch.Tensor, doc_ids: torch.Tensor, k: int):
    """Top-k docs by score, ties to the lower position; non-finite picks
    get id −1."""
    vals, idx = select_top(scores, k)
    ids = torch.gather(doc_ids, -1, idx)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return ids, vals


def topk_recall_np(want_ids, got_ids) -> float:
    """Fraction of valid reference ids found in the candidate top-k lists
    (``[B, k]`` id arrays, −1 padded); 1.0 when the reference has none."""
    want = np.asarray(want_ids)
    got = np.asarray(got_ids)
    want_valid = want >= 0
    found = (
        (want[:, :, None] == got[:, None, :])
        & want_valid[:, :, None]
        & (got[:, None, :] >= 0)
    ).any(axis=-1)
    total = int(want_valid.sum())
    return float(found.sum()) / total if total else 1.0
