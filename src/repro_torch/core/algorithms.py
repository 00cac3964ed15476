"""K-SWEEP, the paper's main query algorithm, batched (port of
``repro/core/algorithms.py``).

Every registered algorithm shares the signature::

    (text_index, spatial_index, pagerank, query, budgets, weights)
        -> TopKResult(ids [B,k], scores [B,k], stats {str: [B]})

The reference ``vmap``s one query at a time; here every stage carries the
batch axis explicitly.  ``stats`` keeps the reference's counters and dtypes
(the modeled bytes are ``count * float32(bytes)``), so they compare exactly.
TEXT-FIRST and GEO-FIRST arrive with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
from torch.profiler import record_function

from repro_torch.core import footprint as fp
from repro_torch.core import geometry
from repro_torch.core import ranking, spatial_index as sidx, text_index as tidx
from repro_torch.core.spatial_index import INVALID

ALGORITHMS: dict[str, object] = {}
# K-SWEEP's profiler spans, one per stage, in order (read by a profiler pass:
# chip_smoke.py prints each one's host and device time)
SPANS = (
    "k_sweep.1-2_sweeps",
    "k_sweep.3-6a_fetch_score",
    "k_sweep.4_sort_dedupe",
    "k_sweep.5_text_filter",
    "k_sweep.6_rescore_topk",
    "k_sweep.stats",
)


def register_algorithm(name: str):
    """Add a query algorithm to the registry under ``name``."""

    def deco(fn):
        ALGORITHMS[name] = fn
        return fn

    return deco


def get_algorithm(name: str):
    """Resolve a registered algorithm by name (clear error on a typo)."""
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {sorted(ALGORITHMS)} "
            "(text_first, geo_first and 'auto' are not ported yet)"
        ) from None


@dataclass(frozen=True)
class QueryBudgets:
    """Static shape budgets (see the reference for each knob)."""

    max_candidates: int = 1024
    max_tiles: int = 64
    k_sweeps: int = 4
    sweep_budget: int = 2048
    top_k: int = 10
    early_termination: bool = False
    prune: bool = False
    prune_eps: float = 0.0


@dataclass(frozen=True)
class QueryBatch:
    """A batch of geo queries (fixed shapes).

    terms:  i32[B, d]   (−1 padded)
    rects:  f32[B, Qr, 4] query footprint rectangles (empty-rect padded)
    amps:   f32[B, Qr]
    """

    terms: torch.Tensor
    rects: torch.Tensor
    amps: torch.Tensor

    @property
    def batch(self) -> int:
        return self.terms.shape[0]

    def to(self, device) -> "QueryBatch":
        return QueryBatch(
            self.terms.to(device), self.rects.to(device), self.amps.to(device)
        )


@dataclass(frozen=True)
class TopKResult:
    ids: torch.Tensor  # i32[B, k], −1 padded
    scores: torch.Tensor  # f32[B, k]
    stats: dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _geo_score_docs(spatial, doc_ids, valid, q_rects, q_amps):
    """Gather doc-major footprints [B, C] and score them against each query."""
    safe = torch.where(valid, doc_ids, 0).long()
    rects = spatial.doc_rects[safe]  # [B, C, R, 4]
    amps = torch.where(valid[..., None], spatial.doc_amps[safe], 0.0)
    g = fp.geo_score(rects, amps, q_rects[:, None], q_amps[:, None])
    return torch.where(valid, g, 0.0)


def _count_unique(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Distinct ids among each row's valid positions, i32[B]."""
    _, last = _sorted_dedupe(ids, valid)
    return last.sum(dim=1, dtype=torch.int32)


def _sorted_dedupe(ids: torch.Tensor, valid: torch.Tensor):
    """Sort each row (invalid → +inf sentinel) and mark the last element of
    each run — a fixed-shape dedupe, deliberately cumsum-free (see the
    reference: no prefix sum may touch a score that feeds ``require_geo``).

    Returns (sorted_ids, last_of_run & valid)."""
    big = INVALID
    ids_s = torch.sort(torch.where(valid, ids, big), dim=1).values
    nxt = torch.cat([ids_s[:, 1:], torch.full_like(ids_s[:, :1], -2)], dim=1)
    last = (ids_s != nxt) & (ids_s != big)
    return ids_s, last


def _default_tp_scorer(rects, amps, q_rects, q_amps):
    """Plain per-toe-print scorer: Σ_q area(tp ∩ q)·amp_tp·amp_q, [B, C]."""
    inter = geometry.rect_intersection_area(
        rects[:, :, None, :].float(), q_rects[:, None, :, :].float()
    )
    return torch.sum(
        inter * amps[:, :, None].float() * q_amps[:, None, :].float(), dim=-1
    )


# ---------------------------------------------------------------------------
# K-SWEEP (paper §IV.C — the main algorithm)
# ---------------------------------------------------------------------------

@register_algorithm("k_sweep")
def k_sweep(
    text: tidx.TextIndex,
    spatial: sidx.SpatialIndex,
    pagerank: torch.Tensor,
    query: QueryBatch,
    budgets: QueryBudgets,
    weights: ranking.RankWeights = ranking.RankWeights(),
    tp_scorer=None,
    fused: bool = False,  # fused fetch+score kernel (kernels/sweep_score)
) -> TopKResult:
    """K-SWEEP: (1) tile intervals → (2) ≤k sweeps → (3) bulk fetch →
    (4) docID translation + sort → (5) text filter → (6) geo scores → top-k.

    ``tp_scorer(rects [B,C,4], amps [B,C], q_rects, q_amps) -> [B,C]`` scores
    toe prints on the unfused path (the geo_score kernel under
    ``use_pallas``).  ``budgets.prune`` switches stage (3+6a) to the
    block-max pruned sweep → score → select: the sweep_score_pruned kernel
    when ``fused``, else its plain version.  See the reference's docstring
    for the streamed-vs-scored accounting of the stats.
    """
    from repro_torch.kernels.sweep_score import ops as sweep_ops
    from repro_torch.kernels.sweep_score.ref import sweep_score_pruned_ref

    if tp_scorer is None:
        tp_scorer = _default_tp_scorer
    terms, q_rects, q_amps = query.terms, query.rects, query.amps
    B = terms.shape[0]
    S = budgets.sweep_budget
    with record_function(SPANS[0]):
        # (1) intervals of all intersecting tiles
        starts, ends = sidx.gather_query_intervals(spatial, q_rects, budgets.max_tiles)
        # (2) coalesce into ≤ k sweeps, re-chunked to the fetch budget
        s_starts, s_ends = sidx.coalesce_k_sweeps(starts, ends, budgets.k_sweeps)
        s_starts, s_ends = sidx.split_sweeps_to_budget(
            s_starts, s_ends, budgets.k_sweeps, S
        )
        n_sweeps = (s_starts != INVALID).sum(dim=1, dtype=torch.int32)
    total = budgets.k_sweeps * S
    Cmax = min(budgets.max_candidates, total)
    bs = spatial.block_size
    scale = spatial.tp_amp_scale if spatial.tp_amp_scale.shape[0] else None
    with record_function(SPANS[1]):
        if budgets.prune:
            # (3+6a+5a) PRUNED: block-max bound test against an adaptive θ
            # seeded with the select stage's own score floor
            pruned = sweep_ops.sweep_score_pruned if fused else sweep_score_pruned_ref
            floor = torch.clamp(
                torch.tensor(budgets.prune_eps, dtype=torch.float32, device=q_rects.device)
                * fp.query_mass(q_rects, q_amps),
                min=0.0,
            )
            part3, ok3, st3, blocks_scored, blocks_active = pruned(
                spatial.tp_rects, spatial.tp_amps, spatial.blk_mbr, spatial.blk_max_amp,
                spatial.blk_max_mass, s_starts, s_ends, q_rects, q_amps, S,
                budgets.max_candidates, bs, floor, tp_amp_scale=scale,
            )
            part = part3.reshape(B, -1)
            ok = ok3.reshape(B, -1)
            kept = ok & st3.reshape(B, -1)
            docs = sidx.fetch_sweep_ids(spatial, s_starts, s_ends, S)
            # select: partial top-C cut over the survivors, plus the floor
            val, sel = ranking.select_top(torch.where(kept, part, -1.0), Cmax)
            docs_c = torch.gather(docs, 1, sel)
            ok_c = torch.gather(kept, 1, sel) & (val > floor[:, None])
            streamed_tp = st3.sum(dim=(1, 2), dtype=torch.int32)
            blocks_total = blocks_active
            blocks_skipped = blocks_active - blocks_scored
        else:
            if fused:
                # (3+6a) FUSED: the kernel streams each sweep and scores it in
                # registers; only the doc-id column is fetched separately
                part3, ok3 = sweep_ops.sweep_score(
                    spatial.tp_rects, spatial.tp_amps, s_starts, s_ends, q_rects,
                    q_amps, S, tp_amp_scale=scale,
                )
                part = part3.reshape(B, -1)
                ok = ok3.reshape(B, -1)
                docs = sidx.fetch_sweep_ids(spatial, s_starts, s_ends, S)
            else:
                # (3) bulk contiguous fetch, (6a) per-toe-print partial scores
                rects, amps, docs, ok = sidx.fetch_sweeps(spatial, s_starts, s_ends, S)
                part = tp_scorer(rects, torch.where(ok, amps, 0.0), q_rects, q_amps)
            # (5a) lossy geo-score early termination (paper future work);
            # without it the partial scores select nothing and go unread,
            # as in the reference
            if budgets.early_termination and Cmax < total:
                val, sel = ranking.select_top(torch.where(ok, part, -1.0), Cmax)
                docs_c = torch.gather(docs, 1, sel)
                ok_c = torch.gather(ok, 1, sel) & (val > 0)
            else:
                docs_c, ok_c = docs, ok
            streamed_tp = n_sweeps * S
            blocks_total = n_sweeps * ((S + bs - 1) // bs)
            blocks_skipped = torch.zeros((B,), dtype=torch.int32, device=terms.device)
    with record_function(SPANS[2]):
        # (4) translate to doc ids, sort, dedupe per doc
        docs_s, dvalid = _sorted_dedupe(docs_c, ok_c)
        docs_u = torch.where(dvalid, docs_s, 0)
    with record_function(SPANS[3]):
        # (5) filter through the inverted index (the counted variant reports
        # the probes a short-circuiting evaluator issues)
        if budgets.prune:
            match, tscore, text_probes = tidx.text_score_of_docs_counted(
                text, terms, docs_u, dvalid
            )
        else:
            match, tscore = tidx.text_score_of_docs(text, terms, docs_u)
            text_probes = None
        keep = dvalid & match
    with record_function(SPANS[4]):
        # (6) final geo score from each survivor's own footprint slots
        g_tot = _geo_score_docs(spatial, docs_u, keep, q_rects, q_amps)
        qm = fp.query_mass(q_rects, q_amps)
        score = ranking.combine_scores(
            weights, tscore, g_tot, pagerank[torch.where(keep, docs_u, 0).long()], qm[:, None]
        )
        score = torch.where(keep, score, -torch.inf)
        ids, vals = ranking.top_k(score, docs_u, budgets.top_k)
    with record_function(SPANS[5]):
        fetched = ok.sum(dim=1, dtype=torch.int32)
        n_selected = ok_c.sum(dim=1, dtype=torch.int32)
        n_uniq = dvalid.sum(dim=1, dtype=torch.int32)
        n_terms_real = (terms >= 0).sum(dim=1, dtype=torch.int32)
        if budgets.prune or budgets.early_termination:
            probes_saved = (_count_unique(docs, ok) - n_uniq) * n_terms_real
        else:
            probes_saved = torch.zeros((B,), dtype=torch.int32, device=terms.device)
        f32 = torch.float32
        tpb = torch.tensor(spatial.tp_bytes, dtype=f32, device=terms.device)
        pb = torch.tensor(text.posting_bytes, dtype=f32, device=terms.device)
        log_p = torch.ceil(
            torch.log2(torch.tensor(float(max(text.n_postings, 2)), dtype=f32, device=terms.device))
        )
        stats = {
            "candidates": fetched,
            "sweeps": n_sweeps,
            "bytes_spatial": streamed_tp.to(f32) * tpb,
            "sweep_slack": n_sweeps * S - fetched,
            "bytes_scored": n_selected.to(f32) * tpb,
            "blocks_total": blocks_total,
            "blocks_skipped": blocks_skipped,
            "probes_saved": probes_saved,
            "bytes_postings": n_uniq.to(f32) * log_p * pb,
            "seeks": n_sweeps + n_terms_real,
            "n_probes": text_probes if text_probes is not None else n_uniq * n_terms_real,
            "bytes_seq": streamed_tp.to(f32) * tpb,
            "bytes_random": n_uniq * n_terms_real * 32,
        }
    return TopKResult(ids.to(torch.int32), vals, stats)


# ---------------------------------------------------------------------------
# Exact oracle (dense scan) — for recall evaluation in tests/benchmarks
# ---------------------------------------------------------------------------

def oracle(
    text: tidx.TextIndex,
    spatial: sidx.SpatialIndex,
    pagerank: torch.Tensor,
    query: QueryBatch,
    k: int,
    weights: ranking.RankWeights = ranking.RankWeights(),
) -> TopKResult:
    """Exact top-k by scoring *every* document (no budgets).  O(N) per query."""
    B = query.terms.shape[0]
    all_docs = torch.arange(spatial.n_docs, dtype=torch.int32, device=pagerank.device)
    all_docs = all_docs.expand(B, -1).contiguous()
    match, tscore = tidx.text_score_of_docs(text, query.terms, all_docs)
    g = fp.geo_score(
        spatial.doc_rects, spatial.doc_amps, query.rects[:, None], query.amps[:, None]
    )
    qm = fp.query_mass(query.rects, query.amps)
    score = ranking.combine_scores(weights, tscore, g, pagerank, qm[:, None])
    score = torch.where(match, score, -torch.inf)
    ids, vals = ranking.top_k(score, all_docs, k)
    return TopKResult(ids.to(torch.int32), vals, {})


def with_sweep_budget_cap(budgets: QueryBudgets, n_toeprints: int) -> QueryBudgets:
    """Sweeps cannot exceed the store."""
    return replace(budgets, sweep_budget=min(budgets.sweep_budget, n_toeprints))
