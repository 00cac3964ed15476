"""The paper's three query algorithms, batched (port of
``repro/core/algorithms.py``): TEXT-FIRST (plain and block-max pruned),
GEO-FIRST and K-SWEEP, plus the exact oracle.

Every registered algorithm shares the signature::

    (text_index, spatial_index, pagerank, query, budgets, weights)
        -> TopKResult(ids [B,k], scores [B,k], stats {str: [B]})

The reference ``vmap``s one query at a time; here every stage carries the
batch axis explicitly.  ``stats`` keeps the reference's counters and dtypes
(the modeled bytes are ``count * float32(bytes)``), so they compare exactly.
Each stage is a ``record_function`` span, named in :data:`SPANS`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
from torch.profiler import record_function

from repro_torch.core import footprint as fp
from repro_torch.core import geometry
from repro_torch.core import ranking, spatial_index as sidx, text_index as tidx
from repro_torch.core.ranking import fma32 as _fma32
from repro_torch.core.spatial_index import INVALID
from repro_torch.kernels.text_probe.ops import window_size

ALGORITHMS: dict[str, object] = {}
# each algorithm's profiler spans, one per stage, in order (read by a
# profiler pass: chip_smoke.py prints each one's host and device time)
SPANS = {
    "k_sweep": (
        "k_sweep.1-2_sweeps",
        "k_sweep.3-6a_fetch_score",
        "k_sweep.4_sort_dedupe",
        "k_sweep.5_text_filter",
        "k_sweep.6_rescore_topk",
        "k_sweep.stats",
    ),
    "text_first": (
        "text_first.1_driver_walk",
        "text_first.2_select",
        "text_first.3_text_filter",
        "text_first.4_geo_score_topk",
        "text_first.stats",
    ),
    "geo_first": (
        "geo_first.1_tile_candidates",
        "geo_first.2_sort_dedupe",
        "geo_first.3_text_filter",
        "geo_first.4_geo_score_topk",
        "geo_first.stats",
    ),
}


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
            "(plus 'auto' at the engine/serving layer, which routes through "
            "the cost-based planner)"
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


def _fetch_runs(cand, valid, n_c):
    """Runs of the candidates' footprint fetches: sorted doc ids coalesce
    into one run unless 64 apart (the reference's disk access model)."""
    cs = torch.sort(torch.where(valid, cand, INVALID), dim=1).values
    new_run = ((cs[:, 1:] - cs[:, :-1]) > 64) & (cs[:, 1:] != INVALID)
    return new_run.sum(dim=1, dtype=torch.int32) + (n_c > 0).to(torch.int32)


def _rank_docs(spatial, pagerank, cand, valid, tscore, q_rects, q_amps, weights, k):
    """Exact geo score of each candidate's own footprint, the combined
    score, and the top-k."""
    g = _geo_score_docs(spatial, cand, valid, q_rects, q_amps)
    qm = fp.query_mass(q_rects, q_amps)
    score = ranking.combine_scores(
        weights, tscore, g, pagerank[torch.where(valid, cand, 0).long()], qm[:, None]
    )
    score = torch.where(valid, score, -torch.inf)
    ids, vals = ranking.top_k(score, cand, k)
    return ids.to(torch.int32), vals


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number rounded to a float32 scalar, as ``jnp.float32(x)``."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# TEXT-FIRST (paper §IV.A)
# ---------------------------------------------------------------------------

@register_algorithm("text_first")
def text_first(
    text: tidx.TextIndex,
    spatial: sidx.SpatialIndex,
    pagerank: torch.Tensor,
    query: QueryBatch,
    budgets: QueryBudgets,
    weights: ranking.RankWeights = ranking.RankWeights(),
    fused: bool = False,  # pruned walk through the text_probe kernel
) -> TopKResult:
    """TEXT-FIRST: drive the intersection with the shortest posting list,
    probe the other terms, fetch footprints for the survivors.

    ``budgets.prune`` switches the driver walk to the block-max pruned
    probe → score → select pipeline (:func:`_text_first_pruned`); see the
    reference's docstring for the accounting of both paths.
    """
    if budgets.prune:
        return _text_first_pruned(text, spatial, pagerank, query, budgets, weights, fused)
    spans = SPANS["text_first"]
    terms, q_rects, q_amps = query.terms, query.rects, query.amps
    B = terms.shape[0]
    R = spatial.doc_rects.shape[1]
    mc = budgets.max_candidates
    with record_function(spans[0]):
        cand, valid, score0, driver = tidx.driver_postings(text, terms, mc)
    with record_function(spans[2]):
        valid, tscore, _ = tidx.text_probe_loop(
            text, terms, cand, skip=driver, match=valid, score=score0
        )
        cand = torch.where(valid, cand, INVALID)
        tscore = torch.where(valid, tscore, 0.0)
    with record_function(spans[3]):
        ids, vals = _rank_docs(
            spatial, pagerank, cand, valid, tscore, q_rects, q_amps, weights, budgets.top_k
        )
    with record_function(spans[4]):
        f32, i32 = torch.float32, torch.int32
        n_c = valid.sum(dim=1, dtype=i32)
        n_terms_real = (terms >= 0).sum(dim=1, dtype=i32)
        probes_per = torch.clamp(n_terms_real - 1, min=0)
        fetch_runs = _fetch_runs(cand, valid, n_c)
        pb = _f32(text.posting_bytes, terms)
        rdb = _f32(R * spatial.doc_bytes, terms)
        window = _f32(mc * text.posting_bytes, terms)
        zeros = torch.zeros((B,), dtype=i32, device=terms.device)
        stats = {
            "candidates": n_c,
            "bytes_spatial": n_c.to(f32) * rdb,
            "bytes_postings": _fma32(n_c.to(f32), pb, window),
            "fetch_runs": fetch_runs,
            "seeks": fetch_runs + n_terms_real,
            "n_probes": n_c * probes_per,
            # unpruned: the whole max_candidates window streams
            "text_blocks_total": zeros + -(-mc // tidx.POSTING_BLOCK),
            "text_blocks_skipped": zeros,
            "probes_saved": zeros,
            "bytes_seq": window.expand(B).clone(),
            "bytes_random": _fma32(n_c.to(f32), rdb, (n_c * probes_per * 32).to(f32)),
        }
    return TopKResult(ids, vals, stats)


def text_first_bounds(text, spatial, pagerank, terms, budgets, weights):
    """The pruned TEXT-FIRST walk's per-query inputs: ``(driver i64[B],
    b0 i32[B], nb i32[B], rest_ub f32[B], floor f32[B])`` — the driver
    column, its block run, the bound on everything a posting's final score
    can gain beyond its own impact (the other terms' max impacts, geo and
    pagerank), and the select floor ``prune_eps ×`` the best optimistic
    score."""
    B, d = terms.shape
    dev = terms.device
    f32, i32 = torch.float32, torch.int32
    NB = text.blk_pos.shape[0]
    n_win = window_size(text.max_term_blocks)
    # query-independent remainder: combine_scores adds w_geo·g/max(qm, ε)
    # ≤ w_geo·Σ_r amp_r, plus w_pr·pagerank (sums in index order, as the
    # reference's reductions run)
    R = spatial.doc_amps.shape[1]
    amps = spatial.doc_amps.float()
    amp_sum = torch.zeros(amps.shape[:1], dtype=f32, device=dev)
    for r in range(R):
        amp_sum = amp_sum + amps[:, r]
    zero = torch.zeros((), dtype=f32, device=dev)
    amp_sum_max = torch.maximum(amp_sum.max(), zero) if amps.shape[0] else zero
    pr_max = torch.maximum(pagerank.float().max(), zero) if pagerank.numel() else zero
    const_ub = _fma32(_f32(weights.w_pr, terms), pr_max, _f32(weights.w_geo, terms) * amp_sum_max)
    w_text = _f32(weights.w_text, terms)
    driver, t0, any_real = tidx.driver_terms(text, terms)
    safe = torch.clamp(terms, min=0).long()
    tb0 = text.blk_term_off[safe]
    tnb = text.blk_term_off[safe + 1] - tb0
    wi = torch.arange(n_win, dtype=i32, device=dev)
    bidx = torch.clamp(tb0[..., None] + wi, 0, NB - 1).long()
    # per-term max impact from the block metadata: what the non-driver
    # terms can add to any candidate's text score
    tmax = torch.where(wi < tnb[..., None], text.blk_max_impact[bidx], 0.0).amax(dim=-1)
    others = (terms >= 0) & (torch.arange(d, device=dev)[None, :] != driver[:, None])
    rest = torch.zeros((B,), dtype=f32, device=dev)
    for i in range(d):
        rest = rest + torch.where(others[:, i], tmax[:, i], 0.0)
    rest_ub = _fma32(w_text, rest, const_ub)
    b0 = text.blk_term_off[t0].to(i32)
    nb = torch.where(any_real, text.blk_term_off[t0 + 1] - b0, 0).to(i32)
    tmax_d = torch.gather(tmax, 1, driver[:, None])[:, 0]
    floor = torch.clamp(
        _f32(budgets.prune_eps, terms) * _fma32(w_text, tmax_d, rest_ub), min=0.0
    )
    return driver, b0, nb, rest_ub, floor


def _text_first_pruned(text, spatial, pagerank, query, budgets, weights, fused):
    """Block-max pruned TEXT-FIRST: walk the whole driver list in 128-posting
    blocks, skip blocks whose optimistic bound cannot beat the running
    top-C threshold (the text_probe kernel when ``fused``, else its plain
    version), select the top ``max_candidates`` streamed postings by
    optimistic score, probe the other terms for them only."""
    from repro_torch.kernels.text_probe import ops as probe_ops
    from repro_torch.kernels.text_probe.ref import text_probe_pruned_ref

    probe = probe_ops.text_probe_pruned if fused else text_probe_pruned_ref
    spans = SPANS["text_first"]
    terms, q_rects, q_amps = query.terms, query.rects, query.amps
    R = spatial.doc_rects.shape[1]
    NB = text.blk_pos.shape[0]
    P = text.n_postings
    mc = budgets.max_candidates
    Cs = min(mc, window_size(text.max_term_blocks) * tidx.POSTING_BLOCK)
    f32, i32 = torch.float32, torch.int32
    with record_function(spans[0]):
        driver, b0, nb, rest_ub, floor = text_first_bounds(
            text, spatial, pagerank, terms, budgets, weights
        )
        opt, valid, streamed, blocks_scored, blocks_active = probe(
            text.impacts, text.blk_pos, text.blk_max_impact, text.blk_len, b0, nb,
            weights.w_text, rest_ub, floor, max_candidates=mc,
            max_term_blocks=text.max_term_blocks,
            # impact layout: blk_max_impact is a per-term suffix-max envelope,
            # so the walk may stop at the driver's first failing bound
            monotone=text.layout == "impact",
        )
    with record_function(spans[1]):
        # select: the top-C streamed survivors by optimistic score, then
        # their doc ids (only the selected candidates' blocks are decoded)
        kept = valid & streamed
        val, sel = ranking.select_top(torch.where(kept, opt, -1.0), Cs)
        ok_c = torch.gather(kept, 1, sel) & (val > floor[:, None])
        lane = sel % tidx.POSTING_BLOCK
        gb = torch.clamp(b0[:, None] + torch.div(sel, tidx.POSTING_BLOCK, rounding_mode="floor"),
                         0, NB - 1)
        apos = torch.clamp(text.blk_pos[gb] + lane, 0, max(P - 1, 0)).long()
        if text.is_compressed:
            dec = tidx.decode_posting_blocks(text, gb)  # [B, Cs, 128]
            cand = torch.gather(dec, 2, lane[..., None])[..., 0]
        else:
            cand = text.postings[apos]
        cand = torch.where(ok_c, cand, INVALID)
        imp_d = torch.where(ok_c, text.impacts[apos].float(), 0.0)
    with record_function(spans[2]):
        valid_c, tscore, _ = tidx.text_probe_loop(
            text, terms, cand, skip=driver, match=ok_c, score=imp_d
        )
        cand = torch.where(valid_c, cand, INVALID)
        tscore = torch.where(valid_c, tscore, 0.0)
    with record_function(spans[3]):
        ids, vals = _rank_docs(
            spatial, pagerank, cand, valid_c, tscore, q_rects, q_amps, weights, budgets.top_k
        )
    with record_function(spans[4]):
        n_sel = ok_c.sum(dim=1, dtype=i32)  # candidates probed
        n_c = valid_c.sum(dim=1, dtype=i32)  # intersection survivors
        streamed_valid = (valid & streamed).sum(dim=1, dtype=i32)
        n_terms_real = (terms >= 0).sum(dim=1, dtype=i32)
        probes_per = torch.clamp(n_terms_real - 1, min=0)
        fetch_runs = _fetch_runs(cand, valid_c, n_c)
        pb = _f32(text.posting_bytes, terms)
        rdb = _f32(R * spatial.doc_bytes, terms)
        stats = {
            "candidates": n_c,
            "bytes_spatial": n_c.to(f32) * rdb,
            # only streamed driver blocks count, plus the selected
            # candidates' random reads
            "bytes_postings": _fma32(streamed_valid.to(f32), pb, n_sel.to(f32) * pb),
            "fetch_runs": fetch_runs,
            "seeks": fetch_runs + n_terms_real,
            "n_probes": n_c * probes_per,
            "text_blocks_total": blocks_active,
            "text_blocks_skipped": blocks_active - blocks_scored,
            "probes_saved": torch.clamp(streamed_valid - n_sel, min=0) * probes_per,
            "bytes_seq": streamed_valid.to(f32) * pb,
            "bytes_random": _fma32(
                n_sel.to(f32), pb, _fma32(n_c.to(f32), rdb, (n_c * probes_per * 32).to(f32))
            ),
        }
    return TopKResult(ids, vals, stats)


# ---------------------------------------------------------------------------
# GEO-FIRST (paper §IV.B)
# ---------------------------------------------------------------------------

@register_algorithm("geo_first")
def geo_first(
    text: tidx.TextIndex,
    spatial: sidx.SpatialIndex,
    pagerank: torch.Tensor,
    query: QueryBatch,
    budgets: QueryBudgets,
    weights: ranking.RankWeights = ranking.RankWeights(),
) -> TopKResult:
    """GEO-FIRST: toe prints from the query's tiles (the R*-tree lookup),
    translated to doc ids and deduped, filtered by text probes, then the
    survivors' footprints fetched and scored."""
    spans = SPANS["geo_first"]
    terms, q_rects, q_amps = query.terms, query.rects, query.amps
    R = spatial.doc_rects.shape[1]
    with record_function(spans[0]):
        tp_ids, ok = sidx.tile_candidate_toeprints(
            spatial, q_rects, budgets.max_tiles, budgets.max_candidates
        )
        # translate toe prints → doc ids (random access into the id column)
        docs = torch.where(ok, spatial.tp_doc_ids[tp_ids.long()].to(torch.int32), INVALID)
    with record_function(spans[1]):
        docs_s, dvalid = _sorted_dedupe(docs, ok)
        docs_u = torch.where(dvalid, docs_s, 0)
    with record_function(spans[2]):
        match, tscore = tidx.text_score_of_docs(text, terms, docs_u)
        keep = dvalid & match
    with record_function(spans[3]):
        ids, vals = _rank_docs(
            spatial, pagerank, docs_u, keep, tscore, q_rects, q_amps, weights, budgets.top_k
        )
    with record_function(spans[4]):
        f32, i32 = torch.float32, torch.int32
        n_cand = ok.sum(dim=1, dtype=i32)
        n_uniq = dvalid.sum(dim=1, dtype=i32)
        n_keep = keep.sum(dim=1, dtype=i32)
        n_terms_real = (terms >= 0).sum(dim=1, dtype=i32)
        idb = _f32(spatial.tp_doc_ids.element_size(), terms)
        rdb = _f32(R * spatial.doc_bytes, terms)
        log_p = torch.ceil(torch.log2(_f32(float(max(text.n_postings, 2)), terms)))
        stats = {
            "candidates": n_cand,
            "bytes_spatial": _fma32(n_cand.to(f32), idb, n_keep.to(f32) * rdb),
            # XLA folds the two constant factors first
            "bytes_postings": n_uniq.to(f32) * (log_p * _f32(text.posting_bytes, terms)),
            # every candidate toe print, and every surviving footprint, is
            # fetched individually (R*-tree random access)
            "seeks": n_cand + n_keep,
            "n_probes": n_uniq * n_terms_real,
            "bytes_seq": torch.zeros(n_cand.shape, dtype=f32, device=terms.device),
            "bytes_random": _fma32(n_cand.to(f32), idb, n_keep.to(f32) * rdb)
            + (n_uniq * n_terms_real * 32).to(f32),
        }
    return TopKResult(ids, vals, stats)


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
    spans = SPANS["k_sweep"]
    terms, q_rects, q_amps = query.terms, query.rects, query.amps
    B = terms.shape[0]
    S = budgets.sweep_budget
    with record_function(spans[0]):
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
    with record_function(spans[1]):
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
    with record_function(spans[2]):
        # (4) translate to doc ids, sort, dedupe per doc
        docs_s, dvalid = _sorted_dedupe(docs_c, ok_c)
        docs_u = torch.where(dvalid, docs_s, 0)
    with record_function(spans[3]):
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
    with record_function(spans[4]):
        # (6) final geo score from each survivor's own footprint slots
        ids, vals = _rank_docs(
            spatial, pagerank, docs_u, keep, tscore, q_rects, q_amps, weights, budgets.top_k
        )
    with record_function(spans[5]):
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
            # XLA folds the two constant factors first
            "bytes_postings": n_uniq.to(f32) * (log_p * pb),
            "seeks": n_sweeps + n_terms_real,
            "n_probes": text_probes if text_probes is not None else n_uniq * n_terms_real,
            "bytes_seq": streamed_tp.to(f32) * tpb,
            "bytes_random": n_uniq * n_terms_real * 32,
        }
    return TopKResult(ids, vals, stats)


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
