"""Cost-based per-query planner (port of ``repro/core/planner.py``): pick
TEXT-FIRST / GEO-FIRST / K-SWEEP per query from cheap host-side features.

A :class:`QueryPlan` is (algorithm, budgets, fused flag): everything the
engine needs to run one pipeline variant.  Plans are frozen and hashable and
key the engine's function cache, the serving batcher's buckets and the
report's per-plan attribution.

:class:`CostModel` predicts each plan's ``n_probes``, ``bytes_postings`` and
``bytes_spatial`` per query from posting-list lengths (the ``df`` table) and
footprint coverage (a summed-area table of the tile grid's interval lengths,
and the Morton-store span of the blocks whose MBR the footprint touches);
:class:`Planner` picks the cheapest, charging candidates a plan's budgets
would drop far above their bytes.  The feature tables are host numpy copies
of the index's ``offsets``, ``blk_mbr``, ``tile_starts`` and ``tile_ends``,
made once at build, so planning never touches the device; a sharded
index's model sums or concatenates its shards' tables (``from_shards``,
``from_sharded_index``).  The reference's docstrings give each estimate's
derivation.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.core import algorithms as alg
from repro_torch.core import geometry
from repro_torch.core.spatial_index import INVALID, SCALE_BLOCK
from repro_torch.device import to_numpy

# objective keys: the per-stage counters every algorithm reports
COST_KEYS = ("n_probes", "bytes_postings", "bytes_spatial")
_SCALE_CLIP = 16.0
# coarse bbox-grid resolution for the tp_span candidate lookup
_SPAN_GRID = 16


@dataclass(frozen=True)
class QueryPlan:
    """One executable pipeline choice: algorithm + budgets + kernel knobs."""

    algorithm: str
    budgets: alg.QueryBudgets
    fused: bool = False

    @property
    def label(self) -> str:
        """Human-readable plan name for reports (``k_sweep+prune+fused``)."""
        out = self.algorithm
        if self.algorithm in ("k_sweep", "text_first") and self.budgets.prune:
            out += "+prune"
        if self.algorithm in ("k_sweep", "text_first") and self.fused:
            out += "+fused"
        return out

    def engine_kw(self) -> dict:
        """Extra keyword args the engine forwards to the algorithm fn."""
        if self.algorithm in ("k_sweep", "text_first") and self.fused:
            return {"fused": True}
        return {}


@dataclass(frozen=True)
class QueryFeatures:
    """Cheap per-query features the cost model consumes."""

    n_terms: int
    df_min: float  # shortest posting list among the query terms
    df_sum: float  # total posting volume of the query terms
    tp_est: float  # estimated toe prints the tile intervals cover
    tp_span: float  # estimated Morton-store span (block metadata hits)
    area: float  # total query footprint area


@dataclass
class CostModel:
    """Per-algorithm per-stage cost estimates from per-query features.

    Feature tables are plain numpy copies of the index's auxiliary
    structures (df table, block metadata) — the model never touches device
    arrays at plan time.
    """

    df: np.ndarray  # f64[M] posting-list length per term
    blk_mbr: np.ndarray  # f32[NB, 4] block MBRs (Morton store)
    blk_count: np.ndarray  # f64[NB] toe prints per block
    tile_sat: np.ndarray  # f64[G+1, G+1] summed-area table of per-tile
    #                       interval coverage (Σ interval lengths per tile)
    grid: int
    n_postings: int
    n_toeprints: int
    n_docs: int
    rect_slots: int  # R of the doc-major footprint mirror
    budgets: alg.QueryBudgets
    # per-record byte sizes of the index actually being served — read from
    # the index properties at build so compressed stores shrink the
    # predicted bytes_* exactly like they shrink the measured counters
    posting_bytes: float = 8.0  # doc id + impact, uncompressed
    tp_bytes: float = 24.0  # rect + amp + doc id per toe print, uncompressed
    doc_bytes: float = 20.0  # doc-major rect + amp slot
    tp_id_bytes: float = 4.0  # toe-print doc-id column entry
    # (algorithm, counter) -> multiplicative calibration scale
    scales: dict = field(default_factory=dict)
    # metrics registry attached by the serving layer (the obs slice); None =
    # the planner publishes nothing
    metrics: object = None
    # cumulative exact MBR tests performed by the tp_span candidate path
    tp_span_probes: int = 0

    def __post_init__(self) -> None:
        # Coarse bbox grid over the occupied block MBRs: cell -> block-id
        # CSR.  Replaces the O(NB) all-blocks scan in features(): a query
        # rect gathers candidate blocks from its covered coarse cells and
        # runs the exact MBR ∩ rect test on those only.  Exact because the
        # cell mapping is clamped and monotone with NO upper-edge epsilon
        # on either side: any point in MBR ∩ rect lands in a cell covered
        # by both, so candidates are a superset of the true hits (boundary
        # over-coverage only adds candidates, never drops one), and zero-
        # count blocks contribute nothing to the span sum either way.
        G = _SPAN_GRID
        occ = np.flatnonzero(np.asarray(self.blk_count) > 0)
        m = np.asarray(self.blk_mbr, np.float64)
        if len(occ):
            ix0, iy0, ix1, iy1 = coarse_cells(m[occ], G)
            w, h = ix1 - ix0 + 1, iy1 - iy0 + 1
            ok = (w > 0) & (h > 0)  # inverted MBRs (padding) cover nothing
            occ, ix0, iy0, w, h = occ[ok], ix0[ok], iy0[ok], w[ok], h[ok]
        if len(occ):
            reps = w * h
            blocks = np.repeat(occ, reps)
            # per-entry (dx, dy) offset within its block's cell range
            first = np.concatenate(([0], np.cumsum(reps)[:-1]))
            k = np.arange(int(reps.sum())) - np.repeat(first, reps)
            wv = np.repeat(w, reps)
            cells = (np.repeat(iy0, reps) + k // wv) * G + (
                np.repeat(ix0, reps) + k % wv
            )
            order = np.argsort(cells, kind="stable")
            self._span_blocks = blocks[order]
            self._span_offsets = np.zeros(G * G + 1, np.int64)
            np.cumsum(np.bincount(cells, minlength=G * G), out=self._span_offsets[1:])
        else:
            self._span_blocks = np.zeros((0,), np.int64)
            self._span_offsets = np.zeros(G * G + 1, np.int64)

    def _span_candidates(self, r: np.ndarray) -> np.ndarray:
        """Block ids whose coarse cells the query rects touch (superset of
        the blocks whose MBR intersects any rect)."""
        G = _SPAN_GRID
        ix0, iy0, ix1, iy1 = coarse_cells(r, G)
        parts = []
        for j in range(len(r)):
            for cy in range(int(iy0[j]), int(iy1[j]) + 1):
                base = cy * G
                s = self._span_offsets[base + int(ix0[j])]
                e = self._span_offsets[base + int(ix1[j]) + 1]
                if e > s:
                    parts.append(self._span_blocks[s:e])
        if not parts:
            return np.zeros((0,), np.int64)
        return np.unique(np.concatenate(parts))

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_geo_index(index, budgets: alg.QueryBudgets) -> "CostModel":
        """Build feature tables from a single :class:`GeoIndex`."""
        text, spatial = index.text, index.spatial
        df = np.diff(to_numpy(text.offsets)).astype(np.float64)
        blk_mbr = to_numpy(spatial.blk_mbr)
        blk_count = _block_counts(spatial.n_toeprints, spatial.block_size, blk_mbr)
        return CostModel(
            df=df,
            blk_mbr=blk_mbr,
            blk_count=blk_count,
            tile_sat=_tile_sat(
                to_numpy(spatial.tile_starts),
                to_numpy(spatial.tile_ends),
                spatial.grid,
            ),
            grid=int(spatial.grid),
            n_postings=int(text.n_postings),
            n_toeprints=int(spatial.n_toeprints),
            n_docs=int(spatial.n_docs),
            rect_slots=int(spatial.doc_rects.shape[1]),
            budgets=budgets,
            posting_bytes=float(text.posting_bytes),
            tp_bytes=float(spatial.tp_bytes),
            doc_bytes=float(spatial.doc_bytes),
            tp_id_bytes=float(spatial.tp_doc_ids.element_size()),
        )

    @staticmethod
    def from_shards(indexes, budgets: alg.QueryBudgets) -> "CostModel":
        """Aggregate feature tables over per-shard :class:`GeoIndex` es: df
        and tile coverage sum across shards (every shard sees every query),
        block metadata concatenates, so the features count the whole
        corpus."""
        parts = [CostModel.from_geo_index(ix, budgets) for ix in indexes]
        tot_p = max(sum(p.n_postings for p in parts), 1)
        tot_t = max(sum(p.n_toeprints for p in parts), 1)
        return CostModel(
            df=np.sum([p.df for p in parts], axis=0),
            blk_mbr=np.concatenate([p.blk_mbr for p in parts], axis=0),
            blk_count=np.concatenate([p.blk_count for p in parts], axis=0),
            tile_sat=np.sum([p.tile_sat for p in parts], axis=0),
            grid=parts[0].grid,
            n_postings=sum(p.n_postings for p in parts),
            n_toeprints=sum(p.n_toeprints for p in parts),
            n_docs=sum(p.n_docs for p in parts),
            rect_slots=parts[0].rect_slots,
            budgets=budgets,
            # record sizes weighted by each shard's postings / toe prints
            posting_bytes=sum(p.posting_bytes * p.n_postings for p in parts) / tot_p,
            tp_bytes=sum(p.tp_bytes * p.n_toeprints for p in parts) / tot_t,
            doc_bytes=parts[0].doc_bytes,
            tp_id_bytes=parts[0].tp_id_bytes,
        )

    @staticmethod
    def from_sharded_index(sharded, budgets: alg.QueryBudgets) -> "CostModel":
        """Build from a stacked
        :class:`~repro_torch.core.distributed.ShardedGeoIndex` (the mesh
        executor).  Padding is excluded where the reference excludes it
        (zero amplitudes, zero block maxima, doc map −1) and counted where
        it counts it (the packed-word and block columns)."""
        offsets = to_numpy(sharded.offsets).astype(np.int64)  # [S, M+1]
        df = np.diff(offsets, axis=1).sum(axis=0).astype(np.float64)
        blk_mbr = to_numpy(sharded.blk_mbr).reshape(-1, 4)
        # int8 amp stores keep the sign (positive scales): a widening cast
        # counts the valid toe prints
        n_tp = int((to_numpy(sharded.tp_amps).astype(np.float32) > 0).sum())
        blk_amp = to_numpy(sharded.blk_max_amp).reshape(-1)
        blk_count = np.where(blk_amp > 0, float(sharded.block_size), 0.0)
        n_docs = int((to_numpy(sharded.doc_offset) >= 0).sum())
        grid = int(sharded.grid)
        sat = np.sum(
            [
                _tile_sat(to_numpy(sharded.tile_starts[s]), to_numpy(sharded.tile_ends[s]), grid)
                for s in range(sharded.n_shards)
            ],
            axis=0,
        )
        P_tot = max(int(df.sum()), 1)
        imp_b = sharded.impacts.element_size()
        if sharded.blk_first.shape[1] > 0:  # compressed posting store
            # 20 B of block metadata per block, 8 B per impact segment
            packed = 4 * sharded.post_packed.numel() + 20 * sharded.blk_first.numel()
            if sharded.layout == "impact":
                packed += 8 * sharded.seg_pos.numel()
            posting_bytes = packed / P_tot + imp_b
        else:
            seg = 8 * sharded.seg_pos.numel() if sharded.layout == "impact" else 0
            posting_bytes = 4.0 + seg / P_tot + imp_b
        scale_b = 4.0 / SCALE_BLOCK if sharded.tp_amp_scale.shape[1] else 0.0
        plane_b = 4 * sharded.tp_rects.element_size() + sharded.tp_amps.element_size() + scale_b
        return CostModel(
            df=df,
            blk_mbr=blk_mbr,
            blk_count=blk_count,
            tile_sat=sat,
            grid=grid,
            n_postings=int(df.sum()),
            n_toeprints=n_tp,
            n_docs=n_docs,
            rect_slots=int(sharded.doc_rects.shape[2]),
            budgets=budgets,
            posting_bytes=float(posting_bytes),
            tp_bytes=float(plane_b + sharded.tp_doc_ids.element_size()),
            doc_bytes=float(4 * sharded.doc_rects.element_size() + sharded.doc_amps.element_size()),
            tp_id_bytes=float(sharded.tp_doc_ids.element_size()),
        )

    # ------------------------------------------------------------------
    # features
    # ------------------------------------------------------------------
    def features(self, terms, rects, amps) -> QueryFeatures:
        t = np.unique(np.asarray(terms, np.int64).reshape(-1))
        t = t[(t >= 0) & (t < len(self.df))]
        dfs = self.df[t] if len(t) else np.zeros((0,))
        r = np.asarray(rects, np.float64).reshape(-1, 4)
        a = np.asarray(amps, np.float64).reshape(-1)
        valid = (r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1]) & (a > 0)
        r = r[valid]
        area = float(
            np.sum((r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])) if len(r) else 0.0
        )
        tp_est, tp_span = 0.0, 0.0
        if len(r):
            # tile-interval coverage: what GEO-FIRST / K-SWEEP actually
            # enumerate is the tile grid's per-tile intervals (with their
            # coalescing slack), so tp_est sums the precomputed per-tile
            # interval lengths over the touched cell range — O(1) per rect
            # via the summed-area table.  rect_cell_bounds_np is the same
            # bucketing the index build used, so coverage cannot drift.
            x0, y0, x1, y1 = geometry.rect_cell_bounds_np(r, self.grid)
            s = self.tile_sat
            covered = (
                s[y1 + 1, x1 + 1] - s[y0, x1 + 1] - s[y1 + 1, x0] + s[y0, x0]
            )
            tp_est = float(np.minimum(covered.sum(), self.n_toeprints))
        if len(r) and len(self.blk_mbr):
            # Morton-span estimate for K-SWEEP's contiguous streams: every
            # metadata block whose MBR touches the footprint lies inside
            # the span the coalesced sweeps must cover.  The coarse bbox
            # grid narrows the exact MBR test to the blocks sharing a cell
            # with the footprint — same sum as the old all-blocks scan
            # (superset argument in __post_init__), O(candidates) not O(NB)
            cand = self._span_candidates(r)
            self.tp_span_probes += len(cand)
            if self.metrics is not None:
                self.metrics.inc("planner.tp_span_probe", float(len(cand)))
            if len(cand):
                m = self.blk_mbr[cand].astype(np.float64)
                hit = (
                    (np.minimum(m[None, :, 2], r[:, None, 2])
                     >= np.maximum(m[None, :, 0], r[:, None, 0]))
                    & (np.minimum(m[None, :, 3], r[:, None, 3])
                       >= np.maximum(m[None, :, 1], r[:, None, 1]))
                ).any(axis=0)
                tp_span = float(
                    np.minimum((hit * self.blk_count[cand]).sum(), self.n_toeprints)
                )
        return QueryFeatures(
            n_terms=int(len(t)),
            df_min=float(dfs.min()) if len(dfs) else 0.0,
            df_sum=float(dfs.sum()),
            tp_est=tp_est,
            tp_span=max(tp_span, tp_est),
            area=area,
        )

    # ------------------------------------------------------------------
    # per-algorithm estimates
    # ------------------------------------------------------------------
    def estimate(self, plan: QueryPlan, f: QueryFeatures) -> dict[str, float]:
        """Predicted per-query counters for ``plan`` (COST_KEYS)."""
        bud = plan.budgets
        d = max(f.n_terms, 1)
        mc = bud.max_candidates
        logp = float(np.ceil(np.log2(max(self.n_postings, 2))))
        pb, tpb, db = self.posting_bytes, self.tp_bytes, self.doc_bytes
        R = self.rect_slots
        tp_per_doc = max(self.n_toeprints / max(self.n_docs, 1), 1.0)
        if plan.algorithm == "text_first":
            n_c = min(f.df_min, mc)  # driver-list bound on survivors
            if bud.prune:
                # block-max pruned traversal: the whole driver list streams
                # at worst (block skips are modeled as zero, a safe upper
                # bound like K-SWEEP's — calibration learns the skip rate),
                # then the select stage caps candidates at mc, so hot-term
                # queries probe/fetch far fewer docs than they stream
                est = {
                    "n_probes": n_c * max(d - 1, 0),
                    "bytes_postings": f.df_min * pb + n_c * pb,
                    "bytes_spatial": n_c * R * db,
                }
            else:
                est = {
                    "n_probes": n_c * max(d - 1, 0),
                    "bytes_postings": n_c * pb + mc * pb,
                    "bytes_spatial": n_c * R * db,
                }
        elif plan.algorithm == "geo_first":
            n_cand = min(f.tp_est, mc)
            n_uniq = n_cand / tp_per_doc
            keep = n_uniq * min(f.df_min / max(self.n_docs, 1), 1.0)
            est = {
                "n_probes": n_uniq * d,
                "bytes_postings": n_uniq * logp * pb,
                "bytes_spatial": n_cand * self.tp_id_bytes + keep * R * db,
            }
        elif plan.algorithm == "k_sweep":
            # sweeps stream whole sweep_budget chunks over the Morton span
            # the footprint's blocks cover
            n_sweeps = (
                min(-(-f.tp_span // bud.sweep_budget), bud.k_sweeps)
                if f.tp_span > 0
                else 1
            )
            streamed = n_sweeps * bud.sweep_budget
            n_valid = min(f.tp_est, streamed)
            if bud.prune or bud.early_termination:
                n_valid = min(n_valid, mc)
            n_uniq = n_valid / tp_per_doc
            est = {
                "n_probes": n_uniq * d,
                "bytes_postings": n_uniq * logp * pb,
                # pruning is modeled as zero skips (a safe upper bound);
                # calibration learns the workload's actual skip rate
                "bytes_spatial": streamed * tpb,
            }
        else:
            raise ValueError(f"cost model has no estimator for {plan.algorithm!r}")
        key = plan.algorithm
        return {k: v * self.scales.get((key, k), 1.0) for k, v in est.items()}

    def truncation(self, plan: QueryPlan, f: QueryFeatures) -> float:
        """Estimated candidates a plan's budgets would *drop* for this query.

        Each algorithm is exact until a static budget truncates its
        candidate stream (TEXT-FIRST: the driver posting list vs
        ``max_candidates``; GEO-FIRST: footprint toe prints vs
        ``max_candidates``; K-SWEEP: footprint toe prints vs the total
        sweep capacity).  The planner charges dropped candidates far above
        their byte cost — recall, not traffic, is what truncation loses —
        so a plan that covers the query beats a nominally cheaper plan
        that cannot.
        """
        bud = plan.budgets
        if plan.algorithm == "text_first":
            if bud.prune:
                # pruned traversal sees the WHOLE driver list and keeps the
                # best-bound ``max_candidates`` — a score-aware cut, not a
                # blind head-of-list truncation, so no coverage charge
                return 0.0
            return max(0.0, f.df_min - bud.max_candidates)
        if plan.algorithm == "geo_first":
            return max(0.0, f.tp_est - bud.max_candidates)
        if plan.algorithm == "k_sweep":
            return max(0.0, f.tp_span - bud.k_sweeps * bud.sweep_budget)
        return 0.0

    # ------------------------------------------------------------------
    # calibration
    # ------------------------------------------------------------------
    def calibrate(self, engine, batch, plans) -> None:
        """Fit per-(algorithm, counter) scales against measured counters.

        Runs each plan once on ``batch`` through ``engine`` and sets
        ``scales[(algorithm, key)] = mean(measured) / mean(predicted)``,
        clipped to [1/16, 16].  Idempotent: predictions are re-derived from
        the unscaled closed forms each call.
        """
        terms = to_numpy(batch.terms)
        rects = to_numpy(batch.rects)
        amps = to_numpy(batch.amps)
        feats = [
            self.features(terms[b], rects[b], amps[b])
            for b in range(terms.shape[0])
        ]
        for plan in plans:
            res = engine.query(batch, plan=plan)
            for k in COST_KEYS:  # predict unscaled
                self.scales.pop((plan.algorithm, k), None)
            pred = {k: 0.0 for k in COST_KEYS}
            for f in feats:
                for k, v in self.estimate(plan, f).items():
                    pred[k] += v
            for k in COST_KEYS:
                meas = float(to_numpy(res.stats[k]).astype(np.float64).sum())
                if pred[k] > 0 and meas > 0:
                    self.scales[(plan.algorithm, k)] = float(
                        np.clip(meas / pred[k], 1.0 / _SCALE_CLIP, _SCALE_CLIP)
                    )


@dataclass
class Planner:
    """Chooses the cheapest :class:`QueryPlan` per query.

    ``candidates`` is the plan menu (one per registered algorithm by
    default; the K-SWEEP entry inherits the engine budgets' ``prune`` /
    ``fused`` configuration).  The objective weights mirror the paper's
    probe + posting-byte traffic, with a light spatial-stream tiebreaker.
    """

    model: CostModel
    candidates: tuple[QueryPlan, ...]
    w_probes: float = 1.0
    w_postings: float = 1.0
    w_spatial: float = 0.1
    # bytes charged per candidate a plan's budget would drop (recall risk:
    # dominates the traffic terms so coverage wins over nominal cheapness)
    w_truncation: float = 2048.0

    # ------------------------------------------------------------------
    @staticmethod
    def make_candidates(
        budgets: alg.QueryBudgets, fused: bool = False
    ) -> tuple[QueryPlan, ...]:
        return (
            # pruned TEXT-FIRST has a kernel pipeline too (text_probe)
            QueryPlan("text_first", budgets, fused=fused and budgets.prune),
            QueryPlan("geo_first", budgets),
            QueryPlan("k_sweep", budgets, fused=fused),
        )

    @staticmethod
    def from_engine(engine, fused: bool = False, calibrate_with=None) -> "Planner":
        model = CostModel.from_geo_index(engine.index, engine.budgets)
        planner = Planner(
            model=model,
            candidates=Planner.make_candidates(engine.budgets, fused=fused),
        )
        if calibrate_with is not None:
            model.calibrate(engine, calibrate_with, planner.candidates)
        return planner

    # ------------------------------------------------------------------
    def cost(self, plan: QueryPlan, f: QueryFeatures) -> float:
        est = self.model.estimate(plan, f)
        return (
            self.w_probes * est["n_probes"]
            + self.w_postings * est["bytes_postings"]
            + self.w_spatial * est["bytes_spatial"]
            + self.w_truncation * self.model.truncation(plan, f)
        )

    def plan_query(self, terms, rects, amps) -> QueryPlan:
        """Cheapest plan for one (un-padded or padded) query."""
        f = self.model.features(terms, rects, amps)
        best, best_cost = None, float("inf")
        for plan in self.candidates:  # stable order breaks exact ties
            c = self.cost(plan, f)
            if c < best_cost:
                best, best_cost = plan, c
        return best

    def explain(self, terms, rects, amps) -> dict:
        """The full planning decision for one query, as plain data.

        Returns ``{"features": {...}, "candidates": {label: {algorithm,
        n_probes, bytes_postings, bytes_spatial, truncation, cost}},
        "chosen": label}`` — the planner-audit record the serving layer
        persists.  The chosen label matches :meth:`plan_query` exactly
        (same costs, same stable tie-break order).
        """
        f = self.model.features(terms, rects, amps)
        candidates: dict[str, dict] = {}
        best, best_cost = None, float("inf")
        for plan in self.candidates:
            est = self.model.estimate(plan, f)
            trunc = self.model.truncation(plan, f)
            c = (
                self.w_probes * est["n_probes"]
                + self.w_postings * est["bytes_postings"]
                + self.w_spatial * est["bytes_spatial"]
                + self.w_truncation * trunc
            )
            candidates[plan.label] = {
                "algorithm": plan.algorithm,
                **est,
                "truncation": trunc,
                "cost": c,
            }
            if c < best_cost:
                best, best_cost = plan.label, c
        return {"features": asdict(f), "candidates": candidates, "chosen": best}

    def plan_rows(self, batch: alg.QueryBatch) -> list[QueryPlan]:
        """One plan per row of a padded :class:`QueryBatch`."""
        terms = to_numpy(batch.terms)
        rects = to_numpy(batch.rects)
        amps = to_numpy(batch.amps)
        return [
            self.plan_query(terms[b], rects[b], amps[b])
            for b in range(terms.shape[0])
        ]


def coarse_cells(rects: np.ndarray, grid: int):
    """Clamped inclusive cell bounds ``(ix0, iy0, ix1, iy1)`` on a coarse
    bbox grid — deliberately WITHOUT :func:`geometry.rect_cell_bounds_np`'s
    upper-edge epsilon, so an edge exactly on a cell boundary also claims
    the next cell.  Over-coverage keeps the candidate set a superset of the
    true MBR hits (the exactness requirement); degenerate (zero-area) block
    MBRs still cover their point's cell, while inverted (padding) MBRs come
    back with ``ix1 < ix0`` and cover nothing.

    Footprint routing (:mod:`repro_torch.core.distributed`) buckets each
    shard's coverage through this same mapping.
    """
    g = float(grid)
    ix0 = np.clip(np.floor(rects[..., 0] * g).astype(np.int64), 0, grid - 1)
    iy0 = np.clip(np.floor(rects[..., 1] * g).astype(np.int64), 0, grid - 1)
    ix1 = np.clip(np.floor(rects[..., 2] * g).astype(np.int64), 0, grid - 1)
    iy1 = np.clip(np.floor(rects[..., 3] * g).astype(np.int64), 0, grid - 1)
    return ix0, iy0, ix1, iy1


def _block_counts(n_toeprints: int, block_size: int, blk_mbr: np.ndarray):
    """Toe prints per metadata block (tail block is short)."""
    nb = blk_mbr.shape[0]
    counts = np.full((nb,), float(block_size))
    if nb:
        counts[-1] = max(n_toeprints - (nb - 1) * block_size, 0)
    return counts


def _tile_sat(tile_starts, tile_ends, grid: int) -> np.ndarray:
    """Summed-area table of per-tile interval coverage, f64[G+1, G+1].

    ``coverage[iy, ix]`` = Σ interval lengths of tile ``iy·G + ix`` — the
    toe prints (including coalescing slack) a query touching that tile
    enumerates.  The SAT makes any cell-range sum O(1) per query rect.
    """
    starts = np.asarray(tile_starts, np.int64)  # [G*G, m]
    ends = np.asarray(tile_ends, np.int64)
    valid = starts != np.int64(INVALID)
    cover = np.where(valid, ends - starts, 0).sum(axis=1).astype(np.float64)
    sat = np.zeros((grid + 1, grid + 1))
    sat[1:, 1:] = cover.reshape(grid, grid).cumsum(axis=0).cumsum(axis=1)
    return sat
