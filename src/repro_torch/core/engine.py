"""GeoSearchEngine: build / hold indexes, execute batched geo queries
(port of ``repro/core/engine.py``).

Execution is plan-driven: every call resolves to a
:class:`~repro_torch.core.planner.QueryPlan` and the function cache is keyed
by plan, so one engine can hold several pipeline variants against one
index.  ``algorithm="auto"`` routes through the engine's cost-based
:class:`~repro_torch.core.planner.Planner`, which picks the cheapest plan per
query.  The engine lives on one device — CUDA unless ``device="cpu"`` is
passed to :meth:`GeoSearchEngine.build`.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import Callable

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import ranking
from repro_torch.core.planner import Planner, QueryPlan
from repro_torch.core.spatial_index import (
    SpatialIndex,
    build_spatial_index_np,
    normalize_compress,
)
from repro_torch.core.text_index import TextIndex, build_text_index_np
from repro_torch.device import resolve_device, to_numpy


@dataclass(frozen=True)
class GeoIndex:
    """The full index state, on one device."""

    text: TextIndex
    spatial: SpatialIndex
    pagerank: torch.Tensor  # f32[N]

    @property
    def device(self) -> torch.device:
        return self.pagerank.device


@dataclass
class GeoSearchEngine:
    index: GeoIndex
    budgets: alg.QueryBudgets
    weights: ranking.RankWeights
    _fn_cache: dict = field(default_factory=dict, repr=False, compare=False)
    # metrics registry attached by the serving layer's attach_telemetry;
    # each distinct plan x kw pipeline counts in engine.compiled_fns_total
    metrics: object = field(default=None, repr=False, compare=False)

    @staticmethod
    def build(
        doc_terms: list[np.ndarray],
        doc_rects: np.ndarray,
        doc_amps: np.ndarray,
        n_terms: int,
        pagerank: np.ndarray | None = None,
        grid: int = 64,
        m_intervals: int = 2,
        n_bitmap_terms: int = 0,
        budgets: alg.QueryBudgets | None = None,
        weights: ranking.RankWeights | None = None,
        compress: "bool | str" = False,
        block_size: int = 128,
        idf: np.ndarray | None = None,
        layout: str = "docid",
        device: "str | torch.device | None" = None,
    ) -> "GeoSearchEngine":
        """Build both indexes on ``device`` (default CUDA; raises without it).

        ``compress`` (``"none"``/``"f16"``/``"int8"``, bool accepted) stores
        both indexes compressed together, as the reference does: the text
        index PForDelta-packed with f16 impacts, the toe-print store at the
        mode's dtypes.  ``layout`` is the posting order (``"docid"`` or
        ``"impact"``, see :mod:`repro_torch.core.text_index`).
        """
        mode = normalize_compress(compress)
        dev = resolve_device(device)
        text = build_text_index_np(
            doc_terms, n_terms, n_bitmap_terms, idf=idf, compress=mode != "none",
            impact_dtype=np.float16 if mode != "none" else None, layout=layout, device=dev,
        )
        spatial = build_spatial_index_np(
            doc_rects, doc_amps, grid, m_intervals, compress=mode, block_size=block_size,
            device=dev,
        )
        if pagerank is None:
            pagerank = np.full((len(doc_terms),), 0.1, dtype=np.float32)
        return GeoSearchEngine.from_index(
            GeoIndex(text, spatial, torch.from_numpy(np.asarray(pagerank, np.float32)).to(dev)),
            budgets,
            weights,
        )

    @staticmethod
    def from_index(
        index: GeoIndex,
        budgets: alg.QueryBudgets | None = None,
        weights: ranking.RankWeights | None = None,
    ) -> "GeoSearchEngine":
        """An engine over an existing index (e.g. one converted from the
        reference with :func:`repro_torch.core.convert.geo_index_from_numpy`)."""
        budgets = alg.with_sweep_budget_cap(
            budgets or alg.QueryBudgets(), index.spatial.n_toeprints
        )
        return GeoSearchEngine(index, budgets, weights or ranking.RankWeights())

    @property
    def device(self) -> torch.device:
        return self.index.device

    def query(
        self,
        batch: alg.QueryBatch,
        algorithm: str = "k_sweep",
        plan: QueryPlan | None = None,
        **kw,
    ) -> alg.TopKResult:
        """Run one batch under a plan (``plan=None``: the default plan for
        ``algorithm`` from the engine's own budgets).  ``algorithm="auto"``
        asks the engine's planner for a per-query plan and gathers each
        row's result from its assigned plan's run."""
        if plan is None:
            if algorithm == "auto":
                return self._query_auto(batch, **kw)
            plan = QueryPlan(algorithm, self.budgets, fused=bool(kw.pop("fused", False)))
        else:
            kw.pop("fused", None)  # the plan owns the fused flag
        fn = self._compiled(plan, tuple(sorted(kw.items())))
        return fn(batch.to(self.device))

    @property
    def planner(self) -> Planner:
        """Lazily-built cost-based planner over this engine's index."""
        p = self.__dict__.get("_planner")
        if p is None:
            p = Planner.from_engine(self)
            self.__dict__["_planner"] = p
        return p

    def _query_auto(self, batch: alg.QueryBatch, **kw) -> alg.TopKResult:
        """Per-query plan dispatch at the engine level.

        The serving layer runs plan-homogeneous batches; against one padded
        batch this emulates it, as the reference does: each distinct chosen
        plan runs on the whole batch and every row's ids, scores and stats
        are gathered from its own plan's run.  With more than one plan the
        rows are gathered on the host and the stats come back ``float32``
        (the reference's float64 gather, through ``jnp.asarray`` with x64
        off); ids stay ``int32`` and scores ``float32``.
        """
        fused = bool(kw.pop("fused", False))
        plans = self.planner.plan_rows(batch)
        if fused:  # route rows with a kernel pipeline through it
            plans = [
                replace(p, fused=True)
                if p.algorithm == "k_sweep"
                or (p.algorithm == "text_first" and p.budgets.prune)
                else p
                for p in plans
            ]
        uniq: list[QueryPlan] = []
        for p in plans:
            if p not in uniq:
                uniq.append(p)
        if len(uniq) == 1:
            return self.query(batch, plan=uniq[0], **kw)
        results = {p: self.query(batch, plan=p, **kw) for p in uniq}
        rows = [np.asarray([plan == p for plan in plans]) for p in uniq]
        ids = np.zeros_like(to_numpy(results[uniq[0]].ids))
        scores = np.zeros_like(to_numpy(results[uniq[0]].scores))
        keys = sorted({k for r in results.values() for k in r.stats})
        stats = {k: np.zeros((batch.batch,), np.float64) for k in keys}
        for p, sel in zip(uniq, rows):
            res = results[p]
            ids[sel] = to_numpy(res.ids)[sel]
            scores[sel] = to_numpy(res.scores)[sel]
            for k in keys:  # absent counters contribute 0 for this plan
                if k in res.stats:
                    v = to_numpy(res.stats[k]).astype(np.float64)
                    stats[k][sel] = v[sel] if v.ndim else v
        dev = self.device
        return alg.TopKResult(
            ids=torch.from_numpy(ids).to(dev),
            scores=torch.from_numpy(scores).to(dev),
            stats={k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in stats.items()},
        )

    def oracle(self, batch: alg.QueryBatch, k: int | None = None) -> alg.TopKResult:
        idx = self.index
        return alg.oracle(
            idx.text, idx.spatial, idx.pagerank, batch.to(self.device),
            k or self.budgets.top_k, self.weights,
        )

    def _compiled(self, plan: QueryPlan, kw_key) -> Callable:
        """Plan-keyed function cache (one bound pipeline per plan × kw)."""
        key = (plan, kw_key)
        if key not in self._fn_cache:
            if self.metrics is not None:
                self.metrics.inc("engine.compiled_fns_total")
            idx = self.index
            self._fn_cache[key] = partial(
                alg.get_algorithm(plan.algorithm),
                idx.text,
                idx.spatial,
                idx.pagerank,
                budgets=alg.with_sweep_budget_cap(plan.budgets, idx.spatial.n_toeprints),
                weights=self.weights,
                **{**plan.engine_kw(), **dict(kw_key)},
            )
        return self._fn_cache[key]

    def recall_at_k(
        self,
        batch: alg.QueryBatch,
        algorithm: str = "k_sweep",
        k: int | None = None,
        **kw,
    ) -> float:
        """Recall@k of an algorithm vs the exact oracle."""
        k = k or self.budgets.top_k
        got = self.query(batch, algorithm, **kw)
        want = self.oracle(batch, k)
        return ranking.topk_recall_np(want.ids.cpu().numpy(), got.ids.cpu().numpy())
