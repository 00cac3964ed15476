"""Batch executors: single-device, doc-sharded scatter-gather, and the
mesh step (port of ``repro/serving/executor.py``).

The executor is the serving layer's view of the engine: it takes a padded
:class:`~repro_torch.core.algorithms.QueryBatch` and returns a
:class:`~repro_torch.core.algorithms.TopKResult` with *global* doc ids.

* :class:`SingleDeviceExecutor` wraps one :class:`GeoSearchEngine`.
* :class:`ShardedExecutor` partitions the corpus doc-wise with a
  :class:`~repro_torch.core.distributed.Partitioner`, builds one engine per
  shard on the executor's device, **scatters** each batch to the shards it
  can reach and **gathers** their local top-k lists on the host (numpy:
  ties to the lower global doc id, counters summed in float64).
* :class:`MeshExecutor` runs :func:`~repro_torch.core.distributed.make_serve_fn`'s
  step over a stacked :class:`~repro_torch.core.distributed.ShardedGeoIndex`,
  its counters summed over the doc axes inside the step: a loop over the
  shards on one device, or one rank per mesh position on a
  :class:`~repro_torch.core.distributed.ProcessMesh` (rank 0 drives).

Footprint routing (``routing="footprint"``): each shard's coverage SAT
decides which shards a batch reaches; the sharded executor skips the rest
and the mesh step masks them, bit-identical to ``routing="broadcast"``
(the default).  Both add ``shards_touched`` (per query) and
``shards_visited`` (per batch, or per query slice of the mesh).

Every executor serves ``k_sweep``, ``text_first``, ``geo_first`` and
``auto``: under ``auto`` it holds a cost-based
:class:`~repro_torch.core.planner.Planner`, so the serving layer can ask
:meth:`plan_query` for each query's cheapest plan before batching;
fixed-algorithm executors return ``None`` there.

Telemetry: every executor has :meth:`attach_telemetry` (the server calls it
when built with a :class:`~repro_torch.obs.Telemetry` handle).  It hands the
metrics registry to the engines (``engine.compiled_fns_total``) and to the
planner's cost model (``planner.tp_span_probe``), and with a tracer the
executors record host wall-clock spans on the trace's executor process: the
engine call of :class:`SingleDeviceExecutor` (``engine`` /
``query[label]``), one span per visited shard of :class:`ShardedExecutor`
from its dispatch to its host pull (``shard s``), and the mesh step of
:class:`MeshExecutor` (``mesh step`` / ``serve[label]``).  No span
synchronizes the device: the engine and mesh spans end when the call
returns, which on CUDA may be before the work it queued has finished; a
shard span ends after its host pull, so it covers its shard's device work.
``telemetry=None`` (the default) leaves ``run`` untouched.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import ranking
from repro_torch.core.distributed import (
    Mesh,
    MortonPartitioner,
    Partitioner,
    ProcessMesh,
    ShardedGeoIndex,
    _require_partitioner,
    _valid_rects_np,
    footprint_touch_np,
    make_serve_fn,
    mesh_axes,
    shard_corpus_np,
    shard_coverage_sat_np,
    shard_rows,
)
from repro_torch.core.engine import GeoSearchEngine
from repro_torch.core.planner import CostModel, Planner, QueryPlan
from repro_torch.core.text_index import global_idf_np
from repro_torch.device import resolve_device, to_numpy

ROUTINGS = ("broadcast", "footprint")


def _check_routing(routing: str) -> str:
    if routing not in ROUTINGS:
        raise ValueError(f"routing must be one of {ROUTINGS}, got {routing!r}")
    return routing


def _reject_partition_kwarg(kw: dict) -> None:
    """The ``partition="hash"|"geo"`` string flag is gone — fail loudly
    instead of letting the stale kwarg leak into engine query kwargs."""
    if "partition" in kw:
        raise TypeError(
            "partition= strings were replaced by the Partitioner API: pass "
            "partitioner=HashPartitioner() / MortonPartitioner() / "
            "RegionRangePartitioner() (strings resolve only at the CLI "
            "boundary via repro_torch.core.distributed.resolve_partitioner)"
        )


class SingleDeviceExecutor:
    """Run batches through one engine on its device."""

    def __init__(self, engine: GeoSearchEngine, algorithm: str = "k_sweep", **kw):
        self.engine = engine
        self.algorithm = algorithm
        self.kw = kw
        self.telemetry = None
        self.planner: Planner | None = None
        if algorithm == "auto":
            self.planner = Planner.from_engine(engine, fused=bool(kw.get("fused", False)))

    @property
    def top_k(self) -> int:
        return self.engine.budgets.top_k

    def attach_telemetry(self, telemetry) -> None:
        self.telemetry = telemetry
        if telemetry and telemetry.metrics is not None:
            self.engine.metrics = telemetry.metrics
            if self.planner is not None:
                self.planner.model.metrics = telemetry.metrics

    def plan_query(self, terms, rects, amps) -> QueryPlan | None:
        """Cheapest plan for one query; ``None`` when the algorithm is fixed."""
        if self.planner is None:
            return None
        return self.planner.plan_query(terms, rects, amps)

    def run(
        self, batch: alg.QueryBatch, plan: QueryPlan | None = None
    ) -> alg.TopKResult:
        tracer = self.telemetry.tracer if self.telemetry else None
        t0 = tracer.wall_now() if tracer is not None else 0.0
        if plan is not None:
            res = self.engine.query(batch, plan=plan, **self.kw)
        else:
            res = self.engine.query(batch, self.algorithm, **self.kw)
        if tracer is not None:
            label = plan.label if plan is not None else self.algorithm
            tracer.span(
                "engine", f"query[{label}]", t0, tracer.wall_now(),
                args={"batch": int(batch.terms.shape[0])},
            )
        return res


class ShardedExecutor:
    """Doc-sharded scatter-gather over per-shard engines on one device.

    With ``overlap`` (the default) every routed shard's query is issued
    before any result is pulled to the host, so the device work of shard
    ``s+1`` can queue while shard ``s`` computes; ``overlap=False``
    synchronizes the device after each shard.  Results and counters are
    identical either way.
    """

    def __init__(
        self,
        engines,
        global_ids,
        algorithm: str = "k_sweep",
        routing: str = "broadcast",
        overlap: bool = True,
        **kw,
    ):
        _reject_partition_kwarg(kw)
        self.engines: list[GeoSearchEngine] = engines
        self.global_ids: list[np.ndarray] = global_ids  # per shard: local → global
        self.algorithm = algorithm
        self.routing = _check_routing(routing)
        self.overlap = overlap
        self._coverage_sats: np.ndarray | None = None  # lazy f32[S, G+1, G+1]
        self.kw = kw
        self.telemetry = None
        self.planner: Planner | None = None
        if algorithm == "auto":
            # corpus-global features: df and tile coverage summed over the
            # shards, block metadata concatenated
            model = CostModel.from_shards([e.index for e in engines], engines[0].budgets)
            self.planner = Planner(
                model=model,
                candidates=Planner.make_candidates(
                    engines[0].budgets, fused=bool(kw.get("fused", False))
                ),
            )

    @property
    def n_shards(self) -> int:
        return len(self.engines)

    @property
    def top_k(self) -> int:
        return self.engines[0].budgets.top_k

    def attach_telemetry(self, telemetry) -> None:
        self.telemetry = telemetry
        if telemetry and telemetry.metrics is not None:
            for eng in self.engines:
                eng.metrics = telemetry.metrics
            if self.planner is not None:
                self.planner.model.metrics = telemetry.metrics

    def plan_query(self, terms, rects, amps) -> QueryPlan | None:
        if self.planner is None:
            return None
        return self.planner.plan_query(terms, rects, amps)

    @staticmethod
    def build(
        doc_terms: list[np.ndarray],
        doc_rects: np.ndarray,
        doc_amps: np.ndarray,
        n_terms: int,
        pagerank: np.ndarray,
        n_shards: int,
        partitioner: Partitioner | None = None,
        grid: int = 64,
        budgets: alg.QueryBudgets | None = None,
        weights: ranking.RankWeights | None = None,
        algorithm: str = "k_sweep",
        routing: str = "broadcast",
        compress: "bool | str" = False,
        layout: str = "docid",
        overlap: bool = True,
        device: "str | torch.device | None" = None,
        **kw,
    ) -> "ShardedExecutor":
        """One engine per shard on ``device`` (default CUDA).  As in the
        reference, each engine clamps the sweep budget to its own store and
        takes the default ``m_intervals``."""
        _reject_partition_kwarg(kw)
        budgets = budgets or alg.QueryBudgets()
        dev = resolve_device(device)
        partitioner = _require_partitioner(partitioner, default=MortonPartitioner)
        shard_ids = np.asarray(partitioner.assign(doc_rects, n_shards))
        idf_global = global_idf_np(doc_terms, n_terms)
        engines, gids = [], []
        for s in range(n_shards):
            # ascending global ids in-shard: local tie-breaks match global
            sel = np.flatnonzero(shard_ids == s)
            # the global IDF goes into the build: impacts round to f32 once
            # from partition-independent statistics, so per-doc scores are
            # bitwise equal across shard layouts
            engines.append(GeoSearchEngine.build(
                [doc_terms[i] for i in sel], doc_rects[sel], doc_amps[sel], n_terms,
                pagerank=pagerank[sel], grid=grid, budgets=budgets, weights=weights,
                idf=idf_global, compress=compress, layout=layout, device=dev,
            ))
            gids.append(sel.astype(np.int32))
        return ShardedExecutor(engines, gids, algorithm, routing=routing, overlap=overlap, **kw)

    def _coverage(self) -> np.ndarray:
        """Stacked per-shard coverage SATs ``f32[S, G+1, G+1]`` (lazy)."""
        if self._coverage_sats is None:
            self._coverage_sats = np.stack([
                shard_coverage_sat_np(
                    to_numpy(e.index.spatial.tp_rects), to_numpy(e.index.spatial.tp_amps),
                    to_numpy(e.index.spatial.tp_amp_scale),
                )
                for e in self.engines
            ])
        return self._coverage_sats

    def route_batch(self, batch: alg.QueryBatch) -> tuple[np.ndarray, np.ndarray]:
        """Footprint routing of a batch: ``(visit bool[S], touched f64[B])``
        — the shards any query reaches, and how many each query reaches."""
        touch = footprint_touch_np(
            self._coverage(), to_numpy(batch.rects), to_numpy(batch.amps)
        )  # [S, B]
        return touch.any(axis=1), touch.sum(axis=0, dtype=np.float64)

    def run(
        self, batch: alg.QueryBatch, plan: QueryPlan | None = None
    ) -> alg.TopKResult:
        """Scatter the batch to the routed shards; gather and merge the
        top-k on the host.  The result's arrays are host numpy."""
        all_ids, all_scores = [], []
        stats_acc: dict[str, np.ndarray] = {}
        visit = np.ones(self.n_shards, dtype=bool)
        if self.routing == "footprint":
            visit, touched = self.route_batch(batch)
            if not _valid_rects_np(to_numpy(batch.rects), to_numpy(batch.amps)).any():
                # all-padding batch (server warm-up): broadcast, so every
                # shard's engine still runs during the warm-up
                visit[:] = True
            stats_acc["shards_touched"] = touched
            stats_acc["shards_visited"] = np.float64(visit.sum())
            if not visit.any():
                b, k = batch.terms.shape[0], self.top_k
                return alg.TopKResult(
                    ids=np.full((b, k), -1, dtype=np.int32),
                    scores=np.full((b, k), -np.inf, dtype=np.float32),
                    stats=stats_acc,
                )
        tracer = self.telemetry.tracer if self.telemetry else None
        label = plan.label if plan is not None else self.algorithm
        # scatter: issue every routed shard's query before pulling any
        pending = []
        for shard, (eng, gid) in enumerate(zip(self.engines, self.global_ids)):
            if not visit[shard]:
                continue
            t0 = tracer.wall_now() if tracer is not None else 0.0
            if plan is not None:
                # each shard's engine clamps the plan's sweep budget to its
                # own toe-print store
                res = eng.query(batch, plan=plan, **self.kw)
            else:
                res = eng.query(batch, self.algorithm, **self.kw)
            if not self.overlap and eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            pending.append((shard, gid, res, t0))
        # gather: the host pulls each shard's lists and counters
        for shard, gid, res, t0 in pending:
            ids = to_numpy(res.ids)
            scores = to_numpy(res.scores).copy()
            valid = ids >= 0
            g = np.where(valid, gid[np.clip(ids, 0, len(gid) - 1)], -1)
            scores[~valid] = -np.inf
            all_ids.append(g)
            all_scores.append(scores)
            for key, v in res.stats.items():
                v = to_numpy(v).astype(np.float64)
                stats_acc[key] = stats_acc.get(key, 0.0) + v
            if tracer is not None:
                # from this shard's dispatch to its host pull: under overlap
                # the shard spans overlap in time
                tracer.span(
                    f"shard {shard}", f"query[{label}]", t0, tracer.wall_now(),
                    args={"batch": int(batch.terms.shape[0])},
                )
        k = all_ids[0].shape[-1]
        ids = np.concatenate(all_ids, axis=-1)  # [B, S*k]
        scores = np.concatenate(all_scores, axis=-1)
        # global top-k, ties broken by the lower global doc id
        order = np.lexsort((ids, -scores), axis=-1)[:, :k]
        m_ids = np.take_along_axis(ids, order, axis=-1)
        m_scores = np.take_along_axis(scores, order, axis=-1)
        m_ids = np.where(np.isfinite(m_scores), m_ids, -1)
        return alg.TopKResult(ids=m_ids, scores=m_scores, stats=stats_acc)


class MeshExecutor:
    """The mesh twin of :class:`ShardedExecutor`: the same doc-wise
    partitioning, stacked into one :class:`ShardedGeoIndex`, and one serve
    step per plan (:func:`~repro_torch.core.distributed.make_serve_fn`).
    The doc and query axes come from
    :func:`~repro_torch.core.distributed.mesh_axes`.  Each shard's
    per-query counters are summed over the doc axes inside the step.  Steps
    are made lazily per plan: the fixed-algorithm step at construction, one
    per distinct plan under ``algorithm="auto"``.

    On a :class:`~repro_torch.core.distributed.ProcessMesh` every rank
    builds the executor and holds its own row of the index.  Rank 0 drives:
    :meth:`run` broadcasts the plan and the batch, every rank runs the step,
    and rank 0 returns the merged result (a :class:`GeoServer` runs there
    only).  The other ranks follow in :meth:`serve_forever` until rank 0's
    :meth:`close`.
    """

    def __init__(
        self,
        mesh: Mesh,
        serve_fn,
        sharded_index: ShardedGeoIndex,
        top_k: int,
        budgets: alg.QueryBudgets | None = None,
        algorithm: str = "k_sweep",
        weights: ranking.RankWeights | None = None,
        doc_axes: tuple[str, ...] = ("data",),
        query_axis: str = "model",
        fused: bool = False,
        routing: str = "broadcast",
        planner: Planner | None = None,
    ):
        self.mesh = mesh
        self._index = sharded_index
        self.top_k = top_k
        self.budgets = budgets or alg.QueryBudgets(top_k=top_k)
        self.algorithm = algorithm
        self.weights = weights or ranking.RankWeights()
        self.doc_axes = doc_axes
        self.query_axis = query_axis
        self.fused = fused
        self.routing = _check_routing(routing)
        # plan (None: the construction-time configuration) → serve step
        self._serve_fns: dict = {None: serve_fn}
        self.telemetry = None
        self._closed = False
        self.planner = planner
        if algorithm == "auto" and planner is None:
            if isinstance(mesh, ProcessMesh):
                raise ValueError(
                    "algorithm='auto' on a process mesh needs the planner of the whole "
                    "stacked index: build with MeshExecutor.from_index"
                )
            self.planner = Planner(
                model=CostModel.from_sharded_index(sharded_index, self.budgets),
                candidates=Planner.make_candidates(self.budgets, fused=fused),
            )

    @staticmethod
    def build(
        doc_terms: list[np.ndarray],
        doc_rects: np.ndarray,
        doc_amps: np.ndarray,
        n_terms: int,
        pagerank: np.ndarray,
        mesh: Mesh,
        partitioner: Partitioner | None = None,
        grid: int = 64,
        budgets: alg.QueryBudgets | None = None,
        weights: ranking.RankWeights | None = None,
        algorithm: str = "k_sweep",
        fused: bool = False,
        routing: str = "broadcast",
        compress: "bool | str" = False,
        layout: str = "docid",
        **kw,
    ) -> "MeshExecutor":
        """Shard the corpus over the mesh's doc axes: stacked on
        ``mesh.device``, or on a process mesh stacked on the host and cut to
        the rank's row (:meth:`from_index`)."""
        _reject_partition_kwarg(kw)
        if kw:
            raise TypeError(f"unexpected keyword arguments: {sorted(kw)}")
        partitioner = _require_partitioner(partitioner, default=MortonPartitioner)
        doc_axes, _ = mesh_axes(mesh)
        sharded = shard_corpus_np(
            doc_terms, doc_rects, doc_amps, pagerank, n_terms,
            math.prod(mesh.shape[a] for a in doc_axes), partitioner, grid=grid,
            compress=compress, layout=layout,
            device="cpu" if isinstance(mesh, ProcessMesh) else mesh.device,
        )
        return MeshExecutor.from_index(
            mesh, sharded, budgets=budgets, weights=weights, algorithm=algorithm,
            fused=fused, routing=routing,
        )

    @staticmethod
    def from_index(
        mesh: Mesh,
        sharded: ShardedGeoIndex,
        budgets: alg.QueryBudgets | None = None,
        weights: ranking.RankWeights | None = None,
        algorithm: str = "k_sweep",
        fused: bool = False,
        routing: str = "broadcast",
    ) -> "MeshExecutor":
        """The executor over a stacked index of the mesh's doc shards.  As
        in the reference, the sweep budget is clamped to the *stacked*
        store's length; under ``auto`` the planner's cost model reads every
        shard.  Both read the whole index, so plans and budgets equal the
        one-card executor's; on a process mesh the rank then keeps only its
        row (:func:`~repro_torch.core.distributed.shard_rows`), on its
        device."""
        budgets = budgets or alg.QueryBudgets()
        doc_axes, query_axis = mesh_axes(mesh)
        n_shards = math.prod(mesh.shape[a] for a in doc_axes)
        if sharded.n_shards != n_shards:
            raise ValueError(
                f"index has {sharded.n_shards} shards, the mesh's doc axes {doc_axes} "
                f"hold {n_shards}"
            )
        budgets = replace(
            budgets, sweep_budget=min(budgets.sweep_budget, sharded.tp_rects.shape[1])
        )
        weights = weights or ranking.RankWeights()
        serve = make_serve_fn(
            mesh, budgets, weights, doc_axes=doc_axes, query_axis=query_axis,
            algorithm="k_sweep" if algorithm == "auto" else algorithm, fused=fused,
            with_routing=routing == "footprint",
        )
        planner = None
        if algorithm == "auto":
            planner = Planner(
                model=CostModel.from_sharded_index(sharded, budgets),
                candidates=Planner.make_candidates(budgets, fused=fused),
            )
        if isinstance(mesh, ProcessMesh):
            sharded = shard_rows(sharded, mesh.shard_of(doc_axes), mesh.device)
        return MeshExecutor(
            mesh, serve, sharded, budgets.top_k, budgets=budgets, algorithm=algorithm,
            weights=weights, doc_axes=doc_axes, query_axis=query_axis, fused=fused,
            routing=routing, planner=planner,
        )

    @property
    def n_shards(self) -> int:
        """The mesh's doc shards (on a process mesh this rank holds one)."""
        return math.prod(self.mesh.shape[a] for a in self.doc_axes)

    @property
    def index(self) -> ShardedGeoIndex:
        """The stacked index (on a process mesh: this rank's row)."""
        return self._index

    def attach_telemetry(self, telemetry) -> None:
        self.telemetry = telemetry
        if telemetry and telemetry.metrics is not None:
            if self.planner is not None:
                self.planner.model.metrics = telemetry.metrics

    def plan_query(self, terms, rects, amps) -> QueryPlan | None:
        if self.planner is None:
            return None
        return self.planner.plan_query(terms, rects, amps)

    def _serve_for(self, plan: QueryPlan | None):
        """The serve step for a plan (made on first use)."""
        if plan in self._serve_fns:
            return self._serve_fns[plan]
        if self.telemetry and self.telemetry.metrics is not None:
            self.telemetry.metrics.inc("engine.compiled_fns_total")
        budgets = replace(
            plan.budgets,
            sweep_budget=min(plan.budgets.sweep_budget, self._index.tp_rects.shape[1]),
        )
        serve = make_serve_fn(
            self.mesh, budgets, self.weights, doc_axes=self.doc_axes,
            query_axis=self.query_axis, algorithm=plan.algorithm, fused=plan.fused,
            with_routing=self.routing == "footprint",
        )
        self._serve_fns[plan] = serve
        return serve

    def _follower(self) -> bool:
        return isinstance(self.mesh, ProcessMesh) and self.mesh.rank != 0

    def run(
        self, batch: alg.QueryBatch, plan: QueryPlan | None = None
    ) -> alg.TopKResult:
        """ids and scores on the mesh's device; the counters as host numpy.
        On a process mesh: rank 0 only, while the others serve_forever."""
        if isinstance(self.mesh, ProcessMesh):
            if self._follower():
                raise RuntimeError(
                    "on a process mesh rank 0 runs the batches; the other ranks call "
                    "serve_forever()"
                )
            if self._closed:
                raise RuntimeError("the process mesh's executor is closed")
            n_slices = self.mesh.shape[self.query_axis]
            if batch.batch % n_slices:  # raised here, before the ranks wait on a step
                raise ValueError(
                    f"batch of {batch.batch} does not split over {n_slices} query slices")
        serve = self._serve_for(plan)
        tracer = self.telemetry.tracer if self.telemetry else None
        t0 = tracer.wall_now() if tracer is not None else 0.0
        if isinstance(self.mesh, ProcessMesh):
            self.mesh.broadcast_object(
                ("run", plan, tuple(to_numpy(x) for x in (batch.terms, batch.rects, batch.amps))))
        ids, scores, stats = serve(self._index, batch)
        if tracer is not None:
            label = plan.label if plan is not None else self.algorithm
            tracer.span(
                "mesh step", f"serve[{label}]", t0, tracer.wall_now(),
                args={"batch": int(batch.terms.shape[0])},
            )
        return alg.TopKResult(ids=ids, scores=scores, stats={k: to_numpy(v) for k, v in stats.items()})

    def serve_forever(self) -> int:
        """Every rank but 0 of a process mesh: run the step on each batch
        rank 0 broadcasts, until its :meth:`close`.  Returns the number of
        batches run."""
        if not self._follower():
            raise RuntimeError("serve_forever runs on the ranks other than 0 of a process mesh")
        n = 0
        while True:
            msg = self.mesh.broadcast_object()
            if msg[0] == "stop":
                self._closed = True
                return n
            _, plan, arrays = msg
            self._serve_for(plan)(self._index, alg.QueryBatch(*map(torch.from_numpy, arrays)))
            n += 1

    def close(self) -> None:
        """On rank 0 of a process mesh: end the other ranks'
        :meth:`serve_forever` (once).  Nothing elsewhere."""
        if isinstance(self.mesh, ProcessMesh) and not self._follower() and not self._closed:
            self._closed = True
            self.mesh.broadcast_object(("stop",))
