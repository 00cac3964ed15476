"""Batch executors (port of ``repro/serving/executor.py``).

The executor is the serving layer's view of the engine: it takes a padded
:class:`~repro_torch.core.algorithms.QueryBatch` and returns a
:class:`~repro_torch.core.algorithms.TopKResult`.  The single-device
executor serves ``k_sweep``, ``text_first``, ``geo_first`` and ``auto``:
under ``auto`` it holds a cost-based
:class:`~repro_torch.core.planner.Planner` over its engine, so the serving
layer can ask :meth:`SingleDeviceExecutor.plan_query` for each query's
cheapest plan before batching; fixed-algorithm executors return ``None``
there.  The sharded and mesh executors arrive with the distributed slice,
and a telemetry handle with the obs slice; until then both raise
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.core import algorithms as alg
from repro_torch.core.engine import GeoSearchEngine
from repro_torch.core.planner import Planner, QueryPlan


def reject_telemetry(telemetry) -> None:
    """``None`` is accepted (no telemetry); any handle raises until the obs
    slice ports ``repro.obs``."""
    if telemetry is not None:
        raise NotImplementedError(
            "telemetry is not ported yet: the metrics, tracer, audit and event "
            "sinks arrive with the obs slice; pass telemetry=None"
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
        reject_telemetry(telemetry)

    def plan_query(self, terms, rects, amps) -> QueryPlan | None:
        """Cheapest plan for one query; ``None`` when the algorithm is fixed."""
        if self.planner is None:
            return None
        return self.planner.plan_query(terms, rects, amps)

    def run(
        self, batch: alg.QueryBatch, plan: QueryPlan | None = None
    ) -> alg.TopKResult:
        if plan is not None:
            return self.engine.query(batch, plan=plan, **self.kw)
        return self.engine.query(batch, self.algorithm, **self.kw)
