"""Batch executors (port of ``repro/serving/executor.py``).

The executor is the serving layer's view of the engine: it takes a padded
:class:`~repro_torch.core.algorithms.QueryBatch` and returns a
:class:`~repro_torch.core.algorithms.TopKResult`.  The single-device
executor serves ``k_sweep``, ``text_first`` and ``geo_first``; the sharded
and mesh executors, telemetry and the ``auto`` planner are not ported yet.
"""
from __future__ import annotations

from repro_torch.core import algorithms as alg
from repro_torch.core.engine import GeoSearchEngine
from repro_torch.core.planner import QueryPlan


class SingleDeviceExecutor:
    """Run batches through one engine on its device."""

    def __init__(self, engine: GeoSearchEngine, algorithm: str = "k_sweep", **kw):
        if algorithm == "auto":
            raise NotImplementedError(
                "algorithm='auto' needs the cost-based planner, which is not ported yet"
            )
        self.engine = engine
        self.algorithm = algorithm
        self.kw = kw

    @property
    def top_k(self) -> int:
        return self.engine.budgets.top_k

    def run(
        self, batch: alg.QueryBatch, plan: QueryPlan | None = None
    ) -> alg.TopKResult:
        if plan is not None:
            return self.engine.query(batch, plan=plan, **self.kw)
        return self.engine.query(batch, self.algorithm, **self.kw)
