"""Query plans (port of the ``QueryPlan`` part of ``repro/core/planner.py``).

A plan is (algorithm, budgets, fused flag): everything the engine needs to
run one pipeline variant.  Plans are frozen and hashable and key the
engine's function cache.  The cost-based ``Planner`` arrives with a later
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import algorithms as alg


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
