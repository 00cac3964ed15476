"""Planner audit log: predicted vs measured cost per planned query (port
of ``repro/obs/audit.py``).

The cost-based planner picks an algorithm per query from predicted
``n_probes`` / ``bytes_postings`` / ``bytes_spatial``.  Those predictions
are only as good as their calibration — and calibration is only as good
as the evidence.  This module makes the evidence a first-class artifact:
for every planned cache miss the server records

* the query's :class:`~repro_torch.core.planner.QueryFeatures` (as a dict),
* every candidate plan's predicted counters + total cost,
* the chosen plan label,

and after the batch executes, the per-row **measured** counters from the
executor's stats are joined back onto the record.  The result is a JSONL
file where each line is one planned query with prediction and ground
truth side by side, plus :meth:`PlannerAudit.error_summary` — mean
relative prediction error per ``(algo, counter)`` — which is exactly the
signal :meth:`~repro_torch.core.planner.CostModel.calibrate` consumes.

Audit records reference queries by the server's ``qid`` (coalesced
followers share the leader's record; only the leader is planned).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

# counters present in both predictions and executor stats
COST_KEYS = ("n_probes", "bytes_postings", "bytes_spatial")


@dataclass
class AuditRecord:
    qid: int
    idx: int  # trace position
    features: dict
    candidates: dict  # label -> {algorithm, n_probes, bytes_*, cost, ...}
    chosen: str
    t_plan: float  # virtual/wall arrival-clock time of planning
    measured: dict | None = None  # joined post-execution

    def errors(self) -> dict[str, float] | None:
        """Per-counter relative error |pred - meas| / max(meas, 1)."""
        if self.measured is None:
            return None
        pred = self.candidates[self.chosen]
        out = {}
        for k in COST_KEYS:
            if k in pred and k in self.measured:
                m = float(self.measured[k])
                out[k] = abs(float(pred[k]) - m) / max(m, 1.0)
        return out


@dataclass
class PlannerAudit:
    """Accumulates audit records; joined lazily as batches complete."""

    records: list[AuditRecord] = field(default_factory=list)
    _by_qid: dict[int, AuditRecord] = field(default_factory=dict)

    def record(
        self,
        qid: int,
        idx: int,
        features: dict,
        candidates: dict,
        chosen: str,
        t_plan: float,
    ) -> None:
        rec = AuditRecord(qid, idx, features, candidates, chosen, t_plan)
        self.records.append(rec)
        self._by_qid[qid] = rec

    def join(self, qid: int, measured: dict) -> None:
        """Attach post-execution measured counters to a planned query."""
        rec = self._by_qid.get(qid)
        if rec is not None:
            rec.measured = measured

    # ------------------------------------------------------------------
    @property
    def joined(self) -> list[AuditRecord]:
        return [r for r in self.records if r.measured is not None]

    def error_summary(self) -> dict[tuple[str, str], float]:
        """Mean relative prediction error per (chosen algo, counter)."""
        sums: dict[tuple[str, str], float] = {}
        counts: dict[tuple[str, str], int] = {}
        for rec in self.joined:
            algo = rec.candidates[rec.chosen].get("algorithm", rec.chosen)
            for k, e in (rec.errors() or {}).items():
                key = (algo, k)
                sums[key] = sums.get(key, 0.0) + e
                counts[key] = counts.get(key, 0) + 1
        return {k: sums[k] / counts[k] for k in sums}

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(
                    json.dumps(
                        {
                            "qid": rec.qid,
                            "idx": rec.idx,
                            "t_plan_s": rec.t_plan,
                            "features": rec.features,
                            "candidates": rec.candidates,
                            "chosen": rec.chosen,
                            "measured": rec.measured,
                            "errors": rec.errors(),
                        }
                    )
                    + "\n"
                )
