"""Observability for the serving pipeline: metrics, spans, audit, events
(port of ``repro/obs``; plain Python, no tensors).

Everything hangs off one :class:`Telemetry` handle.  A server built with
``telemetry=None`` (the default) pays **zero** overhead — every hook in
the hot path is guarded by a single truthiness check and the telemetry
branches never run.  A server built with ``Telemetry()`` records:

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  log-bucketed histograms from every pipeline stage (``.metrics``);
* :class:`~repro_torch.obs.tracing.SpanRecorder` — per-query, per-batch and
  per-shard spans, exportable as Chrome/Perfetto trace JSON (``.tracer``);
* :class:`~repro_torch.obs.audit.PlannerAudit` — predicted vs measured cost
  per planned query (``.audit``, only populated under ``algorithm=auto``);
* :class:`~repro_torch.obs.events.EventLog` — flush/dispatch/complete/evict/
  coalesce/expire JSONL events (``.events``).

Each component can be disabled individually (pass ``None``); the handle
is falsy only when *all* components are off.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .audit import COST_KEYS, AuditRecord, PlannerAudit
from .events import EventLog
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import BatchSpan, ExecSpan, QuerySpan, SpanRecorder
from .validate import validate_trace

__all__ = [
    "Telemetry",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "SpanRecorder",
    "QuerySpan",
    "BatchSpan",
    "ExecSpan",
    "PlannerAudit",
    "AuditRecord",
    "COST_KEYS",
    "EventLog",
    "validate_trace",
]


def _default_metrics():
    return MetricsRegistry()


def _default_tracer():
    return SpanRecorder()


def _default_audit():
    return PlannerAudit()


def _default_events():
    return EventLog()


@dataclass
class Telemetry:
    """Bundle of all telemetry sinks; pass to ``GeoServer(telemetry=...)``."""

    metrics: MetricsRegistry | None = field(default_factory=_default_metrics)
    tracer: SpanRecorder | None = field(default_factory=_default_tracer)
    audit: PlannerAudit | None = field(default_factory=_default_audit)
    events: EventLog | None = field(default_factory=_default_events)

    def __bool__(self) -> bool:
        return (
            self.metrics is not None
            or self.tracer is not None
            or self.audit is not None
            or self.events is not None
        )
