"""Metrics registry: counters, gauges, log-bucketed histograms (port of
``repro/obs/metrics.py``).

The paper argues per-query cost accounting is what makes a geo engine's
algorithm choices defensible; this module is the serving stack's ledger
for exactly that.  Every pipeline stage (server, batcher, cache, pending
table, executors, planner) publishes into one :class:`MetricsRegistry`
under a stable dotted naming scheme:

    server.queries_total            counter   one per served query
    server.cache_hits_total         counter
    server.cache_misses_total       counter
    server.coalesced_total          counter   misses served by a twin
    server.latency_ms               histogram end-to-end latency
    server.batch_wait_ms            histogram arrival -> bucket flush
    server.queue_wait_ms            histogram flush -> worker pickup
    server.service_ms               histogram batch execution share
    batcher.flush_total{reason=}    counter   fill | deadline | drain
    batcher.batch_real_queries      histogram real rows per flushed batch
    batcher.pad_slots / real_slots  gauge     cumulative padding ledger
    cache.evictions_total           counter
    pending.expired_total           counter   coalesce windows closed
    executor.batches_total{plan=}   counter
    executor.<stat>_total{plan=}    counter   bytes_*, n_probes, seeks, ...
    executor.text_blocks_skipped_total{plan=}
                                    counter   driver posting blocks whose
                                              bytes never streamed (pruned
                                              TEXT-FIRST θ-skips; pair
                                              with text_blocks_total for
                                              the skip rate)
    executor.shards_touched{plan=}  histogram shard fan-out per routed query
                                              (footprint routing only;
                                              broadcast never emits it)
    engine.compiled_fns_total       counter   plan x shape jit programs
    planner.tp_span_probe           counter   block MBRs tested per query
                                              (bbox-grid candidates only)

Histograms are **log-bucketed**: bucket ``i`` covers
``[lo * growth^(i-1), lo * growth^i)`` so a fixed number of buckets spans
microseconds to minutes, and :meth:`Histogram.quantile` reconstructs any
percentile to within one bucket width of the exact order statistic — tight
enough that the serving report's ``percentile_ms`` and the histogram
export agree to the bucket (asserted in the telemetry tests).

Exports: :meth:`MetricsRegistry.to_prometheus` (text exposition format)
and :meth:`MetricsRegistry.to_json` (one dict per metric, histograms with
explicit bucket bounds + reconstructed p50/p99).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted(labels.items())) if labels else ()


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


@dataclass
class Counter:
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


@dataclass
class Gauge:
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


@dataclass
class Histogram:
    """Log-bucketed histogram with exact-to-one-bucket quantiles.

    ``lo`` is the smallest resolvable value (everything at or below it
    lands in bucket 0); bucket widths grow geometrically by ``growth``.
    The defaults resolve 0.1 us to ~20 min when observing milliseconds,
    with ~19% relative bucket width (growth = 2^0.25).
    """

    lo: float = 1e-4
    growth: float = 2.0 ** 0.25
    counts: dict[int, int] = field(default_factory=dict)
    n: int = 0
    sum: float = 0.0

    def observe(self, value: float) -> None:
        i = self._index(value)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.sum += value

    def _index(self, value: float) -> int:
        if value <= self.lo:
            return 0
        return int(math.log(value / self.lo) / math.log(self.growth)) + 1

    def bucket_bounds(self, i: int) -> tuple[float, float]:
        """``[lo_edge, hi_edge)`` of bucket ``i`` (bucket 0 is ``[0, lo)``)."""
        if i <= 0:
            return (0.0, self.lo)
        return (self.lo * self.growth ** (i - 1), self.lo * self.growth ** i)

    def quantile(self, p: float) -> float:
        """Percentile ``p`` in [0, 100], reconstructed from the buckets.

        Returns the geometric midpoint of the bucket holding the
        ``p``-th order statistic — within one bucket width of the exact
        (numpy linear-interpolated) percentile by construction.
        """
        if self.n == 0:
            return float("nan")
        target = p / 100.0 * (self.n - 1)
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum > target:
                lo, hi = self.bucket_bounds(i)
                return math.sqrt(lo * hi) if lo > 0 else hi / 2.0
        lo, hi = self.bucket_bounds(max(self.counts))
        return math.sqrt(lo * hi) if lo > 0 else hi / 2.0

    def same_or_adjacent_bucket(self, value: float, other: float) -> bool:
        """True when two values fall in the same or neighboring buckets —
        the histogram-reconstruction accuracy contract."""
        return abs(self._index(value) - self._index(other)) <= 1


class MetricsRegistry:
    """Name + label-keyed store of counters / gauges / histograms."""

    def __init__(self) -> None:
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    # ------------------------------------------------------------------
    def counter(self, name: str, labels: dict | None = None) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, labels: dict | None = None) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram()
        return h

    # convenience single-call forms (the serving hot path uses these)
    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        self.counter(name, labels or None).inc(amount)

    def set(self, name: str, value: float, **labels) -> None:
        self.gauge(name, labels or None).set(value)

    def observe(self, name: str, value: float, **labels) -> None:
        self.histogram(name, labels or None).observe(value)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    @staticmethod
    def _prom_name(name: str) -> str:
        return name.replace(".", "_").replace("-", "_")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (counters, gauges, histograms
        with cumulative ``_bucket{le=}`` series)."""
        lines: list[str] = []
        typed: set[str] = set()

        def header(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, lk), c in sorted(self._counters.items()):
            pn = self._prom_name(name)
            header(pn, "counter")
            lines.append(f"{pn}{_label_str(lk)} {c.value:g}")
        for (name, lk), g in sorted(self._gauges.items()):
            pn = self._prom_name(name)
            header(pn, "gauge")
            lines.append(f"{pn}{_label_str(lk)} {g.value:g}")
        for (name, lk), h in sorted(self._histograms.items()):
            pn = self._prom_name(name)
            header(pn, "histogram")
            cum = 0
            for i in sorted(h.counts):
                cum += h.counts[i]
                le = h.bucket_bounds(i)[1]
                lk_le = lk + (("le", f"{le:g}"),)
                lines.append(f"{pn}_bucket{_label_str(lk_le)} {cum}")
            lk_inf = lk + (("le", "+Inf"),)
            lines.append(f"{pn}_bucket{_label_str(lk_inf)} {h.n}")
            lines.append(f"{pn}_sum{_label_str(lk)} {h.sum:g}")
            lines.append(f"{pn}_count{_label_str(lk)} {h.n}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """One JSON-serializable dict per metric; histograms carry explicit
        bucket bounds plus reconstructed p50/p99."""
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, lk), c in sorted(self._counters.items()):
            out["counters"][name + _label_str(lk)] = c.value
        for (name, lk), g in sorted(self._gauges.items()):
            out["gauges"][name + _label_str(lk)] = g.value
        for (name, lk), h in sorted(self._histograms.items()):
            out["histograms"][name + _label_str(lk)] = {
                "count": h.n,
                "sum": h.sum,
                "p50": h.quantile(50),
                "p99": h.quantile(99),
                "buckets": [
                    [*h.bucket_bounds(i), h.counts[i]] for i in sorted(h.counts)
                ],
            }
        return out
