"""GeoServer: the trace-driven serve loop, closed- and open-loop (port of
``repro/serving/server.py``).

One query's life:

1. **fingerprint** — the raw (terms, rects, amps) triple is normalized
   (:mod:`repro_torch.serving.fingerprint`); near-duplicate searches collide.
2. **cache lookup** — a hit returns the cached top-k immediately; its
   latency is just the lookup.
3. **coalesce check** (optional) — a miss whose fingerprint is already in
   a queued or executing batch *subscribes* to that batch's pending result
   (:mod:`repro_torch.serving.pending`) instead of re-enqueueing.
4. **planner** (optional) — when the executor runs ``algorithm="auto"``,
   the miss is routed through the cost-based planner
   (:mod:`repro_torch.core.planner`): cheap host-side features pick the
   cheapest :class:`QueryPlan` (text-first / geo-first / K-SWEEP) for
   *this* query.  Fixed-algorithm executors skip this stage (plan
   ``None``), bit-identically to the pre-planner server.
5. **batcher** — remaining misses queue in their (plan, terms, rects)
   bucket — buckets are *plan-homogeneous*, so a flushed batch runs one
   plan only; the bucket flushes when it fills *or* when its
   oldest query's deadline (``max_wait_s``) expires
   (:class:`~repro_torch.serving.batcher.DeadlineBatcher`).
6. **dispatch queue → workers** — flushed batches enter a FIFO dispatch
   queue; each of ``n_workers`` executor slots picks up the next batch
   when free, so sharded/mesh executor batches can overlap.
7. **executor** — the batch runs on the engine (single device or sharded
   scatter-gather) under the batch's plan; per-query rows are scattered
   back to their submitters and to any coalesced subscribers, and the
   batch's byte counters / latencies are attributed to its plan in the
   report's per-plan breakdown.
8. **cache fill** — each executed query's result is inserted with its
   *cost* (its share of the batch's measured execution time — the Landlord
   eviction credit) and its *size* (the top-k payload bytes — the Landlord
   byte-budget admission input).

``run_trace`` supports two replay disciplines:

* **closed-loop** (``arrival="closed"``): the next query is
  released as soon as the previous one is handled; wall-clock timing; the
  worker pool degenerates to the one real executor (``n_workers`` must be
  1 — there is only one wall clock).
* **open-loop** (any other ``arrival`` label): queries are released at the
  ``arrival_s`` stamps on the trace regardless of server progress, as an
  event-driven discrete-event simulation over a virtual clock.  Service
  durations are *measured* on the real executor (or supplied via
  ``service_time`` for deterministic tests) and charged to the earliest-
  free of ``n_workers`` parallel worker timelines (``n_workers=1`` is the
  single-busy-server model, bit-identically), so queueing delay
  under burst is modeled, not hidden.  Per-query latency is decomposed
  exactly into **batch-wait** (arrival → bucket flush) + **queue-wait**
  (flush → a worker frees up) + **service** (batch execution); coalesced
  queries are charged the same three stages against their twin batch's
  timeline, clamped at their own arrival, so the decomposition still sums
  exactly to total latency for every query.

Batches stay host numpy until the executor boundary: :meth:`GeoServer.
_to_query_batch` wraps them as CPU tensors and the engine moves them to its
device; :meth:`GeoServer._finish_batch` copies ids, scores and every stats
counter back to the host before the batch's completion time is read, so a
measured service time covers finished device work, not a queued launch.
The warmup runs one inert batch per predicted shape and waits for the
device, so each kernel's first launch never lands in a timed batch.  With a
:class:`~repro_torch.obs.Telemetry` handle the server records the
reference's metrics, spans, planner audit and events; they read only values
the serve loop already holds on the host (the stats ``_finish_batch``
copied), so they add no device synchronization and change no result.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.corpus.synth import TraceQuery
from repro_torch.device import to_numpy
from repro_torch.serving.batcher import (
    DeadlineBatcher,
    PendingQuery,
    RawBatch,
    ShapeBucketedBatcher,
)
from repro_torch.serving.fingerprint import query_fingerprint
from repro_torch.serving.pending import PendingTable


@dataclass
class QueryResult:
    ids: np.ndarray  # i32[k]
    scores: np.ndarray  # f32[k]


@dataclass
class BatchEvent:
    """One executed batch on the (virtual or wall) timeline."""

    flush_t: float  # batcher emitted the batch (enters dispatch queue)
    start_t: float  # a worker picked it up
    done_t: float  # execution finished
    worker: int  # worker slot that ran it
    n_real: int  # real (non-padding) queries in the batch


@dataclass
class ServeReport:
    n_queries: int = 0
    wall_s: float = 0.0
    latencies_s: list[float] = field(default_factory=list)
    cache_hits: int = 0
    cache_misses: int = 0
    coalesced: int = 0  # misses served by subscribing to an in-flight twin
    n_batches: int = 0
    n_workers: int = 1
    pad_slots: int = 0
    real_slots: int = 0
    element_padding_overhead: float = 0.0
    n_compiled_shapes: int = 0
    stats: dict[str, float] = field(default_factory=dict)  # summed byte counters
    shapes_used: set = field(default_factory=set)  # distinct shapes this run
    # latency decomposition (one entry per query, same order as latencies_s)
    batch_wait_s: list[float] = field(default_factory=list)
    queue_wait_s: list[float] = field(default_factory=list)
    service_s: list[float] = field(default_factory=list)
    # dispatch timeline, one entry per executed batch in dispatch order
    batch_events: list[BatchEvent] = field(default_factory=list)
    # per-plan attribution: executed/coalesced query counts, latencies and
    # summed byte counters keyed by plan label (fixed-algorithm serving
    # attributes everything to the executor's single algorithm)
    plan_queries: dict = field(default_factory=dict)  # label -> int
    plan_latencies_s: dict = field(default_factory=dict)  # label -> [float]
    plan_stats: dict = field(default_factory=dict)  # label -> {ctr: float}
    # shard fan-out per plan (footprint-routed executors only): label ->
    # {"queries", "shards_touched", "batches", "shards_visited"} — the
    # per-query mean shards-touched is the routing win the paper argues for
    routing: dict = field(default_factory=dict)
    # per-trace-position results (run_trace(collect_results=True) only)
    results: list | None = None
    arrival: str = "closed"
    slo_ms: float | None = None

    @property
    def qps(self) -> float:
        return self.n_queries / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0

    @property
    def padding_overhead(self) -> float:
        total = self.pad_slots + self.real_slots
        return self.pad_slots / total if total else 0.0

    @property
    def slo_attainment(self) -> float:
        """Fraction of queries whose end-to-end latency met ``slo_ms``."""
        if self.slo_ms is None or not self.latencies_s:
            return 1.0
        lat = np.asarray(self.latencies_s)
        return float((lat <= self.slo_ms * 1e-3).mean())

    def percentile_ms(self, p: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), p) * 1e3)

    def stage_percentile_ms(self, stage: str, p: float) -> float:
        """Percentile of one latency component: batch_wait|queue_wait|service.

        NaN when the stage has no samples — "never ran" must be
        distinguishable from "ran in 0ms" on a dashboard.
        """
        xs = getattr(self, f"{stage}_s")
        if not xs:
            return float("nan")
        return float(np.percentile(np.asarray(xs), p) * 1e3)

    def plan_percentile_ms(self, label: str, p: float) -> float:
        """Latency percentile of the queries served under one plan; NaN
        when no query ran under ``label`` (same contract as
        :meth:`stage_percentile_ms`)."""
        xs = self.plan_latencies_s.get(label)
        if not xs:
            return float("nan")
        return float(np.percentile(np.asarray(xs), p) * 1e3)

    def _record_plan(self, label: str, latency_s: float) -> None:
        self.plan_queries[label] = self.plan_queries.get(label, 0) + 1
        self.plan_latencies_s.setdefault(label, []).append(latency_s)

    def routing_mean(self, label: str) -> float:
        """Mean shards-touched per executed query under one plan; NaN when
        no routed batch ran under ``label`` (same contract as
        :meth:`plan_percentile_ms`)."""
        r = self.routing.get(label)
        if not r or not r["queries"]:
            return float("nan")
        return r["shards_touched"] / r["queries"]

    def summary(self) -> str:
        per_q = {
            k: v / max(self.n_queries, 1)
            for k, v in sorted(self.stats.items())
            if k.startswith("bytes_") or k in ("seeks", "n_probes", "candidates")
        }
        lines = [
            f"queries={self.n_queries}  qps={self.qps:,.1f}  "
            f"p50={self.percentile_ms(50):.3f}ms  p99={self.percentile_ms(99):.3f}ms  "
            f"hit_rate={self.hit_rate:.3f}  batches={self.n_batches}  "
            f"padding={self.padding_overhead:.3f}  "
            f"elem_padding={self.element_padding_overhead:.3f}  "
            f"shapes={self.n_compiled_shapes}"
        ]
        if len(self.plan_queries) > 1:
            # NaN percentile = no latency samples under that plan: omit
            # the p50/p99 parenthetical, keep the count
            mix = "  ".join(
                f"{label}={n} (p50/p99="
                f"{self.plan_percentile_ms(label, 50):.3f}/"
                f"{self.plan_percentile_ms(label, 99):.3f}ms)"
                if self.plan_latencies_s.get(label)
                else f"{label}={n}"
                for label, n in sorted(self.plan_queries.items())
            )
            lines.append(f"plans: {mix}")
        if self.routing:
            fan = "  ".join(
                f"{label}: shards/q={self.routing_mean(label):.2f} "
                f"visited/batch="
                f"{r['shards_visited'] / max(r['batches'], 1):.2f}"
                for label, r in sorted(self.routing.items())
            )
            lines.append(f"routing: {fan}")
        if self.batch_wait_s:
            decomp = "  ".join(
                f"{stage}_p50/p99={self.stage_percentile_ms(stage, 50):.3f}/"
                f"{self.stage_percentile_ms(stage, 99):.3f}ms"
                for stage in ("batch_wait", "queue_wait", "service")
                if getattr(self, f"{stage}_s")
            )
            slo = (
                f"  slo_{self.slo_ms:g}ms={self.slo_attainment:.3f}"
                if self.slo_ms is not None
                else ""
            )
            lines.append(
                f"arrival={self.arrival}  workers={self.n_workers}  "
                f"coalesced={self.coalesced}  {decomp}{slo}"
            )
        if self.stats.get("text_blocks_total"):
            # pruned TEXT-FIRST only: share of driver posting blocks whose
            # bytes never streamed (θ-skipped, incl. monotone tail cuts)
            skipped = self.stats.get("text_blocks_skipped", 0.0)
            total = self.stats["text_blocks_total"]
            lines.append(
                f"text block skip rate={skipped / total:.3f} "
                f"({skipped:,.0f}/{total:,.0f} blocks)"
            )
        lines.append("  ".join(f"{k}/q={v:,.0f}" for k, v in per_q.items()))
        return "\n".join(lines)


class GeoServer:
    """Cache → coalesce → deadline batcher → worker pool, over a query trace."""

    def __init__(
        self,
        executor,
        cache=None,
        batcher: ShapeBucketedBatcher | None = None,
        fingerprint_quant: int = 128,
        n_workers: int = 1,
        coalesce: bool = False,
        telemetry=None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.executor = executor
        self.cache = cache
        self.batcher = batcher or DeadlineBatcher()
        self.fingerprint_quant = fingerprint_quant
        self.n_workers = n_workers
        self.coalesce = coalesce
        # repro_torch.obs.Telemetry handle, or None: every telemetry branch
        # in the serve loop is behind a single `if self.telemetry` check, so
        # a server built without one runs the telemetry-free code path
        self.telemetry = telemetry
        if telemetry:
            attach = getattr(executor, "attach_telemetry", None)
            if attach is not None:  # test doubles need no telemetry surface
                attach(telemetry)
        # qid → (fingerprint key, arrival time, trace position)
        self._inflight: dict[int, tuple[tuple, float, int]] = {}
        # id(TraceQuery) → QueryPlan, per run_trace: the warmup's shape
        # prediction and the live loop plan the same objects, and zipf
        # traces repeat pool entries — plan each object once
        self._plan_cache: dict[int, object] = {}
        self._next_qid = 0
        # per-worker busy-until times (virtual seconds, open loop)
        self._workers: list[float] = [0.0] * n_workers
        # open-loop cache fills deferred to their batch's virtual completion:
        # a (done_time, seq, key, value, cost) min-heap — dispatch order is
        # NOT completion order once workers overlap, so a fast batch behind
        # a slow one must still become visible at its own done time
        self._pending_fills: list[tuple[float, int, tuple, QueryResult, float]] = []
        self._fill_seq = itertools.count()
        # fingerprint → in-flight batch subscription (coalescing)
        self._pending = PendingTable() if coalesce else None

    # ------------------------------------------------------------------
    def run_trace(
        self,
        trace: list[TraceQuery],
        warmup: bool = True,
        arrival: str = "closed",
        slo_ms: float | None = None,
        service_time=None,
        collect_results: bool = False,
    ) -> ServeReport:
        """Serve a whole trace; returns the metrics report.

        ``arrival="closed"`` replays back-to-back on the wall clock.
        Any other label replays **open-loop**: queries enter at their
        ``arrival_s`` stamps on a virtual clock and queue when the worker
        pool falls behind.  ``service_time`` (optional, ``RawBatch ->
        seconds``) replaces measured execution time in the virtual
        timeline, making open-loop replay fully deterministic for tests;
        cache-hit lookup latency is likewise pinned to zero when it is
        supplied.

        ``collect_results=True`` additionally stores every query's top-k
        (:class:`QueryResult`) in ``report.results``, aligned with the
        input ``trace`` positions — hits get the cached value, executed
        misses their batch row, coalesced misses their twin's row.

        ``warmup=True`` runs one inert batch of each shape the trace will
        emit (predicted by replaying the cache/batcher decisions host-side)
        before the timed loop, so latency percentiles measure serving, not
        first launches (the kernels' build and module load, the allocator's
        first requests).
        """
        open_loop = arrival != "closed"
        if open_loop and not isinstance(self.batcher, DeadlineBatcher):
            raise ValueError("open-loop replay requires a DeadlineBatcher")
        if not open_loop and self.n_workers != 1:
            raise ValueError(
                "closed-loop replay times one real executor on the wall clock; "
                "n_workers > 1 requires open-loop arrivals"
            )
        report = ServeReport(arrival=arrival, slo_ms=slo_ms)
        report.n_workers = self.n_workers
        self._plan_cache.clear()  # trace objects may be reused across runs
        if collect_results:
            report.results = [None] * len(trace)
        if warmup and trace:
            self._warmup(trace, open_loop)
        # snapshot cumulative batcher counters so the report is per-run
        b = self.batcher
        base = (b.pad_slots, b.real_slots, b.pad_elements, b.real_elements)
        if open_loop:
            self._run_open(trace, report, service_time)
        else:
            self._run_closed(trace, report)
        report.pad_slots = b.pad_slots - base[0]
        report.real_slots = b.real_slots - base[1]
        pad_el, real_el = b.pad_elements - base[2], b.real_elements - base[3]
        report.element_padding_overhead = (
            pad_el / (pad_el + real_el) if pad_el + real_el else 0.0
        )
        report.n_compiled_shapes = len(report.shapes_used)
        if self.telemetry and self.telemetry.metrics is not None:
            m = self.telemetry.metrics
            m.set("batcher.pad_slots", report.pad_slots)
            m.set("batcher.real_slots", report.real_slots)
        assert not self._inflight, "batcher dropped in-flight queries"
        if self._pending is not None:
            n_left = self._pending.unresolved_subscribers()
            assert n_left == 0, "coalesced queries left unresolved"
        return report

    # ------------------------------------------------------------------
    def _lookup(self, q: TraceQuery):
        if self.cache is None and not self.coalesce:
            return None, None  # no consumer → fingerprinting is pure overhead
        key = query_fingerprint(q.terms, q.rects, q.amps, quant=self.fingerprint_quant)
        hit = self.cache.get(key) if self.cache is not None else None
        return key, hit

    def _plan_for(self, q: TraceQuery):
        """Ask the executor's planner for this query's plan (None = fixed).

        Memoized by trace-object identity for the current ``run_trace`` —
        the warmup replay and the live loop see the same objects (and zipf
        traces repeat them), so each query is planned exactly once.
        """
        plan_fn = getattr(self.executor, "plan_query", None)
        if plan_fn is None:
            return None
        key = id(q)
        if key not in self._plan_cache:
            self._plan_cache[key] = plan_fn(q.terms, q.rects, q.amps)
        return self._plan_cache[key]

    def _plan_label(self, raw: RawBatch) -> str:
        if raw.plan is not None:
            return raw.plan.label
        return getattr(self.executor, "algorithm", "fixed")

    @staticmethod
    def _set_result(report: ServeReport, idx: int, value) -> None:
        if report.results is not None:
            report.results[idx] = value

    def _run_closed(self, trace: list[TraceQuery], report: ServeReport) -> None:
        """Wall-clock loop + deadline flushes discovered between queries."""
        deadline_aware = isinstance(self.batcher, DeadlineBatcher)
        if self._pending is not None:
            self._pending.clear()
        t_start = time.perf_counter()
        for idx, q in enumerate(trace):
            t_arr = time.perf_counter() - t_start
            if deadline_aware:
                dl = self.batcher.next_deadline()
                if dl is not None and dl <= t_arr:
                    for raw in self.batcher.due(t_arr):
                        self._execute(
                            raw, report, flush_t=t_arr, t0=t_start,
                            reason="deadline",
                        )
            key, hit = self._lookup(q)
            if hit is not None:
                report.cache_hits += 1
                self._count("server.cache_hits_total")
                lookup_s = time.perf_counter() - t_start - t_arr
                self._record(
                    report, lookup_s, 0.0, 0.0, lookup_s,
                    t_arr=t_arr, idx=idx, kind="hit",
                )
                self._set_result(report, idx, hit)
                report.n_queries += 1
                continue
            report.cache_misses += 1
            self._count("server.cache_misses_total")
            # coalesce: the twin is still waiting in a batcher bucket
            # (closed-loop has no post-flush window — execution is
            # synchronous with the flush on the wall clock)
            if self._pending is not None:
                entry = self._pending.lookup(key, t_arr)
                if entry is not None:
                    report.coalesced += 1
                    self._coalesce_event(t_arr, entry.owner_qid, idx)
                    entry.subscribers.append((t_arr, idx))
                    report.n_queries += 1
                    continue
            qid = self._next_qid
            self._next_qid += 1
            self._inflight[qid] = (key, t_arr, idx)
            if self._pending is not None:
                self._pending.register(key, qid)
            plan = self._plan_for(q)
            self._audit_plan(qid, idx, q, plan, t_arr)
            pending = PendingQuery(qid, q.terms, q.rects, q.amps, plan)
            raws = (
                self.batcher.add(pending, t_arr)
                if deadline_aware
                else self.batcher.add(pending)
            )
            for raw in raws:
                self._execute(
                    raw, report, flush_t=t_arr, t0=t_start, reason="fill"
                )
            report.n_queries += 1
        t_end = time.perf_counter() - t_start
        for raw in self.batcher.flush():
            self._execute(raw, report, flush_t=t_end, t0=t_start, reason="drain")
        report.wall_s = time.perf_counter() - t_start

    def _run_open(self, trace, report: ServeReport, service_time) -> None:
        """Discrete-event open-loop replay over the trace's arrival stamps.

        Flushed batches enter a FIFO dispatch queue; each of ``n_workers``
        executor slots picks up the next batch the moment it frees up
        (equivalently: a batch's start time is ``max(flush_t, earliest
        worker-free time)`` in flush order — work-conserving by
        construction; the reference property-tests it, and the port's tests
        hold this loop's reports equal to the reference's).
        """
        b: DeadlineBatcher = self.batcher
        order = sorted(range(len(trace)), key=lambda i: trace[i].arrival_s)
        self._workers = [0.0] * self.n_workers
        self._pending_fills.clear()
        if self._pending is not None:
            self._pending.clear()
        t_first = trace[order[0]].arrival_s if trace else 0.0
        t_last = trace[order[-1]].arrival_s if trace else 0.0
        for idx in order:
            q = trace[idx]
            now = q.arrival_s
            # fire every deadline timer that expires before this arrival
            while True:
                dl = b.next_deadline()
                if dl is None or dl > now:
                    break
                for raw in b.due(dl):
                    self._execute_open(
                        raw, report, flush_t=dl, service_time=service_time,
                        reason="deadline",
                    )
            # apply fills AFTER the deadline loop: a deadline batch that
            # completed before `now` must be visible to this very lookup
            # (it triggered the lazy flush), as it would be on a live server
            self._apply_fills(now)
            if self._pending is not None:
                self._expire_pending(now)
            t_lk = time.perf_counter()
            key, hit = self._lookup(q)
            if hit is not None:
                report.cache_hits += 1
                self._count("server.cache_hits_total")
                # a hit's latency is just the (real, measured) lookup; zero
                # under an injected service model so tests are deterministic
                lookup_s = (
                    0.0 if service_time is not None else time.perf_counter() - t_lk
                )
                self._record(
                    report, lookup_s, 0.0, 0.0, lookup_s,
                    t_arr=now, idx=idx, kind="hit",
                )
                self._set_result(report, idx, hit)
                report.n_queries += 1
                continue
            report.cache_misses += 1
            self._count("server.cache_misses_total")
            # coalesce: subscribe to an in-flight twin (queued in a bucket,
            # waiting for a worker, or executing) instead of re-enqueueing
            if self._pending is not None:
                entry = self._pending.lookup(key, now)
                if entry is not None:
                    report.coalesced += 1
                    self._coalesce_event(now, entry.owner_qid, idx)
                    if entry.dispatched:
                        self._record_coalesced(report, entry, now, idx)
                    else:
                        entry.subscribers.append((now, idx))
                    report.n_queries += 1
                    continue
            qid = self._next_qid
            self._next_qid += 1
            self._inflight[qid] = (key, now, idx)
            if self._pending is not None:
                self._pending.register(key, qid)
            plan = self._plan_for(q)
            self._audit_plan(qid, idx, q, plan, now)
            pq = PendingQuery(qid, q.terms, q.rects, q.amps, plan)
            for raw in b.add(pq, now):
                self._execute_open(
                    raw, report, flush_t=now, service_time=service_time,
                    reason="fill",
                )
            report.n_queries += 1
        # drain: fire remaining finite deadlines in order, then the
        # infinite-wait leftovers at the end of the stream
        while True:
            dl = b.next_deadline()
            if dl is None:
                break
            for raw in b.due(dl):
                self._execute_open(
                    raw, report, flush_t=dl, service_time=service_time,
                    reason="deadline",
                )
        for raw in b.flush():
            flush_t = max(t_last, min(self._workers))
            self._execute_open(
                raw, report, flush_t=flush_t, service_time=service_time,
                reason="drain",
            )
        self._apply_fills(float("inf"))  # a later run_trace sees the full cache
        if self._pending is not None:
            self._expire_pending(float("inf"))
        report.wall_s = max(max(self._workers), t_last) - t_first

    # ------------------------------------------------------------------
    def _record(
        self,
        report,
        latency,
        batch_wait,
        queue_wait,
        service,
        *,
        t_arr: float = 0.0,
        qid: int = -1,
        idx: int = -1,
        kind: str = "executed",
        label: str | None = None,
    ) -> None:
        """Every served query's latency decomposition funnels through here —
        report lists, metrics histograms, and the query's trace span are all
        appended in the same order from the same numbers, so the span-derived
        percentiles are the report's percentiles by construction."""
        report.latencies_s.append(latency)
        report.batch_wait_s.append(batch_wait)
        report.queue_wait_s.append(queue_wait)
        report.service_s.append(service)
        tel = self.telemetry
        if tel:
            if tel.metrics is not None:
                m = tel.metrics
                m.inc("server.queries_total")
                m.observe("server.latency_ms", latency * 1e3)
                m.observe("server.batch_wait_ms", batch_wait * 1e3)
                m.observe("server.queue_wait_ms", queue_wait * 1e3)
                m.observe("server.service_ms", service * 1e3)
            if tel.tracer is not None:
                tel.tracer.query(
                    qid, idx, kind, label, t_arr,
                    latency, batch_wait, queue_wait, service,
                )

    def _record_coalesced(self, report, entry, t_arr: float, idx: int) -> None:
        """Charge a coalesced query against its twin batch's timeline.

        Each stage is clamped at the subscriber's own arrival — it cannot
        wait for a phase that ended before it arrived — so the three
        components still sum exactly to ``done - t_arr``:

        * arrived before the flush: full batch-wait tail + queue-wait +
          service;
        * arrived while the batch sat in the dispatch queue: queue-wait
          tail + service;
        * arrived mid-execution: the remaining service time only.
        """
        batch_wait = max(entry.flush_t - t_arr, 0.0)
        queue_wait = max(entry.start_t - max(t_arr, entry.flush_t), 0.0)
        service = entry.done_t - max(t_arr, entry.start_t)
        self._record(
            report, entry.done_t - t_arr, batch_wait, queue_wait, service,
            t_arr=t_arr, idx=idx, kind="coalesced", label=entry.plan_label,
        )
        if entry.plan_label is not None:
            report._record_plan(entry.plan_label, entry.done_t - t_arr)
        self._set_result(report, idx, entry.value)

    # ------------------------------------------------------------------
    # telemetry helpers (each a no-op without the matching sink)
    # ------------------------------------------------------------------
    def _count(self, name: str, amount: float = 1.0, **labels) -> None:
        tel = self.telemetry
        if tel and tel.metrics is not None:
            tel.metrics.inc(name, amount, **labels)

    def _coalesce_event(self, now: float, owner_qid: int, idx: int) -> None:
        tel = self.telemetry
        if tel:
            if tel.metrics is not None:
                tel.metrics.inc("server.coalesced_total")
            if tel.events is not None:
                tel.events.emit(now, "coalesce", qid=owner_qid, idx=idx)

    def _expire_pending(self, now: float) -> None:
        n = self._pending.expire(now)
        tel = self.telemetry
        if n and tel:
            if tel.metrics is not None:
                tel.metrics.inc("pending.expired_total", n)
            if tel.events is not None:
                tel.events.emit(now, "expire", n=n)

    def _audit_plan(self, qid: int, idx: int, q, plan, now: float) -> None:
        """Record a planned miss's features + candidate costs for the audit.

        Runs :meth:`~repro_torch.core.planner.Planner.explain` — a second feature
        pass over the query — so the audit costs nothing unless enabled.
        Recorded at live enqueue (not in ``_plan_for``) so the warmup's
        shape-prediction replay never pollutes the log.
        """
        tel = self.telemetry
        if plan is None or not tel or tel.audit is None:
            return
        planner = getattr(self.executor, "planner", None)
        if planner is None:
            return
        ex = planner.explain(q.terms, q.rects, q.amps)
        tel.audit.record(
            qid, idx, ex["features"], ex["candidates"], ex["chosen"], now
        )

    def _batch_telemetry(
        self, raw: RawBatch, label: str, reason: str,
        flush_t: float, start_t: float, done_t: float, worker: int,
    ) -> None:
        """Per-executed-batch flush/dispatch/complete events + batch span."""
        tel = self.telemetry
        if not tel:
            return
        shape = (raw.shape.batch, raw.shape.d_terms, raw.shape.q_rects)
        if tel.metrics is not None:
            m = tel.metrics
            m.inc("batcher.flush_total", reason=reason)
            m.observe("batcher.batch_real_queries", float(raw.n_real))
            m.inc("executor.batches_total", plan=label)
        if tel.tracer is not None:
            tel.tracer.batch(
                worker, flush_t, start_t, done_t, label, raw.n_real, shape
            )
        if tel.events is not None:
            shape = list(shape)
            tel.events.emit(
                flush_t, "flush", reason=reason, plan=label,
                n_real=raw.n_real, shape=shape,
            )
            tel.events.emit(
                start_t, "dispatch", worker=worker, plan=label,
                n_real=raw.n_real,
            )
            tel.events.emit(
                done_t, "complete", worker=worker, plan=label,
                n_real=raw.n_real, service_s=done_t - start_t,
            )

    def _put_cache(self, key, value, cost: float, now: float) -> None:
        """Cache insert + eviction accounting (Landlord may evict many)."""
        ev0 = self.cache.evictions
        self.cache.put(
            key, value, cost=cost, size=value.ids.nbytes + value.scores.nbytes
        )
        n_ev = self.cache.evictions - ev0
        tel = self.telemetry
        if n_ev and tel:
            if tel.metrics is not None:
                tel.metrics.inc("cache.evictions_total", n_ev)
            if tel.events is not None:
                tel.events.emit(now, "evict", n=n_ev)

    def _predict_shapes(self, trace: list[TraceQuery], open_loop: bool) -> set:
        """Replay cache + batcher decisions (no execution) → emitted
        (plan, shape) pairs — the launch shapes of a planned server.

        Exact for LRU and for Landlord without eviction pressure; under
        pressure Landlord's cost/size-dependent evictions may diverge, and
        in open-loop mode the real loop fills the cache at *completion*
        time rather than emission time, so a duplicate arriving while its
        twin is still queued may hit here and miss there.  Coalescing is
        approximated the same way: a duplicate of a not-yet-emitted query
        is skipped (its in-flight window is closed at emission here, at
        batch completion in the real loop).  Closed-loop prediction is
        time-blind: with a finite ``max_wait_s`` the real loop's
        wall-clock deadline flushes can emit smaller batch shapes than
        predicted (open-loop replay is the intended home of finite
        deadlines).  Either way an unpredicted shape simply runs for the
        first time inside the timed loop.
        """
        cache = self.cache.fresh_clone() if self.cache is not None else None
        batcher = self.batcher.clone_empty()
        deadline_aware = isinstance(batcher, DeadlineBatcher)
        pending: dict[int, tuple] = {}
        inflight_keys: set = set()  # coalesce window approximation
        shapes: set = set()

        def emit(raws):
            for raw in raws:
                shapes.add((raw.plan, raw.shape))
                for qid in raw.qids:
                    key = pending.pop(qid)
                    inflight_keys.discard(key)
                    if cache is not None:
                        cache.put(key, True)

        qid = 0

        def admit(q: TraceQuery, now: float) -> None:
            nonlocal qid
            if cache is None and not self.coalesce:
                key = None
            else:
                key = query_fingerprint(
                    q.terms, q.rects, q.amps, quant=self.fingerprint_quant
                )
            if cache is not None and cache.get(key) is not None:
                return
            if self.coalesce and key in inflight_keys:
                return
            pending[qid] = key
            inflight_keys.add(key)
            p = PendingQuery(qid, q.terms, q.rects, q.amps, self._plan_for(q))
            emit(batcher.add(p, now) if deadline_aware else batcher.add(p))
            qid += 1

        if open_loop:
            for q in sorted(trace, key=lambda q: q.arrival_s):
                while True:
                    dl = batcher.next_deadline()
                    if dl is None or dl > q.arrival_s:
                        break
                    emit(batcher.due(dl))
                admit(q, q.arrival_s)
            while True:
                dl = batcher.next_deadline()
                if dl is None:
                    break
                emit(batcher.due(dl))
        else:
            for q in trace:
                admit(q, 0.0)
        emit(batcher.flush())
        return shapes

    def _warmup(self, trace: list[TraceQuery], open_loop: bool = False) -> None:
        """Run every predicted (plan, shape) once with an inert batch and
        wait for the device."""
        for plan, shape in sorted(
            self._predict_shapes(trace, open_loop),
            key=lambda ps: (repr(ps[0]), ps[1].batch, ps[1].d_terms, ps[1].q_rects),
        ):
            terms = np.full((shape.batch, shape.d_terms), -1, dtype=np.int32)
            rects = np.zeros((shape.batch, shape.q_rects, 4), dtype=np.float32)
            rects[:, :, 0] = 1.0
            rects[:, :, 1] = 1.0
            amps = np.zeros((shape.batch, shape.q_rects), dtype=np.float32)
            batch = alg.QueryBatch(
                terms=torch.from_numpy(terms),
                rects=torch.from_numpy(rects),
                amps=torch.from_numpy(amps),
            )
            res = (
                self.executor.run(batch, plan=plan)
                if plan is not None
                else self.executor.run(batch)
            )
            _wait(res.scores)

    @staticmethod
    def routing_acc(report: ServeReport, label: str) -> dict:
        return report.routing.setdefault(
            label,
            {
                "queries": 0,
                "shards_touched": 0.0,
                "batches": 0,
                "shards_visited": 0.0,
            },
        )

    @staticmethod
    def _to_query_batch(raw: RawBatch) -> alg.QueryBatch:
        return alg.QueryBatch(
            terms=torch.from_numpy(raw.terms),
            rects=torch.from_numpy(raw.rects),
            amps=torch.from_numpy(raw.amps),
        )

    # ------------------------------------------------------------------
    def _finish_batch(self, raw: RawBatch, report: ServeReport):
        """Run the executor under the batch's plan; return host results
        (every output is on the host, so its device work has finished)."""
        if raw.plan is not None:
            res = self.executor.run(self._to_query_batch(raw), plan=raw.plan)
        else:
            res = self.executor.run(self._to_query_batch(raw))
        ids = to_numpy(res.ids)
        scores = to_numpy(res.scores)
        report.n_batches += 1
        report.shapes_used.add(raw.shape)
        label = self._plan_label(raw)
        tel = self.telemetry
        metrics = tel.metrics if tel else None
        pstats = report.plan_stats.setdefault(label, {})
        per_row: dict[str, np.ndarray] = {}
        # in key order, as the reference's jit outputs return their dicts
        for key, v in sorted(res.stats.items()):
            # only the real rows' work is attributable to served queries,
            # but padded rows burn real bytes too — count everything
            arr = to_numpy(v).astype(np.float64)
            total = float(arr.sum())
            report.stats[key] = report.stats.get(key, 0.0) + total
            pstats[key] = pstats.get(key, 0.0) + total
            if metrics is not None:
                metrics.inc(f"executor.{key}_total", total, plan=label)
            if arr.ndim >= 1 and arr.shape[0] == raw.shape.batch:
                per_row[key] = arr.reshape(arr.shape[0], -1).sum(axis=1)
        if "shards_touched" in per_row:
            # footprint-routed executor: fold this batch's fan-out into the
            # per-plan routing summary (real rows only — padding rows touch
            # no shard a served query can be charged for)
            touched = per_row["shards_touched"][: raw.n_real]
            raw.routing = {
                "shards_touched": touched,
                "shards_visited": float(
                    to_numpy(res.stats.get("shards_visited", 0.0)).sum()
                ),
            }
            r = self.routing_acc(report, label)
            r["queries"] += raw.n_real
            r["shards_touched"] += float(touched.sum())
            r["batches"] += 1
            r["shards_visited"] += raw.routing["shards_visited"]
            if metrics is not None:
                for v in touched:
                    metrics.observe(
                        "executor.shards_touched", float(v), plan=label
                    )
        if tel and tel.audit is not None and raw.plan is not None:
            # join each planned row's measured counters back onto its
            # audit record — prediction vs ground truth, per query
            for row, qid in enumerate(raw.qids):
                tel.audit.join(
                    qid, {k: float(a[row]) for k, a in per_row.items()}
                )
        return ids, scores

    def _execute(
        self,
        raw: RawBatch,
        report: ServeReport,
        flush_t: float,
        t0: float,
        reason: str = "fill",
    ) -> None:
        """Closed-loop execution: wall-clock timing relative to ``t0``.

        Service is measured per batch (``t_exec → t_done``), so when one
        flush event drains several batches (end-of-trace, overdue-deadline
        bursts) the later batches' wait behind the earlier ones lands in
        queue-wait, not in their service time or Landlord cost.
        """
        t_exec = time.perf_counter() - t0
        ids, scores = self._finish_batch(raw, report)
        t_done = time.perf_counter() - t0
        # batch cost shared equally by its real queries (Landlord credit)
        service = t_done - t_exec
        cost = service / max(raw.n_real, 1)
        report.batch_events.append(
            BatchEvent(flush_t, t_exec, t_done, 0, raw.n_real)
        )
        label = self._plan_label(raw)
        self._batch_telemetry(raw, label, reason, flush_t, t_exec, t_done, 0)
        for row, qid in enumerate(raw.qids):
            key, t_arr, idx = self._inflight.pop(qid)
            self._record(
                report, t_done - t_arr, flush_t - t_arr, t_exec - flush_t, service,
                t_arr=t_arr, qid=qid, idx=idx, kind="executed", label=label,
            )
            report._record_plan(label, t_done - t_arr)
            need_value = (
                report.results is not None
                or self.cache is not None
                or self._pending is not None
            )
            value = (
                QueryResult(ids[row].copy(), scores[row].copy())
                if need_value
                else None
            )
            self._set_result(report, idx, value)
            if self.cache is not None:
                self._put_cache(key, value, cost, t_done)
            if self._pending is not None:
                entry = self._pending.resolve(key, qid)
                if entry is not None:
                    for t_sub, sub_idx in entry.subscribers:
                        self._record(
                            report,
                            t_done - t_sub,
                            flush_t - t_sub,
                            t_exec - flush_t,
                            service,
                            t_arr=t_sub, idx=sub_idx, kind="coalesced",
                            label=label,
                        )
                        report._record_plan(label, t_done - t_sub)
                        self._set_result(report, sub_idx, value)
                    entry.subscribers.clear()

    def _apply_fills(self, now: float) -> None:
        """Insert deferred results whose batch completed by virtual ``now``.

        Open-loop cache fills become visible only at their batch's virtual
        completion — a duplicate arriving while its twin is still queued or
        executing misses the cache, exactly as it would in a live server
        (with coalescing on, that duplicate subscribes to the in-flight
        twin instead).
        """
        fills = self._pending_fills
        while fills and fills[0][0] <= now:
            done, _, key, value, cost = heapq.heappop(fills)
            self._put_cache(key, value, cost, done)

    def _execute_open(
        self,
        raw: RawBatch,
        report: ServeReport,
        flush_t: float,
        service_time,
        reason: str = "fill",
    ) -> None:
        """Open-loop execution: dispatch to the earliest-free worker slot.

        The batch starts when a worker frees up (``max(flush_t,
        min(worker-free times))`` — FIFO dispatch, work-conserving) and its
        measured (or injected) duration is charged to that worker's
        timeline; with one worker this is exactly the single busy-server
        recurrence.
        """
        t0 = time.perf_counter()
        ids, scores = self._finish_batch(raw, report)
        if service_time is not None:
            dt = float(service_time(raw))
        else:
            dt = time.perf_counter() - t0
        w = min(range(self.n_workers), key=lambda i: self._workers[i])
        start = max(flush_t, self._workers[w])
        done = start + dt
        self._workers[w] = done
        report.batch_events.append(BatchEvent(flush_t, start, done, w, raw.n_real))
        cost = dt / max(raw.n_real, 1)
        label = self._plan_label(raw)
        self._batch_telemetry(raw, label, reason, flush_t, start, done, w)
        for row, qid in enumerate(raw.qids):
            key, t_arr, idx = self._inflight.pop(qid)
            self._record(
                report, done - t_arr, flush_t - t_arr, start - flush_t, dt,
                t_arr=t_arr, qid=qid, idx=idx, kind="executed", label=label,
            )
            report._record_plan(label, done - t_arr)
            need_value = (
                report.results is not None
                or self.cache is not None
                or self._pending is not None
            )
            value = (
                QueryResult(ids[row].copy(), scores[row].copy())
                if need_value
                else None
            )
            self._set_result(report, idx, value)
            if self.cache is not None:
                heapq.heappush(
                    self._pending_fills,
                    (done, next(self._fill_seq), key, value, cost),
                )
            if self._pending is not None:
                entry = self._pending.on_dispatch(
                    key, qid, flush_t, start, done, value
                )
                if entry is not None:
                    entry.plan_label = label
                    # resolve duplicates that subscribed while this query
                    # sat in its batcher bucket; later duplicates (arriving
                    # before `done`) are recorded directly at lookup time
                    for t_sub, sub_idx in entry.subscribers:
                        self._record_coalesced(report, entry, t_sub, sub_idx)
                    entry.subscribers.clear()


def _wait(x) -> None:
    """Block until the device work behind ``x`` has finished (the
    reference's ``jax.block_until_ready``); host arrays are ready."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
