"""Per-query span tracing, exported as Chrome/Perfetto ``trace_event`` JSON
(port of ``repro/obs/tracing.py``).

Every query served by :class:`~repro_torch.serving.server.GeoServer` records one
**query span** — arrival to completion — decomposed into the same three
contiguous stage spans the serving report measures:

    query ............................. [arrival, done)
      batch_wait ...................... [arrival, flush)      (miss only)
      queue_wait ...................... [flush, worker start)
      service ......................... [start, done)
      lookup .......................... [arrival, done)       (cache hit)

Stage boundaries are reconstructed from the *exact* batch-wait /
queue-wait / service values the report records, so the span sums equal the
report's latency decomposition to the bit (property-tested in the
telemetry tests).  Timestamps are **virtual-clock** seconds in
open-loop replay and wall-clock seconds in closed-loop replay — the same
clock the report itself uses.

Two additional span families share the file:

* **batch spans** — one per executed batch on its worker's track
  (``worker 0..N-1``); per-worker timelines are sequential, so each track
  is monotone (validated by :mod:`repro_torch.obs.validate`).
* **executor spans** — wall-clock spans measured *inside* the executors
  (per-shard spans of :class:`~repro_torch.serving.executor.ShardedExecutor`'s
  sequential scatter-gather loop, the mesh step, the single-device engine
  call).  They live in a separate trace process ("executors (wall clock)")
  because open-loop virtual time and host wall time are different clock
  domains; mixing them on one track would be a lie.  On CUDA they stay
  host wall clock and add no synchronization: the engine span ends when
  ``engine.query`` returns and the mesh span when the serve step returns,
  which may be before the device work they queued has finished (the
  server's host copy of the results waits for it, inside the batch's
  service time); a shard span ends at its host pull, so it does cover its
  shard's device work.

Export targets the ``trace_event`` JSON array format (Chrome's
``chrome://tracing`` and Perfetto's https://ui.perfetto.dev both open it
directly): query spans are async events (``ph: b/e`` keyed by a unique
id), batch/executor spans are complete events (``ph: X``), and metadata
events name the processes and threads.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

# trace process ids: virtual-clock serving timeline vs wall-clock executors
PID_SERVING = 1
PID_EXECUTOR = 2
TID_QUERIES = 1
TID_WORKER0 = 10  # worker w -> tid TID_WORKER0 + w


@dataclass
class QuerySpan:
    """One served query: arrival time + exact stage durations (seconds)."""

    qid: int  # server query id (-1 for cache hits: never enqueued)
    idx: int  # trace position
    kind: str  # "hit" | "executed" | "coalesced"
    label: str | None  # plan label (None = fixed-algorithm serving)
    t0: float  # arrival (virtual or wall seconds)
    latency: float  # end-to-end, as recorded (bit-identical to the report)
    batch_wait: float
    queue_wait: float
    service: float
    args: dict | None = None

    @property
    def total(self) -> float:
        return self.latency

    def boundaries(self) -> tuple[float, float, float, float]:
        """Contiguous stage edges: (arrival, flush, start, done)."""
        b1 = self.t0 + self.batch_wait
        b2 = b1 + self.queue_wait
        return self.t0, b1, b2, b2 + self.service


@dataclass
class BatchSpan:
    worker: int
    flush_t: float
    start_t: float
    done_t: float
    label: str | None
    n_real: int
    shape: tuple  # (batch, d_terms, q_rects)


@dataclass
class ExecSpan:
    track: str  # e.g. "shard 3", "engine", "mesh step"
    name: str
    t0: float  # wall seconds relative to recorder start
    t1: float
    args: dict | None = None


@dataclass
class SpanRecorder:
    """Accumulates query / batch / executor spans for one or more runs."""

    queries: list[QuerySpan] = field(default_factory=list)
    batches: list[BatchSpan] = field(default_factory=list)
    exec_spans: list[ExecSpan] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._wall_t0 = time.perf_counter()
        # per-qid args staged before the query's span is recorded (the
        # server learns fingerprint/plan timings at enqueue, stage
        # durations only at completion)
        self._pending_args: dict[int, dict] = {}

    # ------------------------------------------------------------------
    def wall_now(self) -> float:
        """Wall-clock seconds since recorder creation (executor spans)."""
        return time.perf_counter() - self._wall_t0

    def annotate(self, qid: int, **args) -> None:
        """Attach args to a not-yet-completed query (by server qid)."""
        self._pending_args.setdefault(qid, {}).update(args)

    def query(
        self,
        qid: int,
        idx: int,
        kind: str,
        label: str | None,
        t0: float,
        latency: float,
        batch_wait: float,
        queue_wait: float,
        service: float,
    ) -> None:
        self.queries.append(
            QuerySpan(
                qid, idx, kind, label, t0, latency,
                batch_wait, queue_wait, service,
                args=self._pending_args.pop(qid, None),
            )
        )

    def batch(
        self,
        worker: int,
        flush_t: float,
        start_t: float,
        done_t: float,
        label: str | None,
        n_real: int,
        shape: tuple,
    ) -> None:
        self.batches.append(
            BatchSpan(worker, flush_t, start_t, done_t, label, n_real, shape)
        )

    def span(self, track: str, name: str, t0: float, t1: float, args=None) -> None:
        self.exec_spans.append(ExecSpan(track, name, t0, t1, args))

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_trace_events(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON object."""
        us = 1e6
        ev: list[dict] = [
            _meta("process_name", PID_SERVING, 0, "serving (virtual clock)"),
            _meta("thread_name", PID_SERVING, TID_QUERIES, "queries"),
        ]
        workers = sorted({b.worker for b in self.batches})
        for w in workers:
            ev.append(
                _meta("thread_name", PID_SERVING, TID_WORKER0 + w, f"worker {w}")
            )
        if self.exec_spans:
            ev.append(
                _meta("process_name", PID_EXECUTOR, 0, "executors (wall clock)")
            )
        exec_tids: dict[str, int] = {}
        for s in self.exec_spans:
            if s.track not in exec_tids:
                tid = len(exec_tids) + 1
                exec_tids[s.track] = tid
                ev.append(_meta("thread_name", PID_EXECUTOR, tid, s.track))

        for span_id, q in enumerate(self.queries):
            t_arr, t_flush, t_start, t_done = q.boundaries()
            args = {"idx": q.idx, "kind": q.kind}
            if q.label is not None:
                args["plan"] = q.label
            if q.args:
                args.update(q.args)
            base = {"cat": "query", "id": span_id, "pid": PID_SERVING,
                    "tid": TID_QUERIES}
            ev.append(
                {"name": "query", "ph": "b", "ts": t_arr * us, "args": args,
                 **base}
            )
            stages = (
                [("lookup", t_arr, t_done)]
                if q.kind == "hit"
                else [
                    ("batch_wait", t_arr, t_flush),
                    ("queue_wait", t_flush, t_start),
                    ("service", t_start, t_done),
                ]
            )
            for name, s0, s1 in stages:
                ev.append({"name": name, "ph": "b", "ts": s0 * us, **base})
                ev.append({"name": name, "ph": "e", "ts": s1 * us, **base})
            ev.append({"name": "query", "ph": "e", "ts": t_done * us, **base})

        for b in self.batches:
            name = f"batch[{b.label}]" if b.label else "batch"
            ev.append(
                {
                    "name": name, "ph": "X", "pid": PID_SERVING,
                    "tid": TID_WORKER0 + b.worker,
                    "ts": b.start_t * us, "dur": (b.done_t - b.start_t) * us,
                    "args": {
                        "flush_t_s": b.flush_t, "n_real": b.n_real,
                        "shape": list(b.shape),
                    },
                }
            )
        for s in self.exec_spans:
            ev.append(
                {
                    "name": s.name, "ph": "X", "pid": PID_EXECUTOR,
                    "tid": exec_tids[s.track],
                    "ts": s.t0 * us, "dur": (s.t1 - s.t0) * us,
                    **({"args": s.args} if s.args else {}),
                }
            )
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_trace_events(), f)

    # ------------------------------------------------------------------
    # report cross-checks (the serving report derives from these spans)
    # ------------------------------------------------------------------
    def stage_sums(self) -> tuple[list[float], list[float], list[float], list[float]]:
        """Per-query (total, batch_wait, queue_wait, service) in record
        order — must equal the serving report's four lists exactly."""
        return (
            [q.total for q in self.queries],
            [q.batch_wait for q in self.queries],
            [q.queue_wait for q in self.queries],
            [q.service for q in self.queries],
        )


def _meta(name: str, pid: int, tid: int, value: str) -> dict:
    return {
        "name": name, "ph": "M", "pid": pid, "tid": tid, "ts": 0,
        "args": {"name": value},
    }
