"""Shape-bucketed dynamic micro-batcher (port of ``repro/serving/batcher.py``).

The reference compiles its query pipeline once per static shape
``(batch, terms_per_query, rects_per_query)``; the port runs eagerly, but
keeps the same shapes so that both packages batch a trace identically and
the kernels see a bounded set of launch shapes.  A naive dynamic batcher
would emit a fresh shape for every mix of query widths in flight.  This
batcher instead *registers a small lattice of static shapes up front*
(power-of-two term/rect capacities × power-of-two batch sizes) and pads
every incoming query up to the nearest bucket:

* the number of distinct batch shapes is bounded by
  ``len(term_buckets) · len(rect_buckets) · log2(max_batch)+1`` regardless
  of trace length;
* padding waste is *measured*, not hidden — ``pad_slots`` (whole dummy
  queries emitted to round a batch up) and ``pad_elements`` (padded term /
  rect cells inside real queries) feed the serving report's
  ``padding_overhead`` column.

Buckets are additionally *plan-homogeneous*: when the serving layer runs a
cost-based planner (``algorithm="auto"``), each query carries its chosen
:class:`~repro_torch.core.planner.QueryPlan` and the plan joins the bucket
key — a flushed batch holds one plan only, so the executor runs one
pipeline per plan × shape and every row under its own chosen algorithm.
Fixed-algorithm serving leaves ``plan`` as ``None`` and behaves
bit-identically to the pre-planner batcher.

Invariants (unit-tested): every emitted batch's shape is in the registered
set, every submitted query appears in exactly one emitted batch, and every
query in an emitted batch shares the batch's plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np


@dataclass(frozen=True)
class BucketShape:
    """One registered static shape: capacities, not actual occupancy."""

    batch: int
    d_terms: int
    q_rects: int


@dataclass
class PendingQuery:
    qid: int
    terms: np.ndarray  # i32[d]  (no padding)
    rects: np.ndarray  # f32[r, 4]
    amps: np.ndarray  # f32[r]
    plan: object = None  # QueryPlan chosen by the planner (None = fixed)


@dataclass
class RawBatch:
    """A padded batch ready for the executor (host-side numpy)."""

    shape: BucketShape
    qids: list[int]  # real queries, len <= shape.batch
    terms: np.ndarray  # i32[B, d]
    rects: np.ndarray  # f32[B, r, 4]
    amps: np.ndarray  # f32[B, r]
    plan: object = None  # the plan every query in this batch shares
    # filled post-execution by footprint-routed executors: per-batch shard
    # fan-out {"shards_touched": f64[n_real], "shards_visited": float}
    routing: dict | None = None

    @property
    def n_real(self) -> int:
        return len(self.qids)


def _pow2_buckets(max_value: int) -> list[int]:
    out, v = [], 1
    while v < max_value:
        out.append(v)
        v *= 2
    out.append(max_value)
    return out


@dataclass
class ShapeBucketedBatcher:
    """Groups queries by (term, rect) bucket; flushes full or on demand."""

    max_batch: int = 32
    max_terms: int = 8
    max_rects: int = 4
    # filled in __post_init__
    term_buckets: list[int] = field(default_factory=list)
    rect_buckets: list[int] = field(default_factory=list)
    batch_sizes: list[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.term_buckets = self.term_buckets or _pow2_buckets(self.max_terms)
        self.rect_buckets = self.rect_buckets or _pow2_buckets(self.max_rects)
        self.batch_sizes = self.batch_sizes or _pow2_buckets(self.max_batch)
        self._pending: dict[tuple, list[PendingQuery]] = {}
        # padding accounting
        self.pad_slots = 0  # dummy whole-query rows
        self.real_slots = 0
        self.pad_elements = 0  # padded term/rect cells in real queries
        self.real_elements = 0
        self.emitted_shapes: set[BucketShape] = set()

    # ------------------------------------------------------------------
    def clone_empty(self) -> "ShapeBucketedBatcher":
        """A fresh batcher with identical configuration and no state.

        Works for subclasses too (all their config lives in dataclass
        fields) — the server uses this to replay batching decisions
        host-side for shape prediction/warmup.
        """
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for k in ("term_buckets", "rect_buckets", "batch_sizes"):
            kw[k] = list(kw[k])
        return type(self)(**kw)

    @property
    def registered_shapes(self) -> set[BucketShape]:
        return {
            BucketShape(b, d, r)
            for b in self.batch_sizes
            for d in self.term_buckets
            for r in self.rect_buckets
        }

    def _bucket_of(self, n: int, buckets: list[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(f"query dimension {n} exceeds largest bucket {buckets[-1]}")

    def _key_of(self, q: PendingQuery) -> tuple:
        """The (plan, term, rect) bucket a query lands in.

        The plan leads the key so buckets are plan-homogeneous: one flushed
        batch = one plan × shape.
        """
        return (
            q.plan,
            self._bucket_of(max(len(q.terms), 1), self.term_buckets),
            self._bucket_of(max(len(q.rects), 1), self.rect_buckets),
        )

    # ------------------------------------------------------------------
    def add(self, q: PendingQuery) -> list[RawBatch]:
        """Enqueue one query; returns any batch made full by it."""
        key = self._key_of(q)
        self._pending.setdefault(key, []).append(q)
        if len(self._pending[key]) >= self.max_batch:
            return [self._emit(key, self._pending.pop(key))]
        return []

    def flush(self) -> list[RawBatch]:
        """Emit everything still pending (end of trace / wait timeout)."""
        out = [self._emit(k, qs) for k, qs in self._pending.items()]
        self._pending.clear()
        return out

    # ------------------------------------------------------------------
    def _emit(self, key: tuple, qs: list[PendingQuery]) -> RawBatch:
        plan, d, r = key
        B = self._bucket_of(len(qs), self.batch_sizes)
        shape = BucketShape(B, d, r)
        terms = np.full((B, d), -1, dtype=np.int32)
        rects = np.zeros((B, r, 4), dtype=np.float32)
        rects[:, :, 0] = 1.0  # empty-rect padding (x1 < x0)
        rects[:, :, 1] = 1.0
        amps = np.zeros((B, r), dtype=np.float32)
        for i, q in enumerate(qs):
            nt, nr = len(q.terms), len(q.rects)
            terms[i, :nt] = q.terms
            rects[i, :nr] = q.rects
            amps[i, :nr] = q.amps
            self.pad_elements += (d - nt) + (r - nr)
            self.real_elements += nt + nr
        self.pad_slots += B - len(qs)
        self.real_slots += len(qs)
        self.emitted_shapes.add(shape)
        return RawBatch(shape, [q.qid for q in qs], terms, rects, amps, plan)

    # ------------------------------------------------------------------
    @property
    def padding_overhead(self) -> float:
        """Fraction of emitted batch slots that were padding."""
        total = self.pad_slots + self.real_slots
        return self.pad_slots / total if total else 0.0

    @property
    def element_padding_overhead(self) -> float:
        """Fraction of term/rect cells inside real rows that were padding."""
        total = self.pad_elements + self.real_elements
        return self.pad_elements / total if total else 0.0


@dataclass
class DeadlineBatcher(ShapeBucketedBatcher):
    """Clock-aware batcher: flush on full **or** on the oldest query's deadline.

    Each bucket remembers when its oldest pending query was enqueued; that
    query's deadline is ``enqueue_time + max_wait_s``.  The serve loop asks
    :meth:`next_deadline` for the earliest deadline across buckets (its next
    timer event) and :meth:`due` for every bucket whose deadline has passed,
    in deadline order — so a half-full bucket never holds a query hostage
    for longer than ``max_wait_s``.

    Two edge cases pin the semantics (unit-tested):

    * ``max_wait_s = 0``   — every query flushes immediately in a batch of
      one: minimum latency, maximum padding.
    * ``max_wait_s = inf`` — deadlines never fire; behavior is bit-identical
      to the count-only :class:`ShapeBucketedBatcher`.

    The clock is whatever the caller passes as ``now`` — wall seconds in a
    live server, virtual seconds in simulation/tests — which is what makes
    deadline behavior deterministic under test.
    """

    max_wait_s: float = float("inf")

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0 (inf = count-only)")
        self._oldest: dict[tuple, float] = {}

    # ------------------------------------------------------------------
    def add(self, q: PendingQuery, now: float = 0.0) -> list[RawBatch]:
        """Enqueue at time ``now``; returns any batch made full by it."""
        key = self._key_of(q)
        out = super().add(q)
        if out:
            self._oldest.pop(key, None)
        else:
            self._oldest.setdefault(key, now)
        return out

    # ------------------------------------------------------------------
    def next_deadline(self) -> float | None:
        """Earliest pending deadline, or ``None`` if nothing can expire."""
        if not self._oldest or self.max_wait_s == float("inf"):
            return None
        return min(self._oldest.values()) + self.max_wait_s

    def due(self, now: float) -> list[RawBatch]:
        """Flush every bucket whose oldest query expired by ``now``.

        Batches come back in deadline order (oldest expiry first), so a
        replay loop draining multiple overdue buckets services them in the
        order their queries would have timed out.
        """
        if self.max_wait_s == float("inf"):
            return []
        # key=t only: bucket keys lead with a QueryPlan (unorderable), so a
        # tied deadline must fall back to stable insertion order, not key
        # comparison
        ripe = sorted(
            ((t, k) for k, t in self._oldest.items() if t + self.max_wait_s <= now),
            key=lambda tk: tk[0],
        )
        out = []
        for _, key in ripe:
            del self._oldest[key]
            out.append(self._emit(key, self._pending.pop(key)))
        return out

    def flush(self) -> list[RawBatch]:
        self._oldest.clear()
        return super().flush()
