"""In-flight request coalescing: the pending-result table (port of
``repro/serving/pending.py``).

A live serving tier sees the same popular query many times in a short
window.  The result cache only helps once the first execution *finishes* —
until then every duplicate would re-enter the batcher and burn executor
time recomputing an answer that is already on its way.  The
:class:`PendingTable` closes that window: it maps a query fingerprint to
the **in-flight** execution of that fingerprint (still waiting in a
batcher bucket, queued for a worker, or executing), so a duplicate can
*subscribe* to the pending result instead of re-enqueueing.

Lifecycle of an entry (driven by :class:`~repro_torch.serving.server.GeoServer`):

1. ``register(key, qid)`` — a cache miss enqueued into the batcher becomes
   the *owner* of its fingerprint.
2. ``lookup(key, now)`` — a later miss with the same fingerprint finds the
   entry; the server appends it to ``subscribers`` (owner still batched,
   completion time unknown) or records it immediately (owner dispatched,
   timing known).
3. ``dispatched(key, qid, …)`` — the owner's batch is flushed and placed
   on a worker: the entry learns its ``flush_t``/``start_t``/``done_t``
   timeline and the owner's result row; deferred subscribers are resolved
   by the server at this point.
4. The entry stays coalescible until virtual time passes ``done_t`` (the
   result is then in the result cache, if any); ``expire(now)`` garbage-
   collects it.

The table never stores un-fingerprinted queries and is policy-free: all
latency accounting stays in the server so batch-wait + queue-wait +
service continues to sum exactly to total latency for coalesced queries.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field


@dataclass
class PendingEntry:
    """One in-flight fingerprint: its owner query and (once known) timing."""

    owner_qid: int
    # virtual timeline of the owner's batch; None until dispatched
    flush_t: float | None = None
    start_t: float | None = None
    done_t: float | None = None
    value: object | None = None  # owner's QueryResult row, set at dispatch
    plan_label: str | None = None  # plan that served the owner's batch
    # (arrival_s, trace index) of duplicates that subscribed while the
    # owner was still in a batcher bucket (timing unknown at subscribe time)
    subscribers: list[tuple[float, int]] = field(default_factory=list)

    @property
    def dispatched(self) -> bool:
        return self.done_t is not None


class PendingTable:
    """fingerprint key → in-flight :class:`PendingEntry`."""

    def __init__(self) -> None:
        self._by_key: dict = {}
        # (done_t, seq, key, qid) min-heap — with several workers, dispatch
        # order is not completion order, so expiry must pop by done time
        self._done_heap: list[tuple[float, int, object, int]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._by_key)

    def clear(self) -> None:
        self._by_key.clear()
        self._done_heap.clear()

    # ------------------------------------------------------------------
    def register(self, key, qid: int) -> PendingEntry:
        """A freshly-enqueued miss becomes the owner of its fingerprint."""
        entry = PendingEntry(owner_qid=qid)
        self._by_key[key] = entry
        return entry

    def lookup(self, key, now: float) -> PendingEntry | None:
        """The entry a duplicate arriving at ``now`` may coalesce onto.

        An entry whose batch already completed (``done_t <= now``) is not
        returned: its result has moved to the result cache (or is gone),
        so the duplicate must take the normal cache/batcher path.
        """
        entry = self._by_key.get(key)
        if entry is None:
            return None
        if entry.done_t is not None and entry.done_t <= now:
            return None
        return entry

    def on_dispatch(
        self, key, qid: int, flush_t: float, start_t: float, done_t: float, value
    ) -> PendingEntry | None:
        """Record the owner's batch timeline; returns the entry if owned.

        Returns ``None`` when ``qid`` no longer owns the fingerprint (a
        later miss re-registered after this entry expired) — nothing to
        resolve in that case.
        """
        entry = self._by_key.get(key)
        if entry is None or entry.owner_qid != qid:
            return None
        entry.flush_t, entry.start_t, entry.done_t = flush_t, start_t, done_t
        entry.value = value
        heapq.heappush(self._done_heap, (done_t, next(self._seq), key, qid))
        return entry

    def resolve(self, key, qid: int) -> PendingEntry | None:
        """Pop the entry outright (closed-loop: completion is in the past
        the moment the wall-clock executor returns)."""
        entry = self._by_key.get(key)
        if entry is None or entry.owner_qid != qid:
            return None
        del self._by_key[key]
        return entry

    def expire(self, now: float) -> int:
        """Drop entries whose batch completed by virtual ``now``; returns
        the number of coalesce windows closed (telemetry counter)."""
        heap = self._done_heap
        n = 0
        while heap and heap[0][0] <= now:
            _, _, key, qid = heapq.heappop(heap)
            entry = self._by_key.get(key)
            if entry is not None and entry.owner_qid == qid:
                del self._by_key[key]
                n += 1
        return n

    # ------------------------------------------------------------------
    def unresolved_subscribers(self) -> int:
        """Deferred subscribers still waiting on a dispatch (0 after a
        fully drained run — asserted by the server)."""
        return sum(len(e.subscribers) for e in self._by_key.values())
