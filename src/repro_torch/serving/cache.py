"""Query-result caches: LRU and cost-aware Landlord eviction (port of
``repro/serving/cache.py``).

A geo search trace is Zipf-skewed — a few head queries repeat constantly —
so a result cache in front of the engine converts the bulk of traffic into
O(1) lookups.  Two policies:

* :class:`LRUCache` — classic recency eviction.  Optimal when every miss
  costs the same.
* :class:`LandlordCache` — the Landlord algorithm (Young 1998; the
  weighted-caching generalization of LRU/FIFO/GreedyDual).  Every entry is
  admitted with credit ``cost / size``; on pressure the minimum remaining
  credit is charged as "rent" to all entries (lazily, via a virtual clock)
  and a zero-credit entry is evicted; a hit restores the entry's credit.
  Expensive-to-recompute results (deep sweeps, many probes) therefore
  outlive cheap ones even when they recur less often — the right policy
  when miss costs vary by orders of magnitude, as the paper's per-query
  byte counters show they do.

Both caches track hits / misses / evictions and expose ``hit_rate``.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Any, Hashable


class _CacheStats:
    hits: int
    misses: int
    evictions: int

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0


class LRUCache(_CacheStats):
    """Least-recently-used result cache with a fixed entry capacity."""

    def __init__(self, capacity: int):
        super().__init__()
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._data: OrderedDict[Hashable, Any] = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def get(self, key: Hashable):
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return None

    def put(
        self, key: Hashable, value: Any, cost: float = 1.0, size: float = 1.0
    ) -> None:
        if key in self._data:
            self._data.move_to_end(key)
            self._data[key] = value
            return
        while len(self._data) >= self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1
        self._data[key] = value

    def fresh_clone(self) -> "LRUCache":
        """Empty cache with the same configuration (for shape prediction)."""
        return LRUCache(self.capacity)


class LandlordCache(_CacheStats):
    """Cost-aware cache (Landlord / GreedyDual-Size with lazy rent).

    Rent is charged through a virtual clock ``L``: an entry stored at clock
    value ``L0`` with credit ``cost/size`` expires at ``L0 + cost/size``.
    Eviction pops the minimum-expiry entry and advances ``L`` to its expiry
    (equivalent to subtracting the minimum credit from everyone).  A hit
    re-credits the entry: its expiry becomes ``L + cost/size`` again.

    **Size-aware admission**: with a ``max_bytes`` budget, ``size`` is the
    entry's payload bytes (the server passes the top-k arrays' ``nbytes``)
    and eviction also runs while the byte budget is exceeded, so many small
    results can coexist with few large ones under one memory ceiling — the
    GreedyDual-*Size* half of the algorithm.  An entry larger than the whole
    budget is never admitted (admitting it would evict everything for a
    result too big to keep).  Without ``max_bytes`` the cache is count-
    bounded only and ``size`` just scales credit, as before.

    **Exact byte accounting**: entry sizes are whole bytes (``int(size)``,
    floored at 1) and ``bytes_used`` is an integer — the running total is
    ``sum(entry sizes)`` exactly, through any sequence of admissions,
    replacements and eviction storms.  (The accounting used to accumulate
    float residue and paper over it with a reset-to-zero-when-empty hack;
    only the *credit* math ``cost / size`` is float now.)
    """

    def __init__(self, capacity: int, max_bytes: float | None = None):
        super().__init__()
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be > 0 (or None for unbounded)")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.bytes_used = 0
        self.rejected = 0  # oversized entries refused admission
        self.clock = 0.0
        # key -> [value, cost, size, expiry, generation]
        self._data: dict[Hashable, list] = {}
        self._heap: list[tuple[float, int, int, Hashable]] = []  # lazy-deleted
        self._gen = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def _push(self, key: Hashable, entry: list) -> None:
        self._gen += 1
        entry[4] = self._gen
        heapq.heappush(self._heap, (entry[3], self._gen, id(entry), key))
        # lazy deletion leaves stale records behind on every renewal; on
        # hit-heavy workloads (the cache's target regime) that is O(hits)
        # growth for a fixed-capacity cache — compact when it gets silly
        if len(self._heap) > 4 * self.capacity + 64:
            self._heap = [(e[3], e[4], id(e), k) for k, e in self._data.items()]
            heapq.heapify(self._heap)

    def get(self, key: Hashable):
        entry = self._data.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        # renew: restore full credit relative to the current clock
        entry[3] = self.clock + entry[1] / entry[2]
        self._push(key, entry)
        return entry[0]

    def put(
        self, key: Hashable, value: Any, cost: float = 1.0, size: float = 1.0
    ) -> None:
        cost = max(float(cost), 1e-12)
        size = max(int(size), 1)  # whole bytes: accounting stays exact
        if self.max_bytes is not None and size > self.max_bytes:
            self.rejected += 1
            return
        if key in self._data:
            entry = self._data[key]
            self.bytes_used += size - entry[2]
            entry[0], entry[1], entry[2] = value, cost, size
            entry[3] = self.clock + cost / size
            self._push(key, entry)
        else:
            while len(self._data) >= self.capacity:
                self._evict_one()
            entry = [value, cost, size, self.clock + cost / size, 0]
            self._data[key] = entry
            self.bytes_used += size
            self._push(key, entry)
        if self.max_bytes is not None:
            # may evict the entry just admitted if its credit is the minimum
            while self._data and self.bytes_used > self.max_bytes:
                self._evict_one()

    def _evict_one(self) -> None:
        while self._heap:
            expiry, gen, _, key = heapq.heappop(self._heap)
            entry = self._data.get(key)
            if entry is None or entry[4] != gen:
                continue  # stale heap record (renewed or replaced)
            self.clock = max(self.clock, expiry)  # charge rent = min credit
            del self._data[key]
            self.bytes_used -= entry[2]
            self.evictions += 1
            return
        raise RuntimeError("landlord heap empty while cache non-empty")

    def fresh_clone(self) -> "LandlordCache":
        """Empty cache with the same configuration (for shape prediction)."""
        return LandlordCache(self.capacity, max_bytes=self.max_bytes)


def make_cache(policy: str, capacity: int, max_bytes: float | None = None):
    """Factory: ``none`` | ``lru`` | ``landlord``.

    ``max_bytes`` (Landlord only) adds a result-payload byte budget on top
    of the entry-count capacity; combining it with another policy is an
    error rather than a silent no-op.
    """
    if policy != "landlord" and max_bytes is not None:
        raise ValueError(f"max_bytes is only supported by landlord, not {policy!r}")
    if policy == "none":
        return None
    if policy == "lru":
        return LRUCache(capacity)
    if policy == "landlord":
        return LandlordCache(capacity, max_bytes=max_bytes)
    raise ValueError(f"unknown cache policy {policy!r}")
