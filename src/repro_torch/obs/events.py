"""Structured JSONL event log for the serving pipeline (port of
``repro/obs/events.py``).

Low-frequency discrete events that spans and metrics don't capture well —
*why* a batch flushed, *which* cache entries were evicted, *who* coalesced
onto whom.  One JSON object per line, each carrying the event time ``t``
(virtual-clock seconds in open-loop, wall seconds in closed-loop — the
serving clock), the event name ``ev``, and event-specific fields:

    flush      reason=fill|deadline|drain, plan, n_real, shape
    dispatch   worker, plan, n_real
    complete   worker, plan, n_real, service_s
    evict      n (entries evicted by this insert)
    coalesce   qid (leader), idx (follower trace position)
    expire     n (coalesce windows closed past their reuse horizon)

Events are buffered in memory and written once at the end of the run;
the serving hot path only ever pays an ``append``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class EventLog:
    events: list[dict] = field(default_factory=list)

    def emit(self, t: float, ev: str, **fields) -> None:
        self.events.append({"t": t, "ev": ev, **fields})

    def __len__(self) -> int:
        return len(self.events)

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
