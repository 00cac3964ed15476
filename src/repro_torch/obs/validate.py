"""Validator for exported ``trace_event`` JSON (port of
``repro/obs/validate.py``).

Checks the structural invariants a trace viewer relies on:

* top level is ``{"traceEvents": [...]}`` and every event is an object
  with ``name``/``ph``/``pid``/``tid``/``ts``;
* ``X`` (complete) events carry ``dur >= 0`` and appear in
  non-decreasing ``ts`` order per ``(pid, tid)`` track;
* ``b``/``e`` (async) events pair up per ``(pid, cat, id)`` with
  LIFO nesting — every ``e`` closes the most recent open ``b`` of the
  same name, and nothing is left open at the end;
* all async ids referenced by ``e`` events resolve to an open span.

Usage::

    python -m repro_torch.obs.validate trace.json

Exits 0 on a valid trace, 1 with one line per violation otherwise.
"""
from __future__ import annotations

import json
import sys


def validate_trace(trace: dict) -> list[str]:
    """Return a list of violation messages (empty = valid)."""
    errors: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["top-level 'traceEvents' missing or not a list"]

    last_x_ts: dict[tuple, float] = {}
    open_async: dict[tuple, list[str]] = {}

    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in ("name", "ph", "pid", "tid", "ts") if k not in ev]
        if missing:
            errors.append(f"event {i}: missing fields {missing}")
            continue
        ph = ev["ph"]
        track = (ev["pid"], ev["tid"])
        if ph == "X":
            dur = ev.get("dur")
            if dur is None or dur < 0:
                errors.append(f"event {i} ({ev['name']}): X needs dur >= 0")
            ts = ev["ts"]
            if ts < last_x_ts.get(track, float("-inf")):
                errors.append(
                    f"event {i} ({ev['name']}): ts {ts} not monotone on "
                    f"track {track}"
                )
            last_x_ts[track] = ts
        elif ph in ("b", "e"):
            if "id" not in ev:
                errors.append(f"event {i} ({ev['name']}): async without id")
                continue
            key = (ev["pid"], ev.get("cat", ""), ev["id"])
            stack = open_async.setdefault(key, [])
            if ph == "b":
                stack.append(ev["name"])
            elif not stack:
                errors.append(
                    f"event {i} ({ev['name']}): 'e' with no open span for "
                    f"id {ev['id']}"
                )
            elif stack[-1] != ev["name"]:
                errors.append(
                    f"event {i}: 'e' for {ev['name']!r} but innermost open "
                    f"span is {stack[-1]!r} (bad nesting, id {ev['id']})"
                )
            else:
                stack.pop()
        elif ph != "M":
            errors.append(f"event {i} ({ev['name']}): unknown ph {ph!r}")

    for (pid, cat, sid), stack in open_async.items():
        if stack:
            errors.append(
                f"async id {sid} (pid {pid}, cat {cat!r}): unclosed spans "
                f"{stack}"
            )
    return errors


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate TRACE.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        trace = json.load(f)
    errors = validate_trace(trace)
    for e in errors:
        print(f"trace-invalid: {e}", file=sys.stderr)
    if not errors:
        n = len(trace["traceEvents"])
        print(f"trace ok: {n} events")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
