"""Cluster-level fault tolerance: heartbeats, straggler watchdog, elastic
re-meshing (port of ``repro/train/fault.py``: host Python, copied as it
is).  Launcher-side logic; tests exercise it with simulated hosts.

On a real multi-host deployment each host process runs ``Heartbeat`` next to
the training loop; the (replicated) ``Watchdog`` on the coordinator
periodically scans heartbeat files:

* missing/stale heartbeat  → host declared dead → job restarts on the
  surviving hosts with a *shrunk* ``data`` axis (`plan_elastic_mesh`), and
  state restores through the resharding checkpoint loader (checkpoint.py) —
  no index/model rebuild.
* slow heartbeat (straggler) → logged; after ``straggler_patience`` scans
  the host is treated as dead (pre-emptive eviction), the standard
  mitigation when one of thousands of nodes runs at 10% speed.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass


@dataclass
class Heartbeat:
    directory: str
    host_id: int

    def beat(self, step: int, step_time_s: float):
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"host_{self.host_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"host": self.host_id, "step": step, "t": time.time(),
                 "step_time_s": step_time_s},
                f,
            )
        os.replace(tmp, path)


@dataclass
class WatchdogConfig:
    timeout_s: float = 300.0
    straggler_factor: float = 3.0  # step_time > factor × median → straggler
    straggler_patience: int = 3


class Watchdog:
    def __init__(self, directory: str, cfg: WatchdogConfig = WatchdogConfig()):
        self.directory = directory
        self.cfg = cfg
        self.strikes: dict[int, int] = {}

    def scan(self, now: float | None = None) -> dict:
        """Returns {'alive': [...], 'dead': [...], 'stragglers': [...]}."""
        now = time.time() if now is None else now
        beats = []
        if os.path.isdir(self.directory):
            for name in os.listdir(self.directory):
                if name.startswith("host_") and name.endswith(".json"):
                    try:
                        with open(os.path.join(self.directory, name)) as f:
                            beats.append(json.load(f))
                    except Exception:
                        pass
        alive, dead, stragglers = [], [], []
        times = sorted(b["step_time_s"] for b in beats) or [0.0]
        median = times[len(times) // 2]
        for b in beats:
            if now - b["t"] > self.cfg.timeout_s:
                dead.append(b["host"])
                continue
            if median > 0 and b["step_time_s"] > self.cfg.straggler_factor * median:
                self.strikes[b["host"]] = self.strikes.get(b["host"], 0) + 1
                if self.strikes[b["host"]] >= self.cfg.straggler_patience:
                    dead.append(b["host"])  # evict persistent straggler
                else:
                    stragglers.append(b["host"])
                    alive.append(b["host"])
            else:
                self.strikes.pop(b["host"], None)
                alive.append(b["host"])
        return {"alive": sorted(alive), "dead": sorted(dead), "stragglers": sorted(stragglers)}


def plan_elastic_mesh(
    n_alive_hosts: int,
    chips_per_host: int,
    model_parallel: int,
    pods: int = 1,
) -> tuple[int, ...]:
    """Largest (pod, data, model) mesh fitting the surviving hosts.

    ``model`` is fixed (set by the architecture's memory footprint); the
    ``data`` axis shrinks to the largest size the chips support.  Returns the
    mesh shape; the caller re-lowers and restores via the resharding loader.
    """
    total = n_alive_hosts * chips_per_host
    per_pod = total // pods
    data = max(per_pod // model_parallel, 1)
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)
