"""Architecture/shape registry (port of ``repro/configs/base.py``).

Each ``configs/<id>.py`` registers ``make() -> ArchSpec`` with the exact
published configuration, a reduced smoke configuration (same family) and
its shape set; ``launch/steps.py`` turns (arch, shape) into a cell with
real inputs on the device.  Only the archs the port has are registered.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any

# the modules that register the port's archs (the reference's all_archs
# lists the LM, GNN and geoweb ones too)
_ARCH_MODULES = ("autoint", "bst", "dcn_v2", "two_tower_retrieval")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # recsys_train | recsys_serve | recsys_retrieval (the port's kinds)
    params: dict


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # recsys
    config: Any
    smoke_config: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}")


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", dict(batch=65536)),
    ShapeSpec("serve_p99", "recsys_serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "recsys_serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "recsys_retrieval", dict(batch=1, n_candidates=1_000_000)),
)


_REGISTRY: dict[str, Any] = {}


def register(name: str):
    def deco(make):
        _REGISTRY[name] = make
        return make

    return deco


def _load() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_arch(name: str) -> ArchSpec:
    _load()
    if name not in _REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported yet; the port has {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _load()
    return sorted(_REGISTRY.keys())
