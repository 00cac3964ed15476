"""Architecture/shape registry (port of ``repro/configs/base.py``).

Each ``configs/<id>.py`` registers ``make() -> ArchSpec`` with the exact
published configuration, a reduced smoke configuration (same family) and
its shape set; ``launch/steps.py`` turns (arch, shape) into a cell with
real inputs on the device.  Only the archs the port has are registered:
the four recsys ones, the five LMs and ``geoweb``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any

# the modules that register the port's archs (the reference's all_archs
# lists the GNN one too)
_ARCH_MODULES = (
    "autoint", "bst", "dcn_v2", "geoweb", "granite_moe_1b_a400m", "olmoe_1b_7b",
    "qwen1_5_0_5b", "qwen2_5_14b", "smollm_135m", "two_tower_retrieval",
)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # lm_train | lm_prefill | lm_decode | recsys_train | recsys_serve |
    #            recsys_retrieval | geo_serve (the port's kinds)
    params: dict
    skip: str | None = None  # reason if this cell is inapplicable
    variant_of: str | None = None  # beyond-paper variant rows


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # lm | recsys | geoweb
    config: Any
    smoke_config: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}")


# ---------------------------------------------------------------------------
# shared LM shape set (assigned to every LM arch)
# ---------------------------------------------------------------------------

def lm_shapes(full_attention: bool, decode_batch: int = 128) -> tuple[ShapeSpec, ...]:
    shapes = [
        ShapeSpec("train_4k", "lm_train", dict(seq_len=4096, global_batch=256)),
        ShapeSpec("prefill_32k", "lm_prefill", dict(seq_len=32768, global_batch=32)),
        ShapeSpec("decode_32k", "lm_decode", dict(seq_len=32768, global_batch=decode_batch)),
    ]
    if full_attention:
        shapes.append(
            ShapeSpec(
                "long_500k", "lm_decode", dict(seq_len=524288, global_batch=1),
                skip="pure full-attention arch: 500k-token full-attention serving "
                     "is out of published scope (DESIGN.md §6); see the "
                     "long_500k_sliding beyond-paper variant",
            )
        )
        shapes.append(
            ShapeSpec(
                "long_500k_sliding", "lm_decode",
                dict(seq_len=524288, global_batch=1, attn_window=8192),
                variant_of="long_500k",
            )
        )
    else:
        shapes.append(
            ShapeSpec("long_500k", "lm_decode", dict(seq_len=524288, global_batch=1))
        )
    return tuple(shapes)


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
