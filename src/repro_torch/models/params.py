"""Parameter definitions: one source of truth for the shape, logical axes,
dtype and initializer of every parameter (port of ``repro/models/params.py``).

Models declare a dict of :class:`ParamDef`; from it come ``init_params``
(real tensors drawn on a device), ``param_shapes`` (``meta`` tensors, each
with its sharding when a mesh is given: the dry-run's parameters, which
allocate nothing), ``param_specs`` (the partition spec of every leaf) and
``param_count``.  ``params_from_numpy`` carries the reference's parameter
arrays across, checked against the definitions, so that both packages
compute with the same weights.  On a
:class:`~repro_torch.core.distributed.ProcessMesh` a rank holds only its
block of each leaf (``param_shardings``, ``place_params``,
``init_params(..., mesh=...)``), and :func:`split_over_model` says which
leaves those blocks cut over ``model``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import (
    NamedSharding,
    local_block,
    logical_spec,
    named_sharding,
    splits,
)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # override fan-in scale

    def initializer(self, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "embed":
            scale = self.scale or 0.02
        else:  # fan-in scaled normal
            fan_in = self.shape[-2] if len(self.shape) >= 2 else max(self.shape[-1], 1)
            scale = self.scale if self.scale is not None else 1.0 / np.sqrt(fan_in)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        # scaled in place: a published LM's stacked FFN leaf alone is 13.6 GB
        return x.mul_(float(np.float32(scale))).to(self.dtype)


def _flatten(defs: dict, prefix: str = "") -> list[tuple[str, ParamDef]]:
    """(path, def) leaves in the reference's flattened order (sorted keys at
    every level, as ``jax.tree_util`` flattens a dict); nested paths join
    with ``/``."""
    out = []
    for k in sorted(defs):
        v = defs[k]
        if isinstance(v, ParamDef):
            out.append((prefix + k, v))
        else:
            out.extend(_flatten(v, prefix + k + "/"))
    return out


def _unflatten(leaves: dict) -> dict:
    out: dict = {}
    for path, x in leaves.items():
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = x
    return out


def _param_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0] >> 1)


def init_params(defs: dict, seed: int = 0, device=None, mesh=None) -> dict:
    """Real tensors for ``defs`` on ``device`` (CUDA unless given).  Each
    parameter draws from its own ``torch.Generator`` on that device, seeded
    by (``seed``, its index in the flattened order).  The values are not the
    reference's threefry draws; carry those across with
    :func:`params_from_numpy`.

    On a :class:`~repro_torch.core.distributed.ProcessMesh` ``mesh`` each
    leaf is drawn whole, one at a time, and only this rank's block of it
    (:func:`param_shardings`) is kept: the blocks are bitwise slices of the
    one-card init on the same device type, and no rank holds the model."""
    dev = resolve_device(device)
    shardings = dict(_flatten_shardings(defs, mesh)) if mesh is not None else {}
    leaves = {}
    for i, (path, d) in enumerate(_flatten(defs)):
        g = torch.Generator(device=dev)
        g.manual_seed(_param_seed(seed, i))
        x = d.initializer(g, dev)
        sh = shardings.get(path)
        leaves[path] = local_block(x, sh).clone() if splits(sh) else x
        del x  # freed before the next leaf is drawn
    return _unflatten(leaves)


def _flatten_shardings(defs: dict, mesh) -> list[tuple[str, NamedSharding]]:
    return [(path, NamedSharding(mesh, logical_spec(d.logical, mesh.axis_names,
                                                    shape=d.shape, mesh=mesh)))
            for path, d in _flatten(defs)]


def param_shardings(defs: dict, mesh) -> dict:
    """The :class:`~repro_torch.sharding.specs.NamedSharding` of every leaf
    of ``defs`` on ``mesh`` (its :func:`param_specs` entry)."""
    return _unflatten(dict(_flatten_shardings(defs, mesh)))


def split_over_model(defs: dict, mesh) -> dict:
    """Per leaf of ``defs`` (a tree like it of bools), whether a rank of
    ``mesh`` holds it as a block over ``model``: its sharding
    (:func:`param_shardings`) names ``model``, which has more than one
    position, and splits the leaf across the ranks of a process mesh
    (:func:`~repro_torch.sharding.specs.splits`).  A leaf whose dimension
    ``model`` does not divide is False: ``logical_spec`` drops the axis
    and keeps it whole, and the layers that use it run replicated."""
    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return splits(s) and s.mesh.shape.get("model", 1) > 1 and "model" in s.spec.axes()

    return walk(param_shardings(defs, mesh))


def place_params(params: dict, shardings: dict) -> dict:
    """A global parameter tree placed on a process mesh: each leaf's block
    that this rank's coordinates select under its sharding (a copy), a
    leaf that its sharding leaves whole as it is."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return local_block(p, s).clone() if splits(s) else p

    return walk(params, shardings)


def params_from_numpy(defs: dict, arrays: dict, device=None) -> dict:
    """The reference's parameter dict, as numpy arrays, turned into the
    port's tensors on ``device``.  Every name, shape and dtype is checked
    against ``defs``; a missing, extra or mismatched entry raises."""
    dev = resolve_device(device)
    want = dict(_flatten(defs))
    got = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                got[prefix + k] = v

    walk(arrays, "")
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    leaves = {}
    for path, d in want.items():
        a = np.array(got[path])  # a copy the tensor may own
        t = torch.from_numpy(a)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)}, expected {tuple(d.shape)}")
        if t.dtype != d.dtype:
            raise TypeError(f"{path}: dtype {a.dtype}, expected {d.dtype}")
        leaves[path] = t.to(dev)
    return _unflatten(leaves)


def meta_tensor(shape, dtype, mesh=None, logical=None, rules=None) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``); with a mesh, its ``sharding`` attribute holds
    the :class:`~repro_torch.sharding.specs.NamedSharding` of the logical
    axes ``logical``."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    if mesh is not None:
        t.sharding = named_sharding(mesh, tuple(logical), rules, shape=tuple(shape))
    return t


def param_shapes(defs: dict, mesh=None, rules=None) -> dict:
    """``meta`` tensors of ``defs``' shapes and dtypes, in the reference's
    flattened order; each carries its sharding when ``mesh`` is given."""
    return _unflatten({path: meta_tensor(d.shape, d.dtype, mesh, d.logical, rules)
                       for path, d in _flatten(defs)})


def param_specs(defs: dict, mesh, rules=None) -> dict:
    """The partition spec of every leaf of ``defs`` on ``mesh``."""
    return _unflatten({path: logical_spec(d.logical, mesh.axis_names, rules, d.shape, mesh)
                       for path, d in _flatten(defs)})


def param_count(defs: dict) -> int:
    return int(sum(np.prod(d.shape) for _, d in _flatten(defs)))
