"""Checkpointing: atomic, async, keep-K (port of
``repro/train/checkpoint.py``), in the reference's on-disk format, so
each package restores the other's checkpoints:

    <dir>/step_<N:08d>/
        manifest.json       {step, leaves: [{path, shape, dtype, file}]}
        arr_<i>.npy         one file per leaf (numpy format)
    <dir>/step_<N:08d>.tmp/ (writer workspace — renamed atomically on success)

Leaf paths are ``jax.tree_util.tree_flatten_with_path``'s strings
(:mod:`repro_torch.train.tree`), e.g. ``[0]/['user_id']`` and
``[1]/['step']`` for a ``(params, opt_state)`` tuple.  The state is copied
to host numpy before a save returns or starts its thread, so the thread
never touches a device tensor and later in-place steps cannot reach the
files.  Restore places each array on the device of its ``like`` leaf (the
reference's resharding restore).

On a :class:`~repro_torch.core.distributed.ProcessMesh` both take the
state's ``shardings`` (a tree like the state of
:class:`~repro_torch.sharding.specs.NamedSharding` or None): every rank
calls :func:`save_checkpoint`, the ranks' blocks of each split leaf are
gathered into its global array on the mesh's rank 0, which writes the
files (the reference's format: global shapes); and
:func:`restore_checkpoint` gives each rank its own block of each global
array (:meth:`~repro_torch.sharding.specs.NamedSharding.block`), on the
same mesh or on another (elastic resume on fewer ranks).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.distributed import ProcessMesh
from repro_torch.device import to_numpy
from repro_torch.sharding.specs import local_block, splits
from repro_torch.train.tree import flatten_with_paths, leaves, unflatten


def _shardings_of(tree, shardings) -> list:
    flat = flatten_with_paths(tree)
    if shardings is None:
        return [None] * len(flat)
    out = leaves(shardings)
    if len(out) != len(flat):
        raise ValueError(f"{len(out)} shardings for a state of {len(flat)} leaves")
    return out


def _gathered(x: torch.Tensor, sharding) -> np.ndarray | None:
    """The global array of the ranks' blocks ``x`` under ``sharding``, on
    the mesh's rank 0 (None on the others)."""
    mesh = sharding.mesh
    parts = mesh.gather_to([x.detach()])
    if parts is None:
        return None
    out = None
    for r, (part,) in enumerate(parts):
        a = part.numpy()
        if out is None:
            out = np.empty(sharding.global_shape(tuple(a.shape)), dtype=a.dtype)
        local_block(out, sharding, r)[...] = a
    return out


def save_checkpoint(directory: str, step: int, state, *, async_: bool = False,
                    keep: int = 3, shardings=None) -> threading.Thread | None:
    """Write state atomically; optionally in a background thread.  With
    ``shardings`` on a process mesh every rank calls it: the split leaves'
    blocks are gathered here, before any thread starts, and the mesh's
    rank 0 writes (the others return None)."""
    shs = _shardings_of(state, shardings)
    mesh = next((s.mesh for s in shs if s is not None and isinstance(s.mesh, ProcessMesh)),
                None)
    writer = mesh is None or mesh.rank == 0
    host = []
    for (p, x), sh in zip(flatten_with_paths(state), shs):
        if splits(sh):
            a = _gathered(x, sh)
        else:
            a = to_numpy(x, copy=True) if writer else None
        host.append((p, a))
    if not writer:
        return None

    def write():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (p, a) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
            manifest["leaves"].append(
                {"path": p, "shape": list(a.shape), "dtype": str(a.dtype), "file": f"arr_{i}.npy"}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _gc(directory, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(directory: str, keep: int):
    steps = sorted(list_checkpoints(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def list_checkpoints(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_checkpoint(directory: str) -> int | None:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, like, shardings=None):
    """Load ``step`` into the structure of ``like`` (a tree of tensors),
    each array on the device of its ``like`` leaf.  With ``shardings`` (a
    tree like ``like``; the reference's signature) each rank of a process
    mesh keeps its block of every split leaf, read from the global array.

    Every leaf (or block) must have its ``like`` leaf's shape, or
    ``ValueError``.
    """
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    out = []
    for (p, leaf), sh in zip(flatten_with_paths(like), _shardings_of(like, shardings)):
        meta = by_path[p]
        a = np.load(os.path.join(final, meta["file"]), mmap_mode="r")
        what = f"checkpoint shape {tuple(a.shape)}"
        if splits(sh):
            try:
                a = local_block(a, sh)
            except ValueError as e:
                raise ValueError(f"{p}: {what}: {e}") from None
            what = f"this rank's block {tuple(a.shape)} of the {what}"
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{p}: {what}, expected {tuple(leaf.shape)}")
        out.append(torch.from_numpy(np.array(a)).to(leaf.device))
    return unflatten(like, out)


def verify_checkpoint(directory: str, step: int) -> bool:
    """Integrity check used by the restart manager before trusting a ckpt."""
    final = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        for l in manifest["leaves"]:
            fp = os.path.join(final, l["file"])
            if not os.path.exists(fp):
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False

