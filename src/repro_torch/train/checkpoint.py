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
reference's resharding restore, on one device).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import to_numpy
from repro_torch.train.tree import flatten_with_paths, unflatten


def save_checkpoint(directory: str, step: int, state, *, async_: bool = False,
                    keep: int = 3) -> threading.Thread | None:
    """Write state atomically; optionally in a background thread."""
    host = [(p, to_numpy(x, copy=True)) for p, x in flatten_with_paths(state)]

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


def restore_checkpoint(directory: str, step: int, like):
    """Load ``step`` into the structure of ``like`` (a tree of tensors),
    each array on the device of its ``like`` leaf.

    Every leaf's shape must equal its ``like`` leaf's, or ``ValueError``.
    """
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    out = []
    for p, leaf in flatten_with_paths(like):
        meta = by_path[p]
        a = np.load(os.path.join(final, meta["file"]))
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{p}: checkpoint shape {tuple(a.shape)}, expected {tuple(leaf.shape)}")
        out.append(torch.from_numpy(a).to(leaf.device))
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

