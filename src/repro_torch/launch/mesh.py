"""Production and host meshes (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device.  The production meshes are the reference's layouts of 256 and 512
devices, here abstract meshes on the ``meta`` device (H100s in the
dry-run's roofline, :mod:`repro_torch.launch.roofline`); no card is needed
to build or read them.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import Mesh, make_mesh
from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16×16 = 256 devices over ("data", "model").
    Multi-pod: 2×16×16 = 512 devices over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def make_host_mesh(
    shape: tuple[int, ...] | None = None,
    axes: tuple[str, ...] | None = None,
    device=None,
) -> Mesh:
    """A mesh over the cards this host has (``torch.cuda.device_count()``:
    ``(n, 1)`` over ("data", "model"), ``(1, 1)`` with one card) on
    ``device`` (CUDA unless given; on any other device one)."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if shape is None:
        shape = (n, 1) if n > 1 else (1, 1)
        axes = ("data", "model")
    return make_mesh(shape, axes, device=dev)
