"""int8 gradient compression with error feedback (port of
``repro/train/compression.py``).

Under data parallelism the gradient all-reduce moves ``4·n_params`` bytes
per step per link; quantizing to int8 with a per-tensor absmax scale cuts
that 4×, and the quantization error is fed back into the next step's
gradient (error feedback, Karimireddy et al. 2019).  ``torch.round``
rounds half to even, as ``jnp.round`` does.  The compressed all-reduce
(:func:`psum_compressed`) runs over the mesh of the ambient
``use_sharding`` context, the counterpart of ``shard_map``'s axes.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives as col
from repro_torch.core.distributed import ProcessMesh
from repro_torch.sharding.specs import get_context
from repro_torch.train.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization.  Returns (q int8, scale f32)."""
    absmax = torch.max(torch.abs(x.float()))
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, error_buf):
    """Quantize grads + error feedback; returns (q_tree, scales, new_error)."""

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error_buf))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(q_tree, s_tree):
    return tree_map(dequantize_int8, q_tree, s_tree)


def psum_compressed(grads, error_buf, axis_names):
    """The int8 all-reduce of the reference's ``shard_map`` step, step for
    step: ``compress_tree`` (error feedback), a ``pmax`` of each leaf's
    scale over ``axis_names`` (the common grid), each leaf re-quantized to
    int8 on it, an int32 sum over the axes, then ``acc · s_max / n`` with
    ``n`` the product of the axis sizes.  Returns (mean grads, new error
    buffer); the error buffer stays local.

    The mesh is the one of ``use_sharding(mesh)``.  On a
    :class:`~repro_torch.core.distributed.ProcessMesh` ``grads`` and
    ``error_buf`` are this rank's trees; on a plain mesh, lists of every
    position's trees (the loop form), and so are the results.  The int8
    values go on the wire (one gather of every leaf) and are summed in
    int32 in group order: an integer sum is exact in any order, so the
    result is the reference's bit for bit."""
    mesh = get_context().mesh
    if mesh is None:
        raise RuntimeError("psum_compressed runs over a mesh: call it under "
                           "repro_torch.sharding.specs.use_sharding(mesh)")
    axes = tuple(axis_names)
    local = col.positions(mesh)
    mesh.group(axes, local[0])  # the axes must be the mesh's
    procs = isinstance(mesh, ProcessMesh)
    g_list, e_list = ([grads], [error_buf]) if procs else (list(grads), list(error_buf))
    n = col.group_size(mesh, axes)
    comp = [compress_tree(g, e) for g, e in zip(g_list, e_list)]
    qs = [leaves(q) for q, _, _ in comp]
    ss = [leaves(s) for _, s, _ in comp]
    s_max = col.pmax(mesh, [torch.stack(s) for s in ss], axes)  # one gather of every scale
    q8 = [[torch.clamp(torch.round(dequantize_int8(q, s) / sm[j]), -127, 127).to(torch.int8)
           for j, (q, s) in enumerate(zip(qp, sp))]
          for qp, sp, sm in zip(qs, ss, s_max)]
    means = []
    for g, sm, members in zip(g_list, s_max, col.gather(mesh, q8, axes)):
        acc = [col.ordered_sum([m[j].to(torch.int32) for m in members]) for j in range(len(sm))]
        means.append(unflatten(g, [a.float() * sm[j] / n for j, a in enumerate(acc)]))
    errs = [e for _, _, e in comp]
    return (means[0], errs[0]) if procs else (means, errs)
