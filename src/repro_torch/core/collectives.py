"""Collectives over mesh axes: the port's ``jax.lax.psum``, ``pmax``,
``all_gather(tiled=True)``, ``psum_scatter(tiled=True)``,
``all_to_all(tiled=True)``, ``all_gather_invariant(tiled=True)`` and its
transpose, a block slice of a replicated tensor, inside ``shard_map`` (no
reference module of its own: the reference calls ``jax.lax``), for the
train side's data-parallel step, ZeRO-1's update, ``psum_compressed``,
EGNN's sharded loss, the dense LM's tensor- and sequence-parallel layers
and the MoE layer's experts over ``model``.

Every collective takes ``xs``, one tensor per mesh position this process
holds (:func:`positions`), and returns one per position, as the serve
step has its two forms:

* on a :class:`~repro_torch.core.distributed.ProcessMesh`, ``xs`` holds
  this rank's one tensor and the collective communicates: one
  :meth:`~repro_torch.core.distributed.ProcessMesh.gather_axes` of the
  group's tensors;
* on a plain :class:`~repro_torch.core.distributed.Mesh`, ``xs`` holds
  every position's tensor, and the collective is a loop over them on one
  device.

A group is the positions that differ only on ``axes`` (:meth:`Mesh.group`),
in row-major order of their coordinates there.  Every float sum is a
gather followed by additions from zero in that order (:func:`ordered_sum`),
never an ``all_reduce``, which adds in the backend's order: so a process
mesh gives the loop's bits, and a sum over ranks gives the bits of the
one-process step that adds microbatches in the same order.

Gradients (``torch.autograd.Function``s), as JAX transposes the same
collectives:

* :func:`all_gather`'s backward is the :func:`psum_scatter` of the
  cotangents along the same dim, and :func:`psum_scatter`'s is the
  :func:`all_gather`;
* :func:`all_to_all`'s backward is the inverse :func:`all_to_all` (its two
  dims swapped): it moves blocks and adds nothing, so both directions are
  bitwise the loop form's;
* :func:`split` takes the position's block of a tensor replicated over the
  group and moves nothing; its backward is the tiled all-gather of the
  group's block cotangents (the replicated input's whole cotangent, on
  every member, with nothing added);
* :func:`all_gather_invariant` is :func:`split`'s transpose: the tiled
  all-gather of the blocks, whose output is replicated over the group, so
  its cotangent is too and the backward keeps the position's block of it,
  adding nothing (:func:`all_gather`'s backward, a ``psum_scatter``, would
  count a replicated cotangent G times).  On a plain mesh the members of a
  group share one output, as :func:`psum`'s;
* :func:`replicated` is the identity; its backward sums each leaf's
  cotangents over the group.  It is the one place gradients of replicated
  parameters are reduced: the data-parallel step and the sharded EGNN loss
  both enter their parameters through it;
* :func:`psum`'s output is replicated over the group, so its cotangent is
  too: the backward hands it to every member unchanged.  On a plain mesh
  the group's members share one output, computed once; a loss read at
  position 0 then reaches every member's input once.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.distributed import Mesh, ProcessMesh
from repro_torch.sharding.specs import get_context
from repro_torch.train.tree import leaves, unflatten

# the tensor-parallel axis of the dense LM (the rules' heads, ffn, vocab)
MODEL = ("model",)


def model_mesh(mesh=None) -> ProcessMesh | None:
    """``mesh`` (default: the sharding context's) when it is a
    :class:`ProcessMesh` whose ``model`` axis splits the model (size > 1),
    else None: the LM's layers then compute on their parameter blocks,
    entering each parallel region through :func:`replicated` and leaving it
    through a :func:`psum` over :data:`MODEL`."""
    mesh = get_context().mesh if mesh is None else mesh
    if isinstance(mesh, ProcessMesh) and mesh.shape.get("model", 1) > 1:
        return mesh
    return None



def positions(mesh: Mesh) -> list[int]:
    """The mesh positions this process holds: its rank on a
    :class:`ProcessMesh`, every position on a plain :class:`Mesh`."""
    return [mesh.rank] if isinstance(mesh, ProcessMesh) else list(range(mesh.size))


def group_size(mesh: Mesh, axes: tuple[str, ...]) -> int:
    """The number of positions in a group over ``axes``."""
    return math.prod(mesh.shape[a] for a in axes)


def _check_entries(mesh: Mesh, xs) -> list[int]:
    """The local positions, checked against the number of entries."""
    local = positions(mesh)
    if len(xs) != len(local):
        raise ValueError(f"a collective on {type(mesh).__name__} {mesh.shape} takes "
                         f"{len(local)} local entries, got {len(xs)}")
    return local


def gather(mesh: Mesh, xs: list[list[torch.Tensor]], axes: tuple[str, ...]) -> list[list]:
    """For each local position, its group's tensor lists (``xs[i]`` is
    position ``positions(mesh)[i]``'s list), member by member in group
    order.  Every member passes tensors of the same shapes and dtypes."""
    local = _check_entries(mesh, xs)
    if isinstance(mesh, ProcessMesh):
        return [mesh.gather_axes(list(xs[0]), tuple(axes))]
    return [[xs[q] for q in mesh.group(tuple(axes), p)] for p in local]


def ordered_sum(parts) -> torch.Tensor:
    """``parts`` added from zero in order, in their dtype (each add
    rounded to it)."""
    acc = torch.zeros_like(parts[0])
    for x in parts:
        acc.add_(x)
    return acc


def pmax(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...]) -> list[torch.Tensor]:
    """Each position's group maximum (elementwise; not differentiable)."""
    return [functools.reduce(torch.maximum, [m[0] for m in members])
            for members in gather(mesh, [[x] for x in xs], axes)]


def _block(x: torch.Tensor, n: int, i: int, dim: int = 0) -> torch.Tensor:
    """Block ``i`` of ``n`` equal blocks of ``x`` along ``dim``."""
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} entries of dim {dim} do not divide over a group of {n}")
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def _all_gather(mesh, xs, axes, dim) -> list[torch.Tensor]:
    return [torch.cat([m[0] for m in members], dim=dim)
            for members in gather(mesh, [[x] for x in xs], axes)]


def _psum_scatter(mesh, xs, axes, dim) -> list[torch.Tensor]:
    out = []
    for p, members in zip(positions(mesh), gather(mesh, [[x] for x in xs], axes)):
        i, n = mesh.group(tuple(axes), p).index(p), len(members)
        out.append(ordered_sum([_block(m[0], n, i, dim) for m in members]))
    return out


def _all_to_all(mesh, xs, axes, split_dim, concat_dim) -> list[torch.Tensor]:
    out = []
    for p, members in zip(positions(mesh), gather(mesh, [[x] for x in xs], axes)):
        i, n = mesh.group(tuple(axes), p).index(p), len(members)
        out.append(torch.cat([_block(m[0], n, i, split_dim) for m in members], dim=concat_dim))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return tuple(_all_gather(mesh, list(xs), axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_psum_scatter(ctx.mesh, list(gs), ctx.axes, ctx.dim))


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return tuple(_psum_scatter(mesh, list(xs), axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_all_gather(ctx.mesh, list(gs), ctx.axes, ctx.dim))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, split_dim, concat_dim, *xs):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, (split_dim, concat_dim)
        return tuple(_all_to_all(mesh, list(xs), axes, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        return (None,) * 4 + tuple(_all_to_all(ctx.mesh, list(gs), ctx.axes, concat_dim,
                                               split_dim))


class _Psum(torch.autograd.Function):
    """One group's sum from its local members (every member on a plain
    mesh, this rank on a process mesh)."""

    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.n = len(xs)
        if isinstance(mesh, ProcessMesh):
            return ordered_sum([m[0] for m in gather(mesh, [[xs[0]]], axes)[0]])
        return ordered_sum(xs)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + (g,) * ctx.n


def all_gather(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...],
               dim: int = 0) -> list[torch.Tensor]:
    """``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``: each
    position's group's tensors concatenated along ``dim`` in group order."""
    return list(_AllGather.apply(mesh, tuple(axes), dim, *xs))


def psum_scatter(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...],
                 dim: int = 0) -> list[torch.Tensor]:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the group's sum (from zero, in group order), each position keeping the
    block along ``dim`` of its place in the group."""
    return list(_PsumScatter.apply(mesh, tuple(axes), dim, *xs))


def all_to_all(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...], split_dim: int,
               concat_dim: int) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axes, split_dim, concat_dim, tiled=True)``:
    each member's tensor cut into G equal blocks along ``split_dim`` (G the
    group's size); member i receives block i of every member, concatenated
    along ``concat_dim`` in group order.  On a process mesh one gather of
    the group's tensors, then each rank slices its blocks."""
    return list(_AllToAll.apply(mesh, tuple(axes), split_dim, concat_dim, *xs))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return tuple(_block(x, group_size(mesh, axes), mesh.group(axes, p).index(p), dim)
                     for p, x in zip(_check_entries(mesh, xs), xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_all_gather(ctx.mesh, list(gs), ctx.axes, ctx.dim))


class _GatherInvariant(torch.autograd.Function):
    """One group's tiled gather from its local members (every member on a
    plain mesh, this rank on a process mesh); the backward hands each
    member its block of the one cotangent."""

    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.dim = dim
        if isinstance(mesh, ProcessMesh):
            ctx.places = [mesh.group(axes, mesh.rank).index(mesh.rank)]
            ctx.n = group_size(mesh, axes)
            return _all_gather(mesh, list(xs), axes, dim)[0]
        ctx.places, ctx.n = list(range(len(xs))), len(xs)
        return torch.cat(xs, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, *(_block(g, ctx.n, i, ctx.dim) for i in ctx.places))


def split(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...],
          dim: int = 0) -> list[torch.Tensor]:
    """Each position's block along ``dim`` of its tensor, which is
    replicated over the group: block i of G for the member at place i (the
    inverse of a tiled all-gather).  No communication; the backward
    all-gathers the block cotangents along ``dim``."""
    return list(_Split.apply(mesh, tuple(axes), dim, *xs))


def all_gather_invariant(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...],
                         dim: int = 0) -> list[torch.Tensor]:
    """``jax.lax.all_gather_invariant(x, axes, axis=dim, tiled=True)``: the
    group's tensors concatenated along ``dim`` in group order, replicated
    over the group; the backward keeps each member's block of the
    cotangent (:func:`split`'s transpose).  On a plain mesh the members of
    a group share one output."""
    axes = tuple(axes)
    local = _check_entries(mesh, xs)
    if isinstance(mesh, ProcessMesh):
        return [_GatherInvariant.apply(mesh, axes, dim, xs[0])]
    outs: dict[tuple, torch.Tensor] = {}
    for p in local:
        members = tuple(mesh.group(axes, p))
        if members not in outs:
            outs[members] = _GatherInvariant.apply(mesh, axes, dim, *[xs[q] for q in members])
    return [outs[tuple(mesh.group(axes, p))] for p in local]


def psum(mesh: Mesh, xs: list[torch.Tensor], axes: tuple[str, ...]) -> list[torch.Tensor]:
    """``jax.lax.psum``: each position's group sum, from zero in group
    order.  On a plain mesh the members of a group share one output."""
    axes = tuple(axes)
    local = _check_entries(mesh, xs)
    if isinstance(mesh, ProcessMesh):
        return [_Psum.apply(mesh, axes, xs[0])]
    sums: dict[tuple, torch.Tensor] = {}
    out = []
    for p in local:
        members = tuple(mesh.group(axes, p))
        if members not in sums:
            sums[members] = _Psum.apply(mesh, axes, *[xs[q] for q in members])
        out.append(sums[members])
    return out


class _Replicated(torch.autograd.Function):
    """Per local position, a view of every leaf; the backward sums each
    leaf's cotangents over the group, from zero in group order."""

    @staticmethod
    def forward(ctx, mesh, axes, *flat):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, len(flat)
        return tuple(x.view_as(x) for _ in positions(mesh) for x in flat)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        per_pos = [list(gs[i * n:(i + 1) * n]) for i in range(len(gs) // n)]
        members = gather(ctx.mesh, per_pos, ctx.axes)[0]  # position 0's group: every one
        return (None, None, *(ordered_sum([m[j] for m in members]) for j in range(n)))


def replicated(mesh: Mesh, tree, axes: tuple[str, ...]) -> list:
    """``tree`` (replicated parameters) entering per-position code: one
    tree per local position, equal to ``tree``; the backward sums each
    leaf's cotangents over the group (:class:`_Replicated`).  On a plain
    mesh ``axes`` must span the mesh (one group): its one ``tree`` takes
    every position's cotangent."""
    axes = tuple(axes)
    if not isinstance(mesh, ProcessMesh) and group_size(mesh, axes) != mesh.size:
        raise ValueError(f"on a plain mesh, replicated sums over every axis of size > 1: "
                         f"{axes} of {mesh.shape}")
    flat = leaves(tree)
    outs = _Replicated.apply(mesh, axes, *flat)
    n = len(flat)
    return [unflatten(tree, list(outs[i * n:(i + 1) * n])) for i in range(len(outs) // n)]
