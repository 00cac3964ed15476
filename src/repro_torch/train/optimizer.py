"""AdamW with global-norm clipping and cosine/linear/constant schedules
(port of ``repro/train/optimizer.py``).

The reference's formula, op for op, in f32: clip scale
``min(1, clip / max(gnorm, 1e-9))``; bias corrections ``1 − b^step``
computed in f32; then ``p − lr·(m̂/(sqrt(v̂) + eps) + wd·p)``.  Not
``torch.optim.AdamW``, which decays before the Adam step and does not clip.
Leaves are walked in ``jax.tree.leaves`` order (sorted dict keys), and the
global norm is the Python sum of per-leaf f32 squared sums in that order.

The update is dense (every row of every embedding table decays and moves
its moments each step, as in the reference) and in place: ``p``, ``m`` and
``v`` are written under ``torch.no_grad()`` and the same dicts come back —
the counterpart of the reference's donation of params and state into the
jitted step.  The schedule, clip scale and bias corrections stay 0-d
tensors on the device, so a step makes no host sync.

ZeRO-1 (``cfg.zero1`` with ``moment_shardings``, the reference's
``zero1_sharding`` layout, on a
:class:`~repro_torch.core.distributed.ProcessMesh`): where a leaf's
sharding puts ``data`` on a dimension, each rank holds only its block of
``m`` and ``v`` along it (by its ``data`` coordinate), updates only its
block of the parameter from the full reduced gradient, and one all-gather
over ``data`` rebuilds every replicated parameter; leaves the layout leaves
whole are updated whole on every rank.  The formula is elementwise, so a
block's bits are the dense update's.  The reference states the layout as
a sharding constraint and lets XLA place the moments; on a plain
:class:`~repro_torch.core.distributed.Mesh`, or without shardings, the
update is dense.

Tensor parallelism: where a leaf's sharding also splits it over other
axes (``model``), the rank's parameter, gradient and moments are that
block (``data`` then splits the block further), and the global norm adds
each such leaf's squared sum over those axes first (:func:`global_norm`),
so it is the global arrays' norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core import collectives as col
from repro_torch.sharding.specs import NamedSharding, PartitionSpec, splits
from repro_torch.train.tree import leaves, unflatten


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # ZeRO-1 moment sharding over the data axis (:func:`zero1_sharding`):
    # with ``moment_shardings`` on a process mesh each rank holds its block
    # of the moments; on one device there is nothing to shard
    zero1: bool = False


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), in f32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "linear":
        decay = torch.clamp_min(1.0 - (step - cfg.warmup_steps) / span, 0.0)
    else:  # cosine
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_opt_state(cfg: OptimizerConfig, params, moment_shardings=None) -> dict:
    """``step`` (int32, 0-d) and zero moments beside ``params``: under
    ZeRO-1 (:func:`zero1_blocks`) only this rank's blocks."""
    device = leaves(params)[0].device
    blocks = zero1_blocks(cfg, params, moment_shardings)

    def zeros():
        return unflatten(params, [torch.zeros_like(p if b is None else p.narrow(*b))
                                  for p, b in zip(leaves(params), blocks)])

    return {"step": torch.zeros((), dtype=torch.int32, device=device), "m": zeros(), "v": zeros()}


def zero1_sharding(mesh, spec, shape) -> NamedSharding:
    """ZeRO-1 moment sharding: the param's own spec + the ``data`` axis on
    the first free dim it divides (so moments shard over data×model while
    params stay replicated across data)."""
    if "data" in spec.axes() or "data" not in mesh.axis_names:
        return NamedSharding(mesh, spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % mesh.shape["data"] == 0:
            entries[i] = "data"
            return NamedSharding(mesh, PartitionSpec(*entries))
    return NamedSharding(mesh, spec)


def zero1_blocks(cfg: OptimizerConfig, params, moment_shardings) -> list:
    """Per leaf of ``params`` (this rank's blocks), this rank's ZeRO-1 block
    of its moments as ``narrow`` arguments ``(dim, start, length)``, or None
    where the leaf stays whole: the dimension whose sharding names ``data``
    (as :func:`zero1_sharding` adds it), split by the rank's ``data``
    coordinate (:meth:`~repro_torch.sharding.specs.NamedSharding.block`
    over ``data`` alone: the parameter is already the block of its other
    axes).  All None unless ``cfg.zero1`` and the shardings are on a
    :class:`~repro_torch.core.distributed.ProcessMesh`."""
    flat = leaves(params)
    if not cfg.zero1 or moment_shardings is None:
        return [None] * len(flat)
    shardings = leaves(moment_shardings)
    if len(shardings) != len(flat):
        raise ValueError(f"{len(shardings)} moment shardings for {len(flat)} parameters")
    out = []
    for p, sh in zip(flat, shardings):
        block = sh.block(tuple(p.shape), axes=("data",)) if splits(sh) else []
        out.append(block[0] if block else None)
    return out


def _model_axes(sharding) -> tuple[str, ...]:
    """The axes other than ``data`` that ``sharding`` splits its leaf over
    on a process mesh (the parameter's own split), in spec order."""
    if not splits(sharding):
        return ()
    return tuple(a for a in sharding.spec.axes()
                 if a != "data" and sharding.mesh.shape[a] > 1)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The global norm: the per-leaf f32 squared sums added in leaf order.
    With ``shardings`` (a tree like ``tree``) a leaf split over process-mesh
    axes other than ``data`` is the rank's block: its squared sum is first
    summed over those axes (one ordered ``psum`` per axis set, all such
    leaves stacked), so every rank gets the global arrays' norm; whole
    leaves count once.  The shardings must describe the leaves as held: a
    whole leaf under a sharding split over ``model`` would count M times
    (``launch.steps.build_recsys_cell`` refuses such a mesh for training)."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if shardings is not None:
        groups: dict[tuple, list[int]] = {}
        for i, sh in enumerate(leaves(shardings)):
            axes = _model_axes(sh)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            mesh = leaves(shardings)[idx[0]].mesh
            summed = col.psum(mesh, [torch.stack([sq[i] for i in idx])], axes)[0]
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, params, state, moment_shardings=None):
    """One AdamW step, in place.  Returns (params, state, metrics) — the
    same ``params`` and ``state`` objects, updated — with metrics
    ``grad_norm`` and ``lr`` as 0-d tensors.  Params, grads and moments are
    f32 (every config's ``param_dtype``).  ``moment_shardings`` (a tree
    like ``params`` of :func:`zero1_sharding`'s layouts) makes the update
    ZeRO-1's under ``cfg.zero1`` on a process mesh (module docstring); the
    grads are then the full reduced ones, equal on every rank, and so is
    the global norm (:func:`global_norm`, over ``model`` blocks too)."""
    blocks = zero1_blocks(cfg, params, moment_shardings)
    step = state["step"] + 1
    gnorm = global_norm(grads, moment_shardings)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    split = []  # (parameter, its block, the updated block) of each split leaf
    for g, p, m, v, b in zip(leaves(grads), leaves(params), leaves(state["m"]),
                             leaves(state["v"]), blocks):
        if not (p.dtype == m.dtype == v.dtype == torch.float32):
            raise TypeError(f"AdamW state must be f32, got {p.dtype}/{m.dtype}/{v.dtype}")
        whole = p
        if b is not None:
            g, p = g.narrow(*b), p.narrow(*b)
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"moments of shape {tuple(m.shape)} beside a parameter block of "
                             f"{tuple(p.shape)}: init_opt_state with the same shardings")
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        den = (v / bc2).sqrt_().add_(cfg.eps)  # sqrt(v̂) + eps
        upd = (m / bc1).div_(den)  # m̂ / (sqrt(v̂) + eps)
        del den
        upd.add_(cfg.weight_decay * p)
        p.sub_(upd.mul_(lr))
        if b is not None:
            split.append((whole, b, p))
    if split:  # every rank's updated blocks, in data order, into every parameter
        mesh = leaves(moment_shardings)[0].mesh
        every = mesh.gather_axes([blk.contiguous() for _, _, blk in split], ("data",))
        for j, (whole, (dim, _, k), _) in enumerate(split):
            for c, parts in enumerate(every):
                whole.narrow(dim, c * k, k).copy_(parts[j])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
