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
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.train.tree import leaves, tree_map


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
    # ZeRO-1 moment sharding over the data axis: accepted, and nothing to
    # do on one device (the sharded layout comes with the mesh across cards)
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


def init_opt_state(cfg: OptimizerConfig, params) -> dict:
    """``step`` (int32, 0-d) and zero moments beside ``params``."""
    device = leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, params, state):
    """One AdamW step, in place.  Returns (params, state, metrics) — the
    same ``params`` and ``state`` objects, updated — with metrics
    ``grad_norm`` and ``lr`` as 0-d tensors.  Params, grads and moments are
    f32 (every config's ``param_dtype``)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    for g, p, m, v in zip(leaves(grads), leaves(params), leaves(state["m"]), leaves(state["v"])):
        if not (p.dtype == m.dtype == v.dtype == torch.float32):
            raise TypeError(f"AdamW state must be f32, got {p.dtype}/{m.dtype}/{v.dtype}")
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        den = (v / bc2).sqrt_().add_(cfg.eps)  # sqrt(v̂) + eps
        upd = (m / bc1).div_(den)  # m̂ / (sqrt(v̂) + eps)
        del den
        upd.add_(cfg.weight_decay * p)
        p.sub_(upd.mul_(lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
