"""Mixture-of-Experts FFN with top-k routing and grouped, sort-based
capacity dispatch (port of ``repro/models/moe.py``).

A group is one sequence.  Per group:

1. router logits (in ``x``'s dtype, then f32) → softmax → the top-k
   experts of each token, their probabilities renormalised;
2. the (token, k) assignments flattened and sorted stably by expert id;
3. each assignment's position within its expert from the sorted runs;
   assignments at or past the capacity ``C = max(int(f · S · K / E + 0.5),
   1)`` are dropped (they go to an overflow slot that is cut off);
4. slot → token maps ``[E · C]``, the tokens gathered into ``[E, C, D]``,
   the batched expert SwiGLU, and each token's kept outputs, weighted by
   their router probabilities, summed back.

The reference maps each group with ``vmap``; here every step is batched
over the group axis ``B``, and each group keeps its own sort, capacity and
slots.  The expert products run expert-major (``[E, B · C, D]``), which
changes nothing in the values.

Both data movements have a fixed order, on the card too.  The combine sums
each token's kept contributions in ascending slot order (ascending expert
id) from a zero, as the reference's ``.at[slot_token].add`` does on the
CPU; it gathers through the inverse map (token, k) → slot, where the
reference's scatter-add would run on atomics here.  The dispatch gather's
backward is the same per-token gather-sum, and the combine's backward is
the dispatch's gather, so a train step's gradients are repeatable bit for
bit.

The load-balance loss (Switch) is ``E · Σ_e mean_prob_e · assign_frac_e``
over all ``B · S · K`` assignments.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ranking import select_top


def capacity(cfg, S: int) -> int:
    """Slots per expert for a group of ``S`` tokens (Python floats, as the
    reference)."""
    return max(int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts + 0.5), 1)


def _dispatch_maps(top_e: torch.Tensor, top_p: torch.Tensor, E: int, C: int):
    """The grouped dispatch's maps.  ``top_e``/``top_p`` [B, S, K] →

    * ``slot_token`` i64[B, E·C]: the token each slot holds (0 when unused);
    * ``slot_used`` bool[B, E·C];
    * ``slot_w`` f32[B, E·C]: the router weight of the slot's assignment (0
      when unused), differentiable in ``top_p``;
    * ``tok_slot`` i64[B, S, K]: each token's slots in ascending order, the
      overflow slot ``E·C`` for a dropped assignment (sorted last).
    """
    B, S, K = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(B, S * K)
    flat_t = torch.arange(S, device=dev).repeat_interleave(K).expand(B, S * K)
    flat_w = top_p.reshape(B, S * K).float()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_s = torch.gather(flat_e, 1, order)
    t_s = torch.gather(flat_t, 1, order)
    w_s = torch.gather(flat_w, 1, order)
    first = torch.searchsorted(e_s, e_s, side="left")
    pos = torch.arange(S * K, device=dev) - first
    keep = pos < C
    slot = torch.where(keep, e_s * C + pos, E * C)  # overflow bucket
    # the kept slots are distinct; the overflow slot is cut off below
    slot_token = torch.zeros((B, E * C + 1), dtype=torch.long, device=dev).scatter(1, slot, t_s)
    slot_used = torch.zeros((B, E * C + 1), dtype=torch.bool, device=dev).scatter(1, slot, keep)
    slot_w = torch.zeros((B, E * C + 1), dtype=torch.float32, device=dev).scatter(
        1, slot, torch.where(keep, w_s, 0.0))
    tok_slot = torch.empty_like(slot).scatter(1, order, slot)
    tok_slot = torch.sort(tok_slot.reshape(B, S, K), dim=-1).values
    return slot_token[:, :E * C], slot_used[:, :E * C], slot_w[:, :E * C], tok_slot


def _slot_gather(x: torch.Tensor, slot_token: torch.Tensor, slot_used: torch.Tensor):
    """x [B, S, D] → [B, E·C, D]: each used slot's token row, else 0."""
    idx = slot_token[..., None].expand(-1, -1, x.shape[-1])
    return torch.where(slot_used[..., None], torch.gather(x, 1, idx), 0)


def _token_sum(y: torch.Tensor, tok_slot: torch.Tensor) -> torch.Tensor:
    """y [B, E·C, D] → [B, S, D]: each token's slots added in ascending slot
    order from a zero (the overflow slot reads a zero row)."""
    B, S, K = tok_slot.shape
    y = F.pad(y, (0, 0, 0, 1))
    out = torch.zeros((B, S, y.shape[-1]), dtype=y.dtype, device=y.device)
    for k in range(K):
        idx = tok_slot[:, :, k, None].expand(-1, -1, y.shape[-1])
        out = out + torch.gather(y, 1, idx)
    return out


class _Dispatch(torch.autograd.Function):
    """:func:`_slot_gather`, whose backward is :func:`_token_sum`."""

    @staticmethod
    def forward(ctx, x, slot_token, slot_used, tok_slot):
        ctx.save_for_backward(tok_slot)
        return _slot_gather(x, slot_token, slot_used)

    @staticmethod
    def backward(ctx, g):
        (tok_slot,) = ctx.saved_tensors
        return _token_sum(g, tok_slot), None, None, None


class _Combine(torch.autograd.Function):
    """:func:`_token_sum`, whose backward is :func:`_slot_gather`."""

    @staticmethod
    def forward(ctx, y, slot_token, slot_used, tok_slot):
        ctx.save_for_backward(slot_token, slot_used)
        return _token_sum(y, tok_slot)

    @staticmethod
    def backward(ctx, g):
        slot_token, slot_used = ctx.saved_tensors
        return _slot_gather(g, slot_token, slot_used), None, None, None


def _route(x: torch.Tensor, p: dict, cfg):
    """Router probabilities f32[..., E] and the top-k (probs, experts) of
    ``x`` [..., D]: the logits in ``x``'s dtype, then f32; ties to the
    lower expert id, as ``jax.lax.top_k``."""
    logits = torch.matmul(x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = select_top(probs, cfg.top_k)
    if cfg.norm_topk_probs:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def moe_ffn(x: torch.Tensor, p: dict, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (out [B, S, D], aux_loss f32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, top_p, top_e = _route(x, p, cfg)

    # load-balance aux loss (Switch): E · Σ_e f_e · p_e over all assignments
    me = probs.mean(dim=(0, 1))
    # the assignments per expert, as bincount's integers, with a
    # shape-static op (bincount's output size depends on the data, so it
    # has no meta kernel and the dry-run could not trace it)
    flat_e = top_e.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (B * S * K)
    aux = E * torch.sum(me * ce)

    C = capacity(cfg, S)
    slot_token, slot_used, slot_w, tok_slot = _dispatch_maps(top_e, top_p, E, C)
    xe = _Dispatch.apply(x, slot_token, slot_used, tok_slot)  # [B, E·C, D]

    # batched expert SwiGLU, expert-major: [E, B·C, D]
    xe = xe.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    gate = torch.bmm(xe, p["wi_gate"].to(x.dtype))
    up = torch.bmm(xe, p["wi_up"].to(x.dtype))
    ye = torch.bmm(F.silu(gate) * up, p["wo"].to(x.dtype))
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # unused slots hold 0 (a zero row through the SwiGLU, weight 0) and
    # no token reads them
    ye = ye * slot_w.to(ye.dtype)[..., None]
    return _Combine.apply(ye, slot_token, slot_used, tok_slot), aux


def moe_ffn_ref(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Dense oracle: every expert on every token.  Equals :func:`moe_ffn`
    when ``capacity_factor`` is large enough that no token is dropped."""
    B, S, D = x.shape
    E = cfg.n_experts
    xt = x.reshape(B * S, D)
    _, top_p, top_e = _route(xt, p, cfg)
    dt = x.dtype
    gate = torch.einsum("td,edf->tef", xt, p["wi_gate"].to(dt))
    up = torch.einsum("td,edf->tef", xt, p["wi_up"].to(dt))
    ye = torch.einsum("tef,efd->ted", F.silu(gate) * up, p["wo"].to(dt))  # [T, E, D]
    weights = (F.one_hot(top_e, E).float() * top_p[..., None]).sum(dim=1)  # [T, E]
    out = torch.einsum("ted,te->td", ye.float(), weights)
    return out.reshape(B, S, D).to(dt)
