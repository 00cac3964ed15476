"""Plain PyTorch versions of the sweep kernels (same arithmetic order).

``sweep_score_planar_ref`` and ``sweep_score_pruned_planar_ref`` take the
kernels' exact inputs and repeat their arithmetic op for op — decode
astype-f32 then × scale, ``acc + (w*h)*qa`` over the ``Q_MAX`` slots, × amp
— and the pruned one walks the tiles in order with the same cyclic
partial top-C buffer and θ = min(buffer) rule, so on the card every score
and every skip flag agrees with the kernel bitwise.

``live_slots`` is the rule by which the card's scorer skips query slots
that add exactly nothing; ``sweep_score_planar_live_ref``, a test aid,
scores with that rule and is held bitwise to the all-slot version.

``sweep_score_ref`` / ``sweep_score_pruned_ref`` run the wrappers' whole
pipeline (window offsets, block bounds, re-window) through these
plain cores: the latter is the scorer behind ``k_sweep(prune=True,
fused=False)``, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sweep_score.kernel import LANES, Q_MAX, TILE


def _window_store(block_starts, store, pad_budget):
    """The store as every window position reads it, decoded to f32: (live
    [B, k, pad] — the position lies in the store —, amp, x0, y0, x1, y1);
    positions past the end read the last row, and ``live`` masks them."""
    rects, amps, scale = store
    T = rects.shape[0]
    p = block_starts.long()[..., None] * TILE + torch.arange(
        pad_budget, device=block_starts.device
    )
    live = p < T
    pc = torch.clamp(p, max=T - 1)
    a = amps[pc].float()
    if scale is not None:
        a = a * scale[torch.div(pc, LANES, rounding_mode="floor")]
    return (live, a, *(rects[:, c][pc].float() for c in range(4)))


def _slot_term(acc, x0, y0, x1, y1, q, qa):
    """acc + (w*h)*qa for one query slot ``q`` = [.., 4] (broadcast)."""
    w = torch.clamp(torch.minimum(x1, q[..., 2]) - torch.maximum(x0, q[..., 0]), min=0.0)
    h = torch.clamp(torch.minimum(y1, q[..., 3]) - torch.maximum(y0, q[..., 1]), min=0.0)
    return acc + (w * h) * qa


def sweep_score_planar_ref(
    block_starts: torch.Tensor,  # i32[B, k] window origins in TILE units
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4]
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
    store: tuple,  # rects [T, 4], amps [T], scale f32[ceil(T/LANES)] or None
    pad_budget: int,
) -> torch.Tensor:
    """Scores of every window position, f32[B, k, pad_budget]; positions
    past the store's end score 0."""
    if store[0].shape[0] == 0:
        return torch.zeros((*block_starts.shape, pad_budget), dtype=torch.float32,
                           device=block_starts.device)
    live, a, x0, y0, x1, y1 = _window_store(block_starts, store, pad_budget)
    acc = torch.zeros_like(x0)
    for j in range(Q_MAX):
        q = q_rects[:, None, None, j]  # [B, 1, 1, 4]
        acc = _slot_term(acc, x0, y0, x1, y1, q, q_amps[:, j, None, None])
    return torch.where(live, acc * a, 0.0)


def live_slots(q_rects: torch.Tensor, q_amps: torch.Tensor) -> torch.Tensor:
    """bool[B, Q]: the query slots that can change a score.  A slot of amp
    0 (or −0) whose extent area fl(fl(x1 − x0) · fl(y1 − y0)) is finite
    adds exactly ±0 to the running sum (proof in ``csrc/sweep_score.cu``),
    so the card's scorer skips it; every other slot is live."""
    area = (q_rects[..., 2] - q_rects[..., 0]) * (q_rects[..., 3] - q_rects[..., 1])
    return (q_amps != 0) | ~torch.isfinite(area)


def sweep_score_planar_live_ref(
    block_starts: torch.Tensor,
    q_rects: torch.Tensor,
    q_amps: torch.Tensor,
    store: tuple,
    pad_budget: int,
) -> torch.Tensor:
    """Test aid: :func:`sweep_score_planar_ref` with the card's loop — each
    query sums its live slots only (:func:`live_slots`), in slot order.
    Bitwise equal to the all-slot version."""
    if store[0].shape[0] == 0:
        return torch.zeros((*block_starts.shape, pad_budget), dtype=torch.float32,
                           device=block_starts.device)
    live, a, x0, y0, x1, y1 = _window_store(block_starts, store, pad_budget)
    keep = live_slots(q_rects, q_amps)
    acc = torch.zeros_like(x0)
    for b in range(acc.shape[0]):
        for j in torch.nonzero(keep[b]).flatten().tolist():
            acc[b] = _slot_term(acc[b], x0[b], y0[b], x1[b], y1[b], q_rects[b, j], q_amps[b, j])
    return torch.where(live, acc * a, 0.0)


def sweep_score_pruned_planar_ref(
    block_starts: torch.Tensor,  # i32[B, k]
    bounds: torch.Tensor,  # i32[B, k, 2]
    floor: torch.Tensor,  # f32[B]
    block_ub: torch.Tensor,  # f32[B, k, n_tiles * bpt]
    q_rects: torch.Tensor,
    q_amps: torch.Tensor,
    store: tuple,
    pad_budget: int,
    max_candidates: int,
    bpt: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[B, k, pad_budget], scored i32[B, k, n_tiles*bpt])."""
    B, k = block_starts.shape
    n_tiles = pad_budget // TILE
    bs = TILE // bpt
    cb = max(1, -(-max_candidates // TILE))
    sc_all = sweep_score_planar_ref(block_starts, q_rects, q_amps, store, pad_budget)
    pos = block_starts.long()[..., None] * TILE + torch.arange(
        pad_budget, device=block_starts.device
    )
    okm = (pos >= bounds[..., :1]) & (pos < bounds[..., 1:])
    n = k * n_tiles
    flat_ub = block_ub.reshape(B, n, bpt)
    flat_sc = sc_all.reshape(B, n, bpt, bs)
    flat_ok = okm.reshape(B, n, bpt, bs)
    # sequential tile walk: per-block decisions against the cyclic partial
    # top-C buffer, seeded with the select floor
    buf = floor.float()[:, None, None].expand(B, cb, TILE).clone()
    scored = torch.empty((B, n, bpt), dtype=torch.bool, device=sc_all.device)
    for t in range(n):
        theta = buf.amin(dim=(1, 2))
        s = flat_ub[:, t] > theta[:, None]
        scored[:, t] = s
        masked = torch.where(s[..., None] & flat_ok[:, t], flat_sc[:, t], 0.0)
        buf[:, t % cb] = torch.maximum(buf[:, t % cb], masked.reshape(B, TILE))
    out = torch.where(
        scored.reshape(B, k, n_tiles, bpt, 1),
        sc_all.reshape(B, k, n_tiles, bpt, bs),
        0.0,
    ).reshape(B, k, pad_budget)
    return out, scored.reshape(B, k, n_tiles * bpt).to(torch.int32)


def sweep_score_ref(
    tp_rects, tp_amps, sweep_starts, sweep_ends, q_rects, q_amps, budget,
    tp_amp_scale=None,
):
    """``ops.sweep_score`` through the plain core, on any device."""
    from repro_torch.kernels.sweep_score.ops import _sweep

    return _sweep(
        tp_rects, tp_amps, sweep_starts, sweep_ends, q_rects, q_amps, budget,
        tp_amp_scale, planar=sweep_score_planar_ref,
    )


def sweep_score_pruned_ref(
    tp_rects, tp_amps, blk_mbr, blk_max_amp, blk_max_mass, sweep_starts,
    sweep_ends, q_rects, q_amps, budget, max_candidates, block_size, floor=0.0,
    tp_amp_scale=None,
):
    """``ops.sweep_score_pruned`` through the plain core, on any device."""
    from repro_torch.kernels.sweep_score.ops import _sweep_pruned

    return _sweep_pruned(
        tp_rects, tp_amps, blk_mbr, blk_max_amp, blk_max_mass, sweep_starts,
        sweep_ends, q_rects, q_amps, budget, max_candidates, block_size, floor,
        tp_amp_scale, planar=sweep_score_pruned_planar_ref,
    )
