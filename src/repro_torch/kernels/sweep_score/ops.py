"""Public wrappers of the fused sweep kernels (port of
``repro/kernels/sweep_score/ops.py``, with an explicit batch axis).

Handles TILE alignment of sweep starts (the kernels read TILE-aligned
windows; the window is aligned down and the in-kernel budget grows by one
tile so the true [start, end) range is always covered), re-windowing back
to exact sweep bounds, and — for the pruned variant — the per-block upper
bounds that drive the in-kernel skip test.  The kernels read the index's
toe-print store in place: the reference's planar copy of the store existed
for the TPU's vector lanes, and here it would cost a pass over the whole
store per batch.  CUDA tensors go to the kernels, one launch per batch; CPU
tensors to their plain versions; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.spatial_index import INVALID, SCALE_BLOCK
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.geo_score.ops import pad_query
from repro_torch.kernels.sweep_score import kernel as K
from repro_torch.kernels.sweep_score.kernel import TILE
from repro_torch.kernels.sweep_score.ref import (
    sweep_score_planar_ref,
    sweep_score_pruned_planar_ref,
)

# (coordinates, amplitudes) of the stores the compress modes produce — none,
# f16 and int8 — and the only pairs the kernels are built for
_STORE_DTYPES = {
    (torch.float32, torch.float32),
    (torch.float16, torch.float16),
    (torch.float16, torch.int8),
}


def padded_budget(budget: int) -> int:
    """Positions per kernel window: the budget rounded up to a TILE, plus
    one TILE for the aligned-down start."""
    return (budget + TILE - 1) // TILE * TILE + TILE


def sweep_window_offsets(sweep_starts, sweep_ends, T):
    """Window prologue shared by the kernels' wrappers and their plain
    versions: INVALID-safe starts, TILE-aligned origins (elements and TILE
    units) and the exact candidate ``[start, end)`` bounds, all [B, k]."""
    safe = torch.where(sweep_starts == INVALID, 0, sweep_starts)
    aligned = torch.div(safe, TILE, rounding_mode="floor") * TILE
    block_starts = torch.div(aligned, TILE, rounding_mode="floor").to(torch.int32)
    ends = torch.where(sweep_starts == INVALID, 0, torch.clamp(sweep_ends, max=T))
    bounds = torch.stack([safe, ends], dim=-1).to(torch.int32).contiguous()
    return safe, aligned, block_starts, bounds


def _window(flat, safe, aligned, sweep_starts, sweep_ends, T, budget):
    """Re-window padded per-tile outputs [B, k, pad] to exactly
    ``[start, start+budget)`` and rebuild the valid mask."""
    j = torch.arange(budget, dtype=torch.int32, device=flat.device)
    idx = (safe - aligned)[..., None] + j
    scores = torch.gather(flat, 2, idx.long())
    pos = safe[..., None] + j
    ss = sweep_starts[..., None]
    valid = (ss != INVALID) & (pos >= ss) & (pos < sweep_ends[..., None]) & (pos < T)
    return scores, valid, idx


def rewindow_outputs(
    flat, scored, safe, aligned, sweep_starts, sweep_ends, T, budget, block_size
):
    """Pruned-sweep epilogue: re-windowed scores, the valid mask and the
    per-position streamed (block-scored) mask, all [B, k, budget]."""
    scores, valid, idx = _window(flat, safe, aligned, sweep_starts, sweep_ends, T, budget)
    streamed = torch.gather(
        scored.bool(), 2, torch.div(idx, block_size, rounding_mode="floor").long()
    )
    return torch.where(valid & streamed, scores, 0.0), valid, streamed


def block_upper_bounds(
    blk_mbr: torch.Tensor,  # f32[NB, 4]
    blk_max_amp: torch.Tensor,  # f32[NB]
    blk_max_mass: torch.Tensor,  # f32[NB]
    q_rects: torch.Tensor,  # [B, Q, 4]
    q_amps: torch.Tensor,  # [B, Q]
) -> torch.Tensor:
    """Safe per-block upper bound on any toe print's partial geo score,
    f32[B, NB]: min(blk_max_amp · Σ_q area(mbr ∩ q)·amp_q,
    blk_max_mass · Σ_q amp_q).  The sums run in slot order."""
    qr = q_rects.float()[:, None, :, :]  # [B, 1, Q, 4]
    qa = q_amps.float()
    m = blk_mbr[None, :, None, :]  # [1, NB, 1, 4]
    w = torch.clamp(
        torch.minimum(m[..., 2], qr[..., 2]) - torch.maximum(m[..., 0], qr[..., 0]), min=0.0
    )
    h = torch.clamp(
        torch.minimum(m[..., 3], qr[..., 3]) - torch.maximum(m[..., 1], qr[..., 1]), min=0.0
    )
    area_sum = torch.zeros(w.shape[:2], dtype=torch.float32, device=w.device)
    amp_sum = torch.zeros((qa.shape[0], 1), dtype=torch.float32, device=w.device)
    for q in range(qa.shape[1]):
        area_sum = area_sum + w[..., q] * h[..., q] * qa[:, q, None]
        amp_sum = amp_sum + qa[:, q, None]
    return torch.minimum(blk_max_amp * area_sum, blk_max_mass * amp_sum)


def window_block_bounds(
    ub_blocks: torch.Tensor,  # f32[B, NB]
    block_starts: torch.Tensor,  # i32[B, k] aligned window origins, TILE units
    bounds: torch.Tensor,  # i32[B, k, 2]
    n_tiles: int,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (sweep, window-block) bound and overlap mask, [B, k, n_tiles·bpt].

    The bound is zeroed for blocks outside the sweep's ``[start, end)``
    (they hold no candidates); ``overlap`` marks the blocks an unpruned
    sweep would stream — the baseline of the skipped-block counters."""
    B, nb = ub_blocks.shape
    k = block_starts.shape[1]
    bpt = TILE // block_size
    w = torch.arange(n_tiles * bpt, device=ub_blocks.device)
    b0 = block_starts.long()[..., None] * bpt + w  # metadata block per slot
    ub = torch.gather(ub_blocks, 1, torch.clamp(b0, 0, nb - 1).reshape(B, -1))
    ub = torch.where(b0 < nb, ub.reshape(B, k, -1), 0.0)
    e0 = b0 * block_size
    overlap = (e0 + block_size > bounds[..., :1]) & (e0 < bounds[..., 1:])
    return torch.where(overlap, ub, 0.0), overlap


def _check_store(tp_rects, tp_amps, tp_amp_scale, sweep_starts, sweep_ends, q_rects, q_amps):
    dev = tp_rects.device
    T = tp_rects.shape[0]
    B, k = sweep_starts.shape
    check_tensor("tp_rects", tp_rects, (torch.float32, torch.float16), (T, 4), dev)
    check_tensor("tp_amps", tp_amps, (torch.float32, torch.float16, torch.int8), (T,), dev)
    if (tp_rects.dtype, tp_amps.dtype) not in _STORE_DTYPES:
        raise TypeError(
            f"store of {tp_rects.dtype} rects and {tp_amps.dtype} amps: expected one of "
            f"{sorted((str(c), str(a)) for c, a in _STORE_DTYPES)}"
        )
    if (tp_amps.dtype == torch.int8) != (tp_amp_scale is not None):
        raise ValueError("tp_amp_scale is given with int8 amps, and only with them")
    if tp_amp_scale is not None:
        check_tensor("tp_amp_scale", tp_amp_scale, (torch.float32,), (None,), dev)
        if tp_amp_scale.shape[0] < (T + SCALE_BLOCK - 1) // SCALE_BLOCK:
            raise ValueError(f"tp_amp_scale: one scale per {SCALE_BLOCK} toe prints needed")
    check_tensor("sweep_starts", sweep_starts, (torch.int32,), (B, k), dev)
    check_tensor("sweep_ends", sweep_ends, (torch.int32,), (B, k), dev)
    check_tensor("q_amps", q_amps, (torch.float32,), (B, None), dev)
    check_tensor("q_rects", q_rects, (torch.float32,), (B, q_amps.shape[1], 4), dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep kernels run on cuda or cpu tensors, got {dev}")
    on_card = dev.type == "cuda"
    if on_card and tp_rects.data_ptr() % (4 * tp_rects.element_size()):
        raise ValueError("tp_rects: each [4] row must be aligned for one vector load")
    return on_card


def _sweep(tp_rects, tp_amps, sweep_starts, sweep_ends, q_rects, q_amps, budget,
           tp_amp_scale=None, *, planar):
    T = tp_rects.shape[0]
    qr, qa = pad_query(q_rects, q_amps)
    pad_budget = padded_budget(budget)
    safe, aligned, block_starts, _ = sweep_window_offsets(sweep_starts, sweep_ends, T)
    store = (tp_rects, tp_amps, tp_amp_scale)
    flat = planar(block_starts.contiguous(), qr, qa, store, pad_budget)
    scores, valid, _ = _window(flat, safe, aligned, sweep_starts, sweep_ends, T, budget)
    return torch.where(valid, scores, 0.0), valid


def sweep_score(
    tp_rects: torch.Tensor,  # [T, 4] f32|f16 toe-print store
    tp_amps: torch.Tensor,  # [T] f32|f16|int8
    sweep_starts: torch.Tensor,  # i32[B, k] element offsets (INVALID padded)
    sweep_ends: torch.Tensor,  # i32[B, k]
    q_rects: torch.Tensor,  # f32[B, Q, 4], Q <= Q_MAX
    q_amps: torch.Tensor,  # f32[B, Q]
    budget: int,
    tp_amp_scale: torch.Tensor | None = None,  # f32[ceil(T/128)], int8 store only
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused fetch+score: (scores f32[B, k, budget], valid bool[B, k, budget])."""
    on_card = _check_store(
        tp_rects, tp_amps, tp_amp_scale, sweep_starts, sweep_ends, q_rects, q_amps
    )
    if on_card:
        sweep_score.launches += 1
    return _sweep(
        tp_rects, tp_amps, sweep_starts, sweep_ends, q_rects, q_amps, budget,
        tp_amp_scale, planar=K.sweep_score_planar if on_card else sweep_score_planar_ref,
    )


sweep_score.launches = 0


def _sweep_pruned(tp_rects, tp_amps, blk_mbr, blk_max_amp, blk_max_mass,
                  sweep_starts, sweep_ends, q_rects, q_amps, budget, max_candidates,
                  block_size, floor=0.0, tp_amp_scale=None, *, planar):
    T = tp_rects.shape[0]
    B = sweep_starts.shape[0]
    bpt = TILE // block_size
    qr, qa = pad_query(q_rects, q_amps)
    pad_budget = padded_budget(budget)
    n_tiles = pad_budget // TILE
    safe, aligned, block_starts, bounds = sweep_window_offsets(
        sweep_starts, sweep_ends, T
    )
    ub_blocks = block_upper_bounds(blk_mbr, blk_max_amp, blk_max_mass, q_rects, q_amps)
    win_ub, overlap = window_block_bounds(ub_blocks, block_starts, bounds, n_tiles, block_size)
    floor = torch.clamp(
        torch.as_tensor(floor, dtype=torch.float32, device=tp_rects.device).expand(B),
        min=0.0,
    ).contiguous()
    flat, scored = planar(
        block_starts.contiguous(), bounds, floor, win_ub.contiguous(), qr, qa,
        (tp_rects, tp_amps, tp_amp_scale), pad_budget, max_candidates, bpt,
    )
    scores, valid, streamed = rewindow_outputs(
        flat, scored, safe, aligned, sweep_starts, sweep_ends, T, budget, block_size
    )
    blocks_scored = ((scored > 0) & overlap).sum(dim=(1, 2), dtype=torch.int32)
    blocks_active = overlap.sum(dim=(1, 2), dtype=torch.int32)
    return scores, valid, streamed, blocks_scored, blocks_active


def sweep_score_pruned(
    tp_rects: torch.Tensor,  # [T, 4] f32|f16
    tp_amps: torch.Tensor,  # [T] f32|f16|int8
    blk_mbr: torch.Tensor,  # f32[NB, 4] block-max metadata columns
    blk_max_amp: torch.Tensor,  # f32[NB]
    blk_max_mass: torch.Tensor,  # f32[NB]
    sweep_starts: torch.Tensor,  # i32[B, k] element offsets (INVALID padded)
    sweep_ends: torch.Tensor,  # i32[B, k]
    q_rects: torch.Tensor,  # f32[B, Q, 4]
    q_amps: torch.Tensor,  # f32[B, Q]
    budget: int,
    max_candidates: int,
    block_size: int,
    floor: "torch.Tensor | float" = 0.0,  # select-stage score floor, [B] or scalar
    tp_amp_scale: torch.Tensor | None = None,
):
    """Fused fetch+score+select with block-max pruning.

    Returns ``(scores f32[B, k, budget], valid bool, streamed bool,
    blocks_scored i32[B], blocks_active i32[B])``: ``streamed`` marks
    positions whose metadata block was scored (a skipped block scores 0),
    candidates are ``valid & streamed``, and ``blocks_active``
    counts the blocks an unpruned sweep would stream.
    """
    on_card = _check_store(
        tp_rects, tp_amps, tp_amp_scale, sweep_starts, sweep_ends, q_rects, q_amps
    )
    dev = tp_rects.device
    NB = blk_mbr.shape[0]
    check_tensor("blk_mbr", blk_mbr, (torch.float32,), (NB, 4), dev)
    check_tensor("blk_max_amp", blk_max_amp, (torch.float32,), (NB,), dev)
    check_tensor("blk_max_mass", blk_max_mass, (torch.float32,), (NB,), dev)
    if TILE % block_size:
        raise ValueError(f"block_size {block_size} must divide {TILE}")
    if on_card:
        sweep_score_pruned.launches += 1
    return _sweep_pruned(
        tp_rects, tp_amps, blk_mbr, blk_max_amp, blk_max_mass, sweep_starts,
        sweep_ends, q_rects, q_amps, budget, max_candidates, block_size, floor,
        tp_amp_scale,
        planar=K.sweep_score_pruned_planar if on_card else sweep_score_pruned_planar_ref,
    )


sweep_score_pruned.launches = 0
