"""Public wrapper of the text_probe kernel (port of
``repro/kernels/text_probe/ops.py``, with an explicit batch axis).

Handles the per-window bounds and lengths that drive the in-kernel skip
test (the prologue shared with the plain version, so skip decisions agree
bitwise) and the expansion of the kernel's per-block flags into the
per-position ``(opt, valid, streamed)`` contract that
``core/algorithms._text_first_pruned`` consumes.  The kernel reads the
index's CSR impact column in place: the reference's ``impact_planes``
copy of the whole store existed for the TPU's DMA engine.  CUDA tensors go
to the kernel, one launch per batch; CPU tensors to the plain version;
nothing falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.text_probe import kernel as K
from repro_torch.kernels.text_probe.kernel import BLOCK_ROWS, LANES, TILE
from repro_torch.kernels.text_probe.ref import text_probe_planar_ref

__all__ = ["BLOCK_ROWS", "LANES", "TILE", "text_probe_pruned", "window_size",
           "window_term_bounds"]


def window_size(max_term_blocks: int) -> int:
    """Static window-block count: max blocks of any term, whole tiles."""
    mtb = max(max_term_blocks, 1)
    return -(-mtb // BLOCK_ROWS) * BLOCK_ROWS


def window_term_bounds(
    blk_max_impact: torch.Tensor,  # f32[NB]
    blk_len: torch.Tensor,  # i32[NB]
    b0: torch.Tensor,  # i32[B] driver term's first block
    nb: torch.Tensor,  # i32[B] driver term's block count
    w_text: torch.Tensor,  # f32 scalar
    rest_ub: torch.Tensor,  # f32[B] (≥ 0)
    n_win: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-window-block upper bounds ``w_text·blk_max + rest`` (-inf past
    the driver's ``nb`` blocks: they can never beat θ ≥ 0), valid lengths,
    and the active-block mask — what an unpruned traversal would stream,
    the baseline of the skipped-block counters.  All [B, n_win]."""
    NB = blk_max_impact.shape[0]
    w = torch.arange(n_win, dtype=torch.int32, device=b0.device)
    active = w[None, :] < nb[:, None]
    bid = torch.clamp(b0[:, None] + w, 0, NB - 1).long()
    ub = torch.where(active, w_text * blk_max_impact[bid] + rest_ub[:, None], -torch.inf)
    lens = torch.where(active, blk_len[bid], 0).to(torch.int32)
    return ub, lens, active


def _probe(impacts, blk_pos, blk_max_impact, blk_len, b0, nb, w_text, rest_ub, floor,
           max_candidates, max_term_blocks, monotone, *, planar):
    B = b0.shape[0]
    n_win = window_size(max_term_blocks)
    dev = impacts.device
    w32 = float(np.float32(w_text))
    wt = torch.tensor(w32, dtype=torch.float32, device=dev)
    ub, lens, active = window_term_bounds(blk_max_impact, blk_len, b0, nb, wt, rest_ub, n_win)
    floor_c = torch.clamp(
        torch.as_tensor(floor, dtype=torch.float32, device=dev).expand(B), min=0.0
    ).contiguous()
    opt, scored = planar(
        impacts, blk_pos, b0, nb, ub.contiguous(), lens.contiguous(), w32,
        rest_ub, floor_c, max_candidates, monotone,
    )
    scored_blk = scored.reshape(B, n_win) > 0
    lane_ok = torch.arange(LANES, device=dev) < lens[..., None]
    valid = (active[..., None] & lane_ok).reshape(B, n_win * LANES)
    streamed = scored_blk.repeat_interleave(LANES, dim=1)
    blocks_scored = (scored_blk & active).sum(dim=1, dtype=torch.int32)
    blocks_active = active.sum(dim=1, dtype=torch.int32)
    return opt.reshape(B, n_win * LANES), valid, streamed, blocks_scored, blocks_active


def text_probe_pruned(
    impacts: torch.Tensor,  # [P] f32|f16 stored impacts, CSR order
    blk_pos: torch.Tensor,  # i32[NB]
    blk_max_impact: torch.Tensor,  # f32[NB]
    blk_len: torch.Tensor,  # i32[NB]
    b0: torch.Tensor,  # i32[B] driver term's first block
    nb: torch.Tensor,  # i32[B] driver term's block count
    w_text: float,
    rest_ub: torch.Tensor,  # f32[B] query-constant remainder bound
    floor: "torch.Tensor | float" = 0.0,  # select-stage score floor, [B] or scalar
    max_candidates: int = 1024,  # C of the partial top-C threshold buffer
    max_term_blocks: int = 1,  # static window bound (TextIndex field)
    monotone: bool = False,  # non-increasing bounds → early-exit cut
) -> tuple[torch.Tensor, ...]:
    """Fused probe+score+select over each query's driver blocks.

    Returns ``(opt f32[B, n_win·128], valid bool, streamed bool,
    blocks_scored i32[B], blocks_active i32[B])``: ``opt`` is each streamed
    posting's optimistic score (0 where skipped or invalid), ``valid``
    marks genuine driver postings, ``streamed`` positions whose block was
    scored (a skipped block issues no loads).  ``monotone=True`` asserts the
    driver's bounds are non-increasing along its block run (the impact
    layout's envelope): the walk then stops at the first failing bound.
    """
    dev = impacts.device
    P, NB, B = impacts.shape[0], blk_pos.shape[0], b0.shape[0]
    check_tensor("impacts", impacts, (torch.float32, torch.float16), (P,), dev)
    check_tensor("blk_pos", blk_pos, (torch.int32,), (NB,), dev)
    check_tensor("blk_max_impact", blk_max_impact, (torch.float32,), (NB,), dev)
    check_tensor("blk_len", blk_len, (torch.int32,), (NB,), dev)
    check_tensor("b0", b0, (torch.int32,), (B,), dev)
    check_tensor("nb", nb, (torch.int32,), (B,), dev)
    check_tensor("rest_ub", rest_ub, (torch.float32,), (B,), dev)
    if isinstance(floor, torch.Tensor):
        check_tensor("floor", floor, (torch.float32,), (B,) if floor.dim() else (), dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"text_probe runs on cuda or cpu tensors, got {dev}")
    on_card = dev.type == "cuda"
    if on_card:
        if K.buffer_tiles(max_candidates) > K.MAX_BUFFER_TILES:
            raise ValueError(
                f"max_candidates {max_candidates}: the θ buffer needs more than the "
                f"{K.MAX_BUFFER_TILES * TILE} slots shared memory holds"
            )
        text_probe_pruned.launches += 1
    return _probe(
        impacts, blk_pos, blk_max_impact, blk_len, b0, nb, w_text, rest_ub, floor,
        max_candidates, max_term_blocks, monotone,
        planar=K.text_probe_planar if on_card else text_probe_planar_ref,
    )


text_probe_pruned.launches = 0
