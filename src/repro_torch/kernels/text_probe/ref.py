"""Plain PyTorch version of the text_probe kernel (same arithmetic order).

``text_probe_planar_ref`` takes the kernel's exact inputs and walks the
tiles in order as the kernel does: θ = the ``c_sel``-th largest value of
the cyclic partial top-C buffer (then the floor), one θ per tile, the
optimistic score ``float(imp)·w_text + rest_ub`` as two rounded
operations, the fold into slot ``t mod cb``, and the monotone cut flag that
a failing bound sets for later tiles.  On the card every score and every
skip flag agrees with the kernel bitwise.  The loop stops after the last
tile any query's driver reaches: later tiles hold no active block and
change nothing.

``text_probe_pruned_ref`` runs the wrapper's whole pipeline (window bounds,
flag expansion, block counters) through this core: the traversal behind
``text_first(prune=True, fused=False)``, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.text_probe.kernel import (
    BLOCK_ROWS,
    LANES,
    TILE,
    buffer_tiles,
    select_rank,
)


def text_probe_planar_ref(
    impacts: torch.Tensor,  # [P] f32|f16
    blk_pos: torch.Tensor,  # i32[NB]
    b0: torch.Tensor,  # i32[B]
    nb: torch.Tensor,  # i32[B]
    ub: torch.Tensor,  # f32[B, n_win]
    lens: torch.Tensor,  # i32[B, n_win]
    w_text: float,
    rest_ub: torch.Tensor,  # f32[B]
    floor: torch.Tensor,  # f32[B]
    max_candidates: int,
    monotone: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(opt f32[B, n_tiles, BLOCK_ROWS, LANES], scored i32[B, n_tiles,
    BLOCK_ROWS])."""
    B, n_win = ub.shape
    n_tiles = n_win // BLOCK_ROWS
    dev = ub.device
    cb = buffer_tiles(max_candidates)
    c_sel = select_rank(max_candidates, n_win)
    NB, P = blk_pos.shape[0], impacts.shape[0]
    opt = torch.zeros((B, n_tiles, BLOCK_ROWS, LANES), dtype=torch.float32, device=dev)
    scored = torch.zeros((B, n_tiles, BLOCK_ROWS), dtype=torch.bool, device=dev)
    buf = floor.float()[:, None].expand(B, cb * TILE).clone()
    cut = torch.zeros((B,), dtype=torch.bool, device=dev)
    wt = torch.tensor(w_text, dtype=torch.float32, device=dev)
    lane = torch.arange(LANES, device=dev)
    rows = torch.arange(BLOCK_ROWS, device=dev)
    n_live = -(-int(nb.max()) // BLOCK_ROWS) if B else 0
    for t in range(min(n_live, n_tiles)):
        theta = torch.maximum(torch.topk(buf, c_sel, dim=1).values[:, -1], floor)
        w = slice(t * BLOCK_ROWS, (t + 1) * BLOCK_ROWS)
        raw = ub[:, w] > theta[:, None]
        sb = raw & ~cut[:, None] if monotone else raw
        bid = torch.clamp(b0.long()[:, None] + t * BLOCK_ROWS + rows, 0, NB - 1)
        pos = torch.clamp(blk_pos[bid].long()[..., None] + lane, 0, max(P - 1, 0))
        o = impacts[pos].float() * wt + rest_ub[:, None, None]
        sc = torch.where(sb[..., None] & (lane < lens[:, w, None]), o, 0.0)
        opt[:, t] = sc
        scored[:, t] = sb
        s = (t % cb) * TILE
        buf[:, s : s + TILE] = torch.maximum(buf[:, s : s + TILE], sc.reshape(B, TILE))
        if monotone:
            cut = cut | (~raw).any(dim=1)
    return opt, scored.to(torch.int32)


def text_probe_pruned_ref(
    impacts, blk_pos, blk_max_impact, blk_len, b0, nb, w_text, rest_ub, floor=0.0,
    max_candidates=1024, max_term_blocks=1, monotone=False,
):
    """``ops.text_probe_pruned`` through the plain core, on any device."""
    from repro_torch.kernels.text_probe.ops import _probe

    return _probe(
        impacts, blk_pos, blk_max_impact, blk_len, b0, nb, w_text, rest_ub, floor,
        max_candidates, max_term_blocks, monotone, planar=text_probe_planar_ref,
    )
