"""Launcher of the hand-written CUDA text_probe kernel (``csrc/text_probe.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/text_probe/kernel.py::
text_probe_pruned_planar``.  The kernel reads the index's CSR impact column
in place (f32 or f16) with an explicit batch axis: one launch per batch of
queries, one CTA per query.  Inputs are checked by ``ops.py``; this module
allocates the zero-filled outputs and passes pointers and the current
stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library

LANES = 128  # postings per block = one tile row
BLOCK_ROWS = 8  # blocks per tile
TILE = BLOCK_ROWS * LANES
IMPACT_KIND = {torch.float32: 0, torch.float16: 1}
# the θ buffer lives in shared memory: at most 227 KB per block on Hopper
MAX_BUFFER_TILES = (227 * 1024) // (TILE * 4)


def buffer_tiles(max_candidates: int) -> int:
    """Tiles of the partial top-C buffer, ``cb = ceil(C / TILE)``."""
    return max(1, -(-max_candidates // TILE))


def select_rank(max_candidates: int, n_win: int) -> int:
    """``c_sel``: the buffer rank θ reads — C, capped at the window."""
    return max(1, min(max_candidates, n_win * LANES))


def text_probe_planar(
    impacts: torch.Tensor,  # [P] f32|f16, CSR order
    blk_pos: torch.Tensor,  # i32[NB]
    b0: torch.Tensor,  # i32[B] driver's first block
    nb: torch.Tensor,  # i32[B] driver's block count
    ub: torch.Tensor,  # f32[B, n_win] per-window-block bounds (-inf padded)
    lens: torch.Tensor,  # i32[B, n_win]
    w_text: float,
    rest_ub: torch.Tensor,  # f32[B]
    floor: torch.Tensor,  # f32[B] (≥ 0)
    max_candidates: int,
    monotone: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(opt f32[B, n_tiles, BLOCK_ROWS, LANES], scored i32[B, n_tiles,
    BLOCK_ROWS]); positions the kernel never reaches stay zero."""
    B, n_win = ub.shape
    n_tiles = n_win // BLOCK_ROWS
    dev = ub.device
    out = torch.zeros((B, n_tiles, BLOCK_ROWS, LANES), dtype=torch.float32, device=dev)
    scored = torch.zeros((B, n_tiles, BLOCK_ROWS), dtype=torch.int32, device=dev)
    err = library().text_probe_launch(
        impacts.data_ptr(), IMPACT_KIND[impacts.dtype], blk_pos.data_ptr(),
        b0.data_ptr(), nb.data_ptr(), ub.data_ptr(), lens.data_ptr(),
        rest_ub.data_ptr(), floor.data_ptr(), float(w_text), out.data_ptr(),
        scored.data_ptr(), B, n_tiles, buffer_tiles(max_candidates),
        select_rank(max_candidates, n_win), int(monotone),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("text_probe_launch", err)
    return out, scored
