"""Launchers of the hand-written CUDA sweep kernels (``csrc/sweep_score.cu``).

* :func:`sweep_score_planar` replaces the Pallas TPU kernel
  ``repro/kernels/sweep_score/kernel.py::sweep_score_planar``;
* :func:`sweep_score_pruned_planar` replaces ``sweep_score_pruned_planar``.

Both read the index's toe-print store where it lies, in its stored dtype
— ``(rects [T, 4], amps [T], scale f32[ceil(T/128)] or None)``: f32/f32,
f16/f16, or f16 rects with int8 amps and their scale — with an explicit
batch axis: one launch per batch of queries.  Inputs are checked by
``ops.py``; these functions pass pointers and the current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library

LANES = 128
TILE = 1024  # toe prints per sweep tile
Q_MAX = 8
DTYPE_KIND = {torch.float32: 0, torch.float16: 1, torch.int8: 2}


def _store_args(store):
    rects, amps, scale = store
    ptrs = [rects.data_ptr(), amps.data_ptr(), None if scale is None else scale.data_ptr()]
    return ptrs, rects.shape[0], DTYPE_KIND[rects.dtype], DTYPE_KIND[amps.dtype]


def sweep_score_planar(
    block_starts: torch.Tensor,  # i32[B, k] window origins in TILE units
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4]
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
    store: tuple,  # rects [T, 4], amps [T], scale f32[ceil(T/LANES)] or None
    pad_budget: int,  # positions per sweep window, a multiple of TILE
) -> torch.Tensor:
    """Scores of every window position, f32[B, k, pad_budget]."""
    B, k = block_starts.shape
    out = torch.empty((B, k, pad_budget), dtype=torch.float32, device=q_rects.device)
    ptrs, T, ck, ak = _store_args(store)
    err = library().sweep_score_launch(
        block_starts.data_ptr(), q_rects.data_ptr(), q_amps.data_ptr(), *ptrs,
        out.data_ptr(), B, k, pad_budget, T, ck, ak,
        torch.cuda.current_stream(q_rects.device).cuda_stream,
    )
    check_launch("sweep_score_launch", err)
    return out


def sweep_score_pruned_planar(
    block_starts: torch.Tensor,  # i32[B, k] window origins in TILE units
    bounds: torch.Tensor,  # i32[B, k, 2] exact [start, end) offsets
    floor: torch.Tensor,  # f32[B] select-stage score floor (≥ 0)
    block_ub: torch.Tensor,  # f32[B, k, n_tiles * bpt] per-block bounds
    q_rects: torch.Tensor,  # f32[B, Q_MAX, 4]
    q_amps: torch.Tensor,  # f32[B, Q_MAX]
    store: tuple,
    pad_budget: int,
    max_candidates: int,  # C of the partial top-C threshold buffer
    bpt: int,  # metadata blocks per TILE (1, 2, 4 or 8)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[B, k, pad_budget], scored i32[B, k, n_tiles*bpt]); one
    CTA per query walks its tiles in order."""
    B, k = block_starts.shape
    n_tiles = pad_budget // TILE
    cb = max(1, -(-max_candidates // TILE))
    dev = q_rects.device
    out = torch.empty((B, k, pad_budget), dtype=torch.float32, device=dev)
    scored = torch.empty((B, k, n_tiles * bpt), dtype=torch.int32, device=dev)
    ptrs, T, ck, ak = _store_args(store)
    err = library().sweep_score_pruned_launch(
        block_starts.data_ptr(), bounds.data_ptr(), floor.data_ptr(),
        block_ub.data_ptr(), q_rects.data_ptr(), q_amps.data_ptr(), *ptrs,
        out.data_ptr(), scored.data_ptr(), B, k, n_tiles, cb, bpt, T, ck, ak,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("sweep_score_pruned_launch", err)
    return out, scored
