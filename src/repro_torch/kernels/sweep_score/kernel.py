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
RING = 16  # tiles of scores in flight in the pruned sweep's θ walk
SMEM_LIMIT = 232_448  # shared memory one CTA may use on an H100 (227 KB)
WALK_STATIC_SMEM = 128  # the walk's static shared memory (mbarriers, counters, minima)


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
    """Scores of every window position, f32[B, k, pad_budget], one CTA per
    store tile for all the windows that cover it."""
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


def walk_smem_bytes(max_candidates: int, k: int, n_tiles: int, bpt: int) -> int:
    """Dynamic shared memory of the pruned sweep's θ walk (the layout of
    ``walk_smem_bytes`` in ``csrc/sweep_score.cu``): the score ring, the
    cb·1024-float θ buffer, the query's block bounds, per-tile maxima and
    per-tile info words padded to 8 bytes, its [start, end) offsets and a
    flag byte per block.  Raises ``ValueError`` when one CTA cannot hold
    them, rather than failing at launch."""
    cb = max(1, -(-max_candidates // TILE))
    n_ub = k * n_tiles * bpt
    nbytes = (RING + cb) * TILE * 4 + (n_ub + 2 * k * n_tiles + 1) // 2 * 2 * 4 + k * 2 * 8 + n_ub
    if nbytes + WALK_STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(
            f"max_candidates C={max_candidates}: the pruned sweep's walk needs "
            f"{nbytes + WALK_STATIC_SMEM} bytes of shared memory per query (a θ buffer of "
            f"{cb} tiles, {RING} ring tiles, {n_ub} block bounds), more than the "
            f"{SMEM_LIMIT} one CTA may use"
        )
    return nbytes


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
    *,
    passes: int = 3,
    outputs: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[B, k, pad_budget], scored i32[B, k, n_tiles*bpt]), in two
    launches: the score pass gated by the floor over every SM, then one CTA
    per query walks its tiles in order over those scores.  ``passes`` (bit 0
    the score pass, bit 1 the walk) and ``outputs`` (the tensors to write)
    let a caller time one pass alone."""
    B, k = block_starts.shape
    n_tiles = pad_budget // TILE
    cb = max(1, -(-max_candidates // TILE))
    walk_smem_bytes(max_candidates, k, n_tiles, bpt)
    dev = q_rects.device
    if outputs is None:
        outputs = (torch.empty((B, k, pad_budget), dtype=torch.float32, device=dev),
                   torch.empty((B, k, n_tiles * bpt), dtype=torch.int32, device=dev))
    out, scored = outputs
    ptrs, T, ck, ak = _store_args(store)
    err = library().sweep_score_pruned_launch(
        block_starts.data_ptr(), bounds.data_ptr(), floor.data_ptr(),
        block_ub.data_ptr(), q_rects.data_ptr(), q_amps.data_ptr(), *ptrs,
        out.data_ptr(), scored.data_ptr(), B, k, n_tiles, cb, bpt, T, ck, ak, passes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("sweep_score_pruned_launch", err)
    return out, scored
