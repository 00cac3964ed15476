"""Spatial index: Morton-ordered toe-print store + tile→interval grid
(port of ``repro/core/spatial_index.py``).

Every footprint rectangle of every document is a *toe print*; toe prints
are sorted by the Morton code of their center, a ``G×G`` tile grid stores
per tile ≤ ``m`` toe-print-ID intervals covering the toe prints that touch
it, and a query coalesces its tiles' intervals into ≤ ``k`` contiguous
*sweeps*.  The store is also cut into ``block_size`` blocks with block-max
metadata (MBR, max amp, max amp·area) for the pruned K-SWEEP.

The build runs in numpy on the host and produces arrays identical to the
reference's; unlike the reference it enumerates (tile, toe print) pairs and
coalesces every tile's intervals with whole-array operations instead of
Python loops.  Query-time functions take an explicit batch axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import geometry
from repro_torch.core.footprint import footprint_mbr_np
from repro_torch.device import resolve_device

INVALID = 2**31 - 1
SCALE_BLOCK = 128  # toe prints per int8 amplitude-scale block
COMPRESS_MODES = ("none", "f16", "int8")
BLOCK_SIZES = (128, 256, 512, 1024)  # must divide the kernels' 1024 tile


@dataclass(frozen=True)
class SpatialIndex:
    # --- Morton-sorted toe-print store (f16 / int8 / i16 when compressed) ---
    tp_rects: torch.Tensor  # f32[T, 4]
    tp_amps: torch.Tensor  # f32[T]
    tp_doc_ids: torch.Tensor  # i32[T]
    tp_amp_scale: torch.Tensor  # f32[ceil(T/SCALE_BLOCK)] ([0] unless int8)
    # --- tile grid: per tile, m toe-print-ID intervals [start, end) ---
    tile_starts: torch.Tensor  # i32[G*G, m]
    tile_ends: torch.Tensor  # i32[G*G, m]
    # --- doc-major mirror ---
    doc_rects: torch.Tensor  # f32[N, R, 4]
    doc_amps: torch.Tensor  # f32[N, R]
    doc_mbr: torch.Tensor  # f32[N, 4]
    doc_mass: torch.Tensor  # f32[N]
    # --- block-max metadata over the toe-print store ---
    blk_mbr: torch.Tensor  # f32[NB, 4]
    blk_max_amp: torch.Tensor  # f32[NB]
    blk_max_mass: torch.Tensor  # f32[NB]
    grid: int
    n_docs: int
    block_size: int = 128

    @property
    def n_toeprints(self) -> int:
        return self.tp_rects.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.blk_mbr.shape[0]

    @property
    def m_intervals(self) -> int:
        return self.tile_starts.shape[1]

    @property
    def plane_bytes(self) -> float:
        """Bytes per toe print the sweep kernels stream (rect + amp +
        amortized scale column, not the doc-id column)."""
        scale = 4.0 / SCALE_BLOCK if self.tp_amp_scale.shape[0] else 0.0
        return 4 * self.tp_rects.element_size() + self.tp_amps.element_size() + scale

    @property
    def tp_bytes(self) -> float:
        """Modeled bytes per toe-print record (rect + amp + doc id); 24 raw."""
        return self.plane_bytes + self.tp_doc_ids.element_size()

    @property
    def doc_bytes(self) -> float:
        """Bytes per doc-major footprint slot (rect + amp); 20 raw."""
        return 4 * self.doc_rects.element_size() + self.doc_amps.element_size()


def normalize_compress(compress) -> str:
    """Accept the legacy bool flag or a mode string; return the mode."""
    if compress is True:
        return "f16"
    if compress is False or compress is None:
        return "none"
    if compress not in COMPRESS_MODES:
        raise ValueError(f"compress must be one of {COMPRESS_MODES}, got {compress!r}")
    return compress


def quantize_amps_np(amps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-SCALE_BLOCK int8 quantization of the amp column.

    Returns (q int8[T], scale f32[ceil(T/SB)]); decode is
    ``q.astype(f32) * scale[t // SCALE_BLOCK]``.
    """
    T = amps.shape[0]
    nb = max((T + SCALE_BLOCK - 1) // SCALE_BLOCK, 1)
    pad = nb * SCALE_BLOCK - T
    a = np.concatenate([amps.astype(np.float32), np.zeros((pad,), np.float32)])
    a = a.reshape(nb, SCALE_BLOCK)
    max_abs = np.abs(a).max(axis=1)
    scale = np.where(max_abs > 0, max_abs / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(a / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1)[:T], scale


def _id_dtype(n_docs: int, mode: str):
    return np.int16 if (mode != "none" and n_docs <= np.iinfo(np.int16).max) else np.int32


def block_metadata_np(
    rects: np.ndarray,  # f32[T, 4] Morton-ordered toe-print rects
    amps: np.ndarray,  # f32[T]
    block_size: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-block (MBR, max amp, max amp·area) over the Morton-ordered store;
    ``ceil(T/bs)`` rows (at least 1)."""
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"block_size {block_size} must be 128/256/512/1024")
    T = rects.shape[0]
    nb = max((T + block_size - 1) // block_size, 1)
    pad = nb * block_size - T
    # pad with empty rects / zero amps: they cannot raise any block max
    big = np.float32(np.inf)
    r = np.concatenate(
        [rects, np.tile([big, big, -big, -big], (pad, 1)).astype(np.float32)]
    ).reshape(nb, block_size, 4)
    a = np.concatenate([amps, np.zeros((pad,), np.float32)]).reshape(nb, block_size)
    mbr = np.stack(
        [
            r[:, :, 0].min(axis=1),
            r[:, :, 1].min(axis=1),
            r[:, :, 2].max(axis=1),
            r[:, :, 3].max(axis=1),
        ],
        axis=1,
    ).astype(np.float32)
    empty = ~np.isfinite(mbr).all(axis=1)
    mbr[empty] = geometry.EMPTY_RECT
    area = np.maximum(r[:, :, 2] - r[:, :, 0], 0) * np.maximum(
        r[:, :, 3] - r[:, :, 1], 0
    )
    area = np.where(np.isfinite(area), area, 0.0)
    return (
        mbr,
        a.max(axis=1).astype(np.float32),
        (a * area).max(axis=1).astype(np.float32),
    )


def _coalesce_to_m(ids: np.ndarray, m: int) -> list[tuple[int, int]]:
    """Cover sorted toe-print IDs with ≤ m [start, end) intervals, cut at the
    m−1 largest gaps (> 1).  The one-tile form of :func:`tile_intervals_np`."""
    ids = np.unique(ids)
    if len(ids) == 0:
        return []
    starts, ends, _, _ = tile_intervals_np(ids, np.zeros(ids.shape, np.int64), m)
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


def tile_intervals_np(
    ids: np.ndarray,  # i64[P] toe-print ids, ascending within each tile
    tiles: np.ndarray,  # i64[P] tile of each id, ascending (tile-major)
    m: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Every tile's ``_coalesce_to_m`` at once.

    Per tile the reference cuts at the ``m−1`` largest id gaps — ties to the
    lower position (a stable argsort of −gap) — keeping only gaps > 1.
    Picking the first maximal remaining gap ``m−1`` times makes the same
    choice.  Returns ``(starts, ends, tile, slot)`` of every interval.
    """
    P = len(ids)
    seg_start = np.ones((P,), bool)
    seg_start[1:] = tiles[1:] != tiles[:-1]
    heads = np.flatnonzero(seg_start)
    # gap[p] = ids[p] - ids[p-1] within a tile; -1 where p opens a tile
    gap = np.full((P,), -1, np.int64)
    gap[1:] = ids[1:] - ids[:-1]
    gap[seg_start] = -1
    cut = np.zeros((P,), bool)
    seg_of = np.cumsum(seg_start) - 1
    pos = np.arange(P)
    live = gap.copy()
    for _ in range(m - 1):
        if P == 0:
            break
        best = np.maximum.reduceat(live, heads)
        is_best = (live == best[seg_of]) & (live >= 0)
        first = np.minimum.reduceat(np.where(is_best, pos, P), heads)
        pick = first[first < P]
        cut[pick[gap[pick] > 1]] = True
        live[pick] = -1
    o = np.flatnonzero(seg_start | cut)  # positions that open an interval
    closes = np.empty_like(o)
    closes[:-1] = o[1:] - 1
    if len(o):
        closes[-1] = P - 1
    tile_first = np.flatnonzero(seg_start[o])  # first interval of each tile
    slot = np.arange(len(o)) - tile_first[np.cumsum(seg_start[o]) - 1]
    return ids[o], ids[closes] + 1, tiles[o], slot


def build_spatial_index_np(
    doc_rects: np.ndarray,  # f32[N, R, 4] (padded with EMPTY_RECT)
    doc_amps: np.ndarray,  # f32[N, R]
    grid: int = 64,
    m_intervals: int = 2,
    compress: "bool | str" = False,
    block_size: int = 128,
    device: "str | torch.device | None" = None,
) -> SpatialIndex:
    """Host-side index build; the arrays equal the reference's.  The result
    lives on ``device`` (default CUDA; see :func:`resolve_device`)."""
    arrays, statics = build_spatial_arrays_np(
        doc_rects, doc_amps, grid, m_intervals, compress, block_size
    )
    return spatial_index_from_numpy(arrays, statics, device)


def build_spatial_arrays_np(
    doc_rects, doc_amps, grid=64, m_intervals=2, compress=False, block_size=128
) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """The numpy build behind :func:`build_spatial_index_np`: a dict of the
    :class:`SpatialIndex` array fields plus its static ints."""
    N, R, _ = doc_rects.shape
    valid = doc_rects[:, :, 2] > doc_rects[:, :, 0]
    doc_idx, rect_idx = np.nonzero(valid)
    rects = doc_rects[doc_idx, rect_idx]  # [T, 4]
    amps = doc_amps[doc_idx, rect_idx]

    # Morton order by rect-center cell in a fine 2^15 grid.
    cx = (rects[:, 0] + rects[:, 2]) * 0.5
    cy = (rects[:, 1] + rects[:, 3]) * 0.5
    fine = 1 << 15
    ix = np.clip((cx * fine).astype(np.int64), 0, fine - 1)
    iy = np.clip((cy * fine).astype(np.int64), 0, fine - 1)
    codes = geometry.morton_encode_np(ix.astype(np.uint32), iy.astype(np.uint32))
    order = np.argsort(codes, kind="stable")
    rects, amps, doc_idx = rects[order], amps[order], doc_idx[order]
    T = len(rects)

    # (tile, toe print) pairs, toe-print-major; a stable sort by tile then
    # lists each tile's toe prints in ascending id order, like the
    # reference's per-tile append loop
    x0, y0, x1, y1 = geometry.rect_cell_bounds_np(rects, grid)
    nx = np.maximum(x1 - x0 + 1, 0)
    ny = np.maximum(y1 - y0 + 1, 0)
    cnt = nx * ny
    tp = np.repeat(np.arange(T, dtype=np.int64), cnt)
    k = np.arange(len(tp), dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    nxr = np.repeat(np.maximum(nx, 1), cnt)
    tile = (np.repeat(y0, cnt) + k // nxr) * grid + np.repeat(x0, cnt) + k % nxr
    # (a 16-bit key lets numpy's stable sort run as a radix sort)
    key = tile.astype(np.uint16) if grid * grid <= 1 << 16 else tile
    by_tile = np.argsort(key, kind="stable")
    tile, tp = tile[by_tile], tp[by_tile]

    tile_starts = np.full((grid * grid, m_intervals), INVALID, dtype=np.int32)
    tile_ends = np.full((grid * grid, m_intervals), INVALID, dtype=np.int32)
    s, e, t, j = tile_intervals_np(tp, tile, m_intervals)
    tile_starts[t, j] = s
    tile_ends[t, j] = e

    # doc-major mirrors
    mbr = footprint_mbr_np(doc_rects)
    area = np.maximum(doc_rects[:, :, 2] - doc_rects[:, :, 0], 0) * np.maximum(
        doc_rects[:, :, 3] - doc_rects[:, :, 1], 0
    )
    mass = (area * doc_amps).sum(axis=1).astype(np.float32)

    mode = normalize_compress(compress)
    ft = np.float16 if mode != "none" else np.float32
    if mode == "int8":
        tp_amps_store, tp_amp_scale = quantize_amps_np(amps)
        dec_amps = tp_amps_store.astype(np.float32) * np.repeat(
            tp_amp_scale, SCALE_BLOCK
        )[: len(tp_amps_store)]
    else:
        tp_amps_store = amps.astype(ft)
        tp_amp_scale = np.zeros((0,), np.float32)
        dec_amps = tp_amps_store.astype(np.float32)
    # block-max metadata from the values the query path scores (post-cast /
    # dequantized), so the bounds stay safe under lossy compression
    blk_mbr, blk_max_amp, blk_max_mass = block_metadata_np(
        rects.astype(ft).astype(np.float32), dec_amps, block_size
    )
    arrays = dict(
        tp_rects=rects.astype(ft),
        tp_amps=tp_amps_store,
        tp_doc_ids=doc_idx.astype(_id_dtype(N, mode)),
        tp_amp_scale=tp_amp_scale,
        tile_starts=tile_starts,
        tile_ends=tile_ends,
        doc_rects=doc_rects.astype(ft),
        doc_amps=doc_amps.astype(ft),
        doc_mbr=mbr.astype(ft),
        doc_mass=mass.astype(ft),
        blk_mbr=blk_mbr,
        blk_max_amp=blk_max_amp,
        blk_max_mass=blk_max_mass,
    )
    return arrays, dict(grid=grid, n_docs=N, block_size=block_size)


def spatial_index_from_numpy(
    arrays: dict[str, np.ndarray], statics: dict, device=None
) -> SpatialIndex:
    """A :class:`SpatialIndex` on ``device`` from its numpy fields."""
    dev = resolve_device(device)
    return SpatialIndex(
        **{k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()},
        grid=int(statics["grid"]),
        n_docs=int(statics["n_docs"]),
        block_size=int(statics.get("block_size", 128)),
    )


# ---------------------------------------------------------------------------
# Query-time primitives, batched: one row per query
# ---------------------------------------------------------------------------

def gather_query_intervals(
    index: SpatialIndex,
    query_rects: torch.Tensor,  # f32[B, Qr, 4]
    max_tiles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intervals of every tile each query's footprint touches:
    ``(starts, ends)`` i32[B, Qr*max_tiles*m], INVALID padded."""
    B = query_rects.shape[0]
    tiles, valid = geometry.enumerate_rect_tiles(query_rects, index.grid, max_tiles)
    s = index.tile_starts[tiles.long()]  # [B, Qr, max_tiles, m]
    e = index.tile_ends[tiles.long()]
    s = torch.where(valid[..., None], s, INVALID)
    e = torch.where(valid[..., None], e, INVALID)
    return s.reshape(B, -1), e.reshape(B, -1)


def coalesce_k_sweeps(
    starts: torch.Tensor,  # i32[B, I] with INVALID padding
    ends: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coalesce each row's intervals into ≤ k sweeps, cut at the k−1 largest
    positive gaps.  Returns ``(sweep_starts, sweep_ends)`` i32[B, k]; empty
    sweeps hold INVALID."""
    B, I = starts.shape
    dev = starts.device
    order = torch.sort(starts, dim=1, stable=True).indices  # jnp.argsort is stable
    s = torch.gather(starts, 1, order)
    e = torch.gather(ends, 1, order)
    valid = s != INVALID
    # running max of interval ends, to handle containment/overlap
    run_end = torch.cummax(torch.where(valid, e, -1), dim=1).values
    prev_end = torch.cat([torch.zeros_like(run_end[:, :1]), run_end[:, :-1]], dim=1)
    gap = torch.where(valid, s - prev_end, -1)
    gap[:, 0] = torch.where(valid[:, 0], 0, -1)
    # the first valid interval always opens a sweep
    first_valid = torch.argmax(valid.to(torch.int32), dim=1)  # 0 if none valid
    at_first = torch.arange(I, device=dev)[None, :] == first_valid[:, None]
    gap = torch.where(
        at_first & valid.any(dim=1, keepdim=True), torch.tensor(2**30, dtype=gap.dtype, device=dev), gap
    )
    gap = torch.where(at_first, gap, torch.where(gap > 0, gap, -1))

    # k largest gaps, ties to the lower position (as jax.lax.top_k)
    kk = min(k, I)
    top_gap, top_idx = torch.sort(gap, dim=1, descending=True, stable=True)
    top_gap, top_idx = top_gap[:, :kk], top_idx[:, :kk]
    is_cut = torch.zeros((B, I), dtype=torch.bool, device=dev)
    is_cut.scatter_(1, top_idx, top_gap > 0)

    sweep_id = torch.cumsum(is_cut.to(torch.int32), dim=1) - 1
    sweep_id = torch.where(valid, sweep_id, k).long()  # invalid → bucket k
    big = 2**30
    sweep_starts = torch.full((B, k + 1), big, dtype=torch.int32, device=dev)
    sweep_starts = sweep_starts.scatter_reduce(
        1, sweep_id, torch.where(valid, s, big).to(torch.int32), "amin", include_self=True
    )[:, :k]
    sweep_ends = torch.full((B, k + 1), -1, dtype=torch.int32, device=dev)
    sweep_ends = sweep_ends.scatter_reduce(
        1, sweep_id, torch.where(valid, e, -1).to(torch.int32), "amax", include_self=True
    )[:, :k]
    empty = sweep_ends < sweep_starts
    sweep_starts = torch.where(empty, INVALID, sweep_starts)
    sweep_ends = torch.where(empty, INVALID, sweep_ends)
    return sweep_starts, sweep_ends


def split_sweeps_to_budget(
    sweep_starts: torch.Tensor,  # i32[B, k]
    sweep_ends: torch.Tensor,
    k: int,
    budget: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-chunk coalesced runs into ≤ k sweeps of length ≤ budget (the first
    k chunks across runs)."""
    B = sweep_starts.shape[0]
    dev = sweep_starts.device
    live = sweep_starts != INVALID
    lens = torch.where(live, sweep_ends - sweep_starts, 0)
    chunks = torch.div(lens + budget - 1, budget, rounding_mode="floor")
    cum = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev),
         torch.cumsum(chunks, dim=1).to(torch.int32)],
        dim=1,
    )
    j = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k).contiguous()
    run = torch.clamp(torch.searchsorted(cum, j, right=True) - 1, 0, k - 1)
    within = j - torch.gather(cum, 1, run)
    valid = j < cum[:, -1:]
    rs = torch.gather(sweep_starts, 1, run)
    s = torch.where(rs == INVALID, 0, rs) + within * budget
    e = torch.minimum(s + budget, torch.gather(sweep_ends, 1, run))
    s = torch.where(valid, s, INVALID).to(torch.int32)
    e = torch.where(valid, e, INVALID).to(torch.int32)
    return s, e


def _window_starts(index: SpatialIndex, sweep_starts: torch.Tensor, budget: int):
    """Fetch origin of each sweep: its start, clamped so a ``budget``-long
    window stays inside the store."""
    T = index.n_toeprints
    return torch.clamp(
        torch.where(sweep_starts == INVALID, 0, sweep_starts), 0, max(T - budget, 0)
    )


def fetch_sweeps(
    index: SpatialIndex,
    sweep_starts: torch.Tensor,  # i32[B, k]
    sweep_ends: torch.Tensor,
    sweep_budget: int,
):
    """Fetch ``sweep_budget`` consecutive toe prints from each sweep start.

    Returns (rects f32[B, k*S, 4], amps f32[B, k*S], doc_ids i32[B, k*S],
    valid bool[B, k*S]) — the amps decoded astype-f32 then × scale, the
    kernels' order.
    """
    B, k = sweep_starts.shape
    start = _window_starts(index, sweep_starts, sweep_budget)
    pos = start[..., None] + torch.arange(
        sweep_budget, dtype=torch.int32, device=start.device
    )  # [B, k, S]
    p = pos.long()
    r = index.tp_rects[p].float()
    a = index.tp_amps[p].float()
    if index.tp_amp_scale.shape[0]:
        a = a * index.tp_amp_scale[torch.div(p, SCALE_BLOCK, rounding_mode="floor")]
    d = index.tp_doc_ids[p].to(torch.int32)
    s = sweep_starts[..., None]
    ok = (s != INVALID) & (pos >= s) & (pos < sweep_ends[..., None])
    return (
        r.reshape(B, k * sweep_budget, 4),
        a.reshape(B, -1),
        d.reshape(B, -1),
        ok.reshape(B, -1),
    )


def fetch_sweep_ids(
    index: SpatialIndex,
    sweep_starts: torch.Tensor,  # i32[B, k]
    sweep_ends: torch.Tensor,
    sweep_budget: int,
) -> torch.Tensor:
    """Doc ids of each sweep's ``[s, s+budget)`` window, i32[B, k*S] — the
    fused kernels' window convention (reads clamped to the fetched run)."""
    B, k = sweep_starts.shape
    start = _window_starts(index, sweep_starts, sweep_budget)
    shift = torch.where(sweep_starts == INVALID, 0, sweep_starts) - start
    j = torch.arange(sweep_budget, dtype=torch.int32, device=start.device)
    idx = torch.clamp(shift[..., None] + j, 0, sweep_budget - 1)
    d = index.tp_doc_ids[(start[..., None] + idx).long()]
    return d.to(torch.int32).reshape(B, k * sweep_budget)


def tile_candidate_toeprints(
    index: SpatialIndex,
    query_rects: torch.Tensor,  # f32[B, Qr, 4]
    max_tiles: int,
    max_candidates: int,
    max_runs: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GEO-FIRST candidates: each query's tile intervals merged into ≤
    ``max_runs`` disjoint runs, then enumerated one toe-print id at a time
    up to ``max_candidates``.  Returns (tp_ids i32[B, C], valid bool[B, C])."""
    starts, ends = gather_query_intervals(index, query_rects, max_tiles)
    s, e = coalesce_k_sweeps(starts, ends, max_runs)  # disjoint runs
    lens = torch.where(s != INVALID, e - s, 0)
    B = s.shape[0]
    dev = s.device
    offs = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev),
         torch.cumsum(lens, dim=1, dtype=torch.int32)],
        dim=1,
    )
    j = torch.arange(max_candidates, dtype=torch.int32, device=dev).expand(B, -1).contiguous()
    run = torch.clamp(torch.searchsorted(offs, j, right=True) - 1, 0, max_runs - 1)
    ok = j < offs[:, -1:]
    rs = torch.gather(s, 1, run)
    ids = torch.where(rs == INVALID, 0, rs) + (j - torch.gather(offs, 1, run))
    return torch.where(ok, ids, 0).to(torch.int32), ok
