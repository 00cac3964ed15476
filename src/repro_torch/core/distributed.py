"""Document-sharded geo search (port of ``repro/core/distributed.py``).

Documents are partitioned into ``S`` index shards laid out over the mesh's
doc axes (``("pod", "data")``); the query batch is split over the
``"model"`` axis.  One serve step (:func:`make_serve_fn`):

1. every shard runs the whole algorithm for every query slice;
2. local top-k per (query, shard), local doc ids mapped to global ones;
3. hierarchical merge over the doc axes, innermost first: concatenate the
   shards' lists shard-major, keep the top k (lower position on ties).

The reference runs this as one ``shard_map`` over a device mesh with
``all_gather`` and ``psum`` collectives.  The port has two meshes:

* :class:`Mesh` (:func:`make_mesh`) describes the axes on one device, and
  a loop over the shards and query slices takes the collectives' place:
  shard ``s`` is the view ``field[s]`` of each stacked tensor of
  :class:`ShardedGeoIndex` (contiguous, so the kernels read it in place),
  the all-gathers become a stack and the psums a sum in shard order.
* :class:`ProcessMesh` (:func:`make_process_mesh`) puts one rank of a
  ``torch.distributed`` process group on each mesh position, in row-major
  rank order as ``jax.sharding.Mesh`` lays out its devices.  Each rank
  holds its own row of the stacked index (:func:`shard_rows`) and runs its
  (shard, query slice); one world all-gather brings every rank's lists,
  touch flags and raw counters to every rank, which then applies the
  loop's own merge and shard-order sums.  So ids, scores and every counter
  are bitwise the loop's; an ``all_reduce`` would add in the backend's
  order instead.

The reference's ``sharded_index_specs`` (a table of ``PartitionSpec``s
saying "every field's leading dimension goes over the doc axes") has no
counterpart: the meshes and the rules table
(:data:`repro_torch.sharding.specs.DEFAULT_RULES`, read by
:func:`mesh_axes`) carry that meaning.

Partitioners
------------
A :class:`Partitioner` maps doc footprints to shard ids (``assign``) and
summarizes a shard's toe prints as a coverage grid (``coverage``, shared).
:class:`HashPartitioner` is round-robin, :class:`MortonPartitioner` splits
the Morton order of footprint centers into equal ranges,
:class:`RegionRangePartitioner` makes recursive median (KD) splits.  Each
gives the reference's shard id per document, stable argsorts included.
Strings resolve to instances only at the CLI boundary
(:func:`resolve_partitioner`); everywhere else a string is a ``TypeError``.

Footprint routing
-----------------
Each shard's toe prints are summarized as a ``G×G`` occupancy grid
(``G = COVERAGE_GRID``, the planner's clamped-floor :func:`coarse_cells`
mapping, so it over-covers) stored as its summed-area table.  A shard no
query footprint reaches can only return empty lists (``require_geo``
scores a doc −inf when its geo score is 0), so the host executor skips it
and the serve step masks it: results bit-identical to broadcasting.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from functools import cached_property, partial

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import geometry, ranking
from repro_torch.core.engine import GeoIndex
from repro_torch.core.planner import coarse_cells
from repro_torch.core.spatial_index import (
    SCALE_BLOCK,
    SpatialIndex,
    build_spatial_arrays_np,
    normalize_compress,
)
from repro_torch.core.text_index import TextIndex, build_text_arrays_np, global_idf_np
from repro_torch.device import resolve_device
from repro_torch.sharding.specs import DEFAULT_RULES

#: Side length of the per-shard coverage bbox grid (the planner's tp_span
#: grid resolution).
COVERAGE_GRID = 16


# ---------------------------------------------------------------------------
# Coverage grids and footprint routing (host numpy)
# ---------------------------------------------------------------------------

def _valid_rects_np(rects: np.ndarray, amps: np.ndarray | None = None) -> np.ndarray:
    """bool[...] mask of real (non-padding) rect slots: positive area and,
    when amplitudes are given, positive amplitude."""
    rects = np.asarray(rects)
    v = (rects[..., 2] > rects[..., 0]) & (rects[..., 3] > rects[..., 1])
    if amps is not None:
        v = v & (np.asarray(amps) > 0)
    return v


def coverage_grid_np(
    rects: np.ndarray, amps: np.ndarray | None = None, grid: int = COVERAGE_GRID
) -> np.ndarray:
    """Occupancy grid ``bool[G, G]`` (row = y cell) of the valid rects,
    claimed through :func:`coarse_cells` (no upper-edge epsilon, so every
    point of every valid rect lands in a claimed cell)."""
    occ = np.zeros((grid, grid), dtype=bool)
    r = np.asarray(rects).reshape(-1, 4)
    r = r[_valid_rects_np(rects, amps).reshape(-1)]
    if r.shape[0] == 0:
        return occ
    ix0, iy0, ix1, iy1 = coarse_cells(r, grid)
    # mark each rect's cell range as a 2-D difference array, then prefix-sum
    diff = np.zeros((grid + 1, grid + 1), dtype=np.int64)
    np.add.at(diff, (iy0, ix0), 1)
    np.add.at(diff, (iy0, ix1 + 1), -1)
    np.add.at(diff, (iy1 + 1, ix0), -1)
    np.add.at(diff, (iy1 + 1, ix1 + 1), 1)
    return diff.cumsum(axis=0).cumsum(axis=1)[:grid, :grid] > 0


def coverage_sat_np(occ: np.ndarray) -> np.ndarray:
    """Summed-area table ``f32[G+1, G+1]`` of a 0/1 occupancy grid."""
    g = occ.shape[0]
    sat = np.zeros((g + 1, g + 1), dtype=np.float32)
    sat[1:, 1:] = np.cumsum(np.cumsum(occ.astype(np.float32), axis=0), axis=1)
    return sat


def footprint_touch_np(
    sats: np.ndarray,
    rects: np.ndarray,
    amps: np.ndarray | None = None,
    grid: int = COVERAGE_GRID,
) -> np.ndarray:
    """Which shards each query's footprints can reach: ``bool[S, B]``.

    ``sats`` is the stacked coverage SAT ``f32[S, G+1, G+1]``, ``rects``
    the query footprints ``f32[B, R, 4]`` (``amps f32[B, R]`` marks
    padding).  A query touches a shard iff a valid rect's coarse-cell range
    holds a covered cell: a four-corner SAT lookup per (shard, rect).
    """
    sats = np.asarray(sats)
    rects = np.asarray(rects)
    valid = _valid_rects_np(rects, amps)  # [B, R]
    ix0, iy0, ix1, iy1 = coarse_cells(rects, grid)  # each [B, R]
    cover = (
        sats[:, iy1 + 1, ix1 + 1]
        - sats[:, iy0, ix1 + 1]
        - sats[:, iy1 + 1, ix0]
        + sats[:, iy0, ix0]
    )  # [S, B, R]
    return np.any((cover > 0) & valid[None], axis=-1)


def shard_coverage_sat_np(
    tp_rects: np.ndarray, tp_amps: np.ndarray, tp_amp_scale: np.ndarray, partitioner=None
) -> np.ndarray:
    """One shard's coverage SAT from its stored toe prints: amplitudes
    decoded to f32 (int8 stores times their block scales), rects as f32."""
    amps = np.asarray(tp_amps).astype(np.float32)
    if tp_amp_scale.shape[0]:
        amps = amps * np.repeat(np.asarray(tp_amp_scale), SCALE_BLOCK)[: amps.shape[0]]
    rects = np.asarray(tp_rects).astype(np.float32)
    occ = (partitioner.coverage(rects, amps, COVERAGE_GRID) if partitioner is not None
           else coverage_grid_np(rects, amps, COVERAGE_GRID))
    return coverage_sat_np(occ)


# ---------------------------------------------------------------------------
# Partitioners
# ---------------------------------------------------------------------------

def _footprint_centers(doc_rects: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean footprint center per doc, over valid rect slots (f64[N], f64[N])."""
    r = np.asarray(doc_rects, dtype=np.float64)
    valid = _valid_rects_np(r)  # [N, R]
    w = np.maximum(valid.sum(axis=1), 1)
    cx = np.where(valid, (r[:, :, 0] + r[:, :, 2]) * 0.5, 0.0).sum(axis=1) / w
    cy = np.where(valid, (r[:, :, 1] + r[:, :, 3]) * 0.5, 0.0).sum(axis=1) / w
    return cx, cy


class Partitioner:
    """Document-partitioning strategy (see the module docstring): ``assign``
    maps doc footprints to shard ids; ``coverage`` is shared."""

    name: str = "base"

    def assign(self, doc_rects: np.ndarray, n_shards: int) -> np.ndarray:
        raise NotImplementedError

    def coverage(
        self,
        rects: np.ndarray,
        amps: np.ndarray | None = None,
        grid: int = COVERAGE_GRID,
    ) -> np.ndarray:
        return coverage_grid_np(rects, amps, grid)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}()"


class HashPartitioner(Partitioner):
    """Round-robin ``doc_id % n_shards`` — the geography-blind baseline."""

    name = "hash"

    def assign(self, doc_rects: np.ndarray, n_shards: int) -> np.ndarray:
        n_docs = np.asarray(doc_rects).shape[0]
        return (np.arange(n_docs) % n_shards).astype(np.int32)


class MortonPartitioner(Partitioner):
    """Equal contiguous ranges of the Morton order of footprint centers."""

    name = "morton"

    def assign(self, doc_rects: np.ndarray, n_shards: int) -> np.ndarray:
        n_docs = np.asarray(doc_rects).shape[0]
        cx, cy = _footprint_centers(doc_rects)
        fine = 1 << 15
        code = geometry.morton_encode_np(
            np.clip(cx * fine, 0, fine - 1).astype(np.uint32),
            np.clip(cy * fine, 0, fine - 1).astype(np.uint32),
        )
        order = np.argsort(code, kind="stable")
        per = (n_docs + n_shards - 1) // n_shards
        ids = np.empty(n_docs, dtype=np.int32)
        ids[order] = np.arange(n_docs) // per
        return ids


class RegionRangePartitioner(Partitioner):
    """Recursive median (KD) splits of footprint centers: each shard owns a
    compact axis-aligned region.  Any ``n_shards`` via proportional child
    targets (shard sizes differ by at most one doc)."""

    name = "region"

    def assign(self, doc_rects: np.ndarray, n_shards: int) -> np.ndarray:
        n_docs = np.asarray(doc_rects).shape[0]
        cx, cy = _footprint_centers(doc_rects)
        ids = np.zeros(n_docs, dtype=np.int32)
        next_id = [0]

        def split(sel: np.ndarray, parts: int, depth: int) -> None:
            if parts <= 1:
                ids[sel] = next_id[0]
                next_id[0] += 1
                return
            left = parts // 2
            axis = cx if depth % 2 == 0 else cy
            order = sel[np.argsort(axis[sel], kind="stable")]
            cut = (len(sel) * left + parts - 1) // parts
            split(order[:cut], left, depth + 1)
            split(order[cut:], parts - left, depth + 1)

        split(np.arange(n_docs), n_shards, 0)
        return ids


_PARTITIONERS = {
    "hash": HashPartitioner,
    "morton": MortonPartitioner,
    "region": RegionRangePartitioner,
    # legacy CLI spelling: Morton order
    "geo": MortonPartitioner,
}


def resolve_partitioner(spec: "str | Partitioner | None") -> Partitioner:
    """CLI-boundary resolution: a name → an instance (once); instances pass
    through; ``None`` → :class:`MortonPartitioner` (the serving default)."""
    if spec is None:
        return MortonPartitioner()
    if isinstance(spec, Partitioner):
        return spec
    if isinstance(spec, str):
        try:
            return _PARTITIONERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown partitioner {spec!r}; choose from {sorted(_PARTITIONERS)}"
            ) from None
    raise TypeError(f"expected Partitioner instance or name, got {type(spec).__name__}")


def _require_partitioner(
    partitioner: "Partitioner | None", default: type[Partitioner]
) -> Partitioner:
    """Core-API guard: instances only (strings stop at the CLI boundary)."""
    if partitioner is None:
        return default()
    if isinstance(partitioner, Partitioner):
        return partitioner
    raise TypeError(
        "partitioner must be a Partitioner instance (e.g. MortonPartitioner()); "
        "raw strings are only accepted at the CLI boundary via "
        f"resolve_partitioner() — got {partitioner!r}"
    )


# ---------------------------------------------------------------------------
# The stacked index
# ---------------------------------------------------------------------------

# the array fields, in the reference's order (text, then spatial, then the
# doc map and the routing SAT)
_TEXT_FIELDS = (
    "postings", "impacts", "offsets", "post_packed", "blk_first", "blk_bits",
    "blk_word_off", "blk_n_exc", "blk_len", "blk_pos", "blk_max_impact",
    "blk_term_off", "seg_term_off", "seg_pos", "seg_len",
)
_SPATIAL_FIELDS = (
    "tp_rects", "tp_amps", "tp_doc_ids", "tp_amp_scale", "tile_starts", "tile_ends",
    "doc_rects", "doc_amps", "doc_mbr", "doc_mass", "blk_mbr", "blk_max_amp",
    "blk_max_mass",
)
ARRAY_FIELDS = (*_TEXT_FIELDS, *_SPATIAL_FIELDS, "pagerank", "doc_offset", "coverage_sat")


@dataclass(frozen=True, eq=False)
class ShardedGeoIndex:
    """Stacked per-shard index tensors on one device; leading dim = shard.

    Stored dtypes are the single index's (i16 compressed doc ids, f16 and
    int8 stores, u32 packed words).  Padding makes every shard's arrays one
    shape: postings 2**31-1, ``blk_bits`` 1, ``tp_amp_scale`` 1.0,
    ``tp_rects``/``doc_rects`` ``EMPTY_RECT``, ``doc_offset`` −1, all else
    0 — so a padded toe print scores 0 and a padded block's bound is 0.
    """

    # text index
    postings: torch.Tensor  # i32[S, P] ([S, 0] when compressed)
    impacts: torch.Tensor  # f32[S, P]
    offsets: torch.Tensor  # i32[S, M+1]
    post_packed: torch.Tensor  # u32[S, W]
    blk_first: torch.Tensor  # i32[S, NBp]
    blk_bits: torch.Tensor  # i32[S, NBp]
    blk_word_off: torch.Tensor  # i32[S, NBp]
    blk_n_exc: torch.Tensor  # i32[S, NBp]
    blk_len: torch.Tensor  # i32[S, NBt]
    blk_pos: torch.Tensor  # i32[S, NBt]
    blk_max_impact: torch.Tensor  # f32[S, NBt]
    blk_term_off: torch.Tensor  # i32[S, M+1]
    seg_term_off: torch.Tensor  # i32[S, M+1]
    seg_pos: torch.Tensor  # i32[S, NSp]
    seg_len: torch.Tensor  # i32[S, NSp]
    # spatial index
    tp_rects: torch.Tensor  # f32[S, T, 4]
    tp_amps: torch.Tensor  # f32[S, T]
    tp_doc_ids: torch.Tensor  # i32[S, T]
    tp_amp_scale: torch.Tensor  # f32[S, ceil(T/SCALE_BLOCK)] ([S, 0] unless int8)
    tile_starts: torch.Tensor  # i32[S, G*G, m]
    tile_ends: torch.Tensor  # i32[S, G*G, m]
    doc_rects: torch.Tensor  # f32[S, N, R, 4]
    doc_amps: torch.Tensor  # f32[S, N, R]
    doc_mbr: torch.Tensor  # f32[S, N, 4]
    doc_mass: torch.Tensor  # f32[S, N]
    blk_mbr: torch.Tensor  # f32[S, NB, 4]
    blk_max_amp: torch.Tensor  # f32[S, NB]
    blk_max_mass: torch.Tensor  # f32[S, NB]
    pagerank: torch.Tensor  # f32[S, N]
    doc_offset: torch.Tensor  # i32[S, N] local → global doc id (−1: padding)
    coverage_sat: torch.Tensor  # f32[S, CG+1, CG+1]
    grid: int
    n_terms: int
    block_size: int = 128
    coverage_grid: int = COVERAGE_GRID
    max_term_blocks: int = 1  # max posting blocks of any term on any shard
    layout: str = "docid"
    max_term_segments: int = 1  # max impact segments of any term on any shard

    @property
    def n_shards(self) -> int:
        return self.postings.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pagerank.device

    @cached_property
    def shards(self) -> tuple[tuple[GeoIndex, torch.Tensor], ...]:
        """Each shard's :class:`GeoIndex` as views ``field[s]`` of the
        stacked tensors, with its local → global doc id map."""
        return tuple(self._local(s) for s in range(self.n_shards))

    def _local(self, s: int) -> tuple[GeoIndex, torch.Tensor]:
        n_docs = self.doc_rects.shape[1]
        dev = self.device
        text = TextIndex(
            **{f: getattr(self, f)[s] for f in _TEXT_FIELDS},
            bitmaps=torch.empty((0, 4), dtype=torch.uint32, device=dev),
            bitmap_term_ids=torch.empty((0,), dtype=torch.int32, device=dev),
            n_docs=n_docs, n_terms=self.n_terms, max_term_blocks=self.max_term_blocks,
            layout=self.layout, max_term_segments=self.max_term_segments,
        )
        spatial = SpatialIndex(
            **{f: getattr(self, f)[s] for f in _SPATIAL_FIELDS},
            grid=self.grid, n_docs=n_docs, block_size=self.block_size,
        )
        return GeoIndex(text, spatial, self.pagerank[s]), self.doc_offset[s]


def shard_corpus_np(
    doc_terms: list[np.ndarray],
    doc_rects: np.ndarray,
    doc_amps: np.ndarray,
    pagerank: np.ndarray,
    n_terms: int,
    n_shards: int,
    partitioner: "Partitioner | None" = None,
    grid: int = 64,
    m_intervals: int = 2,
    block_size: int = 128,
    compress: "bool | str" = False,
    layout: str = "docid",
    device: "str | torch.device | None" = None,
) -> ShardedGeoIndex:
    """Partition a corpus with ``partitioner`` (default hash round-robin),
    build one index per shard on the host and stack them on ``device``
    (default CUDA), each shard with its coverage SAT.

    As in the reference: every shard's text index takes the corpus-global
    IDF (impacts bitwise equal across partitionings) and, under ``compress``,
    the PForDelta store with f32 impacts (no ``impact_dtype``, unlike the
    single-index engine); the toe-print store takes ``compress``'s dtypes.
    """
    mode = normalize_compress(compress)
    dev = resolve_device(device)
    n_docs = len(doc_terms)
    partitioner = _require_partitioner(partitioner, default=HashPartitioner)
    shard_ids = np.asarray(partitioner.assign(doc_rects, n_shards))
    if shard_ids.shape != (n_docs,):
        raise ValueError(
            f"{partitioner.name}.assign returned shape {shard_ids.shape}, "
            f"expected ({n_docs},)"
        )
    idf_global = global_idf_np(doc_terms, n_terms)
    texts, spatials, statics, ranks, sels, coverage = [], [], [], [], [], []
    for s in range(n_shards):
        # ascending global ids within the shard: local tie-breaks (lower
        # local doc id wins) agree with the single index's
        sel = np.flatnonzero(shard_ids == s)
        text, tstat = build_text_arrays_np(
            [doc_terms[i] for i in sel], n_terms, idf=idf_global,
            compress=mode != "none", layout=layout,
        )
        spatial, sstat = build_spatial_arrays_np(
            doc_rects[sel], doc_amps[sel], grid, m_intervals, compress=mode,
            block_size=block_size,
        )
        texts.append(text)
        spatials.append(spatial)
        statics.append((tstat, sstat))
        ranks.append(np.asarray(pagerank, np.float32)[sel])
        sels.append(sel)
        coverage.append(shard_coverage_sat_np(
            spatial["tp_rects"], spatial["tp_amps"], spatial["tp_amp_scale"], partitioner))

    def stack(arrays, fill, empty_rect=False):
        """Pad each shard's array along dim 0 to the longest, then stack."""
        n = max(a.shape[0] for a in arrays)
        out = np.full((len(arrays), n) + arrays[0].shape[1:], fill, dtype=arrays[0].dtype)
        for i, a in enumerate(arrays):
            out[i, : a.shape[0]] = a
            if empty_rect:
                out[i, a.shape[0]:] = geometry.EMPTY_RECT
        return out

    fills = {"postings": 2**31 - 1, "blk_bits": 1, "tp_amp_scale": 1.0}
    stacked = {}
    for f in _TEXT_FIELDS:
        stacked[f] = stack([t[f] for t in texts], fills.get(f, 0))
    for f in _SPATIAL_FIELDS:
        stacked[f] = stack([sp[f] for sp in spatials], fills.get(f, 0),
                           empty_rect=f in ("tp_rects", "doc_rects"))
    stacked["pagerank"] = stack(ranks, 0.0)
    stacked["doc_offset"] = stack([sel.astype(np.int32) for sel in sels], -1)
    stacked["coverage_sat"] = np.stack(coverage)
    return ShardedGeoIndex(
        **{f: torch.from_numpy(stacked[f]).to(dev) for f in ARRAY_FIELDS},
        grid=grid,
        n_terms=n_terms,
        block_size=int(statics[0][1]["block_size"]),
        coverage_grid=COVERAGE_GRID,
        max_term_blocks=max(t["max_term_blocks"] for t, _ in statics),
        layout=layout,
        max_term_segments=max(t["max_term_segments"] for t, _ in statics),
    )


def shard_rows(
    idx: ShardedGeoIndex, s: int, device: "str | torch.device | None" = None
) -> ShardedGeoIndex:
    """Shard ``s`` of a stacked index as a 1-shard index on ``device``
    (default: the index's): every field's row ``s`` copied, the padded
    shapes and the statics (``max_term_blocks``, ``grid``, …) kept, so the
    row's results are bitwise those of the view ``field[s]``.  A copy, so
    the stacked tensors can be freed.  A process mesh's rank holds this."""
    if not 0 <= s < idx.n_shards:
        raise IndexError(f"shard {s} of an index of {idx.n_shards} shards")
    dev = idx.device if device is None else resolve_device(device)
    return dataclasses.replace(
        idx, **{f: getattr(idx, f)[s:s + 1].to(dev, copy=True) for f in ARRAY_FIELDS}
    )


# ---------------------------------------------------------------------------
# The meshes and the serve step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes.

    The doc axes (the rules' ``"docs"``, :func:`mesh_axes`) multiply to
    the shard count, and the query axis (``"queries"``) to the number of
    query slices.  A plain :class:`Mesh` is one device: every shard and
    slice runs on ``device``, the serve step a loop over them (on
    ``"meta"`` it is the dry-run's abstract mesh).  Its subclass
    :class:`ProcessMesh` has one process per mesh position.
    """

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh describes."""
        return math.prod(self.axis_sizes)

    def coords_of(self, pos: int) -> dict[str, int]:
        """A position's (on a :class:`ProcessMesh`, a rank's) coordinate on
        each axis; positions are row-major."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(pos, self.axis_sizes))))

    def group(self, axes: tuple[str, ...], pos: int) -> list[int]:
        """The positions of ``pos``'s group over ``axes``: those whose
        coordinates off ``axes`` equal its, in row-major order of their
        coordinates on ``axes`` (the order in which a collective over
        ``axes`` concatenates and adds them, as ``jax.lax``'s)."""
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {tuple(axes)} must be distinct axes of the mesh "
                             f"{self.axis_names}")
        mine = self.coords_of(pos)
        members = [q for q in range(self.size)
                   if all(c == mine[a] for a, c in self.coords_of(q).items() if a not in axes)]
        return sorted(members, key=lambda q: tuple(self.coords_of(q)[a] for a in axes))


@dataclass(frozen=True)
class ProcessMesh(Mesh):
    """A mesh whose positions are the ranks of the default
    ``torch.distributed`` process group, in row-major rank order (as
    ``jax.sharding.Mesh`` lays out its devices); ``device`` is this rank's.
    Every rank builds the same mesh and calls the same collectives in the
    same order."""

    rank: int = 0
    backend: str = "gloo"
    # this rank's process group of each axis set (_subgroup), made on first use
    _groups: dict = field(default_factory=dict, compare=False, repr=False)

    def shard_of(self, doc_axes: tuple[str, ...], rank: int | None = None) -> int:
        """The doc shard a rank holds: its doc coordinates, row-major in
        ``doc_axes`` order (the leading dimension's ``P(doc_axes)``)."""
        c = self.coords_of(self.rank if rank is None else rank)
        return int(np.ravel_multi_index(
            tuple(c[a] for a in doc_axes), tuple(self.shape[a] for a in doc_axes)))

    def all_gather(self, tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
        """Every rank's ``tensors``, in rank order, on this rank's device:
        one world ``all_gather`` of their bytes.  Every rank passes tensors
        of the same shapes and dtypes.  Under ``gloo`` the bytes are staged
        through host memory here, explicitly: gloo's transport moves host
        buffers (given CUDA tensors, torch 2.11's gloo copies them through
        the host itself, checked on an H100), so the copy is named here
        and the same for every version."""
        import torch.distributed as dist

        flat = self._bytes(tensors)
        out = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(out, flat)
        return [_unpack(buf.to(self.device), tensors) for buf in out]

    def gather_to(self, tensors: list[torch.Tensor], dst: int = 0) -> list[list[torch.Tensor]] | None:
        """Every rank's ``tensors``, in rank order, on the host of rank
        ``dst`` (None on the others): one ``gather`` of their bytes (under
        ``gloo`` staged through host memory, as :meth:`all_gather`).  The
        checkpoint's writer collects the ranks' blocks with it."""
        import torch.distributed as dist

        flat = self._bytes(tensors)
        out = [torch.empty_like(flat) for _ in range(self.size)] if self.rank == dst else None
        dist.gather(flat, out, dst=dst)
        if out is None:
            return None
        return [_unpack(buf.cpu(), tensors) for buf in out]

    def _bytes(self, tensors: list[torch.Tensor]) -> torch.Tensor:
        """``tensors``' bytes in one buffer (on the host under ``gloo``)."""
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
        return flat.cpu() if self.backend == "gloo" else flat

    def gather_axes(self, tensors: list[torch.Tensor],
                    axes: tuple[str, ...]) -> list[list[torch.Tensor]]:
        """The ``tensors`` of this rank's group over ``axes``
        (:meth:`Mesh.group`), member by member in the order of their
        coordinates on ``axes``: ``("pod", "data")`` on a (2, 2, 1) mesh
        gives the 4 ranks of this rank's ``model`` coordinate, pod-major.
        A group of the whole world is one world :meth:`all_gather`; a
        smaller one gathers over the process group of its ranks
        (:meth:`_subgroup`), so only the group's bytes move; a group of one
        rank moves nothing: its entry is ``tensors`` themselves."""
        import torch.distributed as dist

        group = self.group(tuple(axes), self.rank)
        if len(group) == 1:
            return [list(tensors)]
        if len(group) == self.size:
            every = self.all_gather(tensors)
            return [every[r] for r in group]
        flat = self._bytes(tensors)
        out = [torch.empty_like(flat) for _ in group]
        dist.all_gather(out, flat, group=self._subgroup(tuple(axes)))
        # a process group orders its members by rank
        by_rank = dict(zip(sorted(group), out))
        return [_unpack(by_rank[r].to(self.device), tensors) for r in group]

    def _subgroup(self, axes: tuple[str, ...]):
        """This rank's process group over ``axes``.  The first call for an
        axis set creates the groups of all of them, every rank in the same
        order (``new_group`` is collective over the world), as every rank
        reaches it at the same collective."""
        import torch.distributed as dist

        key = tuple(sorted(axes))
        if key not in self._groups:
            for members in sorted({tuple(sorted(self.group(axes, r))) for r in range(self.size)}):
                g = dist.new_group(list(members))
                if self.rank in members:
                    self._groups[key] = g
        return self._groups[key]

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled; sent by rank 0 of this
        program only)."""
        import torch.distributed as dist

        box = [obj]
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        dist.broadcast_object_list(box, src=0, device=dev)
        return box[0]


def _unpack(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """``buf``'s bytes as tensors of ``like``'s shapes and dtypes."""
    off, parts = 0, []
    for t in like:
        n = t.numel() * t.element_size()
        # a fresh tensor per part, so its dtype view is aligned
        parts.append(buf[off:off + n].clone().view(t.dtype).reshape(t.shape))
        off += n
    return parts


def _check_axes(shape: tuple[int, ...], axis_names: tuple[str, ...]):
    sizes, names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"mesh shape {sizes} does not match axis names {names}")
    if len(set(names)) != len(names) or any(n < 1 for n in sizes):
        raise ValueError(f"mesh axes must be distinct and of size >= 1: {names}, {sizes}")
    return sizes, names


def make_mesh(
    shape: tuple[int, ...],
    axis_names: tuple[str, ...],
    device: "str | torch.device | None" = None,
) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axis_names`` on ``device``
    (default CUDA; raises without it).  On ``"meta"`` it is an abstract
    mesh that holds no data: the dry-run's production meshes
    (:mod:`repro_torch.launch.mesh`)."""
    sizes, names = _check_axes(shape, axis_names)
    return Mesh(names, sizes, resolve_device(device))


def make_process_mesh(
    shape: tuple[int, ...],
    axis_names: tuple[str, ...],
    device: "str | torch.device | None" = None,
) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` over ``axis_names`` on the
    default process group, which must be initialised
    (``torch.distributed.init_process_group``) with ``prod(shape)`` ranks.

    Rank ``r`` runs on ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``
    from the environment, else the rank; raises without CUDA) unless
    ``device`` is given; ``"cpu"`` runs the kernels' plain versions, as the
    tests do.  On a host with one card every rank shares ``cuda:0``.
    """
    import torch.distributed as dist

    sizes, names = _check_axes(shape, axis_names)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_process_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group first (or launch the ranks with "
            "repro_torch.launch.ranks.run_ranks)"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(sizes):
        raise ValueError(
            f"the process group has {world} ranks, the mesh {dict(zip(names, sizes))} "
            f"needs {math.prod(sizes)}"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return ProcessMesh(names, sizes, dev, rank=rank, backend=dist.get_backend())


def mesh_axes(mesh: Mesh) -> tuple[tuple[str, ...], str]:
    """The mesh's doc axes (outermost first) and query axis, resolved by the
    rules table's ``"docs"`` and ``"queries"``
    (:data:`repro_torch.sharding.specs.DEFAULT_RULES`)."""
    doc_axes = tuple(a for a in DEFAULT_RULES["docs"] if a in mesh.axis_names)
    query = [a for a in DEFAULT_RULES["queries"] if a in mesh.axis_names]
    if not query:
        raise ValueError(f"mesh {mesh.axis_names} has no query axis {DEFAULT_RULES['queries']}")
    return doc_axes, query[0]


def shard_touch(
    sats: torch.Tensor, coverage_grid: int, rects: torch.Tensor, amps: torch.Tensor
) -> torch.Tensor:
    """Footprint routing test of every shard, on the device: ``bool[S, B]``.

    The reference's in-step test: cell bounds ``floor(x·G)`` in f32, cast
    to i32 and clipped (not :func:`coarse_cells`), and the four-corner SAT
    difference in f32.
    """
    cg = coverage_grid
    g = float(cg)

    def cell(c):
        return torch.clamp(torch.floor(rects[..., c] * g).to(torch.int32), 0, cg - 1).long()

    ix0, iy0, ix1, iy1 = cell(0), cell(1), cell(2), cell(3)
    valid = (rects[..., 2] > rects[..., 0]) & (rects[..., 3] > rects[..., 1]) & (amps > 0)
    cover = (
        sats[:, iy1 + 1, ix1 + 1] - sats[:, iy0, ix1 + 1] - sats[:, iy1 + 1, ix0]
        + sats[:, iy0, ix0]
    )  # [S, B, R]
    return torch.any((cover > 0) & valid[None], dim=-1)


def make_serve_fn(
    mesh: Mesh,
    budgets: alg.QueryBudgets,
    weights: ranking.RankWeights = ranking.RankWeights(),
    doc_axes: tuple[str, ...] = ("data",),
    query_axis: str = "model",
    algorithm: str = "k_sweep",
    fused: bool = False,
    with_routing: bool = False,
):
    """The serve step for a mesh: ``serve(index, query) -> (ids i32[B, k],
    scores f32[B, k], stats)`` with global doc ids and the per-query
    counters (each shard's, summed over the doc axes).  The grid, term
    count, block size and text statics are read from the index.

    On a :class:`Mesh` the index is the whole stacked index and one loop
    runs every (shard, query slice).  On a :class:`ProcessMesh` it is this
    rank's row (:func:`shard_rows`); every rank calls ``serve`` with the
    same batch and gets the whole result.

    ``fused`` runs K-SWEEP (pruned under ``budgets.prune``) and pruned
    TEXT-FIRST through their kernels on every shard.  ``with_routing``
    masks each (query, shard) pair the query's footprints do not reach:
    its results become (−1, −inf), and a shard no query of a slice reaches
    contributes zero to that slice's counters.  It adds ``shards_touched``
    (per query) and ``shards_visited`` (one value per query slice).
    """
    fn = alg.get_algorithm(algorithm)
    if algorithm in ("k_sweep", "text_first") and fused:
        fn = partial(fn, fused=True)
    for a in (*doc_axes, query_axis):
        if a not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {a!r}")
    doc_sizes = tuple(mesh.shape[a] for a in doc_axes)
    n_shards = math.prod(doc_sizes)
    n_slices = mesh.shape[query_axis]

    def merge(ids: torch.Tensor, scores: torch.Tensor):
        """Hierarchical top-k over the doc axes, innermost first: [S, b, k]
        → [b, k]; within a level, the shards' lists concatenate in shard
        order and the lower position wins a tie (as ``jax.lax.top_k``)."""
        b, k = ids.shape[1:]
        ids = ids.reshape(*doc_sizes, b, k)
        scores = scores.reshape(*doc_sizes, b, k)
        for _ in doc_axes:
            n_ax = ids.shape[-3]
            ids = ids.movedim(-3, -2).reshape(*ids.shape[:-3], b, n_ax * k)
            scores = scores.movedim(-3, -2).reshape(*scores.shape[:-3], b, n_ax * k)
            scores, sel = ranking.select_top(scores, k)
            ids = torch.gather(ids, -1, sel)
        return ids, scores

    def shard_step(local: GeoIndex, gid_map: torch.Tensor, query: alg.QueryBatch):
        """One shard on one query slice: global ids and scores (−1, −inf
        where empty) and the shard's raw counters."""
        res = fn(local.text, local.spatial, local.pagerank, query, budgets, weights)
        valid = res.ids >= 0
        safe = torch.clamp(res.ids, 0, gid_map.shape[0] - 1).long()
        ids = torch.where(valid, gid_map[safe], -1)
        return ids, torch.where(valid, res.scores, -torch.inf), res.stats

    def combine(ids: torch.Tensor, scores: torch.Tensor, raw: list[dict], touch):
        """The collectives over the doc axes for one query slice: the
        shards' lists ``[S, b, k]`` and counters in shard order, and (under
        routing) their touch flags ``bool[S, b]`` → the merged lists and
        the counters summed in shard order."""
        if with_routing:
            ids = torch.where(touch[..., None], ids, -1)
            scores = torch.where(touch[..., None], scores, -torch.inf)
        ids, scores = merge(ids, scores)
        stats = {}
        for key in raw[0]:
            acc = None
            for s, st in enumerate(raw):
                v = st[key]
                if with_routing:
                    # a shard counts the slice's whole batch iff any of its
                    # queries reaches it (the host executor's visit rule)
                    v = torch.where(touch[s].any(), v, torch.zeros_like(v))
                acc = v if acc is None else acc + v
            stats[key] = acc
        if with_routing:
            stats["shards_touched"] = _sum_rows(touch.to(torch.float32))
            stats["shards_visited"] = _sum_rows(touch.any(dim=1).to(torch.float32))[None]
        return ids, scores, stats

    def loop_step(idx: ShardedGeoIndex, query: alg.QueryBatch):
        """One query slice over every shard of the stacked index."""
        outs = [shard_step(local, gid_map, query) for local, gid_map in idx.shards]
        touch = (shard_touch(idx.coverage_sat, idx.coverage_grid, query.rects, query.amps)
                 if with_routing else None)
        return combine(torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                       [o[2] for o in outs], touch)

    def split(query: alg.QueryBatch) -> list[alg.QueryBatch]:
        B = query.batch
        if B % n_slices:
            raise ValueError(f"batch of {B} does not split over {n_slices} query slices")
        b = B // n_slices
        return [alg.QueryBatch(query.terms[i * b:(i + 1) * b], query.rects[i * b:(i + 1) * b],
                               query.amps[i * b:(i + 1) * b]) for i in range(n_slices)]

    def join(outs):
        ids = torch.cat([o[0] for o in outs])
        scores = torch.cat([o[1] for o in outs])
        # keys in sorted order, as the reference's step returns its dict
        stats = {key: torch.cat([o[2][key] for o in outs]) for key in sorted(outs[0][2])}
        return ids, scores, stats

    def serve(idx: ShardedGeoIndex, query: alg.QueryBatch):
        if idx.n_shards != n_shards:
            raise ValueError(
                f"index has {idx.n_shards} shards, the mesh's doc axes {doc_axes} "
                f"hold {n_shards}"
            )
        return join([loop_step(idx, q) for q in split(query.to(idx.device))])

    if not isinstance(mesh, ProcessMesh):
        return serve

    # the rank holding (shard s, slice m): the first in rank order, so a
    # mesh axis outside the doc and query axes holds replicas
    owner: dict[tuple[int, int], int] = {}
    for r in range(mesh.size):
        owner.setdefault((mesh.shard_of(doc_axes, r), mesh.coords_of(r)[query_axis]), r)
    my_shard, my_slice = mesh.shard_of(doc_axes), mesh.coords_of(mesh.rank)[query_axis]

    def process_serve(idx: ShardedGeoIndex, query: alg.QueryBatch):
        if idx.n_shards != 1:
            raise ValueError(
                f"a process mesh's step takes this rank's row of the stacked index "
                f"(shard_rows(index, {my_shard})), got an index of {idx.n_shards} shards"
            )
        q = split(query.to(idx.device))[my_slice]
        local, gid_map = idx.shards[0]
        ids, scores, raw = shard_step(local, gid_map, q)
        keys = list(raw)
        mine = [ids, scores, *(raw[key] for key in keys)]
        if with_routing:
            mine.append(shard_touch(idx.coverage_sat, idx.coverage_grid, q.rects, q.amps)[0])
        # the doc axes' all_gathers and psums, as one world all_gather; the
        # reference gathers intra-pod, then inter-pod, which saves bandwidth
        # only across several cards and gives the same lists
        every = mesh.all_gather(mine)
        outs = []
        for m in range(n_slices):
            rows = [every[owner[(s, m)]] for s in range(n_shards)]
            outs.append(combine(
                torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows]),
                [dict(zip(keys, r[2:2 + len(keys)])) for r in rows],
                torch.stack([r[-1] for r in rows]) if with_routing else None,
            ))
        return join(outs)

    return process_serve


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in row order (a psum over the doc axes)."""
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    return acc
