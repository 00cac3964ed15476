"""Rectangle and space-filling-curve geometry (port of ``repro/core/geometry.py``).

World coordinates live in the unit square.  A rectangle is ``(x0, y0, x1,
y1)``; empty rectangles have ``x1 < x0`` (padding).  Tensor functions work
on any leading batch shape; ``*_np`` functions are the host-side build twins.
"""
from __future__ import annotations

import numpy as np
import torch

EMPTY_RECT = np.array([1.0, 1.0, 0.0, 0.0], dtype=np.float32)  # x1 < x0 => empty


def rect_area(r: torch.Tensor) -> torch.Tensor:
    """Area of rectangles ``r[..., 4]``; empty rects give 0."""
    w = torch.clamp(r[..., 2] - r[..., 0], min=0.0)
    h = torch.clamp(r[..., 3] - r[..., 1], min=0.0)
    return w * h


def rect_intersection_area(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection area of broadcast rect tensors ``a[..., 4]``, ``b[..., 4]``."""
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    return torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)


def morton_encode_np(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Interleave integer coordinates (< 2**16) into Z-order codes, int64."""
    ix = ix.astype(np.uint32)
    iy = iy.astype(np.uint32)

    def part(v):
        v = v & np.uint32(0x0000FFFF)
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return (part(ix) | (part(iy) << np.uint32(1))).astype(np.int64)


def rect_to_cell_range(r: torch.Tensor, grid: int):
    """Inclusive integer cell bounds ``(ix0, iy0, ix1, iy1)`` of rects ``r``.

    float32 arithmetic as in the reference; empty rects give ``ix1 < ix0``.
    """
    g = torch.tensor(float(grid), dtype=torch.float32, device=r.device)
    # subtract a hair so an exact upper boundary stays in its own cell
    eps = torch.tensor(0.5 / grid * 1e-3, dtype=torch.float32, device=r.device)

    def cell(v):
        return torch.clamp(torch.floor(v * g).to(torch.int32), 0, grid - 1)

    ix0 = cell(r[..., 0])
    iy0 = cell(r[..., 1])
    ix1 = cell(r[..., 2] - eps)
    iy1 = cell(r[..., 3] - eps)
    empty = (r[..., 2] <= r[..., 0]) | (r[..., 3] <= r[..., 1])
    ix1 = torch.where(empty, ix0 - 1, ix1)
    return ix0, iy0, ix1, iy1


def rect_cell_bounds_np(rects: np.ndarray, grid: int):
    """Host-side twin of :func:`rect_to_cell_range` (same upper-edge eps);
    empty rects yield inverted bounds."""
    g = float(grid)
    eps = 0.5 / grid * 1e-3
    ix0 = np.clip(np.floor(rects[..., 0] * g).astype(np.int64), 0, grid - 1)
    iy0 = np.clip(np.floor(rects[..., 1] * g).astype(np.int64), 0, grid - 1)
    ix1 = np.clip(np.floor((rects[..., 2] - eps) * g).astype(np.int64), 0, grid - 1)
    iy1 = np.clip(np.floor((rects[..., 3] - eps) * g).astype(np.int64), 0, grid - 1)
    return ix0, iy0, ix1, iy1


def enumerate_rect_tiles(r: torch.Tensor, grid: int, max_tiles: int):
    """Row-major tile ids (``iy*grid+ix``) intersecting rects ``r[..., 4]``.

    Returns ``(tile_ids i32[..., max_tiles], valid bool[..., max_tiles])``;
    a rect covering more than ``max_tiles`` tiles drops the overflow (the
    reference's documented budget approximation).
    """
    ix0, iy0, ix1, iy1 = rect_to_cell_range(r, grid)
    nx = torch.clamp(ix1 - ix0 + 1, min=0)[..., None]
    ny = torch.clamp(iy1 - iy0 + 1, min=0)[..., None]
    idx = torch.arange(max_tiles, dtype=torch.int32, device=r.device)
    nx1 = torch.clamp(nx, min=1)
    rel_y = torch.div(idx, nx1, rounding_mode="floor")
    rel_x = idx % nx1
    valid = (idx < nx * ny) & (nx > 0) & (ny > 0)
    tix = torch.clamp(ix0[..., None] + rel_x, 0, grid - 1)
    tiy = torch.clamp(iy0[..., None] + rel_y, 0, grid - 1)
    tile_ids = (tiy * grid + tix).to(torch.int32)
    return torch.where(valid, tile_ids, 0), valid
