"""Launcher of the hand-written CUDA bitmap kernel (``csrc/bitmap_filter.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/bitmap_filter/kernel.py::
bitmap_and_popcount_planar``.  Reads the ``[d, W]`` u32 rows in place (the
TPU kernel's ``[d, rows, 128]`` padding served its vector tiles).  Inputs
are checked by ``ops.py``.  ``W ≥ 1``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library, raw_stream

# (device index, stream) -> the count-only launch's word of block tickets
# and running sum: zeroed once, and zeroed again by the last block of every
# launch
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def bitmap_and_popcount_cuda(bitmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(anded u32[W], counts i32[W]) of u32[d, W] rows, one launch."""
    d, W = bitmaps.shape
    dev = bitmaps.device
    anded = torch.empty((W,), dtype=torch.uint32, device=dev)
    counts = torch.empty((W,), dtype=torch.int32, device=dev)
    err = library().bitmap_and_popcount_launch(
        bitmaps.data_ptr(), anded.data_ptr(), counts.data_ptr(), None, None, d, W,
        raw_stream(dev),
    )
    check_launch("bitmap_and_popcount_launch", err)
    return anded, counts


def conjunction_count_cuda(bitmaps: torch.Tensor) -> torch.Tensor:
    """Σ popcount(AND of the u32[d, W] rows) as a scalar i64 tensor: the
    kernel's count-only mode, one launch, nothing written but the sum."""
    d, W = bitmaps.shape
    dev = bitmaps.device
    stream = raw_stream(dev)
    scratch = _SCRATCH.get((dev.index, stream))
    if scratch is None:  # once per stream: calls on two streams never share one
        scratch = _SCRATCH[dev.index, stream] = torch.zeros(1, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    err = library().bitmap_and_popcount_launch(
        bitmaps.data_ptr(), None, None, scratch.data_ptr(), total.data_ptr(), d, W, stream,
    )
    check_launch("bitmap_and_popcount_launch", err)
    return total
