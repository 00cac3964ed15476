"""Launcher of the hand-written CUDA bitmap kernel (``csrc/bitmap_filter.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/bitmap_filter/kernel.py::
bitmap_and_popcount_planar``.  Reads the ``[d, W]`` u32 rows in place (the
TPU kernel's ``[d, rows, 128]`` padding served its vector tiles).  Inputs
are checked by ``ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library


def bitmap_and_popcount_cuda(bitmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(anded u32[W], counts i32[W]) of u32[d, W] rows, one launch."""
    d, W = bitmaps.shape
    dev = bitmaps.device
    anded = torch.empty((W,), dtype=torch.uint32, device=dev)
    counts = torch.empty((W,), dtype=torch.int32, device=dev)
    err = library().bitmap_and_popcount_launch(
        bitmaps.data_ptr(), anded.data_ptr(), counts.data_ptr(), d, W,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("bitmap_and_popcount_launch", err)
    return anded, counts
