"""Shared layers (port of ``repro/models/layers.py``): ``rms_norm``, which
BST uses.  Rope, attention and SwiGLU come with the LM slice."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32 and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)
