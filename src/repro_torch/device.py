"""Device resolution shared by every entry point of the port, and the
host copy the host-side modules (planner, server) read tensors through."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means the CUDA device; any explicit device is taken as given.

    There is no silent CPU fallback: without CUDA the default raises and
    names the explicit opt-in.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run the port "
                "on the CPU (its kernels then run their plain PyTorch versions)"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_numpy(x, copy: bool = False) -> np.ndarray:
    """A host numpy array of a tensor on any device (or ``np.asarray`` of
    anything else); reading a CUDA tensor waits for the work that writes it.
    A CPU tensor's array shares its memory unless ``copy`` is true."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=copy).numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)
