"""Hand-written Hopper kernels of the port, one package per Pallas kernel
of the reference: ``kernel.py`` launches the CUDA source in ``csrc/``,
``ref.py`` is its plain PyTorch version, ``ops.py`` the public wrapper.

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``); :func:`launch_counts` reads them all.
"""
from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.bitmap_filter.ops import bitmap_and_popcount
    from repro_torch.kernels.geo_score.ops import geo_score_toeprints
    from repro_torch.kernels.sweep_score.ops import sweep_score, sweep_score_pruned
    from repro_torch.kernels.text_probe.ops import text_probe_pruned

    return {
        "sweep_score": sweep_score,
        "geo_score": geo_score_toeprints,
        "sweep_score_pruned": sweep_score_pruned,
        "text_probe": text_probe_pruned,
        "bitmap_and_popcount": bitmap_and_popcount,
    }


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
