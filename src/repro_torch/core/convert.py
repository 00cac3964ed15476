"""Carry index state across from the reference package.

The index arrays are this system's state, as weights are a model's: the
reference's ``GeoIndex`` (text index, spatial index, pagerank), each field
taken out as numpy, becomes the port's :class:`GeoIndex` on a device.
The function takes plain dicts of numpy arrays, so it needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import GeoIndex
from repro_torch.core.spatial_index import spatial_index_from_numpy
from repro_torch.core.text_index import text_index_from_numpy
from repro_torch.device import resolve_device


def geo_index_from_numpy(
    text: dict[str, np.ndarray],
    spatial: dict[str, np.ndarray],
    pagerank: np.ndarray,
    statics: dict,
    device: "str | torch.device | None" = None,
) -> GeoIndex:
    """Build the port's index from the reference's fields.

    ``text``/``spatial`` map each array field of the reference's
    ``TextIndex``/``SpatialIndex`` to its numpy value; ``statics`` holds
    their static fields (``grid``, ``n_docs``, ``block_size``, ``n_terms``,
    ``max_term_blocks``, ``layout``, ``max_term_segments``).
    """
    dev = resolve_device(device)
    return GeoIndex(
        text=text_index_from_numpy(text, statics, dev),
        spatial=spatial_index_from_numpy(spatial, statics, dev),
        pagerank=torch.from_numpy(np.asarray(pagerank, np.float32)).to(dev),
    )
