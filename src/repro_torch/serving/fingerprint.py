"""Normalized query fingerprints for result caching (port of
``repro/serving/fingerprint.py``).

Two queries should share a cache entry when they are *semantically* the
same search: the same conjunction of terms over (almost) the same
footprint.  Real traces are full of such near-duplicates — the same "pizza
new york" issued from slightly different map viewports.  The fingerprint
therefore normalizes away the noise:

* **terms** — deduplicated, sorted, padding (−1) dropped: term order never
  changes a conjunction;
* **rects** — coordinates quantized onto a ``quant × quant`` lattice, empty
  rects dropped, rects sorted: footprints that differ by less than one
  lattice cell collide;
* **amps**  — quantized to ``amp_levels`` buckets.

The key is a flat tuple of ints — hashable, cheap to compare, and stable
across processes (no float bit patterns).
"""
from __future__ import annotations

import numpy as np

Fingerprint = tuple

def query_fingerprint(
    terms: np.ndarray,
    rects: np.ndarray,
    amps: np.ndarray,
    quant: int = 128,
    amp_levels: int = 8,
) -> Fingerprint:
    """Normalize one query → hashable key.

    terms: i32[d] (−1 padded) · rects: f32[r, 4] · amps: f32[r].
    """
    t = np.unique(np.asarray(terms, dtype=np.int64))
    t = t[t >= 0]

    r = np.asarray(rects, dtype=np.float64).reshape(-1, 4)
    a = np.asarray(amps, dtype=np.float64).reshape(-1)
    # validity is judged on the raw floats; quantization must never *create*
    # or *destroy* a rect (a sub-cell rect still identifies a location)
    valid = (r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1]) & (a > 0)
    r = r[valid]
    # floor the low edge, ceil the high edge, min one lattice cell: nearby
    # rects collide, but tiny rects in different cells stay distinct
    lo = np.clip(np.floor(r[:, :2] * quant), 0, quant - 1).astype(np.int64)
    hi = np.clip(np.ceil(r[:, 2:] * quant), 0, quant).astype(np.int64)
    hi = np.maximum(hi, lo + 1)
    qa = np.clip((a[valid] * amp_levels).astype(np.int64), 0, amp_levels)
    rows = np.concatenate([lo, hi, qa[:, None]], axis=1)
    # canonical order so rect permutations collide
    order = np.lexsort(rows.T[::-1])
    rows = rows[order]
    return (len(t), *t.tolist(), *rows.reshape(-1).tolist())
