"""Synthetic geo web corpus + query traces (port of ``repro/corpus/synth.py``).

The numpy draws are the reference's, bit for bit: the same generator, the
same calls in the same order, so a seed gives the reference's corpus and
traces.  ``make_corpus`` keeps only the random draws inside its per-document
loop and does the float32 footprint arithmetic afterwards on whole arrays —
the same IEEE operations in the same order, so the values are unchanged
while the loop sheds the per-scalar ``np.clip``/``rng.choice`` overhead
that made the reference take minutes at 2^20 documents.

Queries come back as torch tensors on the CPU where the reference returns
``jnp`` arrays; the engine moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.algorithms import QueryBatch


@dataclass
class SynthCorpus:
    doc_terms: list[np.ndarray]
    doc_rects: np.ndarray  # [N, R, 4]
    doc_amps: np.ndarray  # [N, R]
    pagerank: np.ndarray  # [N]
    n_terms: int
    cities: np.ndarray  # [C, 3]: x, y, radius


def make_corpus(
    n_docs: int = 2000,
    n_terms: int = 500,
    n_cities: int = 32,
    max_rects: int = 4,
    doc_len: int = 32,
    zipf_a: float = 1.3,
    seed: int = 0,
) -> SynthCorpus:
    rng = np.random.default_rng(seed)
    # cities: power-law sizes
    cx = rng.uniform(0.05, 0.95, n_cities)
    cy = rng.uniform(0.05, 0.95, n_cities)
    pop = rng.zipf(1.5, n_cities).astype(np.float64)
    pop = pop / pop.max()
    radius = 0.01 + 0.06 * np.sqrt(pop)
    cities = np.stack([cx, cy, radius], axis=1).astype(np.float32)
    city_p = pop / pop.sum()
    # Generator.choice(n, size, p=p, replace=True) draws random(size) and
    # maps it through this cdf with a right-sided searchsorted
    cdf = city_p.cumsum()
    cdf /= cdf[-1]

    # The reference's draw sequence per document: zipf(doc_len) terms,
    # integers(1, R+1) places, random(places) for the city choice, then per
    # place random() (address vs town), uniform() (half-width), uniform()
    # (amp), normal() twice (center jitter).  uniform(a, b) is
    # a + (b-a)·random() and normal(0, s) is 0 + s·standard_normal(), so the
    # loop records the raw draws and the arithmetic runs vectorized below.
    zipf, integers, random, std_normal = (
        rng.zipf, rng.integers, rng.random, rng.standard_normal
    )
    term_draws = []
    n_places = np.empty((n_docs,), np.int64)
    choice_u, place_u, place_z = [], [], []
    for i in range(n_docs):
        term_draws.append(zipf(zipf_a, doc_len))
        n = integers(1, max_rects + 1)
        n_places[i] = n
        choice_u.append(random(n))
        for _ in range(n):
            place_u.append(random(3))
            place_z.append(std_normal(2))

    terms = np.minimum(np.concatenate(term_draws) - 1, n_terms - 1).astype(np.int32)
    doc_terms = list(terms.reshape(n_docs, doc_len))

    rects = np.zeros((n_docs, max_rects, 4), dtype=np.float32)
    rects[:, :, 0] = 1.0  # empty-rect padding (x1 < x0)
    rects[:, :, 1] = 1.0
    amps = np.zeros((n_docs, max_rects), dtype=np.float32)
    if n_docs:
        doc_of = np.repeat(np.arange(n_docs), n_places)
        first = np.repeat(np.cumsum(n_places) - n_places, n_places)
        slot = np.arange(len(doc_of)) - first
        c = cdf.searchsorted(np.concatenate(choice_u), side="right")
        u = np.stack(place_u)  # f64[P, 3]
        z = np.stack(place_z)  # f64[P, 2]
        x, y, r = cities[c, 0], cities[c, 1], cities[c, 2]  # f32
        small = u[:, 0] < 0.5  # address-style small rect (high amp)
        wu = np.where(small, 0.05 + (0.2 - 0.05) * u[:, 1], 0.5 + (1.5 - 0.5) * u[:, 1])
        amp = np.where(small, 0.7 + (1.0 - 0.7) * u[:, 2], 0.2 + (0.6 - 0.2) * u[:, 2])
        # np.float32 ⊙ Python float computes in float32 (NEP 50): cast first
        w = r * wu.astype(np.float32)
        s = (r / np.float32(2)).astype(np.float64)
        px = np.clip(x + (0.0 + s * z[:, 0]).astype(np.float32), 0.001, 0.999)
        py = np.clip(y + (0.0 + s * z[:, 1]).astype(np.float32), 0.001, 0.999)
        x0, x1 = np.clip(px - w, 0, 1), np.clip(px + w, 0, 1)
        y0, y1 = np.clip(py - w, 0, 1), np.clip(py + w, 0, 1)
        ok = (x1 > x0) & (y1 > y0)
        rects[doc_of[ok], slot[ok]] = np.stack([x0, y0, x1, y1], axis=1)[ok]
        amps[doc_of[ok], slot[ok]] = amp[ok]

    pagerank = rng.pareto(2.0, n_docs).astype(np.float32)
    pagerank = pagerank / max(pagerank.max(), 1e-9)
    return SynthCorpus(doc_terms, rects, amps, pagerank, n_terms, cities)


def make_query_trace(
    corpus: SynthCorpus,
    n_queries: int = 64,
    d_terms: int = 4,
    q_rects: int = 2,
    zipf_a: float = 1.3,
    seed: int = 1,
    from_docs: bool = True,
) -> QueryBatch:
    """Query trace: terms + footprints around cities (see the reference)."""
    rng = np.random.default_rng(seed)
    n_cities = len(corpus.cities)
    terms = np.full((n_queries, d_terms), -1, dtype=np.int32)
    rects = np.zeros((n_queries, q_rects, 4), dtype=np.float32)
    rects[:, :, 0] = 1.0
    rects[:, :, 1] = 1.0
    amps = np.zeros((n_queries, q_rects), dtype=np.float32)
    scales = np.array([0.3, 1.0, 3.0])
    for i in range(n_queries):
        nt = rng.integers(1, d_terms + 1)
        if from_docs:
            doc = corpus.doc_terms[rng.integers(0, len(corpus.doc_terms))]
            t = np.unique(rng.choice(doc, size=min(nt, len(doc)), replace=False))
        else:
            t = np.unique(np.minimum(rng.zipf(zipf_a, nt) - 1, corpus.n_terms - 1))
        terms[i, : len(t)] = t
        c = rng.integers(0, n_cities)
        x, y, r = corpus.cities[c]
        nr = rng.integers(1, q_rects + 1)
        for j in range(nr):
            w = r * scales[rng.integers(0, 3)] * rng.uniform(0.5, 1.0)
            px = np.clip(x + rng.normal(0, r / 4), 0.001, 0.999)
            py = np.clip(y + rng.normal(0, r / 4), 0.001, 0.999)
            x0, x1 = np.clip(px - w, 0, 1), np.clip(px + w, 0, 1)
            y0, y1 = np.clip(py - w, 0, 1), np.clip(py + w, 0, 1)
            if x1 <= x0 or y1 <= y0:
                continue
            rects[i, j] = (x0, y0, x1, y1)
            amps[i, j] = 1.0
    return QueryBatch(
        terms=torch.from_numpy(terms),
        rects=torch.from_numpy(rects),
        amps=torch.from_numpy(amps),
    )


@dataclass
class TraceQuery:
    """One un-padded query in a serving trace (variable widths)."""

    terms: np.ndarray  # i32[d], no padding
    rects: np.ndarray  # f32[r, 4]
    amps: np.ndarray  # f32[r]
    arrival_s: float = 0.0


def _one_query(
    rng, corpus: SynthCorpus, city: int, d_terms: int, q_rects: int,
    scales: tuple = (0.3, 1.0, 3.0),
):
    """Sample one variable-width query about ``city`` (terms from a doc)."""
    nt = int(rng.integers(1, d_terms + 1))
    doc = corpus.doc_terms[rng.integers(0, len(corpus.doc_terms))]
    terms = np.unique(rng.choice(doc, size=min(nt, len(doc)), replace=False))
    x, y, r = corpus.cities[city]
    scales = np.asarray(scales)
    rects, amps = [], []
    for _ in range(int(rng.integers(1, q_rects + 1))):
        w = r * scales[rng.integers(0, len(scales))] * rng.uniform(0.5, 1.0)
        px = np.clip(x + rng.normal(0, r / 4), 0.001, 0.999)
        py = np.clip(y + rng.normal(0, r / 4), 0.001, 0.999)
        x0, x1 = np.clip(px - w, 0, 1), np.clip(px + w, 0, 1)
        y0, y1 = np.clip(py - w, 0, 1), np.clip(py + w, 0, 1)
        if x1 <= x0 or y1 <= y0:
            continue
        rects.append((x0, y0, x1, y1))
        amps.append(1.0)
    if not rects:  # degenerate draw: whole-city rect
        rects, amps = [(x - r, y - r, x + r, y + r)], [1.0]
    return TraceQuery(
        terms=terms.astype(np.int32),
        rects=np.asarray(rects, dtype=np.float32),
        amps=np.asarray(amps, dtype=np.float32),
    )


def make_zipf_trace(
    corpus: SynthCorpus,
    n_queries: int = 2048,
    pool_size: int = 256,
    zipf_a: float = 1.1,
    hot_frac: float = 0.8,
    n_hot_cities: int = 4,
    d_terms: int = 4,
    q_rects: int = 2,
    seed: int = 1,
    scales: tuple = (0.3, 1.0, 3.0),
) -> list[TraceQuery]:
    """Skewed serving trace: Zipf repetition over a pool of distinct queries,
    ``hot_frac`` of them about the ``n_hot_cities`` largest cities."""
    rng = np.random.default_rng(seed)
    hot = np.argsort(-corpus.cities[:, 2])[:n_hot_cities]
    pool = []
    for _ in range(pool_size):
        if rng.random() < hot_frac:
            city = int(hot[rng.integers(0, len(hot))])
        else:
            city = int(rng.integers(0, len(corpus.cities)))
        pool.append(_one_query(rng, corpus, city, d_terms, q_rects, scales))
    # Zipf over pool ranks (rejection-free: clip the unbounded tail)
    ranks = np.minimum(rng.zipf(zipf_a, n_queries) - 1, pool_size - 1)
    return [pool[r] for r in ranks]


def pad_trace_batch(
    trace: list[TraceQuery],
    max_terms: int = 8,
    max_rects: int = 4,
) -> QueryBatch:
    """Pad a serving trace into one fixed-shape :class:`QueryBatch` (CPU)."""
    B = len(trace)
    terms = np.full((B, max_terms), -1, dtype=np.int32)
    rects = np.tile(
        np.array([1.0, 1.0, 0.0, 0.0], np.float32), (B, max_rects, 1)
    )
    amps = np.zeros((B, max_rects), dtype=np.float32)
    for i, q in enumerate(trace):
        t = q.terms[:max_terms]
        terms[i, : len(t)] = t
        r = q.rects[:max_rects]
        rects[i, : len(r)] = r
        amps[i, : len(r)] = q.amps[: len(r)]
    return QueryBatch(
        terms=torch.from_numpy(terms),
        rects=torch.from_numpy(rects),
        amps=torch.from_numpy(amps),
    )
