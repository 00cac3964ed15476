"""Synthetic geo web corpus + query traces (port of ``repro/corpus/synth.py``).

The numpy draws are the reference's, bit for bit: the same generator, the
same calls in the same order, so a seed gives the reference's corpus and
traces.  ``make_corpus`` keeps only the random draws inside its per-document
loop and does the float32 footprint arithmetic afterwards on whole arrays —
the same IEEE operations in the same order, so the values are unchanged
while the loop sheds the per-scalar ``np.clip``/``rng.choice`` overhead
that made the reference take minutes at 2^20 documents.

Queries come back as torch tensors on the CPU where the reference returns
``jnp`` arrays; the engine moves them to its device.  The arrival processes
and the mixture and uniform traces are the reference's code under the same
draws; ``term_document_frequencies`` counts the same integers without the
reference's per-document loop.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

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


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

ARRIVAL_KINDS = ("closed", "poisson", "bursty", "diurnal")


def make_arrivals(
    kind: str,
    n: int,
    rate_qps: float = 200.0,
    seed: int = 0,
    burst_factor: float = 4.0,
    on_frac: float = 0.1,
    diurnal_period_s: float = 60.0,
    diurnal_depth: float = 0.8,
) -> np.ndarray:
    """Arrival-time stamps (seconds, non-decreasing, f64[n]) for a stream.

    ``closed`` is all zeros (the replay ignores them); ``poisson`` has
    i.i.d. exponential gaps at ``rate_qps``; ``bursty`` is a two-state
    on/off Markov-modulated Poisson process whose mean rate is ``rate_qps``
    (ON at ``burst_factor`` times it for ~``on_frac`` of the time);
    ``diurnal`` thins a Poisson process to the rate ``rate_qps · (1 +
    diurnal_depth · sin(2πt / diurnal_period_s))``.
    """
    if kind not in ARRIVAL_KINDS:
        raise ValueError(f"unknown arrival kind {kind!r}; want one of {ARRIVAL_KINDS}")
    if kind == "closed":
        return np.zeros(n, dtype=np.float64)
    if rate_qps <= 0:
        raise ValueError("rate_qps must be > 0 for open-loop arrivals")
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate_qps, n))
    if kind == "bursty":
        if not 0.0 < on_frac < 1.0:
            raise ValueError("on_frac must be in (0, 1)")
        if burst_factor * on_frac >= 1.0:
            raise ValueError("burst_factor * on_frac must be < 1 (mean-rate budget)")
        rate_on = burst_factor * rate_qps
        rate_off = (1.0 - burst_factor * on_frac) * rate_qps / (1.0 - on_frac)
        mean_dwell = diurnal_period_s / 10.0
        out = np.empty(n, dtype=np.float64)
        t, i, on = 0.0, 0, False
        state_end = t + rng.exponential(mean_dwell * (1.0 - on_frac))
        while i < n:
            rate = rate_on if on else rate_off
            nxt = t + rng.exponential(1.0 / rate)
            if nxt >= state_end:
                # no arrival before the switch: restart the clock in the new
                # state (exponential dwell is memoryless, so this is exact)
                t, on = state_end, not on
                state_end = t + rng.exponential(
                    mean_dwell * (on_frac if on else 1.0 - on_frac)
                )
                continue
            t = nxt
            out[i] = t
            i += 1
        return out
    # diurnal: thinning against the peak rate
    rate_max = rate_qps * (1.0 + diurnal_depth)
    out = np.empty(n, dtype=np.float64)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / rate_max)
        rate_t = rate_qps * (
            1.0 + diurnal_depth * np.sin(2.0 * np.pi * t / diurnal_period_s)
        )
        if rng.random() * rate_max < rate_t:
            out[i] = t
            i += 1
    return out


def stamp_arrivals(
    trace: list[TraceQuery],
    kind: str = "poisson",
    rate_qps: float = 200.0,
    seed: int = 0,
    **kw,
) -> list[TraceQuery]:
    """Return a copy of ``trace`` with ``arrival_s`` stamped by ``kind``."""
    times = make_arrivals(kind, len(trace), rate_qps=rate_qps, seed=seed, **kw)
    return [replace(q, arrival_s=float(t)) for q, t in zip(trace, times)]


def term_document_frequencies(corpus: SynthCorpus) -> np.ndarray:
    """Per-term document frequency (docs containing the term), f64[n_terms]."""
    lens = np.fromiter((len(t) for t in corpus.doc_terms), np.int64, len(corpus.doc_terms))
    if not lens.sum():
        return np.zeros((corpus.n_terms,), dtype=np.float64)
    terms = np.concatenate(corpus.doc_terms).astype(np.int64)
    docs = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    # each (doc, term) pair once, then a count per term: exact integers
    pairs = np.unique(docs * corpus.n_terms + terms)
    return np.bincount(pairs % corpus.n_terms, minlength=corpus.n_terms).astype(np.float64)


def make_mixture_trace(
    corpus: SynthCorpus,
    n_queries: int = 2048,
    rare_frac: float = 0.5,
    rare_df_max: int = 4,
    hot_quantile: float = 0.92,
    seed: int = 1,
) -> list[TraceQuery]:
    """Bimodal term-selectivity × footprint-area workload (planner stressor).

    ``rare_frac`` of the queries hold one rare term (df ≤ ``rare_df_max``)
    over a country-sized footprint (TEXT-FIRST territory); the rest hold
    2–3 of the hottest terms (df above the ``hot_quantile``) over a
    city-block footprint on a real document's least crowded rect, drawn
    from the sparse tail of the geographic density (spatial-first
    territory).  No fixed algorithm is close to per-query selection here.
    """
    rng = np.random.default_rng(seed)
    df = term_document_frequencies(corpus)
    rare_terms = np.nonzero((df >= 1) & (df <= rare_df_max))[0]
    if len(rare_terms) == 0:  # tiny corpora: fall back to the rarest decile
        order = np.argsort(df + np.where(df < 1, np.inf, 0.0))
        rare_terms = order[: max(corpus.n_terms // 10, 1)]
    hot_cut = np.quantile(df[df > 0], hot_quantile)
    hot_set = set(np.nonzero(df >= max(hot_cut, 2))[0].tolist())
    # footprint rects intersecting each cell of a coarse grid (2D difference
    # trick + cumsum = integral image); hot+tiny queries anchor on doc rects
    # in the emptiest cells, where the tile grid's intervals are tight
    G = 64
    N, R, _ = corpus.doc_rects.shape
    rects_flat = corpus.doc_rects.reshape(-1, 4)
    valid_flat = rects_flat[:, 2] > rects_flat[:, 0]
    vx0 = np.clip((rects_flat[:, 0] * G).astype(np.int64), 0, G - 1)
    vy0 = np.clip((rects_flat[:, 1] * G).astype(np.int64), 0, G - 1)
    vx1 = np.clip((rects_flat[:, 2] * G).astype(np.int64), 0, G - 1)
    vy1 = np.clip((rects_flat[:, 3] * G).astype(np.int64), 0, G - 1)
    diff = np.zeros((G + 1, G + 1))
    w = valid_flat.astype(np.float64)
    np.add.at(diff, (vy0, vx0), w)
    np.add.at(diff, (vy1 + 1, vx0), -w)
    np.add.at(diff, (vy0, vx1 + 1), -w)
    np.add.at(diff, (vy1 + 1, vx1 + 1), w)
    crowd = diff.cumsum(axis=0).cumsum(axis=1)[:G, :G]  # [iy, ix]
    # per doc: its least-crowded valid rect (anchor) and that crowding
    cx = ((rects_flat[:, 0] + rects_flat[:, 2]) * 0.5 * G).astype(np.int64)
    cy = ((rects_flat[:, 1] + rects_flat[:, 3]) * 0.5 * G).astype(np.int64)
    rect_crowd = np.where(
        valid_flat,
        crowd[np.clip(cy, 0, G - 1), np.clip(cx, 0, G - 1)],
        np.inf,
    ).reshape(N, R)
    anchor_rect = rect_crowd.argmin(axis=1)
    anchor_crowd = rect_crowd.min(axis=1)
    finite = np.isfinite(anchor_crowd)
    cut = np.quantile(anchor_crowd[finite], 0.15) if finite.any() else np.inf
    quiet_docs = np.nonzero(finite & (anchor_crowd <= cut))[0]
    if len(quiet_docs) == 0:
        quiet_docs = np.nonzero(finite)[0]
    out = []
    for _ in range(n_queries):
        if rng.random() < rare_frac:
            # rare + huge: one rare term, near-domain-wide footprint
            t = np.array([rare_terms[rng.integers(0, len(rare_terms))]], np.int32)
            w = rng.uniform(0.25, 0.45)
            qx, qy = rng.uniform(0.35, 0.65, 2)
            rect = (
                max(qx - w, 0.0), max(qy - w, 0.0),
                min(qx + w, 1.0), min(qy + w, 1.0),
            )
        else:
            # hot + tiny: the doc's hottest terms, city-block footprint at
            # the doc's least-crowded footprint rect
            while True:
                d_i = int(quiet_docs[rng.integers(0, len(quiet_docs))])
                cand = np.unique(corpus.doc_terms[d_i])
                hot = cand[np.isin(cand, list(hot_set))] if hot_set else cand
                if len(hot) == 0:  # fall back to the doc's highest-df terms
                    hot = cand[np.argsort(-df[cand])][:3]
                if len(hot):
                    break
            nt = int(rng.integers(2, 4))
            t = np.sort(rng.choice(hot, size=min(nt, len(hot)), replace=False))
            r0 = corpus.doc_rects[d_i, anchor_rect[d_i]]
            qx = float((r0[0] + r0[2]) * 0.5)
            qy = float((r0[1] + r0[3]) * 0.5)
            w = rng.uniform(0.002, 0.006)
            rect = (
                max(qx - w, 0.0), max(qy - w, 0.0),
                min(qx + w, 1.0), min(qy + w, 1.0),
            )
        out.append(
            TraceQuery(
                terms=t.astype(np.int32),
                rects=np.asarray([rect], dtype=np.float32),
                amps=np.ones((1,), dtype=np.float32),
            )
        )
    return out


def make_uniform_trace(
    corpus: SynthCorpus,
    n_queries: int = 2048,
    d_terms: int = 4,
    q_rects: int = 2,
    seed: int = 1,
) -> list[TraceQuery]:
    """Adversarial trace for the cache: every query distinct, no locality."""
    rng = np.random.default_rng(seed)
    return [
        _one_query(
            rng, corpus, int(rng.integers(0, len(corpus.cities))), d_terms, q_rects
        )
        for _ in range(n_queries)
    ]


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
