"""Quickstart (port of ``examples/quickstart.py``): build a small geo
search engine and run queries.

    python -m repro_torch.examples.quickstart [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  The corpus comes from
numpy's seeded generator, as the reference's does, so under the same
numpy its printed lines equal the reference example's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import GeoSearchEngine, QueryBatch, QueryBudgets
from repro_torch.corpus import make_corpus, make_query_trace
from repro_torch.device import resolve_device, to_numpy


def main(device=None) -> list[str]:
    """Print, and return, the example's lines."""
    dev = resolve_device(device)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    # 1. a synthetic "national crawl": 2000 docs, 400-term vocabulary,
    #    footprints around power-law cities
    corpus = make_corpus(n_docs=2000, n_terms=400, seed=0)

    # 2. build the engine: inverted index + Morton toe-print store +
    #    1024-tile grid (paper §IV)
    engine = GeoSearchEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
        pagerank=corpus.pagerank, grid=32,
        budgets=QueryBudgets(
            max_candidates=2048, max_tiles=1024, k_sweeps=4,
            sweep_budget=1024, top_k=5,
        ),
        device=dev,
    )

    # 3. a hand-written query: two terms taken from a real document, with a
    #    footprint around that document's own area ("yoga Tambaram")
    doc_id = 17
    t = sorted(set(int(x) for x in corpus.doc_terms[doc_id]))[:2]
    dr = corpus.doc_rects[doc_id, 0]
    cx, cy = (dr[0] + dr[2]) / 2, (dr[1] + dr[3]) / 2
    w = 0.08
    query = QueryBatch(
        terms=torch.tensor([[t[0], t[1] if len(t) > 1 else -1, -1, -1]], dtype=torch.int32),
        rects=torch.tensor(np.array([[[cx - w, cy - w, cx + w, cy + w],
                                      [1.0, 1.0, 0.0, 0.0]]], np.float32)),
        amps=torch.tensor([[1.0, 0.0]], dtype=torch.float32),
    )
    for algo in ["text_first", "geo_first", "k_sweep"]:
        res = engine.query(query, algo)
        ids = to_numpy(res.ids)[0]
        scores = to_numpy(res.scores)[0]
        hits = [(int(i), round(float(s), 4)) for i, s in zip(ids, scores) if i >= 0]
        say(f"{algo:12s} top-5: {hits}")

    # 4. a realistic trace + recall vs the exact oracle
    trace = make_query_trace(corpus, n_queries=32, seed=1)
    for algo in ["text_first", "geo_first", "k_sweep"]:
        say(f"{algo:12s} recall@5 vs oracle: {engine.recall_at_k(trace, algo):.3f}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(None if args.device == "cuda" else args.device)
