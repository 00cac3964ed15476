"""The end-to-end driver (port of ``examples/geosearch_serve.py``): build a
corpus, then serve batched geo-query traffic through all three algorithms,
reporting queries/s, ms per query, recall and the per-stage I/O counters
the paper optimizes, with the paper's Table-1 style comparison under the
2010 disk cost model and an H100 HBM cost model.

    python -m repro_torch.examples.geosearch_serve [--n-docs 20000] [--use-pallas] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  ``--use-pallas`` (the
reference's flag) scores K-SWEEP's toe prints with the ``geo_score``
kernel.  Both cost columns are models over the measured counters, not
measurements: ``t_disk2010`` is the reference's (8 ms per seek, 100 MB/s),
``t_hbm_h100`` takes the H100 SXM data sheet's 3.35e12 B/s with the
reference's sequential and random efficiencies (the reference's
``t_hbm_v5e`` column models a TPU v5e at 819e9 B/s).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import GeoSearchEngine, QueryBatch, QueryBudgets
from repro_torch.corpus import make_corpus, make_query_trace
from repro_torch.device import resolve_device, to_numpy

SEEK_S, DISK_BW = 8e-3, 100e6
HBM_BW, EFF_SEQ, EFF_RAND = 3.35e12, 0.9, 0.15
ALGORITHMS = ("text_first", "geo_first", "k_sweep")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=20000)
    ap.add_argument("--n-queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--use-pallas", action="store_true",
                    help="score K-SWEEP's toe prints with the geo_score kernel")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def cost_models(seeks: float, b_seq: float, b_rand: float, n: int) -> tuple[float, float]:
    """(t_disk2010, t_hbm_h100) in seconds per query."""
    t_disk = (seeks * SEEK_S + (b_seq + b_rand) / DISK_BW) / n
    t_hbm = (b_seq / (HBM_BW * EFF_SEQ) + b_rand / (HBM_BW * EFF_RAND)) / n
    return t_disk, t_hbm


def _slice(q: QueryBatch, lo: int, hi: int) -> QueryBatch:
    return QueryBatch(q.terms[lo:hi], q.rects[lo:hi], q.amps[lo:hi])


def run(args: argparse.Namespace, device=None) -> list[dict]:
    """Build, then serve ``args.n_queries`` queries in batches of
    ``args.batch`` through each algorithm.  One row per algorithm: its
    ``qps`` and ``ms_per_q`` (wall clock, synchronized), the counter sums
    ``seeks``/``bytes_seq``/``bytes_random`` over ``n`` queries, the cost
    models, ``recall`` (@top_k vs the oracle, on the first batch) and
    ``last``, the last batch's result."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    print(f"[build] corpus: {args.n_docs} docs …")
    t0 = time.perf_counter()
    corpus = make_corpus(args.n_docs, 2000, seed=0)
    budgets = QueryBudgets(
        max_candidates=4096, max_tiles=2048, k_sweeps=8,
        sweep_budget=max(args.n_docs // 3, 512), top_k=10,
    )
    eng = GeoSearchEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
        pagerank=corpus.pagerank, grid=64, budgets=budgets, device=dev,
    )
    print(f"[build] done in {time.perf_counter()-t0:.1f}s "
          f"({eng.index.spatial.n_toeprints} toe prints, "
          f"{eng.index.text.n_postings} postings)")

    trace = make_query_trace(corpus, n_queries=args.n_queries, seed=1).to(dev)
    kw = {}
    if args.use_pallas:
        from repro_torch.kernels.geo_score.ops import geo_score_toeprints
        kw["tp_scorer"] = geo_score_toeprints

    rows = []
    for algo in ALGORITHMS:
        akw = kw if algo == "k_sweep" else {}
        nb = args.n_queries // args.batch
        sub0 = _slice(trace, 0, args.batch)
        eng.query(sub0, algo, **akw)  # warm up
        sync()
        t0 = time.perf_counter()
        seeks = b_seq = b_rand = 0.0
        for i in range(nb):
            res = eng.query(_slice(trace, i * args.batch, (i + 1) * args.batch), algo, **akw)
            seeks += float(to_numpy(res.stats["seeks"]).sum())
            b_seq += float(to_numpy(res.stats["bytes_seq"]).sum())
            b_rand += float(to_numpy(res.stats["bytes_random"]).sum())
        sync()
        dt = time.perf_counter() - t0
        n = nb * args.batch
        t_disk, t_hbm = cost_models(seeks, b_seq, b_rand, n)
        rows.append({
            "algorithm": algo, "n": n, "qps": n / dt, "ms_per_q": dt / n * 1e3,
            "seeks": seeks, "bytes_seq": b_seq, "bytes_random": b_rand,
            "t_disk2010": t_disk, "t_hbm_h100": t_hbm,
            "recall": eng.recall_at_k(sub0, algo), "last": res,
        })
    return rows


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    rows = run(args, None if args.device == "cuda" else args.device)
    print(f"\n{'algorithm':12s} {'QPS':>8s} {'ms/q':>7s} {'recall':>7s} "
          f"{'t_disk2010':>11s} {'t_hbm_h100':>10s}")
    for r in rows:
        print(f"{r['algorithm']:12s} {r['qps']:8.1f} {r['ms_per_q']:7.3f} {r['recall']:7.3f} "
              f"{r['t_disk2010']*1e3:9.1f}ms {r['t_hbm_h100']*1e6:8.2f}us")
    print("\npaper Table 1 reference: old 0.65 s -> proposed 0.34 s (1.91x)")
    return rows


if __name__ == "__main__":
    main()
