"""Serving launcher: trace-driven serving through ``repro_torch.serving``
(port of ``repro/launch/serve.py``: the same flags, defaults, choices,
errors and printed lines, plus ``--device``).

Builds a synthetic corpus + indexes, generates a serving trace (Zipf-skewed
with geographic hot spots, or adversarially uniform), optionally stamps it
with an open-loop arrival process, then drives it through the production
serving stack —

    trace → fingerprint → result cache → deadline/shape-bucketed batcher
          → (sharded) executor → scatter-gather top-k merge

— reporting QPS, p50/p99 latency, cache hit rate, padding overhead, number
of compiled batch shapes, recall@k vs the exact oracle, and the paper's
per-stage byte counters.

Replay discipline (``--arrival``):

* ``closed`` (default) — next query released when the previous finishes;
  wall-clock timing, the baseline.
* ``poisson`` / ``bursty`` / ``diurnal`` — open-loop replay: queries enter
  at stamped arrival times (``--rate-qps`` mean rate) whether or not the
  server has kept up, batches flush on fill **or** on the oldest query's
  ``--max-wait-ms`` deadline, flushed batches drain through a FIFO
  dispatch queue onto ``--workers`` parallel executor slots, and the
  report decomposes each query's latency into batch-wait / queue-wait /
  service p50+p99 plus the fraction of queries meeting the ``--slo-ms``
  budget.  ``--coalesce`` lets a duplicate query arriving while its twin
  is queued or executing subscribe to the in-flight result instead of
  re-executing (reported in the ``coalesced`` counter).

``--prune`` switches the engines to their block-max pruned pipelines
(``--fused`` runs them through the hand-written CUDA kernels; on the CPU
their plain PyTorch versions run).
K-SWEEP: whole sweep blocks whose precomputed upper bound cannot beat the
running top-C threshold are skipped before scoring.  TEXT-FIRST: the
driver term's 128-posting blocks are tested against a partial
top-``max_candidates`` impact threshold and skipped before their bytes
stream (probe→score→select in ``kernels/text_probe``).  Both shrink the
inverted-index probes and the streamed bytes in the reported counters.
``--layout impact`` stores posting lists in descending-impact segments
(:mod:`repro_torch.core.text_index`): the pruned traversal's block bounds
become monotone per term, so one failed bound cuts the whole tail of the
term — same results as ``--layout docid``, strictly fewer blocks
streamed (watch the ``text block skip rate`` report line).

Sharded serving (``--shards N``) is configured by two grouped flags:
``--partition {hash,morton,region}`` picks the document
:class:`~repro_torch.core.distributed.Partitioner` (resolved from the string
exactly once, here at the CLI boundary), and ``--routing
{broadcast,footprint}`` picks the scatter discipline — ``broadcast``
sends every batch to all shards (the paper's O(S) baseline), while
``footprint`` consults each shard's coverage grid and skips shards no
query footprint touches, bit-identically.  The report then carries a
per-plan ``routing:`` fan-out line (mean shards-touched per query).

Telemetry (``--trace-out/--metrics-out/--audit-out/--events-out``): any of
these flags builds the server with a :class:`repro_torch.obs.Telemetry` handle
and exports, post-run, a Chrome/Perfetto ``trace_event`` JSON of every
query/batch/executor span (open it at https://ui.perfetto.dev), a metrics
snapshot (Prometheus text for ``.prom``/``.txt`` paths, JSON otherwise),
the planner audit JSONL (predicted vs measured cost per planned query;
``--algorithm auto`` only), and the flush/dispatch/complete/evict/coalesce
event JSONL.  Without the flags the server runs telemetry-free (zero
overhead).

``--algorithm auto`` turns on the cost-based planner
(:mod:`repro_torch.core.planner`): every miss is routed to the cheapest of
text-first / geo-first / K-SWEEP from its posting-list lengths and
footprint coverage, batcher buckets become plan-homogeneous (one compile
per plan × shape), and the report breaks query counts, latency
percentiles and byte counters down per plan.  ``--trace mixture``
generates the bimodal workload (rare terms × huge footprints alongside
hot terms × tiny footprints) where no fixed algorithm competes with
per-query selection.

``--device`` (default ``cuda``) is where the indexes live and the engines
run; without CUDA the default raises and names the opt-in, ``--device
cpu`` (the kernels' plain PyTorch versions then run).

Examples::

    python -m repro_torch.launch.serve --trace zipf --cache landlord --batcher bucketed
    python -m repro_torch.launch.serve --trace zipf --arrival poisson \\
        --rate-qps 200 --max-wait-ms 5 --slo-ms 50 --workers 4 --coalesce
    python -m repro_torch.launch.serve --trace zipf --prune --fused --cache none
    python -m repro_torch.launch.serve --trace zipf --shards 8 \\
        --partition region --routing footprint --cache none
    python -m repro_torch.launch.serve --trace mixture --algorithm auto \\
        --grid 128 --m-intervals 8 --cache none
    python -m repro_torch.launch.serve --device cpu --n-docs 3000 \\
        --trace-out trace.json --metrics-out metrics.prom
"""
from __future__ import annotations

import argparse

from repro_torch.core import GeoSearchEngine, QueryBudgets
from repro_torch.core.distributed import resolve_partitioner
from repro_torch.corpus import (
    ARRIVAL_KINDS,
    make_corpus,
    make_mixture_trace,
    make_uniform_trace,
    make_zipf_trace,
    stamp_arrivals,
)
from repro_torch.device import resolve_device
from repro_torch.serving import (
    DeadlineBatcher,
    GeoServer,
    SingleDeviceExecutor,
    make_cache,
    make_executor,
)


def build_telemetry(args):
    """A :class:`repro_torch.obs.Telemetry` handle, or None when no export
    path was requested (the server then runs the telemetry-free code path)."""
    if not (args.trace_out or args.metrics_out or args.audit_out or args.events_out):
        return None
    from repro_torch.obs import Telemetry

    return Telemetry()


def export_telemetry(tel, args) -> None:
    import json

    if args.trace_out:
        tel.tracer.write(args.trace_out)
        print(f"trace ({len(tel.tracer.queries)} query spans) → {args.trace_out}")
    if args.metrics_out:
        if args.metrics_out.endswith((".prom", ".txt")):
            with open(args.metrics_out, "w") as f:
                f.write(tel.metrics.to_prometheus())
        else:
            with open(args.metrics_out, "w") as f:
                json.dump(tel.metrics.to_json(), f, indent=2)
        print(f"metrics → {args.metrics_out}")
    if args.audit_out:
        tel.audit.to_jsonl(args.audit_out)
        errs = tel.audit.error_summary()
        joined = len(tel.audit.joined)
        print(f"planner audit ({joined} joined records) → {args.audit_out}")
        for (algo, counter), e in sorted(errs.items()):
            print(f"  pred-error {algo}/{counter}: {e:.3f}")
    if args.events_out:
        tel.events.to_jsonl(args.events_out)
        print(f"events ({len(tel.events)}) → {args.events_out}")


def build_stack(args, corpus, device=None):
    """The server and its budgets, with the executor's indexes on
    ``device`` (default CUDA)."""
    budgets = QueryBudgets(
        max_candidates=2048, max_tiles=args.max_tiles, k_sweeps=8,
        sweep_budget=max(args.n_docs // 8, 256), top_k=args.top_k,
        prune=args.prune,
    )
    sharded = args.shards > 1
    # the one place a partition *string* becomes a Partitioner instance
    executor = make_executor(
        "sharded" if sharded else "single",
        corpus,
        algorithm=args.algorithm,
        budgets=budgets,
        partitioner=resolve_partitioner(args.partition) if sharded else None,
        routing=args.routing if sharded else "broadcast",
        n_shards=args.shards,
        grid=args.grid,
        m_intervals=args.m_intervals,
        fused=args.fused,
        use_pallas=args.use_pallas,
        compress=args.compress,
        layout=args.layout,
        device=device,
    )

    cache = make_cache(args.cache, args.cache_capacity, max_bytes=args.cache_max_bytes)
    max_wait_s = args.max_wait_ms * 1e-3
    if args.batcher == "bucketed":
        batcher = DeadlineBatcher(
            max_batch=args.batch, max_terms=8, max_rects=4, max_wait_s=max_wait_s
        )
    else:  # "fixed": one shape only — full padding, the pre-serving baseline
        batcher = DeadlineBatcher(
            max_batch=args.batch, max_terms=8, max_rects=4,
            term_buckets=[8], rect_buckets=[4], batch_sizes=[args.batch],
            max_wait_s=max_wait_s,
        )
    server = GeoServer(
        executor, cache=cache, batcher=batcher,
        n_workers=args.workers, coalesce=args.coalesce,
        telemetry=build_telemetry(args),
    )
    return server, budgets


def main(argv: list[str] | None = None) -> None:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=20000)
    ap.add_argument("--n-terms", type=int, default=2000)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument(
        "--m-intervals", type=int, default=2,
        help="toe-print intervals per tile (higher = tighter "
        "spatial candidate streams; single-device only)",
    )
    ap.add_argument(
        "--max-tiles", type=int, default=256,
        help="per-rect tile enumeration budget",
    )
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=32, help="max micro-batch size")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--trace", default="zipf", choices=["zipf", "uniform", "mixture"])
    ap.add_argument(
        "--pool-size", type=int, default=256,
        help="distinct queries in the zipf trace pool",
    )
    ap.add_argument("--cache", default="landlord", choices=["none", "lru", "landlord"])
    ap.add_argument("--cache-capacity", type=int, default=512)
    ap.add_argument(
        "--cache-max-bytes", type=float, default=None,
        help="landlord result-payload byte budget (size-aware admission)",
    )
    ap.add_argument("--batcher", default="bucketed", choices=["bucketed", "fixed"])
    ap.add_argument(
        "--arrival", default="closed", choices=list(ARRIVAL_KINDS),
        help="closed-loop replay, or an open-loop arrival process "
        "(poisson | bursty MMPP on/off | diurnal sinusoid)",
    )
    ap.add_argument(
        "--rate-qps", type=float, default=200.0,
        help="mean offered load for open-loop arrivals",
    )
    ap.add_argument(
        "--max-wait-ms", type=float, default=None,
        help="deadline before a non-full bucket flushes anyway "
        "(0 = flush every query immediately; inf = count-only; "
        "default: inf closed-loop, 5 ms open-loop)",
    )
    ap.add_argument(
        "--slo-ms", type=float, default=None,
        help="latency budget; report the fraction of queries under it",
    )
    ap.add_argument(
        "--workers", type=int, default=1,
        help="parallel executor slots draining the dispatch queue "
        "(open-loop replay only; 1 = single busy server)",
    )
    ap.add_argument(
        "--coalesce", action="store_true",
        help="subscribe duplicate queries to in-flight twin batches "
        "instead of re-executing them",
    )
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument(
        "--partition", default="morton",
        choices=["hash", "morton", "region", "geo"],
        metavar="{hash,morton,region}",  # "geo" = legacy alias for morton
        help="document partitioner for --shards > 1 (hash = round-robin "
        "baseline; morton = Z-order range split; region = recursive "
        "median KD split)",
    )
    ap.add_argument(
        "--routing", default="broadcast", choices=["broadcast", "footprint"],
        help="scatter discipline for --shards > 1: broadcast every batch "
        "to all shards, or skip shards whose coverage grid no query "
        "footprint touches (bit-identical results, fewer shards visited)",
    )
    ap.add_argument(
        "--algorithm", default="k_sweep",
        choices=["text_first", "geo_first", "k_sweep", "auto"],
        help="fixed query algorithm, or 'auto' for per-query "
        "cost-based plan selection",
    )
    ap.add_argument(
        "--use-pallas", action="store_true",
        help="score with the hand-written CUDA geo_score kernel (its plain "
        "PyTorch version on the CPU)",
    )
    ap.add_argument(
        "--prune", action="store_true",
        help="block-max pruning: K-SWEEP skips sweep blocks and "
        "TEXT-FIRST skips driver posting blocks whose upper bound "
        "cannot beat the running top-C threshold "
        "(fewer index probes + bytes streamed)",
    )
    ap.add_argument(
        "--layout", default="docid", choices=["docid", "impact"],
        help="posting order: docid (ascending doc ids) or impact "
        "(descending-impact segments — monotone block bounds let the "
        "pruned TEXT-FIRST traversal cut a term's whole tail after the "
        "first failed bound; identical results)",
    )
    ap.add_argument(
        "--fused", action="store_true",
        help="run K-SWEEP through the hand-written CUDA sweep kernel and, "
        "with --prune, TEXT-FIRST through the CUDA text-probe kernel "
        "(in-kernel probe→score→select; their plain PyTorch versions on "
        "the CPU)",
    )
    ap.add_argument(
        "--compress", default="none", choices=["none", "f16", "int8"],
        help="compressed index storage: bit-packed posting deltas plus "
        "f16 (or int8 + per-block scale) toe-print stores, decoded "
        "inside the sweep kernels — the byte counters report the "
        "compressed sizes that actually stream",
    )
    ap.add_argument(
        "--no-recall", action="store_true",
        help="skip the oracle recall check (slow on big corpora)",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write per-query/batch/executor spans as Chrome/Perfetto "
        "trace_event JSON",
    )
    ap.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write the metrics registry snapshot (.prom/.txt = "
        "Prometheus text format, otherwise JSON)",
    )
    ap.add_argument(
        "--audit-out", default=None, metavar="PATH",
        help="write the planner audit JSONL (predicted vs measured cost "
        "per planned query; --algorithm auto only)",
    )
    ap.add_argument(
        "--events-out", default=None, metavar="PATH",
        help="write flush/dispatch/complete/evict/coalesce events as JSONL",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", default="cuda",
        help="where the indexes live and the engines run: cuda (the "
        "default; raises without CUDA) or cpu (the kernels' plain "
        "PyTorch versions)",
    )
    args = ap.parse_args(argv)
    if args.arrival == "closed" and args.workers > 1:
        # fail before the (minutes-long) corpus + index build does
        ap.error(
            "--workers > 1 requires an open-loop --arrival "
            "(poisson | bursty | diurnal)"
        )
    if args.routing == "footprint" and args.shards <= 1:
        ap.error("--routing footprint requires --shards > 1")
    if args.max_wait_ms is None:
        # closed-loop: count-only batching; open-loop: a live server
        # would never hold a half-full bucket for seconds
        args.max_wait_ms = float("inf") if args.arrival == "closed" else 5.0
    # before the corpus build: no CUDA and no --device cpu raises here
    device = resolve_device(None if args.device == "cuda" else args.device)

    print(f"building corpus: {args.n_docs} docs, {args.n_terms} terms …")
    corpus = make_corpus(args.n_docs, args.n_terms, seed=args.seed)
    server, budgets = build_stack(args, corpus, device)

    if args.trace == "zipf":
        trace = make_zipf_trace(
            corpus, n_queries=args.queries, pool_size=args.pool_size,
            seed=args.seed + 1,
        )
    elif args.trace == "mixture":
        trace = make_mixture_trace(corpus, n_queries=args.queries, seed=args.seed + 1)
    else:
        trace = make_uniform_trace(corpus, n_queries=args.queries, seed=args.seed + 1)
    if args.arrival != "closed":
        trace = stamp_arrivals(
            trace, args.arrival, rate_qps=args.rate_qps, seed=args.seed + 3
        )

    print(
        f"serving {len(trace)} queries: trace={args.trace} arrival={args.arrival} "
        f"rate_qps={args.rate_qps:g} max_wait_ms={args.max_wait_ms:g} "
        f"cache={args.cache} batcher={args.batcher} shards={args.shards} "
        f"partition={args.partition} routing={args.routing} "
        f"workers={args.workers} coalesce={args.coalesce} "
        f"algo={args.algorithm} prune={args.prune} fused={args.fused} "
        f"layout={args.layout} …"
    )
    report = server.run_trace(trace, arrival=args.arrival, slo_ms=args.slo_ms)
    print(report.summary())
    if server.telemetry:
        export_telemetry(server.telemetry, args)

    if not args.no_recall:
        from repro_torch.corpus import make_query_trace

        eng = (
            server.executor.engine
            if isinstance(server.executor, SingleDeviceExecutor)
            else GeoSearchEngine.build(
                corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
                pagerank=corpus.pagerank, grid=args.grid,
                m_intervals=args.m_intervals, budgets=budgets,
                compress=args.compress, layout=args.layout, device=device,
            )
        )
        if args.trace == "mixture":
            from repro_torch.corpus import pad_trace_batch

            probe = pad_trace_batch(trace[: min(64, len(trace))])
        else:
            probe = make_query_trace(
                corpus, n_queries=min(64, args.queries), seed=args.seed + 2
            )
        kw = (
            {"fused": True}
            if args.fused
            and (
                args.algorithm in ("k_sweep", "auto")
                or (args.algorithm == "text_first" and args.prune)
            )
            else {}
        )
        rec = eng.recall_at_k(probe, args.algorithm, **kw)
        print(f"recall@{budgets.top_k} vs oracle = {rec:.3f}")


if __name__ == "__main__":
    main()
