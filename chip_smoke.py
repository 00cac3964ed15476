#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes — the sweep kernels on f32, f16 and int8 stores,
   INVALID-padded sweeps, all four block sizes; text_probe on f32 and f16
   impacts, with and without the monotone cut, at max_candidates 2048 and
   1000, with and without a select floor; bitmap_and_popcount on 2, 4 and
   8 rows of the index's bitmaps — masks, flags and block counts exactly,
   scores bitwise (the kernels are compiled without FMA contraction); then
   the two redesigned kernels' edges: bitmap_and_popcount and the
   count-only prefilter (== ``counts.sum()``) on 1, 3, 8 and 9 rows of 1,
   5 and 32,771 words, aligned and at an odd word offset; geo_score's bit
   patterns (NaN and ±inf included) on ``ref.adversarial_case`` with 1, 2,
   4 and 8 live slots × T in (1, 3, 4097), B = 3, aligned and at an odd
   storage offset;
3. drives K-SWEEP at 2^20 documents in batches of 32 through the executor
   ``make_executor("single", ...)`` builds and, over its index, the ones
   its ``fused=`` and ``use_pallas=`` select — plain, fused, geo-score
   kernel, each of the three again with early termination, pruned plain
   and pruned fused — and checks that each kernel launched once per batch
   and that the kernel variants equal their plain twins in ids, scores and
   every stats counter
   (at serve.py's budgets, without early termination, the unpruned
   kernels' scores select nothing, so only the early-termination and
   pruned variants hold a kernel's scores to the answer); a small corpus
   gives the same answers on the card as on the CPU and as a brute-force
   numpy oracle; then drives TEXT-FIRST (unpruned, and block-max pruned
   plain and through text_probe) and GEO-FIRST on the docid, impact and
   impact/int8 text stores — the last built by ``make_executor("single",
   corpus, algorithm="text_first", ..., layout="impact",
   compress="int8")`` — and checks the kernel variants against their plain
   twins, the impact layout against the docid layout (ids and scores
   bitwise, K-SWEEP included), and the block-bitmap conjunction prefilter
   against the CSR intersection over the trace's term tuples;
4. times each kernel and its plain version with CUDA events (median of
   20 runs) beside its bound — operations counted from each query's live
   slots — and each variant's batch latency; times the unpruned scorer
   again with every window at one origin (all windows on a few store
   tiles), beside a torch fill of its output's size and the store bytes
   its windows request and the unique bytes; beside each kernel's time
   (CUDA events around one call), its device time: 100 launches queued
   behind a spin kernel between one pair of events, over 100, and the
   host µs per call it took to queue them; the launch floor (a 1-element
   ``fill_`` timed the same way) beside every row, each device time over
   max(bound, floor); the conjunction prefilter's one count-only launch
   against the kernel + ``counts.sum()`` it replaced; and ``geo_score``
   both ways at phase 9's retrieval shape;
5. runs one profiler pass per variant (phase 7's sharded executor too):
   each stage's host time and device time, and the device's idle share
   over a batch; and one over each of phase 9's recsys cells (the
   geo-blended retrieval, AutoInt's chunked retrieval and every serve
   shape), over a prefill (2,048
   tokens) and a decode step (4,096 cached tokens) of each of phases
   12–13's five LMs, over a train step (2,048 tokens) of Granite-MoE and
   over a train step of each of phase 14's EGNN cells:
   the device's busy time, idle share and top device ops;
6. serves 2048-query traces through ``GeoServer`` over the phase-3 index,
   at ``launch/serve.py``'s defaults (Landlord cache of 512, deadline
   batcher of 32 × 8 terms × 4 rects, 5 ms deadline open loop):
   ``serve_fused`` (zipf, closed loop, the sweep_score kernel),
   ``serve_pruned_poisson`` (zipf at 200 queries/s, the pruned sweep
   kernel) and ``serve_auto_mixture`` (the mixture trace under the planner,
   pruned, through the pruned sweep and text_probe kernels); prints each
   report (queries/s, p50/p99, hit rate, padding, the open-loop stage split,
   the plan mix), its launches and recall@10; then replays the first 512
   queries of each trace open loop with Poisson stamps and a fixed service
   time through the kernel executor and its plain twin, whose reports and
   per-query ids and scores must be equal.  It runs after phase 4 and
   before phase 5, so no profiler session precedes a timed serving run;
7. shards the same corpus into 8 region shards behind footprint routing
   (``make_executor("sharded", corpus, n_shards=8,
   partitioner=RegionRangePartitioner(), routing="footprint", fused=True,
   budgets=prune)``) and drives the 256-query trace through it: footprint
   equals broadcast (ids and scores bitwise) and the kernel executor its
   plain twin (ids, scores and every counter bitwise), both over the same
   shard engines; the pruned sweep launches once per visited shard per
   batch; a narrow batch (copies of one query whose footprint, cut to a
   fifth, misses some shards) holds the same checks while routing skips
   shards; one batch each of fused K-SWEEP and ``use_pallas`` K-SWEEP (with
   early termination, so the kernels' scores pick the candidates) and of
   pruned fused TEXT-FIRST equals its plain twin; ``GeoServer`` serves a
   2048-query zipf trace over the sharded executor
   (``serve_sharded_footprint``: serve.py's defaults with ``--shards 8
   --partition region --routing footprint --prune --fused``; its launches
   exactly one per visited shard per live batch plus 8 per warm-up shape);
   and the mesh executor on an (8, 1) data × model mesh equals the sharded
   one on the trace and the narrow batch (ids and scores after sorting each
   row by (−score, id), counter sums within rtol 1e-6).  The mesh's
   stacked index (``shard_corpus_np`` of the same corpus and partitioner,
   as ``make_executor("mesh", ...)`` builds it) is built on the host by a
   subprocess with no card visible, started before phase 1 beside the
   dry-run of phase 15 (a) and waited for at the end of the set-up, so
   that its build is not on the timed path; phase 7 loads it onto the
   card.  It runs after phase 6 and before phase 5.
8. puts telemetry (``repro_torch.obs.Telemetry``) to work: (a) serves
   phase 6's ``serve_auto_mixture`` (without its cache, whose wall-clock
   eviction credits could move a hit between runs) ``TEL_RUNS`` times each
   without and with a handle, alternating, and prints the queries/s ratio of the best runs
   (on/off, as the reference's serve benchmark computes it; not gated),
   again with every sink but the planner audit, and the planner's host
   time per query (``plan_query`` and the audit's ``explain``);
   ids, scores, every counter, hits, batches and shapes equal the
   telemetry-off run, the tracer's stage sums equal the report's four
   latency lists exactly, the trace validates, the latency histogram's
   p50/p99 fall in the report's bucket or the next, each
   ``executor.<stat>_total`` summed over plans equals the report's stat,
   and the audit joins one record per executed planned query with a
   finite error summary; (b) serves ``serve_sharded_footprint`` over phase
   7's executor with and without a handle: equal results, one ``shard s``
   span per visited shard per batch (warm-up batches visit all 8), and as
   many ``executor.shards_touched`` observations as routed queries; (c)
   runs the CLI as users start it, ``python -m repro_torch.launch.serve
   --n-docs 262144 --trace zipf --algorithm auto --prune --fused
   --arrival poisson --rate-qps 200 --coalesce`` with the four export
   flags, in a subprocess: it exits 0, prints its report and recall@10,
   writes four non-empty files whose trace ``python -m
   repro_torch.obs.validate`` accepts, and its kernel plans' served
   batches (one launch of their kernel each, from
   ``executor.batches_total``) are printed.  Its in-process launches are
   added to the kernel table's.  It runs after phase 7 and before phase 5.
9. drives the recsys serving path (``repro_torch.launch.steps.
   build_recsys_cell``) at the four recsys archs' published ``CONFIG``s,
   f32 matmuls at full f32 (no TF32): (d) each ``SMOKE`` config gives the
   same losses, forwards, towers and geo-blended top-100 on the card as on
   the CPU (the same weights, carried by ``params_from_numpy``; rtol 1e-4 /
   atol 1e-5; ids where adjacent scores are separated, −inf picks exactly);
   ``two-tower-retrieval`` at ``retrieval_cand`` (1,000,000 candidates, 4
   rects each, 2 query rects, weight 5): (a) ``geo_score_docs`` equals its
   plain version bitwise, (b) the retrieval through the kernel equals the
   one through the plain geo path in top-100 ids and scores, (c) launches
   ``geo_score`` exactly once, (e) its −inf picks are the candidates beyond
   the geo matches; then times it with and without the blend, split into
   the towers, score and blend, the kernel (beside its plain version and
   bound) and top-k; then every arch at ``serve_p99`` and ``serve_bulk``:
   ms per batch, rows/s, model FLOP/s and their share of 67e12, parameter
   bytes and peak memory, finite outputs.  ``dcn-v2``, ``autoint`` and
   ``bst`` at ``retrieval_cand`` score 1,000,000 candidate rows in the
   chunks of ``launch.steps.retrieval_chunk_rows`` (DCN-v2 one call,
   AutoInt 8, BST 4), then one top-100 of all: (k) values and ids of
   shape [100], finite non-increasing values, distinct ids in range, no
   kernel launched in the driven run; (l) on the cell's first 262,144
   rows, 100,000-row chunks (the last ragged) against one call within
   rtol 1e-4 / atol 1e-5, the top-100 ids equal where separated; (m) in
   (d), each SMOKE cell over 4,096 candidates in 1,500-row chunks, card
   vs CPU; each timed (ms per 1M candidates, rows/s, FLOP share, peak
   beside the chunk rule's prediction, the chunks).  The geo-blended
   retrieval's launch is added to the kernel table's.  It runs after phase
   8 and before phase 5.
10. trains the four recsys archs (``repro_torch.train``: AdamW, the train
   step, the fault-tolerant loop, checkpoints; ``build_recsys_cell``'s
   ``recsys_train`` cell; ``python -m repro_torch.launch.train``), f32 at
   full f32: (g) each ``SMOKE`` config takes 3 train steps on the card and
   on the CPU from the same weights and batches — losses, parameters and
   moments within rtol 1e-4 / atol 1e-5; (h) ``run`` with a checkpoint
   every 2 steps and a failure at step 5 replays to step 8 bitwise equal
   to a run without the failure (``SMOKE`` two-tower and DCN-v2); (i) the
   train CLI as subprocesses, with and without ``--simulate-failure 5``:
   both exit 0, the failing run prints its ``[fault]`` lines and its loss
   lines equal the other's; (j) ``python -m
   repro_torch.examples.recsys_retrieval`` on the card: finite losses,
   every geo-constrained top-10 id inside the query area, one
   ``geo_score`` launch (added to the kernel table's), ``geo_score_docs``
   on the example's geo inputs (1,024 candidates × 1 rect, 1 query rect)
   equal to its plain version; then each arch's
   ``train_batch`` cell (65,536 rows) at its published ``CONFIG``, built
   and freed in turn: 2 warm-up steps, 10 timed (CUDA events, median), one
   split by CUDA events into forward + loss, backward and AdamW (through
   the step's own ``value_and_grad`` and ``adamw_update``); ms per
   step, rows/s, model FLOP/s and their share of 67e12, parameter and
   optimizer-state bytes, peak memory; (f) finite losses and gradient
   norms, the optimizer's step count equal to the steps taken, every
   parameter leaf moved.  It runs after phase 9 and before phase 5.
11. runs the paper's two example drivers and the geoweb cells: (a)
   ``repro_torch.examples.quickstart`` on the card, its printed lines equal
   to its CPU run's in this process; (b) ``geosearch_serve.run`` at its
   defaults (20,000 docs, 512 queries, batch 64), plain and with
   ``--use-pallas``: the counter sums and recall equal, the last K-SWEEP
   batch's ids and scores bitwise, the ``geo_score`` launches of the
   kernel run counted (one per K-SWEEP batch and its warm-up; added to
   the kernel table's), queries/s, ms per query and the cost models per
   algorithm; (c) the three geoweb SMOKE cells
   (``launch.steps.build_cell``) on a one-card mesh equal to the same
   cells on the CPU (ids and counters exactly, scores within 1e-5), and
   the published ``CONFIG``'s int32 guard raising on that mesh.  It runs
   after phase 10 and before phase 5.
12. serves the three dense LMs (``smollm-135m``, ``qwen1.5-0.5b``,
   ``qwen2.5-14b``) through ``build_lm_cell``: each SMOKE config at f32
   compute gives the same forward, prefill, decode and cache on the card
   as on the CPU (rtol 1e-4 / atol 1e-5); then each published config,
   f32 parameters and bf16 compute, built and freed in turn: decode of
   token 512 after a 512-token prefill equals a 513-token prefill's last
   logits within ``LM_BF16_TOL`` of the largest logit, and its
   ``prefill_32k`` and ``decode_32k`` cells (and SmolLM-135M's
   ``long_500k_sliding``) at the batch and sequence of ``LM_CUTS``, each
   cut printed with its KV arithmetic: ms per prefill or decode step (CUDA
   events, median of 3 after a warm-up; the 65,536-token step once),
   tokens/s, model FLOPs as a share of 989e12, peak memory, finite logits.
   It runs after phase 11 and before phase 5.
13. runs the MoE LMs (``olmoe-1b-7b``, ``granite-moe-1b-a400m``: the
   grouped capacity-dispatch FFN) and LM training through autograd: (a)
   each MoE SMOKE config at f32 compute gives the same forward (and aux
   loss), prefill, decode and caches on the card as on the CPU (rtol 1e-4
   / atol 1e-5) and the same routing in every MoE call; (b) each MoE
   published config serves as phase 12's dense ones do (``lm_serve``: the
   decode-after-prefill check, run with capacity factor E / K so that
   nothing is dropped, and the ``prefill_32k`` and ``decode_32k`` cells at
   their ``LM_CUTS``); (c) ``train_4k`` cut to 1 x 4,096 through
   ``build_lm_cell``'s ``lm_train`` cell for SmolLM-135M, Qwen1.5-0.5B and
   Granite-MoE (remat "full"): ms per step (median of 3 after a warm-up),
   tokens/s, bf16 share of 989e12, the forward + loss / backward / AdamW
   split, peak memory, finite losses, and SmolLM-135M's step and peak again
   with remat "none"; OLMoE and Qwen2.5-14B printed as not run, with their
   train-state bytes; (d) every LM SMOKE config at f32 compute takes 3
   train steps on the card and on the CPU (losses, grad norms and moments
   within rtol 1e-4 / atol 1e-5; parameters within ``LM_STEP_TOL`` and
   ``LM_TRAJ_TOL`` of the distance each leaf travelled), and a
   failure at step 5 restored and replayed to step 8 equals the run
   without it bitwise; (e) ``python -m repro_torch.launch.train --arch
   granite-moe-1b-a400m`` with and without ``--simulate-failure 5`` (equal
   loss lines) and ``python -m repro_torch.examples.train_lm --steps 60``
   (``OK: learning``), as subprocesses.  It runs after phase 12 and before
   phase 5.
14. trains EGNN (the E(n)-equivariant GNN over ordered segment sums):
   (a) the SMOKE config at f32 compute on each cell kind's graph (a full
   power-law graph, a fanout-sampled subgraph, a molecule batch under
   graph regression) gives the same outputs, coordinates and loss on the
   card as on the CPU (rtol 1e-4 / atol 1e-5), 3 train steps too (losses
   and gradient norms within that tolerance, parameters as phase 13 (d)
   holds them), passes the reference's equivariance check on the card
   (rotation by 1.1 rad plus a translation, atol 2e-4), repeats bit for
   bit (twice the same 3 steps, at f32 and at bf16 compute), and a failure
   at step 5 restored and replayed to step 8 equals the run without it
   bitwise; (b) the published ``CONFIG`` (f32 parameters, bf16 compute)
   through ``build_gnn_cell`` at ``full_graph_sm``, ``molecule`` and
   ``minibatch_lg`` (its 232,965-node / 114,615,892-edge graph built once,
   then a (1024, (15, 10)) sample; the host seconds of each printed): ms
   per train step (CUDA events, median of 3 after a warm-up), nodes/s and
   edges/s, model FLOPs as a share of 989e12, peak memory, a finite loss,
   and the bytes autograd saves per edge and per node of a layer; (c)
   ``ogb_products`` printed as not run, with that count scaled to its
   61,859,140 edges against the card's memory (it needs several cards); (d) ``python -m
   repro_torch.launch.train --arch egnn`` with and without
   ``--simulate-failure 5`` as subprocesses (equal loss lines).  It
   launches no kernel, and runs after phase 13 and before phase 5, which
   profiles one train step of each (b) cell.
15. checks the dry-run and roofline tooling (``repro_torch.launch.dryrun``,
   ``launch/roofline``): (a) ``python -m repro_torch.launch.dryrun --mesh
   single`` over every arch × shape at published widths, as one subprocess
   per arch, all started together before phase 1 with no card visible and
   at the lowest CPU priority (they trace on ``meta``, on the host's cores,
   beside phase 1 and the set-up, which waits for them: no timed phase runs
   beside them), read after (b): each exits 0, no
   ``error`` row, one row per shape that is not skipped; each row's
   ``hbm_per_dev_GB``, ``bottleneck`` and ``roofline_fraction`` printed (a
   model from the H100 data sheet); (b) the roofline against the card on the (1, 1) host mesh,
   at sizes earlier phases run (DCN-v2 ``train_batch``, SmolLM-135M
   ``train_4k`` at ``LM_TRAIN_CUT``, Qwen2.5-14B ``prefill_32k`` at its
   ``LM_CUTS``, EGNN ``molecule``, AutoInt ``retrieval_cand`` in its 8
   chunks): (i) the dry-run's FLOPs (summed over
   dtypes) equal ``FlopCounterMode`` over the real CUDA step exactly; (ii) its
   argument bytes equal the real arguments' ``nbytes`` exactly; (iii) its
   predicted peak printed beside ``torch.cuda.max_memory_allocated()`` (the
   step's own, above what was allocated before its cell) with their ratio,
   held within ``PEAK_RATIO`` for cells above 1 GiB; (iv) the step's ms
   (CUDA events, median of ``LM_RUNS`` after the counted run) at least
   each strict bound within ``BOUND_SLACK``: FLOPs over each dtype's peak,
   and the arguments read once plus the donated ones written once over the
   HBM bandwidth; the traced-bytes ``roofline_fraction`` printed, not
   checked.  It launches no kernel, and runs after phase 14 and before
   phase 5.
16. runs the serve step across processes (``make_process_mesh``,
   ``MeshExecutor.from_index``, ``repro_torch.launch.ranks.run_ranks``):
   (a) phase 7's stacked index of 8 region shards is saved to a temporary
   directory outside the repository and 8 ``gloo`` ranks, all on
   ``cuda:0``, form the (2, 4, 1) pod x data x model mesh, each keeping
   its row; rank 0 runs phase 7's trace batches and its narrow batch
   (``--prune --fused``, routing footprint) after a warm-up, the others
   follow until its ``close()``; on every batch ids, scores and every
   counter equal the one-card loop's on the same (2, 4, 1) mesh over the
   same index, bitwise, and each rank launched ``sweep_score_pruned`` once
   per batch (its shard), the warm-up included; per-batch ms of the
   process mesh and of the loop, rank start-up seconds; (b) one ``nccl``
   rank (world size 1) runs the geoweb SMOKE ``serve_ksweep`` cell on a
   (1, 1) process mesh, bitwise equal to the one-card cell of phase 11
   (c).  It runs after phase 7 and before phase 8.
17. runs the train-side collectives across processes
   (``repro_torch.core.collectives``, the data-parallel
   ``make_train_step``, ZeRO-1's ``adamw_update``, ``psum_compressed``,
   EGNN's ``make_sharded_loss``): one ``run_ranks`` call of 4 ``gloo``
   ranks, all on ``cuda:0``, on the (4, 1) data x model process mesh:
   (a) SmolLM-135M ``train_4k`` at published widths, global batch 4 x
   4,096 (one sequence per rank; the published batch is 256), remat full,
   ``TRAIN_OPT`` (ZeRO-1), 2 steps: params (SHA-256 of their bytes), loss
   and grad_norm after each step bitwise equal on every rank and to the
   one-process ``microbatches=4`` step on the card; each rank's ms per
   step, its gradient gather and ordered sums timed alone, moment bytes per
   rank against one process's (the leaves left whole named), peak per
   rank; then ``psum_compressed`` of each rank's step-1 gradients the same
   bits on every rank, within 5 % of the exact mean and bitwise equal to
   rank 0's plain recomputation from the gathered gradients; (b) EGNN
   ``full_graph_sm`` at ``CONFIG`` (3,072 nodes and 10,752 edges, 768 and
   2,688 a rank): loss and accuracy of ``make_sharded_loss`` bitwise the
   one-process loop's on the same mesh shape on the card, gradients within
   ``GRAD_TOL`` (bitwise or not, printed), the loss within 2^-5 of
   ``loss_fn``'s; then 2 train steps of the ``gnn_full`` cell with ZeRO-1
   (ms per step); (c) one ``nccl`` rank on a (1, 1) process mesh: the
   data-parallel step (SmolLM-135M SMOKE) and the sharded loss (EGNN SMOKE)
   bitwise equal to the one-card step and loop.  The card's name and
   power limit are printed beside its times.  It launches no kernel, and
   runs after phase 15 and before phase 5.  No run on several cards is
   possible on one card's host.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without that line — as it does when CUDA is unavailable.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# launch/serve.py's defaults with --n-docs 1048576 --fused: one shard of the
# 2^26-document geoweb corpus at 64 doc shards
N_DOCS = 1 << 20
N_TERMS = 2000
N_QUERIES = 256
BATCH = 32
BUDGETS = dict(
    max_candidates=2048, max_tiles=256, k_sweeps=8, sweep_budget=N_DOCS // 8, top_k=10
)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and f32 operations/s
# outside the tensor cores.  The sheet's 67 TFLOP/s counts an FMA as two;
# the kernels are built with -fmad=false, so each counted operation is one
# instruction, issued at half that rate (132 SMs x 128 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
# per (toe print, live query slot): 2 min, 2 max, 2 sub, 2 clamp, 2 mul,
# 1 add; per toe print: the final multiply by the amp (an int8 store adds
# one more, its scale; the main path's store is f32).  A slot the scorer
# skips (amp 0, finite extent: ref.live_slots) adds exactly nothing, so
# the bounds count 11 per live slot; the count over all 8 slots is printed
# beside it for comparison with earlier runs
OPS_PER_SLOT = 11
OPS_PER_POSITION_ALL_SLOTS = 8 * OPS_PER_SLOT + 1
STORE_BYTES = 20.0  # f32 rect (16 B) and amp (4 B) per toe print
RUNS = 20
DEVICE = "cuda"
SOURCES = {
    "sweep_score": ("src/repro_torch/csrc/sweep_score.cu", "src/repro/kernels/sweep_score/kernel.py:80"),
    "geo_score": ("src/repro_torch/csrc/geo_score.cu", "src/repro/kernels/geo_score/kernel.py:53"),
    "sweep_score_pruned": ("src/repro_torch/csrc/sweep_score.cu", "src/repro/kernels/sweep_score/kernel.py:249"),
    "text_probe": ("src/repro_torch/csrc/text_probe.cu", "src/repro/kernels/text_probe/kernel.py:162"),
    "bitmap_and_popcount": ("src/repro_torch/csrc/bitmap_filter.cu", "src/repro/kernels/bitmap_filter/kernel.py:47"),
}
# 32-bit integer operations/s: the H100 SXM has 64 INT32 lanes per SM
# (half its FP32 lanes): 132 SMs x 64 x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N_BITMAP_TERMS = 64
# phase 6: launch/serve.py's serving defaults (--queries, --pool-size,
# --cache landlord --cache-capacity, --batch, --rate-qps, --max-wait-ms 5
# open loop; the stamp seed is --seed + 3)
SERVE_QUERIES = 2048
SERVE_POOL = 256
CACHE_CAPACITY = 512
RATE_QPS = 200.0
OPEN_WAIT_S = 5e-3
STAMP_SEED = 3
RECALL_PROBE = 64
# the twin replay: the first TWIN_QUERIES of each trace, open loop on the
# virtual clock with a fixed service time; arrivals fast enough that the
# buckets fill inside the deadline, so few, full batches keep the plain
# twins' host loops short
TWIN_QUERIES = 512
TWIN_RATE_QPS = 6400.0
TWIN_SERVICE_S = 1e-3
# phase 8: (a)'s runs of each side (3 until PR 26, cut to 2 for phase 16's
# time beside the halved LM_CUTS), and the serving CLI's subprocess
TEL_RUNS = 2
CLI_TIMEOUT_S = 600
# phase 8 (c)'s CLI: 2^18 docs (N_DOCS until PR 27, cut for phase 17's time)
CLI_N_DOCS = 1 << 18
# phase 9: the recsys serving path at the published CONFIGs (one card)
RECSYS_ARCHS = ("two-tower-retrieval", "dcn-v2", "autoint", "bst")
RECSYS_SEED = 0
TOP_K = 100
# the retrieval's geo blend: configs/geoweb.py's doc-major R = 4 rects per
# candidate and Q = 2 query rects, weight 5 (examples/recsys_retrieval.py)
GEO_RECTS = 4
GEO_Q_RECTS = ((0.3, 0.3, 0.5, 0.5), (0.6, 0.6, 0.75, 0.75))
GEO_WEIGHT = 5.0
# the SMOKE configs, card vs CPU: cuBLAS and the CPU's BLAS sum in other
# orders.  The retrieval's footprints are small enough that fewer than
# TOP_K candidates match, so its −inf picks are compared too
SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)
SMOKE_ROWS = 512
SMOKE_CANDIDATES = 4096
SMOKE_Q_RECTS = ((0.3, 0.3, 0.35, 0.35), (0.6, 0.6, 0.62, 0.62))
# the CTR models' retrieval_cand: 1,000,000 candidate rows in the chunks of
# launch.steps.retrieval_chunk_rows, one top-100 of all.  (l) chunked ==
# one call on the cell's first CTR_PREFIX rows, in CTR_CHECK_CHUNK-row
# chunks (two full, one of 62,144); (m) each SMOKE cell over
# SMOKE_CANDIDATES rows in CTR_SMOKE_CHUNK-row chunks (two full, one of
# 1,096), card vs CPU
CTR_RETRIEVAL_ARCHS = ("dcn-v2", "autoint", "bst")
CTR_PREFIX = 262_144
CTR_CHECK_CHUNK = 100_000
CTR_SMOKE_CHUNK = 1_500
# f32 FLOP/s outside the tensor cores with an FMA counted as two, as model
# FLOPs count a multiply-add (cuBLAS f32 without TF32 runs there)
F32_FLOPS_PER_S = 67e12
# phase 10: recsys training.  The published CONFIGs at train_batch (65,536
# rows): 2 warm-up steps, then 10 timed (CUDA events, median) and one split
# into forward + loss, backward and AdamW.  The SMOKE configs, card vs CPU,
# with the reference's _train_one optimizer (tests/test_arch_smoke.py); the
# fault replay and the CLI as tests/test_torch_train.py runs them
TRAIN_WARMUP = 2
TRAIN_RUNS = 10
TRAIN_SMOKE_STEPS = 3
TRAIN_SMOKE_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
REPLAY_ARCHS = ("two-tower-retrieval", "dcn-v2")
REPLAY_STEPS, REPLAY_CKPT_EVERY, REPLAY_FAILURE = 8, 2, 5
REPLAY_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
# phase 4's device times: back-to-back launches queued behind a spin
# kernel (torch.cuda._sleep), so the card runs them without host gaps
DEVICE_LAUNCHES = 100
SPIN_CYCLES = 40_000_000  # ~20 ms at 1.98 GHz
# phase 12: dense LM serving at published widths, f32 parameters, bf16
# compute.  Every width is published; batch and sequence are cut to one
# card's 80 GB and to the script's time limit (the reference's flash loop
# passes over a [B, S, KVH, G, 512] f32 score block per KV chunk, so a
# prefill costs O(S^2) passes: SmolLM-135M at B 1 x 32,768 is ~14 s).
# (global_batch, seq_len) per (arch, shape)
LM_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "qwen2.5-14b")
# (the MoE LMs' cells, phase 13 (b), are the last four)
# PR 26 halved each cut for phase 16's time (the decodes' batch, keeping
# their 32,768 keys; the prefills' length; the window step's length)
LM_CUTS = {
    ("smollm-135m", "prefill_32k"): (1, 4096),
    ("smollm-135m", "decode_32k"): (32, 32768),
    ("smollm-135m", "long_500k_sliding"): (1, 65536),
    ("qwen1.5-0.5b", "prefill_32k"): (1, 4096),
    ("qwen1.5-0.5b", "decode_32k"): (8, 32768),
    ("qwen2.5-14b", "prefill_32k"): (1, 2048),
    ("qwen2.5-14b", "decode_32k"): (1, 32768),
    ("olmoe-1b-7b", "prefill_32k"): (1, 4096),
    ("olmoe-1b-7b", "decode_32k"): (2, 32768),
    ("granite-moe-1b-a400m", "prefill_32k"): (1, 4096),
    ("granite-moe-1b-a400m", "decode_32k"): (8, 32768),
}
LM_SEED = 0
LM_WARMUP = 1
LM_RUNS = 3
# long_500k_sliding: one step, no warm-up (cut from the published 524,288
# keys, 1,024 KV chunks per layer, 14-26 s on the card, host-bound in the
# flash loop, to 65,536: the script's time limit)
LM_LONG = (0, 1)
# decode of token S after an S-token prefill vs an (S+1)-token prefill's
# last position, at full width in bf16.  The 513-token prefill runs as one
# KV chunk (attn_chunk 513: Skv % chunk == 0 as the reference asserts)
LM_CHECK_S = 512
# phase 5's LM profiles: a prefill of 2,048 tokens and a decode step over
# 4,096 cached ones, batch 1 (4 and 8 KV chunks per layer: the flash loop's
# per-chunk work at a size whose profile stays small), and a train step of
# 2,048 tokens of the MoE train cell only (a train step's profile takes
# ~30 s to gather; the dense train cells' splits are phase 13 (c)'s)
LM_PROFILE_CUT = (2048, 4096)
LM_PROFILE_TRAIN = "granite-moe-1b-a400m"
# H100 SXM dense bf16 tensor-core peak (NVIDIA H100 data sheet, SXM)
BF16_FLOPS_PER_S = 989e12
# bf16 keeps 8 significant bits; the two paths run other GEMM shapes
# (cuBLAS picks other kernels, so other summation orders) and a one-chunk
# vs two-chunk softmax, and their roundings compound over up to 48 layers:
# max |diff| within 2^-4 of max |logit| (the CPU tests allow 2^-5 for 2
# layers of XLA-vs-torch rounding)
LM_BF16_TOL = 2.0**-4
# phase 13: the MoE LMs (serving at the LM_CUTS above) and LM training
MOE_ARCHS = ("olmoe-1b-7b", "granite-moe-1b-a400m")
# train_4k (published 256 x 4,096) at 1 x 4,096, remat "full", on the LMs
# whose train state (16 B per parameter: f32 params, grads, m and v) fits
# one card: a warm-up step, LM_TRAIN_RUNS timed (median), one split
LM_TRAIN_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "granite-moe-1b-a400m")
LM_TRAIN_CUT = (1, 4096)
LM_TRAIN_RUNS = 3
# every SMOKE LM at f32 compute trains TRAIN_SMOKE_STEPS steps on the card
# and on the CPU at batch x length LM_SMOKE_BATCH, then replays a fault
# with REPLAY_*.  Losses, grad norms and moments are held within SMOKE_TOL.
# Parameters are held as trajectories: AdamW divides each first moment by
# the root of the second, so a gradient entry near its rounding noise
# moves its parameter by a step of full size whatever its error (f32
# rounding alone, against f64 gradients on the CPU, moves these
# parameters by up to 3.4e-5 after 3 steps, 0.00019 of the distance a
# leaf travels).  Each leaf's distance between the card and the CPU must
# stay within LM_TRAJ_TOL of the distance it travelled, and every entry
# within rtol 1e-4 / atol lr, one step's largest move
LM_SMOKE_BATCH = (4, 64)
LM_TRAJ_TOL = 1e-2
LM_STEP_TOL = dict(rtol=1e-4, atol=TRAIN_SMOKE_OPT["lr"])
# phase 14: EGNN.  (a) the SMOKE graphs of tests/test_arch_smoke.py, seed
# 0 weights; (b) the published CONFIG at the shapes that fit one card,
# LM_WARMUP + LM_RUNS steps each; (c) ogb_products (2,449,029 nodes,
# 61,859,140 edges) needs several cards (its saved activations exceed one card)
EGNN_SEED = 0
EGNN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
EGNN_NOT_RUN = "ogb_products"
EGNN_EQUIV_ATOL = 2e-4
# phase 16: the serve step across processes, (2, 4, 1) pod x data x model
# over phase 7's 8 region shards, one gloo rank each on the card
PROC_MESH = (2, 4, 1)
PROC_AXES = ("pod", "data", "model")
PROC_TIMEOUT_S = 300
# phase 17: the train-side collectives across processes: 4 gloo ranks on
# the card on the (4, 1) data x model mesh for (a) SmolLM-135M train_4k at
# a global batch of 4 x 4,096 (one sequence per rank; published 256 x
# 4,096) and (b) EGNN full_graph_sm at CONFIG; (c) one nccl rank
TRAIN_MESH = (4, 1)
TRAIN_AXES = ("data", "model")
TRAIN_DP_ARCH = "smollm-135m"
TRAIN_DP_CUT = (4, 4096)
TRAIN_DP_STEPS = 2
TRAIN_GNN_STEPS = 2
TRAIN_TIMEOUT_S = 600
COMPRESS_REL = 0.05  # tests/test_distributed.py's bound on the int8 mean
GNN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_egnn.py's GRAD_TOL
GNN_BF16_REL = 2.0**-5  # tests/test_torch_egnn.py's BF16_REL: the loss against loss_fn
# phase 15: the dry-run CLI on the single-pod mesh (one subprocess per
# arch), and the roofline against the card at sizes earlier phases run:
# (arch, shape, (global_batch, seq_len) cut or None)
DRYRUN_TIMEOUT_S = 300
ROOFLINE_CELLS = (
    ("dcn-v2", "train_batch", None),
    ("smollm-135m", "train_4k", LM_TRAIN_CUT),
    ("qwen2.5-14b", "prefill_32k", LM_CUTS[("qwen2.5-14b", "prefill_32k")]),
    ("egnn", "molecule", None),
    ("autoint", "retrieval_cand", None),
)
# the measured step may beat a strict lower bound only by timing noise
BOUND_SLACK = 1.05
# measured peak / predicted peak, held for cells above 1 GiB: the trace
# counts the step's tensors; the card adds the caching allocator's 512-B
# rounding and the library workspaces (sorts, cuBLAS) no tensor shows
PEAK_RATIO = (0.8, 1.25)
PEAK_CHECK_BYTES = 2**30


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, torch, runs: int = RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` runs, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, torch, launches: int = DEVICE_LAUNCHES) -> tuple[float, float]:
    """Device time per launch of ``fn``: ``launches`` launches queued behind
    a spin kernel between one pair of CUDA events, so they run back to back
    on the card; and the host µs per call it took to queue them.  Checks
    that the host queued them all before the spin ended (else the figure
    would hold host gaps)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t = time.perf_counter()
    for _ in range(launches):
        fn()
    host = (time.perf_counter() - t) * 1e3
    ev[2].record()
    ev[2].synchronize()
    spin = ev[0].elapsed_time(ev[1])
    check(host < spin, f"device_ms: queuing {launches} launches took {host:.3f} ms, longer "
          f"than the {spin:.3f} ms spin")
    return ev[1].elapsed_time(ev[2]) / launches, host * 1e3 / launches


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def exact(a, b, what: str, torch) -> float:
    """Assert two tensors equal exactly; return their max abs difference."""
    check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype differ")
    check(bool(torch.equal(a, b)), f"{what}: differs from the plain version")
    if a.dtype.is_floating_point:
        return float((a - b).abs().max()) if a.numel() else 0.0
    return 0.0


def at_odd_offset(x, torch):
    """A contiguous copy of ``x`` (4-byte elements) whose storage starts one
    element into its buffer, off 16-byte alignment."""
    flat = x.reshape(-1).view(torch.int32)
    buf = torch.empty(flat.numel() + 1, dtype=torch.int32, device=x.device)
    buf[1:] = flat
    return buf[1:].view(x.dtype).view(x.shape)


def results_equal(a, b, what: str, torch, counters: bool = True) -> None:
    """ids, scores and (unless ``counters`` is false) every stats counter
    equal exactly."""
    exact(a.ids, b.ids, f"{what} ids", torch)
    exact(a.scores, b.scores, f"{what} scores", torch)
    if not counters:
        return
    check(set(a.stats) == set(b.stats), f"{what}: stats keys differ")
    for k in a.stats:
        exact(a.stats[k], b.stats[k], f"{what} stats[{k}]", torch)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: unavailable ({e})"
    if smi.returncode or not smi.stdout.strip():
        return f"nvidia-smi: unavailable (exit {smi.returncode})"
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    # phase 15 (a) and phase 7's stacked index start first: their CPU-only
    # subprocesses run beside phase 1 and the set-up, which time nothing
    dry = start_dryrun_cli()
    stacked = start_stacked_index()
    try:
        return run_phases(dry, stacked)
    finally:
        stop_stacked_index(stacked)
        stop_dryrun_cli(dry)


def run_phases(dry: dict, stacked: dict) -> int:
    """Phases 1 to 17 and 5 (see the module docstring)."""
    import numpy as np

    import torch

    from repro_torch.core import GeoIndex, GeoSearchEngine, QueryBudgets, RankWeights
    from repro_torch.core import spatial_index as sidx
    from repro_torch.core.algorithms import SPANS, text_first_bounds
    from repro_torch.core.ranking import topk_recall_np
    from repro_torch.core.text_index import build_text_index_np
    from repro_torch.corpus import make_corpus, make_zipf_trace, pad_trace_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bitmap_filter import kernel as BK
    from repro_torch.kernels.bitmap_filter import ref as BR
    from repro_torch.kernels.bitmap_filter.ops import (
        bitmap_and_popcount,
        conjunction_block_prefilter,
    )
    from repro_torch.kernels.build import library
    from repro_torch.kernels.geo_score import kernel as GK
    from repro_torch.kernels.geo_score import ref as GR
    from repro_torch.kernels.geo_score.ops import geo_score_toeprints, pad_query
    from repro_torch.kernels.sweep_score import kernel as SK
    from repro_torch.kernels.sweep_score import ops as SO
    from repro_torch.kernels.sweep_score import ref as SR
    from repro_torch.kernels.text_probe import kernel as TK
    from repro_torch.kernels.text_probe import ops as TO
    from repro_torch.kernels.text_probe import ref as TR
    from repro_torch.serving import SingleDeviceExecutor, make_executor

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    # ---- phase 1: device and build -------------------------------------
    say(card_line())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    library()
    say(f"phase 1: kernels built in {time.perf_counter() - t:.1f} s")

    # ---- set-up: corpus, trace, the plain executor's index ---------------
    t = time.perf_counter()
    corpus = make_corpus(n_docs=N_DOCS, n_terms=N_TERMS, seed=0)
    trace = make_zipf_trace(corpus, n_queries=N_QUERIES, pool_size=256, seed=1)
    batches = [
        pad_trace_batch(trace[i : i + BATCH], max_terms=8, max_rects=4)
        for i in range(0, N_QUERIES, BATCH)
    ]
    say(f"set-up: corpus of {N_DOCS} docs + {N_QUERIES}-query zipf trace in "
        f"{time.perf_counter() - t:.1f} s")
    budgets = QueryBudgets(**BUDGETS)
    t = time.perf_counter()
    plain_ex = make_executor("single", corpus, budgets=budgets)
    sp = plain_ex.engine.index.spatial
    say(f"set-up: index built in {time.perf_counter() - t:.1f} s; {sp.n_toeprints} toe "
        f"prints, {plain_ex.engine.index.text.n_postings} postings (numpy {np.__version__})")
    # TEXT-FIRST's stores: docid (with the bitmap rows) and impact share
    # the K-SWEEP index's toe-print store; the impact/int8 one comes from
    # the user's entry point, the toe-print store compressed with it
    pr = replace(budgets, prune=True)
    pagerank = plain_ex.engine.index.pagerank
    t = time.perf_counter()
    idx_docid = GeoIndex(build_text_index_np(
        corpus.doc_terms, N_TERMS, n_bitmap_terms=N_BITMAP_TERMS, device=dev), sp, pagerank)
    idx_impact = GeoIndex(build_text_index_np(
        corpus.doc_terms, N_TERMS, layout="impact", device=dev), sp, pagerank)
    say(f"set-up: docid + impact text indexes built in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tf_ex = make_executor("single", corpus, algorithm="text_first", budgets=pr, fused=True,
                          layout="impact", compress="int8")
    idx_int8 = tf_ex.engine.index
    check(tf_ex.kw == {"fused": True}, "make_executor did not route pruned TEXT-FIRST to its kernel")
    say(f"set-up: impact/int8 index built in {time.perf_counter() - t:.1f} s")
    for name, idx in (("docid", idx_docid), ("impact", idx_impact), ("impact/int8", idx_int8)):
        tx = idx.text
        say(f"set-up: {name} text store: {tx.n_postings} postings, {tx.blk_pos.shape[0]} blocks, "
            f"max_term_blocks {tx.max_term_blocks}, max_term_segments {tx.max_term_segments}, "
            f"{tx.posting_bytes:.4f} B/posting, impacts {tx.impacts.dtype}")

    wait_dryrun_cli(dry)  # before anything is timed
    wait_stacked_index(stacked)
    # ---- phase 2: each kernel against its plain version ------------------
    b0 = batches[0].to(dev)
    S = plain_ex.engine.budgets.sweep_budget
    starts, ends = sidx.gather_query_intervals(sp, b0.rects, budgets.max_tiles)
    ss, ee = sidx.coalesce_k_sweeps(starts, ends, budgets.k_sweeps)
    ss, ee = sidx.split_sweeps_to_budget(ss, ee, budgets.k_sweeps, S)
    ss[0, -1] = sidx.INVALID  # at least one INVALID-padded sweep
    ee[0, -1] = sidx.INVALID
    say(f"phase 2: {int((ss != sidx.INVALID).sum())} live sweeps of budget {S} in batch 0")
    max_err = {name: 0.0 for name in SOURCES}

    rects, amps, _, ok = sidx.fetch_sweeps(sp, ss, ee, S)
    amps = torch.where(ok, amps, 0.0)
    qr, qa = pad_query(b0.rects, b0.amps)
    # through the wrapper the main path calls (its own checks and padding)
    got = geo_score_toeprints(rects, amps, b0.rects, b0.amps)
    want = GR.geo_score_toeprints_ref(rects, amps, qr, qa)
    max_err["geo_score"] = exact(got, want, "geo_score", torch)
    torch.cuda.synchronize()
    say(f"phase 2: geo_score wrapper == plain on {tuple(rects.shape)}")

    amps_np = sp.tp_amps.cpu().numpy()
    q8, s8 = sidx.quantize_amps_np(amps_np)
    stores = {
        "f32": (sp.tp_rects, sp.tp_amps, None, amps_np),
        "f16": (sp.tp_rects.half(), sp.tp_amps.half(), None,
                sp.tp_amps.half().float().cpu().numpy()),
        "int8": (sp.tp_rects.half(), torch.from_numpy(q8).to(dev),
                 torch.from_numpy(s8).to(dev),
                 q8.astype(np.float32) * np.repeat(s8, sidx.SCALE_BLOCK)[: len(q8)]),
    }
    for mode, (tr, ta, sc, dec) in stores.items():
        got = SO.sweep_score(tr, ta, ss, ee, b0.rects, b0.amps, S, tp_amp_scale=sc)
        want = SR.sweep_score_ref(tr, ta, ss, ee, b0.rects, b0.amps, S, tp_amp_scale=sc)
        err = exact(got[0], want[0], f"sweep_score[{mode}] scores", torch)
        exact(got[1], want[1], f"sweep_score[{mode}] valid", torch)
        max_err["sweep_score"] = max(max_err["sweep_score"], err)
        torch.cuda.synchronize()
        rects_np = tr.float().cpu().numpy()
        for bs in sidx.BLOCK_SIZES:
            meta = [torch.from_numpy(x).to(dev) for x in sidx.block_metadata_np(rects_np, dec, bs)]
            for C, floor in ((budgets.max_candidates, 0.0), (512, 1e-4), (3000, 0.0)):
                args = (tr, ta, *meta, ss, ee, b0.rects, b0.amps, S, C, bs, floor)
                got = SO.sweep_score_pruned(*args, tp_amp_scale=sc)
                want = SR.sweep_score_pruned_ref(*args, tp_amp_scale=sc)
                tag = f"sweep_score_pruned[{mode}, bs={bs}, C={C}, floor={floor}]"
                err = exact(got[0], want[0], tag + " scores", torch)
                for j, name in enumerate(("valid", "streamed", "blocks_scored", "blocks_active")):
                    exact(got[j + 1], want[j + 1], f"{tag} {name}", torch)
                max_err["sweep_score_pruned"] = max(max_err["sweep_score_pruned"], err)
                torch.cuda.synchronize()
                say(f"phase 2: {tag} == plain; blocks scored/active "
                    f"{int(got[3].sum())}/{int(got[4].sum())}")
        say(f"phase 2: sweep_score[{mode}] == plain")
    del rects, amps, got, want, stores

    # text_probe at the main path's shapes: batch 0's drivers on each text
    # store (f32 docid and impact, f16 impact/int8), cut on and off, the
    # buffer-minimum θ (C = 2048) and the radix select (C = 1000), select
    # floor 0 and prune_eps 0.05 of the best optimistic score
    weights = RankWeights()
    for iname, idx in (("docid", idx_docid), ("impact", idx_impact), ("impact/int8", idx_int8)):
        tx = idx.text
        for eps in (0.0, 0.05):
            _, start, nblk, rest, floor = text_first_bounds(
                tx, idx.spatial, idx.pagerank, b0.terms, replace(pr, prune_eps=eps), weights)
            for mono in (False, True):
                for C in (budgets.max_candidates, 1000):
                    args = (tx.impacts, tx.blk_pos, tx.blk_max_impact, tx.blk_len, start, nblk,
                            weights.w_text, rest, floor)
                    kw = dict(max_candidates=C, max_term_blocks=tx.max_term_blocks, monotone=mono)
                    got = TO.text_probe_pruned(*args, **kw)
                    want = TR.text_probe_pruned_ref(*args, **kw)
                    tag = f"text_probe[{iname}, {tx.impacts.dtype}, monotone={mono}, C={C}, eps={eps}]"
                    err = exact(got[0], want[0], tag + " opt", torch)
                    for j, name in enumerate(("valid", "streamed", "blocks_scored", "blocks_active")):
                        exact(got[j + 1], want[j + 1], f"{tag} {name}", torch)
                    max_err["text_probe"] = max(max_err["text_probe"], err)
                    torch.cuda.synchronize()
                    say(f"phase 2: {tag} == plain; blocks scored/active "
                        f"{int(got[3].sum())}/{int(got[4].sum())}")
    del got, want

    # bitmap_and_popcount on the docid index's bitmap rows
    bm = idx_docid.text.bitmaps
    for d in (2, 4, 8):
        rows = bm[:d].contiguous()
        got = bitmap_and_popcount(rows)
        want = BR.bitmap_and_popcount_ref(rows)
        exact(got[0].view(torch.int32), want[0].view(torch.int32), f"bitmap_and_popcount[d={d}] anded", torch)
        exact(got[1], want[1], f"bitmap_and_popcount[d={d}] counts", torch)
        torch.cuda.synchronize()
        say(f"phase 2: bitmap_and_popcount[d={d}, {tuple(rows.shape)}] == plain; "
            f"{int(got[1].sum())} docs in every row")
    # the redesigned kernels' edges: bitmap row counts around the chunk of 8
    # and widths around the 4-word groups, a row block at an odd word offset
    # (scalar loads), the count-only prefilter against counts.sum(); geo_score
    # on ref.adversarial_case (1, 2, 4, 8 live slots, a zero-amp slot of
    # overflowing area, a row with none; NaN, ±inf and huge store
    # coordinates, −0 amps; B = 3 rows of T positions, off 16-byte alignment
    # for T = 3, 4097) and from inputs at an odd storage offset, bit patterns
    # compared (NaN included)
    rng = np.random.default_rng(4)
    for d in (1, 3, 8, 9):
        for W in (1, 5, 32768 + 3):
            rows_np = rng.integers(0, 2**32, (d, W), dtype=np.uint64).astype(np.uint32)
            rows_np[:, : min(W, 2)] = 0xFFFFFFFF
            rows = torch.from_numpy(rows_np.view(np.int32)).to(dev).view(torch.uint32)
            want = BR.bitmap_and_popcount_ref(rows)
            for where, x in (("aligned", rows), ("odd offset", at_odd_offset(rows, torch))):
                tag = f"bitmap_and_popcount[d={d}, W={W}, {where}]"
                got = bitmap_and_popcount(x)
                exact(got[0].view(torch.int32), want[0].view(torch.int32), tag + " anded", torch)
                exact(got[1], want[1], tag + " counts", torch)
                exact(conjunction_block_prefilter(x), want[1].sum(), tag + " prefilter", torch)
    torch.cuda.synchronize()
    say("phase 2: bitmap_and_popcount == plain and the count-only prefilter == counts.sum() "
        "for d in (1, 3, 8, 9), W in (1, 5, 32771), aligned and at an odd word offset")
    for n_live in (1, 2, 4, 8):
        for T in (1, 3, 4097):
            args = [torch.from_numpy(x).to(dev) for x in GR.adversarial_case(rng, T, n_live)]
            want = GR.geo_score_toeprints_ref(*args).view(torch.int32)
            for where, r, a in (("aligned", *args[:2]),
                                ("odd offset", *(at_odd_offset(x, torch) for x in args[:2]))):
                got = geo_score_toeprints(r, a, *args[2:])
                exact(got.view(torch.int32), want,
                      f"geo_score[{n_live} live, T={T}, {where}] bit patterns", torch)
    torch.cuda.synchronize()
    say("phase 2: geo_score == plain bit for bit (NaN, ±inf) on the adversarial cases: "
        "1, 2, 4, 8 live slots x T in (1, 3, 4097), B = 3, aligned and at an odd offset")

    # small input: the card equals the CPU port and a brute-force oracle
    small = make_corpus(n_docs=3000, n_terms=400, seed=5)
    small_q = pad_trace_batch(make_zipf_trace(small, n_queries=BATCH, pool_size=16, seed=6))
    small_b = QueryBudgets(max_candidates=512, max_tiles=256, k_sweeps=4, sweep_budget=512)
    for fused, use_pallas, prune, et in (
        (False, False, False, False), (True, False, False, False),
        (False, True, False, False), (True, False, True, False),
        (True, False, False, True), (False, True, False, True),
    ):
        bb = replace(small_b, prune=prune, early_termination=et)
        on_card = make_executor("single", small, budgets=bb, fused=fused, use_pallas=use_pallas)
        on_cpu = make_executor("single", small, budgets=bb, fused=fused,
                               use_pallas=use_pallas, device="cpu")
        a, c = on_card.run(small_q), on_cpu.run(small_q)
        exact(a.ids.cpu(), c.ids, "small card vs cpu ids", torch)
        for k in a.stats:
            exact(a.stats[k].cpu(), c.stats[k], f"small card vs cpu stats[{k}]", torch)
        # scores pass through reductions (query mass, tp_scorer sums) that
        # the CPU and the card may order differently: held to 1e-5
        check(bool(torch.allclose(a.scores.cpu(), c.scores, rtol=1e-5, atol=1e-6)),
              "small card vs cpu scores")
    # the numpy oracle sums in float64, the port in float32: near-ties at the
    # k-th place may swap, so hold the two to recall rather than order
    want_ids = brute_force_oracle(small, small_q, 10)
    got_ids = on_card.engine.oracle(small_q, 10).ids.cpu().numpy()
    rec = topk_recall_np(want_ids, got_ids)
    check(rec >= 0.99, f"oracle on the card vs numpy brute force: recall {rec}")
    say("phase 2: small corpus: card == CPU port (ids, stats; scores within 1e-5); "
        f"oracle vs numpy brute force recall@10 {rec:.4f}")

    # ---- phase 3: the main path at size ---------------------------------
    # (executor kwargs, the kernel it reaches); without early termination the
    # unpruned kernels' partial scores select nothing (the reference's
    # semantics), so the *_et variants are the ones whose answers depend on
    # the sweep_score and geo_score kernels
    # (budgets, executor kwargs: what make_executor's fused= and use_pallas=
    # select for K-SWEEP, the kernel it reaches).  Every variant runs over
    # the plain executor's index: they differ in budgets and kernels only,
    # and make_executor would build the same index again for each
    et = replace(budgets, early_termination=True)
    variants = {
        "plain": (budgets, {}, None),
        "fused": (budgets, dict(fused=True), "sweep_score"),
        "geo_score": (budgets, dict(tp_scorer=geo_score_toeprints), "geo_score"),
        "plain_et": (et, {}, None),
        "fused_et": (et, dict(fused=True), "sweep_score"),
        "geo_score_et": (et, dict(tp_scorer=geo_score_toeprints), "geo_score"),
        "pruned_plain": (pr, {}, None),
        "pruned": (pr, dict(fused=True), "sweep_score_pruned"),
    }
    main_counts = {name: 0 for name in SOURCES}
    kernel_batches = {name: 0 for name in SOURCES}
    executors: dict[str, tuple] = {}
    outputs: dict[str, list] = {}
    latency: dict[str, list] = {}
    oracle0 = plain_ex.engine.oracle(batches[0])

    def engine(idx, b):
        return GeoSearchEngine.from_index(idx, b)

    def drive(name, ex, kernel, runs):
        """Warm up, zero the launch counters, run ``runs`` through ``ex``,
        read the counters: ``kernel`` (or none) launched once per batch."""
        ex.run(runs[0])  # warm-up: allocator and first-launch costs
        torch.cuda.synchronize()
        reset_launch_counts()
        outs, times = [], []
        for b in runs:
            t = time.perf_counter()
            res = ex.run(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(res)
        counts = launch_counts()
        for k, n in counts.items():
            want_n = len(runs) if k == kernel else 0
            check(n == want_n, f"{name}: {k} launched {n} times, expected {want_n}")
            main_counts[k] += n
        if kernel:
            kernel_batches[kernel] += len(runs)
        for res in outs:
            ids, scores = res.ids, res.scores
            check(tuple(ids.shape) == (BATCH, budgets.top_k), f"{name}: ids shape")
            check(bool(((ids >= -1) & (ids < N_DOCS)).all()), f"{name}: ids out of range")
            check(bool(torch.isfinite(scores[ids >= 0]).all()), f"{name}: non-finite score")
        rec = topk_recall_np(oracle0.ids.cpu().numpy(), outs[0].ids.cpu().numpy())
        stats = {k: float(sum(float(r.stats[k].double().sum()) for r in outs)) for k in outs[0].stats}
        say(f"phase 3: {name}: {len(runs)} batches of {BATCH}; launches {counts}; "
            f"recall@10 vs oracle (batch 0) {rec:.4f}")
        say(f"phase 3: {name}: stats sums " + json.dumps(stats))
        executors[name] = (ex, ex.algorithm)
        outputs[name] = outs
        latency[name] = times

    for name, (b, kw, kernel) in variants.items():
        ex = (plain_ex if name == "plain"
              else SingleDeviceExecutor(engine(plain_ex.engine.index, b), "k_sweep", **kw))
        drive(name, ex, kernel, batches)
    for a, b, note in (
        ("fused", "plain", "; its kernel's scores select nothing without early termination"),
        ("geo_score", "plain", "; its kernel's scores select nothing without early termination"),
        ("fused_et", "plain_et", "; the kernel's scores pick the candidates"),
        ("geo_score_et", "plain_et", "; the kernel's scores pick the candidates"),
        ("pruned", "pruned_plain", "; the kernel's scores and skips pick the candidates"),
    ):
        for i, (x, y) in enumerate(zip(outputs[a], outputs[b])):
            results_equal(x, y, f"{a} vs {b} batch {i}", torch)
        say(f"phase 3: {a} == {b} in ids, scores and every stats counter{note}")
    fused0 = outputs["fused"][0]
    outputs.clear()

    # TEXT-FIRST and GEO-FIRST on the three text stores; the impact/int8
    # pruned-kernel variant is the executor make_executor built above
    tf_variants = {
        "tf_plain": (SingleDeviceExecutor(engine(idx_docid, budgets), "text_first"), None),
        "tf_pruned_plain": (SingleDeviceExecutor(engine(idx_docid, pr), "text_first"), None),
        "tf_pruned": (SingleDeviceExecutor(engine(idx_docid, pr), "text_first", fused=True),
                      "text_probe"),
        "tf_pruned_plain_impact": (SingleDeviceExecutor(engine(idx_impact, pr), "text_first"), None),
        "tf_pruned_impact": (
            SingleDeviceExecutor(engine(idx_impact, pr), "text_first", fused=True), "text_probe"),
        "tf_pruned_plain_int8": (SingleDeviceExecutor(engine(idx_int8, pr), "text_first"), None),
        "tf_pruned_int8": (tf_ex, "text_probe"),
        "geo_first": (SingleDeviceExecutor(engine(idx_docid, budgets), "geo_first"), None),
        "geo_first_impact": (SingleDeviceExecutor(engine(idx_impact, budgets), "geo_first"), None),
    }
    for name, (ex, kernel) in tf_variants.items():
        drive(name, ex, kernel, batches)
    # one K-SWEEP batch on the impact layout (the probes go through its
    # segments) and one pruned batch on the int8 stores, kernel and plain
    drive("fused_impact", SingleDeviceExecutor(engine(idx_impact, budgets), "k_sweep", fused=True),
          "sweep_score", batches[:1])
    drive("pruned_plain_int8", SingleDeviceExecutor(engine(idx_int8, pr), "k_sweep"), None,
          batches[:1])
    drive("pruned_int8", SingleDeviceExecutor(engine(idx_int8, pr), "k_sweep", fused=True),
          "sweep_score_pruned", batches[:1])
    for a, b, note in (
        ("tf_pruned", "tf_pruned_plain", ""),
        ("tf_pruned_impact", "tf_pruned_plain_impact", ""),
        ("tf_pruned_int8", "tf_pruned_plain_int8", ""),
        ("pruned_int8", "pruned_plain_int8", " (one batch)"),
    ):
        for i, (x, y) in enumerate(zip(outputs[a], outputs[b])):
            results_equal(x, y, f"{a} vs {b} batch {i}", torch)
        say(f"phase 3: {a} == {b} in ids, scores and every stats counter{note}")
    # the impact layout reorders postings only: the docid layout's ids and
    # scores, bitwise (the byte counters differ by the segment prefixes)
    for a, b in (("tf_pruned_impact", "tf_pruned"), ("geo_first_impact", "geo_first")):
        for i, (x, y) in enumerate(zip(outputs[a], outputs[b])):
            results_equal(x, y, f"{a} vs {b} batch {i}", torch, counters=False)
        say(f"phase 3: {a} == {b} in ids and scores")
    results_equal(outputs["fused_impact"][0], fused0, "fused_impact vs fused batch 0", torch,
                  counters=False)
    say("phase 3: fused_impact == fused (batch 0) in ids and scores")
    outputs.clear()

    # the block-bitmap conjunction prefilter over the trace's term tuples
    # whose terms all have bitmap rows (topped up with seeded tuples of
    # bitmap terms): its count equals the CSR intersection's size
    tx = idx_docid.text
    row_of = {int(w): r for r, w in enumerate(tx.bitmap_term_ids.cpu().tolist())}
    tuples = []
    for q in trace:
        real = [int(w) for w in np.unique(q.terms) if w >= 0]
        if len(real) >= 2 and all(w in row_of for w in real):
            tuples.append(real)
    n_trace = len(tuples)
    rng = np.random.default_rng(2)
    bm_terms = sorted(row_of)
    while len(tuples) < BATCH:
        tuples.append(sorted(rng.choice(bm_terms, int(rng.integers(2, 5)), replace=False).tolist()))
    postings = tx.postings.cpu().numpy()
    offsets = tx.offsets.cpu().numpy()
    # gathered through an int32 view: torch indexes no uint32 tensor on CUDA
    gathered = [bm.view(torch.int32)[[row_of[w] for w in tup]].view(torch.uint32)
                for tup in tuples]
    torch.cuda.synchronize()
    reset_launch_counts()
    got_counts = [conjunction_block_prefilter(rows) for rows in gathered]
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["bitmap_and_popcount"] == len(tuples) and sum(counts.values()) == len(tuples),
          f"prefilter: launches {counts}, expected {len(tuples)} of bitmap_and_popcount")
    main_counts["bitmap_and_popcount"] += counts["bitmap_and_popcount"]
    kernel_batches["bitmap_and_popcount"] += len(tuples)
    for tup, got_n in zip(tuples, got_counts):
        # a term's doc ids are distinct: the docs in every list are the
        # ids counted len(tup) times
        seen = np.bincount(np.concatenate([postings[offsets[w] : offsets[w + 1]] for w in tup]),
                           minlength=N_DOCS)
        n_inter = int((seen == len(tup)).sum())
        check(int(got_n) == n_inter, f"prefilter {tup}: {int(got_n)} vs CSR intersection {n_inter}")
    say(f"phase 3: conjunction prefilter over {len(tuples)} term tuples ({n_trace} from the trace): "
        f"launches {counts}; every count equals the CSR intersection's size")

    # ---- phase 4: timings at the main path's shapes ---------------------
    rows = []
    # operations per position of each query: 11 per live slot, plus the
    # multiply by the amp
    ops_per_pos = OPS_PER_SLOT * SR.live_slots(qr, qa).sum(dim=1).double() + 1.0  # [B]

    def op_bound(name, n_bytes, pos_per_query):
        """Bound from each query's live slots; the 89-per-position count
        printed beside it."""
        n_ops = float((ops_per_pos * pos_per_query.double()).sum())
        n_pos = float(pos_per_query.sum())
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        old_ms, old_by = bound_ms(n_bytes, n_pos * OPS_PER_POSITION_ALL_SLOTS)
        say(f"phase 4: {name} bound: {n_bytes:.0f} bytes, {n_ops:.0f} operations "
            f"({n_ops / max(n_pos, 1.0):.4f} per position from the live slots, "
            f"{float(ops_per_pos.mean() - 1) / OPS_PER_SLOT:.4f} live slots per query) -> "
            f"{b_ms:.4f} ms ({b_by}); at {OPS_PER_POSITION_ALL_SLOTS} per position "
            f"{n_pos * OPS_PER_POSITION_ALL_SLOTS:.0f} operations -> {old_ms:.4f} ms ({old_by})")
        return b_ms, b_by

    rects, amps, _, ok = sidx.fetch_sweeps(sp, ss, ee, S)
    amps = torch.where(ok, amps, 0.0).contiguous()
    n = amps.numel()
    kern = lambda: GK.geo_score_cuda(rects, amps, qr, qa)  # noqa: E731
    plain = lambda: GR.geo_score_toeprints_ref(rects, amps, qr, qa)  # noqa: E731
    per_q = torch.full((BATCH,), amps.shape[1], dtype=torch.float64, device=dev)
    rows.append(("geo_score", kern, plain, *op_bound("geo_score", n * (STORE_BYTES + 4.0), per_q)))
    del ok

    store = (sp.tp_rects, sp.tp_amps, None)
    pad_budget = SO.padded_budget(S)
    T = sp.n_toeprints
    safe, aligned, block_starts, bounds = SO.sweep_window_offsets(ss, ee, T)
    block_starts = block_starts.contiguous()
    pos = block_starts.long()[..., None] * SK.TILE + torch.arange(pad_budget, device=dev)
    touched = torch.zeros(T, dtype=torch.bool, device=dev)
    touched[pos[pos < T]] = True
    n_out = pos.numel()
    n_live = int((pos < T).sum())
    n_unique = int(touched.sum())
    kern = lambda: SK.sweep_score_planar(block_starts, qr, qa, store, pad_budget)  # noqa: E731
    plain = lambda: SR.sweep_score_planar_ref(block_starts, qr, qa, store, pad_budget)  # noqa: E731
    rows.append(("sweep_score", kern, plain, *op_bound(
        "sweep_score", n_unique * STORE_BYTES + n_out * 4.0, (pos < T).sum(dim=(1, 2)))))
    # diagnosis: the same scorer with every window at origin 0.  The
    # store-tile-major scorer reads each tile once either way, so the gap
    # to the real windows is what crowding every window onto the first
    # pad_budget / TILE tiles costs (load imbalance); for a scorer that
    # reads the store once per window (a thread per window position) it
    # is what fetching the store costs (the slice stays in L2).  Beside it,
    # writing the output alone: torch filling a tensor of the output's
    # size, the floor of the scorer's writes on this card
    one = torch.zeros_like(block_starts)
    fill = torch.empty((*block_starts.shape, pad_budget), dtype=torch.float32, device=dev)
    diag = (time_ms(kern, torch),
            time_ms(lambda: SK.sweep_score_planar(one, qr, qa, store, pad_budget), torch),
            time_ms(lambda: fill.fill_(1.0), torch))
    del fill
    say(f"phase 4: sweep_score diagnosis: the batch's windows {diag[0]:.4f} ms, every window at "
        f"origin 0 (all on {pad_budget // SK.TILE} store tiles) {diag[1]:.4f} ms, filling the "
        f"{n_out * 4} output bytes alone {diag[2]:.4f} ms; store bytes requested "
        f"{n_live * STORE_BYTES:.0f}, "
        f"unique {n_unique * STORE_BYTES:.0f} ({n_live / max(n_unique, 1):.2f} reads per row)")

    bs = sp.block_size
    bpt = SK.TILE // bs
    n_tiles = pad_budget // SK.TILE
    ub = SO.block_upper_bounds(sp.blk_mbr, sp.blk_max_amp, sp.blk_max_mass, b0.rects, b0.amps)
    win_ub, _ = SO.window_block_bounds(ub, block_starts, bounds, n_tiles, bs)
    win_ub = win_ub.contiguous()
    floor = torch.zeros((BATCH,), dtype=torch.float32, device=dev)
    pargs = (block_starts, bounds, floor, win_ub, qr, qa, store, pad_budget,
             budgets.max_candidates, bpt)
    _, scored = SK.sweep_score_pruned_planar(*pargs)
    scored_pos = scored.bool().repeat_interleave(bs, dim=2) & (pos < T)  # [B, k, pad_budget]
    touched.zero_()
    touched[pos[scored_pos]] = True
    n_scored = int(scored_pos.sum())
    kern = lambda: SK.sweep_score_pruned_planar(*pargs)  # noqa: E731
    plain = lambda: SR.sweep_score_pruned_planar_ref(*pargs)  # noqa: E731
    rows.append(("sweep_score_pruned", kern, plain, *op_bound(
        "sweep_score_pruned",
        float(touched.sum()) * STORE_BYTES + n_out * 4.0 + win_ub.numel() * 8.0,
        scored_pos.sum(dim=(1, 2)))))
    say(f"phase 4: pruned kernel scores {n_scored} of {n_out} window positions")
    # its two launches alone (the walk rereads the scores the score pass
    # left, and zeroes the same blocks on every run), and the speculative
    # blocks: bound above the floor, so scored in pass 1, but not above θ,
    # so zeroed in pass 2
    live = win_ub > floor[:, None, None]
    n_spec = int((live & (scored == 0)).sum())
    # the walk's steps: tiles in which some block beats θ (one barrier each)
    n_fold = int(scored.reshape(BATCH, -1, bpt).bool().any(dim=2).sum())
    outs = (torch.empty((*block_starts.shape, pad_budget), dtype=torch.float32, device=dev),
            torch.empty_like(scored))
    pass_ms = [time_ms(lambda: SK.sweep_score_pruned_planar(*pargs, passes=1, outputs=outs), torch)]
    pass_ms.append(time_ms(lambda: SK.sweep_score_pruned_planar(*pargs, passes=2, outputs=outs),
                           torch))
    exact(outs[1], scored, "sweep_score_pruned flags, passes timed alone", torch)
    say(f"phase 4: sweep_score_pruned: pass 1 (gated score) {pass_ms[0]:.4f} ms, pass 2 "
        f"(θ walk, ring of {SK.RING} tiles) {pass_ms[1]:.4f} ms; blocks: {win_ub.numel()} in "
        f"all, {win_ub.numel() - int(live.sum())} gated by the floor (not scored), "
        f"{int(scored.sum())} scored, {n_spec} speculative (scored in pass 1, zeroed in pass 2); "
        f"{n_fold} of {BATCH * block_starts.shape[1] * n_tiles} tiles fold")

    # text_probe at the main path's inputs: batch 0 on the impact/int8
    # store (f16 impacts, monotone cut).  Bound: the scored blocks' impact
    # rows and block positions, the ub/lens inputs and the full outputs;
    # 2 f32 operations per scored posting plus the θ read over the
    # cb·1024-slot buffer at every tile a query walks
    tx = idx_int8.text
    _, start, nblk, rest, floor = text_first_bounds(
        tx, idx_int8.spatial, idx_int8.pagerank, b0.terms, pr, weights)
    n_win = TO.window_size(tx.max_term_blocks)
    w32 = torch.tensor(weights.w_text, dtype=torch.float32, device=dev)
    ub_w, lens_w, active = TO.window_term_bounds(
        tx.blk_max_impact, tx.blk_len, start, nblk, w32, rest, n_win)
    targs = (tx.impacts, tx.blk_pos, start, nblk, ub_w.contiguous(), lens_w.contiguous(),
             weights.w_text, rest, floor, budgets.max_candidates, True)
    _, tscored = TK.text_probe_planar(*targs)
    sc_blk = tscored.reshape(BATCH, n_win).bool()
    n_tpos = int(torch.where(sc_blk, lens_w, 0).sum())
    # tiles walked: up to the driver's last block, or (monotone) one past
    # the first tile with a failing bound, whose θ read ends the walk
    fail = (active & ~sc_blk).reshape(BATCH, -1, TK.BLOCK_ROWS).any(dim=2)
    first_fail = torch.where(fail.any(dim=1), fail.int().argmax(dim=1), n_win)
    walked = torch.minimum(-(-nblk.long() // TK.BLOCK_ROWS), first_fail + 2)
    cb = TK.buffer_tiles(budgets.max_candidates)
    t_bytes = (n_tpos * tx.impacts.element_size() + int(sc_blk.sum()) * 4
               + BATCH * n_win * 8 + BATCH * n_win * (TK.LANES * 4 + 4))
    t_ops = 2 * n_tpos + int(walked.sum()) * cb * TK.TILE
    rows.append(("text_probe", lambda: TK.text_probe_planar(*targs),
                 lambda: TR.text_probe_planar_ref(*targs), *bound_ms(t_bytes, t_ops)))
    say(f"phase 4: text_probe scores {n_tpos} postings in {int(sc_blk.sum())} of "
        f"{int(active.sum())} driver blocks; {int(walked.sum())} tiles walked")

    # bitmap_and_popcount over 8 bitmap rows: d·W·4 bytes read, W·8
    # written; d−1 ANDs and a popcount per word at the INT32 rate
    rows8 = bm[:8].contiguous()
    W = rows8.shape[1]
    rows.append(("bitmap_and_popcount", lambda: BK.bitmap_and_popcount_cuda(rows8),
                 lambda: BR.bitmap_and_popcount_ref(rows8),
                 *bound_ms(8 * W * 4 + W * 8, 8 * W, INT32_OPS_PER_S)))

    # the launch floor: a 1-element fill_, timed as the kernels are; a
    # kernel whose bound is below it is held to max(bound, floor)
    one = torch.empty(1, dtype=torch.float32, device=dev)
    floor_ms, floor_us = device_ms(lambda: one.fill_(1.0), torch)
    say(f"phase 4: launch floor (a 1-element fill_): device {floor_ms:.4f} ms, host "
        f"{floor_us:.2f} us per call ({DEVICE_LAUNCHES} back-to-back launches)")
    table = []
    for name, kern, plain, b_ms, b_by in rows:
        k_out, p_out = kern(), plain()
        for x, y in zip(k_out if isinstance(k_out, tuple) else (k_out,),
                        p_out if isinstance(p_out, tuple) else (p_out,)):
            if x.dtype == torch.uint32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            max_err[name] = max(max_err[name], exact(x, y, f"{name} at timing shapes", torch))
        ms_kernel = time_ms(kern, torch)
        ms_device, us_host = device_ms(kern, torch)
        ms_plain = time_ms(plain, torch, runs=RUNS)
        src, replaces = SOURCES[name]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_counts[name], "max_abs_err": max_err[name],
            "ms": ms_kernel, "device_ms": ms_device, "host_us": us_host, "plain_ms": ms_plain,
            "bound_ms": b_ms, "bound_by": b_by, "floor_ms": floor_ms, "library_ms": None,
        })
        say(f"phase 4: {name}: kernel {ms_kernel:.4f} ms (events around one call), device "
            f"{ms_device:.4f} ms ({DEVICE_LAUNCHES} back-to-back launches; host {us_host:.2f} us "
            f"per call), plain {ms_plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); device / "
            f"max(bound, floor) {ms_device / max(b_ms, floor_ms):.3f}; {main_counts[name]} "
            f"launches in {kernel_batches[name]} batches (or prefilter calls) that reach it")
    # the prefilter: one count-only launch per call, against the two steps
    # it replaced (the kernel's outputs, then counts.sum())
    pre = (device_ms(lambda: BK.conjunction_count_cuda(rows8), torch),
           device_ms(lambda: BK.bitmap_and_popcount_cuda(rows8)[1].sum(), torch))
    say(f"phase 4: conjunction prefilter over 8 rows: one count-only launch {pre[0][0]:.4f} ms "
        f"device, {pre[0][1]:.2f} us host per call; the kernel + counts.sum() {pre[1][0]:.4f} "
        f"ms device, {pre[1][1]:.2f} us host")
    # geo_score at phase 9's retrieval shape (1,000,000 candidates x
    # GEO_RECTS rects, 2 query rects), timed both ways
    geo = recsys_geo(1_000_000, 0.08, GEO_Q_RECTS, dev)
    flat_r, flat_a = geo["cand_rects"].reshape(1, -1, 4), geo["cand_amps"].reshape(1, -1)
    gqr, gqa = pad_query(geo["q_rects"][None], geo["q_amps"][None])
    kern = lambda: GK.geo_score_cuda(flat_r, flat_a, gqr, gqa)  # noqa: E731
    exact(kern(), GR.geo_score_toeprints_ref(flat_r, flat_a, gqr, gqa),
          "geo_score kernel at the retrieval shape", torch)
    n_tp = flat_a.numel()
    b_ms, b_by = bound_ms(n_tp * (STORE_BYTES + 4.0), n_tp * (OPS_PER_SLOT * len(GEO_Q_RECTS) + 1))
    ms_device, us_host = device_ms(kern, torch)
    retrieval = {"ms": time_ms(kern, torch), "device_ms": ms_device, "host_us": us_host,
                 "bound_ms": b_ms, "bound_by": b_by}
    table[[r["name"] for r in table].index("geo_score")]["retrieval_shape"] = retrieval
    say(f"phase 4: geo_score at the retrieval shape ({n_tp} rects, {len(GEO_Q_RECTS)} query "
        f"rects): kernel {retrieval['ms']:.4f} ms (events around one call), device "
        f"{ms_device:.4f} ms ({DEVICE_LAUNCHES} back-to-back launches; host {us_host:.2f} us "
        f"per call), bound {b_ms:.4f} ms ({b_by}); bound / kernel "
        f"{b_ms / retrieval['ms']:.3f}, bound / device {b_ms / ms_device:.3f}")
    del geo, flat_r, flat_a
    for name, times in latency.items():
        say(f"phase 4: {name}: batch latency median {1e3 * statistics.median(times):.2f} ms, "
            f"{len(times) * BATCH / sum(times):.1f} queries/s")
    # ---- phase 6: the serving stack at size, before the profiler pass ----
    serve_counts = serving_phase(corpus, plain_ex.engine.index, budgets)
    # ---- phase 7: document-sharded serving, before the profiler pass ----
    shard_counts, executors["sharded_footprint"], (mesh_ex, narrow) = sharded_phase(
        corpus, budgets, batches, stacked["dir"])
    # ---- phase 16: the serve step across processes, on phase 7's index --
    proc_counts = process_mesh_phase(mesh_ex, batches + [narrow], budgets)
    del mesh_ex
    torch.cuda.empty_cache()
    # ---- phase 8: telemetry and the serving CLI, before the profiler pass
    tel_counts = telemetry_phase(corpus, plain_ex.engine.index, budgets,
                                 executors["sharded_footprint"][0])
    peak = torch.cuda.max_memory_allocated()
    # ---- phase 9: the recsys serving path, before the profiler pass -----
    rec_counts = recsys_phase()
    torch.cuda.empty_cache()  # phase 9's cells are freed
    # ---- phase 10: recsys training, before the profiler pass ------------
    train_counts = training_phase()
    torch.cuda.empty_cache()
    # ---- phase 11: the geo examples and the geoweb cells ----------------
    example_counts = examples_phase()
    torch.cuda.empty_cache()
    # ---- phase 12: dense LM serving at published widths -----------------
    lm_phase()
    torch.cuda.empty_cache()
    # ---- phase 13: the MoE LMs and LM training ---------------------------
    moe_train_phase()
    torch.cuda.empty_cache()
    # ---- phase 14: EGNN --------------------------------------------------
    egnn_phase()
    torch.cuda.empty_cache()
    # ---- phase 15: the dry-run and roofline tooling ----------------------
    roofline_phase(dry)
    torch.cuda.empty_cache()
    # ---- phase 17: the train-side collectives across processes -----------
    train_collectives_phase()
    torch.cuda.empty_cache()
    for row in table:
        main_counts[row["name"]] += (serve_counts[row["name"]] + shard_counts[row["name"]]
                                     + proc_counts[row["name"]]
                                     + tel_counts[row["name"]] + rec_counts[row["name"]]
                                     + train_counts[row["name"]] + example_counts[row["name"]])
        row["launches"] = main_counts[row["name"]]
    # ---- phase 5: one profiler pass per variant, after every timing, so
    # no profiler session runs before or during a timed run ---------------
    for name, (ex, algorithm) in executors.items():
        for line in profile_batch(lambda: ex.run(batches[0]), torch, SPANS[algorithm]):
            say(f"phase 5: {name}: profile (batch 0): {line}")
    for name, lines in recsys_profiles():
        for line in lines:
            say(f"phase 5: {name}: profile: {line}")
    for name, lines in lm_profiles():
        for line in lines:
            say(f"phase 5: {name}: profile: {line}")
    for name, lines in egnn_profiles():
        for line in lines:
            say(f"phase 5: {name}: profile: {line}")
    say(f"peak device memory of phases 1-8 {peak / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serving_phase(corpus, index, budgets) -> dict[str, int]:
    """Phase 6: ``GeoServer`` over ``index`` at serve.py's defaults, three
    runs and their twin replays (see the module docstring).  Returns the
    kernel launches of the three runs (the twin replays compare kernels
    with their plain versions and are not counted)."""
    import numpy as np
    import torch

    from repro_torch.core import GeoSearchEngine
    from repro_torch.corpus import (
        make_mixture_trace,
        make_zipf_trace,
        pad_trace_batch,
        stamp_arrivals,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import DeadlineBatcher, GeoServer, SingleDeviceExecutor, make_cache

    t_phase = time.perf_counter()
    pr = replace(budgets, prune=True)
    t = time.perf_counter()
    zipf = make_zipf_trace(corpus, n_queries=SERVE_QUERIES, pool_size=SERVE_POOL, seed=1)
    mixture = make_mixture_trace(corpus, n_queries=SERVE_QUERIES, seed=1)
    say(f"phase 6: zipf and mixture traces of {SERVE_QUERIES} queries in "
        f"{time.perf_counter() - t:.1f} s")
    # (budgets, algorithm, trace, arrival): serve.py --fused;
    # --prune --fused --arrival poisson; --algorithm auto --prune --fused
    # --trace mixture
    runs = {
        "serve_fused": (budgets, "k_sweep", zipf, "closed"),
        "serve_pruned_poisson": (
            pr, "k_sweep",
            stamp_arrivals(zipf, "poisson", rate_qps=RATE_QPS, seed=STAMP_SEED), "poisson"),
        "serve_auto_mixture": (pr, "auto", mixture, "closed"),
    }
    # the kernel each planned label reaches (geo_first reaches none)
    kernel_of = {"k_sweep+prune+fused": "sweep_score_pruned",
                 "text_first+prune+fused": "text_probe"}
    totals = dict.fromkeys(launch_counts(), 0)

    def kernels_used(rep, b, algorithm):
        if algorithm == "auto":
            return {kernel_of[label] for label in rep.plan_queries if label in kernel_of}
        return {"sweep_score_pruned" if b.prune else "sweep_score"}

    def launched(counts, used, what):
        """Every batch of a kernel's plan launches it once (the warm-up's
        inert batches too); no other kernel launches."""
        for k, n in counts.items():
            check(n >= 1 if k in used else n == 0, f"{what}: {k} launched {n} times")

    def server(ex, open_loop):
        return GeoServer(ex, cache=make_cache("landlord", CACHE_CAPACITY),
                         batcher=DeadlineBatcher(max_batch=BATCH, max_terms=8, max_rects=4,
                                                 max_wait_s=OPEN_WAIT_S if open_loop
                                                 else float("inf")))

    def decomposes(rep, n, what):
        check(rep.n_queries == n and len(rep.latencies_s) == n, f"{what}: queries {rep.n_queries}")
        check(rep.cache_hits + rep.cache_misses == n, f"{what}: hits + misses")
        total = (np.asarray(rep.batch_wait_s) + np.asarray(rep.queue_wait_s)
                 + np.asarray(rep.service_s))
        err = float(np.abs(total - np.asarray(rep.latencies_s)).max())
        check(err <= 1e-9, f"{what}: batch-wait + queue-wait + service off by {err}")

    for name, (b, algorithm, trace, arrival) in runs.items():
        eng = GeoSearchEngine.from_index(index, b)
        kernel_ex = SingleDeviceExecutor(eng, algorithm, fused=True)
        open_loop = arrival != "closed"
        srv = server(kernel_ex, open_loop)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        rep = srv.run_trace(trace, arrival=arrival)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = launch_counts()
        for k, n in counts.items():
            totals[k] += n
        decomposes(rep, len(trace), name)
        launched(counts, kernels_used(rep, b, algorithm), name)
        for line in rep.summary().splitlines():
            say(f"phase 6: {name}: {line}")
        summary = {
            "queries": rep.n_queries, "run_s": run_s, "qps": rep.qps,
            "p50_ms": rep.percentile_ms(50), "p99_ms": rep.percentile_ms(99),
            "hit_rate": rep.hit_rate, "padding": rep.padding_overhead,
            "batches": rep.n_batches, "shapes": rep.n_compiled_shapes,
            "launches": {k: n for k, n in counts.items() if n},
        }
        if open_loop:
            summary["stages_ms"] = {
                stage: [rep.stage_percentile_ms(stage, 50), rep.stage_percentile_ms(stage, 99)]
                for stage in ("batch_wait", "queue_wait", "service")}
        if algorithm == "auto":
            summary["plans"] = {
                label: [n, rep.plan_percentile_ms(label, 50), rep.plan_percentile_ms(label, 99)]
                for label, n in sorted(rep.plan_queries.items())}
            # serve.py's recall probe: the trace's first 64 queries
            summary["recall_at_10"] = eng.recall_at_k(
                pad_trace_batch(trace[:RECALL_PROBE]), "auto", fused=True)
        say(f"phase 6: {name}: " + json.dumps(summary))

        # the twin replay: kernel executor vs its plain twin, same engine
        twin = stamp_arrivals(trace[:TWIN_QUERIES], "poisson", rate_qps=TWIN_RATE_QPS,
                              seed=STAMP_SEED)
        reps, twin_counts = [], []
        t = time.perf_counter()
        for ex in (kernel_ex, SingleDeviceExecutor(eng, algorithm)):
            torch.cuda.synchronize()
            reset_launch_counts()
            reps.append(server(ex, True).run_trace(
                twin, arrival="poisson", collect_results=True,
                service_time=lambda raw: TWIN_SERVICE_S))
            torch.cuda.synchronize()
            twin_counts.append(launch_counts())
        kern, plain = reps
        decomposes(kern, len(twin), f"{name} twin")
        launched(twin_counts[0], kernels_used(kern, b, algorithm), f"{name} twin (kernels)")
        launched(twin_counts[1], set(), f"{name} twin (plain)")

        def unfused(d):
            return {label.replace("+fused", ""): v for label, v in d.items()}

        for f in ("n_queries", "wall_s", "cache_hits", "cache_misses", "coalesced",
                  "n_batches", "pad_slots", "real_slots", "element_padding_overhead",
                  "shapes_used", "stats", "latencies_s", "batch_wait_s", "queue_wait_s",
                  "service_s", "batch_events"):
            check(getattr(kern, f) == getattr(plain, f), f"{name} twin: {f} differs")
        for f in ("plan_queries", "plan_latencies_s", "plan_stats"):
            check(unfused(getattr(kern, f)) == getattr(plain, f), f"{name} twin: {f} differs")
        for i, (x, y) in enumerate(zip(kern.results, plain.results)):
            check(np.array_equal(x.ids, y.ids)
                  and np.array_equal(x.scores.view(np.uint32), y.scores.view(np.uint32)),
                  f"{name} twin: query {i} result differs")
        say(f"phase 6: {name} twin: {len(twin)} queries at {TWIN_RATE_QPS:g}/s, "
            f"{kern.n_batches} batches, {kern.cache_hits} hits; kernel launches "
            f"{ {k: n for k, n in twin_counts[0].items() if n} }, plain none; reports and "
            f"every query's ids and scores equal (bitwise) in {time.perf_counter() - t:.1f} s")
    say(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    return totals


def sharded_phase(corpus, budgets, batches, stacked_dir) -> tuple[dict[str, int], tuple, tuple]:
    """Phase 7: the sharded and mesh executors over 8 region shards of the
    phase-3 corpus (see the module docstring), the mesh's stacked index
    read from ``stacked_dir`` (:func:`build_stacked_index`).  Returns the kernel launches
    of the runs a user's entry points make — the footprint-routed trace,
    the one-batch kernel variants, the served trace and the mesh; the
    broadcast and plain-twin comparisons are not counted —, the sharded
    executor with its algorithm, for phase 5's profile, and the mesh
    executor with the narrow batch, for phase 16."""
    import numpy as np
    import torch

    from repro_torch.core import QueryPlan, RegionRangePartitioner, ShardedGeoIndex, make_mesh
    from repro_torch.corpus import make_zipf_trace
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.geo_score.ops import geo_score_toeprints
    from repro_torch.serving import (
        DeadlineBatcher,
        GeoServer,
        MeshExecutor,
        ShardedExecutor,
        make_cache,
        make_executor,
    )

    t_phase = time.perf_counter()
    pr = replace(budgets, prune=True)
    totals = dict.fromkeys(launch_counts(), 0)

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    def counted(counts, used, what, add=True):
        """Only ``used`` kernels launched, each as often as given."""
        for k, n in counts.items():
            check(n == used.get(k, 0), f"{what}: {k} launched {n} times, expected "
                  f"{used.get(k, 0)}")
            if add:
                totals[k] += n

    def host_equal(a, b, what, counters=True):
        """Host results equal: ids exactly, scores bitwise (−inf included),
        and every counter exactly."""
        check(np.array_equal(a.ids, b.ids), f"{what}: ids differ")
        check(np.asarray(a.scores).tobytes() == np.asarray(b.scores).tobytes(),
              f"{what}: scores differ")
        if counters:
            check(set(a.stats) == set(b.stats), f"{what}: stats keys differ")
            for k in a.stats:
                check(np.array_equal(a.stats[k], b.stats[k]), f"{what}: stats[{k}] differs")

    def run_all(ex, runs, plan=None):
        sync()
        reset_launch_counts()
        outs, times = [], []
        for b in runs:
            t = time.perf_counter()
            outs.append(ex.run(b, plan=plan))
            sync()
            times.append(time.perf_counter() - t)
        return outs, launch_counts(), times

    t = time.perf_counter()
    # serve.py --shards 8 --partition region --routing footprint --prune --fused
    ex = make_executor("sharded", corpus, n_shards=8, partitioner=RegionRangePartitioner(),
                       routing="footprint", fused=True, budgets=pr, device=DEVICE)
    engines, gids = ex.engines, ex.global_ids
    sizes = [len(g) for g in gids]
    tps = [e.index.spatial.n_toeprints for e in engines]
    say(f"phase 7: 8 region shards built in {time.perf_counter() - t:.1f} s; docs per shard "
        f"{min(sizes)}-{max(sizes)}, toe prints per shard {min(tps)}-{max(tps)}")
    broadcast = ShardedExecutor(engines, gids, "k_sweep", routing="broadcast", fused=True)
    plain = ShardedExecutor(engines, gids, "k_sweep", routing="footprint")

    # the 256-query trace through the footprint-routed kernel executor
    ex.run(batches[0])  # warm-up
    outs, counts, times = run_all(ex, batches)
    visited = [int(o.stats["shards_visited"]) for o in outs]
    touched = np.concatenate([o.stats["shards_touched"] for o in outs])
    counted(counts, {"sweep_score_pruned": sum(visited)}, "sharded footprint")
    for o in outs:
        ids = np.asarray(o.ids)
        check(ids.shape == (BATCH, budgets.top_k), "sharded: ids shape")
        check(bool(((ids >= -1) & (ids < N_DOCS)).all()), "sharded: ids out of range")
        check(bool(np.isfinite(np.asarray(o.scores)[ids >= 0]).all()), "sharded: non-finite score")
    say(f"phase 7: sharded footprint: {len(batches)} batches of {BATCH}; shards visited per "
        f"batch {visited}; shards touched per query mean {touched.mean():.4f}; launches "
        f"{ {k: n for k, n in counts.items() if n} } (one per visited shard per batch); batch "
        f"latency median {1e3 * statistics.median(times):.2f} ms, "
        f"{len(times) * BATCH / sum(times):.1f} queries/s")
    b_outs, b_counts, b_times = run_all(broadcast, batches)
    counted(b_counts, {"sweep_score_pruned": 8 * len(batches)}, "sharded broadcast", add=False)
    for i, (x, y) in enumerate(zip(outs, b_outs)):
        host_equal(x, y, f"footprint vs broadcast batch {i}", counters=False)
    say(f"phase 7: footprint == broadcast in ids and scores (bitwise); broadcast batch latency "
        f"median {1e3 * statistics.median(b_times):.2f} ms, "
        f"{len(b_times) * BATCH / sum(b_times):.1f} queries/s")
    p_outs, p_counts, _ = run_all(plain, batches)
    counted(p_counts, {}, "sharded plain twin", add=False)
    for i, (x, y) in enumerate(zip(outs, p_outs)):
        host_equal(x, y, f"sharded kernel vs plain batch {i}")
    say("phase 7: sharded kernel executor == plain twin in ids, scores and every counter")

    # the trace's batches reach nearly every shard; a narrow batch makes
    # footprint routing skip some: copies of the trace's first query whose
    # footprint, cut to the middle fifth of its first rect, misses a shard
    cands = (narrow_batch(b, i, BATCH) for b in batches for i in range(BATCH))
    nb = next((b for b in cands if ex.route_batch(b)[0].sum() < 8), None)
    check(nb is not None, "narrow batch: every cut footprint of the trace reaches all 8 shards")
    n_outs, n_counts, n_times = run_all(ex, [nb])
    narrow_vis = int(n_outs[0].stats["shards_visited"])
    check(narrow_vis < 8, f"narrow batch: {narrow_vis} shards visited")
    counted(n_counts, {"sweep_score_pruned": narrow_vis}, "sharded narrow")
    nb_outs, nb_counts, _ = run_all(broadcast, [nb])
    counted(nb_counts, {"sweep_score_pruned": 8}, "sharded narrow broadcast", add=False)
    host_equal(n_outs[0], nb_outs[0], "narrow footprint vs broadcast", counters=False)
    np_outs, np_counts, _ = run_all(plain, [nb])
    counted(np_counts, {}, "sharded narrow plain twin", add=False)
    host_equal(n_outs[0], np_outs[0], "narrow kernel vs plain")
    say(f"phase 7: narrow batch ({BATCH} copies of one cut footprint): {narrow_vis} of 8 shards "
        f"visited, sweep_score_pruned launched {n_counts['sweep_score_pruned']} times; "
        f"{int((np.asarray(n_outs[0].ids) >= 0).sum())} live ids; batch latency "
        f"{1e3 * n_times[0]:.2f} ms; footprint == broadcast (bitwise) and kernel == plain twin")

    # one batch each of the other kernels through the same shards: fused and
    # geo-score K-SWEEP with early termination (their scores pick the
    # candidates), and pruned fused TEXT-FIRST
    et = replace(engines[0].budgets, prune=False, early_termination=True)
    one = [
        ("fused_et", ShardedExecutor(engines, gids, "k_sweep", routing="footprint"),
         QueryPlan("k_sweep", et, fused=True), QueryPlan("k_sweep", et), "sweep_score"),
        ("geo_score_et", ShardedExecutor(engines, gids, "k_sweep", routing="footprint",
                                         tp_scorer=geo_score_toeprints),
         QueryPlan("k_sweep", et), QueryPlan("k_sweep", et), "geo_score"),
        ("tf_pruned", ShardedExecutor(engines, gids, "text_first", routing="footprint"),
         QueryPlan("text_first", engines[0].budgets, fused=True),
         QueryPlan("text_first", engines[0].budgets), "text_probe"),
    ]
    for name, kern_ex, kplan, pplan, kernel in one:
        k_out, k_counts, _ = run_all(kern_ex, batches[:1], kplan)
        n_vis = int(k_out[0].stats["shards_visited"])
        counted(k_counts, {kernel: n_vis}, f"sharded {name}")
        twin = ShardedExecutor(engines, gids, kplan.algorithm, routing="footprint")
        p_out, p_counts, _ = run_all(twin, batches[:1], pplan)
        counted(p_counts, {}, f"sharded {name} plain twin", add=False)
        host_equal(k_out[0], p_out[0], f"sharded {name} vs plain")
        say(f"phase 7: sharded {name} (batch 0) == plain twin in ids, scores and every counter; "
            f"{kernel} launched {k_counts[kernel]} times ({n_vis} visited shards)")

    # GeoServer over the sharded executor at serve.py's defaults
    zipf = make_zipf_trace(corpus, n_queries=SERVE_QUERIES, pool_size=SERVE_POOL, seed=1)
    srv = GeoServer(ex, cache=make_cache("landlord", CACHE_CAPACITY),
                    batcher=DeadlineBatcher(max_batch=BATCH, max_terms=8, max_rects=4,
                                            max_wait_s=float("inf")))
    # the warm-up runs one inert batch per predicted shape, broadcast to
    # all 8 shards
    n_shapes = len(srv._predict_shapes(zipf, open_loop=False))
    sync()
    reset_launch_counts()
    t = time.perf_counter()
    rep = srv.run_trace(zipf, arrival="closed")
    sync()
    run_s = time.perf_counter() - t
    counts = launch_counts()
    check(rep.n_queries == len(zipf) and rep.cache_hits + rep.cache_misses == len(zipf),
          "serve_sharded_footprint: query count")
    label = ex.algorithm  # a fixed-algorithm executor's batches carry its name
    r = rep.routing.get(label)
    check(r is not None and r["batches"] == rep.n_batches, "serve_sharded_footprint: routing")
    # each live batch launches once per visited shard, each warm-up batch
    # once per shard
    check(rep.n_compiled_shapes == n_shapes,
          f"serve_sharded_footprint: {rep.n_compiled_shapes} shapes run, {n_shapes} predicted")
    counted(counts, {"sweep_score_pruned": int(r["shards_visited"]) + 8 * n_shapes},
            "serve_sharded_footprint")
    for line in rep.summary().splitlines():
        say(f"phase 7: serve_sharded_footprint: {line}")
    say("phase 7: serve_sharded_footprint: " + json.dumps({
        "queries": rep.n_queries, "run_s": run_s, "qps": rep.qps,
        "p50_ms": rep.percentile_ms(50), "p99_ms": rep.percentile_ms(99),
        "hit_rate": rep.hit_rate, "padding": rep.padding_overhead,
        "batches": rep.n_batches, "shapes": rep.n_compiled_shapes,
        "shards_touched_mean": rep.routing_mean(label),
        "shards_visited_per_batch": r["shards_visited"] / max(r["batches"], 1),
        "warmup_batches": n_shapes,
        "launches": {k: n for k, n in counts.items() if n}}))

    # the mesh step over the same partitioning, stacked on the card
    t = time.perf_counter()
    fields = torch.load(Path(stacked_dir, "index.pt"), mmap=True, weights_only=True)
    stacked = ShardedGeoIndex(**{k: v.to(DEVICE) if isinstance(v, torch.Tensor) else v
                                 for k, v in fields.items()})
    mesh_ex = MeshExecutor.from_index(make_mesh((8, 1), ("data", "model"), device=DEVICE),
                                      stacked, budgets=pr, fused=True, routing="footprint")
    del fields, stacked
    say(f"phase 7: mesh (8, 1) data x model: stacked index (built on the host before phase "
        f"1) loaded in {time.perf_counter() - t:.1f} s; {mesh_ex.index.tp_rects.shape[1]} "
        f"toe-print rows per shard")
    mesh_ex.run(batches[0])  # warm-up
    m_outs, m_counts, m_times = run_all(mesh_ex, batches)
    # every shard runs the step on every batch (the SPMD twin); untouched
    # (query, shard) pairs are masked
    counted(m_counts, {"sweep_score_pruned": 8 * len(batches)}, "mesh")
    mn_outs, mn_counts, _ = run_all(mesh_ex, [nb])
    counted(mn_counts, {"sweep_score_pruned": 8}, "mesh narrow")
    check(float(mn_outs[0].stats["shards_visited"][0]) == narrow_vis,
          "mesh narrow: shards visited differ from the sharded executor's")

    def by_score(ids, scores):
        o = np.lexsort((ids, -scores), axis=-1)
        return np.take_along_axis(ids, o, -1), np.take_along_axis(scores, o, -1)

    for i, (m, h) in enumerate(zip(m_outs + mn_outs, outs + n_outs)):
        mi, ms = by_score(m.ids.cpu().numpy(), m.scores.cpu().numpy())
        hi, hs = by_score(np.asarray(h.ids), np.asarray(h.scores))
        check(np.array_equal(mi, hi) and ms.tobytes() == hs.tobytes(),
              f"mesh vs sharded batch {i}: ids or scores differ")
        check(set(m.stats) == set(h.stats), f"mesh vs sharded batch {i}: stats keys")
        for k in h.stats:
            a = float(np.asarray(m.stats[k], np.float64).sum())
            b = float(np.asarray(h.stats[k], np.float64).sum())
            check(abs(a - b) <= 1e-6 * abs(b), f"mesh vs sharded batch {i}: stats[{k}] {a} vs {b}")
    say(f"phase 7: mesh == sharded in ids and scores (rows sorted by -score, id) and counter "
        f"sums (rtol 1e-6), the narrow batch included; launches { {k: n for k, n in m_counts.items() if n} }; batch latency "
        f"median {1e3 * statistics.median(m_times):.2f} ms, "
        f"{len(m_times) * BATCH / sum(m_times):.1f} queries/s")
    say(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    return totals, (ex, ex.algorithm), (mesh_ex, nb)


def _mesh_rank(rank: int, tmp: str, budgets, device: str) -> dict:
    """Phase 16 (a), one rank of the process mesh: the stacked index from
    ``tmp``, cut to the rank's row by ``MeshExecutor.from_index``; rank 0
    runs the batches (a warm-up, then each timed) and closes, the others
    follow.  Every rank counts its own launches from after its build."""
    import numpy as np
    import torch

    from repro_torch.core import ShardedGeoIndex, make_process_mesh
    from repro_torch.core.algorithms import QueryBatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import MeshExecutor

    torch.set_num_threads(1)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    mesh = make_process_mesh(PROC_MESH, PROC_AXES, device=None if device == "cuda" else device)
    stacked = ShardedGeoIndex(**torch.load(Path(tmp, "index.pt"), mmap=True, weights_only=True))
    ex = MeshExecutor.from_index(mesh, stacked, budgets=budgets, fused=True, routing="footprint")
    del stacked
    sync()
    out = {"ready": time.time(), "device": str(mesh.device)}
    reset_launch_counts()
    if mesh.rank:
        out["batches"] = ex.serve_forever()
        sync()
        out["launches"] = launch_counts()
        return out
    batches = [QueryBatch(*a) for a in torch.load(Path(tmp, "batches.pt"), weights_only=True)]
    try:
        ex.run(batches[0])  # warm-up
        sync()
        out["times"], out["results"] = [], []
        for b in batches:
            t = time.perf_counter()
            r = ex.run(b)
            sync()
            out["times"].append(time.perf_counter() - t)
            out["results"].append((r.ids.cpu().numpy(), r.scores.cpu().numpy(),
                                   {k: np.asarray(v) for k, v in r.stats.items()}))
    finally:
        ex.close()
    out["batches"] = len(batches) + 1
    out["launches"] = launch_counts()
    return out


def _geoweb_rank(rank: int, device: str) -> tuple:
    """Phase 16 (b): the geoweb SMOKE ``serve_ksweep`` cell on a (1, 1)
    process mesh."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.core import make_process_mesh
    from repro_torch.launch.steps import build_cell

    mesh = make_process_mesh((1, 1), ("data", "model"), device=None if device == "cuda" else device)
    spec = get_arch("geoweb")
    shape = next(s for s in spec.shapes if s.name == "serve_ksweep")
    cell = build_cell(dataclasses.replace(spec, config=spec.smoke_config), shape, mesh)
    ids, scores, stats = cell.fn(*cell.args)
    return (str(mesh.device), ids.cpu().numpy(), scores.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in stats.items()})


def process_mesh_phase(mesh_ex, batches, budgets) -> dict[str, int]:
    """Phase 16: the serve step across processes (see the module
    docstring).  Returns the process mesh's kernel launches, summed over
    its ranks; the one-card loop it is held to is not counted."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core import make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.steps import build_cell
    from repro_torch.serving import MeshExecutor

    t_phase = time.perf_counter()
    pr = replace(budgets, prune=True)
    n_ranks = math.prod(PROC_MESH)
    totals = dict.fromkeys(launch_counts(), 0)

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    # (a) the (2, 4, 1) process mesh under gloo, every rank on the card
    idx = mesh_ex.index
    fields = {f.name: getattr(idx, f.name) for f in dataclasses.fields(idx)}
    index_mib = sum(v.nbytes for v in fields.values() if isinstance(v, torch.Tensor)) / 2**20
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ranks-")
    try:
        t = time.perf_counter()
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in fields.items()},
                   Path(tmp, "index.pt"))
        torch.save([(b.terms.cpu(), b.rects.cpu(), b.amps.cpu()) for b in batches],
                   Path(tmp, "batches.pt"))
        save_s = time.perf_counter() - t
        t0, t = time.time(), time.perf_counter()
        outs = run_ranks(_mesh_rank, n_ranks, args=(tmp, pr, DEVICE), backend="gloo",
                         timeout_s=PROC_TIMEOUT_S)
        ranks_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    start_s = [o["ready"] - t0 for o in outs]
    say(f"phase 16 (a): {n_ranks} gloo ranks on {sorted({o['device'] for o in outs})}, mesh "
        f"{dict(zip(PROC_AXES, PROC_MESH))}: the stacked index ({index_mib:.1f} MiB) "
        f"saved in {save_s:.1f} s; rank start-up (spawn, group, index row on the card) "
        f"{min(start_s):.1f}-{max(start_s):.1f} s; the ranks' whole run {ranks_s:.1f} s")
    per_rank = [o["launches"] for o in outs]
    for r, (o, counts) in enumerate(zip(outs, per_rank)):
        check(o["batches"] == len(batches) + 1, f"phase 16 (a): rank {r} ran {o['batches']} batches")
        for k, n in counts.items():
            want = len(batches) + 1 if k == "sweep_score_pruned" else 0
            check(n == want, f"phase 16 (a): rank {r} launched {k} {n} times, expected {want}")
            totals[k] += n
    loop = MeshExecutor.from_index(make_mesh(PROC_MESH, PROC_AXES, device=DEVICE), idx,
                                   budgets=pr, fused=True, routing="footprint")
    loop.run(batches[0])  # warm-up
    sync()
    reset_launch_counts()
    loop_times, visited = [], []
    for i, (b, (ids, scores, stats)) in enumerate(zip(batches, outs[0]["results"])):
        t = time.perf_counter()
        want = loop.run(b)
        sync()
        loop_times.append(time.perf_counter() - t)
        w_ids, w_scores = want.ids.cpu().numpy(), want.scores.cpu().numpy()
        check(ids.dtype == w_ids.dtype and np.array_equal(ids, w_ids),
              f"phase 16 (a) batch {i}: ids differ from the one-card loop's")
        check(scores.tobytes() == w_scores.tobytes(),
              f"phase 16 (a) batch {i}: scores differ from the one-card loop's (bitwise)")
        check(list(stats) == list(want.stats), f"phase 16 (a) batch {i}: stats keys differ")
        for k, v in want.stats.items():
            check(stats[k].dtype == v.dtype and stats[k].tobytes() == v.tobytes(),
                  f"phase 16 (a) batch {i}: stats[{k}] differs from the one-card loop's")
        visited.append(float(stats["shards_visited"][0]))
    loop_counts = launch_counts()
    check(loop_counts["sweep_score_pruned"] == n_ranks * len(batches),
          f"phase 16 (a): the loop launched {loop_counts}")
    p_ms = [1e3 * x for x in outs[0]["times"]]
    l_ms = [1e3 * x for x in loop_times]
    say(f"phase 16 (a): process mesh == the one-card loop on the same mesh, bitwise in ids, "
        f"scores and every counter, on {len(batches)} batches of {BATCH} (the trace's "
        f"{len(batches) - 1} and phase 7's narrow one: shards visited {visited}); "
        f"sweep_score_pruned launched {totals['sweep_score_pruned']} times over the ranks "
        f"({[c['sweep_score_pruned'] for c in per_rank]}: one per shard per batch, the warm-up "
        f"included), the loop {loop_counts['sweep_score_pruned']}")
    say("phase 16 (a): per-batch ms, process mesh vs loop: " + json.dumps({
        "process_ms": p_ms, "loop_ms": l_ms,
        "process_median_ms": statistics.median(p_ms), "loop_median_ms": statistics.median(l_ms),
        "startup_s": max(start_s)}))
    del loop

    # (b) NCCL at world size 1: the geoweb SMOKE serve_ksweep cell
    t = time.perf_counter()
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    dev, ids, scores, stats = run_ranks(_geoweb_rank, 1, args=(DEVICE,), backend=backend,
                                        timeout_s=PROC_TIMEOUT_S)[0]
    nccl_s = time.perf_counter() - t
    spec = get_arch("geoweb")
    shape = next(s for s in spec.shapes if s.name == "serve_ksweep")
    cell = build_cell(dataclasses.replace(spec, config=spec.smoke_config), shape,
                      make_mesh((1, 1), ("data", "model"), device=DEVICE))
    w_ids, w_scores, w_stats = cell.fn(*cell.args)
    check(np.array_equal(ids, w_ids.cpu().numpy()), "phase 16 (b): geoweb ids differ")
    check(scores.tobytes() == w_scores.cpu().numpy().tobytes(), "phase 16 (b): geoweb scores differ")
    check(list(stats) == list(w_stats), "phase 16 (b): geoweb stats keys differ")
    for k, v in w_stats.items():
        check(stats[k].tobytes() == v.cpu().numpy().tobytes(), f"phase 16 (b): stats[{k}] differs")
    check(int((ids >= 0).sum()) > 0, "phase 16 (b): no hits")
    say(f"phase 16 (b): {backend} at world size 1 on {dev}: geoweb serve_ksweep (SMOKE, (1, 1) "
        f"process mesh) == the one-card cell (phase 11 (c)'s) bitwise in ids, scores and every "
        f"counter; {int((ids >= 0).sum())} hits; {nccl_s:.1f} s with the rank's start-up")
    say(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return totals


def telemetry_phase(corpus, index, budgets, sharded) -> dict[str, int]:
    """Phase 8: telemetry on the single and sharded serving paths and the
    serving CLI with its export flags (see the module docstring).  Returns
    the kernel launches of (a) and (b), all served through a user's entry
    points (the CLI's run in (c) launches in its own process; its launches
    are printed, not added)."""
    import math
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import GeoSearchEngine
    from repro_torch.corpus import make_mixture_trace, make_zipf_trace
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Telemetry, validate_trace
    from repro_torch.serving import (
        DeadlineBatcher,
        GeoServer,
        ShardedExecutor,
        SingleDeviceExecutor,
        make_cache,
    )

    t_phase = time.perf_counter()
    pr = replace(budgets, prune=True)
    totals = dict.fromkeys(launch_counts(), 0)

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    def serve(ex, trace, tel, cache=True):
        srv = GeoServer(ex, cache=make_cache("landlord", CACHE_CAPACITY) if cache else None,
                        batcher=DeadlineBatcher(max_batch=BATCH, max_terms=8, max_rects=4,
                                                max_wait_s=float("inf")),
                        telemetry=tel)
        sync()
        reset_launch_counts()
        rep = srv.run_trace(trace, arrival="closed", collect_results=True)
        sync()
        for k, n in launch_counts().items():
            totals[k] += n
        return rep

    def same_results(a, b, what):
        """ids and scores bitwise per query; counters, hits, batches, shapes
        and the per-plan tallies exactly (latencies are wall clock)."""
        check(len(a.results) == len(b.results), f"{what}: result count")
        for i, (x, y) in enumerate(zip(a.results, b.results)):
            check(np.array_equal(x.ids, y.ids)
                  and np.array_equal(x.scores.view(np.uint32), y.scores.view(np.uint32)),
                  f"{what}: query {i} result differs")
        for f in ("n_queries", "cache_hits", "cache_misses", "coalesced", "n_batches",
                  "pad_slots", "real_slots", "shapes_used", "stats", "plan_queries",
                  "plan_stats", "routing"):
            check(getattr(a, f) == getattr(b, f), f"{what}: {f} differs")

    def spans_match(rep, tel, what):
        """Stage sums are the report's lists exactly; the trace validates;
        histogram p50/p99 in the report's bucket or the next."""
        check(tel.tracer.stage_sums() == (rep.latencies_s, rep.batch_wait_s,
                                          rep.queue_wait_s, rep.service_s),
              f"{what}: stage sums differ from the report")
        errors = validate_trace(tel.tracer.to_trace_events())
        check(errors == [], f"{what}: trace invalid: {errors[:3]}")
        h = tel.metrics.histogram("server.latency_ms")
        for p in (50, 99):
            check(h.same_or_adjacent_bucket(h.quantile(p), rep.percentile_ms(p)),
                  f"{what}: latency p{p} histogram {h.quantile(p)} vs {rep.percentile_ms(p)}")

    # (a) serve_auto_mixture without and with a handle, best of TEL_RUNS each.
    # Without a cache, as the reference's serve benchmark pairs them: the
    # Landlord cache's credits are wall-clock service costs, so which entry
    # it evicts, and so a later hit, can move between two runs whatever the
    # telemetry (the mixture trace repeats almost nothing: 1 hit in 2048)
    mixture = make_mixture_trace(corpus, n_queries=SERVE_QUERIES, seed=1)
    off_ex = SingleDeviceExecutor(GeoSearchEngine.from_index(index, pr), "auto", fused=True)
    on_ex = SingleDeviceExecutor(GeoSearchEngine.from_index(index, pr), "auto", fused=True)
    # "no_audit": every sink but the planner audit, whose explain() repeats
    # the planner's feature pass per planned query inside the timed loop
    # (the plans themselves are made in the warm-up's shape prediction)
    no_audit_ex = SingleDeviceExecutor(GeoSearchEngine.from_index(index, pr), "auto", fused=True)
    runs = {"off": [], "on": [], "no_audit": []}
    for _ in range(TEL_RUNS):
        runs["off"].append((serve(off_ex, mixture, None, cache=False), None))
        tel = Telemetry()
        runs["on"].append((serve(on_ex, mixture, tel, cache=False), tel))
        runs["no_audit"].append((serve(no_audit_ex, mixture, Telemetry(audit=None),
                                       cache=False), None))
    off, (on, tel) = runs["off"][0][0], runs["on"][0]
    same_results(on, off, "telemetry on vs off")
    spans_match(on, tel, "telemetry on")
    m = tel.metrics
    for key, total in on.stats.items():
        got = sum(c.value for (name, _), c in m._counters.items()
                  if name == f"executor.{key}_total")
        check(math.isclose(got, total, rel_tol=1e-12),
              f"executor.{key}_total {got} vs report {total}")
    executed = on.cache_misses - on.coalesced
    audit = tel.audit
    check(len(audit.records) == len(audit.joined) == executed,
          f"audit: {len(audit.records)} records, {len(audit.joined)} joined, "
          f"{executed} executed planned queries")
    errs = audit.error_summary()
    check(bool(errs) and all(math.isfinite(v) for v in errs.values()), "audit: error summary")
    best = {side: max(r.qps for r, _ in rs) for side, rs in runs.items()}
    n_events = len(tel.tracer.to_trace_events()["traceEvents"])
    say(f"phase 8: serve_auto_mixture with telemetry: results, counters, hits, batches and "
        f"shapes equal the telemetry-off run; stage sums == report; trace valid "
        f"({n_events} events); p50/p99 within a bucket; executor.<stat>_total == report "
        f"stats; {len(audit.joined)} audit records joined")
    say("phase 8: audit pred-error " + "  ".join(
        f"{a}/{c}={e:.3f}" for (a, c), e in sorted(errs.items())))
    # the planner's host time per query: one pass of each entry point over
    # the trace (host clock; planning reads host numpy only)
    planner = on_ex.planner
    plan_ms = {}
    for name, fn in (("plan_query", planner.plan_query), ("explain", planner.explain)):
        t = time.perf_counter()
        for q in mixture:
            fn(q.terms, q.rects, q.amps)
        plan_ms[name] = (time.perf_counter() - t) / len(mixture) * 1e3
    say("phase 8: telemetry overhead: " + json.dumps({
        **{f"qps_{side}": [r.qps for r, _ in rs] for side, rs in runs.items()},
        "qps_ratio": best["on"] / best["off"],
        "qps_ratio_no_audit": best["no_audit"] / best["off"],
        "p50_ms_off": off.percentile_ms(50), "p50_ms_on": on.percentile_ms(50),
        "p99_ms_off": off.percentile_ms(99), "p99_ms_on": on.percentile_ms(99),
        "planner_ms_per_query": plan_ms}))

    # (b) serve_sharded_footprint over phase 7's engines without and with a
    # handle (fresh executors: attaching one binds its registry to the
    # shared engines, detached again below)
    zipf = make_zipf_trace(corpus, n_queries=SERVE_QUERIES, pool_size=SERVE_POOL, seed=1)

    def sharded_ex():
        return ShardedExecutor(sharded.engines, sharded.global_ids, sharded.algorithm,
                               routing="footprint", **sharded.kw)

    s_off = serve(sharded_ex(), zipf, None)
    s_tel = Telemetry()
    srv_probe = GeoServer(sharded_ex(), cache=make_cache("landlord", CACHE_CAPACITY),
                          batcher=DeadlineBatcher(max_batch=BATCH, max_terms=8, max_rects=4,
                                                  max_wait_s=float("inf")))
    n_shapes = len(srv_probe._predict_shapes(zipf, open_loop=False))
    try:
        s_on = serve(sharded_ex(), zipf, s_tel)
    finally:
        for e in sharded.engines:
            e.metrics = None
    same_results(s_on, s_off, "sharded telemetry on vs off")
    spans_match(s_on, s_tel, "sharded telemetry on")
    r = s_on.routing[sharded.algorithm]
    shard_spans = [s for s in s_tel.tracer.exec_spans if s.track.startswith("shard ")]
    check(len(shard_spans) == int(r["shards_visited"]) + 8 * n_shapes,
          f"sharded: {len(shard_spans)} shard spans, {int(r['shards_visited'])} visited "
          f"shards in live batches + 8 x {n_shapes} warm-up batches")
    check({s.track for s in shard_spans} <= {f"shard {i}" for i in range(8)}, "shard tracks")
    touched = sum(h.n for (name, _), h in s_tel.metrics._histograms.items()
                  if name == "executor.shards_touched")
    check(touched == r["queries"], f"executor.shards_touched observed {touched} times, "
          f"{r['queries']} routed queries")
    say(f"phase 8: serve_sharded_footprint with telemetry: results equal the telemetry-off "
        f"run; {len(shard_spans)} shard spans = {int(r['shards_visited'])} visited in "
        f"{r['batches']} live batches + 8 x {n_shapes} warm-up; shards_touched observed for "
        f"{touched} routed queries; qps off {s_off.qps:.1f}, on {s_on.qps:.1f}")

    # (c) the CLI as users start it, in a subprocess
    with tempfile.TemporaryDirectory() as d:
        exports = {"--trace-out": "T.json", "--metrics-out": "M.prom",
                   "--audit-out": "A.jsonl", "--events-out": "E.jsonl"}
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--n-docs", str(CLI_N_DOCS),
               "--trace", "zipf", "--algorithm", "auto", "--prune", "--fused",
               "--arrival", "poisson", "--rate-qps", "200", "--coalesce",
               *[x for kv in exports.items() for x in kv]]
        if DEVICE != "cuda":  # a CPU rehearsal names the opt-in
            cmd += ["--device", DEVICE]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        say("phase 8: cli: " + " ".join(cmd[1:]))
        t = time.perf_counter()
        cli = subprocess.run(cmd, cwd=d, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S)
        cli_s = time.perf_counter() - t
        for line in cli.stdout.splitlines():
            say(f"phase 8: cli: {line}")
        check(cli.returncode == 0, f"cli exited {cli.returncode}: {cli.stderr[-2000:]}")
        check(any(line.startswith("queries=") for line in cli.stdout.splitlines()),
              "cli: no report line")
        check("recall@10 vs oracle = " in cli.stdout, "cli: no recall@10 line")
        for name in exports.values():
            path = Path(d) / name
            check(path.exists() and path.stat().st_size > 0, f"cli: {name} missing or empty")
        val = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", "T.json"],
                             cwd=d, env=env, capture_output=True, text=True, timeout=300)
        check(val.returncode == 0, f"cli trace invalid: {val.stderr[-2000:]}")
        batches = {m.group(1): int(float(m.group(2))) for m in re.finditer(
            r'^executor_batches_total\{plan="([^"]+)"\} (\S+)$',
            (Path(d) / "M.prom").read_text(), re.M)}
    kernel_of = {"k_sweep+prune+fused": "sweep_score_pruned",
                 "text_first+prune+fused": "text_probe"}
    cli_launches = {kernel_of[label]: n for label, n in batches.items() if label in kernel_of}
    check(bool(cli_launches), f"cli: no kernel plan served a batch ({batches})")
    say(f"phase 8: cli: exit 0 in {cli_s:.1f} s; {val.stdout.strip()}; batches per plan "
        f"{batches}; kernel launches on its served batches (one per batch of the kernel's "
        f"plan) {cli_launches}")
    say(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return totals


def plain_geo(geo):
    """Per-candidate geo scores (``geo_score_docs``) by the kernel's plain
    version, for a geo dict of ``cand_rects [Nc,R,4]``, ``cand_amps [Nc,R]``,
    ``q_rects [Q,4]``, ``q_amps [Q]``."""
    from repro_torch.kernels.geo_score import ref as GR
    from repro_torch.kernels.geo_score.ops import pad_query

    n, r = geo["cand_rects"].shape[:2]
    qr, qa = pad_query(geo["q_rects"][None], geo["q_amps"][None])
    flat = GR.geo_score_toeprints_ref(geo["cand_rects"].reshape(1, -1, 4),
                                      geo["cand_amps"].reshape(1, -1), qr, qa)
    return flat.reshape(n, r).sum(dim=1)


def recsys_phase() -> dict[str, int]:
    """Phase 9: the recsys serving path at the published ``CONFIG``s (see
    the module docstring).  Returns the kernel launches of the driven
    geo-blended retrieval (the checks' and timings' launches not counted)."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core.ranking import select_top
    from repro_torch.data.recsys import make_generator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.geo_score import kernel as GK
    from repro_torch.kernels.geo_score import ref as GR
    from repro_torch.kernels.geo_score.ops import geo_score_docs, pad_query
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_recsys_cell, recsys_batch
    from repro_torch.models import recsys as rec
    from repro_torch.models.params import params_from_numpy

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    prec, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    say(f"phase 9: float32 matmul precision {prec!r}, cuBLAS TF32 {tf32}")
    check(prec == "highest" and not tf32, "phase 9: f32 matmuls must run at full f32, no TF32")

    def on(tree, device):
        return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

    # (d) each SMOKE config: the same weights (the port's init on the CPU,
    # carried to the card by params_from_numpy) and inputs on both
    losses = {"two-tower-retrieval": rec.two_tower_loss, "dcn-v2": rec.dcn_v2_loss,
              "autoint": rec.autoint_loss, "bst": rec.bst_loss}
    forwards = {"dcn-v2": rec.dcn_v2_forward, "autoint": rec.autoint_forward,
                "bst": rec.bst_forward}
    for name in RECSYS_ARCHS:
        cfg = get_arch(name).smoke_config
        p_cpu = cfg.init(RECSYS_SEED, "cpu")
        p_dev = params_from_numpy(cfg.param_defs(), {k: v.numpy() for k, v in p_cpu.items()}, dev)
        b_cpu = recsys_batch(cfg, SMOKE_ROWS, "cpu", RECSYS_SEED)
        b_dev = on(b_cpu, dev)
        errs = {"loss": card_close(losses[name](cfg, p_dev, b_dev)[0],
                                   losses[name](cfg, p_cpu, b_cpu)[0], f"{name} smoke loss")}
        if name in forwards:
            errs["forward"] = card_close(forwards[name](cfg, p_dev, b_dev),
                                         forwards[name](cfg, p_cpu, b_cpu), f"{name} smoke forward")
            # (m) the retrieval cell in chunks with a ragged tail
            spec = get_arch(name)
            spec = replace(spec, config=cfg, shapes=(ShapeSpec(
                "retrieval_cand", "recsys_retrieval",
                dict(batch=1, n_candidates=SMOKE_CANDIDATES)),))
            cell = build_recsys_cell(spec, spec.shape("retrieval_cand"), "cpu", RECSYS_SEED,
                                     chunk_rows=CTR_SMOKE_CHUNK)
            n_chunks = -(-SMOKE_CANDIDATES // CTR_SMOKE_CHUNK)
            check(n_chunks >= 3 and SMOKE_CANDIDATES % CTR_SMOKE_CHUNK
                  and cell.note.endswith(f"{CTR_SMOKE_CHUNK} rows a chunk, {n_chunks} chunks"),
                  f"phase 9 (m): {name} smoke retrieval: {cell.note}")
            rp_cpu, rb_cpu = cell.args
            rp_dev = params_from_numpy(cfg.param_defs(), {k: v.numpy() for k, v in rp_cpu.items()},
                                       dev)
            s_cpu, i_cpu = cell.fn(rp_cpu, rb_cpu)
            s_dev, i_dev = cell.fn(rp_dev, on(rb_cpu, dev))
            errs["retrieval scores"] = card_close(s_dev, s_cpu, f"{name} smoke retrieval scores")
            sep = separated(s_cpu)
            check(torch.equal(i_dev.cpu()[sep], i_cpu[sep]),
                  f"{name} smoke retrieval: top-{TOP_K} ids differ between the card and the CPU")
            say(f"phase 9: {name} smoke: card == CPU within rtol 1e-4 / atol 1e-5 (forward and "
                f"loss at {SMOKE_ROWS} rows; (m) retrieval over {SMOKE_CANDIDATES} candidates in "
                f"{n_chunks} chunks of {CTR_SMOKE_CHUNK}, the last "
                f"{SMOKE_CANDIDATES - (n_chunks - 1) * CTR_SMOKE_CHUNK}: {int(sep.sum())} "
                f"separated ids of {TOP_K} equal); max abs " + json.dumps(errs))
            del p_dev, b_dev, rp_dev, cell
            continue
        errs["user tower"] = card_close(rec.two_tower_user(cfg, p_dev, b_dev),
                                        rec.two_tower_user(cfg, p_cpu, b_cpu),
                                        f"{name} smoke user tower")
        errs["item tower"] = card_close(
            rec.two_tower_item(cfg, p_dev, b_dev["target"], b_dev["item_fields"]),
            rec.two_tower_item(cfg, p_cpu, b_cpu["target"], b_cpu["item_fields"]),
            f"{name} smoke item tower")
        geo_cpu = recsys_geo(SMOKE_CANDIDATES, 0.01, SMOKE_Q_RECTS, "cpu")
        geo_dev = on(geo_cpu, dev)
        cand_ids = torch.arange(SMOKE_CANDIDATES, dtype=torch.int32) % cfg.n_items
        cand_fields = torch.randint(0, cfg.field_vocab, (SMOKE_CANDIDATES, cfg.n_item_fields),
                                    generator=make_generator(RECSYS_SEED, 1, "cpu"),
                                    dtype=torch.int32)
        user = {k: v[:1] for k, v in b_cpu.items()}
        s_cpu, i_cpu = rec.two_tower_score_candidates(cfg, p_cpu, user, cand_ids, cand_fields,
                                                       TOP_K, geo_cpu)
        s_dev, i_dev = rec.two_tower_score_candidates(cfg, p_dev, on(user, dev), cand_ids.to(dev),
                                                       cand_fields.to(dev), TOP_K, geo_dev)
        errs["retrieval scores"] = card_close(s_dev, s_cpu, f"{name} smoke retrieval scores")
        # ids equal wherever adjacent CPU scores differ by more than the
        # tolerance; the −inf picks (lowest positions outside the
        # footprint) exactly
        i_dev = i_dev.cpu()
        fin = torch.isfinite(s_cpu)
        sep = separated(s_cpu)
        check(torch.equal(i_dev[sep], i_cpu[sep]) and torch.equal(i_dev[~fin], i_cpu[~fin]),
              f"{name} smoke retrieval: top-{TOP_K} ids differ between the card and the CPU")
        n_match = int((plain_geo(geo_cpu) > 0).sum())
        check(int((~fin).sum()) == max(0, TOP_K - n_match),
              f"{name} smoke retrieval: −inf picks are not the candidates beyond the matches")
        say(f"phase 9: {name} smoke: card == CPU within rtol 1e-4 / atol 1e-5 (loss, towers at "
            f"{SMOKE_ROWS} rows, retrieval over {SMOKE_CANDIDATES} candidates with {n_match} geo "
            f"matches: {int(sep.sum())} separated ids equal, {int((~fin).sum())} −inf picks "
            f"equal); max abs " + json.dumps(errs))
        del p_dev, b_dev, geo_dev

    # the published CONFIGs: the geo-blended retrieval, then every serve shape
    report = []

    def record(model, shape, rows, ms, flops, param_bytes, peak, **extra):
        row = {"model": model, "shape": shape, "rows": rows, "ms": ms,
               "rows_per_s": rows / ms * 1e3, "model_flops": flops,
               "flops_per_s": flops / ms * 1e3, "f32_share": flops / ms * 1e3 / F32_FLOPS_PER_S,
               "param_gb": param_bytes / 1e9, "peak_gib": peak / 2**30, **extra}
        report.append(row)
        say(f"phase 9: {model} {shape}: {ms:.4f} ms per batch of {rows}, {row['rows_per_s']:.1f} "
            f"rows/s, {flops:.4g} model FLOP -> {row['flops_per_s'] / 1e12:.3f} TFLOP/s "
            f"({row['f32_share']:.4f} of {F32_FLOPS_PER_S / 1e12:g}e12), params "
            f"{row['param_gb']:.3f} GB, peak {row['peak_gib']:.2f} GiB")

    spec = get_arch("two-tower-retrieval")
    shape = spec.shape("retrieval_cand")
    cfg, n_cand = spec.config, shape.params["n_candidates"]
    torch.cuda.reset_peak_memory_stats()
    geo = recsys_geo(n_cand, 0.08, GEO_Q_RECTS, dev)
    cell = build_recsys_cell(spec, shape, dev, RECSYS_SEED, geo=geo)
    params, batch, cand_ids, cand_fields = cell.args
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    check(param_bytes == cfg.n_params() * 4, "two-tower: parameter bytes differ from its defs")
    # (a) the kernel at the retrieval shape against its plain version
    g = geo_score_docs(geo["cand_rects"][None], geo["cand_amps"][None],
                       geo["q_rects"][None], geo["q_amps"][None])[0]
    g_plain = plain_geo(geo)
    err_a = exact(g, g_plain, "geo_score_docs at the retrieval shape", torch)
    n_match = int((g_plain > 0).sum())
    # the driven run: counts from 0 just before, read just after
    reset_launch_counts()
    vals, ids = cell.fn(*cell.args)
    torch.cuda.synchronize()
    counts = launch_counts()
    # (c) one geo_score launch per geo retrieval, no other kernel
    check(counts == {**{k: 0 for k in counts}, "geo_score": 1},
          f"phase 9: a geo retrieval launched {counts}, not geo_score once")
    # (b) the same retrieval through the plain geo path
    u = rec.two_tower_user(cfg, params, batch)
    v = rec.two_tower_item(cfg, params, cand_ids, cand_fields)
    scores = u @ v.T
    pv, pi = select_top(rec.geo_blend(scores, g_plain, GEO_WEIGHT), TOP_K)
    exact(vals, pv, "geo retrieval top-100 scores, kernel vs plain geo path", torch)
    exact(ids, pi, "geo retrieval top-100 ids, kernel vs plain geo path", torch)
    # (e) finite where the reference's are: the picks up to the matches
    n_inf = int(torch.isneginf(vals).sum())
    check(n_inf == max(0, TOP_K - n_match) and bool(torch.isfinite(vals[:, : TOP_K - n_inf]).all()),
          f"phase 9: {n_inf} −inf picks with {n_match} geo matches")
    check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()), "phase 9: non-finite towers")
    nv, ni = rec.two_tower_score_candidates(cfg, params, batch, cand_ids, cand_fields, TOP_K)
    check(bool(torch.isfinite(nv).all()) and ni.shape == (1, TOP_K), "phase 9: plain retrieval")
    say(f"phase 9: retrieval over {n_cand} candidates x {GEO_RECTS} rects, {len(GEO_Q_RECTS)} "
        f"query rects, weight {GEO_WEIGHT}: {n_match} geo matches; geo_score_docs kernel == "
        f"plain (max abs err {err_a}); top-{TOP_K} ids and scores with the kernel == the plain geo "
        f"path; {n_inf} −inf picks; launches {counts}; "
        f"{len(set(ni[0].tolist()) & set(ids[0].tolist()))} of the {TOP_K} picks without the "
        f"blend are among those with it")
    # timings: the whole retrieval with and without the blend, its split,
    # and the kernel beside its plain version and its bound
    blended = rec.geo_blend(scores, g, GEO_WEIGHT)
    qr, qa = pad_query(geo["q_rects"][None], geo["q_amps"][None])
    flat_r, flat_a = geo["cand_rects"].reshape(1, -1, 4), geo["cand_amps"].reshape(1, -1)
    exact(GK.geo_score_cuda(flat_r, flat_a, qr, qa), GR.geo_score_toeprints_ref(flat_r, flat_a, qr, qa),
          "geo_score kernel at the retrieval shape", torch)
    split = {
        "retrieval_geo": time_ms(lambda: cell.fn(*cell.args), torch),
        "retrieval_no_geo": time_ms(lambda: rec.two_tower_score_candidates(
            cfg, params, batch, cand_ids, cand_fields, TOP_K), torch),
        "user_tower": time_ms(lambda: rec.two_tower_user(cfg, params, batch), torch),
        "item_tower": time_ms(lambda: rec.two_tower_item(cfg, params, cand_ids, cand_fields), torch),
        "score_and_blend": time_ms(lambda: rec.geo_blend(u @ v.T, g, GEO_WEIGHT), torch),
        "geo_score_docs": time_ms(lambda: geo_score_docs(
            geo["cand_rects"][None], geo["cand_amps"][None],
            geo["q_rects"][None], geo["q_amps"][None]), torch),
        "geo_score_kernel": time_ms(lambda: GK.geo_score_cuda(flat_r, flat_a, qr, qa), torch),
        "geo_score_plain": time_ms(lambda: GR.geo_score_toeprints_ref(flat_r, flat_a, qr, qa), torch),
        "top_k": time_ms(lambda: select_top(blended, TOP_K), torch),
    }
    n_tp = n_cand * GEO_RECTS
    b_ms, b_by = bound_ms(n_tp * (STORE_BYTES + 4.0), n_tp * (OPS_PER_SLOT * len(GEO_Q_RECTS) + 1))
    split["geo_score_bound"] = b_ms
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 9: retrieval split (ms): " + json.dumps(split) + f"; geo_score bound {b_ms:.4f} ms "
        f"({b_by}: {n_tp * (STORE_BYTES + 4.0):.0f} bytes), the kernel "
        f"{split['geo_score_kernel'] / split['retrieval_geo']:.4%} of the retrieval")
    record("two-tower-retrieval", "retrieval_cand", n_cand, split["retrieval_geo"],
           cell.model_flops, param_bytes, peak, ms_no_geo=split["retrieval_no_geo"])
    del cell, params, batch, cand_ids, cand_fields, geo, g, g_plain, u, v, scores, blended
    del flat_r, flat_a, vals, ids, pv, pi, nv, ni
    torch.cuda.empty_cache()
    ctr_retrieval(report, record)

    for name in RECSYS_ARCHS:
        spec = get_arch(name)
        for shape_name in ("serve_p99", "serve_bulk"):
            shape = spec.shape(shape_name)
            torch.cuda.reset_peak_memory_stats()
            cell = build_recsys_cell(spec, shape, dev, RECSYS_SEED)
            param_bytes = sum(t.numel() * t.element_size() for t in cell.args[0].values())
            check(param_bytes == spec.config.n_params() * 4, f"{name}: parameter bytes")
            out = cell.fn(*cell.args)
            rows = shape.params["batch"]
            want = (rows, spec.config.embed_dim) if name == "two-tower-retrieval" else (rows,)
            check(tuple(out.shape) == want and bool(torch.isfinite(out).all()),
                  f"phase 9: {name} {shape_name}: output {tuple(out.shape)}, finite "
                  f"{bool(torch.isfinite(out).all())}")
            ms = time_ms(lambda: cell.fn(*cell.args), torch)
            record(name, shape_name, rows, ms, cell.model_flops, param_bytes,
                   torch.cuda.max_memory_allocated())
            del cell, out
            torch.cuda.empty_cache()
    say("phase 9: " + json.dumps(report))
    say(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return counts


def ctr_retrieval(report: list, record) -> None:
    """Phase 9's CTR ``retrieval_cand`` cells at the published ``CONFIG``s:
    each driven once with the launch counts from 0 ((k): a well-formed
    top-100 and no kernel launch), timed, then (l) its chunked forward
    against one call on its first ``CTR_PREFIX`` rows."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core.ranking import select_top
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import (
        build_recsys_cell,
        recsys_forward,
        retrieval_chunk_rows,
        retrieval_row_bytes,
    )
    from repro_torch.models import recsys as rec

    dev = torch.device(DEVICE)
    card = card_line()
    for name in CTR_RETRIEVAL_ARCHS:
        spec = get_arch(name)
        shape = spec.shape("retrieval_cand")
        cfg, n_cand = spec.config, shape.params["n_candidates"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cell = build_recsys_cell(spec, shape, dev, RECSYS_SEED)
        params, batch = cell.args
        param_bytes = sum(t.numel() * t.element_size() for t in params.values())
        input_bytes = sum(t.numel() * t.element_size() for t in batch.values())
        check(param_bytes == cfg.n_params() * 4, f"{name}: parameter bytes differ from its defs")
        chunk = retrieval_chunk_rows(cfg, n_cand)
        n_chunks = -(-n_cand // chunk)
        # the driven run: counts from 0 just before, read just after
        reset_launch_counts()
        vals, ids = cell.fn(*cell.args)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # (k) a well-formed top-100, no kernel on this path
        check(tuple(vals.shape) == tuple(ids.shape) == (TOP_K,),
              f"(k) {name}: top-k shapes {tuple(vals.shape)}, {tuple(ids.shape)}")
        check(bool(torch.isfinite(vals).all()) and bool((vals[:-1] >= vals[1:]).all()),
              f"(k) {name}: top-{TOP_K} values not finite and non-increasing")
        id_list = ids.tolist()
        check(len(set(id_list)) == TOP_K and min(id_list) >= 0 and max(id_list) < n_cand,
              f"(k) {name}: top-{TOP_K} ids not distinct in [0, {n_cand})")
        check(not any(counts.values()), f"(k) {name}: the retrieval launched {counts}")
        ms = time_ms(lambda: cell.fn(*cell.args), torch)
        # the peak the chunk rule predicts: parameters, candidates, the
        # [N] scores and one chunk's counted transient
        pred = param_bytes + input_bytes + 4 * n_cand + chunk * retrieval_row_bytes(cfg)
        record(name, "retrieval_cand", n_cand, ms, cell.model_flops, param_bytes, peak,
               ms_per_1m_candidates=ms * 1e6 / n_cand, chunk_rows=chunk, chunks=n_chunks,
               last_chunk_rows=n_cand - (n_chunks - 1) * chunk,
               peak_above_base_gib=(peak - base) / 2**30, predicted_peak_gib=pred / 2**30)
        say(f"phase 9: {name} retrieval_cand on {card}: (k) top-{TOP_K} of {n_cand} finite, "
            f"non-increasing, distinct ids, launches {counts}; {n_chunks} chunks of {chunk} rows "
            f"(the last {n_cand - (n_chunks - 1) * chunk}); {ms * 1e6 / n_cand:.4f} ms per 1M "
            f"candidates; peak {(peak - base) / 2**30:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB held before (predicted {pred / 2**30:.2f})")
        del vals, ids
        # (l) chunked == one call on the cell's first CTR_PREFIX rows
        fwd = recsys_forward(cfg)
        prefix = {k: v[:CTR_PREFIX] for k, v in batch.items()}
        one = fwd(params, prefix)
        one_v, one_i = select_top(one, TOP_K)
        one, one_v, one_i = one.cpu(), one_v.cpu(), one_i.cpu()
        torch.cuda.empty_cache()
        got = rec.forward_in_row_chunks(fwd, params, prefix, CTR_CHECK_CHUNK)
        got_v, got_i = select_top(got, TOP_K)
        err = card_close(got, one, f"(l) {name}: chunked vs one call")
        sep = separated(one_v)
        check(torch.equal(got_i.cpu()[sep], one_i[sep]),
              f"(l) {name}: top-{TOP_K} ids of the chunked forward differ from one call's")
        last = CTR_PREFIX - (CTR_PREFIX // CTR_CHECK_CHUNK) * CTR_CHECK_CHUNK
        say(f"phase 9: (l) {name}: the first {CTR_PREFIX} candidates in chunks of "
            f"{CTR_CHECK_CHUNK} (the last {last}) == one call within rtol 1e-4 / atol 1e-5 (max "
            f"abs {err:.3g}); {int(sep.sum())} separated top-{TOP_K} ids equal")
        del cell, params, batch, prefix, one, got
        torch.cuda.empty_cache()


def separated(scores):
    """The picks of a top-k whose score lies more than ``SMOKE_TOL`` from
    each neighbour's (finite scores only): where two top-k lists of
    scores within the tolerance must agree in their ids."""
    fin = scores.isfinite()
    tol = SMOKE_TOL["atol"] + SMOKE_TOL["rtol"] * scores.abs()
    gap = (scores[..., 1:] - scores[..., :-1]).abs()
    sep = fin.clone()
    sep[..., 1:] &= gap > tol[..., 1:]
    sep[..., :-1] &= gap > tol[..., :-1]
    return sep


def card_close(got, want, what: str, tol: dict = SMOKE_TOL) -> float:
    """Card vs CPU within ``tol``, −inf where the CPU has −inf; returns
    the max abs difference."""
    import torch

    got = got.cpu()
    fin = torch.isfinite(want)
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin]),
          f"{what}: non-finite entries differ between the card and the CPU")
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    check(bool(torch.allclose(got[fin], want[fin], **tol)),
          f"{what}: card vs CPU beyond rtol {tol['rtol']:g} / atol {tol['atol']:g} "
          f"(max abs {err:.3g})")
    return err


def training_phase() -> dict[str, int]:
    """Phase 10: recsys training (see the module docstring).  Returns the
    kernel launches of the retrieval example (one geo_score)."""
    import contextlib
    import io
    import math
    import os
    import re
    import tempfile

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.examples import recsys_retrieval
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.geo_score.ops import geo_score_docs
    from repro_torch.launch.steps import TRAIN_OPT, build_recsys_cell, recsys_batch, recsys_loss
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.loop import LoopConfig, make_train_step, run, value_and_grad
    from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state
    from repro_torch.train.tree import leaves

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "phase 10: f32 matmuls must run at full f32, no TF32")

    # (g) each SMOKE config: the same weights and batches, TRAIN_SMOKE_STEPS
    # train steps on the card and on the CPU
    opt = OptimizerConfig(**TRAIN_SMOKE_OPT)
    for name in RECSYS_ARCHS:
        cfg = get_arch(name).smoke_config
        step = make_train_step(recsys_loss(cfg), opt)
        p_cpu = cfg.init(RECSYS_SEED, "cpu")
        p_dev = params_from_numpy(cfg.param_defs(), {k: v.numpy() for k, v in p_cpu.items()}, dev)
        s_cpu, s_dev = init_opt_state(opt, p_cpu), init_opt_state(opt, p_dev)
        errs = {"loss": 0.0, "params": 0.0}
        for s in range(TRAIN_SMOKE_STEPS):
            b_cpu = recsys_batch(cfg, SMOKE_ROWS, "cpu", RECSYS_SEED, s)
            _, _, m_cpu = step(p_cpu, s_cpu, b_cpu)
            _, _, m_dev = step(p_dev, s_dev, {k: v.to(dev) for k, v in b_cpu.items()})
            errs["loss"] = max(errs["loss"], card_close(m_dev["loss"], m_cpu["loss"],
                                                        f"{name} smoke step {s} loss"))
        for k in p_cpu:
            errs["params"] = max(errs["params"], card_close(p_dev[k], p_cpu[k],
                                                            f"{name} smoke params[{k}]"))
        for k in ("m", "v"):
            for a, b in zip(leaves(s_dev[k]), leaves(s_cpu[k])):
                card_close(a, b, f"{name} smoke {k}")
        say(f"phase 10: (g) {name} smoke: {TRAIN_SMOKE_STEPS} train steps of {SMOKE_ROWS} rows, "
            f"card == CPU within rtol 1e-4 / atol 1e-5 (losses, params, moments); max abs "
            + json.dumps(errs))
        del p_dev, s_dev

    # (h) the fault-tolerant loop on the card: a failure at REPLAY_FAILURE
    # restores the last checkpoint and replays, bitwise equal to a run
    # without the failure
    opt = OptimizerConfig(**REPLAY_OPT)
    for name in REPLAY_ARCHS:
        cfg = get_arch(name).smoke_config
        step = make_train_step(recsys_loss(cfg), opt)

        def init_state():
            params = cfg.init(RECSYS_SEED, dev)
            return params, init_opt_state(opt, params)

        def batch_fn(s):
            return recsys_batch(cfg, SMOKE_ROWS, dev, RECSYS_SEED, s)

        logs = []
        with tempfile.TemporaryDirectory() as d:
            faulty = run(LoopConfig(total_steps=REPLAY_STEPS, ckpt_every=REPLAY_CKPT_EVERY,
                                    ckpt_dir=d, log_every=1, simulate_failure_at=REPLAY_FAILURE),
                         step, init_state, batch_fn, log=logs.append)
        clean = run(LoopConfig(total_steps=REPLAY_STEPS, log_every=1), step, init_state,
                    batch_fn, log=lambda line: None)
        restored = REPLAY_FAILURE // REPLAY_CKPT_EVERY * REPLAY_CKPT_EVERY
        check(f"[fault] restoring step {restored}" in logs, f"(h) {name}: no restore in {logs}")
        check(dict(faulty[2]) == dict(clean[2]), f"(h) {name}: replayed losses differ")
        n_leaves = 0
        for a, b in zip(leaves(faulty[:2]), leaves(clean[:2])):
            exact(a, b, f"(h) {name}: state after the replay", torch)
            n_leaves += 1
        say(f"phase 10: (h) {name} smoke: failure at step {REPLAY_FAILURE}, restored step "
            f"{restored}, replayed to {REPLAY_STEPS}: params, moments and step bitwise equal to "
            f"the run without the failure ({n_leaves} leaves)")

    # (i) the train CLI in subprocesses, with and without the failure
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dcn-v2", "--steps",
               str(REPLAY_STEPS), "--batch-size", "64", "--ckpt-every", str(REPLAY_CKPT_EVERY)]
        if DEVICE != "cuda":  # a CPU rehearsal names the opt-in
            cmd += ["--device", DEVICE]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        runs = {tag: (cmd + ["--ckpt-dir", str(Path(d) / tag)] + extra) for tag, extra in
                (("fault", ["--simulate-failure", str(REPLAY_FAILURE)]), ("clean", []))}
        say("phase 10: (i) cli: " + " ".join(runs["fault"][1:]))
        procs = {tag: subprocess.Popen(c, cwd=d, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                 for tag, c in runs.items()}
        outs = {}
        for tag, proc in procs.items():
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
            check(proc.returncode == 0, f"(i) cli ({tag}) exited {proc.returncode}: {err[-2000:]}")
            outs[tag] = out.splitlines()
    for line in outs["fault"]:
        say(f"phase 10: (i) cli: {line}")
    pat = re.compile(r"^step +(\d+) +loss (\S+) ")
    losses = {tag: [pat.match(x).groups() for x in out if pat.match(x)]
              for tag, out in outs.items()}
    check([int(s) for s, _ in losses["clean"]] == list(range(REPLAY_STEPS)),
          f"(i) cli without the failure logged {losses['clean']}")
    check(any(x.startswith("[fault] ") for x in outs["fault"])
          and f"[fault] restoring step {restored}" in outs["fault"], "(i) cli: no [fault] lines")
    check(set(losses["fault"]) == set(losses["clean"])
          and sorted({int(s) for s, _ in losses["fault"]}) == list(range(REPLAY_STEPS)),
          f"(i) cli: loss lines differ: {losses}")
    say(f"phase 10: (i) cli: both runs exit 0; the {len(losses['fault'])} loss lines of the "
        f"failing run equal the {len(losses['clean'])} of the run without the failure")

    # (j) the retrieval example: train, then rank through geo_score
    reset_launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ex = recsys_retrieval.main(device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    for line in printed.getvalue().splitlines():
        if line.strip():
            say(f"phase 10: (j) example: {line}")
    check(counts == {**{k: 0 for k in counts}, "geo_score": 1},
          f"(j) the example launched {counts}, not geo_score once")
    check(len(ex["losses"]) == 100 and all(math.isfinite(x) for x in ex["losses"]),
          "(j) non-finite example losses")
    x0, y0, x1, y1 = recsys_retrieval.Q_RECT
    r = ex["cand_rects"][ex["geo"], 0]
    check(len(ex["geo"]) == 10 and bool(((r[:, 0] < x1) & (r[:, 2] > x0) & (r[:, 1] < y1)
                                         & (r[:, 3] > y0)).all()),
          "(j) a geo-constrained top-10 candidate misses the query area")
    # the kernel at the example's shape against its plain version
    geo = ex["geo_inputs"]
    g = geo_score_docs(geo["cand_rects"][None], geo["cand_amps"][None],
                       geo["q_rects"][None], geo["q_amps"][None])[0]
    err_j = exact(g, plain_geo(geo), "(j) geo_score_docs at the example's shape", torch)
    say(f"phase 10: (j) example: 100 finite losses, every geo top-10 id inside the query "
        f"area, launches {counts}; geo_score_docs over {tuple(geo['cand_rects'].shape)} rects "
        f"and {tuple(geo['q_rects'].shape)} query rects == plain (max abs err {err_j})")

    # the published CONFIGs at train_batch: timings, the split, check (f)
    report = []
    for name in RECSYS_ARCHS:
        spec = get_arch(name)
        shape = spec.shape("train_batch")
        B = shape.params["batch"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cell = build_recsys_cell(spec, shape, dev, RECSYS_SEED)
        params, state, batch = cell.args
        param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
        opt_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
        check(param_bytes == spec.config.n_params() * 4, f"{name}: parameter bytes")
        before = {k: t.to("cpu", copy=True) for k, t in params.items()}
        metrics = []

        def one():
            metrics.append(cell.fn(*cell.args)[2])

        for _ in range(TRAIN_WARMUP):
            one()
        times = []
        for _ in range(TRAIN_RUNS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            one()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = statistics.median(times)
        # one step split by CUDA events, through the functions the step
        # calls: value_and_grad (forward + loss, then backward) and
        # adamw_update with the cell's optimizer config
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        loss_fn = recsys_loss(spec.config)

        def timed_loss(prm, b):
            out = loss_fn(prm, b)
            ev[1].record()
            return out

        ev[0].record()
        loss, _, grads = value_and_grad(timed_loss, params, batch)
        ev[2].record()
        _, _, m = adamw_update(TRAIN_OPT, grads, params, state)
        ev[3].record()
        ev[3].synchronize()
        metrics.append({"loss": loss, **m})
        del loss, grads
        split = {"forward_loss": ev[0].elapsed_time(ev[1]), "backward": ev[1].elapsed_time(ev[2]),
                 "adamw": ev[2].elapsed_time(ev[3])}
        peak = torch.cuda.max_memory_allocated()
        # (f) finite losses and norms, the step count, every leaf moved
        n_steps = TRAIN_WARMUP + TRAIN_RUNS + 1
        vals = torch.stack([torch.stack([x["loss"], x["grad_norm"]]) for x in metrics])
        check(bool(torch.isfinite(vals).all()), f"(f) {name}: non-finite loss or grad_norm")
        check(int(state["step"]) == n_steps, f"(f) {name}: step {int(state['step'])}, "
              f"{n_steps} steps taken")
        still = [k for k, t in params.items() if torch.equal(before[k], t.cpu())]
        check(not still, f"(f) {name}: parameters that did not move: {still}")
        flops = cell.model_flops
        row = {"model": name, "shape": "train_batch", "rows": B, "ms": ms,
               "rows_per_s": B / ms * 1e3, "model_flops": flops,
               "flops_per_s": flops / ms * 1e3, "f32_share": flops / ms * 1e3 / F32_FLOPS_PER_S,
               "param_gb": param_bytes / 1e9, "opt_state_gb": opt_bytes / 1e9,
               "train_state_gb": (2 * param_bytes + opt_bytes) / 1e9, "peak_gib": peak / 2**30,
               "split_ms": split, "loss_first_last": [float(vals[0, 0]), float(vals[-1, 0])]}
        report.append(row)
        say(f"phase 10: {name} train_batch: {ms:.4f} ms per step of {B} rows, "
            f"{row['rows_per_s']:.1f} rows/s, {flops:.4g} model FLOP -> "
            f"{row['flops_per_s'] / 1e12:.3f} TFLOP/s ({row['f32_share']:.4f} of "
            f"{F32_FLOPS_PER_S / 1e12:g}e12); params {row['param_gb']:.3f} GB, optimizer state "
            f"{row['opt_state_gb']:.3f} GB, train state (params + grads + m + v) "
            f"{row['train_state_gb']:.3f} GB; peak {row['peak_gib']:.2f} GiB; split (ms) "
            + json.dumps(split) + f"; (f) {n_steps} steps, losses and norms finite, every one "
            f"of {len(before)} leaves moved")
        del cell, params, state, batch, before, metrics, m
        torch.cuda.empty_cache()
    say("phase 10: " + json.dumps(report))
    say(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return counts


def examples_phase() -> dict[str, int]:
    """Phase 11: the paper's two example drivers and the geoweb cells (see
    the module docstring).  Returns the geo_score launches of the driven
    ``--use-pallas`` run."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core import make_mesh
    from repro_torch.examples import geosearch_serve, quickstart
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_cell

    t_phase = time.perf_counter()
    # (a) quickstart on the card; its lines equal the CPU run's (the same
    # numpy in this process, so the same corpus)
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_lines = quickstart.main("cpu")
    t = time.perf_counter()
    card_lines = quickstart.main(DEVICE)
    check(card_lines == cpu_lines, f"phase 11 (a): quickstart card lines {card_lines} differ "
          f"from the CPU's {cpu_lines}")
    say(f"phase 11 (a): quickstart on the card in {time.perf_counter() - t:.1f} s: its "
        f"{len(card_lines)} lines equal the CPU run's")

    # (b) geosearch_serve at its defaults, plain, then through the kernel
    # (the driven run: launch counts from 0 just before, read just after)
    t = time.perf_counter()
    plain = geosearch_serve.run(geosearch_serve.parse_args([]), DEVICE)
    plain_s = time.perf_counter() - t
    reset_launch_counts()
    t = time.perf_counter()
    args = geosearch_serve.parse_args(["--use-pallas"])
    kern = geosearch_serve.run(args, DEVICE)
    torch.cuda.synchronize()
    counts = launch_counts()
    kern_s = time.perf_counter() - t
    # K-SWEEP scores through geo_score once per batch: the warm-up batch and
    # the timed batches (the recall batch runs the default scorer, as the
    # reference's example does)
    n_k = args.n_queries // args.batch + 1
    check(counts == {**{k: 0 for k in counts}, "geo_score": n_k},
          f"phase 11 (b): --use-pallas launched {counts}, not geo_score {n_k} times")
    for a, b in zip(plain, kern):
        for key in ("algorithm", "n", "seeks", "bytes_seq", "bytes_random", "recall"):
            check(a[key] == b[key], f"phase 11 (b): {a['algorithm']} {key}: plain {a[key]}, "
                  f"kernel {b[key]}")
    ks = plain[-1]["algorithm"]
    exact(kern[-1]["last"].ids, plain[-1]["last"].ids, f"phase 11 (b) {ks} ids", torch)
    exact(kern[-1]["last"].scores, plain[-1]["last"].scores, f"phase 11 (b) {ks} scores", torch)
    for tag, rows in (("plain", plain), ("geo_score kernel", kern)):
        for r in rows:
            say(f"phase 11 (b): {tag} {r['algorithm']}: {r['qps']:.1f} queries/s, "
                f"{r['ms_per_q']:.4f} ms per query, recall@10 {r['recall']:.4f}, counters "
                f"seeks {r['seeks']:.0f} bytes_seq {r['bytes_seq']:.0f} bytes_random "
                f"{r['bytes_random']:.0f}; cost models t_disk2010 {r['t_disk2010'] * 1e3:.4f} ms, "
                f"t_hbm_h100 {r['t_hbm_h100'] * 1e6:.4f} us per query")
    say(f"phase 11 (b): geosearch_serve ({args.n_docs} docs, {args.n_queries} queries, batch "
        f"{args.batch}) plain in {plain_s:.1f} s, --use-pallas in {kern_s:.1f} s: counters and "
        f"recall equal, the last {ks} batch's ids and scores bitwise; launches {counts}")
    del plain, kern

    # (c) the three geoweb SMOKE cells on a one-card mesh vs the CPU's
    spec = get_arch("geoweb")
    smoke = dataclasses.replace(spec, config=spec.smoke_config)
    meshes = {d: make_mesh((1, 1), ("data", "model"), device=d) for d in (DEVICE, "cpu")}
    for shape in spec.shapes:
        shape_name = shape.name
        card = build_cell(smoke, shape, meshes[DEVICE])
        cpu = build_cell(smoke, shape, meshes["cpu"])
        (ids, scores, stats), (c_ids, c_scores, c_stats) = card.fn(*card.args), cpu.fn(*cpu.args)
        exact(ids.cpu(), c_ids, f"phase 11 (c) {shape_name} ids", torch)
        check(sorted(stats) == sorted(c_stats), f"phase 11 (c) {shape_name}: stats keys differ")
        for k in stats:
            exact(stats[k].cpu(), c_stats[k], f"phase 11 (c) {shape_name} stats[{k}]", torch)
        # scores, as phase 2's small corpus, within 1e-5
        check(bool(torch.allclose(scores.cpu(), c_scores, rtol=1e-5, atol=1e-6)),
              f"phase 11 (c) {shape_name}: scores card vs CPU")
        check(int((ids >= 0).sum()) > 0, f"phase 11 (c) {shape_name}: no hits")
        say(f"phase 11 (c): geoweb {shape_name} (SMOKE, 1 x 1 mesh): card == CPU in ids and "
            f"every counter, scores within 1e-5; {int((ids >= 0).sum())} hits over "
            f"{ids.shape[0]} queries; model_flops {card.model_flops:.6g}")
    try:
        build_cell(spec, spec.shapes[0], meshes[DEVICE])
    except ValueError as e:
        check(">= 8 devices" in str(e), f"phase 11 (c): the CONFIG guard raised {e}")
        say(f"phase 11 (c): CONFIG on the 1 x 1 mesh raises: {e}")
    else:
        check(False, "phase 11 (c): CONFIG on a 1 x 1 mesh did not raise the int32 guard")
    torch.cuda.synchronize()
    say(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return counts


def lm_phase() -> None:
    """Phase 12: dense LM serving at published widths (see the module
    docstring)."""
    import torch

    from repro_torch.configs.base import get_arch

    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "phase 12: f32 matmuls must run at full f32, no TF32")
    say(f"phase 12: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held by earlier phases")

    # the SMOKE configs at f32 compute: card == CPU (the same weights)
    for name in LM_ARCHS:
        lm_smoke_parity(name, "phase 12")

    report = []
    for name in LM_ARCHS:
        lm_serve(get_arch(name), "phase 12", report)
    say("phase 12: " + json.dumps(report))
    say(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


def moe_train_phase() -> None:
    """Phase 13: the MoE LMs and LM training (see the module docstring)."""
    import dataclasses
    import os
    import re
    import tempfile

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import TRAIN_OPT, build_lm_cell
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.loop import LoopConfig, make_train_step, run, value_and_grad
    from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state
    from repro_torch.train.tree import leaves

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "phase 13: f32 matmuls must run at full f32, no TF32")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory

    # (a) the MoE SMOKE configs, card == CPU, the routing identical
    for name in MOE_ARCHS:
        lm_smoke_parity(name, "phase 13 (a)")

    # (b) MoE serving at published widths.  The decode check runs with no
    # assignment dropped: at the published capacity factor an S-token and
    # an (S+1)-token prefill drop different assignments, so they compute
    # different functions (moe.py's own oracle holds moe_ffn only when
    # nothing is dropped)
    t = time.perf_counter()
    report = []
    for name in MOE_ARCHS:
        spec = get_arch(name)
        cfg = spec.config
        E, K = cfg.n_experts, cfg.top_k
        say(f"phase 13 (b): {name}: {E} experts, top-{K}, capacity factor "
            f"{cfg.capacity_factor}; {cfg.n_active_params():,} of {cfg.n_params():,} parameters "
            f"active per token; the decode check at capacity factor E / K = {E / K:g} (C = S, "
            f"nothing dropped): at {cfg.capacity_factor} the {LM_CHECK_S}- and "
            f"{LM_CHECK_S + 1}-token prefills drop different assignments and would compute "
            "different functions")
        lm_serve(spec, "phase 13 (b)", report, check_overrides=dict(capacity_factor=E / K))
    say("phase 13 (b): " + json.dumps(report))
    say(f"phase 13 (b): {time.perf_counter() - t:.1f} s")

    # (c) LM training at published widths: train_4k cut to LM_TRAIN_CUT
    t = time.perf_counter()
    report = []
    B, S = LM_TRAIN_CUT
    for name in LM_ARCHS + MOE_ARCHS:
        spec = get_arch(name)
        cfg = spec.config
        state_bytes = 16 * cfg.n_params()
        shape = spec.shape("train_4k")
        B0, S0 = shape.params["global_batch"], shape.params["seq_len"]
        if name not in LM_TRAIN_ARCHS:
            say(f"phase 13 (c): {name} train_4k not run: its train state (f32 params, grads, m "
                f"and v: 16 B x {cfg.n_params():,} parameters) is {state_bytes / 1e9:.1f} GB "
                f"of the card's {card_bytes / 1e9:.2f} GB; ZeRO-1 (phase 17) splits the "
                "moments over the data ranks, but ranks sharing this one card share its "
                "memory: it needs several cards")
            continue
        cut = dataclasses.replace(shape, params={**shape.params, "global_batch": B,
                                                 "seq_len": S})
        row = {"model": name, "shape": "train_4k", "batch": B, "seq_len": S,
               "published": [B0, S0], "remat": cfg.remat, "train_state_gb": state_bytes / 1e9}
        for remat in ("full", "none") if name == "smollm-135m" else ("full",):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rspec = dataclasses.replace(spec, config=dataclasses.replace(cfg, remat=remat))
            cell = build_lm_cell(rspec, cut, dev, LM_SEED)
            params, state, batch = cell.args
            metrics, times = [], []
            reset_launch_counts()
            n_runs = LM_TRAIN_RUNS if remat == "full" else 1
            for i in range(LM_WARMUP + n_runs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                metrics.append(cell.fn(*cell.args)[2])
                ev[1].record()
                ev[1].synchronize()
                if i >= LM_WARMUP:
                    times.append(ev[0].elapsed_time(ev[1]))
            counts = launch_counts()
            check(not any(counts.values()), f"phase 13 (c): {name} launched {counts}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            vals = torch.stack([torch.stack([m["loss"], m["grad_norm"]]) for m in metrics])
            check(bool(torch.isfinite(vals).all()),
                  f"phase 13 (c): {name} (remat {remat}): non-finite loss or grad_norm")
            check(int(state["step"]) == LM_WARMUP + n_runs,
                  f"phase 13 (c): {name}: step {int(state['step'])}")
            if remat == "none":
                row.update(ms_remat_none=statistics.median(times), peak_gib_remat_none=peak)
                say(f"phase 13 (c): {name} train_4k at {B} x {S}, remat none: "
                    f"{row['ms_remat_none']:.3f} ms per step, peak {peak:.2f} GiB (remat full "
                    f"{row['peak_gib']:.2f} GiB)")
                del cell, params, state, batch, metrics
                continue
            # one step split by CUDA events: forward + loss, backward, AdamW
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            lcfg = rspec.config

            def timed_loss(prm, b, lcfg=lcfg, ev=ev):
                out = tf.loss_fn(lcfg, prm, b)
                ev[1].record()
                return out

            ev[0].record()
            loss, _, grads = value_and_grad(timed_loss, params, batch)
            ev[2].record()
            adamw_update(TRAIN_OPT, grads, params, state)
            ev[3].record()
            ev[3].synchronize()
            check(bool(torch.isfinite(loss)), f"phase 13 (c): {name}: non-finite loss")
            del grads
            ms = statistics.median(times)
            row.update(
                ms=ms, runs_ms=times, tokens_per_s=B * S / ms * 1e3, model_flops=cell.model_flops,
                bf16_share=cell.model_flops / ms * 1e3 / BF16_FLOPS_PER_S, peak_gib=peak,
                split_ms={"forward_loss": ev[0].elapsed_time(ev[1]),
                          "backward": ev[1].elapsed_time(ev[2]),
                          "adamw": ev[2].elapsed_time(ev[3])},
                loss_first_last=[float(vals[0, 0]), float(loss)])
            say(f"phase 13 (c): {name} train_4k: published {B0} x {S0}, run at {B} x {S} "
                f"(remat {remat}): {ms:.3f} ms per step (median of {n_runs} after {LM_WARMUP} "
                f"warm-up), {row['tokens_per_s']:.1f} tokens/s, {cell.model_flops:.4g} model "
                f"FLOP -> {row['bf16_share']:.5f} of {BF16_FLOPS_PER_S / 1e12:g}e12; train state "
                f"{state_bytes / 1e9:.2f} GB; peak {peak:.2f} GiB; split (ms) "
                + json.dumps(row["split_ms"]) + f"; losses finite ({row['loss_first_last']})")
            del cell, params, state, batch, metrics, loss
        report.append(row)
        torch.cuda.empty_cache()
    say("phase 13 (c): " + json.dumps(report))
    say(f"phase 13 (c): {time.perf_counter() - t:.1f} s")

    # (d) every SMOKE LM trained on the card and on the CPU, then a fault
    # replayed on the card
    t = time.perf_counter()
    sb, ss = LM_SMOKE_BATCH
    for name in LM_ARCHS + MOE_ARCHS:
        cfg = dataclasses.replace(get_arch(name).smoke_config, compute_dtype=torch.float32)
        opt = OptimizerConfig(**TRAIN_SMOKE_OPT)
        step = make_train_step(lambda p, b, cfg=cfg: tf.loss_fn(cfg, p, b), opt)
        p_cpu = cfg.init(LM_SEED, "cpu")
        p_dev = params_from_numpy(cfg.param_defs(), numpy_tree(p_cpu), dev)
        p_init = [t.clone() for t in leaves(p_cpu)]
        s_cpu, s_dev = init_opt_state(opt, p_cpu), init_opt_state(opt, p_dev)
        errs = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0, "params_traj": 0.0,
                "moments": 0.0}
        for s in range(TRAIN_SMOKE_STEPS):
            b_cpu = lm_batch(LMDataConfig(cfg.vocab, ss, sb, LM_SEED), s, "cpu")
            _, _, m_cpu = step(p_cpu, s_cpu, b_cpu)
            _, _, m_dev = step(p_dev, s_dev, {k: v.to(dev) for k, v in b_cpu.items()})
            for k in ("loss", "grad_norm"):
                errs[k] = max(errs[k], card_close(m_dev[k], m_cpu[k],
                                                  f"(d) {name} smoke step {s} {k}"))
        for a, c, c0 in zip(leaves(p_dev), leaves(p_cpu), p_init):
            errs["params"] = max(errs["params"], card_close(a, c, f"(d) {name} smoke params",
                                                            LM_STEP_TOL))
            moved = float((c - c0).norm())
            traj = float((a.cpu() - c).norm()) / moved if moved else float((a.cpu() - c).norm())
            check(traj <= LM_TRAJ_TOL, f"(d) {name} smoke params: card and CPU {traj:.3g} of "
                  f"the distance travelled apart (> {LM_TRAJ_TOL})")
            errs["params_traj"] = max(errs["params_traj"], traj)
        for a, c in zip(leaves((s_dev["m"], s_dev["v"])), leaves((s_cpu["m"], s_cpu["v"]))):
            errs["moments"] = max(errs["moments"], card_close(a, c, f"(d) {name} smoke moments"))
        del p_dev, s_dev

        ropt = OptimizerConfig(**REPLAY_OPT)
        rstep = make_train_step(lambda p, b, cfg=cfg: tf.loss_fn(cfg, p, b), ropt)

        def init_state(cfg=cfg, ropt=ropt):
            params = cfg.init(LM_SEED, dev)
            return params, init_opt_state(ropt, params)

        def batch_fn(s, cfg=cfg):
            return lm_batch(LMDataConfig(cfg.vocab, ss, sb, LM_SEED), s, dev)

        logs = []
        with tempfile.TemporaryDirectory() as d:
            faulty = run(LoopConfig(total_steps=REPLAY_STEPS, ckpt_every=REPLAY_CKPT_EVERY,
                                    ckpt_dir=d, log_every=1, simulate_failure_at=REPLAY_FAILURE),
                         rstep, init_state, batch_fn, log=logs.append)
        clean = run(LoopConfig(total_steps=REPLAY_STEPS, log_every=1), rstep, init_state,
                    batch_fn, log=lambda line: None)
        restored = REPLAY_FAILURE // REPLAY_CKPT_EVERY * REPLAY_CKPT_EVERY
        check(f"[fault] restoring step {restored}" in logs, f"(d) {name}: no restore in {logs}")
        check(dict(faulty[2]) == dict(clean[2]), f"(d) {name}: replayed losses differ")
        n_leaves = 0
        for a, c in zip(leaves(faulty[:2]), leaves(clean[:2])):
            exact(a, c, f"(d) {name}: state after the replay", torch)
            n_leaves += 1
        say(f"phase 13 (d): {name} smoke (f32 compute, {sb} x {ss} tokens): "
            f"{TRAIN_SMOKE_STEPS} train steps, card == CPU (losses, grad norms and moments "
            f"within rtol 1e-4 / atol 1e-5; params within rtol 1e-4 / atol "
            f"{LM_STEP_TOL['atol']:g} and each leaf within {LM_TRAJ_TOL:g} of the distance it "
            "travelled); max abs (params_traj: the largest such share) " + json.dumps(errs)
            + f"; failure at step "
            f"{REPLAY_FAILURE}, restored step {restored}, replayed to {REPLAY_STEPS}: params, "
            f"moments and step bitwise equal to the run without the failure ({n_leaves} leaves)")
        del faulty, clean
    say(f"phase 13 (d): {time.perf_counter() - t:.1f} s")

    # (e) the entry points as users start them, in subprocesses
    t = time.perf_counter()
    pat = re.compile(r"^step +(\d+) +loss (\S+) ")
    with tempfile.TemporaryDirectory() as d:
        opt_in = [] if DEVICE == "cuda" else ["--device", DEVICE]  # a CPU rehearsal
        cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "granite-moe-1b-a400m", "--steps", str(REPLAY_STEPS), "--ckpt-every",
               str(REPLAY_CKPT_EVERY)] + opt_in
        cmds = {"fault": cli + ["--ckpt-dir", str(Path(d) / "fault"), "--simulate-failure",
                                str(REPLAY_FAILURE)],
                "clean": cli + ["--ckpt-dir", str(Path(d) / "clean")],
                "train_lm": [sys.executable, "-m", "repro_torch.examples.train_lm",
                             "--steps", "60"] + opt_in}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for tag, c in cmds.items():
            say(f"phase 13 (e): {tag}: " + " ".join(c[1:]))
        procs = {tag: subprocess.Popen(c, cwd=d, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                 for tag, c in cmds.items()}
        outs = {}
        for tag, proc in procs.items():
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
            check(proc.returncode == 0, f"(e) {tag} exited {proc.returncode}: {err[-2000:]}")
            outs[tag] = out.splitlines()
    for tag in ("fault", "train_lm"):
        for line in outs[tag]:
            say(f"phase 13 (e): {tag}: {line}")
    losses = {tag: [pat.match(x).groups() for x in outs[tag] if pat.match(x)]
              for tag in ("fault", "clean")}
    check([int(s) for s, _ in losses["clean"]] == list(range(REPLAY_STEPS)),
          f"(e) the train CLI without the failure logged {losses['clean']}")
    check(f"[fault] restoring step {restored}" in outs["fault"],
          "(e) the train CLI printed no [fault] restore")
    check(set(losses["fault"]) == set(losses["clean"])
          and sorted({int(s) for s, _ in losses["fault"]}) == list(range(REPLAY_STEPS)),
          f"(e) the train CLI's loss lines differ: {losses}")
    check(bool(outs["train_lm"]) and outs["train_lm"][-1].endswith("(OK: learning)"),
          f"(e) train_lm did not end learning: {outs['train_lm'][-1:]}")
    say(f"phase 13 (e): the train CLI (granite-moe-1b-a400m smoke) with and without the failure "
        f"exits 0, the {len(losses['fault'])} loss lines of the failing run equal the "
        f"{len(losses['clean'])} of the other; train_lm exits 0: {outs['train_lm'][-1]}; "
        f"{time.perf_counter() - t:.1f} s")
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


def egnn_smoke(kind: str, device):
    """(cfg, batch) of a phase-14 (a) SMOKE case at f32 compute on
    ``device``: the graphs of tests/test_arch_smoke.py."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data import graph

    cfg = dataclasses.replace(get_arch("egnn").smoke_config, compute_dtype=torch.float32)
    if kind == "molecule":
        cfg = dataclasses.replace(cfg, n_classes=0)
        return cfg, graph.molecule_batch(8, 10, 16, cfg.d_feat, seed=0, device=device)
    if kind == "sampled":
        g = graph.make_powerlaw_graph(512, 4096, cfg.d_feat, cfg.n_classes, seed=1,
                                      device=device)
        return cfg, graph.sample_subgraph(g, graph.SampledShape(16, (4, 3)), seed=0, step=0,
                                          device=device)
    g = graph.make_powerlaw_graph(128, 512, cfg.d_feat, cfg.n_classes, seed=0, device=device)
    return cfg, graph.full_graph_batch(g, edge_multiple=8, device=device)


def saved_bytes(run, rows: dict) -> dict:
    """Bytes autograd saves while ``run()`` records, each storage counted
    once, summed by the leading dim of the tensor saved: under the name in
    ``rows`` (name → row count) it matches, else under "other"."""
    import torch

    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen.setdefault(st.data_ptr(), (st.nbytes(), t.shape[0] if t.dim() else None))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run()
    del out
    by = {name: 0 for name in (*rows, "other")}
    for nbytes, lead in seen.values():
        name = next((k for k, n in rows.items() if n == lead), "other")
        by[name] += nbytes
    return by


def egnn_phase() -> None:
    """Phase 14: EGNN (see the module docstring)."""
    import dataclasses
    import math
    import os
    import re
    import tempfile

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data import graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import egnn
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.loop import LoopConfig, make_train_step, run
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.tree import leaves, tree_map

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "phase 14: f32 matmuls must run at full f32, no TF32")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    reset_launch_counts()

    # (a) SMOKE, card vs CPU, on each cell kind's graph
    opt = OptimizerConfig(**TRAIN_SMOKE_OPT)
    ropt = OptimizerConfig(**REPLAY_OPT)
    for kind in ("full", "sampled", "molecule"):
        t = time.perf_counter()
        cfg, b_cpu = egnn_smoke(kind, "cpu")
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        p_cpu = cfg.init(EGNN_SEED, "cpu")
        p0 = numpy_tree(cfg.init(EGNN_SEED, "cpu"))  # the initial weights, kept
        p_dev = params_from_numpy(cfg.param_defs(), p0, dev)
        errs = {}
        outs = {w: egnn.forward(cfg, p, b) for w, p, b in (("cpu", p_cpu, b_cpu),
                                                          ("card", p_dev, b_dev))}
        errs["out"] = card_close(outs["card"][0], outs["cpu"][0], f"(a) {kind} out")
        errs["x"] = card_close(outs["card"][1], outs["cpu"][1], f"(a) {kind} x")
        errs["loss"] = card_close(egnn.loss_fn(cfg, p_dev, b_dev)[0],
                                  egnn.loss_fn(cfg, p_cpu, b_cpu)[0], f"(a) {kind} loss")

        # the reference's equivariance check, on the card
        th = 1.1
        R = torch.tensor([[math.cos(th), -math.sin(th), 0], [math.sin(th), math.cos(th), 0],
                          [0, 0, 1.0]], device=dev)
        shift = torch.tensor([0.5, -1.0, 2.0], device=dev)
        h2, x2 = egnn.forward(cfg, p_dev, {**b_dev, "coords": b_dev["coords"] @ R.T + shift})
        h1, x1 = outs["card"]
        equiv = (float((h1 - h2).abs().max()), float((x1 @ R.T + shift - x2).abs().max()))
        check(max(equiv) <= EGNN_EQUIV_ATOL, f"(a) {kind}: equivariance off by {equiv}")

        # TRAIN_SMOKE_STEPS steps, card vs CPU; the card's twice, bitwise
        step = make_train_step(lambda p, b, cfg=cfg: egnn.loss_fn(cfg, p, b), opt)
        p_init = [x.clone() for x in leaves(p_cpu)]
        s_cpu = init_opt_state(opt, p_cpu)
        twice = []
        for _ in range(2):
            p2 = params_from_numpy(cfg.param_defs(), p0, dev)
            s2 = init_opt_state(opt, p2)
            ms = [step(p2, s2, b_dev)[2] for _ in range(TRAIN_SMOKE_STEPS)]
            twice.append((ms, p2, s2))
        for s in range(TRAIN_SMOKE_STEPS):
            m_cpu = step(p_cpu, s_cpu, b_cpu)[2]
            for k in ("loss", "grad_norm"):
                errs[k] = max(errs.get(k, 0.0), card_close(
                    twice[0][0][s][k], m_cpu[k], f"(a) {kind} step {s} {k}"))
        (ms1, pa, sa), (ms2, pb, sb) = twice
        for a, c, c0 in zip(leaves(pa), leaves(p_cpu), p_init):
            errs["params"] = max(errs.get("params", 0.0), card_close(
                a, c, f"(a) {kind} params", LM_STEP_TOL))
            moved = float((c - c0).norm())
            traj = float((a.cpu() - c).norm()) / (moved or 1.0)
            check(traj <= LM_TRAJ_TOL, f"(a) {kind} params: card and CPU {traj:.3g} of the "
                  f"distance travelled apart (> {LM_TRAJ_TOL})")
            errs["params_traj"] = max(errs.get("params_traj", 0.0), traj)
        for a, c in zip(leaves((sa["m"], sa["v"])), leaves((s_cpu["m"], s_cpu["v"]))):
            errs["moments"] = max(errs.get("moments", 0.0), card_close(
                a, c, f"(a) {kind} moments"))
        for m1, m2 in zip(ms1, ms2):
            for k in ("loss", "grad_norm"):
                exact(m1[k], m2[k], f"(a) {kind} repeated {k}", torch)
        n_leaves = 0
        for a, c in zip(leaves((pa, sa)), leaves((pb, sb))):
            exact(a, c, f"(a) {kind} repeated state", torch)
            n_leaves += 1
        # the same twice at bf16 compute
        bcfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        bstep = make_train_step(lambda p, b, cfg=bcfg: egnn.loss_fn(cfg, p, b), opt)
        bf = []
        for _ in range(2):
            p2 = params_from_numpy(cfg.param_defs(), p0, dev)
            s2 = init_opt_state(opt, p2)
            for _ in range(TRAIN_SMOKE_STEPS):
                bstep(p2, s2, b_dev)
            bf.append(leaves((p2, s2)))
        for a, c in zip(*bf):
            exact(a, c, f"(a) {kind} repeated state at bf16", torch)

        # a failure at REPLAY_FAILURE, restored and replayed
        rstep = make_train_step(lambda p, b, cfg=cfg: egnn.loss_fn(cfg, p, b), ropt)

        def init_state(cfg=cfg):
            params = cfg.init(EGNN_SEED, dev)
            return params, init_opt_state(ropt, params)

        logs = []
        with tempfile.TemporaryDirectory() as d:
            faulty = run(LoopConfig(total_steps=REPLAY_STEPS, ckpt_every=REPLAY_CKPT_EVERY,
                                    ckpt_dir=d, log_every=1, simulate_failure_at=REPLAY_FAILURE),
                         rstep, init_state, lambda s, b=b_dev: b, log=logs.append)
        clean = run(LoopConfig(total_steps=REPLAY_STEPS, log_every=1), rstep, init_state,
                    lambda s, b=b_dev: b, log=lambda line: None)
        restored = REPLAY_FAILURE // REPLAY_CKPT_EVERY * REPLAY_CKPT_EVERY
        check(f"[fault] restoring step {restored}" in logs, f"(a) {kind}: no restore in {logs}")
        check(dict(faulty[2]) == dict(clean[2]), f"(a) {kind}: replayed losses differ")
        for a, c in zip(leaves(faulty[:2]), leaves(clean[:2])):
            exact(a, c, f"(a) {kind}: state after the replay", torch)
        n_edges = int(b_cpu["edge_mask"].sum())
        say(f"phase 14 (a): {kind} smoke (f32 compute, {b_cpu['feats'].shape[0]} nodes, "
            f"{n_edges} real of {b_cpu['senders'].shape[0]} edges, largest in-degree "
            f"{int(torch.bincount(b_cpu['receivers'][b_cpu['edge_mask']]).max())}): "
            f"forward, loss and {TRAIN_SMOKE_STEPS} train steps card == CPU (within rtol 1e-4 "
            f"/ atol 1e-5; params within rtol 1e-4 / atol {LM_STEP_TOL['atol']:g} and each "
            f"leaf within {LM_TRAJ_TOL:g} of the distance it travelled); max abs "
            + json.dumps(errs) + f"; equivariance on the card: |h - h'| {equiv[0]:.3g}, "
            f"|xR + t - x'| {equiv[1]:.3g} (atol {EGNN_EQUIV_ATOL:g}); two runs of the "
            f"{TRAIN_SMOKE_STEPS} steps bitwise equal at f32 ({n_leaves} leaves) and at bf16 "
            f"compute; failure at step {REPLAY_FAILURE}, restored step {restored}, replayed to "
            f"{REPLAY_STEPS}: bitwise equal to the run without it; "
            f"{time.perf_counter() - t:.1f} s")

    # (b) the published CONFIG at each shape that fits one card
    spec = get_arch("egnn")
    report = []
    per = {}
    for name in EGNN_SHAPES:
        shape = spec.shape(name)
        cfg = steps.gnn_cell_config(spec, shape)
        p = shape.params
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        row = {"shape": name, "kind": shape.kind}
        if shape.kind == "gnn_minibatch":
            g = graph.make_powerlaw_graph(p["n_nodes"], p["n_edges"], cfg.d_feat,
                                          n_classes=p["n_classes"], seed=EGNN_SEED, device=dev)
            row["graph_build_s"] = time.perf_counter() - t
            t = time.perf_counter()
            batch = steps.gnn_batch(cfg, shape, dev, EGNN_SEED, graph=g)
            torch.cuda.synchronize()
            row["sample_s"] = time.perf_counter() - t
            check(len(g.indices) == p["n_edges"] and g.n_nodes == p["n_nodes"],
                  f"(b) {name}: the graph has {g.n_nodes} nodes, {len(g.indices)} edges")
            del g
            say(f"phase 14 (b): {name}: the published graph ({p['n_nodes']:,} nodes, "
                f"{p['n_edges']:,} edges, {p['d_feat']} features) built in "
                f"{row['graph_build_s']:.2f} s on the host (its endpoint search and sort on "
                f"the card); one sample_subgraph ({p['batch_nodes']}, {tuple(p['fanouts'])}) "
                f"in {row['sample_s']:.2f} s (the input pipeline's cost per step)")
        else:
            batch = steps.gnn_batch(cfg, shape, dev, EGNN_SEED)
            row["batch_s"] = time.perf_counter() - t
        cell = steps.build_gnn_cell(spec, shape, dev, EGNN_SEED, batch=batch)
        params, state, batch = cell.args
        N, E = batch["feats"].shape[0], batch["senders"].shape[0]
        real_e = int(batch["edge_mask"].sum())
        real_n = int((batch["labels"] >= 0).sum()) if "labels" in batch else N
        if shape.kind == "gnn_minibatch":  # every node of the sample carries features
            real_n = int(torch.unique(torch.cat([batch["senders"][batch["edge_mask"]],
                                                 batch["receivers"][batch["edge_mask"]]])).numel())
        deg = torch.bincount(batch["receivers"][batch["edge_mask"]].long())
        reset_launch_counts()
        times = []
        for i in range(LM_WARMUP + LM_RUNS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, _, metrics = cell.fn(*cell.args)
            ev[1].record()
            ev[1].synchronize()
            if i >= LM_WARMUP:
                times.append(ev[0].elapsed_time(ev[1]))
        counts = launch_counts()
        check(not any(counts.values()), f"(b) {name} launched {counts}")
        check(all(bool(torch.isfinite(metrics[k])) for k in ("loss", "grad_norm")),
              f"(b) {name}: non-finite loss or grad_norm")
        check(int(state["step"]) == LM_WARMUP + LM_RUNS, f"(b) {name}: step {int(state['step'])}")
        ms = statistics.median(times)
        # what autograd keeps for the backward, by leading dim
        live = tree_map(lambda x: x.detach().requires_grad_(True), params)
        with torch.enable_grad():
            sb = saved_bytes(lambda: egnn.loss_fn(cfg, live, batch)[0], {"edges": E, "nodes": N})
        del live
        L = cfg.n_layers
        per[name] = (sb["edges"] / (E * L), sb["nodes"] / (N * L))
        row.update({
            "nodes": N, "real_nodes": real_n, "edges": E, "real_edges": real_e,
            "max_in_degree": int(deg.max()), "ms": ms, "runs_ms": times,
            "nodes_per_s": N / ms * 1e3, "edges_per_s": E / ms * 1e3,
            "model_flops": cell.model_flops,
            "bf16_share": cell.model_flops / ms * 1e3 / BF16_FLOPS_PER_S,
            "loss": float(metrics["loss"]), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "saved_bytes_per_edge_layer": per[name][0],
            "saved_bytes_per_node_layer": per[name][1]})
        report.append(row)
        say(f"phase 14 (b): {name} ({shape.kind}): {N:,} nodes ({real_n:,} real), {E:,} edges "
            f"({real_e:,} real, largest in-degree {row['max_in_degree']}), published CONFIG "
            f"(d_hidden {cfg.d_hidden}, {L} layers, {cfg.n_params():,} f32 parameters, bf16 "
            f"compute): {ms:.3f} ms per train step (median of {LM_RUNS} after {LM_WARMUP} "
            f"warm-up; {', '.join(f'{x:.3f}' for x in times)}), {row['nodes_per_s']:,.0f} "
            f"nodes/s, {row['edges_per_s']:,.0f} edges/s, {cell.model_flops:.4g} model FLOP -> "
            f"{row['bf16_share']:.6f} of {BF16_FLOPS_PER_S / 1e12:g}e12; loss "
            f"{row['loss']:.5f} (finite); peak {row['peak_gib']:.2f} GiB; autograd saves "
            f"{per[name][0]:.1f} B per edge and {per[name][1]:.1f} B per node of a layer")
        del cell, params, state, batch, metrics
        torch.cuda.empty_cache()
    say("phase 14 (b): " + json.dumps(report))

    # (c) ogb_products: the saved bytes scaled to its size
    shape = spec.shape(EGNN_NOT_RUN)
    p = shape.params
    N, E = egnn.pad_nodes(p["n_nodes"]), graph.pad_edges(p["n_edges"])
    cfg = steps.gnn_cell_config(spec, shape)
    e_b, n_b = per["full_graph_sm"]
    saved = (e_b * E + n_b * N) * cfg.n_layers
    inputs = N * (cfg.d_feat + cfg.coord_dim + 1) * 4 + E * (4 + 4 + 1)
    H = cfg.d_hidden
    estimate = (2 * H + 1) * 2 + 6 * H * 2  # m_in, and six [E, H] bf16 tensors
    say(f"phase 14 (c): {EGNN_NOT_RUN} not run: {p['n_nodes']:,} nodes ({N:,} padded), "
        f"{p['n_edges']:,} edges ({E:,} padded); autograd saves {e_b:.1f} B per edge and "
        f"{n_b:.1f} B per node of a layer (measured in (b) at full_graph_sm; the count "
        f"(2 H + 1) x 2 B of m_in + six [E, {H}] bf16 tensors = {estimate} B per edge), so "
        f"{e_b * E / 1e9:.1f} GB per layer of edges and {saved / 1e9:.1f} GB for "
        f"{cfg.n_layers} layers, beside {inputs / 1e9:.2f} GB of inputs, against the card's "
        f"{card_bytes / 1e9:.2f} GB: make_sharded_loss (phase 17) splits them over the "
        "ranks, but ranks sharing this one card still hold them all: it needs several cards")
    check(saved > card_bytes, f"(c) {EGNN_NOT_RUN}: {saved / 1e9:.1f} GB would fit the card")

    # (d) the train CLI as users start it, in subprocesses
    t = time.perf_counter()
    pat = re.compile(r"^step +(\d+) +loss (\S+) ")
    with tempfile.TemporaryDirectory() as d:
        opt_in = [] if DEVICE == "cuda" else ["--device", DEVICE]  # a CPU rehearsal
        cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "egnn", "--steps",
               str(REPLAY_STEPS), "--ckpt-every", str(REPLAY_CKPT_EVERY)] + opt_in
        cmds = {"fault": cli + ["--ckpt-dir", str(Path(d) / "fault"), "--simulate-failure",
                                str(REPLAY_FAILURE)],
                "clean": cli + ["--ckpt-dir", str(Path(d) / "clean")]}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for tag, c in cmds.items():
            say(f"phase 14 (d): {tag}: " + " ".join(c[1:]))
        procs = {tag: subprocess.Popen(c, cwd=d, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                 for tag, c in cmds.items()}
        outs = {}
        for tag, proc in procs.items():
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
            check(proc.returncode == 0, f"(d) {tag} exited {proc.returncode}: {err[-2000:]}")
            outs[tag] = out.splitlines()
    for line in outs["fault"]:
        say(f"phase 14 (d): fault: {line}")
    losses = {tag: [pat.match(x).groups() for x in outs[tag] if pat.match(x)]
              for tag in ("fault", "clean")}
    restored = REPLAY_FAILURE // REPLAY_CKPT_EVERY * REPLAY_CKPT_EVERY
    check([int(s) for s, _ in losses["clean"]] == list(range(REPLAY_STEPS)),
          f"(d) the train CLI without the failure logged {losses['clean']}")
    check(f"[fault] restoring step {restored}" in outs["fault"],
          "(d) the train CLI printed no [fault] restore")
    check(set(losses["fault"]) == set(losses["clean"])
          and sorted({int(s) for s, _ in losses["fault"]}) == list(range(REPLAY_STEPS)),
          f"(d) the train CLI's loss lines differ: {losses}")
    say(f"phase 14 (d): the train CLI (egnn smoke) with and without the failure exits 0, the "
        f"{len(losses['fault'])} loss lines of the failing run equal the "
        f"{len(losses['clean'])} of the other; {time.perf_counter() - t:.1f} s")
    say(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


def build_stacked_index(out_dir: str) -> None:
    """Phase 7's stacked index, in a subprocess with no card: the set-up's
    corpus made again from its seed, split into 8 region shards and
    stacked on the host as ``make_executor("mesh", corpus,
    partitioner=RegionRangePartitioner())`` does, saved to
    ``out_dir/index.pt``; prints its timings as JSON."""
    import dataclasses

    import torch

    from repro_torch.core import RegionRangePartitioner, shard_corpus_np
    from repro_torch.corpus import make_corpus

    t = time.perf_counter()
    corpus = make_corpus(n_docs=N_DOCS, n_terms=N_TERMS, seed=0)
    corpus_s = time.perf_counter() - t
    t = time.perf_counter()
    idx = shard_corpus_np(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                          corpus.pagerank, corpus.n_terms, 8, RegionRangePartitioner(),
                          device="cpu")
    build_s = time.perf_counter() - t
    torch.save({f.name: getattr(idx, f.name) for f in dataclasses.fields(idx)},
               Path(out_dir, "index.pt"))
    print(json.dumps({"corpus_s": corpus_s, "build_s": build_s}), flush=True)


def start_stacked_index() -> dict:
    """Start :func:`build_stacked_index` in a subprocess (before phase 1,
    no card visible), writing into a temporary directory."""
    import os
    import tempfile

    out_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-stacked-"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.build_stacked_index(sys.argv[2])")
    with open(out_dir / "log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(out_dir)], cwd=ROOT,
                                env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"dir": out_dir, "proc": proc, "t0": time.perf_counter()}


def wait_stacked_index(stacked: dict) -> None:
    """Wait for :func:`start_stacked_index`'s subprocess (at the end of
    the set-up); fails unless it exited 0."""
    t = time.perf_counter()
    rc = stacked["proc"].wait(timeout=DRYRUN_TIMEOUT_S)
    log = (stacked["dir"] / "log").read_text()
    check(rc == 0, f"phase 7's stacked index build exited {rc}: {log[-2000:]}")
    say(f"set-up: phase 7's stacked index built on the host in a subprocess "
        f"{log.strip().splitlines()[-1]}; it ended {time.perf_counter() - stacked['t0']:.1f} s "
        f"after its start before phase 1, the set-up waited {time.perf_counter() - t:.1f} s")


def stop_stacked_index(stacked: dict) -> None:
    """Kill :func:`start_stacked_index`'s subprocess if it is left and
    remove its files."""
    import shutil

    if stacked["proc"].poll() is None:
        stacked["proc"].kill()
        stacked["proc"].wait()
    shutil.rmtree(stacked["dir"], ignore_errors=True)


def start_dryrun_cli() -> dict:
    """Phase 15 (a), started before phase 1: the dry-run CLI over every
    arch × shape on the single-pod mesh, one subprocess per arch, all
    started together, each writing its rows and its log into a temporary
    directory.  They trace on ``meta`` on the host's cores, so they run
    with no card visible and at the lowest CPU priority."""
    import os
    import tempfile

    from repro_torch.configs.base import list_archs

    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = {}
    for name in list_archs():
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", name,
               "--mesh", "single", "--out", str(out_dir / f"{name}.jsonl")]
        with open(out_dir / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           preexec_fn=lambda: os.nice(19))
    return {"dir": out_dir, "procs": procs, "t0": time.perf_counter()}


def wait_dryrun_cli(dry: dict) -> None:
    """Wait for phase 15 (a)'s subprocesses to end (at the end of the
    set-up, so that none runs beside a timed phase)."""
    t = time.perf_counter()
    for proc in dry["procs"].values():
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
    dry["wall_s"] = time.perf_counter() - dry["t0"]
    dry["waited_s"] = time.perf_counter() - t


def stop_dryrun_cli(dry: dict) -> None:
    """Kill what is left of phase 15 (a)'s subprocesses and remove their files."""
    import shutil

    for proc in dry["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(dry["dir"], ignore_errors=True)


def dryrun_cli_phase(dry: dict) -> None:
    """Phase 15 (a), checked: every subprocess of :func:`start_dryrun_cli`
    exited 0 with one row per shape and no ``error`` row."""
    from repro_torch.configs.base import get_arch

    n_rows = 0
    for name, proc in dry["procs"].items():
        log = (dry["dir"] / f"{name}.log").read_text()
        check(proc.returncode == 0, f"(a) dryrun --arch {name} exited {proc.returncode}: "
              f"{log[-2000:]}")
        rows = [json.loads(x) for x in (dry["dir"] / f"{name}.jsonl").read_text().splitlines()]
        check(not any("error" in r for r in rows), f"(a) {name}: error rows {rows}")
        want = [(s.name, bool(s.skip)) for s in get_arch(name).shapes]
        check([(r["shape"], "skipped" in r) for r in rows] == want,
              f"(a) {name}: rows {[r['shape'] for r in rows]} for shapes {want}")
        for r in rows:
            if "skipped" in r:
                say(f"phase 15 (a): {name} x {r['shape']}: skipped ({r['skipped'][:60]}...)")
                continue
            say(f"phase 15 (a): {name} x {r['shape']} on 256 H100s (model, data-sheet "
                f"constants): hbm_per_dev_GB {r['hbm_per_dev_GB']:.3f}, bottleneck "
                f"{r['bottleneck']}, roofline_fraction {r['roofline_fraction']:.4f} "
                f"({r['method']}; traced in {r['t_trace_s']} s)")
            n_rows += 1
    say(f"phase 15 (a): python -m repro_torch.launch.dryrun --mesh single: {len(dry['procs'])} "
        f"processes exit 0, {n_rows} rows, no error row; they ended {dry['wall_s']:.1f} s after "
        f"their start before phase 1, the set-up waited {dry['waited_s']:.1f} s for them")


def _digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (bitwise equality of trees
    across processes without moving them)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _lm_train_cut(spec):
    """SmolLM-135M's ``train_4k`` at ``TRAIN_DP_CUT`` (phase 17 (a))."""
    import dataclasses

    shape = spec.shape("train_4k")
    B, S = TRAIN_DP_CUT
    return dataclasses.replace(shape, params={**shape.params, "global_batch": B, "seq_len": S})


def _timed(fn, device: str):
    """``fn()`` and its host ms, the device synchronised before and after."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _train_rank(rank: int, device: str) -> dict:
    """Phase 17 (a) and (b), one rank of the (4, 1) process mesh."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core import collectives as col
    from repro_torch.core import make_process_mesh
    from repro_torch.launch import steps
    from repro_torch.models import egnn
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.specs import use_sharding
    from repro_torch.train.compression import psum_compressed
    from repro_torch.train.loop import batch_axes, value_and_grad
    from repro_torch.train.optimizer import zero1_blocks
    from repro_torch.train.tree import flatten_with_paths, leaves, tree_map

    torch.set_num_threads(1)
    mesh = make_process_mesh(TRAIN_MESH, TRAIN_AXES, device=None if device == "cuda" else device)
    out = {"device": str(mesh.device), "ready": time.time()}
    cuda = device == "cuda"

    # (a) SmolLM-135M train_4k, data-parallel with ZeRO-1
    spec = get_arch(TRAIN_DP_ARCH)
    cfg = spec.config
    cell = steps.build_lm_cell(spec, _lm_train_cut(spec), seed=LM_SEED, mesh=mesh)
    params, opt, batch = cell.args
    axes = batch_axes(mesh)
    shard = mesh.group(axes, mesh.rank).index(mesh.rank)
    rows = tree_map(lambda x: x.narrow(0, shard * (x.shape[0] // 4), x.shape[0] // 4), batch)
    # this rank's gradients of step 1, before the sum: psum_compressed's input
    _, _, local = value_and_grad(lambda p, b: tf.loss_fn(cfg, p, b), params, rows)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ms, runs = [], []
    for _ in range(TRAIN_DP_STEPS):
        (params, opt, m), t = _timed(lambda: cell.fn(params, opt, batch), device)
        ms.append(t)
        runs.append((_digest(leaves(params)), m["loss"].cpu().numpy().tobytes(),
                     m["grad_norm"].cpu().numpy().tobytes(), float(m["loss"]),
                     float(m["grad_norm"])))
    out["lm_peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    # the step's gradient reduction alone: its gather, then the ordered sums
    # (rank 0 keeps the gathered gradients for psum_compressed's check)
    every, out["gather_ms"] = _timed(lambda: mesh.gather_axes(leaves(local), axes), device)
    _, out["sum_ms"] = _timed(lambda: [col.ordered_sum([m[j] for m in every])
                                       for j in range(len(every[0]))], device)
    ms_tree = steps.moment_shardings(cfg.param_defs(), mesh)
    blocks = zero1_blocks(steps.TRAIN_OPT, params, ms_tree)
    out.update(lm_ms=ms, lm_runs=runs,
               moment_bytes=sum(x.nbytes for x in leaves(opt["m"]) + leaves(opt["v"])),
               whole=[p for (p, _), b in zip(flatten_with_paths(params), blocks) if b is None],
               gather_bytes=sum(x.nbytes for x in leaves(local)))
    # psum_compressed over the step-1 gradients, error buffer zero
    with use_sharding(mesh):
        (mean, err), out["compress_ms"] = _timed(lambda: psum_compressed(
            local, tree_map(torch.zeros_like, local), ("data",)), device)
    out["compress_digest"] = _digest(leaves(mean))  # the error buffer stays local
    if mesh.rank == 0:  # the batch axes are psum_compressed's: ("data",)
        out["compress_check"] = _compress_check(leaves(mean), every)
    del every, mean, err, local, cell, params, opt, batch, rows
    if cuda:
        torch.cuda.empty_cache()

    # (b) EGNN full_graph_sm at CONFIG: the sharded loss, then the cell's steps
    spec = get_arch("egnn")
    shape = spec.shape("full_graph_sm")
    gcfg = steps.gnn_cell_config(spec, shape)
    graph = steps.gnn_batch(gcfg, shape, mesh.device, EGNN_SEED)
    gparams = gcfg.init(EGNN_SEED, mesh.device)
    gaxes = egnn.sharded_axes(mesh)
    grows = egnn.graph_rows(graph, col.group_size(mesh, gaxes),
                            mesh.group(gaxes, mesh.rank).index(mesh.rank))
    (loss, metrics, grads), out["gnn_loss_ms"] = _timed(
        lambda: value_and_grad(egnn.make_sharded_loss(gcfg, mesh), gparams, grows), device)
    out["gnn"] = (loss.cpu().numpy().tobytes(), metrics["acc"].cpu().numpy().tobytes(),
                  [g.cpu().numpy() for g in leaves(grads)], float(loss), float(metrics["acc"]))
    out["gnn_rows"] = (grows["feats"].shape[0], grows["senders"].shape[0])
    cell = steps.build_gnn_cell(spec, shape, seed=EGNN_SEED, batch=graph, mesh=mesh)
    gms, gruns = [], []
    for _ in range(TRAIN_GNN_STEPS):
        (_, _, m), t = _timed(lambda: cell.fn(*cell.args), device)
        gms.append(t)
        gruns.append((float(m["loss"]), float(m["grad_norm"])))
    out.update(gnn_ms=gms, gnn_runs=gruns,
               gnn_digest=_digest(leaves(cell.args[0])))
    return out


def _compress_check(mean: list, group: list) -> dict:
    """Rank 0 of phase 17 (a): ``psum_compressed``'s mean against the exact
    mean of the gathered gradients (relative error, the reference test's
    measure) and against its plain recomputation from them (bitwise): each
    member's leaf quantized on its absmax scale, re-quantized on the
    group's largest, summed in int32, times the scale over the count."""
    import torch

    from repro_torch.core.collectives import ordered_sum

    n = len(group)
    err = top = 0.0
    same = True
    for j, got in enumerate(mean):
        gs = [m[j].float() for m in group]
        scales = [torch.clamp_min(g.abs().max(), 1e-12) / 127.0 for g in gs]
        qs = [torch.clamp(torch.round(g / s), -127, 127).to(torch.int8) for g, s in zip(gs, scales)]
        s_max = torch.stack(scales).max()
        q8 = [torch.clamp(torch.round(q.float() * s / s_max), -127, 127).to(torch.int8)
              for q, s in zip(qs, scales)]
        plain = ordered_sum([q.to(torch.int32) for q in q8]).float() * s_max / n
        same = same and plain.dtype == got.dtype and bool(
            torch.equal(plain.view(torch.int32), got.view(torch.int32)))
        exact = ordered_sum(gs) / n
        err = max(err, float((got - exact).abs().max()))
        top = max(top, float(exact.abs().max()))
    return {"rel_err": err / (top + 1e-9), "plain_bitwise": same, "leaves": len(mean)}


def _nccl_rank(rank: int, device: str) -> dict:
    """Phase 17 (c): the data-parallel step (SmolLM-135M SMOKE) and the
    sharded loss (EGNN SMOKE, the full graph) on a (1, 1) process mesh."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.core import make_process_mesh
    from repro_torch.launch import steps
    from repro_torch.models import egnn
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import leaves

    mesh = make_process_mesh((1, 1), ("data", "model"), device=None if device == "cuda" else device)
    spec = get_arch(TRAIN_DP_ARCH)
    spec = dataclasses.replace(spec, config=spec.smoke_config)
    cell = steps.build_lm_cell(spec, _smoke_train_cut(spec), seed=LM_SEED, mesh=mesh)
    runs = []
    for _ in range(TRAIN_DP_STEPS):
        _, _, m = cell.fn(*cell.args)
        runs.append((_digest(leaves(cell.args[0])), m["loss"].cpu().numpy().tobytes(),
                     m["grad_norm"].cpu().numpy().tobytes()))
    cfg, batch = egnn_smoke("full", mesh.device)
    loss, metrics, grads = value_and_grad(egnn.make_sharded_loss(cfg, mesh),
                                          cfg.init(EGNN_SEED, mesh.device), batch)
    return {"device": str(mesh.device), "backend": mesh.backend, "lm": runs,
            "gnn": (loss.cpu().numpy().tobytes(), metrics["acc"].cpu().numpy().tobytes(),
                    _digest(leaves(grads)))}


def _smoke_train_cut(spec):
    """A SMOKE LM's ``train_4k`` at ``LM_SMOKE_BATCH`` (phase 17 (c))."""
    import dataclasses

    shape = spec.shape("train_4k")
    B, S = LM_SMOKE_BATCH
    return dataclasses.replace(shape, params={**shape.params, "global_batch": B, "seq_len": S})


def train_collectives_phase() -> None:
    """Phase 17: the train-side collectives across processes (see the
    module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core import make_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import egnn
    from repro_torch.models import transformer as tf
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.train.tree import leaves

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    n = math.prod(TRAIN_MESH)
    B, S = TRAIN_DP_CUT
    spec = get_arch(TRAIN_DP_ARCH)
    B0, S0 = (spec.shape("train_4k").params[k] for k in ("global_batch", "seq_len"))
    say(f"phase 17: {card_line()}")

    # (a) + (b): one run_ranks call of 4 gloo ranks on the card
    t0, t = time.time(), time.perf_counter()
    outs = run_ranks(_train_rank, n, args=(DEVICE,), backend="gloo", timeout_s=TRAIN_TIMEOUT_S)
    ranks_s = time.perf_counter() - t
    start_s = [o["ready"] - t0 for o in outs]
    say(f"phase 17: {n} gloo ranks on {sorted({o['device'] for o in outs})}, mesh "
        f"{dict(zip(TRAIN_AXES, TRAIN_MESH))}: rank start-up {min(start_s):.1f}-"
        f"{max(start_s):.1f} s; the ranks' whole run {ranks_s:.1f} s")

    # (a) against the one-process microbatches=4 step on the card
    cell = steps.build_lm_cell(spec, _lm_train_cut(spec), dev, LM_SEED)
    params, opt, batch = cell.args
    step = make_train_step(lambda p, b: tf.loss_fn(spec.config, p, b), steps.TRAIN_OPT,
                           microbatches=n)
    # a warm-up, as the ranks' own gradients warm them: the first row's
    # value and gradients, which leave the state as it is
    value_and_grad(lambda p, b: tf.loss_fn(spec.config, p, b), params,
                   {k: v[:1] for k, v in batch.items()})
    want, one_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_DP_STEPS):
        (params, opt, m), t = _timed(lambda: step(params, opt, batch), DEVICE)
        one_ms.append(t)
        want.append((_digest(leaves(params)), m["loss"].cpu().numpy().tobytes(),
                     m["grad_norm"].cpu().numpy().tobytes()))
    one_peak = torch.cuda.max_memory_allocated()
    dense_bytes = sum(x.nbytes for x in leaves(opt["m"]) + leaves(opt["v"]))
    whole_bytes = 2 * sum(p.nbytes for p, path in zip(leaves(params), _paths(params))
                          if path in outs[0]["whole"])
    del cell, params, opt, batch, step
    torch.cuda.empty_cache()
    for r, o in enumerate(outs):
        for i, (got, w) in enumerate(zip(o["lm_runs"], want)):
            check(got[:3] == w, f"phase 17 (a): rank {r} step {i}: params, loss or grad_norm "
                                f"differ from the one-process microbatches={n} step")
        check(o["moment_bytes"] == (dense_bytes - whole_bytes) // n + whole_bytes,
              f"phase 17 (a): rank {r} holds {o['moment_bytes']} moment bytes")
        check(o["compress_digest"] == outs[0]["compress_digest"],
              f"phase 17 (a): rank {r}'s psum_compressed differs from rank 0's")
    cc = outs[0]["compress_check"]
    check(cc["plain_bitwise"], "phase 17 (a): psum_compressed differs from its plain "
                               "recomputation from the gathered gradients")
    check(cc["rel_err"] < COMPRESS_REL, f"phase 17 (a): psum_compressed relative error "
                                        f"{cc['rel_err']:.4g} >= {COMPRESS_REL}")
    lm = {
        "per_rank_ms_per_step": [statistics.median(o["lm_ms"]) for o in outs],
        "per_rank_runs_ms": [o["lm_ms"] for o in outs],
        "one_process_ms_per_step": statistics.median(one_ms), "one_process_runs_ms": one_ms,
        "gather_ms": [o["gather_ms"] for o in outs], "sum_ms": [o["sum_ms"] for o in outs],
        "gather_bytes_per_rank": outs[0]["gather_bytes"],
        "moment_bytes_per_rank": outs[0]["moment_bytes"], "one_process_moment_bytes": dense_bytes,
        "whole_leaves": outs[0]["whole"], "peak_gib_per_rank": [o["lm_peak"] / 2**30 for o in outs],
        "one_process_peak_gib": one_peak / 2**30,
        "losses": [r[3] for r in outs[0]["lm_runs"]],
        "grad_norms": [r[4] for r in outs[0]["lm_runs"]],
        "compress_ms": [o["compress_ms"] for o in outs], "compress_rel_err": cc["rel_err"]}
    say(f"phase 17 (a): {TRAIN_DP_ARCH} train_4k at published widths, global batch {B} x {S} "
        f"(published {B0} x {S0}: cut to one sequence per rank), remat {spec.config.remat}, "
        f"TRAIN_OPT (ZeRO-1), {TRAIN_DP_STEPS} steps: params, loss and grad_norm after each "
        f"step bitwise equal on the {n} ranks and to the one-process microbatches={n} step "
        f"on the card; ms per step (host clock, synchronised) per rank "
        f"{[round(x, 3) for x in lm['per_rank_ms_per_step']]} against the one-process "
        f"{lm['one_process_ms_per_step']:.3f}; the gradient gather "
        f"({lm['gather_bytes_per_rank'] / 1e6:.1f} MB a rank, through the host) "
        f"{[round(x, 3) for x in lm['gather_ms']]} ms and its ordered sums "
        f"{[round(x, 3) for x in lm['sum_ms']]} ms; moments {lm['moment_bytes_per_rank']:,} B "
        f"a rank against {dense_bytes:,} in one process "
        f"({lm['moment_bytes_per_rank'] / dense_bytes:.4f}; whole: {lm['whole_leaves']}); "
        f"peak {[round(x, 2) for x in lm['peak_gib_per_rank']]} GiB a rank (one process "
        f"{lm['one_process_peak_gib']:.2f}); psum_compressed over the step-1 gradients the "
        f"same bits on every rank, rank 0: relative error {cc['rel_err']:.4g} against the "
        f"exact mean (< {COMPRESS_REL}), bitwise its plain recomputation over "
        f"{cc['leaves']} leaves; {card_line()}")
    say("phase 17 (a): " + json.dumps(lm))

    # (b) against the one-process loop on the same mesh shape on the card
    gspec = get_arch("egnn")
    shape = gspec.shape("full_graph_sm")
    gcfg = steps.gnn_cell_config(gspec, shape)
    graph = steps.gnn_batch(gcfg, shape, dev, EGNN_SEED)
    gparams = gcfg.init(EGNN_SEED, dev)
    loop = make_mesh(TRAIN_MESH, TRAIN_AXES, device=dev)
    (loss, metrics, grads), loop_ms = _timed(
        lambda: value_and_grad(egnn.make_sharded_loss(gcfg, loop), gparams, graph), DEVICE)
    w_loss, w_acc = loss.cpu().numpy().tobytes(), metrics["acc"].cpu().numpy().tobytes()
    w_grads = [g.cpu().numpy() for g in leaves(grads)]
    plain = float(egnn.loss_fn(gcfg, gparams, graph)[0])
    bitwise_grads = True
    for r, o in enumerate(outs):
        g_loss, g_acc, g_grads = o["gnn"][:3]
        check(g_loss == w_loss and g_acc == w_acc,
              f"phase 17 (b): rank {r}'s loss or accuracy differs from the loop's (bitwise)")
        for a, b in zip(g_grads, w_grads):
            bitwise_grads = bitwise_grads and a.tobytes() == b.tobytes()
            check(np.allclose(a, b, **GNN_GRAD_TOL), f"phase 17 (b): rank {r}'s gradients "
                                                     f"beyond GRAD_TOL of the loop's")
    sharded = outs[0]["gnn"][3]
    check(abs(sharded - plain) <= GNN_BF16_REL * abs(plain),
          f"phase 17 (b): sharded loss {sharded} vs loss_fn {plain}")
    digests = {o["gnn_digest"] for o in outs}
    check(len(digests) == 1, "phase 17 (b): the ranks' params differ after the steps")
    gnn = {"nodes": graph["feats"].shape[0], "edges": graph["senders"].shape[0],
           "rows_per_rank": list(outs[0]["gnn_rows"]), "loss": sharded, "loss_fn": plain,
           "acc": outs[0]["gnn"][4], "grads_bitwise": bitwise_grads,
           "loss_ms_per_rank": [o["gnn_loss_ms"] for o in outs], "loop_loss_ms": loop_ms,
           "step_ms_per_rank": [o["gnn_ms"] for o in outs],
           "step_losses": [r[0] for r in outs[0]["gnn_runs"]],
           "step_grad_norms": [r[1] for r in outs[0]["gnn_runs"]]}
    say(f"phase 17 (b): egnn full_graph_sm at CONFIG ({gcfg.n_layers} layers, d_hidden "
        f"{gcfg.d_hidden}, {str(gcfg.compute_dtype).replace('torch.', '')} compute): {gnn['nodes']:,} nodes and {gnn['edges']:,} edges "
        f"({gnn['rows_per_rank'][0]} and {gnn['rows_per_rank'][1]} a rank): make_sharded_loss "
        f"on {n} ranks == the one-process loop on the (4, 1) mesh on the card bitwise in loss "
        f"and accuracy, gradients {'bitwise' if bitwise_grads else 'within GRAD_TOL'}; loss "
        f"{sharded:.6f} against loss_fn's {plain:.6f} (within {GNN_BF16_REL:g}); value and "
        f"gradients ms per rank {[round(x, 3) for x in gnn['loss_ms_per_rank']]}, the loop "
        f"{loop_ms:.3f}; {TRAIN_GNN_STEPS} train steps with ZeRO-1, ms per rank "
        f"{[[round(x, 3) for x in o['gnn_ms']] for o in outs]} (the first builds the "
        f"plans); params equal on every rank; {card_line()}")
    say("phase 17 (b): " + json.dumps(gnn))
    del graph, gparams, grads, loss, metrics
    torch.cuda.empty_cache()

    # (c) NCCL at world size 1, against the one-card step and loop
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    (got,), nccl_ms = _timed(lambda: run_ranks(_nccl_rank, 1, args=(DEVICE,), backend=backend,
                                               timeout_s=TRAIN_TIMEOUT_S), DEVICE)
    sspec = get_arch(TRAIN_DP_ARCH)
    sspec = dataclasses.replace(sspec, config=sspec.smoke_config)
    cell = steps.build_lm_cell(sspec, _smoke_train_cut(sspec), dev, LM_SEED)
    runs = []
    for _ in range(TRAIN_DP_STEPS):
        _, _, m = cell.fn(*cell.args)
        runs.append((_digest(leaves(cell.args[0])), m["loss"].cpu().numpy().tobytes(),
                     m["grad_norm"].cpu().numpy().tobytes()))
    check(got["lm"] == runs, "phase 17 (c): the (1, 1) process mesh's data-parallel step "
                             "differs from the one-card step")
    cfg, batch = egnn_smoke("full", dev)
    loss, metrics, grads = value_and_grad(
        egnn.make_sharded_loss(cfg, make_mesh((1, 1), ("data", "model"), device=dev)),
        cfg.init(EGNN_SEED, dev), batch)
    check(got["gnn"] == (loss.cpu().numpy().tobytes(), metrics["acc"].cpu().numpy().tobytes(),
                         _digest(leaves(grads))),
          "phase 17 (c): the (1, 1) process mesh's sharded loss differs from the one-card loop")
    say(f"phase 17 (c): {got['backend']} at world size 1 on {got['device']}: the "
        f"data-parallel step ({TRAIN_DP_ARCH} SMOKE, {LM_SMOKE_BATCH[0]} x {LM_SMOKE_BATCH[1]}, "
        f"ZeRO-1, {TRAIN_DP_STEPS} steps) == the one-card step and the sharded loss (EGNN SMOKE "
        f"full graph) == the one-card loop, bitwise (params, loss, grad_norm; loss, accuracy, "
        f"gradients); {nccl_ms / 1e3:.1f} s with the rank's start-up")
    say(f"phase 17: {time.perf_counter() - t_phase:.1f} s; no run on several cards was "
        "possible (one card on this host)")


def _paths(tree) -> list[str]:
    from repro_torch.train.tree import flatten_with_paths

    return [p for p, _ in flatten_with_paths(tree)]


def roofline_phase(dry: dict) -> None:
    """Phase 15 (see the module docstring); (a) ran before phase 2."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "phase 15: f32 matmuls must run at full f32, no TF32 (the f32 bound's peak)")
    dev = torch.device(DEVICE)
    mesh = make_host_mesh(device=dev)
    check(mesh.axis_sizes == (1, 1), f"(b) the host mesh is {mesh.axis_sizes}, not (1, 1)")
    report = []
    reset_launch_counts()
    for arch, shape_name, cut in ROOFLINE_CELLS:
        t = time.perf_counter()
        spec = get_arch(arch)
        shape = spec.shape(shape_name)
        if cut is not None:
            shape = dataclasses.replace(shape, params={**shape.params, "global_batch": cut[0],
                                                       "seq_len": cut[1]})
        row = dryrun.run_cell(spec, shape, mesh, "host_1x1")
        g = row["global"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        cell = build_cell(spec, shape, mesh, device=dev, seed=LM_SEED)
        real_args = sum(x.nbytes for x in rf.tensor_leaves(cell.args))
        # (i)-(iii): one counted run, which is also the warm-up
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        flops_total = fc.get_total_flops()
        times = []
        for _ in range(LM_RUNS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            cell.fn(*cell.args)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        ms = statistics.median(times)
        check(flops_total == sum(g["flops_by_dtype"].values()),
              f"(b)(i) {arch} {shape_name}: the dry-run counts "
              f"{g['flops_by_dtype']} FLOPs, FlopCounterMode {flops_total} on the card")
        check(g["argument_bytes"] == real_args,
              f"(b)(ii) {arch} {shape_name}: the dry-run's arguments {g['argument_bytes']} B, "
              f"the cell's {real_args} B")
        pred = g["peak_bytes"]
        ratio = peak / pred
        if pred > PEAK_CHECK_BYTES:
            check(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
                  f"(b)(iii) {arch} {shape_name}: measured peak {peak} B is {ratio:.4f} of the "
                  f"predicted {pred} B (outside {PEAK_RATIO})")
        t_flops = sum(f / rf.peak_flops(getattr(torch, d))
                      for d, f in g["flops_by_dtype"].items()) * 1e3
        t_io = g["io_bytes"] / rf.HBM_BW * 1e3
        for what, bound in (("FLOPs", t_flops), ("bytes", t_io)):
            check(ms * BOUND_SLACK >= bound,
                  f"(b)(iv) {arch} {shape_name}: {ms:.3f} ms beats the {what} bound "
                  f"{bound:.3f} ms")
        entry = {"arch": arch, "shape": shape_name, "params": shape.params, "ms": ms,
                 "runs_ms": times, "flops_by_dtype": g["flops_by_dtype"],
                 "argument_bytes": real_args, "io_bytes": g["io_bytes"],
                 "traced_bytes": g["bytes"], "bound_flops_ms": t_flops, "bound_io_ms": t_io,
                 "model_t_compute_ms": row["t_compute_s"] * 1e3,
                 "model_t_memory_ms": row["t_memory_s"] * 1e3,
                 "predicted_peak_bytes": pred, "measured_peak_bytes": peak,
                 "peak_ratio": ratio, "roofline_fraction": row["roofline_fraction"],
                 "measured_fraction_of_model": max(row["t_compute_s"], row["t_memory_s"])
                 * 1e3 / ms}
        report.append(entry)
        say(f"phase 15 (b): {arch} {shape_name} {dict(shape.params)} on the (1, 1) host mesh: "
            f"(i) FLOPs {g['flops_by_dtype']} = FlopCounterMode over the CUDA step "
            f"({flops_total}); (ii) arguments {real_args} B = the cell's nbytes; (iii) peak "
            f"predicted {pred / 2**30:.3f} GiB, measured {peak / 2**30:.3f} GiB (ratio "
            f"{ratio:.4f}{', held to ' + str(PEAK_RATIO) if pred > PEAK_CHECK_BYTES else ''}); "
            f"(iv) {ms:.3f} ms per step (median of {LM_RUNS}; {', '.join(f'{x:.3f}' for x in times)}) "
            f">= the bounds {t_flops:.3f} ms (FLOPs at each dtype's peak) and {t_io:.3f} ms "
            f"(arguments read once + donated written once at 3.35e12 B/s); the model's traced "
            f"terms: compute {entry['model_t_compute_ms']:.3f} ms, memory "
            f"{entry['model_t_memory_ms']:.3f} ms (unfused eager bytes {g['bytes']:.4g}), "
            f"roofline_fraction {row['roofline_fraction']:.4f} (not checked); "
            f"{time.perf_counter() - t:.1f} s")
        del cell
        torch.cuda.empty_cache()
    counts = launch_counts()
    check(not any(counts.values()), f"phase 15 launched {counts}")
    say("phase 15 (b): " + json.dumps(report))
    dryrun_cli_phase(dry)
    say(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


def numpy_tree(tree):
    """A nested dict of tensors as numpy arrays (for ``params_from_numpy``)."""
    return {k: numpy_tree(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}


def lm_smoke_parity(name: str, tag: str) -> None:
    """A SMOKE LM at f32 compute, card vs CPU from the same weights (phase
    12, phase 13 (a)): ``forward`` (logits and aux loss), a 32-token
    ``prefill`` into a 48-slot cache, a ``decode_step`` at 32 and both
    caches within ``SMOKE_TOL``; for an MoE config also the routing (each
    MoE call's top-k experts), identical."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import params_from_numpy

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_arch(name).smoke_config, compute_dtype=torch.float32)
    p_cpu = cfg.init(LM_SEED, "cpu")
    params = {"cpu": p_cpu, "card": params_from_numpy(cfg.param_defs(), numpy_tree(p_cpu), dev)}
    b = lm_batch(LMDataConfig(cfg.vocab, 32, 2, LM_SEED), 0, "cpu")
    route = moe_lib._route
    outs, routes = {}, {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        record = routes[where] = []

        def recording(x, p, c, record=record):
            out = route(x, p, c)
            record.append(out[2].cpu())
            return out

        moe_lib._route = recording
        try:
            logits, aux = tf.forward(cfg, params[where], b["tokens"].to(d))
            cache = tf.make_cache(cfg, 2, 48, d)
            pre = tf.prefill(cfg, params[where], b["tokens"].to(d), cache)[0]
            dec = tf.decode_step(cfg, params[where], cache, b["labels"][:, -2].to(d), 32)[0]
        finally:
            moe_lib._route = route
        outs[where] = {"forward": logits, "aux": aux, "prefill": pre, "decode": dec,
                       "cache k": cache["k"], "cache v": cache["v"]}
    errs = {k: card_close(outs["card"][k], outs["cpu"][k], f"{tag}: {name} {k}")
            for k in outs["cpu"]}
    line = (f"{tag}: {name} smoke (f32 compute): card == CPU within rtol 1e-4 / atol 1e-5 "
            "(forward, 32-token prefill, decode at 32)")
    if cfg.is_moe:
        n = 3 * cfg.n_layers  # forward, prefill and decode, per layer
        check(len(routes["card"]) == len(routes["cpu"]) == n
              and all(torch.equal(a, c) for a, c in zip(routes["card"], routes["cpu"])),
              f"{tag}: {name}: the routing differs between the card and the CPU")
        line += (f"; routing identical in all {n} MoE calls (top-{cfg.top_k} of "
                 f"{cfg.n_experts} experts); aux {float(outs['card']['aux']):.6f}")
    say(line + "; max abs " + json.dumps(errs))


def lm_serve(spec, tag: str, report: list, check_overrides: dict | None = None) -> None:
    """One published LM's serving (phase 12, phase 13 (b)): f32 parameters
    at ``spec.config``, bf16 compute; the decode-after-prefill check (under
    ``check_overrides``); each serving cell at its ``LM_CUTS`` cut, timed
    and checked; a row per cell appended to ``report``.  The parameters
    and caches are freed before it returns."""
    import dataclasses

    import torch

    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_lm_cell
    from repro_torch.models import transformer as tf

    dev = torch.device(DEVICE)
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    name = spec.name
    cfg = spec.config
    t = time.perf_counter()
    params = cfg.init(LM_SEED, dev)
    torch.cuda.synchronize()
    param_bytes = cfg.n_params() * 4
    kv_token = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 2
    say(f"{tag}: {name}: f32 parameters {param_bytes / 1e9:.3f} GB initialised in "
        f"{time.perf_counter() - t:.1f} s; KV cache {kv_token} bytes per token "
        f"(layers {cfg.n_layers} x 2 x kv heads {cfg.n_kv_heads} x d_head {cfg.d_head} x 2)")

    # full width: decode of token S after an S-token prefill == the
    # (S+1)-token prefill's last position, within LM_BF16_TOL
    S = LM_CHECK_S
    ccfg = dataclasses.replace(cfg, **(check_overrides or {}))
    toks = lm_batch(LMDataConfig(cfg.vocab, S + 1, 1, LM_SEED), 0, dev)["tokens"]
    cache = tf.make_cache(ccfg, 1, 2 * S, dev)
    tf.prefill(ccfg, params, toks[:, :S], cache)
    dec = tf.decode_step(ccfg, params, cache, toks[:, S], S)[0]
    one = dataclasses.replace(ccfg, attn_chunk=S + 1)
    full = tf.prefill(one, params, toks, tf.make_cache(one, 1, S + 1, dev))[0]
    d, v = dec[:, :cfg.vocab].float(), full[:, :cfg.vocab].float()
    check(bool(torch.isfinite(d).all() and torch.isfinite(v).all()),
          f"{tag}: {name}: non-finite logits in the decode check")
    rel = float((d - v).abs().max() / v.abs().max())
    check(rel <= LM_BF16_TOL, f"{tag}: {name}: decode at {S} vs the {S + 1}-token "
          f"prefill differ by {rel:.4g} of the largest logit (> {LM_BF16_TOL})")
    say(f"{tag}: {name}: decode of token {S} after a {S}-token prefill == the "
        f"{S + 1}-token prefill's last logits within {rel:.4g} of the largest |logit| "
        f"(tolerance {LM_BF16_TOL}); argmax equal: {bool(d.argmax() == v.argmax())}")
    del cache, dec, full, d, v, toks

    for shape in spec.shapes:
        if shape.skip:
            say(f"{tag}: {name} {shape.name} not run (skip): {shape.skip}")
            continue
        if (name, shape.name) not in LM_CUTS:
            if shape.kind == "lm_train":
                say(f"{tag}: {name} {shape.name}: training, phase 13 (c)")
            else:
                say(f"{tag}: {name} {shape.name} not run (the window variant runs on "
                    "SmolLM-135M only, for time)")
            continue
        B0, S0 = shape.params["global_batch"], shape.params["seq_len"]
        B, S = LM_CUTS[(name, shape.name)]
        if (B, S) == (B0, S0):
            why = "run as published"
        elif B0 * S0 * kv_token + param_bytes > card_bytes:
            why = "does not fit the card"
        else:
            why = "fits the card; cut for the time limit"
        say(f"{tag}: {name} {shape.name}: published {B0} x {S0} = KV "
            f"{B0 * S0 * kv_token / 1e9:.2f} GB beside {param_bytes / 1e9:.2f} GB of "
            f"parameters ({why}: the card holds {card_bytes / 1e9:.2f} GB); run at "
            f"{B} x {S} = KV {B * S * kv_token / 1e9:.2f} GB")
        cut = dataclasses.replace(shape, params={**shape.params, "global_batch": B,
                                                 "seq_len": S})
        torch.cuda.reset_peak_memory_stats()
        cell = build_lm_cell(spec, cut, dev, LM_SEED, params=params)
        warm, runs = LM_LONG if S > 32768 else (LM_WARMUP, LM_RUNS)
        reset_launch_counts()
        times = []
        for i in range(warm + runs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            logits = cell.fn(*cell.args)[0]  # (the cache it returns is the cell's)
            ev[1].record()
            ev[1].synchronize()
            if i >= warm:
                times.append(ev[0].elapsed_time(ev[1]))
        counts = launch_counts()
        check(not any(counts.values()), f"{tag}: {name} {shape.name} launched {counts}")
        check(logits.shape == (B, cfg.padded_vocab)
              and bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
              f"{tag}: {name} {shape.name}: logits not finite or of shape "
              f"{tuple(logits.shape)}")
        ms = statistics.median(times)
        n_tok = B * S if shape.kind == "lm_prefill" else B
        row = {"model": name, "shape": shape.name, "kind": shape.kind, "batch": B,
               "seq_len": S, "ms": ms, "runs_ms": times, "tokens_per_s": n_tok / ms * 1e3,
               "model_flops": cell.model_flops,
               "bf16_share": cell.model_flops / ms * 1e3 / BF16_FLOPS_PER_S,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if "attn_window" in shape.params:
            row["attn_window"] = shape.params["attn_window"]
        report.append(row)
        say(f"{tag}: {name} {shape.name} at {B} x {S}: {ms:.3f} ms per "
            f"{'prefill' if shape.kind == 'lm_prefill' else 'decode step'} (median of "
            f"{runs} after {warm} warm-up), {row['tokens_per_s']:.1f} tokens/s, "
            f"{cell.model_flops:.4g} model FLOP -> {row['bf16_share']:.5f} of "
            f"{BF16_FLOPS_PER_S / 1e12:g}e12; logits finite; "
            f"peak {row['peak_gib']:.2f} GiB")
        del cell, logits
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def recsys_geo(n: int, side: float, q_rects, device):
    """Phase 9's geo dict: candidate footprints drawn as
    examples/recsys_retrieval.py draws them (``GEO_RECTS`` square rects of
    ``side`` at uniform corners, unit amps), unit query amps."""
    import torch

    from repro_torch.data.recsys import make_generator

    g = make_generator(RECSYS_SEED, 2, device)
    lo = torch.rand((n, GEO_RECTS, 2), generator=g, device=device) * 0.9
    return {"cand_rects": torch.cat([lo, lo + side], dim=2),
            "cand_amps": torch.ones((n, GEO_RECTS), device=device),
            "q_rects": torch.tensor(q_rects, dtype=torch.float32, device=device),
            "q_amps": torch.ones((len(q_rects),), device=device), "weight": GEO_WEIGHT}


def recsys_profiles():
    """Phase 5 for phase 9's cells: one profiler pass over one step of
    each (the geo-blended retrieval, then every arch's serve shapes), each
    cell built anew and freed after.  Yields (name, lines)."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_recsys_cell

    dev = torch.device(DEVICE)
    cells = [("two-tower-retrieval", "retrieval_cand"), ("autoint", "retrieval_cand")] + [
        (a, s) for a in RECSYS_ARCHS for s in ("serve_p99", "serve_bulk")]
    for arch, shape_name in cells:
        spec = get_arch(arch)
        shape = spec.shape(shape_name)
        geo = (recsys_geo(shape.params["n_candidates"], 0.08, GEO_Q_RECTS, dev)
               if (arch, shape_name) == ("two-tower-retrieval", "retrieval_cand") else None)
        cell = build_recsys_cell(spec, shape, dev, RECSYS_SEED, geo=geo)
        cell.fn(*cell.args)  # warm-up outside the profiler
        yield f"{arch} {shape_name}", profile_batch(lambda: cell.fn(*cell.args), torch, ())
        del cell, geo
        torch.cuda.empty_cache()


def lm_profiles():
    """Phase 5 for phases 12–13's LMs: one profiler pass over a prefill of
    ``LM_PROFILE_CUT[0]`` tokens and one over a decode step at
    ``LM_PROFILE_CUT[1]`` cached tokens (batch 1) of each published
    config, and one over a train step of ``LM_PROFILE_CUT[0]`` tokens of
    ``LM_PROFILE_TRAIN``, each model built anew and freed after.
    Yields (name, lines)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_lm_cell

    dev = torch.device(DEVICE)
    for name in LM_ARCHS + MOE_ARCHS:
        spec = get_arch(name)
        params = spec.config.init(LM_SEED, dev)
        shapes = [("prefill_32k", LM_PROFILE_CUT[0]), ("decode_32k", LM_PROFILE_CUT[1])]
        if name == LM_PROFILE_TRAIN:
            shapes.append(("train_4k", LM_PROFILE_CUT[0]))
        for shape_name, S in shapes:
            shape = spec.shape(shape_name)
            cut = dataclasses.replace(shape, params={**shape.params, "global_batch": 1,
                                                     "seq_len": S})
            # the train step writes its parameters in place: its own copy
            cell = build_lm_cell(spec, cut, dev, LM_SEED,
                                 params=None if shape.kind == "lm_train" else params)
            cell.fn(*cell.args)  # warm-up outside the profiler
            yield (f"{name} {shape_name} at 1 x {S}",
                   profile_batch(lambda: cell.fn(*cell.args), torch, ()))
            del cell
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()


def egnn_profiles():
    """Phase 5 for phase 14's cells: one profiler pass over one train step
    of the published EGNN at each of ``EGNN_SHAPES``, each cell built anew
    (``minibatch_lg``'s graph too) and freed after.  Yields (name, lines)."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_gnn_cell

    dev = torch.device(DEVICE)
    spec = get_arch("egnn")
    for name in EGNN_SHAPES:
        cell = build_gnn_cell(spec, spec.shape(name), dev, EGNN_SEED)
        cell.fn(*cell.args)  # warm-up outside the profiler
        yield f"egnn {name} train step", profile_batch(lambda: cell.fn(*cell.args), torch, ())
        del cell
        torch.cuda.empty_cache()


def narrow_batch(batch, i: int, n: int):
    """``n`` copies of query ``i`` of ``batch``, its footprint cut to the
    middle fifth of its first rect (the other rect slots padding)."""
    terms = batch.terms[i : i + 1].cpu().repeat(n, 1)
    r0 = batch.rects[i, 0].cpu()
    c, h = (r0[:2] + r0[2:]) / 2, (r0[2:] - r0[:2]) / 10
    rects = batch.rects.new_tensor([1.0, 1.0, 0.0, 0.0]).cpu().repeat(n, batch.rects.shape[1], 1)
    rects[:, 0, :2], rects[:, 0, 2:] = c - h, c + h
    amps = batch.amps.new_zeros((n, batch.amps.shape[1])).cpu()
    amps[:, 0] = 1.0
    return type(batch)(terms, rects, amps)


def profile_batch(run, torch, spans) -> list[str]:
    """One profiler pass over ``run()`` (one batch).  For each stage span
    in ``spans``: its host ms, its extent on the device timeline (the
    profiler's device-side annotation of the span) and the device-busy ms
    inside that extent, each summed over the span's runs (one per shard
    of a sharded batch); then the device's busy time and idle share over the
    batch, and the device ops that took the longest.  Busy time is the
    union of kernel, copy and set intervals, annotations excluded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function


    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.batch"):
            run()
            torch.cuda.synchronize()
    events = prof.events()
    labels = {*spans, "chip_smoke.batch"}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    work = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in device if e.name not in labels)
    marks: dict[str, list] = {}  # a sharded batch runs each span once per shard
    for e in device:
        if e.name in spans:
            marks.setdefault(e.name, []).append(e.time_range)

    def busy_us(w0, w1):
        busy, covered = 0.0, w0  # union of work intervals inside [w0, w1)
        for s0, s1, _ in work:
            s0, s1 = max(s0, covered), min(s1, w1)
            if s1 > s0:
                busy += s1 - s0
                covered = s1
        return busy

    lines = []
    for name in spans:
        host = sum(e.cpu_time_total for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)
        line = f"{name}: host {host / 1e3:.3f} ms"
        if name in marks:
            ext = sum(m.end - m.start for m in marks[name])
            busy = sum(busy_us(m.start, m.end) for m in marks[name])
            line += (f", device extent {ext / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms"
                     + (f" (summed over {len(marks[name])} spans)" if len(marks[name]) > 1
                        else ""))
        lines.append(line)
    batch = [e for e in events if e.name == "chip_smoke.batch"
             and e.device_type == DeviceType.CPU]
    if not batch or not work:
        lines.append("device time: not measured (the profiler saw no device activity)")
        return lines
    w0, w1 = batch[0].time_range.start, batch[0].time_range.end
    busy, wall = busy_us(w0, w1), max(w1 - w0, 1e-9)
    lines.append(f"batch {wall / 1e3:.3f} ms (host clock, profiled), device busy "
                 f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.4f}")
    by_name: dict[str, float] = {}
    for s0, s1, n in work:
        by_name[n] = by_name.get(n, 0.0) + (s1 - s0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    lines.append("top device ops: " + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top))
    return lines


def brute_force_oracle(corpus, batch, k):
    """Exact top-k by scoring every document in numpy — the oracle's
    semantics (AND text match, geo overlap > 0, text + geo/mass + 0.2·pr),
    written independently of the port; ties go to the lower doc id."""
    import numpy as np

    terms = batch.terms.numpy()
    q_rects, q_amps = batch.rects.numpy(), batch.amps.numpy()
    N = len(corpus.doc_terms)
    df = np.zeros((corpus.n_terms,), np.float64)
    tf = []
    for d in corpus.doc_terms:
        u, c = np.unique(d, return_counts=True)
        df[u] += 1
        tf.append(dict(zip(u.tolist(), c.tolist())))
    idf = np.log(1.0 + N / np.maximum(df, 1.0))
    out = np.full((len(terms), k), -1, np.int64)
    r, a = corpus.doc_rects, corpus.doc_amps
    for i, (t, qr, qa) in enumerate(zip(terms, q_rects, q_amps)):
        t = t[t >= 0]
        text = np.zeros(N)
        match = np.ones(N, bool)
        for w in t.tolist():
            f = np.array([tf_d.get(w, 0) for tf_d in tf], np.float64)
            match &= f > 0
            imp = (idf[w] * (1.0 + np.log(np.maximum(f, 1))) / np.sqrt(
                [max(len(d), 1) for d in corpus.doc_terms])).astype(np.float32)
            text += np.where(f > 0, imp, 0.0)
        iw = np.clip(np.minimum(r[:, :, None, 2], qr[None, None, :, 2])
                     - np.maximum(r[:, :, None, 0], qr[None, None, :, 0]), 0, None)
        ih = np.clip(np.minimum(r[:, :, None, 3], qr[None, None, :, 3])
                     - np.maximum(r[:, :, None, 1], qr[None, None, :, 1]), 0, None)
        g = (iw * ih * a[:, :, None] * qa[None, None, :]).sum(axis=(1, 2))
        mass = max(float((np.clip(qr[:, 2] - qr[:, 0], 0, None)
                          * np.clip(qr[:, 3] - qr[:, 1], 0, None) * qa).sum()), 1e-12)
        score = text + g / mass + 0.2 * corpus.pagerank
        score = np.where(match & (g > 0), score, -np.inf)
        order = np.argsort(-score, kind="stable")[:k]
        out[i] = np.where(np.isfinite(score[order]), order, -1)
    return out


if __name__ == "__main__":
    sys.exit(main())
