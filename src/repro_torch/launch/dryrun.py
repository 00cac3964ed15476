"""Dry-run: every (arch × shape) on the production meshes, shapes only —
memory fit per device and the roofline terms of an H100 (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out dryrun_results.jsonl] [--skip-existing]

Each cell is built with ``device="meta"`` on an abstract mesh of 256
(``single_pod_16x16``) or 512 (``multi_pod_2x16x16``) H100s and traced by
:func:`repro_torch.launch.roofline.count_step`; nothing is allocated and no
card is needed.  Every time it prints is a model from the H100 data
sheet's constants (:mod:`repro_torch.launch.roofline`), not a measurement.
One JSON row per (arch, shape, mesh) is appended to ``--out`` as it is
made; a ``skip`` shape gives a ``skipped`` row, a failure an ``error`` row
and a non-zero exit.

Methods (each row's ``method``):

* ``direct``: the cell's step traced once (recsys cells).
* ``direct (index_add stand-in)``: EGNN, its ordered segment sums (which
  read counts on the host) replaced by ``static_plan``'s ``index_add``:
  the same products, so the same FLOPs.
* ``L-extrapolated(1,2)``: LMs, as the reference: the step traced with 1
  and 2 layers and ``attn_chunk = seq_len`` (so ``long_500k_sliding``'s
  1,024-chunk flash loop stays out of the trace; the chunk changes no
  FLOP), each count ``c1 + (L − 1)·(c2 − c1)``.  A train step's bytes grow
  as L² (the backward of each layer's view ``leaf[i]`` of a stacked
  parameter writes a full ``[L, ...]`` gradient that autograd then adds
  up), so train cells are also traced at 3 layers and extrapolated by the
  second difference too (``L-extrapolated(1,2,3)``).  Transient memory
  is traced at the config's ``attn_chunk`` (one query block per chunk, as
  the step runs): a train step's at 2 and 3 layers, extrapolated from the
  second (each layer saves its input; the first layer's boundary
  differs), a prefill's at 2 layers (serving saves nothing across layers,
  so its peak stops growing there); a decode step's is the 2-layer cost
  trace's (one query row: the one-chunk block is ``B × heads × seq_len``
  scores).
* ``analytic``: geoweb, whose serve step syncs to the host: FLOPs from the
  reference's ``model_flops``; bytes from the budgets (the per-query byte
  counters of ``core/algorithms.py`` at their budget maxima, per shard);
  memory from the index's per-shard shapes plus that working set.

Memory per device = arguments (exact: their shard shapes) + transients
(the traced peak of live bytes less the arguments, each storage over the
product of the mesh axes that split it; see ``roofline``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core.distributed import mesh_axes
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell

# the per-query counters each algorithm's serve step sums over the doc axes
# (the stats keys of core/algorithms.py)
GEOWEB_COUNTERS = {"k_sweep": 13, "text_first": 11, "geo_first": 7}

# the counts a StepCount extrapolates over layers
_SCALARS = ("bytes", "bytes_dev", "transient", "transient_dev")


def _counts(c: rf.StepCount) -> dict:
    return {"flops": dict(c.flops), "flops_dev": dict(c.flops_dev),
            "lookups_dev": dict(c.lookups_dev),
            **{k: getattr(c, k) for k in _SCALARS}}


def _extrapolate(cs: list[dict], L: int) -> dict:
    """Counts at 1, 2 (and 3) layers → at ``L``: ``c1 + (L − 1)·Δ +
    (L − 1)(L − 2)/2·Δ²``, the second difference taken when a third trace
    is given (exact for counts linear or quadratic in the layers)."""
    def at(*v):
        out = v[0] + (L - 1) * (v[1] - v[0])
        if len(v) == 3:
            out += (L - 1) * (L - 2) // 2 * (v[2] - 2 * v[1] + v[0])
        return out

    out = {k: at(*(c[k] for c in cs)) for k in _SCALARS}
    for k in ("flops", "flops_dev", "lookups_dev"):
        keys = set().union(*(c[k] for c in cs))
        out[k] = {d: at(*(c[k].get(d, 0) for c in cs)) for d in keys}
    return out


def _trace(spec, shape, mesh, overrides=None):
    cell = build_cell(spec, shape, mesh, device="meta", lm_overrides=overrides)
    return rf.count_step(cell.fn, cell.args, mesh, cell.donate)


def _lm_counts(spec, shape, mesh) -> dict:
    cfg = spec.config
    L, S = cfg.n_layers, shape.params["seq_len"]
    # a train step's bytes grow as L^2 (the backward of each layer's view
    # of a stacked [L, ...] leaf writes a full-size gradient), so it takes
    # a third trace
    depths = (1, 2, 3) if shape.kind == "lm_train" else (1, 2)
    cost = [_counts(_trace(spec, shape, mesh, {"n_layers": n, "attn_chunk": S}))
            for n in depths]
    out = _extrapolate(cost, L)
    # transients stop growing after the second layer in serving (nothing is
    # saved across layers) and grow by one layer's saved input per layer
    # in training, from the second on (the first layer's boundary differs)
    if shape.kind == "lm_decode":
        mem = [cost[1]]
    else:
        mem = [_counts(_trace(spec, shape, mesh, {"n_layers": n}))
               for n in ((2, 3) if shape.kind == "lm_train" else (2,))]
    for k in ("transient", "transient_dev"):
        out[k] = mem[0][k] + (L - 2) * (mem[1][k] - mem[0][k] if len(mem) == 2 else 0)
    return out


def _geoweb_counts(cell, mesh) -> dict:
    """The analytic geoweb counts (the module docstring)."""
    idx, _query = cell.args
    spec = get_arch(cell.arch)
    cfg, algorithm = spec.config, spec.shape(cell.shape).params["algorithm"]
    kb = cfg.budgets
    gi, _offsets = idx.shards[0]
    sp, tx = gi.spatial, gi.text
    R = cfg.doc_major_rects
    log_p = math.ceil(math.log2(max(tx.n_postings, 2)))
    pb, rdb = tx.posting_bytes, R * sp.doc_bytes
    mc = kb.max_candidates
    tiles = kb.max_tiles * cfg.m_intervals * 2 * 4
    if algorithm == "k_sweep":
        per = tiles + kb.k_sweeps * kb.sweep_budget * sp.tp_bytes + mc * (log_p * pb + rdb)
    elif algorithm == "text_first":
        per = 2 * mc * pb + mc * rdb
    elif algorithm == "geo_first":
        per = tiles + mc * (sp.tp_doc_ids.element_size() + rdb + log_p * pb)
    else:
        raise ValueError(algorithm)
    q = mesh.shape[mesh_axes(mesh)[1]]  # query slices
    b_loc = cfg.query_batch / q
    per_dev = b_loc * per
    return {"flops": {"float32": cell.model_flops * mesh.size / q},
            "flops_dev": {"float32": cell.model_flops / q},
            "lookups_dev": {}, "bytes": per_dev * mesh.size, "bytes_dev": per_dev,
            "transient": per_dev * mesh.size, "transient_dev": per_dev}


def _collectives(spec, shape, cell, mesh, counts: dict) -> dict:
    out: dict = {}
    for axes, b in counts["lookups_dev"].items():
        if math.prod(mesh.shape[a] for a in axes) > 1:
            rf._add(out, "all-reduce", b)
    parts = []
    if shape.kind in ("lm_train", "recsys_train") or spec.family == "gnn":
        params, opt = cell.args[:2]  # a train cell's (params, opt, batch)
        parts.append(rf.grad_sync_bytes(params, opt["m"], mesh))
    if spec.family == "lm":
        cfg = spec.config
        p = shape.params
        if shape.kind == "lm_train":
            tok = cell.args[2]["tokens"]
        else:  # prefill (params, tokens, cache); decode (params, cache, tokens, pos)
            tok = cell.args[1 if shape.kind == "lm_prefill" else 2]
        split = tok.sharding.n_shards
        S = 1 if shape.kind == "lm_decode" else p["seq_len"]
        parts.append(rf.lm_activation_bytes(cfg, shape.kind, p["global_batch"], S,
                                            cell.args[0], mesh, split))
    elif spec.family == "recsys":
        p = shape.params
        parts.append(rf.recsys_bytes(spec.config, shape.kind, cell.args[0], mesh, p["batch"],
                                     p.get("n_candidates", 0)))
    elif spec.family == "gnn":
        from repro_torch.launch.steps import gnn_cell_config

        n = cell.args[2]["feats"].shape[0]
        parts.append(rf.egnn_bytes(gnn_cell_config(spec, shape), shape.kind, n, mesh))
    elif spec.family == "geoweb":
        parts.append(rf.geoweb_bytes(spec.config, mesh,
                                     GEOWEB_COUNTERS[shape.params["algorithm"]]))
    for part in parts:
        for k, v in part.items():
            rf._add(out, k, v)
    return out


def _model_dtype(spec) -> str:
    cd = getattr(spec.config, "compute_dtype", torch.float32)
    return str(cd).removeprefix("torch.")


def run_cell(spec, shape, mesh, mesh_name: str) -> dict:
    """The dry-run row of one (arch, shape) on ``mesh`` (any
    :class:`~repro_torch.core.distributed.Mesh`; its device is not used)."""
    t0 = time.perf_counter()
    cell = build_cell(spec, shape, mesh, device="meta")
    args = rf.arg_counts(cell.args, mesh, cell.donate)
    if spec.family == "lm":
        counts = _lm_counts(spec, shape, mesh)
        method = "L-extrapolated(1,2,3)" if shape.kind == "lm_train" else "L-extrapolated(1,2)"
    elif spec.family == "geoweb":
        counts, method = _geoweb_counts(cell, mesh), "analytic"
    else:
        counts = _counts(rf.count_step(cell.fn, cell.args, mesh, cell.donate))
        method = "direct (index_add stand-in)" if spec.family == "gnn" else "direct"
    coll = _collectives(spec, shape, cell, mesh, counts)
    r = rf.Roofline(
        arch=spec.name, shape=shape.name, mesh=mesh_name, n_devices=mesh.size,
        flops_per_dev=counts["flops_dev"], bytes_per_dev=counts["bytes_dev"],
        coll_bytes_per_dev=float(sum(coll.values())), coll_breakdown=coll,
        model_flops=cell.model_flops, model_dtype=_model_dtype(spec),
        mem_per_dev_bytes=args["arg_bytes_dev"] + counts["transient_dev"], note=cell.note,
    )
    row = r.row()
    row["method"] = method
    row["t_trace_s"] = round(time.perf_counter() - t0, 2)
    row["memory_per_dev"] = {"argument_bytes": args["arg_bytes_dev"],
                             "transient_bytes": counts["transient_dev"]}
    # the whole step on one device (what a (1, 1) mesh's card runs)
    row["global"] = {"flops_by_dtype": counts["flops"], "bytes": counts["bytes"],
                     "argument_bytes": args["arg_bytes"], "io_bytes": args["io_bytes"],
                     "peak_bytes": args["arg_bytes"] + counts["transient"]}
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16", make_production_mesh(multi_pod=True)))

    done = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))

    archs = [args.arch] if args.arch else list_archs()
    n_ok = n_skip = n_fail = 0
    t_start = time.perf_counter()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as out:
        for name in archs:
            spec = get_arch(name)
            for shape in spec.shapes:
                if args.shape and shape.name != args.shape:
                    continue
                for mesh_name, mesh in meshes:
                    key = (spec.name, shape.name, mesh_name)
                    if key in done:
                        continue
                    if shape.skip:
                        print(f"SKIP  {spec.name} × {shape.name} × {mesh_name}: {shape.skip}",
                              flush=True)
                        out.write(json.dumps({"arch": spec.name, "shape": shape.name,
                                              "mesh": mesh_name, "skipped": shape.skip}) + "\n")
                        out.flush()
                        n_skip += 1
                        continue
                    try:
                        row = run_cell(spec, shape, mesh, mesh_name)
                    except Exception as e:  # a cell that cannot be traced is a FAIL row
                        n_fail += 1
                        print(f"FAIL  {spec.name} × {shape.name} × {mesh_name}: {e}", flush=True)
                        traceback.print_exc()
                        out.write(json.dumps({"arch": spec.name, "shape": shape.name,
                                              "mesh": mesh_name, "error": str(e)[:500]}) + "\n")
                        out.flush()
                        continue
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                    n_ok += 1
                    print(
                        f"OK    {spec.name} × {shape.name} × {mesh_name}: "
                        f"hbm={row['hbm_per_dev_GB']:.2f}GB; model (H100 data sheet): "
                        f"t_comp={row['t_compute_s']:.2e}s t_mem={row['t_memory_s']:.2e}s "
                        f"t_coll={row['t_collective_s']:.2e}s dom={row['bottleneck']} "
                        f"frac={row['roofline_fraction']:.3f} ({row['method']}, "
                        f"traced in {row['t_trace_s']}s)",
                        flush=True,
                    )
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"({time.perf_counter() - t_start:.1f} s)")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
