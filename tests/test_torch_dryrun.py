"""The port's dry-run and roofline tooling on the CPU: ``count_step``'s
counts on hand-built steps, every shapes-only cell against the same cell
on real CPU tensors (SMOKE configs, cut shapes: the same arguments, and the
trace's FLOPs equal ``FlopCounterMode`` over the real step), the LMs'
L-extrapolation against a full-depth trace, the MoE and EGNN steps on
``meta``, and ``python -m repro_torch.launch.dryrun`` with the reference's
row keys."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch import roofline as j_rf  # noqa: E402
from repro_torch.configs.base import get_arch, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import egnn as p_egnn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
# the shapes cut to a CPU step's size (every width stays the SMOKE config's)
CUTS = {
    "lm_train": dict(global_batch=2, seq_len=64),
    "lm_prefill": dict(global_batch=2, seq_len=64),
    "lm_decode": dict(global_batch=2, seq_len=64),
    "recsys_train": dict(batch=32),
    "recsys_serve": dict(batch=32),
    "recsys_retrieval": dict(batch=1, n_candidates=256),
    "gnn_full": dict(n_nodes=200, n_edges=800),
    "gnn_minibatch": dict(n_nodes=300, n_edges=1500, batch_nodes=8, fanouts=(3, 2)),
    "gnn_molecule": dict(batch=4),
}


def _smoke(name):
    spec = get_arch(name)
    return dataclasses.replace(spec, config=spec.smoke_config)


def _cut(shape):
    return dataclasses.replace(shape, params={**shape.params, **CUTS[shape.kind]})


def _mb(t):
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# count_step on hand-built steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_step_hand_built(dtype):
    """``(a @ b) * 2`` then ``p -= g``: 2·m·n·k FLOPs under the operands'
    dtype; bytes = inputs + outputs of each op; peak = arguments + the
    product and its double; the in-place update writes a donated argument
    and allocates nothing."""
    m, k, n = 64, 32, 48
    e = torch.empty((), dtype=dtype).element_size()

    def step(a, b, p, g):
        d = (a @ b) * 2
        p.sub_(g)
        return d

    args = tuple(torch.empty(s, dtype=dtype, device="meta")
                 for s in ((m, k), (k, n), (n,), (n,)))
    c = rf.count_step(step, args, donate=(2,))
    name = str(dtype).removeprefix("torch.")
    assert c.flops == {name: 2 * m * n * k}
    assert c.bytes == e * ((m * k + k * n + m * n) + 2 * m * n + 3 * n)
    assert c.arg_bytes == e * (m * k + k * n + 2 * n)
    assert c.io_bytes == c.arg_bytes + e * n  # the donated p written once
    assert c.peak == c.arg_bytes + 2 * e * m * n
    assert c.transient == 2 * e * m * n
    with pytest.raises(ValueError, match="does not donate"):
        rf.count_step(step, args)


def test_count_step_per_device_split():
    """On a mesh each tensor counts over the axes that split it: a batch
    split over data (4) times a weight split over model (2) gives FLOPs and
    live bytes over 8; a row lookup from a table split over model is an
    all-reduce payload."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models.params import meta_tensor

    mesh = make_mesh((4, 2), ("data", "model"), device="meta")
    x = meta_tensor((64, 32), torch.float32, mesh, ("batch", None))
    w = meta_tensor((32, 16), torch.float32, mesh, (None, "ffn"))
    table = meta_tensor((1000, 8), torch.float32, mesh, ("rows", None))
    ids = meta_tensor((64,), torch.int64, mesh, ("batch",))

    def step(x, w, table, ids):
        return x @ w, torch.nn.functional.embedding(ids, table)

    c = rf.count_step(step, (x, w, table, ids), mesh)
    assert c.flops == {"float32": 2 * 64 * 32 * 16}
    assert c.flops_dev == {"float32": 2 * 64 * 32 * 16 / 8}
    assert c.arg_bytes_dev == (64 * 32 / 4 + 32 * 16 / 2 + 1000 * 8 / 2) * 4 + 64 * 8 / 4
    assert c.transient_dev == 64 * 16 * 4 / 8 + 64 * 8 * 4 / 8
    assert c.lookups_dev == {("model",): 64 * 8 * 4 / 4}


# ---------------------------------------------------------------------------
# the collective model on small abstract meshes, against bytes by hand
# ---------------------------------------------------------------------------

MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "8x1": ((8, 1), ("data", "model")), "1x1": ((1, 1), ("data", "model"))}


def _mesh(name):
    from repro_torch.core.distributed import make_mesh

    return make_mesh(*MESHES[name], device="meta")


def _grad_params(mesh):
    """``w`` split over model, ``b`` replicated (no dim ZeRO-1 can split),
    ``emb`` already split over data (f32)."""
    from repro_torch.models.params import meta_tensor

    return {"w": meta_tensor((8, 12), torch.float32, mesh, (None, "ffn")),
            "b": meta_tensor((3,), torch.float32, mesh, ("embed",)),
            "emb": meta_tensor((16, 4), torch.float32, mesh, ("zero1_dim0", None))}


@pytest.mark.parametrize("mesh_name,zero1,want", [
    # w: shard (8, 3) = 96 B, its moment ZeRO-1 split over data; b: 12 B;
    # emb: split over data already, nothing left to sync
    ("2x4", True, {"reduce-scatter": 96, "all-gather": 96, "all-reduce": 12}),
    ("2x4", False, {"all-reduce": 96 + 12}),
    # w: shard (8, 6) = 192 B, scattered over data, its half all-reduced
    # over pod; b: 12 B over pod × data; emb: shard (8, 4) = 128 B over pod
    ("2x2x2", True, {"reduce-scatter": 192, "all-gather": 192,
                     "all-reduce": 192 / 2 + 12 + 128}),
    ("2x2x2", False, {"all-reduce": 192 + 12 + 128}),
])
def test_grad_sync_bytes_by_hand(mesh_name, zero1, want):
    """Gradient synchronisation follows the moments' shardings: the train
    cells' (``TRAIN_OPT.zero1``, from ``_opt_shapes``) or the leaves' own."""
    from repro_torch.launch import steps

    mesh = _mesh(mesh_name)
    params = _grad_params(mesh)
    if zero1:
        assert steps.TRAIN_OPT.zero1
        moments = steps._opt_shapes(params, mesh)["m"]
    else:
        moments = _grad_params(mesh)
    assert rf.grad_sync_bytes(params, moments, mesh) == want


def _lm_cfg(**kw):
    from types import SimpleNamespace

    base = dict(remat="full", compute_dtype=torch.bfloat16, d_model=16, n_layers=3,
                n_heads=4, n_kv_heads=4, d_head=4,
                is_moe=False, n_experts=4, top_k=2, capacity_factor=1.25)
    return SimpleNamespace(**{**base, **kw})


def _lm_params(mesh, mlp_split=True, kv_width=8):
    from repro_torch.models.params import meta_tensor

    return {"layers": {
        "attn": {"wo": meta_tensor((3, 8, 16), torch.float32, mesh, ("layers", "heads", "embed")),
                 # kv_out: split over model = 4 at width 8, whole at 2
                 "wk": meta_tensor((3, 16, kv_width), torch.float32, mesh,
                                   ("layers", "embed", "kv_out"))},
        "mlp": {"wo": meta_tensor((3, 32, 16), torch.float32, mesh,
                                  ("layers", "ffn" if mlp_split else None, "embed"))},
        "moe": {"wi_gate": meta_tensor((3, 4, 16, 8), torch.float32, mesh,
                                       ("layers", "experts", "embed", "expert_ffn"))},
    }}


# B = 4, S = 8, D = 16 in bf16 over a batch split of 2: one all-reduce of the
# activations is 4·8·16·2 / 2 = 512 B; L = 3 layers
@pytest.mark.parametrize("kind,cfg_kw,mlp_split,want", [
    # forward, backward and the full remat's recompute: 3 passes × 3 layers
    # × (attention's wo + the FFN's wo)
    ("lm_train", {}, True, {"all-reduce": 3 * 3 * 2 * 512}),
    ("lm_train", {"remat": "none"}, True, {"all-reduce": 2 * 3 * 2 * 512}),
    ("lm_prefill", {}, True, {"all-reduce": 1 * 3 * 2 * 512}),
    # an FFN whose wo is not split over model needs no all-reduce
    ("lm_train", {}, False, {"all-reduce": 3 * 3 * 512}),
    # MoE: attention's wo, and the port's expert gathers: the dispatch
    # buffer [B, E·C, D] once a pass (the expert outputs forward, the
    # dispatched tokens' cotangent backward), C = int(1.25·8·2/4 + 0.5) = 5:
    # 4·4·5·16·2 / 2 = 1280 B, and the [D, E] f32 router once a forward
    # pass: 16·4·4 = 256 B
    ("lm_train", {"remat": "none", "is_moe": True}, True,
     {"all-reduce": 2 * 3 * 512, "all-gather": 3 * (2 * 1280 + 256)}),
    # kv heads 2 on model 4: sequence-parallel attention adds, per layer and
    # pass, two all-to-alls of q (4·8·4·4·2 / 2 = 512 B) and the all-gathers
    # of k and v (256 B each)
    ("lm_train", {"n_kv_heads": 2}, True,
     {"all-reduce": 3 * 3 * 2 * 512, "all-to-all": 3 * 3 * 2 * 512, "all-gather": 3 * 3 * 2 * 256}),
    # kv heads 1 whose wk/wv model does not divide (kept whole): no kv
    # gathers; the whole k and v enter the region, their cotangents
    # all-reduced once in the backward (4·8·1·4·2 / 2 = 128 B each)
    ("lm_train", {"n_kv_heads": 1, "kv_width": 2}, True,
     {"all-reduce": 3 * 3 * 2 * 512 + 3 * 2 * 128, "all-to-all": 3 * 3 * 2 * 512}),
])
def test_lm_activation_bytes_by_hand(kind, cfg_kw, mlp_split, want):
    mesh = _mesh("2x4")
    cfg = _lm_cfg(**cfg_kw)
    kv_width = cfg_kw.get("kv_width", 8)
    got = rf.lm_activation_bytes(cfg, kind, 4, 8, _lm_params(mesh, mlp_split, kv_width), mesh, 2)
    assert got == want
    # a model axis of 1 moves nothing
    one = _mesh("8x1")
    assert rf.lm_activation_bytes(cfg, kind, 4, 8, _lm_params(one, mlp_split, kv_width), one,
                                  8) == {}


# N = 100 nodes of H + 3 = 8 + 3 features in f32: 4,400 B of state; 2 layers
@pytest.mark.parametrize("kind,want", [
    # nodes split: per layer, forward and backward, gather the state and
    # scatter the sums
    ("gnn_full", {"all-gather": 2 * 2 * 4400, "reduce-scatter": 2 * 2 * 4400}),
    # nodes replicated: the forward sum and the two gathers' backward
    ("gnn_molecule", {"all-reduce": 3 * 2 * 4400}),
    ("gnn_minibatch", {"all-reduce": 3 * 2 * 4400}),
])
def test_egnn_bytes_by_hand(kind, want):
    from types import SimpleNamespace

    cfg = SimpleNamespace(d_hidden=8, coord_dim=3, n_layers=2, compute_dtype=torch.float32)
    for name in ("2x4", "2x2x2"):
        assert rf.egnn_bytes(cfg, kind, 100, _mesh(name)) == want
    assert rf.egnn_bytes(cfg, kind, 100, _mesh("1x1")) == {}


@pytest.mark.parametrize("mesh_name,want", [
    # 64 queries over model (4): 16 per device; one doc axis (data, 2)
    ("2x4", {"all-gather": 16 * 10 * 8 * 2, "all-reduce": 16 * 13 * 4}),
    # over model (2): 32 per device; gathered over data (2), then pod (2)
    ("2x2x2", {"all-gather": 2 * (32 * 10 * 8 * 2), "all-reduce": 32 * 13 * 4}),
])
def test_geoweb_bytes_by_hand(mesh_name, want):
    """The merge: each doc axis gathers top-10 (id, score) pairs of 8 B, and
    the 13 per-query counters are all-reduced over the doc axes."""
    from types import SimpleNamespace

    cfg = SimpleNamespace(query_batch=64, budgets=SimpleNamespace(top_k=10))
    assert rf.geoweb_bytes(cfg, _mesh(mesh_name), 13) == want
    assert rf.geoweb_bytes(cfg, _mesh("1x1"), 13) == {}


# ---------------------------------------------------------------------------
# shapes-only cells against real ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in list_archs() if a != "geoweb"])
def test_meta_cells_match_real_cells(arch):
    """Each shape's shapes-only cell (SMOKE, cut) holds the real CPU cell's
    arguments (paths, shapes, dtypes, bytes), and its trace's FLOPs by
    dtype add up to what ``FlopCounterMode`` counts over the real step."""
    spec = _smoke(arch)
    for shape in spec.shapes:
        if shape.skip:
            continue
        shape = _cut(shape)
        meta = build_cell(spec, shape, device="meta")
        real = build_cell(spec, shape, device=CPU)
        want = rf.tensor_leaves(real.args)
        got = rf.tensor_leaves(meta.args)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want], shape.name
        counted = rf.count_step(meta.fn, meta.args, donate=meta.donate)
        assert counted.arg_bytes == sum(_mb(t) for t in want), shape.name
        with FlopCounterMode(display=False) as fc:
            real.fn(*real.args)
        assert counted.flops_total == fc.get_total_flops() > 0, shape.name
        assert meta.donate == real.donate and meta.model_flops == real.model_flops


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_lm_extrapolation_equals_full_depth(arch, kind):
    """A 4-layer SMOKE LM: the 1- and 2-layer traces (and 3 for a train
    step, whose bytes grow as L²) extrapolated to 4 layers give the
    full-depth trace's FLOPs by dtype and bytes exactly, and the transient
    peak too (the MoE's expert counts by ``scatter_add_``: its train step
    traces on ``meta``)."""
    spec = _smoke(arch)
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, n_layers=4))
    shape = _cut(spec.shape(kind))
    mesh = make_host_mesh(device="meta")
    got = dryrun._lm_counts(spec, shape, mesh)
    S = shape.params["seq_len"]
    full = dryrun._trace(spec, shape, mesh, {"attn_chunk": S})
    assert got["flops"] == full.flops and got["bytes"] == full.bytes
    # the production chunk changes no FLOP; its transient peak is the
    # extrapolated one
    prod = dryrun._trace(spec, shape, mesh)
    assert prod.flops == full.flops and got["transient"] == prod.transient


def test_static_plan_sums_equal_ordered_plan():
    """EGNN's shape-static stand-in sums the same terms (integer-valued, so
    any order is exact) and counts the same degrees."""
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 20, (300,), generator=g)
    mask = torch.rand(300, generator=g) < 0.8
    vals = torch.randint(-8, 8, (300, 5), generator=g).float() * mask[:, None]
    ordered = p_egnn.segment_plan(ids, 20, mask)
    static = p_egnn.static_plan(ids, 20, mask)
    assert torch.equal(p_egnn.segment_sum(vals, static), p_egnn.segment_sum(vals, ordered))
    assert torch.equal(static.counts, ordered.counts)
    src = torch.randn(20, 5, generator=g)
    assert torch.equal(p_egnn.gather(src, static), p_egnn.gather(src, ordered))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli(tmp_path):
    """The CLI as a user runs it: a recsys cell on both meshes, a skipped
    shape and a geoweb row; the rows carry the reference's keys, and a
    rerun with ``--skip-existing`` adds nothing."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = {
        "rec": ["--arch", "dcn-v2", "--shape", "serve_p99", "--mesh", "both"],
        "skip": ["--arch", "smollm-135m", "--shape", "long_500k", "--mesh", "single"],
        "geo": ["--arch", "geoweb", "--shape", "serve_ksweep", "--mesh", "single"],
    }
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a, "--out", str(tmp_path / k)],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, a in runs.items()}
    outs = {k: p.communicate(timeout=240)[0] for k, p in procs.items()}
    assert all(p.returncode == 0 for p in procs.values()), outs
    rows = {k: [json.loads(x) for x in (tmp_path / k).read_text().splitlines()] for k in runs}
    assert [(r["arch"], r["mesh"]) for r in rows["rec"]] == [
        ("dcn-v2", "single_pod_16x16"), ("dcn-v2", "multi_pod_2x16x16")]
    assert set(rows["skip"][0]) == {"arch", "shape", "mesh", "skipped"}
    ref_keys = set(j_rf.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0, 1.0).row())
    for r in rows["rec"] + rows["geo"]:
        assert ref_keys <= set(r) and "error" not in r
        assert r["hbm_per_dev_GB"] > 0 and r["t_compute_s"] > 0 and r["t_memory_s"] > 0
    single, multi = rows["rec"]
    assert multi["devices"] == 2 * single["devices"] == 512
    assert rows["geo"][0]["method"] == "analytic"
    assert rows["geo"][0]["collectives"]["all-gather"] > 0
    assert "dry-run complete: 2 ok, 0 skipped, 0 failed" in outs["rec"]
    before = (tmp_path / "rec").read_text()
    dryrun.main([*runs["rec"], "--out", str(tmp_path / "rec"), "--skip-existing"])
    assert (tmp_path / "rec").read_text() == before


def test_host_mesh_row_counts_the_whole_step():
    """On the one-card host mesh a row's per-device counts are the whole
    step's: FLOPs, argument bytes and the peak of the global trace."""
    spec = get_arch("dcn-v2")
    shape = spec.shape("serve_p99")
    row = dryrun.run_cell(spec, shape, make_host_mesh(device="meta"), "host_1x1")
    cell = build_cell(spec, shape, device="meta")
    c = rf.count_step(cell.fn, cell.args)
    assert row["flops_by_dtype/dev"] == c.flops == row["global"]["flops_by_dtype"]
    assert row["global"]["argument_bytes"] == c.arg_bytes
    assert row["global"]["peak_bytes"] == c.peak
    assert row["hbm_per_dev_GB"] == c.peak / 1e9
    assert row["collectives"] == {} and row["t_collective_s"] == 0.0


@pytest.mark.parametrize("shape_name", ["serve_ksweep", "serve_textfirst", "serve_geofirst"])
def test_geoweb_counters_match_the_serve_step(shape_name):
    """The analytic geoweb row's counter all-reduce counts the per-query
    counters the serve step returns (its SMOKE cell on a one-card mesh)."""
    from repro_torch.core import make_mesh

    spec = _smoke("geoweb")
    shape = spec.shape(shape_name)
    cell = build_cell(spec, shape, make_mesh((1, 1), ("data", "model"), device=CPU))
    _ids, _scores, stats = cell.fn(*cell.args)
    assert len(stats) == dryrun.GEOWEB_COUNTERS[shape.params["algorithm"]]
