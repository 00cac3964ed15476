"""PyTorch port: the recommendation models across process ranks, as the
reference's ``param_specs`` and cells place them
(``repro/sharding/specs.py``, ``repro/models/recsys.py``,
``repro/launch/steps.py``): embedding-table ``rows``, the first MLP
layer's ``ffn`` columns and AutoInt's and BST's attention ``heads`` over
``model``; the batch and the retrieval candidates over data.  4 ``gloo``
ranks on the CPU (``repro_torch.launch.ranks.run_ranks``, torch on one
thread per rank), the four SMOKE configs (f32) with the reference's
seed-0 weights and its generators' batches carried across as numpy
(``params_from_numpy``, then ``place_params``), each on the (2, 2) and
(1, 4) data x model meshes (on (1, 4) AutoInt's and BST's 2 heads do not
divide ``model``: their q/k/v stay whole).  Each case is held to

* one process of the port: the looked-up embedding rows bitwise; the
  serve outputs (the rank's rows), one train step's loss and gradients
  (the ``microbatches=1`` step; the rank's gradient blocks) within
  ``GRAD_TOL`` / ``LOSS_TOL``;
* the reference: its jitted loss, gradients and forwards under
  ``jax.set_mesh`` on an ``AxisType.Auto`` mesh of the same shape (fake
  XLA devices, one subprocess), parameters placed by ``param_specs`` and
  batches by ``_recsys_batch_specs``, within the same tolerances (the
  gradients within ``REF_GRAD_TOL``, set from a reading);
* the dry-run: each rank's parameter bytes equal ``param_shapes(...,
  mesh)``'s per-device count.

Besides: the two-tower in-batch softmax over the global batch on (2, 1)
and (2, 2) (the reference's whole-batch loss, where each rank's rows alone
gave another); retrieval over candidates split over data, the merged
top-100 bitwise ``select_top`` of the ranks' concatenated scores (the
two-tower geo blend with fewer than 100 geo matches, so −inf picks merge);
``build_recsys_cell``'s three kinds on the (2, 2) process mesh; the
roofline's count of the slice's collectives; and the train CLI with
``--model-parallel 2`` on two ranks (the two-tower step with
``microbatches`` = 2 on a data-split mesh: ``tests/test_torch_whole_leaves.py``).  Every launch is bounded by a
timeout."""
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import make_mesh, make_process_mesh  # noqa: E402
from repro_torch.core.ranking import select_top  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import recsys as p_rec  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    param_shapes,
    param_shardings,
    params_from_numpy,
    place_params,
)
from repro_torch.sharding.specs import local_block, named_sharding, use_sharding  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
AXES = ("data", "model")
SEED = 0
B = 16  # the batch of every case
FAULT_B = 8  # the two-tower batch of the global-softmax cases
# gradients of the ranks, one process and the reference differ by f32
# rounding only (tests/test_torch_tensor_parallel.py's GRAD_TOL and
# LOSS_TOL); the serve outputs and retrieval scores are held to GRAD_TOL
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0)
# against the reference's Auto mesh, an atol set from a reading: the
# reference's own two-tower gradients there differ from its one-device ones
# by up to 5.3e-5 (entries up to ~200: the softmax at temperature 0.05), and
# the ranks' from the mesh's by up to 5.7e-5, at most 4.2e-6 past rtol 1e-4
# (on the CPU, jax 0.9.0); every other arch within GRAD_TOL
REF_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CLI_RTOL = 1e-3  # tests/test_torch_seq_parallel.py's: losses printed to 4 decimals
ARCHS = {"two_tower": "two-tower-retrieval", "dcn": "dcn-v2", "autoint": "autoint",
         "bst": "bst"}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CASES = [(a, m) for a in ARCHS for m in MESHES]
CFGS = {a: get_arch(n).smoke_config for a, n in ARCHS.items()}
OPT = OptimizerConfig(zero1=True)
# retrieval: candidates, the CTR forwards' chunk (ragged: 512 rows a rank
# on (2, 2)), the two-tower geo blend's footprints
N_CAND = 1024
CHUNK = 300
TOP_K = 100
GEO = {"side": 0.05, "q_rects": ((0.3, 0.3, 0.35, 0.35), (0.6, 0.6, 0.62, 0.62)),
       "weight": 5.0, "rects": 2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the inputs: the reference's weights and batches, as numpy ---------------

def _ref_batch(cfg, n: int, seed: int = SEED) -> dict:
    import jax

    from repro.data import recsys as j_data

    name = type(cfg).__name__
    if name in ("DCNv2Config", "AutoIntConfig"):
        fn = lambda: j_data.ctr_batch(n, getattr(cfg, "n_dense", 0), cfg.vocab_sizes,  # noqa: E731
                                      seed=seed)
    elif name == "BSTConfig":
        fn = lambda: j_data.bst_batch(n, cfg.n_items, cfg.seq_len, cfg.n_other_fields,  # noqa: E731
                                      cfg.field_vocab, seed=seed)
    else:
        fn = lambda: j_data.two_tower_batch(  # noqa: E731
            n, cfg.n_users, cfg.n_items, cfg.n_user_fields, cfg.n_item_fields, cfg.field_vocab,
            cfg.hist_len, seed=seed)
    return {k: np.asarray(v) for k, v in jax.jit(fn)().items()}


def _inputs():
    """Each arch's reference SMOKE weights (seed 0) and a batch of ``B``
    (histories −1-padded in places, one two-tower bag empty); the
    two-tower batch of ``FAULT_B``; the retrieval candidates."""
    import jax

    from repro.configs.base import get_arch as j_get_arch

    weights, batches = {}, {}
    for arch, name in ARCHS.items():
        jc = j_get_arch(name).smoke_config
        weights[arch] = {k: np.asarray(v) for k, v in jax.jit(jc.init)(jax.random.key(SEED)).items()}
        b = _ref_batch(jc, B)
        if "history" in b:
            b["history"] = b["history"].copy()
            b["history"][::3, :2] = -1
            b["history"][1] = -1
        batches[arch] = b
    batches["fault"] = _ref_batch(j_get_arch(ARCHS["two_tower"]).smoke_config, FAULT_B)
    rng = np.random.default_rng(SEED)
    tt = CFGS["two_tower"]
    lo = rng.uniform(0.0, 0.9, size=(N_CAND, GEO["rects"], 2)).astype(np.float32)
    cands = {
        "two_tower": {"cand_ids": (np.arange(N_CAND) % tt.n_items).astype(np.int32),
                      "cand_fields": rng.integers(0, tt.field_vocab, (N_CAND, tt.n_item_fields))
                      .astype(np.int32),
                      "cand_rects": np.concatenate([lo, lo + GEO["side"]], axis=2),
                      "cand_amps": np.ones((N_CAND, GEO["rects"]), np.float32)},
    }
    for arch in ("dcn", "autoint", "bst"):
        c = _ref_batch(get_arch(ARCHS[arch]).smoke_config, N_CAND, seed=SEED + 1)
        c.pop("label")
        cands[arch] = c
    return weights, batches, cands


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _params(arch: str, weights: dict, mesh=None) -> dict:
    cfg = CFGS[arch]
    params = params_from_numpy(cfg.param_defs(), weights[arch], "cpu")
    if mesh is not None:
        params = place_params(params, param_shardings(cfg.param_defs(), mesh))
    return params


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of ``x`` (the ``batch`` spec's block)."""
    sh = named_sharding(mesh, ("batch",) + (None,) * (x.dim() - 1), shape=tuple(x.shape))
    return local_block(x, sh).clone()


def _serve(arch: str, params: dict, batch: dict):
    cfg = CFGS[arch]
    if arch == "two_tower":
        return p_rec.two_tower_user(cfg, params, batch)
    return p_steps.recsys_forward(cfg)(params, batch)


def _np_tree(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _geo(cands: dict, lo: int = 0, n: int = N_CAND) -> dict:
    return {"cand_rects": torch.from_numpy(cands["cand_rects"][lo:lo + n]),
            "cand_amps": torch.from_numpy(cands["cand_amps"][lo:lo + n]),
            "q_rects": torch.tensor(GEO["q_rects"], dtype=torch.float32),
            "q_amps": torch.ones(len(GEO["q_rects"])), "weight": GEO["weight"]}


def _retrieve(arch: str, params: dict, batch: dict, cands: dict, mesh=None) -> dict:
    """The rank's (one process's: ``mesh`` None) candidate block's scores
    and the merged top-``TOP_K`` under the mesh's sharding context."""
    cfg = CFGS[arch]
    lo, n = 0, N_CAND
    axes = p_rec.candidate_axes(mesh) if mesh is not None else ()
    if axes:
        g = len(mesh.group(axes, mesh.rank))
        n = N_CAND // g
        lo = mesh.group(axes, mesh.rank).index(mesh.rank) * n
    with torch.no_grad(), use_sharding(mesh):
        if arch == "two_tower":
            user = {k: v[:1] for k, v in batch.items()}
            ids = torch.from_numpy(cands["cand_ids"][lo:lo + n])
            fields = torch.from_numpy(cands["cand_fields"][lo:lo + n])
            geo = _geo(cands, lo, n)
            top = p_rec.two_tower_score_candidates(cfg, params, user, ids, fields, TOP_K, geo)
            u = p_rec.two_tower_user(cfg, params, user)
            v = p_rec.two_tower_item(cfg, params, ids, fields)
            g = p_rec.geo_score_docs(geo["cand_rects"][None], geo["cand_amps"][None],
                                     geo["q_rects"][None], geo["q_amps"][None])[0]
            scores = p_rec.geo_blend(u @ v.T, g, GEO["weight"])
        else:
            block = {k: torch.from_numpy(v[lo:lo + n].copy()) for k, v in cands.items()}
            scores = p_rec.forward_in_row_chunks(p_steps.recsys_forward(cfg), params, block,
                                                 CHUNK)
            top = p_rec.select_top_across(scores, TOP_K)
            scores = scores[None]
    return {"scores": scores.numpy(), "values": top[0].numpy(), "positions": top[1].numpy()}


def _case(arch: str, weights: dict, batches: dict, cands: dict, mesh=None) -> dict:
    """One arch on ``mesh`` (a process mesh; None: one process): the
    lookups of a serve forward, its outputs, one train step's loss and
    gradients, the retrieval, the bytes held."""
    cfg = CFGS[arch]
    params = _params(arch, weights, mesh)
    batch = _t(batches[arch])
    serve = {k: v for k, v in batch.items() if k != "label"}
    if mesh is not None:
        serve = {k: _rows(v, mesh) for k, v in serve.items()}
    looked: list = []
    lookups = p_rec._lookups

    def recorded(*args):
        rows = lookups(*args)
        looked.extend(r.detach().numpy().copy() for r in rows)
        return rows

    p_rec._lookups = recorded
    try:
        with torch.no_grad(), use_sharding(mesh):
            out = _serve(arch, params, serve).numpy()
    finally:
        p_rec._lookups = lookups
    loss, _, grads = _step(cfg, mesh).value_and_grad(params, batch)
    return {"serve": out, "lookups": looked, "loss": float(loss), "grads": _np_tree(grads),
            "retrieval": _retrieve(arch, params, batch, cands[arch], mesh),
            "param_bytes": sum(x.nbytes for x in leaves(params)), "rows": int(out.shape[0])}


def _step(cfg, mesh=None, microbatches: int = 1):
    """The train cells' step of ``cfg``: data-parallel on a process mesh,
    ZeRO-1's moment blocks; one process's with ``mesh`` None."""
    if mesh is None:
        return p_steps.make_train_step(p_steps.recsys_loss(cfg), OPT, microbatches)
    with use_sharding(mesh):
        return p_steps.make_train_step(p_steps.recsys_loss(cfg), OPT, microbatches,
                                       p_steps.moment_shardings(cfg.param_defs(), mesh))


def _fault(weights: dict, batches: dict, mesh) -> dict:
    """The two-tower loss and gradients of the ``FAULT_B`` batch by the
    data-parallel step on ``mesh``, the reference's weights."""
    params = _params("two_tower", weights, mesh)
    loss, _, grads = _step(CFGS["two_tower"], mesh).value_and_grad(params, _t(batches["fault"]))
    return {"loss": float(loss), "grads": _np_tree(grads)}


# the cells on (2, 2): kind -> (arch, shape name, shape params)
CELLS = {
    "serve": ("dcn", "serve_p99", {"batch": B}),
    "retrieval_two_tower": ("two_tower", "retrieval_cand", {"batch": 1, "n_candidates": N_CAND}),
    "retrieval_ctr": ("dcn", "retrieval_cand", {"batch": 1, "n_candidates": N_CAND}),
    "train": ("dcn", "train_batch", {"batch": 2 * B}),
}


def _cell(kind: str, cands: dict, mesh=None):
    arch, shape_name, params = CELLS[kind]
    spec = dataclasses.replace(get_arch(ARCHS[arch]), config=CFGS[arch])
    shape = dataclasses.replace(spec.shape(shape_name), params=params)
    geo = None
    if kind == "retrieval_two_tower":
        geo = _geo(cands["two_tower"])
    return p_steps.build_recsys_cell(spec, shape, device="cpu" if mesh is None else None,
                                     seed=SEED, geo=geo, mesh=mesh, chunk_rows=CHUNK)


def _cells(cands: dict, mesh=None) -> dict:
    """Each of ``CELLS`` built on ``mesh`` (or one process) and run once:
    its output, the rows and storage of its batch or candidates, the
    bytes of its parameters and moments."""
    out = {}
    for kind in CELLS:
        cell = _cell(kind, cands, mesh)
        rows = cell.args[2] if kind == "retrieval_two_tower" else next(iter(cell.args[1].values()))
        if kind == "train":
            rows = cell.args[2]["sparse"]
        e = {"rows": int(rows.shape[0]), "storage": rows.untyped_storage().nbytes(),
             "param_bytes": sum(x.nbytes for x in leaves(cell.args[0]))}
        if kind == "train":
            opt = cell.args[1]
            e["moment_bytes"] = sum(x.nbytes for x in leaves(opt["m"]) + leaves(opt["v"]))
            _, _, m = cell.fn(*cell.args)
            e["loss"] = float(m["loss"])
        else:
            with torch.no_grad():
                res = cell.fn(*cell.args)
            e["out"] = [r.numpy() for r in (res if isinstance(res, tuple) else (res,))]
        out[kind] = e
    return out


def _rank4(rank: int, weights: dict, batches: dict, cands: dict) -> dict:
    torch.set_num_threads(1)
    out = {}
    for mname, shape in MESHES.items():
        mesh = make_process_mesh(shape, AXES, device="cpu")
        for arch in ARCHS:
            out[(arch, mname)] = _case(arch, weights, batches, cands, mesh)
    mesh = make_process_mesh((2, 2), AXES, device="cpu")
    out["fault_2x2"] = _fault(weights, batches, mesh)
    out["cells"] = _cells(cands, mesh)
    return out


CLI_ARGS = ["--device", "cpu", "--arch", "dcn-v2", "--steps", "4", "--batch-size", str(B)]


def _rank2(rank: int, weights: dict, batches: dict) -> dict:
    torch.set_num_threads(1)
    out = {"fault_2x1": _fault(weights, batches, make_process_mesh((2, 1), AXES, device="cpu"))}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(CLI_ARGS + ["--model-parallel", "2"])
    out["cli"] = buf.getvalue()
    return out


# -- the reference, in a subprocess on fake XLA devices ----------------------

REF = textwrap.dedent("""
    import json, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro.configs.base import get_arch
    from repro.launch.steps import _recsys_batch_specs, _recsys_fns
    from repro.models import recsys as rr
    from repro.models.params import param_specs
    from repro.sharding.specs import use_sharding

    case = json.loads({case!r})
    inputs = np.load(case["inputs"])
    out = {{}}

    def tree(prefix):
        return {{k[len(prefix):]: jnp.asarray(inputs[k]) for k in inputs.files
                if k.startswith(prefix)}}

    def run(cfg, params, batch, mesh, tag, serve=True):
        loss_fn, fwd = _recsys_fns(cfg)
        if mesh is not None:
            specs = param_specs(cfg.param_defs(), mesh)
            params = {{k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                      for k, v in params.items()}}
            shard = _recsys_batch_specs(cfg, batch[next(iter(batch))].shape[0], mesh)
            batch = {{k: jax.device_put(v, shard[k].sharding) for k, v in batch.items()}}
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b)[0]))(params, batch)
        out[tag + "/loss"] = np.asarray(loss)
        for k, g in grads.items():
            out[tag + "/grad/" + k] = np.asarray(g)
        if serve:
            b = {{k: v for k, v in batch.items() if k != "label"}}
            f = (lambda p, b: rr.two_tower_user(cfg, p, b)) if fwd is None else fwd
            out[tag + "/serve"] = np.asarray(jax.jit(f)(params, b))

    for arch, name in case["archs"].items():
        cfg = get_arch(name).smoke_config
        for mname, shape in case["meshes"].items():
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:shape[0] * shape[1]])
            with use_sharding(mesh), jax.set_mesh(mesh):
                run(cfg, tree(arch + "/params/"), tree(arch + "/batch/"), mesh,
                    arch + "/" + mname)
    cfg = get_arch(case["archs"]["two_tower"]).smoke_config
    fault = tree("fault/")
    run(cfg, tree("two_tower/params/"), fault, None, "fault/one", serve=False)
    for shape in ((2, 1), (2, 2)):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        with use_sharding(mesh), jax.set_mesh(mesh):
            run(cfg, tree("two_tower/params/"), fault, mesh, "fault/%dx%d" % shape, serve=False)
    np.savez(case["out"], **out)
    print(json.dumps({{"keys": len(out)}}))
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything across ranks, run once: the reference's subprocess starts
    first, the 4 ranks and then the 2 ranks run beside it."""
    tmp = tmp_path_factory.mktemp("recsys")
    weights, batches, cands = _inputs()
    arrays = {f"{a}/params/{k}": v for a in ARCHS for k, v in weights[a].items()}
    arrays.update({f"{a}/batch/{k}": v for a in ARCHS for k, v in batches[a].items()})
    arrays.update({f"fault/{k}": v for k, v in batches["fault"].items()})
    np.savez(tmp / "inputs.npz", **arrays)
    case = {"inputs": str(tmp / "inputs.npz"), "out": str(tmp / "ref.npz"), "archs": ARCHS,
            "meshes": MESHES}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen([sys.executable, "-c", REF.format(case=json.dumps(case))], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        four = run_ranks(_rank4, 4, args=(weights, batches, cands), timeout_s=TIMEOUT_S)
        two = run_ranks(_rank2, 2, args=(weights, batches), timeout_s=TIMEOUT_S)
        _, err = ref.communicate(timeout=TIMEOUT_S)
        assert ref.returncode == 0, err[-3000:]
    finally:
        ref.kill()
    one = {arch: _case(arch, weights, batches, cands) for arch in ARCHS}
    return {"four": four, "two": two, "ref": dict(np.load(tmp / "ref.npz")), "one": one,
            "batches": batches, "weights": weights, "cands": cands}


def _block(arch: str, mname: str, name: str, x: np.ndarray, rank: int) -> np.ndarray:
    """Position ``rank``'s block of the global leaf ``x`` on the mesh."""
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    sh = param_shardings(CFGS[arch].param_defs(), mesh)[name]
    return np.asarray(local_block(x, sh, rank))


def _rank_rows(mname: str, x: np.ndarray, rank: int) -> np.ndarray:
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    sh = named_sharding(mesh, ("batch",) + (None,) * (x.ndim - 1), shape=x.shape)
    return np.asarray(local_block(x, sh, rank))


def _split_leaves(arch: str, mname: str) -> set:
    mesh = make_mesh(MESHES[mname], AXES, device="meta")
    return {k for k, d in CFGS[arch].param_defs().items()
            if named_sharding(mesh, d.logical, shape=d.shape).n_shards > 1}


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("arch,mname", CASES)
def test_leaves_split_as_the_reference_specs(arch, mname):
    """The leaves the port holds in blocks are those ``param_specs``
    splits: every table's rows and every first MLP layer (each padded
    vocab and width divides 4), the heads where they divide ``model`` (2
    SMOKE heads: on (2, 2), not on (1, 4)); DCN-v2's cross layers, AutoInt's
    ``wres`` and BST's ``wo`` stay whole."""
    got = _split_leaves(arch, mname)
    defs = CFGS[arch].param_defs()
    want = {k for k, d in defs.items() if "rows" in d.logical or "ffn" in d.logical}
    if mname == "2x2":
        want |= {k for k, d in defs.items() if "heads" in d.logical}
    assert got == want and want
    split = p_rec.model_split(CFGS[arch], make_mesh(MESHES[mname], AXES, device="cpu"))
    assert split.mesh is None and split.blocks == {}  # a plain mesh is one process


@pytest.mark.parametrize("arch,mname", CASES)
def test_lookups_bitwise_one_process(world, arch, mname):
    """The embedding rows a serve forward looks up (each table's rows, the
    two-tower history bag's rows before its mean, BST's padded sequence)
    are bitwise one process's for the rank's rows, on every rank."""
    want = world["one"][arch]["lookups"]
    for r, o in enumerate(world["four"]):
        got = o[(arch, mname)]["lookups"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.tobytes() == _rank_rows(mname, w, r).tobytes(), (arch, mname, r)


@pytest.mark.parametrize("arch,mname", CASES)
def test_ranks_equal_one_process(world, arch, mname):
    """Each rank's serve outputs (its rows) within ``GRAD_TOL`` of one
    process's, bitwise across its ``model`` group; one train step's loss
    within ``LOSS_TOL`` and every gradient block within ``GRAD_TOL`` of
    one process's ``microbatches=1`` step (the ranks' losses equal)."""
    one = world["one"][arch]
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    outs = [o[(arch, mname)] for o in world["four"]]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["serve"], _rank_rows(mname, one["serve"], r), **GRAD_TOL)
        for q in mesh.group(("model",), r):
            assert o["serve"].tobytes() == outs[q]["serve"].tobytes(), (r, q)
        assert o["loss"] == outs[0]["loss"]
        np.testing.assert_allclose(o["loss"], one["loss"], **LOSS_TOL)
        for k, g in one["grads"].items():
            np.testing.assert_allclose(o["grads"][k], _block(arch, mname, k, g, r), **GRAD_TOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("arch,mname", CASES)
def test_reference_on_its_auto_mesh(world, arch, mname):
    """The reference's jitted loss, gradients and serve forward on an
    ``AxisType.Auto`` mesh of the case's shape: each rank's loss within
    ``LOSS_TOL``, its serve rows within ``GRAD_TOL``, its gradient blocks
    within ``REF_GRAD_TOL``."""
    ref = world["ref"]
    tag = f"{arch}/{mname}"
    for r, o in enumerate(world["four"]):
        o = o[(arch, mname)]
        np.testing.assert_allclose(o["loss"], ref[tag + "/loss"], **LOSS_TOL)
        np.testing.assert_allclose(o["serve"], _rank_rows(mname, ref[tag + "/serve"], r),
                                   **GRAD_TOL)
        for k in o["grads"]:
            np.testing.assert_allclose(o["grads"][k], _block(arch, mname, k, ref[f"{tag}/grad/{k}"],
                                                             r), **REF_GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("mname", ["2x1", "2x2"])
def test_two_tower_softmax_over_the_global_batch(world, mname):
    """The two-tower step on a batch split over data: each row's negatives
    are the whole batch's targets.  The loss equals the reference's
    whole-batch loss on one device and on its Auto mesh (within
    ``LOSS_TOL``), not the mean of the shards' own in-batch losses; the
    gradient blocks are the reference's (``GRAD_TOL``)."""
    ref = world["ref"]
    outs = world["two"] if mname == "2x1" else world["four"]
    key = "fault_" + mname
    one = ref["fault/one/loss"]
    shards = [float(p_rec.in_batch_softmax_nll_plain(*x)) for x in _shard_terms(world)]
    assert abs(np.mean(shards) - one) > 0.1 * abs(one)  # the fault the test pins
    mesh = make_mesh(tuple(int(c) for c in mname.split("x")), AXES, device="cpu")
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[key]["loss"], one, **LOSS_TOL)
        np.testing.assert_allclose(o[key]["loss"], ref[f"fault/{mname}/loss"], **LOSS_TOL)
        for k, g in o[key]["grads"].items():
            sh = param_shardings(CFGS["two_tower"].param_defs(), mesh)[k]
            np.testing.assert_allclose(g, np.asarray(local_block(ref[f"fault/one/grad/{k}"], sh, r)),
                                       **GRAD_TOL, err_msg=k)


def _shard_terms(world):
    """Each data shard's (u, v, logq, τ) of the fault batch alone."""
    cfg = CFGS["two_tower"]
    params = _params("two_tower", world["weights"])
    batch = _t(world["batches"]["fault"])
    out = []
    with torch.no_grad():
        for half in (slice(0, FAULT_B // 2), slice(FAULT_B // 2, FAULT_B)):
            b = {k: v[half] for k, v in batch.items()}
            out.append((p_rec.two_tower_user(cfg, params, b),
                        p_rec.two_tower_item(cfg, params, b["target"], b["item_fields"]),
                        b["logq"], cfg.temperature))
    return out


@pytest.mark.parametrize("arch,mname", CASES)
def test_retrieval_merges_the_ranks_top_k(world, arch, mname):
    """Retrieval over ``N_CAND`` candidates split over data (on (1, 4) the
    data axis is 1: every rank scores them all): the merged top-100 is
    bitwise ``select_top`` of the ranks' concatenated scores in rank order,
    the same on every rank; the scores within ``GRAD_TOL`` of one
    process's.  The two-tower geo blend leaves fewer than 100 geo matches,
    so −inf picks (the lowest global positions outside the footprints)
    merge."""
    mesh = make_mesh(MESHES[mname], AXES, device="cpu")
    outs = [o[(arch, mname)]["retrieval"] for o in world["four"]]
    one = world["one"][arch]["retrieval"]
    for r, o in enumerate(outs):
        group = mesh.group(("data",), r)
        scores = np.concatenate([outs[q]["scores"] for q in group], axis=-1)
        v, p = select_top(torch.from_numpy(scores), TOP_K)
        assert o["values"].tobytes() == v.numpy().tobytes(), r
        assert o["positions"].tobytes() == p.numpy().tobytes(), r
        np.testing.assert_allclose(scores, one["scores"], **GRAD_TOL)
        np.testing.assert_allclose(o["values"], one["values"], **GRAD_TOL)
    if arch == "two_tower":
        n_inf = int(np.isneginf(one["values"]).sum())
        assert 0 < n_inf < TOP_K
        for o in outs:
            inf = np.isneginf(o["values"])
            assert inf.sum() == n_inf
            assert o["positions"][inf].tolist() == one["positions"][np.isneginf(one["values"])].tolist()


@pytest.mark.parametrize("arch,mname", CASES)
def test_bytes_a_rank_equal_the_dry_run(world, arch, mname):
    """Each rank's parameter bytes equal ``param_shapes(..., mesh)``'s
    per-device count on the case's mesh (meta), below one process's."""
    cfg = CFGS[arch]
    meta = make_mesh(MESHES[mname], AXES, device="meta")
    want = rf.arg_counts((param_shapes(cfg.param_defs(), meta),), meta)["arg_bytes_dev"]
    for o in world["four"]:
        assert o[(arch, mname)]["param_bytes"] == want < world["one"][arch]["param_bytes"]


@pytest.mark.parametrize("kind", list(CELLS))
def test_cells_on_a_process_mesh(world, kind):
    """``build_recsys_cell`` on the (2, 2) process mesh: each rank holds
    its rows of the serve batch or its half of the candidates (its own
    storage), the global train batch, and exactly the dry-run's parameter
    (and moment) bytes; ``fn`` gives one process's cell's output within
    ``GRAD_TOL`` (the serve rows, the merged top-100 values, the train
    step's loss within ``LOSS_TOL``)."""
    one = _cells(world["cands"])[kind]
    arch, shape_name, params = CELLS[kind]
    spec = dataclasses.replace(get_arch(ARCHS[arch]), config=CFGS[arch])
    shape = dataclasses.replace(spec.shape(shape_name), params=params)
    meta = make_mesh((2, 2), AXES, device="meta")
    args = p_steps.build_recsys_cell(spec, shape, device="meta", mesh=meta).args
    want_p = rf.arg_counts((args[0],), meta)["arg_bytes_dev"]
    for r, o in enumerate(world["four"]):
        got = o["cells"][kind]
        assert got["param_bytes"] == want_p < one["param_bytes"]
        if kind == "train":
            want_m = rf.arg_counts((args[1]["m"], args[1]["v"]), meta)["arg_bytes_dev"]
            assert got["moment_bytes"] == want_m < one["moment_bytes"]
            assert got["rows"] == one["rows"]
            np.testing.assert_allclose(got["loss"], one["loss"], **LOSS_TOL)
            continue
        assert got["rows"] == one["rows"] // 2 and got["storage"] == one["storage"] // 2
        if kind == "serve":
            np.testing.assert_allclose(got["out"][0], _rank_rows("2x2", one["out"][0], r),
                                       **GRAD_TOL)
        else:
            np.testing.assert_allclose(got["out"][0], one["out"][0], **GRAD_TOL)
            assert got["out"][0].tobytes() == world["four"][0]["cells"][kind]["out"][0].tobytes()


# the roofline's collectives of the SMOKE cells on (2, 2), by hand: per
# device, f32 (4 B); DCN-v2's deep_w0 is [52, 32] (4 dense + 6 x 8), the
# two-tower towers' w0 [32, 32] (8 x (1 + 2 + 1)) and [24, 32] (8 x 3)
ROOFLINE = {
    # 8 rows a rank: the deep layer's [8, 32] activation gathered
    ("dcn", "serve"): {"all-gather": 8 * 32 * 4},
    # + the backward's all-reduce of the [8, 52] input and the [32] bias
    ("dcn", "train"): {"all-gather": 8 * 32 * 4, "all-reduce": (8 * 52 + 32) * 4},
    # the user and item towers' gathers and all-reduces at 8 rows; v
    # [16, 16] and logq [16] gathered over data, v's cotangent scattered
    ("two_tower", "train"): {"all-gather": 8 * 32 * 4 * 2 + 16 * (16 * 4 + 4),
                             "all-reduce": (8 * 32 + 32) * 4 + (8 * 24 + 32) * 4,
                             "reduce-scatter": 16 * 16 * 4},
    # the user tower at 1 row, the item tower at 512 candidates, the merge
    # of 2 shards' 100 values and positions
    ("two_tower", "retrieval"): {"all-gather": 1 * 32 * 4 + 512 * 32 * 4 + 100 * 12 * 2},
    # 2 attention layers' outputs [8, 5, 2 x 8] gathered over the heads
    ("autoint", "serve"): {"all-gather": 2 * 8 * 5 * 16 * 4},
}


@pytest.mark.parametrize("arch,kind", list(ROOFLINE))
def test_roofline_counts_the_collectives(arch, kind):
    """``roofline.recsys_bytes`` of the SMOKE cells on the (2, 2) meta
    mesh, at 16 rows (a retrieval: 1 user, ``N_CAND`` candidates), against
    the bytes by hand: the ``ffn`` column gathers, the heads gather, the
    two-tower ``v`` gather and the top-k merge (the row lookups'
    all-reduce is :func:`count_step`'s)."""
    spec = dataclasses.replace(get_arch(ARCHS[arch]), config=CFGS[arch])
    meta = make_mesh((2, 2), AXES, device="meta")
    params = param_shapes(CFGS[arch].param_defs(), meta)
    kinds = {"serve": "recsys_serve", "train": "recsys_train", "retrieval": "recsys_retrieval"}
    Bk, n = (1, N_CAND) if kind == "retrieval" else (B, 0)
    got = rf.recsys_bytes(spec.config, kinds[kind], params, meta, Bk, n)
    assert got == {k: float(v) for k, v in ROOFLINE[(arch, kind)].items()}


def test_train_cli_model_parallel_on_two_ranks(world):
    """``python -m repro_torch.launch.train --arch dcn-v2 --model-parallel
    2`` as two gloo ranks (the (1, 2) mesh: tables, ``deep_w0`` over
    ``model``): rank 0 alone logs, its loss lines within ``CLI_RTOL`` of
    the one-process run's."""
    outs = [o["cli"] for o in world["two"]]
    assert outs[1] == ""
    pattern = r"^step +(\d+) +loss (\S+) "
    got = [m.group(1, 2) for m in re.finditer(pattern, outs[0], re.M)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(CLI_ARGS)
    want = [m.group(1, 2) for m in re.finditer(pattern, buf.getvalue(), re.M)]
    assert [s for s, _ in got] == [s for s, _ in want] == ["0", "1", "2", "3"]
    np.testing.assert_allclose([float(v) for _, v in got], [float(v) for _, v in want],
                               rtol=CLI_RTOL)

