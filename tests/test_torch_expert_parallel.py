"""PyTorch port: the MoE LMs across processes: experts over the ``model``
axis (the reference's ``"experts": ("model",)``) and the load-balance aux
loss over the global batch on meshes that split the batch.  ``gloo`` ranks
on the CPU (``repro_torch.launch.ranks.run_ranks``, torch on one thread
per rank; one world of 4 ranks) at the OLMoE and Granite-MoE SMOKE configs,
f32 compute (8 and 4 experts; 4 / 4 heads, head-parallel on any ``model``
here, and 4 / 2, sequence-parallel on ``model`` = 4), seq 32, batch 8, on
the reference's seed-0 weights (``params_from_numpy``), held to

* (a) one process's ``moe_ffn`` on the same layer: on (1, 4) the output,
  the aux, the gradient of ``x`` and the gathered router and expert
  gradient blocks, bitwise;
* (b) one process's ``microbatches=1`` step (``OPT``: ZeRO-1) on (1, 4),
  (2, 2) and (4, 1): step 0's loss and gathered gradients, the parameters
  after each of two AdamW steps, under ``test_torch_tensor_parallel.py``'s
  tolerances; every rank's losses and grad norms equal, the whole leaves
  bitwise equal across each ``model`` group;
* (c) the reference's one-device ``jax.value_and_grad(loss_fn)`` on the
  global batch: the ranks' gathered gradients within ``TOL``
  (``test_torch_moe.py``'s);
* (d) the reference's aux over the global batch on the data-split meshes
  (4, 1) and (2, 2): the ranks' aux within ``TOL``, on a batch where the
  mean of the data shards' own aux values lies more than 100 x ``TOL``
  away (a step that averaged the ranks' aux values would fail);
* (e) bf16 compute on (2, 2): the gaps from one process's bf16 step within
  ``BF16_GAP_FACTOR`` times that step's own gaps from f32.

Experts that ``model`` does not divide, kept whole, and ``microbatches`` >
1 on a data-split mesh: ``tests/test_torch_whole_leaves.py``.

Besides, ``collectives.split`` and ``all_gather_invariant`` on the (1, 4)
process mesh are bitwise their loop form on a plain ``Mesh``, forward and
backward.  Every launch is bounded by a timeout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import collectives as col  # noqa: E402
from repro_torch.core import make_mesh, make_process_mesh  # noqa: E402
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import moe as pm  # noqa: E402
from repro_torch.models.layers import head_parallel  # noqa: E402
from repro_torch.models.params import param_shardings, params_from_numpy, place_params  # noqa: E402
from repro_torch.models.transformer import loss_fn  # noqa: E402
from repro_torch.sharding.specs import local_block, use_sharding  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves  # noqa: E402

TIMEOUT_S = 240.0
AXES = ("data", "model")
SEED = 0
N_STEPS = 2
SEQ, GLOBAL_BATCH = 32, 8
ARCHS = {"olmoe": "olmoe-1b-7b", "granite": "granite-moe-1b-a400m"}
CFGS = {k: dataclasses.replace(get_arch(a).smoke_config, compute_dtype=torch.float32)
        for k, a in ARCHS.items()}
# tests/test_torch_tensor_parallel.py's optimizer and tolerances
OPT = OptimizerConfig(lr=1e-3, warmup_steps=2, zero1=True)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 1e-4
TRAJ_TOL = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=0)
BF16_GAP_FACTOR = 2
# tests/test_torch_moe.py's: the two packages differ in summation order only
TOL = dict(rtol=1e-4, atol=1e-5)
# name: (config, mesh shape)
CASES = {
    "olmoe_1x4": ("olmoe", (1, 4)),
    "olmoe_2x2": ("olmoe", (2, 2)),
    "olmoe_4x1": ("olmoe", (4, 1)),
    "granite_1x4": ("granite", (1, 4)),
    "granite_2x2": ("granite", (2, 2)),
}
DATA_SPLIT = [k for k, (_, shape) in CASES.items() if shape[0] > 1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the pieces each rank runs -----------------------------------------------

def _batch(cfg, step: int = 0) -> dict:
    return lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=GLOBAL_BATCH,
                                 seed=SEED), step, "cpu")


def _np(tree) -> list:
    return [x.detach().numpy().copy() for x in leaves(tree)]


def _params(cfg, weights, mesh=None) -> dict:
    """The reference's weights as the port's tensors; on a process mesh the
    rank's ``param_specs`` blocks."""
    params = params_from_numpy(cfg.param_defs(), weights, device="cpu")
    if mesh is None:
        return params
    return place_params(params, param_shardings(cfg.param_defs(), mesh))


def _run(cfg, weights, mesh=None) -> dict:
    """``OPT``'s step of ``cfg`` on ``mesh`` (a process mesh; None: one
    process at ``microbatches=1``): step 0's loss and gradients, each
    step's loss and grad norm, the parameters after each."""
    loss = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    params = _params(cfg, weights, mesh)
    if mesh is None:
        step, opt = make_train_step(loss, OPT), init_opt_state(OPT, params)
    else:
        ms = p_steps.moment_shardings(cfg.param_defs(), mesh)
        with use_sharding(mesh):
            step = make_train_step(loss, OPT, moment_shardings=ms)
        opt = init_opt_state(OPT, params, ms)
    value, _, grads = step.value_and_grad(params, _batch(cfg))
    out = {"grad_loss": float(value), "grads": _np(grads), "losses": [], "norms": [],
           "params": []}
    for s in range(N_STEPS):
        params, opt, m = step(params, opt, _batch(cfg, s))
        out["losses"].append(m["loss"].numpy().tobytes())
        out["norms"].append(m["grad_norm"].numpy().tobytes())
        out["params"].append(_np(params))
    return out


def _rank_aux(cfg, weights, mesh) -> float:
    """The aux loss as the data-parallel step computes it on this rank: the
    loss of the rank's rows of batch 0 under the mesh."""
    rows = GLOBAL_BATCH // mesh.shape["data"]
    d = mesh.coords_of(mesh.rank)["data"]
    batch = {k: v[d * rows:(d + 1) * rows] for k, v in _batch(cfg).items()}
    with use_sharding(mesh), torch.no_grad():
        return float(loss_fn(cfg, _params(cfg, weights, mesh), batch)[1]["aux"])


def _layer_inputs(cfg) -> tuple:
    """``moe_ffn``'s input x [8, 32, D] and the cotangents of its output and
    aux, from fixed seeds."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((GLOBAL_BATCH, SEQ, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g), 0.5


def _moe_layer(cfg, weights, mesh=None) -> list:
    """Layer 0's ``moe_ffn`` on ``_layer_inputs`` (the rank's expert and
    router blocks on a process mesh): out, aux, and the gradients of x and
    of the router, wi_gate, wi_up and wo (blocks)."""
    p = {k: v[0] for k, v in _params(cfg, weights, mesh)["layers"]["moe"].items()}
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x, g, w = _layer_inputs(cfg)
    x = x.clone().requires_grad_(True)
    out, aux = pm.moe_ffn(x, p, cfg, mesh)
    grads = torch.autograd.grad((out * g).sum() + w * aux, [x, *p.values()])
    return [t.detach().numpy() for t in (out, aux, *grads)]


def _collective_inputs(rank: int) -> tuple:
    """Position ``rank``'s input [2, 8, 12] (split's input: equal on every
    rank) and block [2, 2, 12], and the cotangents of split's output and of
    all_gather_invariant's (one for the group)."""
    g = torch.Generator().manual_seed(100 + rank)
    shared = torch.Generator().manual_seed(99)
    return (torch.randn(2, 8, 12, generator=shared), torch.randn(2, 2, 12, generator=g),
            torch.randn(2, 2, 12, generator=g), torch.randn(2, 8, 12, generator=shared))


def _collectives(mesh, ranks: list[int]) -> list:
    """split and all_gather_invariant along dim 1 over ``model`` of the
    positions ``ranks`` holds: outputs and input gradients."""
    ins = [_collective_inputs(r) for r in ranks]
    xs = [x.clone().requires_grad_(True) for x, _, _, _ in ins]
    bs = [b.clone().requires_grad_(True) for _, b, _, _ in ins]
    sp = col.split(mesh, xs, col.MODEL, dim=1)
    g_sp = torch.autograd.grad(sp, xs, [c for _, _, c, _ in ins])
    gat = col.all_gather_invariant(mesh, bs, col.MODEL, dim=1)
    # a plain mesh's group shares one output: its cotangent is given once
    uniq = list({id(t): t for t in gat}.values())
    g_gat = torch.autograd.grad(uniq, bs, [ins[0][3]] * len(uniq))
    return [tuple(t.detach().numpy() for t in ts) for ts in zip(sp, g_sp, gat, g_gat)]


def _rank4(rank: int, weights: dict) -> dict:
    torch.set_num_threads(1)
    out = {"runs": {}, "aux": {}}
    for name, (arch, shape) in CASES.items():
        mesh = make_process_mesh(shape, AXES, device="cpu")
        out["runs"][name] = _run(CFGS[arch], weights[arch], mesh)
        if name in DATA_SPLIT:
            out["aux"][name] = _rank_aux(CFGS[arch], weights[arch], mesh)
    mesh = make_process_mesh((1, 4), AXES, device="cpu")
    out["layer"] = {arch: _moe_layer(CFGS[arch], weights[arch], mesh) for arch in ARCHS}
    out["collectives"] = _collectives(mesh, [rank])[0]
    mesh = make_process_mesh((2, 2), AXES, device="cpu")
    cfg16 = dataclasses.replace(CFGS["olmoe"], compute_dtype=torch.bfloat16)
    out["bf16"] = _run(cfg16, weights["olmoe"], mesh)
    return out


# -- the fixtures --------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference on one device (in this process): each config's seed-0
    weights (numpy), ``value_and_grad`` of its ``loss_fn`` on the global
    batch 0, and its aux on the global batch and on each data shard of the
    data-split meshes."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rt

    out = {}
    for arch, name in ARCHS.items():
        rc = dataclasses.replace(ref_get_arch(name).smoke_config, compute_dtype=jnp.float32)
        rp = rc.init(jax.random.key(SEED))
        batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(CFGS[arch]).items()}
        vg = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(rc, p, b), has_aux=True))
        (loss, metrics), grads = vg(rp, batch)
        aux = jax.jit(lambda p, b: rt.loss_fn(rc, p, b)[1]["aux"])
        shards = {}
        for d in sorted({shape[0] for a, shape in CASES.values() if a == arch and shape[0] > 1}):
            rows = GLOBAL_BATCH // d
            shards[d] = [float(aux(rp, {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}))
                         for i in range(d)]
        out[arch] = {"weights": jax.tree.map(np.asarray, rp), "loss": float(loss),
                     "aux": float(metrics["aux"]), "shard_aux": shards,
                     "grads": {"/".join(str(k.key) for k in path): np.asarray(g)
                               for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}}
    return out


@pytest.fixture(scope="module")
def world(reference):
    weights = {arch: r["weights"] for arch, r in reference.items()}
    return run_ranks(_rank4, 4, args=(weights,), timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def one_process(reference):
    out = {arch: _run(cfg, reference[arch]["weights"]) for arch, cfg in CFGS.items()}
    out["olmoe_bf16"] = _run(dataclasses.replace(CFGS["olmoe"], compute_dtype=torch.bfloat16),
                             reference["olmoe"]["weights"])
    out["layer"] = {arch: _moe_layer(cfg, reference[arch]["weights"])
                    for arch, cfg in CFGS.items()}
    return out


def _gathered(cfg, shape, outs: list, what: str, i: int = 0) -> list:
    """Every leaf's global array from the ranks' blocks (``what``: "grads",
    or "params" after step ``i``)."""
    sh = leaves(param_shardings(cfg.param_defs(), make_mesh(shape, AXES, device="cpu")))
    whole = []
    for j, s in enumerate(sh):
        blocks = [o[what][j] if what == "grads" else o[what][i][j] for o in outs]
        g = np.empty(s.global_shape(blocks[0].shape), dtype=blocks[0].dtype)
        for r, blk in enumerate(blocks):
            local_block(g, s, r)[...] = blk
        whole.append(g)
    return whole


def _paths(tree) -> list:
    return ["/".join(k.strip("[]'") for k in p.split("/")) for p, _ in flatten_with_paths(tree)]


# -- the tests ---------------------------------------------------------------

def test_cases_split_experts_and_heads_as_described():
    """Every case's experts divide its ``model`` axis; Granite's 4 / 2
    heads run sequence-parallel on (1, 4) and every other case's
    head-parallel."""
    for name, (arch, (_, m)) in CASES.items():
        cfg = CFGS[arch]
        assert cfg.n_experts % m == 0
        assert head_parallel(cfg.n_heads, cfg.n_kv_heads, m) == (name != "granite_1x4"), name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_layer_across_model_ranks_bitwise(world, one_process, arch):
    """(a) Layer 0's ``moe_ffn`` with its experts and router split over
    ``model`` = 4: on every rank the output, the aux and the gradient of x
    are bitwise one process's, and the ranks' router and expert gradient
    blocks gathered are bitwise one process's whole gradients (torch's CPU
    ``bmm`` computes each expert's product alone, so E/M experts round as
    E do)."""
    want = one_process["layer"][arch]
    cfg = CFGS[arch]
    El = cfg.n_experts // 4
    for r, o in enumerate(world):
        got = o["layer"][arch]
        for j in range(3):  # out, aux, dx
            assert got[j].tobytes() == want[j].tobytes(), (r, j)
        assert got[3].tobytes() == want[3][:, r * El:(r + 1) * El].tobytes(), r
        for j in range(4, 7):
            assert got[j].tobytes() == want[j][r * El:(r + 1) * El].tobytes(), (r, j)


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_step_equals_one_process(world, one_process, reference, name):
    """(b) Every rank's losses and grad norms equal; step 0's loss within
    ``LOSS_TOL`` and its gathered gradients within ``GRAD_TOL`` of one
    process's ``microbatches=1`` step; the gathered parameters after each
    AdamW step within ``PARAM_ATOL`` and ``TRAJ_TOL``; the leaves
    ``param_specs`` keeps whole bitwise equal across each ``model``
    group."""
    arch, shape = CASES[name]
    cfg = CFGS[arch]
    outs, want = [o["runs"][name] for o in world], one_process[arch]
    for o in outs:
        assert o["losses"] == outs[0]["losses"] and o["norms"] == outs[0]["norms"]
        assert o["grad_loss"] == outs[0]["grad_loss"]
    np.testing.assert_allclose(outs[0]["grad_loss"], want["grad_loss"], **LOSS_TOL)
    for a, b in zip(_gathered(cfg, shape, outs, "grads"), want["grads"], strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    init = _np(_params(cfg, reference[arch]["weights"]))
    for i in range(N_STEPS):
        np.testing.assert_allclose(np.frombuffer(outs[0]["losses"][i], np.float32),
                                   np.frombuffer(want["losses"][i], np.float32), **LOSS_TOL)
        for a, b, b0 in zip(_gathered(cfg, shape, outs, "params", i), want["params"][i], init,
                            strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
            assert np.linalg.norm(a - b) <= TRAJ_TOL * np.linalg.norm(b - b0)
    mesh = make_mesh(shape, AXES, device="cpu")
    sh = leaves(param_shardings(cfg.param_defs(), mesh))
    whole = [j for j, s in enumerate(sh) if s.n_shards == 1]
    for r in range(mesh.size):
        for q in mesh.group(("model",), r):
            for j in whole:
                assert outs[r]["params"][-1][j].tobytes() == outs[q]["params"][-1][j].tobytes()


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_gradients_equal_reference(world, reference, name):
    """(c) The ranks' step-0 loss and gathered gradients against the
    reference's one-device ``value_and_grad`` of ``loss_fn`` on the global
    batch, within ``TOL``."""
    arch, shape = CASES[name]
    cfg = CFGS[arch]
    ref = reference[arch]
    outs = [o["runs"][name] for o in world]
    np.testing.assert_allclose(outs[0]["grad_loss"], ref["loss"], **TOL)
    paths = _paths(cfg.param_defs())
    for path, a in zip(paths, _gathered(cfg, shape, outs, "grads"), strict=True):
        b = ref["grads"][path]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, **TOL, err_msg=path)


@pytest.mark.parametrize("name", DATA_SPLIT)
def test_aux_over_the_global_batch_on_data_split_meshes(world, reference, name):
    """(d) On (4, 1) and (2, 2) every rank's aux loss, computed on its rows,
    is the reference's aux over the global batch within ``TOL``; the mean
    of the reference's aux over each data shard's rows lies more than 100 x
    ``TOL`` from it on this batch, so averaging the ranks' own values would
    fail."""
    arch, (D, _) = CASES[name]
    ref = reference[arch]
    per_shard = float(np.mean(ref["shard_aux"][D]))
    assert abs(per_shard - ref["aux"]) > 100 * (TOL["atol"] + TOL["rtol"] * abs(ref["aux"]))
    for o in world:
        np.testing.assert_allclose(o["aux"][name], ref["aux"], **TOL)


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def _gaps(got: dict, want: dict, init) -> dict:
    """The largest gaps of a run from another: loss (relative), gradients
    of step 0 (each leaf's relative L2 distance), parameters after each
    AdamW step (elementwise, and each leaf's distance over its travel)."""
    out = {"loss": max(abs(np.frombuffer(a, np.float32)[0] / np.frombuffer(b, np.float32)[0] - 1)
                       for a, b in zip(got["losses"], want["losses"])),
           "grad": max(_rel(a, b) for a, b in zip(got["grads"], want["grads"], strict=True)),
           "param": 0.0, "traj": 0.0}
    for i in range(len(got["params"])):
        for a, b, b0 in zip(got["params"][i], want["params"][i], init, strict=True):
            out["param"] = max(out["param"], float(np.abs(a - b).max()))
            out["traj"] = max(out["traj"], float(np.linalg.norm(a - b) / np.linalg.norm(b - b0)))
    return out


def test_expert_parallel_bf16_step_equals_one_process(world, one_process, reference):
    """(e) The (2, 2) OLMoE step at bf16 compute against one process's bf16
    ``microbatches=1`` step, gathered: each gap within ``BF16_GAP_FACTOR``
    times one process's bf16 step's gap from its f32 step on the same
    inputs."""
    cfg = CFGS["olmoe"]
    outs = [o["bf16"] for o in world]
    for o in outs:
        assert o["losses"] == outs[0]["losses"]
    got = {"losses": outs[0]["losses"], "grads": _gathered(cfg, (2, 2), outs, "grads"),
           "params": [_gathered(cfg, (2, 2), outs, "params", i) for i in range(N_STEPS)]}
    init = _np(_params(cfg, reference["olmoe"]["weights"]))
    tp = _gaps(got, one_process["olmoe_bf16"], init)
    bf16 = _gaps(one_process["olmoe_bf16"], one_process["olmoe"], init)
    print(f"(2, 2) bf16 gaps {tp}; one process's bf16 from f32 {bf16}")
    for k in tp:
        assert tp[k] <= BF16_GAP_FACTOR * bf16[k], (k, tp, bf16)


def test_split_and_all_gather_invariant_bitwise_their_loop_form(world):
    """On the (1, 4) process mesh, ``split`` (dim 1) and
    ``all_gather_invariant`` (dim 1), forward and backward, are bitwise the
    loop form's on a plain (1, 4) ``Mesh``; the loop form's split is block
    i of the input and its backward the cotangents' concatenation, the
    gather the blocks' concatenation and its backward block i of the one
    cotangent."""
    mesh = make_mesh((1, 4), AXES, device="cpu")
    loop = _collectives(mesh, list(range(4)))
    for r, (got, want) in enumerate(zip([o["collectives"] for o in world], loop, strict=True)):
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), r
    ins = [_collective_inputs(r) for r in range(4)]
    for i in range(4):
        sp, g_sp, gat, g_gat = loop[i]
        assert sp.tobytes() == ins[0][0][:, 2 * i:2 * i + 2].numpy().tobytes()
        assert g_sp.tobytes() == torch.cat([c for _, _, c, _ in ins], dim=1).numpy().tobytes()
        assert gat.tobytes() == torch.cat([b for _, b, _, _ in ins], dim=1).numpy().tobytes()
        assert g_gat.tobytes() == ins[0][3][:, 2 * i:2 * i + 2].numpy().tobytes()
