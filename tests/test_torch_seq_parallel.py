"""PyTorch port: sequence-parallel attention over the ``model`` axis for the
dense LM train step, where the query or kv heads do not divide ``model``
(the reference's adaptive split, ``repro/models/layers.py:136-154``).
``gloo`` ranks on the CPU (``repro_torch.launch.ranks.run_ranks``, torch on
one thread per rank), f32 compute, held to

* the one-process step (``microbatches`` = the data axis): the loss of
  step 0 and its gradients gathered from the ranks' ``param_specs``
  blocks, the parameters after each of two AdamW steps (ZeRO-1), every
  rank's losses and grad norms equal, the whole leaves bitwise equal
  across each ``model`` group;
* the reference: ``value_and_grad`` of its ``loss_fn`` under
  ``jax.set_mesh`` on an ``AxisType.Auto`` mesh of the same shape (fake XLA
  devices, one subprocess), on the same weights and batch;

on these cases:

* the Qwen2.5 SMOKE config (5 heads, kv 1, d_head 16, QKV bias) on (2, 2)
  and (1, 4), and with seq 30 on (1, 4), which ``model`` does not divide
  (every rank attends all rows, as the reference's shape-aware spec
  drops the axis);
* ``tests/test_elastic.py``'s config (4 heads, kv 2) on (1, 4): the kv
  heads alone do not divide (Granite-MoE's 8 kv heads on 16);
* that config with kv 1 on (1, 2), and with kv 1 and qk-norm on (2, 2).

Besides: ``collectives.all_to_all`` and the dim-wise ``all_gather`` on a
process mesh bitwise their loop form on a plain ``Mesh``, forward and
backward; the train CLI on two ranks with ``--model-parallel 2``; and
``roofline.lm_activation_bytes`` for Qwen2.5-14B ``train_4k`` on the
production (16, 16) mesh against a count by hand.  Every launch is
bounded by a timeout."""
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
from repro_torch.core import collectives as col  # noqa: E402
from repro_torch.core import make_mesh, make_process_mesh  # noqa: E402
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.layers import head_parallel  # noqa: E402
from repro_torch.models.params import param_shardings  # noqa: E402
from repro_torch.models.transformer import TransformerConfig, loss_fn  # noqa: E402
from repro_torch.sharding.specs import local_block, use_sharding  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
AXES = ("data", "model")
SEED = 0
N_STEPS = 2
GLOBAL_BATCH = 8
# tests/test_torch_tensor_parallel.py's config and tolerances
ELASTIC = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                            vocab=256, attn_chunk=16, compute_dtype=torch.float32)
QWEN = dataclasses.replace(get_arch("qwen2.5-14b").smoke_config, compute_dtype=torch.float32)
OPT = OptimizerConfig(lr=1e-3, warmup_steps=2, zero1=True)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 1e-4
TRAJ_TOL = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=0)
# name: (config, mesh shape, seq)
CASES = {
    "qwen_2x2": (QWEN, (2, 2), 32),
    "qwen_1x4": (QWEN, (1, 4), 32),
    # 30 rows on 4 ranks; 10-key chunks so that 30 splits into chunks
    "qwen_1x4_s30": (dataclasses.replace(QWEN, attn_chunk=10), (1, 4), 30),
    "kv2_1x4": (ELASTIC, (1, 4), 32),
    "kv1_1x2": (dataclasses.replace(ELASTIC, n_kv_heads=1), (1, 2), 32),
    # q_norm / k_norm (whole leaves) on the rank's rows and on the whole k
    "kv1_qknorm_2x2": (dataclasses.replace(ELASTIC, n_kv_heads=1, qk_norm=True), (2, 2), 32),
}
FOUR = [k for k, (_, shape, _) in CASES.items() if shape[0] * shape[1] == 4]
TWO = [k for k, (_, shape, _) in CASES.items() if shape[0] * shape[1] == 2]
# the train CLI's Qwen2.5 SMOKE run (bf16 compute, its default): the
# model-parallel ranks' loss lines against one process's, within the bf16
# split's rounding (the row-parallel psums add bf16 partial outputs)
CLI_ARGS = ["--device", "cpu", "--arch", "qwen2.5-14b", "--steps", "6", "--batch-size", "4",
            "--seq-len", "32"]
CLI_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the pieces each rank runs -----------------------------------------------

def _batch(name: str, step: int) -> dict:
    cfg, _, seq = CASES[name]
    return lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=GLOBAL_BATCH,
                                 seed=SEED), step, "cpu")


def _np(tree) -> list:
    return [x.detach().numpy().copy() for x in leaves(tree)]


def _run(name: str, mesh) -> dict:
    """``OPT``'s step of the case on ``mesh`` (a process mesh; None: one
    process at ``microbatches`` = the data axis): step 0's loss and
    gradients, each step's loss and grad norm, the parameters after each."""
    cfg, shape, _ = CASES[name]
    loss = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    if mesh is None:
        params = cfg.init(SEED, "cpu")
        step = make_train_step(loss, OPT, shape[0])
        opt = init_opt_state(OPT, params)
    else:
        ms = p_steps.moment_shardings(cfg.param_defs(), mesh)
        with use_sharding(mesh):
            step = make_train_step(loss, OPT, moment_shardings=ms)
        params = cfg.init(SEED, "cpu", mesh)
        opt = init_opt_state(OPT, params, ms)
    value, _, grads = step.value_and_grad(params, _batch(name, 0))
    out = {"grad_loss": float(value), "grads": _np(grads), "losses": [], "norms": [],
           "params": []}
    for s in range(N_STEPS):
        params, opt, m = step(params, opt, _batch(name, s))
        out["losses"].append(m["loss"].numpy().tobytes())
        out["norms"].append(m["grad_norm"].numpy().tobytes())
        out["params"].append(_np(params))
    return out


def _collective_inputs(rank: int, n: int) -> tuple:
    """Position ``rank``'s input [2, 8, 12] and the cotangents of its
    all_to_all (rows to columns) and all_gather (along dim 2) outputs."""
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(2, 8, 12, generator=g)
    return x, torch.randn(2, 8 // n, 12 * n, generator=g), torch.randn(2, 8, 12 * n, generator=g)


def _collectives(mesh, ranks: list[int]) -> list:
    """all_to_all(split 1, concat 2) and all_gather(dim 2) over ``model``
    of the positions ``ranks`` holds: outputs and input gradients."""
    n = mesh.shape["model"]
    ins = [_collective_inputs(r, n) for r in ranks]
    xs = [x.clone().requires_grad_(True) for x, _, _ in ins]
    a2a = col.all_to_all(mesh, xs, col.MODEL, split_dim=1, concat_dim=2)
    g_a2a = torch.autograd.grad(a2a, xs, [c for _, c, _ in ins])
    gat = col.all_gather(mesh, xs, col.MODEL, dim=2)
    g_gat = torch.autograd.grad(gat, xs, [c for _, _, c in ins])
    return [tuple(t.detach().numpy() for t in ts)
            for ts in zip(a2a, g_a2a, gat, g_gat)]


def _rank4(rank: int) -> dict:
    torch.set_num_threads(1)
    out = {name: _run(name, make_process_mesh(CASES[name][1], AXES, device="cpu"))
           for name in FOUR}
    out["collectives"] = _collectives(make_process_mesh((1, 4), AXES, device="cpu"), [rank])[0]
    return out


def _rank2(rank: int, ckpt_dir: str) -> dict:
    torch.set_num_threads(1)
    out = {name: _run(name, make_process_mesh(CASES[name][1], AXES, device="cpu"))
           for name in TWO}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(CLI_ARGS + ["--model-parallel", "2", "--ckpt-dir", ckpt_dir,
                                 "--ckpt-every", "2", "--simulate-failure", "3"])
    out["cli"] = buf.getvalue()
    return out


# -- the reference, in a subprocess on fake XLA devices ----------------------

REF = textwrap.dedent("""
    import json, sys, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models.transformer import TransformerConfig, loss_fn
    from repro.sharding.specs import use_sharding

    cases = json.loads({cases!r})
    out = {{}}
    for name, case in cases.items():
        inputs = np.load(case["inputs"])
        params = {{}}
        for k in inputs.files:
            if k.startswith("params/"):
                *parents, leaf = k[len("params/"):].split("/")
                node = params
                for p in parents:
                    node = node.setdefault(p, {{}})
                node[leaf] = jnp.asarray(inputs[k])
        batch = {{k: jnp.asarray(inputs[k]) for k in ("tokens", "labels")}}
        cfg = TransformerConfig(**case["cfg"], compute_dtype=jnp.float32)
        shape = tuple(case["mesh"])
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        with use_sharding(mesh), jax.set_mesh(mesh):
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: loss_fn(cfg, p, b), has_aux=True))(params, batch)
        out[name + "/loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[name + "/" + "/".join(str(k.key) for k in path)] = np.asarray(g)
    np.savez({out_path!r}, **out)
    print(json.dumps({{"cases": len(cases)}}))
""")
REF_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "qkv_bias",
              "qk_norm", "attn_chunk", "rope_theta")


def _paths(tree) -> list:
    """(path joined by "/", leaf) in flattened order."""
    return [("/".join(k.strip("[]'") for k in p.split("/")), x)
            for p, x in flatten_with_paths(tree)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything, run once: the reference's subprocess starts first (each
    case's weights and batch 0 in an ``.npz``), the 4 ranks and then the
    2 ranks run beside it."""
    tmp = tmp_path_factory.mktemp("sp")
    cases = {}
    for name, (cfg, shape, _) in CASES.items():
        arrays = {f"params/{p}": x.numpy() for p, x in _paths(cfg.init(SEED, "cpu"))}
        arrays.update({k: v.numpy() for k, v in _batch(name, 0).items()})
        np.savez(tmp / f"{name}.npz", **arrays)
        cases[name] = {"inputs": str(tmp / f"{name}.npz"), "mesh": list(shape),
                       "cfg": {f: getattr(cfg, f) for f in REF_FIELDS}}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen([sys.executable, "-c", REF.format(cases=json.dumps(cases),
                                                             out_path=str(tmp / "ref.npz"))],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        four = run_ranks(_rank4, 4, timeout_s=TIMEOUT_S)
        two = run_ranks(_rank2, 2, args=(str(tmp / "ckpt"),), timeout_s=TIMEOUT_S)
        _, err = ref.communicate(timeout=TIMEOUT_S)
        assert ref.returncode == 0, err[-3000:]
    finally:
        ref.kill()
    return {"ranks": {name: [o[name] for o in (four if name in FOUR else two)] for name in CASES},
            "collectives": [o["collectives"] for o in four], "cli": [o["cli"] for o in two],
            "ref": dict(np.load(tmp / "ref.npz")), "ckpt": tmp / "ckpt"}


@pytest.fixture(scope="module")
def one_process():
    return {name: _run(name, None) for name in CASES}


def _gathered(name: str, outs: list, what: str, i: int = 0) -> list:
    """Every leaf's global array from the ranks' blocks (``what``: "grads",
    or "params" after step ``i``)."""
    cfg, shape, _ = CASES[name]
    sh = leaves(param_shardings(cfg.param_defs(), make_mesh(shape, AXES, device="cpu")))
    whole = []
    for j, s in enumerate(sh):
        blocks = [o[what][j] if what == "grads" else o[what][i][j] for o in outs]
        g = np.empty(s.global_shape(blocks[0].shape), dtype=blocks[0].dtype)
        for r, blk in enumerate(blocks):
            local_block(g, s, r)[...] = blk
        whole.append(g)
    return whole


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_cases_run_sequence_parallel(name):
    """Each case's heads do not divide its ``model`` axis, so its attention
    runs sequence-parallel; the projection widths, d_ff and the padded
    vocab divide it."""
    cfg, (_, m), seq = CASES[name]
    assert not head_parallel(cfg.n_heads, cfg.n_kv_heads, m)
    for n in (cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head, cfg.d_ff, cfg.padded_vocab):
        assert n % m == 0
    assert (seq % m != 0) == name.endswith("_s30")


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_parallel_step_equals_one_process(world, one_process, name):
    """Every rank's losses and grad norms equal; step 0's loss within
    ``LOSS_TOL`` and its gathered gradients within ``GRAD_TOL`` of the
    one-process step's; the gathered parameters after each AdamW step
    within ``PARAM_ATOL`` and ``TRAJ_TOL`` (each leaf's distance from one
    process's over the distance it travelled)."""
    outs, want = world["ranks"][name], one_process[name]
    cfg = CASES[name][0]
    for o in outs:
        assert o["losses"] == outs[0]["losses"] and o["norms"] == outs[0]["norms"]
        assert o["grad_loss"] == outs[0]["grad_loss"]
    np.testing.assert_allclose(outs[0]["grad_loss"], want["grad_loss"], **LOSS_TOL)
    for a, b in zip(_gathered(name, outs, "grads"), want["grads"], strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    init = [x.numpy() for x in leaves(cfg.init(SEED, "cpu"))]
    for i in range(N_STEPS):
        np.testing.assert_allclose(np.frombuffer(outs[0]["losses"][i], np.float32),
                                   np.frombuffer(want["losses"][i], np.float32), **LOSS_TOL)
        for a, b, b0 in zip(_gathered(name, outs, "params", i), want["params"][i], init,
                            strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
            assert np.linalg.norm(a - b) <= TRAJ_TOL * np.linalg.norm(b - b0)


@pytest.mark.parametrize("name", list(CASES))
def test_whole_leaves_bitwise_equal_across_model_groups(world, name):
    """The leaves ``param_specs`` leaves whole (the norms, qk-norm's too) are bitwise equal
    on every rank of a ``model`` group after each step; the split leaves'
    blocks differ across it."""
    outs = world["ranks"][name]
    cfg, shape, _ = CASES[name]
    mesh = make_mesh(shape, AXES, device="cpu")
    sh = leaves(param_shardings(cfg.param_defs(), mesh))
    whole = [j for j, s in enumerate(sh) if s.n_shards == 1]
    assert len(whole) == 3 + 2 * cfg.qk_norm  # ln1, ln2, ln_f; q_norm, k_norm
    for r in range(mesh.size):
        for q in mesh.group(("model",), r):
            for i in range(N_STEPS):
                for j, (a, b) in enumerate(zip(outs[r]["params"][i], outs[q]["params"][i])):
                    if j in whole:
                        assert a.tobytes() == b.tobytes(), (r, q, i, j)
                    elif q != r:
                        assert a.tobytes() != b.tobytes(), (r, q, i, j)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_loss_and_gradients_on_its_auto_mesh(world, name):
    """The reference's ``value_and_grad`` of ``loss_fn`` on an
    ``AxisType.Auto`` mesh of the case's shape (its sequence-parallel
    branch), on the port's weights and batch 0: its loss within
    ``LOSS_TOL`` of the ranks', its gradients within ``GRAD_TOL`` of the
    ranks' gathered ones."""
    ref, outs = world["ref"], world["ranks"][name]
    cfg = CASES[name][0]
    np.testing.assert_allclose(outs[0]["grad_loss"], ref[name + "/loss"], **LOSS_TOL)
    paths = [p for p, _ in _paths(cfg.init(SEED, "cpu"))]
    for path, a in zip(paths, _gathered(name, outs, "grads"), strict=True):
        b = ref[f"{name}/{path}"]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=path)


def test_all_to_all_and_all_gather_bitwise_their_loop_form(world):
    """On the (1, 4) process mesh, ``all_to_all`` (rows to columns) and the
    ``all_gather`` along dim 2, and the gradients of both, are bitwise the
    loop form's on a plain (1, 4) ``Mesh``; the loop form's forward is the
    definition (member i: block i of every member, in group order), and
    its backward the inverse ``all_to_all``."""
    mesh = make_mesh((1, 4), AXES, device="cpu")
    loop = _collectives(mesh, list(range(4)))
    for r, (got, want) in enumerate(zip(world["collectives"], loop, strict=True)):
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), r
    ins = [_collective_inputs(r, 4) for r in range(4)]
    for i in range(4):
        a2a, g_a2a, gat, _ = loop[i]
        want = torch.cat([x[:, 2 * i:2 * i + 2] for x, _, _ in ins], dim=2)
        assert a2a.tobytes() == want.numpy().tobytes()
        back = torch.cat([ins[j][1][:, :, 12 * i:12 * i + 12] for j in range(4)], dim=1)
        assert g_a2a.tobytes() == back.numpy().tobytes()
        assert gat.tobytes() == torch.cat([x for x, _, _ in ins], dim=2).numpy().tobytes()


def test_train_cli_model_parallel_on_two_ranks(world):
    """``python -m repro_torch.launch.train --arch qwen2.5-14b
    --model-parallel 2`` as two gloo ranks (the SMOKE config's 5 / 1 heads
    on ``model`` = 2: sequence-parallel): rank 0 alone logs; a failure at
    step 3 restores the step-2 checkpoint of the ranks' blocks and replays
    step 2 with the same loss line; the losses within ``CLI_RTOL`` of the
    one-process run's."""
    outs = world["cli"]
    assert outs[1] == ""
    assert "[fault] restoring step 2" in outs[0]
    got = [m.group(1, 2) for m in re.finditer(r"^step +(\d+) +loss (\S+) ", outs[0], re.M)]
    assert [s for s, _ in got] == ["0", "1", "2", "2", "3", "4", "5"]
    assert got[2] == got[3]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(CLI_ARGS)
    want = [float(m.group(1)) for m in re.finditer(r"^step +\d+ +loss (\S+) ", buf.getvalue(),
                                                  re.M)]
    assert len(want) == 6
    np.testing.assert_allclose([float(v) for _, v in got[:3] + got[4:]], want, rtol=CLI_RTOL)
    assert sorted(os.listdir(world["ckpt"])) == ["step_00000002", "step_00000004",
                                                 "step_00000006"]


def test_lm_activation_bytes_qwen25_14b_train_4k_on_the_production_mesh():
    """Qwen2.5-14B ``train_4k`` (256 x 4,096, bf16 compute, remat full: 3
    passes, 48 layers) on the (16, 16) mesh: the batch splits 16 ways;
    per layer and pass the ``wo`` all-reduces of attention and the FFN
    (256·4096·5120·2 / 16 B each), the all-to-alls of q and of the
    attention output (the same size: H·Dh = 40·128 = 5120) and the
    all-gathers of k and v (256·4096·8·128·2 / 16 B each)."""
    spec = get_arch("qwen2.5-14b")
    mesh = make_production_mesh()
    shape = spec.shape("train_4k")
    cell = p_steps.build_lm_cell(spec, shape, device="meta", mesh=mesh)
    tokens = cell.args[2]["tokens"]
    assert tokens.sharding.n_shards == 16
    got = rf.lm_activation_bytes(spec.config, "lm_train", 256, 4096, cell.args[0], mesh, 16)
    act = 256 * 4096 * 5120 * 2 // 16
    kv = 256 * 4096 * 8 * 128 * 2 // 16
    assert got == {"all-reduce": 3 * 48 * 2 * act, "all-to-all": 3 * 48 * 2 * act,
                   "all-gather": 3 * 48 * 2 * kv}
    # heads that divide model (Qwen1.5-0.5B's 16 / 16) add neither
    q15 = get_arch("qwen1.5-0.5b")
    cell = p_steps.build_lm_cell(q15, q15.shape("train_4k"), device="meta", mesh=mesh)
    assert set(rf.lm_activation_bytes(q15.config, "lm_train", 256, 4096, cell.args[0], mesh,
                                      16)) == {"all-reduce"}
