"""PyTorch port: the ``model`` axis across processes for the dense LM train
step, with resharding checkpoints and elastic resume.  ``gloo`` ranks on
the CPU (``repro_torch.launch.ranks.run_ranks``, torch on one thread per
rank) on (2, 2) and (4, 1) data x model process meshes of 4 ranks and a
(1, 2) mesh of 2, at the reference tests' config (2 layers, d 64, 4 heads,
kv 2, d_ff 128, vocab 256, seq 32, batch 8, f32 compute), held to

* the one-process step (tolerances below): losses, the step's reduced
  gradients and the parameters after AdamW, gathered from the ranks'
  ``param_specs`` blocks; ranks of one ``model`` group hold bitwise-equal
  whole leaves, and the (4, 1) mesh stays bitwise the ``microbatches=4``
  step; at bf16 compute, the (2, 2) step's gaps from one process's within
  twice that step's own gaps from f32;
* the ZeRO-1 checkpoint: a fault replayed by ``loop.run`` is bitwise the
  uninterrupted run, and every rank restores its own moment blocks;
* the guards: a restore onto other shapes, a model-parallel step without
  moment shardings; a projection width or an expert count that ``model``
  does not divide initialising those leaves whole (the recsys train cell
  over ``model`` building with its parameters in blocks);
* the elastic story of ``tests/test_elastic.py`` at 4 -> 2 ranks: train
  on (2, 2), checkpoint, resume on ``plan_elastic_mesh``'s (1, 2);
* the reference, in subprocesses on fake XLA devices (``AxisType.Auto``):
  its own elastic run from (4, 2) to (2, 2) on the same weights and
  batches, its ``restore_checkpoint`` reading the port's checkpoint onto
  its (2, 2) mesh, and the port reading the reference's.

Every launch is bounded by a timeout."""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import make_mesh, make_process_mesh  # noqa: E402
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.params import param_shardings, place_params  # noqa: E402
from repro_torch.models.transformer import TransformerConfig, loss_fn  # noqa: E402
from repro_torch.sharding.specs import local_block, use_sharding  # noqa: E402
from repro_torch.train import checkpoint as p_ckpt  # noqa: E402
from repro_torch.train.fault import plan_elastic_mesh  # noqa: E402
from repro_torch.train.loop import LoopConfig, make_train_step, run  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, unflatten  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
AXES = ("data", "model")
# tests/test_distributed.py's and tests/test_elastic.py's config
CFG = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                        attn_chunk=16, compute_dtype=torch.float32)
DATA = LMDataConfig(vocab=256, seq_len=32, global_batch=8)
# tests/test_elastic.py's optimizer, with ZeRO-1's moment blocks
OPT = OptimizerConfig(lr=1e-3, warmup_steps=2, zero1=True)
SEED = 0
N_STEPS = 6  # the elastic run: 4 steps on (2, 2), 2 on (1, 2)
CKPT_STEP = 4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_train.py's
# Parameters after AdamW: every entry within PARAM_ATOL of one process's
# (the reference's SPMD test's 1e-4; this config reads 2.6e-5 at most), and
# each leaf's distance from one process's within TRAJ_TOL of the distance
# it travelled (3.1e-4 read).  AdamW divides each first moment by the root
# of the second, so an entry whose gradient sits at its rounding noise
# moves by up to lr whatever its error: at Qwen1.5-0.5B's widths on the
# card a few of 362M entries do (6.9e-4), and chip_smoke.py phase 18 holds
# them within lr instead
PARAM_ATOL = 1e-4
TRAJ_TOL = 1e-2
# losses of two f32 runs whose gradients differ in rounding only (the
# model split, the batch split, XLA's order), compounding over 6 steps:
# 1.7e-7 apart on this config, against the port's one process and the
# reference alike
LOSS_TOL = dict(rtol=1e-5, atol=0)
# the published configs' bf16 compute: the row-parallel wo psums add bf16
# partial outputs (each rounded) where one process rounds one f32 sum.  The
# (2, 2) step's gaps from one process's bf16 step are held to
# BF16_GAP_FACTOR times that step's own gaps from one process's f32 step
# (the split may add no more than twice what bf16 itself does).  Read on
# this config, (2, 2) from one process's bf16 against bf16 from f32: the
# loss 3.2e-5 against 1.03e-4, the largest leaf's gradient distance 0.0140
# against 0.0183, parameters 0.00236 against 0.00273, travel 0.2513 against
# 0.2506 (1.003 x); the f32 (2, 2) step's gaps are 6e-8, 7.0e-7, 2.4e-5
# and 3.9e-4
CFG_BF16 = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
BF16_GAP_FACTOR = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the pieces each rank runs -----------------------------------------------

def _batch(step: int) -> dict:
    return lm_batch(dataclasses.replace(DATA, seed=SEED), step, "cpu")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _np(tree) -> list:
    return [x.detach().numpy().copy() for x in leaves(tree)]


def _step(mesh, microbatches: int = 1, cfg=CFG):
    """``OPT``'s step of ``cfg`` on ``mesh`` (a process mesh: data- and
    tensor-parallel; None: one process) and its zero state."""
    loss = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    if mesh is None:
        params = cfg.init(SEED, "cpu")
        return make_train_step(loss, OPT, microbatches), params, init_opt_state(OPT, params)
    ms = p_steps.moment_shardings(cfg.param_defs(), mesh)
    with use_sharding(mesh):
        step = make_train_step(loss, OPT, moment_shardings=ms)
    params = cfg.init(SEED, "cpu", mesh)
    return step, params, init_opt_state(OPT, params, ms)


def _run(mesh, n: int, microbatches: int = 1, cfg=CFG) -> dict:
    """``n`` steps on the batches of steps 0..n-1: step 0's loss and
    gradients, each step's loss and grad norm, the parameters after each."""
    step, params, opt = _step(mesh, microbatches, cfg)
    loss, _, grads = step.value_and_grad(params, _batch(0))
    out = {"grad_loss": float(loss), "grads": _np(grads), "losses": [], "norms": [],
           "params": [], "digests": []}
    for s in range(n):
        params, opt, m = step(params, opt, _batch(s))
        out["losses"].append(m["loss"].numpy().tobytes())
        out["norms"].append(m["grad_norm"].numpy().tobytes())
        out["params"].append(_np(params))
        out["digests"].append(_digest(leaves(params)))
    return out


def _loop(mesh, ckpt_dir, total: int, fail_at=None, record=None):
    """``loop.run`` of ``OPT``'s step on ``mesh`` with the state's
    shardings: (params, opt_state, history).  ``record`` collects each
    call's input step and moment blocks."""
    step, params, opt = _step(mesh)
    if record is not None:
        inner = step

        def step(p, o, b):
            record.append((int(o["step"]), _np(o["m"]) + _np(o["v"])))
            return inner(p, o, b)

    cfg = LoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=1,
                     simulate_failure_at=fail_at)
    return run(cfg, step, lambda: (params, opt), _batch, log=lambda line: None,
               barrier=torch.distributed.barrier,
               shardings=p_steps.state_shardings(CFG.param_defs(), mesh))


def _history(h) -> list:
    return [np.float32(loss).tobytes() for _, loss in h]


def _lm_spec():
    spec = get_arch("qwen1.5-0.5b")
    spec = dataclasses.replace(spec, config=dataclasses.replace(CFG, qkv_bias=True))
    shape = spec.shape("train_4k")
    return spec, dataclasses.replace(shape, params={**shape.params, "global_batch": 8,
                                                    "seq_len": 32})


def _cell_bytes(mesh) -> dict:
    """The train cell (QKV bias, ``TRAIN_OPT``) on ``mesh``: its parameter
    and moment bytes and one step's loss."""
    spec, shape = _lm_spec()
    cell = p_steps.build_lm_cell(spec, shape, seed=SEED, mesh=mesh)
    params, opt, batch = cell.args
    out = {"param_bytes": sum(x.nbytes for x in leaves(params)),
           "moment_bytes": sum(x.nbytes for x in leaves(opt["m"]) + leaves(opt["v"]))}
    _, _, m = cell.fn(params, opt, batch)
    out["cell_loss"] = float(m["loss"])
    return out


def _rank4(rank: int, dirs: dict) -> dict:
    """The (2, 2) mesh: the step twice over (a manual run and ``loop.run``
    with a checkpoint every 2 steps, the elastic run's first half), the
    cell's bytes; the (4, 1) mesh: the step, and a fault replayed by
    ``loop.run`` beside the uninterrupted run."""
    torch.set_num_threads(1)
    mesh = make_process_mesh((2, 2), AXES, device="cpu")
    out = {"22": _run(mesh, 2), "22_bf16": _run(mesh, 2, cfg=CFG_BF16),
           "22_cell": _cell_bytes(mesh), "placed": _placed(mesh)}
    params, opt, hist = _loop(mesh, dirs["elastic"], CKPT_STEP)
    out["22_loop"] = {"history": _history(hist), "state": _np((params, opt))}
    mesh = make_process_mesh((4, 1), AXES, device="cpu")
    out["41"] = _run(mesh, 2)
    record = []
    params, opt, hist = _loop(mesh, dirs["fault"], 5, fail_at=3, record=record)
    out["41_fault"] = {"history": _history(hist), "digest": _digest(leaves(params)),
                       "record": record}
    params, opt, hist = _loop(mesh, None, 5)
    out["41_clean"] = {"history": _history(hist), "digest": _digest(leaves(params))}
    return out


# leaves that model = 2 does not divide, kept whole as logical_spec keeps
# them: d_head 15 and kv 1, a kv projection width of 15 (a d_head that
# RoPE cannot halve, on one process too: whole kv projections run at
# d_head 16 on model = 3 in tests/test_torch_whole_leaves.py); 3 experts
# (their steps there on 6 experts over model = 4)
WHOLE = {"width": dataclasses.replace(CFG, d_model=60, n_kv_heads=1),
         "moe": dataclasses.replace(CFG, n_experts=3, top_k=2)}


def _guards(mesh, ckpt_dir) -> dict:
    out = {}
    for what, cfg in WHOLE.items():
        params = cfg.init(SEED, "cpu", mesh)
        out[what + "_init"] = {p: tuple(x.shape) for p, x in flatten_with_paths(params)}
    wide = dataclasses.replace(CFG, d_ff=256)
    like = (wide.init(SEED, "cpu", mesh), init_opt_state(OPT, wide.init(SEED, "cpu", mesh)))
    try:
        p_ckpt.restore_checkpoint(ckpt_dir, CKPT_STEP, like,
                                  p_steps.state_shardings(CFG.param_defs(), mesh))
    except ValueError as e:
        out["restore"] = str(e)
    try:
        with use_sharding(mesh):
            make_train_step(lambda p, b: loss_fn(CFG, p, b), OPT)
    except ValueError as e:
        out["no_shardings"] = str(e)
    spec = get_arch("dcn-v2")
    cell = p_steps.build_recsys_cell(dataclasses.replace(spec, config=spec.smoke_config),
                                     spec.shape("train_batch"), mesh=mesh)
    out["recsys"] = {k: tuple(cell.args[0][k].shape) for k in ("table_0", "deep_w0", "cross_w0")}
    return out


def _placed(mesh) -> bool:
    """``place_params`` of the one-process init is bitwise the sharded
    init (each leaf drawn whole, its block kept)."""
    placed = place_params(CFG.init(SEED, "cpu"), param_shardings(CFG.param_defs(), mesh))
    return all(torch.equal(a, b) for a, b in zip(leaves(placed),
                                                 leaves(CFG.init(SEED, "cpu", mesh))))


def _remat_off_context(mesh) -> bool:
    """Remat "full" recomputes each layer in the backward, on the card on
    autograd's device thread, where the thread-local sharding context is
    not set: gradients taken outside the context equal those inside."""
    params = CFG.init(SEED, "cpu", mesh)
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with use_sharding(mesh):
        loss, _ = loss_fn(CFG, unflatten(params, live), _batch(0))
        inside = torch.autograd.grad(loss, live, retain_graph=True)
    outside = torch.autograd.grad(loss, live)
    return all(torch.equal(a, b) for a, b in zip(inside, outside))


def _rank2(rank: int, dirs: dict) -> dict:
    """The (1, 2) mesh (``plan_elastic_mesh`` for one host of 2 chips):
    the step; the elastic resume from the (2, 2) checkpoint, each restored
    block against the checkpoint's global arrays; the reference's (4, 2)
    checkpoint read the same way; the guards."""
    torch.set_num_threads(1)
    shape = plan_elastic_mesh(n_alive_hosts=1, chips_per_host=2, model_parallel=2)
    mesh = make_process_mesh(shape, AXES, device="cpu")
    out = {"shape": shape, "12": _run(mesh, 2), "12_cell": _cell_bytes(mesh),
           "remat_off_context": _remat_off_context(mesh), "placed": _placed(mesh)}
    shardings = p_steps.state_shardings(CFG.param_defs(), mesh)
    for name in ("elastic", "ref"):
        _, params, opt = _step(mesh)
        got = p_ckpt.restore_checkpoint(dirs[name], CKPT_STEP, (params, opt), shardings)
        same = []
        final = os.path.join(dirs[name], f"step_{CKPT_STEP:08d}")
        with open(os.path.join(final, "manifest.json")) as f:
            files = {m["path"]: m["file"] for m in json.load(f)["leaves"]}
        for (path, x), sh in zip(flatten_with_paths(got), leaves(shardings)):
            want = local_block(np.load(os.path.join(final, files[path])), sh)
            same.append(x.dtype == torch.from_numpy(np.asarray(want)).dtype
                        and x.numpy().tobytes() == np.ascontiguousarray(want).tobytes())
        out[name + "_restored_bitwise"] = same
        out[name + "_n_leaves"] = len(files)
    params, opt, hist = _loop(mesh, dirs["elastic"], N_STEPS)
    out["12_loop"] = {"history": _history(hist)}
    out["guards"] = _guards(mesh, dirs["elastic"])
    return out


# -- the reference, in subprocesses on fake XLA devices ----------------------

REF_PRELUDE = textwrap.dedent("""
    import json, sys, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models.transformer import TransformerConfig, loss_fn
    from repro.models.params import param_shapes
    from repro.sharding.specs import use_sharding
    from repro.train import checkpoint as ckpt
    from repro.train.loop import make_train_step
    from repro.train.optimizer import OptimizerConfig, init_opt_state, zero1_sharding

    cfg = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                            vocab=256, attn_chunk=16, compute_dtype=jnp.float32)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2)
    inputs = np.load({inputs!r})

    def nest(prefix):
        out = {{}}
        for k in inputs.files:
            if k.startswith(prefix):
                *parents, name = k[len(prefix):].split("/")
                node = out
                for p in parents:
                    node = node.setdefault(p, {{}})
                node[name] = jnp.asarray(inputs[k])
        return out

    def mesh_of(shape, devices):
        return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=devices)

    def shardings(mesh, moments):
        ps = jax.tree.map(lambda s: s.sharding, param_shapes(cfg.param_defs(), mesh))
        ms = jax.tree.map(lambda s: zero1_sharding(mesh, s.sharding.spec, s.shape),
                          param_shapes(cfg.param_defs(), mesh)) if moments else ps
        return ps, {{"step": None, "m": ms, "v": ms}}
""")

# tests/test_elastic.py's story on the port's weights and batches: (4, 2)
# for 4 steps, a checkpoint, plan_elastic_mesh's (2, 2) for 2 more
REF_ELASTIC = REF_PRELUDE + textwrap.dedent("""
    from repro.train.fault import plan_elastic_mesh

    params = nest("params/")
    state = init_opt_state(opt, params)
    losses = []
    step = make_train_step(lambda p, b: loss_fn(cfg, p, b), opt, donate=False)
    batch = lambda s: {{k: jnp.asarray(inputs[f"batch/{{s}}/{{k}}"]) for k in ("tokens", "labels")}}
    mesh1 = mesh_of((4, 2), jax.devices()[:8])
    with use_sharding(mesh1), jax.set_mesh(mesh1):
        for s in range(4):
            params, state, m = step(params, state, batch(s))
            losses.append(float(m["loss"]))
        ckpt.save_checkpoint({out_dir!r}, 4, (params, state))
    shape = plan_elastic_mesh(n_alive_hosts=1, chips_per_host=4, model_parallel=2)
    mesh2 = mesh_of(shape, jax.devices()[:4])
    with use_sharding(mesh2), jax.set_mesh(mesh2):
        params, state = ckpt.restore_checkpoint({out_dir!r}, 4, (params, state),
                                                shardings(mesh2, False))
        for s in range(4, 6):
            params, state, m = step(params, state, batch(s))
            losses.append(float(m["loss"]))
    print(json.dumps({{"losses": losses, "shape": list(shape)}}))
""")

# the reference's resharding restore of the port's (2, 2) checkpoint onto
# its own (2, 2) mesh (ZeRO-1 moment shardings): every device's shard
REF_READ = REF_PRELUDE + textwrap.dedent("""
    mesh = mesh_of((2, 2), jax.devices()[:4])
    params = nest("params/")
    like = (params, init_opt_state(opt, params))
    got = ckpt.restore_checkpoint({port_dir!r}, 4, like, shardings(mesh, True))
    devices = mesh.devices
    out = {{}}
    for i, x in enumerate(jax.tree.leaves(got)):
        for sh in x.addressable_shards:
            d, m = (int(c) for c in np.argwhere(devices == sh.device)[0])
            out[f"{{i}}/{{d * 2 + m}}"] = np.asarray(sh.data)
    np.savez({out_path!r}, **out)
    print(json.dumps({{"leaves": len(jax.tree.leaves(got))}}))
""")


def _ref_env():
    return dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))


def _start(code: str):
    return subprocess.Popen([sys.executable, "-c", code], env=_ref_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything, run once: the reference's elastic run starts first
    (the port's weights and batches in an ``.npz``); the 4 ranks run
    beside it; then the reference reads the port's checkpoint while the 2
    ranks resume from it and read the reference's."""
    tmp = tmp_path_factory.mktemp("tp")
    dirs = {k: str(tmp / k) for k in ("elastic", "fault", "ref")}
    arrays = {f"params/{p}": x.numpy()
              for p, x in _paths(CFG.init(SEED, "cpu"))}
    for s in range(N_STEPS):
        for k, v in _batch(s).items():
            arrays[f"batch/{s}/{k}"] = v.numpy()
    np.savez(tmp / "inputs.npz", **arrays)
    ref = _start(REF_ELASTIC.format(inputs=str(tmp / "inputs.npz"), out_dir=dirs["ref"]))
    try:
        four = run_ranks(_rank4, 4, args=(dirs,), timeout_s=TIMEOUT_S)
        read = _start(REF_READ.format(inputs=str(tmp / "inputs.npz"), port_dir=dirs["elastic"],
                                      out_path=str(tmp / "read.npz")))
        try:
            ref_out = _finish(ref)
            two = run_ranks(_rank2, 2, args=(dirs,), timeout_s=TIMEOUT_S)
            _finish(read)
        finally:
            read.kill()
    finally:
        ref.kill()
    return {"four": four, "two": two, "ref": ref_out, "read": dict(np.load(tmp / "read.npz")),
            "dirs": dirs}


def _paths(params) -> list:
    """(path joined by "/", leaf) in flattened order (the npz keys)."""
    return [("/".join(k.strip("[]'") for k in p.split("/")), x)
            for p, x in flatten_with_paths(params)]


@pytest.fixture(scope="module")
def one_process():
    """The one-process runs: ``microbatches`` 1, 2 and 4, and bf16 compute
    at ``microbatches`` 2 (the (2, 2) mesh's data split)."""
    out = {mb: _run(None, N_STEPS if mb == 2 else 2, mb) for mb in (1, 2, 4)}
    out["bf16"] = _run(None, 2, 2, CFG_BF16)
    return out


def _gathered(outs: list, mesh_shape, key: str, i: int, what: str) -> list:
    """Every leaf's global array from the ranks' blocks of run ``key``
    (``what``: "grads" or "params", after step ``i``)."""
    sh = leaves(param_shardings(CFG.param_defs(), make_mesh(mesh_shape, AXES, device="cpu")))
    n = len(sh)
    whole = []
    for j in range(n):
        x = outs[0][key][what] if what == "grads" else outs[0][key][what][i]
        g = np.empty(sh[j].global_shape(x[j].shape), dtype=x[j].dtype)
        for r, o in enumerate(outs):
            blk = o[key][what][j] if what == "grads" else o[key][what][i][j]
            local_block(g, sh[j], r)[...] = blk
        whole.append(g)
    return whole


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["2x2", "1x2"])
def test_tensor_parallel_step_equals_one_process(world, one_process, name):
    """(a) Two steps on the (2, 2) and (1, 2) meshes: every rank's loss and
    grad norm equal on all ranks; the gathered gradients of step 0 within
    ``GRAD_TOL`` of the one-process ``microbatches=D`` step's, its loss
    within ``LOSS_TOL``; the gathered parameters after each AdamW step
    within ``PARAM_ATOL`` and ``TRAJ_TOL``; and the (2, 2) manual run bitwise equal to
    ``loop.run``'s first two steps (the checkpoint of step 2's arrays).
    On (1, 2), gradients whose remat recomputation runs outside the
    sharding context (as on autograd's device thread) are bitwise those
    taken inside it."""
    outs, mesh_shape, key = ((world["four"], (2, 2), "22") if name == "2x2"
                             else (world["two"], (1, 2), "12"))
    want = one_process[mesh_shape[0]]
    for o in outs:
        assert o[key]["losses"] == outs[0][key]["losses"]
        assert o[key]["norms"] == outs[0][key]["norms"]
    np.testing.assert_allclose(outs[0][key]["grad_loss"], want["grad_loss"], **LOSS_TOL)
    for a, b in zip(_gathered(outs, mesh_shape, key, 0, "grads"), want["grads"], strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    for i in range(2):
        np.testing.assert_allclose(np.frombuffer(outs[0][key]["losses"][i], np.float32),
                                   np.frombuffer(want["losses"][i], np.float32), **LOSS_TOL)
        for a, b, b0 in zip(_gathered(outs, mesh_shape, key, i, "params"), want["params"][i],
                            leaves(CFG.init(SEED, "cpu")), strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
            assert np.linalg.norm(a - b) <= TRAJ_TOL * np.linalg.norm(b - b0.numpy())
    if name == "1x2":
        assert all(o["remat_off_context"] for o in outs)
    if name == "2x2":
        assert outs[0]["22_loop"]["history"][:2] == outs[0][key]["losses"]
        final = os.path.join(world["dirs"]["elastic"], "step_00000002")
        with open(os.path.join(final, "manifest.json")) as f:
            files = {m["path"]: m["file"] for m in json.load(f)["leaves"]}
        got = _gathered(outs, mesh_shape, key, 1, "params")
        for (path, _), g in zip(flatten_with_paths(CFG.init(SEED, "cpu")), got, strict=True):
            a = np.load(os.path.join(final, files[f"[0]/{path}"]))
            assert a.tobytes() == g.tobytes(), path


@pytest.mark.parametrize("name", ["2x2", "1x2"])
def test_whole_leaves_bitwise_equal_across_model_groups(world, name):
    """(b) The leaves ``param_specs`` leaves whole (the norms) are bitwise
    equal on every rank of a ``model`` group (and of the mesh), after each
    step; the split leaves' blocks differ across the group.  Every rank's
    sharded init is ``place_params`` of the one-process init, bitwise."""
    outs, mesh_shape, key = ((world["four"], (2, 2), "22") if name == "2x2"
                             else (world["two"], (1, 2), "12"))
    assert all(o["placed"] for o in outs)
    mesh = make_mesh(mesh_shape, AXES, device="cpu")
    sh = leaves(param_shardings(CFG.param_defs(), mesh))
    whole = [j for j, s in enumerate(sh) if s.n_shards == 1]
    assert len(whole) == 3 and len(sh) - len(whole) == 9  # ln1, ln2, ln_f
    for r in range(mesh.size):
        for q in mesh.group(("model",), r):
            for i in range(2):
                for j, (a, b) in enumerate(zip(outs[r][key]["params"][i],
                                               outs[q][key]["params"][i])):
                    if j in whole:
                        assert a.tobytes() == b.tobytes(), (r, q, i, j)
                    elif q != r:
                        assert a.tobytes() != b.tobytes(), (r, q, i, j)


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def _bf16_gaps(got: dict, want: dict, init) -> dict:
    """The largest gaps of a run from another: loss (relative),
    gradients of step 0 (each leaf's relative L2 distance), parameters
    after each AdamW step (elementwise, and each leaf's distance over its
    travel)."""
    out = {"loss": max(abs(np.frombuffer(a, np.float32)[0] / np.frombuffer(b, np.float32)[0] - 1)
                       for a, b in zip(got["losses"], want["losses"])),
           "grad": max(_rel(a, b) for a, b in zip(got["grads"], want["grads"], strict=True)),
           "param": 0.0, "traj": 0.0}
    for i in range(len(got["params"])):
        for a, b, b0 in zip(got["params"][i], want["params"][i], init, strict=True):
            out["param"] = max(out["param"], float(np.abs(a - b).max()))
            out["traj"] = max(out["traj"], float(np.linalg.norm(a - b) / np.linalg.norm(b - b0)))
    return out


def test_tensor_parallel_bf16_step_equals_one_process(world, one_process):
    """The (2, 2) step at bf16 compute (the published configs') against
    one process's bf16 ``microbatches=2`` step, gathered: each gap within
    ``BF16_GAP_FACTOR`` times the one-process bf16 step's gap from its f32
    step on the same inputs.  The f32 (2, 2) step's gaps are printed
    beside them (``pytest -s``)."""
    outs = world["four"]
    for o in outs:
        assert o["22_bf16"]["losses"] == outs[0]["22_bf16"]["losses"]

    def gathered(key):
        return {"losses": outs[0][key]["losses"], "grads": _gathered(outs, (2, 2), key, 0, "grads"),
                "params": [_gathered(outs, (2, 2), key, i, "params") for i in range(2)]}

    init = [x.numpy() for x in leaves(CFG.init(SEED, "cpu"))]
    tp = _bf16_gaps(gathered("22_bf16"), one_process["bf16"], init)
    bf16 = _bf16_gaps(one_process["bf16"], one_process[2], init)
    f32 = _bf16_gaps(gathered("22"), one_process[2], init)
    print(f"(2, 2) bf16 gaps {tp}; one process's bf16 from f32 {bf16}; (2, 2) f32 {f32}")
    for k in tp:
        assert tp[k] <= BF16_GAP_FACTOR * bf16[k], (k, tp, bf16)


def test_data_only_mesh_stays_bitwise_microbatches(world, one_process):
    """(c) On the (4, 1) mesh (``model`` = 1) the step is bitwise the
    one-process ``microbatches=4`` step: parameters, losses and norms."""
    want = one_process[4]
    for o in world["four"]:
        got = o["41"]
        assert got["digests"] == want["digests"]
        assert got["losses"] == want["losses"] and got["norms"] == want["norms"]


def test_zero1_fault_replay_restores_each_ranks_blocks(world):
    """(d) ``loop.run`` on the (4, 1) mesh with ZeRO-1 and a checkpoint
    every 2 steps, a failure injected at step 3: the replay is bitwise the
    uninterrupted run (losses, final parameters); each rank's restored
    moment blocks are its own from before the fault, and differ from rank
    0's wherever the global moments' blocks differ (the writer's blocks
    handed to every rank would fail this)."""
    outs = world["four"]
    blocks = []
    for r, o in enumerate(outs):
        f, c = o["41_fault"], o["41_clean"]
        # the replay logs step 2 again
        assert len(c["history"]) == 5 and f["history"] == c["history"][:3] + c["history"][2:], r
        assert f["digest"] == c["digest"], r
        steps = [s for s, _ in f["record"]]
        assert steps == [0, 1, 2, 2, 3, 4], steps  # step 2 replayed from the checkpoint
        before, after = f["record"][2][1], f["record"][3][1]
        assert [a.tobytes() for a in after] == [b.tobytes() for b in before], r
        blocks.append(after)
    for r in range(1, len(outs)):  # every leaf's moments split over data
        differ = [a.tobytes() != b.tobytes() for a, b in zip(blocks[r], blocks[0])]
        assert all(differ), (r, differ)
    assert sorted(os.listdir(world["dirs"]["fault"])) == [
        "step_00000002", "step_00000004"]


def test_elastic_resume_on_fewer_ranks(world, one_process):
    """(e) Train on (2, 2) with ZeRO-1 and checkpoint at step 4; resume on
    ``plan_elastic_mesh(n_alive_hosts=1, chips_per_host=2,
    model_parallel=2)`` = (1, 2): every restored block is a bitwise slice
    of the checkpoint's global arrays, and the six losses are within
    ``LOSS_TOL`` of the uninterrupted one-process run's."""
    two = world["two"]
    assert tuple(two[0]["shape"]) == (1, 2)
    for o in two:
        assert all(o["elastic_restored_bitwise"]) and len(o["elastic_restored_bitwise"]) == 37
    first = world["four"][0]["22_loop"]["history"]
    rest = two[0]["12_loop"]["history"]
    assert all(o["12_loop"]["history"] == rest for o in two)
    assert all(o["22_loop"]["history"] == first for o in world["four"])
    losses = np.frombuffer(b"".join(first + rest), np.float32)
    assert len(losses) == N_STEPS
    want = np.frombuffer(b"".join(one_process[2]["losses"]), np.float32)
    np.testing.assert_allclose(losses, want, **LOSS_TOL)


def test_checkpoints_cross_packages_bitwise(world):
    """(f) The reference's ``restore_checkpoint`` reads the port's (2, 2)
    checkpoint onto its (2, 2) mesh of 4 fake XLA devices: each device's
    shard is bitwise the block the port's rank at that position held; the
    port's (1, 2) ranks read the reference's checkpoint written from (4, 2),
    each block bitwise the slice of the reference's global array."""
    read = world["read"]
    for r, o in enumerate(world["four"]):
        state = o["22_loop"]["state"]
        assert len(state) == 37 and int(state[24]) == CKPT_STEP  # [1]/['step']
        for i, x in enumerate(state):
            # the step's sharding is None: placed whole on the first device
            got = read[f"{i}/{r}" if i != 24 else "24/0"]
            assert got.dtype == x.dtype and got.shape == x.shape, (r, i)
            assert got.tobytes() == x.tobytes(), (r, i)
    for o in world["two"]:
        assert o["ref_n_leaves"] == 37 and all(o["ref_restored_bitwise"])


def test_reference_elastic_run_matches_the_port(world):
    """(g) The reference's own elastic run (``tests/test_elastic.py`` with
    ``AxisType.Auto``, (4, 2) then (2, 2)) on the port's weights and
    batches: its six losses within ``LOSS_TOL`` of the port's elastic
    run's (XLA and torch round the same f32 step apart)."""
    assert world["ref"]["shape"] == [2, 2]
    port = np.frombuffer(b"".join(world["four"][0]["22_loop"]["history"]
                                  + world["two"][0]["12_loop"]["history"]), np.float32)
    np.testing.assert_allclose(port, np.asarray(world["ref"]["losses"], np.float32),
                               **LOSS_TOL)


@pytest.mark.parametrize("name", ["2x2", "1x2"])
def test_cell_bytes_equal_the_dry_run_per_device(world, name):
    """The train cell (``build_lm_cell`` on the process mesh, QKV biases,
    ``TRAIN_OPT``): each rank's parameter and moment bytes equal the
    dry-run's per-device count (``roofline.arg_counts`` of the meta cell's
    shardings on the same mesh shape), exactly, and lie below one
    process's; its first step's loss within ``LOSS_TOL`` of the
    one-process cell's."""
    outs, mesh_shape, key = ((world["four"], (2, 2), "22_cell") if name == "2x2"
                             else (world["two"], (1, 2), "12_cell"))
    spec, shape = _lm_spec()
    meta = make_mesh(mesh_shape, AXES, device="meta")
    params, opt, _ = p_steps.build_lm_cell(spec, shape, device="meta", mesh=meta).args
    want_p = rf.arg_counts((params,), meta)["arg_bytes_dev"]
    want_m = rf.arg_counts((opt["m"], opt["v"]), meta)["arg_bytes_dev"]
    cell = p_steps.build_lm_cell(spec, shape, device="cpu", seed=SEED)
    one_p = sum(x.nbytes for x in leaves(cell.args[0]))
    one_m = sum(x.nbytes for x in leaves(cell.args[1]["m"]) + leaves(cell.args[1]["v"]))
    _, _, m = cell.fn(*cell.args)
    for o in outs:
        got = o[key]
        assert got["param_bytes"] == want_p < one_p
        assert got["moment_bytes"] == want_m < one_m
        np.testing.assert_allclose(got["cell_loss"], float(m["loss"]), **LOSS_TOL)


def test_guards_raise(world):
    """(h) A projection width and an expert count that ``model`` does not
    divide initialise those leaves whole, as ``logical_spec`` keeps them,
    and halve the others (steps with whole leaves:
    ``tests/test_torch_whole_leaves.py``); a restore whose ``like`` blocks
    differ from the checkpoint's raises ``ValueError``; a model-parallel
    step without moment shardings raises too.  The recsys train cell
    builds with its parameters in blocks
    (``tests/test_torch_recsys_parallel.py`` holds its steps)."""
    want = {what: {p: tuple(x.shape) for p, x in flatten_with_paths(cfg.init(SEED, "cpu"))}
            for what, cfg in WHOLE.items()}
    for o in world["two"]:
        g = o["guards"]
        for what in WHOLE:
            got, whole = g[what + "_init"], want[what]
            assert got.keys() == whole.keys()
            halved = {p for p in got if got[p] != whole[p]}
            for p in halved:  # a block over model = 2: one dim halved
                assert sum(a != b for a, b in zip(got[p], whole[p])) == 1, p
                assert [b // 2 for a, b in zip(got[p], whole[p]) if a != b] == [
                    a for a, b in zip(got[p], whole[p]) if a != b], p
        # the kv projections (15 columns) whole, q and wo (30) split; the
        # 3 experts and their router whole, the 4 / 2 heads and vocab split
        assert {p for p in g["width_init"] if g["width_init"][p] != want["width"][p]} == {
            "['embed']", "['unembed']", "['layers']/['attn']/['wq']",
            "['layers']/['attn']/['wo']", "['layers']/['mlp']/['wi_gate']",
            "['layers']/['mlp']/['wi_up']", "['layers']/['mlp']/['wo']"}
        assert {p for p in g["moe_init"] if g["moe_init"][p] != want["moe"][p]} == {
            "['embed']", "['unembed']", "['layers']/['attn']/['wq']",
            "['layers']/['attn']/['wk']", "['layers']/['attn']/['wv']",
            "['layers']/['attn']/['wo']"}
        assert "expected" in g["restore"], g
        assert "moment_shardings" in g["no_shardings"], g
        # the SMOKE DCN-v2 train cell builds on (1, 2), its table rows
        # and first deep layer in blocks over model, the cross layer whole
        assert g["recsys"] == {"table_0": (128, 8), "deep_w0": (52, 16), "cross_w0": (52, 52)}
