"""PyTorch port: the train-side collectives across processes.  Four
``gloo`` ranks on the CPU (``repro_torch.launch.ranks.run_ranks``, torch on
one thread per rank) on a (4, 1) data x model and a (2, 2, 1) pod x data x
model process mesh, held to

* the port's one-process loop on the same mesh shape (bitwise): the
  collectives and their gradients, ``psum_compressed``, EGNN's
  ``make_sharded_loss`` and its gradients, the ``gnn_full`` cell's steps;
* the port's dense update (bitwise) and the reference's ``adamw_update``
  with ``zero1_sharding`` moment shardings (within ``ADAM_TOL``): ZeRO-1;
* the one-process ``microbatches=4`` step (bitwise): the data-parallel
  step of the SmolLM-135M and DCN-v2 SMOKE cells, and the train CLI on two
  ranks against ``--microbatches 2``;
* the reference on 4 of 8 fake XLA devices, run once in subprocesses
  started with the module's first test: ``psum_compressed`` under
  ``shard_map`` over groups of 4 and 2 (mean and error buffer bitwise), and
  ``make_sharded_loss`` on (4,) and (2, 2, 1) meshes (``AxisType.Auto``
  under ``jax.set_mesh``) at f32 and bf16 compute.

Every launch is bounded by a timeout."""
import contextlib
import dataclasses
import hashlib
import io
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
from repro_torch.core import distributed as pd  # noqa: E402
from repro_torch.data import graph as p_graph  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import egnn as p_egnn  # noqa: E402
from repro_torch.models import transformer as p_tf  # noqa: E402
from repro_torch.sharding.specs import PartitionSpec, use_sharding  # noqa: E402
from repro_torch.train import compression as p_comp  # noqa: E402
from repro_torch.train import optimizer as p_opt  # noqa: E402
from repro_torch.train.loop import make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
MESHES = {
    "4x1": ((4, 1), ("data", "model")),
    "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
}
# the axes each mesh's collectives run over: groups of 4 and 2
AXES = {"4x1": (("data",), ("data", "model")),
        "2x2x1": (("pod", "data"), ("data",), ("pod", "data", "model"))}
# psum_compressed: (port mesh, axes) -> the reference's (mesh shape, names)
# on 4 devices; group sizes 4 and 2, powers of two
COMPRESS = {("4x1", ("data",)): ((4,), ("data",)),
            ("2x2x1", ("pod", "data")): ((2, 2), ("pod", "data")),
            ("2x2x1", ("data",)): ((2, 2), ("pod", "data"))}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
DP_ARCHS = ("smollm-135m", "dcn-v2")
ZERO1_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, zero1=True)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # XLA and torch sum products in other orders
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)  # XLA's CPU contracts multiply-adds
# the sharded loss against the reference's, f32 compute: the matmuls (XLA's
# and torch's) round apart; the segment sums add in the same order
F32_LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16 compute, as tests/test_torch_egnn.py holds loss_fn: the loss within
# 2^-5 of its magnitude, each gradient within 2^-3 in relative norm (the
# psum_scatter of bf16 partials adds in bf16 in the port, in XLA's order
# and precision in the reference)
BF16_REL = 2.0**-5
BF16_GRAD_REL = 2.0**-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- inputs, shared by the ranks, the loop and the reference ----------------

def egnn_case(dtype: str):
    """The port's EGNN SMOKE config at ``dtype`` compute, its parameters
    (seed 0) and a 256-node, 1,024-edge power-law graph."""
    cfg = dataclasses.replace(get_arch("egnn").smoke_config, compute_dtype=DTYPES[dtype])
    g = p_graph.make_powerlaw_graph(256, 1024, cfg.d_feat, n_classes=cfg.n_classes, seed=0,
                                    device="cpu")
    return cfg, cfg.init(0, "cpu"), p_graph.full_graph_batch(g, edge_multiple=8, device="cpu")


def compress_case(pos: int):
    """Position ``pos``'s gradients and error buffer (numpy)."""
    rng = np.random.default_rng(100 + pos)
    g = {"w": rng.normal(0, 1 + pos, (6, 5)).astype(np.float32),
         "b": rng.normal(0, 0.1, (5,)).astype(np.float32)}
    e = {k: rng.normal(0, 0.01, v.shape).astype(np.float32) for k, v in g.items()}
    return g, e


def zero1_case():
    """Parameters and two steps' gradients (numpy): ``w`` splits over data
    on dim 0, ``u`` on dim 1, ``s`` stays whole (3 rows divide by neither)."""
    rng = np.random.default_rng(7)

    def tree(scale):
        return {"w": rng.normal(0, scale, (8, 6)).astype(np.float32),
                "u": rng.normal(0, scale, (3, 4)).astype(np.float32),
                "s": rng.normal(0, scale, (3,)).astype(np.float32)}

    return tree(1.0), [tree(0.5), tree(2.0)]


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _np(tree):
    return [x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
            for x in leaves(tree)]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# -- the pieces each rank runs, and the loop beside it -----------------------

def _collectives(mesh, name, dtype):
    """Every collective over each of the mesh's ``AXES``, forward and
    gradients, on position p's input ``p + arange``: host arrays."""
    local = col.positions(mesh)
    out = {}
    for axes in AXES[name]:
        tag = ",".join(axes)
        x = [(torch.arange(24.0) * 0.37 + p).reshape(8, 3).to(dtype) for p in local]
        pieces = {"ag": [t.clone().requires_grad_(True) for t in x],
                  "rs": [t.clone().requires_grad_(True) for t in x],
                  "ps": [t.clone().requires_grad_(True) for t in x]}
        ag = col.all_gather(mesh, pieces["ag"], axes)
        rs = col.psum_scatter(mesh, pieces["rs"], axes)
        ps = col.psum(mesh, pieces["ps"], axes)
        pm = col.pmax(mesh, [-t for t in x], axes)
        obj = sum(((a * (p + 1)).sum() + (r * r).sum()) for p, a, r in zip(local, ag, rs))
        # each group's replicated sum read once (on the loop, at its first member)
        obj = obj + sum((o * 3).sum() for o in {id(o): o for o in ps}.values())
        obj.backward()
        for k, v in (("ag", ag), ("rs", rs), ("ps", ps), ("pm", pm)):
            out[f"{tag}/{k}"] = [t.detach().float().numpy() for t in v]
        for k, v in pieces.items():
            out[f"{tag}/{k}.grad"] = [t.grad.float().numpy() for t in v]
    # replicated parameters over every axis
    w = {"a": torch.linspace(-1, 1, 6).reshape(2, 3).requires_grad_(True),
         "b": torch.ones(3).requires_grad_(True)}
    obj = sum(((prm["a"] * (p + 0.5)).sum() + (prm["b"] ** 2 * p).sum())
              for p, prm in zip(local, col.replicated(mesh, w, mesh.axis_names)))
    obj.backward()
    out["replicated.grad"] = [w["a"].grad.numpy(), w["b"].grad.numpy()]
    return out


def _compress(mesh, axes):
    """``psum_compressed`` of each local position's ``compress_case``."""
    cases = [compress_case(p) for p in col.positions(mesh)]
    with use_sharding(mesh):
        if isinstance(mesh, pd.ProcessMesh):
            mean, err = p_comp.psum_compressed(_t(cases[0][0]), _t(cases[0][1]), axes)
            return [(_np(mean), _np(err))]
        means, errs = p_comp.psum_compressed([_t(g) for g, _ in cases],
                                             [_t(e) for _, e in cases], axes)
        return [(_np(m), _np(e)) for m, e in zip(means, errs)]


def _egnn(mesh, dtype):
    """The sharded loss, its metrics and gradients (loss, acc, grads)."""
    cfg, params, batch = egnn_case(dtype)
    axes = p_egnn.sharded_axes(mesh)
    if isinstance(mesh, pd.ProcessMesh):
        batch = p_egnn.graph_rows(batch, col.group_size(mesh, axes),
                                  mesh.group(axes, mesh.rank).index(mesh.rank))
    loss, metrics, grads = value_and_grad(p_egnn.make_sharded_loss(cfg, mesh), params, batch)
    return float(loss), float(metrics["acc"]), loss.numpy().tobytes(), _np(grads)


def _zero1(mesh):
    """Two ZeRO-1 updates (``zero1_sharding``'s layout on ``mesh``):
    params, this rank's moment blocks, grad norms, the moments' bytes."""
    params, grads = zero1_case()
    p = _t(params)
    ms = {k: p_opt.zero1_sharding(mesh, PartitionSpec(), v.shape) for k, v in params.items()}
    cfg = p_opt.OptimizerConfig(**ZERO1_OPT)
    state = p_opt.init_opt_state(cfg, p, ms)
    norms = []
    for g in grads:
        p, state, m = p_opt.adamw_update(cfg, _t(g), p, state, ms)
        norms.append(m["grad_norm"].numpy().tobytes())
    return {"params": _np(p), "m": _np(state["m"]), "v": _np(state["v"]), "norms": norms,
            "blocks": p_opt.zero1_blocks(cfg, p, ms),
            "moment_bytes": sum(x.nbytes for x in leaves(state["m"]) + leaves(state["v"]))}


def _dp_cell(arch, mesh=None):
    """The arch's SMOKE train cell (global batch 4 x 32 tokens, or 64
    rows), on ``mesh``'s ranks or, without it, one process on the CPU."""
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke_config)
    if spec.family == "lm":
        shape = spec.shape("train_4k")
        shape = dataclasses.replace(shape, params={**shape.params, "global_batch": 4,
                                                   "seq_len": 32})
    else:
        shape = spec.shape("train_batch")
        shape = dataclasses.replace(shape, params={**shape.params, "batch": 64})
    return p_steps.build_cell(spec, shape, mesh=mesh, device=None if mesh else "cpu")


def _run_steps(step, params, opt, batch, n=2):
    out = []
    for _ in range(n):
        params, opt, m = step(params, opt, batch)
        out.append((_digest(leaves(params)), m["loss"].numpy().tobytes(),
                    m["grad_norm"].numpy().tobytes()))
    return out, sum(x.nbytes for x in leaves(opt["m"]) + leaves(opt["v"]))


def _gnn_full(mesh):
    """Two steps of the ``gnn_full`` SMOKE cell on ``egnn_case``'s graph:
    on a process mesh the cell (ZeRO-1, the sharded loss on the rank's
    rows); on a plain mesh the sharded loss's loop with the dense update."""
    spec = get_arch("egnn")
    shape = spec.shape("full_graph_sm")
    cfg, _, batch = egnn_case("f32")
    p = dict(shape.params, d_feat=cfg.d_feat, n_classes=cfg.n_classes)
    shape = dataclasses.replace(shape, params=p)
    spec = dataclasses.replace(spec, config=cfg)
    if isinstance(mesh, pd.ProcessMesh):
        cell = p_steps.build_gnn_cell(spec, shape, batch=batch, mesh=mesh)
        return _run_steps(cell.fn, *cell.args)
    params = p_steps.gnn_cell_config(spec, shape).init(0, "cpu")
    step = make_train_step(p_egnn.make_sharded_loss(p_steps.gnn_cell_config(spec, shape), mesh),
                           p_steps.TRAIN_OPT)
    return _run_steps(step, params, p_opt.init_opt_state(p_steps.TRAIN_OPT, params), batch)


def _guards(mesh):
    """What a mismatch raises, by name."""
    out = {}
    try:
        pd.make_process_mesh((8, 1), ("data", "model"), device="cpu")
    except ValueError as e:
        out["world"] = str(e)
    try:
        col.psum(mesh, [torch.ones(2), torch.ones(2)], ("data",))
    except ValueError as e:
        out["entries"] = str(e)
    cell = _dp_cell("dcn-v2", mesh)
    params, opt, batch = cell.args
    try:
        cell.fn(params, opt, {k: v[:6] for k, v in batch.items()})
    except ValueError as e:
        out["rows"] = str(e)
    try:
        p_comp.psum_compressed(*map(_t, compress_case(0)), ("data",))
    except RuntimeError as e:
        out["no_mesh"] = str(e)
    return out


def _rank(rank, name):
    torch.set_num_threads(1)
    mesh = pd.make_process_mesh(*MESHES[name], device="cpu")
    return {
        "collectives": {dt: _collectives(mesh, name, DTYPES[dt]) for dt in DTYPES},
        "compress": {axes: _compress(mesh, axes) for (m, axes) in COMPRESS if m == name},
        "egnn": {dt: _egnn(mesh, dt) for dt in DTYPES},
        "zero1": _zero1(mesh),
        "dp": {arch: _run_steps(c.fn, *c.args)
               for arch, c in ((a, _dp_cell(a, mesh)) for a in DP_ARCHS)},
        "gnn_full": _gnn_full(mesh),
        "guards": _guards(mesh),
    }


@pytest.fixture(scope="module")
def ranks():
    """Each mesh's 4 ranks (``_rank``), run once on first use."""
    box = {}

    def get(name):
        if name not in box:
            box[name] = run_ranks(_rank, 4, args=(name,), timeout_s=TIMEOUT_S)
        return box[name]

    return get


def _loop(name):
    return pd.make_mesh(*MESHES[name], device="cpu")


# -- the reference, in subprocesses on fake XLA devices ----------------------

REF_CODE = textwrap.dedent("""
    import dataclasses, sys, numpy as np, jax, jax.numpy as jnp, torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    from jax.sharding import AxisType, PartitionSpec as P
    import test_torch_train_collectives as T
    from repro.configs import get_arch
    from repro.models import egnn
    from repro.train import compression, optimizer

    devs = jax.devices()[:4]
    out = {{}}
    job = {job!r}
    if job.startswith("egnn"):
        shape, names = T.MESHES[job[5:]]
        jshape = (4,) if job == "egnn_4x1" else shape
        jnames = ("data",) if job == "egnn_4x1" else names
        mesh = jax.make_mesh(jshape, jnames, axis_types=(AxisType.Auto,) * len(jshape),
                             devices=devs)
        for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            pcfg, pparams, pbatch = T.egnn_case(dt)
            cfg = dataclasses.replace(get_arch("egnn").smoke_config, compute_dtype=jdt)
            params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pparams)
            batch = {{k: jnp.asarray(v.numpy()) for k, v in pbatch.items()}}
            with jax.set_mesh(mesh):
                (l, m), g = jax.jit(jax.value_and_grad(egnn.make_sharded_loss(cfg, mesh),
                                                       has_aux=True))(params, batch)
            out[dt + "/loss"] = np.asarray(l)
            out[dt + "/acc"] = np.asarray(m["acc"])
            for i, x in enumerate(jax.tree.leaves(g)):
                out[f"{{dt}}/grad/{{i}}"] = np.asarray(x, np.float32)
    else:
        from jax.experimental.shard_map import shard_map
        for (pname, axes), (shape, names) in T.COMPRESS.items():
            mesh = jax.make_mesh(shape, names, devices=devs)
            cases = [T.compress_case(p) for p in range(4)]
            g = {{k: jnp.stack([c[0][k] for c in cases]) for k in cases[0][0]}}
            e = {{k: jnp.stack([c[1][k] for c in cases]) for k in cases[0][1]}}

            def body(g, e, axes=axes):
                mean, err = compression.psum_compressed(
                    jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e), axes)
                return jax.tree.map(lambda x: x[None], (mean, err))

            spec = P(names)
            f = shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
                          check_rep=False)
            with mesh:
                mean, err = f(g, e)
            tag = pname + "/" + ",".join(axes)
            for i, x in enumerate(jax.tree.leaves(mean)):
                out[f"compress/{{tag}}/mean/{{i}}"] = np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(err)):
                out[f"compress/{{tag}}/err/{{i}}"] = np.asarray(x)
        # ZeRO-1's adamw_update: moments constrained to zero1_sharding's layout
        # (with_sharding_constraint takes only Auto axes under jax 0.9)
        mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=devs)
        params, grads = T.zero1_case()
        cfg = optimizer.OptimizerConfig(**T.ZERO1_OPT)
        shard = {{k: optimizer.zero1_sharding(mesh, P(), v.shape) for k, v in params.items()}}
        p = jax.tree.map(jnp.asarray, params)
        state = optimizer.init_opt_state(cfg, p)
        step = jax.jit(lambda g, p, s: optimizer.adamw_update(cfg, g, p, s, shard))
        for i, g in enumerate(grads):
            p, state, m = step(jax.tree.map(jnp.asarray, g), p, state)
            out[f"adam/norm/{{i}}"] = np.asarray(m["grad_norm"])
        for k in ("m", "v"):
            for i, x in enumerate(jax.tree.leaves(state[k])):
                out[f"adam/{{k}}/{{i}}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"adam/params/{{i}}"] = np.asarray(x)
    np.savez({path!r}, **out)
""")
REF_JOBS = ("egnn_4x1", "egnn_2x2x1", "compress_adam")


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's jobs, one subprocess each, all started with the
    module's first test; ``arrays(job)`` loads a job's ``.npz``."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {job: subprocess.Popen(
        [sys.executable, "-c", REF_CODE.format(tests=os.path.join(ROOT, "tests"), job=job,
                                               path=str(tmp / f"{job}.npz"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for job in REF_JOBS}
    box = {}

    def arrays(job):
        if job not in box:
            proc = procs[job]
            try:
                _, err = proc.communicate(timeout=TIMEOUT_S)
            finally:
                proc.kill()
            assert proc.returncode == 0, err[-3000:]
            box[job] = dict(np.load(tmp / f"{job}.npz"))
        return box[job]

    yield arrays
    for proc in procs.values():
        proc.kill()
        proc.wait()


def _ref_list(arrays, prefix):
    keys = sorted((k for k in arrays if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def _bitwise(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), (what, i)


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_collectives_and_gradients_equal_the_loop(ranks, name):
    """psum, pmax, the tiled all_gather and psum_scatter over every group
    (f32 and bf16) and their gradients, and replicated's summed gradient:
    each rank bitwise equal to the loop's position; psum's cotangent comes
    back unchanged (3 on every input: each group's sum is read once)."""
    outs = ranks(name)
    for dt, dtype in DTYPES.items():
        want = _collectives(_loop(name), name, dtype)
        for r, o in enumerate(outs):
            got = o["collectives"][dt]
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                wr = v if k == "replicated.grad" else [v[r]]
                if k.endswith("ps.grad"):  # each rank seeds its own replicated copy
                    wr = [np.full_like(v[r], 3)]
                _bitwise(got[k], wr, f"{name} {dt} rank {r} {k}")
        for k, v in want.items():
            if k.endswith("ps.grad"):  # the loop reads each group's sum once
                assert all((x == 3).all() for x in v), k


@pytest.mark.parametrize("name,axes", list(COMPRESS), ids=lambda x: ",".join(x)
                         if isinstance(x, tuple) else x)
def test_psum_compressed_equals_reference_bitwise(ranks, reference, name, axes):
    """The int8 mean and the local error buffer: every rank bitwise equal
    to the reference's device and to the loop's position; the mean within
    the reference test's 5 % of the exact mean of the corrected gradients."""
    outs = ranks(name)
    loop = _compress(_loop(name), axes)
    ref = reference("compress_adam")
    tag = f"compress/{name}/{','.join(axes)}"
    mean_ref, err_ref = _ref_list(ref, tag + "/mean"), _ref_list(ref, tag + "/err")
    cases = [compress_case(p) for p in range(4)]
    for r, o in enumerate(outs):
        mean, err = o["compress"][axes][0]
        _bitwise(mean, loop[r][0], f"{tag} rank {r} mean vs loop")
        _bitwise(err, loop[r][1], f"{tag} rank {r} err vs loop")
        _bitwise(mean, [m[r] for m in mean_ref], f"{tag} rank {r} mean vs reference")
        _bitwise(err, [e[r] for e in err_ref], f"{tag} rank {r} err vs reference")
        group = _loop(name).group(axes, r)
        for i, k in enumerate(sorted(cases[0][0])):
            # error feedback: the gradients corrected by the error buffers
            exact = np.mean([cases[q][0][k] + cases[q][1][k] for q in group], axis=0)
            rel = np.abs(mean[i] - exact).max() / (np.abs(exact).max() + 1e-9)
            assert rel < 0.05, (tag, r, k, rel)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_egnn_loss_equals_loop_and_reference(ranks, reference, name, dtype):
    """make_sharded_loss on 4 ranks: loss, accuracy and gradients bitwise
    the loop's; against the reference's shard_map loss, the loss within
    ``F32_LOSS_TOL`` (f32) or ``BF16_REL`` (bf16), gradients within
    ``GRAD_TOL`` (f32) or ``BF16_GRAD_REL`` in relative norm (bf16), the
    accuracy exactly."""
    outs = ranks(name)
    w_loss, w_acc, w_bytes, w_grads = _egnn(_loop(name), dtype)
    for r, o in enumerate(outs):
        loss, acc, raw, grads = o["egnn"][dtype]
        assert raw == w_bytes and acc == w_acc, (name, dtype, r)
        _bitwise(grads, w_grads, f"{name} {dtype} rank {r} grads")
    ref = reference(f"egnn_{name}")
    assert float(ref[f"{dtype}/acc"]) == w_acc
    ref_grads = _ref_list(ref, f"{dtype}/grad")
    assert len(ref_grads) == len(w_grads)
    if dtype == "f32":
        np.testing.assert_allclose(w_loss, ref[f"{dtype}/loss"], **F32_LOSS_TOL)
        for a, b in zip(w_grads, ref_grads):
            np.testing.assert_allclose(a, b, **GRAD_TOL)
    else:
        assert abs(w_loss - float(ref[f"{dtype}/loss"])) <= BF16_REL * abs(w_loss)
        for a, b in zip(w_grads, ref_grads):
            assert np.linalg.norm(a - b) <= BF16_GRAD_REL * np.linalg.norm(b)
    # the loop against the unsharded loss_fn, within the same tolerances
    cfg, params, batch = egnn_case(dtype)
    l1, _, _ = value_and_grad(lambda p, b: p_egnn.loss_fn(cfg, p, b), params, batch)
    tol = F32_LOSS_TOL if dtype == "f32" else dict(rtol=BF16_REL, atol=0)
    np.testing.assert_allclose(w_loss, float(l1), **tol)


@pytest.mark.parametrize("name", MESHES)
def test_zero1_update_equals_dense_and_reference(ranks, reference, name):
    """Two ZeRO-1 updates: params and grad norms bitwise the port's dense
    update on every rank, each rank's moment blocks bitwise the dense
    moments' blocks, the blocks' bytes 1/D of the split leaves'; the
    assembled moments and params within ADAM_TOL of the reference's
    ``adamw_update`` with ``zero1_sharding`` moment shardings."""
    outs = ranks(name)
    params, grads = zero1_case()
    cfg = p_opt.OptimizerConfig(**ZERO1_OPT)
    p, state = _t(params), p_opt.init_opt_state(cfg, _t(params))
    norms = []
    for g in grads:
        p, state, m = p_opt.adamw_update(cfg, _t(g), p, state)  # dense: no shardings
        norms.append(m["grad_norm"].numpy().tobytes())
    dense = {"params": _np(p), "m": _np(state["m"]), "v": _np(state["v"])}
    D = dict(zip(*MESHES[name][::-1]))["data"]
    sizes = {k: v.nbytes for k, v in params.items()}
    assert [b is None for b in outs[0]["zero1"]["blocks"]] == [True, False, False]  # s, u, w
    for r, o in enumerate(outs):
        z = o["zero1"]
        _bitwise(z["params"], dense["params"], f"{name} rank {r} params")
        assert z["norms"] == norms
        for k in ("m", "v"):
            want = [x if b is None else x[tuple(slice(None) if d != b[0]
                                                else slice(b[1], b[1] + b[2])
                                                for d in range(x.ndim))]
                    for x, b in zip(dense[k], z["blocks"])]
            _bitwise(z[k], want, f"{name} rank {r} {k} blocks")
        split = sizes["w"] + sizes["u"]
        assert z["moment_bytes"] == 2 * (split // D + sizes["s"])
    ref = reference("compress_adam")
    for k in ("params", "m", "v"):
        for a, b in zip(dense[k], _ref_list(ref, f"adam/{k}")):
            np.testing.assert_allclose(a, b, **ADAM_TOL)
    for a, i in zip(norms, range(2)):
        np.testing.assert_allclose(np.frombuffer(a, np.float32), ref[f"adam/norm/{i}"],
                                   **ADAM_TOL)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", DP_ARCHS + ("egnn-gnn_full",))
def test_data_parallel_step_equals_one_process(ranks, name, arch):
    """Two steps of the cell across 4 ranks (ZeRO-1 moments): params (by
    digest), loss and grad_norm bitwise equal on every rank and to the
    one-process ``microbatches=4`` step; each rank's moments 1/D of the
    dense ones' bytes (the batch axes' D, ZeRO-1 over data).  The
    ``gnn_full`` cell (the sharded loss on the rank's rows) against the
    sharded loss's loop with the dense update."""
    outs = ranks(name)
    if arch == "egnn-gnn_full":
        want, dense_bytes = _gnn_full(_loop(name))
        for r, o in enumerate(outs):
            assert o["gnn_full"][0] == want, (name, r)
        return
    cell = _dp_cell(arch)
    params, opt, batch = cell.args
    spec = get_arch(arch)
    cfg = spec.smoke_config
    loss = ((lambda p, b: p_tf.loss_fn(cfg, p, b)) if spec.family == "lm"
            else p_steps.recsys_loss(cfg))
    want, dense_bytes = _run_steps(make_train_step(loss, p_steps.TRAIN_OPT, microbatches=4),
                                   params, opt, batch)
    D = dict(zip(*MESHES[name][::-1]))["data"]
    for r, o in enumerate(outs):
        steps, moment_bytes = o["dp"][arch]
        assert steps == want, (name, arch, r)
        assert dense_bytes // D <= moment_bytes < dense_bytes // D * 1.01, (moment_bytes,
                                                                             dense_bytes)


def test_mismatched_world_size_and_guards_raise(ranks):
    """A (8, 1) mesh on 4 ranks, a collective given another position's
    entry count, a batch of rows that do not split over the batch shards,
    and psum_compressed without a mesh: each raises, on every rank."""
    for name in MESHES:
        for o in ranks(name):
            g = o["guards"]
            assert "the process group has 4 ranks" in g["world"]
            assert "takes 1 local entries, got 2" in g["entries"]
            assert "does not split over the 4 batch shards" in g["rows"]
            assert "use_sharding" in g["no_mesh"]
    with pytest.raises(ValueError, match="replicated sums over every axis"):
        col.replicated(_loop("2x2x1"), {"w": torch.ones(2)}, ("data",))
    with pytest.raises(ValueError, match="axes"):
        _loop("4x1").group(("pod",), 0)


def _cli_rank(rank, argv):
    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(argv)
    return buf.getvalue()


def _losses(text):
    return [m.group(1, 2) for m in re.finditer(r"^step +(\d+) +loss (\S+) ", text, re.M)]


def test_train_cli_on_two_ranks_equals_microbatches(tmp_path):
    """The train CLI as two gloo ranks (WORLD_SIZE 2): rank 0 alone logs
    and checkpoints; with an injected failure it restores and replays, and
    its loss lines equal the one-process ``--microbatches 2`` run's."""
    base = ["--device", "cpu", "--arch", "dcn-v2", "--steps", "6", "--batch-size", "8"]
    outs = run_ranks(_cli_rank, 2, args=(base + ["--ckpt-dir", str(tmp_path), "--ckpt-every",
                                                "2", "--simulate-failure", "3"],),
                     timeout_s=TIMEOUT_S)
    assert outs[1] == ""
    assert "[fault] restoring step 2" in outs[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(base + ["--microbatches", "2"])
    want = _losses(buf.getvalue())
    got = _losses(outs[0])
    assert len(want) == 6 and got == want[:3] + want[2:]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004", "step_00000006"]
