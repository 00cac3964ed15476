"""PyTorch port of recsys training against the JAX reference on the CPU:
the AdamW schedule, norm and update, each arch's loss and gradients, the
train step (with and without microbatches), int8 compression, checkpoints
written by one package and restored by the other, keep-K GC, the
fault-tolerant loop's bitwise replay, the watchdog and the elastic mesh
plan, ``InBatchSoftmaxNLL`` against its plain twin, the train cell, the
train CLI and the retrieval example.  Weights come from the reference's
``cfg.init`` and batches from its generators, carried across as numpy."""
import functools
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.data import recsys as j_data  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import recsys as j_rec  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro.train import fault as j_fault  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_arch  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.models import recsys as p_rec  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.train import checkpoint as p_ckpt  # noqa: E402
from repro_torch.train import compression as p_comp  # noqa: E402
from repro_torch.train import fault as p_fault  # noqa: E402
from repro_torch.train import loop as p_loop  # noqa: E402
from repro_torch.train import optimizer as p_opt  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, tree_map  # noqa: E402

ARCHS = ["two-tower-retrieval", "dcn-v2", "autoint", "bst"]
CPU = "cpu"
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # XLA and torch sum in other orders
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)  # XLA's CPU contracts multiply-adds
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)  # the reference's _train_one
ROWS = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.cache
def _smoke_np(name):
    """(reference cfg, port cfg, reference params as numpy)."""
    jc, pc = j_get_arch(name).smoke_config, get_arch(name).smoke_config
    return jc, pc, _np(jax.jit(jc.init)(jax.random.key(0)))


def _smoke(name):
    """Fresh (reference cfg, port cfg, reference params, port params): the
    port's step writes its params in place."""
    jc, pc, arrays = _smoke_np(name)
    return jc, pc, jax.tree.map(jnp.asarray, arrays), params_from_numpy(
        pc.param_defs(), arrays, CPU)


@functools.cache
def _ref_batch_fn(cfg, B):
    """The reference's batch generator for ``cfg`` at ``B`` rows, jitted
    over (seed, step): one compile per config."""
    name = type(cfg).__name__
    if name == "DCNv2Config":
        fn = lambda seed, step: j_data.ctr_batch(B, cfg.n_dense, cfg.vocab_sizes, seed, step)
    elif name == "AutoIntConfig":
        fn = lambda seed, step: j_data.ctr_batch(B, 0, cfg.vocab_sizes, seed, step)
    elif name == "BSTConfig":
        fn = lambda seed, step: j_data.bst_batch(B, cfg.n_items, cfg.seq_len,
                                                 cfg.n_other_fields, cfg.field_vocab, seed, step)
    else:
        fn = lambda seed, step: j_data.two_tower_batch(
            B, cfg.n_users, cfg.n_items, cfg.n_user_fields, cfg.n_item_fields,
            cfg.field_vocab, cfg.hist_len, seed, step)
    return jax.jit(fn)


def _ref_batch(cfg, B, seed=0, step=0):
    b = dict(_np(_ref_batch_fn(cfg, B)(seed, step)))
    if type(cfg).__name__ == "TwoTowerConfig":  # −1 padded histories, one empty
        hist = np.array(b["history"])
        hist[::3, :2] = -1
        hist[1] = -1
        b["history"] = hist
    return b


def _j_loss(name, jc):
    fn = {"two-tower-retrieval": j_rec.two_tower_loss, "dcn-v2": j_rec.dcn_v2_loss,
          "autoint": j_rec.autoint_loss, "bst": j_rec.bst_loss}[name]
    return functools.partial(fn, jc)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **tol)


def _close_trees(got, want, tol):
    g, w = flatten_with_paths(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == ["/".join(str(k) for k in p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        _close(a, b, tol, path)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    steps = np.arange(0, 48, dtype=np.int32)
    want = jax.jit(jax.vmap(lambda s: j_opt.lr_at(j_opt.OptimizerConfig(**cfg), s)))(steps)
    got = torch.stack([p_opt.lr_at(p_opt.OptimizerConfig(**cfg), torch.tensor(s))
                       for s in steps])
    assert got.dtype == torch.float32
    _close(got, want, ADAM_TOL)


def _opt_trees(seed):
    """Numpy grads, params and moments in a nested tree (dict keys out of
    order, so the sorted walk matters)."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {"z": rng.normal(0, scale, (7, 5)).astype(np.float32),
                "a": {"w": rng.normal(0, scale, (3, 4)).astype(np.float32),
                      "b": rng.normal(0, scale, (4,)).astype(np.float32)}}

    m = tree(0.1)
    v = jax.tree.map(np.abs, tree(0.01))
    return tree(1.0), tree(0.5), {"step": np.int32(4), "m": m, "v": v}


def test_global_norm_matches_reference():
    grads, _, _ = _opt_trees(0)
    _close(p_opt.global_norm(_t(grads)), j_opt.global_norm(jax.tree.map(jnp.asarray, grads)),
           ADAM_TOL)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])  # clipped, not clipped
def test_adamw_update_matches_reference(clip_norm):
    grads, params, state = _opt_trees(1)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip_norm)
    jp, js, jm = jax.jit(functools.partial(j_opt.adamw_update, j_opt.OptimizerConfig(**cfg)))(
        *(jax.tree.map(jnp.asarray, t) for t in (grads, params, state)))
    pp, ps = _t(params), _t(state)
    ps["step"] = torch.tensor(4, dtype=torch.int32)
    got_p, got_s, got_m = p_opt.adamw_update(p_opt.OptimizerConfig(**cfg), _t(grads), pp, ps)
    assert got_p is pp and got_s is ps  # in place, the same dicts
    assert got_s["step"].dtype == torch.int32 and int(got_s["step"]) == 5
    _close_trees(got_p, jp, ADAM_TOL)
    _close_trees({"m": got_s["m"], "v": got_s["v"]}, {"m": js["m"], "v": js["v"]}, ADAM_TOL)
    _close(got_m["grad_norm"], jm["grad_norm"], ADAM_TOL)
    _close(got_m["lr"], jm["lr"], ADAM_TOL)
    assert (float(jm["grad_norm"]) > clip_norm) == (clip_norm == 1.0)


# ---------------------------------------------------------------------------
# losses, gradients and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    jc, pc, jp, pp = _smoke(name)
    b = _ref_batch(jc, ROWS)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(_j_loss(name, jc), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, b))
    pl, paux, pg = p_loop.value_and_grad(p_steps.recsys_loss(pc), pp, _t(b))
    _close(pl, jl, GRAD_TOL)
    assert set(paux) == set(jaux) and not pl.requires_grad
    assert set(pg) == set(jg)
    _close_trees(pg, jg, GRAD_TOL)
    if name == "two-tower-retrieval":  # padding ids are clamped to row 0 and masked
        assert not (b["history"] == 0).any() and not (b["target"] == 0).any()
        assert (pg["item_id"][0] == 0).all()


@pytest.mark.parametrize("name,microbatches", [(a, 1) for a in ARCHS]
                         + [("two-tower-retrieval", 2), ("dcn-v2", 2)])
def test_train_steps_match_reference(name, microbatches):
    """3 steps of ``make_train_step`` from the same weights on the same
    batches: per-step loss, grad_norm and lr, then params and moments."""
    jc, pc, jp, pp = _smoke(name)
    jstep = j_loop.make_train_step(_j_loss(name, jc), j_opt.OptimizerConfig(**OPT),
                                   microbatches=microbatches)
    pstep = p_loop.make_train_step(p_steps.recsys_loss(pc), p_opt.OptimizerConfig(**OPT),
                                   microbatches=microbatches)
    js = j_opt.init_opt_state(j_opt.OptimizerConfig(**OPT), jp)
    ps = p_opt.init_opt_state(p_opt.OptimizerConfig(**OPT), pp)
    for s in range(3):
        b = _ref_batch(jc, ROWS, step=s)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        pp, ps, pm = pstep(pp, ps, _t(b))
        assert set(pm) == set(jm)
        for k in jm:
            _close(pm[k], jm[k], GRAD_TOL, k)
    assert int(ps["step"]) == int(js["step"]) == 3
    _close_trees((pp, ps["m"], ps["v"]), (jp, js["m"], js["v"]), GRAD_TOL)


@pytest.mark.parametrize("block_elements", [1 << 28, 1000])  # one block, 4 rows per block
def test_in_batch_softmax_nll_equals_plain_autograd(block_elements, monkeypatch):
    """Value and gradients as the op-for-op version's autograd computes
    them, bitwise on the CPU (within rtol 1e-6 is the contract)."""
    monkeypatch.setattr(p_rec.InBatchSoftmaxNLL, "BLOCK_ELEMENTS", block_elements)
    rng = np.random.default_rng(2)
    B, E = 250, 16
    u, v = (rng.normal(size=(B, E)).astype(np.float32) for _ in range(2))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    logq = np.log(rng.uniform(1e-6, 1e-3, B)).astype(np.float32)
    outs = []
    for fn in (p_rec.in_batch_softmax_nll_plain, p_rec.InBatchSoftmaxNLL.apply):
        x = [torch.from_numpy(a.copy()).requires_grad_() for a in (u, v, logq)]
        loss = fn(*x, 0.05)
        outs.append([loss.detach(), *torch.autograd.grad(loss * 1.5, x)])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_int8_bitwise():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (33, 17)).astype(np.float32)
    x[0, :4] = [127.0, -127.0, 63.5, -0.5]  # halves: round to even
    for a in (x, np.zeros((5,), np.float32)):
        q, s = p_comp.quantize_int8(torch.from_numpy(a))
        jq, js = j_comp.quantize_int8(jnp.asarray(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(p_comp.dequantize_int8(q, s).numpy(),
                                      np.asarray(j_comp.dequantize_int8(jq, js)))


def test_compress_tree_bitwise():
    grads, err, _ = _opt_trees(4)
    err = jax.tree.map(lambda e: e * np.float32(0.01), err)
    q, s, e = p_comp.compress_tree(_t(grads), _t(err))
    jq, js, je = j_comp.compress_tree(*(jax.tree.map(jnp.asarray, t) for t in (grads, err)))
    for got, want in ((q, jq), (s, js), (e, je),
                      (p_comp.decompress_tree(q, s), j_comp.decompress_tree(jq, js))):
        g, w = leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    # psum_compressed over a one-device mesh: the reference's under
    # shard_map bit for bit (mean and error buffer); without a mesh it raises
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro_torch.core import make_mesh
    from repro_torch.sharding.specs import use_sharding

    with use_sharding(make_mesh((1,), ("data",), device="cpu")):
        (mean,), (new_err,) = p_comp.psum_compressed([_t(grads)], [_t(err)], ("data",))
    jmesh = jax.make_mesh((1,), ("data",))
    with jmesh:
        jmean, jerr = shard_map(lambda g, e: j_comp.psum_compressed(g, e, ("data",)),
                                mesh=jmesh, in_specs=(P(), P()), out_specs=P(),
                                check_rep=False)(*(jax.tree.map(jnp.asarray, t)
                                                   for t in (grads, err)))
    for got, want in ((mean, jmean), (new_err, jerr), (new_err, je)):
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    with pytest.raises(RuntimeError, match="use_sharding"):
        p_comp.psum_compressed(_t(grads), _t(err), ("data",))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_flatten_paths_match_jax():
    tree = ({"b": np.zeros(2), "a": np.ones(3)},
            {"step": np.int32(1), "m": {"b": np.zeros(2), "a": np.ones(3)}, "v": [np.ones(1)]})
    got = flatten_with_paths(tree)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in got] == ["/".join(str(k) for k in p) for p, _ in want]
    assert [p for p, _ in got][:3] == ["[0]/['a']", "[0]/['b']", "[1]/['m']/['a']"]
    assert got[-2][0] == "[1]/['step']"


@functools.cache
def _ref_state_np(name):
    """The reference's (params, state) after one step, so the moments are
    not zero, as numpy."""
    jc, _, jp, _ = _smoke(name)
    opt = j_opt.OptimizerConfig(**OPT)
    step = j_loop.make_train_step(_j_loss(name, jc), opt, donate=False)
    jp, js, _ = step(jp, j_opt.init_opt_state(opt, jp),
                     jax.tree.map(jnp.asarray, _ref_batch(jc, ROWS)))
    return _np((jp, js))


def _ref_state(name):
    """(reference (params, state), port (params, state)), equal."""
    arrays = _ref_state_np(name)
    pc = get_arch(name).smoke_config
    return jax.tree.map(jnp.asarray, arrays), (
        params_from_numpy(pc.param_defs(), arrays[0], CPU), _t(arrays[1]))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(writer, tmp_path):
    j_state, p_state = _ref_state("dcn-v2")
    want = _np(j_state)
    if writer == "reference":
        j_ckpt.save_checkpoint(str(tmp_path), 3, j_state)
        got = p_ckpt.restore_checkpoint(str(tmp_path), 3, tree_map(torch.zeros_like, p_state))
        assert int(got[1]["step"]) == 1 and got[1]["step"].dtype == torch.int32
        got = _np(tree_map(lambda t: t.numpy(), got))
    else:
        p_ckpt.save_checkpoint(str(tmp_path), 3, p_state)
        got = _np(j_ckpt.restore_checkpoint(str(tmp_path), 3, jax.tree.map(jnp.zeros_like,
                                                                           j_state)))
    g, w = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    paths = [leaf["path"] for leaf in manifest["leaves"]]
    assert paths[0] == "[0]/['cross_b0']" and "[1]/['step']" in paths


def test_checkpoint_keep_k_verify_and_shape_check(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    threads = [p_ckpt.save_checkpoint(d, s, state, async_=True, keep=2) for s in (1, 2)]
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for s in (3, 4, 5):
        p_ckpt.save_checkpoint(d, s, state, keep=2)
    assert p_ckpt.list_checkpoints(d) == [4, 5] and p_ckpt.latest_checkpoint(d) == 5
    assert p_ckpt.list_checkpoints(d) == j_ckpt.list_checkpoints(d)
    assert p_ckpt.verify_checkpoint(d, 5)
    os.remove(os.path.join(d, "step_00000005", "arr_0.npy"))
    assert not p_ckpt.verify_checkpoint(d, 5) and not j_ckpt.verify_checkpoint(d, 5)
    assert not p_ckpt.verify_checkpoint(d, 9)
    assert p_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    # the save copied the tensor: a later in-place write does not reach it
    state["w"].add_(100.0)
    got = p_ckpt.restore_checkpoint(d, 4, state)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32).reshape(2, 3))
    with pytest.raises(ValueError, match="\\['w'\\]: checkpoint shape"):
        p_ckpt.restore_checkpoint(d, 4, {"w": torch.zeros(3, 2)})


# ---------------------------------------------------------------------------
# the loop, fault tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ckpt_async", [True, False])
def test_run_with_failure_replays_bitwise(ckpt_async, tmp_path):
    """An injected failure at step 5 restores step 4 and replays; the end
    state equals an uninterrupted run's bitwise."""
    spec = get_arch("dcn-v2")
    cfg = spec.smoke_config
    opt = p_opt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    step = p_loop.make_train_step(p_steps.recsys_loss(cfg), opt)

    def init_state():
        params = cfg.init(0, CPU)
        return params, p_opt.init_opt_state(opt, params)

    def batch_fn(s):
        return p_steps.recsys_batch(cfg, 32, CPU, 0, s)

    logs = []
    faulty = p_loop.run(p_loop.LoopConfig(total_steps=8, ckpt_every=2, ckpt_dir=str(tmp_path),
                                          ckpt_async=ckpt_async, log_every=1,
                                          simulate_failure_at=5),
                        step, init_state, batch_fn, log=logs.append)
    clean = p_loop.run(p_loop.LoopConfig(total_steps=8, log_every=1), step, init_state,
                       batch_fn, log=lambda s: None)
    assert "[fault] RuntimeError('injected failure at step 5')" in logs
    assert "[fault] restoring step 4" in logs
    assert [s for s, _ in faulty[2]] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert dict(faulty[2]) == dict(clean[2])
    for a, b in zip(leaves(faulty[:2]), leaves(clean[:2])):
        assert torch.equal(a, b)
    assert int(faulty[1]["step"]) == 8
    # a restart resumes from the last checkpoint
    logs.clear()
    resumed = p_loop.run(p_loop.LoopConfig(total_steps=8, ckpt_dir=str(tmp_path)), step,
                         init_state, batch_fn, log=logs.append)
    assert logs == ["[restore] resuming from step 8"] and resumed[2] == []
    for a, b in zip(leaves(resumed[:2]), leaves(clean[:2])):
        assert torch.equal(a, b)


def test_run_without_checkpoints_reraises():
    def step(p, s, b):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        p_loop.run(p_loop.LoopConfig(total_steps=2), step, lambda: ({}, {}), lambda s: None,
                   log=lambda s: None)


def test_watchdog_and_heartbeat_match_reference(tmp_path):
    dirs = {}
    for pkg, fault in (("ref", j_fault), ("port", p_fault)):
        d = tmp_path / pkg
        fault.Heartbeat(str(d), 7).beat(3, 0.5)
        beat = json.loads((d / "host_7.json").read_text())
        assert set(beat) == {"host", "step", "t", "step_time_s"} and beat["step"] == 3
        for host, t, st in ((0, 1000.0, 1.0), (1, 1000.0, 1.1), (2, 1000.0, 5.0),
                            (3, 500.0, 1.0), (4, 1000.0, 0.9)):
            (d / f"host_{host}.json").write_text(json.dumps(
                {"host": host, "step": 10, "t": t, "step_time_s": st}))
        (d / "host_9.json").write_text("{not json")
        (d / "other.txt").write_text("x")
        dirs[pkg] = str(d)
    cfg = dict(timeout_s=300.0, straggler_factor=3.0, straggler_patience=2)
    ref = j_fault.Watchdog(dirs["ref"], j_fault.WatchdogConfig(**cfg))
    port = p_fault.Watchdog(dirs["port"], p_fault.WatchdogConfig(**cfg))
    for now in (1001.0, 1002.0, 1003.0):
        got, want = port.scan(now), ref.scan(now)
        assert got == want
        assert port.strikes == ref.strikes
    assert 3 in want["dead"] and 2 in want["dead"]  # stale, then an evicted straggler


@pytest.mark.parametrize("hosts,chips,model,pods", [
    (4, 4, 2, 1), (3, 8, 4, 1), (1, 4, 8, 1), (8, 4, 4, 2), (5, 16, 8, 2)])
def test_plan_elastic_mesh_matches_reference(hosts, chips, model, pods):
    assert p_fault.plan_elastic_mesh(hosts, chips, model, pods) == \
        j_fault.plan_elastic_mesh(hosts, chips, model, pods)


# ---------------------------------------------------------------------------
# the train cell, the CLI, the example, devices
# ---------------------------------------------------------------------------

def _small(name):
    from dataclasses import replace

    spec = get_arch(name)
    return replace(spec, config=spec.smoke_config,
                   shapes=(ShapeSpec("train_batch", "recsys_train", dict(batch=8)),))


@pytest.mark.parametrize("name", ARCHS)
def test_train_cell_args_and_step(name):
    spec = _small(name)
    cfg = spec.config
    cell = p_steps.build_recsys_cell(spec, spec.shape("train_batch"), device=CPU, seed=1)
    params, state, batch = cell.args
    assert cell.donate == (0, 1)
    assert cell.model_flops == j_steps._recsys_flops(j_get_arch(name).smoke_config, 8, True)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: d.shape for k, d in cfg.param_defs().items()}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for k in ("m", "v"):
        assert {n: tuple(v.shape) for n, v in state[k].items()} == \
            {n: tuple(v.shape) for n, v in params.items()}
        assert all((v == 0).all() for v in state[k].values())
    want = _ref_batch(j_get_arch(name).smoke_config, 8)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in batch.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    before = {k: v.clone() for k, v in params.items()}
    p2, s2, m = cell.fn(*cell.args)
    assert p2 is params and s2 is state and int(state["step"]) == 1
    assert all(torch.isfinite(m[k]) for k in ("loss", "grad_norm", "lr"))
    assert all(not torch.equal(before[k], params[k]) for k in params)


_LOSS_LINE = re.compile(r"^step +(\d+) +loss (\S+) ")


def test_train_cli_on_cpu_replays_after_failure(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` with a checkpoint every 2
    steps and a failure at step 5: its loss lines equal those of the same
    command without the failure (step 4 twice: run, then replayed); a
    rerun in the same directory resumes from the last checkpoint."""
    base = ["--device", "cpu", "--arch", "dcn-v2", "--steps", "8", "--batch-size", "64",
            "--ckpt-every", "2"]
    runs = {}
    for tag, extra in (("fault", ["--simulate-failure", "5"]), ("clean", [])):
        p_train.main(base + ["--ckpt-dir", str(tmp_path / tag)] + extra)
        runs[tag] = capsys.readouterr().out.splitlines()
    losses = {tag: [_LOSS_LINE.match(x).groups() for x in out if _LOSS_LINE.match(x)]
              for tag, out in runs.items()}
    assert [int(s) for s, _ in losses["clean"]] == list(range(8))
    assert [int(s) for s, _ in losses["fault"]] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert set(losses["fault"]) == set(losses["clean"])
    assert "[fault] RuntimeError('injected failure at step 5')" in runs["fault"]
    assert "[fault] restoring step 4" in runs["fault"]
    p_train.main(base + ["--ckpt-dir", str(tmp_path / "fault"), "--steps", "10"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[restore] resuming from step 8"
    assert [int(_LOSS_LINE.match(x).group(1)) for x in out[1:]] == [8, 9]
    p_train.main(base + ["--microbatches", "2", "--steps", "2"])
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_train_cli_families(monkeypatch):
    """The gnn family gives the EGNN loss and one 512-node power-law graph
    on the device, every step (its runs: ``test_torch_egnn.py``); the lm
    family the LM loss and ``lm_batch`` (``test_torch_lm_train.py``);
    geoweb is a serving system."""
    spec = get_arch("dcn-v2")
    gnn = get_arch("egnn")
    loss, batch_fn = p_train.loss_and_batch_fns(gnn, gnn.smoke_config, 8, 16, 0, CPU)
    b = batch_fn(0)
    assert b["feats"].shape == (512, gnn.smoke_config.d_feat) and b["feats"].device.type == CPU
    assert b["senders"].shape == (2048,) and b["edge_mask"].all() and batch_fn(5) is b
    total, metrics = loss(gnn.smoke_config.init(0, CPU), b)
    assert bool(torch.isfinite(total)) and 0 <= float(metrics["acc"]) <= 1
    lm = get_arch("granite-moe-1b-a400m")
    loss, batch_fn = p_train.loss_and_batch_fns(lm, lm.smoke_config, 2, 16, 0, CPU)
    b = batch_fn(3)
    assert b["tokens"].shape == (2, 16) and b["tokens"].device.type == CPU
    total, metrics = loss(lm.smoke_config.init(0, CPU), b)
    assert bool(torch.isfinite(total)) and float(metrics["aux"]) > 0
    geoweb = type(spec)("geoweb", "geoweb", None, None, ())
    monkeypatch.setattr(p_train, "get_arch", lambda name: geoweb)
    with pytest.raises(SystemExit, match="geoweb is a serving system"):
        p_train.main(["--device", "cpu", "--arch", "geoweb"])


def test_retrieval_example_on_cpu(capsys):
    from repro_torch.examples import recsys_retrieval

    out = recsys_retrieval.main(device=CPU)
    assert len(out["losses"]) == 100 and np.isfinite(out["losses"]).all()
    assert len(set(out["plain"])) == len(set(out["geo"])) == 10
    x0, y0, x1, y1 = recsys_retrieval.Q_RECT
    r = out["cand_rects"][out["geo"], 0]
    assert ((r[:, 0] < x1) & (r[:, 2] > x0) & (r[:, 1] < y1) & (r[:, 3] > y0)).all()
    assert out["inside"] == 10
    assert "geo-constrained results overlapping query area: 10/10" in capsys.readouterr().out


def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from repro_torch.examples import recsys_retrieval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_arch("dcn-v2")
    calls = [
        lambda: p_train.main(["--arch", "dcn-v2", "--steps", "1"]),
        lambda: recsys_retrieval.main(),
        lambda: p_steps.build_recsys_cell(spec, spec.shape("train_batch")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
