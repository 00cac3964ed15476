"""PyTorch port: LM training through autograd against the reference on
the CPU — ``loss_fn``'s value, metrics and gradients against
``jax.value_and_grad`` for the five LM SMOKE configs at f32 compute; the
three remat modes (bitwise equal values and gradients, and the saved
activations they keep); a few steps of ``make_train_step``; the
``lm_train`` cell; the train CLI's ``lm`` family and the ``train_lm``
example on the CPU, each with a fault replay; and the entry points'
CUDA default.  The reference's ``cfg.init(jax.random.key(0))`` weights
come across by ``params_from_numpy``, its batches as numpy.

Tolerances: ``GRAD_TOL``, the recsys training tests'
(``test_torch_train.py``), for losses, metrics, gradients and moments: XLA
and torch sum in other orders.  Parameters after train steps are held
within ``STEP_TOL``: rtol 1e-4, and an absolute 1 % of the most the steps
can move a parameter (about ``lr`` per AdamW step).  AdamW divides each
first moment by the root of the second, so where a gradient entry nearly
cancels, the absolute error that ``GRAD_TOL`` allows it becomes a relative
error of that entry's update: after 3 steps a few of the SMOKE LMs'
parameters differ by up to 1.1e-5 (3e-4 relative), which ``GRAD_TOL``'s
1e-6 would refuse although every gradient holds it."""
import collections
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.data.lm import LMDataConfig as RefLMDataConfig  # noqa: E402
from repro.data.lm import lm_batch as ref_lm_batch  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_arch  # noqa: E402
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.train import loop as p_loop  # noqa: E402
from repro_torch.train import optimizer as p_opt  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, unflatten  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

ARCHS = ["smollm-135m", "qwen1.5-0.5b", "qwen2.5-14b", "olmoe-1b-7b", "granite-moe-1b-a400m"]
CPU = "cpu"
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)  # the recsys tests' _train_one
STEP_TOL = dict(rtol=1e-4, atol=0.01 * 3 * OPT["lr"])  # 3 steps
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """(reference, port) SMOKE configs at f32 compute."""
    rc = dataclasses.replace(ref_get_arch(arch).smoke_config, compute_dtype=jnp.float32, **kw)
    pc = dataclasses.replace(get_arch(arch).smoke_config, compute_dtype=torch.float32, **kw)
    return rc, pc


_ARRAYS = {}


def _weights(arch, pc):
    """The reference's seed-0 weights (numpy, drawn once per arch) and a
    fresh port copy: the port's step writes its params in place."""
    if arch not in _ARRAYS:
        _ARRAYS[arch] = jax.tree.map(np.asarray, _cfgs(arch)[0].init(jax.random.key(0)))
    arrays = _ARRAYS[arch]
    return jax.tree.map(jnp.asarray, arrays), params_from_numpy(pc.param_defs(), arrays, CPU)


def _batch(vocab, step=0):
    """The reference's batch of ``step`` (numpy) and its torch copy."""
    b = {k: np.asarray(v) for k, v in
         ref_lm_batch(RefLMDataConfig(vocab=vocab, seq_len=S, global_batch=B), step).items()}
    return b, {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **tol)


def _close_trees(got, want, tol):
    g, w = flatten_with_paths(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == ["/".join(str(k) for k in p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        _close(a, b, tol, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_grads_equal_reference(arch):
    """Loss, metrics and every gradient leaf against ``jax.value_and_grad``
    (MoE: the aux loss's gradient through the router included)."""
    rc, pc = _cfgs(arch)
    rp, pp = _weights(arch, pc)
    b, tb = _batch(rc.vocab)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(rc, p, b),
                                              has_aux=True))(rp, b)
    loss, metrics, grads = p_loop.value_and_grad(lambda p, b: pt.loss_fn(pc, p, b), pp, tb)
    _close(loss, jl, GRAD_TOL, "loss")
    assert set(metrics) == set(jm) and not loss.requires_grad
    for k in jm:
        _close(metrics[k], jm[k], GRAD_TOL, k)
    _close_trees(grads, jg, GRAD_TOL)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    if rc.is_moe:
        assert float(metrics["aux"]) > 0 and float(grads["layers"]["moe"]["router"].abs().max()) > 0


class _CountOps(TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _remat_run(pc, pp, tb):
    """(bytes the outer graph keeps for the backward, each storage once;
    the aten ops the backward runs)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    live = [p.detach().requires_grad_(True) for p in leaves(pp)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = pt.loss_fn(pc, unflatten(pp, live), tb)
    counter = _CountOps()
    with counter:
        torch.autograd.grad(loss, live, allow_unused=True)
    params = {p.untyped_storage().data_ptr() for p in live}
    return sum(n for ptr, n in seen.items() if ptr not in params), counter.n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_agree_bitwise(arch):
    """``remat`` none, full and dots: bitwise equal loss, metrics and
    gradients.  "full" and "dots" keep each layer's input only in the
    outer graph and recompute the layer in the backward; "full" recomputes
    the products without batch dims (``mm``), "dots" keeps them and
    recomputes the batched ones (``bmm``) and the rest."""
    outs, saved, ops = {}, {}, {}
    b, tb = _batch(get_arch(arch).smoke_config.vocab, step=1)
    for remat in ("none", "full", "dots"):
        _, pc = _cfgs(arch, remat=remat)
        _, pp = _weights(arch, pc)
        outs[remat] = p_loop.value_and_grad(lambda p, b: pt.loss_fn(pc, p, b), pp, tb)
        saved[remat], ops[remat] = _remat_run(pc, pp, tb)
    for remat in ("full", "dots"):
        assert torch.equal(outs[remat][0], outs["none"][0])
        for k, v in outs["none"][1].items():
            assert torch.equal(outs[remat][1][k], v), k
        for (path, a), (_, g) in zip(flatten_with_paths(outs[remat][2]),
                                     flatten_with_paths(outs["none"][2])):
            assert torch.equal(a, g), (remat, path)
    assert saved["full"] == saved["dots"] < saved["none"], saved
    assert ops["full"]["mm"] > ops["dots"]["mm"] == ops["none"]["mm"], ops
    assert ops["full"]["bmm"] == ops["dots"]["bmm"] > ops["none"]["bmm"], ops


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_train_steps_equal_reference(arch):
    """3 steps of ``make_train_step`` from the same weights on the same
    batches: per-step loss, grad_norm and lr, then params and moments."""
    rc, pc = _cfgs(arch)
    rp, pp = _weights(arch, pc)
    jstep = j_loop.make_train_step(lambda p, b: rt.loss_fn(rc, p, b),
                                   j_opt.OptimizerConfig(**OPT))
    pstep = p_loop.make_train_step(lambda p, b: pt.loss_fn(pc, p, b),
                                   p_opt.OptimizerConfig(**OPT))
    js = j_opt.init_opt_state(j_opt.OptimizerConfig(**OPT), rp)
    ps = p_opt.init_opt_state(p_opt.OptimizerConfig(**OPT), pp)
    for s in range(3):
        b, tb = _batch(rc.vocab, step=s)
        rp, js, jm = jstep(rp, js, b)
        pp, ps, pm = pstep(pp, ps, tb)
        assert set(pm) == set(jm)
        for k in jm:
            _close(pm[k], jm[k], GRAD_TOL, k)
    assert int(ps["step"]) == int(js["step"]) == 3
    _close_trees((ps["m"], ps["v"]), (js["m"], js["v"]), GRAD_TOL)
    _close_trees(pp, rp, STEP_TOL)


def _small(arch, batch=2, seq=32):
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config, compute_dtype=torch.float32)
    return dataclasses.replace(spec, config=cfg, shapes=(
        ShapeSpec("train_4k", "lm_train", dict(seq_len=seq, global_batch=batch)),))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_lm_train_cell_equals_direct_call(arch):
    """The cell's args (params, a zero optimizer state, ``lm_batch`` of step
    0), donation and ``model_flops``; its step equals a direct
    ``make_train_step`` step on copies of the same state."""
    spec = _small(arch)
    cfg = spec.config
    cell = steps.build_cell(spec, spec.shape("train_4k"), device=CPU, seed=5)
    params, state, batch = cell.args
    assert cell.donate == (0, 1)
    rcfg = ref_get_arch(arch).smoke_config
    assert cell.model_flops == ref_steps._lm_flops(rcfg, 2 * 32, "train")
    want_b = lm_batch(LMDataConfig(cfg.vocab, 32, 2, 5), 0, device=CPU)
    assert all(torch.equal(batch[k], want_b[k]) for k in ("tokens", "labels"))
    assert int(state["step"]) == 0 and all(not t.any() for t in leaves((state["m"], state["v"])))
    want_p = cfg.init(5, CPU)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(want_p)))
    d_state = p_opt.init_opt_state(steps.TRAIN_OPT, want_p)
    direct = p_loop.make_train_step(lambda p, b: pt.loss_fn(cfg, p, b), steps.TRAIN_OPT)
    _, _, m_direct = direct(want_p, d_state, want_b)
    p2, s2, m = cell.fn(*cell.args)
    assert p2 is params and s2 is state and int(state["step"]) == 1
    for k, v in m_direct.items():
        assert torch.equal(m[k], v), k
    for a, b in zip(leaves((params, state)), leaves((want_p, d_state))):
        assert torch.equal(a, b)


_LOSS_LINE = re.compile(r"^step +(\d+) +loss (\S+) ")


def _losses(lines):
    return [_LOSS_LINE.match(x).groups() for x in lines if _LOSS_LINE.match(x)]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "smollm-135m"])
def test_train_cli_lm_family_replays_after_failure(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <lm>`` on the CPU, a
    checkpoint every 2 steps and a failure at step 5: its loss lines
    equal the run without the failure (step 4 twice)."""
    base = ["--device", CPU, "--arch", arch, "--steps", "8", "--batch-size", "2",
            "--seq-len", "32", "--ckpt-every", "2"]
    runs = {}
    for tag, extra in (("fault", ["--simulate-failure", "5"]), ("clean", [])):
        p_train.main(base + ["--ckpt-dir", str(tmp_path / tag)] + extra)
        runs[tag] = capsys.readouterr().out.splitlines()
    losses = {tag: _losses(out) for tag, out in runs.items()}
    assert [int(s) for s, _ in losses["clean"]] == list(range(8))
    assert [int(s) for s, _ in losses["fault"]] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert set(losses["fault"]) == set(losses["clean"])
    assert "[fault] RuntimeError('injected failure at step 5')" in runs["fault"]
    assert "[fault] restoring step 4" in runs["fault"]
    assert all(np.isfinite(float(v)) for _, v in losses["clean"])


def test_train_lm_example_on_cpu(capsys):
    """``repro_torch.examples.train_lm`` at 60 steps learns; with a failure
    at step 55 (after the step-50 checkpoint) it prints the same losses."""
    from repro_torch.examples import train_lm

    hist = train_lm.main(["--device", CPU, "--steps", "60", "--batch", "4", "--seq-len", "64"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "model: 1.05M params"
    assert re.fullmatch(r"loss \d+\.\d{3} -> \d+\.\d{3} \(OK: learning\)", out[-1])
    assert [s for s, _ in hist] == list(range(0, 60, 3))
    replay = train_lm.main(["--device", CPU, "--steps", "60", "--batch", "4", "--seq-len", "64",
                            "--simulate-failure", "55"])
    out2 = capsys.readouterr().out.splitlines()
    assert "[fault] restoring step 50" in out2
    assert dict(replay) == dict(hist) and out2[-1] == out[-1]


def test_lm_train_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.examples import train_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _small("granite-moe-1b-a400m")
    calls = [
        lambda: steps.build_cell(spec, spec.shape("train_4k")),
        lambda: p_train.main(["--arch", "granite-moe-1b-a400m", "--steps", "1"]),
        lambda: train_lm.main(["--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
