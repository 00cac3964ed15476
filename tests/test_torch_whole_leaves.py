"""PyTorch port: LM leaves that ``model`` does not divide kept whole, as the
reference's shape-aware ``logical_spec`` keeps them
(``repro/sharding/specs.py``), and data-split MoE and two-tower train steps
with ``microbatches`` > 1 in the reference's order (``repro/train/loop.py``:
the global batch cut into microbatches, each spread over the devices).
``gloo`` ranks on the CPU (``repro_torch.launch.ranks.run_ranks``, torch on
one thread per rank; worlds of 3, 4 and 2 ranks), f32 compute, the port's
seed-0 weights carried to the reference as numpy.

The whole-leaf cases, each a train step's loss and gradients and, where a
serve batch is given, a prefill of ``PROMPT`` tokens into ``MAX_LEN``
positions and ``STEPS`` decode steps:

* SmolLM-135M SMOKE on (1, 3): ``wq``/``wo`` split, ``wk``/``wv`` whole
  (a kv width of 16 on 3: they enter the sequence-parallel region whole),
  the MLP split, the vocab whole;
* Qwen2.5-14B SMOKE on (1, 3): the attention and the vocab whole, the MLP
  split;
* Qwen1.5-0.5B SMOKE with 3 heads, kv 1 and d 48 on (1, 3): q split, the
  kv projections and their biases whole, the MLP (d_ff 128) and the vocab
  whole; its serving cell from ``build_lm_cell`` too;
* OLMoE SMOKE with 6 experts on (1, 4): the experts and router whole, the
  attention head-parallel, the vocab split;
* ``tests/test_torch_tensor_parallel.py``'s config with 3 experts on
  (1, 2) (train only);
* SmolLM-135M SMOKE on the ``(pod, data, model)`` = (2, 1, 2) process mesh:
  the batch over pod × data, and a batch-1 decode whose cache has
  ``kv_seq`` over pod (the batch of 1 takes data, of size 1) and
  ``head_dim`` over ``model``.

Each is held to one process of the port (loss within ``LOSS_TOL``, the
gradients gathered from the ranks' blocks within ``GRAD_TOL``, every
whole leaf's gradient bitwise equal on every rank, logits within
``LOGIT_TOL``), to the reference on an ``AxisType.Auto`` mesh of the same
shape (its ``param_specs`` splitting exactly the leaves
``split_over_model`` names, its ``value_and_grad``, jitted ``prefill`` and
``decode_step``; fake XLA devices, two subprocesses), and to the dry-run
(each rank's parameter bytes the per-device count).

The ``microbatches`` = 2 cases, OLMoE SMOKE and two-tower SMOKE on (2, 1)
and (2, 2): the ranks' loss and gradients against one process's
``microbatches=2`` step and against the reference's own
``make_train_step(..., microbatches=2)`` on its Auto mesh (its gradients
read back from the first AdamW moments).

Besides: ``roofline.lm_activation_bytes`` and the dry-run's parameter
bytes a device for whole-leaf layouts by hand, and the train CLI with
``--model-parallel 3`` on three ranks.  Every launch is bounded by a
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
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    param_shapes,
    param_shardings,
    split_over_model,
)
from repro_torch.sharding.specs import local_block, named_sharding, use_sharding  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
SEED = 0
B, SEQ = 8, 48  # an LM train batch
TT_B = 16  # a two-tower train batch
MAX_LEN, PROMPT, STEPS = 64, 24, 10  # positions 24-33 cross kv_seq's block at 32
CHUNK = 8
OPT = OptimizerConfig(lr=1e-3, warmup_steps=2, zero1=True)
# tests/test_torch_tensor_parallel.py's, test_torch_kv_parallel.py's and
# test_torch_recsys_parallel.py's tolerances
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
REF_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CLI_RTOL = 1e-3


def _lm(arch: str, **fields):
    return dataclasses.replace(get_arch(arch).smoke_config, compute_dtype=torch.float32,
                               attn_chunk=CHUNK, **fields)


# key: (arch, config overrides)
LM_CFGS = {
    "smollm": ("smollm-135m", {}),
    "qwen25": ("qwen2.5-14b", {}),
    "qwen15_kv1": ("qwen1.5-0.5b", {"n_heads": 3, "n_kv_heads": 1, "d_model": 48}),
    "olmoe": ("olmoe-1b-7b", {}),
    "olmoe_e6": ("olmoe-1b-7b", {"n_experts": 6}),
}
CFGS = {k: _lm(a, **o) for k, (a, o) in LM_CFGS.items()}
CFGS["tp_e3"] = pt.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                     vocab=256, attn_chunk=CHUNK, compute_dtype=torch.float32,
                                     n_experts=3, top_k=2)
CFGS["two_tower"] = get_arch("two-tower-retrieval").smoke_config
# the whole-leaf cases: name: (config, mesh shape, axes, serve batch or None)
LM = {
    "smollm_1x3": ("smollm", (1, 3), AXES, 2),
    "qwen25_1x3": ("qwen25", (1, 3), AXES, 2),
    "qwen15_kv1_1x3": ("qwen15_kv1", (1, 3), AXES, 2),
    "olmoe_e6_1x4": ("olmoe_e6", (1, 4), AXES, 2),
    "tp_e3_1x2": ("tp_e3", (1, 2), AXES, None),
    "smollm_pod": ("smollm", (2, 1, 2), POD_AXES, 1),
}
SERVED = [k for k, c in LM.items() if c[3]]
# microbatches = 2 on data-split meshes: name: (config, mesh shape)
MB = {
    "olmoe_mb2_2x1": ("olmoe", (2, 1)),
    "olmoe_mb2_2x2": ("olmoe", (2, 2)),
    "two_tower_mb2_2x1": ("two_tower", (2, 1)),
    "two_tower_mb2_2x2": ("two_tower", (2, 2)),
}
# what each whole-leaf case splits over model (the reference's specs agree:
# test_leaves_split_as_the_reference_specs)
SPLIT = {
    "smollm_1x3": {"wq", "wo", "wi_gate", "wi_up", "mlp/wo"},
    "qwen25_1x3": {"wi_gate", "wi_up", "mlp/wo"},
    "qwen15_kv1_1x3": {"wq", "bq", "wo"},
    "olmoe_e6_1x4": {"wq", "wk", "wv", "wo", "embed", "unembed"},
    "tp_e3_1x2": {"wq", "wk", "wv", "wo", "embed", "unembed"},
    "smollm_pod": {"wq", "wk", "wv", "wo", "wi_gate", "wi_up", "mlp/wo", "embed", "unembed"},
}
CLI_ARGS = ["--device", "cpu", "--arch", "smollm-135m", "--steps", "4", "--batch-size", "4",
            "--seq-len", "48"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the pieces each rank runs -----------------------------------------------

def _np(tree) -> list:
    return [x.detach().numpy().copy() for x in leaves(tree)]


def _batch(key: str) -> dict:
    cfg = CFGS[key]
    if key == "two_tower":
        return p_steps.recsys_batch(cfg, TT_B, "cpu", SEED)
    return lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=B, seed=SEED), 0,
                    "cpu")


def _loss(key: str):
    cfg = CFGS[key]
    if key == "two_tower":
        return p_steps.recsys_loss(cfg)
    return lambda p, b: pt.loss_fn(cfg, p, b)


def _grads(key: str, mesh, microbatches: int) -> dict:
    """The step's loss and gradients (the rank's blocks on ``mesh``, a
    process mesh; one process's with ``mesh`` None and ``microbatches``
    there), and the bytes of the parameters held."""
    cfg = CFGS[key]
    if mesh is None:
        params = cfg.init(SEED, "cpu")
        step = make_train_step(_loss(key), OPT, microbatches)
    else:
        params = cfg.init(SEED, "cpu", mesh)
        with use_sharding(mesh):
            step = make_train_step(_loss(key), OPT, microbatches,
                                   p_steps.moment_shardings(cfg.param_defs(), mesh))
    loss, _, grads = step.value_and_grad(params, _batch(key))
    return {"loss": float(loss), "grads": _np(grads),
            "param_bytes": sum(x.nbytes for x in leaves(params))}


def _tokens(name: str) -> np.ndarray:
    cfg = CFGS[LM[name][0]]
    rng = np.random.default_rng(SEED)
    return rng.integers(0, cfg.vocab, size=(LM[name][3], PROMPT + STEPS)).astype(np.int32)


def _serve(name: str, mesh) -> dict:
    """The prefill and every decode step of the case's tokens on ``mesh``
    (the rank's rows, parameter and cache blocks; None: one process): the
    logits of each step, the cache's spec."""
    cfg = CFGS[LM[name][0]]
    toks = torch.from_numpy(_tokens(name))
    if mesh is None:
        params = cfg.init(SEED, "cpu")
    else:
        params = cfg.init(SEED, "cpu", mesh)
        sh = named_sharding(mesh, ("batch", None), shape=tuple(toks.shape))
        toks = local_block(toks, sh).clone()
    cache = pt.make_cache(cfg, LM[name][3], MAX_LEN, "cpu", mesh)
    logits = []
    with torch.no_grad(), use_sharding(mesh):
        lg, cache = pt.prefill(cfg, params, toks[:, :PROMPT], cache)
        logits.append(lg.numpy().copy())
        for i in range(STEPS):
            lg, cache = pt.decode_step(cfg, params, cache, toks[:, PROMPT + i], PROMPT + i)
            logits.append(lg.numpy().copy())
    out = {"logits": np.stack(logits)}
    if mesh is not None:
        out["spec"] = tuple(cache["k"].sharding.spec)
    return out


def _cell(mesh) -> np.ndarray:
    """The Qwen1.5 kv-1 variant's prefill cell (2 x 32) built by
    ``build_lm_cell`` on ``mesh`` (or one process): its logits."""
    spec = dataclasses.replace(get_arch("qwen1.5-0.5b"), config=CFGS["qwen15_kv1"])
    shape = spec.shape("prefill_32k")
    shape = dataclasses.replace(shape, params={**shape.params, "global_batch": 2,
                                               "seq_len": 32})
    cell = p_steps.build_lm_cell(spec, shape, device="cpu", seed=SEED, mesh=mesh)
    with torch.no_grad():
        return cell.fn(*cell.args)[0].numpy()


def _cases(names, mbs, rank: int) -> dict:
    torch.set_num_threads(1)
    out = {}
    for name in names:
        key, shape, axes, serve_b = LM[name]
        mesh = make_process_mesh(shape, axes, device="cpu")
        out[name] = _grads(key, mesh, 1)
        out[name]["split"] = [bool(x) for x in leaves(split_over_model(CFGS[key].param_defs(),
                                                                       mesh))]
        if serve_b:
            out[name].update(_serve(name, mesh))
    for name in mbs:
        key, shape = MB[name]
        out[name] = _grads(key, make_process_mesh(shape, AXES, device="cpu"), 2)
    return out


def _group(n: int) -> tuple[list, list]:
    return ([k for k, c in LM.items() if np.prod(c[1]) == n],
            [k for k, c in MB.items() if np.prod(c[1]) == n])


def _rank3(rank: int) -> dict:
    out = _cases(*_group(3), rank)
    out["cell"] = _cell(make_process_mesh((1, 3), AXES, device="cpu"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(CLI_ARGS + ["--model-parallel", "3"])
    out["cli"] = buf.getvalue()
    return out


def _rank4(rank: int) -> dict:
    return _cases(*_group(4), rank)


def _rank2(rank: int) -> dict:
    return _cases(*_group(2), rank)


# -- the reference, in a subprocess on fake XLA devices ----------------------

REF = textwrap.dedent("""
    import dataclasses, json, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.configs import get_arch
    from repro.launch.steps import _recsys_fns
    from repro.models import transformer as rt
    from repro.models.params import param_specs
    from repro.sharding.specs import logical_spec, use_sharding
    from repro.train.loop import make_train_step
    from repro.train.optimizer import OptimizerConfig, init_opt_state

    cases = json.loads({cases!r})
    out = {{}}

    def tree(inputs, prefix):
        params = {{}}
        for k in inputs.files:
            if k.startswith(prefix):
                *parents, leaf = k[len(prefix):].split("/")
                node = params
                for p in parents:
                    node = node.setdefault(p, {{}})
                node[leaf] = jnp.asarray(inputs[k])
        return params

    def flat(prefix, t):
        for path, g in jax.tree_util.tree_flatten_with_path(t)[0]:
            out[prefix + "/".join(str(k.key) for k in path)] = np.asarray(g)

    for name, case in cases.items():
        inputs = np.load(case["inputs"])
        params, batch = tree(inputs, "params/"), tree(inputs, "batch/")
        if case["arch"] == "two-tower-retrieval":
            cfg = get_arch(case["arch"]).smoke_config
            loss = lambda p, b: _recsys_fns(cfg)[0](p, b)
        else:
            cfg = dataclasses.replace(get_arch(case["arch"]).smoke_config,
                                      compute_dtype=jnp.float32, **case["cfg"])
            loss = lambda p, b: rt.loss_fn(cfg, p, b)
        shape = tuple(case["mesh"])
        mesh = jax.make_mesh(shape, tuple(case["axes"]), axis_types=(AxisType.Auto,) * len(shape),
                             devices=jax.devices()[:int(np.prod(shape))])
        with use_sharding(mesh), jax.set_mesh(mesh):
            if case["microbatches"] > 1:
                opt = OptimizerConfig(lr=1e-3, warmup_steps=2, zero1=True)
                step = make_train_step(loss, opt, microbatches=case["microbatches"],
                                       donate=False)
                _, state, m = step(params, init_opt_state(opt, params), batch)
                norm = float(m["grad_norm"])
                scale = min(1.0, opt.clip_norm / max(norm, 1e-9))
                out[name + "/loss"] = np.asarray(m["loss"])
                flat(name + "/grad/", jax.tree.map(
                    lambda x: np.asarray(x, np.float64) / ((1 - opt.b1) * scale), state["m"]))
                continue
            for path, s in jax.tree_util.tree_flatten_with_path(
                    param_specs(cfg.param_defs(), mesh),
                    is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
                out[name + "/split/" + "/".join(str(k.key) for k in path)] = np.asarray(
                    "model" in jax.tree.leaves(tuple(s)))
            (l, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch)
            out[name + "/loss"] = np.asarray(l)
            flat(name + "/grad/", grads)
            if not case["serve"]:
                continue
            toks = inputs["tokens"]
            cache = {{}}
            for k, d in rt.cache_defs(cfg, toks.shape[0], case["max_len"]).items():
                spec = logical_spec(d.logical, mesh.axis_names, shape=d.shape, mesh=mesh)
                cache[k] = jax.device_put(jnp.zeros(d.shape, d.dtype), NamedSharding(mesh, spec))
            pre = jax.jit(lambda p, t, c: rt.prefill(cfg, p, t, c))
            dec = jax.jit(lambda p, c, t, pos: rt.decode_step(cfg, p, c, t, pos))
            P = case["prompt"]
            logits, cache = pre(params, jnp.asarray(toks[:, :P]), cache)
            steps = [np.asarray(logits)]
            for i in range(toks.shape[1] - P):
                logits, cache = dec(params, cache, jnp.asarray(toks[:, P + i]), jnp.int32(P + i))
                steps.append(np.asarray(logits))
            out[name + "/logits"] = np.stack(steps)
    np.savez({out_path!r}, **out)
    print(json.dumps({{"cases": len(cases)}}))
""")


def _paths(tree) -> list:
    """(path joined by "/", leaf) in flattened order."""
    return [("/".join(k.strip("[]'") for k in p.split("/")), x)
            for p, x in flatten_with_paths(tree)]


def _ref_cases(tmp) -> dict:
    cases = {}
    for name, (key, shape, axes, serve_b) in {**LM, **{k: (c, s, AXES, None)
                                                       for k, (c, s) in MB.items()}}.items():
        arrays = {f"params/{p}": x.numpy() for p, x in _paths(CFGS[key].init(SEED, "cpu"))}
        arrays.update({f"batch/{k}": v.numpy() for k, v in _batch(key).items()})
        if serve_b:
            arrays["tokens"] = _tokens(name)
        np.savez(tmp / f"{name}.npz", **arrays)
        arch, fields = LM_CFGS.get(key, ("two-tower-retrieval", {}))
        if key == "tp_e3":  # tests/test_torch_tensor_parallel.py's config
            arch, fields = "smollm-135m", {f.name: getattr(CFGS[key], f.name)
                                           for f in dataclasses.fields(CFGS[key])
                                           if f.name not in ("name", "compute_dtype",
                                                             "param_dtype")}
        else:
            fields = {**fields, "attn_chunk": CHUNK} if key != "two_tower" else {}
        cases[name] = {"inputs": str(tmp / f"{name}.npz"), "mesh": list(shape),
                       "axes": list(axes), "arch": arch, "cfg": fields,
                       "microbatches": 2 if name in MB else 1, "serve": bool(serve_b),
                       "prompt": PROMPT, "max_len": MAX_LEN}
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything across ranks, run once: the reference's two subprocesses
    (half the cases each) start first, the 3, 4 and 2 ranks run beside
    them."""
    tmp = tmp_path_factory.mktemp("whole")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    cases = list(_ref_cases(tmp).items())
    refs = [subprocess.Popen([sys.executable, "-c", REF.format(
        cases=json.dumps(dict(cases[i::2])), out_path=str(tmp / f"ref{i}.npz"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        ranks = {n: run_ranks(fn, n, timeout_s=TIMEOUT_S)
                 for n, fn in ((3, _rank3), (4, _rank4), (2, _rank2))}
        for ref in refs:
            _, err = ref.communicate(timeout=TIMEOUT_S)
            assert ref.returncode == 0, err[-3000:]
    finally:
        for ref in refs:
            ref.kill()
    out = {name: [o[name] for o in ranks[int(np.prod(c[1]))]]
           for name, c in {**LM, **MB}.items()}
    return {"ranks": out, "three": ranks[3],
            "ref": {k: v for i in range(2) for k, v in np.load(tmp / f"ref{i}.npz").items()}}


@pytest.fixture(scope="module")
def one_process():
    out = {}
    for name, (key, shape, axes, serve_b) in LM.items():
        D = int(np.prod(shape[:-1]))  # the batch axes
        out[name] = _grads(key, None, D)
        if serve_b:
            out[name].update(_serve(name, None))
    for name, (key, _) in MB.items():
        out[name] = _grads(key, None, 2)
    out["cell"] = _cell(None)
    return out


def _shardings(name: str) -> list:
    key, shape, axes = ({**LM, **{k: (c, s, AXES, None) for k, (c, s) in MB.items()}})[name][:3]
    return leaves(param_shardings(CFGS[key].param_defs(), make_mesh(shape, axes, device="cpu")))


def _gathered(name: str, outs: list) -> list:
    """Every leaf's global gradient from the ranks' blocks."""
    whole = []
    for j, s in enumerate(_shardings(name)):
        blocks = [o["grads"][j] for o in outs]
        g = np.empty(s.global_shape(blocks[0].shape), dtype=blocks[0].dtype)
        for r, blk in enumerate(blocks):
            local_block(g, s, r)[...] = blk
        whole.append(g)
    return whole


def _leaf_names(key: str) -> list:
    return [p for p, _ in _paths(CFGS[key].param_defs())]


def _short(path: str) -> str:
    """``layers/mlp/wo`` as ``mlp/wo``; any other leaf by its last name."""
    return "mlp/wo" if path.endswith("mlp/wo") else path.split("/")[-1]


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(LM))
def test_leaves_split_as_the_reference_specs(world, name):
    """``split_over_model`` on each rank names exactly the leaves the
    reference's ``param_specs`` splits over ``model`` on its Auto mesh of
    the case's shape, and they are the case's ``SPLIT`` (the rest whole);
    the ranks hold those leaves in blocks and the others whole."""
    key = LM[name][0]
    names = _leaf_names(key)
    full = [x.shape for x in _np(CFGS[key].init(SEED, "cpu"))]
    for o in world["ranks"][name]:
        got = dict(zip(names, o["split"], strict=True))
        for path, v in got.items():
            assert bool(world["ref"][f"{name}/split/{path}"]) == v, path
        assert {_short(p) for p, v in got.items() if v} == SPLIT[name]
        for j, path in enumerate(names):
            assert (o["grads"][j].shape != full[j]) == got[path], path


@pytest.mark.parametrize("name", list(LM))
def test_whole_leaf_steps_equal_one_process(world, one_process, name):
    """Every rank's loss equal; within ``LOSS_TOL`` of one process's
    ``microbatches`` = D step; the gradients gathered from the ranks' blocks
    within ``GRAD_TOL``; each whole leaf's gradient bitwise equal on every
    rank."""
    outs, want = world["ranks"][name], one_process[name]
    for o in outs:
        assert o["loss"] == outs[0]["loss"]
    np.testing.assert_allclose(outs[0]["loss"], want["loss"], **LOSS_TOL)
    for a, b in zip(_gathered(name, outs), want["grads"], strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    for j, s in enumerate(_shardings(name)):
        if s.n_shards == 1:
            for o in outs[1:]:
                assert o["grads"][j].tobytes() == outs[0]["grads"][j].tobytes(), j


@pytest.mark.parametrize("name", list(LM))
def test_reference_gradients_on_its_auto_mesh(world, name):
    """The reference's ``value_and_grad`` of ``loss_fn`` on an
    ``AxisType.Auto`` mesh of the case's shape and axes, on the port's
    weights and batch: its loss within ``LOSS_TOL`` of the ranks', its
    gradients within ``GRAD_TOL`` of the ranks' gathered ones."""
    ref, outs = world["ref"], world["ranks"][name]
    np.testing.assert_allclose(outs[0]["loss"], ref[name + "/loss"], **LOSS_TOL)
    key = LM[name][0]
    for path, a in zip(_leaf_names(key), _gathered(name, outs), strict=True):
        b = ref[f"{name}/grad/{path}"]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("name", SERVED)
def test_serving_equals_one_process_and_the_reference(world, one_process, name):
    """The prefill's and every decode step's logits of each rank (its rows)
    within ``LOGIT_TOL`` of one process's and of the reference's jitted
    ``prefill``/``decode_step`` on its Auto mesh (its cache placed by its
    spec), and bitwise equal across each ``model`` group; the cache's spec
    is ``logical_spec``'s (the pod case: ``kv_seq`` over pod,
    ``head_dim`` over ``model``)."""
    key, shape, axes, serve_b = LM[name]
    mesh = make_mesh(shape, axes, device="cpu")
    outs = world["ranks"][name]
    sh = named_sharding(mesh, (None, "batch"), shape=(STEPS + 1, serve_b))
    for r, o in enumerate(outs):
        for want in (one_process[name]["logits"], world["ref"][name + "/logits"]):
            np.testing.assert_allclose(o["logits"], np.asarray(local_block(want, sh, r)),
                                       **LOGIT_TOL, err_msg=f"rank {r}")
        for q in mesh.group(("model",), r):
            assert o["logits"].tobytes() == outs[q]["logits"].tobytes(), (r, q)
    want = tuple(named_sharding(mesh, ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                                shape=(CFGS[key].n_layers, serve_b, MAX_LEN, CFGS[key].n_kv_heads,
                                       CFGS[key].d_head)).spec)
    assert all(o["spec"] == want for o in outs)
    if name == "smollm_pod":
        # the batch of 1 takes data (of size 1), which pod does not divide
        assert want == (None, "data", "pod", None, "model")


@pytest.mark.parametrize("name", list(LM))
def test_bytes_equal_the_dry_run(world, name):
    """Each rank's parameter bytes equal ``param_shapes(..., mesh)``'s
    per-device count, below one process's where a leaf splits."""
    key, shape, axes, _ = LM[name]
    meta = make_mesh(shape, axes, device="meta")
    want = rf.arg_counts((param_shapes(CFGS[key].param_defs(), meta),), meta)["arg_bytes_dev"]
    whole = sum(x.nbytes for x in leaves(CFGS[key].init(SEED, "cpu")))
    for o in world["ranks"][name]:
        assert o["param_bytes"] == want < whole


@pytest.mark.parametrize("name", list(MB))
def test_microbatches_equal_one_process(world, one_process, name):
    """``microbatches`` = 2 on the data-split mesh: every rank's loss
    equal, within ``LOSS_TOL`` of one process's ``microbatches=2`` step, the
    gathered gradients within ``GRAD_TOL`` (the MoE aux and the in-batch
    softmax over each global microbatch, as one process takes them)."""
    outs, want = world["ranks"][name], one_process[name]
    for o in outs:
        assert o["loss"] == outs[0]["loss"]
    np.testing.assert_allclose(outs[0]["loss"], want["loss"], **LOSS_TOL)
    for a, b in zip(_gathered(name, outs), want["grads"], strict=True):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("name", list(MB))
def test_microbatches_equal_the_reference_step(world, name):
    """The reference's own ``make_train_step(..., microbatches=2)`` on its
    Auto mesh of the case's shape: its loss within ``LOSS_TOL`` of the
    ranks', its gradients (its first AdamW moments over ``(1 − b1)`` and
    the clip scale) within ``GRAD_TOL`` (the two-tower's within
    ``REF_GRAD_TOL``, its softmax at temperature 0.05)."""
    ref, outs = world["ref"], world["ranks"][name]
    key = MB[name][0]
    np.testing.assert_allclose(outs[0]["loss"], ref[name + "/loss"], **LOSS_TOL)
    tol = REF_GRAD_TOL if key == "two_tower" else GRAD_TOL
    for path, a in zip(_leaf_names(key), _gathered(name, outs), strict=True):
        np.testing.assert_allclose(a, ref[f"{name}/grad/{path}"], **tol, err_msg=path)


def test_serving_cell_builds_with_whole_leaves(world, one_process):
    """``build_lm_cell``'s prefill cell of the Qwen1.5 kv-1 variant on
    (1, 3) (its kv projections, MLP and vocab whole) builds and gives one
    process's logits within ``LOGIT_TOL`` on every rank."""
    for o in world["three"]:
        np.testing.assert_allclose(o["cell"], one_process["cell"], **LOGIT_TOL)


def _meta_cell(arch: str, cfg, shape, axes):
    spec = dataclasses.replace(get_arch(arch), config=cfg)
    train = spec.shape("train_4k")
    train = dataclasses.replace(train, params={**train.params, "global_batch": B,
                                               "seq_len": SEQ})
    mesh = make_mesh(shape, axes, device="meta")
    return p_steps.build_lm_cell(spec, train, device="meta", mesh=mesh), mesh


def _bytes_by_hand(cfg, M: int, split: set) -> int:
    """A device's f32 parameter bytes: each leaf of ``split`` 1/M, the rest
    whole."""
    L, D, H, KV, Dh, F, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.padded_vocab)
    E = cfg.n_experts
    n = {"embed": V * D, "unembed": V * D, "ln_f": D, "ln1": L * D, "ln2": L * D,
         "wq": L * D * H * Dh, "wk": L * D * KV * Dh, "wv": L * D * KV * Dh,
         "wo": L * H * Dh * D}
    if cfg.qkv_bias:
        n.update(bq=L * H * Dh, bk=L * KV * Dh, bv=L * KV * Dh)
    if cfg.qk_norm:
        n.update(q_norm=L * Dh, k_norm=L * Dh)
    if E:
        n.update(router=L * D * E, **{f"moe/{w}": L * E * D * F for w in ("wi_gate", "wi_up",
                                                                       "wo")})
    else:
        n.update(wi_gate=L * D * F, wi_up=L * D * F, **{"mlp/wo": L * F * D})
    return 4 * sum(v // M if k in split else v for k, v in n.items())


# name: (arch, config, mesh shape, the leaves split, the count: act = B·S·D·2
# over the batch split, per layer and pass (3: remat full))
ROOFLINE = {
    # attention whole: only the MLP's wo all-reduce
    "qwen25_1x3": ("qwen2.5-14b", get_arch("qwen2.5-14b").smoke_config, (1, 3),
                   {"wi_gate", "wi_up", "mlp/wo"},
                   lambda c: {"all-reduce": 3 * c.n_layers * B * SEQ * c.d_model * 2}),
    # q split, kv whole (sequence-parallel, 48 rows on 3): the all-to-alls of q
    # and the output, no kv gathers, one backward all-reduce of k's and v's
    # cotangents; the wo all-reduces of attention and the MLP
    "smollm_1x3": ("smollm-135m", get_arch("smollm-135m").smoke_config, (1, 3),
                   {"wq", "wo", "wi_gate", "wi_up", "mlp/wo"},
                   lambda c: {"all-reduce": 3 * c.n_layers * 2 * B * SEQ * c.d_model * 2
                              + c.n_layers * 2 * B * SEQ * c.n_kv_heads * c.d_head * 2,
                              "all-to-all": 3 * c.n_layers * 2 * B * SEQ * c.n_heads
                              * c.d_head * 2}),
    # 6 experts whole on 4: no expert gathers; head-parallel attention's wo
    "olmoe_e6_1x4": ("olmoe-1b-7b", dataclasses.replace(
        get_arch("olmoe-1b-7b").smoke_config, n_experts=6), (1, 4),
        {"wq", "wk", "wv", "wo", "embed", "unembed"},
        lambda c: {"all-reduce": 3 * c.n_layers * B * SEQ * c.d_model * 2}),
}


@pytest.mark.parametrize("name", list(ROOFLINE))
def test_lm_activation_bytes_and_dry_run_bytes_by_hand(name):
    """On a meta mesh, the train cell's ``lm_activation_bytes`` (bf16
    compute, remat full) and its parameter bytes a device
    (``arg_counts``) against counts by hand for whole-leaf layouts."""
    arch, cfg, shape, split, count = ROOFLINE[name]
    cell, mesh = _meta_cell(arch, cfg, shape, AXES)
    got = rf.lm_activation_bytes(cfg, "lm_train", B, SEQ, cell.args[0], mesh, 1)
    assert got == count(cfg)
    assert rf.arg_counts((cell.args[0],), mesh)["arg_bytes_dev"] == _bytes_by_hand(
        cfg, shape[1], split)


def test_train_cli_model_parallel_3_on_three_ranks(world):
    """``python -m repro_torch.launch.train --arch smollm-135m
    --model-parallel 3`` as three gloo ranks (the SMOKE config's kv
    projections and vocab whole on ``model`` = 3, bf16 compute): rank 0
    alone logs, its loss lines within ``CLI_RTOL`` of one process's."""
    outs = [o["cli"] for o in world["three"]]
    assert outs[1] == outs[2] == ""
    got = [float(m.group(1)) for m in re.finditer(r"^step +\d+ +loss (\S+) ", outs[0], re.M)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_train.main(CLI_ARGS)
    want = [float(m.group(1)) for m in re.finditer(r"^step +\d+ +loss (\S+) ", buf.getvalue(),
                                                  re.M)]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=CLI_RTOL)
