"""PyTorch port: LM prefill and decode across process ranks, the KV cache
held as the reference's ``cache_defs`` spec places it
(``repro/models/transformer.py``, ``repro/sharding/specs.py``): ``batch``
over data, ``kv_heads`` over ``model`` with ``head_dim`` as the fallback,
``kv_seq`` over data when the batch does not divide.  4 ``gloo`` ranks on
the CPU (``repro_torch.launch.ranks.run_ranks``, torch on one thread per
rank), f32 compute, the reference's seed-0 weights carried across as
numpy (``params_from_numpy``, then ``place_params``), a 64-position cache
(``attn_chunk`` 8, which divides the prompt's keys as the reference's
``flash_attention`` requires), a 24-token prefill, 12 decode steps (positions
24-35: under ``kv_seq`` the write crosses from data rank 0's block of
positions 0-31 into data rank 1's) and one at position 70, which the
reference's ``dynamic_update_slice`` clamps to 63.  Each case is held to

* one process of the port: every prefill and decode logit within
  ``LOGIT_TOL``, the rank's cache block within it of the same slice of
  one process's cache;
* the reference: its jitted ``prefill`` and ``decode_step`` under
  ``jax.set_mesh`` on an ``AxisType.Auto`` mesh of the same shape (fake
  XLA devices, one subprocess), its cache placed by ``logical_spec`` of
  ``cache_defs``: the same spec, logits and cache within ``LOGIT_TOL``;
* the dry-run: each rank's parameter and cache bytes equal
  ``param_shapes(..., mesh)``'s per-device count.

The cases:

* the SmolLM SMOKE config (3 heads, 1 kv head, d_head 16: ``head_dim``
  over ``model``, attention sequence-parallel) on (2, 2) with B = 2
  (``batch`` over data) and B = 1 (``kv_seq`` over data), and on (1, 4);
* the Qwen1.5-0.5B SMOKE config (4 / 4 heads: ``kv_heads`` over
  ``model``, head-parallel) on (2, 2) with B = 2 and B = 1;
* the OLMoE SMOKE config (4 / 4 heads, 8 experts, 4 a rank) on (2, 2).

Besides: the serving cells of ``build_lm_cell`` build and run on a
process mesh, a data-split cell holding only its rows; an OLMoE prefill
and decode after a data-parallel ``microbatches`` = 2 train step on the
same mesh run as without it; the serving guards (leaves that ``model``
does not divide: ``tests/test_torch_whole_leaves.py``).
Every launch is bounded by a timeout."""
import dataclasses
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
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.layers import head_parallel  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    param_shapes,
    param_shardings,
    params_from_numpy,
    place_params,
)
from repro_torch.sharding.specs import local_block, named_sharding, use_sharding  # noqa: E402
from repro_torch.train import loop as p_loop  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
AXES = ("data", "model")
SEED = 0
MAX_LEN = 64
PROMPT = 24
STEPS = 12
# the decode positions: PROMPT .. PROMPT + STEPS - 1, then one past the
# cache, clamped to MAX_LEN - 1 as the reference's dynamic_update_slice
POSITIONS = [*range(PROMPT, PROMPT + STEPS), MAX_LEN + 6]
# logits and caches of the ranks, one process and the reference differ by
# f32 rounding only: at most 4.1e-6 apart on these cases, where the logits
# reach 4.4 (tests/test_torch_tensor_parallel.py's GRAD_TOL, rtol 1e-4,
# with an atol for entries near 0 at 1e-5 of the logits' scale)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = {"smollm": "smollm-135m", "qwen15": "qwen1.5-0.5b", "olmoe": "olmoe-1b-7b"}
CHUNK = 8
CFGS = {a: dataclasses.replace(get_arch(n).smoke_config, compute_dtype=torch.float32,
                               attn_chunk=CHUNK)
        for a, n in ARCHS.items()}
# name: (arch, mesh shape, batch, the cache's spec)
CASES = {
    "smollm_2x2_b2": ("smollm", (2, 2), 2, (None, "data", None, None, "model")),
    "smollm_2x2_b1": ("smollm", (2, 2), 1, (None, None, "data", None, "model")),
    "smollm_1x4_b2": ("smollm", (1, 4), 2, (None, "data", None, None, "model")),
    "qwen15_2x2_b2": ("qwen15", (2, 2), 2, (None, "data", None, "model", None)),
    "qwen15_2x2_b1": ("qwen15", (2, 2), 1, (None, None, "data", "model", None)),
    "olmoe_2x2_b2": ("olmoe", (2, 2), 2, (None, "data", None, "model", None)),
}
KV_SEQ = [k for k, c in CASES.items() if c[3][2] is not None]
# the serving cells on (2, 2): Qwen1.5 SMOKE at 2 x 32 (a 32-position cache)
CELL_ARCH, CELL_B, CELL_S = "qwen1.5-0.5b", 2, 32
MB_OPT = OptimizerConfig(zero1=True)  # the step before serving


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(name: str) -> np.ndarray:
    cfg, B = CFGS[CASES[name][0]], CASES[name][2]
    rng = np.random.default_rng(SEED)
    return rng.integers(0, cfg.vocab, size=(B, PROMPT + STEPS + 1)).astype(np.int32)


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of ``x`` (the ``batch`` spec's block)."""
    sh = named_sharding(mesh, ("batch",) + (None,) * (x.dim() - 1), shape=tuple(x.shape))
    return local_block(x, sh).clone()


def _nbytes(tree) -> int:
    return sum(x.nbytes for x in leaves(tree))


def _serve(arch: str, weights: dict, tokens: np.ndarray, mesh=None) -> dict:
    """The prefill and every decode step of ``tokens`` (the global batch)
    on ``mesh`` (a process mesh: the rank's rows, parameter and cache
    blocks; None: one process): the logits of each step, the cache after
    the last, the bytes held."""
    cfg = CFGS[arch]
    params = params_from_numpy(cfg.param_defs(), weights, "cpu")
    toks = torch.from_numpy(tokens)
    if mesh is not None:
        params = place_params(params, param_shardings(cfg.param_defs(), mesh))
        toks = _rows(toks, mesh)
    cache = pt.make_cache(cfg, tokens.shape[0], MAX_LEN, "cpu", mesh)
    logits = []
    with torch.no_grad(), use_sharding(mesh):
        lg, cache = pt.prefill(cfg, params, toks[:, :PROMPT], cache)
        logits.append(lg.numpy().copy())
        for i, pos in enumerate(POSITIONS):
            lg, cache = pt.decode_step(cfg, params, cache, toks[:, PROMPT + i], pos)
            logits.append(lg.numpy().copy())
    out = {"logits": np.stack(logits), "k": cache["k"].numpy(), "v": cache["v"].numpy(),
           "param_bytes": _nbytes(params), "cache_bytes": _nbytes(cache)}
    if mesh is not None:
        out["spec"] = tuple(cache["k"].sharding.spec)
        out["rows"] = int(toks.shape[0])
    return out


def _cells(mesh) -> dict:
    """The Qwen1.5 SMOKE serving cells on ``mesh`` (or one process): the
    output of ``fn``, the tokens' rows and storage bytes, the bytes held."""
    spec = get_arch(CELL_ARCH)
    spec = dataclasses.replace(spec, config=CFGS["qwen15"])
    out = {}
    for kind, shape_name in (("lm_prefill", "prefill_32k"), ("lm_decode", "decode_32k")):
        shape = spec.shape(shape_name)
        shape = dataclasses.replace(shape, params={**shape.params, "global_batch": CELL_B,
                                                   "seq_len": CELL_S})
        cell = p_steps.build_lm_cell(spec, shape, device="cpu", seed=SEED, mesh=mesh)
        tokens = cell.args[1] if kind == "lm_prefill" else cell.args[2]
        cache = cell.args[2] if kind == "lm_prefill" else cell.args[1]
        entry = {"tokens": tuple(tokens.shape),
                 "token_storage": tokens.untyped_storage().nbytes(),
                 "param_bytes": _nbytes(cell.args[0]), "cache_bytes": _nbytes(cache)}
        with torch.no_grad():
            entry["logits"] = cell.fn(*cell.args)[0].numpy()
        out[kind] = entry
    return out


def _guards(mesh) -> dict:
    """A whole cache (made without the mesh) raises in a prefill on the
    process mesh, and a rank's cache block outside the mesh's sharding
    context."""
    out = {"whole_cache": "", "no_context": ""}
    cfg = CFGS["qwen15"]
    params, tokens = cfg.init(SEED, "cpu", mesh), torch.zeros((1, 16), dtype=torch.int32)
    for guard, cache, ctx in (("whole_cache", pt.make_cache(cfg, 1, MAX_LEN, "cpu"), mesh),
                              ("no_context", pt.make_cache(cfg, 2, MAX_LEN, "cpu", mesh), None)):
        try:
            with torch.no_grad(), use_sharding(ctx):
                pt.prefill(cfg, params, tokens, cache)
        except ValueError as e:
            out[guard] = str(e)
    return out


def _rank4(rank: int, weights: dict, tokens: dict) -> dict:
    torch.set_num_threads(1)
    out = {}
    for name, (arch, shape, _, _) in CASES.items():
        mesh = make_process_mesh(shape, AXES, device="cpu")
        out[name] = _serve(arch, weights[arch], tokens[name], mesh)
    mesh = make_process_mesh((2, 2), AXES, device="cpu")
    # a serving call after a data-parallel train step that cuts the batch
    # into 2 microbatches on the same mesh: MoE serving takes no aux over
    # the batch, and the step leaves nothing behind that serving reads
    cfg = CFGS["olmoe"]
    with use_sharding(mesh):
        step = p_loop.make_train_step(lambda p, b: pt.loss_fn(cfg, p, b), MB_OPT, 2,
                                      p_steps.moment_shardings(cfg.param_defs(), mesh))
    params = place_params(params_from_numpy(cfg.param_defs(), weights["olmoe"], "cpu"),
                          param_shardings(cfg.param_defs(), mesh))
    toks = torch.from_numpy(tokens["olmoe_2x2_b2"]).repeat(2, 1)  # 2 rows a microbatch
    step.value_and_grad(params, {"tokens": toks[:, :PROMPT], "labels": toks[:, 1:PROMPT + 1]})
    out["olmoe_microbatches"] = _serve("olmoe", weights["olmoe"], tokens["olmoe_2x2_b2"],
                                       mesh)
    out["cells"] = _cells(mesh)
    out["guards"] = _guards(mesh)
    return out


# -- the reference, in a subprocess on fake XLA devices ----------------------

REF = textwrap.dedent("""
    import dataclasses, json, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import get_arch
    from repro.models import transformer as rt
    from repro.sharding.specs import logical_spec, use_sharding

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
        toks = inputs["tokens"]
        cfg = dataclasses.replace(get_arch(case["arch"]).smoke_config, compute_dtype=jnp.float32,
                                  attn_chunk=case["chunk"])
        shape = tuple(case["mesh"])
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        P = case["prompt"]

        def run(mesh):
            cache = {{}}
            for k, d in rt.cache_defs(cfg, toks.shape[0], case["max_len"]).items():
                cache[k] = jnp.zeros(d.shape, d.dtype)
                if mesh is not None:
                    spec = logical_spec(d.logical, mesh.axis_names, shape=d.shape, mesh=mesh)
                    cache[k] = jax.device_put(cache[k], NamedSharding(mesh, spec))
                    out[name + "/spec"] = np.asarray(json.dumps(list(spec)))
            pre = jax.jit(lambda p, t, c: rt.prefill(cfg, p, t, c))
            dec = jax.jit(lambda p, c, t, pos: rt.decode_step(cfg, p, c, t, pos))
            logits, cache = pre(params, jnp.asarray(toks[:, :P]), cache)
            steps = [np.asarray(logits)]
            for i, pos in enumerate(case["positions"]):
                logits, cache = dec(params, cache, jnp.asarray(toks[:, P + i]), jnp.int32(pos))
                steps.append(np.asarray(logits))
            return np.stack(steps), np.asarray(cache["k"]), np.asarray(cache["v"])

        with use_sharding(mesh), jax.set_mesh(mesh):
            out[name + "/logits"], out[name + "/k"], out[name + "/v"] = run(mesh)
        out[name + "/one/logits"], out[name + "/one/k"], out[name + "/one/v"] = run(None)
    np.savez({out_path!r}, **out)
    print(json.dumps({{"cases": len(cases)}}))
""")


def _paths(tree) -> list:
    """(path joined by "/", leaf) in flattened order."""
    return [("/".join(k.strip("[]'") for k in p.split("/")), x)
            for p, x in flatten_with_paths(tree)]


@pytest.fixture(scope="module")
def weights():
    """Each arch's SMOKE weights from the reference's seed-0 init (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch

    out = {}
    for arch, name in ARCHS.items():
        rc = dataclasses.replace(ref_get_arch(name).smoke_config, compute_dtype=jnp.float32,
                                 attn_chunk=CHUNK)
        out[arch] = jax.tree_util.tree_map(np.asarray, rc.init(jax.random.key(SEED)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, weights):
    """Everything across ranks, run once: the reference's subprocess starts
    first (each case's weights and tokens in an ``.npz``), the 4 ranks run
    beside it."""
    tmp = tmp_path_factory.mktemp("kv")
    cases = {}
    tokens = {name: _tokens(name) for name in CASES}
    for name, (arch, shape, _, _) in CASES.items():
        params = params_from_numpy(CFGS[arch].param_defs(), weights[arch], "cpu")
        arrays = {f"params/{p}": x.numpy() for p, x in _paths(params)}
        np.savez(tmp / f"{name}.npz", tokens=tokens[name], **arrays)
        cases[name] = {"inputs": str(tmp / f"{name}.npz"), "mesh": list(shape),
                       "arch": ARCHS[arch], "prompt": PROMPT, "max_len": MAX_LEN,
                       "positions": POSITIONS, "chunk": CHUNK}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen([sys.executable, "-c", REF.format(cases=json.dumps(cases),
                                                             out_path=str(tmp / "ref.npz"))],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_rank4, 4, args=(weights, tokens), timeout_s=TIMEOUT_S)
        _, err = ref.communicate(timeout=TIMEOUT_S)
        assert ref.returncode == 0, err[-3000:]
    finally:
        ref.kill()
    return {"ranks": ranks, "ref": dict(np.load(tmp / "ref.npz"))}


@pytest.fixture(scope="module")
def one_process(weights):
    out = {}
    for name, (arch, _, B, _) in CASES.items():
        if (arch, B) not in out:
            out[(arch, B)] = _serve(arch, weights[arch], _tokens(name))
    return {name: out[(arch, B)] for name, (arch, _, B, _) in CASES.items()}


def _block(name: str, x: np.ndarray, rank: int) -> np.ndarray:
    """Position ``rank``'s block of the global cache ``x`` on the case's
    mesh, by its spec."""
    shape = CASES[name][1]
    sh = named_sharding(make_mesh(shape, AXES, device="cpu"),
                        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                        shape=tuple(x.shape))
    return np.asarray(local_block(x, sh, rank))


def _rank_rows(name: str, x: np.ndarray, rank: int) -> np.ndarray:
    """Position ``rank``'s rows of ``x`` [steps, B, ...] (dim 1)."""
    shape = CASES[name][1]
    mesh = make_mesh(shape, AXES, device="cpu")
    sh = named_sharding(mesh, (None, "batch"), shape=tuple(x.shape[:2]))
    return np.asarray(local_block(x, sh, rank))


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_cache_layout_is_the_references(world, name):
    """The rank's cache carries the spec that ``logical_spec`` of
    ``cache_defs`` gives on its mesh, the reference's own on its Auto
    mesh; its attention is head-parallel exactly when ``kv_heads`` takes
    ``model``; its rows are the ``batch`` spec's block."""
    arch, (d, m), B, spec = CASES[name]
    cfg = CFGS[arch]
    assert json.loads(str(world["ref"][name + "/spec"])) == list(spec)
    assert head_parallel(cfg.n_heads, cfg.n_kv_heads, m) == (spec[3] == "model")
    for o in world["ranks"]:
        assert o[name]["spec"] == spec
        assert o[name]["rows"] == (B // d if spec[1] else B)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_one_process(world, one_process, name):
    """Every rank's prefill and decode logits (its rows, every padded
    vocab column) within ``LOGIT_TOL`` of one process's, and bitwise equal
    across each ``model`` group; its cache block within ``LOGIT_TOL`` of
    the same slice of one process's cache after the last step."""
    want = one_process[name]
    outs = [o[name] for o in world["ranks"]]
    mesh = make_mesh(CASES[name][1], AXES, device="cpu")
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["logits"], _rank_rows(name, want["logits"], r),
                                   **LOGIT_TOL, err_msg=f"rank {r}")
        for k in ("k", "v"):
            np.testing.assert_allclose(o[k], _block(name, want[k], r), **LOGIT_TOL,
                                       err_msg=f"rank {r} {k}")
        for q in mesh.group(("model",), r):
            assert o["logits"].tobytes() == outs[q]["logits"].tobytes(), (r, q)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_prefill_and_decode_on_its_auto_mesh(world, name):
    """The reference's jitted ``prefill`` and ``decode_step`` on an
    ``AxisType.Auto`` mesh of the case's shape, its cache placed by its
    spec: the prefill's and every in-range decode step's logits within
    ``LOGIT_TOL`` of each rank's, and each rank's cache block within it of
    the slice of the reference's cache at positions 0-62.  The write past
    the cache is held to the reference on one device, which clamps it to
    position 63: on the mesh, with ``head_dim`` split over ``model``, the
    reference drops it (ROADMAP Queue 3) and its last logits differ."""
    ref = world["ref"]
    last = len(POSITIONS)  # the clamped step's logits
    for r, o in enumerate(world["ranks"]):
        o = o[name]
        np.testing.assert_allclose(o["logits"][:last],
                                   _rank_rows(name, ref[name + "/logits"], r)[:last],
                                   **LOGIT_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(o["logits"][last:],
                                   _rank_rows(name, ref[name + "/one/logits"], r)[last:],
                                   **LOGIT_TOL, err_msg=f"rank {r}, the clamped step")
        for k in ("k", "v"):
            mesh_cache = ref[f"{name}/{k}"].copy()
            mesh_cache[:, :, MAX_LEN - 1] = ref[f"{name}/one/{k}"][:, :, MAX_LEN - 1]
            np.testing.assert_allclose(o[k], _block(name, mesh_cache, r), **LOGIT_TOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_bytes_a_rank_equal_the_dry_run(world, one_process, name):
    """Each rank's parameter and cache bytes equal the per-device count of
    ``param_shapes`` on the case's mesh (meta), less than one process's."""
    arch, shape, B, _ = CASES[name]
    cfg = CFGS[arch]
    meta = make_mesh(shape, AXES, device="meta")
    want_p = rf.arg_counts((param_shapes(cfg.param_defs(), meta),), meta)["arg_bytes_dev"]
    want_c = rf.arg_counts((param_shapes(pt.cache_defs(cfg, B, MAX_LEN), meta),),
                           meta)["arg_bytes_dev"]
    for o in world["ranks"]:
        assert o[name]["param_bytes"] == want_p < one_process[name]["param_bytes"]
        assert o[name]["cache_bytes"] == want_c < one_process[name]["cache_bytes"]


@pytest.mark.parametrize("name", KV_SEQ)
def test_kv_seq_decode_crosses_the_block_boundary(world, name):
    """Under ``kv_seq`` over data the decode writes land in the block that
    holds their position: data rank 0's block (positions 0-31) takes the
    prompt and positions 24-31, data rank 1's takes 32-35 and the clamped
    write at 63, zero elsewhere."""
    _, (d, m), _, _ = CASES[name]
    n = MAX_LEN // d
    written = set(range(PROMPT + STEPS)) | {MAX_LEN - 1}
    mesh = make_mesh((d, m), AXES, device="cpu")
    for r, o in enumerate(world["ranks"]):
        s0 = mesh.coords_of(r)["data"] * n
        live = np.abs(o[name]["k"]).reshape(*o[name]["k"].shape[:3], -1).max(axis=(0, 1, 3)) > 0
        assert {s0 + i for i in np.flatnonzero(live)} == {p for p in written if s0 <= p < s0 + n}


@pytest.mark.parametrize("kind", ["lm_prefill", "lm_decode"])
def test_serving_cells_on_a_process_mesh(world, kind):
    """``build_lm_cell``'s serving cells build and run on the (2, 2)
    process mesh: each rank holds its row of the 2-row batch (its own
    storage), its parameter and cache blocks (the dry-run's per-device
    bytes), and its ``fn`` gives one process's cell's logits for that row
    within ``LOGIT_TOL``."""
    spec = dataclasses.replace(get_arch(CELL_ARCH), config=CFGS["qwen15"])
    one = _cells(None)[kind]
    meta = make_mesh((2, 2), AXES, device="meta")
    shape = spec.shape("prefill_32k" if kind == "lm_prefill" else "decode_32k")
    shape = dataclasses.replace(shape, params={**shape.params, "global_batch": CELL_B,
                                               "seq_len": CELL_S})
    args = p_steps.build_lm_cell(spec, shape, device="meta", mesh=meta).args
    params, cache = args[0], (args[2] if kind == "lm_prefill" else args[1])
    want_p = rf.arg_counts((params,), meta)["arg_bytes_dev"]
    want_c = rf.arg_counts((cache,), meta)["arg_bytes_dev"]
    for r, o in enumerate(world["ranks"]):
        got = o["cells"][kind]
        rows = one["tokens"][0] // 2
        assert got["tokens"] == (rows, *one["tokens"][1:])
        assert got["token_storage"] == one["token_storage"] // 2
        assert got["param_bytes"] == want_p and got["cache_bytes"] == want_c
        row = (r // 2) * rows
        np.testing.assert_allclose(got["logits"], one["logits"][row:row + rows], **LOGIT_TOL)


def test_moe_serving_inside_train_microbatches(world):
    """An OLMoE SMOKE prefill and decode on the data-split (2, 2) mesh
    after a data-parallel ``microbatches`` = 2 step's gradients on that
    mesh: bitwise as without it (serving takes no aux over the batch, and
    the step leaves no state behind)."""
    for o in world["ranks"]:
        a, b = o["olmoe_microbatches"], o["olmoe_2x2_b2"]
        for k in ("logits", "k", "v"):
            assert a[k].tobytes() == b[k].tobytes(), k


GUARDS = {
    "whole_cache": "make the cache with make_cache(..., mesh=mesh)",
    "no_context": "served under that mesh's use_sharding context",
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_guards_raise(world, guard):
    """A prefill on a process mesh with a cache made without it, or with a
    rank's cache block outside the mesh's sharding context, raises
    ``ValueError`` (a kv projection width that ``model`` does not divide
    serves with its leaves whole: ``tests/test_torch_whole_leaves.py``)."""
    for o in world["ranks"]:
        assert GUARDS[guard] in o["guards"][guard], o["guards"]
