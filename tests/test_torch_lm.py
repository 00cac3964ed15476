"""PyTorch port: dense LM serving against the reference on the CPU at the
three dense archs' SMOKE configs — the registry (every config field, the
shape set, ``_lm_flops``; the MoE archs' too), ``forward``, ``loss_fn``,
``prefill`` and ``decode_step`` (logits and caches), the sliding window,
the layers alone (``flash_attention``'s masks, ``rope``, ``swiglu``), the
LM cells and the token pipeline.  The reference's ``cfg.init(jax.random.key(0))`` weights
come across by ``params_from_numpy``; its tokens as numpy.

Tolerances: with ``compute_dtype`` f32, rtol 1e-4 / atol 1e-5 (the recsys
tests'): both sides compute in f32 and differ in summation order only.
With the default bf16 compute, the logits are held within
``BF16_LOGIT_TOL`` × max |reference logit|: bf16 keeps 8 significant bits
(a rounding moves a value by up to 2^-9 of it), and XLA on the CPU fuses
chains of bf16 elementwise ops and rounds once per chain where the port
rounds after each op, so the two round at different points on every
residual add, norm, RoPE and SwiGLU of each layer; 2^-5 leaves 2× room
over the largest difference seen on these configs (0.0145)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.data.lm import LMDataConfig as RefLMDataConfig  # noqa: E402
from repro.data.lm import lm_batch as ref_lm_batch  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

ARCHS = ["smollm-135m", "qwen1.5-0.5b", "qwen2.5-14b"]
MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]  # their parity: test_torch_moe.py
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOGIT_TOL = 2.0**-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="f32", **kw):
    """(reference, port) SMOKE configs at ``dtype`` compute."""
    rc, pc = ref_get_arch(arch).smoke_config, get_arch(arch).smoke_config
    if dtype == "f32":
        rc = dataclasses.replace(rc, compute_dtype=jnp.float32)
        pc = dataclasses.replace(pc, compute_dtype=torch.float32)
    return dataclasses.replace(rc, **kw), dataclasses.replace(pc, **kw)


@pytest.fixture(scope="module")
def weights():
    """``weights(arch, rc, pc)``: the reference's seed-0 weights and the
    port's copy of them, drawn once per arch."""
    drawn = {}

    def get(arch, rc, pc):
        if arch not in drawn:
            rp = rc.init(jax.random.key(0))
            drawn[arch] = (rp, params_from_numpy(pc.param_defs(),
                                                 jax.tree.map(np.asarray, rp), device="cpu"))
        return drawn[arch]

    return get


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


def _dtype_name(d):
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) else jnp.dtype(d).name


def _fields(cfg):
    return {f.name: (_dtype_name(v) if f.name.endswith("dtype") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_lm_registry_equals_reference(arch):
    want, got = ref_get_arch(arch), get_arch(arch)
    assert (got.name, got.family, got.source) == (want.name, want.family, want.source)
    for which in ("config", "smoke_config"):
        a, b = getattr(want, which), getattr(got, which)
        assert _fields(b) == _fields(a), which
        for prop in ("d_head", "padded_vocab", "is_moe"):
            assert getattr(b, prop) == getattr(a, prop), (which, prop)
        assert b.n_params() == a.n_params() and b.n_active_params() == a.n_active_params()
    assert ([(s.name, s.kind, s.params, s.skip, s.variant_of) for s in got.shapes]
            == [(s.name, s.kind, s.params, s.skip, s.variant_of) for s in want.shapes])
    cfg, rcfg = got.config, want.config
    for kind, n, kv, b in (("train", 4096 * 256, 0, 1), ("prefill", 32768 * 32, 0, 1),
                           ("decode", 128, 32768, 128), ("decode", 1, 524288, 1)):
        assert steps._lm_flops(cfg, n, kind, kv, b) == ref_steps._lm_flops(rcfg, n, kind, kv, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference(arch, weights):
    rc, pc = _cfgs(arch)
    rp, pp = weights(arch, rc, pc)
    batch = ref_lm_batch(RefLMDataConfig(vocab=rc.vocab, seq_len=32, global_batch=2), 0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    want, _ = rt.forward(rc, rp, batch["tokens"])
    got, aux = pt.forward(pc, pp, tb["tokens"])
    assert got.shape == (2, 32, pc.padded_vocab) and got.dtype == torch.float32
    _close(got, want, "logits")
    assert float(aux) == 0.0
    r_total, r_m = rt.loss_fn(rc, rp, batch)
    p_total, p_m = pt.loss_fn(pc, pp, tb)
    _close(p_total, r_total, "loss")
    assert list(p_m) == list(r_m)
    for k in r_m:
        _close(p_m[k], r_m[k], k)
    assert p_m["tokens"].dtype == torch.int32 and int(p_m["tokens"]) == int(r_m["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch, weights):
    """An 8-token prefill into a 16-slot cache, then one decode step at
    pos 8 (the reference's tests/test_arch_smoke.py decode smoke)."""
    rc, pc = _cfgs(arch)
    rp, pp = weights(arch, rc, pc)
    toks = _tokens(rc.vocab, (2, 8))
    r_logits, r_cache = rt.prefill(rc, rp, jnp.asarray(toks), rt.make_cache(rc, 2, 16))
    cache = pt.make_cache(pc, 2, 16, device="cpu")
    cache["k"].fill_(7.0)  # stale contents past the prompt are zeroed, as the reference pads
    logits, cache = pt.prefill(pc, pp, torch.from_numpy(toks), cache)
    assert logits.shape == (2, pc.padded_vocab)
    _close(logits, r_logits, "prefill logits")
    for k in ("k", "v"):
        _close(cache[k], r_cache[k], f"prefill cache {k}")
    nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)
    r_logits2, r_cache2 = rt.decode_step(rc, rp, r_cache, jnp.asarray(nxt), jnp.int32(8))
    logits2, cache2 = pt.decode_step(pc, pp, cache, torch.from_numpy(nxt), 8)
    assert cache2 is cache  # written in place
    _close(logits2, r_logits2, "decode logits")
    for k in ("k", "v"):
        _close(cache2[k], r_cache2[k], f"decode cache {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_sliding_window_equals_reference(arch, weights):
    """attn_window 8, attn_chunk 8 (tests/test_arch_smoke.py:74): the
    forward over 32 tokens, and a 16-token prefill then a decode step."""
    rc, pc = _cfgs(arch, attn_window=8, attn_chunk=8)
    rp, pp = weights(arch, *_cfgs(arch))
    toks = _tokens(rc.vocab, (2, 32), seed=2)
    want, _ = rt.forward(rc, rp, jnp.asarray(toks))
    got, _ = pt.forward(pc, pp, torch.from_numpy(toks))
    _close(got, want, "windowed logits")
    r_logits, r_cache = rt.prefill(rc, rp, jnp.asarray(toks[:, :16]), rt.make_cache(rc, 2, 24))
    logits, cache = pt.prefill(pc, pp, torch.from_numpy(toks[:, :16]),
                               pt.make_cache(pc, 2, 24, device="cpu"))
    _close(logits, r_logits, "windowed prefill logits")
    r2, _ = rt.decode_step(rc, rp, r_cache, jnp.asarray(toks[:, 16]), jnp.int32(16))
    p2, _ = pt.decode_step(pc, pp, cache, torch.from_numpy(toks[:, 16]), 16)
    _close(p2, r2, "windowed decode logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_bf16_tolerance(arch, weights):
    rc, pc = _cfgs(arch, dtype="bf16")
    rp, pp = weights(arch, *_cfgs(arch))
    toks = _tokens(rc.vocab, (2, 32), seed=3)
    want = np.asarray(rt.forward(rc, rp, jnp.asarray(toks))[0])[..., :rc.vocab]
    got = pt.forward(pc, pp, torch.from_numpy(toks))[0].numpy()[..., :rc.vocab]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_LOGIT_TOL * np.abs(want).max()


FLASH_CASES = {
    "causal": dict(causal=True),
    "causal_q_offset": dict(causal=True, q_offset=8),
    "not_causal": dict(causal=False),
    "valid_len_rows": dict(causal=False, kv_valid_len=[16, 0, 5]),
    "valid_len_scalar": dict(causal=False, kv_valid_len=9),
    "window": dict(causal=True, window=5),
    "window_offset_valid": dict(causal=True, q_offset=12, window=6, kv_valid_len=[20, 3, 0]),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_masks_equal_reference(case):
    """GQA (6 query heads over 2 kv heads), 4 chunks of 8; a row with no
    valid key gives exactly 0."""
    kw = dict(FLASH_CASES[case])
    rng = np.random.default_rng(4)
    B, Sq, Skv, H, KVH, Dh = 3, 8, 32, 6, 2, 16
    q = rng.standard_normal((B, Sq, H, Dh), np.float32)
    k = rng.standard_normal((B, Skv, KVH, Dh), np.float32)
    v = rng.standard_normal((B, Skv, KVH, Dh), np.float32)
    rkw = dict(kw)
    if "kv_valid_len" in kw:
        rkw["kv_valid_len"] = jnp.asarray(kw["kv_valid_len"], jnp.int32)
        kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], dtype=torch.int32)
    want = np.asarray(RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         chunk=8, **rkw))
    got = PL.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             chunk=8, **kw)
    _close(got, want, case)
    if case.startswith(("valid_len_rows", "window_offset")):
        dead = 2 if case == "window_offset_valid" else 1
        assert not got[dead].any()  # fully masked: exactly 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_and_swiglu_equal_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16), np.float32)
    pos = np.arange(7, dtype=np.int32)[None] + np.array([[0], [40]], np.int32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    tol = TOL if dtype == "f32" else dict(rtol=2.0**-7, atol=2.0**-7)
    want = RL.rope(jnp.asarray(x, jd), jnp.asarray(pos), 1_000_000.0)
    got = PL.rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), 1_000_000.0)
    assert got.dtype == td
    _close(got, np.asarray(want, np.float32), "rope", **tol)
    y = rng.standard_normal((2, 5, 12), np.float32)
    p = {k: rng.standard_normal(s, np.float32) * 0.3
         for k, s in (("wi_gate", (12, 20)), ("wi_up", (12, 20)), ("wo", (20, 12)))}
    want = RL.swiglu(jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()})
    got = PL.swiglu(torch.from_numpy(y), {k: torch.from_numpy(v) for k, v in p.items()})
    _close(got, want, "swiglu")


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "long_500k_sliding"])
def test_lm_cells_equal_direct_calls(kind):
    """``build_lm_cell`` at SMOKE, its shape cut to 2 × 32 tokens: the cell
    equals the direct call on its own inputs, its tokens are ``lm_batch``'s
    and its ``model_flops`` the reference's formula."""
    spec = get_arch("smollm-135m")
    smoke = dataclasses.replace(spec, config=_cfgs("smollm-135m")[1])
    shape = spec.shape(kind)
    shape = dataclasses.replace(shape, params={**shape.params, "global_batch": 2,
                                               "seq_len": 32})
    cell = steps.build_cell(smoke, shape, device="cpu", seed=3)
    cfg = smoke.config
    if "attn_window" in shape.params:
        cfg = dataclasses.replace(cfg, attn_window=shape.params["attn_window"])
    params = cell.args[0]
    toks = lm_batch(LMDataConfig(cfg.vocab, 32 if kind == "prefill_32k" else 1, 2, 3), 0,
                    device="cpu")["tokens"]
    rcfg = dataclasses.replace(ref_get_arch("smollm-135m").smoke_config,
                               attn_window=cfg.attn_window)
    if kind == "prefill_32k":
        _, tokens, cache = cell.args
        assert torch.equal(tokens, toks) and cache["k"].shape == (2, 2, 32, 1, 16)
        got, _ = cell.fn(*cell.args)
        want, _ = pt.prefill(cfg, params, tokens, pt.make_cache(cfg, 2, 32, device="cpu"))
        assert cell.model_flops == ref_steps._lm_flops(rcfg, 64, "prefill")
        assert cell.donate == (2,)
    else:
        _, cache, tokens, pos = cell.args
        assert torch.equal(tokens, toks[:, 0]) and pos == 31
        got, _ = cell.fn(*cell.args)
        want, _ = pt.decode_step(cfg, params, pt.make_cache(cfg, 2, 32, device="cpu"),
                                 tokens, pos)
        assert cell.model_flops == ref_steps._lm_flops(rcfg, 2, "decode", kv_len=32, batch=2)
        assert cell.donate == (1,)
    assert got.shape == (2, cfg.padded_vocab) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_lm_train_cell_and_moe_raise():
    """The gaps this test once pinned are closed: the ``lm_train`` cell
    builds and the MoE FFN runs (their parity: ``test_torch_lm_train.py``,
    ``test_torch_moe.py``), and so do the GNN family's cells and training
    (their parity: ``test_torch_egnn.py``): ``build_cell`` gives an
    ``egnn`` cell and ``loss_and_batch_fns`` a finite EGNN loss."""
    from repro_torch.launch import train as p_train

    spec = get_arch("qwen1.5-0.5b")
    shape = spec.shape("train_4k")
    shape = dataclasses.replace(shape, params={"global_batch": 1, "seq_len": 16})
    cell = steps.build_cell(dataclasses.replace(spec, config=spec.smoke_config), shape,
                            device="cpu")
    assert cell.donate == (0, 1) and len(cell.args) == 3
    moe = dataclasses.replace(spec.smoke_config, n_experts=4, top_k=2)
    logits, aux = pt.forward(moe, moe.init(0, "cpu"), torch.zeros((1, 4), dtype=torch.int32))
    assert logits.shape == (1, 4, moe.padded_vocab) and float(aux) > 0
    gnn = get_arch("egnn")
    gnn = dataclasses.replace(gnn, config=gnn.smoke_config)
    cell = steps.build_cell(gnn, gnn.shape("molecule"), device="cpu")
    assert cell.donate == (0, 1) and len(cell.args) == 3 and cell.model_flops > 0
    loss, batch_fn = p_train.loss_and_batch_fns(gnn, gnn.config, 8, 16, 0, "cpu")
    total, metrics = loss(gnn.config.init(0, "cpu"), batch_fn(0))
    assert torch.isfinite(total) and set(metrics) == {"nll", "acc"}


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_batch_shapes_ranges_and_replay(seed):
    """The reference's keys, shapes, dtypes, ranges and label shift; the
    same batch for the same (seed, step), another for another step."""
    dc = LMDataConfig(vocab=512, seq_len=24, global_batch=3, seed=seed)
    b = lm_batch(dc, 5, device="cpu")
    want = ref_lm_batch(RefLMDataConfig(vocab=512, seq_len=24, global_batch=3, seed=seed), 5)
    for k in ("tokens", "labels"):
        assert b[k].shape == want[k].shape and b[k].dtype == torch.int32
    t = b["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 512
    assert torch.equal(b["labels"][:, :-1], t[:, 1:]) and (b["labels"][:, -1] == -1).all()
    # the cluster walk moves by at most one cluster (8 tokens) per position
    c = t // 8
    step = (c[:, 1:] - c[:, :-1]) % 64
    assert bool(((step == 0) | (step == 1) | (step == 63)).all())
    assert torch.equal(lm_batch(dc, 5, device="cpu")["tokens"], t)
    assert not torch.equal(lm_batch(dc, 6, device="cpu")["tokens"], t)


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` the LM entry points run on CUDA; on a host
    without it they raise and name ``device="cpu"``, before allocating
    (every LM arch, its serving and training cells)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS[:1] + MOE_ARCHS:
        spec = get_arch(arch)
        cfg = spec.smoke_config
        smoke = dataclasses.replace(spec, config=cfg)
        for call in (lambda: cfg.init(0), lambda: pt.make_cache(cfg, 1, 16),
                     lambda: lm_batch(LMDataConfig(512, 8, 1), 0),
                     lambda: steps.build_cell(smoke, spec.shape("decode_32k")),
                     lambda: steps.build_cell(smoke, spec.shape("train_4k"))):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
