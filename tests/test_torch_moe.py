"""PyTorch port: the MoE LMs against the reference on the CPU at the two
MoE archs' SMOKE configs — the registry (every config field, the shape
set, the capacity per shape, ``_lm_flops``), ``moe_ffn`` (output, aux
loss, routing and the dispatch maps of every group; with the published
capacity factor, with one small enough to drop assignments, and at bf16
compute), the dense oracle ``moe_ffn_ref``, the dispatch and combine
gradients, and ``forward``, ``loss_fn``, ``prefill`` and ``decode_step``.
The reference's ``cfg.init(jax.random.key(0))`` weights come across by
``params_from_numpy``; inputs are numpy draws from fixed seeds.

Tolerances: f32 compute, rtol 1e-4 / atol 1e-5 (``test_torch_lm.py``'s):
both sides compute in f32 and differ in summation order only.  The
routing (top-k experts, slots, drops) is held exactly.  At bf16 compute
the output is held within ``BF16_TOL`` × max |reference| for the reason
``test_torch_lm.py`` gives: XLA on the CPU rounds fused bf16 chains once
where the port rounds after each op."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import moe as rm  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe as pm  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 2.0**-5


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


_DRAWN = {}


def _weights(arch):
    """The reference's seed-0 weights and the port's copy of them."""
    if arch not in _DRAWN:
        rc, pc = _cfgs(arch)
        rp = rc.init(jax.random.key(0))
        _DRAWN[arch] = (rp, params_from_numpy(pc.param_defs(), jax.tree.map(np.asarray, rp),
                                              device="cpu"))
    return _DRAWN[arch]


def _layer0(arch):
    """Layer 0's MoE parameters, (reference, port)."""
    rp, pp = _weights(arch)
    return (jax.tree.map(lambda a: a[0], rp["layers"]["moe"]),
            {k: v[0] for k, v in pp["layers"]["moe"].items()})


def _x(d_model, seed=0, shape=(3, 32)):
    return np.random.default_rng(seed).standard_normal((*shape, d_model)).astype(np.float32)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


def _dtype_name(d):
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) else jnp.dtype(d).name


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_registry_equals_reference(arch):
    """Every field of CONFIG and SMOKE, the shapes, the parameter counts,
    the capacity of each shape's group and ``_lm_flops``."""
    want, got = ref_get_arch(arch), get_arch(arch)
    assert (got.name, got.family, got.source) == (want.name, want.family, want.source)
    for which in ("config", "smoke_config"):
        a, b = getattr(want, which), getattr(got, which)
        fields = [f.name for f in dataclasses.fields(a)]
        assert fields == [f.name for f in dataclasses.fields(b)]
        for f in fields:
            va, vb = getattr(a, f), getattr(b, f)
            if f.endswith("dtype"):
                va, vb = _dtype_name(va), _dtype_name(vb)
            assert va == vb, (which, f)
        assert b.is_moe and b.n_params() == a.n_params()
        assert b.n_active_params() == a.n_active_params()
    assert ([(s.name, s.kind, s.params, s.skip, s.variant_of) for s in got.shapes]
            == [(s.name, s.kind, s.params, s.skip, s.variant_of) for s in want.shapes])
    cfg = got.config
    want_c = {"olmoe-1b-7b": (1280, 640, 1), "granite-moe-1b-a400m": (2560, 1280, 1)}[arch]
    assert tuple(pm.capacity(cfg, S) for S in (8192, 4096, 1)) == want_c
    for kind, n, kv, b in (("train", 4096 * 256, 0, 1), ("prefill", 32768 * 32, 0, 1),
                           ("decode", 128, 32768, 128)):
        assert steps._lm_flops(cfg, n, kind, kv, b) == ref_steps._lm_flops(want.config, n, kind,
                                                                           kv, b)


MOE_CASES = ["published", "dropping", "bf16"]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_equals_reference(arch, case):
    """``moe_ffn`` on 3 groups of 32 tokens: the output and aux loss, the
    router's top-k experts, and each group's slot maps against the
    reference's ``_dispatch_group``.  ``dropping`` sets a capacity factor
    of 0.5, and the test checks that assignments were dropped."""
    kw = {"dropping": dict(capacity_factor=0.5)}.get(case, {})
    rc, pc = _cfgs(arch, "bf16" if case == "bf16" else "f32", **kw)
    lr, lp = _layer0(arch)
    x = _x(rc.d_model)
    xr, xp = jnp.asarray(x, rc.compute_dtype), torch.from_numpy(x).to(pc.compute_dtype)
    want, want_aux = rm.moe_ffn(xr, lr, rc)
    got, aux = pm.moe_ffn(xp, lp, pc)
    assert got.shape == xp.shape and got.dtype == pc.compute_dtype and aux.dtype == torch.float32
    if case == "bf16":
        w = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - w).max() <= BF16_TOL * np.abs(w).max()
    else:
        _close(got, want, "out")
    _close(aux, want_aux, "aux")
    # routing: the reference's router and top-k, then its per-group maps
    logits = jnp.einsum("bsd,de->bse", xr, lr["router"].astype(xr.dtype)).astype(jnp.float32)
    r_p, r_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), rc.top_k)
    r_p = r_p / jnp.maximum(r_p.sum(-1, keepdims=True), 1e-9)
    _, top_p, top_e = pm._route(xp, lp, pc)
    assert np.array_equal(top_e.numpy(), np.asarray(r_e))
    E, S = rc.n_experts, x.shape[1]
    C = pm.capacity(pc, S)
    assert C == max(int(rc.capacity_factor * S * rc.top_k / E + 0.5), 1)
    _, r_tok, r_used, r_w = jax.vmap(lambda xs, te, tp: rm._dispatch_group(xs, te, tp, E, C))(
        xr, r_e, r_p)
    tok, used, w, tok_slot = pm._dispatch_maps(top_e, top_p, E, C)
    assert np.array_equal(used.numpy(), np.asarray(r_used))
    assert np.array_equal(np.where(used.numpy(), tok.numpy(), 0),
                          np.where(np.asarray(r_used), np.asarray(r_tok), 0))
    _close(w, r_w, "slot weights")
    n_kept = int(used.sum())
    assert int((tok_slot < E * C).sum()) == n_kept
    if case == "dropping":
        assert n_kept < x.shape[0] * S * rc.top_k  # some assignment was dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_ref_and_no_drop_equal(arch):
    """The dense oracle equals the reference's; with capacity factor E / K
    (C = S: nothing dropped) the port's ``moe_ffn`` equals its own
    oracle."""
    rc, pc = _cfgs(arch)
    lr, lp = _layer0(arch)
    x = _x(rc.d_model, seed=1)
    got = pm.moe_ffn_ref(torch.from_numpy(x), lp, pc)
    _close(got, rm.moe_ffn_ref(jnp.asarray(x), lr, rc), "moe_ffn_ref")
    wide = dataclasses.replace(pc, capacity_factor=pc.n_experts / pc.top_k)
    assert pm.capacity(wide, x.shape[1]) == x.shape[1]
    out, _ = pm.moe_ffn(torch.from_numpy(x), lp, wide)
    _close(out, got.numpy(), "moe_ffn (no drop) vs moe_ffn_ref")


@pytest.mark.parametrize("which", ["dispatch", "combine"])
def test_dispatch_and_combine_are_adjoint(which):
    """The hand-written backwards (each one the other's forward) against
    numerical gradients in f64, on a grouping that drops assignments."""
    rng = np.random.default_rng(2)
    B, S, K, E, D = 2, 6, 2, 3, 4
    top_e = torch.from_numpy(np.stack([np.stack([rng.permutation(E)[:K] for _ in range(S)])
                                       for _ in range(B)]))
    top_p = torch.rand(B, S, K, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    C = 3
    tok, used, _, tok_slot = pm._dispatch_maps(top_e, top_p, E, C)
    assert int(used.sum()) < B * S * K
    if which == "dispatch":
        x = torch.randn(B, S, D, dtype=torch.float64, requires_grad=True)
        fn = lambda x: pm._Dispatch.apply(x, tok, used, tok_slot)  # noqa: E731
    else:
        x = torch.randn(B, E * C, D, dtype=torch.float64, requires_grad=True)
        fn = lambda x: pm._Combine.apply(x, tok, used, tok_slot)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_loss_prefill_decode_equal_reference(arch):
    """``forward`` (logits and the per-layer aux summed), ``loss_fn`` and
    its metrics; an 8-token prefill into a 16-slot cache, then a decode
    step at pos 8."""
    rc, pc = _cfgs(arch)
    rp, pp = _weights(arch)
    toks = np.random.default_rng(3).integers(0, rc.vocab, (2, 32)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    want, want_aux = rt.forward(rc, rp, jnp.asarray(toks))
    got, aux = pt.forward(pc, pp, torch.from_numpy(toks))
    _close(got, want, "logits")
    _close(aux, want_aux, "aux")
    assert float(aux) > 0
    batch = {"tokens": toks, "labels": labels}
    r_total, r_m = rt.loss_fn(rc, rp, {k: jnp.asarray(v) for k, v in batch.items()})
    p_total, p_m = pt.loss_fn(pc, pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(p_total, r_total, "loss")
    assert list(p_m) == list(r_m)
    for k in r_m:
        _close(p_m[k], r_m[k], k)
    r_logits, r_cache = rt.prefill(rc, rp, jnp.asarray(toks[:, :8]), rt.make_cache(rc, 2, 16))
    cache = pt.make_cache(pc, 2, 16, device="cpu")
    logits, cache = pt.prefill(pc, pp, torch.from_numpy(toks[:, :8]), cache)
    _close(logits, r_logits, "prefill logits")
    for k in ("k", "v"):
        _close(cache[k], r_cache[k], f"prefill cache {k}")
    nxt = toks[:, 8]
    r2, r_cache2 = rt.decode_step(rc, rp, r_cache, jnp.asarray(nxt), jnp.int32(8))
    p2, cache2 = pt.decode_step(pc, pp, cache, torch.from_numpy(nxt), 8)
    _close(p2, r2, "decode logits")
    for k in ("k", "v"):
        _close(cache2[k], r_cache2[k], f"decode cache {k}")
