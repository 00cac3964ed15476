"""PyTorch port: each kernel's plain version (what the wrappers run on CPU
tensors) against the reference's Pallas kernels in interpret mode and their
jnp oracles, over the reference's own kernel test cases.  The hand-written
CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.footprint import geo_score as j_fp_score  # noqa: E402
from repro.core.spatial_index import SCALE_BLOCK, block_metadata_np, quantize_amps_np  # noqa: E402
from repro.kernels.geo_score.ops import geo_score_docs as j_geo_docs  # noqa: E402
from repro.kernels.geo_score.ops import geo_score_toeprints as j_geo  # noqa: E402
from repro.kernels.geo_score.ref import geo_score_toeprints_ref as j_geo_ref  # noqa: E402
from repro.kernels.sweep_score.ops import sweep_score as j_sweep  # noqa: E402
from repro.kernels.sweep_score.ops import sweep_score_pruned as j_pruned  # noqa: E402
from repro.kernels.sweep_score.ref import sweep_score_pruned_ref as j_pruned_ref  # noqa: E402
from repro.kernels.sweep_score.ref import sweep_score_ref as j_sweep_ref  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.geo_score import ops as pg  # noqa: E402
from repro_torch.kernels.geo_score import ref as pgr  # noqa: E402
from repro_torch.kernels.sweep_score import kernel as psk  # noqa: E402
from repro_torch.kernels.sweep_score import ops as ps  # noqa: E402
from repro_torch.kernels.sweep_score import ref as psr  # noqa: E402

INVALID = 2**31 - 1
TOL = dict(rtol=1e-6, atol=1e-7)  # XLA and torch may round a sum in another order
QR2 = np.array([[0.2, 0.2, 0.6, 0.6], [0.5, 0.5, 0.9, 0.9]], np.float32)


def _rects(rng, n):
    lo = rng.uniform(0, 0.9, (n, 2)).astype(np.float32)
    hi = lo + rng.uniform(0.005, 0.2, (n, 2)).astype(np.float32)
    return np.concatenate([lo, np.minimum(hi, 1.0)], axis=1)


def _store(rng, T):
    lo = rng.uniform(0, 0.9, (T, 2)).astype(np.float32)
    wh = rng.uniform(0.01, 0.08, (T, 2)).astype(np.float32)
    return np.concatenate([lo, lo + wh], axis=1).astype(np.float32), rng.uniform(0, 1, T).astype(np.float32)


def _sweeps(rng, T, budget, k):
    ss = np.sort(rng.integers(0, T, k)).astype(np.int32)
    ee = np.minimum(ss + rng.integers(1, budget + 500, k), T).astype(np.int32)
    if k > 1:
        ss[k // 2] = INVALID
        ee[k // 2] = INVALID
    return ss, ee


def _compressed_store(rng, T, mode):
    lo = rng.uniform(0, 0.9, (T, 2)).astype(np.float32)
    wh = rng.uniform(0.01, 0.08, (T, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + wh], axis=1).astype(np.float16)
    amps = rng.uniform(-0.2, 1.0, T).astype(np.float32)
    if mode == "int8":
        store, scale = quantize_amps_np(amps)
        dec = store.astype(np.float32) * np.repeat(scale, SCALE_BLOCK)[:T]
    else:
        store, scale = amps.astype(np.float16), None
        dec = store.astype(np.float32)
    return rects, store, scale, dec


def _t(x, dev="cpu"):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)


# ---------------------------------------------------------------------------
# geo_score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [7, 1025, 4096])
@pytest.mark.parametrize("Q", [1, 8])
def test_geo_score_plain_matches_reference(T, Q):
    rng = np.random.default_rng(T * 31 + Q)
    r, a = _rects(rng, T), rng.uniform(0, 1, T).astype(np.float32)
    qr, qa = _rects(rng, Q), rng.uniform(0, 1, Q).astype(np.float32)
    got = pg.geo_score_toeprints(_t(r[None]), _t(a[None]), _t(qr[None]), _t(qa[None]))[0]
    jargs = [jnp.asarray(x) for x in (r, a, qr, qa)]
    np.testing.assert_allclose(got.numpy(), np.asarray(j_geo(*jargs)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_geo_ref(*jargs)), **TOL)


@pytest.mark.parametrize("dtype", [jnp.float16, jnp.bfloat16])
def test_geo_score_narrow_inputs_match_reference(dtype):
    """The reference casts narrow inputs to f32 before scoring; the port's
    wrapper takes f32, so the test hands it the same cast values."""
    rng = np.random.default_rng(9)
    args = [jnp.asarray(_rects(rng, 512)).astype(dtype),
            jnp.asarray(rng.uniform(0, 1, 512).astype(np.float32)).astype(dtype),
            jnp.asarray(_rects(rng, 4)).astype(dtype), jnp.ones((4,), dtype)]
    want = np.asarray(j_geo(*args))
    got = pg.geo_score_toeprints(*[_t(np.asarray(x.astype(jnp.float32))[None]) for x in args])
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def test_geo_score_batch_rows_and_empty_rects():
    """Each batch row is scored against its own query; empty rects score 0."""
    rng = np.random.default_rng(1)
    r = np.stack([_rects(rng, 300) for _ in range(3)])
    r[1, 3] = [1.0, 1.0, 0.0, 0.0]
    a = rng.uniform(0, 1, (3, 300)).astype(np.float32)
    qr = np.stack([_rects(rng, 2) for _ in range(3)])
    qa = rng.uniform(0.5, 1, (3, 2)).astype(np.float32)
    got = pg.geo_score_toeprints(_t(r), _t(a), _t(qr), _t(qa)).numpy()
    for b in range(3):
        want = np.asarray(j_geo(*[jnp.asarray(x[b]) for x in (r, a, qr, qa)]))
        np.testing.assert_allclose(got[b], want, **TOL)
    assert got[1, 3] == 0.0


def test_geo_score_docs_matches_reference():
    rng = np.random.default_rng(2)
    C, R, Q = 33, 3, 2
    rects = _rects(rng, C * R).reshape(C, R, 4)
    amps = rng.uniform(0, 1, (C, R)).astype(np.float32)
    qr, qa = _rects(rng, Q), np.ones((Q,), np.float32)
    got = pg.geo_score_docs(_t(rects[None]), _t(amps[None]), _t(qr[None]), _t(qa[None]))[0]
    jargs = [jnp.asarray(x) for x in (rects, amps, qr, qa)]
    np.testing.assert_allclose(got.numpy(), np.asarray(j_geo_docs(*jargs)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fp_score(*jargs)), **TOL)


@pytest.mark.parametrize("T", [1, 3, 4097])
@pytest.mark.parametrize("n_live", [1, 2, 4, 8])
def test_geo_score_live_slots_bitwise_and_reference(n_live, T):
    """The card's loop (live slots only, slot 0 alone in a row with none)
    gives the all-slot sum's bit patterns, NaN and ±inf included; both are
    within TOL of the reference's kernel in interpret mode, row by row."""
    rng = np.random.default_rng(100 * n_live + T)
    rects, amps, qr, qa = pgr.adversarial_case(rng, T, n_live)
    args = [_t(x) for x in (rects, amps, qr, qa)]
    assert psr.live_slots(*args[2:]).sum(dim=1).tolist() == [n_live, n_live, 0]
    want = pg.geo_score_toeprints(*args)
    got = pgr.geo_score_toeprints_live_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(want[2]).any())
    if T > 7:  # every kind of store row in every query row
        assert bool(torch.isnan(want).any(dim=1).all())
        assert bool(torch.isinf(want[0]).any()) == (n_live >= 2)
    for b in range(3):
        ref = np.asarray(j_geo(*[jnp.asarray(x[b]) for x in (rects, amps, qr, qa)]))
        np.testing.assert_allclose(want[b].numpy(), ref, **TOL)


def test_wrappers_reject_bad_inputs():
    r = torch.zeros((1, 8, 4))
    a = torch.zeros((1, 8))
    q = torch.zeros((1, 2, 4))
    qa = torch.zeros((1, 2))
    with pytest.raises(TypeError):
        pg.geo_score_toeprints(r.double(), a, q, qa)
    with pytest.raises(ValueError):
        pg.geo_score_toeprints(r[:, :, :3], a, q, qa)
    with pytest.raises(ValueError):
        pg.geo_score_toeprints(r.transpose(1, 2).contiguous().transpose(1, 2), a, q, qa)
    with pytest.raises(ValueError):
        pg.geo_score_toeprints(r, a, torch.zeros((1, 9, 4)), torch.zeros((1, 9)))
    tp = torch.zeros((100, 4))
    with pytest.raises(TypeError):
        ps.sweep_score(tp, torch.zeros(100), torch.zeros((1, 2), dtype=torch.int64),
                       torch.zeros((1, 2), dtype=torch.int32), q, qa, 64)


@pytest.mark.parametrize("coords,amps,scale", [
    (torch.float32, torch.float16, False),
    (torch.float32, torch.int8, True),
    (torch.float16, torch.float32, False),
    (torch.float16, torch.int8, False),
    (torch.float32, torch.float32, True),
])
def test_sweep_wrappers_accept_only_built_store_dtypes(coords, amps, scale):
    """Only the stores the compress modes produce (f32/f32, f16/f16, f16 with
    int8 amps and their scale) reach the kernels; any other pairing raises."""
    T = 300
    store = (torch.zeros((T, 4), dtype=coords), torch.zeros(T, dtype=amps))
    sc = torch.ones(3) if scale else None
    ss = torch.zeros((1, 2), dtype=torch.int32)
    q, qa = torch.zeros((1, 2, 4)), torch.zeros((1, 2))
    meta = block_metadata_np(np.zeros((T, 4), np.float32), np.zeros(T, np.float32), 128)
    with pytest.raises((TypeError, ValueError)):
        ps.sweep_score(*store, ss, ss, q, qa, 64, tp_amp_scale=sc)
    with pytest.raises((TypeError, ValueError)):
        ps.sweep_score_pruned(*store, *map(_t, meta), ss, ss, q, qa, 64, 256, 128,
                              tp_amp_scale=sc)


# ---------------------------------------------------------------------------
# sweep_score (unpruned)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,budget,k", [(5000, 2048, 4), (33000, 1024, 8), (2048, 2048, 3)])
def test_sweep_score_plain_matches_reference(T, budget, k):
    rng = np.random.default_rng(T + budget + k)
    rects, amps = _store(rng, T)
    ss, ee = _sweeps(rng, T, budget, k)
    qa = np.ones((2,), np.float32)
    got_s, got_v = ps.sweep_score(_t(rects), _t(amps), _t(ss[None]), _t(ee[None]),
                                  _t(QR2[None]), _t(qa[None]), budget)
    jargs = [jnp.asarray(x) for x in (rects, amps, ss, ee, QR2, qa)]
    for fn in (j_sweep, j_sweep_ref):
        want_s, want_v = fn(*jargs, budget)
        np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
        np.testing.assert_allclose(got_s[0].numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("mode", ["f16", "int8"])
def test_sweep_score_compressed_store_matches_reference(mode):
    rng = np.random.default_rng(41 if mode == "f16" else 43)
    T, budget, k = 5000, 2048, 4
    rects, store, scale, _ = _compressed_store(rng, T, mode)
    ss, ee = _sweeps(rng, T, budget, k)
    qa = np.ones((2,), np.float32)
    got = ps.sweep_score(_t(rects), _t(store), _t(ss[None]), _t(ee[None]), _t(QR2[None]),
                         _t(qa[None]), budget, tp_amp_scale=_t(scale))
    sc = None if scale is None else jnp.asarray(scale)
    jargs = [jnp.asarray(x) for x in (rects, store, ss, ee, QR2, qa)]
    want = j_sweep(*jargs, budget, tp_amp_scale=sc)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]), **TOL)


def test_sweep_score_all_invalid_and_batch_rows():
    rng = np.random.default_rng(9)
    rects, amps = _store(rng, 4000)
    ss = np.full((2, 4), INVALID, np.int32)
    ss[1, :2] = [100, 2500]
    ee = ss.copy()
    ee[1, :2] = [1900, 3999]
    qr = np.stack([np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), QR2[:1]])
    qa = np.ones((2, 1), np.float32)
    got_s, got_v = ps.sweep_score(_t(rects), _t(amps), _t(ss), _t(ee), _t(qr), _t(qa), 1024)
    assert not bool(got_v[0].any()) and float(got_s[0].abs().max()) == 0.0
    want_s, want_v = j_sweep(*[jnp.asarray(x) for x in (rects, amps, ss[1], ee[1], qr[1], qa[1])], 1024)
    np.testing.assert_array_equal(got_v[1].numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_s[1].numpy(), np.asarray(want_s), **TOL)


# ---------------------------------------------------------------------------
# sweep_score_pruned
# ---------------------------------------------------------------------------

def _assert_pruned_equal(got, want, row=0):
    np.testing.assert_array_equal(got[1][row].numpy(), np.asarray(want[1]))  # valid
    np.testing.assert_array_equal(got[2][row].numpy(), np.asarray(want[2]))  # streamed
    assert int(got[3][row]) == int(want[3]) and int(got[4][row]) == int(want[4])
    np.testing.assert_allclose(got[0][row].numpy(), np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("T,budget,k,C,bs,floor", [
    (1024, 1024, 1, 256, 128, 0.0),
    (5000, 2048, 4, 1024, 128, 0.05),
    (33000, 1024, 8, 4096, 512, 0.0),
    (2048, 2048, 3, 512, 1024, 0.01),
])
def test_pruned_plain_matches_reference(T, budget, k, C, bs, floor):
    """Scores, and every per-block skip decision, agree with the Pallas
    kernel (interpret) and with the jnp oracle."""
    rng = np.random.default_rng(T + budget + k + bs)
    rects, amps = _store(rng, T)
    meta = block_metadata_np(rects, amps, bs)
    ss, ee = _sweeps(rng, T, budget, k)
    qa = np.ones((2,), np.float32)
    got = ps.sweep_score_pruned(
        _t(rects), _t(amps), *map(_t, meta), _t(ss[None]), _t(ee[None]),
        _t(QR2[None]), _t(qa[None]), budget, C, bs, floor,
    )
    jargs = [jnp.asarray(x) for x in (rects, amps, *meta, ss, ee, QR2, qa)]
    _assert_pruned_equal(got, j_pruned(*jargs, budget, C, bs, floor))
    _assert_pruned_equal(got, j_pruned_ref(*jargs, budget, C, bs, floor))


@pytest.mark.parametrize("mode,bs,C,floor", [("f16", 128, 1024, 0.0), ("int8", 256, 512, 0.02)])
def test_pruned_compressed_store_matches_reference(mode, bs, C, floor):
    rng = np.random.default_rng(1000 + bs + (1 if mode == "int8" else 0))
    T, budget, k = 5000, 2048, 4
    rects, store, scale, dec = _compressed_store(rng, T, mode)
    meta = block_metadata_np(rects.astype(np.float32), dec, bs)
    ss = np.sort(rng.integers(0, T, k)).astype(np.int32)
    ee = np.minimum(ss + rng.integers(1, budget + 500, k), T).astype(np.int32)
    qa = np.ones((2,), np.float32)
    got = ps.sweep_score_pruned(
        _t(rects), _t(store), *map(_t, meta), _t(ss[None]), _t(ee[None]),
        _t(QR2[None]), _t(qa[None]), budget, C, bs, floor, tp_amp_scale=_t(scale),
    )
    sc = None if scale is None else jnp.asarray(scale)
    jargs = [jnp.asarray(x) for x in (rects, store, *meta, ss, ee, QR2, qa)]
    _assert_pruned_equal(got, j_pruned(*jargs, budget, C, bs, floor, tp_amp_scale=sc))


def test_pruned_batch_rows_keep_their_own_threshold():
    """Rows of one batch (one launch) walk independent θ buffers: each row
    equals the reference run on that query alone."""
    rng = np.random.default_rng(77)
    T, budget, k, C, bs = 6000, 1024, 3, 1024, 128
    rects, amps = _store(rng, T)
    meta = block_metadata_np(rects, amps, bs)
    sw = [_sweeps(rng, T, budget, k) for _ in range(3)]
    ss, ee = np.stack([s for s, _ in sw]), np.stack([e for _, e in sw])
    qr = np.stack([QR2, QR2[::-1], np.array([[0.0, 0.0, 1.0, 1.0], [1, 1, 0, 0]], np.float32)])
    qa = np.array([[1.0, 1.0], [0.5, 1.0], [1.0, 0.0]], np.float32)
    floors = np.array([0.0, 0.01, 0.0], np.float32)
    got = ps.sweep_score_pruned(
        _t(rects), _t(amps), *map(_t, meta), _t(ss), _t(ee), _t(qr), _t(qa),
        budget, C, bs, _t(floors),
    )
    for b in range(3):
        jargs = [jnp.asarray(x) for x in (rects, amps, *meta, ss[b], ee[b], qr[b], qa[b])]
        _assert_pruned_equal(got, j_pruned(*jargs, budget, C, bs, float(floors[b])), row=b)


def _pruned_planar_inputs(rng, T, budget, k, B, bs, floor):
    """The planar pruned sweep's inputs, built as the wrapper builds them,
    over a store with negative amplitudes (their zero-overlap scores are
    −0.0) and faint stretches (their blocks' bounds fall below θ)."""
    rects = _store(rng, T)[0]
    n_chunks = -(-T // 1024)  # faint chunks in the store's second half
    chunk = np.where((rng.random(n_chunks) < 0.7) & (np.arange(n_chunks) >= n_chunks // 2),
                     10.0 ** rng.uniform(-3.0, -1.5, n_chunks), 1.0)
    faint = np.repeat(chunk, 1024)[:T]
    amps = (rng.uniform(-0.05, 1.0, T) * faint).astype(np.float32)
    meta = [_t(x) for x in block_metadata_np(rects, amps, bs)]
    sw = [_sweeps(rng, T, budget, k) for _ in range(B)]
    stride = T // k  # query 0 sweeps the store in order: strong first, then faint
    sw[0] = (np.arange(k, dtype=np.int32) * stride, np.arange(1, k + 1, dtype=np.int32) * stride)
    ss, ee = _t(np.stack([s for s, _ in sw])), _t(np.stack([e for _, e in sw]))
    qr = np.stack([np.concatenate([_rects(rng, 2) * 0.5 + 0.2, QR2]) for _ in range(B)])
    qr[0, 0] = (0.0, 0.0, 1.0, 1.0)  # every toe print overlaps: θ rises above the floor
    qa = rng.uniform(2.0, 20.0, (B, 4)).astype(np.float32)
    qr_p, qa_p = pg.pad_query(_t(qr), _t(qa))
    pad_budget = ps.padded_budget(budget)
    n_tiles = pad_budget // psk.TILE
    _, _, block_starts, bounds = ps.sweep_window_offsets(ss, ee, T)
    ub = ps.block_upper_bounds(*meta, _t(qr), _t(qa))
    win_ub, _ = ps.window_block_bounds(ub, block_starts, bounds, n_tiles, bs)
    floors = torch.full((B,), floor, dtype=torch.float32)
    store = (_t(rects), _t(amps), None)
    return (block_starts, bounds, floors, win_ub.contiguous(), qr_p, qa_p, store, pad_budget)


def _two_pass_model(block_starts, bounds, floor, ub, qr, qa, store, pad_budget, C, bpt):
    """The CUDA design, step for step: pass 1 scores every block whose bound
    beats the floor; the walk decides each tile against θ, folds and takes
    the minimum (over −0-folded bit patterns) only in tiles where a block
    beats θ, and zeroes the blocks the floor let through but θ skipped."""
    B, k = block_starts.shape
    n_tiles, bs = pad_budget // psk.TILE, psk.TILE // bpt
    cb = max(1, -(-C // psk.TILE))
    n_all = k * n_tiles
    live = ub > floor[:, None, None]
    out = torch.where(live.repeat_interleave(bs, dim=2),
                      psr.sweep_score_planar_ref(block_starts, qr, qa, store, pad_budget), 0.0)
    out = out.reshape(B, n_all, bpt, bs)
    e = torch.arange(pad_budget).reshape(n_tiles, psk.TILE)
    rel = bounds.long() - block_starts.long()[..., None] * psk.TILE
    flat_ub, flat_live = ub.reshape(B, n_all, bpt), live.reshape(B, n_all, bpt)
    scored = torch.zeros((B, n_all, bpt), dtype=torch.int32)
    for b in range(B):
        buf = torch.full((cb, psk.TILE), float(floor[b]))
        theta = floor[b]
        for t in range(n_all):
            i, j = divmod(t, n_tiles)
            sb = flat_ub[b, t] > theta
            scored[b, t] = sb.int()
            if sb.any():
                sc = out[b, t].reshape(-1)
                ok = sb.repeat_interleave(bs) & (e[j] >= rel[b, i, 0]) & (e[j] < rel[b, i, 1])
                buf[t % cb] = torch.maximum(buf[t % cb], torch.where(ok, sc, 0.0))
                bits = torch.where(buf == 0.0, 0.0, buf).view(torch.int32)
                theta = bits.min().reshape(1).view(torch.float32)[0]
            out[b, t][~sb & flat_live[b, t]] = 0.0
    return out.reshape(B, k, pad_budget), scored.reshape(B, k, n_tiles * bpt)


@pytest.mark.parametrize("seed,C,floor,bs", [
    (0, 512, 0.0, 128),
    (1, 1000, 0.001, 256),
    (2, 2048, 0.0, 512),
    (3, 3000, 0.002, 1024),
    (4, 3000, 0.0, 128),
    (5, 1024, 0.05, 256),
])
def test_pruned_plain_facts_of_the_two_pass_design(seed, C, floor, bs):
    """What the card's two launches rest on, held on the plain version: a
    block whose bound does not beat the floor is never scored and outputs
    0; a scored block outputs the unpruned scorer's values bitwise; and the
    gated pass + θ walk (tiles that fold nothing skip the minimum) give the
    sequential walk's scores and flags bitwise, over slot reuse (C 3000)."""
    rng = np.random.default_rng(seed)
    bpt = psk.TILE // bs
    args = _pruned_planar_inputs(rng, 20000, 4096, 6, 3, bs, floor)
    block_starts, _, floors, ub, qr, qa, store, pad_budget = args
    out, scored = psr.sweep_score_pruned_planar_ref(*args, C, bpt)
    gated = ~(ub > floors[:, None, None])
    assert gated.any() and scored.bool().any()
    assert not (scored.bool() & gated).any()
    per_pos = scored.bool().repeat_interleave(bs, dim=2)
    unpruned = psr.sweep_score_planar_ref(block_starts, qr, qa, store, pad_budget)
    assert torch.equal(out[~per_pos], torch.zeros_like(out[~per_pos]))
    assert torch.equal(out[per_pos], unpruned[per_pos])
    want_out, want_scored = _two_pass_model(*args, C, bpt)
    assert torch.equal(scored, want_scored)
    assert torch.equal(out.view(torch.int32), want_out.view(torch.int32))


def test_pruned_walk_shared_memory_check():
    """The launcher sizes the walk's shared memory without a card and
    refuses a C whose θ buffer cannot fit one CTA."""
    k, n_tiles, bpt = 8, 129, 8  # the main path's windows at block size 128
    fits = psk.walk_smem_bytes(2048, k, n_tiles, bpt)
    assert fits == (psk.RING + 2) * psk.TILE * 4 + k * n_tiles * (bpt + 2) * 4 + k * 16 + k * n_tiles * bpt
    assert psk.walk_smem_bytes(3000, k, n_tiles, bpt) == fits + psk.TILE * 4
    with pytest.raises(ValueError, match="C=200000"):
        psk.walk_smem_bytes(200_000, k, n_tiles, bpt)
    largest = (psk.SMEM_LIMIT - psk.WALK_STATIC_SMEM - fits) // (psk.TILE * 4) + 2
    psk.walk_smem_bytes(largest * psk.TILE, k, n_tiles, bpt)
    with pytest.raises(ValueError):
        psk.walk_smem_bytes((largest + 1) * psk.TILE, k, n_tiles, bpt)


# ---------------------------------------------------------------------------
# the card's scorer: live query slots
# ---------------------------------------------------------------------------

HUGE = 3.0e38  # a query extent of 2·HUGE overflows f32


def _adversarial_queries(rng):
    """Query slots the card's scorer must skip, or must not: every live-slot
    count from 0 to 8 at random slot positions (the rest zero rects of amp
    0), −0 amps, negative amps with a live slot of infinite area, a query
    whose slots are all zero, and a zero-amp slot whose extent area
    overflows among live ones."""
    qr, qa = [], []
    for n_live in range(9):
        r = np.zeros((8, 4), np.float32)
        a = np.zeros(8, np.float32)
        pos = rng.choice(8, n_live, replace=False)
        r[pos] = _rects(rng, n_live)
        a[pos] = rng.uniform(0.5, 2.0, n_live)
        dead = np.setdiff1d(np.arange(8), pos)
        r[dead[: len(dead) // 2]] = _rects(rng, len(dead) // 2)  # amp 0, real extent
        qr.append(r)
        qa.append(a)
    r = _rects(rng, 8)
    qr.append(r)
    qa.append(np.where(np.arange(8) % 2 == 0, -0.0, rng.uniform(0.5, 2.0, 8)).astype(np.float32))
    r = _rects(rng, 8)
    r[0] = (-HUGE, 0.0, HUGE, 1.0)  # live, area inf: ±inf where it meets a wide rect
    qr.append(r)
    qa.append(rng.uniform(-2.0, 1.0, 8).astype(np.float32))
    r = _rects(rng, 8)
    r[3] = (-HUGE, -HUGE, HUGE, HUGE)  # amp 0 but area inf: live, and NaN where it meets a huge rect
    a = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    a[3] = 0.0
    a[6] = -0.0
    qr.append(r)
    qa.append(a)
    return _t(np.stack(qr)), _t(np.stack(qa))


def _adversarial_store(rng, T, mode):
    """A store with ±inf and huge coordinates among ordinary rects, in the
    dtypes of the three compress modes: (rects, amps, scale)."""
    rects = _store(rng, T)[0]
    bad = rng.choice(T, 40, replace=False)
    rects[bad[:10]] = (-np.inf, -np.inf, np.inf, np.inf)
    rects[bad[10:20]] = (-HUGE, -HUGE, HUGE, HUGE)
    rects[bad[20:30], 0] = np.inf
    rects[bad[30:], 3] = -np.inf
    amps = rng.uniform(-0.2, 1.0, T).astype(np.float32)
    if mode == "f32":
        return _t(rects), _t(amps), None
    if mode == "f16":
        return _t(rects.astype(np.float16)), _t(amps.astype(np.float16)), None
    q8, s8 = quantize_amps_np(amps)
    return _t(rects.astype(np.float16)), _t(q8), _t(s8)


def test_live_slot_rule():
    """Dead: amp ±0 with a finite extent area (inverted or empty rects
    included).  Live: any nonzero amp, or an area that is inf or NaN."""
    qr = _t(np.array([[[0.2, 0.2, 0.6, 0.6], [0.6, 0.6, 0.2, 0.2], [0, 0, 0, 0],
                       [-HUGE, 0, HUGE, 1], [0, 0, np.inf, 1], [0, 0, 1, 1],
                       [np.nan, 0, 1, 1], [0, 0, 1, 1]]], np.float32))
    qa = _t(np.array([[0.0, -0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 1e-30]], np.float32))
    assert psr.live_slots(qr, qa).tolist() == [[False, False, False, True, True, True, True, True]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
def test_live_slot_scorer_equals_all_slot_sum_bitwise(mode, seed):
    """Summing only the live slots (the card's loop) gives the all-slot
    sum's bit patterns, NaN and inf included, over adversarial queries and
    a store with ±inf and huge coordinates."""
    rng = np.random.default_rng(seed)
    T, budget = 3000, 1024
    store = _adversarial_store(rng, T, mode)
    qr, qa = _adversarial_queries(rng)
    pad_budget = ps.padded_budget(budget)
    B = qr.shape[0]
    starts = rng.integers(0, T, (B, 3)) // psk.TILE
    starts[:, 0] = 0  # every query covers the store's head, where the bad rows are too
    block_starts = _t(starts.astype(np.int32))
    want = psr.sweep_score_planar_ref(block_starts, qr, qa, store, pad_budget)
    got = psr.sweep_score_planar_live_ref(block_starts, qr, qa, store, pad_budget)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    live = psr.live_slots(qr, qa)
    assert live.sum(dim=1)[:9].tolist() == list(range(9)) and bool(live[-1, 3])
    assert bool(torch.isnan(want[-1]).any()) and bool(torch.isinf(want).any())
    assert not bool(torch.isnan(want[:9]).any())


def test_cpu_calls_do_not_count_as_launches():
    reset_launch_counts()
    rng = np.random.default_rng(3)
    rects, amps = _store(rng, 2048)
    ps.sweep_score(_t(rects), _t(amps), _t(np.array([[0]], np.int32)),
                   _t(np.array([[900]], np.int32)), _t(QR2[None]),
                   _t(np.ones((1, 2), np.float32)), 1024)
    counts = launch_counts()
    assert {"sweep_score", "geo_score", "sweep_score_pruned", "text_probe",
            "bitmap_and_popcount"} <= set(counts)
    assert not any(counts.values())
