"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version, bitwise, through the public wrappers, and the
launch counters; and GeoServer over the kernel executors against its plain
twins.  Imports no JAX, so it runs on a GPU host without the
reference; without CUDA every test skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.spatial_index import (  # noqa: E402
    SCALE_BLOCK,
    block_metadata_np,
    quantize_amps_np,
)
from repro_torch.core.text_index import build_text_index_np  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bitmap_filter import ops as pbm  # noqa: E402
from repro_torch.kernels.bitmap_filter.ref import bitmap_and_popcount_ref  # noqa: E402
from repro_torch.kernels.geo_score import ops as pg  # noqa: E402
from repro_torch.kernels.geo_score import ref as pgr  # noqa: E402
from repro_torch.kernels.geo_score.ref import geo_score_toeprints_ref  # noqa: E402
from repro_torch.kernels.sweep_score import kernel as psk  # noqa: E402
from repro_torch.kernels.sweep_score import ops as ps  # noqa: E402
from repro_torch.kernels.sweep_score import ref as psr  # noqa: E402
from repro_torch.kernels.text_probe import ops as ptp  # noqa: E402
from repro_torch.kernels.text_probe.ref import text_probe_pruned_ref  # noqa: E402

INVALID = 2**31 - 1
QR2 = np.array([[0.2, 0.2, 0.6, 0.6], [0.5, 0.5, 0.9, 0.9]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, dev):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _rects(rng, n):
    lo = rng.uniform(0, 0.9, (n, 2)).astype(np.float32)
    hi = lo + rng.uniform(0.005, 0.2, (n, 2)).astype(np.float32)
    return np.concatenate([lo, np.minimum(hi, 1.0)], axis=1)


def _store(rng, T, mode):
    lo = rng.uniform(0, 0.9, (T, 2)).astype(np.float32)
    wh = rng.uniform(0.01, 0.08, (T, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + wh], axis=1).astype(np.float32)
    amps = rng.uniform(-0.2, 1.0, T).astype(np.float32)
    if mode == "f32":
        return rects, amps, None, amps
    rects = rects.astype(np.float16)
    if mode == "f16":
        return rects, amps.astype(np.float16), None, amps.astype(np.float16).astype(np.float32)
    store, scale = quantize_amps_np(amps)
    return rects, store, scale, store.astype(np.float32) * np.repeat(scale, SCALE_BLOCK)[:T]


def _sweeps(rng, T, budget, k):
    ss = np.sort(rng.integers(0, T, k)).astype(np.int32)
    ee = np.minimum(ss + rng.integers(1, budget + 500, k), T).astype(np.int32)
    ss[k // 2] = INVALID
    ee[k // 2] = INVALID
    return ss, ee


def _at_odd_offset(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts one 4-byte element
    into its buffer (not 16-byte aligned)."""
    flat = x.reshape(-1).view(torch.int32)
    buf = torch.empty(flat.numel() + 1, dtype=torch.int32, device=x.device)
    buf[1:] = flat
    return buf[1:].view(x.dtype).view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 3, 4097])
@pytest.mark.parametrize("n_live", [1, 2, 4, 8])
def test_geo_score_kernel_bitwise_on_card(cuda, n_live, T):
    """The kernel's bit patterns (NaN and ±inf included) equal the plain
    version's on ``ref.adversarial_case`` (1, 2, 4, 8 live slots, a
    zero-amp slot of overflowing area, a row with none; NaN, ±inf and huge
    store coordinates, −0 amps; B = 3, so rows start off 16-byte
    alignment) and on ordinary rects with ``n_live`` query rects (read
    unpadded); and from rects, amps or query rects at an odd storage offset
    (the scalar path)."""
    rng = np.random.default_rng(5 + 10 * n_live + T)
    ordinary = (np.stack([_rects(rng, T) for _ in range(3)]),
                rng.uniform(0, 1, (3, T)).astype(np.float32),
                np.stack([_rects(rng, n_live) for _ in range(3)]),
                rng.uniform(0, 1, (3, n_live)).astype(np.float32))
    for case in (pgr.adversarial_case(rng, T, n_live), ordinary):
        args = [_t(x, cuda) for x in case]
        reset_launch_counts()
        got = pg.geo_score_toeprints(*args)
        assert launch_counts()["geo_score"] == 1
        want = geo_score_toeprints_ref(*args[:2], *pg.pad_query(*args[2:]))
        odd = [pg.geo_score_toeprints(_at_odd_offset(args[0]), _at_odd_offset(args[1]), *args[2:]),
               pg.geo_score_toeprints(args[0], _at_odd_offset(args[1]), *args[2:]),
               pg.geo_score_toeprints(*args[:2], _at_odd_offset(args[2]), args[3])]
        torch.cuda.synchronize()
        for x in (got, *odd):
            assert torch.equal(x.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
@pytest.mark.parametrize("bs", [128, 256, 512, 1024])
def test_sweep_kernels_bitwise_on_card(cuda, mode, bs):
    rng = np.random.default_rng(bs)
    T, budget = 20000, 2048
    rects, store, scale, dec = _store(rng, T, mode)
    meta = [_t(x, cuda) for x in block_metadata_np(rects.astype(np.float32), dec, bs)]
    sw = [_sweeps(rng, T, budget, 4) for _ in range(3)]
    q = [_t(x, cuda) for x in (np.stack([s for s, _ in sw]), np.stack([e for _, e in sw]),
                              np.stack([QR2] * 3), np.ones((3, 2), np.float32))]
    base = [_t(x, cuda) for x in (rects, store)]
    sc = _t(scale, cuda)
    reset_launch_counts()
    got = ps.sweep_score(*base, *q, budget, tp_amp_scale=sc)
    got_p = ps.sweep_score_pruned(*base, *meta, *q, budget, 1024, bs, 0.001, tp_amp_scale=sc)
    counts = launch_counts()
    assert counts.pop("sweep_score") == 1 and counts.pop("sweep_score_pruned") == 1
    assert not any(counts.values())
    want = psr.sweep_score_ref(*base, *q, budget, tp_amp_scale=sc)
    want_p = psr.sweep_score_pruned_ref(*base, *meta, *q, budget, 1024, bs, 0.001, tp_amp_scale=sc)
    torch.cuda.synchronize()
    for x, y in zip((*got, *got_p), (*want, *want_p)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("C,mode", [(1024, "f32"), (2048, "f16"), (3000, "int8"), (5000, "f32")])
@pytest.mark.parametrize("floor,bs", [(0.0, 128), (0.001, 256), (0.05, 512)])
def test_pruned_sweep_two_passes_bitwise_on_card(cuda, C, mode, floor, bs):
    """The gated score pass and the θ walk against the sequential plain
    walk: 200 queries (more CTAs than SMs), budget 1024 (two tiles per
    window), θ buffers of 1-3 tiles held in registers and of 5 in shared
    memory, with slot reuse, some queries over the whole domain and faint
    store stretches, so θ rises past the floor and some blocks are scored
    in pass 1 only to be skipped by the walk."""
    rng = np.random.default_rng(C + bs)
    T, budget, B, k = 50000, 1024, 200, 4
    rects, store, scale, dec = _store(rng, T, mode)
    faint = np.repeat(np.where(rng.random(-(-T // 1024)) < 0.5, 0.01, 1.0), 1024)[:T]
    if mode == "int8":
        store, scale = quantize_amps_np(dec * faint)
        dec = store.astype(np.float32) * np.repeat(scale, SCALE_BLOCK)[:T]
    else:
        store = (store.astype(np.float32) * faint).astype(store.dtype)
        dec = store.astype(np.float32)
    meta = [_t(x, cuda) for x in block_metadata_np(rects.astype(np.float32), dec, bs)]
    sw = [_sweeps(rng, T, budget, k) for _ in range(B)]
    qr = np.stack([np.concatenate([_rects(rng, 2), QR2]) for _ in range(B)])
    qr[::3, 0] = (0.0, 0.0, 1.0, 1.0)
    qa = rng.uniform(2.0, 20.0, (B, 4)).astype(np.float32)
    q = [_t(x, cuda) for x in (np.stack([s for s, _ in sw]), np.stack([e for _, e in sw]), qr, qa)]
    base = [_t(x, cuda) for x in (rects, store)]
    sc = _t(scale, cuda)
    args = (*base, *meta, *q, budget, C, bs, floor)
    reset_launch_counts()
    got = ps.sweep_score_pruned(*args, tp_amp_scale=sc)
    counts = launch_counts()
    assert counts.pop("sweep_score_pruned") == 1 and not any(counts.values())
    want = psr.sweep_score_pruned_ref(*args, tp_amp_scale=sc)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for x, y in zip(got[1:], want[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)


HUGE = 3.0e38  # a query extent of 2·HUGE overflows f32


def _bits(x):
    """Floats as their bit patterns (NaN equals itself), others as they are."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _slot_patterns(rng, overflow):
    """Queries with every live-slot count from 0 to 8 at random slot
    positions (dead slots: zero rects, or real rects of amp 0 or −0), one
    with negative amps and a live slot of infinite area, and with
    ``overflow`` one whose zero-amp slot has an extent area that overflows
    (NaN where it meets a huge store rect)."""
    qr, qa = [], []
    for n_live in range(9):
        r, a = np.zeros((8, 4), np.float32), np.zeros(8, np.float32)
        pos = rng.choice(8, n_live, replace=False)
        r[pos] = _rects(rng, n_live)
        a[pos] = rng.uniform(0.5, 2.0, n_live)
        dead = np.setdiff1d(np.arange(8), pos)
        r[dead[::2]] = _rects(rng, len(dead[::2]))
        a[dead[1::2]] = -0.0
        qr.append(r)
        qa.append(a)
    r = _rects(rng, 8)
    r[0] = (-HUGE, 0.0, HUGE, 1.0)  # live, area inf: ±inf where it meets a wide rect
    qr.append(r)
    qa.append(rng.uniform(-2.0, 1.0, 8).astype(np.float32))
    if overflow:
        r = _rects(rng, 8)
        r[5] = (-HUGE, -HUGE, HUGE, HUGE)
        a = rng.uniform(0.5, 2.0, 8).astype(np.float32)
        a[5] = 0.0
        qr.append(r)
        qa.append(a)
    return np.stack(qr), np.stack(qa)


def _scorer_case(rng, mode, T, adversarial):
    """Store (±inf and huge rects when ``adversarial``), queries of every
    live-slot pattern, and window origins (TILE units): heavy overlap on a
    few tiles, several INVALID windows at origin 0, windows running past
    the store's end and one wholly past it."""
    rects, store, scale, dec = _store(rng, T, mode)
    if adversarial:
        bad = rng.choice(T, 40, replace=False)
        rects[bad[:20]] = (-np.inf, -np.inf, np.inf, np.inf)
        with np.errstate(over="ignore"):  # f16 rounds HUGE to inf
            rects[bad[20:]] = (-HUGE, -HUGE, HUGE, HUGE)
    qr, qa = _slot_patterns(rng, adversarial)
    B, k = qr.shape[0], 6
    n_store = -(-T // 1024)
    starts = rng.integers(0, 3, (B, k))
    starts[:, 1] = 0
    starts[::3, 2] = 0
    starts[:, 3] = rng.integers(0, n_store, B)
    starts[::2, 4] = n_store - 1
    starts[1, 5] = n_store + 3
    return rects, store, scale, dec, qr, qa, starts.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_major_scorer_bitwise_on_card(cuda, mode, seed):
    """The store-tile-major scorer against the all-slot plain version, as
    bit patterns (NaN and ±inf included): every live-slot pattern 0-8 and
    the overflow slot, over heavily overlapping windows, INVALID windows at
    origin 0, windows past the store's end and a partial last tile."""
    rng = np.random.default_rng(7 + seed)
    T, budget = 30000 + 300, 4096
    rects, store, scale, _, qr, qa, starts = _scorer_case(rng, mode, T, True)
    qr_t, qa_t = _t(qr, cuda), _t(qa, cuda)
    tstore = (_t(rects, cuda), _t(store, cuda), _t(scale, cuda))
    block_starts = _t(starts, cuda)
    pad_budget = ps.padded_budget(budget)
    got = psk.sweep_score_planar(block_starts, qr_t, qa_t, tstore, pad_budget)
    want = psr.sweep_score_planar_ref(block_starts, qr_t, qa_t, tstore, pad_budget)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
@pytest.mark.parametrize("bs", [128, 1024])
def test_tile_major_gated_pass_bitwise_on_card(cuda, mode, bs):
    """The pruned sweep's pass 1 (the same scorer, gated by the floor per
    metadata block) alone, as bit patterns, on the adversarial store; then
    the whole pruned sweep, both launches, on a finite store over the same
    window and slot patterns."""
    rng = np.random.default_rng(bs + len(mode))
    T, budget = 30000 + 300, 4096
    bpt = 1024 // bs
    rects, store, scale, _, qr, qa, starts = _scorer_case(rng, mode, T, True)
    qr_t, qa_t = _t(qr, cuda), _t(qa, cuda)
    tstore = (_t(rects, cuda), _t(store, cuda), _t(scale, cuda))
    block_starts = _t(starts, cuda)
    B, k = starts.shape
    pad_budget = ps.padded_budget(budget)
    ub = _t(rng.uniform(0, 1, (B, k, pad_budget // 1024 * bpt)).astype(np.float32), cuda)
    floor = _t(rng.uniform(0.2, 0.6, B).astype(np.float32), cuda)
    bounds = _t(np.zeros((B, k, 2), np.int32), cuda)
    outs = (torch.empty((B, k, pad_budget), dtype=torch.float32, device=cuda),
            torch.zeros((B, k, ub.shape[2]), dtype=torch.int32, device=cuda))
    psk.sweep_score_pruned_planar(block_starts, bounds, floor, ub, qr_t, qa_t, tstore,
                                  pad_budget, 1024, bpt, passes=1, outputs=outs)
    gate = (ub > floor[:, None, None]).repeat_interleave(bs, dim=2)
    want = torch.where(gate, psr.sweep_score_planar_ref(block_starts, qr_t, qa_t, tstore,
                                                         pad_budget), 0.0)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), want.view(torch.int32))

    rects, store, scale, dec, qr, qa, starts = _scorer_case(rng, mode, T, False)
    meta = [_t(x, cuda) for x in block_metadata_np(rects.astype(np.float32), dec, bs)]
    ss = (starts.astype(np.int64) * 1024 + rng.integers(0, 1024, starts.shape)).astype(np.int32)
    ee = np.minimum(ss.astype(np.int64) + rng.integers(1, budget, ss.shape), T).astype(np.int32)
    ss[:, 1], ee[:, 1] = INVALID, INVALID
    ee = np.maximum(ee, np.where(ss == INVALID, ee, ss))
    args = (_t(rects, cuda), _t(store, cuda), *meta, _t(ss, cuda), _t(ee, cuda), _t(qr, cuda),
            _t(qa, cuda), budget, 2048, bs, 0.0)
    reset_launch_counts()
    got = ps.sweep_score_pruned(*args, tp_amp_scale=_t(scale, cuda))
    got_u = ps.sweep_score(*args[:2], *args[5:9], budget, tp_amp_scale=_t(scale, cuda))
    counts = launch_counts()
    assert counts.pop("sweep_score_pruned") == 1 and counts.pop("sweep_score") == 1
    assert not any(counts.values())
    want = psr.sweep_score_pruned_ref(*args, tp_amp_scale=_t(scale, cuda))
    want_u = psr.sweep_score_ref(*args[:2], *args[5:9], budget, tp_amp_scale=_t(scale, cuda))
    torch.cuda.synchronize()
    for x, y in zip((*got, *got_u), (*want, *want_u)):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    assert int(got[3].sum()) > 0


def _text_store(rng, n_docs, n_terms, dtype, layout):
    """A skewed corpus (term 0 in every doc), its text index and the
    per-term block CSR, on the CPU."""
    docs = [np.concatenate([[0], rng.integers(1, n_terms, int(rng.integers(1, 40)))]).astype(np.int32)
            for _ in range(n_docs)]
    return build_text_index_np(docs, n_terms, n_bitmap_terms=8, impact_dtype=dtype,
                               layout=layout, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, np.float16])
@pytest.mark.parametrize("layout", ["docid", "impact"])
@pytest.mark.parametrize("C,floor", [(2048, 0.0), (1000, 0.0), (1000, 0.4), (256, 0.1)])
def test_text_probe_kernel_bitwise_on_card(cuda, dtype, layout, C, floor):
    """opt, flags and block counts equal the plain version bitwise — the
    buffer-minimum θ (C a multiple of 1024) and the radix select (any
    other C), with and without the monotone cut."""
    rng = np.random.default_rng(C + (7 if dtype else 0) + (3 if layout == "impact" else 0))
    text = _text_store(rng, 6000, 300, dtype, layout)
    bto = text.blk_term_off.numpy()
    terms = np.array([0, 1, 2, 5, 299, 17], np.int64)
    b0 = bto[terms].astype(np.int32)
    nb = (bto[terms + 1] - bto[terms]).astype(np.int32)
    nb[-1] = 0  # a query with no real term
    rest = rng.uniform(0.0, 2.0, len(terms)).astype(np.float32)
    tmax = float(text.blk_max_impact.max())
    floors = (floor * (tmax + rest)).astype(np.float32)
    cols = [x.to(cuda) for x in (text.impacts, text.blk_pos, text.blk_max_impact, text.blk_len)]
    q = [_t(x, cuda) for x in (b0, nb)]
    kw = dict(max_candidates=C, max_term_blocks=text.max_term_blocks, monotone=layout == "impact")
    reset_launch_counts()
    got = ptp.text_probe_pruned(*cols, *q, 1.0, _t(rest, cuda), _t(floors, cuda), **kw)
    assert launch_counts()["text_probe"] == 1
    want = text_probe_pruned_ref(*cols, *q, 1.0, _t(rest, cuda), _t(floors, cuda), **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 5, 32768, 32768 + 3, 32768 + 77])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 9])
def test_bitmap_kernel_bitwise_on_card(cuda, d, W):
    """anded and counts equal the plain version's and numpy's; the
    count-only prefilter equals ``counts.sum()`` in one launch; the same
    from a row block at an odd word offset (the kernel's scalar loads)."""
    rng = np.random.default_rng(d * 100003 + W)
    rows = rng.integers(0, 2**32, (d, W), dtype=np.uint64).astype(np.uint32)
    rows[:, :100] = 0xFFFFFFFF
    bm = _t(rows, cuda)
    want = bitmap_and_popcount_ref(bm)
    np.testing.assert_array_equal(want[0].cpu().numpy(), np.bitwise_and.reduce(rows, axis=0))
    for x in (bm, _at_odd_offset(bm)):
        reset_launch_counts()
        anded, counts = pbm.bitmap_and_popcount(x)
        total = pbm.conjunction_block_prefilter(x)
        assert launch_counts()["bitmap_and_popcount"] == 2
        torch.cuda.synchronize()
        assert anded.dtype == torch.uint32 and counts.dtype == torch.int32
        assert torch.equal(anded.view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(counts, want[1])
        assert total.dtype == torch.int64 and total.shape == ()
        assert int(total) == int(want[1].sum())
    # the running sum is zero again after each launch: repeated calls agree
    assert [int(pbm.conjunction_block_prefilter(bm)) for _ in range(3)] == [int(want[1].sum())] * 3


@pytest.mark.cuda
def test_new_wrappers_reject_bad_inputs_on_card(cuda):
    """Only f32/f16 impacts reach the text_probe kernel; tensors split
    across the CPU and the card are refused by both new wrappers; the
    bitmap wrappers refuse other dtypes, strides and empty rows or words;
    geo_score refuses more than Q_MAX query slots."""
    rng = np.random.default_rng(0)
    text = _text_store(rng, 500, 50, None, "docid")
    cols = [x.to(cuda) for x in (text.impacts, text.blk_pos, text.blk_max_impact, text.blk_len)]
    q = [_t(np.zeros(2, np.int32), cuda), _t(np.ones(2, np.int32), cuda)]
    rest = _t(np.zeros(2, np.float32), cuda)
    kw = dict(max_candidates=1024, max_term_blocks=text.max_term_blocks)
    with pytest.raises(TypeError):
        ptp.text_probe_pruned(cols[0].double(), *cols[1:], *q, 1.0, rest, **kw)
    with pytest.raises(TypeError):
        ptp.text_probe_pruned(cols[0].to(torch.bfloat16), *cols[1:], *q, 1.0, rest, **kw)
    with pytest.raises(ValueError):
        ptp.text_probe_pruned(cols[0].cpu(), *cols[1:], *q, 1.0, rest, **kw)
    with pytest.raises(ValueError):
        ptp.text_probe_pruned(*cols, q[0].cpu(), q[1], 1.0, rest, **kw)
    bm = _t(np.ones((2, 64), np.uint32), cuda)
    for fn in (pbm.bitmap_and_popcount, pbm.conjunction_block_prefilter):
        with pytest.raises(TypeError):
            fn(bm.view(torch.int32))
        with pytest.raises(ValueError):
            fn(bm[:, ::2])
        with pytest.raises(ValueError):
            fn(bm[:, :0])
        with pytest.raises(ValueError):
            fn(bm[:0])
    # the geo_score kernel reads at most Q_MAX query slots
    r, a = _t(np.zeros((1, 8, 4), np.float32), cuda), _t(np.zeros((1, 8), np.float32), cuda)
    with pytest.raises(ValueError):
        pg.geo_score_toeprints(r, a, _t(np.zeros((1, 9, 4), np.float32), cuda),
                               _t(np.ones((1, 9), np.float32), cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,prune", [("k_sweep", False), ("k_sweep", True),
                                             ("auto", True)])
def test_geo_server_kernel_executor_equals_plain_on_card(cuda, algorithm, prune):
    """Open-loop replay with an injected service time is deterministic, so
    the server over the kernel executor (fused K-SWEEP, pruned K-SWEEP, or
    auto with pruning: the text_probe and pruned sweep kernels) and over its
    plain twin (same engine, ``fused=False``) give equal reports and
    bitwise equal per-query results; only the kernel side launches."""
    import dataclasses

    from repro_torch.core import GeoSearchEngine, QueryBudgets
    from repro_torch.corpus import make_corpus, make_mixture_trace, make_zipf_trace, stamp_arrivals
    from repro_torch.serving import DeadlineBatcher, GeoServer, SingleDeviceExecutor, make_cache

    corpus = make_corpus(n_docs=3000, n_terms=400, seed=5)
    budgets = QueryBudgets(max_candidates=512, max_tiles=256, k_sweeps=4, sweep_budget=512,
                           prune=prune)
    eng = GeoSearchEngine.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                                corpus.n_terms, pagerank=corpus.pagerank, budgets=budgets)
    trace = make_zipf_trace(corpus, n_queries=96, pool_size=24, seed=6)
    if algorithm == "auto":
        trace = make_mixture_trace(corpus, n_queries=64, seed=7) + trace[:64]
    trace = stamp_arrivals(trace, "poisson", rate_qps=800.0, seed=3)
    reports, counts = [], []
    for fused in (True, False):
        server = GeoServer(SingleDeviceExecutor(eng, algorithm, fused=fused),
                           cache=make_cache("landlord", 32),
                           batcher=DeadlineBatcher(max_batch=8, max_wait_s=2e-3),
                           n_workers=2, coalesce=True)
        reset_launch_counts()
        reports.append(server.run_trace(trace, arrival="poisson", collect_results=True,
                                        service_time=lambda raw: 1e-3 + 1e-4 * raw.n_real))
        torch.cuda.synchronize()
        counts.append(launch_counts())
    kern, plain = reports
    for f in dataclasses.fields(kern):
        a, b = getattr(kern, f.name), getattr(plain, f.name)
        if f.name == "results":
            for x, y in zip(a, b):
                assert np.array_equal(x.ids, y.ids)
                assert np.array_equal(x.scores.view(np.uint32), y.scores.view(np.uint32))
        elif f.name in ("plan_queries", "plan_latencies_s", "plan_stats"):
            # the twins' labels differ only by "+fused"
            assert {k.replace("+fused", ""): v for k, v in a.items()} == b, f.name
        else:
            assert a == b, f.name
    assert sum(counts[1].values()) == 0
    used = {"sweep_score_pruned" if prune else "sweep_score"} if algorithm == "k_sweep" else {
        k for k, label in (("sweep_score_pruned", "k_sweep+prune+fused"),
                           ("text_probe", "text_first+prune+fused")) if label in kern.plan_queries}
    assert used and all(counts[0][k] > 0 for k in used), counts[0]
    assert all(n == 0 for k, n in counts[0].items() if k not in used), counts[0]


def _narrow_batch(batch, i, n):
    """``n`` copies of query ``i`` of ``batch``, its footprint cut to the
    middle fifth of its first rect (the other rect slots padding)."""
    r0 = batch.rects[i, 0]
    c, h = (r0[:2] + r0[2:]) / 2, (r0[2:] - r0[:2]) / 10
    rects = torch.tensor([1.0, 1.0, 0.0, 0.0]).repeat(n, batch.rects.shape[1], 1)
    rects[:, 0, :2], rects[:, 0, 2:] = c - h, c + h
    amps = torch.zeros((n, batch.amps.shape[1]))
    amps[:, 0] = 1.0
    return type(batch)(batch.terms[i : i + 1].repeat(n, 1), rects, amps)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,prune,fused_kw", [
    ("k_sweep", True, dict(fused=True)),
    ("k_sweep", False, dict(fused=True)),
    ("k_sweep", False, dict(use_pallas=True)),
    ("text_first", True, dict(fused=True)),
])
def test_sharded_executor_on_card_equals_plain_and_cpu(cuda, algorithm, prune, fused_kw):
    """The footprint-routed sharded executor on the card, on a trace batch
    and on a narrow batch that skips shards: its kernel variant equals the
    plain twin over the same shard engines (ids, scores and every counter
    bitwise; the kernel launched once per visited shard) and the same
    executor built on the CPU (ids and counters exactly, scores within
    1e-5: the card and the CPU may order a reduction differently)."""
    import dataclasses

    from repro_torch.core import QueryBudgets, RegionRangePartitioner
    from repro_torch.corpus import make_corpus, make_zipf_trace, pad_trace_batch
    from repro_torch.serving import ShardedExecutor, make_executor

    corpus = make_corpus(n_docs=3000, n_terms=400, seed=5)
    q = pad_trace_batch(make_zipf_trace(corpus, n_queries=32, pool_size=16, seed=6))
    budgets = QueryBudgets(max_candidates=512, max_tiles=256, k_sweeps=4, sweep_budget=512,
                           prune=prune, early_termination=not prune)
    kw = dict(algorithm=algorithm, n_shards=4, partitioner=RegionRangePartitioner(),
              routing="footprint", budgets=budgets, **fused_kw)
    card = make_executor("sharded", corpus, **kw)
    cpu = make_executor("sharded", corpus, device="cpu", **kw)
    twin = ShardedExecutor(card.engines, card.global_ids, algorithm, routing="footprint")
    kernel = {"text_first": "text_probe"}.get(
        algorithm, "geo_score" if "use_pallas" in fused_kw else
        "sweep_score_pruned" if prune else "sweep_score")
    # the trace, then copies of its first query with the footprint cut to a
    # fifth, which footprint routing sends to fewer than all 4 shards
    for batch, narrow in ((q, False), (_narrow_batch(q, 0, 32), True)):
        reset_launch_counts()
        got = card.run(batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        visited = int(got.stats["shards_visited"])
        assert 1 <= visited < 4 if narrow else visited >= 1
        assert counts == {k: (visited if k == kernel else 0) for k in counts}
        plain, on_cpu = twin.run(batch), cpu.run(batch)
        for want, exact_scores in ((plain, True), (on_cpu, False)):
            assert np.array_equal(got.ids, want.ids)
            if exact_scores:
                assert got.scores.tobytes() == want.scores.tobytes()
            else:
                np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)
            assert set(got.stats) == set(want.stats)
            for k in want.stats:
                assert np.array_equal(got.stats[k], want.stats[k]), k
    assert dataclasses.asdict(card.engines[0].budgets) == dataclasses.asdict(
        cpu.engines[0].budgets)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["k_sweep", "text_first"])
def test_mesh_executor_on_card_equals_plain_and_cpu(cuda, algorithm):
    """The mesh step on a (2, 2) data × model mesh on the card: pruned and
    fused, it equals its plain twin (ids, scores and counters bitwise; every
    shard launches the kernel once per query slice) and the same step on
    the CPU (ids and counters exactly, scores within 1e-5)."""
    from repro_torch.core import QueryBudgets, RegionRangePartitioner, make_mesh
    from repro_torch.corpus import make_corpus, make_zipf_trace, pad_trace_batch
    from repro_torch.serving import make_executor

    corpus = make_corpus(n_docs=3000, n_terms=400, seed=5)
    q = pad_trace_batch(make_zipf_trace(corpus, n_queries=32, pool_size=16, seed=6))
    budgets = QueryBudgets(max_candidates=512, max_tiles=256, k_sweeps=4, sweep_budget=512,
                           prune=True)
    runs = {}
    for name, fused, dev in (("kernel", True, "cuda"), ("plain", False, "cuda"),
                             ("cpu", True, "cpu")):
        ex = make_executor("mesh", corpus, algorithm=algorithm,
                           mesh=make_mesh((2, 2), ("data", "model"), device=dev),
                           partitioner=RegionRangePartitioner(), routing="footprint",
                           budgets=budgets, fused=fused)
        reset_launch_counts()
        runs[name] = ex.run(q)
        torch.cuda.synchronize()
        kernel = "sweep_score_pruned" if algorithm == "k_sweep" else "text_probe"
        want_n = 4 if name == "kernel" else 0  # 2 shards x 2 query slices
        assert launch_counts() == {k: (want_n if k == kernel else 0) for k in launch_counts()}
    got = runs["kernel"]
    assert torch.equal(got.ids, runs["plain"].ids) and torch.equal(got.scores, runs["plain"].scores)
    assert torch.equal(got.ids.cpu(), runs["cpu"].ids)
    assert torch.allclose(got.scores.cpu(), runs["cpu"].scores, rtol=1e-5, atol=1e-6)
    for other in ("plain", "cpu"):
        assert list(got.stats) == list(runs[other].stats)
        for k in got.stats:
            assert np.array_equal(got.stats[k], runs[other].stats[k]), (other, k)
    assert got.stats["shards_visited"].shape == (2,)


@pytest.mark.cuda
def test_geo_server_telemetry_on_card_changes_nothing(cuda):
    """A ``Telemetry()`` attached to a single-executor ``GeoServer`` on the
    card (auto, pruned, fused: the text_probe and pruned sweep kernels)
    leaves ids, scores, stats and every report field equal to the
    telemetry-off run; its trace validates and its stage sums are the
    report's lists."""
    import dataclasses

    from repro_torch.core import QueryBudgets
    from repro_torch.corpus import make_corpus, make_mixture_trace, stamp_arrivals
    from repro_torch.obs import Telemetry, validate_trace
    from repro_torch.serving import DeadlineBatcher, GeoServer, make_cache, make_executor

    corpus = make_corpus(n_docs=3000, n_terms=400, seed=5)
    budgets = QueryBudgets(max_candidates=512, max_tiles=256, k_sweeps=4, sweep_budget=512,
                           prune=True)
    trace = stamp_arrivals(make_mixture_trace(corpus, n_queries=96, seed=7), "poisson",
                           rate_qps=800.0, seed=3)
    reports, tels = [], []
    for tel in (None, Telemetry()):
        ex = make_executor("single", corpus, algorithm="auto", budgets=budgets, fused=True)
        server = GeoServer(ex, cache=make_cache("landlord", 32),
                           batcher=DeadlineBatcher(max_batch=8, max_wait_s=2e-3),
                           n_workers=2, coalesce=True, telemetry=tel)
        reports.append(server.run_trace(trace, arrival="poisson", collect_results=True,
                                        service_time=lambda raw: 1e-3 + 1e-4 * raw.n_real))
        tels.append(tel)
    off, on = reports
    for f in dataclasses.fields(off):
        a, b = getattr(on, f.name), getattr(off, f.name)
        if f.name == "results":
            for x, y in zip(a, b):
                assert np.array_equal(x.ids, y.ids)
                assert np.array_equal(x.scores.view(np.uint32), y.scores.view(np.uint32))
        else:
            assert a == b, f.name
    tel = tels[1]
    assert tel.tracer.stage_sums() == (on.latencies_s, on.batch_wait_s, on.queue_wait_s,
                                       on.service_s)
    assert validate_trace(tel.tracer.to_trace_events()) == []
    assert len(tel.audit.joined) == len(tel.audit.records) > 0


@pytest.mark.cuda
def test_serve_cli_on_card_writes_valid_exports(cuda, tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve`` at 20000 docs on the card
    (its default device), pruned and fused under the planner, open loop:
    exits normally and writes the four exports, the trace valid."""
    import json

    from repro_torch.launch import serve
    from repro_torch.obs import validate_trace

    monkeypatch.chdir(tmp_path)
    serve.main(["--n-docs", "20000", "--queries", "512", "--trace", "zipf", "--algorithm",
                "auto", "--prune", "--fused", "--arrival", "poisson", "--coalesce",
                "--trace-out", "T.json", "--metrics-out", "M.prom", "--audit-out", "A.jsonl",
                "--events-out", "E.jsonl"])
    out = capsys.readouterr().out
    assert "recall@10 vs oracle = " in out and "queries=512" in out
    for name in ("T.json", "M.prom", "A.jsonl", "E.jsonl"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert validate_trace(json.loads((tmp_path / "T.json").read_text())) == []
    assert "# TYPE server_queries_total counter" in (tmp_path / "M.prom").read_text()


def _geo_candidates(dev, n, side, q_rects, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lo = torch.rand((n, 4, 2), generator=g, device=dev) * 0.9
    return {"cand_rects": torch.cat([lo, lo + side], dim=2),
            "cand_amps": torch.rand((n, 4), generator=g, device=dev) + 0.5,
            "q_rects": torch.tensor(q_rects, dtype=torch.float32, device=dev),
            "q_amps": torch.tensor([1.0, 0.7], device=dev), "weight": 5.0}


def _plain_geo_docs(geo):
    """Per-candidate geo scores by the kernel's plain version."""
    n, r, _ = geo["cand_rects"].shape
    qr, qa = pg.pad_query(geo["q_rects"][None], geo["q_amps"][None])
    flat = geo_score_toeprints_ref(geo["cand_rects"].reshape(1, n * r, 4),
                                   geo["cand_amps"].reshape(1, n * r), qr, qa)
    return flat.reshape(n, r).sum(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3000, 20000])
def test_geo_score_docs_kernel_bitwise_on_card(cuda, n):
    """The retrieval's geo scores: one kernel launch per call, bitwise
    equal to the plain version."""
    geo = _geo_candidates(cuda, n, 0.08, [[0.3, 0.3, 0.5, 0.5], [0.6, 0.6, 0.75, 0.75]])
    reset_launch_counts()
    got = pg.geo_score_docs(geo["cand_rects"][None], geo["cand_amps"][None],
                            geo["q_rects"][None], geo["q_amps"][None])[0]
    assert launch_counts()["geo_score"] == 1
    assert torch.equal(got, _plain_geo_docs(geo))


@pytest.mark.cuda
@pytest.mark.parametrize("side", [0.08, 0.01])
def test_two_tower_geo_retrieval_kernel_equals_plain_on_card(cuda, side):
    """Two-tower retrieval with the geo blend through the kernel equals the
    same retrieval through the plain geo path (ids and scores bitwise); the
    small footprints leave fewer matches than top_k, so the −inf picks (the
    lowest positions outside the footprint) are compared too."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.ranking import select_top
    from repro_torch.data.recsys import two_tower_batch
    from repro_torch.models import recsys as rec

    cfg = get_arch("two-tower-retrieval").smoke_config
    params = cfg.init(0, cuda)
    user = two_tower_batch(1, cfg.n_users, cfg.n_items, cfg.n_user_fields, cfg.n_item_fields,
                           cfg.field_vocab, cfg.hist_len, seed=4, device=cuda)
    n, top_k = 4000, 100
    cand_ids = (torch.arange(n, device=cuda) % cfg.n_items).to(torch.int32)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    cand_fields = torch.randint(0, cfg.field_vocab, (n, cfg.n_item_fields), generator=g,
                                device=cuda, dtype=torch.int32)
    geo = _geo_candidates(cuda, n, side, [[0.3, 0.3, 0.34, 0.34], [0.6, 0.6, 0.62, 0.62]])
    reset_launch_counts()
    vals, ids = rec.two_tower_score_candidates(cfg, params, user, cand_ids, cand_fields,
                                               top_k, geo)
    assert launch_counts()["geo_score"] == 1
    g = _plain_geo_docs(geo)
    scores = rec.two_tower_user(cfg, params, user) @ rec.two_tower_item(
        cfg, params, cand_ids, cand_fields).T
    want_vals, want_ids = select_top(rec.geo_blend(scores, g, geo["weight"]), top_k)
    assert torch.equal(vals, want_vals) and torch.equal(ids, want_ids)
    n_match = int((g > 0).sum())
    assert int(torch.isneginf(vals).sum()) == max(0, top_k - n_match)
    if side == 0.01:
        assert n_match < top_k
        outside = torch.nonzero(g == 0)[: top_k - n_match, 0]
        assert torch.equal(ids[0, n_match:], outside)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two-tower-retrieval", "dcn-v2", "autoint", "bst"])
def test_smoke_train_step_on_card_matches_cpu(cuda, name):
    """One train step of the SMOKE config on the card and on the CPU from
    the same weights and batch: loss, norm, lr and every parameter within
    rtol 1e-4 / atol 1e-5 (cuBLAS and the CPU's BLAS sum in other orders)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import recsys_batch, recsys_loss
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    cfg = get_arch(name).smoke_config
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(recsys_loss(cfg), opt)
    p_cpu = cfg.init(0, "cpu")
    p_dev = params_from_numpy(cfg.param_defs(), {k: v.numpy() for k, v in p_cpu.items()}, cuda)
    s_cpu, s_dev = init_opt_state(opt, p_cpu), init_opt_state(opt, p_dev)
    batch = recsys_batch(cfg, 512, "cpu", 0)
    _, _, m_cpu = step(p_cpu, s_cpu, batch)
    _, _, m_dev = step(p_dev, s_dev, {k: v.to(cuda) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(m_dev[k].cpu(), m_cpu[k], rtol=1e-4, atol=1e-5)
    for k in p_cpu:
        torch.testing.assert_close(p_dev[k].cpu(), p_cpu[k], rtol=1e-4, atol=1e-5)
    assert int(s_dev["step"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two-tower-retrieval", "dcn-v2"])
def test_fault_replay_on_card_bitwise(cuda, name, tmp_path):
    """``run`` on the card with a checkpoint every 2 steps and a failure at
    step 5: params, moments and step after 8 steps equal a run without the
    failure bitwise."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import recsys_batch, recsys_loss
    from repro_torch.train.loop import LoopConfig, make_train_step, run
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.tree import leaves

    cfg = get_arch(name).smoke_config
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(recsys_loss(cfg), opt)

    def init_state():
        params = cfg.init(0, cuda)
        return params, init_opt_state(opt, params)

    def batch_fn(s):
        return recsys_batch(cfg, 512, cuda, 0, s)

    logs = []
    faulty = run(LoopConfig(total_steps=8, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=1,
                            simulate_failure_at=5), step, init_state, batch_fn, log=logs.append)
    clean = run(LoopConfig(total_steps=8, log_every=1), step, init_state, batch_fn,
                log=lambda line: None)
    assert "[fault] restoring step 4" in logs
    assert dict(faulty[2]) == dict(clean[2])
    for a, b in zip(leaves(faulty[:2]), leaves(clean[:2])):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_egnn_train_step_on_card_repeats_bitwise(cuda, compute):
    """Two runs of an EGNN SMOKE train step on the card, from the same
    weights and graph (a hub of more than 256 incoming edges), give the
    same loss, gradient norm, parameters and moments bit for bit: the
    segment sums and the gathers' backward add in a fixed order, on no
    atomics."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.data.graph import full_graph_batch, make_powerlaw_graph
    from repro_torch.models import egnn
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.tree import leaves

    cfg = dataclasses.replace(get_arch("egnn").smoke_config,
                              compute_dtype=getattr(torch, compute))
    batch = full_graph_batch(make_powerlaw_graph(256, 4096, cfg.d_feat, cfg.n_classes,
                                                 seed=3, device=cuda),
                             edge_multiple=8, device=cuda)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(lambda p, b: egnn.loss_fn(cfg, p, b), opt)
    runs = []
    for _ in range(2):
        params = cfg.init(0, cuda)
        state = init_opt_state(opt, params)
        _, _, m = step(params, state, batch)
        runs.append((m, leaves((params, state["m"], state["v"]))))
    (m1, t1), (m2, t2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in ("loss", "grad_norm"))
    assert torch.isfinite(m1["loss"])
    assert all(a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(t1, t2))
