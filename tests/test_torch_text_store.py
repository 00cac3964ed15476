"""PyTorch port: the packed (PForDelta) and impact-ordered text store, its
query-side probes, GEO-FIRST's candidate enumeration and the bitmap
kernel's plain version, each against the reference (small seeded inputs,
CPU)."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import GeoSearchEngine as RefEngine  # noqa: E402
from repro.core import spatial_index as rsi  # noqa: E402
from repro.core import text_index as rti  # noqa: E402
from repro.kernels.bitmap_filter.ops import bitmap_and_popcount as j_bitmap  # noqa: E402
from repro.kernels.bitmap_filter.ops import (  # noqa: E402
    conjunction_block_prefilter as j_prefilter,
)
from repro.kernels.bitmap_filter.ref import bitmap_and_popcount_ref as j_bitmap_ref  # noqa: E402
from repro_torch.core import GeoSearchEngine, QueryBudgets  # noqa: E402
from repro_torch.core import spatial_index as psi  # noqa: E402
from repro_torch.core import text_index as pti  # noqa: E402
from repro_torch.core.convert import geo_index_from_numpy  # noqa: E402
from repro_torch.corpus import make_corpus, make_zipf_trace, pad_trace_batch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bitmap_filter import ops as pbm  # noqa: E402

CPU = torch.device("cpu")
MODES = [(False, None), (True, np.float16), (False, np.float16), (True, None)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread: in a process that also holds
    XLA's thread pool, and beside other test workers, more threads only
    contend (the port's many small ops ran ~10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=1500, n_terms=200, seed=12)


def _assert_fields_equal(ref_obj, port_obj):
    for f in dataclasses.fields(ref_obj):
        want = getattr(ref_obj, f.name)
        got = getattr(port_obj, f.name)
        if isinstance(got, torch.Tensor):
            w = np.asarray(want)
            assert got.numpy().dtype == w.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f.name)
        else:
            assert got == want, f.name


def _both(corpus, compress, dtype, layout, n_bitmap_terms=0):
    kw = dict(compress=compress, impact_dtype=dtype, layout=layout)
    want = rti.build_text_index_np(corpus.doc_terms, corpus.n_terms, n_bitmap_terms, **kw)
    got = pti.build_text_index_np(
        corpus.doc_terms, corpus.n_terms, n_bitmap_terms, device=CPU, **kw
    )
    return want, got


# ---------------------------------------------------------------------------
# build side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress,dtype", MODES)
@pytest.mark.parametrize("layout", ["docid", "impact"])
def test_text_store_fields_equal(corpus, compress, dtype, layout):
    """Every array (dtype and itemsize included) and static of the packed
    and impact-ordered builds, and the modeled bytes per posting."""
    want, got = _both(corpus, compress, dtype, layout, n_bitmap_terms=6)
    _assert_fields_equal(want, got)
    assert got.posting_bytes == want.posting_bytes
    assert got.is_compressed == want.is_compressed


@pytest.mark.parametrize("layout", ["docid", "impact"])
def test_text_store_edge_cases_equal(layout):
    """Empty terms, one all-docs term, a single-posting term, repeated
    terms and an empty corpus, packed and not."""
    rng = np.random.default_rng(44)
    docs = [rng.integers(0, 50, size=int(rng.integers(1, 40))).astype(np.int32) for _ in range(400)]
    docs = [np.concatenate([d, [3]]) for d in docs]
    docs.append(np.full((9,), 55, np.int32))
    for case in (docs, []):
        for compress, dtype in MODES[:2]:
            kw = dict(compress=compress, impact_dtype=dtype, layout=layout)
            want = rti.build_text_index_np(case, 60, **kw)
            got = pti.build_text_index_np(case, 60, device=CPU, **kw)
            _assert_fields_equal(want, got)


def _pack_both(plists):
    offsets = np.zeros((len(plists) + 1,), np.int64)
    offsets[1:] = np.cumsum([len(p) for p in plists])
    post = np.concatenate(plists).astype(np.int64) if offsets[-1] else np.zeros((0,), np.int64)
    want = rti.pack_postings_np(post, offsets)
    got = pti.pack_postings_np(post, offsets)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return SimpleNamespace(**{k: torch.from_numpy(v) for k, v in got.items()})


def _decode_term(idx, t):
    bto, blk_len = idx.blk_term_off.numpy(), idx.blk_len.numpy()
    blocks = torch.arange(int(bto[t]), int(bto[t + 1]))
    dec = pti.decode_posting_blocks(idx, blocks).numpy()
    return np.concatenate([dec[i, : blk_len[b]] for i, b in enumerate(blocks.tolist())])


def _pfor_cases():
    big = (1 << (pti.PFOR_HIGH_BITS + 4)) + 5
    heavy = np.ones(pti.POSTING_BLOCK, np.int64)
    heavy[1::2] = 1 << 20
    rng = np.random.default_rng(41)
    n = 2 * pti.POSTING_BLOCK + 37
    ragged = rng.integers(1, 4, size=n).astype(np.int64)
    ragged[n - 5] = 1 << 18
    return {
        "zero_exception": [np.arange(0, 2 * pti.POSTING_BLOCK * 3, 3, dtype=np.int64)],
        "exception_heavy": [np.cumsum(heavy) - 1],
        "single_and_max_gap": [
            np.asarray([7], np.int64),
            np.asarray([0, big], np.int64),
            np.concatenate([np.arange(64, dtype=np.int64), np.asarray([big], np.int64)]),
        ],
        "ragged_tail": [np.cumsum(ragged) - 1],
        "empty": [],
    }


@pytest.mark.parametrize("case", list(_pfor_cases()))
def test_pfor_edge_cases_equal_and_round_trip(case):
    """The reference's PForDelta edge cases (tests/test_impact_layout.py):
    identical packed columns, and every term decodes to its list."""
    plists = _pfor_cases()[case]
    idx = _pack_both(plists)
    for t, want in enumerate(plists):
        np.testing.assert_array_equal(_decode_term(idx, t), want)
    if case == "exception_heavy":
        assert int(idx.blk_n_exc[0]) == pti.POSTING_BLOCK // 2


def test_pfor_width_rule_equal():
    """The vectorized width choice is the reference's per-block scan, on
    random delta mixes (ties between widths included)."""
    rng = np.random.default_rng(8)
    for _ in range(300):
        n = int(rng.integers(1, pti.POSTING_BLOCK + 1))
        d = rng.integers(1, 1 << int(rng.integers(1, 12)), size=n).astype(np.int64)
        d[rng.random(n) < 0.1] <<= int(rng.integers(0, 19))
        d[0] = 0
        assert pti._pfor_width_np(d) == rti._pfor_width_np(d)


def test_layout_helpers_equal(corpus):
    want, _ = _both(corpus, False, None, "docid")
    post, imp, off = (np.asarray(x) for x in (want.postings, want.impacts, want.offsets))
    np.testing.assert_array_equal(pti.impact_levels_np(imp), rti.impact_levels_np(imp))
    for w, g in zip(rti._impact_order_np(post, imp, off), pti._impact_order_np(post, imp, off)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(2)
    bm = rng.random(200).astype(np.float32)
    bto = np.concatenate([[0], np.sort(rng.integers(0, 201, 30)), [200]]).astype(np.int32)
    np.testing.assert_array_equal(
        pti._suffix_max_per_term_np(bm, bto), rti._suffix_max_per_term_np(bm, bto)
    )


# ---------------------------------------------------------------------------
# query side
# ---------------------------------------------------------------------------

def _queries(corpus, B=6, C=256, seed=23):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, len(corpus.doc_terms), (B, C)).astype(np.int32)
    docs[:, :40] = np.arange(40)  # some surely-matching ids
    terms = np.full((B, 5), -1, np.int32)
    for b in range(B - 1):
        t = np.unique(rng.choice(corpus.doc_terms[b * 7], size=b % 4 + 1))
        terms[b, : len(t)] = t
    return docs, terms


def _ref_window_covered(text, terms, mc):
    """Rows whose TEXT-FIRST driver window the reference's packed walk
    decodes in full (ceil(mc/128) blocks; see ROADMAP Queue 3)."""
    if np.asarray(text.blk_first).shape[0] == 0:
        return np.ones(len(terms), bool)
    off, bto = np.asarray(text.offsets), np.asarray(text.blk_term_off)
    bl = np.asarray(text.blk_len)
    out = []
    for row in terms:
        real = row[row >= 0]
        if not len(real):
            out.append(True)
            continue
        lens = off[real + 1] - off[real]
        t0 = real[np.argmin(lens)]
        nbd = min(-(-mc // 128), bto[t0 + 1] - bto[t0])
        out.append(bl[bto[t0] : bto[t0] + nbd].sum() >= min(lens.min(), mc))
    return np.asarray(out)


# the reference's query-side functions, jitted and vmapped over the batch
# once (the index is an argument)
_ref_probe = jax.jit(jax.vmap(rti.probe_term, in_axes=(None, 0, 0)))
_ref_text_score = jax.jit(jax.vmap(rti.text_score_of_docs, in_axes=(None, 0, 0)))
_ref_conjunction = jax.jit(
    jax.vmap(rti.conjunction_candidates, in_axes=(None, 0, None)), static_argnums=2
)
_ref_decode = jax.jit(rti.decode_posting_blocks)


@pytest.mark.parametrize("compress,dtype", MODES[:2])
@pytest.mark.parametrize("layout", ["docid", "impact"])
def test_decode_probe_and_conjunction_equal(corpus, compress, dtype, layout):
    """decode_posting_blocks (every block, garbage slots included),
    probe_term, text_score_of_docs and conjunction_candidates."""
    want, got = _both(corpus, compress, dtype, layout)
    if compress:
        blocks = np.arange(want.blk_first.shape[0], dtype=np.int32).reshape(-1, 1)
        np.testing.assert_array_equal(
            pti.decode_posting_blocks(got, torch.from_numpy(blocks)).numpy(),
            np.asarray(_ref_decode(want, jnp.asarray(blocks))),
        )
    docs, terms = _queries(corpus)
    probe_terms = np.array([0, 1, 17, 150, 199], np.int32)
    wm, wi = _ref_probe(want, jnp.asarray(probe_terms), jnp.asarray(docs[:1].repeat(5, 0)))
    gm, gi = pti.probe_term(got, torch.from_numpy(probe_terms), torch.from_numpy(docs[:1].repeat(5, 0)))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    wm, ws = _ref_text_score(want, jnp.asarray(terms), jnp.asarray(docs))
    gm, gs = pti.text_score_of_docs(got, torch.from_numpy(terms), torch.from_numpy(docs))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-7)
    _, raw = _both(corpus, False, dtype, layout)
    for mc in (64, 300):
        wc, wv, ws = _ref_conjunction(want, jnp.asarray(terms), mc)
        gc, gv, gs = pti.conjunction_candidates(got, torch.from_numpy(terms), mc)
        # the reference decodes ceil(mc/128) driver blocks, which under the
        # impact layout's ragged segment blocks may not hold the whole
        # window: its garbage rows are held to the unpacked twin instead
        ok = _ref_window_covered(want, terms, mc)
        np.testing.assert_array_equal(gv.numpy()[ok], np.asarray(wv)[ok])
        np.testing.assert_array_equal(gc.numpy()[ok], np.asarray(wc)[ok])
        # the driver's impact plus the others', added in column order
        np.testing.assert_array_equal(gs.numpy()[ok], np.asarray(ws)[ok])
        for g, r in zip((gc, gv, gs), pti.conjunction_candidates(raw, torch.from_numpy(terms), mc)):
            assert torch.equal(g, r)


def test_tile_candidate_toeprints_equal(corpus):
    trace = make_zipf_trace(corpus, n_queries=12, pool_size=8, seed=4)
    q = pad_trace_batch(trace)
    ref = rsi.build_spatial_index_np(corpus.doc_rects, corpus.doc_amps, 32, 2)
    port = psi.build_spatial_index_np(corpus.doc_rects, corpus.doc_amps, 32, 2, device=CPU)
    fn = jax.jit(
        jax.vmap(rsi.tile_candidate_toeprints, in_axes=(None, 0, None, None, None)),
        static_argnums=(2, 3, 4),
    )
    for max_tiles, mc, runs in ((128, 512, 64), (16, 3000, 4)):
        wi, wo = fn(ref, jnp.asarray(q.rects.numpy()), max_tiles, mc, runs)
        gi, go = psi.tile_candidate_toeprints(port, q.rects, max_tiles, mc, runs)
        assert gi.dtype == torch.int32
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("compress,layout", [("int8", "impact"), ("f16", "docid")])
def test_engine_from_reference_packed_index(corpus, compress, layout):
    """The reference's packed / impact-ordered index, carried over as numpy
    by geo_index_from_numpy, equals the port's own build field for field
    and answers the same."""
    kw = dict(pagerank=corpus.pagerank, grid=32, compress=compress, layout=layout)
    ref = RefEngine.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms, **kw)
    port = GeoSearchEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms, device="cpu",
        budgets=QueryBudgets(max_candidates=256, sweep_budget=512), **kw,
    )

    def arrays(obj):
        out, statics = {}, {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            (out if hasattr(v, "shape") else statics)[f.name] = np.asarray(v) if hasattr(v, "shape") else v
        return out, statics

    text, ts = arrays(ref.index.text)
    spatial, ss = arrays(ref.index.spatial)
    conv = geo_index_from_numpy(text, spatial, np.asarray(ref.index.pagerank), {**ts, **ss}, "cpu")
    _assert_fields_equal(ref.index.text, conv.text)
    _assert_fields_equal(port.index.text, conv.text)
    eng = GeoSearchEngine.from_index(conv, port.budgets)
    q = pad_trace_batch(make_zipf_trace(corpus, n_queries=8, pool_size=8, seed=3))
    for alg in ("text_first", "geo_first"):
        a, b = eng.query(q, alg), port.query(q, alg)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
        for k in a.stats:
            assert torch.equal(a.stats[k], b.stats[k]), k


# ---------------------------------------------------------------------------
# bitmap_and_popcount: the plain version against the reference
# ---------------------------------------------------------------------------

# d in {1, 3, 8, 9} (9: the card's chunk of 8 rows, then 1) × W % 4 in
# {0, 1, 2, 3} (the card's 4-word groups and their tail)
BITMAP_SHAPES = [(1, 5), (2, 1024), (3, 1000), (8, 4099), (9, 1)] + [
    (d, W) for d in (1, 3, 8, 9) for W in (4096, 4097, 4098, 4099) if (d, W) != (8, 4099)
]


@pytest.mark.parametrize("d,W", BITMAP_SHAPES)
def test_bitmap_plain_matches_reference(d, W):
    rng = np.random.default_rng(d * 1000 + W)
    rows = rng.integers(0, 2**32, (d, W), dtype=np.uint64).astype(np.uint32)
    rows[:, : min(W, 3)] = 0xFFFFFFFF
    rows[0, -1] = 0
    reset_launch_counts()
    anded, counts = pbm.bitmap_and_popcount(torch.from_numpy(rows))
    assert launch_counts()["bitmap_and_popcount"] == 0  # CPU tensors never launch
    assert anded.dtype == torch.uint32 and counts.dtype == torch.int32
    for fn in (j_bitmap, j_bitmap_ref):
        wa, wc = fn(jnp.asarray(rows))
        np.testing.assert_array_equal(anded.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
    assert int(pbm.conjunction_block_prefilter(torch.from_numpy(rows))) == int(
        j_prefilter(jnp.asarray(rows))
    )


def test_bitmap_prefilter_on_index_rows(corpus):
    """Over an index's own bitmap rows: the conjunction's survivor count
    equals the popcount of the per-block AND the reference computes."""
    want, got = _both(corpus, False, None, "docid", n_bitmap_terms=8)
    rows = got.bitmaps[[0, 2, 5]].contiguous()
    assert int(pbm.conjunction_block_prefilter(rows)) == int(
        j_prefilter(jnp.asarray(np.asarray(want.bitmaps)[[0, 2, 5]]))
    )
    with pytest.raises(TypeError):
        pbm.bitmap_and_popcount(rows.view(torch.int32))
    with pytest.raises(ValueError):
        pbm.bitmap_and_popcount(rows[:0])
