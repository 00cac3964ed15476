"""PyTorch port: geometry, both index builds and the query-side index
primitives equal the reference exactly (small seeded corpora, CPU)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as rgeo  # noqa: E402
from repro.core import spatial_index as rsi  # noqa: E402
from repro.core import text_index as rti  # noqa: E402
from repro.corpus import (  # noqa: E402
    make_mixture_trace,
    make_uniform_trace,
    make_zipf_trace,
    pad_trace_batch,
)
from repro_torch.core import geometry as pgeo  # noqa: E402
from repro_torch.core import spatial_index as psi  # noqa: E402
from repro_torch.core import text_index as pti  # noqa: E402
from repro_torch.corpus import make_corpus  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=2000, n_terms=300, seed=12)


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


# ---------------------------------------------------------------------------
# build side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["none", "f16", "int8"])
@pytest.mark.parametrize("block_size", [128, 256, 512, 1024])
def test_spatial_index_fields_equal(corpus, compress, block_size):
    args = (corpus.doc_rects, corpus.doc_amps, 32, 2)
    want = rsi.build_spatial_index_np(*args, compress=compress, block_size=block_size)
    got = psi.build_spatial_index_np(
        *args, compress=compress, block_size=block_size, device=CPU
    )
    _assert_fields_equal(want, got)
    assert got.tp_bytes == want.tp_bytes and got.doc_bytes == want.doc_bytes


@pytest.mark.parametrize("grid,m", [(16, 1), (64, 3), (8, 4)])
def test_spatial_tile_grid_equal(corpus, grid, m):
    want = rsi.build_spatial_index_np(corpus.doc_rects[:700], corpus.doc_amps[:700], grid, m)
    got = psi.build_spatial_index_np(
        corpus.doc_rects[:700], corpus.doc_amps[:700], grid, m, device=CPU
    )
    _assert_fields_equal(want, got)


@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_coalesce_to_m_equals_reference(m):
    rng = np.random.default_rng(m)
    for _ in range(30):
        ids = np.unique(rng.integers(0, 400, int(rng.integers(1, 40))))
        assert psi._coalesce_to_m(ids, m) == rsi._coalesce_to_m(ids, m)
    assert psi._coalesce_to_m(np.zeros((0,), np.int64), m) == []


def test_quantize_and_block_metadata_equal():
    rng = np.random.default_rng(31)
    amps = rng.uniform(-2.0, 2.0, 2 * 128 + 37).astype(np.float32)
    amps[128:256] = 0.0
    for w, g in zip(rsi.quantize_amps_np(amps), psi.quantize_amps_np(amps)):
        np.testing.assert_array_equal(g, w)
    lo = rng.uniform(0, 0.9, (1000, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + 0.05], axis=1)
    amps = rng.uniform(0, 1, 1000).astype(np.float32)
    for bs in (128, 1024):
        want = rsi.block_metadata_np(rects, amps, bs)
        for w, g in zip(want, psi.block_metadata_np(rects, amps, bs)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_bitmap_terms", [0, 8])
def test_text_index_fields_equal(corpus, n_bitmap_terms):
    want = rti.build_text_index_np(corpus.doc_terms, corpus.n_terms, n_bitmap_terms)
    got = pti.build_text_index_np(
        corpus.doc_terms, corpus.n_terms, n_bitmap_terms, device=CPU
    )
    _assert_fields_equal(want, got)
    assert got.posting_bytes == want.posting_bytes


def test_text_index_edge_cases_equal():
    """Empty terms, a multi-block term, repeated terms and a global idf."""
    rng = np.random.default_rng(44)
    docs = [rng.integers(0, 50, size=int(rng.integers(1, 40))).astype(np.int32) for _ in range(300)]
    docs.append(np.full((200,), 3, np.int32))
    idf = np.log(1.0 + len(docs) / np.maximum(np.bincount(np.concatenate(docs), minlength=60), 1.0))
    idf[7] = 0.0
    for kw in ({}, {"idf": idf}):
        want = rti.build_text_index_np(docs, 60, **kw)
        got = pti.build_text_index_np(docs, 60, device=CPU, **kw)
        _assert_fields_equal(want, got)


# ---------------------------------------------------------------------------
# query side
# ---------------------------------------------------------------------------

def test_cell_range_and_tiles_equal():
    rng = np.random.default_rng(5)
    lo = rng.uniform(-0.1, 1.0, (400, 2)).astype(np.float32)
    r = np.concatenate([lo, lo + rng.uniform(-0.05, 0.4, (400, 2)).astype(np.float32)], 1)
    r[:10] = [1.0, 1.0, 0.0, 0.0]
    r[10:20, 2] = np.floor(r[10:20, 2] * 32) / 32  # exact cell edges
    for grid in (16, 64):
        want = rgeo.rect_to_cell_range(jnp.asarray(r), grid)
        got = pgeo.rect_to_cell_range(torch.from_numpy(r), grid)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        wt, wv = jax.vmap(lambda x: rgeo.enumerate_rect_tiles(x, grid, 48))(jnp.asarray(r))
        gt, gv = pgeo.enumerate_rect_tiles(torch.from_numpy(r), grid, 48)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def _traces(corpus):
    return {
        "zipf": make_zipf_trace(corpus, n_queries=48, pool_size=24, seed=1),
        "uniform": make_uniform_trace(corpus, n_queries=48, seed=2),
        "mixture": make_mixture_trace(corpus, n_queries=48, seed=3),
    }


@functools.lru_cache(maxsize=None)
def _ref_sweep_fn(max_tiles, k, budget):
    """Reference gather → coalesce → split → fetches, vmapped and jitted
    once per budget triple (the index is an argument, so traces reuse it)."""

    def one(index, r):
        s, e = rsi.gather_query_intervals(index, r, max_tiles)
        s2, e2 = rsi.coalesce_k_sweeps(s, e, k)
        s3, e3 = rsi.split_sweeps_to_budget(s2, e2, k, budget)
        fetched = rsi.fetch_sweeps(index, s3, e3, budget)
        ids = rsi.fetch_sweep_ids(index, s3, e3, budget)
        return (s, e, s2, e2, s3, e3), fetched, ids

    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


@pytest.mark.parametrize("kind", ["zipf", "uniform", "mixture"])
def test_sweep_bounds_equal(corpus, kind):
    """gather → coalesce → split, and both fetches, on three traces."""
    q = pad_trace_batch(_traces(corpus)[kind])
    ref = rsi.build_spatial_index_np(corpus.doc_rects, corpus.doc_amps, 32, 2)
    port = psi.build_spatial_index_np(corpus.doc_rects, corpus.doc_amps, 32, 2, device=CPU)
    rects = torch.from_numpy(np.array(q.rects))
    for max_tiles, k, budget in [(256, 8, 256), (16, 2, 1000)]:
        bounds, fetched, ids = _ref_sweep_fn(max_tiles, k, budget)(ref, q.rects)
        s, e = psi.gather_query_intervals(port, rects, max_tiles)
        s2, e2 = psi.coalesce_k_sweeps(s, e, k)
        s3, e3 = psi.split_sweeps_to_budget(s2, e2, k, budget)
        for w, g in zip(bounds, (s, e, s2, e2, s3, e3)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for w, g in zip(fetched, psi.fetch_sweeps(port, s3, e3, budget)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(psi.fetch_sweep_ids(port, s3, e3, budget).numpy(), np.asarray(ids))


def test_probes_and_text_scores_equal(corpus):
    ref = rti.build_text_index_np(corpus.doc_terms, corpus.n_terms)
    port = pti.build_text_index_np(corpus.doc_terms, corpus.n_terms, device=CPU)
    rng = np.random.default_rng(23)
    B, C = 6, 300
    docs = rng.integers(0, 2000, (B, C)).astype(np.int32)
    terms = np.full((B, 5), -1, np.int32)
    for b in range(B):
        t = np.unique(rng.choice(corpus.doc_terms[b * 7], size=b % 4 + 1))
        terms[b, : len(t)] = t
    terms[0, 0] = 299  # a rare or empty term
    valid = rng.random((B, C)) < 0.7
    for t in (0, 1, 17, 299):
        wm, wi = rti.probe_term(ref, jnp.int32(t), jnp.asarray(docs[0]))
        gm, gi = pti.probe_term(port, torch.full((1,), t, dtype=torch.int32), torch.from_numpy(docs[:1]))
        np.testing.assert_array_equal(gm.numpy()[0], np.asarray(wm))
        np.testing.assert_array_equal(gi.numpy()[0], np.asarray(wi))
    wm, ws = jax.vmap(lambda t, d: rti.text_score_of_docs(ref, t, d))(jnp.asarray(terms), jnp.asarray(docs))
    gm, gs = pti.text_score_of_docs(port, torch.from_numpy(terms), torch.from_numpy(docs))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-7)
    wm, ws, wp = jax.vmap(lambda t, d, v: rti.text_score_of_docs_counted(ref, t, d, v))(
        jnp.asarray(terms), jnp.asarray(docs), jnp.asarray(valid)
    )
    gm, gs, gp = pti.text_score_of_docs_counted(
        port, torch.from_numpy(terms), torch.from_numpy(docs), torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-7)
