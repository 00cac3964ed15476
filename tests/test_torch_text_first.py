"""PyTorch port: TEXT-FIRST (plain and block-max pruned) and GEO-FIRST,
and K-SWEEP's text filter, on every text store (compress × layout) against
the reference; the text_probe kernel's plain version against the Pallas
kernel in interpret mode and its jnp oracle; and the reference's own
identities inside the port (small seeded corpora, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import GeoSearchEngine as RefEngine  # noqa: E402
from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.core import text_index as rti  # noqa: E402
from repro.corpus import pad_trace_batch as ref_pad  # noqa: E402
from repro.kernels.text_probe.ops import impact_planes  # noqa: E402
from repro.kernels.text_probe.ops import text_probe_pruned as j_probe  # noqa: E402
from repro.kernels.text_probe.ref import text_probe_pruned_ref as j_probe_ref  # noqa: E402
from repro_torch.core import GeoIndex, GeoSearchEngine, QueryBudgets  # noqa: E402
from repro_torch.core import text_index as pti  # noqa: E402
from repro_torch.corpus import make_corpus, make_query_trace, make_zipf_trace, pad_trace_batch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.text_probe import ops as ptp  # noqa: E402
from repro_torch.kernels.text_probe.ref import text_probe_pruned_ref  # noqa: E402
from repro_torch.serving import SingleDeviceExecutor, make_executor  # noqa: E402

BUDGETS = dict(max_candidates=256, max_tiles=128, k_sweeps=4, sweep_budget=512, top_k=10)
GRID = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU kernels on one thread: in a process that also holds
    XLA's thread pool, and beside other test workers, more threads only
    contend (the port's many small ops ran ~10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hot_docs(n_docs=2560, n_short=1024, n_terms=64, seed=0):
    """The reference's hot-term corpus (tests/test_text_prune.py): terms 0
    and 1 in every doc, short high-impact docs first."""
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n_docs):
        if d < n_short:
            docs.append(np.array([0, 1], np.int32))
        else:
            fill = rng.integers(2, n_terms, size=62).astype(np.int32)
            docs.append(np.concatenate([np.array([0, 1], np.int32), fill]))
    return docs, n_terms


def _assert_result_equal(want, got, rows=slice(None)):
    """ids, scores and every stats counter exactly (the port rounds each
    score as the reference's compiled step does: its geo sums and weighted
    terms as fused multiply-adds, in the same order)."""
    np.testing.assert_array_equal(got.ids.numpy()[rows], np.asarray(want.ids)[rows])
    np.testing.assert_array_equal(got.scores.numpy()[rows], np.asarray(want.scores)[rows])
    assert set(got.stats) == set(want.stats)
    for k, v in want.stats.items():
        w = np.asarray(v)
        assert got.stats[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got.stats[k].numpy()[rows], w[rows], err_msg=k)


def _ref_window_covered(text, terms, mc):
    """Rows whose unpruned TEXT-FIRST driver window the reference decodes
    in full.  It decodes ceil(mc/128) blocks of a packed store; under the
    impact layout a term's leading segments end in ragged blocks, so those
    blocks may hold fewer postings than the window, and the reference then
    reads garbage doc ids for the rest (a fault of the reference; the port
    decodes the whole window).  Uncompressed stores are always covered."""
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


# ---------------------------------------------------------------------------
# text_probe: plain version vs the Pallas kernel (interpret) and its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("impact_dtype", [None, np.float16])
@pytest.mark.parametrize("C,floor_frac,layout", [
    (256, 0.0, "docid"), (2048, 0.0, "docid"), (256, 0.4, "docid"),
    (1000, 0.1, "impact"), (2048, 0.0, "impact"),
])
def test_text_probe_plain_matches_reference(compress, impact_dtype, C, floor_frac, layout):
    """Bitwise in opt, exactly in valid/streamed flags and block counts —
    the grid of tests/test_text_prune.py, plus the impact layout's
    monotone cut and a C that is not a multiple of 1024 — three driver
    terms in one batched call."""
    docs, n_terms = _hot_docs()
    text = rti.build_text_index_np(
        docs, n_terms, compress=compress, impact_dtype=impact_dtype, layout=layout
    )
    assert text.max_term_blocks > 8  # multi-tile window, ragged tail
    plane = impact_planes(text.impacts, text.blk_pos, text.blk_len)
    cases = [(0, 0.7), (1, 0.0), (5, 1.3)]
    bto = np.asarray(text.blk_term_off)
    b0 = np.array([bto[t] for t, _ in cases], np.int32)
    nb = np.array([bto[t + 1] - bto[t] for t, _ in cases], np.int32)
    rest = np.array([r for _, r in cases], np.float32)
    tmax = float(np.asarray(text.blk_max_impact).max())
    floors = np.array([floor_frac * (tmax + r) for _, r in cases], np.float32)
    cols = [torch.from_numpy(np.array(getattr(text, f)))
            for f in ("impacts", "blk_pos", "blk_max_impact", "blk_len")]
    kw = dict(max_candidates=C, max_term_blocks=text.max_term_blocks,
              monotone=layout == "impact")
    args = (*cols, torch.from_numpy(b0), torch.from_numpy(nb), 1.0,
            torch.from_numpy(rest), torch.from_numpy(floors))
    reset_launch_counts()
    got = ptp.text_probe_pruned(*args, **kw)
    assert launch_counts()["text_probe"] == 0  # CPU tensors never launch
    plain = text_probe_pruned_ref(*args, **kw)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert got[0].dtype == torch.float32 and got[3].dtype == torch.int32
    for i in range(len(cases)):
        jargs = (plane, text.blk_max_impact, text.blk_len, jnp.int32(b0[i]), jnp.int32(nb[i]),
                 jnp.float32(1.0), jnp.float32(rest[i]), jnp.float32(floors[i]))
        for fn in (j_probe, j_probe_ref):
            for g, w, name in zip(got, fn(*jargs, **kw),
                                  ("opt", "valid", "streamed", "blocks_scored", "blocks_active")):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=f"{i} {name}")


# ---------------------------------------------------------------------------
# the algorithms against the reference, on every text store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    corpus = make_corpus(n_docs=1200, n_terms=160, seed=11)
    trace = make_zipf_trace(corpus, n_queries=16, pool_size=12, seed=12)
    return corpus, trace


@pytest.mark.parametrize("compress", ["none", "f16", "int8"])
@pytest.mark.parametrize("layout", ["docid", "impact"])
def test_algorithms_equal_reference(setup, compress, layout):
    """text_first (unpruned, and pruned through the kernel's wrapper),
    geo_first and pruned k_sweep: ids, masks, scores and every counter
    exactly."""
    corpus, trace = setup
    kw = dict(pagerank=corpus.pagerank, grid=GRID, compress=compress, layout=layout)
    ref = RefEngine.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
                          budgets=RefBudgets(**BUDGETS), **kw)
    port = GeoSearchEngine.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                                 corpus.n_terms, budgets=QueryBudgets(**BUDGETS), device="cpu",
                                 **kw)
    qr, qp = ref_pad(trace), pad_trace_batch(trace)
    # pruned TEXT-FIRST through the kernel's wrapper; a select floor on one store
    eps = 0.3 if (compress, layout) == ("int8", "impact") else 0.0
    for alg, bkw, fused in (
        ("text_first", {}, False),
        ("text_first", {"prune": True, "prune_eps": eps}, True),
        ("geo_first", {}, False),
        ("k_sweep", {"prune": True}, True),
    ):
        want = RefEngine(ref.index, dataclasses.replace(ref.budgets, **bkw), ref.weights).query(
            qr, alg, fused=False
        )
        got = GeoSearchEngine.from_index(port.index, dataclasses.replace(port.budgets, **bkw)).query(
            qp, alg, fused=fused
        )
        if alg == "text_first" and not bkw:
            covered = _ref_window_covered(ref.index.text, qp.terms.numpy(), BUDGETS["max_candidates"])
            _assert_result_equal(want, got, rows=covered)
            # where the reference reads garbage, the port equals its twin
            # over the same postings stored unpacked
            raw = pti.build_text_index_np(
                corpus.doc_terms, corpus.n_terms, impact_dtype=port.index.text.impacts.numpy().dtype,
                layout=layout, device="cpu",
            )
            twin = GeoSearchEngine.from_index(
                GeoIndex(raw, port.index.spatial, port.index.pagerank), port.budgets
            ).query(qp, alg)
            assert torch.equal(got.ids, twin.ids) and torch.equal(got.scores, twin.scores)
            for k in ("candidates", "n_probes", "fetch_runs", "seeks"):
                assert torch.equal(got.stats[k], twin.stats[k]), k
        else:
            _assert_result_equal(want, got)


# ---------------------------------------------------------------------------
# the reference's identities, inside the port
# ---------------------------------------------------------------------------

def test_pruned_matches_unpruned_when_covering():
    """C ≥ every driver list and no floor: no block is skipped and pruned
    TEXT-FIRST (plain and through the wrapper) returns exactly the
    unpruned top-k, ids and scores (tests/test_text_prune.py:205)."""
    corpus = make_corpus(n_docs=400, n_terms=100, seed=11)
    b = QueryBudgets(max_candidates=1024, max_tiles=256, k_sweeps=4, sweep_budget=1024)
    eng = GeoSearchEngine.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                                corpus.n_terms, pagerank=corpus.pagerank, grid=GRID,
                                budgets=b, device="cpu")
    q = make_query_trace(corpus, n_queries=24, seed=12)
    un = eng.query(q, "text_first")
    pr_eng = GeoSearchEngine.from_index(eng.index, dataclasses.replace(b, prune=True))
    for fused in (False, True):
        pr = pr_eng.query(q, "text_first", fused=fused)
        assert torch.equal(un.ids, pr.ids) and torch.equal(un.scores, pr.scores)
        assert int(pr.stats["text_blocks_skipped"].sum()) == 0


@pytest.mark.parametrize("compress", ["none", "f16", "int8"])
def test_impact_equals_docid_in_port(setup, compress):
    """The impact layout is a pure reordering: pruned TEXT-FIRST (plain and
    kernel wrapper), GEO-FIRST and K-SWEEP return the docid layout's ids
    and scores bitwise (tests/test_impact_layout.py:51,77)."""
    corpus, trace = setup
    q = pad_trace_batch(trace)
    pr = dict(BUDGETS, prune=True)
    out = {}
    for layout in ("docid", "impact"):
        eng = GeoSearchEngine.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                                    corpus.n_terms, pagerank=corpus.pagerank, grid=GRID,
                                    budgets=QueryBudgets(**pr), compress=compress,
                                    layout=layout, device="cpu")
        plain = GeoSearchEngine.from_index(eng.index, QueryBudgets(**BUDGETS))
        out[layout] = [eng.query(q, "text_first"), eng.query(q, "text_first", fused=True),
                       plain.query(q, "geo_first"), eng.query(q, "k_sweep", fused=True)]
    for a, b in zip(out["docid"], out["impact"]):
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    skipped = {k: int(v[0].stats["text_blocks_skipped"].sum()) for k, v in out.items()}
    assert skipped["impact"] >= skipped["docid"]


def test_make_executor_threads_text_first(setup):
    """make_executor builds packed/impact indexes for TEXT-FIRST and
    GEO-FIRST; ``fused`` reaches TEXT-FIRST only when pruned, as in the
    reference's factory; without CUDA the default device raises."""
    corpus, trace = setup
    q = pad_trace_batch(trace)
    b = QueryBudgets(**BUDGETS)
    bp = dataclasses.replace(b, prune=True)
    ex = make_executor("single", corpus, algorithm="text_first", budgets=bp, fused=True,
                       layout="impact", compress="int8", grid=GRID, device="cpu")
    assert isinstance(ex, SingleDeviceExecutor) and ex.kw == {"fused": True}
    text = ex.engine.index.text
    assert text.layout == "impact" and text.is_compressed and text.impacts.dtype == torch.float16
    assert ex.engine.index.spatial.tp_amps.dtype == torch.int8
    res = ex.run(q)
    assert res.ids.shape == (q.batch, b.top_k)
    assert int(res.stats["text_blocks_total"].sum()) > 0
    same = GeoSearchEngine.from_index(ex.engine.index, bp).query(q, "text_first")
    assert torch.equal(res.ids, same.ids) and torch.equal(res.scores, same.scores)
    assert make_executor("single", corpus, algorithm="text_first", budgets=b, fused=True,
                         grid=GRID, device="cpu").kw == {}
    gf = make_executor("single", corpus, algorithm="geo_first", budgets=b, fused=True,
                       grid=GRID, device="cpu")
    assert gf.kw == {} and gf.run(q).ids.shape == (q.batch, b.top_k)
    with pytest.raises(ValueError):
        make_executor("single", corpus, compress="zip", device="cpu")
    with pytest.raises(ValueError):
        make_executor("single", corpus, layout="random", device="cpu")
    if not torch.cuda.is_available():
        for alg in ("text_first", "geo_first"):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make_executor("single", corpus, algorithm=alg, budgets=bp, fused=True)
