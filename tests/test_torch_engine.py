"""PyTorch port: K-SWEEP end to end against the reference — plain, fused,
geo-score kernel and pruned variants through GeoSearchEngine and
make_executor("single"), the oracle and recall@k, and an engine built from
the reference's own index arrays (small seeded corpus, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GeoSearchEngine as RefEngine  # noqa: E402
from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.corpus import make_uniform_trace  # noqa: E402
from repro.corpus import pad_trace_batch as ref_pad  # noqa: E402
from repro.serving.factory import make_executor as ref_make_executor  # noqa: E402
from repro_torch.core import GeoSearchEngine, QueryBudgets, QueryPlan  # noqa: E402
from repro_torch.core.convert import geo_index_from_numpy  # noqa: E402
from repro_torch.corpus import make_corpus, make_zipf_trace, pad_trace_batch  # noqa: E402
from repro_torch.serving import SingleDeviceExecutor, make_executor  # noqa: E402

BUDGETS = dict(max_candidates=1024, max_tiles=256, k_sweeps=8, sweep_budget=256, top_k=10)
GRID = 32


@pytest.fixture(scope="module")
def setup():
    corpus = make_corpus(n_docs=1500, n_terms=300, seed=9)
    trace = make_zipf_trace(corpus, n_queries=32, pool_size=24, seed=10)
    ref = RefEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
        pagerank=corpus.pagerank, grid=GRID, budgets=RefBudgets(**BUDGETS),
    )
    port = GeoSearchEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
        pagerank=corpus.pagerank, grid=GRID, budgets=QueryBudgets(**BUDGETS),
        device="cpu",
    )
    return corpus, trace, ref, port


def _assert_result_equal(want, got):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-7)
    assert set(got.stats) == set(want.stats)
    for k, v in want.stats.items():
        w = np.asarray(v)
        assert got.stats[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got.stats[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("fused,budget_kw", [
    (False, {}), (True, {}), (False, {"prune": True}),
    (True, {"prune": True, "prune_eps": 1e-3}),
    (False, {"early_termination": True, "max_candidates": 256}),
    (True, {"early_termination": True, "max_candidates": 256}),
])
def test_k_sweep_equals_reference(setup, fused, budget_kw):
    corpus, trace, ref, port = setup
    rb = dataclasses.replace(ref.budgets, **budget_kw)
    pb = dataclasses.replace(port.budgets, **budget_kw)
    want = RefEngine(ref.index, rb, ref.weights).query(ref_pad(trace), "k_sweep", fused=fused)
    got = GeoSearchEngine.from_index(port.index, pb).query(
        pad_trace_batch(trace), "k_sweep", fused=fused
    )
    _assert_result_equal(want, got)


def test_make_executor_single_equals_reference(setup):
    """The geo_score kernel's path: ``use_pallas`` swaps in its wrapper as
    the toe-print scorer."""
    corpus, trace, _, _ = setup
    ref_ex = ref_make_executor(
        "single", corpus, budgets=RefBudgets(**BUDGETS), grid=GRID, use_pallas=True
    )
    port_ex = make_executor("single", corpus, budgets=QueryBudgets(**BUDGETS), grid=GRID,
                            device="cpu", use_pallas=True)
    assert isinstance(port_ex, SingleDeviceExecutor)
    _assert_result_equal(ref_ex.run(ref_pad(trace)), port_ex.run(pad_trace_batch(trace)))


def test_geo_score_scorer_with_early_termination_equals_reference(setup):
    """Under early termination the geo_score kernel's per-toe-print scores
    pick the candidates, so the result depends on them."""
    corpus, trace, _, _ = setup
    kw = dict(BUDGETS, early_termination=True, max_candidates=256)
    ref_ex = ref_make_executor("single", corpus, budgets=RefBudgets(**kw), grid=GRID,
                               use_pallas=True)
    port_ex = make_executor("single", corpus, budgets=QueryBudgets(**kw), grid=GRID,
                            device="cpu", use_pallas=True)
    _assert_result_equal(ref_ex.run(ref_pad(trace)), port_ex.run(pad_trace_batch(trace)))


def test_oracle_and_recall_equal_reference(setup):
    _, trace, ref, port = setup
    want = ref.oracle(ref_pad(trace))
    got = port.oracle(pad_trace_batch(trace))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-7)
    assert port.recall_at_k(pad_trace_batch(trace)) == ref.recall_at_k(ref_pad(trace))


def test_engine_from_reference_index_equals_port_built(setup):
    """The reference's index arrays, carried over as numpy, give the same
    engine as the port's own build."""
    _, trace, ref, port = setup
    idx = ref.index

    def arrays(obj):
        out, statics = {}, {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if hasattr(v, "shape"):
                out[f.name] = np.asarray(v)
            else:
                statics[f.name] = v
        return out, statics

    text, ts = arrays(idx.text)
    spatial, ss = arrays(idx.spatial)
    conv = geo_index_from_numpy(text, spatial, np.asarray(idx.pagerank), {**ts, **ss}, "cpu")
    eng = GeoSearchEngine.from_index(conv, port.budgets)
    q = pad_trace_batch(trace)
    for fused in (False, True):
        a, b = eng.query(q, fused=fused), port.query(q, fused=fused)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
        for k in a.stats:
            assert torch.equal(a.stats[k], b.stats[k]), k


@pytest.mark.parametrize("kind", ["zipf", "uniform"])
def test_pruned_equals_unpruned_in_port(kind):
    """The reference's identity: with the candidate buffer larger than the
    whole window, pruned K-SWEEP (plain and kernel wrapper) returns exactly
    the unpruned top-k, ids and scores."""
    corpus = make_corpus(n_docs=900, n_terms=300, seed=17)
    if kind == "zipf":
        trace = make_zipf_trace(corpus, n_queries=48, pool_size=32, seed=18)
    else:
        trace = make_uniform_trace(corpus, n_queries=48, seed=18)
    q = pad_trace_batch(trace)
    b = QueryBudgets(max_candidates=2 * 8 * 256, max_tiles=256, k_sweeps=8, sweep_budget=256)
    eng = GeoSearchEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
        pagerank=corpus.pagerank, grid=32, budgets=b, device="cpu",
    )
    un = eng.query(q)
    pr_eng = GeoSearchEngine.from_index(eng.index, dataclasses.replace(b, prune=True))
    for fused in (False, True):
        pr = pr_eng.query(q, fused=fused)
        assert torch.equal(un.ids, pr.ids) and torch.equal(un.scores, pr.scores)


def test_plans_and_unported_options(setup):
    corpus, trace, _, port = setup
    q = pad_trace_batch(trace)
    ex = SingleDeviceExecutor(port, fused=True)
    plan = QueryPlan("k_sweep", port.budgets, fused=True)
    assert plan.label == "k_sweep+fused"
    a, b = ex.run(q, plan=plan), port.query(q, fused=True)
    assert torch.equal(a.ids, b.ids)
    assert len(port._fn_cache) >= 1
    # the sharded and mesh kinds build on the CPU and serve the batch
    from repro_torch.core import make_mesh
    from repro_torch.device import to_numpy

    for kind, kw in (("sharded", dict(n_shards=2)),
                     ("mesh", dict(mesh=make_mesh((2, 1), ("data", "model"), device="cpu")))):
        res = make_executor(kind, corpus, grid=GRID, budgets=port.budgets, device="cpu",
                            **kw).run(q)
        ids = to_numpy(res.ids)
        assert ids.dtype == np.int32 and ids.shape == tuple(b.ids.shape), kind
    # "auto" is ported: the planner's rows, each from its own plan's run
    auto = port.query(q, "auto")
    assert auto.ids.shape == b.ids.shape and auto.ids.dtype == torch.int32
    # a telemetry handle attaches: the engine's pipelines count in its
    # registry and the executor records one engine span per batch
    from repro_torch.obs import Telemetry

    tel = Telemetry()
    tex = SingleDeviceExecutor(port, fused=True)
    tex.attach_telemetry(tel)
    assert tex.telemetry is tel and port.metrics is tel.metrics
    try:
        assert torch.equal(tex.run(q).ids, b.ids)
        assert [(s.track, s.name) for s in tel.tracer.exec_spans] == [("engine", "query[k_sweep]")]
    finally:
        port.metrics = None  # the fixture's engine is shared
    with pytest.raises(ValueError):
        port.query(q, "no_such_algorithm")
