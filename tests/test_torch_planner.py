"""PyTorch port: the cost-based planner and ``algorithm="auto"`` against the
reference — feature tables, features, estimates, truncation charges and plan
choices (exactly: host numpy float64 on equal index arrays), calibration
scales, the engine's per-row auto dispatch (ids and every stat, dtype
included), and the reference's acceptance properties on the port (small
seeded corpora, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GeoSearchEngine as RefEngine  # noqa: E402
from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.core import QueryPlan as RefPlan  # noqa: E402
from repro.corpus import make_query_trace as ref_query_trace  # noqa: E402
from repro.corpus import pad_trace_batch as ref_pad  # noqa: E402
from repro.serving import SingleDeviceExecutor as RefExecutor  # noqa: E402
from repro_torch.core import (  # noqa: E402
    COST_KEYS,
    CostModel,
    GeoSearchEngine,
    Planner,
    QueryBudgets,
    QueryPlan,
)
from repro_torch.corpus import (  # noqa: E402
    make_corpus,
    make_mixture_trace,
    make_query_trace,
    make_uniform_trace,
    make_zipf_trace,
    pad_trace_batch,
)
from repro_torch.serving import SingleDeviceExecutor, make_executor  # noqa: E402

# the reference's planner fixtures (tests/test_planner.py)
SMALL = dict(n_docs=600, n_terms=300, seed=5, grid=32, m_intervals=4,
             budgets=dict(max_candidates=512, max_tiles=256, k_sweeps=4,
                          sweep_budget=256, top_k=5))
MIXTURE = dict(n_docs=2500, n_terms=1000, seed=9, grid=128, m_intervals=8,
               budgets=dict(max_candidates=2048, max_tiles=1024, k_sweeps=8,
                            sweep_budget=max(2500 // 8, 256), top_k=10))
FIXED = ("text_first", "geo_first", "k_sweep")


def _engines(cfg):
    corpus = make_corpus(cfg["n_docs"], cfg["n_terms"], seed=cfg["seed"])
    kw = dict(pagerank=corpus.pagerank, grid=cfg["grid"], m_intervals=cfg["m_intervals"])
    args = (corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms)
    ref = RefEngine.build(*args, budgets=RefBudgets(**cfg["budgets"]), **kw)
    port = GeoSearchEngine.build(*args, budgets=QueryBudgets(**cfg["budgets"]), device="cpu",
                                 **kw)
    return corpus, ref, port


@pytest.fixture(scope="module")
def small():
    return _engines(SMALL)


@pytest.fixture(scope="module")
def mixture():
    return _engines(MIXTURE)


def _traces(corpus):
    return {
        "zipf": make_zipf_trace(corpus, n_queries=48, pool_size=24, seed=3),
        "uniform": make_uniform_trace(corpus, n_queries=48, seed=4),
        "mixture": make_mixture_trace(corpus, n_queries=48, seed=5),
    }


def _ref_plan(plan: QueryPlan, ref_budgets) -> RefPlan:
    return RefPlan(plan.algorithm, dataclasses.replace(ref_budgets, **dataclasses.asdict(
        plan.budgets)), fused=plan.fused)


def _assert_result_equal(want, got):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert got.ids.numpy().dtype == np.asarray(want.ids).dtype
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-7)
    assert set(got.stats) == set(want.stats)
    for k, v in want.stats.items():
        w = np.asarray(v)
        assert got.stats[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got.stats[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("fixture", ["small", "mixture"])
def test_cost_model_tables_equal_reference(fixture, request):
    _, ref, port = request.getfixturevalue(fixture)
    want, got = ref.planner.model, port.planner.model
    for name in ("df", "blk_mbr", "blk_count", "tile_sat", "_span_blocks", "_span_offsets"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("grid", "n_postings", "n_toeprints", "n_docs", "rect_slots",
                 "posting_bytes", "tp_bytes", "doc_bytes", "tp_id_bytes"):
        assert getattr(got, name) == getattr(want, name), name
    assert [p.label for p in port.planner.candidates] == [
        p.label for p in ref.planner.candidates]


@pytest.mark.parametrize("fixture", ["small", "mixture"])
@pytest.mark.parametrize("kind", ["zipf", "uniform", "mixture"])
def test_features_estimates_and_choices_equal_reference(fixture, kind, request):
    corpus, ref, port = request.getfixturevalue(fixture)
    rp, pp = ref.planner, port.planner
    rp.model.tp_span_probes = pp.model.tp_span_probes = 0
    for q in _traces(corpus)[kind]:
        want = rp.model.features(q.terms, q.rects, q.amps)
        got = pp.model.features(q.terms, q.rects, q.amps)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for plan, rplan in zip(pp.candidates, rp.candidates):
            assert plan.label == rplan.label
            assert pp.model.estimate(plan, got) == rp.model.estimate(rplan, want)
            assert pp.model.truncation(plan, got) == rp.model.truncation(rplan, want)
            assert pp.cost(plan, got) == rp.cost(rplan, want)
        assert pp.plan_query(q.terms, q.rects, q.amps).label == rp.plan_query(
            q.terms, q.rects, q.amps).label
        assert pp.explain(q.terms, q.rects, q.amps) == rp.explain(q.terms, q.rects, q.amps)
    assert pp.model.tp_span_probes == rp.model.tp_span_probes > 0
    rows = [p.label for p in pp.plan_rows(pad_trace_batch(_traces(corpus)[kind]))]
    assert rows == [p.label for p in rp.plan_rows(ref_pad(_traces(corpus)[kind]))]


def test_calibrate_equals_reference(small):
    corpus, ref, port = small
    rplanner = type(ref.planner).from_engine(ref)
    pplanner = Planner.from_engine(port)
    rplanner.model.calibrate(ref, ref_query_trace(corpus, n_queries=16, seed=6),
                             rplanner.candidates)
    pplanner.model.calibrate(port, make_query_trace(corpus, n_queries=16, seed=6),
                             pplanner.candidates)
    assert pplanner.model.scales
    assert pplanner.model.scales == rplanner.model.scales
    for (algo, key), s in pplanner.model.scales.items():
        assert key in COST_KEYS and 1.0 / 16.0 <= s <= 16.0, (algo, key, s)


@pytest.mark.parametrize("kind", ["zipf", "mixture"])
@pytest.mark.parametrize("fused,prune", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_query_auto_equals_reference(mixture, kind, fused, prune):
    """Rows gathered from several plans come back as the reference's: ids
    i32 exactly, scores within tolerance, every stat exactly and as f32."""
    corpus, ref, port = mixture
    rb = dataclasses.replace(ref.budgets, prune=prune)
    pb = dataclasses.replace(port.budgets, prune=prune)
    trace = _traces(corpus)[kind][:32]
    r_eng = RefEngine(ref.index, rb, ref.weights)
    p_eng = GeoSearchEngine.from_index(port.index, pb)
    want = r_eng.query(ref_pad(trace), "auto", fused=fused)
    got = p_eng.query(pad_trace_batch(trace), "auto", fused=fused)
    _assert_result_equal(want, got)
    if kind == "mixture":  # several plans: the gathered path
        assert len({p.algorithm for p in p_eng.planner.plan_rows(pad_trace_batch(trace))}) >= 2
        assert all(v.dtype == torch.float32 for v in got.stats.values())


def test_executor_auto_equals_reference(mixture):
    corpus, ref, port = mixture
    trace = _traces(corpus)["mixture"][:16]
    r_ex = RefExecutor(ref, "auto", fused=True)
    p_ex = SingleDeviceExecutor(port, "auto", fused=True)
    for q in trace:
        plan = p_ex.plan_query(q.terms, q.rects, q.amps)
        want = r_ex.plan_query(q.terms, q.rects, q.amps)
        assert (plan.label, plan.fused) == (want.label, want.fused)
    plan = p_ex.plan_query(trace[0].terms, trace[0].rects, trace[0].amps)
    _assert_result_equal(r_ex.run(ref_pad(trace), plan=_ref_plan(plan, ref.budgets)),
                         p_ex.run(pad_trace_batch(trace), plan=plan))
    assert SingleDeviceExecutor(port, "k_sweep").plan_query(
        trace[0].terms, trace[0].rects, trace[0].amps) is None


def test_make_executor_auto_runs_and_recall(small):
    """``make_executor("single", ..., algorithm="auto")`` builds the
    planner, routes the kernels under ``fused`` as the reference's factory
    does, and ``recall_at_k(batch, "auto", fused=True)`` equals the
    reference's."""
    corpus, ref, port = small
    ex = make_executor("single", corpus, algorithm="auto", fused=True, grid=32,
                       m_intervals=4, budgets=port.budgets, device="cpu")
    assert ex.planner is not None and ex.kw == {"fused": True}
    assert {p.label for p in ex.planner.candidates} == {
        "text_first", "geo_first", "k_sweep+fused"}
    batch = pad_trace_batch(make_mixture_trace(corpus, n_queries=24, seed=7))
    res = ex.run(batch)
    assert tuple(res.ids.shape) == (24, port.budgets.top_k)
    r_batch = ref_pad(make_mixture_trace(corpus, n_queries=24, seed=7))
    assert port.recall_at_k(batch, "auto", fused=True) == ref.recall_at_k(
        r_batch, "auto", fused=True)


def test_plan_choice_goldens(mixture):
    """The reference's goldens, on the port: rare-term × huge-footprint
    queries plan TEXT-FIRST; hot-term × tiny-footprint queries plan a
    spatial-first pipeline."""
    corpus, _, port = mixture
    planner = port.planner
    rare = pad_trace_batch(make_mixture_trace(corpus, n_queries=24, rare_frac=1.0, seed=21))
    hot = pad_trace_batch(make_mixture_trace(corpus, n_queries=24, rare_frac=0.0, seed=22))
    rare_plans = [p.algorithm for p in planner.plan_rows(rare)]
    hot_plans = [p.algorithm for p in planner.plan_rows(hot)]
    assert rare_plans.count("text_first") >= 0.75 * len(rare_plans)
    spatial = [a for a in hot_plans if a in ("geo_first", "k_sweep")]
    assert len(spatial) >= 0.75 * len(hot_plans)
    assert hot_plans.count("geo_first") > 0


def _trace_cost(res) -> float:
    """The acceptance objective: inverted-index probes + posting bytes."""
    return float(res.stats["n_probes"].double().sum() + res.stats["bytes_postings"].double().sum())


def test_auto_beats_every_fixed_algorithm_on_mixture(mixture):
    """The reference's acceptance gate, on the port: on the mixture trace
    ``auto`` spends >= 1.3x fewer probes + posting bytes than the best fixed
    algorithm, at recall@10 >= 0.95 against the exact oracle."""
    corpus, _, port = mixture
    batch = pad_trace_batch(make_mixture_trace(corpus, n_queries=96, seed=10))
    costs = {a: _trace_cost(port.query(batch, a)) for a in (*FIXED, "auto")}
    best_fixed = min(costs[a] for a in FIXED)
    assert best_fixed >= 1.3 * costs["auto"], costs
    assert port.recall_at_k(batch, "auto") >= 0.95
    assert len({p.algorithm for p in port.planner.plan_rows(batch)}) >= 2


def test_cost_model_of_shards_waits_for_distributed_slice(small):
    """The sharded cost models are ported: over one shard (the whole index)
    their tables equal the reference's."""
    from repro.core.distributed import HashPartitioner as RefHash
    from repro.core.distributed import shard_corpus_np as ref_shard
    from repro.core.planner import CostModel as RefCostModel
    from repro_torch.core import HashPartitioner, shard_corpus_np

    corpus, ref, port = small
    args = (corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
            corpus.n_terms, 1)
    pairs = [
        (RefCostModel.from_shards([ref.index], ref.budgets),
         CostModel.from_shards([port.index], port.budgets)),
        (RefCostModel.from_sharded_index(ref_shard(*args, RefHash(), grid=SMALL["grid"]),
                                         ref.budgets),
         CostModel.from_sharded_index(shard_corpus_np(*args, HashPartitioner(),
                                                      grid=SMALL["grid"], device="cpu"),
                                      port.budgets)),
    ]
    for want, got in pairs:
        for name in ("df", "blk_mbr", "blk_count", "tile_sat"):
            a, b = np.asarray(getattr(want, name)), getattr(got, name)
            assert b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        for name in ("grid", "n_postings", "n_toeprints", "n_docs", "rect_slots",
                     "posting_bytes", "tp_bytes", "doc_bytes", "tp_id_bytes"):
            assert getattr(got, name) == getattr(want, name), name
