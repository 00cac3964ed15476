"""PyTorch port: GeoServer against the reference's, over executors built
from one corpus (the port's on the CPU).  Open loop with an injected service
time is deterministic, so every ServeReport field must be equal — per-query
latencies and their batch-wait / queue-wait / service decomposition
exactly, hits, batches, shapes, pad counters, and the summed stats and
per-plan stats — across arrival processes, worker counts, coalescing and
cache policies; closed loop (wall clock) must agree on everything but
time.  Collected ids are equal and scores within tolerance."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.serving import DeadlineBatcher as RefDeadlineBatcher  # noqa: E402
from repro.serving import GeoServer as RefServer  # noqa: E402
from repro.serving import ShapeBucketedBatcher as RefShapeBatcher  # noqa: E402
from repro.serving import make_cache as ref_make_cache  # noqa: E402
from repro.serving import make_executor as ref_make_executor  # noqa: E402
from repro_torch.core import QueryBudgets  # noqa: E402
from repro_torch.corpus import (  # noqa: E402
    make_corpus,
    make_mixture_trace,
    make_zipf_trace,
    stamp_arrivals,
)
from repro_torch.serving import (  # noqa: E402
    DeadlineBatcher,
    GeoServer,
    ShapeBucketedBatcher,
    make_cache,
    make_executor,
)

BUDGETS = dict(max_candidates=512, max_tiles=128, k_sweeps=4, sweep_budget=256, top_k=5)
GRID = 32
SHAPE = dict(max_batch=4, max_terms=4, max_rects=2)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=1500, n_terms=300, seed=9)


def _executors(corpus, algorithm="k_sweep", fused=False, **budget_kw):
    kw = dict(algorithm=algorithm, grid=GRID, fused=fused)
    ref = ref_make_executor("single", corpus, budgets=RefBudgets(**BUDGETS, **budget_kw), **kw)
    port = make_executor("single", corpus, budgets=QueryBudgets(**BUDGETS, **budget_kw),
                         device="cpu", **kw)
    return ref, port


@pytest.fixture(scope="module")
def k_sweep(corpus):
    return _executors(corpus)


@pytest.fixture(scope="module")
def zipf(corpus):
    return make_zipf_trace(corpus, n_queries=96, pool_size=20, d_terms=4, q_rects=2, seed=10)


def _service(raw) -> float:
    """Injected batch duration: a deterministic function of the batch."""
    return 1e-3 + 2.5e-4 * raw.n_real + 1e-4 * raw.shape.d_terms


def _caches(policy):
    if policy == "lru":
        return make_cache("lru", 16), ref_make_cache("lru", 16)
    # 40-byte top-5 payloads: the byte budget binds before the count does
    return (make_cache("landlord", 16, max_bytes=480.0),
            ref_make_cache("landlord", 16, max_bytes=480.0))


def _plain(x):
    """A report field as plain data (BucketShape / BatchEvent / QueryResult
    are the two packages' own classes)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _assert_results_equal(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert isinstance(g.ids, np.ndarray) and g.ids.dtype == w.ids.dtype
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-6, atol=1e-7)


def _assert_reports_equal(want, got, timed=True):
    fields = [f.name for f in dataclasses.fields(want)]
    skip = {"results"} | (set() if timed else {
        "wall_s", "latencies_s", "batch_wait_s", "queue_wait_s", "service_s",
        "batch_events", "plan_latencies_s"})
    for name in fields:
        if name not in skip:
            w = getattr(want, name)
            g = getattr(got, name)
            if name == "batch_events":
                w, g = [_plain(e) for e in w], [_plain(e) for e in g]
            assert _plain(g) == _plain(w), name
    if want.results is not None:
        _assert_results_equal(want.results, got.results)


def _check_decomposition(rep, n):
    assert rep.n_queries == n == len(rep.latencies_s)
    assert rep.cache_hits + rep.cache_misses == n
    total = np.asarray(rep.batch_wait_s) + np.asarray(rep.queue_wait_s) + np.asarray(
        rep.service_s)
    np.testing.assert_allclose(np.asarray(rep.latencies_s), total, rtol=0, atol=1e-12)
    assert min(rep.batch_wait_s) >= 0 and min(rep.queue_wait_s) >= 0


def _serve_both(ref_ex, port_ex, trace, arrival, policy, workers=1, coalesce=False, *,
                batcher, **run_kw):
    """One run of each package's server; ``batcher(side)`` builds a fresh
    batcher for side ``"ref"`` or ``"port"``."""
    caches = _caches(policy) if policy else (None, None)
    ref = RefServer(ref_ex, cache=caches[1], n_workers=workers, coalesce=coalesce,
                    batcher=batcher("ref"))
    port = GeoServer(port_ex, cache=caches[0], n_workers=workers, coalesce=coalesce,
                     batcher=batcher("port"))
    want = ref.run_trace(trace, arrival=arrival, collect_results=True, **run_kw)
    got = port.run_trace(trace, arrival=arrival, collect_results=True, **run_kw)
    return want, got


def _deadline(max_wait_s):
    return lambda side: (RefDeadlineBatcher if side == "ref" else DeadlineBatcher)(
        **SHAPE, max_wait_s=max_wait_s)


@pytest.mark.parametrize("policy", ["lru", "landlord"])
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
def test_open_loop_report_equals_reference(k_sweep, zipf, arrival, workers, coalesce, policy):
    ref_ex, port_ex = k_sweep
    trace = stamp_arrivals(zipf, arrival, rate_qps=900.0, seed=3, diurnal_period_s=0.05)
    want, got = _serve_both(ref_ex, port_ex, trace, arrival, policy, workers, coalesce,
                            batcher=_deadline(2e-3), service_time=_service)
    _assert_reports_equal(want, got)
    _check_decomposition(got, len(trace))
    assert got.cache_hits > 0 and got.n_batches > 1
    if coalesce:
        assert got.coalesced > 0


@pytest.mark.parametrize("fused", [False, True])
def test_open_loop_auto_report_equals_reference(corpus, zipf, fused):
    """``algorithm="auto"`` with pruning: plan-homogeneous buckets, one
    plan per batch, per-plan counts, latencies and stats."""
    ref_ex, port_ex = _executors(corpus, "auto", fused=fused, prune=True)
    trace = make_mixture_trace(corpus, n_queries=40, seed=11) + list(zipf[:40])
    trace = stamp_arrivals(trace, "poisson", rate_qps=600.0, seed=4)
    want, got = _serve_both(ref_ex, port_ex, trace, "poisson", "landlord", 2, True,
                            batcher=_deadline(3e-3), service_time=_service)
    _assert_reports_equal(want, got)
    _check_decomposition(got, len(trace))
    assert len(got.plan_queries) >= 2
    assert sum(got.plan_queries.values()) == got.cache_misses


@pytest.mark.parametrize("kind", ["shape", "deadline_inf"])
@pytest.mark.parametrize("policy,coalesce", [(None, False), ("lru", True), ("landlord", False)])
def test_closed_loop_equals_reference(k_sweep, zipf, kind, policy, coalesce):
    """Closed loop times the wall clock, so only the counts compare: the
    same hits, coalesced queries, batches, shapes, padding, stats and
    results."""
    ref_ex, port_ex = k_sweep
    if kind == "shape":
        def batcher(side):
            return (RefShapeBatcher if side == "ref" else ShapeBucketedBatcher)(**SHAPE)
    else:
        batcher = _deadline(float("inf"))
    want, got = _serve_both(ref_ex, port_ex, zipf, "closed", policy, 1, coalesce,
                            batcher=batcher)
    _assert_reports_equal(want, got, timed=False)
    assert got.n_batches == len(got.batch_events) > 1
    _check_decomposition(got, len(zipf))


def test_closed_loop_auto_equals_reference(corpus):
    ref_ex, port_ex = _executors(corpus, "auto")
    trace = make_mixture_trace(corpus, n_queries=48, seed=12)
    want, got = _serve_both(ref_ex, port_ex, trace, "closed", None,
                            batcher=_deadline(float("inf")))
    _assert_reports_equal(want, got, timed=False)
    assert len(got.plan_queries) >= 2 and "plans:" in got.summary()


def test_serve_report_is_per_run_and_warm_cache_carries_over(k_sweep, zipf):
    """A second run_trace on one server reports only its own queries and
    sees the first run's cache, in both packages alike."""
    ref_ex, port_ex = k_sweep
    trace = stamp_arrivals(zipf[:48], "poisson", rate_qps=500.0, seed=6)
    caches = _caches("lru")
    ref = RefServer(ref_ex, cache=caches[1], batcher=RefDeadlineBatcher(**SHAPE, max_wait_s=2e-3))
    port = GeoServer(port_ex, cache=caches[0], batcher=DeadlineBatcher(**SHAPE, max_wait_s=2e-3))
    for _ in range(2):
        want = ref.run_trace(trace, arrival="poisson", service_time=_service)
        got = port.run_trace(trace, arrival="poisson", service_time=_service)
        _assert_reports_equal(want, got)
    assert got.n_queries == 48 and got.cache_misses == 0


def test_guards_match_reference(k_sweep, zipf):
    ref_ex, port_ex = k_sweep
    with pytest.raises(ValueError, match="n_workers"):
        GeoServer(port_ex, n_workers=0)
    srv = GeoServer(port_ex, batcher=DeadlineBatcher(**SHAPE), n_workers=2)
    with pytest.raises(ValueError, match="open-loop"):
        srv.run_trace(zipf[:4])
    srv = GeoServer(port_ex, batcher=ShapeBucketedBatcher(**SHAPE))
    with pytest.raises(ValueError, match="DeadlineBatcher"):
        srv.run_trace(zipf[:4], arrival="poisson")
    # a telemetry handle attaches through the server and the factory; None
    # detaches the executor's
    from repro_torch.obs import Telemetry

    tel = Telemetry()
    fresh = make_executor("single", make_corpus(64, 20, seed=1), device="cpu", telemetry=tel)
    assert fresh.telemetry is tel and fresh.engine.metrics is tel.metrics
    srv = GeoServer(fresh, telemetry=Telemetry())
    assert srv.telemetry and fresh.telemetry is srv.telemetry
    port_ex.attach_telemetry(None)
    assert port_ex.telemetry is None
