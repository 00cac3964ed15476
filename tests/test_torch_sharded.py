"""PyTorch port: the doc-sharded scatter-gather executor against the
reference's — ids, scores (bitwise) and every counter (float64 sums, in
shard order) exactly, torch on one CPU thread, for K-SWEEP fused and
unfused, pruned, pruned fused TEXT-FIRST, GEO-FIRST and ``auto``, with
overlapped and sequential shard dispatch; the port's own routing pairs
(footprint == broadcast, and region-footprint == hash-broadcast, bitwise);
the mesh executor against the sharded one (rtol 1e-6 on counter sums, as
the reference's tests); ``GeoServer`` over a footprint-routed sharded
executor equal to the reference's report field for field (open loop,
injected service time; collected scores within rtol 1e-6); and
``make_executor``'s validation (small seeded corpora, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.core import distributed as rd  # noqa: E402
from repro.corpus import pad_trace_batch as ref_pad  # noqa: E402
from repro.serving import DeadlineBatcher as RefDeadlineBatcher  # noqa: E402
from repro.serving import GeoServer as RefServer  # noqa: E402
from repro.serving import make_cache as ref_make_cache  # noqa: E402
from repro.serving import make_executor as ref_make_executor  # noqa: E402
from repro_torch.core import QueryBudgets  # noqa: E402
from repro_torch.core import distributed as pd  # noqa: E402
from repro_torch.core.algorithms import QueryBatch  # noqa: E402
from repro_torch.corpus import (  # noqa: E402
    make_corpus,
    make_zipf_trace,
    pad_trace_batch,
    stamp_arrivals,
)
from repro_torch.serving import (  # noqa: E402
    DeadlineBatcher,
    GeoServer,
    ShardedExecutor,
    make_cache,
    make_executor,
)

BUDGETS = dict(max_candidates=256, max_tiles=64, k_sweeps=4, sweep_budget=128, top_k=5)
GRID = 16
N_SHARDS = 3
VARIANTS = {
    "k_sweep": dict(algorithm="k_sweep"),
    "k_sweep_fused": dict(algorithm="k_sweep", fused=True),
    "k_sweep_pruned_fused": dict(algorithm="k_sweep", fused=True, prune=True),
    "text_first_pruned_fused": dict(algorithm="text_first", fused=True, prune=True),
    "geo_first": dict(algorithm="geo_first"),
    "auto": dict(algorithm="auto", fused=True, prune=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, so its sums add in one fixed order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=400, n_terms=80, seed=3)


@pytest.fixture(scope="module")
def batch(corpus):
    trace = make_zipf_trace(corpus, n_queries=16, pool_size=12, seed=4)
    return pad_trace_batch(trace), ref_pad(trace)


@pytest.fixture(scope="module")
def reference(corpus, batch):
    """Each variant's reference result, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = dict(VARIANTS[name])
            prune = kw.pop("prune", False)
            ex = ref_make_executor(
                "sharded", corpus, n_shards=N_SHARDS, partitioner=rd.RegionRangePartitioner(),
                routing="footprint", grid=GRID, budgets=RefBudgets(**BUDGETS, prune=prune), **kw)
            cache[name] = ex.run(batch[1])
        return cache[name]

    return get


def _port(corpus, name):
    kw = dict(VARIANTS[name])
    prune = kw.pop("prune", False)
    return make_executor(
        "sharded", corpus, n_shards=N_SHARDS, partitioner=pd.RegionRangePartitioner(),
        routing="footprint", grid=GRID, budgets=QueryBudgets(**BUDGETS, prune=prune),
        device="cpu", **kw)


def _bitwise(want, got, counters=True):
    """ids exactly; scores bitwise (−inf included); every counter exactly,
    with its dtype.  Bitwise against the reference holds on this module's
    batch; on other queries the port's engine, the single one too, can
    round a score 1 ulp away from the reference's compiled step."""
    assert got.ids.dtype == np.asarray(want.ids).dtype
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    assert np.asarray(got.scores).tobytes() == np.asarray(want.scores).tobytes()
    if not counters:
        return
    assert set(got.stats) == set(want.stats)
    for k, v in want.stats.items():
        a, b = np.asarray(v), np.asarray(got.stats[k])
        assert b.dtype == a.dtype and b.shape == a.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_executor_equals_reference(corpus, batch, reference, name, overlap):
    ex = _port(corpus, name)
    assert isinstance(ex, ShardedExecutor) and ex.overlap
    if not overlap:  # the same engines, each shard finished before the next
        ex = ShardedExecutor(ex.engines, ex.global_ids, ex.algorithm, routing=ex.routing,
                             overlap=False, **ex.kw)
    if name == "auto":
        assert ex.planner is not None
    _bitwise(reference(name), ex.run(batch[0]))


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_footprint_equals_broadcast_bitwise(corpus, batch, n_shards):
    """The port's own routing pairs: footprint == broadcast on the same
    partition, and region-footprint == hash-broadcast (partition-independent
    impacts through the global IDF)."""
    kw = dict(algorithm="k_sweep", budgets=QueryBudgets(**BUDGETS, prune=True), fused=True,
              grid=GRID, n_shards=n_shards, device="cpu")
    hash_bc = make_executor("sharded", corpus, partitioner=pd.HashPartitioner(),
                            routing="broadcast", **kw)
    region = make_executor("sharded", corpus, partitioner=pd.RegionRangePartitioner(),
                           routing="footprint", **kw)
    region_bc = ShardedExecutor(region.engines, region.global_ids, "k_sweep",
                                routing="broadcast", fused=True)
    want, got = hash_bc.run(batch[0]), region.run(batch[0])
    _bitwise(want, got, counters=False)
    _bitwise(region_bc.run(batch[0]), got, counters=False)
    touched = got.stats["shards_touched"]
    assert touched.shape == (16,) and np.all((touched >= 0) & (touched <= n_shards))
    assert float(got.stats["shards_visited"]) <= n_shards
    assert "shards_touched" not in want.stats


def test_footprint_equals_single_device_bitwise(corpus, batch):
    b = QueryBudgets(**BUDGETS)
    single = make_executor("single", corpus, budgets=b, grid=GRID, device="cpu")
    routed = make_executor("sharded", corpus, partitioner=pd.RegionRangePartitioner(),
                           routing="footprint", budgets=b, grid=GRID, n_shards=4, device="cpu")
    a, g = single.run(batch[0]), routed.run(batch[0])
    np.testing.assert_array_equal(g.ids, a.ids.numpy())
    assert g.scores.tobytes() == a.scores.numpy().tobytes()


def test_routing_decisions_and_unreachable_footprint(corpus):
    ex = make_executor("sharded", corpus, partitioner=pd.RegionRangePartitioner(),
                       routing="footprint", budgets=QueryBudgets(**BUDGETS), grid=GRID,
                       n_shards=8, device="cpu")
    widths = [0.01, 0.05, 0.1, 0.2, 0.4, 0.6]
    rects = np.zeros((len(widths), 1, 4), dtype=np.float32)
    for i, w in enumerate(widths):
        rects[i, 0] = [0.5 - w, 0.5 - w, 0.5 + w, 0.5 + w]
    q = QueryBatch(torch.zeros((len(widths), 1), dtype=torch.int32), torch.from_numpy(rects),
                   torch.ones((len(widths), 1)))
    _, touched = ex.route_batch(q)
    assert np.all(np.diff(touched) >= 0) and touched[-1] == 8
    far = QueryBatch(torch.zeros((1, 1), dtype=torch.int32),
                     torch.tensor([[[5.0, 5.0, 6.0, 6.0]]]), torch.ones((1, 1)))
    res = ex.run(far)
    assert np.all(res.ids == -1) and float(res.stats["shards_visited"]) == 0
    # an all-padding batch (the server's warm-up) is broadcast to every shard
    pad = QueryBatch(torch.full((2, 1), -1, dtype=torch.int32),
                     torch.tensor([[[1.0, 1.0, 0.0, 0.0]]] * 2), torch.zeros((2, 1)))
    assert float(ex.run(pad).stats["shards_visited"]) == 8


@pytest.mark.parametrize("prune", [False, True])
def test_mesh_equals_sharded(corpus, batch, prune):
    """The port's mesh step against its sharded executor on 4 shards: ids
    and scores after sorting each row by (−score, id), counter sums within
    rtol 1e-6 (the reference's comparison); an unreachable footprint gives
    −1 everywhere and zero counters."""
    kw = dict(partitioner=pd.RegionRangePartitioner(), routing="footprint", fused=True,
              budgets=QueryBudgets(**{**BUDGETS, "sweep_budget": 64}, prune=prune), grid=GRID,
              device="cpu")
    mesh = make_executor("mesh", corpus, mesh=pd.make_mesh((4, 1), ("data", "model"),
                                                           device="cpu"), **kw)
    host = make_executor("sharded", corpus, n_shards=4, **kw)
    got, want = mesh.run(batch[0]), host.run(batch[0])

    def by_score(ids, scores):
        o = np.lexsort((ids, -scores), axis=-1)
        return np.take_along_axis(ids, o, -1), np.take_along_axis(scores, o, -1)

    gi, gs = by_score(got.ids.numpy(), got.scores.numpy())
    wi, ws = by_score(want.ids, want.scores)
    np.testing.assert_array_equal(gi, wi)
    assert gs.tobytes() == ws.tobytes()
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        np.testing.assert_allclose(np.asarray(got.stats[k], np.float64).sum(),
                                   np.asarray(want.stats[k], np.float64).sum(), rtol=1e-6,
                                   err_msg=k)
    far = QueryBatch(torch.zeros((1, 1), dtype=torch.int32),
                     torch.tensor([[[5.0, 5.0, 6.0, 6.0]]]), torch.ones((1, 1)))
    res = mesh.run(far)
    assert torch.all(res.ids == -1)
    for k, v in res.stats.items():
        assert float(np.asarray(v, np.float64).sum()) == 0, k


def _service(raw) -> float:
    return 1e-3 + 2.5e-4 * raw.n_real + 1e-4 * raw.shape.d_terms


def test_geo_server_over_sharded_equals_reference(corpus):
    """Open loop with an injected service time: every report field of the
    port's server over its footprint-routed sharded executor equals the
    reference's (the routing summary included); collected ids and scores
    equal."""
    kw = dict(n_shards=2, routing="footprint", grid=GRID, algorithm="k_sweep", fused=True)
    ref_ex = ref_make_executor("sharded", corpus, partitioner=rd.RegionRangePartitioner(),
                               budgets=RefBudgets(**BUDGETS, prune=True), **kw)
    port_ex = make_executor("sharded", corpus, partitioner=pd.RegionRangePartitioner(),
                            budgets=QueryBudgets(**BUDGETS, prune=True), device="cpu", **kw)
    trace = stamp_arrivals(make_zipf_trace(corpus, n_queries=32, pool_size=12, d_terms=2,
                                           q_rects=2, seed=10), "poisson", rate_qps=900.0,
                           seed=3)
    shape = dict(max_batch=4, max_terms=2, max_rects=2, max_wait_s=2e-3)
    ref = RefServer(ref_ex, cache=ref_make_cache("lru", 16),
                    batcher=RefDeadlineBatcher(**shape), n_workers=2).run_trace(
        trace, arrival="poisson", collect_results=True, service_time=_service)
    got = GeoServer(port_ex, cache=make_cache("lru", 16), batcher=DeadlineBatcher(**shape),
                    n_workers=2).run_trace(trace, arrival="poisson", collect_results=True,
                                           service_time=_service)
    assert got.routing and got.routing.keys() == ref.routing.keys()
    assert got.n_batches > 4 and got.cache_hits > 0
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "results":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.ids, y.ids)
                np.testing.assert_array_equal(x.scores, y.scores)
        else:
            assert _plain(a) == _plain(b), f.name


@pytest.mark.parametrize("kind", ["single", "sharded"])
@pytest.mark.parametrize("name", ["k_sweep_pruned_fused", "text_first_pruned_fused", "geo_first"])
def test_scores_within_one_ulp_of_reference_on_two_term_trace(corpus, kind, name):
    """The ``GeoServer`` test's 2-term, 2-rect queries in one batch: ids,
    every counter and every score exactly, the single engine's as the
    sharded executor's.  (These scores were once 1 ulp off: the reference's
    compiled combine adds the pagerank term as one fused multiply-add, and
    ``ranking.combine_scores`` now rounds it once too.)"""
    kw = dict(VARIANTS[name])
    prune = kw.pop("prune", False)
    if kind == "sharded":
        kw.update(n_shards=2, routing="footprint")
    ref_kw = dict(kw, partitioner=rd.RegionRangePartitioner()) if kind == "sharded" else kw
    port_kw = dict(kw, partitioner=pd.RegionRangePartitioner()) if kind == "sharded" else kw
    ref_ex = ref_make_executor(kind, corpus, grid=GRID, budgets=RefBudgets(**BUDGETS, prune=prune),
                               **ref_kw)
    port_ex = make_executor(kind, corpus, grid=GRID, budgets=QueryBudgets(**BUDGETS, prune=prune),
                            device="cpu", **port_kw)
    trace = make_zipf_trace(corpus, n_queries=32, pool_size=12, d_terms=2, q_rects=2, seed=10)
    want = ref_ex.run(ref_pad(trace, max_terms=2, max_rects=2))
    got = port_ex.run(pad_trace_batch(trace, max_terms=2, max_rects=2))
    ids, scores = (np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in (got.ids, got.scores))
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    ref_scores = np.asarray(want.scores)
    assert np.isfinite(ref_scores).sum() > 0
    assert scores.dtype == ref_scores.dtype and scores.tobytes() == ref_scores.tobytes()
    for k, v in want.stats.items():
        np.testing.assert_array_equal(np.asarray(got.stats[k]), np.asarray(v), err_msg=k)


def _plain(x):
    """A report field as plain data (each package has its own dataclasses)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("case", [
    dict(kind="single", partitioner=pd.HashPartitioner(), match="only apply to"),
    dict(kind="single", routing="footprint", match="only apply to"),
    dict(kind="single", n_shards=2, match="only apply to"),
    dict(kind="sharded", routing="nearest", match="routing must be one of"),
    dict(kind="mesh", match="requires mesh="),
    dict(kind="mesh", use_pallas=True, match="host executors only"),
    dict(kind="ring", match="kind must be one of"),
])
def test_make_executor_validation(corpus, case):
    """The reference's validation messages, raised before any build."""
    case = dict(case)
    kind, match = case.pop("kind"), case.pop("match")
    ref_case = {k: (rd.HashPartitioner() if k == "partitioner" else v) for k, v in case.items()}
    with pytest.raises(ValueError, match=match):
        ref_make_executor(kind, corpus, grid=GRID, **ref_case)
    with pytest.raises(ValueError, match=match):
        make_executor(kind, corpus, grid=GRID, device="cpu", **case)


def test_stale_partition_kwarg_and_strings_rejected(corpus):
    with pytest.raises(TypeError, match="Partitioner API"):
        ShardedExecutor.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                              corpus.n_terms, corpus.pagerank, 2, partition="hash",
                              device="cpu")
    with pytest.raises(TypeError, match="CLI boundary"):
        ShardedExecutor.build(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                              corpus.n_terms, corpus.pagerank, 2, partitioner="hash",
                              device="cpu")
    from repro_torch.obs import Telemetry

    tel = Telemetry()
    ex = make_executor("sharded", corpus, n_shards=2, grid=GRID, device="cpu", telemetry=tel)
    assert ex.telemetry is tel and all(e.metrics is tel.metrics for e in ex.engines)
