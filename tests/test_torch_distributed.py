"""PyTorch port: the host side of document sharding and the mesh step
against the reference — partitioner ids, coverage grids, SATs and footprint
touch, the global IDF, every ``ShardedGeoIndex`` field of
``shard_corpus_np`` with its dtype, the sharded cost models and plan
choices (all exact), the mesh executor on a (1, 1) mesh, and the serve
step on a (2, 2, 2) pod × data × model mesh against the reference's
``make_serve_fn`` on 8 host devices in a subprocess (ids, scores and
counters exactly, torch on one CPU thread; small seeded corpora, CPU)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as RefMesh  # noqa: E402

from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.core import distributed as rd  # noqa: E402
from repro.core.planner import CostModel as RefCostModel  # noqa: E402
from repro.core.planner import Planner as RefPlanner  # noqa: E402
from repro.core.text_index import build_text_index_np as ref_build_text  # noqa: E402
from repro.core.text_index import global_idf_np as ref_global_idf  # noqa: E402
from repro.core.text_index import rescale_impacts_to_global as ref_rescale  # noqa: E402
from repro.corpus import pad_trace_batch as ref_pad  # noqa: E402
from repro.serving import make_executor as ref_make_executor  # noqa: E402
from repro_torch.core import CostModel, Planner, QueryBudgets  # noqa: E402
from repro_torch.core import distributed as pd  # noqa: E402
from repro_torch.core.text_index import build_text_index_np  # noqa: E402
from repro_torch.core.text_index import global_idf_np, rescale_impacts_to_global  # noqa: E402
from repro_torch.corpus import (  # noqa: E402
    make_corpus,
    make_mixture_trace,
    make_zipf_trace,
    pad_trace_batch,
)
from repro_torch.serving import make_executor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = dict(max_candidates=256, max_tiles=64, k_sweeps=4, sweep_budget=128, top_k=5)
GRID = 16
STATICS = ("grid", "n_terms", "block_size", "coverage_grid", "max_term_blocks", "layout",
           "max_term_segments")


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
    return trace, pad_trace_batch(trace), ref_pad(trace)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
@pytest.mark.parametrize("name", ["hash", "morton", "region"])
def test_partitioner_ids_equal_reference(name, n_shards, seed):
    c = make_corpus(n_docs=300 + 37 * seed, n_terms=40, seed=20 + seed)
    want = rd.resolve_partitioner(name).assign(c.doc_rects, n_shards)
    got = pd.resolve_partitioner(name).assign(c.doc_rects, n_shards)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert pd.resolve_partitioner(name).name == rd.resolve_partitioner(name).name


@pytest.mark.parametrize("seed", [0, 1])
def test_coverage_sat_and_touch_equal_reference(seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.05, 0.95, (300, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + rng.uniform(-0.01, 0.3, (300, 2)).astype(np.float32)], 1)
    rects[:7] = [0.25, 0.5, 0.5, 0.75]  # edges on cell boundaries
    amps = rng.uniform(-0.2, 1.0, 300).astype(np.float32)  # some padding (≤ 0)
    sats_ref, sats = [], []
    for part in np.array_split(np.arange(300), 5):
        want = rd.coverage_grid_np(rects[part], amps[part])
        got = pd.coverage_grid_np(rects[part], amps[part])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        sats_ref.append(rd.coverage_sat_np(want))
        sats.append(pd.coverage_sat_np(got))
        assert sats[-1].dtype == sats_ref[-1].dtype == np.float32
        np.testing.assert_array_equal(sats[-1], sats_ref[-1])
    q = rects[200:].reshape(25, 4, 4)
    qa = amps[200:].reshape(25, 4)
    np.testing.assert_array_equal(pd.footprint_touch_np(np.stack(sats), q, qa),
                                  rd.footprint_touch_np(np.stack(sats_ref), q, qa))
    # the step's own test (f32 floor, i32 clip) gives the same routing here
    got = pd.shard_touch(torch.from_numpy(np.stack(sats)), pd.COVERAGE_GRID,
                         torch.from_numpy(q), torch.from_numpy(qa))
    np.testing.assert_array_equal(got.numpy(), rd.footprint_touch_np(np.stack(sats_ref), q, qa))


def test_global_idf_and_rescale_equal_reference(corpus):
    want = ref_global_idf(corpus.doc_terms, corpus.n_terms)
    got = global_idf_np(corpus.doc_terms, corpus.n_terms)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    half = corpus.doc_terms[:150]
    for layout in ("docid", "impact"):
        r = ref_rescale(ref_build_text(half, corpus.n_terms, layout=layout), want)
        p = rescale_impacts_to_global(
            build_text_index_np(half, corpus.n_terms, layout=layout, device="cpu"), got)
        for name in ("impacts", "blk_max_impact"):
            a, b = np.asarray(getattr(r, name)), getattr(p, name).numpy()
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("layout", ["docid", "impact"])
@pytest.mark.parametrize("compress", ["none", "f16", "int8"])
def test_shard_corpus_fields_equal_reference(corpus, compress, layout):
    args = (corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
            corpus.n_terms, 3)
    want = rd.shard_corpus_np(*args, rd.RegionRangePartitioner(), grid=GRID,
                              compress=compress, layout=layout)
    got = pd.shard_corpus_np(*args, pd.RegionRangePartitioner(), grid=GRID,
                             compress=compress, layout=layout, device="cpu")
    for name in pd.ARRAY_FIELDS:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in STATICS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_shards == want.n_shards == 3
    # each shard's view reads the stacked tensor in place
    local, gids = got.shards[1]
    assert local.spatial.tp_rects.is_contiguous()
    assert local.spatial.tp_rects.data_ptr() == got.tp_rects[1].data_ptr()
    assert torch.equal(gids, got.doc_offset[1])


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_sharded_cost_models_and_plans_equal_reference(corpus, compress):
    rb, pb = RefBudgets(**BUDGETS), QueryBudgets(**BUDGETS)
    kw = dict(n_shards=3, grid=GRID, compress=compress, algorithm="auto", fused=True)
    ref = ref_make_executor("sharded", corpus, partitioner=rd.MortonPartitioner(),
                            budgets=rb, **kw)
    port = make_executor("sharded", corpus, partitioner=pd.MortonPartitioner(), budgets=pb,
                         device="cpu", **kw)
    args = (corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
            corpus.n_terms, 3)
    stacked = (rd.shard_corpus_np(*args, rd.MortonPartitioner(), grid=GRID, compress=compress),
               pd.shard_corpus_np(*args, pd.MortonPartitioner(), grid=GRID, compress=compress,
                                  device="cpu"))
    pairs = [
        (ref.planner.model, port.planner.model),
        (RefCostModel.from_sharded_index(stacked[0], rb),
         CostModel.from_sharded_index(stacked[1], pb)),
    ]
    for want, got in pairs:
        for name in ("df", "blk_mbr", "blk_count", "tile_sat", "_span_blocks", "_span_offsets"):
            a, b = np.asarray(getattr(want, name)), getattr(got, name)
            assert b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        for name in ("grid", "n_postings", "n_toeprints", "n_docs", "rect_slots",
                     "posting_bytes", "tp_bytes", "doc_bytes", "tp_id_bytes"):
            assert getattr(got, name) == getattr(want, name), name
    rp = RefPlanner(model=pairs[1][0], candidates=RefPlanner.make_candidates(rb, fused=True))
    pp = Planner(model=pairs[1][1], candidates=Planner.make_candidates(pb, fused=True))
    for q in make_mixture_trace(corpus, n_queries=40, seed=5):
        assert port.plan_query(q.terms, q.rects, q.amps).label == ref.plan_query(
            q.terms, q.rects, q.amps).label
        assert pp.plan_query(q.terms, q.rects, q.amps).label == rp.plan_query(
            q.terms, q.rects, q.amps).label


def _equal_to_reference(want, got):
    """ids, scores (bitwise, −inf included) and every counter (key order,
    dtype) exactly."""
    ids, scores = got.ids.numpy(), got.scores.numpy()
    assert ids.dtype == np.asarray(want.ids).dtype
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    assert scores.tobytes() == np.asarray(want.scores).tobytes()
    assert list(got.stats) == list(want.stats)
    for k, v in want.stats.items():
        a, b = np.asarray(v), np.asarray(got.stats[k])
        assert b.dtype == a.dtype and b.shape == a.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("variant", [
    dict(algorithm="k_sweep", fused=True, prune=True, compress="int8"),
    dict(algorithm="text_first", fused=True, prune=True, layout="impact"),
    dict(algorithm="geo_first"),
    dict(algorithm="auto", fused=True, prune=True),
])
def test_mesh_1x1_equals_reference(corpus, batch, variant):
    """One shard, one query slice: the port's step against the reference's
    ``MeshExecutor`` on ``jax.devices()[:1]`` — ids, scores and every
    counter (sorted keys, dtypes) exactly."""
    _, q, rq = batch
    kw = dict(variant)
    prune = kw.pop("prune", False)
    ref = ref_make_executor(
        "mesh", corpus, mesh=RefMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                                     ("data", "model")),
        partitioner=rd.HashPartitioner(), routing="footprint", grid=GRID,
        budgets=RefBudgets(**BUDGETS, prune=prune), **kw)
    port = make_executor(
        "mesh", corpus, mesh=pd.make_mesh((1, 1), ("data", "model"), device="cpu"),
        partitioner=pd.HashPartitioner(), routing="footprint", grid=GRID,
        budgets=QueryBudgets(**BUDGETS, prune=prune), device="cpu", **kw)
    # both clamp the sweep budget to the stacked store
    assert dataclasses.asdict(port.budgets) == dataclasses.asdict(ref.budgets)
    _equal_to_reference(ref.run(rq), port.run(q))


def test_mesh_guards(corpus, batch):
    _, q, _ = batch
    with pytest.raises(ValueError, match="axis names"):
        pd.make_mesh((2, 1), ("data",), device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        pd.make_mesh((2, 2), ("data", "data"), device="cpu")
    with pytest.raises(ValueError, match="query axis"):
        make_executor("mesh", corpus, mesh=pd.make_mesh((2,), ("data",), device="cpu"),
                      device="cpu")
    ex = make_executor("mesh", corpus, mesh=pd.make_mesh((1, 3), ("data", "model"),
                                                         device="cpu"),
                       grid=GRID, budgets=QueryBudgets(**BUDGETS), device="cpu")
    with pytest.raises(ValueError, match="query slices"):
        ex.run(q)  # 16 queries over 3 slices
    with pytest.raises(ValueError, match="no axis 'pod'"):
        pd.make_serve_fn(ex.mesh, ex.budgets, doc_axes=("pod", "data"))
    with pytest.raises(ValueError, match="mesh's device"):
        make_executor("mesh", corpus, mesh=ex.mesh, device="meta")


def test_mesh_step_on_pod_data_model_mesh_equals_reference():
    """The port's step on a (2, 2, 2) pod × data × model mesh against the
    reference's ``make_serve_fn`` on 8 host devices.  The first query slice
    repeats one small footprint, so the two slices visit different shard
    sets.  ids, scores (bitwise), ``shards_touched`` per query,
    ``shards_visited`` per query slice and every other counter exactly."""
    code = textwrap.dedent("""
        import json, numpy as np, jax, torch
        torch.set_num_threads(1)
        from repro.core import QueryBudgets as RB
        from repro.core import distributed as rd
        from repro.core.algorithms import QueryBatch as RQ
        from repro_torch.core import QueryBudgets as PB
        from repro_torch.core import distributed as pd
        from repro_torch.core.algorithms import QueryBatch as PQ
        from repro_torch.corpus import make_corpus, make_zipf_trace, pad_trace_batch

        assert len(jax.devices()) == 8
        corpus = make_corpus(n_docs=480, n_terms=60, seed=13)
        q = pad_trace_batch(make_zipf_trace(corpus, n_queries=16, pool_size=10, seed=14))
        terms, rects, amps = q.terms.numpy(), q.rects.numpy().copy(), q.amps.numpy().copy()
        # slice 0: eight copies of query 0, its footprint cut to the middle
        # fifth of its first rect
        r0 = rects[0, 0]
        c, h = (r0[:2] + r0[2:]) / 2, (r0[2:] - r0[:2]) / 10
        terms[:8] = terms[0]
        rects[:8] = [1.0, 1.0, 0.0, 0.0]
        rects[:8, 0] = np.concatenate([c - h, c + h])
        amps[:8] = 0.0
        amps[:8, 0] = 1.0
        args = (corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
                corpus.n_terms, 4)
        ref_idx = rd.shard_corpus_np(*args, rd.RegionRangePartitioner(), grid=16)
        idx = pd.shard_corpus_np(*args, pd.RegionRangePartitioner(), grid=16, device="cpu")
        names = ("pod", "data", "model")
        ref_mesh = jax.make_mesh((2, 2, 2), names)
        mesh = pd.make_mesh((2, 2, 2), names, device="cpu")
        bud = dict(max_candidates=256, max_tiles=64, k_sweeps=4, sweep_budget=96, top_k=5)
        out = {}
        for algo in ("k_sweep", "text_first"):
            kw = dict(doc_axes=("pod", "data"), query_axis="model", algorithm=algo,
                      fused=True, with_routing=True)
            # the reference's step takes the index's statics as arguments;
            # the port's reads them from the index
            statics = dict(grid=16, n_terms=corpus.n_terms, with_stats=True,
                           max_term_blocks=idx.max_term_blocks, layout=idx.layout,
                           max_term_segments=idx.max_term_segments)
            ref_serve = rd.make_serve_fn(ref_mesh, RB(**bud, prune=True), **kw, **statics)
            serve = pd.make_serve_fn(mesh, PB(**bud, prune=True), **kw)
            with ref_mesh:
                rids, rsc, rst = ref_serve(ref_idx, RQ(terms, rects, amps))
            ids, sc, st = serve(idx, PQ(*(torch.from_numpy(x) for x in (terms, rects, amps))))
            rids, rsc, ids, sc = np.asarray(rids), np.asarray(rsc), ids.numpy(), sc.numpy()
            rst = {k: np.asarray(v) for k, v in rst.items()}
            st = {k: v.numpy() for k, v in st.items()}
            out[algo] = {
                "ids": bool(np.array_equal(rids, ids)),
                "scores": rsc.tobytes() == sc.tobytes(),
                "keys": list(rst) == list(st),
                "touched": bool(np.array_equal(rst["shards_touched"], st["shards_touched"])),
                "visited": [st["shards_visited"].tolist(), rst["shards_visited"].tolist()],
                "dtypes": all(rst[k].dtype == st[k].dtype for k in rst),
                "counters": all(np.array_equal(st[k], rst[k]) for k in rst),
                "live": [int((ids[:8] >= 0).sum()), int((ids[8:] >= 0).sum())],
            }
        print(json.dumps(out))
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    for algo, r in out.items():
        assert r["ids"] and r["scores"] and r["keys"] and r["dtypes"], (algo, r)
        assert r["touched"] and r["counters"], (algo, r)
        visited, want = r["visited"]
        assert visited == want and len(visited) == 2, (algo, r)
        assert visited[0] < visited[1], (algo, r)  # the slices route apart
        assert min(r["live"]) > 0, (algo, r)


def test_partitioner_strings_rejected_outside_cli(corpus):
    args = (corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
            corpus.n_terms, 2)
    with pytest.raises(TypeError, match="CLI boundary"):
        pd.shard_corpus_np(*args, "hash", device="cpu")
    with pytest.raises(TypeError, match="Partitioner instance"):
        make_executor("sharded", corpus, n_shards=2, partitioner="region", device="cpu")
    with pytest.raises(ValueError, match="unknown partitioner"):
        pd.resolve_partitioner("nope")
    with pytest.raises(TypeError):
        pd.resolve_partitioner(3)
    assert isinstance(pd.resolve_partitioner(None), pd.MortonPartitioner)
    assert isinstance(pd.resolve_partitioner("geo"), pd.MortonPartitioner)
