"""PyTorch port: the geo serve step across processes.  Four ``gloo`` ranks
on the CPU (``repro_torch.launch.ranks.run_ranks``, torch on one thread per
rank), each holding its own row of the stacked index on a process mesh,
against the port's one-process loop on the same mesh shape and the
reference's ``make_serve_fn`` on 4 fake XLA devices in a subprocess: ids,
scores (bitwise, −inf included), every counter (bitwise), keys and dtypes.
Then ``GeoServer`` over the process ``MeshExecutor`` on rank 0, the geoweb
SMOKE cells over 4 ranks, and the guards (a wrong world size, a failing
rank, the worker loop's stop).  Every launch is bounded by a timeout."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import QueryBudgets  # noqa: E402
from repro_torch.core import distributed as pd  # noqa: E402
from repro_torch.core.algorithms import QueryBatch  # noqa: E402
from repro_torch.corpus import (  # noqa: E402
    make_corpus,
    make_mixture_trace,
    make_zipf_trace,
    pad_trace_batch,
    stamp_arrivals,
)
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DeadlineBatcher,
    GeoServer,
    MeshExecutor,
    make_cache,
    make_executor,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = dict(max_candidates=256, max_tiles=64, k_sweeps=4, sweep_budget=96, top_k=5)
GRID = 16
TIMEOUT_S = 240.0
MESHES = {
    "4x1": ((4, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
}
# (algorithm, fused, prune)
VARIANTS = (
    ("k_sweep", True, True),
    ("text_first", True, True),
    ("geo_first", False, False),
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, as in every rank, so sums add in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doc_axes(names):
    return tuple(a for a in ("pod", "data") if a in names)


def _step_inputs(n_shards):
    """The corpus, its stacked index over ``n_shards`` region shards (CPU)
    and an 8-query batch whose first half repeats one narrow footprint (the
    middle fifth of query 0's first rect), so routing masks shards."""
    corpus = make_corpus(n_docs=480, n_terms=60, seed=13)
    q = pad_trace_batch(make_zipf_trace(corpus, n_queries=8, pool_size=8, seed=14))
    terms, rects, amps = q.terms.numpy().copy(), q.rects.numpy().copy(), q.amps.numpy().copy()
    r0 = rects[0, 0]
    c, h = (r0[:2] + r0[2:]) / 2, (r0[2:] - r0[:2]) / 10
    terms[:4] = terms[0]
    rects[:4] = [1.0, 1.0, 0.0, 0.0]
    rects[:4, 0] = np.concatenate([c - h, c + h])
    amps[:4] = 0.0
    amps[:4, 0] = 1.0
    idx = pd.shard_corpus_np(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                             corpus.pagerank, corpus.n_terms, n_shards,
                             pd.RegionRangePartitioner(), grid=GRID, device="cpu")
    return idx, (terms, rects, amps)


def _run_step(mesh, idx, arrays):
    """Every variant × routing through ``make_serve_fn(mesh, ...)``: a dict
    of host arrays (ids, scores, each counter, the key order)."""
    doc_axes = _doc_axes(mesh.axis_names)
    query = QueryBatch(*(torch.from_numpy(a) for a in arrays))
    out = {}
    for algo, fused, prune in VARIANTS:
        for routing in (False, True):
            serve = pd.make_serve_fn(mesh, QueryBudgets(**BUDGETS, prune=prune),
                                     doc_axes=doc_axes, query_axis="model", algorithm=algo,
                                     fused=fused, with_routing=routing)
            ids, scores, stats = serve(idx, query)
            tag = f"{algo}/{fused}/{prune}/{routing}"
            out[f"{tag}/ids"], out[f"{tag}/scores"] = ids.numpy(), scores.numpy()
            out[f"{tag}/keys"] = np.array(list(stats))
            for k, v in stats.items():
                out[f"{tag}/stats/{k}"] = v.numpy()
    return out


def _step_rank(rank, shape, names):
    torch.set_num_threads(1)
    mesh = pd.make_process_mesh(shape, names, device="cpu")
    doc_axes = _doc_axes(names)
    idx, arrays = _step_inputs(int(np.prod([mesh.shape[a] for a in doc_axes])))
    return _run_step(mesh, pd.shard_rows(idx, mesh.shard_of(doc_axes)), arrays)


REF_CODE = textwrap.dedent("""
    import sys, numpy as np, jax, torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    from test_torch_mesh_procs import BUDGETS, GRID, MESHES, VARIANTS, _doc_axes, _step_inputs
    from repro.core import QueryBudgets as RB
    from repro.core import distributed as rd
    from repro.core.algorithms import QueryBatch as RQ
    from repro_torch.corpus import make_corpus

    assert len(jax.devices()) == 4
    corpus = make_corpus(n_docs=480, n_terms=60, seed=13)
    out = {{}}
    for name in [{name!r}]:
        shape, names = MESHES[name]
        doc_axes = _doc_axes(names)
        n_shards = int(np.prod([dict(zip(names, shape))[a] for a in doc_axes]))
        idx, (terms, rects, amps) = _step_inputs(n_shards)
        ref_idx = rd.shard_corpus_np(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                                     corpus.pagerank, corpus.n_terms, n_shards,
                                     rd.RegionRangePartitioner(), grid=GRID)
        mesh = jax.make_mesh(shape, names)
        statics = dict(grid=GRID, n_terms=corpus.n_terms, with_stats=True,
                       max_term_blocks=idx.max_term_blocks, layout=idx.layout,
                       max_term_segments=idx.max_term_segments)
        for algo, fused, prune in VARIANTS:
            for routing in (False, True):
                serve = rd.make_serve_fn(mesh, RB(**BUDGETS, prune=prune), doc_axes=doc_axes,
                                         query_axis="model", algorithm=algo, fused=fused,
                                         with_routing=routing, **statics)
                with mesh:
                    ids, scores, stats = serve(ref_idx, RQ(terms, rects, amps))
                tag = f"{{name}}/{{algo}}/{{fused}}/{{prune}}/{{routing}}"
                out[tag + "/ids"], out[tag + "/scores"] = np.asarray(ids), np.asarray(scores)
                out[tag + "/keys"] = np.array(list(stats))
                for k, v in stats.items():
                    out[f"{{tag}}/stats/{{k}}"] = np.asarray(v)
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's step on 4 fake XLA devices for every variant and
    routing, one subprocess per mesh, all started with the module's first
    test (the step tests, which read them, come last); ``arrays(mesh)``
    loads a mesh's ``.npz``."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name in MESHES:
        code = REF_CODE.format(tests=os.path.join(ROOT, "tests"), name=name,
                               path=str(tmp / f"{name}.npz"))
        procs[name] = subprocess.Popen([sys.executable, "-c", code], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    box = {}

    def arrays(name):
        if name not in box:
            proc = procs[name]
            try:
                _, err = proc.communicate(timeout=TIMEOUT_S)
            finally:
                proc.kill()
            assert proc.returncode == 0, err[-3000:]
            npz = dict(np.load(tmp / f"{name}.npz"))
            box[name] = {k[len(name) + 1:]: v for k, v in npz.items()}
        return box[name]

    yield arrays
    for proc in procs.values():
        proc.kill()
        proc.wait()


def _assert_same(want: dict, got: dict, what: str):
    """Every key: dtype, shape and bytes equal (scores bitwise, −inf
    included; counters exactly; the stats key order)."""
    assert sorted(got) == sorted(want), what
    for k, a in want.items():
        b = got[k]
        assert b.dtype == a.dtype and b.shape == a.shape, (what, k, b.dtype, a.dtype)
        assert b.tobytes() == a.tobytes(), (what, k)


# -- GeoServer on rank 0 -------------------------------------------------------

SERVER_MESH = ((2, 2), ("data", "model"))


def _service(raw) -> float:
    """Injected batch duration: a deterministic function of the batch."""
    return 1e-3 + 2.5e-4 * raw.n_real + 1e-4 * raw.shape.d_terms


def _server_corpus():
    return make_corpus(n_docs=600, n_terms=100, seed=21)


def _server_executor(corpus, mesh):
    return make_executor(
        "mesh", corpus, mesh=mesh, algorithm="auto", fused=True, routing="footprint",
        partitioner=pd.RegionRangePartitioner(), grid=GRID,
        budgets=QueryBudgets(**BUDGETS, prune=True), device="cpu")


def _serve(corpus, ex):
    """A short zipf trace (and mixture queries, for more plans) stamped
    Poisson, open loop with an injected service time: deterministic."""
    trace = (make_mixture_trace(corpus, n_queries=24, seed=22)
             + make_zipf_trace(corpus, n_queries=40, pool_size=12, d_terms=4, q_rects=2,
                               seed=23))
    trace = stamp_arrivals(trace, "poisson", rate_qps=700.0, seed=24)
    srv = GeoServer(ex, cache=make_cache("landlord", 16), n_workers=2, coalesce=True,
                    batcher=DeadlineBatcher(max_batch=4, max_terms=4, max_rects=2,
                                            max_wait_s=3e-3, batch_sizes=[2, 4]))
    return srv.run_trace(trace, arrival="poisson", service_time=_service,
                         collect_results=True)


def _server_rank(rank):
    torch.set_num_threads(1)
    corpus = _server_corpus()
    ex = _server_executor(corpus, pd.make_process_mesh(*SERVER_MESH, device="cpu"))
    if rank:
        return ex.serve_forever()
    runs, run = [], ex.run
    ex.run = lambda *a, **kw: runs.append(1) or run(*a, **kw)  # count rank 0's batches
    try:
        return _serve(corpus, ex), len(runs)
    finally:
        ex.close()


def test_geoserver_on_rank_0_equals_one_process_mesh():
    outs = run_ranks(_server_rank, 4, timeout_s=TIMEOUT_S)
    got, n_runs = outs[0]
    corpus = _server_corpus()
    want = _serve(corpus, _server_executor(corpus, pd.make_mesh(*SERVER_MESH, device="cpu")))
    for f in dataclasses.fields(want):
        if f.name in ("wall_s", "results"):
            continue
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "batch_events":
            a, b = [dataclasses.astuple(e) for e in a], [dataclasses.astuple(e) for e in b]
        if isinstance(a, np.ndarray) or (isinstance(a, dict) and any(
                isinstance(v, np.ndarray) for v in a.values())):
            a, b = repr(a), repr(b)
        assert b == a, f.name
    assert len(got.results) == len(want.results)
    for w, g in zip(want.results, got.results):
        assert g.ids.dtype == w.ids.dtype and np.array_equal(g.ids, w.ids)
        assert np.asarray(g.scores).tobytes() == np.asarray(w.scores).tobytes()
    # the followers ran every batch rank 0 ran (the warm-up's included)
    assert outs[1] == outs[2] == outs[3] == n_runs > got.n_batches
    assert len(got.plan_queries) >= 2 and got.n_batches > 4


# -- geoweb ------------------------------------------------------------------

def _geoweb_outputs(mesh):
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_cell

    spec = get_arch("geoweb")
    smoke = dataclasses.replace(spec, config=spec.smoke_config)
    out = {}
    for shape in spec.shapes:
        cell = build_cell(smoke, shape, mesh)
        ids, scores, stats = cell.fn(*cell.args)
        out[f"{shape.name}/ids"], out[f"{shape.name}/scores"] = ids.numpy(), scores.numpy()
        out[f"{shape.name}/keys"] = np.array(list(stats))
        for k, v in stats.items():
            out[f"{shape.name}/stats/{k}"] = v.numpy()
        if isinstance(mesh, pd.ProcessMesh):
            assert cell.args[0].n_shards == 1  # the rank's row only
    return out


def _geoweb_rank(rank):
    torch.set_num_threads(1)
    return _geoweb_outputs(pd.make_process_mesh((4, 1), ("data", "model"), device="cpu"))


def test_geoweb_smoke_cells_over_4_ranks_equal_one_process():
    outs = run_ranks(_geoweb_rank, 4, timeout_s=TIMEOUT_S)
    want = _geoweb_outputs(pd.make_mesh((4, 1), ("data", "model"), device="cpu"))
    for rank, got in enumerate(outs):
        _assert_same(want, got, f"geoweb rank {rank}")
    assert all((want[f"{s}/ids"] >= 0).sum() > 0 for s in
               ("serve_ksweep", "serve_textfirst", "serve_geofirst"))


# -- guards --------------------------------------------------------------------

def _guard_rank(rank):
    """Each guard's message on this rank, then one batch through a 2-rank
    executor and its stop."""
    torch.set_num_threads(1)
    msgs = {}
    for key, call in (
        ("world", lambda: pd.make_process_mesh((2, 2), ("data", "model"), device="cpu")),
        ("cuda", lambda: pd.make_process_mesh((2, 1), ("data", "model"))),
    ):
        try:
            call()
        except (ValueError, RuntimeError) as e:
            msgs[key] = f"{type(e).__name__}: {e}"
    mesh = pd.make_process_mesh((2, 1), ("data", "model"), device="cpu")
    corpus = make_corpus(n_docs=200, n_terms=40, seed=5)
    ex = make_executor("mesh", corpus, mesh=mesh, grid=GRID, budgets=QueryBudgets(**BUDGETS),
                       device="cpu")
    serve = pd.make_serve_fn(mesh, ex.budgets)
    whole = pd.shard_corpus_np(corpus.doc_terms, corpus.doc_rects, corpus.doc_amps,
                               corpus.pagerank, corpus.n_terms, 2, device="cpu")
    batch = pad_trace_batch(make_zipf_trace(corpus, n_queries=4, pool_size=4, seed=6))
    try:
        serve(whole, batch)
    except ValueError as e:
        msgs["stacked"] = str(e)
    try:  # the planner must read the whole stacked index, not a row
        MeshExecutor(mesh, serve, ex.index, 5, algorithm="auto")
    except ValueError as e:
        msgs["auto"] = str(e)
    if rank:
        try:
            ex.run(batch)
        except RuntimeError as e:
            msgs["follower_run"] = str(e)
        msgs["served"] = ex.serve_forever()
        return msgs
    try:
        msgs["ids"] = ex.run(batch).ids.numpy()
    finally:
        ex.close()
    ex.close()  # a second close sends nothing
    try:
        ex.run(batch)
    except RuntimeError as e:
        msgs["closed"] = str(e)
    return msgs


def _raising_rank(rank):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails before the barrier")
    dist.barrier()  # rank 0 waits in a collective that never completes
    return rank


def test_process_mesh_guards():
    with pytest.raises(RuntimeError, match="init_process_group"):
        pd.make_process_mesh((1, 1), ("data", "model"), device="cpu")
    idx, _ = _step_inputs(2)
    with pytest.raises(IndexError, match="shard 2 of an index of 2"):
        pd.shard_rows(idx, 2)
    row = pd.shard_rows(idx, 1)
    assert row.n_shards == 1 and row.max_term_blocks == idx.max_term_blocks
    assert all(torch.equal(getattr(row, f)[0], getattr(idx, f)[1]) for f in pd.ARRAY_FIELDS)
    outs = run_ranks(_guard_rank, 2, timeout_s=TIMEOUT_S)
    for rank, m in enumerate(outs):
        assert "has 2 ranks" in m["world"] and "needs 4" in m["world"], m
        if not torch.cuda.is_available():  # the default device is CUDA, no fallback
            assert "CUDA is not available" in m["cuda"], m
        assert "this rank's row" in m["stacked"], m
        assert "MeshExecutor.from_index" in m["auto"], m
    assert "rank 0 runs the batches" in outs[1]["follower_run"]
    assert outs[1]["served"] == 1  # the one batch, then the stop
    assert "closed" in outs[0]["closed"]
    corpus = make_corpus(n_docs=200, n_terms=40, seed=5)
    want = make_executor("mesh", corpus, mesh=pd.make_mesh((2, 1), ("data", "model"),
                                                           device="cpu"),
                         grid=GRID, budgets=QueryBudgets(**BUDGETS), device="cpu")
    batch = pad_trace_batch(make_zipf_trace(corpus, n_queries=4, pool_size=4, seed=6))
    np.testing.assert_array_equal(outs[0]["ids"], want.run(batch).ids.numpy())


def test_failing_rank_ends_the_run_not_hangs():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as e:
        run_ranks(_raising_rank, 2, timeout_s=TIMEOUT_S)
    assert "rank 1 fails before the barrier" in str(e.value)
    assert time.monotonic() - t < TIMEOUT_S / 4
    with pytest.raises(ValueError, match="backend"):
        run_ranks(_raising_rank, 2, backend="mpi")


# -- the step against the loop and the reference (last: it waits for the
# reference subprocess the first test started) ---------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_process_step_equals_loop_and_reference(mesh_name, reference):
    shape, names = MESHES[mesh_name]
    outs = run_ranks(_step_rank, 4, args=(shape, names), timeout_s=TIMEOUT_S)
    doc_axes = _doc_axes(names)
    idx, arrays = _step_inputs(int(np.prod([dict(zip(names, shape))[a] for a in doc_axes])))
    loop = _run_step(pd.make_mesh(shape, names, device="cpu"), idx, arrays)
    # every rank holds the whole batch's result, equal to the loop's
    for rank, got in enumerate(outs):
        _assert_same(loop, got, f"rank {rank} vs the loop")
    _assert_same(reference(mesh_name), outs[0], "rank 0 vs the reference")
    # routing masked shards, and every variant found hits
    for algo, fused, prune in VARIANTS:
        tag = f"{algo}/{fused}/{prune}/True"
        assert loop[f"{tag}/stats/shards_touched"].min() < idx.n_shards, tag
        assert (loop[f"{tag}/ids"] >= 0).sum() > 0, tag
