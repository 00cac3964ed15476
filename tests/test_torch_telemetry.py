"""PyTorch port: the obs package (metrics, spans, planner audit, events,
trace validator) and its hooks in ``GeoServer`` and the executors, against
the reference's.

Open loop with an injected service time runs on a virtual clock, so the two
packages' exports are compared for equality: the ``trace_event`` JSON,
``to_json()``, ``to_prometheus()``, the event JSONL and ``stage_sums()``,
across workers × coalescing × deadline, on the reference's deterministic
row executor and its twin here.  The planner audit of an ``auto`` executor
on a small corpus is equal line for line.  The executors' own spans are
host wall clock, so those are compared by track, name and args.  Attaching
telemetry changes no id, score, stat or latency.  Both validators accept
the port's traces and the port's rejects what the reference's rejects."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.core import QueryBudgets as RefBudgets  # noqa: E402
from repro.core import distributed as rd  # noqa: E402
from repro.serving import DeadlineBatcher as RefDeadlineBatcher  # noqa: E402
from repro.serving import GeoServer as RefServer  # noqa: E402
from repro.serving import LRUCache as RefLRUCache  # noqa: E402
from repro.serving import make_cache as ref_make_cache  # noqa: E402
from repro.serving import make_executor as ref_make_executor  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import QueryBudgets  # noqa: E402
from repro_torch.core import distributed as pd  # noqa: E402
from repro_torch.core.algorithms import TopKResult  # noqa: E402
from repro_torch.corpus import make_corpus, make_zipf_trace, stamp_arrivals  # noqa: E402
from repro_torch.corpus.synth import TraceQuery  # noqa: E402
from repro_torch.device import to_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DeadlineBatcher,
    GeoServer,
    LRUCache,
    make_cache,
    make_executor,
)

from test_multiworker_serving import RowExecutor as RefRowExecutor  # noqa: E402
from test_multiworker_serving import _pool_query, _random_trace, _service  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
WAITS = (0.0, 2e-3, float("inf"))


class RowExecutor:
    """The reference's ``RowExecutor`` test double for the port's server:
    each output row a pure function of its own query's terms."""

    top_k = 4

    def run(self, batch):
        terms = to_numpy(batch.terms)
        B = terms.shape[0]
        base = terms.max(axis=1).astype(np.int64)  # padding rows → -1
        ids = (base[:, None] * 16 + np.arange(self.top_k)).astype(np.int32)
        tsum = np.where(terms >= 0, terms, 0).sum(axis=1).astype(np.float32)
        scores = tsum[:, None] - np.arange(self.top_k, dtype=np.float32)
        return TopKResult(ids=ids, scores=scores, stats={"bytes_seq": np.ones(B)})


def _port_trace(trace):
    """The reference's trace as the port's TraceQuery objects (same arrays)."""
    return [TraceQuery(q.terms, q.rects, q.amps, q.arrival_s) for q in trace]


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


def _reports_equal(want, got, skip=()):
    for f in dataclasses.fields(want):
        if f.name not in ("results", *skip):
            assert _plain(getattr(got, f.name)) == _plain(getattr(want, f.name)), f.name


def _servers(workers, coalesce, wait, with_cache, ref_tel, tel, max_batch=8):
    shape = dict(max_batch=max_batch, max_terms=8, max_rects=4, max_wait_s=wait)
    ref = RefServer(RefRowExecutor(), cache=RefLRUCache(64) if with_cache else None,
                    batcher=RefDeadlineBatcher(**shape), n_workers=workers,
                    coalesce=coalesce, telemetry=ref_tel)
    port = GeoServer(RowExecutor(), cache=LRUCache(64) if with_cache else None,
                     batcher=DeadlineBatcher(**shape), n_workers=workers,
                     coalesce=coalesce, telemetry=tel)
    return ref, port


def _exports_equal(ref_tel, tel, tmp_path):
    """Every export of the port's handle equals the reference's, the written
    files byte for byte."""
    assert tel.tracer.to_trace_events() == ref_tel.tracer.to_trace_events()
    assert tel.metrics.to_json() == ref_tel.metrics.to_json()
    assert tel.metrics.to_prometheus() == ref_tel.metrics.to_prometheus()
    assert tel.events.events == ref_tel.events.events
    assert tel.tracer.stage_sums() == ref_tel.tracer.stage_sums()
    for name, write in (("trace.json", lambda t, p: t.tracer.write(p)),
                        ("events.jsonl", lambda t, p: t.events.to_jsonl(p)),
                        ("audit.jsonl", lambda t, p: t.audit.to_jsonl(p))):
        write(ref_tel, str(tmp_path / f"ref_{name}"))
        write(tel, str(tmp_path / f"port_{name}"))
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"ref_{name}").read_bytes()


@pytest.mark.parametrize("wait", WAITS)
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_open_loop_exports_equal_reference(workers, coalesce, wait, tmp_path):
    """The reference's span/metrics grid (tests/test_telemetry.py): the
    port's exports equal the reference's for the same trace, its stage sums
    equal its report's lists exactly, both validators accept its trace, its
    histograms reconstruct the report's percentiles to the bucket, and the
    same server without telemetry gives the same report."""
    seed = (workers + 2 * coalesce + 3 * WAITS.index(wait)) % 4
    kind = ("poisson", "bursty")[seed % 2]
    with_cache = seed % 3 == 0
    trace = _random_trace(seed, kind=kind)
    ref_tel, tel = ref_obs.Telemetry(), obs.Telemetry()
    ref, port = _servers(workers, coalesce, wait, with_cache, ref_tel, tel)
    kw = dict(warmup=False, arrival=kind, service_time=_service)
    want = ref.run_trace(trace, **kw)
    got = port.run_trace(_port_trace(trace), **kw)
    _reports_equal(want, got)
    _exports_equal(ref_tel, tel, tmp_path)

    tot, bw, qw, svc = tel.tracer.stage_sums()
    assert (tot, bw, qw, svc) == (got.latencies_s, got.batch_wait_s, got.queue_wait_s,
                                  got.service_s)
    trace_json = tel.tracer.to_trace_events()
    assert obs.validate_trace(trace_json) == [] and ref_obs.validate_trace(trace_json) == []
    m = tel.metrics
    assert m.counter("server.queries_total").value == len(trace)
    assert m.counter("server.coalesced_total").value == got.coalesced
    assert sum(m.counter("batcher.flush_total", {"reason": r}).value
               for r in ("fill", "deadline", "drain")) == got.n_batches
    assert len(tel.tracer.batches) == got.n_batches
    h = m.histogram("server.latency_ms")
    for p in (50, 99):
        assert h.same_or_adjacent_bucket(h.quantile(p), got.percentile_ms(p))

    _, plain = _servers(workers, coalesce, wait, with_cache, None, None)
    _reports_equal(got, plain.run_trace(_port_trace(trace), **kw))


def test_closed_loop_spans_and_events_match_reference_structure():
    """Closed loop runs on the wall clock: the same spans and events in the
    same order, with the same names, tracks, ids and non-time fields."""
    qs = [_pool_query(i, d=3, r=1) for i in range(6)]
    trace = qs + [dataclasses.replace(qs[0])]
    ref_tel, tel = ref_obs.Telemetry(), obs.Telemetry()
    ref, port = _servers(1, True, float("inf"), True, ref_tel, tel, max_batch=4)
    want = ref.run_trace(trace, warmup=False)
    got = port.run_trace(_port_trace(trace), warmup=False)
    assert (got.cache_hits, got.n_batches) == (want.cache_hits, want.n_batches)

    def shape(t):
        evs = t.tracer.to_trace_events()["traceEvents"]
        return [(e["name"], e["ph"], e["pid"], e["tid"], e.get("id"),
                 {k: v for k, v in e.get("args", {}).items() if k != "flush_t_s"})
                for e in evs]

    def events(t):
        return [{k: v for k, v in e.items() if k not in ("t", "service_s")}
                for e in t.events.events]

    assert shape(tel) == shape(ref_tel)
    assert events(tel) == events(ref_tel)
    assert {"flush", "dispatch", "complete"} <= {e["ev"] for e in tel.events.events}
    assert tel.tracer.stage_sums() == (got.latencies_s, got.batch_wait_s, got.queue_wait_s,
                                       got.service_s)
    assert obs.validate_trace(tel.tracer.to_trace_events()) == []


def test_histogram_and_metrics_units_match_reference():
    """The reference's unit checks on both registries, with equal outputs."""
    hs = (obs.Histogram(), ref_obs.Histogram())
    for h in hs:
        for v in [1.0, 2.0, 4.0, 8.0, 100.0]:
            h.observe(v)
    h, ref_h = hs
    assert (h.n, h.sum, h.counts) == (ref_h.n, ref_h.sum, ref_h.counts) and h.sum == 115.0
    assert [h.quantile(p) for p in (0, 50, 99, 100)] == [ref_h.quantile(p) for p in (0, 50, 99, 100)]
    assert h.same_or_adjacent_bucket(h.quantile(50), 4.0)
    assert np.isnan(obs.Histogram().quantile(50))
    for i in range(1, 40):
        lo, hi = h.bucket_bounds(i)
        assert (lo, hi) == ref_h.bucket_bounds(i) and h._index(lo * 1.0000001) == i

    regs = (obs.MetricsRegistry(), ref_obs.MetricsRegistry())
    for reg in regs:
        reg.inc("server.queries_total", 3)
        reg.inc("batcher.flush_total", reason="fill")
        reg.set("batcher.pad_slots", 7)
        reg.inc("executor.bytes_seq_total", 1.5e9, plan="k_sweep+prune+fused")
        for v in (1.0, 2.0, 3.0, 1e-5):
            reg.observe("server.latency_ms", v)
    reg, ref_reg = regs
    assert reg.to_prometheus() == ref_reg.to_prometheus()
    assert reg.to_json() == ref_reg.to_json()
    prom = reg.to_prometheus()
    assert "# TYPE server_queries_total counter" in prom
    assert 'batcher_flush_total{reason="fill"} 1' in prom and 'le="+Inf"' in prom


MALFORMED = {
    "ok": {"traceEvents": [
        {"name": "q", "ph": "b", "pid": 1, "tid": 1, "ts": 0, "cat": "c", "id": 1},
        {"name": "q", "ph": "e", "pid": 1, "tid": 1, "ts": 5, "cat": "c", "id": 1},
        {"name": "x", "ph": "X", "pid": 1, "tid": 2, "ts": 0, "dur": 3},
    ]},
    "no_trace_events": {"nope": []},
    "unclosed": {"traceEvents": [
        {"name": "q", "ph": "b", "pid": 1, "tid": 1, "ts": 0, "cat": "c", "id": 1},
    ]},
    "mismatched_name": {"traceEvents": [
        {"name": "a", "ph": "b", "pid": 1, "tid": 1, "ts": 0, "cat": "c", "id": 1},
        {"name": "b", "ph": "e", "pid": 1, "tid": 1, "ts": 1, "cat": "c", "id": 1},
    ]},
    "negative_dur": {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": -1},
    ]},
    "non_monotone": {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 10, "dur": 1},
        {"name": "y", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1},
    ]},
    "missing_fields_and_unknown_ph": {"traceEvents": [
        {"name": "x", "ph": "X"}, 7, {"name": "z", "ph": "Q", "pid": 1, "tid": 1, "ts": 0},
        {"name": "q", "ph": "e", "pid": 1, "tid": 1, "ts": 0, "id": 3},
    ]},
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validate_trace_equals_reference(case):
    """The reference's malformed traces: the port's validator reports the
    same violations, word for word (none for the valid one)."""
    got = obs.validate_trace(MALFORMED[case])
    assert got == ref_obs.validate_trace(MALFORMED[case])
    assert (got == []) == (case == "ok")


def _run_module(module, *args):
    return subprocess.run([sys.executable, "-m", module, *map(str, args)], capture_output=True,
                          text=True, timeout=300, env={"PYTHONPATH": str(SRC), "PATH": ""})


def test_validator_clis_accept_port_trace(tmp_path):
    """``python -m repro.obs.validate`` accepts a trace the port wrote; the
    port's CLI exits 0, 1 and 2 where the reference's does."""
    tel = obs.Telemetry()
    srv = GeoServer(RowExecutor(), batcher=DeadlineBatcher(max_batch=8, max_terms=8, max_rects=4,
                                                           max_wait_s=2e-3),
                    n_workers=2, coalesce=True, telemetry=tel)
    srv.run_trace(_port_trace(_random_trace(3)), warmup=False, arrival="poisson",
                  service_time=_service)
    good, bad = tmp_path / "trace.json", tmp_path / "bad.json"
    tel.tracer.write(str(good))
    bad.write_text(json.dumps(MALFORMED["unclosed"]))
    n = len(tel.tracer.to_trace_events()["traceEvents"])
    for module in ("repro.obs.validate", "repro_torch.obs.validate"):
        ok = _run_module(module, good)
        assert ok.returncode == 0 and ok.stdout.strip() == f"trace ok: {n} events", ok.stderr
        rej = _run_module(module, bad)
        assert rej.returncode == 1 and rej.stderr.count("trace-invalid:") == 1
        assert _run_module(module).returncode == 2


def test_span_recorder_event_log_and_audit_units_equal_reference(tmp_path):
    """The reference's unit scenarios on both packages: equal trace JSON,
    event JSONL, audit JSONL and audit errors."""
    out = []
    for pkg in (obs, ref_obs):
        rec = pkg.SpanRecorder()
        rec.annotate(5, plan_algo="k_sweep")
        rec.query(5, 0, "executed", "ksweep", 0.0, 1e-3, 4e-4, 1e-4, 5e-4)
        rec.query(-1, 1, "hit", None, 2e-3, 1e-6, 0.0, 0.0, 1e-6)
        rec.batch(0, 4e-4, 5e-4, 1e-3, "ksweep", 1, (8, 8, 4))
        rec.span("shard 0", "query[ksweep]", 0.001, 0.002, {"rows": 8})
        log = pkg.EventLog()
        log.emit(0.1, "flush", reason="fill", n_real=4)
        log.emit(0.2, "evict", n=2)
        audit = pkg.PlannerAudit()
        audit.record(qid=1, idx=0, features={"df_min": 3.0},
                     candidates={"ksweep": {"algorithm": "k_sweep", "n_probes": 10.0,
                                            "bytes_postings": 100.0, "bytes_spatial": 50.0,
                                            "cost": 1.0}},
                     chosen="ksweep", t_plan=0.0)
        assert audit.joined == []
        audit.join(1, {"n_probes": 20.0, "bytes_postings": 100.0, "bytes_spatial": 0.0})
        tag = pkg.__name__.replace(".", "_")
        log.to_jsonl(str(tmp_path / f"{tag}_events.jsonl"))
        audit.to_jsonl(str(tmp_path / f"{tag}_audit.jsonl"))
        out.append((rec.to_trace_events(), (tmp_path / f"{tag}_events.jsonl").read_text(),
                    (tmp_path / f"{tag}_audit.jsonl").read_text(), audit.error_summary(),
                    len(log), pkg.COST_KEYS))
    assert out[0] == out[1]
    trace, _, _, summary, n_events, _ = out[0]
    assert obs.validate_trace(trace) == [] and n_events == 2
    assert summary[("k_sweep", "n_probes")] == pytest.approx(0.5)
    assert not obs.Telemetry(None, None, None, None) and obs.Telemetry(None, None, None,
                                                                       obs.EventLog())


# ---------------------------------------------------------------------------
# real executors on a small corpus (the port's on the CPU)
# ---------------------------------------------------------------------------

BUDGETS = dict(max_candidates=512, max_tiles=128, k_sweeps=4, sweep_budget=256, top_k=5)
GRID = 32
SHAPE = dict(max_batch=4, max_terms=4, max_rects=2, max_wait_s=2e-3)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=1500, n_terms=300, seed=9)


@pytest.fixture(scope="module")
def trace(corpus):
    return stamp_arrivals(make_zipf_trace(corpus, n_queries=48, pool_size=16, d_terms=4,
                                          q_rects=2, seed=10), "poisson", rate_qps=800.0, seed=3)


def _serve(ex, trace, telemetry, cache=True, ref=False):
    if ref:
        srv = RefServer(ex, cache=ref_make_cache("lru", 16) if cache else None,
                        batcher=RefDeadlineBatcher(**SHAPE), telemetry=telemetry)
    else:
        srv = GeoServer(ex, cache=make_cache("lru", 16) if cache else None,
                        batcher=DeadlineBatcher(**SHAPE), telemetry=telemetry)
    return srv.run_trace(trace, arrival="poisson", collect_results=True,
                         service_time=lambda raw: 1e-3 + 2.5e-4 * raw.n_real)


def test_auto_audit_and_metrics_equal_reference(corpus, trace, tmp_path):
    """An ``auto`` executor (pruned, fused): the audit JSONL — features,
    every candidate's predicted counters and cost, the chosen plan, the
    measured counters and the errors — equals the reference's byte for
    byte, as do the metrics exports (executor counters per plan, the
    planner's probes, the engine's pipelines); the trace equals it apart
    from the executor spans' wall-clock times; and attaching telemetry
    changes no id, score, stat or latency."""
    kw = dict(algorithm="auto", grid=GRID, fused=True)
    ref_ex = ref_make_executor("single", corpus, budgets=RefBudgets(**BUDGETS, prune=True), **kw)
    ref_tel = ref_obs.Telemetry()
    want = _serve(ref_ex, trace, ref_tel, ref=True)

    def port_ex():
        return make_executor("single", corpus, budgets=QueryBudgets(**BUDGETS, prune=True),
                             device="cpu", **kw)

    tel = obs.Telemetry()
    got = _serve(port_ex(), _port_trace(trace), tel)
    _reports_equal(want, got)
    assert len(tel.audit.records) == len(tel.audit.joined) > 0
    for name in ("audit.jsonl",):
        ref_tel.audit.to_jsonl(str(tmp_path / f"ref_{name}"))
        tel.audit.to_jsonl(str(tmp_path / f"port_{name}"))
        assert (tmp_path / f"port_{name}").read_text() == (tmp_path / f"ref_{name}").read_text()
    assert tel.audit.error_summary() == ref_tel.audit.error_summary()
    assert tel.metrics.to_json() == ref_tel.metrics.to_json()
    assert tel.metrics.to_prometheus() == ref_tel.metrics.to_prometheus()
    assert tel.metrics.counter("planner.tp_span_probe").value > 0
    assert tel.metrics.counter("engine.compiled_fns_total").value > 0
    assert tel.events.events == ref_tel.events.events

    def serving_events(t):
        evs = t.tracer.to_trace_events()["traceEvents"]
        return [e for e in evs if e["pid"] != 2]

    assert serving_events(tel) == serving_events(ref_tel)
    assert _exec_spans(tel) == _exec_spans(ref_tel)
    assert obs.validate_trace(tel.tracer.to_trace_events()) == []

    plain = _serve(port_ex(), _port_trace(trace), None)
    _reports_equal(got, plain)
    for x, y in zip(got.results, plain.results):
        np.testing.assert_array_equal(x.ids, y.ids)
        assert x.scores.tobytes() == y.scores.tobytes()


def _exec_spans(tel):
    return [(s.track, s.name, s.args) for s in tel.tracer.exec_spans]


def _mesh_pair(corpus, kw, budgets):
    import jax
    from jax.sharding import Mesh as RefMesh

    ref = ref_make_executor(
        "mesh", corpus, mesh=RefMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                                     ("data", "model")),
        partitioner=rd.HashPartitioner(), budgets=RefBudgets(**budgets), **kw)
    port = make_executor(
        "mesh", corpus, mesh=pd.make_mesh((1, 1), ("data", "model"), device="cpu"),
        partitioner=pd.HashPartitioner(), budgets=QueryBudgets(**budgets), device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("kind", ["single", "sharded", "mesh"])
def test_executor_spans_and_compiled_fns_equal_reference(corpus, trace, kind):
    """Each real executor under ``auto`` (pruned; fused on the single one,
    whose reference kernels are quickest to interpret) with footprint
    routing where it applies: the executor spans — ``engine``, one ``shard
    s`` per visited shard, ``mesh step`` — equal the reference's by track,
    name and args, in order, as does ``engine.compiled_fns_total``; the
    ``executor.shards_touched`` histogram counts every routed real query."""
    budgets = dict(BUDGETS, prune=True)
    kw = dict(algorithm="auto", grid=GRID, fused=kind == "single")
    if kind == "mesh":
        ref_ex, port_ex = _mesh_pair(corpus, dict(kw, routing="footprint"), budgets)
    else:
        if kind == "sharded":
            kw.update(n_shards=3, routing="footprint")
        ref_ex = ref_make_executor(kind, corpus, budgets=RefBudgets(**budgets), **kw,
                                   **({"partitioner": rd.RegionRangePartitioner()}
                                      if kind == "sharded" else {}))
        port_ex = make_executor(kind, corpus, budgets=QueryBudgets(**budgets), device="cpu",
                                **kw, **({"partitioner": pd.RegionRangePartitioner()}
                                         if kind == "sharded" else {}))
    ref_tel, tel = ref_obs.Telemetry(), obs.Telemetry()
    want = _serve(ref_ex, trace, ref_tel, cache=False, ref=True)
    got = _serve(port_ex, _port_trace(trace), tel, cache=False)
    _reports_equal(want, got)
    spans = _exec_spans(tel)
    assert spans and spans == _exec_spans(ref_tel)
    track = {"single": "engine", "sharded": "shard ", "mesh": "mesh step"}[kind]
    assert all(t.startswith(track) for t, _, _ in spans)
    n = tel.metrics.counter("engine.compiled_fns_total").value
    assert n == ref_tel.metrics.counter("engine.compiled_fns_total").value
    assert n > 0 or kind == "mesh"
    if kind == "sharded":
        routed = sum(r["queries"] for r in got.routing.values())
        touched = [h.n for (name, _), h in tel.metrics._histograms.items()
                   if name == "executor.shards_touched"]
        assert routed > 0 and sum(touched) == routed
        visited = sum(r["shards_visited"] for r in got.routing.values())
        assert len(spans) >= visited  # warm-up batches visit every shard too
