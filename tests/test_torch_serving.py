"""PyTorch port: the serving layer's host modules against the reference,
bit for bit — arrival processes, stamped / uniform / mixture traces and
document frequencies, query fingerprints, the LRU and Landlord caches, the
shape-bucketed and deadline batchers, and the in-flight pending table,
each driven by the same seeded sequence in both packages."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.corpus import synth as ref_synth  # noqa: E402
from repro.serving import batcher as ref_batcher  # noqa: E402
from repro.serving import cache as ref_cache  # noqa: E402
from repro.serving import pending as ref_pending  # noqa: E402
from repro.serving.fingerprint import query_fingerprint as ref_fingerprint  # noqa: E402
from repro_torch.corpus import (  # noqa: E402
    ARRIVAL_KINDS,
    make_arrivals,
    make_corpus,
    make_mixture_trace,
    make_uniform_trace,
    make_zipf_trace,
    stamp_arrivals,
    term_document_frequencies,
)
from repro_torch.serving import (  # noqa: E402
    DeadlineBatcher,
    LandlordCache,
    LRUCache,
    PendingQuery,
    PendingTable,
    ShapeBucketedBatcher,
    make_cache,
    query_fingerprint,
)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=1200, n_terms=300, seed=4)


def _same_trace(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("terms", "rects", "amps"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert g.arrival_s == w.arrival_s


# ---------------------------------------------------------------------------
# arrivals and traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ARRIVAL_KINDS)
@pytest.mark.parametrize("rate,seed", [(200.0, 0), (37.5, 11)])
def test_arrivals_equal_reference(kind, rate, seed):
    assert ARRIVAL_KINDS == ref_synth.ARRIVAL_KINDS
    kw = dict(burst_factor=5.0, on_frac=0.15, diurnal_period_s=7.0) if seed else {}
    got = make_arrivals(kind, 777, rate_qps=rate, seed=seed, **kw)
    want = ref_synth.make_arrivals(kind, 777, rate_qps=rate, seed=seed, **kw)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.all(np.diff(got) >= 0)


def test_arrivals_reject_what_the_reference_rejects():
    for kw in (dict(kind="nope"), dict(kind="poisson", rate_qps=0.0),
               dict(kind="bursty", on_frac=1.0), dict(kind="bursty", burst_factor=10.0)):
        kind = kw.pop("kind")
        with pytest.raises(ValueError):
            ref_synth.make_arrivals(kind, 4, **kw)
        with pytest.raises(ValueError):
            make_arrivals(kind, 4, **kw)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_stamp_arrivals_equal_reference(corpus, kind):
    trace = make_zipf_trace(corpus, n_queries=300, pool_size=40, seed=2)
    _same_trace(stamp_arrivals(trace, kind, rate_qps=150.0, seed=3),
                ref_synth.stamp_arrivals(trace, kind, rate_qps=150.0, seed=3))


@pytest.mark.parametrize("seed", [1, 8])
def test_uniform_trace_equal_reference(corpus, seed):
    _same_trace(make_uniform_trace(corpus, n_queries=200, seed=seed),
                ref_synth.make_uniform_trace(corpus, n_queries=200, seed=seed))


def test_term_document_frequencies_equal_reference(corpus):
    got = term_document_frequencies(corpus)
    want = ref_synth.term_document_frequencies(corpus)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ragged = dataclasses.replace(corpus, doc_terms=[t[: 1 + i % 7] for i, t in
                                                    enumerate(corpus.doc_terms)])
    assert np.array_equal(term_document_frequencies(ragged),
                          ref_synth.term_document_frequencies(ragged))


@pytest.mark.parametrize("rare_frac,seed", [(0.5, 1), (1.0, 21), (0.0, 22)])
def test_mixture_trace_equal_reference(corpus, rare_frac, seed):
    _same_trace(make_mixture_trace(corpus, n_queries=160, rare_frac=rare_frac, seed=seed),
                ref_synth.make_mixture_trace(corpus, n_queries=160, rare_frac=rare_frac,
                                             seed=seed))


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["zipf", "uniform"])
@pytest.mark.parametrize("quant,levels", [(128, 8), (16, 3)])
def test_fingerprint_equal_reference(corpus, kind, quant, levels):
    if kind == "zipf":
        trace = make_zipf_trace(corpus, n_queries=400, pool_size=64, seed=5)
    else:
        trace = make_uniform_trace(corpus, n_queries=400, seed=5)
    keys = set()
    for q in trace:
        got = query_fingerprint(q.terms, q.rects, q.amps, quant=quant, amp_levels=levels)
        assert got == ref_fingerprint(q.terms, q.rects, q.amps, quant=quant, amp_levels=levels)
        assert all(type(x) is int for x in got)
        keys.add(got)
    assert 1 < len(keys) <= len(trace)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_state(c):
    if isinstance(c, (LRUCache, ref_cache.LRUCache)):
        return list(c._data.items())
    return ([(k, e[0], e[1], e[2], e[3]) for k, e in c._data.items()],
            c.clock, c.bytes_used, c.rejected)


def _drive_cache(c, seed):
    rng = np.random.default_rng(seed)
    log = []
    for step in range(600):
        key = ("q", int(rng.zipf(1.3)) % 90)
        if rng.random() < 0.55:
            v = c.get(key)
            log.append(("get", key, v))
        else:
            cost = float(rng.exponential(2e-3))
            size = float(rng.integers(40, 400))
            c.put(key, ("v", step), cost=cost, size=size)
            log.append(("put", key, len(c)))
        log.append((c.hits, c.misses, c.evictions))
    return log


@pytest.mark.parametrize("policy,capacity,max_bytes", [
    ("lru", 24, None), ("landlord", 24, None), ("landlord", 64, 3000.0),
    ("landlord", 8, 300.0),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_cache_sequence_equal_reference(policy, capacity, max_bytes, seed):
    got = make_cache(policy, capacity, max_bytes=max_bytes)
    want = ref_cache.make_cache(policy, capacity, max_bytes=max_bytes)
    assert _drive_cache(got, seed) == _drive_cache(want, seed)
    assert _cache_state(got) == _cache_state(want)
    assert got.hit_rate == want.hit_rate
    clone = got.fresh_clone()
    assert type(clone) is type(got) and len(clone) == 0
    if max_bytes is not None:
        assert got.bytes_used <= max_bytes and clone.max_bytes == max_bytes


def test_cache_factory_guards():
    assert make_cache("none", 4) is None
    assert isinstance(make_cache("lru", 4), LRUCache)
    assert isinstance(make_cache("landlord", 4), LandlordCache)
    for args, kw in ((("lru", 4), dict(max_bytes=10.0)), (("fifo", 4), {}),
                     (("lru", 0), {}), (("landlord", 4), dict(max_bytes=0.0))):
        with pytest.raises(ValueError):
            make_cache(*args, **kw)
        with pytest.raises(ValueError):
            ref_cache.make_cache(*args, **kw)


# ---------------------------------------------------------------------------
# batchers
# ---------------------------------------------------------------------------

def _queries(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for qid in range(n):
        d, r = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        lo = rng.uniform(0, 0.8, (r, 2)).astype(np.float32)
        out.append((qid, rng.integers(0, 100, d).astype(np.int32),
                    np.concatenate([lo, lo + 0.1], axis=1).astype(np.float32),
                    rng.uniform(0.1, 1.0, r).astype(np.float32),
                    ["a", "b", None][int(rng.integers(0, 3))],
                    float(rng.exponential(2e-3))))
    return out


def _raw(raw):
    s = raw.shape
    return ((s.batch, s.d_terms, s.q_rects), list(raw.qids), raw.plan,
            raw.terms.tobytes(), raw.rects.tobytes(), raw.amps.tobytes(), raw.n_real,
            raw.terms.dtype, raw.rects.dtype, raw.amps.dtype)


def _drive_batcher(b, pq_cls, seed):
    deadline = hasattr(b, "next_deadline")
    log, now = [], 0.0
    for qid, terms, rects, amps, plan, gap in _queries(seed):
        now += gap
        if deadline:
            while (dl := b.next_deadline()) is not None and dl <= now:
                log.append(("due", dl, [_raw(r) for r in b.due(dl)]))
            out = b.add(pq_cls(qid, terms, rects, amps, plan), now)
        else:
            out = b.add(pq_cls(qid, terms, rects, amps, plan))
        log.append(("add", qid, [_raw(r) for r in out]))
    log.append(("flush", [_raw(r) for r in b.flush()]))
    counters = (b.pad_slots, b.real_slots, b.pad_elements, b.real_elements,
                b.padding_overhead, b.element_padding_overhead,
                sorted((s.batch, s.d_terms, s.q_rects) for s in b.emitted_shapes),
                sorted((s.batch, s.d_terms, s.q_rects) for s in b.registered_shapes))
    return log, counters


@pytest.mark.parametrize("cfg", [
    dict(cls="shape", max_batch=8), dict(cls="shape", max_batch=4, max_terms=8, max_rects=4),
    dict(cls="deadline", max_batch=8, max_wait_s=float("inf")),
    dict(cls="deadline", max_batch=8, max_wait_s=3e-3),
    dict(cls="deadline", max_batch=4, max_wait_s=0.1),
    dict(cls="deadline", max_batch=4, max_wait_s=0.0),
    dict(cls="deadline", max_batch=8, term_buckets=[8], rect_buckets=[4], batch_sizes=[8],
         max_wait_s=5e-3),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_batcher_sequence_equal_reference(cfg, seed):
    cfg = dict(cfg)
    cls = cfg.pop("cls")
    mine = (ShapeBucketedBatcher if cls == "shape" else DeadlineBatcher)(**cfg)
    theirs = (ref_batcher.ShapeBucketedBatcher if cls == "shape"
              else ref_batcher.DeadlineBatcher)(**cfg)
    got = _drive_batcher(mine, PendingQuery, seed)
    assert got == _drive_batcher(theirs, ref_batcher.PendingQuery, seed)
    seen = sorted(q for entry in got[0] for raws in entry[-1:] for r in raws for q in r[1])
    assert seen == list(range(120))  # every query in exactly one batch
    clone = mine.clone_empty()
    assert type(clone) is type(mine) and clone.pad_slots == 0
    assert clone.registered_shapes == mine.registered_shapes


def test_deadline_batcher_guards():
    with pytest.raises(ValueError):
        DeadlineBatcher(max_wait_s=-1.0)
    b = ShapeBucketedBatcher(max_batch=4, max_terms=2, max_rects=1)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        b.add(PendingQuery(0, np.arange(3, dtype=np.int32),
                           np.zeros((1, 4), np.float32), np.ones(1, np.float32)))


# ---------------------------------------------------------------------------
# pending table
# ---------------------------------------------------------------------------

def _drive_pending(t, seed):
    rng = np.random.default_rng(seed)
    log, owner, now, qid = [], {}, 0.0, 0
    for _ in range(400):
        now += float(rng.exponential(1e-3))
        key = ("k", int(rng.integers(0, 12)))
        op = rng.random()
        if op < 0.35:
            t.register(key, qid)
            owner[key] = qid
            qid += 1
            log.append(("reg", key, len(t)))
        elif op < 0.6:
            e = t.lookup(key, now)
            if e is not None:
                e.subscribers.append((now, qid))
            log.append(("look", key, None if e is None else
                        (e.owner_qid, e.dispatched, e.done_t, len(e.subscribers))))
        elif op < 0.8:
            q = owner.get(key, -1) if rng.random() < 0.8 else qid + 7
            start = now + float(rng.exponential(1e-3))
            e = t.on_dispatch(key, q, now, start, start + float(rng.exponential(2e-3)), ("v", q))
            log.append(("disp", key, None if e is None else (e.owner_qid, e.done_t, e.value)))
        elif op < 0.9:
            e = t.resolve(key, owner.get(key, -1))
            log.append(("res", key, None if e is None else (e.owner_qid, list(e.subscribers))))
        else:
            log.append(("exp", t.expire(now), len(t)))
        log.append(t.unresolved_subscribers())
    t.clear()
    log.append(len(t))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pending_table_sequence_equal_reference(seed):
    assert _drive_pending(PendingTable(), seed) == _drive_pending(ref_pending.PendingTable(), seed)
