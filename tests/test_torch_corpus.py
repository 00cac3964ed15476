"""PyTorch port: corpus and traces equal the reference's bit for bit, the
port imports neither JAX nor the reference, and entry points default to
CUDA."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import corpus as ref_corpus  # noqa: E402
from repro_torch import corpus as port_corpus  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _assert_corpus_equal(a, b):
    assert len(a.doc_terms) == len(b.doc_terms)
    for x, y in zip(a.doc_terms, b.doc_terms):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for name in ("doc_rects", "doc_amps", "pagerank", "cities"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.n_terms == b.n_terms


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_docs=2000, n_terms=300, seed=0),
        dict(n_docs=1500, n_terms=500, seed=7),
        dict(n_docs=800, n_terms=120, n_cities=9, max_rects=6, doc_len=12, seed=3),
        dict(n_docs=1, n_terms=10, seed=11),
    ],
)
def test_make_corpus_equals_reference(kw):
    _assert_corpus_equal(ref_corpus.make_corpus(**kw), port_corpus.make_corpus(**kw))


@pytest.mark.parametrize("from_docs", [True, False])
def test_make_query_trace_equals_reference(from_docs):
    c = port_corpus.make_corpus(n_docs=500, n_terms=100, seed=2)
    want = ref_corpus.make_query_trace(c, n_queries=40, seed=5, from_docs=from_docs)
    got = port_corpus.make_query_trace(c, n_queries=40, seed=5, from_docs=from_docs)
    for name in ("terms", "rects", "amps"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("scales", [(0.3, 1.0, 3.0), (1.0,)])
def test_zipf_trace_and_padding_equal_reference(scales):
    c = port_corpus.make_corpus(n_docs=600, n_terms=150, seed=4)
    want = ref_corpus.make_zipf_trace(c, n_queries=96, pool_size=40, seed=6, scales=scales)
    got = port_corpus.make_zipf_trace(c, n_queries=96, pool_size=40, seed=6, scales=scales)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        for name in ("terms", "rects", "amps"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    pw, pg = ref_corpus.pad_trace_batch(want), port_corpus.pad_trace_batch(got)
    for name in ("terms", "rects", "amps"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(), np.asarray(getattr(pw, name)))


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, imports with ``jax`` and
    ``repro`` made unimportable."""
    code = f"""
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None or m.startswith(("jax.", "repro."))]
assert not bad, bad
print(len(names))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_default_to_cuda():
    """Without ``device=`` the engine and executor run on CUDA; on a host
    without CUDA they raise and name the explicit ``device="cpu"``."""
    from repro_torch.core import GeoSearchEngine
    from repro_torch.serving import make_executor

    c = port_corpus.make_corpus(n_docs=50, n_terms=20, seed=1)
    args = (c.doc_terms, c.doc_rects, c.doc_amps, c.n_terms)
    if torch.cuda.is_available():
        assert GeoSearchEngine.build(*args).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GeoSearchEngine.build(*args)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_executor("single", c)
    assert GeoSearchEngine.build(*args, device="cpu").device.type == "cpu"
