"""PyTorch port: the paper's ``geoweb`` config and serve cells, the train
CLI's ``--arch geoweb`` exit, and the two geo examples against the
reference on the CPU — every config field, the int32 guard and its
message, the three SMOKE cells' ids, scores and counters exactly, the
quickstart's printed lines, and ``geosearch_serve``'s counter sums, cost
columns and recall (small seeded corpora)."""
import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as RefMesh  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core import distributed as rd  # noqa: E402
from repro.core.algorithms import QueryBatch as RefQueryBatch  # noqa: E402
from repro.core.engine import GeoSearchEngine as RefEngine  # noqa: E402
from repro.corpus import make_corpus as ref_make_corpus  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.configs import base as cbase  # noqa: E402
from repro_torch.core import make_mesh  # noqa: E402
from repro_torch.examples import geosearch_serve, quickstart  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_ARGS = ["--n-docs", "2000", "--n-queries", "64", "--batch", "32"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread, so its sums add in one fixed order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_example(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape_fields(s):
    return (s.name, s.kind, s.params, s.skip, s.variant_of)


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_geoweb_config_equals_reference(which):
    want, got = ref_get_arch("geoweb"), cbase.get_arch("geoweb")
    a, b = getattr(want, which), getattr(got, which)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert dataclasses.asdict(b.budgets) == dataclasses.asdict(a.budgets)
    assert dataclasses.asdict(b.weights) == dataclasses.asdict(a.weights)
    assert (got.name, got.family, got.source) == (want.name, want.family, want.source)
    assert [_shape_fields(s) for s in got.shapes] == [_shape_fields(s) for s in want.shapes]


@pytest.mark.parametrize("pkg,extra", [("repro", []), ("repro_torch", ["--device", "cpu"])])
def test_train_cli_geoweb_exits_with_its_message(pkg, extra):
    """Both train CLIs refuse ``--arch geoweb`` with their package's
    message and no traceback."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch.train", "--arch", "geoweb", *extra],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert f"geoweb is a serving system: use {pkg}.launch.serve" in run.stderr
    assert "Traceback" not in run.stderr, run.stderr[-2000:]


def test_train_cli_geoweb_message_before_device_check(monkeypatch):
    """Without CUDA, the port's default ``--device cuda`` still reaches the
    geoweb message, not the device error."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="geoweb is a serving system"):
        train.main(["--arch", "geoweb"])


@pytest.mark.parametrize("n_shards", [1, 4, 8, 16, 32])
def test_i32_guard_equals_reference(n_shards):
    """CONFIG over ``n_shards`` doc shards: the port's guard passes or
    raises exactly where the reference's does, with its message."""
    assert steps.I32_SAFE_MAX == ref_steps.I32_SAFE_MAX
    cfg = ref_get_arch("geoweb").config
    n = cfg.n_docs // n_shards
    want = None
    try:
        ref_steps._check_i32_addressable("toe prints", n * cfg.max_rects, n_shards)
        ref_steps._check_i32_addressable("postings", n * cfg.avg_postings_per_doc, n_shards)
    except ValueError as e:
        want = str(e)
    got = None
    try:
        steps.check_geoweb_shards(cbase.get_arch("geoweb").config, n_shards)
    except ValueError as e:
        got = str(e)
    assert got == want
    assert (got is None) == (n_shards >= 8)  # the production meshes (16, 32) pass


def test_geoweb_config_cell_raises_before_drawing(monkeypatch):
    """On a 1 × 1 mesh the published CONFIG's cell raises the reference's
    error (minimum 8 shards) before any corpus is drawn."""
    import repro_torch.corpus

    def no_corpus(*a, **k):
        raise AssertionError("the guard must run before the corpus is drawn")

    monkeypatch.setattr(repro_torch.corpus, "make_corpus", no_corpus)
    spec = cbase.get_arch("geoweb")
    ref_spec = ref_get_arch("geoweb")
    ref_mesh = RefMesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with pytest.raises(ValueError) as want:
        ref_steps.build_cell(ref_spec, ref_spec.shapes[0], ref_mesh)
    with pytest.raises(ValueError, match=">= 8 devices") as got:
        steps.build_cell(spec, spec.shapes[0], make_mesh((1, 1), ("data", "model"), device="cpu"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="need a mesh"):
        steps.build_geoweb_cell(spec, spec.shapes[0], None)


@pytest.mark.parametrize("shape", ["serve_ksweep", "serve_textfirst", "serve_geofirst"])
def test_geoweb_smoke_cell_equals_reference(shape):
    """The SMOKE cell on a CPU 1 × 1 mesh against the reference's
    ``make_serve_fn`` (with its counters) over the reference's stacked
    index of the same corpus, on the cell's queries: ids, scores (bitwise)
    and every counter exactly; ``model_flops`` equal to the reference
    cell's."""
    spec, ref_spec = cbase.get_arch("geoweb"), ref_get_arch("geoweb")
    smoke = dataclasses.replace(spec, config=spec.smoke_config)
    ref_smoke = dataclasses.replace(ref_spec, config=ref_spec.smoke_config)
    sh, ref_sh = spec.shape(shape), ref_spec.shape(shape)
    cell = steps.build_cell(smoke, sh, make_mesh((1, 1), ("data", "model"), device="cpu"))
    ids, scores, stats = cell.fn(*cell.args)

    cfg = ref_spec.smoke_config
    c = ref_make_corpus(cfg.n_docs, cfg.n_terms, max_rects=cfg.doc_major_rects,
                        doc_len=cfg.avg_postings_per_doc, seed=0)
    ref_idx = rd.shard_corpus_np(c.doc_terms, c.doc_rects, c.doc_amps, c.pagerank, c.n_terms,
                                 1, grid=cfg.grid, m_intervals=cfg.m_intervals,
                                 compress=cfg.compress)
    idx, q = cell.args
    for name in ("tp_rects", "doc_rects", "impacts", "offsets", "tile_starts"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(ref_idx, name)), err_msg=name)
    ref_mesh = RefMesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    serve = rd.make_serve_fn(
        ref_mesh, cfg.budgets, cfg.weights, doc_axes=("data",), query_axis="model",
        algorithm=ref_sh.params["algorithm"], grid=cfg.grid, n_terms=cfg.n_terms,
        with_stats=True, max_term_blocks=ref_idx.max_term_blocks, layout=ref_idx.layout,
        max_term_segments=ref_idx.max_term_segments)
    with ref_mesh:
        r_ids, r_scores, r_stats = serve(
            ref_idx, RefQueryBatch(q.terms.numpy(), q.rects.numpy(), q.amps.numpy()))
    assert ids.shape == (cfg.query_batch, cfg.budgets.top_k)
    assert int((ids >= 0).sum()) > 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    assert scores.numpy().tobytes() == np.asarray(r_scores).tobytes()
    assert list(stats) == list(r_stats)
    for k, v in r_stats.items():
        a, b = np.asarray(v), stats[k].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert cell.model_flops == ref_steps.build_cell(ref_smoke, ref_sh, ref_mesh).model_flops


def test_quickstart_prints_the_reference_lines():
    ref = _reference_example("quickstart")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    want = out.getvalue().splitlines()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = quickstart.main(device="cpu")
    assert got == out.getvalue().splitlines() == want
    assert len(want) == 6


def _reference_serve_rows(monkeypatch):
    """Run the reference's ``geosearch_serve.main`` at SERVE_ARGS, recording
    every engine call, and return (its printed table rows, each
    algorithm's timed batches' results)."""
    ref = _reference_example("geosearch_serve")
    calls = []
    query = RefEngine.query

    def recording(self, batch, algorithm="k_sweep", *a, **k):
        res = query(self, batch, algorithm, *a, **k)
        calls.append((algorithm, res))
        return res

    monkeypatch.setattr(RefEngine, "query", recording)
    monkeypatch.setattr(sys, "argv", ["geosearch_serve.py", *SERVE_ARGS])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    table = {}
    for line in out.getvalue().splitlines():
        f = line.split()
        if f and f[0] in geosearch_serve.ALGORITHMS:
            table[f[0]] = {"recall": f[3], "t_disk2010": f[4], "t_hbm_v5e": f[5]}
    batches = {}
    nb = 64 // 32
    for algo in geosearch_serve.ALGORITHMS:
        mine = [res for a, res in calls if a == algo]
        assert len(mine) == nb + 2  # warm-up, timed batches, the recall batch
        batches[algo] = mine[1:1 + nb]
    return table, batches


def test_geosearch_serve_equals_reference(monkeypatch):
    """Counter sums exactly, the disk column and recall as printed, and
    ``t_hbm_h100`` by its formula on those counters; the TPU v5e column
    of the reference is the same formula at its bandwidth."""
    table, batches = _reference_serve_rows(monkeypatch)
    rows = geosearch_serve.run(geosearch_serve.parse_args(SERVE_ARGS), device="cpu")
    assert [r["algorithm"] for r in rows] == list(geosearch_serve.ALGORITHMS)
    for r in rows:
        algo = r["algorithm"]
        for key in ("seeks", "bytes_seq", "bytes_random"):
            want = 0.0
            for res in batches[algo]:
                want += float(np.asarray(res.stats[key]).sum())
            assert r[key] == want, (algo, key)
        assert f"{r['recall']:.3f}" == table[algo]["recall"]
        assert f"{r['t_disk2010'] * 1e3:.1f}ms" == table[algo]["t_disk2010"]
        n = r["n"]
        assert r["t_hbm_h100"] == (r["bytes_seq"] / (3.35e12 * 0.9)
                                   + r["bytes_random"] / (3.35e12 * 0.15)) / n
        v5e = (r["bytes_seq"] / (819e9 * 0.9) + r["bytes_random"] / (819e9 * 0.15)) / n
        assert f"{v5e * 1e6:.2f}us" == table[algo]["t_hbm_v5e"]
        last = batches[algo][-1]
        np.testing.assert_array_equal(r["last"].ids.numpy(), np.asarray(last.ids))
        assert r["last"].scores.numpy().tobytes() == np.asarray(last.scores).tobytes()


def test_geosearch_serve_geo_score_kernel_rows_equal_plain(capsys):
    """``--use-pallas`` (the ``geo_score`` kernel's wrapper as K-SWEEP's
    toe-print scorer) gives the plain rows: counters, cost columns, recall
    and the last batch's ids and scores; ``main`` prints the H100 column."""
    plain = geosearch_serve.run(geosearch_serve.parse_args(SERVE_ARGS), device="cpu")
    rows = geosearch_serve.main([*SERVE_ARGS, "--use-pallas", "--device", "cpu"])
    for a, b in zip(plain, rows):
        for key in ("algorithm", "n", "seeks", "bytes_seq", "bytes_random", "t_disk2010",
                    "t_hbm_h100", "recall"):
            assert a[key] == b[key], (a["algorithm"], key)
        assert torch.equal(a["last"].ids, b["last"].ids)
        assert a["last"].scores.numpy().tobytes() == b["last"].scores.numpy().tobytes()
    out = capsys.readouterr().out
    assert "t_hbm_h100" in out and "t_hbm_v5e" not in out


def test_geo_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` the examples and the geoweb mesh run on CUDA; on
    a host without it they raise and name ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (quickstart.main,
                 lambda: geosearch_serve.run(geosearch_serve.parse_args(SERVE_ARGS)),
                 lambda: make_mesh((1, 1), ("data", "model"))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
