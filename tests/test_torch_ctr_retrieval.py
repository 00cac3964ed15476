"""The CTR models' ``retrieval_cand`` cell (DCN-v2, AutoInt, BST) in the
PyTorch port against the JAX reference on the CPU: the port's row-chunked
forward (``models.recsys.forward_in_row_chunks``) and one top-100 of all
scores against the reference cell's own one-call ``fn`` at the SMOKE
configs; the chunked scores against one call; and the chunk rule
(``launch.steps.retrieval_chunk_rows``) on the published configs, counted
on ``meta``.  Weights come from the reference's ``cfg.init`` and batches
from its generators, carried across as numpy."""
import functools
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.data import recsys as j_data  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_arch  # noqa: E402
from repro_torch.core.ranking import select_top  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import recsys as p_rec  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)  # XLA and torch sum matmuls in other orders
CTR = ["dcn-v2", "autoint", "bst"]
CHUNKS = [None, 64, 300, 1000]  # one call, 5 chunks (the last 44 rows), one call twice
NC = 300  # candidates at SMOKE
TOP = 100
CPU = "cpu"
# the published configs' one-call transient bytes per candidate row
# (``count_step`` on meta) and the rule's rows a chunk at 1,000,000 rows
ROW_BYTES = {"dcn-v2": 17_384, "autoint": 106_392, "bst": 67_092}
CHUNK_AT_1M = {"dcn-v2": 1_000_000, "autoint": 131_072, "bst": 262_144}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _ref_batch(cfg, B, seed=0):
    """The reference's batch for ``cfg`` without its label (one compile)."""
    def make():
        if type(cfg).__name__ == "BSTConfig":
            return j_data.bst_batch(B, cfg.n_items, cfg.seq_len, cfg.n_other_fields,
                                    cfg.field_vocab, seed=seed)
        n_dense = cfg.n_dense if type(cfg).__name__ == "DCNv2Config" else 0
        return j_data.ctr_batch(B, n_dense, cfg.vocab_sizes, seed=seed)

    batch = dict(jax.jit(make)())
    batch.pop("label")
    return batch


@functools.cache
def _case(name):
    """(port SMOKE spec, port params, port batch, reference top-100 values,
    reference top-100 ids, reference scores): the reference cell built on a
    (1, 1) mesh and its ``fn`` run on its own weights and batch."""
    j_spec = j_get_arch(name)
    jc = j_spec.smoke_config
    jp = jax.jit(jc.init)(jax.random.key(0))
    jb = _ref_batch(jc, NC, seed=3)
    j_shape = JShapeSpec("retrieval", "recsys_retrieval", dict(batch=1, n_candidates=NC))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cell = j_steps.build_recsys_cell(replace(j_spec, config=jc), j_shape, mesh)
    want_v, want_i = jax.jit(cell.fn)(jp, jb)
    fwd = {"dcn-v2": "dcn_v2", "autoint": "autoint", "bst": "bst"}[name]
    from repro.models import recsys as j_rec

    want_s = jax.jit(functools.partial(getattr(j_rec, fwd + "_forward"), jc))(jp, jb)
    spec = get_arch(name)
    spec = replace(spec, config=spec.smoke_config, shapes=(
        ShapeSpec("retrieval", "recsys_retrieval", dict(batch=1, n_candidates=NC)),))
    pp = params_from_numpy(spec.config.param_defs(), _np(jp), CPU)
    return spec, pp, _t(_np(jb)), np.asarray(want_v), np.asarray(want_i), np.asarray(want_s)


def _assert_ids_match_where_separated(got_s, got_i, want_s, want_i):
    """Values within TOL; ids equal wherever the reference's adjacent
    scores differ by more than the tolerance (``tests/test_torch_recsys.py``'s
    rule, on one row)."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    assert got_s.shape == got_i.shape == want_s.shape == (TOP,)
    assert np.isfinite(want_s).all() and np.isfinite(got_s).all()
    np.testing.assert_allclose(got_s, want_s, **TOL)
    tol = TOL["atol"] + TOL["rtol"] * np.abs(want_s)
    gap = np.abs(np.diff(want_s))
    sep = np.ones(TOP, bool)
    sep[1:] &= gap > tol[1:]
    sep[:-1] &= gap > tol[:-1]
    assert sep.sum() > 0.5 * TOP
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("name", CTR)
def test_retrieval_cell_matches_reference(name, chunk):
    """The port cell's top-100 (chunked ``chunk`` rows, then one stable
    top-100 of all scores) against the reference cell's one-call
    ``jax.lax.top_k``."""
    spec, pp, pb, want_v, want_i, _ = _case(name)
    cell = p_steps.build_recsys_cell(spec, spec.shape("retrieval"), device=CPU, seed=1,
                                     chunk_rows=chunk)
    split = chunk is not None and chunk < NC
    assert ("5 chunks" in cell.note) == split and ("one call" in cell.note) == (not split)
    got_v, got_i = cell.fn(pp, pb)
    assert got_i.dtype == torch.int64
    _assert_ids_match_where_separated(got_v, got_i, want_v, want_i)


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("name", CTR)
def test_chunked_scores_equal_one_call(name, chunk):
    """``forward_in_row_chunks`` runs the forward on row views of the
    batch (ragged last chunk) and equals one call and the reference's
    scores within TOL; one call when ``chunk_rows`` is None or covers N."""
    spec, pp, pb, _, _, want_s = _case(name)
    fwd = p_steps.recsys_forward(spec.config)
    calls = []

    def spy(params, batch):
        for k, v in batch.items():  # views into the caller's tensors
            assert v.untyped_storage().data_ptr() == pb[k].untyped_storage().data_ptr()
        calls.append(next(iter(batch.values())).shape[0])
        return fwd(params, batch)

    got = p_rec.forward_in_row_chunks(spy, pp, pb, chunk)
    one = fwd(pp, pb)
    assert calls == ([64, 64, 64, 64, 44] if chunk == 64 else [NC])
    assert got.shape == (NC,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), want_s, **TOL)
    if chunk == 64:
        with pytest.raises(ValueError, match="positive"):
            p_rec.forward_in_row_chunks(fwd, pp, pb, 0)


@pytest.mark.parametrize("name", CTR)
def test_chunk_rule_on_published_configs(name):
    """The published config's one-call transient bytes per row (linear in
    rows), and the rule's chunks at 1,000,000 rows on the (1, 1) host mesh:
    the largest power of two within RETRIEVAL_TRANSIENT_BYTES, capped at
    the rows."""
    spec = get_arch(name)
    cfg = spec.config
    per = p_steps.retrieval_row_bytes(cfg)
    assert per == ROW_BYTES[name]
    fwd = p_steps.recsys_forward(cfg)
    batch = p_steps.recsys_input_specs(cfg, 3000)
    batch.pop("label")
    params = p_steps.param_shapes(cfg.param_defs())
    assert p_steps.count_step(fwd, (params, batch)).transient == 3000 * per
    chunk = p_steps.retrieval_chunk_rows(cfg, 1_000_000)
    assert chunk == CHUNK_AT_1M[name]
    assert chunk == 1_000_000 or (chunk * per <= p_steps.RETRIEVAL_TRANSIENT_BYTES
                                  < 2 * chunk * per)
    for rows in (1, 1000, chunk - 1, chunk):
        assert p_steps.retrieval_chunk_rows(cfg, rows) == rows
    assert p_steps.retrieval_chunk_rows(cfg, 10**7) == (1 << 20 if name == "dcn-v2" else chunk)
    cell = p_steps.build_recsys_cell(spec, spec.shape("retrieval_cand"), device="meta",
                                     mesh=make_host_mesh(device="meta"))
    n_chunks = -(-1_000_000 // chunk)
    last = 1_000_000 - (n_chunks - 1) * chunk
    assert (n_chunks, last) == {"dcn-v2": (1, 1_000_000), "autoint": (8, 82_496),
                                "bst": (4, 213_568)}[name]
    want = "one call" if n_chunks == 1 else f"{chunk} rows a chunk, {n_chunks} chunks"
    assert cell.note.endswith("1000000 rows a device, " + want)


@pytest.mark.parametrize("name", CTR)
def test_chunk_rule_keeps_production_meshes_one_call(name):
    """On the 256- and 512-device meshes a device holds 1,000,000 over the
    batch axes (pod × data) of the candidates, well under a chunk: the
    cell stays the one call: its trace counts what one forward and one
    top-100 count."""
    spec = get_arch(name)
    shape = spec.shape("retrieval_cand")
    fwd = p_steps.recsys_forward(spec.config)
    for multi, rows in ((False, 62_500), (True, 31_250)):
        mesh = make_production_mesh(multi_pod=multi)
        cell = p_steps.build_recsys_cell(spec, shape, device="meta", mesh=mesh)
        assert cell.note.endswith(f"{rows} rows a device, one call")
        assert p_steps.retrieval_chunk_rows(spec.config, rows) == rows
        got = p_steps.count_step(cell.fn, cell.args, mesh)
        want = p_steps.count_step(lambda p, b: select_top(fwd(p, b), TOP), cell.args, mesh)
        assert (got.flops_dev, got.bytes_dev, got.peak_dev, got.n_ops) == \
            (want.flops_dev, want.bytes_dev, want.peak_dev, want.n_ops)
