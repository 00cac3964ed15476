"""PyTorch port of EGNN against the JAX reference on the CPU: the graph
generators (bitwise), the parameters carried across, ``forward``,
``loss_fn`` and the gradients at f32 and at bf16 compute, the ordered
segment sum against XLA's, the equivariance test, the three gnn cells and
the train CLI's gnn family.  Weights come from the reference's
``cfg.init``, carried across as numpy."""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.data import graph as j_graph  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import egnn as j_egnn  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data import graph as p_graph  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.models import egnn as p_egnn  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves  # noqa: E402

CPU = "cpu"
F32_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # XLA and torch sum products in other orders
# bf16 compute: the matmuls, silu and the 3-term dist² round at other
# points in XLA and torch (1 bf16 ulp, 2^-8 relative, moves a message),
# and autograd adds a node's cotangents in another order; the segment
# sums add in the same order and round after every add in both.  Outputs,
# coordinates and the loss are held within 2^-5 of their largest
# magnitude (measured ≤ 0.0101), each gradient within 2^-3 in relative
# norm (measured ≤ 0.088: the coordinate MLP's gradients cancel).  Sums
# accumulated in f32 instead miss both: 0.19 and up to 0.56 on the hub
BF16_REL = 2.0**-5
BF16_GRAD_REL = 2.0**-3
KINDS = ["full", "sampled", "molecule"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _cfgs(kind, **kw):
    """(reference cfg, port cfg): SMOKE, graph regression for molecules."""
    jc, pc = j_get_arch("egnn").smoke_config, get_arch("egnn").smoke_config
    if kind == "molecule":
        kw["n_classes"] = 0
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v) for k, v in kw.items()}
    return dataclasses.replace(jc, **jkw), dataclasses.replace(pc, **kw)


@functools.cache
def _ref_batch(kind, d_feat=8, n_classes=4):
    """The reference's batch of ``kind`` as numpy (the graphs of
    tests/test_arch_smoke.py)."""
    if kind == "full":
        g = j_graph.make_powerlaw_graph(128, 512, d_feat, n_classes=n_classes, seed=0)
        return _np(j_graph.full_graph_batch(g, edge_multiple=8))
    if kind == "sampled":
        g = j_graph.make_powerlaw_graph(512, 4096, d_feat, n_classes=n_classes, seed=1)
        return _np(j_graph.sample_subgraph(g, j_graph.SampledShape(16, (4, 3)), seed=0, step=0))
    if kind == "hub":  # node 0 receives more than 256 edges
        g = j_graph.make_powerlaw_graph(256, 4096, d_feat, n_classes=n_classes, seed=3)
        return _np(j_graph.full_graph_batch(g, edge_multiple=8))
    if kind == "equivariance":
        g = j_graph.make_powerlaw_graph(64, 256, d_feat, n_classes=n_classes, seed=2)
        return _np(j_graph.full_graph_batch(g, edge_multiple=8))
    return _np(j_graph.molecule_batch(8, 10, 16, d_feat, seed=0))


@functools.cache
def _ref_params(kind):
    jc, _ = _cfgs(kind)
    return _np(jc.init(jax.random.key(0)))


def _port_params(kind, pc):
    return params_from_numpy(pc.param_defs(), _ref_params(kind), CPU)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape and np.array_equal(g, v), k


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("gen", ["powerlaw", "full", "sampled", "molecule"])
def test_graph_generators_equal_reference(gen, seed):
    """The same arrays, dtypes and shapes bit for bit (numpy draws both)."""
    j = j_graph.make_powerlaw_graph(300, 2000, 6, n_classes=5, seed=seed)
    p = p_graph.make_powerlaw_graph(300, 2000, 6, n_classes=5, seed=seed, device=CPU)
    if gen == "powerlaw":
        for f in ("indptr", "indices", "feats", "coords", "labels"):
            a, b = getattr(p, f), getattr(j, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert p.n_nodes == j.n_nodes == 300
    elif gen == "full":
        _equal(p_graph.full_graph_batch(p, edge_multiple=64, device=CPU),
               j_graph.full_graph_batch(j, edge_multiple=64))
    elif gen == "sampled":
        ss = (j_graph.SampledShape(8, (5, 3)), p_graph.SampledShape(8, (5, 3)))
        assert (ss[1].max_nodes, ss[1].max_edges) == (ss[0].max_nodes, ss[0].max_edges)
        _equal(p_graph.sample_subgraph(p, ss[1], seed, seed + 1, device=CPU),
               j_graph.sample_subgraph(j, ss[0], seed, seed + 1))
    else:
        _equal(p_graph.molecule_batch(4, 7, 12, 5, seed, step=2, device=CPU),
               j_graph.molecule_batch(4, 7, 12, 5, seed, step=2))
    assert p_graph.pad_edges(2000) == j_graph.pad_edges(2000) == 2048


@pytest.mark.parametrize("kind", ["full", "molecule"])
def test_params_from_numpy_carries_reference_init(kind):
    jc, pc = _cfgs(kind)
    arrays = _ref_params(kind)
    params = _port_params(kind, pc)
    want = dict(flatten_with_paths(arrays))
    got = dict(flatten_with_paths(params))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k
    assert pc.n_params() == jc.n_params()
    own = pc.init(0, CPU)
    assert [tuple(t.shape) for t in leaves(own)] == [tuple(t.shape) for t in leaves(params)]
    assert p_egnn.pad_nodes(2708) == j_egnn.pad_nodes(2708) == 3072


def _ref_outputs(jc, kind):
    arrays, batch = _ref_params(kind), _ref_batch(kind)
    (out, x) = jax.jit(lambda p, b: j_egnn.forward(jc, p, b))(arrays, batch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_egnn.loss_fn(jc, p, b), has_aux=True))(arrays, batch)
    return _np((out, x, loss, metrics, grads))


@functools.cache
def _f32_ref(kind):
    return _ref_outputs(_cfgs(kind)[0], kind)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_and_loss_equal_reference(kind):
    """SMOKE at f32: node outputs, coordinates, the loss and its metrics."""
    _, pc = _cfgs(kind)
    out, x, loss, metrics, _ = _f32_ref(kind)
    params, batch = _port_params(kind, pc), _to_torch(_ref_batch(kind))
    p_out, p_x = p_egnn.forward(pc, params, batch)
    assert p_out.dtype == torch.float32 and p_out.shape == out.shape
    _close(p_out, out, F32_TOL, "out")
    _close(p_x, x, F32_TOL, "x")
    p_loss, p_metrics = p_egnn.loss_fn(pc, params, batch)
    _close(p_loss, loss, F32_TOL, "loss")
    assert sorted(p_metrics) == sorted(metrics)
    for k in metrics:
        _close(p_metrics[k], metrics[k], F32_TOL, k)


class _Ops(TorchDispatchMode):
    """Records the aten ops that run, backward included."""

    def __init__(self):
        super().__init__()
        self.atomic = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        accumulate = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        if (name in ("index_add", "index_add_", "scatter_add", "scatter_add_",
                     "scatter_reduce", "scatter_reduce_", "segment_reduce",
                     "embedding_dense_backward", "index_select_backward", "put_")
                or (name in ("index_put", "index_put_", "_index_put_impl_") and accumulate)):
            self.atomic.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_equal_reference_without_scatter_adds(kind):
    """SMOKE at f32: every parameter's gradient; no op of the forward or
    the backward is a scatter-add (on the card those run on atomics)."""
    _, pc = _cfgs(kind)
    grads = _f32_ref(kind)[4]
    params, batch = _port_params(kind, pc), _to_torch(_ref_batch(kind))
    with _Ops() as ops:
        _, _, p_grads = value_and_grad(lambda p, b: p_egnn.loss_fn(pc, p, b), params, batch)
    assert ops.atomic == []
    want = dict(flatten_with_paths(grads))
    got = dict(flatten_with_paths(p_grads))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v, GRAD_TOL, k)


@pytest.mark.parametrize("kind", ["hub", "molecule"])
def test_bf16_compute_equal_reference(kind):
    """The published dtypes (bf16 messages, f32 parameters and loss), with
    a hub of more than 256 incoming edges, where a bf16 sum that rounds
    after every add saturates: outputs, coordinates and loss within
    ``BF16_REL`` of each one's largest magnitude, gradients within
    ``BF16_GRAD_REL`` in relative norm."""
    jc, pc = _cfgs(kind, compute_dtype=torch.bfloat16)
    batch = _ref_batch(kind)
    if kind == "hub":
        deg = np.bincount(batch["receivers"][batch["edge_mask"]])
        assert deg.max() > 256
    out, x, loss, _, grads = _ref_outputs(jc, kind)
    params, tb = _port_params(kind, pc), _to_torch(batch)
    p_out, p_x = p_egnn.forward(pc, params, tb)
    assert p_x.dtype == torch.bfloat16
    p_loss, _, p_grads = value_and_grad(lambda p, b: p_egnn.loss_fn(pc, p, b), params, tb)
    for k, got, want in (("out", p_out, out), ("x", p_x, x), ("loss", p_loss, loss)):
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (k, err, np.abs(want).max())
    got = dict(flatten_with_paths(p_grads))
    for k, want in flatten_with_paths(grads):
        rel = np.linalg.norm(got[k].numpy() - want) / np.linalg.norm(want)
        assert rel <= BF16_GRAD_REL, (k, rel)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ordered_segment_sum_equals_xla(dtype):
    """``segment_sum`` and the gather's backward bitwise equal to XLA's
    ``segment_sum`` and its gather's transpose, on a hub of 600 edges
    whose bf16 sum, rounded after every add, differs from an f32
    accumulation rounded once; masked edges hold zeros."""
    rng = np.random.default_rng(4)
    E, N, D = 3000, 40, 5
    ids = rng.integers(0, N, E).astype(np.int32)
    ids[rng.permutation(E)[:600]] = 3
    mask = rng.random(E) < 0.9
    vals = (rng.normal(0, 1, (E, D)) + 0.5).astype(np.float32) * mask[:, None]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(lambda v, i: jax.ops.segment_sum(
        v.astype(jd), i, num_segments=N))(vals, ids).astype(jnp.float32))
    t_ids = torch.from_numpy(ids)
    plan = p_egnn.segment_plan(t_ids, N, torch.from_numpy(mask))
    got = p_egnn.segment_sum(torch.from_numpy(vals).to(td), plan)
    assert got.dtype == td and np.array_equal(got.float().numpy(), want)
    once = torch.zeros((N, D)).index_add_(0, t_ids.long(), torch.from_numpy(vals).to(td).float())
    if dtype == "bfloat16":
        assert not np.array_equal(once.to(td).float().numpy(), want)
    # the gather's backward: XLA's scatter-add of the cotangent
    src = rng.normal(0, 1, (N, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: s.astype(jd)[ids], src)
    want_g = np.asarray(vjp(jnp.asarray(vals).astype(jd))[0].astype(jnp.float32))
    s = torch.from_numpy(src).to(td).requires_grad_(True)
    p_egnn.gather(s, plan).backward(torch.from_numpy(vals).to(td))
    assert np.array_equal(s.grad.float().numpy(), want_g)


@pytest.mark.parametrize("kind", ["equivariance", "sampled", "molecule"])
def test_equivariance_on_port(kind):
    """The reference's test (tests/test_arch_smoke.py, ``test_equivariance``)
    on the port: a rotation by 1.1 rad and a translation of the inputs
    leave the node outputs unchanged and move the coordinates with them."""
    _, pc = _cfgs(kind)
    params, batch = _port_params(kind, pc), _to_torch(_ref_batch(kind))
    h1, x1 = p_egnn.forward(pc, params, batch)
    th = 1.1
    R = torch.tensor([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]],
                     dtype=torch.float32)
    t = torch.tensor([0.5, -1.0, 2.0])
    b2 = dict(batch)
    b2["coords"] = batch["coords"] @ R.T + t
    h2, x2 = p_egnn.forward(pc, params, b2)
    torch.testing.assert_close(h1, h2, atol=2e-4, rtol=0)
    torch.testing.assert_close(x1 @ R.T + t, x2, atol=2e-4, rtol=0)


def _cell_shapes(spec_name):
    """(port spec with SMOKE widths, reference spec likewise), minibatch_lg
    at a reduced graph and sample (its published graph is 114.6M edges)."""
    small = {"minibatch_lg": dict(n_nodes=3000, n_edges=40_000, batch_nodes=16,
                                  fanouts=(4, 3), d_feat=602, n_classes=41)}
    out = []
    for spec in (get_arch("egnn"), j_get_arch("egnn")):
        shapes = tuple(dataclasses.replace(s, params=small.get(s.name, s.params))
                       for s in spec.shapes)
        out.append(dataclasses.replace(spec, config=spec.smoke_config, shapes=shapes))
    return out


@pytest.mark.parametrize("shape_name", ["full_graph_sm", "minibatch_lg", "molecule"])
def test_gnn_cell_matches_reference_and_steps(shape_name):
    """The cell's arrays in the reference's shapes and dtypes (nodes padded
    with zero rows and label −1, edges to ``pad_edges``), its parameters
    and a zero optimizer state, ``donate`` and ``model_flops`` equal to the
    reference's ``build_cell(..., mesh=None)``; one CPU train step."""
    p_spec, j_spec = _cell_shapes(shape_name)
    shape = p_spec.shape(shape_name)
    cell = p_steps.build_cell(p_spec, shape, device=CPU, seed=2)
    ref = j_steps.build_cell(j_spec, j_spec.shape(shape_name), None)
    assert cell.donate == ref.donate == (0, 1)
    assert cell.model_flops == ref.model_flops
    params, state, batch = cell.args
    j_params, j_state, j_batch = ref.args
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in batch.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in j_batch.items()}
    for got, want in ((params, j_params), (state["m"], j_state["m"]), (state["v"], j_state["v"])):
        assert [(k, tuple(v.shape)) for k, v in flatten_with_paths(got)] == \
            [(k, v.shape) for k, v in flatten_with_paths(want)]
    assert int(state["step"]) == 0 and not any(t.any() for t in leaves((state["m"], state["v"])))
    cfg = p_steps.gnn_cell_config(p_spec, shape)
    if shape.kind == "gnn_full":
        n = shape.params["n_nodes"]
        assert not batch["feats"][n:].any() and (batch["labels"][n:] == -1).all()
        assert (batch["labels"][:n] >= 0).all() and cfg.n_classes == 7
    if shape.kind == "gnn_molecule":
        assert cfg.n_classes == 0 and batch["edge_mask"].all()
    before = [t.clone() for t in leaves(params)]
    p2, s2, m = cell.fn(*cell.args)
    assert p2 is params and s2 is state and int(state["step"]) == 1
    assert all(torch.isfinite(m[k]) for k in ("loss", "grad_norm", "lr"))
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(params)))


_LOSS_LINE = re.compile(r"^step +(\d+) +loss (\S+) ")


def test_train_cli_gnn_family_replays_after_failure(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch egnn`` on the CPU, a
    checkpoint every 2 steps and a failure at step 5: its loss lines equal
    the run without the failure (step 4 twice); the family's loss and
    batch are the reference's 512-node graph and EGNN loss."""
    base = ["--device", CPU, "--arch", "egnn", "--steps", "8", "--ckpt-every", "2"]
    runs = {}
    for tag, extra in (("fault", ["--simulate-failure", "5"]), ("clean", [])):
        p_train.main(base + ["--ckpt-dir", str(tmp_path / tag)] + extra)
        runs[tag] = capsys.readouterr().out.splitlines()
    losses = {tag: [_LOSS_LINE.match(x).groups() for x in out if _LOSS_LINE.match(x)]
              for tag, out in runs.items()}
    assert [int(s) for s, _ in losses["clean"]] == list(range(8))
    assert [int(s) for s, _ in losses["fault"]] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert set(losses["fault"]) == set(losses["clean"])
    assert "[fault] restoring step 4" in runs["fault"]
    spec = get_arch("egnn")
    cfg = spec.smoke_config
    _, batch_fn = p_train.loss_and_batch_fns(spec, cfg, 8, 16, 0, CPU)
    jg = j_graph.make_powerlaw_graph(512, 2048, cfg.d_feat, n_classes=cfg.n_classes, seed=0)
    _equal(batch_fn(3), _np(j_graph.full_graph_batch(jg, edge_multiple=8)))
