"""The port's sharding specs, production meshes and shapes-only cells
against the JAX reference on the CPU, with no fake devices: every leaf's
partition spec (``logical_spec``, ``param_specs``, ``zero1_sharding``), its
shard shape, the ``meta`` parameters and input specs, every cell's
arguments and ``model_flops`` (the geoweb CONFIG index included) on
``jax.sharding.AbstractMesh`` of the reference's two production layouts;
and the two leftover functions ``geo_score_upper_bound`` and
``quantize_impacts``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.core import footprint as j_fp  # noqa: E402
from repro.core import text_index as j_ti  # noqa: E402
from repro.data import lm as j_lm  # noqa: E402
from repro.data import recsys as j_rec  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import params as j_params  # noqa: E402
from repro.sharding import specs as j_specs  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs.base import get_arch, list_archs  # noqa: E402
from repro_torch.core import distributed as p_dist  # noqa: E402
from repro_torch.core import footprint as p_fp  # noqa: E402
from repro_torch.core import text_index as p_ti  # noqa: E402
from repro_torch.data import lm as p_lm  # noqa: E402
from repro_torch.data import recsys as p_rec  # noqa: E402
from repro_torch.launch import mesh as p_mesh  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.models import params as p_params  # noqa: E402
from repro_torch.sharding import specs as p_specs  # noqa: E402
from repro_torch.train import optimizer as p_opt  # noqa: E402

MESHES = {
    "single_pod_16x16": ((16, 16), ("data", "model"), False),
    "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"), True),
}
ARCHS = list_archs()


def _meshes(name):
    shape, axes, multi = MESHES[name]
    return AbstractMesh(shape, axes), p_mesh.make_production_mesh(multi_pod=multi)


def _entries(spec) -> tuple:
    return tuple(spec)


def _leaves(tree, path=""):
    """(path, leaf) of dicts, lists, tuples and dataclasses, in one order
    for both packages; a partition spec is a leaf."""
    if isinstance(tree, p_specs.PartitionSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}/{i}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}/{f.name}")
    else:
        yield path, tree


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return np.dtype(t.dtype).name


def _same_leaf(path, ref, got):
    """Shape, dtype, spec and shard shape; a reference leaf without a
    sharding (the optimizer's step) is replicated."""
    assert tuple(got.shape) == tuple(ref.shape), path
    assert _dtype_name(got) == _dtype_name(ref), path
    if ref.sharding is None:
        assert not got.sharding.spec.axes(), path
        return
    assert _entries(got.sharding.spec) == _entries(ref.sharding.spec), path
    assert got.sharding.shard_shape(tuple(got.shape)) == ref.sharding.shard_shape(ref.shape), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_reference(arch, mesh_name):
    """Every cell's tensor arguments (shapes, dtypes, specs, shard shapes),
    ``donate`` and ``model_flops`` equal the reference's cell on the
    abstract mesh; the decode cell's ``pos`` is a Python int in the port."""
    jm, pm = _meshes(mesh_name)
    jspec, pspec = j_get_arch(arch), get_arch(arch)
    for shape in pspec.shapes:
        if shape.skip:
            continue
        want = j_steps.build_cell(jspec, jspec.shape(shape.name), jm)
        got = p_steps.build_cell(pspec, shape, pm, device="meta")
        ref = {p: x for p, x in _leaves(want.args) if isinstance(x, jax.ShapeDtypeStruct)}
        mine = {p: x for p, x in _leaves(got.args) if isinstance(x, torch.Tensor)}
        if shape.kind == "lm_decode":
            assert ref.pop("/3").shape == () and got.args[3] == shape.params["seq_len"] - 1
        assert set(mine) == set(ref), (shape.name, set(mine) ^ set(ref))
        for path in ref:
            assert mine[path].device.type == "meta"
            _same_leaf(f"{shape.name}{path}", ref[path], mine[path])
        assert got.donate == tuple(want.donate), shape.name
        assert got.model_flops == want.model_flops, shape.name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "geoweb"])
def test_param_specs_and_zero1_equal_reference(arch, mesh_name):
    """``param_specs``, ``param_shapes`` and ``zero1_sharding`` of every
    leaf of the arch's CONFIG equal the reference's."""
    jm, pm = _meshes(mesh_name)
    jdefs, pdefs = j_get_arch(arch).config.param_defs(), get_arch(arch).config.param_defs()
    want_specs = dict(_leaves(j_params.param_specs(jdefs, jm)))
    got_specs = dict(_leaves(p_params.param_specs(pdefs, pm)))
    want = dict(_leaves(j_params.param_shapes(jdefs, jm)))
    got = dict(_leaves(p_params.param_shapes(pdefs, pm)))
    assert list(got) == list(want) and list(got_specs) == list(want)
    for path, ref in want.items():
        _same_leaf(path, ref, got[path])
        assert _entries(got_specs[path]) == _entries(want_specs[path]), path
        z_ref = j_opt.zero1_sharding(jm, ref.sharding.spec, ref.shape)
        z_got = p_opt.zero1_sharding(pm, got[path].sharding.spec, tuple(ref.shape))
        assert _entries(z_got.spec) == _entries(z_ref.spec), path
        assert z_got.shard_shape(tuple(ref.shape)) == z_ref.shard_shape(ref.shape), path


LOGICAL_CASES = [
    # (dims, shape): a KV cache whose 8 kv heads cannot split over 16
    # falls through to head_dim; batch 1 falls through to kv_seq
    (("layers", "batch", "kv_seq", "kv_heads", "head_dim"), (48, 1, 524288, 8, 128)),
    (("layers", "batch", "kv_seq", "kv_heads", "head_dim"), (30, 128, 32768, 3, 64)),
    (("batch", None), (256, 4096)),
    (("edges",), (61859328,)),
    (("vocab", "embed"), (49152, 576)),
    (("rows", None), (10_000_000, 64)),
    (("batch", "batch"), (64, 64)),  # one mesh axis is never used twice
    (("nodes", None), (7, 3)),  # indivisible everywhere: replicated
]


@pytest.mark.parametrize("case", range(len(LOGICAL_CASES)))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_spec_equals_reference(mesh_name, case):
    jm, pm = _meshes(mesh_name)
    dims, shape = LOGICAL_CASES[case]
    want = j_specs.logical_spec(dims, jm.axis_names, None, shape, jm)
    got = p_specs.logical_spec(dims, pm.axis_names, None, shape, pm)
    assert _entries(got) == _entries(want)
    # shape-blind (no mesh sizes), and under a custom rules table
    rules = {**p_specs.DEFAULT_RULES, "embed": ("model",)}
    assert _entries(p_specs.logical_spec(dims, pm.axis_names)) == \
        _entries(j_specs.logical_spec(dims, jm.axis_names))
    assert _entries(p_specs.logical_spec(dims, pm.axis_names, rules, shape, pm)) == \
        _entries(j_specs.logical_spec(dims, jm.axis_names, rules, shape, jm))


def test_rules_context_and_meshes():
    """One rules table (equal to the reference's; the geo engine resolves
    its doc and query axes from it, with no table of its own), the context
    manager, ``shard``, and the production and host meshes."""
    assert p_specs.DEFAULT_RULES == j_specs.DEFAULT_RULES
    assert not hasattr(p_dist, "SHARDING_RULES")
    assert p_dist.DEFAULT_RULES is p_specs.DEFAULT_RULES
    single, multi = (p_mesh.make_production_mesh(multi_pod=m) for m in (False, True))
    assert p_dist.mesh_axes(single) == (("data",), "model")
    assert p_dist.mesh_axes(multi) == (j_specs.DEFAULT_RULES["docs"], "model")
    assert (single.axis_names, single.axis_sizes, single.size) == (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, multi.axis_sizes, multi.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert single.device.type == multi.device.type == "meta"
    host = p_mesh.make_host_mesh(device="cpu")
    assert (host.axis_names, host.axis_sizes) == (("data", "model"), (1, 1))
    assert p_dist.make_mesh((4, 2), ("data", "model"), device="meta").size == 8
    x = torch.zeros((32, 8))
    assert p_specs.shard(x, "batch", None) is x and not hasattr(x, "sharding")
    with p_specs.use_sharding(single) as ctx:
        assert p_specs.get_context() is ctx
        p_specs.shard(x, "batch", None)
        assert x.sharding.spec == p_specs.PartitionSpec("data", None)
        assert x.sharding.shard_shape((32, 8)) == (2, 8)
    assert p_specs.get_context().mesh is None


def test_input_specs_equal_reference():
    """The ``*_input_specs`` helpers: the reference's keys, shapes and
    dtypes, as meta tensors."""
    cases = [
        (j_lm.lm_input_specs(j_lm.LMDataConfig(1000, 128, 4)),
         p_lm.lm_input_specs(p_lm.LMDataConfig(1000, 128, 4))),
        (j_rec.ctr_input_specs(64, 13, 26), p_rec.ctr_input_specs(64, 13, 26)),
        (j_rec.ctr_input_specs(64, 0, 39), p_rec.ctr_input_specs(64, 0, 39)),
        (j_rec.bst_input_specs(64, 20, 3), p_rec.bst_input_specs(64, 20, 3)),
        (j_rec.two_tower_input_specs(64, 4, 3, 20), p_rec.two_tower_input_specs(64, 4, 3, 20)),
    ]
    for want, got in cases:
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert _dtype_name(got[k]) == _dtype_name(want[k]), k
            assert got[k].device.type == "meta"


def test_geoweb_guard_on_small_mesh():
    """The shapes-only geoweb CONFIG cell runs the int32 guard: 4 doc
    shards hold 2^31 postings each, as the reference refuses."""
    spec = get_arch("geoweb")
    mesh = p_dist.make_mesh((4, 2), ("data", "model"), device="meta")
    with pytest.raises(ValueError, match="shard the docs over >= 8"):
        p_steps.build_cell(spec, spec.shapes[0], mesh, device="meta")
    jspec = j_get_arch("geoweb")
    with pytest.raises(ValueError, match="shard the docs over >= 8"):
        j_steps.build_cell(jspec, jspec.shapes[0], AbstractMesh((4, 2), ("data", "model")))


def test_geo_score_upper_bound_equals_reference():
    rng = np.random.default_rng(5)
    lo = rng.random((3, 50, 2), dtype=np.float32) * 0.8
    mbr = np.concatenate([lo, lo + rng.random((3, 50, 2), dtype=np.float32) * 0.3], -1)
    mass = rng.random((3, 50), dtype=np.float32) * 0.05
    qlo = rng.random((4, 2), dtype=np.float32) * 0.7
    qr = np.concatenate([qlo, qlo + 0.25], -1).astype(np.float32)
    qa = rng.random(4, dtype=np.float32)
    want = np.asarray(j_fp.geo_score_upper_bound(jnp.asarray(mbr), jnp.asarray(mass),
                                                 jnp.asarray(qr), jnp.asarray(qa)))
    got = p_fp.geo_score_upper_bound(*(torch.from_numpy(a) for a in (mbr, mass, qr, qa)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("layout", ["docid", "impact"])
def test_quantize_impacts_equals_reference(layout):
    """The deprecated shim: f16 impacts and refreshed block maxima equal."""
    rng = np.random.default_rng(7)
    docs = [rng.integers(0, 40, size=rng.integers(1, 30)).astype(np.int32) for _ in range(300)]
    want = j_ti.quantize_impacts(j_ti.build_text_index_np(docs, 40, layout=layout))
    got = p_ti.quantize_impacts(p_ti.build_text_index_np(docs, 40, layout=layout, device="cpu"))
    assert got.impacts.dtype == torch.float16
    np.testing.assert_array_equal(got.impacts.numpy(), np.asarray(want.impacts))
    np.testing.assert_array_equal(got.blk_max_impact.numpy(), np.asarray(want.blk_max_impact))
