"""PyTorch port of the recsys serving path against the JAX reference on the
CPU: the embedding substrate, ``rms_norm``, the two-tower towers, losses
and candidate scoring (with and without the geo blend, whose geo_score the
reference runs in interpret mode), DCN-v2, AutoInt and BST at their SMOKE
configs; the weight carry-over, the configs, the data generators and the
cell builder.  Weights come from the reference's ``cfg.init`` and batches
from its generators, both carried across as numpy."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.data import recsys as j_data  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import recsys as j_rec  # noqa: E402
from repro.models.layers import rms_norm as j_rms_norm  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_arch, list_archs  # noqa: E402
from repro_torch.data import recsys as p_data  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.models import recsys as p_rec  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.params import ParamDef, init_params, params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)  # XLA and torch sum matmuls in other orders
ARCHS = ["two-tower-retrieval", "dcn-v2", "autoint", "bst"]
CPU = "cpu"


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@functools.cache
def _smoke(name):
    """(reference cfg, port cfg, reference params, port params)."""
    jc, pc = j_get_arch(name).smoke_config, get_arch(name).smoke_config
    jp = jax.jit(jc.init)(jax.random.key(0))
    return jc, pc, jp, params_from_numpy(pc.param_defs(), _np(jp), CPU)


def _jit(fn, cfg):
    """A reference function, jitted as its steps run (one compile instead
    of one per eager op)."""
    return jax.jit(functools.partial(fn, cfg))


def _ref_batch(cfg, B, seed=0):
    """The reference's batch for ``cfg`` (jitted: one compile)."""
    return jax.jit(lambda: _ref_batch_eager(cfg, B, seed))()


def _ref_batch_eager(cfg, B, seed):
    name = type(cfg).__name__
    if name == "DCNv2Config":
        return j_data.ctr_batch(B, cfg.n_dense, cfg.vocab_sizes, seed=seed)
    if name == "AutoIntConfig":
        return j_data.ctr_batch(B, 0, cfg.vocab_sizes, seed=seed)
    if name == "BSTConfig":
        return j_data.bst_batch(B, cfg.n_items, cfg.seq_len, cfg.n_other_fields,
                                cfg.field_vocab, seed=seed)
    return j_data.two_tower_batch(B, cfg.n_users, cfg.n_items, cfg.n_user_fields,
                                  cfg.n_item_fields, cfg.field_vocab, cfg.hist_len, seed=seed)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# models: each forward and loss value against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_loss_match_reference(name):
    jc, pc, jp, pp = _smoke(name)
    jb = dict(_ref_batch(jc, 16))
    if name == "two-tower-retrieval":  # −1 padded histories, one empty
        hist = np.array(jb["history"])
        hist[::3, :2] = -1
        hist[1] = -1
        jb["history"] = jnp.asarray(hist)
    pb = _t(_np(jb))
    if name == "two-tower-retrieval":
        _close(p_rec.two_tower_user(pc, pp, pb), _jit(j_rec.two_tower_user, jc)(jp, jb))
        _close(p_rec.two_tower_item(pc, pp, pb["target"], pb["item_fields"]),
               _jit(j_rec.two_tower_item, jc)(jp, jb["target"], jb["item_fields"]))
        pairs = [(p_rec.two_tower_loss, j_rec.two_tower_loss, "nll")]
    else:
        fwd = {"dcn-v2": "dcn_v2", "autoint": "autoint", "bst": "bst"}[name]
        _close(getattr(p_rec, fwd + "_forward")(pc, pp, pb),
               _jit(getattr(j_rec, fwd + "_forward"), jc)(jp, jb))
        pairs = [(getattr(p_rec, fwd + "_loss"), getattr(j_rec, fwd + "_loss"), "bce")]
    for p_loss, j_loss, key in pairs:
        (pl, pm), (jl, jm) = p_loss(pc, pp, pb), _jit(j_loss, jc)(jp, jb)
        _close(pl, jl)
        _close(pm[key], jm[key])
        assert set(pm) == set(jm)


def test_bst_masks_padded_history_as_reference():
    """BST appends the target and masks −1 history slots (zero embedding
    before the position embedding)."""
    jc, pc, jp, pp = _smoke("bst")
    jb = dict(_ref_batch(jc, 8))
    hist = np.array(jb["history"])
    hist[::2, :3] = -1
    jb["history"] = jnp.asarray(hist)
    _close(p_rec.bst_forward(pc, pp, _t(_np(jb))), _jit(j_rec.bst_forward, jc)(jp, jb))


# ---------------------------------------------------------------------------
# the embedding substrate and rms_norm
# ---------------------------------------------------------------------------

def _table(rng, V=40, D=6):
    return rng.normal(size=(V, D)).astype(np.float32)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(3)
    table = _table(rng)
    ids = rng.integers(-1, 40, (2, 5, 7)).astype(np.int32)  # −1 padding
    ids[0, 1] = -1  # an empty bag
    got = p_rec.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode)
    want = j_rec.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode)
    _close(got, want)
    assert (got[0, 1] == 0).all()
    with pytest.raises(ValueError):
        p_rec.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), "median")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_ragged_matches_reference(weighted, mode):
    rng = np.random.default_rng(4)
    table = _table(rng)
    num_bags = 6
    lens = np.array([3, 0, 5, 1, 4, 2])  # bag 1 is empty
    seg = np.repeat(np.arange(num_bags), lens).astype(np.int32)
    flat = rng.integers(0, 40, seg.size).astype(np.int32)
    flat[[1, 6]] = -1  # padding inside bags 0 and 2
    w = rng.uniform(0.1, 2.0, seg.size).astype(np.float32) if weighted else None
    got = p_rec.embedding_bag_ragged(
        torch.from_numpy(table), torch.from_numpy(flat), torch.from_numpy(seg), num_bags,
        None if w is None else torch.from_numpy(w), mode)
    want = j_rec.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), num_bags,
        None if w is None else jnp.asarray(w), mode)
    _close(got, want)
    assert (got[1] == 0).all()


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3, 16)).astype(np.float32) * 3.0
    w = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           j_rms_norm(jnp.asarray(x), jnp.asarray(w)))


# ---------------------------------------------------------------------------
# two-tower retrieval, with and without the geo blend
# ---------------------------------------------------------------------------

NC, R, Q = 256, 3, 2
Q_RECTS = np.array([[0.1, 0.1, 0.3, 0.3], [0.6, 0.6, 0.7, 0.7]], np.float32)


def _candidates(cfg):
    rng = np.random.default_rng(7)
    cand_ids = (np.arange(NC) % cfg.n_items).astype(np.int32)
    cand_fields = rng.integers(0, cfg.field_vocab, (NC, cfg.n_item_fields)).astype(np.int32)
    lo = rng.uniform(0, 0.9, (NC, R, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + np.float32(0.05)], axis=2)
    geo = {"cand_rects": rects, "cand_amps": rng.uniform(0.5, 1.0, (NC, R)).astype(np.float32),
           "q_rects": Q_RECTS, "q_amps": np.array([1.0, 0.7], np.float32), "weight": 5.0}
    return cand_ids, cand_fields, geo


def _assert_ids_match_where_separated(got_s, got_i, want_s, want_i):
    """Ids equal wherever the reference's adjacent scores differ by more
    than the tolerance; the −inf picks (equal scores, lower position first)
    equal exactly."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], **TOL)
    np.testing.assert_array_equal(got_i[~fin], want_i[~fin])
    tol = TOL["atol"] + TOL["rtol"] * np.abs(want_s)
    gap = np.abs(np.diff(np.where(fin, want_s, -1e30), axis=-1))
    sep = np.ones_like(fin)
    sep[:, 1:] &= gap > tol[:, 1:]
    sep[:, :-1] &= gap > tol[:, :-1]
    sep &= fin
    assert sep.sum() > 0.5 * fin.sum()
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


@pytest.mark.parametrize("with_geo", [False, True])
def test_score_candidates_matches_reference(with_geo):
    jc, pc, jp, pp = _smoke("two-tower-retrieval")
    jb = _ref_batch(jc, 2, seed=3)
    cand_ids, cand_fields, geo = _candidates(jc)
    top_k = 100
    j_geo = None if not with_geo else {k: (v if k == "weight" else jnp.asarray(v))
                                       for k, v in geo.items()}
    p_geo = None if not with_geo else {k: (v if k == "weight" else torch.from_numpy(v))
                                       for k, v in geo.items()}
    want_s, want_i = jax.jit(functools.partial(
        j_rec.two_tower_score_candidates, jc, top_k=top_k))(
        jp, jb, jnp.asarray(cand_ids), jnp.asarray(cand_fields), geo=j_geo)
    reset_launch_counts()
    got_s, got_i = p_rec.two_tower_score_candidates(
        pc, pp, _t(_np(jb)), torch.from_numpy(cand_ids), torch.from_numpy(cand_fields),
        top_k=top_k, geo=p_geo)
    assert launch_counts()["geo_score"] == 0  # CPU tensors run the plain version
    assert got_s.shape == got_i.shape == (2, top_k)
    assert got_i.dtype == torch.int64 and got_s.dtype == torch.float32
    _assert_ids_match_where_separated(got_s, got_i, want_s, want_i)
    if not with_geo:
        assert np.isfinite(np.asarray(want_s)).all()
        return
    # the geo scores: the masked set exactly, the values as the kernel's
    # plain version is held to the reference (tests/test_torch_kernels.py)
    from repro.kernels.geo_score.ops import geo_score_docs as j_geo_docs
    from repro_torch.kernels.geo_score.ops import geo_score_docs as p_geo_docs

    g_want = np.asarray(j_geo_docs(*(jnp.asarray(geo[k]) for k in
                                     ("cand_rects", "cand_amps", "q_rects", "q_amps"))))
    g_got = p_geo_docs(*(p_geo[k][None] for k in
                         ("cand_rects", "cand_amps", "q_rects", "q_amps")))[0].numpy()
    np.testing.assert_array_equal(g_got > 0, g_want > 0)
    np.testing.assert_array_max_ulp(g_got, g_want, maxulp=2)
    n_match = int((g_want > 0).sum())
    assert 0 < n_match < top_k and (g_want == 0).any()
    # every row ends in top_k − n_match −inf picks, at the lowest positions
    # of the candidates outside the footprint
    outside = np.flatnonzero(g_want == 0)[: top_k - n_match]
    for row_s, row_i in zip(got_s.numpy(), got_i.numpy()):
        assert int(np.isneginf(row_s).sum()) == top_k - n_match
        np.testing.assert_array_equal(row_i[n_match:], outside)


def test_geo_blend_is_one_rounding_and_masks_outside():
    """``scores + w·g`` rounded once (the reference's fused multiply-add)
    and −inf where g == 0."""
    rng = np.random.default_rng(8)
    s = rng.normal(size=(3, 64)).astype(np.float32)
    g = rng.uniform(0, 1e-3, 64).astype(np.float32)
    g[::5] = 0.0
    got = p_rec.geo_blend(torch.from_numpy(s), torch.from_numpy(g), 5.0).numpy()
    want = (np.float64(np.float32(5.0)) * g.astype(np.float64) + s).astype(np.float32)
    want = np.where(g[None] > 0, want, -np.inf)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# parameters: the weight carry-over and init
# ---------------------------------------------------------------------------

def test_params_from_numpy_rejects_mismatches():
    cfg = get_arch("dcn-v2").smoke_config
    jp = _np(_smoke("dcn-v2")[2])
    defs = cfg.param_defs()
    ok = params_from_numpy(defs, jp, CPU)
    assert set(ok) == set(defs) and ok["cross_w0"].dtype == torch.float32
    bad = dict(jp, cross_w0=jp["cross_w0"][:, :-1])
    with pytest.raises(ValueError, match="cross_w0: shape"):
        params_from_numpy(defs, bad, CPU)
    bad = dict(jp, cross_b0=jp["cross_b0"].astype(np.float64))
    with pytest.raises(TypeError, match="cross_b0: dtype"):
        params_from_numpy(defs, bad, CPU)
    bad = {k: v for k, v in jp.items() if k != "logit_b"}
    with pytest.raises(KeyError, match="missing \\['logit_b'\\]"):
        params_from_numpy(defs, bad, CPU)
    with pytest.raises(KeyError, match="unexpected \\['extra'\\]"):
        params_from_numpy(defs, dict(jp, extra=jp["logit_b"]), CPU)


def test_init_params_follows_defs_and_seed():
    defs = {"b": ParamDef((300, 8), (None, None), init="embed"),
            "a": {"w": ParamDef((64, 32), (None, None)), "z": ParamDef((5,), (None,), init="zeros"),
                  "o": ParamDef((5,), (None,), init="ones")}}
    p0, p1 = init_params(defs, 0, CPU), init_params(defs, 1, CPU)
    again = init_params(defs, 0, CPU)
    assert p0["b"].shape == (300, 8) and p0["a"]["w"].shape == (64, 32)
    assert torch.equal(p0["b"], again["b"]) and not torch.equal(p0["b"], p1["b"])
    assert (p0["a"]["z"] == 0).all() and (p0["a"]["o"] == 1).all()
    assert abs(float(p0["b"].std()) - 0.02) < 0.003  # embed: 0.02
    assert abs(float(p0["a"]["w"].std()) - 1 / 8) < 0.02  # fan-in 64


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

def test_vocabs_match_reference():
    assert p_data.CRITEO_VOCABS == j_data.CRITEO_VOCABS
    assert p_data.avazu_like_vocabs() == j_data.avazu_like_vocabs()
    assert p_data.avazu_like_vocabs(11, seed=5) == j_data.avazu_like_vocabs(11, seed=5)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    j, p = j_get_arch(name), get_arch(name)
    for jc, pc in ((j.config, p.config), (j.smoke_config, p.smoke_config)):
        assert pc.n_params() == jc.n_params()
        assert {k: d.shape for k, d in pc.param_defs().items()} == \
            {k: d.shape for k, d in jc.param_defs().items()}
        assert {k: d.logical for k, d in pc.param_defs().items()} == \
            {k: d.logical for k, d in jc.param_defs().items()}
    assert [(s.name, s.kind, s.params) for s in p.shapes] == \
        [(s.name, s.kind, s.params) for s in j.shapes]
    assert (p.name, p.family, p.source) == (j.name, j.family, j.source)
    for s in p.shapes:
        train = s.kind == "recsys_train"
        B = s.params["batch"] if s.kind != "recsys_retrieval" else s.params["n_candidates"]
        if s.kind == "recsys_retrieval" and name == "two-tower-retrieval":
            assert p_steps._two_tower_retrieval_flops(p.config, 1, B) == \
                j_steps._two_tower_retrieval_flops(j.config, 1, B)
        else:
            assert p_steps._recsys_flops(p.config, B, train) == \
                j_steps._recsys_flops(j.config, B, train)


def test_registry_lists_only_ported_archs():
    """Every arch of the reference is ported, ``egnn`` the last; an
    unknown name raises."""
    assert list_archs() == sorted(
        [*ARCHS, "egnn", "geoweb", "granite-moe-1b-a400m", "olmoe-1b-7b", "qwen1.5-0.5b",
         "qwen2.5-14b", "smollm-135m"])
    assert get_arch("egnn").family == "gnn"
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gcn")


@pytest.mark.parametrize("kind", ["ctr_dense", "ctr", "bst", "two_tower"])
def test_data_generators_match_reference_layout(kind):
    B = 4096
    if kind.startswith("ctr"):
        nd = 5 if kind == "ctr_dense" else 0
        vs = (7, 1000, 10_131_227)
        j = jax.jit(lambda: j_data.ctr_batch(B, nd, vs, seed=2))()
        p = p_data.ctr_batch(B, nd, vs, seed=2, device=CPU)
        s = p["sparse"].numpy()
        assert (s >= 0).all() and (s < np.array(vs)).all()
        assert abs(float((s[:, 2] / vs[2]).mean()) - 1 / 3) < 0.02  # squared-uniform skew
        if nd:
            assert abs(float(p["dense"].mean())) < 0.05 and abs(float(p["dense"].std()) - 1) < 0.05
    elif kind == "bst":
        j = jax.jit(lambda: j_data.bst_batch(B, 500, 5, 2, 50, seed=2))()
        p = p_data.bst_batch(B, 500, 5, 2, 50, seed=2, device=CPU)
        assert p["history"].min() >= 0 and p["history"].max() < 500
        assert p["other"].min() >= 0 and p["other"].max() < 50
    else:
        j = jax.jit(lambda: j_data.two_tower_batch(B, 1000, 300, 2, 3, 50, 6, seed=2))()
        p = p_data.two_tower_batch(B, 1000, 300, 2, 3, 50, 6, seed=2, device=CPU)
        h = p["history"]
        assert h.min() == -1 and h.max() < 300 and (h == -1).any()
        assert p["user_id"].max() < 1000 and p["target"].max() < 300
        lq = p["logq"].numpy()
        assert (lq >= np.log(np.float32(1e-6)) - 1e-5).all() and (lq <= np.log(1e-3) + 1e-5).all()
    assert set(p) == set(j)
    for k in j:
        assert tuple(p[k].shape) == tuple(j[k].shape), k
        assert str(p[k].dtype).removeprefix("torch.") == str(np.asarray(j[k]).dtype), k
    if "label" in p:
        lab = p["label"].numpy()
        assert set(np.unique(lab)) <= {0.0, 1.0} and abs(float(lab.mean()) - 0.25) < 0.03


def test_data_generators_deterministic_in_seed_and_step():
    def draw(seed, step):
        return p_data.two_tower_batch(64, 1000, 300, 2, 3, 50, 6, seed=seed, step=step,
                                      device=CPU)

    a, b = draw(0, 0), draw(0, 0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["user_id"], draw(0, 1)["user_id"])
    assert not torch.equal(a["user_id"], draw(1, 0)["user_id"])


# ---------------------------------------------------------------------------
# devices and cells
# ---------------------------------------------------------------------------

def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_arch("dcn-v2")
    cfg = spec.smoke_config
    calls = [
        lambda: cfg.init(0),
        lambda: init_params(cfg.param_defs(), 0),
        lambda: params_from_numpy(cfg.param_defs(), {}),
        lambda: p_data.ctr_batch(4, 2, (5, 5)),
        lambda: p_data.bst_batch(4, 10, 3, 2, 5),
        lambda: p_data.two_tower_batch(4, 10, 10, 2, 2, 5, 3),
        lambda: p_steps.build_recsys_cell(spec, spec.shape("serve_p99")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()


def _small(name):
    """The arch at its SMOKE config with small shapes (for the CPU)."""
    from dataclasses import replace

    spec = get_arch(name)
    shapes = (ShapeSpec("train_batch", "recsys_train", dict(batch=8)),
              ShapeSpec("serve", "recsys_serve", dict(batch=8)),
              ShapeSpec("retrieval", "recsys_retrieval", dict(batch=1, n_candidates=300)))
    return replace(spec, config=spec.smoke_config, shapes=shapes)


@pytest.mark.parametrize("name", ARCHS)
def test_build_recsys_cell_runs_on_cpu(name):
    spec = _small(name)
    cfg = spec.config
    serve = p_steps.build_recsys_cell(spec, spec.shape("serve"), device=CPU, seed=1)
    out = serve.fn(*serve.args)
    rows = 8
    assert out.shape == ((rows, cfg.embed_dim) if name == "two-tower-retrieval" else (rows,))
    assert torch.isfinite(out).all() and "label" not in serve.args[1]
    assert serve.model_flops == j_steps._recsys_flops(j_get_arch(name).smoke_config, rows, False)
    retr = p_steps.build_recsys_cell(spec, spec.shape("retrieval"), device=CPU, seed=1)
    vals, idx = retr.fn(*retr.args)
    assert idx.shape[-1] == 100 and torch.isfinite(vals).all()
    assert (vals[..., :-1] >= vals[..., 1:]).all()
    train = p_steps.build_recsys_cell(spec, spec.shape("train_batch"), device=CPU, seed=1)
    _, state, metrics = train.fn(*train.args)
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1
    assert train.model_flops == j_steps._recsys_flops(j_get_arch(name).smoke_config, rows, True)


def test_two_tower_cell_with_geo_matches_the_function():
    spec = _small("two-tower-retrieval")
    cfg = spec.config
    rng = np.random.default_rng(2)
    lo = rng.uniform(0, 0.9, (300, 4, 2)).astype(np.float32)
    geo = {"cand_rects": torch.from_numpy(np.concatenate([lo, lo + np.float32(0.08)], axis=2)),
           "cand_amps": torch.ones((300, 4)), "q_rects": torch.from_numpy(Q_RECTS),
           "q_amps": torch.ones(2), "weight": 5.0}
    cell = p_steps.build_recsys_cell(spec, spec.shape("retrieval"), device=CPU, seed=1, geo=geo)
    params, batch, cand_ids, cand_fields = cell.args
    assert torch.equal(cand_ids, torch.arange(300, dtype=torch.int32) % cfg.n_items)
    assert cand_fields.shape == (300, cfg.n_item_fields) and cand_fields.max() < cfg.field_vocab
    vals, idx = cell.fn(*cell.args)
    want = p_rec.two_tower_score_candidates(cfg, params, batch, cand_ids, cand_fields, 100, geo)
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    assert cell.model_flops == j_steps._two_tower_retrieval_flops(
        j_get_arch("two-tower-retrieval").smoke_config, 1, 300)
    with pytest.raises(ValueError, match="two-tower retrieval"):
        p_steps.build_recsys_cell(spec, spec.shape("serve"), device=CPU, geo=geo)
