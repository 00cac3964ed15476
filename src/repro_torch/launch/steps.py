"""Cell builders (port of ``repro/launch/steps.py``): (arch × shape) → a
:class:`Cell` whose ``fn(*args)`` runs the step.

* ``lm_train``          train_step(params, opt_state, batch): the LM loss
                        (MoE aux included), its gradients by autograd and
                        the AdamW update, in place
* ``lm_prefill``        prefill(params, tokens, cache)
* ``lm_decode``         decode_step(params, cache, tokens, pos)
* ``gnn_*``             train_step(params, opt_state, graph): the EGNN loss
                        (node classification, or graph regression for
                        molecules), its gradients and the AdamW update
* ``recsys_train``      train_step(params, opt_state, batch): the loss,
                        its gradients and the AdamW update, in place
* ``recsys_serve``      forward(params, batch) (two-tower: the user tower)
* ``recsys_retrieval``  candidate scoring and top-k (two-tower: the towers,
                        the dot product, the optional geo blend)
* ``geo_serve``         the mesh serve step over a stacked index

On a real device a cell carries real tensors at the shape's sizes:
parameters from ``cfg.init(seed, device)``, batches from
``repro_torch.data``, a geoweb corpus from ``make_corpus``.  With
``device="meta"`` (``build_cell(spec, shape, mesh, device="meta")``) it is
shapes-only, as the reference's cells of ``ShapeDtypeStruct``s: parameters
from ``param_shapes``, the optimizer state beside them, batches from the
``*_input_specs`` helpers, KV caches of ``make_cache``'s shapes, and the
geoweb index of the reference's per-shard shapes; each tensor carries its
``sharding`` on ``mesh`` (the production sharding config), and nothing is
allocated.  The dry-run (:mod:`repro_torch.launch.dryrun`) traces them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import cache, partial
from typing import Callable

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core import collectives as col
from repro_torch.core.distributed import ProcessMesh
from repro_torch.core.ranking import select_top
from repro_torch.data import graph as graph_data
from repro_torch.data import recsys as rec_data
from repro_torch.data.lm import LMDataConfig, lm_batch, lm_input_specs
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import count_step
from repro_torch.models import egnn as egnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.params import meta_tensor, param_shapes
from repro_torch.sharding.specs import named_sharding, use_sharding
from repro_torch.train.loop import global_loss, make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, zero1_sharding
from repro_torch.train.tree import leaves, tree_map, unflatten


# the train cells' optimizer (lm, gnn, recsys), the reference's
TRAIN_OPT = OptimizerConfig(zero1=True)


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple
    # positions in ``args`` that ``fn`` updates in place (the reference's
    # donated arguments).  Read by launch/roofline.count_step: the step may
    # write no other argument, and a donated one is counted once in memory
    # (its update allocates nothing, as the reference subtracts
    # alias_size_in_bytes) and written once in the step's byte bound
    donate: tuple = ()
    # analytic "useful" flops for this step (2 per multiply-add), global
    model_flops: float = 0.0
    note: str = ""


def _is_meta(dev: torch.device) -> bool:
    return dev.type == "meta"


def _shard_inputs(batch: dict, mesh, logical: dict) -> dict:
    """``batch``'s meta tensors, each given the sharding of its logical axes
    on ``mesh`` (none without a mesh)."""
    if mesh is not None:
        for k, t in batch.items():
            t.sharding = named_sharding(mesh, logical[k], shape=tuple(t.shape))
    return batch


def _opt_shapes(pshapes: dict, mesh) -> dict:
    """The :data:`TRAIN_OPT` state of meta ``pshapes``: ``step`` and the
    moments, which carry their ZeRO-1 shardings (:func:`zero1_sharding`)
    when ``TRAIN_OPT.zero1``, else their leaves'."""
    def moments():
        out = []
        for p in leaves(pshapes):
            m = torch.empty(p.shape, dtype=p.dtype, device="meta")
            if mesh is not None:
                m.sharding = (zero1_sharding(mesh, p.sharding.spec, tuple(p.shape))
                              if TRAIN_OPT.zero1 else p.sharding)
            out.append(m)
        return unflatten(pshapes, out)

    return {"step": meta_tensor((), torch.int32, mesh, ()), "m": moments(), "v": moments()}


def moment_shardings(defs: dict, mesh) -> dict:
    """The ZeRO-1 layout of the moments of ``defs``' parameters on
    ``mesh``: each leaf's :func:`zero1_sharding` of its own spec (the
    reference's ``_moment_shardings``)."""
    return tree_map(lambda s: zero1_sharding(mesh, s.sharding.spec, tuple(s.shape)),
                    param_shapes(defs, mesh))


def _train_step(loss, params: dict, defs: dict, mesh) -> tuple[Callable, dict]:
    """A real cell's :data:`TRAIN_OPT` step and zero state.  On a
    :class:`~repro_torch.core.distributed.ProcessMesh` the step is the
    data-parallel one (built under ``use_sharding(mesh)``) and the moments
    are ZeRO-1's blocks (:func:`moment_shardings`), as the reference's cells
    on a mesh; elsewhere the one-device step."""
    if not isinstance(mesh, ProcessMesh):
        return make_train_step(loss, TRAIN_OPT), init_opt_state(TRAIN_OPT, params)
    ms = moment_shardings(defs, mesh)
    with use_sharding(mesh):
        step = make_train_step(loss, TRAIN_OPT, moment_shardings=ms)
    return step, init_opt_state(TRAIN_OPT, params, ms)


def _cell_device(device, mesh) -> torch.device:
    """``device``, or a process mesh's own when none is given."""
    if device is None and isinstance(mesh, ProcessMesh):
        return mesh.device
    return resolve_device(device)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_flops(cfg, n_tokens: int, kind: str, kv_len: int = 0, batch: int = 1) -> float:
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * n_tokens
    if kind == "prefill":
        return 2.0 * n_active * n_tokens
    # decode: one token per sequence + attention over the cache
    attn = 2.0 * 2.0 * batch * cfg.n_heads * cfg.d_head * kv_len
    return 2.0 * n_active * n_tokens + attn * cfg.n_layers


def build_lm_cell(
    spec: ArchSpec, shape: ShapeSpec, device=None, seed: int = 0, params: dict | None = None,
    mesh=None, overrides: dict | None = None,
) -> Cell:
    """The (arch, shape) LM cell with its inputs on ``device`` (CUDA
    unless given): ``params`` (``cfg.init(seed, device)`` unless given, so
    two cells can share one model) and tokens from ``lm_batch`` of the
    shape's ``global_batch`` × ``seq_len``.  The train cell steps with
    :data:`TRAIN_OPT` from a zero optimizer state on the batch of step 0;
    the serving cells take a zero cache from ``make_cache``, and the decode
    cell writes at ``pos = seq_len − 1``, so its step attends over the
    whole cache.  ``attn_window`` comes from the shape; ``overrides``
    replace config fields (the dry-run's ``n_layers`` and ``attn_chunk``).
    On ``meta`` the cell is shapes-only, sharded on ``mesh``.  On a
    :class:`~repro_torch.core.distributed.ProcessMesh` (on its device
    unless ``device`` is given) the train cell's step is data-parallel with
    ZeRO-1's moments: every rank holds the global batch and steps on its
    rows."""
    cfg = spec.config
    p = shape.params
    if "attn_window" in p:
        cfg = dataclasses.replace(cfg, attn_window=p["attn_window"])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if shape.kind not in ("lm_train", "lm_prefill", "lm_decode"):
        raise ValueError(shape.kind)
    dev = _cell_device(device, mesh)
    meta = _is_meta(dev)
    B, S = p["global_batch"], p["seq_len"]
    if params is None:
        params = param_shapes(cfg.param_defs(), mesh) if meta else cfg.init(seed, dev)

    def tokens_of(seq_len: int) -> dict:
        if meta:
            return _shard_inputs(lm_input_specs(LMDataConfig(cfg.vocab, seq_len, B)), mesh,
                                 {"tokens": ("batch", None), "labels": ("batch", None)})
        return lm_batch(LMDataConfig(cfg.vocab, seq_len, B, seed), 0, dev)

    if shape.kind == "lm_train":
        def loss(prm, b):
            return tf_lib.loss_fn(cfg, prm, b)

        if meta:
            step, opt = make_train_step(loss, TRAIN_OPT), _opt_shapes(params, mesh)
        else:
            step, opt = _train_step(loss, params, cfg.param_defs(), mesh)
        return Cell(
            spec.name, shape.name, step, (params, opt, tokens_of(S)),
            donate=(0, 1), model_flops=_lm_flops(cfg, B * S, "train"),
        )

    if meta:
        cache = param_shapes(tf_lib.cache_defs(cfg, B, S), mesh)
    else:
        cache = tf_lib.make_cache(cfg, B, S, dev)

    if shape.kind == "lm_prefill":
        def fn(params, tokens, cache):
            return tf_lib.prefill(cfg, params, tokens, cache)

        tokens = tokens_of(S)["tokens"]
        return Cell(
            spec.name, shape.name, fn, (params, tokens, cache), donate=(2,),
            model_flops=_lm_flops(cfg, B * S, "prefill"),
        )

    def fn(params, cache, tokens, pos):
        return tf_lib.decode_step(cfg, params, cache, tokens, pos)

    if meta:
        tokens = meta_tensor((B,), torch.int32, mesh, ("batch",))
    else:
        tokens = lm_batch(LMDataConfig(cfg.vocab, 1, B, seed), 0, dev)["tokens"][:, 0]
    return Cell(
        spec.name, shape.name, fn, (params, cache, tokens, S - 1), donate=(1,),
        model_flops=_lm_flops(cfg, B, "decode", kv_len=S, batch=B),
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _egnn_flops(cfg, n_edges: int, n_nodes: int, train: bool = True) -> float:
    H = cfg.d_hidden
    per_edge = 2 * ((2 * H + 1) * H + H * H) + 2 * (H * H + H)  # φ_e + φ_x
    per_node = 2 * (2 * H * H + H * H)  # φ_h
    fwd = cfg.n_layers * (per_edge * n_edges + per_node * n_nodes)
    return (3.0 if train else 1.0) * fwd


def pad_rows(batch: dict, n: int, keys: tuple, fill: dict) -> dict:
    """``keys`` of ``batch`` padded along dim 0 to ``n`` rows of ``fill``
    (0 unless named)."""
    out = dict(batch)
    for k in keys:
        t = batch[k]
        pad = t.new_full((n - t.shape[0], *t.shape[1:]), fill.get(k, 0))
        out[k] = torch.cat([t, pad])
    return out


def gnn_cell_config(spec: ArchSpec, shape: ShapeSpec):
    """``spec.config`` with the shape's ``d_feat`` and ``n_classes`` (0 for
    molecules: graph regression), as the reference's cell."""
    p = shape.params
    n_classes = 0 if shape.kind == "gnn_molecule" else p.get("n_classes", 8)
    return dataclasses.replace(spec.config, d_feat=p["d_feat"], n_classes=n_classes)


def gnn_batch(cfg, shape: ShapeSpec, device, seed: int = 0,
              graph: graph_data.CSRGraph | None = None) -> dict:
    """The cell's graph (step 0) in the reference's shapes and dtypes, on
    ``device`` (``graph``, where given, is the full graph of the first two
    kinds):

    * ``gnn_full``: ``make_powerlaw_graph`` of the shape's sizes through
      ``full_graph_batch`` (edges padded to ``pad_edges``), nodes padded to
      ``pad_nodes`` with zero features and coordinates and label −1;
    * ``gnn_minibatch``: ``sample_subgraph(g, shape, seed, 0)`` of that
      full graph (``max_nodes`` nodes), its edges padded to
      ``pad_edges(max_edges)``;
    * ``gnn_molecule``: ``molecule_batch`` of ``batch`` graphs, its edges
      padded to ``pad_edges``.
    """
    p = shape.params
    edges = ("senders", "receivers", "edge_mask")
    if shape.kind == "gnn_molecule":
        G, npg, epg = p["batch"], p["n_nodes"], p["n_edges"]
        b = graph_data.molecule_batch(G, npg, epg, cfg.d_feat, seed, 0, device=device)
        return pad_rows(b, graph_data.pad_edges(G * epg), edges, {})
    g = graph
    if g is None:
        g = graph_data.make_powerlaw_graph(p["n_nodes"], p["n_edges"], cfg.d_feat,
                                           n_classes=p.get("n_classes", 8), seed=seed,
                                           device=device)
    if shape.kind == "gnn_full":
        b = graph_data.full_graph_batch(g, device=device)
        return pad_rows(b, egnn_lib.pad_nodes(g.n_nodes), ("feats", "coords", "labels"),
                        {"labels": -1})
    if shape.kind == "gnn_minibatch":
        ss = graph_data.SampledShape(p["batch_nodes"], tuple(p["fanouts"]))
        b = graph_data.sample_subgraph(g, ss, seed, 0, device=device)
        return pad_rows(b, graph_data.pad_edges(ss.max_edges), edges, {})
    raise ValueError(shape.kind)


def gnn_input_specs(cfg, shape: ShapeSpec, mesh=None) -> dict:
    """:func:`gnn_batch`'s shapes and dtypes as meta tensors, sharded on
    ``mesh`` as the reference's cells: edges over ``"edges"``, a full
    graph's nodes over ``"nodes"``."""
    p = shape.params
    if shape.kind == "gnn_full":
        N, E = egnn_lib.pad_nodes(p["n_nodes"]), graph_data.pad_edges(p["n_edges"])
    elif shape.kind == "gnn_minibatch":
        ss = graph_data.SampledShape(p["batch_nodes"], tuple(p["fanouts"]))
        N, E = ss.max_nodes, graph_data.pad_edges(ss.max_edges)
    elif shape.kind == "gnn_molecule":
        N, E = p["batch"] * p["n_nodes"], graph_data.pad_edges(p["batch"] * p["n_edges"])
    else:
        raise ValueError(shape.kind)
    node = "nodes" if shape.kind == "gnn_full" else None
    spec = {
        "feats": ((N, cfg.d_feat), torch.float32, (node, None)),
        "coords": ((N, cfg.coord_dim), torch.float32, (node, None)),
        "senders": ((E,), torch.int32, ("edges",)),
        "receivers": ((E,), torch.int32, ("edges",)),
        "edge_mask": ((E,), torch.bool, ("edges",)),
    }
    if shape.kind == "gnn_molecule":
        spec["graph_ids"] = ((N,), torch.int32, (None,))
        spec["targets"] = ((p["batch"],), torch.float32, (None,))
    else:
        spec["labels"] = ((N,), torch.int32, (node,))
    return {k: meta_tensor(sh, dt, mesh, lg) for k, (sh, dt, lg) in spec.items()}


def build_gnn_cell(
    spec: ArchSpec, shape: ShapeSpec, device=None, seed: int = 0, batch: dict | None = None,
    mesh=None,
) -> Cell:
    """The (egnn, shape) train cell with its inputs on ``device`` (CUDA
    unless given): :func:`gnn_cell_config`'s model from ``cfg.init(seed,
    device)``, a zero :data:`TRAIN_OPT` state and ``batch``
    (:func:`gnn_batch`'s unless given).  The step runs the plain
    ``loss_fn``, as the reference's one-device cell.  On a
    :class:`~repro_torch.core.distributed.ProcessMesh` (on its device unless
    ``device`` is given) the step is the data-parallel one with ZeRO-1's
    moments, and ``gnn_full`` runs the reference's sharded loss
    (:func:`~repro_torch.models.egnn.make_sharded_loss`) on the rank's rows
    of the graph (the cell's batch); the other kinds run ``loss_fn`` on the
    whole graph on every rank (the reference lets XLA split its edges; the
    port's one split loss is the full-graph one).  On ``meta`` the cell is
    shapes-only, sharded on ``mesh``, and its sums run through
    ``static_plan`` (the ordered plan reads counts on the host)."""
    if shape.kind not in ("gnn_full", "gnn_minibatch", "gnn_molecule"):
        raise ValueError(shape.kind)
    dev = _cell_device(device, mesh)
    cfg = gnn_cell_config(spec, shape)
    note = ""
    sharded = isinstance(mesh, ProcessMesh) and shape.kind == "gnn_full" and not _is_meta(dev)
    if _is_meta(dev):
        params = param_shapes(cfg.param_defs(), mesh)
        opt = _opt_shapes(params, mesh)
        batch = gnn_input_specs(cfg, shape, mesh)
        step = make_train_step(
            lambda prm, b: egnn_lib.loss_fn(cfg, prm, b, plan=egnn_lib.static_plan), TRAIN_OPT)
        note = "segment sums as index_add (static_plan)"
    else:
        params = cfg.init(seed, dev)
        if batch is None:
            batch = gnn_batch(cfg, shape, dev, seed)

        def loss(prm, b):
            return egnn_lib.loss_fn(cfg, prm, b)

        if sharded:
            loss, note = egnn_lib.make_sharded_loss(cfg, mesh), "sharded loss on the rank's rows"
        elif isinstance(mesh, ProcessMesh):
            loss = global_loss(loss)
        step, opt = _train_step(loss, params, cfg.param_defs(), mesh)
    N, E = batch["feats"].shape[0], batch["senders"].shape[0]
    if sharded:
        axes = egnn_lib.sharded_axes(mesh)
        batch = egnn_lib.graph_rows(batch, col.group_size(mesh, axes),
                                    mesh.group(axes, mesh.rank).index(mesh.rank))
    return Cell(
        spec.name, shape.name, step, (params, opt, batch),
        donate=(0, 1), model_flops=_egnn_flops(cfg, E, N), note=note,
    )


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def recsys_batch(cfg, B: int, device, seed: int, step: int = 0) -> dict:
    """The batch of ``step`` at ``B`` rows, from the port's generators."""
    name = type(cfg).__name__
    if name in ("DCNv2Config", "AutoIntConfig"):
        vocabs = cfg.vocab_sizes or (100_000,) * cfg.n_sparse
        n_dense = cfg.n_dense if name == "DCNv2Config" else 0
        return rec_data.ctr_batch(B, n_dense, vocabs, seed=seed, step=step, device=device)
    if name == "BSTConfig":
        return rec_data.bst_batch(B, cfg.n_items, cfg.seq_len, cfg.n_other_fields,
                                  cfg.field_vocab, seed=seed, step=step, device=device)
    if name == "TwoTowerConfig":
        return rec_data.two_tower_batch(
            B, cfg.n_users, cfg.n_items, cfg.n_user_fields, cfg.n_item_fields,
            cfg.field_vocab, cfg.hist_len, seed=seed, step=step, device=device)
    raise ValueError(name)


def recsys_input_specs(cfg, B: int, mesh=None) -> dict:
    """:func:`recsys_batch`'s shapes and dtypes as meta tensors, each row
    dimension over ``"batch"`` on ``mesh``."""
    name = type(cfg).__name__
    if name in ("DCNv2Config", "AutoIntConfig"):
        n_dense = cfg.n_dense if name == "DCNv2Config" else 0
        batch = rec_data.ctr_input_specs(B, n_dense, cfg.n_sparse)
    elif name == "BSTConfig":
        batch = rec_data.bst_input_specs(B, cfg.seq_len, cfg.n_other_fields)
    elif name == "TwoTowerConfig":
        batch = rec_data.two_tower_input_specs(B, cfg.n_user_fields, cfg.n_item_fields,
                                               cfg.hist_len)
    else:
        raise ValueError(name)
    return _shard_inputs(batch, mesh, {k: ("batch",) + (None,) * (t.dim() - 1)
                                       for k, t in batch.items()})


def recsys_loss(cfg):
    """The arch's loss(params, batch) -> (loss, metrics)."""
    name = type(cfg).__name__
    if name == "DCNv2Config":
        return partial(rec_lib.dcn_v2_loss, cfg)
    if name == "AutoIntConfig":
        return partial(rec_lib.autoint_loss, cfg)
    if name == "BSTConfig":
        return partial(rec_lib.bst_loss, cfg)
    if name == "TwoTowerConfig":
        return partial(rec_lib.two_tower_loss, cfg)
    raise ValueError(name)


def recsys_forward(cfg):
    """The CTR models' forward(params, batch); None for two-tower, whose
    serve step is its user tower."""
    name = type(cfg).__name__
    if name == "DCNv2Config":
        return partial(rec_lib.dcn_v2_forward, cfg)
    if name == "AutoIntConfig":
        return partial(rec_lib.autoint_forward, cfg)
    if name == "BSTConfig":
        return partial(rec_lib.bst_forward, cfg)
    if name == "TwoTowerConfig":
        return None
    raise ValueError(name)


def _recsys_flops(cfg, B: int, train: bool) -> float:
    """Dense-compute FLOPs (embedding lookups are bandwidth, not FLOPs)."""
    name = type(cfg).__name__
    if name == "DCNv2Config":
        d = cfg.d_input
        per = cfg.n_cross_layers * 2 * d * d
        dims = [d, *cfg.mlp_dims]
        per += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        per += 2 * (d + cfg.mlp_dims[-1])
    elif name == "AutoIntConfig":
        F, D = cfg.n_sparse, cfg.embed_dim
        per, d_in = 0, D
        for _ in range(cfg.n_attn_layers):
            d_out = cfg.n_heads * cfg.d_attn
            per += F * (3 * 2 * d_in * d_out + 2 * d_in * d_out)
            per += 2 * F * F * d_out * 2
            d_in = d_out
        per += 2 * F * d_in
    elif name == "BSTConfig":
        D, S = cfg.embed_dim, cfg.seq_len + 1
        per = cfg.n_blocks * (
            4 * 2 * S * D * D + 2 * 2 * S * S * D + 2 * 2 * S * D * 4 * D
        )
        d_in = S * D + cfg.n_other_fields * D
        dims = [d_in, *cfg.mlp_dims, 1]
        per += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    elif name == "TwoTowerConfig":
        D = cfg.feat_dim
        u_in = D * (1 + cfg.n_user_fields + 1)
        i_in = D * (1 + cfg.n_item_fields)
        u_per = _tower_flops([u_in, *cfg.tower_dims, cfg.embed_dim])
        i_per = _tower_flops([i_in, *cfg.tower_dims, cfg.embed_dim])
        if train:  # both towers + in-batch [B,B] logits
            return 3.0 * ((u_per + i_per) * B + 2 * cfg.embed_dim * B * B)
        return u_per * B  # serve = user-embedding computation
    else:
        raise ValueError(name)
    return (3.0 if train else 1.0) * per * B


# the transient bytes one chunk of a CTR retrieval may take (the one-call
# forward's count, by ``count_step``); the rest of an 80 GB card holds the
# parameters, the candidates, the [N] scores and their sort.  A constant,
# not the free memory, so the chunking is the same from run to run
RETRIEVAL_TRANSIENT_BYTES = 24 * 2**30
RETRIEVAL_PROBE_ROWS = (1024, 4096)


@cache
def retrieval_row_bytes(cfg) -> int:
    """The transient bytes a candidate row of the CTR forward takes:
    :func:`~repro_torch.launch.roofline.count_step` of the one-call
    forward on ``meta`` at :data:`RETRIEVAL_PROBE_ROWS`, which must give
    the same figure per row."""
    fwd = recsys_forward(cfg)
    params = param_shapes(cfg.param_defs())
    per = set()
    for n in RETRIEVAL_PROBE_ROWS:
        batch = recsys_input_specs(cfg, n)
        batch.pop("label", None)
        t = count_step(fwd, (params, batch)).transient
        per.add(t / n)
    if len(per) != 1 or not float(next(iter(per))).is_integer():
        raise RuntimeError(f"{cfg.name}: transient bytes per row differ across "
                           f"{RETRIEVAL_PROBE_ROWS} rows: {sorted(per)}")
    return int(per.pop())


def retrieval_chunk_rows(cfg, rows: int) -> int:
    """Rows a chunk of the CTR retrieval over ``rows`` candidate rows: the
    largest power of two whose transient bytes
    (:func:`retrieval_row_bytes`) fit :data:`RETRIEVAL_TRANSIENT_BYTES`,
    capped at ``rows`` (one call when it fits)."""
    fit = max(RETRIEVAL_TRANSIENT_BYTES // retrieval_row_bytes(cfg), 1)
    return min(1 << (fit.bit_length() - 1), rows)


def _rows_per_device(batch: dict) -> int:
    """The rows of ``batch`` one device holds: a meta tensor's shard of
    its rows on its mesh, else all of them."""
    t = next(iter(batch.values()))
    sh = getattr(t, "sharding", None)
    return sh.shard_shape(tuple(t.shape))[0] if sh is not None else t.shape[0]


def _tower_flops(dims: list[int]) -> float:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _two_tower_retrieval_flops(cfg, B: int, Nc: int) -> float:
    D = cfg.feat_dim
    u_in = D * (1 + cfg.n_user_fields + 1)
    i_in = D * (1 + cfg.n_item_fields)
    return (
        _tower_flops([u_in, *cfg.tower_dims, cfg.embed_dim]) * B
        + _tower_flops([i_in, *cfg.tower_dims, cfg.embed_dim]) * Nc
        + 2.0 * cfg.embed_dim * B * Nc  # scoring dot
    )


def build_recsys_cell(
    spec: ArchSpec, shape: ShapeSpec, device=None, seed: int = 0, geo: dict | None = None,
    mesh=None, chunk_rows: int | None | str = "auto",
) -> Cell:
    """The (arch, shape) cell with its inputs on ``device`` (CUDA unless
    given).  ``geo`` (two-tower ``recsys_retrieval`` only) is the
    reference's geo dict: ``cand_rects [Nc,R,4]``, ``cand_amps [Nc,R]``,
    ``q_rects [Q,4]``, ``q_amps [Q]``, ``weight``.  The CTR models'
    ``recsys_retrieval`` scores its candidates in chunks of ``chunk_rows``
    rows a device (:func:`~repro_torch.models.recsys.forward_in_row_chunks`;
    None: one call; ``"auto"``: :func:`retrieval_chunk_rows` of the rows a
    device holds), then takes one top-100 of all.  ``recsys_train``
    steps with :data:`TRAIN_OPT`.  On ``meta`` the cell is shapes-only,
    sharded on ``mesh``; on a
    :class:`~repro_torch.core.distributed.ProcessMesh` (on its device unless
    ``device`` is given) the train step is data-parallel with ZeRO-1's
    moments."""
    cfg = spec.config
    p = shape.params
    if geo is not None and not (shape.kind == "recsys_retrieval"
                                and type(cfg).__name__ == "TwoTowerConfig"):
        raise ValueError("geo applies to the two-tower retrieval cell only")
    dev = _cell_device(device, mesh)
    meta = _is_meta(dev)
    fwd = recsys_forward(cfg)
    params = param_shapes(cfg.param_defs(), mesh) if meta else cfg.init(seed, dev)

    def batch_of(B: int) -> dict:
        return recsys_input_specs(cfg, B, mesh) if meta else recsys_batch(cfg, B, dev, seed)

    if shape.kind == "recsys_train":
        B = p["batch"]
        if meta:
            step, opt = make_train_step(recsys_loss(cfg), TRAIN_OPT), _opt_shapes(params, mesh)
        else:
            step, opt = _train_step(recsys_loss(cfg), params, cfg.param_defs(), mesh)
        return Cell(
            spec.name, shape.name, step, (params, opt, batch_of(B)),
            donate=(0, 1), model_flops=_recsys_flops(cfg, B, True),
        )

    if shape.kind == "recsys_serve":
        B = p["batch"]
        if fwd is None:  # two-tower: serve = user-embedding computation
            def fn(prm, batch):
                return rec_lib.two_tower_user(cfg, prm, batch)
        else:
            fn = fwd
        batch = batch_of(B)
        batch.pop("label", None)
        return Cell(
            spec.name, shape.name, fn, (params, batch),
            model_flops=_recsys_flops(cfg, B, False),
        )

    if shape.kind == "recsys_retrieval":
        Nc = p["n_candidates"]
        B = p["batch"]
        if type(cfg).__name__ == "TwoTowerConfig":
            def fn(prm, batch, cand_ids, cand_fields):
                return rec_lib.two_tower_score_candidates(
                    cfg, prm, batch, cand_ids, cand_fields, top_k=100, geo=geo
                )

            batch = batch_of(B)
            batch.pop("label", None)
            if meta:
                cand_ids = meta_tensor((Nc,), torch.int32, mesh, ("candidates",))
                cand_fields = meta_tensor((Nc, cfg.n_item_fields), torch.int32, mesh,
                                          ("candidates", None))
            else:
                cand_ids = (torch.arange(Nc, device=dev) % cfg.n_items).to(torch.int32)
                g = rec_data.make_generator(seed, 1, dev)
                cand_fields = torch.randint(0, cfg.field_vocab, (Nc, cfg.n_item_fields),
                                            generator=g, device=dev, dtype=torch.int32)
            return Cell(
                spec.name, shape.name, fn, (params, batch, cand_ids, cand_fields),
                model_flops=_two_tower_retrieval_flops(cfg, B, Nc),
            )
        # CTR models: retrieval scoring = candidate-major forward batch,
        # in row chunks a device; on a mesh a chunk spans that many rows of
        # every device's share
        batch = batch_of(Nc)
        batch.pop("label", None)
        rows = _rows_per_device(batch)
        chunk = retrieval_chunk_rows(cfg, rows) if chunk_rows == "auto" else chunk_rows
        span = None if chunk is None or chunk >= rows else chunk * (Nc // rows)

        def fn(prm, batch):
            return select_top(rec_lib.forward_in_row_chunks(fwd, prm, batch, span), 100)

        how = ("one call" if span is None
               else f"{chunk} rows a chunk, {-(-rows // chunk)} chunks")
        return Cell(
            spec.name, shape.name, fn, (params, batch),
            model_flops=_recsys_flops(cfg, Nc, False),
            note=f"candidate-major scoring (1 user context broadcast into rows); {rows} rows "
                 f"a device, {how}",
        )
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# geoweb cells (the paper's system)
# ---------------------------------------------------------------------------

I32_SAFE_MAX = 2**30  # see _check_i32_addressable below


def _check_i32_addressable(name: str, value: int, n_shards: int) -> int:
    """Guard the engine's int32 index arithmetic at production scale.

    Every posting/toe-print position in the query pipeline is int32 (CSR
    offsets, binary-search bounds, sweep starts).  At the paper's full
    scale (2^26 docs × 128 postings = 2^33 global postings) a shard's
    store only stays addressable because the mesh provides enough doc
    shards; with too few shards the offsets' top entries and the search
    positions would wrap negative.  The bound is 2^30 — not 2^31−1 — so
    intermediate index sums (``start + budget``, the bisection bounds) keep
    headroom too.  Fails at cell construction with the minimum shard count.
    """
    if value > I32_SAFE_MAX:
        need = -(-value * n_shards // I32_SAFE_MAX)
        raise ValueError(
            f"geoweb cell: per-shard {name} = {value:,} exceeds the int32-"
            f"addressable bound 2^30; shard the docs over >= {need} devices "
            f"(mesh provides {n_shards}) or shrink the config"
        )
    return value


def check_geoweb_shards(cfg, n_shards: int) -> None:
    """The int32 guard of a geoweb config over ``n_shards`` doc shards: its
    per-shard toe prints and postings (``build_geoweb_cell`` runs it before
    anything is drawn or allocated)."""
    n = cfg.n_docs // n_shards  # docs per shard
    _check_i32_addressable("toe prints", n * cfg.max_rects, n_shards)
    _check_i32_addressable("postings", n * cfg.avg_postings_per_doc, n_shards)


def geoweb_index_specs(cfg, mesh):
    """The geoweb cell's inputs as meta tensors, sharded on ``mesh``: a
    :class:`~repro_torch.core.distributed.ShardedGeoIndex` of the
    reference's per-shard shapes and dtypes (``cfg.n_docs`` over the doc
    axes, ``max_rects`` toe prints and ``avg_postings_per_doc`` postings per
    doc, the docid layout, the compressed stores of ``cfg.compress``) and a
    :class:`~repro_torch.core.algorithms.QueryBatch` over ``"queries"``.
    The int32 guard runs first."""
    from repro_torch.core.algorithms import QueryBatch
    from repro_torch.core.distributed import COVERAGE_GRID, ShardedGeoIndex, mesh_axes
    from repro_torch.core.spatial_index import SCALE_BLOCK, normalize_compress
    from repro_torch.core.text_index import POSTING_BLOCK

    doc_axes = mesh_axes(mesh)[0]
    S = math.prod(mesh.shape[a] for a in doc_axes)
    check_geoweb_shards(cfg, S)
    N = cfg.n_docs // S  # docs per shard
    Tt, Pp = N * cfg.max_rects, N * cfg.avg_postings_per_doc  # toe prints, postings
    G2, R, M = cfg.grid * cfg.grid, cfg.doc_major_rects, cfg.n_terms
    mode = normalize_compress(cfg.compress)
    ft = torch.float16 if mode != "none" else torch.float32
    at = torch.int8 if mode == "int8" else ft  # amp store dtype
    it = torch.int16 if (mode != "none" and N <= 2**15 - 1) else torch.int32
    # one compressed block per POSTING_BLOCK postings, its delta width bound
    # by the shard's doc-id range; the 128-posting framing (block-max text
    # pruning) exists in both layouts
    NBp = max(-(-Pp // POSTING_BLOCK), 1) if mode != "none" else 0
    NBt = max(-(-Pp // POSTING_BLOCK), 1)
    d_bits = max(int(N - 1).bit_length(), 1) if N > 1 else 1
    Wp = NBp * (POSTING_BLOCK * d_bits // 32)
    Pp_store = 0 if mode != "none" else Pp  # raw doc-id column
    SBn = max(-(-Tt // SCALE_BLOCK), 1) if mode == "int8" else 0
    bs = getattr(cfg, "block_size", 128)  # block-max metadata: one f32 row per block
    NB = max((Tt + bs - 1) // bs, 1)
    CG = COVERAGE_GRID + 1
    i32, f32 = torch.int32, torch.float32

    def sh(shape_, dtype):  # leading shard dim over the doc axes
        return meta_tensor((S, *shape_), dtype, mesh, ("docs",) + (None,) * len(shape_))

    idx = ShardedGeoIndex(
        postings=sh((Pp_store,), i32), impacts=sh((Pp,), ft), offsets=sh((M + 1,), i32),
        post_packed=sh((Wp,), torch.uint32), blk_first=sh((NBp,), i32),
        blk_bits=sh((NBp,), i32), blk_word_off=sh((NBp,), i32), blk_n_exc=sh((NBp,), i32),
        blk_len=sh((NBt,), i32), blk_pos=sh((NBt,), i32), blk_max_impact=sh((NBt,), f32),
        blk_term_off=sh((M + 1,), i32),
        # the docid layout's impact-segment CSR is degenerate
        seg_term_off=sh((M + 1,), i32), seg_pos=sh((1,), i32), seg_len=sh((1,), i32),
        tp_rects=sh((Tt, 4), ft), tp_amps=sh((Tt,), at), tp_doc_ids=sh((Tt,), it),
        tp_amp_scale=sh((SBn,), f32),
        tile_starts=sh((G2, cfg.m_intervals), i32), tile_ends=sh((G2, cfg.m_intervals), i32),
        doc_rects=sh((N, R, 4), ft), doc_amps=sh((N, R), ft), doc_mbr=sh((N, 4), ft),
        doc_mass=sh((N,), ft), blk_mbr=sh((NB, 4), f32), blk_max_amp=sh((NB,), f32),
        blk_max_mass=sh((NB,), f32), pagerank=sh((N,), f32), doc_offset=sh((N,), i32),
        coverage_sat=sh((CG, CG), f32),
        grid=cfg.grid, n_terms=M, block_size=bs, coverage_grid=COVERAGE_GRID,
        # synthetic hot-term bound: a term may touch every shard doc
        max_term_blocks=max(-(-N // POSTING_BLOCK), 1),
    )
    B, d, Qr = cfg.query_batch, cfg.d_terms, cfg.q_rects
    query = QueryBatch(
        terms=meta_tensor((B, d), i32, mesh, ("queries", None)),
        rects=meta_tensor((B, Qr, 4), f32, mesh, ("queries", None, None)),
        amps=meta_tensor((B, Qr), f32, mesh, ("queries", None)),
    )
    return idx, query


def build_geoweb_cell(spec: ArchSpec, shape: ShapeSpec, mesh, seed: int = 0,
                      device=None) -> Cell:
    """The geoweb serve cell on ``mesh`` (:func:`repro_torch.core.make_mesh`
    or, on every rank of a process group,
    :func:`repro_torch.core.make_process_mesh`): ``fn(index, query) -> (ids,
    scores, stats)``, the mesh serve step with the shape's algorithm over a
    stacked index of ``make_corpus(n_docs, n_terms,
    max_rects=doc_major_rects, doc_len=avg_postings_per_doc, seed)``
    hash-partitioned over the mesh's doc axes (under
    ``normalize_compress(cfg.compress)``; on a process mesh stacked on the
    host and cut to the rank's row), and a query batch of ``query_batch`` ×
    ``d_terms`` × ``q_rects`` from ``make_query_trace``.  The int32 guard
    runs first: ``CONFIG`` needs >= 8 doc shards, and its 2^26 docs fit one
    card in no case.  On a ``meta`` mesh (or ``device``) the cell is
    shapes-only: :func:`geoweb_index_specs`."""
    from repro_torch.core.distributed import (
        ProcessMesh,
        make_serve_fn,
        mesh_axes,
        shard_corpus_np,
        shard_rows,
    )
    from repro_torch.core.spatial_index import normalize_compress
    from repro_torch.corpus import make_corpus, make_query_trace

    cfg = spec.config
    if mesh is None:
        raise ValueError("geoweb cells need a mesh")
    doc_axes, query_axis = mesh_axes(mesh)
    S = math.prod(mesh.shape[a] for a in doc_axes)
    # geo-score flops: ~14 flops per (toeprint, query-rect) pair per query
    kb = cfg.budgets
    mf = float(cfg.query_batch) * kb.k_sweeps * kb.sweep_budget * cfg.q_rects * 14
    serve = make_serve_fn(
        mesh, cfg.budgets, cfg.weights,
        doc_axes=doc_axes, query_axis=query_axis, algorithm=shape.params["algorithm"],
    )
    if _is_meta(mesh.device) or (device is not None and _is_meta(resolve_device(device))):
        return Cell(spec.name, shape.name, serve, geoweb_index_specs(cfg, mesh),
                    model_flops=mf, note="shapes only: the serve step syncs to the host")
    check_geoweb_shards(cfg, S)
    procs = isinstance(mesh, ProcessMesh)
    corpus = make_corpus(cfg.n_docs, cfg.n_terms, max_rects=cfg.doc_major_rects,
                         doc_len=cfg.avg_postings_per_doc, seed=seed)
    idx = shard_corpus_np(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
        corpus.n_terms, S, grid=cfg.grid, m_intervals=cfg.m_intervals,
        compress=normalize_compress(cfg.compress), device="cpu" if procs else mesh.device,
    )
    if procs:
        idx = shard_rows(idx, mesh.shard_of(doc_axes), mesh.device)
    query = make_query_trace(corpus, n_queries=cfg.query_batch, d_terms=cfg.d_terms,
                             q_rects=cfg.q_rects, seed=seed + 1).to(mesh.device)
    return Cell(spec.name, shape.name, serve, (idx, query), model_flops=mf)


def build_cell(
    spec: ArchSpec, shape: ShapeSpec, mesh=None, device=None, seed: int = 0,
    lm_overrides: dict | None = None,
) -> Cell:
    """Dispatch on the arch's family: geoweb cells run on ``mesh``, the
    others on ``device`` (CUDA unless given).  With ``device="meta"`` every
    cell is shapes-only, its tensors sharded on ``mesh``."""
    if spec.family == "geoweb":
        return build_geoweb_cell(spec, shape, mesh, seed, device)
    if spec.family == "lm":
        return build_lm_cell(spec, shape, device, seed, mesh=mesh, overrides=lm_overrides)
    if spec.family == "gnn":
        return build_gnn_cell(spec, shape, device, seed, mesh=mesh)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape, device, seed, mesh=mesh)
    raise ValueError(spec.family)
