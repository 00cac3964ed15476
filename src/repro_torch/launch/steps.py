"""Cell builders (port of ``repro/launch/steps.py``): (arch × shape) → a
:class:`Cell` whose ``fn(*args)`` runs the step.

* ``lm_train``          train_step(params, opt_state, batch): the LM loss
                        (MoE aux included), its gradients by autograd and
                        the AdamW update, in place
* ``lm_prefill``        prefill(params, tokens, cache)
* ``lm_decode``         decode_step(params, cache, tokens, pos)
* ``recsys_train``      train_step(params, opt_state, batch): the loss,
                        its gradients and the AdamW update, in place
* ``recsys_serve``      forward(params, batch) (two-tower: the user tower)
* ``recsys_retrieval``  candidate scoring and top-k (two-tower: the towers,
                        the dot product, the optional geo blend)
* ``geo_serve``         the mesh serve step over a stacked index

The reference's cells carry ``ShapeDtypeStruct``s for lowering; the port's
carry real tensors on the device at the shape's sizes: parameters from
``cfg.init(seed, device)``, batches from ``repro_torch.data``, a geoweb
corpus from ``make_corpus``.  The GNN cells (ROADMAP Queue 1 item 4) wait
for their slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core.ranking import select_top
from repro_torch.data import recsys as rec_data
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


# the lm_train and recsys_train cells' optimizer, the reference's
TRAIN_OPT = OptimizerConfig(zero1=True)


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple
    # positions in ``args`` that ``fn`` updates in place (the reference's
    # donated arguments); for the dry-run/mesh tooling of the multi-card
    # slice, which reads the reference's ``donate`` there
    donate: tuple = ()
    # analytic "useful" flops for this step (2 per multiply-add), global
    model_flops: float = 0.0
    note: str = ""


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
) -> Cell:
    """The (arch, shape) LM cell with its inputs on ``device`` (CUDA
    unless given): ``params`` (``cfg.init(seed, device)`` unless given, so
    two cells can share one model) and tokens from ``lm_batch`` of the
    shape's ``global_batch`` × ``seq_len``.  The train cell steps with
    :data:`TRAIN_OPT` from a zero optimizer state on the batch of step 0;
    the serving cells take a zero cache from ``make_cache``, and the decode
    cell writes at ``pos = seq_len − 1``, so its step attends over the
    whole cache.  ``attn_window`` comes from the shape."""
    cfg = spec.config
    p = shape.params
    if "attn_window" in p:
        cfg = dataclasses.replace(cfg, attn_window=p["attn_window"])
    if shape.kind not in ("lm_train", "lm_prefill", "lm_decode"):
        raise ValueError(shape.kind)
    dev = resolve_device(device)
    B, S = p["global_batch"], p["seq_len"]
    if params is None:
        params = cfg.init(seed, dev)

    if shape.kind == "lm_train":
        step = make_train_step(lambda prm, b: tf_lib.loss_fn(cfg, prm, b), TRAIN_OPT)
        batch = lm_batch(LMDataConfig(cfg.vocab, S, B, seed), 0, dev)
        return Cell(
            spec.name, shape.name, step, (params, init_opt_state(TRAIN_OPT, params), batch),
            donate=(0, 1), model_flops=_lm_flops(cfg, B * S, "train"),
        )

    cache = tf_lib.make_cache(cfg, B, S, dev)

    if shape.kind == "lm_prefill":
        def fn(params, tokens, cache):
            return tf_lib.prefill(cfg, params, tokens, cache)

        tokens = lm_batch(LMDataConfig(cfg.vocab, S, B, seed), 0, dev)["tokens"]
        return Cell(
            spec.name, shape.name, fn, (params, tokens, cache), donate=(2,),
            model_flops=_lm_flops(cfg, B * S, "prefill"),
        )

    def fn(params, cache, tokens, pos):
        return tf_lib.decode_step(cfg, params, cache, tokens, pos)

    tokens = lm_batch(LMDataConfig(cfg.vocab, 1, B, seed), 0, dev)["tokens"][:, 0]
    return Cell(
        spec.name, shape.name, fn, (params, cache, tokens, S - 1), donate=(1,),
        model_flops=_lm_flops(cfg, B, "decode", kv_len=S, batch=B),
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


def _recsys_forward(cfg):
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
) -> Cell:
    """The (arch, shape) cell with its inputs on ``device`` (CUDA unless
    given).  ``geo`` (two-tower ``recsys_retrieval`` only) is the
    reference's geo dict: ``cand_rects [Nc,R,4]``, ``cand_amps [Nc,R]``,
    ``q_rects [Q,4]``, ``q_amps [Q]``, ``weight``.  ``recsys_train``
    steps with :data:`TRAIN_OPT`."""
    cfg = spec.config
    p = shape.params
    if geo is not None and not (shape.kind == "recsys_retrieval"
                                and type(cfg).__name__ == "TwoTowerConfig"):
        raise ValueError("geo applies to the two-tower retrieval cell only")
    dev = resolve_device(device)
    fwd = _recsys_forward(cfg)
    params = cfg.init(seed, dev)

    if shape.kind == "recsys_train":
        B = p["batch"]
        step = make_train_step(recsys_loss(cfg), TRAIN_OPT)
        batch = recsys_batch(cfg, B, dev, seed)
        return Cell(
            spec.name, shape.name, step, (params, init_opt_state(TRAIN_OPT, params), batch),
            donate=(0, 1), model_flops=_recsys_flops(cfg, B, True),
        )

    if shape.kind == "recsys_serve":
        B = p["batch"]
        if fwd is None:  # two-tower: serve = user-embedding computation
            def fn(prm, batch):
                return rec_lib.two_tower_user(cfg, prm, batch)
        else:
            fn = fwd
        batch = recsys_batch(cfg, B, dev, seed)
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

            batch = recsys_batch(cfg, B, dev, seed)
            batch.pop("label", None)
            cand_ids = (torch.arange(Nc, device=dev) % cfg.n_items).to(torch.int32)
            g = rec_data.make_generator(seed, 1, dev)
            cand_fields = torch.randint(0, cfg.field_vocab, (Nc, cfg.n_item_fields),
                                        generator=g, device=dev, dtype=torch.int32)
            return Cell(
                spec.name, shape.name, fn, (params, batch, cand_ids, cand_fields),
                model_flops=_two_tower_retrieval_flops(cfg, B, Nc),
            )
        # CTR models: retrieval scoring = candidate-major forward batch
        batch = recsys_batch(cfg, Nc, dev, seed)
        batch.pop("label", None)

        def fn(prm, batch):
            return select_top(fwd(prm, batch), 100)

        return Cell(
            spec.name, shape.name, fn, (params, batch),
            model_flops=_recsys_flops(cfg, Nc, False),
            note="candidate-major scoring (1 user context broadcast into rows)",
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


def build_geoweb_cell(spec: ArchSpec, shape: ShapeSpec, mesh, seed: int = 0) -> Cell:
    """The geoweb serve cell on ``mesh`` (:func:`repro_torch.core.make_mesh`):
    ``fn(index, query) -> (ids, scores, stats)``, the mesh serve step with
    the shape's algorithm over a stacked index of ``make_corpus(n_docs,
    n_terms, max_rects=doc_major_rects, doc_len=avg_postings_per_doc,
    seed)`` hash-partitioned over the mesh's doc axes (under
    ``normalize_compress(cfg.compress)``), and a query batch of
    ``query_batch`` × ``d_terms`` × ``q_rects`` from ``make_query_trace``.
    The int32 guard runs first."""
    from repro_torch.core.distributed import make_serve_fn, shard_corpus_np
    from repro_torch.core.spatial_index import normalize_compress
    from repro_torch.corpus import make_corpus, make_query_trace

    cfg = spec.config
    if mesh is None:
        raise ValueError("geoweb cells need a mesh")
    doc_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    S = math.prod(mesh.shape[a] for a in doc_axes)
    check_geoweb_shards(cfg, S)
    corpus = make_corpus(cfg.n_docs, cfg.n_terms, max_rects=cfg.doc_major_rects,
                         doc_len=cfg.avg_postings_per_doc, seed=seed)
    idx = shard_corpus_np(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.pagerank,
        corpus.n_terms, S, grid=cfg.grid, m_intervals=cfg.m_intervals,
        compress=normalize_compress(cfg.compress), device=mesh.device,
    )
    query = make_query_trace(corpus, n_queries=cfg.query_batch, d_terms=cfg.d_terms,
                             q_rects=cfg.q_rects, seed=seed + 1).to(mesh.device)
    serve = make_serve_fn(
        mesh, cfg.budgets, cfg.weights,
        doc_axes=doc_axes, query_axis="model", algorithm=shape.params["algorithm"],
    )
    # geo-score flops: ~14 flops per (toeprint, query-rect) pair per query
    kb = cfg.budgets
    mf = float(cfg.query_batch) * kb.k_sweeps * kb.sweep_budget * cfg.q_rects * 14
    return Cell(spec.name, shape.name, serve, (idx, query), model_flops=mf)


def build_cell(
    spec: ArchSpec, shape: ShapeSpec, mesh=None, device=None, seed: int = 0,
) -> Cell:
    """Dispatch on the arch's family: geoweb cells run on ``mesh``, the
    others on ``device`` (CUDA unless given)."""
    if spec.family == "geoweb":
        return build_geoweb_cell(spec, shape, mesh, seed)
    if spec.family == "lm":
        return build_lm_cell(spec, shape, device, seed)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape, device, seed)
    raise NotImplementedError(
        f"{spec.name}: the {spec.family} cells are not ported yet (ROADMAP Queue 1 item 4)")
