"""Cell builders (port of the recsys part of ``repro/launch/steps.py``):
(arch × shape) → a :class:`Cell` whose ``fn(*args)`` runs the step.

* ``recsys_train``      train_step(params, opt_state, batch): the loss,
                        its gradients and the AdamW update, in place
* ``recsys_serve``      forward(params, batch) (two-tower: the user tower)
* ``recsys_retrieval``  candidate scoring and top-k (two-tower: the towers,
                        the dot product, the optional geo blend)

The reference's cells carry ``ShapeDtypeStruct``s for lowering; the port's
carry real tensors on the device at the shape's sizes: parameters from
``cfg.init(seed, device)``, batches from ``repro_torch.data.recsys``.  The
LM, GNN and geoweb cells wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core.ranking import select_top
from repro_torch.data import recsys as rec_data
from repro_torch.device import resolve_device
from repro_torch.models import recsys as rec_lib
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


# the recsys_train cell's optimizer, the reference's
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
