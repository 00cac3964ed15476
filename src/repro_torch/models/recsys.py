"""RecSys architectures, forwards and differentiable losses (port of
``repro/models/recsys.py``): two-tower retrieval with the geo_score blend,
DCN-v2, AutoInt, BST.

The functions keep the reference's ``(cfg, params, batch)`` signatures:
``params`` is the dict ``cfg.init(seed, device)`` (or
:func:`~repro_torch.models.params.params_from_numpy`) returns, and the
batch dict follows the reference's convention:

    dense    f32[B, n_dense]            (dcn only)
    sparse   i32[B, n_fields]           single-hot categorical ids
    history  i32[B, hist_len]           (bst, two-tower user history)
    target   i32[B]                     target item (bst)
    label    f32[B]                     CTR label / implicit positive

Ids are in range by construction; −1 marks padding where a function says
so (it is clamped to row 0 and masked).  The reference's ``shard``
annotations are no-ops on one device and are left out.  The losses are
differentiable end to end (no host sync, no in-place write on autograd's
path), with the reference's gradients: a clamped padding id masks row 0's
gradient to zero, and ``max`` bags split a tie's gradient evenly
(``amax``, as JAX's ``max``).  The two-tower in-batch softmax runs as
:class:`InBatchSoftmaxNLL`, which keeps one [B, B] buffer.
:func:`forward_in_row_chunks` runs a CTR forward over row slices, so a
candidate batch larger than one card's memory scores on one card.

Across the ranks of a :class:`~repro_torch.core.distributed.ProcessMesh`
(the sharding context's, ``use_sharding(mesh)``) whose ``model`` axis M is
> 1, ``params`` are the rank's ``param_specs`` blocks
(``cfg.init(seed, device, mesh)``), and which leaves are blocks is read
from their shardings (:func:`model_split`), never assumed:

* an embedding table split along its ``rows``: each rank looks up the ids
  of its row block and gives zeros for the others, and one ordered
  :func:`~repro_torch.core.collectives.psum` over ``model`` adds the one
  nonzero term of every split table of the forward, so the rows are
  bitwise one process's (the reference's partial gather + all-reduce,
  ``repro/models/recsys.py:6-8``); padding ids are clamped before the
  block test and masked after the sum, and a ``mean`` bag sums its rows
  over the hot dim after the psum, in one process's order;
* the first layer of an MLP split over ``ffn``: its input and whole bias
  enter through :func:`~repro_torch.core.collectives.replicated`, each
  rank computes its columns and the activation, and one tiled
  :func:`~repro_torch.core.collectives.all_gather_invariant` over
  ``model`` rebuilds the activation for the whole later layers;
* AutoInt's and BST's q/k/v projections split over ``heads``: each rank
  attends with its heads (the input entering through ``replicated``), and
  the outputs are gathered over the heads before the whole ``wres`` /
  ``wo``.  Where M does not divide the head count the reference's
  ``logical_spec`` keeps the leaves whole, and the layer runs whole on
  every rank with no collective.

Every leaf a rank holds whole takes its whole gradient on every rank, as
the LM's layers do.  Over the batch axes, the two-tower loss is the
in-batch softmax over the global batch (:func:`two_tower_loss`), and a
retrieval over candidates split across ranks merges the ranks' top-k in
rank order (:func:`select_top_across`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import collectives as col
from repro_torch.core.distributed import ProcessMesh
from repro_torch.core.ranking import fma32, select_top
from repro_torch.kernels.geo_score.ops import geo_score_docs
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamDef, init_params, param_count, param_shardings
from repro_torch.sharding.specs import DEFAULT_RULES, get_context, splits
from repro_torch.train.loop import batch_axes


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def _pad_vocab(v: int) -> int:
    """Row counts padded to a multiple of 256 so tables shard evenly over
    the model axis (ids never reference padding rows)."""
    return (v + 255) // 256 * 256


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot lookup: table [V, D], ids i32[...] → [..., D]."""
    return F.embedding(ids, table)


def _take(table: torch.Tensor, ids: torch.Tensor, block: tuple[int, int] | None = None):
    """Rows ``ids`` (>= 0, global row numbers) of ``table`` [V, D], or of
    each field's table of a stacked [F, V, D] (ids [..., F]).  With
    ``block`` (start, n), ``table`` holds the global rows start..start+n−1
    of each field: the ids outside them give zero rows."""
    if table.dim() == 3:
        n_fields, vocab, dim = table.shape
        flat = table.reshape(n_fields * vocab, dim)
        offsets = torch.arange(n_fields, device=ids.device, dtype=torch.int64) * vocab
    else:
        vocab, flat, offsets = table.shape[0], table, 0
    if block is None:
        return F.embedding(ids.long() + offsets, flat)
    local = ids.long() - block[0]
    mine = (local >= 0) & (local < vocab)
    rows = F.embedding(local.clamp(0, vocab - 1) + offsets, flat)
    return torch.where(mine[..., None], rows, 0.0)


def _bag(emb: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    """A fixed-width bag's reduce over the hot dim of its masked rows
    ``emb`` [..., H, D] (``mask`` [..., H, 1])."""
    if mode == "sum":
        return emb.sum(dim=-2)
    if mode == "mean":
        return emb.sum(dim=-2) / mask.sum(dim=-2).clamp_min(1.0)
    if mode == "max":
        top = torch.where(mask > 0, emb, -torch.inf).amax(dim=-2)
        return torch.where(torch.isfinite(top), top, 0.0)
    raise ValueError(mode)


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,  # i32[..., H] multi-hot, −1 padded
    mode: str = "sum",
) -> torch.Tensor:
    """Fixed-width EmbeddingBag: masked take + reduce over the hot dim.
    ``mean`` divides by max(count, 1); ``max`` gives 0 for an empty bag."""
    mask = (ids >= 0).to(table.dtype)[..., None]
    return _bag(embedding_lookup(table, ids.clamp_min(0)) * mask, mask, mode)


def embedding_bag_ragged(
    table: torch.Tensor,
    flat_ids: torch.Tensor,  # i32[T] concatenated bags
    segment_ids: torch.Tensor,  # i32[T] bag index per id
    num_bags: int,
    weights: torch.Tensor | None = None,
    mode: str = "sum",
) -> torch.Tensor:
    """CSR-style ragged EmbeddingBag: take + segment sum (any ``mode`` but
    ``sum`` divides by the bag's weight, at least 1)."""
    emb = embedding_lookup(table, flat_ids.clamp_min(0))
    valid = (flat_ids >= 0).to(table.dtype)
    w = valid if weights is None else weights * valid
    emb = emb * w[:, None]
    seg = segment_ids.long()
    tot = torch.zeros((num_bags, table.shape[1]), dtype=emb.dtype, device=emb.device)
    tot.index_add_(0, seg, emb)
    if mode == "sum":
        return tot
    cnt = torch.zeros((num_bags,), dtype=w.dtype, device=w.device).index_add_(0, seg, w)
    return tot / cnt.clamp_min(1.0)[:, None]


@dataclass(frozen=True)
class ModelSplit:
    """The leaves a rank holds as blocks over ``model``: each split leaf's
    (first global row, column or head, count) along the dimension its
    sharding splits (:func:`model_split`).  With ``mesh`` None every leaf
    is whole and the forwards run as one process."""

    mesh: Any = None
    blocks: dict = field(default_factory=dict)


def model_split(cfg, mesh=None) -> ModelSplit:
    """The :class:`ModelSplit` of ``cfg``'s parameters on ``mesh``
    (default: the sharding context's), read from their shardings
    (:func:`~repro_torch.models.params.param_shardings`): on a process mesh
    whose ``model`` axis is > 1, the leaves that ``logical_spec`` splits
    (table ``rows``, ``ffn`` columns, attention ``heads``); else none."""
    mesh = col.model_mesh(mesh)
    if mesh is None:
        return ModelSplit()
    defs = cfg.param_defs()
    blocks = {}
    for name, sh in param_shardings(defs, mesh).items():
        if splits(sh):
            ((_, start, n),) = sh.block(defs[name].shape)
            blocks[name] = (start, n)
    return ModelSplit(mesh, blocks)


def _lookups(p: dict, split: ModelSplit, requests) -> list[torch.Tensor]:
    """One process's rows for each (table name, ids >= 0) of ``requests``
    (:func:`_take`).  The rank's block of a split table gives its ids'
    rows and zeros elsewhere; one ``psum`` over ``model`` of all of them
    (flattened into one tensor) adds each id's one nonzero term, exactly."""
    rows = [_take(p[name], ids, split.blocks.get(name)) for name, ids in requests]
    part = [i for i, (name, _) in enumerate(requests) if name in split.blocks]
    if part:
        flat = torch.cat([rows[i].reshape(-1) for i in part])
        total = col.psum(split.mesh, [flat], col.MODEL)[0]
        for i, t in zip(part, total.split([rows[i].numel() for i in part])):
            rows[i] = t.view(rows[i].shape)
    return rows


def _mlp_defs(name: str, dims: list[int], pd) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{name}_w{i}"] = ParamDef((a, b), (None, "ffn") if i == 0 else (None, None), pd)
        out[f"{name}_b{i}"] = ParamDef((b,), (None,), pd, "zeros")
    return out


def _mlp_apply(p: dict, name: str, x: torch.Tensor, n: int, act=F.relu, last_act=True,
               split: ModelSplit = ModelSplit()):
    """The MLP ``name``.  A first layer split over ``ffn`` (``split``)
    computes the rank's columns, its input and whole bias entering through
    ``replicated``, and gathers the activation over ``model``."""
    for i in range(n):
        w, b = p[f"{name}_w{i}"], p[f"{name}_b{i}"]
        block = split.blocks.get(f"{name}_w{i}")
        if block is not None:
            x, b = col.replicated(split.mesh, (x, b), col.MODEL)[0]
            b = b[block[0]:block[0] + block[1]]
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1 or last_act:
            x = act(x)
        if block is not None:
            x = col.all_gather_invariant(split.mesh, [x], col.MODEL, dim=-1)[0]
    return x


def _bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return torch.mean(
        logit.clamp_min(0) - logit * label + torch.log1p(torch.exp(-logit.abs()))
    )


def _sqrt_f32(d: int) -> float:
    """``sqrt(float32(d))`` as the reference computes it, in f32."""
    return float(np.sqrt(np.float32(d)))


# ---------------------------------------------------------------------------
# Two-tower retrieval (Yi et al., RecSys'19)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two_tower"
    embed_dim: int = 256
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    n_users: int = 1_000_000
    n_items: int = 1_000_000
    n_user_fields: int = 4  # user categorical context fields
    n_item_fields: int = 3
    field_vocab: int = 100_000
    hist_len: int = 20
    feat_dim: int = 64  # per-feature embedding dim
    temperature: float = 0.05
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_defs(self) -> dict:
        pd = self.param_dtype
        D = self.feat_dim
        user_in = D * (1 + self.n_user_fields + 1)  # id + fields + history pool
        item_in = D * (1 + self.n_item_fields)
        defs = {
            "user_id": ParamDef((_pad_vocab(self.n_users), D), ("rows", None), pd, "embed"),
            "item_id": ParamDef((_pad_vocab(self.n_items), D), ("rows", None), pd, "embed"),
            "user_fields": ParamDef(
                (self.n_user_fields, _pad_vocab(self.field_vocab), D), (None, "rows", None), pd, "embed"
            ),
            "item_fields": ParamDef(
                (self.n_item_fields, _pad_vocab(self.field_vocab), D), (None, "rows", None), pd, "embed"
            ),
        }
        udims = [user_in, *self.tower_dims, self.embed_dim]
        idims = [item_in, *self.tower_dims, self.embed_dim]
        defs.update(_mlp_defs("user", udims, pd))
        defs.update(_mlp_defs("item", idims, pd))
        return defs

    @property
    def n_tower_layers(self) -> int:
        return len(self.tower_dims) + 1

    def init(self, seed: int = 0, device=None, mesh=None) -> dict:
        """Parameters from ``seed`` on ``device``; on a process mesh the
        rank's blocks (:func:`~repro_torch.models.params.init_params`)."""
        return init_params(self.param_defs(), seed, device, mesh)

    def n_params(self) -> int:
        return param_count(self.param_defs())


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


def two_tower_user(cfg: TwoTowerConfig, p: dict, batch: dict) -> torch.Tensor:
    split = model_split(cfg)
    hist_ids = batch["history"]
    mask = (hist_ids >= 0).to(p["item_id"].dtype)[..., None]
    uid, uf, hist = _lookups(p, split, [("user_id", batch["user_id"]),
                                        ("user_fields", batch["user_fields"]),
                                        ("item_id", hist_ids.clamp_min(0))])  # [B, (F, H,) D]
    hist = _bag(hist * mask, mask, "mean")  # [B, D]
    x = torch.cat([uid, uf.reshape(uid.shape[0], -1), hist], dim=-1)
    return _unit(_mlp_apply(p, "user", x, cfg.n_tower_layers, last_act=False, split=split))


def two_tower_item(cfg: TwoTowerConfig, p: dict, item_id, item_fields) -> torch.Tensor:
    split = model_split(cfg)
    iid, itf = _lookups(p, split, [("item_id", item_id), ("item_fields", item_fields)])
    x = torch.cat([iid, itf.reshape(iid.shape[0], -1)], dim=-1)
    return _unit(_mlp_apply(p, "item", x, cfg.n_tower_layers, last_act=False, split=split))


def in_batch_softmax_nll_plain(u: torch.Tensor, v: torch.Tensor, logq: torch.Tensor,
                               temperature: float) -> torch.Tensor:
    """The in-batch sampled softmax NLL op for op as the reference writes
    it; :class:`InBatchSoftmaxNLL` is held to it.  Its autograd keeps
    several [B, B] tensors."""
    logits = (u @ v.T) / temperature  # [B, B]
    logits = logits - logq[None, :]  # logQ correction
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - torch.diagonal(logits))


class InBatchSoftmaxNLL(torch.autograd.Function):
    """``mean_i(logsumexp_j L_ij − L_i,row0+i)`` with ``L = u·vᵀ/τ −
    logq``, in one saved [rows, B] buffer, with the arithmetic of the
    plain version's autograd.  ``u`` [rows, E] are the rows ``row0 ..
    row0 + rows − 1`` of the batch whose targets ``v`` [B, E] and ``logq``
    [B] are given whole (``row0`` 0 and rows = B: the whole batch's loss);
    the mean is over the ``rows``.  The forward writes the logits into the
    buffer and takes ``logsumexp`` over blocks of rows (its temporary is
    one block, not [B, B]); the backward turns the buffer in place into
    ``dL = exp(L − lse)·g/rows − I·g/rows`` (I at the rows' own columns),
    takes ``dlogq = −Σ_i dL_ij``, then ``dS = dL/τ`` and the two GEMMs, so
    a forward takes one backward (a second one raises, autograd seeing the
    buffer modified).  At batch 65,536 the buffer is 16 GiB; the plain
    version's autograd keeps and makes several."""

    BLOCK_ELEMENTS = 1 << 28  # logsumexp's temporary: 1 GiB of f32

    @staticmethod
    def forward(ctx, u, v, logq, temperature: float, row0: int = 0):
        buf = torch.matmul(u, v.T)
        buf.div_(temperature).sub_(logq[None, :])  # the logits
        rows = max(1, InBatchSoftmaxNLL.BLOCK_ELEMENTS // buf.shape[1])
        lse = torch.cat([torch.logsumexp(blk, dim=-1) for blk in buf.split(rows)])
        ctx.save_for_backward(u, v, buf, lse)
        ctx.temperature, ctx.row0 = temperature, row0
        return torch.mean(lse - buf.diagonal(row0))

    @staticmethod
    def backward(ctx, g):
        u, v, buf, lse = ctx.saved_tensors
        g_row = g / buf.shape[0]
        buf.sub_(lse[:, None]).exp_().mul_(g_row)  # softmax · g/rows
        buf.diagonal(ctx.row0).sub_(g_row)  # dL
        dlogq = -buf.sum(dim=0) if ctx.needs_input_grad[2] else None
        buf.div_(ctx.temperature)  # dS
        du = buf @ v if ctx.needs_input_grad[0] else None
        dv = buf.T @ u if ctx.needs_input_grad[1] else None
        return du, dv, dlogq, None, None


def two_tower_loss(cfg: TwoTowerConfig, params: dict, batch: dict):
    """In-batch sampled softmax with logQ correction (batch["logq"] [B]):
    each row's negatives are the whole batch's targets.

    Inside the data-parallel train step on a process mesh whose batch axes
    split the batch into D shards (``make_train_step``: ``batch`` is then
    the rank's B/D rows), the targets ``v`` and ``logq`` are all-gathered
    over those axes in rank order (:func:`~repro_torch.core.collectives.all_gather`,
    whose backward is the ordered ``psum_scatter``), each rank takes its
    rows' logits against all B columns in a [B/D, B] buffer, their own
    columns at its global row offset, and returns the mean over its rows.
    The step's ``psum`` of the ranks' losses over D is then the global
    batch's mean, as the reference's loss on its mesh; the gradient is
    that mean's: each rank's loss has the gradient of its rows' mean, the
    gather's backward and ``replicated``'s add the ranks' terms, and the
    step's division by D makes the sum of D row means the global mean.
    With ``microbatches`` > 1 the step gives each rank its rows of one
    microbatch of the global batch at a time (the reference's order), so
    the gathered columns are that microbatch's, as the reference's
    negatives are."""
    u = two_tower_user(cfg, params, batch)  # [B, E]
    v = two_tower_item(cfg, params, batch["target"], batch["item_fields"])  # [B, E]
    logq, row0 = batch["logq"], 0
    mesh = get_context().mesh
    axes = batch_axes(mesh) if isinstance(mesh, ProcessMesh) else ()
    if axes and col.group_size(mesh, axes) > 1:
        row0 = mesh.group(axes, mesh.rank).index(mesh.rank) * u.shape[0]
        v = col.all_gather(mesh, [v], axes, dim=0)[0]
        logq = col.all_gather(mesh, [logq], axes, dim=0)[0]
    nll = InBatchSoftmaxNLL.apply(u, v, logq, cfg.temperature, row0)
    return nll, {"nll": nll}


def geo_blend(scores: torch.Tensor, g: torch.Tensor, weight: float) -> torch.Tensor:
    """``scores + weight·g``, rounded once as XLA contracts it (a fused
    multiply-add), and −inf where a candidate's footprint misses the query
    (g == 0).  scores [B, Nc], g [Nc]."""
    blended = fma32(weight, g[None, :], scores)
    return torch.where(g[None, :] > 0, blended, -torch.inf)


def two_tower_score_candidates(
    cfg: TwoTowerConfig,
    params: dict,
    batch: dict,  # one/few users
    cand_ids: torch.Tensor,  # i32[Nc]
    cand_fields: torch.Tensor,  # i32[Nc, n_item_fields]
    top_k: int = 100,
    geo: dict | None = None,  # optional geo-constrained retrieval (paper tie-in)
):
    """Score candidates for retrieval; optionally blend a geographic score
    computed with the geo_score kernel (one launch per call on the card).

    geo = {cand_rects [Nc,R,4], cand_amps [Nc,R], q_rects [Q,4], q_amps [Q],
           weight float}

    Returns (values, positions) [B, top_k], as ``jax.lax.top_k``: among
    equal scores the lower candidate position wins, which orders the −inf
    picks of a row with fewer than ``top_k`` geo matches.  On a process
    mesh whose candidate axes split the candidates
    (:func:`candidate_axes`), the candidates and ``geo``'s ``cand_*`` are
    the rank's contiguous block, and the result is the whole set's,
    positions global (:func:`select_top_across`).
    """
    u = two_tower_user(cfg, params, batch)  # [B, E]
    v = two_tower_item(cfg, params, cand_ids, cand_fields)  # [Nc, E]
    scores = u @ v.T  # [B, Nc]
    if geo is not None:
        g = geo_score_docs(
            geo["cand_rects"][None], geo["cand_amps"][None],
            geo["q_rects"][None], geo["q_amps"][None],
        )[0]  # [Nc]
        scores = geo_blend(scores, g, geo["weight"])
    return select_top_across(scores, top_k)


def candidate_axes(mesh=None) -> tuple[str, ...]:
    """The axes of ``mesh`` (default: the sharding context's) that split a
    retrieval's candidates: on a :class:`ProcessMesh`, the rules'
    ``"candidates"`` axes (pod, data) it has with more than one rank;
    else none."""
    mesh = get_context().mesh if mesh is None else mesh
    if not isinstance(mesh, ProcessMesh):
        return ()
    return tuple(a for a in DEFAULT_RULES["candidates"] if mesh.shape.get(a, 1) > 1)


def select_top_across(scores: torch.Tensor, k: int):
    """``select_top(scores, k)`` of the whole candidate set.  Off a mesh
    (the sharding context's) that splits the candidates
    (:func:`candidate_axes`) that is the call itself.  On one, ``scores``
    [B, n] are this rank's contiguous block of
    the candidates: its top-k, their positions made global, are gathered
    over the candidate axes in rank order and merged by ``select_top``, so
    among equal values (the −inf picks of the geo blend too) the lower
    global position wins, as in ``jax.lax.top_k`` of the whole vector.
    Every rank returns the same (values, positions)."""
    mesh = get_context().mesh
    axes = candidate_axes(mesh)
    if not axes:
        return select_top(scores, k)
    vals, pos = select_top(scores, k)
    pos = pos + mesh.group(axes, mesh.rank).index(mesh.rank) * scores.shape[-1]
    vals, pos = (col.all_gather(mesh, [t], axes, dim=-1)[0] for t in (vals, pos))
    top, at = select_top(vals, k)
    return top, torch.gather(pos, -1, at)


# ---------------------------------------------------------------------------
# DCN-v2 (arXiv:2008.13535)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn_v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    vocab_sizes: tuple[int, ...] = ()  # len == n_sparse
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def param_defs(self) -> dict:
        pd = self.param_dtype
        vs = self.vocab_sizes or tuple([100_000] * self.n_sparse)
        defs = {
            f"table_{i}": ParamDef((_pad_vocab(v), self.embed_dim), ("rows", None), pd, "embed")
            for i, v in enumerate(vs)
        }
        d = self.d_input
        for l in range(self.n_cross_layers):
            defs[f"cross_w{l}"] = ParamDef((d, d), (None, None), pd)
            defs[f"cross_b{l}"] = ParamDef((d,), (None,), pd, "zeros")
        defs.update(_mlp_defs("deep", [d, *self.mlp_dims], pd))
        defs["logit_w"] = ParamDef((d + self.mlp_dims[-1], 1), (None, None), pd)
        defs["logit_b"] = ParamDef((1,), (None,), pd, "zeros")
        return defs

    def init(self, seed: int = 0, device=None, mesh=None) -> dict:
        """Parameters from ``seed`` on ``device``; on a process mesh the
        rank's blocks (:func:`~repro_torch.models.params.init_params`)."""
        return init_params(self.param_defs(), seed, device, mesh)

    def n_params(self) -> int:
        return param_count(self.param_defs())


def dcn_v2_forward(cfg: DCNv2Config, p: dict, batch: dict) -> torch.Tensor:
    split = model_split(cfg)
    embs = _lookups(p, split, [(f"table_{i}", batch["sparse"][:, i])
                               for i in range(cfg.n_sparse)])
    x0 = torch.cat([batch["dense"].to(cfg.compute_dtype), *embs], dim=-1)
    # cross network: x_{l+1} = x0 ⊙ (W x_l + b) + x_l
    x = x0
    for l in range(cfg.n_cross_layers):
        x = x0 * (x @ p[f"cross_w{l}"].to(x.dtype) + p[f"cross_b{l}"].to(x.dtype)) + x
    deep = _mlp_apply(p, "deep", x0, len(cfg.mlp_dims), split=split)
    out = torch.cat([x, deep], dim=-1)
    logit = out @ p["logit_w"].to(x.dtype) + p["logit_b"].to(x.dtype)
    return logit[:, 0]


def dcn_v2_loss(cfg: DCNv2Config, params: dict, batch: dict):
    loss = _bce(dcn_v2_forward(cfg, params, batch), batch["label"])
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# AutoInt (arXiv:1810.11921)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocab_sizes: tuple[int, ...] = ()
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_defs(self) -> dict:
        pd = self.param_dtype
        vs = self.vocab_sizes or tuple([100_000] * self.n_sparse)
        defs = {
            f"table_{i}": ParamDef((_pad_vocab(v), self.embed_dim), ("rows", None), pd, "embed")
            for i, v in enumerate(vs)
        }
        d_in = self.embed_dim
        for l in range(self.n_attn_layers):
            defs[f"attn{l}_wq"] = ParamDef((d_in, self.n_heads, self.d_attn), (None, "heads", None), pd)
            defs[f"attn{l}_wk"] = ParamDef((d_in, self.n_heads, self.d_attn), (None, "heads", None), pd)
            defs[f"attn{l}_wv"] = ParamDef((d_in, self.n_heads, self.d_attn), (None, "heads", None), pd)
            defs[f"attn{l}_wres"] = ParamDef((d_in, self.n_heads * self.d_attn), (None, None), pd)
            d_in = self.n_heads * self.d_attn
        defs["logit_w"] = ParamDef((self.n_sparse * d_in, 1), (None, None), pd)
        defs["logit_b"] = ParamDef((1,), (None,), pd, "zeros")
        return defs

    def init(self, seed: int = 0, device=None, mesh=None) -> dict:
        """Parameters from ``seed`` on ``device``; on a process mesh the
        rank's blocks (:func:`~repro_torch.models.params.init_params`)."""
        return init_params(self.param_defs(), seed, device, mesh)

    def n_params(self) -> int:
        return param_count(self.param_defs())


def autoint_forward(cfg: AutoIntConfig, p: dict, batch: dict) -> torch.Tensor:
    B = batch["sparse"].shape[0]
    split = model_split(cfg)
    x = torch.stack(_lookups(p, split, [(f"table_{i}", batch["sparse"][:, i])
                                        for i in range(cfg.n_sparse)]),
                    dim=1).to(cfg.compute_dtype)  # [B, F, D]
    scale = _sqrt_f32(cfg.d_attn)
    for l in range(cfg.n_attn_layers):
        heads = f"attn{l}_wq" in split.blocks  # the rank's heads; the input enters replicated
        y = col.replicated(split.mesh, x, col.MODEL)[0] if heads else x
        q = torch.einsum("bfd,dha->bfha", y, p[f"attn{l}_wq"].to(x.dtype))
        k = torch.einsum("bfd,dha->bfha", y, p[f"attn{l}_wk"].to(x.dtype))
        v = torch.einsum("bfd,dha->bfha", y, p[f"attn{l}_wv"].to(x.dtype))
        s = torch.einsum("bfha,bgha->bhfg", q, k) / scale
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bgha->bfha", a, v)
        if heads:  # every head, for the whole wres
            o = col.all_gather_invariant(split.mesh, [o], col.MODEL, dim=2)[0]
        o = o.reshape(B, cfg.n_sparse, cfg.n_heads * cfg.d_attn)
        x = F.relu(o + torch.einsum("bfd,de->bfe", x, p[f"attn{l}_wres"].to(x.dtype)))
    flat = x.reshape(B, -1)
    logit = flat @ p["logit_w"].to(x.dtype) + p["logit_b"].to(x.dtype)
    return logit[:, 0]


def autoint_loss(cfg: AutoIntConfig, params: dict, batch: dict):
    loss = _bce(autoint_forward(cfg, params, batch), batch["label"])
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# BST — Behavior Sequence Transformer (arXiv:1905.06874)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    n_items: int = 1_000_000
    n_other_fields: int = 4
    field_vocab: int = 100_000
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def d_head(self) -> int:
        return self.embed_dim // self.n_heads

    def param_defs(self) -> dict:
        pd = self.param_dtype
        D = self.embed_dim
        defs = {
            "item_emb": ParamDef((_pad_vocab(self.n_items), D), ("rows", None), pd, "embed"),
            "pos_emb": ParamDef((self.seq_len + 1, D), (None, None), pd, "embed"),
            "other_fields": ParamDef(
                (self.n_other_fields, _pad_vocab(self.field_vocab), D), (None, "rows", None), pd, "embed"
            ),
        }
        for b in range(self.n_blocks):
            defs[f"blk{b}_wq"] = ParamDef((D, self.n_heads, self.d_head), (None, "heads", None), pd)
            defs[f"blk{b}_wk"] = ParamDef((D, self.n_heads, self.d_head), (None, "heads", None), pd)
            defs[f"blk{b}_wv"] = ParamDef((D, self.n_heads, self.d_head), (None, "heads", None), pd)
            defs[f"blk{b}_wo"] = ParamDef((self.n_heads * self.d_head, D), (None, None), pd)
            defs[f"blk{b}_ln1"] = ParamDef((D,), (None,), pd, "ones")
            defs[f"blk{b}_ln2"] = ParamDef((D,), (None,), pd, "ones")
            defs[f"blk{b}_ff1"] = ParamDef((D, 4 * D), (None, None), pd)
            defs[f"blk{b}_ff1b"] = ParamDef((4 * D,), (None,), pd, "zeros")
            defs[f"blk{b}_ff2"] = ParamDef((4 * D, D), (None, None), pd)
            defs[f"blk{b}_ff2b"] = ParamDef((D,), (None,), pd, "zeros")
        d_in = (self.seq_len + 1) * D + self.n_other_fields * D
        defs.update(_mlp_defs("mlp", [d_in, *self.mlp_dims], pd))
        defs["logit_w"] = ParamDef((self.mlp_dims[-1], 1), (None, None), pd)
        defs["logit_b"] = ParamDef((1,), (None,), pd, "zeros")
        return defs

    def init(self, seed: int = 0, device=None, mesh=None) -> dict:
        """Parameters from ``seed`` on ``device``; on a process mesh the
        rank's blocks (:func:`~repro_torch.models.params.init_params`)."""
        return init_params(self.param_defs(), seed, device, mesh)

    def n_params(self) -> int:
        return param_count(self.param_defs())


def bst_forward(cfg: BSTConfig, p: dict, batch: dict) -> torch.Tensor:
    B = batch["target"].shape[0]
    split = model_split(cfg)
    seq = torch.cat([batch["history"], batch["target"][:, None]], dim=1)  # [B, S+1]
    # padding ids clamped to row 0 before any block test, masked after
    x, other = _lookups(p, split, [("item_emb", seq.clamp_min(0)),
                                   ("other_fields", batch["other"])])  # other: [B, F, D]
    x = x * (seq >= 0).to(x.dtype)[..., None]
    x = x + p["pos_emb"].to(x.dtype)[None, :, :]
    scale = _sqrt_f32(cfg.d_head)
    for b in range(cfg.n_blocks):
        y = rms_norm(x, p[f"blk{b}_ln1"])
        heads = f"blk{b}_wq" in split.blocks  # the rank's heads; y enters replicated
        if heads:
            y = col.replicated(split.mesh, y, col.MODEL)[0]
        q = torch.einsum("bsd,dha->bsha", y, p[f"blk{b}_wq"].to(x.dtype))
        k = torch.einsum("bsd,dha->bsha", y, p[f"blk{b}_wk"].to(x.dtype))
        v = torch.einsum("bsd,dha->bsha", y, p[f"blk{b}_wv"].to(x.dtype))
        s = torch.einsum("bsha,btha->bhst", q, k) / scale
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhst,btha->bsha", a, v)
        if heads:  # every head, for the whole wo
            o = col.all_gather_invariant(split.mesh, [o], col.MODEL, dim=2)[0]
        o = o.reshape(B, cfg.seq_len + 1, -1)
        x = x + torch.einsum("bse,ed->bsd", o, p[f"blk{b}_wo"].to(x.dtype))
        y = rms_norm(x, p[f"blk{b}_ln2"])
        h = F.relu(y @ p[f"blk{b}_ff1"].to(x.dtype) + p[f"blk{b}_ff1b"].to(x.dtype))
        x = x + h @ p[f"blk{b}_ff2"].to(x.dtype) + p[f"blk{b}_ff2b"].to(x.dtype)

    flat = torch.cat([x.reshape(B, -1), other.reshape(B, -1)], dim=-1)
    h = _mlp_apply(p, "mlp", flat, len(cfg.mlp_dims), act=F.leaky_relu, split=split)
    logit = h @ p["logit_w"].to(x.dtype) + p["logit_b"].to(x.dtype)
    return logit[:, 0]


def bst_loss(cfg: BSTConfig, params: dict, batch: dict):
    loss = _bce(bst_forward(cfg, params, batch), batch["label"])
    return loss, {"bce": loss}


# ---------------------------------------------------------------------------
# Row-chunked scoring
# ---------------------------------------------------------------------------

def forward_in_row_chunks(fwd, params: dict, batch: dict, chunk_rows: int | None) -> torch.Tensor:
    """``fwd(params, batch)`` → f32[N] over ``batch``'s N rows, run on
    slices of ``chunk_rows`` rows (views of every batch tensor along dim 0;
    the last slice may be ragged), each slice's scores written into one
    [N] output so no slice's intermediates outlive it.  With
    ``chunk_rows`` None or ``>= N`` it is the one call ``fwd(params,
    batch)``.  The CTR forwards score each row from that row alone, so
    the result is the one call's (the reference scores its candidates in
    one call, sharded over its mesh)."""
    n = next(iter(batch.values())).shape[0]
    if chunk_rows is None or chunk_rows >= n:
        return fwd(params, batch)
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    out = None
    for lo in range(0, n, chunk_rows):
        s = fwd(params, {k: v[lo:lo + chunk_rows] for k, v in batch.items()})
        if out is None:
            out = s.new_empty((n,))
        out[lo:lo + s.shape[0]] = s
    return out
