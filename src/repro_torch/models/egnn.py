"""E(n)-Equivariant Graph Neural Network (EGNN, arXiv:2102.09844; port of
``repro/models/egnn.py``).

Layer l:
    m_ij      = φ_e(h_i, h_j, ||x_i − x_j||², e_ij)
    x_i^{l+1} = x_i + C · Σ_j (x_i − x_j) · φ_x(m_ij)          (coord update)
    h_i^{l+1} = φ_h(h_i, Σ_j m_ij)                              (feature update)

The reference's ``lax.scan`` over layers is a loop over the stacked
``[L, …]`` leaves.  Parameters are ``param_dtype`` (f32); the messages
run in ``compute_dtype``, each weight cast to it where it is used.

**Sums in a fixed order.**  The reference's ``segment_sum`` over the
receivers, and the scatter-adds that transpose its gathers ``h[senders]``,
``h[receivers]``, ``x[…]``, add each segment's terms in ascending edge
index from a zero, rounding after every add in the compute dtype (XLA's
CPU scatter: in bf16 a hub of more than 256 incoming edges saturates).
``index_add_`` and indexing's backward run on atomics on the card, in an
order that changes from run to run.  So the port sums through a
:class:`SegmentPlan`, built once per batch from a stable sort of the
edges by segment: each segment's terms in ascending edge index, the
segments ranked by size so that the k-th terms of all segments still
running are one contiguous slice, added in one elementwise add per k in
the compute dtype.  Two autograd Functions, each the other's adjoint,
carry it: :func:`segment_sum` (backward: a gather) and :func:`gather`
(backward: an ordered segment sum).  Padded edges (mask 0) carry zero
messages, updates and cotangents, and adding a zero to a sum that
started at +0 changes no bit, so the plans leave them out.  The degree
(``coord_agg="mean"``) is the plan's count of real edges, in f32, cast to
the compute dtype before the divide, as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef, init_params, param_count


@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 16  # input node-feature dim
    coord_dim: int = 3
    n_classes: int = 8  # node classification head (0 → graph regression)
    coord_agg: str = "mean"
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_defs(self) -> dict:
        H, Fin, Lyr = self.d_hidden, self.d_feat, self.n_layers
        pd = self.param_dtype
        # φ_e: (h_i, h_j, dist²) → m ; φ_x: m → scalar ; φ_h: (h_i, Σm) → h
        layer = {
            "edge_w1": ParamDef((Lyr, 2 * H + 1, H), ("layers", None, None), pd),
            "edge_b1": ParamDef((Lyr, H), ("layers", None), pd, "zeros"),
            "edge_w2": ParamDef((Lyr, H, H), ("layers", None, None), pd),
            "edge_b2": ParamDef((Lyr, H), ("layers", None), pd, "zeros"),
            "coord_w1": ParamDef((Lyr, H, H), ("layers", None, None), pd),
            "coord_b1": ParamDef((Lyr, H), ("layers", None), pd, "zeros"),
            "coord_w2": ParamDef((Lyr, H, 1), ("layers", None, None), pd, "normal", 0.001),
            "node_w1": ParamDef((Lyr, 2 * H, H), ("layers", None, None), pd),
            "node_b1": ParamDef((Lyr, H), ("layers", None), pd, "zeros"),
            "node_w2": ParamDef((Lyr, H, H), ("layers", None, None), pd),
            "node_b2": ParamDef((Lyr, H), ("layers", None), pd, "zeros"),
        }
        return {
            "encode": ParamDef((Fin, H), (None, None), pd),
            "layers": layer,
            "head": ParamDef((H, max(self.n_classes, 1)), (None, None), pd),
        }

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.param_defs(), seed, device)

    def n_params(self) -> int:
        return param_count(self.param_defs())


# ---------------------------------------------------------------------------
# ordered segment sums
# ---------------------------------------------------------------------------

@dataclass
class SegmentPlan:
    """The order in which :func:`segment_sum` adds ``ids``' segments.

    * ``ids`` i64[E]: each edge's segment (all edges, padding included);
    * ``order`` i64[R]: the R real edges in (k, rank) order: for each k, the
      k-th edge (ascending edge index) of every segment with more than k
      real edges, the segments ranked by size, larger first (stable);
    * ``runs``: for each k, how many segments have more than k edges (a
      host list: the slice of ``order`` of k and the rows it adds into);
    * ``live`` i64[runs[0]]: the segment of each rank;
    * ``counts`` i64[n]: the real edges of each segment.
    """

    ids: torch.Tensor
    n: int
    order: torch.Tensor
    runs: list
    live: torch.Tensor
    counts: torch.Tensor


def segment_plan(ids: torch.Tensor, n: int, mask: torch.Tensor | None = None) -> SegmentPlan:
    """The plan of ``ids`` (values in [0, n)) over the edges where ``mask``
    (all edges if None); two host syncs (the real-edge count, ``runs``)."""
    ids = ids.long()
    key = ids if mask is None else torch.where(mask, ids, n)  # n: the padding
    sorted_key, by_key = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=n + 1)[:n]
    R = int(counts.sum())
    starts = torch.cumsum(counts, 0) - counts
    live = torch.sort(counts, descending=True, stable=True).indices
    rank = torch.empty_like(live)
    rank[live] = torch.arange(n, device=ids.device)
    seg = sorted_key[:R]
    k = torch.arange(R, device=ids.device) - starts[seg]
    per_k = torch.bincount(k)
    at = (torch.cumsum(per_k, 0) - per_k)[k] + rank[seg]
    order = torch.empty(R, dtype=torch.long, device=ids.device)
    order[at] = by_key[:R]
    runs = per_k.tolist()
    return SegmentPlan(ids, n, order, runs, live[: runs[0] if runs else 0], counts)


@dataclass
class StaticPlan:
    """A shape-static stand-in for :class:`SegmentPlan`, for a trace on the
    ``meta`` device (the dry-run): :func:`segment_sum` by ``index_add``
    (unordered on the card) and :func:`gather` by ``index_select`` with its
    own backward, over all edges (padded ones carry zeros); ``counts`` by
    ``scatter_add_``.  The products, and so the FLOPs, are those of the
    ordered plan; no host sync."""

    ids: torch.Tensor
    n: int
    counts: torch.Tensor


def static_plan(ids: torch.Tensor, n: int, mask: torch.Tensor | None = None) -> StaticPlan:
    """:func:`segment_plan`'s shape-static stand-in (same arguments)."""
    ids = ids.long()
    ones = torch.ones_like(ids) if mask is None else mask.long()
    counts = torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(0, ids, ones)
    return StaticPlan(ids, n, counts)


def _ordered_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """vals [E, ...] → [n, ...]: each segment's real terms added in
    ascending edge index from a zero, rounded after every add in
    ``vals``' dtype."""
    out = vals.new_zeros((plan.n, *vals.shape[1:]))
    if not plan.runs:
        return out
    terms = vals.index_select(0, plan.order)
    acc = vals.new_zeros((plan.runs[0], *vals.shape[1:]))
    at = 0
    for c in plan.runs:
        acc[:c].add_(terms[at:at + c])
        at += c
    return out.index_copy_(0, plan.live, acc)


class _SegmentSum(torch.autograd.Function):
    """:func:`_ordered_sum`, whose backward is the gather by ``ids``."""

    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan = plan
        return _ordered_sum(vals, plan)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.plan.ids), None


class _Gather(torch.autograd.Function):
    """``src[ids]``, whose backward is :func:`_ordered_sum` over ``ids``."""

    @staticmethod
    def forward(ctx, src, plan):
        ctx.plan = plan
        return src.index_select(0, plan.ids)

    @staticmethod
    def backward(ctx, g):
        return _ordered_sum(g, ctx.plan), None


def segment_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """``jax.ops.segment_sum(vals, ids, n)`` in the reference's order
    (masked edges, which must hold zeros, left out)."""
    if isinstance(plan, StaticPlan):
        return vals.new_zeros((plan.n, *vals.shape[1:])).index_add(0, plan.ids, vals)
    return _SegmentSum.apply(vals, plan)


def gather(src: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """``src[ids]``; its backward sums in the reference's order (masked
    edges, whose cotangents must be zeros, left out)."""
    if isinstance(plan, StaticPlan):
        return src.index_select(0, plan.ids)
    return _Gather.apply(src, plan)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _mlp2(x, w1, b1, w2, b2):
    w1, b1, w2, b2 = (t.to(x.dtype) for t in (w1, b1, w2, b2))
    return F.silu(x @ w1 + b1) @ w2 + b2


def egnn_layer(cfg: EGNNConfig, lp: dict, h, x, edge_mask, recv: SegmentPlan,
               send: SegmentPlan):
    """One EGNN layer.  h [N,H], x [N,C], edge_mask [E] in the compute
    dtype; the edges are the plans' ``ids``."""
    H = h.shape[1]
    hx = torch.cat([h, x], dim=-1)  # one gather (and one backward sum) per side
    hi, xi = gather(hx, recv).split([H, x.shape[1]], dim=-1)
    hj, xj = gather(hx, send).split([H, x.shape[1]], dim=-1)
    diff = xi - xj
    dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)  # [E,1]
    m_in = torch.cat([hi, hj, dist2], dim=-1)
    m = _mlp2(m_in, lp["edge_w1"], lp["edge_b1"], lp["edge_w2"], lp["edge_b2"])
    m = F.silu(m) * edge_mask[:, None]

    # coordinate update (E(n) equivariant)
    cw = F.silu(
        m @ lp["coord_w1"].to(m.dtype) + lp["coord_b1"].to(m.dtype)
    ) @ lp["coord_w2"].to(m.dtype)  # [E,1]
    upd = diff * cw * edge_mask[:, None]
    num, agg = segment_sum(torch.cat([upd, m], dim=-1), recv).split([x.shape[1], H], dim=-1)
    if cfg.coord_agg == "mean":
        deg = recv.counts.to(torch.float32)  # the f32 segment sum of the mask
        num = num / torch.clamp(deg, min=1.0).to(num.dtype)[:, None]
    x_new = x + num.to(x.dtype)

    # feature update
    h_new = h + _mlp2(
        torch.cat([h, agg], dim=-1),
        lp["node_w1"], lp["node_b1"], lp["node_w2"], lp["node_b2"],
    )
    return h_new, x_new


def forward(cfg: EGNNConfig, params: dict, batch: dict, plan=segment_plan):
    """batch: feats f32[N,Fin], coords f32[N,C], senders/receivers i32[E],
    edge_mask bool[E].  Returns (node_out f32[N, max(n_classes, 1)],
    coords [N, C] in the compute dtype).  ``plan`` builds the sums' plans
    (:func:`static_plan` for a trace on ``meta``)."""
    cd = cfg.compute_dtype
    h = batch["feats"].to(cd) @ params["encode"].to(cd)
    x = batch["coords"].to(cd)
    real = batch["edge_mask"].bool()  # the plans run over the real edges
    recv = plan(batch["receivers"], h.shape[0], real)
    send = plan(batch["senders"], h.shape[0], real)
    edge_mask = batch["edge_mask"].to(cd)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        h, x = egnn_layer(cfg, lp, h, x, edge_mask, recv, send)
    return (h @ params["head"].to(h.dtype)).float(), x


def make_sharded_loss(cfg: EGNNConfig, mesh):
    """The reference's shard_map full-graph loss (node state row-sharded,
    all-gather + reduce-scatter per layer) waits for the mesh across cards
    (ROADMAP Queue 1 item 6)."""
    raise NotImplementedError(
        "make_sharded_loss needs the mesh across several cards (ROADMAP Queue 1 item 6); "
        "on one card use loss_fn")


def pad_nodes(n: int, multiple: int = 512) -> int:
    return (n + multiple - 1) // multiple * multiple


def loss_fn(cfg: EGNNConfig, params: dict, batch: dict, plan=segment_plan):
    """Node classification (labels i32[N], −1 ignored) or graph regression
    (graph_ids i32[N] + targets f32[G]); ``plan`` as :func:`forward`'s."""
    out, _ = forward(cfg, params, batch, plan)
    if cfg.n_classes > 0:
        labels = batch["labels"].long()
        mask = labels >= 0
        lse = torch.logsumexp(out, dim=-1)
        # the label's logit picked by a compare, not a gather (whose
        # backward is a scatter-add)
        cls = torch.arange(out.shape[1], device=out.device)
        ll = torch.where(cls == torch.clamp(labels, min=0)[:, None], out, 0.0).sum(-1)
        n = torch.clamp(mask.sum(), min=1)
        loss = ((lse - ll) * mask).sum() / n
        acc = ((out.argmax(-1) == labels) & mask).sum() / n
        return loss, {"nll": loss, "acc": acc}
    # graph regression: mean-pool nodes per graph
    G = batch["targets"].shape[0]
    graphs = plan(batch["graph_ids"], G)
    pooled = segment_sum(out[:, 0], graphs)
    counts = graphs.counts.to(torch.float32)  # the f32 segment sum of ones
    pred = pooled / torch.clamp(counts, min=1.0)
    loss = torch.mean((pred - batch["targets"]) ** 2)
    return loss, {"mse": loss}
