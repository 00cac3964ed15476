"""Decoder-only LM (port of ``repro/models/transformer.py``): a dense
SwiGLU or a Mixture-of-Experts FFN (:mod:`repro_torch.models.moe`), GQA,
RoPE, layer parameters stacked on a leading ``layers`` dim.

``forward`` and ``loss_fn`` (differentiable: training goes through
``torch.autograd``), and serving: ``prefill`` and ``decode_step`` with a
KV cache.  The reference's ``lax.scan`` over layers is a loop over the
stacked dim, and ``forward`` sums the per-layer MoE aux losses as the
scan stacks them.  ``remat`` is the reference's ``jax.checkpoint`` of the
layer body, as ``torch.utils.checkpoint`` of each layer in ``forward``
while autograd records: ``"full"`` keeps each layer's input and
recomputes the rest in the backward; ``"dots"`` also keeps the outputs of
the products without batch dims (``aten.mm``: the projections; not the
attention's or the experts' batched products), the counterpart of
``checkpoint_dots_with_no_batch_dims``; ``"none"`` keeps everything.
Remat changes memory, never values.  ``scan_unroll`` shapes only the
reference's compiled program.  Parameters are ``param_dtype`` (f32);
activations run in ``compute_dtype`` (bf16), each weight cast to it where
it is used.

Tensor parallelism (the reference's ``model`` axis): under
``use_sharding(ProcessMesh)`` with ``model`` = M > 1 the LM holds the
blocks ``param_specs`` gives it (``cfg.init(seed, device, mesh)``), and
:func:`loss_fn` reads the mesh once and passes it down to compute on them:
head- or sequence-parallel attention and FFN-parallel layers
(:mod:`~repro_torch.models.layers`),
a vocab-parallel lookup (rows outside the rank's range give zero, then one
``psum``) and a vocab-parallel loss (the rank's logit columns; ``logsumexp``
from a ``pmax`` and an ordered ``psum`` of the exp sums, the label's logit
a ``psum`` of the masked gather), so no rank builds the ``[B, S, Vp]``
logits.  Attention is head-parallel when both head counts divide M and
sequence-parallel otherwise (Qwen2.5-14B's 40 / 8 heads on M = 16), as
the reference's adaptive rule chooses.  A MoE config splits its experts
over ``model`` (:mod:`~repro_torch.models.moe`: the rank's E/M experts
and router columns), and on any process mesh whose batch axes split the
batch its aux loss is the global batch's: :func:`loss_fn` then passes the
process mesh to the MoE layers.  Remat "full" recomputes the collectives
in the backward, in the same order on every rank.  A leaf that M does not
divide (a projection width, d_ff, the expert count or the padded vocab)
is kept whole, as the reference's ``logical_spec`` keeps it
(:func:`~repro_torch.models.params.split_over_model` says which, once a
call: :func:`_parts`), and the part that uses it runs replicated on every
rank: whole attention, FFN or experts with no collective over ``model``,
a whole vocab's plain lookup and loss (no ``psum``, no ``pmax``).

Serving across ranks: under ``use_sharding(ProcessMesh)`` :func:`prefill`
and :func:`decode_step` take the rank's rows of the batch (the ``batch``
spec's block) and a cache from ``make_cache(..., mesh=mesh)``, the rank's
block of ``cache_defs``' spec (:func:`cache_block`: ``batch`` over (pod,
data), ``kv_heads`` over ``model`` or ``head_dim`` where M does not divide
the kv heads, ``kv_seq`` over (pod, data) where the batch does not
divide).  The layers run as in the loss, attention with the cache block
(:mod:`~repro_torch.models.layers`), and the logits are one process's for
the rank's rows: the rank's vocab columns joined by one exact
``all_gather`` over ``model`` (none where the vocab is whole).  A MoE
config's experts split over ``model`` as in training; its aux loss, which
serving discards, is the rank's rows' (no gather over the batch axes).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core import collectives as col
from repro_torch.core.distributed import ProcessMesh
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.params import (
    ParamDef,
    init_params,
    param_count,
    param_shardings,
    split_over_model,
)
from repro_torch.sharding.specs import get_context, splits
from repro_torch.train.loop import batch_axes


@dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 1024
    # MoE (n_experts == 0 → dense)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    norm_topk_probs: bool = True
    aux_loss_weight: float = 0.01
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_window: int | None = None  # sliding-window (beyond-paper long_500k)
    attn_chunk: int = 512
    tie_embeddings: bool = False
    # the reference's layer-loop unrolling (its dry-run's HLO cost analysis)
    scan_unroll: bool = False
    # numerics
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    z_loss: float = 1e-4
    remat: str = "full"  # none | full | dots

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style); padded logit
        columns are masked in _unembed."""
        return (self.vocab + 255) // 256 * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_defs(self) -> dict:
        D, H, KVH, Dh, F, E = (
            self.d_model, self.n_heads, self.n_kv_heads, self.d_head, self.d_ff,
            self.n_experts,
        )
        Lyr = self.n_layers
        pd = self.param_dtype
        layer: dict = {
            "ln1": ParamDef((Lyr, D), ("layers", "embed"), pd, "ones"),
            "ln2": ParamDef((Lyr, D), ("layers", "embed"), pd, "ones"),
            "attn": {
                "wq": ParamDef((Lyr, D, H * Dh), ("layers", "embed", "qkv_out"), pd),
                "wk": ParamDef((Lyr, D, KVH * Dh), ("layers", "embed", "kv_out"), pd),
                "wv": ParamDef((Lyr, D, KVH * Dh), ("layers", "embed", "kv_out"), pd),
                "wo": ParamDef((Lyr, H * Dh, D), ("layers", "qkv_out", "embed"), pd),
            },
        }
        if self.qkv_bias:
            layer["attn"]["bq"] = ParamDef((Lyr, H * Dh), ("layers", "qkv_out"), pd, "zeros")
            layer["attn"]["bk"] = ParamDef((Lyr, KVH * Dh), ("layers", "kv_out"), pd, "zeros")
            layer["attn"]["bv"] = ParamDef((Lyr, KVH * Dh), ("layers", "kv_out"), pd, "zeros")
        if self.qk_norm:
            layer["attn"]["q_norm"] = ParamDef((Lyr, Dh), ("layers", None), pd, "ones")
            layer["attn"]["k_norm"] = ParamDef((Lyr, Dh), ("layers", None), pd, "ones")
        if self.is_moe:
            layer["moe"] = {
                "router": ParamDef((Lyr, D, E), ("layers", "embed", "experts"), pd),
                "wi_gate": ParamDef((Lyr, E, D, F), ("layers", "experts", "embed", "expert_ffn"), pd),
                "wi_up": ParamDef((Lyr, E, D, F), ("layers", "experts", "embed", "expert_ffn"), pd),
                "wo": ParamDef((Lyr, E, F, D), ("layers", "experts", "expert_ffn", "embed"), pd),
            }
        else:
            layer["mlp"] = {
                "wi_gate": ParamDef((Lyr, D, F), ("layers", "embed", "ffn"), pd),
                "wi_up": ParamDef((Lyr, D, F), ("layers", "embed", "ffn"), pd),
                "wo": ParamDef((Lyr, F, D), ("layers", "ffn", "embed"), pd),
            }
        Vp = self.padded_vocab
        out = {
            "embed": ParamDef((Vp, D), ("vocab", "embed"), pd, "embed"),
            "ln_f": ParamDef((D,), ("embed",), pd, "ones"),
            "layers": layer,
        }
        if not self.tie_embeddings:
            out["unembed"] = ParamDef((D, Vp), ("embed", "vocab"), pd)
        return out

    def init(self, seed: int = 0, device=None, mesh=None) -> dict:
        """Parameters from ``seed`` on ``device``; on a process mesh the
        rank's blocks (:func:`~repro_torch.models.params.init_params`;
        whole leaves where ``model`` does not divide them)."""
        return init_params(self.param_defs(), seed, device, mesh)

    def n_params(self) -> int:
        return param_count(self.param_defs())

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        total = self.n_params()
        if not self.is_moe:
            return total
        expert_p = 3 * self.d_model * self.d_ff * self.n_layers * self.n_experts
        return int(total - expert_p * (1 - self.top_k / self.n_experts))


@dataclass(frozen=True)
class _Parts:
    """The model mesh each part of the LM computes on: the mesh where the
    part's leaves are the rank's blocks over ``model``, None where they are
    whole and the part runs replicated (:func:`_parts`)."""

    vocab: Any = None  # embed / unembed and the loss
    attn: Any = None  # wq, wo (and bq)
    kv_whole: bool = False  # wk, wv whole while wq splits
    ffn: Any = None  # a dense config's MLP
    experts: bool = False  # a MoE config's router and experts split


def _parts(cfg: TransformerConfig, mesh) -> _Parts:
    """The :class:`_Parts` of ``cfg`` on ``mesh`` (a model mesh, or None:
    every part whole), read from the leaves' shardings
    (:func:`~repro_torch.models.params.split_over_model`)."""
    if mesh is None:
        return _Parts()
    split = split_over_model(cfg.param_defs(), mesh)
    lay = split["layers"]
    q = lay["attn"]["wq"]
    return _Parts(vocab=mesh if split["embed"] else None, attn=mesh if q else None,
                  kv_whole=q and not lay["attn"]["wk"],
                  ffn=mesh if not cfg.is_moe and lay["mlp"]["wo"] else None,
                  experts=cfg.is_moe and lay["moe"]["wi_gate"])


def _moe_mesh(cfg: TransformerConfig, mesh, train: bool = True):
    """The process mesh a MoE config's layers take (:func:`moe_lib.moe_ffn`):
    the sharding context's ``mesh`` when it splits the batch (``train``:
    the aux loss is the global batch's) or has a ``model`` axis, else
    None."""
    if not cfg.is_moe or not isinstance(mesh, ProcessMesh):
        return None
    D = col.group_size(mesh, batch_axes(mesh)) if train else 1
    if D == 1 and mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def _vocab_start(mesh, n_local: int) -> int:
    """The first vocab row of this rank's block."""
    return mesh.coords_of(mesh.rank)["model"] * n_local


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """Rows gathered, then cast: the reference's cast-then-gather values
    without a compute-dtype copy of the whole table per call.  (The
    lookup's backward sums repeated rows in a fixed order on the card.)
    Vocab-parallel on a model mesh: each rank looks up the tokens of its
    rows, zero elsewhere, and one ``psum`` adds the one nonzero term."""
    if mesh is None:
        return F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)
    table = params["embed"]
    n = table.shape[0]
    ids = tokens.long() - _vocab_start(mesh, n)
    mine = (ids >= 0) & (ids < n)
    x = F.embedding(ids.clamp(0, n - 1), table).to(cfg.compute_dtype)
    return col.psum(mesh, [torch.where(mine[..., None], x, 0)], col.MODEL)[0]


def _unembed(cfg: TransformerConfig, params: dict, x: torch.Tensor,
             mesh=None) -> torch.Tensor:
    """f32 logits [..., padded_vocab] of ``x`` [..., D]; padded columns −1e9.
    On a model mesh the rank's vocab columns (``x`` entering the
    region)."""
    if mesh is not None:
        x = col.replicated(mesh, x, col.MODEL)[0]
    w = (params["embed"].T if cfg.tie_embeddings else params["unembed"]).to(cfg.compute_dtype)
    logits = torch.matmul(x.float(), w.float())
    pad = cfg.vocab - (0 if mesh is None else _vocab_start(mesh, w.shape[1]))
    if pad < logits.shape[-1]:  # mask padding columns
        logits[..., max(pad, 0):] = -1e9
    return logits


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views ``leaf[i]`` of the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in params.items()}


def _ffn(cfg: TransformerConfig, x: torch.Tensor, lp: dict, parts: _Parts, moe_mesh=None,
         global_aux: bool = True):
    """The FFN half of a layer: (x + FFN(norm(x)), aux).  ``parts``: the
    call's :class:`_Parts`; ``moe_mesh``: the process mesh of a MoE
    config's layers (:func:`_moe_mesh`) or None; ``global_aux`` as
    :func:`moe_lib.moe_ffn`'s."""
    y = L.rms_norm(x, lp["ln2"])
    if cfg.is_moe:
        f, aux = moe_lib.moe_ffn(y, lp["moe"], cfg, moe_mesh, global_aux, parts.experts)
    else:  # a dense layer's aux loss is 0
        f = L.swiglu(y, lp["mlp"], parts.ffn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def _attention(cfg: TransformerConfig, x: torch.Tensor, lp: dict, positions: torch.Tensor,
               parts: _Parts, **cache):
    """The attention block of layer ``lp`` on the normed ``x``, as
    ``parts`` splits it; ``cache``: :func:`~repro_torch.models.layers.attention_block`'s
    cache arguments."""
    return L.attention_block(L.rms_norm(x, lp["ln1"]), lp["attn"], cfg, positions,
                             mesh=parts.attn, kv_whole=parts.kv_whole, **cache)


def _layer_body(cfg: TransformerConfig, x: torch.Tensor, lp: dict, positions: torch.Tensor,
                parts: _Parts = _Parts(), moe_mesh=None):
    """One layer; ``parts`` and ``moe_mesh`` as :func:`_ffn`'s."""
    h, _ = _attention(cfg, x, lp, positions, parts)
    return _ffn(cfg, x + h, lp, parts, moe_mesh)


def _save_dots(ctx, op, *args, **kwargs):
    """Remat "dots": keep the products without batch dims."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, body):
    """``body`` under the config's checkpointing, while autograd records."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    if cfg.remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {cfg.remat!r}: none | full | dots")


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, mesh=None,
            moe_mesh=None):
    """tokens i32[B, S] → (logits f32[B, S, V], aux_loss: the sum over
    layers).  ``mesh``: a model mesh (:func:`loss_fn` passes the sharding
    context's), where ``params`` are the rank's blocks and the logits the
    rank's vocab columns (all of them where the vocab is whole);
    ``moe_mesh``: the process mesh of a MoE config's layers
    (:func:`_moe_mesh`)."""
    return _forward(cfg, params, tokens, _parts(cfg, mesh), moe_mesh)


def _forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, parts: _Parts,
             moe_mesh=None):
    """:func:`forward` as ``parts`` splits the LM.  The layers take the
    meshes as arguments, as remat recomputes them on autograd's device
    thread."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens, parts.vocab)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    body = _remat(cfg, functools.partial(_layer_body, cfg, parts=parts, moe_mesh=moe_mesh))
    auxs = []
    for i in range(cfg.n_layers):
        x, a = body(x, _layer(params["layers"], i), positions)
        auxs.append(a)
    x = L.rms_norm(x, params["ln_f"])
    return _unembed(cfg, params, x, parts.vocab), torch.stack(auxs).sum()


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict):
    """batch: tokens i32[B, S], labels i32[B, S] (−1 = ignore).  Returns
    (total, metrics): the reference's loss, z-loss and weighted aux loss;
    under a model mesh, the sharding context's, vocab-parallel where the
    vocab splits (:func:`_vocab_parallel_terms`); a MoE config's aux over
    the global batch on a data-split process mesh (:func:`_moe_mesh`)."""
    ctx_mesh = get_context().mesh
    parts = _parts(cfg, col.model_mesh(ctx_mesh))
    logits, aux = _forward(cfg, params, batch["tokens"], parts, _moe_mesh(cfg, ctx_mesh))
    labels = batch["labels"].long()
    mask = labels >= 0
    if parts.vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    else:
        lse, ll = _vocab_parallel_terms(parts.vocab, logits, labels)
    nll = (lse - ll) * mask
    n = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / n
    zl = cfg.z_loss * ((lse * mask) ** 2).sum() / n
    total = loss + zl + cfg.aux_loss_weight * aux
    return total, {"nll": loss, "z_loss": zl, "aux": aux, "tokens": n.to(torch.int32)}


def _vocab_parallel_terms(mesh, logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, the label's logit) of the global logits from this rank's
    columns: the row maximum by ``pmax`` (a constant to autograd, as
    ``logsumexp``'s shift is), the exp sums by an ordered ``psum``, the
    label's logit by a ``psum`` of the gather on the rank that holds it."""
    n = logits.shape[-1]
    top = col.pmax(mesh, [logits.detach().amax(dim=-1)], col.MODEL)[0]
    sums = col.psum(mesh, [torch.exp(logits - top[..., None]).sum(dim=-1)], col.MODEL)[0]
    lse = top + torch.log(sums)
    ids = torch.clamp(labels, min=0) - _vocab_start(mesh, n)
    mine = (ids >= 0) & (ids < n)
    ll = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    return lse, col.psum(mesh, [torch.where(mine, ll, 0.0)], col.MODEL)[0]


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def cache_defs(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    """The KV cache as :class:`ParamDef`s (the dry-run's shapes and specs)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    # kv_seq/head_dim are fallback shards: they engage exactly when batch or
    # kv_heads cannot divide the mesh axes (long-context b=1, GQA kv<model)
    logical = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamDef(shape, logical, cfg.compute_dtype, "zeros"),
        "v": ParamDef(shape, logical, cfg.compute_dtype, "zeros"),
    }


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None,
               mesh=None) -> dict:
    """A zero KV cache ``[layers, batch, max_len, kv_heads, d_head]`` in
    ``compute_dtype`` on ``device`` (CUDA unless given; a process mesh's
    own device).  On a :class:`~repro_torch.core.distributed.ProcessMesh`
    ``mesh`` each tensor is this rank's block of ``cache_defs``' spec and
    carries that :class:`~repro_torch.sharding.specs.NamedSharding` as its
    ``sharding`` (the reference's cache arrays carry theirs), which
    :func:`prefill` and :func:`decode_step` read (:func:`cache_block`)."""
    defs = cache_defs(cfg, batch, max_len)
    if not isinstance(mesh, ProcessMesh):
        dev = resolve_device(device)
        return {k: torch.zeros(d.shape, dtype=d.dtype, device=dev) for k, d in defs.items()}
    dev = mesh.device if device is None else resolve_device(device)
    out = {}
    for (k, d), sh in zip(defs.items(), param_shardings(defs, mesh).values()):
        out[k] = torch.zeros(sh.shard_shape(d.shape), dtype=d.dtype, device=dev)
        out[k].sharding = sh
    return out


def cache_block(cache: dict) -> L.CacheBlock:
    """The global rows, positions, kv heads and head_dim columns that this
    rank's cache block covers (:class:`~repro_torch.models.layers.CacheBlock`):
    the whole cache on one process or where the spec splits nothing."""
    sh = getattr(cache["k"], "sharding", None)
    shape = tuple(cache["k"].shape)
    if not splits(sh):
        return L.CacheBlock.whole(shape)
    return L.CacheBlock.of(sh, sh.global_shape(shape))


def _serving(cfg: TransformerConfig, cache: dict, rows: int):
    """(:class:`_Parts`, MoE mesh, cache block) of a serving call under the
    sharding context, checked against the cache and the ``rows`` given."""
    ctx_mesh = get_context().mesh
    if (isinstance(ctx_mesh, ProcessMesh) and ctx_mesh.size > 1
            and getattr(cache["k"], "sharding", None) is None):
        raise ValueError("on a process mesh, make the cache with make_cache(..., mesh=mesh): "
                         "its block carries its sharding")
    block = cache_block(cache)
    if block.mesh is not None and block.mesh != ctx_mesh:
        raise ValueError("a cache block of a process mesh is served under that mesh's "
                         "use_sharding context")
    if rows != block.size[1]:
        raise ValueError(f"{rows} rows of tokens for a cache block of {block.size[1]} rows "
                         "(on a process mesh, pass the rank's rows of the batch)")
    return (_parts(cfg, col.model_mesh(ctx_mesh)), _moe_mesh(cfg, ctx_mesh, train=False),
            block)


def _serve_logits(cfg: TransformerConfig, params: dict, x: torch.Tensor, mesh):
    """f32 logits [B, 1, padded_vocab] of ``x`` [B, 1, D]: on a model mesh
    whose ranks hold vocab blocks (``mesh``) their columns gathered in
    rank order."""
    logits = _unembed(cfg, params, x, mesh)
    if mesh is not None:
        logits = col.all_gather(mesh, [logits], col.MODEL, dim=-1)[0]
    return logits


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, cache: dict):
    """Fill the cache with the prompt; returns (logits_last f32[B, V], cache).

    Each layer's k/v are written into ``cache`` in place and its positions
    from S on are zeroed: the reference's stacked, zero-padded cache, without
    holding a second copy of it.  Across ranks (module docstring) each rank
    writes and zeroes its block only."""
    B, S = tokens.shape
    parts, moe_mesh, block = _serving(cfg, cache, B)
    if S > block.shape[2]:
        raise ValueError(f"a prompt of {S} tokens for a cache of {block.shape[2]} positions")
    x = _embed(cfg, params, tokens, parts.vocab)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, (k, v) = _attention(cfg, x, lp, positions, parts)
        block.write(cache["k"][i], k, 0)
        block.write(cache["v"][i], v, 0)
        x, _ = _ffn(cfg, x + h, lp, parts, moe_mesh, global_aux=False)
    first = max(S - block.start[2], 0)  # the block's position S
    cache["k"][:, :, first:] = 0
    cache["v"][:, :, first:] = 0
    x = L.rms_norm(x, params["ln_f"])
    logits = _serve_logits(cfg, params, x[:, -1:, :], parts.vocab)
    return logits[:, 0], cache


def decode_step(
    cfg: TransformerConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # i32[B] last generated token
    pos: int,  # write position (= current length)
):
    """One token of batched decode, writing its k/v into ``cache`` in
    place.  Returns (logits f32[B, V], cache).  Across ranks (module
    docstring) the write lands in the block that holds ``pos``."""
    B = tokens.shape[0]
    parts, moe_mesh, block = _serving(cfg, cache, B)
    x = _embed(cfg, params, tokens, parts.vocab)[:, None, :]  # [B, 1, D]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, _ = _attention(cfg, x, lp, positions, parts, k_cache=cache["k"][i],
                          v_cache=cache["v"][i], cache_pos=pos, kv_valid_len=pos + 1,
                          block=block)
        x, _ = _ffn(cfg, x + h, lp, parts, moe_mesh, global_aux=False)
    x = L.rms_norm(x, params["ln_f"])
    logits = _serve_logits(cfg, params, x, parts.vocab)
    return logits[:, 0], cache
