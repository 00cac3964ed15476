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

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.params import ParamDef, init_params, param_count


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

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.param_defs(), seed, device)

    def n_params(self) -> int:
        return param_count(self.param_defs())

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        total = self.n_params()
        if not self.is_moe:
            return total
        expert_p = 3 * self.d_model * self.d_ff * self.n_layers * self.n_experts
        return int(total - expert_p * (1 - self.top_k / self.n_experts))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(cfg: TransformerConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows gathered, then cast: the reference's cast-then-gather values
    without a compute-dtype copy of the whole table per call.  (The
    lookup's backward sums repeated rows in a fixed order on the card.)"""
    return F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)


def _unembed(cfg: TransformerConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [..., padded_vocab] of ``x`` [..., D]; padded columns −1e9."""
    w = (params["embed"].T if cfg.tie_embeddings else params["unembed"]).to(cfg.compute_dtype)
    logits = torch.matmul(x.float(), w.float())
    if cfg.padded_vocab != cfg.vocab:  # mask padding columns
        logits[..., cfg.vocab:] = -1e9
    return logits


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views ``leaf[i]`` of the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in params.items()}


def _ffn(cfg: TransformerConfig, x: torch.Tensor, lp: dict):
    """The FFN half of a layer: (x + FFN(norm(x)), aux)."""
    y = L.rms_norm(x, lp["ln2"])
    if cfg.is_moe:
        f, aux = moe_lib.moe_ffn(y, lp["moe"], cfg)
    else:  # a dense layer's aux loss is 0
        f, aux = L.swiglu(y, lp["mlp"]), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def _layer_body(cfg: TransformerConfig, x: torch.Tensor, lp: dict, positions: torch.Tensor):
    h, _ = L.attention_block(L.rms_norm(x, lp["ln1"]), lp["attn"], cfg, positions)
    return _ffn(cfg, x + h, lp)


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


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """tokens i32[B, S] → (logits f32[B, S, V], aux_loss: the sum over
    layers)."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    body = _remat(cfg, functools.partial(_layer_body, cfg))
    auxs = []
    for i in range(cfg.n_layers):
        x, a = body(x, _layer(params["layers"], i), positions)
        auxs.append(a)
    x = L.rms_norm(x, params["ln_f"])
    return _unembed(cfg, params, x), torch.stack(auxs).sum()


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict):
    """batch: tokens i32[B, S], labels i32[B, S] (−1 = ignore).  Returns
    (total, metrics): the reference's loss, z-loss and weighted aux loss."""
    logits, aux = forward(cfg, params, batch["tokens"])
    labels = batch["labels"].long()
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = (lse - ll) * mask
    n = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / n
    zl = cfg.z_loss * ((lse * mask) ** 2).sum() / n
    total = loss + zl + cfg.aux_loss_weight * aux
    return total, {"nll": loss, "z_loss": zl, "aux": aux, "tokens": n.to(torch.int32)}


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


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None) -> dict:
    """A zero KV cache ``[layers, batch, max_len, kv_heads, d_head]`` in
    ``compute_dtype`` on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    return {k: torch.zeros(d.shape, dtype=d.dtype, device=dev)
            for k, d in cache_defs(cfg, batch, max_len).items()}


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, cache: dict):
    """Fill the cache with the prompt; returns (logits_last f32[B, V], cache).

    Each layer's k/v are written into ``cache`` in place and its positions
    from S on are zeroed: the reference's stacked, zero-padded cache, without
    holding a second copy of it."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, (k, v) = L.attention_block(L.rms_norm(x, lp["ln1"]), lp["attn"], cfg, positions)
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        x, _ = _ffn(cfg, x + h, lp)
    cache["k"][:, :, S:] = 0
    cache["v"][:, :, S:] = 0
    x = L.rms_norm(x, params["ln_f"])
    logits = _unembed(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache


def decode_step(
    cfg: TransformerConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # i32[B] last generated token
    pos: int,  # write position (= current length)
):
    """One token of batched decode, writing its k/v into ``cache`` in
    place.  Returns (logits f32[B, V], cache)."""
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens)[:, None, :]  # [B, 1, D]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, _ = L.attention_block(
            L.rms_norm(x, lp["ln1"]), lp["attn"], cfg, positions,
            k_cache=cache["k"][i], v_cache=cache["v"][i], cache_pos=pos,
            kv_valid_len=pos + 1,
        )
        x, _ = _ffn(cfg, x + h, lp)
    x = L.rms_norm(x, params["ln_f"])
    logits = _unembed(cfg, params, x)
    return logits[:, 0], cache
