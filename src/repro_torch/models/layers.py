"""Shared layers (port of ``repro/models/layers.py``): RMSNorm, RoPE, GQA
flash attention, the attention block with its KV cache, and SwiGLU.

Each function computes what the reference's does, op for op, on one
device: the reference's logical-axis sharding constraints (``shard``) only
place data on a mesh and are dropped.  Where the reference's einsum
accumulates a low-precision product into f32 (``preferred_element_type``),
the port multiplies the operands upcast to f32, which gives the same exact
products and an f32 sum.

Given ``mesh``, a process mesh whose ``model`` axis M is > 1
(:func:`~repro_torch.core.collectives.model_mesh`), the projections are
the rank's ``param_specs`` blocks: column blocks of ``wq``/``wk``/``wv``
(and their biases) over the flattened ``H·Dh``/``KVH·Dh`` outputs, a row
block of ``wo``, the rank's d_ff/M columns of :func:`swiglu`.  Each block
enters through :func:`~repro_torch.core.collectives.replicated` over
``model`` (its backward sums the input's cotangents over the group) and
leaves its row-parallel ``wo`` through one
:func:`~repro_torch.core.collectives.psum` over ``model``.

Where M does not divide a leaf, the reference's shape-aware
``logical_spec`` keeps it whole (``models.params.split_over_model`` says
which), and a layer whose leaves are whole runs replicated, as the norms
do: the caller passes it no mesh, so it enters no region and closes with
no ``psum``; every rank computes one process's values, and its gradients
are one process's on every rank.  ``wq`` and ``wo`` share the ``H·Dh``
dimension, so they are whole or split together, and since ``H·Dh =
G·KVH·Dh`` k and v are whole whenever q is.  Where q splits and k and v
are whole (``kv_whole``), k and v are computed from the whole input
outside the region and enter it through ``replicated``, as the input does:
the backward adds each rank's share of their cotangents once, and nothing
is gathered.  Such kv heads never divide M, so that attention is
sequence-parallel.  :func:`attention_block` splits attention as the
reference's adaptive rule does (``repro/models/layers.py:136-154``,
:func:`head_parallel`):

* heads that divide M run head-parallel: the rank's H/M query and KVH/M kv
  heads (GQA groups stay whole), with no other collective;
* any other head count runs sequence-parallel (the reference's ``"seq"``
  rule): the rank's column blocks cut through heads, so an
  :func:`~repro_torch.core.collectives.all_to_all` sends q to the rank's
  S/M contiguous rows with every head, k and v are gathered whole
  (:func:`~repro_torch.core.collectives.all_gather` of the columns; whole
  leaves give them whole already), the norms and RoPE act on whole heads
  there, the rank's rows attend causally from their offset, and a second
  ``all_to_all`` brings the output back to the rank's column block for
  ``wo``.  When M does not divide S the reference's shape-aware spec
  drops the axis: q is gathered whole, every rank attends all rows and
  keeps its output columns.  A decode step (S = 1) with a cache always
  takes this branch.

A KV cache across the ranks of a process mesh is held as the reference's
``cache_defs`` spec places it (:class:`CacheBlock`: ``batch`` over (pod,
data), ``kv_heads`` over ``model`` or, when M does not divide them,
``head_dim``, and ``kv_seq`` over (pod, data) when the batch does not
divide).  A step writes its new k/v into the rank's block only, then
all-gathers the layer's blocks over the split ``kv_seq`` and ``head_dim``
axes in rank order (exact), so :func:`flash_attention` sees one process's
layer: every position, whole heads.  Head-parallel attention attends its
own kv heads, which are the block's.

The mesh is passed, never read from the thread-local sharding context:
``torch.utils.checkpoint`` recomputes a layer on autograd's device thread.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as col


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32 and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x [..., S, H, Dh], positions [..., S] (int); the
    angles in f32, the result in ``x``'s dtype."""
    dh = x.shape[-1]
    half = dh // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., :, None].float() * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Skv, KVH, Dh]
    v: torch.Tensor,  # [B, Skv, KVH, Dh]
    *,
    causal: bool = True,
    q_offset: "torch.Tensor | int" = 0,
    kv_valid_len: "torch.Tensor | int | None" = None,  # [B] or scalar; mask k_pos >= len
    window: int | None = None,  # sliding-window attention (beyond-paper)
    chunk: int = 512,
) -> torch.Tensor:
    """Chunked-KV attention with a running softmax (flash-style, plain
    PyTorch), the reference's loop op for op.

    Never materializes the [Sq, Skv] score matrix: each step holds one
    ``[B, Sq, KVH, G, chunk]`` f32 score block.  GQA by head grouping.
    ``m``, ``l`` and the accumulator are f32; a row whose keys are all
    masked gives 0.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    assert H % KVH == 0, (H, KVH)
    G = H // KVH
    scale = Dh**-0.5
    dev = q.device
    qg = q.reshape(B, Sq, KVH, G, Dh).float()
    chunk = min(chunk, Skv)
    assert Skv % chunk == 0, (Skv, chunk)
    n_chunks = Skv // chunk
    q_pos = torch.as_tensor(q_offset, device=dev) + torch.arange(Sq, dtype=torch.int32, device=dev)
    vl = None
    if kv_valid_len is not None:
        vl = torch.broadcast_to(torch.as_tensor(kv_valid_len, device=dev), (B,))

    m = torch.full((B, Sq, KVH, G), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KVH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KVH, G, Dh), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]  # [B, chunk, KVH, Dh]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        k_pos = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)  # [chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb.float()) * scale  # [B, Sq, KVH, G, chunk]
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
        if vl is not None:
            ok = (k_pos[None, :] < vl[:, None])[:, None, None, None, :]  # [B,1,1,1,chunk]
            s = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isneginf(s), 0.0, p)
        m_inf = torch.isneginf(m)
        corr = torch.exp(torch.where(m_inf, -torch.inf, m - m_safe))
        corr = torch.where(m_inf, 0.0, corr)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(vb.dtype), vb)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype (the weight cast to it)."""
    return torch.matmul(x, w.to(x.dtype))


@dataclass(frozen=True)
class CacheBlock:
    """The block of a KV cache ``[layers, batch, max_len, kv_heads,
    head_dim]`` (global ``shape``) that this rank of ``mesh`` holds: on
    each dim its first global index (``start``), its length (``size``) and
    the mesh axes that split it (``axes``, empty where it is whole), as the
    cache's :class:`~repro_torch.sharding.specs.NamedSharding` places it.
    Its methods take one layer's block ``[rows, positions, heads, dims]``."""

    mesh: object  # repro_torch.core.distributed.ProcessMesh, or None
    shape: tuple[int, ...]
    start: tuple[int, ...]
    size: tuple[int, ...]
    axes: tuple[tuple[str, ...], ...]

    @classmethod
    def whole(cls, shape: tuple[int, ...]) -> "CacheBlock":
        """A cache of ``shape`` held whole (one process)."""
        shape = tuple(shape)
        return cls(None, shape, (0,) * len(shape), shape, ((),) * len(shape))

    @classmethod
    def of(cls, sharding, shape: tuple[int, ...]) -> "CacheBlock":
        """The block of a cache of global ``shape`` under ``sharding`` at
        its process mesh's rank."""
        start, size = [0] * len(shape), list(shape)
        for dim, s, n in sharding.block(tuple(shape)):
            start[dim], size[dim] = s, n
        axes = []
        for i in range(len(shape)):
            e = sharding.spec[i] if i < len(sharding.spec) else None
            names = (e,) if isinstance(e, str) else tuple(e or ())
            axes.append(names if size[i] < shape[i] else ())
        return cls(sharding.mesh, tuple(shape), tuple(start), tuple(size), tuple(axes))

    def write(self, dst: torch.Tensor, src: torch.Tensor, at: int) -> None:
        """Write ``src`` [rows, S, heads, head_dim] (the global positions
        ``at`` … ``at + S``; every kv head, or the block's own) into the
        layer block ``dst`` where the two overlap; nothing where they do
        not."""
        s0, n = self.start[2], self.size[2]
        lo, hi = max(at, s0), min(at + src.shape[1], s0 + n)
        if lo >= hi:
            return
        if src.shape[0] != dst.shape[0] or src.shape[2] not in (self.shape[3], self.size[3]):
            raise ValueError(f"k/v {tuple(src.shape)} do not fit the cache block "
                             f"{tuple(dst.shape)} of {self.shape}")
        h = self.start[3] if src.shape[2] == self.shape[3] else 0
        d = self.start[4]
        dst[:, lo - s0:hi - s0] = src[:, lo - at:hi - at, h:h + self.size[3],
                                      d:d + self.size[4]].to(dst.dtype)

    def gather(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The layer blocks ``k``, ``v`` with every position and every
        head_dim column: one all-gather of both over the ``kv_seq`` axes,
        one over the ``head_dim`` axes, in rank order.  The block's heads
        stay its own."""
        if not (self.axes[2] or self.axes[4]):
            return k, v
        kv = torch.stack([k, v])
        for dim in (2, 4):  # [2, rows, positions, heads, dims]
            if self.axes[dim]:
                kv = col.all_gather(self.mesh, [kv], self.axes[dim], dim=dim)[0]
        return kv[0], kv[1]


def attention_block(
    x: torch.Tensor,  # [B, S, D]
    p: dict,
    cfg,
    positions: torch.Tensor,
    *,
    k_cache: torch.Tensor | None = None,
    v_cache: torch.Tensor | None = None,
    cache_pos: "torch.Tensor | int | None" = None,
    kv_valid_len: "torch.Tensor | int | None" = None,
    mesh=None,
    block: CacheBlock | None = None,
    kv_whole: bool = False,
):
    """GQA attention with an optional KV cache (decode).

    With a cache, the new k/v are written into ``k_cache``/``v_cache`` at
    ``cache_pos`` in place (the reference's ``dynamic_update_slice``
    returns updated copies) and attention runs over the whole cache.
    Returns (out [B, S, D], (k, v): the cache, or this call's full k/v).
    With a model-parallel ``mesh`` (module docstring) ``p`` holds the
    rank's blocks of ``wq`` and ``wo`` and ``out`` is summed over
    ``model``; ``kv_whole``: ``wk`` and ``wv`` are whole leaves.  Without a
    cache the k/v returned are the rank's heads (head-parallel) or whole
    (sequence-parallel).  Without ``mesh`` every leaf is whole and the
    block runs as one process's (``block`` may still be a rank's).
    ``block``: the :class:`CacheBlock` the cache layer is (module
    docstring); default the whole layer.
    """
    B, S, D = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    seq_parallel = False
    kv = None
    if mesh is not None:
        M = mesh.shape["model"]
        if kv_whole:  # from the whole x, entering the region as x does
            kv = col.replicated(mesh, _kv(x, p, cfg), col.MODEL)[0]
        x = col.replicated(mesh, x, col.MODEL)[0]
        if cfg.qk_norm:  # whole leaves applied to the rank's heads or rows only
            p = {**p, **col.replicated(mesh, {k: p[k] for k in ("q_norm", "k_norm")},
                                       col.MODEL)[0]}
        if head_parallel(H, KVH, M):  # never with kv_whole: KVH does not divide M
            H, KVH = H // M, KVH // M
        elif k_cache is None:
            return _sequence_parallel(x, p, cfg, positions, mesh, kv)
        else:  # with a cache: every row on every rank, q, k and v whole
            seq_parallel = True
    q = _q(x, p, cfg)
    k, v = _kv(x, p, cfg) if kv is None else kv
    if seq_parallel:
        q = col.all_gather(mesh, [q], col.MODEL, dim=2)[0]
        if kv is None:
            k, v = (col.all_gather(mesh, [t], col.MODEL, dim=2)[0] for t in (k, v))
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KVH, Dh)
    v = v.reshape(B, S, KVH, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if k_cache is not None:
        # decode: insert the new kv at cache_pos (clamped into the cache, as
        # dynamic_update_slice clamps its start), attend over the cache
        # (across ranks: into the rank's block only, then the layer whole)
        block = block or CacheBlock.whole((1, *k_cache.shape))
        pos = int(cache_pos)
        at = min(max(pos, 0), block.shape[2] - S)
        block.write(k_cache, k, at)
        block.write(v_cache, v, at)
        k_all, v_all = block.gather(k_cache, v_cache)
        out = flash_attention(
            q,
            k_all.to(q.dtype),
            v_all.to(q.dtype),
            causal=False,
            kv_valid_len=kv_valid_len if kv_valid_len is not None else pos + S,
            window=cfg.attn_window,
            chunk=cfg.attn_chunk,
        )
        new_kv = (k_cache, v_cache)
    else:
        out = flash_attention(q, k, v, causal=True, window=cfg.attn_window, chunk=cfg.attn_chunk)
        new_kv = (k, v)
    out = out.reshape(B, S, H * Dh)
    if seq_parallel:  # the rank's column block, for its wo rows
        c = H * Dh // M
        r = mesh.coords_of(mesh.rank)["model"]
        out = out[..., r * c:(r + 1) * c]
    out = _proj(out, p["wo"])
    if mesh is not None:
        out = col.psum(mesh, [out], col.MODEL)[0]
    return out, new_kv


def _q(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """The q projection (the rank's column block on a model mesh), with its
    bias: ``[B, S, H·Dh]``."""
    q = _proj(x, p["wq"])
    return q + p["bq"].to(x.dtype) if cfg.qkv_bias else q


def _kv(x: torch.Tensor, p: dict, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The k and v projections (the rank's column blocks, or whole), with
    their biases: ``[B, S, KVH·Dh]`` each."""
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return k, v


def head_parallel(n_heads: int, n_kv_heads: int, model: int) -> bool:
    """The reference's selector (``repro/models/layers.py:146``): attention
    runs head-parallel when both head counts divide ``model``, else
    sequence-parallel."""
    return n_heads % model == 0 and n_kv_heads % model == 0


def _sequence_parallel(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor, mesh,
                       kv=None):
    """Sequence-parallel attention on a model mesh (module docstring):
    ``x`` [B, S, D] entered the region; ``kv``: the whole k and v, entered
    too, where they are whole leaves (else the rank's column blocks are
    gathered); returns (the ``psum`` of the rank's ``wo`` rows, (k, v)
    whole)."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    M = mesh.shape["model"]
    r = mesh.coords_of(mesh.rank)["model"]
    q = _q(x, p, cfg)
    if kv is None:
        k, v = (col.all_gather(mesh, [t], col.MODEL, dim=2)[0] for t in _kv(x, p, cfg))
    else:
        k, v = kv
    if S % M == 0:  # the rank's contiguous rows, every head
        n = S // M
        q = col.all_to_all(mesh, [q], col.MODEL, split_dim=1, concat_dim=2)[0]
        q_pos, q_offset = positions[..., r * n:(r + 1) * n], r * n
    else:  # the reference's spec drops "seq": every row on every rank
        n = S
        q = col.all_gather(mesh, [q], col.MODEL, dim=2)[0]
        q_pos, q_offset = positions, 0
    k = k.reshape(B, S, KVH, Dh)
    v = v.reshape(B, S, KVH, Dh)
    q = q.reshape(B, n, H, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset, window=cfg.attn_window,
                          chunk=cfg.attn_chunk).reshape(B, n, H * Dh)
    if S % M == 0:  # back to every row of the rank's column block
        out = col.all_to_all(mesh, [out], col.MODEL, split_dim=2, concat_dim=1)[0]
    else:
        c = H * Dh // M
        out = out[..., r * c:(r + 1) * c]
    out = col.psum(mesh, [_proj(out, p["wo"])], col.MODEL)[0]
    return out, (k, v)


def swiglu(x: torch.Tensor, p: dict, mesh=None) -> torch.Tensor:
    """SwiGLU; with a model-parallel ``mesh`` column-parallel ``wi_gate`` /
    ``wi_up`` and row-parallel ``wo`` (the rank's d_ff/M columns), summed
    over ``model``; without one (one process, or a d_ff that ``model``
    does not divide) on the whole leaves."""
    if mesh is not None:
        x = col.replicated(mesh, x, col.MODEL)[0]
    gate = _proj(x, p["wi_gate"])
    up = _proj(x, p["wi_up"])
    h = F.silu(gate) * up
    out = _proj(h, p["wo"])
    return out if mesh is None else col.psum(mesh, [out], col.MODEL)[0]
