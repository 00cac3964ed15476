"""int8 gradient compression with error feedback (port of
``repro/train/compression.py``).

Under data parallelism the gradient all-reduce moves ``4·n_params`` bytes
per step per link; quantizing to int8 with a per-tensor absmax scale cuts
that 4×, and the quantization error is fed back into the next step's
gradient (error feedback, Karimireddy et al. 2019).  ``torch.round``
rounds half to even, as ``jnp.round`` does.  The compressed all-reduce
itself (:func:`psum_compressed`) needs a collective and waits for the mesh
across cards.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization.  Returns (q int8, scale f32)."""
    absmax = torch.max(torch.abs(x.float()))
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, error_buf):
    """Quantize grads + error feedback; returns (q_tree, scales, new_error)."""

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error_buf))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(q_tree, s_tree):
    return tree_map(dequantize_int8, q_tree, s_tree)


def psum_compressed(grads, error_buf, axis_names):
    """The int8 all-reduce of the reference's ``shard_map`` step."""
    raise NotImplementedError(
        "psum_compressed needs a collective across cards: it waits for the mesh across "
        "cards (ROADMAP Queue 1 item 6b)")
