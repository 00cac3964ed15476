"""Deterministic synthetic LM token pipeline (port of ``repro/data/lm.py``).

Keyed by (seed, step), so a restarted job replays identical batches.  A
light Markov structure (a cluster walk) makes the loss decreasable.  The
same shapes, ranges and distributions as the reference; the values come
from a ``torch.Generator`` on the target device seeded by (seed, step),
so they are not the reference's ``jax.random`` draws.  Batches are built
on ``device`` (CUDA unless given).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.data.recsys import make_generator
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_clusters: int = 64  # markov structure


def lm_batch(cfg: LMDataConfig, step: int, device=None) -> dict:
    """Batch for ``step``: tokens and next-token labels i32[B, S] (the last
    label −1), a pure function of (cfg.seed, step)."""
    dev = resolve_device(device)
    g = make_generator(cfg.seed, step, dev)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    # cluster walk: each position's cluster = prev cluster + small step
    steps = torch.randint(-1, 2, (B, S), generator=g, device=dev, dtype=torch.int32)
    clusters = torch.cumsum(steps, dim=1) % cfg.n_clusters
    within = torch.randint(0, max(V // cfg.n_clusters, 1), (B, S), generator=g, device=dev)
    tokens = ((clusters * (V // cfg.n_clusters) + within) % V).to(torch.int32)
    labels = torch.cat(
        [tokens[:, 1:], torch.full((B, 1), -1, dtype=torch.int32, device=dev)], dim=1)
    return {"tokens": tokens, "labels": labels}


def lm_input_specs(cfg: LMDataConfig) -> dict:
    """The batch's shapes and dtypes as ``meta`` tensors (the dry-run's
    inputs): tokens and labels i32[B, S]."""
    shape = (cfg.global_batch, cfg.seq_len)
    return {"tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
            "labels": torch.empty(shape, dtype=torch.int32, device="meta")}
