"""Synthetic recsys batches (Criteo/Avazu/Alibaba-style), deterministic in
(seed, step) (port of ``repro/data/recsys.py``).

The same keys, shapes, dtypes, ranges and distributions as the reference;
the values come from a ``torch.Generator`` on the target device seeded by
(seed, step), so they are not the reference's threefry draws.  Batches are
built on ``device`` (CUDA unless given).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def make_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0] >> 1))
    return g


def _uniform(g, shape, device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _randint(g, shape, lo: int, hi: int, device) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32)


def _label(g, batch: int, device) -> torch.Tensor:
    return (_uniform(g, (batch,), device) < 0.25).float()


def ctr_batch(
    batch: int,
    n_dense: int,
    vocab_sizes: tuple[int, ...],
    seed: int = 0,
    step: int = 0,
    device=None,
) -> dict:
    dev = resolve_device(device)
    g = make_generator(seed, step, dev)
    vs = torch.tensor(vocab_sizes, dtype=torch.int32, device=dev)
    # zipf-ish skew: square a uniform to concentrate mass at low ids
    u = _uniform(g, (batch, len(vocab_sizes)), dev)
    out = {
        "sparse": (u * u * vs[None, :]).to(torch.int32),
        "label": _label(g, batch, dev),
    }
    if n_dense > 0:
        out["dense"] = torch.randn((batch, n_dense), generator=g, device=dev)
    return out


def _spec(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def ctr_input_specs(batch: int, n_dense: int, n_sparse: int) -> dict:
    """:func:`ctr_batch`'s shapes and dtypes as ``meta`` tensors."""
    out = {"sparse": _spec((batch, n_sparse)), "label": _spec((batch,), torch.float32)}
    if n_dense > 0:
        out["dense"] = _spec((batch, n_dense), torch.float32)
    return out


def bst_batch(
    batch: int, n_items: int, seq_len: int, n_other: int, field_vocab: int,
    seed: int = 0, step: int = 0, device=None,
) -> dict:
    dev = resolve_device(device)
    g = make_generator(seed, step, dev)
    return {
        "history": _randint(g, (batch, seq_len), 0, n_items, dev),
        "target": _randint(g, (batch,), 0, n_items, dev),
        "other": _randint(g, (batch, n_other), 0, field_vocab, dev),
        "label": _label(g, batch, dev),
    }


def bst_input_specs(batch: int, seq_len: int, n_other: int) -> dict:
    """:func:`bst_batch`'s shapes and dtypes as ``meta`` tensors."""
    return {
        "history": _spec((batch, seq_len)),
        "target": _spec((batch,)),
        "other": _spec((batch, n_other)),
        "label": _spec((batch,), torch.float32),
    }


def two_tower_batch(
    batch: int, n_users: int, n_items: int, n_user_fields: int, n_item_fields: int,
    field_vocab: int, hist_len: int, seed: int = 0, step: int = 0, device=None,
) -> dict:
    """``history`` ids are drawn from [−1, n_items): −1 is padding."""
    dev = resolve_device(device)
    g = make_generator(seed, step, dev)
    return {
        "user_id": _randint(g, (batch,), 0, n_users, dev),
        "user_fields": _randint(g, (batch, n_user_fields), 0, field_vocab, dev),
        "history": _randint(g, (batch, hist_len), -1, n_items, dev),
        "target": _randint(g, (batch,), 0, n_items, dev),
        "item_fields": _randint(g, (batch, n_item_fields), 0, field_vocab, dev),
        "logq": torch.log(_uniform(g, (batch,), dev, 1e-6, 1e-3)),
    }


def two_tower_input_specs(batch: int, n_user_fields: int, n_item_fields: int,
                          hist_len: int) -> dict:
    """:func:`two_tower_batch`'s shapes and dtypes as ``meta`` tensors."""
    return {
        "user_id": _spec((batch,)),
        "user_fields": _spec((batch, n_user_fields)),
        "history": _spec((batch, hist_len)),
        "target": _spec((batch,)),
        "item_fields": _spec((batch, n_item_fields)),
        "logq": _spec((batch,), torch.float32),
    }


# classic Criteo-Kaggle per-field vocabulary sizes (26 categorical fields)
CRITEO_VOCABS = (
    1460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145, 5_683,
    8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4, 7_046_547,
    18, 15, 286_181, 105, 142_572,
)


def avazu_like_vocabs(n_fields: int = 39, seed: int = 3) -> tuple[int, ...]:
    """Mixed small/large vocabularies for AutoInt's 39 fields."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_fields):
        r = rng.random()
        if r < 0.5:
            out.append(int(rng.integers(4, 1000)))
        elif r < 0.85:
            out.append(int(rng.integers(1000, 100_000)))
        else:
            out.append(int(rng.integers(100_000, 3_000_000)))
    return tuple(out)
