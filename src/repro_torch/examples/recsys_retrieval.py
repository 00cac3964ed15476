"""Geo-constrained two-tower retrieval (port of
``examples/recsys_retrieval.py``) — the paper's ranking function with a
learned text score: train a small two-tower model with in-batch sampled
softmax, then score a candidate corpus with dot-product + geo_score (the
hand-written kernel on the card, one launch) and compare plain vs
geo-constrained top-k.

    python -m repro_torch.examples.recsys_retrieval [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  The weights and batches
come from the port's seeded generators, not the reference's draws, so the
printed losses and ids differ from the reference example's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.recsys import two_tower_batch
from repro_torch.device import resolve_device
from repro_torch.models.recsys import (
    TwoTowerConfig, two_tower_loss, two_tower_score_candidates,
)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

Q_RECT = (0.3, 0.3, 0.5, 0.5)


def main(device=None) -> dict:
    """Train, then rank.  Returns ``losses`` (one per step), ``plain`` and
    ``geo`` (the top-10 candidate ids), ``inside`` (how many geo top-10
    candidates overlap the query area), the candidates' ``cand_rects``
    (numpy) and ``geo_inputs``, the geo dict the ranking was given."""
    dev = resolve_device(device)
    cfg = TwoTowerConfig(
        name="two-tower-mini", embed_dim=32, tower_dims=(128, 64),
        n_users=5000, n_items=2000, n_user_fields=2, n_item_fields=2,
        field_vocab=200, hist_len=8, feat_dim=16,
    )
    params = cfg.init(0, dev)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    step = make_train_step(lambda p, b: two_tower_loss(cfg, p, b), opt)
    state = init_opt_state(opt, params)
    print("training two-tower with in-batch sampled softmax …")
    losses = []
    for s in range(100):
        batch = two_tower_batch(64, cfg.n_users, cfg.n_items, cfg.n_user_fields,
                                cfg.n_item_fields, cfg.field_vocab, cfg.hist_len,
                                seed=0, step=s, device=dev)
        params, state, m = step(params, state, batch)
        losses.append(m["loss"])
        if s % 25 == 0:
            print(f"  step {s:3d} loss {float(m['loss']):.4f}")
    losses = torch.stack(losses).tolist()

    # candidate corpus with geographic footprints
    rng = np.random.default_rng(1)
    Nc = 1024
    cand_ids = (torch.arange(Nc, device=dev) % cfg.n_items).to(torch.int32)
    cand_fields = torch.from_numpy(
        rng.integers(0, cfg.field_vocab, (Nc, 2)).astype(np.int32)).to(dev)
    lo = rng.uniform(0, 0.9, (Nc, 1, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + np.float32(0.08)], axis=2)
    cand_rects = torch.from_numpy(rects).to(dev)
    cand_amps = torch.ones((Nc, 1), device=dev)

    user = two_tower_batch(1, cfg.n_users, cfg.n_items, cfg.n_user_fields,
                           cfg.n_item_fields, cfg.field_vocab, cfg.hist_len,
                           seed=9, step=0, device=dev)
    _, plain_i = two_tower_score_candidates(cfg, params, user, cand_ids, cand_fields, top_k=10)
    geo = {
        "cand_rects": cand_rects, "cand_amps": cand_amps,
        "q_rects": torch.tensor([Q_RECT], dtype=torch.float32, device=dev),
        "q_amps": torch.ones((1,), device=dev), "weight": 5.0,
    }
    _, geo_i = two_tower_score_candidates(cfg, params, user, cand_ids, cand_fields,
                                          top_k=10, geo=geo)
    plain, geo_ids = plain_i[0].tolist(), geo_i[0].tolist()
    print("\nplain top-10 candidates:   ", plain)
    print("geo-constrained top-10:    ", geo_ids)
    x0, y0, x1, y1 = Q_RECT
    inside = sum(1 for i in geo_ids if rects[i, 0, 0] < x1 and rects[i, 0, 2] > x0
                 and rects[i, 0, 1] < y1 and rects[i, 0, 3] > y0)
    print(f"geo-constrained results overlapping query area: {inside}/10")
    return {"losses": losses, "plain": plain, "geo": geo_ids, "inside": inside,
            "cand_rects": rects, "geo_inputs": geo}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(None if args.device == "cuda" else args.device)
