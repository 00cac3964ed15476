"""Train a small LM end to end with checkpointing and fault injection (port
of ``examples/train_lm.py``): a reduced SmolLM-family config (4 layers,
d_model 128, f32 compute), AdamW, a checkpoint every 50 steps in a
temporary directory, and a closing ``loss a -> b (OK: learning)`` line.

    python -m repro_torch.examples.train_lm [--steps 200] [--simulate-failure 70] \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.  The weights and batches
come from the port's seeded generators, not the reference's draws, so the
printed losses differ from the reference example's.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerConfig, loss_fn
from repro_torch.train.loop import LoopConfig, make_train_step, run
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def main(argv=None) -> list:
    """Train; returns the loop's history of (step, loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the state lives and the steps run (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    cfg = TransformerConfig(
        name="smollm-nano", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=384, vocab=2048, attn_chunk=64, tie_embeddings=True,
        compute_dtype=torch.float32,
    )
    print(f"model: {cfg.n_params()/1e6:.2f}M params")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    dc = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch)
    step_fn = make_train_step(lambda p, b: loss_fn(cfg, p, b), opt)

    def init_state():
        p = cfg.init(0, device)
        return p, init_opt_state(opt, p)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = LoopConfig(
            total_steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir,
            log_every=max(args.steps // 20, 1),
            simulate_failure_at=args.simulate_failure,
        )
        _, _, hist = run(loop, step_fn, init_state, lambda s: lm_batch(dc, s, device))
    first, last = hist[0][1], hist[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} ({'OK: learning' if last < first else 'WARN'})")
    return hist


if __name__ == "__main__":
    main()
