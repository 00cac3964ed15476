"""Training launcher (port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch dcn-v2 --steps 20 [--device cpu]

Runs real training steps on one device (the reduced ``SMOKE`` config by
default; ``--full`` for the published one), with checkpointing
(``--ckpt-dir``, ``--ckpt-every``), fault injection
(``--simulate-failure STEP``: the loop restores the latest checkpoint and
replays, bit-identically) and deterministic data keyed by (seed, step).
``--device`` (default ``cuda``) is where the state lives and the steps
run; without CUDA the default raises and names the opt-in ``--device
cpu``.  The port trains the LM, GNN and recsys families.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_arch
from repro_torch.data.graph import full_graph_batch, make_powerlaw_graph
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import recsys_batch, recsys_loss
from repro_torch.models import egnn as egnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.train.loop import LoopConfig, make_train_step, run
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def loss_and_batch_fns(spec, cfg, batch_size: int, seq_len: int, seed: int, device):
    """(loss(params, batch), batch_fn(step)) for ``spec``'s family, the
    batches on ``device``.  ``seq_len`` is the LM family's."""
    if spec.family == "lm":
        dc = LMDataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch_size, seed=seed)
        return (lambda p, b: tf_lib.loss_fn(cfg, p, b),
                lambda step: lm_batch(dc, step, device))
    if spec.family == "gnn":  # one 512-node power-law graph, every step
        g = make_powerlaw_graph(512, 2048, cfg.d_feat, n_classes=max(cfg.n_classes, 1),
                                seed=seed, device=device)
        batch = full_graph_batch(g, edge_multiple=8, device=device)
        return (lambda p, b: egnn_lib.loss_fn(cfg, p, b), lambda step: batch)
    if spec.family == "recsys":
        return (recsys_loss(cfg),
                lambda step: recsys_batch(cfg, batch_size, device, seed, step))
    raise ValueError(spec.family)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true", help="use the full published config")
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the state lives and the steps run (cuda or cpu)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family == "geoweb":  # on any machine, before the device check
        raise SystemExit("geoweb is a serving system: use repro_torch.launch.serve")
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = spec.config if args.full else spec.smoke_config

    opt = OptimizerConfig(
        lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
        total_steps=args.steps,
    )
    loss_fn, batch_fn = loss_and_batch_fns(
        spec, cfg, args.batch_size, args.seq_len, args.seed, device
    )
    step_fn = make_train_step(loss_fn, opt, microbatches=args.microbatches)

    def init_state():
        params = cfg.init(args.seed, device)
        return params, init_opt_state(opt, params)

    loop = LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 20, 1),
        simulate_failure_at=args.simulate_failure,
    )
    run(loop, step_fn, init_state, batch_fn)


if __name__ == "__main__":
    main()
