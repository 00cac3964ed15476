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

Started as ``WORLD_SIZE`` > 1 ranks of a process group (``torchrun``, or
``main(argv)`` from each rank of
:func:`repro_torch.launch.ranks.run_ranks`), the launcher builds the
``(n / M, M)`` data × model :class:`~repro_torch.core.distributed.ProcessMesh`
(``--model-parallel M``, default 1: the ``(n, 1)`` mesh, as the reference's
``make_host_mesh`` builds its mesh of the host's devices), and trains
data-parallel (:func:`~repro_torch.train.loop.make_train_step` under
``use_sharding(mesh)``): every rank draws the global batch and steps on its
rows, with ZeRO-1's moment blocks; the gnn family runs EGNN's sharded loss
on the rank's rows of the graph.  With M > 1 the lm family is also
tensor-parallel: each rank holds its ``param_specs`` blocks, and attention
runs head-parallel where both head counts divide M and sequence-parallel
otherwise (the Qwen2.5 configs' 5 / 1 and 40 / 8 heads); a MoE arch's
experts split over M too, and a leaf that M does not divide stays whole
on every rank, as the reference's ``logical_spec`` keeps it (any M:
``--model-parallel 3``).  The recsys family takes M too: each rank holds
its blocks of the embedding tables' rows, the first MLP layers' columns
and the attention heads (``models.recsys``).  Where the data axis is > 1
a MoE arch's aux loss and the two-tower in-batch softmax are the global
batch's (with ``--microbatches`` m, each microbatch's: a rank steps on its
rows of each of the global batch's m blocks, as the reference's step cuts
them).  Every
rank takes part in a checkpoint (the blocks gathered into global arrays);
rank 0 alone logs and writes the files.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os

import torch.distributed as dist

from repro_torch.configs.base import get_arch
from repro_torch.core import collectives as col
from repro_torch.core.distributed import make_process_mesh
from repro_torch.data.graph import full_graph_batch, make_powerlaw_graph
from repro_torch.data.lm import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (
    moment_shardings,
    pad_rows,
    recsys_batch,
    recsys_loss,
    state_shardings,
)
from repro_torch.models import egnn as egnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.sharding.specs import use_sharding
from repro_torch.train.loop import LoopConfig, make_train_step, run
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def loss_and_batch_fns(spec, cfg, batch_size: int, seq_len: int, seed: int, device, mesh=None):
    """(loss(params, batch), batch_fn(step)) for ``spec``'s family, the
    batches on ``device``.  ``seq_len`` is the LM family's.  On a process
    ``mesh`` the gnn family's loss is EGNN's sharded one and its batch the
    rank's rows (the graph padded to divide over the mesh)."""
    if spec.family == "lm":
        dc = LMDataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch_size, seed=seed)
        return (lambda p, b: tf_lib.loss_fn(cfg, p, b),
                lambda step: lm_batch(dc, step, device))
    if spec.family == "gnn":  # one 512-node power-law graph, every step
        g = make_powerlaw_graph(512, 2048, cfg.d_feat, n_classes=max(cfg.n_classes, 1),
                                seed=seed, device=device)
        if mesh is None:
            batch = full_graph_batch(g, edge_multiple=8, device=device)
            return (lambda p, b: egnn_lib.loss_fn(cfg, p, b), lambda step: batch)
        axes = egnn_lib.sharded_axes(mesh)
        n = col.group_size(mesh, axes)
        batch = full_graph_batch(g, edge_multiple=math.lcm(8, n), device=device)
        batch = pad_rows(batch, -(-g.n_nodes // n) * n, egnn_lib.NODE_KEYS, {"labels": -1})
        rows = egnn_lib.graph_rows(batch, n, mesh.group(axes, mesh.rank).index(mesh.rank))
        return egnn_lib.make_sharded_loss(cfg, mesh), lambda step: rows
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis across WORLD_SIZE ranks (the lm and recsys families)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family == "geoweb":  # on any machine, before the device check
        raise SystemExit("geoweb is a serving system: use repro_torch.launch.serve")
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = spec.config if args.full else spec.smoke_config
    if args.model_parallel > 1 and spec.family not in ("lm", "recsys"):
        raise SystemExit(f"--model-parallel: the {spec.family} family trains data-parallel only")
    mesh = _process_mesh(device, args.model_parallel)
    if mesh is not None:
        device = mesh.device
    rank0 = mesh is None or mesh.rank == 0

    opt = OptimizerConfig(
        lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
        total_steps=args.steps,
    )
    ms = shardings = None
    if mesh is not None:  # ZeRO-1 across the ranks, checkpointed as global arrays
        opt = dataclasses.replace(opt, zero1=True)
        ms = moment_shardings(cfg.param_defs(), mesh)
        shardings = state_shardings(cfg.param_defs(), mesh)
    loss_fn, batch_fn = loss_and_batch_fns(
        spec, cfg, args.batch_size, args.seq_len, args.seed, device, mesh
    )
    with use_sharding(mesh):
        step_fn = make_train_step(loss_fn, opt, microbatches=args.microbatches,
                                  moment_shardings=ms)

    def init_state():
        tp = mesh is not None and mesh.shape["model"] > 1
        params = cfg.init(args.seed, device, mesh) if tp else cfg.init(args.seed, device)
        return params, init_opt_state(opt, params, ms)

    loop = LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 20, 1),
        simulate_failure_at=args.simulate_failure,
    )
    run(loop, step_fn, init_state, batch_fn, log=print if rank0 else lambda line: None,
        barrier=None if mesh is None else dist.barrier, shardings=shardings)


def _process_mesh(device, model: int = 1):
    """The ``(n / model, model)`` data × model process mesh when
    ``WORLD_SIZE`` > 1 (the default group initialised from the environment
    if it is not yet: gloo on the CPU, nccl on cards), else None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        if model > 1:
            raise SystemExit(f"--model-parallel {model} needs WORLD_SIZE ranks, got {world}")
        return None
    if world % model:
        raise SystemExit(f"--model-parallel {model} does not divide WORLD_SIZE {world}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_process_mesh((world // model, model), ("data", "model"),
                             device=None if device.type == "cuda" else device)


if __name__ == "__main__":
    main()
