"""Train-step factory and fault-tolerant training loop (port of
``repro/train/loop.py``).

``make_train_step(loss_fn, opt_cfg, microbatches)`` builds
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
with optional gradient accumulation (microbatching); the AdamW update
writes params and moments in place (:func:`adamw_update`).

``run(...)`` checkpoints every N steps (atomic, async), and on a failure
(including an injected one) restores the latest checkpoint and replays —
the batches being keyed by (seed, step), the replay is bit-identical to an
uninterrupted run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import OptimizerConfig, adamw_update
from repro_torch.train.tree import leaves, tree_map, unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` by ``torch.autograd``:
    (loss, metrics, grads), detached, grads in ``params``' structure (zeros
    for a leaf the loss does not reach)."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, list(grads)))


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> (loss, metrics)
    opt_cfg: OptimizerConfig,
    microbatches: int = 1,
):
    """The train step.  ``microbatches > 1`` splits every batch leaf along
    its leading dimension (as ``dynamic_slice_in_dim``), sums the gradients
    in f32, divides by the count and averages the loss (metrics then carry
    only ``loss``, ``grad_norm`` and ``lr``, as the reference's).

    The reference's ``jit`` and ``donate`` have no counterpart: the step
    runs eagerly, and it updates params and moments in place, which is what
    donation buys.  Its ``moment_shardings`` (ZeRO-1) waits for the mesh
    across cards."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(microbatches):
                mb = tree_map(lambda x: x.narrow(0, i * (x.shape[0] // microbatches),
                                                 x.shape[0] // microbatches), batch)
                l, _, g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                loss_sum = loss_sum + l
            for acc in leaves(grads):
                acc.div_(microbatches)
            loss = loss_sum / microbatches
            metrics = {}
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads, params, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10
    simulate_failure_at: int | None = None  # fault-injection for tests


def run(
    loop_cfg: LoopConfig,
    train_step,
    init_state: Callable[[], tuple],  # () -> (params, opt_state)
    batch_fn: Callable[[int], Any],  # step -> batch (deterministic)
    log: Callable[[str], None] = print,
):
    """Fault-tolerant loop.  Returns (params, opt_state, history).  The
    step updates the state in place, so each restore rebinds it to the
    restored tensors."""
    params, opt_state = init_state()
    start = 0
    if loop_cfg.ckpt_dir:
        latest = ckpt_lib.latest_checkpoint(loop_cfg.ckpt_dir)
        if latest is not None and ckpt_lib.verify_checkpoint(loop_cfg.ckpt_dir, latest):
            log(f"[restore] resuming from step {latest}")
            params, opt_state = ckpt_lib.restore_checkpoint(
                loop_cfg.ckpt_dir, latest, (params, opt_state)
            )
            start = latest

    history = []
    pending = None
    step = start
    failed_once = False
    while step < loop_cfg.total_steps:
        try:
            if loop_cfg.simulate_failure_at is not None and step == loop_cfg.simulate_failure_at and not failed_once:
                failed_once = True
                raise RuntimeError(f"injected failure at step {step}")
            batch = batch_fn(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            if step % loop_cfg.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                history.append((step, loss))
                log(f"step {step:5d}  loss {loss:.4f}  ({dt*1e3:.0f} ms)")
            step += 1
            if loop_cfg.ckpt_dir and step % loop_cfg.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = ckpt_lib.save_checkpoint(
                    loop_cfg.ckpt_dir, step, (params, opt_state),
                    async_=loop_cfg.ckpt_async, keep=loop_cfg.ckpt_keep,
                )
        except Exception as e:  # fault path: restore + replay
            log(f"[fault] {e!r}")
            if not loop_cfg.ckpt_dir:
                raise
            if pending is not None:
                pending.join()
                pending = None
            latest = ckpt_lib.latest_checkpoint(loop_cfg.ckpt_dir)
            if latest is None:
                log("[fault] no checkpoint — restarting from scratch")
                params, opt_state = init_state()
                step = 0
            else:
                log(f"[fault] restoring step {latest}")
                params, opt_state = ckpt_lib.restore_checkpoint(
                    loop_cfg.ckpt_dir, latest, (params, opt_state)
                )
                step = latest
    if pending is not None:
        pending.join()
    return params, opt_state, history
