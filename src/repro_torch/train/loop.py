"""Train-step factory and fault-tolerant training loop (port of
``repro/train/loop.py``).

``make_train_step(loss_fn, opt_cfg, microbatches, moment_shardings)``
builds ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)`` with optional gradient accumulation (microbatching); the AdamW
update writes params and moments in place (:func:`adamw_update`, ZeRO-1's
with ``moment_shardings`` on a process mesh).  Built under
``use_sharding(ProcessMesh)`` the step is data-parallel across the ranks
(:func:`make_train_step`), where the reference's SPMD step lets XLA reduce
the gradients over ``data``; with a ``model`` axis > 1 the LM is also
tensor-parallel over it (a MoE config's experts split over it too), each
rank holding its parameter blocks (the LMs' and the recsys models').

``run(...)`` checkpoints every N steps (atomic, async), and on a failure
(including an injected one) restores the latest checkpoint and replays —
the batches being keyed by (seed, step), the replay is bit-identical to an
uninterrupted run.  Given the state's shardings, every rank saves and
restores its own blocks of the global arrays.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core import collectives as col
from repro_torch.core.distributed import ProcessMesh
from repro_torch.sharding.specs import DEFAULT_RULES, get_context, use_sharding
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


def global_loss(loss_fn: Callable) -> Callable:
    """Mark ``loss_fn`` as computing, on every rank of a process mesh, the
    global loss of the batch it is given, its gradients already the global
    ones (EGNN's :func:`~repro_torch.models.egnn.make_sharded_loss` reduces
    them itself): the data-parallel step then neither splits the batch nor
    reduces the gradients.  Returns ``loss_fn``."""
    loss_fn.global_loss = True
    return loss_fn


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes a batch's leading dimension is split over: the rules'
    ``"batch"`` axes the mesh has (``pod``, ``data``)."""
    return tuple(a for a in DEFAULT_RULES["batch"] if a in mesh.axis_names)


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> (loss, metrics)
    opt_cfg: OptimizerConfig,
    microbatches: int = 1,
    moment_shardings=None,
):
    """The train step.  ``microbatches > 1`` splits every batch leaf along
    its leading dimension (as ``dynamic_slice_in_dim``), sums the gradients
    in f32, divides by the count and averages the loss (metrics then carry
    only ``loss``, ``grad_norm`` and ``lr``, as the reference's).
    ``moment_shardings`` goes to :func:`adamw_update`.

    Built under ``use_sharding(mesh)`` with a
    :class:`~repro_torch.core.distributed.ProcessMesh`, the step is
    data-parallel: every rank is given the global batch, cuts it into
    ``microbatches`` blocks as the reference's step does, and takes its
    rows of each (the block's leading dimension over :func:`batch_axes`,
    by its place there): the reference's microbatches-then-devices order,
    so a microbatch's rows across the ranks are the reference's
    microbatch.  The parameters enter the loss through
    :func:`~repro_torch.core.collectives.replicated`, whose backward adds
    the ranks' gradients of each microbatch from zero in rank order, and
    the step divides by ``microbatches · D`` (``D`` the batch shards); the
    losses are added the same way.  Those are the one-process
    ``microbatches=m·D`` step's operations, so a ``D``-rank step of a loss
    that is a mean of per-row terms (the dense LMs, the CTR models) equals
    it bitwise.  Two losses are statistics of the global batch, which they
    gather over the batch axes: a MoE config's aux loss
    (:mod:`~repro_torch.models.moe`) and the two-tower in-batch softmax,
    whose negatives are every row's target
    (:func:`~repro_torch.models.recsys.two_tower_loss`: the rank's loss is
    its rows' mean against the gathered targets, so the step's sum over
    ``D`` divided by ``D`` is the global mean, and so are its gradients).
    Each gathers over its microbatch's rows on every rank, so their
    ``D``-rank step equals the one-process step with the same
    ``microbatches`` within rounding.  A :func:`global_loss` is run on the
    batch as given.

    With a ``model`` axis > 1 the parameters are the rank's blocks and
    the loss is tensor-parallel over ``model`` (the LM's, its experts too,
    and the recsys models' tables, first MLP layers and attention heads,
    under the step's sharding context, which the step re-enters);
    ``moment_shardings`` must then be given, as they tell the update which
    leaves are blocks.

    The step's ``value_and_grad(params, batch)`` attribute is its gradient
    half: (loss, metrics, the reduced gradients) before the update.

    The reference's ``jit`` and ``donate`` have no counterpart: the step
    runs eagerly, and it updates params and moments in place, which is what
    donation buys."""
    ctx = get_context()
    if isinstance(ctx.mesh, ProcessMesh):
        grads_of = _data_parallel_grads(ctx.mesh, loss_fn, microbatches, moment_shardings)
    else:
        def grads_of(params, batch):
            if microbatches == 1:
                return value_and_grad(loss_fn, params, batch)
            loss, grads = _mean_over_microbatches(loss_fn, params, batch, microbatches,
                                                  microbatches)
            return loss, {}, grads

    def step(params, opt_state, batch):
        with use_sharding(ctx.mesh, ctx.rules):
            loss, metrics, grads = grads_of(params, batch)
            params, opt_state, opt_metrics = adamw_update(opt_cfg, grads, params, opt_state,
                                                          moment_shardings)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    def value_and_grad_of(params, batch):
        with use_sharding(ctx.mesh, ctx.rules):
            return grads_of(params, batch)

    step.value_and_grad = value_and_grad_of
    return step


def _microbatch(batch, n: int, i: int):
    """Block ``i`` of ``n`` along every leaf's leading dimension (the
    remainder rows, as ``dynamic_slice_in_dim``'s, in none)."""
    return tree_map(lambda x: x.narrow(0, i * (x.shape[0] // n), x.shape[0] // n), batch)


def _mean_over_microbatches(loss_fn, params, batch, n: int, count: int,
                            reduce=lambda loss: loss, rows=lambda mb: mb):
    """(loss, grads) over ``n`` microbatches (each through ``rows``): the
    gradients summed in f32 from zero, the losses (each through
    ``reduce``) likewise, both divided by ``count``."""
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
    for i in range(n):
        l, _, g = value_and_grad(loss_fn, params, rows(_microbatch(batch, n, i)))
        for acc, gi in zip(leaves(grads), leaves(g)):
            acc.add_(gi)
        loss_sum = loss_sum + reduce(l)
    for acc in leaves(grads):
        acc.div_(count)
    return loss_sum / count, grads


def _data_parallel_grads(mesh: ProcessMesh, loss_fn, microbatches, moment_shardings):
    """:func:`make_train_step`'s gradients across the ranks of ``mesh``."""
    if mesh.shape.get("model", 1) > 1 and moment_shardings is None:
        raise ValueError(f"a step on {mesh.shape} splits the parameters over model: give "
                         "it their moment_shardings (launch.steps.moment_shardings)")
    axes = batch_axes(mesh)
    D = col.group_size(mesh, axes)
    shard = mesh.group(axes, mesh.rank).index(mesh.rank)
    is_global = getattr(loss_fn, "global_loss", False)
    if is_global and microbatches != 1:
        raise ValueError("a global loss takes the batch whole: microbatches must be 1")

    def local_loss(params, batch):
        return loss_fn(col.replicated(mesh, params, axes)[0], batch)

    def grads_of(params, batch):
        if is_global:
            return value_and_grad(loss_fn, params, batch)
        for x in leaves(batch):
            if (x.shape[0] // microbatches) % D:
                raise ValueError(f"a batch of {x.shape[0]} rows in {microbatches} microbatches "
                                 f"does not split over the {D} batch shards of {mesh.shape}")
        loss, grads = _mean_over_microbatches(
            local_loss, params, batch, microbatches, microbatches * D,
            lambda l: col.psum(mesh, [l], axes)[0], lambda mb: _microbatch(mb, D, shard))
        return loss, {}, grads

    return grads_of


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
    *,
    barrier: Callable[[], None] | None = None,
    shardings=None,
):
    """Fault-tolerant loop.  Returns (params, opt_state, history).  The
    step updates the state in place, so each restore rebinds it to the
    restored tensors.

    Across ranks (the data-parallel step) every rank runs the loop with
    the state's ``shardings`` (a tree like ``(params, opt_state)`` on the
    process mesh: ``launch.steps.state_shardings``): every rank takes part
    in each save, which gathers the blocks into the global arrays (written
    by the mesh's rank 0), and each restore gives every rank its own blocks
    of them (ZeRO-1's moments, the ``model`` blocks).  After a fault
    ``barrier`` (every rank's) runs once the last save has landed, so that
    all ranks restore the same step."""
    params, opt_state = init_state()
    start = 0
    if loop_cfg.ckpt_dir:
        latest = ckpt_lib.latest_checkpoint(loop_cfg.ckpt_dir)
        if latest is not None and ckpt_lib.verify_checkpoint(loop_cfg.ckpt_dir, latest):
            log(f"[restore] resuming from step {latest}")
            params, opt_state = ckpt_lib.restore_checkpoint(
                loop_cfg.ckpt_dir, latest, (params, opt_state), shardings
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
                    async_=loop_cfg.ckpt_async, keep=loop_cfg.ckpt_keep, shardings=shardings,
                )
        except Exception as e:  # fault path: restore + replay
            log(f"[fault] {e!r}")
            if not loop_cfg.ckpt_dir:
                raise
            if pending is not None:
                pending.join()
                pending = None
            if barrier is not None:
                barrier()
            latest = ckpt_lib.latest_checkpoint(loop_cfg.ckpt_dir)
            if latest is None:
                log("[fault] no checkpoint — restarting from scratch")
                params, opt_state = init_state()
                step = 0
            else:
                log(f"[fault] restoring step {latest}")
                params, opt_state = ckpt_lib.restore_checkpoint(
                    loop_cfg.ckpt_dir, latest, (params, opt_state), shardings
                )
                step = latest
    if pending is not None:
        pending.join()
    return params, opt_state, history
