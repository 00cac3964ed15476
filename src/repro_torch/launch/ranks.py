"""Start the ranks of a ``torch.distributed`` process group on this host and
collect what each returns.

    from repro_torch.launch.ranks import run_ranks

    def work(rank, corpus_seed):          # importable by its module path
        mesh = make_process_mesh((4, 1), ("data", "model"), device="cpu")
        ...
        return host_numbers               # pickled back to the caller

    outs = run_ranks(work, 4, args=(0,), backend="gloo", timeout_s=120)

Each rank is a process of the ``spawn`` start method (the caller may hold a
CUDA context, which a forked child cannot use) that initialises the default
process group (``init_method``: ``file://`` in a fresh temporary directory
unless a ``file://`` or ``tcp://127.0.0.1:<port>`` address is given) with a
collective timeout, runs ``fn(rank, *args)`` and sends its result back
pickled, so it returns host objects (numpy, numbers), not tensors.

``gloo`` runs several ranks on the CPU or on one card; ``nccl`` needs one
card per rank (on a host with one card: world size 1).  The first rank that
raises, exits without a result or outlives ``timeout_s`` ends the run: the
other ranks' reports are read for a moment (a rank waiting on a failed one
fails too), every rank still running is killed, and :class:`RuntimeError`
names each failed rank with its traceback.  So a rank waiting in a
collective cannot hang the caller.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

BACKENDS = ("gloo", "nccl")
# after a rank fails, how long the other ranks' reports are awaited
_SETTLE_S = 2.0


def _rank_main(rank, world_size, backend, init_method, timeout_s, fn, args, results) -> None:
    """A rank's process: join the group, run ``fn``, report, leave.  The
    report goes out before the group is torn down, so a failing rank's
    traceback precedes the errors its peers then see."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    dist = None
    try:
        import torch.distributed as dist

        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timedelta(seconds=timeout_s))
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except Exception:  # the boundary: report the traceback to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn,
    world_size: int,
    args: tuple = (),
    *,
    backend: str = "gloo",
    init_method: str | None = None,
    timeout_s: float = 300.0,
) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks; their results in
    rank order.  Raises :class:`RuntimeError` if any rank fails or the run
    outlives ``timeout_s`` (every process it started is stopped first)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="ranks-")
        init_method = f"file://{os.path.join(tmp, 'init')}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            rank, world_size, backend, init_method, timeout_s, fn, args, results))
        for rank in range(world_size)
    ]
    done: dict[int, bytes] = {}
    failed: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    settle = None  # after a failure: until when the others' reports are read
    try:
        for p in procs:
            p.start()
        while len(done) + len(failed) < world_size:
            now = time.monotonic()
            if settle is not None and now >= settle:
                break
            if now >= deadline:
                for r in range(world_size):
                    if r not in done and r not in failed:
                        failed[r] = f"no result within {timeout_s:g} s"
                break
            try:
                rank, ok, payload = results.get(timeout=min(0.5, (settle or deadline) - now))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in done and r not in failed and p.exitcode not in (None, 0):
                        failed[r] = f"exited with code {p.exitcode} and no result"
                        settle = settle or now + _SETTLE_S
                continue
            if ok:
                done[rank] = payload
            else:
                # a rank's failure makes the ranks waiting on it fail too:
                # read their reports briefly, then stop them all
                failed[rank] = payload
                settle = settle or now + _SETTLE_S
    finally:
        if len(done) < world_size:  # a failure, or the caller interrupted
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
            if p.is_alive():  # stuck after its result (a group's teardown)
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError(f"run_ranks ({backend}, {world_size} ranks): " + "".join(
            f"\nrank {r} failed: {failed[r]}" for r in sorted(failed)))
    return [pickle.loads(done[r]) for r in range(world_size)]
