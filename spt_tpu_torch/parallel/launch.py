"""Start and join a small world of ranks, and join a torchrun world.

``spawn(fn, world)`` runs ``fn(rank, world, *args)`` in `world` fresh
processes (the ``spawn`` start method), each a rank of a process group on a
``file://`` store with a timeout, as ``torchrun`` would give them one
(``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` are set; under NCCL rank r
renders on card r).  It returns each rank's result in rank order.  A rank
that raises, exits without a result, or a world that does not finish
within `timeout` seconds makes it kill every rank and raise.  ``fn`` must
be importable by name (a module-level function), since the children start
from a fresh interpreter.

``init_from_env(device)`` is what the entry points call: under ``torchrun``
(``WORLD_SIZE`` > 1) it joins the world's process group, NCCL on cards and
gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, NamedTuple

import torch
import torch.distributed as dist


class RankResult(NamedTuple):
    value: Any              # what fn returned on the rank
    init_seconds: float     # the rank's init_process_group


def init_from_env(device) -> bool:
    """Join the process group torchrun describes in the environment when it
    has more than one rank and none is up yet: NCCL when `device` is a card
    (rank LOCAL_RANK renders on card LOCAL_RANK), gloo on the CPU.  Returns
    whether it initialized the group (and so should destroy it)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def _child(fn, rank, world, args, backend, store, timeout, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        t0 = time.perf_counter()
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        init_s = time.perf_counter() - t0
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, RankResult(value, init_s)))
    except Exception:   # reported to the parent, which fails the world
        results.put((rank, traceback.format_exc(), None))
        raise


def _failures(world, errors, results, grace: float = 2.0) -> str:
    """The first failure's report, with the other ranks' failures that
    arrive within `grace` seconds (a rank that raises makes the ranks
    waiting for it fail in turn, and either may report first)."""
    end = time.monotonic() + grace
    while len(errors) < world and time.monotonic() < end:
        try:
            rank, err, _ = results.get(timeout=max(end - time.monotonic(),
                                                    0.01))
        except queue.Empty:
            break
        if err is not None:
            errors[rank] = err
    return "\n".join(f"rank {r} of {world} failed:\n{e}"
                     for r, e in sorted(errors.items()))


def spawn(fn, world: int, args=(), *, backend: str = "gloo",
          timeout: float = 120.0) -> list:
    """Run fn(rank, world, *args) on `world` ranks of a `backend` process
    group -> [RankResult] in rank order.  Raises RuntimeError naming the
    rank that failed, or TimeoutError; every rank is stopped either way."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="spt_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, world, tuple(args), backend, store,
                               timeout, results))
             for rank in range(world)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"a world of {world} ranks did not finish "
                                   f"within {timeout} s (ranks done: "
                                   f"{sorted(out)})")
            try:
                rank, err, res = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if gone:
                    # a result put just before exit may still be in flight
                    try:
                        rank, err, res = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} and no result") from None
                else:
                    continue
            if err is not None:
                raise RuntimeError(_failures(world, {rank: err}, results))
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        for rank, p in enumerate(procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {rank} exited with code "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
