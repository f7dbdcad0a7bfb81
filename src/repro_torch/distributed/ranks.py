"""Process groups on one host: spawned ranks under a deadline.

``spawn_ranks(fn, world, args, init_dir=...)`` starts ``world`` processes
(the ``spawn`` start method), joins them in one gloo group (NCCL refuses
two ranks on one card) through a rendezvous file in ``init_dir`` (no TCP
port), runs ``fn(rank, world, *args)`` in each, and returns the ranks'
results in rank order.  ``fn`` must be a module-level function and its
results picklable host values.  The distributed SSSP backend keeps
replicated state bitwise equal on every rank, so the ranks take the same
branches and match their collectives; a bug that breaks this would hang
one.  So the group's collectives time out after ``timeout`` seconds, and
the whole run has a ``deadline``: when it passes or a rank fails, every
rank still alive is killed and ``spawn_ranks`` raises.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback
import uuid


def _rank_main(fn, rank, world, init_file, timeout, args, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world: int, args=(), *, init_dir: str,
                timeout: float = 60.0, deadline: float = 300.0) -> list:
    """``[fn(r, world, *args) for r in range(world)]``, each rank in its
    own process of one gloo group (see the module docstring)."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(init_dir, f"rendezvous_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init_file, timeout, tuple(args),
                               out), daemon=True)
             for r in range(world)]
    end = time.monotonic() + deadline
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                late = sorted(set(range(world)) - set(results))
                dead = [r for r in late if procs[r].exitcode not in
                        (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} of {world} exited with codes "
                        f"{[procs[r].exitcode for r in dead]}") from None
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"ranks {late} of {world} gave no result within "
                        f"the {deadline:.0f} s deadline") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"a rank of {world} did not exit within "
                                   f"the {deadline:.0f} s deadline")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if os.path.exists(init_file):
            os.remove(init_file)
    return [results[r] for r in range(world)]
