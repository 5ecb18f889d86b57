"""Start the ranks of a multi-process run (a helper of the port's own; the
reference's ranks are a device mesh inside one process).

`run_ranks(fn, world_size, device)` spawns world_size processes, each of
which joins one process group on a file store (NCCL on the card, one card a
rank; gloo on the CPU), calls fn(mesh, *args) with its rank's
dist/sharding.py Mesh and sends back what fn returns. Every rank and the
group get a timeout; a rank that raises or dies fails the call with its
traceback, and a rank that hangs fails it when the timeout runs out, the
other ranks terminated. The tests (gloo CPU ranks), chip_smoke.py (one
process a card) and entry.dryrun_multichip share it; `init_rank` joins a
group in the calling process.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device


def init_rank(rank, world_size, device, init_method, timeout_s=120):
    """Join the process group as `rank` of `world_size` and return this
    rank's Mesh: NCCL for a CUDA device (cuda:<rank> where `device` names
    no index), gloo for the CPU. A group that cannot start raises."""
    from .sharding import make_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", rank if dev.index is None else dev.index))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"ranks run on cuda or cpu, not {dev}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(world_size, dev)


def _rank_main(rank, world_size, device, init_method, timeout_s, fn, args, results):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        mesh = init_rank(rank, world_size, device, init_method, timeout_s)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:           # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size, device="cpu", timeout_s=120, args=()):
    """fn(mesh, *args) on world_size spawned ranks; returns their results in
    rank order. fn and args must pickle (a module-level function). Raises
    RuntimeError with a rank's traceback if it fails or dies, TimeoutError
    if the ranks have not all finished within timeout_s seconds."""
    if torch.device(device).type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} cards; "
                         f"{torch.cuda.device_count()} found")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="grail_ranks_")
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, str(device), init_method, timeout_s, fn,
                               args, results))
             for r in range(world_size)]
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"did not finish within {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
