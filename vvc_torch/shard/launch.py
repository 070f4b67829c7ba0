"""Run one function on N ranks: one spawned process per rank under
torch.distributed.

The multi-process stand-in for the single controller that drives a device
mesh: every rank calls the same function on the same arguments and works
on its own chunk (`vvc_torch.shard.mesh`).  It is how the tests get a
mesh of CPU ranks (gloo) and how one process drives several CUDA ranks.

    run_ranks(fn, world_size, backend, device, timeout_s, *args, **kwargs)

* ranks are started with the ``spawn`` context (never fork: CUDA may
  already be initialised in the caller) and meet through a file store;
* every process group gets ``timeout_s`` as its collective timeout, and
  the whole run must end within ``timeout_s`` too: a rank that fails, dies
  or overruns ends the run with an exception, and every rank still alive
  is terminated, so a fault never leaves a process blocked in a
  collective;
* ``device`` is ``"cpu"`` or ``"cuda"``.  A CUDA rank uses card
  ``rank % torch.cuda.device_count()`` (under NCCL every rank needs a card
  of its own; under gloo several ranks may share one);
* ``fn`` gets the rank's device as its ``device`` keyword;
* returns rank 0's result.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(rank, world_size, backend, device, store_path, timeout_s,
               threads, fn, args, kwargs, results):
    import torch
    import torch.distributed as dist
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        rank_device = "cpu"
        extra = {}
        if device == "cuda":
            card = rank % torch.cuda.device_count()
            torch.cuda.set_device(card)
            rank_device = f"cuda:{card}"
            if backend == "nccl":           # bind the communicator's card
                extra["device_id"] = torch.device(rank_device)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s), **extra)
        try:
            out = fn(*args, device=rank_device, **kwargs)
            results.put((rank, True, out if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, backend: str, device: str,
              timeout_s: float, *args, threads: int | None = None,
              **kwargs):
    """Call ``fn(*args, device=<the rank's device>, **kwargs)`` on
    ``world_size`` spawned ranks of one process group and return rank 0's
    result (the rank's device is ``"cpu"`` or ``"cuda:<card>"``).  ``fn``
    must be picklable (a module-level function).  ``threads``: torch's intra-op thread count in
    each rank (None leaves torch's default).  Raises RuntimeError if a rank
    raises, dies or has not finished within ``timeout_s`` seconds."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"run_ranks: unknown backend {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"run_ranks: device must be 'cpu' or 'cuda', "
                         f"not {device!r}")
    if backend == "nccl":
        import torch
        n_cards = torch.cuda.device_count() if device == "cuda" else 0
        if world_size > n_cards:
            raise ValueError(f"run_ranks: NCCL needs a card per rank "
                             f"({world_size} ranks, {n_cards} cards)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="vvc_torch_ranks_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, device, store_path,
                               timeout_s, threads, fn, args, kwargs,
                               results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    got = {}
    failure = None
    try:
        for p in procs:
            p.start()
        while len(got) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"ranks {sorted(set(range(world_size)) - set(got))}"
                           f" did not finish within {timeout_s} s")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    # a rank may have put its result just before exiting
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                else:
                    continue
            if not ok:
                failure = f"rank {rank} failed:\n{out}"
            got[rank] = out
        if failure is not None:
            # the others' errors follow the first one's (often a rank's
            # fault ends its peers' collectives): report them all
            grace = time.monotonic() + 2.0
            while time.monotonic() < grace:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                if not ok:
                    failure += f"\nrank {rank} failed:\n{out}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) + 10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks: {failure}")
    return got[0]
