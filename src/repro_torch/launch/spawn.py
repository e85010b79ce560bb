"""Run one function on every rank of a fresh ``torch.distributed`` world.

:func:`run_ranks` starts ``world`` processes with the ``spawn`` method
(CUDA cannot be used after ``fork``), each of which joins the process
group through a file rendezvous (no TCP port, so concurrent worlds cannot
clash), runs ``fn(rank, world, *args)`` and sends back what it returns.
Every wait is bounded: the process group's ``timeout`` bounds each
collective, and the parent gives the whole world ``timeout`` seconds; on
any rank's failure, or when the time runs out, it kills every rank and
raises.  ``fn`` must be importable by name (a module-level function of
the package), and what it returns picklable (numpy arrays, not tensors).
``fn`` and ``args`` go to the ranks through a file in the rendezvous
directory: a spawned child reads its start-up pipe only after importing
its parent's main module, so a large payload there would start the ranks
one after another.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback


def _rank_main(payload: str, rank: int, world: int, init_method: str,
               backend: str, timeout: float, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        with open(payload, "rb") as f:          # written by run_ranks
            fn, args = pickle.load(f)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, *args, rdzv_dir, backend: str = "gloo",
              timeout: float = 120.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    their results in rank order.  ``rdzv_dir`` is an existing directory
    for the rendezvous file (a fresh one per world)."""
    path = os.path.join(os.fspath(rdzv_dir), "rendezvous")
    payload = os.path.join(os.fspath(rdzv_dir), "payload.pickle")
    if os.path.exists(path) or os.path.exists(payload):
        raise ValueError(f"{rdzv_dir} holds a world's files: give each world a "
                         "fresh directory")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(payload, r, world, f"file://{path}", backend,
                               timeout, out))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    results: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} ranks did "
                                   f"not finish in {timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})"
                                       ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:                # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5.0)
        out.close()
    return [results[r] for r in range(world)]
