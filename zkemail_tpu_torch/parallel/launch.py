"""One process per rank: the launcher of the port's meshes.

The JAX package drives every device of a mesh from one controller; PyTorch
drives one device per process. ``spawn`` starts ``world_size`` processes
(the spawn start method), gives each a process group and runs
``fn(rank, world_size, *args)`` in each:

  * the rendezvous is a file in a fresh temporary directory
    (``file://``), so concurrent runs, such as test workers, never meet on
    a port;
  * under NCCL rank r runs on ``cuda:r``; under gloo a rank runs on
    ``cuda:(r % cards)`` where there is a card (ranks may share one), and
    CPU work takes one thread per rank;
  * results come back through a queue, in rank order; any rank's exception
    is raised in the caller with that rank's traceback;
  * one deadline covers the run and every collective's timeout: when it
    passes, or a rank fails or dies, every child is killed, so a hung
    collective fails the caller instead of hanging it.

``fn`` and ``args`` are pickled once to a file the children read (through
the start pipe, a large job would keep each ``start`` waiting for its child
to import its modules, one child after another): ``fn`` must be a function
at module level of a module the children can import without JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(job_path: str, rank: int, world_size: int, backend: str, init_method: str,
               timeout_s: float, results) -> None:
    try:
        with open(job_path, "rb") as f:
            fn, args = pickle.load(f)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
            if torch.cuda.is_available():
                torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
            results.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, backend: str = "gloo", args: tuple = (),
          timeout_s: float = 600.0) -> list:
    """Run fn(rank, world_size, *args) on world_size ranks of a new process
    group over `backend` ("gloo" or "nccl"); returns the ranks' results in
    rank order. Raises RuntimeError when a rank fails or dies, and
    TimeoutError when the run outlasts timeout_s; no child outlives the
    call."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"NCCL needs one card per rank: {world_size} ranks, "
                         f"{torch.cuda.device_count()} cards")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory(prefix="zk_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(job_path, r, world_size, backend, init, timeout_s, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        done = False
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
                got[rank] = payload
            done = True
        finally:
            for p in procs:
                p.join(timeout=30 if done else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]
