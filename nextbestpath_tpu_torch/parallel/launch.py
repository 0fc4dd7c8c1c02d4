"""Run a function on several ranks of one machine, with a deadline.

The JAX package runs its mesh program in one process. Here a data-parallel
job is one process a rank: ``spawn`` starts ``n_ranks`` processes
(``torch.multiprocessing``, the spawn method), each of which starts the
process group (a ``file://`` rendezvous in a temporary directory, so no
port is taken and two jobs on one machine cannot meet), makes its mesh
(``parallel/mesh.py``) and calls ``fn(mesh, *args)``. ``fn`` must be a
module-level function of an importable module: spawn imports it by its
path in every rank.

Every job has a deadline. A rank that raises fails the job with its
traceback (the others are stopped). When one rank's failure makes others
fail (a peer's socket closes under a collective), the error names the
rank that failed first, with every failed rank's traceback after it. A
job still running at its deadline
is killed, and the stacks of its ranks, dumped just before, are in the
error. ``spawn`` returns each rank's return value (a host object, which is
pickled), in rank order.

CPU ranks start from a fork server that has imported torch, ``fn``'s
module and ``torch._dynamo`` (which an optimizer's first construction
imports) once for the calling process, so that a job of CPU ranks starts
in well under a second instead of re-importing them in every rank (a few
seconds a rank). The server is a fresh process with one thread that has
only imported modules, so forking it is safe. Card ranks start fresh
(the spawn method): a process that has touched the CUDA driver must not
fork.
"""

from __future__ import annotations

import datetime
import faulthandler
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException, start_processes

from .mesh import make_mesh
from .multihost import default_backend

KILL_GRACE_S = 0.5  # after the ranks' stack dumps, before the kill


def _rank_main(rank: int, fn: Callable, n_ranks: int, device: str,
               backend: str, tmp: str, args: Sequence, deadline: float,
               threads: Optional[int]) -> None:
    """A rank's body: the stack dump timer, the process group, the mesh,
    ``fn``, its result written for the parent."""
    stack_file = open(os.path.join(tmp, f"stack_{rank}.txt"), "w")
    faulthandler.dump_traceback_later(max(deadline - time.time(), 0.1),
                                      file=stack_file)
    if threads is not None:
        torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(seconds=max(deadline - time.time(),
                                                   1.0)))
        out = fn(make_mesh(n_ranks, device=device), *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    except BaseException:
        # The time of the failure first: the parent reports the earliest.
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()
        stack_file.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
    for p in ctx.processes:
        p.join(5)


def spawn(fn: Callable, n_ranks: int, device: str = "cuda",
          backend: Optional[str] = None, args: Sequence = (),
          timeout_s: float = 600.0) -> List[Any]:
    """``fn(mesh, *args)`` on ``n_ranks`` ranks of this machine; returns
    the ranks' results in rank order.

    device: "cuda" (NCCL: rank r on card r, which must exist; gloo: every
    rank on the current card, which the ranks then share), a card such as
    "cuda:0", or "cpu". backend: "nccl" or "gloo", by default NCCL on the
    card and gloo on the CPU; nothing picks gloo, or the CPU, on its own.
    timeout_s: the job's deadline, start-up included. A CPU rank runs one
    intra-op thread: the ranks share the cores. Raises RuntimeError when a rank fails, with its traceback, and
    TimeoutError at the deadline, with the ranks' stacks."""
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL ranks need a CUDA device")
    threads = 1 if dev.type == "cpu" else None
    if dev.type == "cpu":
        # Takes effect when the fork server starts (this process's first
        # CPU job).
        multiprocessing.set_forkserver_preload(
            ["torch", "torch._dynamo", fn.__module__])
    tmp = tempfile.mkdtemp(prefix="nbp_spawn_")
    deadline = time.time() + timeout_s
    try:
        ctx = start_processes(
            _rank_main, args=(fn, n_ranks, device, backend, tmp, tuple(args),
                              deadline, threads),
            nprocs=n_ranks, join=False,
            start_method="forkserver" if dev.type == "cpu" else "spawn")
        try:
            while not ctx.join(timeout=0.2, grace_period=KILL_GRACE_S):
                if time.time() > deadline + KILL_GRACE_S:
                    _stop(ctx)
                    stacks = "".join(
                        f"--- rank {r} ---\n{_read(tmp, f'stack_{r}.txt')}"
                        for r in range(n_ranks))
                    raise TimeoutError(
                        f"{fn.__module__}.{fn.__qualname__} on {n_ranks} "
                        f"ranks passed its {timeout_s:.0f} s deadline; the "
                        f"ranks were killed. Their stacks:\n{stacks}")
        except ProcessException as e:
            _stop(ctx)
            raise RuntimeError(_failure(fn, n_ranks, tmp, e)) from None
        return [_load(tmp, r) for r in range(n_ranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(fn: Callable, n_ranks: int, tmp: str,
             e: ProcessException) -> str:
    """The failed ranks' tracebacks, the earliest failure first (the
    others are often its consequence); the exception torch saw when no
    rank wrote its own (a rank killed by a signal)."""
    failed = []
    for r in range(n_ranks):
        try:
            with open(os.path.join(tmp, f"error_{r}.txt")) as f:
                t, tb = f.read().split("\n", 1)
            failed.append((float(t), r, tb))
        except (OSError, ValueError):
            pass
    name = f"{fn.__module__}.{fn.__qualname__}"
    if not failed:
        return f"{name} failed on rank {e.error_index} of {n_ranks}:\n{e}"
    failed.sort()
    return "".join(
        [f"{name} failed on rank {failed[0][1]} of {n_ranks} first:\n"]
        + [f"--- rank {r} ---\n{tb}" for _, r, tb in failed])


def _read(tmp: str, name: str) -> str:
    try:
        with open(os.path.join(tmp, name)) as f:
            return f.read() or "(no stack dumped)\n"
    except OSError:
        return "(the rank never started)\n"


def _load(tmp: str, rank: int) -> Any:
    # The file was written by this job's own rank (module docstring).
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
        return pickle.load(f)
