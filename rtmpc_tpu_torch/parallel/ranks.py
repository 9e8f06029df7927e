"""Rank processes on one host: ``spawn_ranks`` starts n ranks of a
``torch.distributed`` group with ``torch.multiprocessing`` and returns what
each rank's function returned.  The data-parallel dry run
(``entry.dryrun_multichip``), ``chip_smoke.py`` and the CPU tests launch
their ranks through it; ``sweep_rank`` is the rank function of a sharded
``run_mc_sweep``.

The ranks meet through a ``file://`` store in a fresh directory (no TCP
port to collide on), run one torch thread each, and have a deadline: a rank
that raises or exits makes ``spawn_ranks`` stop the others and raise, and
so does a run past its timeout.  No rank's failure is swallowed.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .distributed import (dp_group, gather_rows, initialize_from_env,
                          rank_device)

__all__ = ["spawn_ranks", "sweep_rank"]


def _rank_main(rank: int, world: int, backend: str, workdir: str,
               fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    store = os.path.join(workdir, "store")
    if not initialize_from_env(backend, init_method="file://" + store):
        raise RuntimeError(f"rank {rank}: no process group was initialised")
    try:
        out = fn(*args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _environ(**values):
    """The spawned interpreters inherit these (OpenMP reads its thread
    count when torch loads, before a rank's code runs)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spawn_ranks(fn: Callable, n: int, args: Sequence = (), *,
                backend: str = "gloo", timeout: float = 180.0,
                workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` in ``n`` spawned ranks joined in one process
    group of ``backend``; returns each rank's return value, in rank order.

    ``fn`` must be importable (a module-level function) and its arguments
    and result picklable.  Each rank sees ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE``, so ``rank_device()`` gives
    rank r the card ``r`` modulo the visible cards.  ``workdir`` holds the
    store and the results (default: a temporary directory, removed after).
    Raises ``torch.multiprocessing.ProcessRaisedException`` (or
    ``ProcessExitedException``) when a rank fails and ``TimeoutError`` when
    the ranks are not done within ``timeout`` seconds; the other ranks are
    stopped either way."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="rtmpc_ranks_") if own else workdir
    try:
        with _environ(OMP_NUM_THREADS="1"):
            ctx = mp.start_processes(
                _rank_main, args=(n, backend, workdir, fn, tuple(args)),
                nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn_ranks: {n} ranks of "
                                       f"{getattr(fn, '__name__', fn)} not "
                                       f"done within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def sweep_rank(jobs: Sequence[tuple], device: str = "cuda") -> list:
    """The rank function of sharded sweeps: for each job ``(setup,
    to_device_kwargs, sweep_kwargs)`` freezes ``setup`` on this rank's
    device and runs ``run_mc_sweep(..., group=dp_group())``.  Returns, a
    job, ``{"result", "launches", "wall_s", "gathers", "gather_s",
    "device"}``: the sweep's result, the ADMM kernel's launches in it, its
    host seconds, and its gathers and their host seconds."""
    from ..ops.qp_cuda import admm_solve_cuda
    from .mc import run_mc_sweep
    dev = rank_device(device)
    out = []
    for setup, to_device_kw, sweep_kw in jobs:
        arrays, cfg = setup.to_device(device=dev, **to_device_kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        admm_solve_cuda.launches = 0
        calls, seconds = gather_rows.calls, gather_rows.seconds
        t0 = time.perf_counter()
        res = run_mc_sweep(arrays, cfg, group=dp_group(), **sweep_kw)
        out.append(dict(result=res, launches=admm_solve_cuda.launches,
                        wall_s=time.perf_counter() - t0,
                        gathers=gather_rows.calls - calls,
                        gather_s=gather_rows.seconds - seconds,
                        device=str(dev)))
    return out
