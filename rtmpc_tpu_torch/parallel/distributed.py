"""Data-parallel launch path on ``torch.distributed`` (counterpart of
``rtmpc_tpu/parallel/distributed.py``).

The Monte-Carlo batch is the system's one parallel axis: the QPs are
small, so there is no model axis to split.  Every rank runs the same
program on its contiguous slice of the batch rows, and the ranks talk only
at start-up and when the results are gathered.

* ``initialize_from_env()``: a guarded ``torch.distributed``
  initialisation from the arguments or torchrun's variables
  (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``); a single process with nothing to coordinate is a no-op.
* ``rank_device()``: this rank's card, ``cuda:{LOCAL_RANK}`` modulo the
  visible cards.
* ``dp_group()``: the 1-D data-parallel group over every rank (None when
  the run is one process, so that ``run_mc_sweep(group=dp_group())`` is the
  one-process sweep there).
* ``shard_rows(n)`` / ``gather_rows(t, n)``: this rank's rows of n, and the
  full ``(n, ...)`` result on every rank.

Launch on one host with N cards::

    torchrun --nproc_per_node=N script.py
    # script.py: initialize_from_env(); dev = rank_device(); ...
    #            run_mc_sweep(..., group=dp_group())

**The gather runs on the host, through gloo.**  ``gather_rows`` copies a
rank's rows to host memory, pads them to ``ceil(n / world)`` rows,
``all_gather``s them over a gloo group (created beside the default group
when that one is NCCL's) and trims the padding.  Gloo does not
``all_gather`` CUDA tensors, and the sweep copies its results to numpy
anyway, so a gather through NCCL would only add a device copy.  Each
sweep gathers once a chunk: the traffic is the results, never the inputs
(every rank holds the same draws and slices them).
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_from_env", "is_distributed", "rank_device",
           "dp_group", "shard_rows", "gather_rows"]

# The gloo group that gathers for each process group whose backend is not
# gloo (the group itself where it is): made once, by every rank at the same
# call, since creating a group is a collective.
_HOST_GROUPS: dict = {}


def is_distributed() -> bool:
    """True once a process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` modulo the visible cards,
    or the CPU where the caller asks for it.  Raises where ``device`` is
    ``"cuda"`` and there is no card (there is no quiet fallback)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no CUDA device is visible; pass "
                           "device='cpu' to run on the CPU")
    local = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_from_env(backend: Optional[str] = None,
                        init_method: Optional[str] = None,
                        world_size: Optional[int] = None,
                        rank: Optional[int] = None) -> bool:
    """Guarded ``torch.distributed.init_process_group``.

    Each field resolves to the argument, else torchrun's variables:
    ``init_method`` to ``"env://"`` where ``MASTER_ADDR`` and
    ``MASTER_PORT`` are set, ``world_size`` to ``WORLD_SIZE``, ``rank`` to
    ``RANK``.  ``backend`` defaults to ``"nccl"`` where each rank of this
    host has a card of its own (``LOCAL_WORLD_SIZE``, else the world size,
    at most the visible cards) and to ``"gloo"`` otherwise; an explicit
    ``backend`` wins (``"gloo"`` for several ranks on one card).

    Returns True when a process group is initialised, False when there is
    nothing to coordinate (no coordinator and at most one process).  Raises
    ``ValueError`` for several processes without a coordinator.  A second
    call does nothing."""
    if is_distributed():
        return True
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = _env_int("RANK") if rank is None else rank
    if init_method is None:
        if world_size is None or world_size == 1:
            return False
        raise ValueError(
            f"WORLD_SIZE={world_size} but no coordinator: set MASTER_ADDR "
            "and MASTER_PORT on every process (torchrun does) or pass "
            "init_method")
    if world_size is None or rank is None:
        raise ValueError("initialize_from_env: a coordinator needs the "
                         "world size and this process's rank (WORLD_SIZE, "
                         "RANK, or the arguments)")
    if backend is None:
        local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
        own_card = (torch.cuda.is_available() and dist.is_nccl_available()
                    and local_world <= torch.cuda.device_count())
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def dp_group():
    """The data-parallel group over every rank, or None in a one-process
    run (no process group, or a world of one)."""
    if not is_distributed() or dist.get_world_size() == 1:
        return None
    return dist.group.WORLD


def _world(group) -> tuple:
    return dist.get_world_size(group), dist.get_rank(group)


def shard_rows(n: int, group=None) -> slice:
    """This rank's contiguous slice of ``n`` batch rows: ``ceil(n /
    world)`` rows a rank, so the last ranks may hold fewer or none."""
    world, rank = _world(group)
    per = math.ceil(n / world)
    return slice(min(rank * per, n), min((rank + 1) * per, n))


def _host_group(group):
    group = dist.group.WORLD if group is None else group
    if dist.get_backend(group) == "gloo":
        return group
    if group not in _HOST_GROUPS:
        _HOST_GROUPS[group] = dist.new_group(
            dist.get_process_group_ranks(group), backend="gloo")
    return _HOST_GROUPS[group]


def gather_rows(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """The full ``(n, ...)`` tensor on every rank, on the host, from each
    rank's ``shard_rows(n, group)`` rows ``t`` (on any device): one
    ``all_gather`` over gloo.  Counts its calls, the rows it returned and
    its host seconds, the copy to the host included (``gather_rows.calls``,
    ``.rows``, ``.seconds``)."""
    world, rank = _world(group)
    per = math.ceil(n / world)
    mine = shard_rows(n, group)
    if t.shape[0] != mine.stop - mine.start:
        raise ValueError(f"gather_rows: rank {rank} holds {t.shape[0]} rows, "
                         f"its share of {n} is {mine.stop - mine.start}")
    t0 = time.perf_counter()
    host = torch.zeros((per,) + tuple(t.shape[1:]), dtype=t.dtype)
    host[:t.shape[0]] = t.detach().cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host, group=_host_group(group))
    full = torch.cat(parts)[:n]
    gather_rows.calls += 1
    gather_rows.rows += n
    gather_rows.seconds += time.perf_counter() - t0
    return full


gather_rows.calls = 0
gather_rows.rows = 0
gather_rows.seconds = 0.0
