"""Entry points of the port (counterpart of ``__graft_entry__.py``).

``entry()`` returns the flagship's batched closed-loop rollout and its
example inputs (T=8, B=16).  ``dryrun_multichip(n)`` spawns n ranks that
each run their share of a small flagship batch and all-reduce the
Monte-Carlo metric's sums across the group (the JAX dry run's ``psum``):
data parallelism over rollouts, the system's one scaling axis.

    python3 -m rtmpc_tpu_torch.entry [--device cuda|cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .models import flagship_setup
from .parallel import make_batched_rollout, tracking_error_rms
from .parallel.distributed import rank_device, shard_rows
from .parallel.ranks import spawn_ranks
from .protocol import draw_disturbances, draw_loss_masks

__all__ = ["entry", "dryrun_multichip"]

# The bench's solver schedule (bench.py:61-64): two ADMM phases of 60
# iterations, over-relaxation 1.8, phase 2 at 0.2 x rho.
FLAGSHIP_KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
ENTRY_T, ENTRY_B = 8, 16
DRYRUN_T, DRYRUN_PER_RANK, DRYRUN_LOSS = 6, 4, 0.5
RANK_TIMEOUT_S = 180.0


@functools.lru_cache(maxsize=1)
def _setup():
    return flagship_setup()


def _flagship(device: torch.device, dtype: torch.dtype):
    """The flagship frozen on ``device``: solver "cuda" (the ADMM kernel)
    on a card, its plain version "admm" on the CPU."""
    solver = "cuda" if device.type == "cuda" else "admm"
    return _setup().to_device(dtype, device, solver=solver, **FLAGSHIP_KW)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev


def entry(device="cuda", dtype: torch.dtype = torch.float32):
    """``(fn, args)``: the flagship's batched rollout at T=8 and its inputs
    for B=16 rollouts from rest towards x1 = 4, no loss, no disturbance;
    ``fn(*args)`` returns ``(carry, StepOutputs)``."""
    dev = _device(device)
    arrays, cfg = _flagship(dev, dtype)
    T, B, nx = ENTRY_T, ENTRY_B, cfg.nx
    fn = make_batched_rollout(arrays, cfg, T)
    refs = torch.zeros(B, T, nx, dtype=dtype, device=dev)
    refs[:, :, 0] = 4.0
    w = torch.zeros(B, T, nx, dtype=dtype, device=dev)
    theta = torch.ones(B, T, dtype=torch.int32, device=dev)
    gamma = torch.ones(B, T, dtype=torch.int32, device=dev)
    x0 = torch.zeros(B, nx, dtype=dtype, device=dev)
    return fn, (x0, refs, w, theta, gamma)


def dryrun_draws(n: int):
    """The port's own draws for ``dryrun_multichip(n)`` (seed 0): loss
    masks at 0.5/0.5 and disturbances in +-0.1, ``(4 n, 6)`` and ``(4 n,
    6, 2)``."""
    g = torch.Generator().manual_seed(0)
    batch = DRYRUN_PER_RANK * n
    theta, gamma = draw_loss_masks(g, DRYRUN_T, DRYRUN_LOSS, DRYRUN_LOSS,
                                   (batch,))
    w = draw_disturbances(g, DRYRUN_T, [-0.1, -0.1], [0.1, 0.1], (batch,))
    return theta.numpy(), gamma.numpy(), w.numpy()


def _dryrun_rank(device: str, dtype: torch.dtype, draws) -> tuple:
    """One rank of the dry run: its rows of the batch, then the sums of
    tracking error and feasibility all-reduced over the group."""
    dev = rank_device(device)
    arrays, cfg = _flagship(dev, dtype)
    theta, gamma, w = draws
    batch, T, nx = w.shape
    rows = shard_rows(batch)
    k = rows.stop - rows.start
    sums = torch.zeros(2, dtype=torch.float64)
    if k:
        x0 = torch.zeros(k, nx, dtype=dtype, device=dev)
        refs = torch.zeros(k, T, nx, dtype=dtype, device=dev)
        refs[:, :, 0] = 4.0
        carry, outs = make_batched_rollout(arrays, cfg, T)(
            x0, refs, torch.as_tensor(w[rows], dtype=dtype, device=dev),
            torch.as_tensor(theta[rows], dtype=torch.int32, device=dev),
            torch.as_tensor(gamma[rows], dtype=torch.int32, device=dev))
        if tuple(outs.x.shape) != (k, T, nx):
            raise RuntimeError(f"dry run: outputs {tuple(outs.x.shape)}, "
                               f"expected {(k, T, nx)}")
        err = tracking_error_rms(x0, outs.x, refs)
        sums = torch.stack([err.double().sum(),
                            carry.feasible.double().sum()]).cpu()
    # the cross-rank Monte-Carlo reduction: on the card under NCCL, on the
    # host under gloo
    comm = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    sums = sums.to(comm)
    dist.all_reduce(sums)
    mean_err, frac = (sums.cpu() / batch).tolist()
    if not np.isfinite(mean_err):
        raise RuntimeError(f"dry run: mean tracking error {mean_err}")
    if frac != 1.0:
        raise RuntimeError(f"dry run: {frac:.4f} of the rollouts feasible, "
                           "all must be")
    return mean_err, frac


def dryrun_multichip(n: int, device="cuda", draws=None,
                     dtype: torch.dtype = torch.float32) -> tuple:
    """Spawn ``n`` ranks that shard a batch of 4 n flagship rollouts (T=6,
    loss 0.5/0.5) and all-reduce the sums of tracking error and
    feasibility; every rank must read every rollout feasible and a finite
    mean error.  Returns ``(mean_err, frac_feasible)``.

    The group is NCCL's where each rank has a card of its own (``n <=
    torch.cuda.device_count()``), else gloo's with the ranks sharing the
    cards (``cuda:0`` on a one-card machine); the choice is printed.
    ``draws``: ``(theta, gamma, w)`` arrays of ``(4 n, 6)``, ``(4 n, 6)``
    and ``(4 n, 6, 2)`` (default ``dryrun_draws(n)``).  A rank that fails
    or runs past ``RANK_TIMEOUT_S`` makes the call raise."""
    dev = _device(device)
    draws = dryrun_draws(n) if draws is None else tuple(
        np.asarray(a) for a in draws)
    if draws[2].shape[0] != DRYRUN_PER_RANK * n:
        raise ValueError(f"dryrun_multichip({n}): draws for "
                         f"{draws[2].shape[0]} rollouts, expected "
                         f"{DRYRUN_PER_RANK * n}")
    if dev.type == "cuda" and n <= torch.cuda.device_count() \
            and dist.is_nccl_available():
        backend, where = "nccl", "one card a rank"
    else:
        backend = "gloo"
        where = ("on the CPU" if dev.type == "cpu" else
                 f"sharing {torch.cuda.device_count()} card(s): "
                 f"{n} ranks, so NCCL cannot give each its own")
    print(f"dryrun_multichip({n}): backend {backend}, {where}", flush=True)
    results = spawn_ranks(_dryrun_rank, n, (dev.type, dtype, draws),
                          backend=backend, timeout=RANK_TIMEOUT_S)
    if any(r != results[0] for r in results):
        raise RuntimeError(f"dry run: the ranks disagree: {results}")
    mean_err, frac = results[0]
    print(f"dryrun_multichip({n}): OK, batch {DRYRUN_PER_RANK * n} sharded "
          f"over {n} ranks, mean tracking error {mean_err:.6f}, feasible "
          f"{frac:.3f}", flush=True)
    return mean_err, frac


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    fn, ins = entry(args.device)
    carry, outs = fn(*ins)
    if not bool(carry.feasible.all()):
        raise RuntimeError("entry(): a rollout went infeasible")
    print("entry(): OK", tuple(outs.x.shape))
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
