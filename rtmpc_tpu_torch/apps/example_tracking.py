"""Tracking MPC with an artificial steady state on the double integrator
(counterpart of ``rtmpc_tpu/apps/example_tracking.py``).

    python3 -m rtmpc_tpu_torch.apps.example_tracking --device cuda \\
        [--solver ip|cuda|admm] [--dtype float64] [--quick]

Equivalent of ``Example_of_Tracking_MPC.py``: state box |x| <= 8, input
|u| <= 1, piecewise reference [5, -9, 9, 4] (the -9/9 segments are outside
X, so the artificial steady state saturates at the feasible boundary),
T=120 steps (40 with ``--quick``), no disturbance, no network; 400 ADMM
iterations a step under the ADMM solvers.
"""

import numpy as np
import torch

from ..models import setup_tracking
from ..parallel import make_direct_rollout
from ..utils import box
from .common import (DI_A, DI_B, EXAMPLE_SOLVERS, check, device_name,
                     example_refs, host, make_parser, resolve, solver_kwargs,
                     timed_rollout)

N = 10
X0 = np.array([1.0, 2.0])


def parse_args(argv=None):
    return make_parser(__doc__, default_solver="ip",
                       solvers=EXAMPLE_SOLVERS).parse_args(argv)


def run(args, draws=None) -> dict:
    """Set up, run and check; returns ``ok``, ``outs`` (``DirectOutputs``,
    batch 1), ``refs``, ``seconds`` and ``launches``.  The example draws
    nothing (``draws`` is accepted for symmetry)."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    T = 40 if args.quick else 120
    setup = setup_tracking(DI_A, DI_B, np.eye(2), np.eye(1), N,
                           box(np.array([8.0, 8.0])), box(np.array([1.0])))
    arrays, cfg = setup.to_device(dtype, dev,
                                  **solver_kwargs(args, admm_iters=400))
    rollout = make_direct_rollout(arrays, cfg, T)
    refs = example_refs(T)
    (_, outs), seconds, launches = timed_rollout(
        lambda: rollout(torch.tensor(X0[None], device=dev),
                        torch.tensor(refs[None], dtype=dtype, device=dev),
                        torch.zeros(1, T, 2, dtype=dtype, device=dev)), dev)
    xs, us, xbars = host(outs.x), host(outs.u), host(outs.xbar)

    seg = T // 4
    ok = check("input constraints", bool(np.all(np.abs(us) <= 1 + 1e-4)),
               f"max |u| = {np.abs(us).max():.6f}")
    ok &= check("state constraints", bool(np.all(np.abs(xs) <= 8 + 1e-4)),
                f"max |x| = {np.abs(xs).max():.4f}")
    # the artificial steady state saturates inside the feasible boundary
    # for the infeasible references (8 is the box; xbar stays below it)
    sat = xbars[seg + 5:2 * seg, 0]
    ok &= check("steady state saturates for ref=-9",
                bool(np.all(sat > -8.1) and np.all(sat < -7.0)),
                f"xbar in [{sat.min():.3f}, {sat.max():.3f}]")
    ok &= check("tracks feasible reference 4",
                abs(xs[-1, 0] - 4.0) < 0.05, f"x1(T) = {xs[-1, 0]:.4f}")
    return dict(ok=ok, outs=outs, refs=refs, seconds=seconds,
                launches=launches)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
