"""Tube tracking MPC without a network, Limon 2010 (counterpart of
``rtmpc_tpu/apps/example_tube_tracking.py``).

    python3 -m rtmpc_tpu_torch.apps.example_tube_tracking --device cuda \\
        [--solver ip|cuda|admm] [--dtype float64] [--quick] [--seed 0]

Equivalent of ``Example_of_Tube_Tracking_MPC.py``: double integrator,
|x| <= 8, |u| <= 1, |w| <= 0.1, piecewise reference [5, -9, 9, 4], T=120
(40 with ``--quick``); applies the ancillary law u = u*_0 - K (x - x*_nom0)
in the loop (ref :89) and checks the input constraints (ref :99-100).  600
ADMM iterations a step under the ADMM solvers (the -9 -> +9 reversal
invalidates the warm start).  The disturbances come from the port's
generator at ``--seed``.
"""

import numpy as np
import torch

from ..models import setup_tube_tracking
from ..parallel import make_direct_rollout
from ..utils import box
from .common import (DI_A, DI_B, EXAMPLE_SOLVERS, check, check_tol,
                     device_name, example_draws, example_refs, host,
                     make_parser, resolve, solver_kwargs, timed_rollout)

N = 10
X0 = np.array([1.0, 2.0])
W_HALF = np.array([0.1, 0.1])


def parse_args(argv=None):
    return make_parser(__doc__, default_solver="ip",
                       solvers=EXAMPLE_SOLVERS).parse_args(argv)


def run(args, draws=None) -> dict:
    """Set up, run and check; ``draws`` (``w``, ``(T, 2)``) replace the
    port's own.  Returns ``ok``, ``outs`` (``DirectOutputs``, batch 1),
    ``refs``, ``draws``, ``seconds`` and ``launches``."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    T = 40 if args.quick else 120
    setup = setup_tube_tracking(DI_A, DI_B, np.eye(2), np.eye(1), N,
                                box(np.array([8.0, 8.0])),
                                box(np.array([1.0])), box(W_HALF))
    arrays, cfg = setup.to_device(dtype, dev,
                                  **solver_kwargs(args, admm_iters=600))
    rollout = make_direct_rollout(arrays, cfg, T, ancillary=True)
    refs = example_refs(T)
    d = example_draws(args, T, w_half=W_HALF, draws=draws)
    (_, outs), seconds, launches = timed_rollout(
        lambda: rollout(torch.tensor(X0[None], device=dev),
                        torch.tensor(refs[None], dtype=dtype, device=dev),
                        d["w"][None].to(dev, dtype)), dev)
    us, x_noms = host(outs.u), host(outs.x_nom)
    traj = np.vstack([X0[None], host(outs.x)])

    tol = check_tol(args)
    ok = check("input constraints (ref :99-100)",
               bool(np.all(np.abs(us) <= 1 + tol)),
               f"max |u| = {np.abs(us).max():.4f}")
    ok &= check("state constraints", bool(np.all(np.abs(traj) <= 8 + 1e-4)),
                f"max |x| = {np.abs(traj).max():.4f}")
    viol = max(float(np.max(setup.Z.A @ (traj[t] - x_noms[t]) - setup.Z.b))
               for t in range(T))
    ok &= check("x - x_nom stays in the tube Z", viol < tol,
                f"max tube violation {viol:.2e}")
    ok &= check("tracks final feasible reference",
                abs(traj[-1, 0] - 4.0) < 0.3, f"x1(T) = {traj[-1, 0]:.3f}")
    return dict(ok=ok, outs=outs, refs=refs, draws=d, seconds=seconds,
                launches=launches)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
