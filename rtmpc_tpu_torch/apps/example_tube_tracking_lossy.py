"""Remote tube tracking MPC over a lossy network, the flagship demo
(counterpart of ``rtmpc_tpu/apps/example_tube_tracking_lossy.py``).

    python3 -m rtmpc_tpu_torch.apps.example_tube_tracking_lossy \\
        --device cuda [--solver ip|cuda|admm] [--dtype float64] [--quick] \\
        [--seed 0]

Equivalent of ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py``:
double integrator, N=10, |x| <= 8, |u| <= 1, |w| <= 0.1, 70% packet loss
in both directions, fixed initial state (paper eq. (8d)), consistent
actuator and estimator, T=120 (40 with ``--quick``).  Promotes the
reference's post-hoc checks to PASS/FAIL: the estimation error in Z
whenever Theta_t == 1 (:165-179) and tube membership x - x_nom in Z at
every step (:181-184).

As in the JAX example, the controller is the dense interior point with
polish (``solver="ip"``, :34-35) by default; ``--solver cuda`` or
``admm`` runs the same controller on that ADMM, with the examples'
schedule (``solver_kwargs``) at 200 iterations a step: two phases of 100,
polished in float64.  The masks and disturbances come from the port's
generator at ``--seed``.
"""

import numpy as np
import torch

from ..models import setup_tube_tracking
from ..parallel import make_batched_rollout
from ..utils import box, contains
from .common import (DI_A, DI_B, EXAMPLE_SOLVERS, check, device_name,
                     example_draws, example_refs, host, make_parser, resolve,
                     solver_kwargs, timed_rollout)

N = 10
X0 = np.array([1.0, 2.0])
W_HALF = np.array([0.1, 0.1])
P_LOSS = 0.7


def parse_args(argv=None):
    return make_parser(__doc__, default_solver="ip",
                       solvers=EXAMPLE_SOLVERS).parse_args(argv)


def controller_kwargs(args) -> dict:
    """``to_device`` arguments: the JAX example's (``iters=200,
    polish=True, solver="ip"``, :34-35; ``iters`` is an ADMM setting the
    interior point ignores) under ``--solver ip``; under ``cuda`` or
    ``admm`` the examples' ADMM schedule of ``solver_kwargs`` at those 200
    iterations a step."""
    if args.solver == "ip":
        return dict(iters=200, polish=True, solver="ip")
    return solver_kwargs(args, admm_iters=200)


def run(args, draws=None) -> dict:
    """Set up, run and check; ``draws`` (``theta``, ``gamma`` ``(T,)``,
    ``w`` ``(T, 2)``) replace the port's own.  Returns ``ok``, ``outs``
    (``StepOutputs``, batch 1), ``refs``, ``draws``, ``seconds`` and
    ``launches``."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    kw = controller_kwargs(args)
    print(f"device {device_name(dev)}, solver {kw['solver']}, {args.dtype}")
    T = 40 if args.quick else 120
    setup = setup_tube_tracking(DI_A, DI_B, np.eye(2), np.eye(1), N,
                                box(np.array([8.0, 8.0])),
                                box(np.array([1.0])), box(W_HALF),
                                fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype, dev, **kw)
    rollout = make_batched_rollout(arrays, cfg, T)
    refs = example_refs(T)
    d = example_draws(args, T, w_half=W_HALF, p_loss=P_LOSS, draws=draws)
    theta, gamma = (d[k].to(torch.int32) for k in ("theta", "gamma"))
    (_, outs), seconds, launches = timed_rollout(
        lambda: rollout(torch.tensor(X0[None], dtype=dtype, device=dev),
                        torch.tensor(refs[None], dtype=dtype, device=dev),
                        d["w"][None].to(dev, dtype), theta[None].to(dev),
                        gamma[None].to(dev)), dev)
    xh, xn, Th = host(outs.x_hat), host(outs.x_nom), host(outs.Theta)
    traj = np.vstack([X0[None], host(outs.x)])
    Z = setup.Z

    # Proposition 1 (tube form): e_t in Z whenever Theta_t == 1
    bad_prop1 = [t for t in range(T)
                 if Th[t] == 1 and not contains(Z, traj[t] - xh[t],
                                                tol=1e-6)]
    ok = check("Proposition 1: e in Z when Theta=1 (ref :165-179)",
               not bad_prop1 and Th.sum() > 0,
               f"{int(Th.sum())} consistent steps")
    bad_tube = [t for t in range(T)
                if not contains(Z, traj[t] - xn[t], tol=1e-6)]
    ok &= check("tube membership x - x_nom in Z (ref :181-184)",
                not bad_tube)
    ok &= check("state constraints under 70% loss",
                bool(np.all(np.abs(traj) <= 8 + 1e-4)),
                f"max |x| = {np.abs(traj).max():.4f}")
    if not args.quick:
        # --quick leaves too few steps after the ref=9 segment for the
        # descent to 4 under 70% loss; only meaningful at the full T=120
        ok &= check("tracks final feasible reference",
                    abs(traj[-1, 0] - 4.0) < 0.5,
                    f"x1(T) = {traj[-1, 0]:.3f}")
    return dict(ok=ok, outs=outs, refs=refs, draws=d, seconds=seconds,
                launches=launches)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
