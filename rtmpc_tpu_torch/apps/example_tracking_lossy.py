"""Remote tracking MPC over a lossy network, the Pezzutto 2022 protocol
(counterpart of ``rtmpc_tpu/apps/example_tracking_lossy.py``).

    python3 -m rtmpc_tpu_torch.apps.example_tracking_lossy --device cuda \\
        [--solver ip|cuda|admm] [--dtype float64] [--quick] [--seed 0]

Equivalent of ``Example_of_Tracking_MPC_Over_Lossy_Network.py``: the
tracking MPC of ``example_tracking`` plus the estimator and the smart
actuator (``protocol/actuator.py``, ``mode="smart"``) with 70% packet loss
in both directions, T=120 (40 with ``--quick``); checks Proposition 1 of
Pezzutto (the estimation error is zero whenever Theta_t == 1, ref
:141-156).  The masks come from the port's generator at ``--seed`` (other
bits than ``jax.random``).
"""

import numpy as np
import torch

from ..models import setup_tracking
from ..parallel import make_batched_rollout
from ..utils import box
from .common import (DI_A, DI_B, EXAMPLE_SOLVERS, check, device_name,
                     example_draws, example_refs, host, make_parser, resolve,
                     solver_kwargs, timed_rollout)

N = 10
X0 = np.array([1.0, 2.0])
P_LOSS = 0.7


def parse_args(argv=None):
    return make_parser(__doc__, default_solver="ip",
                       solvers=EXAMPLE_SOLVERS).parse_args(argv)


def run(args, draws=None) -> dict:
    """Set up, run and check; ``draws`` (``theta``, ``gamma``, each
    ``(T,)``) replace the port's own.  Returns ``ok``, ``outs``
    (``StepOutputs``, batch 1), ``refs``, ``draws``, ``seconds`` and
    ``launches``."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    T = 40 if args.quick else 120
    setup = setup_tracking(DI_A, DI_B, np.eye(2), np.eye(1), N,
                           box(np.array([8.0, 8.0])), box(np.array([1.0])))
    arrays, cfg = setup.to_device(dtype, dev, **solver_kwargs(args))
    rollout = make_batched_rollout(arrays, cfg, T, actuator_mode="smart")
    refs = example_refs(T)
    d = example_draws(args, T, p_loss=P_LOSS, draws=draws)
    theta, gamma = (d[k].to(torch.int32) for k in ("theta", "gamma"))
    (_, outs), seconds, launches = timed_rollout(
        lambda: rollout(torch.tensor(X0[None], dtype=dtype, device=dev),
                        torch.tensor(refs[None], dtype=dtype, device=dev),
                        torch.zeros(1, T, 2, dtype=dtype, device=dev),
                        theta[None].to(dev), gamma[None].to(dev)), dev)
    xs, xh, Th = host(outs.x), host(outs.x_hat), host(outs.Theta)
    traj = np.vstack([X0[None], xs])       # x_t for t = 0..T

    # Proposition 1: e_t = x_t - x_hat_t == 0 whenever Theta_t == 1
    errs = [np.abs(traj[t] - xh[t]).max() for t in range(T) if Th[t] == 1]
    rate = float(theta.double().mean())
    ok = check("Proposition 1: zero estimation error when Theta=1",
               len(errs) > 0 and max(errs) < 1e-6,
               f"{len(errs)} consistent steps, max err "
               f"{max(errs) if errs else float('nan'):.2e}")
    ok &= check("delivery stats sane", 0.1 < rate < 0.6,
                f"theta rate {rate:.2f}")
    final = f"x1(T) = {xs[-1, 0]:.3f}"
    if args.quick:
        # as example_tube_tracking_lossy: T=40 leaves 10 steps after the
        # ref=9 segment for the descent to 4, too few under 70% loss for
        # some draws (the port's at seed 0 end at 8.000, the JAX example's
        # at 4.183); gated at the full T=120 only
        print(f"[info] tracks final feasible reference (gated at full T) "
              f"- {final}")
    else:
        ok &= check("tracks final feasible reference",
                    abs(xs[-1, 0] - 4.0) < 0.5, final)
    return dict(ok=ok, outs=outs, refs=refs, draws=d, seconds=seconds,
                launches=launches)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
