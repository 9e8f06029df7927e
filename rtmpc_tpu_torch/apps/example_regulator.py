"""Regulator MPC on the double integrator (counterpart of
``rtmpc_tpu/apps/example_regulator.py``).

    python3 -m rtmpc_tpu_torch.apps.example_regulator --device cuda \\
        [--solver ip|cuda|admm] [--dtype float64]

Equivalent of ``Examples of Model Predictive Controllers/
Example_of_Regulator_MPC.py``: A=[[1,1],[0,1]], B=[[0],[1]], N=10,
|u| <= 1, T=20 closed-loop steps from x0=(1,2), regulated to the origin by
the non-networked loop (``make_direct_rollout``).  ``--quick`` changes
nothing (the JAX example has no shorter run).
"""

import numpy as np
import torch

from ..models import setup_regulator
from ..parallel import make_direct_rollout
from ..utils import box
from .common import (DI_A, DI_B, EXAMPLE_SOLVERS, check, check_tol,
                     device_name, host, make_parser, resolve, solver_kwargs,
                     timed_rollout)

N, T = 10, 20
X0 = np.array([1.0, 2.0])


def parse_args(argv=None):
    return make_parser(__doc__, default_solver="ip",
                       solvers=EXAMPLE_SOLVERS).parse_args(argv)


def run(args, draws=None) -> dict:
    """Set up, run and check; returns ``ok``, the rollout's outputs
    ``outs`` (``DirectOutputs``, batch 1), ``seconds`` and ``launches``.
    The example draws nothing (``draws`` is accepted for symmetry)."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    setup = setup_regulator(DI_A, DI_B, np.eye(2), np.eye(1), N,
                            U=box(np.array([1.0])))
    arrays, cfg = setup.to_device(dtype, dev, **solver_kwargs(args))
    rollout = make_direct_rollout(arrays, cfg, T)
    zeros = torch.zeros(1, T, 2, dtype=dtype, device=dev)
    (_, outs), seconds, launches = timed_rollout(
        lambda: rollout(torch.tensor(X0[None], device=dev), zeros, zeros),
        dev)
    xs, us, rp = host(outs.x), host(outs.u), host(outs.r_prim)

    tol = check_tol(args)
    ok = check("input constraints |u| <= 1",
               bool(np.all(np.abs(us) <= 1.0 + tol)),
               f"max |u| = {np.abs(us).max():.4f}")
    ok &= check("state regulated to origin",
                bool(np.linalg.norm(xs[-1]) < 1e-2),
                f"|x(T)| = {np.linalg.norm(xs[-1]):.2e}")
    ok &= check("QP residuals small", float(np.max(rp)) < 10 * tol,
                f"max r_prim = {float(np.max(rp)):.2e}")
    return dict(ok=ok, outs=outs, seconds=seconds, launches=launches)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
