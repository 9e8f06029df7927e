"""Tube regulator MPC, the configuration of Mayne 2005 Fig. 2 (counterpart
of ``rtmpc_tpu/apps/example_tube_regulator.py``).

    python3 -m rtmpc_tpu_torch.apps.example_tube_regulator --device cuda \\
        [--solver ip|cuda|admm] [--dtype float64] [--quick] [--seed 0]

Equivalent of ``Example_of_Tube_Regulator_MPC.py``: double integrator with
B=[[0.5],[1]], Q=I, R=0.01, N=9, disturbance |w| <= 0.1, constraints
x2 <= 2 (plus a loose box) and |u| <= 1, T=30 (15 with ``--quick``) from
x0=(-5,-2); the ancillary law u = u*_0 - K (x - x*_nom0) keeps the
disturbed state in a tube around the nominal trajectory.  1500 ADMM
iterations a step under the ADMM solvers (R=0.01 makes this the
worst-conditioned template), rho tuned on representative parameters.  The
disturbances come from the port's generator at ``--seed``.
"""

import numpy as np
import torch

from ..models import setup_tube_regulator
from ..parallel import make_direct_rollout
from ..utils import Polytope, box, contains
from .common import (DI_A, EXAMPLE_SOLVERS, check, check_tol, device_name,
                     example_draws, host, make_parser, resolve, solver_kwargs,
                     timed_rollout)

B_TUBE = np.array([[0.5], [1.0]])
N = 9
X0 = np.array([-5.0, -2.0])
W_HALF = np.array([0.1, 0.1])
PROBE_THETAS = np.array([[-5.0, -2.0, 0.0, 0.0], [0.0, 0, 0, 0]])


def setup():
    # Mayne's constraint x2 <= 2 plus a loose box to keep the sets bounded
    X = Polytope(np.array([[0.0, 1.0], [0.0, -1.0],
                           [1.0, 0.0], [-1.0, 0.0]]),
                 np.array([2.0, 50.0, 50.0, 50.0]))
    return setup_tube_regulator(DI_A, B_TUBE, np.eye(2), 0.01 * np.eye(1), N,
                                X, box(np.array([1.0])), box(W_HALF))


def parse_args(argv=None):
    return make_parser(__doc__, default_solver="ip",
                       solvers=EXAMPLE_SOLVERS).parse_args(argv)


def run(args, draws=None) -> dict:
    """Set up, run and check; ``draws`` (``w``, ``(T, 2)``) replace the
    port's own.  Returns ``ok``, ``outs`` (``DirectOutputs``, batch 1),
    ``draws``, ``seconds`` and ``launches``."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    T = 15 if args.quick else 30
    st = setup()
    arrays, cfg = st.to_device(dtype, dev,
                               **solver_kwargs(args, admm_iters=1500),
                               probe_thetas=PROBE_THETAS)
    rollout = make_direct_rollout(arrays, cfg, T, ancillary=True)
    d = example_draws(args, T, w_half=W_HALF, draws=draws)
    (_, outs), seconds, launches = timed_rollout(
        lambda: rollout(torch.tensor(X0[None], device=dev),
                        torch.zeros(1, T, 2, dtype=dtype, device=dev),
                        d["w"][None].to(dev, dtype)), dev)
    xs, us, x_noms = host(outs.x), host(outs.u), host(outs.x_nom)
    traj = np.vstack([X0[None], xs])

    tol = check_tol(args)
    ok = check("input constraints", bool(np.all(np.abs(us) <= 1 + tol)),
               f"max |u| = {np.abs(us).max():.4f}")
    ok &= check("state constraint x2 <= 2",
                bool(np.all(traj[:, 1] <= 2 + 1e-4)),
                f"max x2 = {traj[:, 1].max():.4f}")
    in_tube = all(contains(st.Z, traj[t] - x_noms[t], tol=tol)
                  for t in range(T))
    ok &= check("x - x_nom stays in the tube Z", in_tube)
    ok &= check("regulated near origin", np.linalg.norm(traj[-1]) < 0.5,
                f"|x(T)| = {np.linalg.norm(traj[-1]):.3f}")
    return dict(ok=ok, outs=outs, draws=d, seconds=seconds,
                launches=launches)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
