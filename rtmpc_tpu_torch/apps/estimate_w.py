"""Data-driven disturbance set of the cartpole (counterpart of
``rtmpc_tpu/apps/estimate_w.py``).

    python3 -m rtmpc_tpu_torch.apps.estimate_w --device cuda \\
        [--n-rollouts 100] [--quick] [--seed 0]

Equivalent of ``Results/estimate_W_for_Cartpole.py``: the LQR controller
of the linearized model stabilizes the nonlinear cartpole (zero-order hold
at 50 Hz over 500 Hz physics, ``models/plants.py:cartpole_zoh_step``) from
random initial states; the 50 Hz residuals ``w(k) = x(k) - Acl x(k-1)``
(:94-107) give the per-dimension 2.5%-trimmed quantile box (:122-127), the
``W`` of the Results scenarios.  All rollouts run as one batch on the
device, in float64.  Prints the box beside the reference's PyBullet values
and runs the JAX app's two checks.

The initial states are drawn with the port's own generator at ``--seed``
(``jax.random`` bits cannot be made in torch); ``estimate_w_box`` takes
them explicitly, so the JAX app's draws give the JAX app's box.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.plants import cartpole_zoh_step
from ..utils.synthesis import dlqr
from .common import check, device_name, require_device
from .scenarios import cartpole_scenario

# the box of initial states around upright (the reference draws random
# stabilizable initial conditions): |p|, |v| <= 0.5, |phi| <= 0.15,
# |omega| <= 0.3
X0_SCALE = np.array([0.5, 0.5, 0.15, 0.3])


def estimate_w_box(sc, x0s, T: int = 150,
                   method: str = "semi_implicit_euler"):
    """The LQR rollouts of the nonlinear plant from ``x0s (B, 4)`` (a
    tensor: the rollouts run on its device, in float64) for ``T`` steps.
    Returns ``(w_box (4,), ws (B*T, 4))`` as numpy: the residuals, rollout
    by rollout, and the larger of ``|q_2.5%|`` and ``|q_97.5%|`` of each
    dimension."""
    x = torch.as_tensor(x0s).to(torch.float64)
    K, _, _ = dlqr(sc.A, sc.B, sc.Q, sc.R)
    Kt = torch.tensor(K, dtype=torch.float64, device=x.device)
    Acl = torch.tensor(sc.A - sc.B @ K, dtype=torch.float64, device=x.device)
    ws = []
    for _ in range(T):
        u = -(x @ Kt.T)
        x_next = cartpole_zoh_step(sc.params, x, u[:, 0], sc.Th,
                                   sc.physics_substeps, method=method)
        ws.append(x_next - x @ Acl.T)
        x = x_next
    ws = torch.stack(ws, dim=1).reshape(-1, 4).cpu().numpy()
    lo = np.quantile(ws, 0.025, axis=0)
    hi = np.quantile(ws, 0.975, axis=0)
    return np.maximum(np.abs(lo), np.abs(hi)), ws


def draw_initial_states(n: int, seed: int) -> torch.Tensor:
    """``n`` initial states uniform in ``+-X0_SCALE`` (float64, CPU), from
    a ``torch.Generator`` at ``seed``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(n, 4, generator=g, dtype=torch.float64)
    return (2.0 * u - 1.0) * torch.tensor(X0_SCALE)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback to the CPU: pass --device cpu for that)")
    p.add_argument("--n-rollouts", type=int, default=100)
    p.add_argument("--quick", action="store_true",
                   help="20 rollouts of 60 steps")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def run(args, x0s=None) -> dict:
    """Estimate the box and run the checks; ``x0s`` replaces the drawn
    initial states.  Returns ``ok``, ``w_box``, ``ws`` and ``seconds``
    (the rollouts alone, synchronized)."""
    dev = require_device(args.device)
    sc = cartpole_scenario()
    n, T = (20, 60) if args.quick else (args.n_rollouts, 150)
    if x0s is None:
        x0s = draw_initial_states(n, args.seed)
    print(f"device {device_name(dev)}: {x0s.shape[0]} LQR rollouts of {T} "
          f"steps on the nonlinear plant, float64")
    t0 = time.perf_counter()
    w_box, ws = estimate_w_box(sc, x0s.to(dev), T)
    seconds = time.perf_counter() - t0     # ws is on the host: synchronized
    print(f"rollouts and quantiles: {seconds:.3f} s")
    print("Estimated disturbance box (97.5% quantile of |w|):")
    for i, name in enumerate(["pos", "vel", "ang", "ang_vel"]):
        print(f"  w_{name:8s} = {w_box[i]:.6f}   "
              f"(reference PyBullet value {sc.W.b[i]:.6f})")
    ok = check("residuals are small (linearization error at 50 Hz)",
               bool(np.all(w_box < 0.2)), f"max {w_box.max():.4f}")
    ok &= check("angular velocity dominates (as in reference)",
                int(np.argmax(w_box)) == 3)
    return dict(ok=bool(ok), w_box=w_box, ws=ws, seconds=seconds)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
