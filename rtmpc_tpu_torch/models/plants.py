"""Plant models (counterpart of ``rtmpc_tpu/models/plants.py``).

The linear plant update ``x+ = A x + B u + w``; the cartpole's
parameters and its continuous-time linearization (NumPy;
the linearized Results scenario is built from them), and the nonlinear
cartpole itself: the analytic rigid-body ODE, one physics step by
semi-implicit Euler (the PyBullet scheme of the reference's plant) or RK4,
and the zero-order-hold plant that holds one 50 Hz control over ten 500 Hz
physics steps (``results_nonlinear_system.py:255-329``).  The nonlinear
functions are batch-explicit torch code: states ``(B, 4)``, forces ``(B,)``.

State convention: ``x = (p, p_dot, phi, phi_dot)`` with ``phi`` measured
from the upright equilibrium.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["linear_plant_step", "CartpoleParams", "cartpole_derivatives",
           "cartpole_step", "cartpole_linearized", "cartpole_zoh_step"]


def linear_plant_step(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                      u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x+ = A x + B u + w``, the per-step plant update of every linear
    benchmark (``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py:152``),
    batch-explicit: ``x``/``w`` ``(B, nx)``, ``u`` ``(B, nu)``."""
    return x @ A.T + u @ B.T + w


@dataclasses.dataclass(frozen=True)
class CartpoleParams:
    """Parameters of ``results_linear_system.py:31-38`` / the URDF."""
    M: float = 1.0       # cart mass
    m: float = 0.1       # pole mass
    b: float = 0.0       # cart friction
    I: float = 0.001     # pole inertia about its COM
    g: float = 9.8
    l: float = 0.5       # distance to pole COM

    @property
    def p(self) -> float:
        return self.I * (self.M + self.m) + self.M * self.m * self.l ** 2


def cartpole_linearized(params: CartpoleParams = CartpoleParams()):
    """Continuous-time (Ac, Bc, Cc) of ``results_linear_system.py:40-55``."""
    M, m, b, I, g, l = (params.M, params.m, params.b, params.I,
                        params.g, params.l)
    p = params.p
    Ac = np.array([
        [0.0, 1.0, 0.0, 0.0],
        [0.0, -(I + m * l ** 2) * b / p, -(m ** 2 * g * l ** 2) / p, 0.0],
        [0.0, 0.0, 0.0, 1.0],
        [0.0, -(m * l * b) / p, m * g * l * (M + m) / p, 0.0],
    ])
    Bc = np.array([[0.0], [(I + m * l ** 2) / p], [0.0], [-m * l / p]])
    Cc = np.array([[1.0, 0, 0, 0], [0, 0, 1.0, 0]])
    return Ac, Bc, Cc


def cartpole_derivatives(params: CartpoleParams, x: torch.Tensor,
                         force: torch.Tensor) -> torch.Tensor:
    """Nonlinear cartpole ODE, consistent with the reference linearization;
    ``x (B, 4)``, ``force (B,)``, returns ``dx/dt (B, 4)``.

    With phi from upright (sin phi ~ phi destabilizing):
        denom = (I+m l^2)(M+m) - m^2 l^2 cos^2(phi)
        p_ddot   = [ (I+m l^2)(F + m l phi_dot^2 s - b p_dot)
                     - m^2 l^2 g s c ] / denom
        phi_ddot = [ m l ( (M+m) g s - c (F + m l phi_dot^2 s - b p_dot) ) ]
                   / denom
    Linearizing at the origin gives Ac/Bc of ``cartpole_linearized``.
    """
    M, m, b, I, g, l = (params.M, params.m, params.b, params.I,
                        params.g, params.l)
    pos_dot = x[:, 1]
    phi = x[:, 2]
    phi_dot = x[:, 3]
    s = torch.sin(phi)
    c = torch.cos(phi)
    ml2 = I + m * l ** 2
    denom = ml2 * (M + m) - (m * l * c) ** 2
    f_eff = force + m * l * phi_dot ** 2 * s - b * pos_dot
    p_ddot = (ml2 * f_eff - m ** 2 * l ** 2 * g * s * c) / denom
    phi_ddot = (m * l * ((M + m) * g * s - c * f_eff)) / denom
    return torch.stack([pos_dot, p_ddot, phi_dot, phi_ddot], dim=1)


def cartpole_step(params: CartpoleParams, x: torch.Tensor,
                  force: torch.Tensor, dt: float,
                  method: str = "semi_implicit_euler") -> torch.Tensor:
    """One physics step at ``dt`` (reference: 1/500 s).

    ``semi_implicit_euler`` matches PyBullet's integrator family (velocities
    first, then positions); ``rk4`` is higher-order for reference solutions.
    """
    if method == "rk4":
        k1 = cartpole_derivatives(params, x, force)
        k2 = cartpole_derivatives(params, x + 0.5 * dt * k1, force)
        k3 = cartpole_derivatives(params, x + 0.5 * dt * k2, force)
        k4 = cartpole_derivatives(params, x + dt * k3, force)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    if method == "semi_implicit_euler":
        d = cartpole_derivatives(params, x, force)
        v_new = x[:, 1] + dt * d[:, 1]
        w_new = x[:, 3] + dt * d[:, 3]
        return torch.stack([x[:, 0] + dt * v_new, v_new,
                            x[:, 2] + dt * w_new, w_new], dim=1)
    raise ValueError(f"unknown method {method!r}")


def cartpole_zoh_step(params: CartpoleParams, x: torch.Tensor,
                      force: torch.Tensor, Th: float, n_substeps: int,
                      method: str = "semi_implicit_euler") -> torch.Tensor:
    """Hold ``force`` for ``n_substeps`` physics steps of ``Th/n_substeps``:
    the 50 Hz control / 500 Hz physics loop of
    ``results_nonlinear_system.py:255-329``."""
    dt = Th / n_substeps
    for _ in range(n_substeps):
        x = cartpole_step(params, x, force, dt, method=method)
    return x
