"""Plant models (counterpart of ``rtmpc_tpu/models/plants.py``).

Ported so far: the cartpole's parameters and its continuous-time
linearization, both NumPy, which the linearized Results scenario is built
from.  The nonlinear ODE and the zero-order-hold physics plant are not
ported yet.

State convention: ``x = (p, p_dot, phi, phi_dot)`` with ``phi`` measured
from the upright equilibrium.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CartpoleParams", "cartpole_linearized"]


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
