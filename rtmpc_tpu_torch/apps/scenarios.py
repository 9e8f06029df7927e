"""The Results scenarios (counterpart of ``rtmpc_tpu/apps/scenarios.py``).

Ported so far: the linearized cartpole of ``results_linear_system.py``:
50 Hz, N=20, Q=diag(100,10,100,10), R=0.1, the disturbance box the
reference estimated from its PyBullet plant, the state box (angle +-0.3)
and the input box +-10.  Built on the port's own ``utils`` (``box``,
``c2d``), which give matrices bit-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.plants import CartpoleParams, cartpole_linearized

from ..utils.polytope import Polytope, box
from ..utils.synthesis import c2d

__all__ = ["CartpoleScenario", "cartpole_scenario"]


@dataclasses.dataclass
class CartpoleScenario:
    A: np.ndarray
    B: np.ndarray
    Q: np.ndarray
    R: np.ndarray
    N: int
    Th: float
    X: Polytope
    U: Polytope
    W: Polytope
    w_lo: np.ndarray
    w_hi: np.ndarray
    params: CartpoleParams
    x0: np.ndarray
    ref_value: float = 0.5
    T: int = 250               # 5 s at 50 Hz
    physics_substeps: int = 10  # 500 Hz physics under ZOH


def cartpole_scenario(w_box=None) -> CartpoleScenario:
    """The linearized-cartpole benchmark scenario.

    ``w_box``: per-dimension half-widths of the disturbance box; defaults
    to the reference's constants (``results_linear_system.py:76-83``).
    """
    params = CartpoleParams()
    Ac, Bc, _ = cartpole_linearized(params)
    Th = 0.02
    A, B = c2d(Ac, Bc, Th)
    Q = np.diag([100.0, 10.0, 100.0, 10.0])
    R = 0.1 * np.eye(1)
    if w_box is None:
        w_box = np.array([1e-4, 2.7e-3, 3e-4, 4.3e-2])
    w_box = np.asarray(w_box, dtype=np.float64)
    return CartpoleScenario(
        A=A, B=B, Q=Q, R=R, N=20, Th=Th,
        X=box(np.array([5.0, 5.0, 0.3, 2.0])),
        U=box(np.array([10.0])),
        W=box(w_box),
        w_lo=-w_box, w_hi=w_box,
        params=params,
        x0=np.zeros(4),
    )
