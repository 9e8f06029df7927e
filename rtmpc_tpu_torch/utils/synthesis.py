"""Discrete-time controller synthesis (host, float64).

The port's own copy of ``rtmpc_tpu/utils/synthesis.py``.  Replaces the reference's use of the ``python-control`` package
(``ct.dlqr``/``ct.dlyap``/``ct.c2d`` at ``TrackingMPC.py:25-31``,
``TubeRegulatorMPC.py:19-23``, ``Results/results_linear_system.py:59-61``)
with direct SciPy/LAPACK calls — same math, no extra dependency.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

__all__ = ["dlqr", "dlyap", "c2d"]


def dlqr(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray):
    """Discrete-time LQR.

    Solves the discrete algebraic Riccati equation and returns
    ``(K, S, eig(A - B K))`` with the feedback convention
    ``u = -K x`` — identical to ``control.dlqr``.
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.atleast_2d(np.asarray(R, dtype=np.float64))
    S = sla.solve_discrete_are(A, B, Q, R)
    K = np.linalg.solve(R + B.T @ S @ B, B.T @ S @ A)
    eigs = np.linalg.eigvals(A - B @ K)
    return K, S, eigs


def dlyap(A: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Discrete Lyapunov equation ``A X A^T - X + Q = 0`` (as ``control.dlyap``).

    The reference uses it with ``A = (A - B K)^T``-free convention:
    ``P = ct.dlyap(Acl, Q_lyap_sym)`` solves ``Acl P Acl^T - P + Q = 0``.
    Note: for the terminal *cost* one wants ``Acl^T P Acl - P + Q = 0``;
    the reference passes ``Acl`` directly (``TrackingMPC.py:31``), so we keep
    the same convention for parity (callers transpose as needed).
    """
    A = np.asarray(A, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    return sla.solve_discrete_lyapunov(A, Q)


def c2d(Ac: np.ndarray, Bc: np.ndarray, Ts: float):
    """Zero-order-hold discretization via the augmented matrix exponential.

    ``expm([[Ac, Bc], [0, 0]] * Ts)`` — same method as
    ``control.c2d(sys, Th)`` used at ``Results/results_linear_system.py:59-61``.
    Returns ``(A, B)``.
    """
    Ac = np.asarray(Ac, dtype=np.float64)
    Bc = np.asarray(Bc, dtype=np.float64)
    nx = Ac.shape[0]
    nu = Bc.shape[1]
    M = np.zeros((nx + nu, nx + nu))
    M[:nx, :nx] = Ac
    M[:nx, nx:] = Bc
    Md = sla.expm(M * Ts)
    return Md[:nx, :nx], Md[:nx, nx:]
