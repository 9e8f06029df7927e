"""MPC QP assembly on the host (counterpart of ``rtmpc_tpu/ops/assembly.py``).

NumPy, float64, unpadded: the same code as the JAX package's
``build_mpc_qp``, so both packages solve bit-identical problem data.  Each
controller variant becomes one canonical parametrized box-QP::

    minimize    0.5 z' P z + q(theta)' z
    subject to  l(theta) <= A z <= u(theta)

with ``q = q0 + Mq theta``, ``l = l0 + Ml theta``, ``u = u0 + Mu theta``,
``theta = [x_init; ref]`` and the variable layout
``z = [x_0 .. x_N | u_0 .. u_{N-1} | xbar | ubar]``.

``condense_template`` (state elimination) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["QPTemplate", "build_mpc_qp"]


@dataclasses.dataclass
class QPTemplate:
    """Canonical parametrized box-QP (host-side, float64, unpadded)."""

    P: np.ndarray        # (n, n) quadratic cost (already doubled: 1/2 z'Pz)
    q0: np.ndarray       # (n,)
    Mq: np.ndarray       # (n, ntheta)
    A: np.ndarray        # (m, n) constraint matrix
    l0: np.ndarray       # (m,)  -inf for one-sided rows
    Ml: np.ndarray       # (m, ntheta)
    u0: np.ndarray       # (m,)
    Mu: np.ndarray       # (m, ntheta)
    is_eq: np.ndarray    # (m,) bool, l == u rows
    nx: int
    nu: int
    N: int
    tracking: bool
    ntheta: int
    # row counts per group, in build_mpc_qp's emission order
    # [dynamics | init | ss | state | input | terminal]
    row_meta: Optional[dict] = None
    # reduced -> full map of a condensed template; None: the port builds
    # only full-layout (uncondensed) templates
    S: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.P.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[0]

    # -- variable index helpers -------------------------------------------
    def x_slice(self, i: int) -> slice:
        return slice(i * self.nx, (i + 1) * self.nx)

    def u_slice(self, j: int) -> slice:
        off = self.nx * (self.N + 1)
        return slice(off + j * self.nu, off + (j + 1) * self.nu)

    @property
    def xbar_slice(self) -> Optional[slice]:
        if not self.tracking:
            return None
        off = self.nx * (self.N + 1) + self.nu * self.N
        return slice(off, off + self.nx)

    @property
    def ubar_slice(self) -> Optional[slice]:
        if not self.tracking:
            return None
        off = self.nx * (self.N + 1) + self.nu * self.N + self.nx
        return slice(off, off + self.nu)


def build_mpc_qp(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R: np.ndarray,
    N: int,
    *,
    tracking: bool = False,
    P_term: Optional[np.ndarray] = None,
    Tout: Optional[np.ndarray] = None,
    Hx: Optional[np.ndarray] = None,
    hx: Optional[np.ndarray] = None,
    Hu: Optional[np.ndarray] = None,
    hu: Optional[np.ndarray] = None,
    HxN: Optional[np.ndarray] = None,
    hxN: Optional[np.ndarray] = None,
    terminal_augmented: bool = False,
    init_mode: str = "fixed",            # "fixed" | "tube"
    Hz: Optional[np.ndarray] = None,
    hz: Optional[np.ndarray] = None,
) -> QPTemplate:
    """Assemble a canonical MPC QP template.

    Parameters mirror the pieces the reference feeds CVXPY:

    * ``tracking``: include artificial steady state (xbar, ubar), the
      steady-state equality ``(A-I) xbar + B ubar = 0``, stage costs centred
      at (xbar, ubar), terminal cost ``P_term`` on ``x_N - xbar`` and offset
      cost ``Tout`` on ``xbar - ref``.
    * non-tracking with ``P_term``: tube-regulator terminal cost on x_N.
    * ``terminal_augmented``: HxN has 2*nx+nu columns over (x_N, xbar, ubar)
      (Gilbert–Tan set of the augmented system, ``TrackingMPC.py:109``);
      otherwise HxN has nx columns over x_N alone.
    * ``init_mode="fixed"``: equality x_0 = x_init.
      ``init_mode="tube"``: -Hz x_0 <= hz - Hz x_init  (initial state tube,
      ``TubeRegulatorMPC.py:128``).
    * ``HxN=None`` with tracking: fall back to x_N == xbar (the reference's
      no-terminal-set branch at ``TrackingMPC.py:105-107``).

    State rows apply to x_0 .. x_{N-1} and input rows to u_0 .. u_{N-1},
    exactly like the reference's loops.
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.atleast_2d(np.asarray(R, dtype=np.float64))
    nx, nu = A.shape[1], B.shape[1]
    N = int(N)
    ntheta = 2 * nx

    n = nx * (N + 1) + nu * N + (nx + nu if tracking else 0)

    # ---------------- cost -------------------------------------------------
    Pq = np.zeros((n, n))
    q0 = np.zeros(n)
    Mq = np.zeros((n, ntheta))

    def xs(i):
        return slice(i * nx, (i + 1) * nx)

    def us(j):
        off = nx * (N + 1)
        return slice(off + j * nu, off + (j + 1) * nu)

    if tracking:
        xb = slice(nx * (N + 1) + nu * N, nx * (N + 1) + nu * N + nx)
        ub = slice(xb.stop, xb.stop + nu)
    else:
        xb = ub = None

    for i in range(N):
        Pq[xs(i), xs(i)] += 2 * Q
        Pq[us(i), us(i)] += 2 * R
        if tracking:
            Pq[xs(i), xb] += -2 * Q
            Pq[xb, xs(i)] += -2 * Q
            Pq[xb, xb] += 2 * Q
            Pq[us(i), ub] += -2 * R
            Pq[ub, us(i)] += -2 * R
            Pq[ub, ub] += 2 * R

    if tracking:
        P_term = np.asarray(P_term, dtype=np.float64)
        Tout = np.asarray(Tout, dtype=np.float64)
        # (x_N - xbar)' P (x_N - xbar)
        Pq[xs(N), xs(N)] += 2 * P_term
        Pq[xs(N), xb] += -2 * P_term
        Pq[xb, xs(N)] += -2 * P_term
        Pq[xb, xb] += 2 * P_term
        # (xbar - ref)' Tout (xbar - ref):  ref enters the linear term
        Pq[xb, xb] += 2 * Tout
        Mq[xb, nx:2 * nx] = -2 * Tout
    elif P_term is not None:
        P_term = np.asarray(P_term, dtype=np.float64)
        Pq[xs(N), xs(N)] += 2 * P_term

    # ---------------- constraints ------------------------------------------
    rows_A, rows_l0, rows_u0, rows_Ml, rows_Mu, rows_eq = [], [], [], [], [], []

    def add_rows(Arow, l0r, u0r, Mlr=None, Mur=None, eq=False):
        k = Arow.shape[0]
        rows_A.append(Arow)
        rows_l0.append(np.asarray(l0r, dtype=np.float64).reshape(-1))
        rows_u0.append(np.asarray(u0r, dtype=np.float64).reshape(-1))
        rows_Ml.append(np.zeros((k, ntheta)) if Mlr is None else Mlr)
        rows_Mu.append(np.zeros((k, ntheta)) if Mur is None else Mur)
        rows_eq.append(np.full(k, eq))

    # dynamics: x_{i+1} - A x_i - B u_i = 0
    for i in range(N):
        Arow = np.zeros((nx, n))
        Arow[:, xs(i + 1)] = np.eye(nx)
        Arow[:, xs(i)] = -A
        Arow[:, us(i)] = -B
        add_rows(Arow, np.zeros(nx), np.zeros(nx), eq=True)

    # initial state
    if init_mode == "fixed":
        Arow = np.zeros((nx, n))
        Arow[:, xs(0)] = np.eye(nx)
        Mb = np.zeros((nx, ntheta))
        Mb[:, :nx] = np.eye(nx)
        add_rows(Arow, np.zeros(nx), np.zeros(nx), Mlr=Mb, Mur=Mb, eq=True)
    elif init_mode == "tube":
        Hz = np.asarray(Hz, dtype=np.float64)
        hz = np.asarray(hz, dtype=np.float64).reshape(-1)
        k = Hz.shape[0]
        Arow = np.zeros((k, n))
        Arow[:, xs(0)] = -Hz
        Mu_r = np.zeros((k, ntheta))
        Mu_r[:, :nx] = -Hz
        add_rows(Arow, np.full(k, -np.inf), hz, Mur=Mu_r)
    else:
        raise ValueError(f"unknown init_mode {init_mode!r}")

    # steady-state equality
    if tracking:
        Arow = np.zeros((nx, n))
        Arow[:, xb] = A - np.eye(nx)
        Arow[:, ub] = B
        add_rows(Arow, np.zeros(nx), np.zeros(nx), eq=True)

    # state constraints on x_0 .. x_{N-1}
    if Hx is not None:
        Hx = np.asarray(Hx, dtype=np.float64)
        hx = np.asarray(hx, dtype=np.float64).reshape(-1)
        k = Hx.shape[0]
        for i in range(N):
            Arow = np.zeros((k, n))
            Arow[:, xs(i)] = Hx
            add_rows(Arow, np.full(k, -np.inf), hx)

    # input constraints on u_0 .. u_{N-1}
    if Hu is not None:
        Hu = np.asarray(Hu, dtype=np.float64)
        hu = np.asarray(hu, dtype=np.float64).reshape(-1)
        k = Hu.shape[0]
        for j in range(N):
            Arow = np.zeros((k, n))
            Arow[:, us(j)] = Hu
            add_rows(Arow, np.full(k, -np.inf), hu)

    # terminal
    if HxN is not None:
        HxN = np.asarray(HxN, dtype=np.float64)
        hxN = np.asarray(hxN, dtype=np.float64).reshape(-1)
        k = HxN.shape[0]
        Arow = np.zeros((k, n))
        if terminal_augmented:
            if not tracking:
                raise ValueError("augmented terminal set requires tracking")
            Arow[:, xs(N)] = HxN[:, :nx]
            Arow[:, xb] = HxN[:, nx:2 * nx]
            Arow[:, ub] = HxN[:, 2 * nx:]
        else:
            Arow[:, xs(N)] = HxN
        add_rows(Arow, np.full(k, -np.inf), hxN)
    elif tracking:
        # no terminal set: x_N == xbar (TrackingMPC.py:105-107)
        Arow = np.zeros((nx, n))
        Arow[:, xs(N)] = np.eye(nx)
        Arow[:, xb] = -np.eye(nx)
        add_rows(Arow, np.zeros(nx), np.zeros(nx), eq=True)

    Acon = np.vstack(rows_A)
    meta = {
        "init_mode": init_mode,
        "mt": 0 if init_mode == "fixed" else Hz.shape[0],
        "has_ss": bool(tracking),
        "mx": 0 if Hx is None else Hx.shape[0],
        "mu": 0 if Hu is None else Hu.shape[0],
        "mN": 0 if HxN is None else HxN.shape[0],
        "terminal_eq_fallback": HxN is None and tracking,
        "terminal_augmented": bool(terminal_augmented and HxN is not None),
    }
    return QPTemplate(
        P=Pq, q0=q0, Mq=Mq, A=Acon,
        l0=np.concatenate(rows_l0), Ml=np.vstack(rows_Ml),
        u0=np.concatenate(rows_u0), Mu=np.vstack(rows_Mu),
        is_eq=np.concatenate(rows_eq),
        nx=nx, nu=nu, N=N, tracking=tracking, ntheta=ntheta,
        row_meta=meta,
    )
