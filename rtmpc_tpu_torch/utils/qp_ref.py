"""High-accuracy dense convex-QP solver (host, float64): the port's own
copy of ``rtmpc_tpu/utils/qp_ref.py``, statement for statement, behind
``QPTemplate.solve_dense``.

A self-contained Mehrotra predictor-corrector primal-dual interior-point
method.  This plays the role Clarabel plays for the reference (default solver
at ``RegulatorMPC.py:31``, 1e-7 gap tolerances at ``TrackingMPC.py:129``):

* test oracle: batched-ADMM device solutions are checked against this,
* setup-time tool: occasional exact solves during scenario setup.

The problems are tiny (<=150 variables, <=400 constraints) so dense LAPACK
factorizations are the right tool; no sparsity is exploited.

Problem form::

    minimize    0.5 z' P z + q' z
    subject to  A z = b         (meq rows, optional)
                G z <= h        (mineq rows, optional)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg as sla

__all__ = ["QPSolution", "solve_qp_dense"]


@dataclasses.dataclass
class QPSolution:
    z: np.ndarray            # primal
    y: Optional[np.ndarray]  # equality multipliers
    lam: Optional[np.ndarray]  # inequality multipliers (>= 0)
    s: Optional[np.ndarray]  # inequality slacks (>= 0)
    obj: float
    status: str              # "optimal" | "max_iter" | "infeasible_or_unbounded"
    iters: int
    gap: float


def _kkt_solve(H, A, rz, re, reg=0.0):
    """Solve [H A'; A 0] [dz; dy] = [rz; re] (A may be None)."""
    n = H.shape[0]
    if A is None or A.shape[0] == 0:
        return sla.solve(H + reg * np.eye(n), rz, assume_a="sym"), None
    meq = A.shape[0]
    K = np.zeros((n + meq, n + meq))
    K[:n, :n] = H + reg * np.eye(n)
    K[:n, n:] = A.T
    K[n:, :n] = A
    K[n:, n:] = -reg * np.eye(meq)
    sol = sla.solve(K, np.concatenate([rz, re]), assume_a="sym")
    return sol[:n], sol[n:]


def solve_qp_dense(P, q, A=None, b=None, G=None, h=None,
                   tol: float = 1e-9, max_iter: int = 100) -> QPSolution:
    """Mehrotra predictor-corrector interior point for dense convex QPs."""
    P = np.asarray(P, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64).reshape(-1)
    n = q.shape[0]
    if A is not None and np.size(A) > 0:
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        b = np.asarray(b, dtype=np.float64).reshape(-1)
    else:
        A, b = None, None
    if G is not None and np.size(G) > 0:
        G = np.atleast_2d(np.asarray(G, dtype=np.float64))
        h = np.asarray(h, dtype=np.float64).reshape(-1)
        mi = G.shape[0]
    else:
        G, h, mi = None, None, 0

    # Unconstrained / equality-only: one KKT solve.
    if mi == 0:
        z, y = _kkt_solve(P, A, -q, b if b is not None else None)
        obj = 0.5 * z @ P @ z + q @ z
        return QPSolution(z, y, None, None, obj, "optimal", 0, 0.0)

    # --- interior-point initialization -------------------------------------
    z = np.zeros(n)
    try:
        z0, _ = _kkt_solve(P + np.eye(n), A, -q, b, reg=1e-10)
        if np.all(np.isfinite(z0)):
            z = z0
    except (np.linalg.LinAlgError, ValueError):   # singular or non-finite
        pass
    s = np.maximum(h - G @ z, 1.0)
    lam = np.ones(mi)
    y = np.zeros(A.shape[0]) if A is not None else None

    status = "max_iter"
    it = 0
    mu = np.dot(s, lam) / mi
    # Best-iterate tracking: on heavily degenerate problems (near-redundant
    # constraint blocks, e.g. an 854-row mRPI tube) Mehrotra can CONVERGE
    # and then blow up — observed on the cartpole tracking QP: at it=30
    # pr=2.5e-14, mu=2.7e-16, du=5.2e-3 (6.7e-8 RELATIVE to the 7.7e4 dual
    # magnitude), after which the multipliers explode to 1e16.  Keep the
    # best iterate by relative merit and fall back to it at exit.
    best = None
    best_merit = np.inf
    for it in range(1, max_iter + 1):
        rd = P @ z + q + G.T @ lam
        if A is not None:
            rd = rd + A.T @ y
            re = A @ z - b
        else:
            re = None
        ri = G @ z + s - h
        mu = np.dot(s, lam) / mi

        pr = max(np.max(np.abs(ri)),
                 np.max(np.abs(re)) if re is not None else 0.0)
        du = np.max(np.abs(rd))
        if pr < tol and du < tol and mu < tol:
            status = "optimal"
            break
        # Degenerate/active-boundary problems can drive mu to ~0 while a
        # residual stalls slightly above tol from float64 noise in the huge
        # multipliers; accept as optimal at a relaxed residual level
        # (dual residual measured RELATIVE to the dual magnitude).
        scale = 1.0 + np.max(np.abs(z))
        dscale = 1.0 + np.max(np.abs(lam)) + (np.max(np.abs(y))
                                              if y is not None else 0.0)
        if mu < 1e-12 and pr < 1e-6 * scale and du < 1e-6 * dscale:
            status = "optimal"
            break
        merit = pr / scale + du / dscale + mu
        if merit < best_merit:
            best_merit = merit
            best = (z.copy(), s.copy(), lam.copy(),
                    None if y is None else y.copy(), pr, du / dscale, mu)

        D = lam / s                      # diag of Lambda S^{-1}
        H = P + (G.T * D) @ G

        def directions(rc):
            rhs_z = -rd - G.T @ ((-rc + lam * ri) / s)
            rhs_e = -re if re is not None else None
            dz, dy = _kkt_solve(H, A, rhs_z, rhs_e, reg=1e-12)
            ds = -ri - G @ dz
            dlam = (-rc - lam * ds) / s
            return dz, dy, ds, dlam

        # predictor (affine) step
        rc_aff = lam * s
        dz_a, dy_a, ds_a, dlam_a = directions(rc_aff)
        alpha_p = _max_step(s, ds_a)
        alpha_d = _max_step(lam, dlam_a)
        mu_aff = np.dot(s + alpha_p * ds_a, lam + alpha_d * dlam_a) / mi
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0

        # corrector step
        rc = lam * s + dlam_a * ds_a - sigma * mu
        dz, dy, ds, dlam = directions(rc)
        alpha_p = min(1.0, 0.995 * _max_step(s, ds))
        alpha_d = min(1.0, 0.995 * _max_step(lam, dlam))

        z = z + alpha_p * dz
        s = s + alpha_p * ds
        lam = lam + alpha_d * dlam
        if y is not None:
            y = y + alpha_d * dy

        if not np.all(np.isfinite(z)) or mu > 1e16:
            status = "infeasible_or_unbounded"
            break

    if status != "optimal" and best is not None:
        # post-convergence blowup / stall: fall back to the best iterate
        # and accept it if it meets the relaxed (degenerate-case) test
        zb, sb, lamb, yb, prb, dub_rel, mub = best
        if mub < 1e-10 and prb < 1e-6 * (1.0 + np.max(np.abs(zb))) \
                and dub_rel < 1e-6:
            z, s, lam, y = zb, sb, lamb, yb
            mu = mub
            status = "optimal"

    obj = float(0.5 * z @ P @ z + q @ z)
    return QPSolution(z, y, lam, s, obj, status, it, float(mu))


def _max_step(v: np.ndarray, dv: np.ndarray) -> float:
    """Largest alpha in (0, 1] with v + alpha dv >= 0."""
    neg = dv < 0
    if not np.any(neg):
        return 1.0
    return float(min(1.0, np.min(-v[neg] / dv[neg])))
