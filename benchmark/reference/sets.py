"""The sets of a tube-tracking MPC, worked out from the configuration alone.

Plain float64 NumPy and SciPy, written from the papers and not from the
program's code:

* the LQR gain and terminal cost (discrete Riccati and Lyapunov equations);
* the tube ``Z``: Rakovic et al. 2005, Alg. 1 (the outer eps-approximation
  of the minimal RPI set), or Schulze Darup & Teichrib 2019, Thm. 2 (an RPI
  set in H-representation, "rpi_method" 1);
* the tightened constraints ``Xc = X - Z``, ``Uc = U - (-K) Z`` by support
  functions;
* the terminal set: Gilbert & Tan 1991, Alg. 3.1, on the augmented system
  of the tracking MPC (Limon et al. 2008).

No set is reduced: a redundant row changes no set and no QP optimum, so the
reference keeps every row it adds.  Supports of a set given by vertices are
a maximum over the vertices; of a set given by inequalities, an LP (HiGHS).
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.linalg as sla
import scipy.optimize as sopt
import scipy.spatial as sspatial

__all__ = ["lqr", "box_rows", "support_lp", "tube_vertices_rakovic",
           "tube_rows_darup", "terminal_set"]


def lqr(A, B, Q, R):
    """``(K, P)``: the LQR gain of ``u = -K x`` and the terminal cost ``P``
    as the source repository defines it, ``dlyap(Acl, Q + K' R K)`` in the
    convention of MATLAB and python-control: ``Acl P Acl' - P + Q + K' R K
    = 0`` with ``Acl = A - B K`` (``TrackingMPC.py``)."""
    S = sla.solve_discrete_are(A, B, Q, R)
    K = np.linalg.solve(R + B.T @ S @ B, B.T @ S @ A)
    Acl = A - B @ K
    Qk = Q + K.T @ R @ K
    P = sla.solve_discrete_lyapunov(Acl, (Qk + Qk.T) / 2)
    return K, P


def box_rows(half):
    """``(H, h)`` of the box ``|x_i| <= half_i``."""
    half = np.asarray(half, float)
    n = half.size
    return np.vstack([np.eye(n), -np.eye(n)]), np.concatenate([half, half])


def support_lp(H, h, d):
    """``max d'x`` over ``{H x <= h}`` (a bounded, nonempty set)."""
    res = sopt.linprog(-np.asarray(d, float), A_ub=H, b_ub=h,
                       bounds=[(None, None)] * H.shape[1], method="highs")
    if res.status != 0:
        raise RuntimeError(f"support LP failed: {res.message}")
    return -res.fun


def _hull(V):
    """The vertices of the convex hull of the points ``V`` (rows)."""
    if V.shape[1] == 1:
        return np.array([[V.min()], [V.max()]])
    return V[sspatial.ConvexHull(V).vertices]


def tube_vertices_rakovic(Acl, w_half, eps):
    """Rakovic et al. 2005, Alg. 1: the smallest ``s`` with ``alpha(s) <=
    eps / (eps + M(s))``, and ``Z = (1 - alpha)^-1 (W + Acl W + ... +
    Acl^(s-1) W)`` as the vertices of that Minkowski sum."""
    nx = Acl.shape[0]
    Vw = np.array(list(itertools.product(*[(-w, w) for w in w_half])))
    Hw, hw = box_rows(w_half)
    powers = [np.eye(nx)]
    M_pos = np.zeros(nx)
    M_neg = np.zeros(nx)
    for s in range(1, 2000):
        powers.append(powers[-1] @ Acl)
        # alpha(s) = max_i h_W((Acl^s)' f_i) / g_i
        alpha = np.max(np.max(Hw @ powers[s] @ Vw.T, axis=1) / hw)
        # M(s) = max_j sum_{i<s} max(h_W(Acl^i' e_j), h_W(-Acl^i' e_j))
        M_pos += np.max(powers[s - 1] @ Vw.T, axis=1)
        M_neg += np.max(-powers[s - 1] @ Vw.T, axis=1)
        if alpha <= eps / (eps + max(M_pos.max(), M_neg.max())):
            break
    else:
        raise RuntimeError("the mRPI iteration did not converge")
    V = Vw.copy()
    for i in range(1, s):
        AV = Vw @ powers[i].T
        V = _hull((V[:, None, :] + AV[None, :, :]).reshape(-1, nx))
    return V / (1.0 - alpha)


def tube_rows_darup(Acl, w_half, Hd, hd, eps):
    """Schulze Darup & Teichrib 2019: the smallest ``k`` meeting (9a) and
    (9b), the container ``C = {Hd x <= (1 + eps) b_k}`` checked against
    (27), and the RPI set ``{Hd Acl^i x <= hc - b_i, i < k}`` of (28), where
    ``b_i = sum_{j<i} h_W(Acl^j' Hd_r)`` row by row."""
    nx = Acl.shape[0]
    Vw = np.array(list(itertools.product(*[(-w, w) for w in w_half])))
    Hw, hw = box_rows(w_half)
    powers = [np.eye(nx)]
    b = [np.zeros(Hd.shape[0])]
    for k in range(1, 2000):
        powers.append(powers[-1] @ Acl)
        b.append(b[-1] + np.max(Hd @ powers[k - 1] @ Vw.T, axis=1))
        cond_a = np.all((1 + eps) * np.max(Hw @ powers[k] @ Vw.T, axis=1)
                        <= eps * hw)
        cond_b = np.all((1 + eps) * b[k] <= hd)
        if cond_a and cond_b:
            break
    else:
        raise RuntimeError("the RPI iteration did not converge")
    hc = (1 + eps) * b[k]
    sup = np.array([support_lp(Hd, hc, row) for row in Hd @ powers[k]])
    if not np.all((1 + eps) * sup <= eps * hc + 1e-14):
        raise RuntimeError("condition (27) of the RPI set does not hold")
    H = np.vstack([Hd @ powers[i] for i in range(k)])
    h = np.concatenate([hc - b[i] for i in range(k)])
    return H, h


def terminal_set(A_e, H, h, box, tol=1e-7, max_iter=1000):
    """Gilbert & Tan 1991, Alg. 3.1: ``O = {x : H A_e^t x <= h, t >= 0}``,
    the rows of step ``t`` added unless the set so far already implies them
    (an LP each, skipped where the box ``|x_j| <= box_j``, which ``H``'s
    own rows imply, already does); stops at the first step that adds
    none."""
    rows, rhs = [H], [h]
    At = np.eye(A_e.shape[0])
    for _ in range(max_iter):
        At = At @ A_e
        Hs, hs = np.vstack(rows), np.concatenate(rhs)
        new = H @ At
        keep = [i for i, r in enumerate(new)
                if np.abs(r) @ box > h[i] + tol
                and support_lp(Hs, hs, r) > h[i] + tol]
        if not keep:
            return Hs, hs
        rows.append(new[keep])
        rhs.append(h[keep])
    raise RuntimeError("the maximal admissible set did not converge")
