"""Invariant-set algorithms (host, float64): mRPI, RPI, maximal admissible set.

The port's own copy of ``rtmpc_tpu/sets/invariant.py``, statement for
statement, so both packages compute bit-identical sets
(``tests/test_torch_utils.py``).  Setup-time machinery for tube MPC, after
the original papers:

* Rakovic et al. 2005, "Invariant Approximations of the Minimal Robust
  Positively Invariant Set", Alg. 1
  (reference: ``utils_polytope.py:180-245``).
* Schulze Darup & Teichrib 2019, "Efficient computation of RPI sets for
  tube-based robust MPC" (reference: ``utils_polytope.py:270-414``) —
  H-rep-pure, hull-free, preferred for higher dimensions (the 4-D cartpole
  uses ``rpi_method=1`` at ``Results/results_linear_system.py:120``).
* Gilbert & Tan 1991, "Linear systems with state and control constraints:
  the theory and application of maximal output admissible sets", Alg. 3.1
  (reference: ``utils_polytope.py:247-268``).

All support-function evaluations are batched (one matmul over the disturbance
set's vertices per iteration) instead of the reference's per-row scipy LPs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.polytope import (
    Polytope, mink_sum, pont_diff, reduce_poly, scale, support_lp_batch,
    support_many,
)

__all__ = ["mrpi_rakovic", "rpi_darup", "max_admissible_set",
           "determine_mrpi", "tighten_constraints"]


def mrpi_rakovic(A: np.ndarray, W: Polytope, eps_var: float = 1.9e-5,
                 s_max: int = 20) -> Tuple[Optional[Polytope], int]:
    """Rakovic Alg. 1 outer eps-approximation of the mRPI of
    ``x+ = A x + w, w in W``.

    Returns ``(polytope, status)`` with status 0 on convergence, -1 otherwise
    (matching the reference's convention at ``utils_polytope.py:229-245``).
    """
    A = np.asarray(A, dtype=np.float64)
    if A.shape[0] != A.shape[1]:
        raise ValueError("A must be square")
    if np.any(W.b <= 0):
        raise ValueError("W must contain the origin in its interior")

    F, g = W.A, W.b
    nx = A.shape[0]
    A_pwr = [np.linalg.matrix_power(A, i) for i in range(s_max)]
    Vw = W.get_vertices()

    M_pos = np.zeros(nx)
    M_neg = np.zeros(nx)
    status = -1
    alpha = np.inf
    s = 0
    while s < s_max - 1:
        s += 1
        # alpha_s[i] = h_W(A^s' f_i) / g_i, batched over rows of F.
        dirs = F @ A_pwr[s]              # rows: (A^s)' f_i  transposed math
        alpha = float(np.max(np.max(dirs @ Vw.T, axis=1) / g))
        # M_s accumulation: support of W along +/- rows of A^{s-1}.
        Asm1 = A_pwr[s - 1]
        M_pos += np.max(Asm1 @ Vw.T, axis=1)
        M_neg += np.max(-Asm1 @ Vw.T, axis=1)
        M_s = max(M_pos.max(), M_neg.max())
        if alpha <= eps_var / (eps_var + M_s):
            status = 0
            break

    if status != 0:
        return None, status

    # F_s = W + A W + ... + A^{s-1} W  (vertex sums + hulls), scaled.
    Fs = Polytope(W.A.copy(), W.b.copy())
    for i in range(1, s):
        Fs = mink_sum(Fs, Vw @ A_pwr[i].T)
    return scale(Fs, 1.0 / (1.0 - alpha)), status


def rpi_darup(A: np.ndarray, W: Polytope, X: Polytope, U: Polytope,
              K: np.ndarray, eps_var: float = 1e-4, s_max: int = 20,
              return_container: bool = False):
    """Darup–Teichrib 2019 efficient RPI computation (H-rep pure).

    Finds the smallest ``k_star`` satisfying conditions (9a)/(9b), builds the
    container ``C`` of Thm 1, verifies condition (27), and assembles the RPI
    ``P_inf = {x : Hc A^i x <= hc - bc_i, i < k_star}`` of Thm 2 / eq. (28).

    Known answers (free test vectors, ``Example of Approximation of
    mRPI_Darup.py:50-55``): for the double integrator with ``B=[[0.5],[1]]``
    and LQR gain, eps 1e-1/1e-2/1e-3 -> k_star 5/6/10.

    Returns ``(rpi, status)`` or ``(rpi, container, status)``.
    """
    A = np.asarray(A, dtype=np.float64)
    K = np.atleast_2d(np.asarray(K, dtype=np.float64))
    if np.any(W.b <= 0):
        raise ValueError("W must contain the origin in its interior")

    Hw, hw = W.A, W.b
    nw = Hw.shape[0]
    # Polytope D above eq. (12): state rows + input rows mapped through -K.
    Hd = np.vstack([X.A, -U.A @ K])
    hd = np.concatenate([X.b, U.b])
    nd = Hd.shape[0]

    A_pwr = [np.linalg.matrix_power(A, i) for i in range(s_max + 1)]
    Vw = W.get_vertices()

    bc_all = np.zeros((nd, s_max))
    k_star = 1
    found = False
    while k_star < s_max and not found:
        # condition (10) -> (9a): (1+eps) h_W(A^{k*}' Hw_i) <= eps hw_i
        HwAj = Hw @ A_pwr[k_star]
        hw_k = np.max(HwAj @ Vw.T, axis=1)
        cond_a = bool(np.all((1 + eps_var) * hw_k <= eps_var * hw))
        # condition (12) -> (9b): accumulated supports along Hd A^{k*-1}
        HcAj = Hd @ A_pwr[k_star - 1]
        sup = np.max(HcAj @ Vw.T, axis=1)
        if k_star == 1:
            bc_all[:, 0] = sup
        else:
            bc_all[:, k_star - 1] = bc_all[:, k_star - 2] + sup
        cond_b = bool(np.all((1 + eps_var) * bc_all[:, k_star - 1] <= hd))
        if cond_a and cond_b:
            found = True
        else:
            k_star += 1

    if not found:
        out = (None, -1) if not return_container else (None, None, -1)
        return out

    # Container C of Thm 1.
    hc = (1 + eps_var) * bc_all[:, k_star - 1]
    C = Polytope(Hd.copy(), hc.copy())

    # Verify condition (27): (1+eps) h_C(A^{k*}' Hc_i) <= eps hc_i.
    HcAk = Hd @ A_pwr[k_star]
    hc_sup = support_many(C, HcAk)
    if not np.all((1 + eps_var) * hc_sup <= eps_var * hc + 1e-14):
        out = (None, -1) if not return_container else (None, None, -1)
        return out

    # RPI of eq. (28): intersection over i < k_star of {Hc A^i x <= hc - bc_{i-1}}.
    H_rows = [Hd]
    h_rows = [hc]
    for i in range(1, k_star):
        H_rows.append(Hd @ A_pwr[i])
        h_rows.append(hc - bc_all[:, i - 1])
    rpi = Polytope(np.vstack(H_rows), np.concatenate(h_rows))
    rpi._k_star = k_star  # exposed for tests / diagnostics
    if return_container:
        return rpi, C, 0
    return rpi, 0


def max_admissible_set(A: np.ndarray, X: Polytope, max_iter: int = 500,
                       tol: float = 1e-7) -> Polytope:
    """Gilbert–Tan Alg. 3.1 maximal output admissible set ``O_inf`` for
    ``x+ = A x`` with ``x in X`` for all k.

    Iterates ``O_{t+1} = O_t ∩ {G A^{t+1} x <= f}`` to the fixed point.
    Convergence test per Gilbert–Tan: ``O_{t+1} == O_t`` iff every *new*
    row is redundant w.r.t. ``O_t`` — one support LP per new row, instead
    of the reference's full polytope-equality/reduction per iteration
    (``utils_polytope.py:257-266``), which is what makes the 9-dimensional
    augmented cartpole system tractable.  Rows already redundant are not
    appended; one exact reduction at the end.
    """
    A = np.asarray(A, dtype=np.float64)
    G, f = X.A, X.b
    rows_A = [G.copy()]
    rows_b = [f.copy()]
    O = Polytope(G.copy(), f.copy())
    Apow = np.eye(A.shape[0])
    for t in range(max_iter):
        Apow = Apow @ A
        Gnew = G @ Apow
        # supports of the current set along all candidate rows: one batched
        # native-LP kernel call per Gilbert-Tan iteration
        sups = support_lp_batch(O.A, O.b, Gnew)
        keep_rows = list(np.where(sups > f + tol)[0])
        if not keep_rows:
            return reduce_poly(O)
        rows_A.append(Gnew[keep_rows])
        rows_b.append(f[keep_rows])
        O = Polytope(np.vstack(rows_A), np.concatenate(rows_b))
    raise RuntimeError(f"Gilbert-Tan did not converge in {max_iter} iters")


def determine_mrpi(Acl: np.ndarray, W: Polytope, X: Optional[Polytope] = None,
                   U: Optional[Polytope] = None, K: Optional[np.ndarray] = None,
                   eps_var: float = 1e-4, rpi_method: int = 0,
                   s_max_init: int = 200, max_escalations: int = 3) -> Polytope:
    """mRPI dispatcher with the reference's s_max x10 escalation-on-failure
    loop and stability precheck (``TubeRegulatorMPC.py:26-78``)."""
    Acl = np.asarray(Acl, dtype=np.float64)
    if np.max(np.abs(np.linalg.eigvals(Acl))) >= 1.0:
        raise ValueError("Acl is not Schur stable; mRPI iteration would "
                         "never converge")
    s_max = s_max_init
    for _ in range(max_escalations + 1):
        if rpi_method == 1:
            Fs, status = rpi_darup(Acl, W, X, U, K, eps_var=eps_var,
                                   s_max=s_max)
        else:
            Fs, status = mrpi_rakovic(Acl, W, eps_var=eps_var, s_max=s_max)
        if status == 0:
            # epsilon-reduction: mRPI approximations carry near-duplicate
            # facet directions that degenerate QP duals and stall ADMM;
            # merging them inflates the set by <= ~1e-7 (outer approx, safe
            # for tube/tightening use)
            return reduce_poly(Fs, angular_tol=1e-9, slack_tol=1e-7)
        s_max *= 10
    raise RuntimeError("mRPI computation failed to converge even after "
                       f"escalating s_max to {s_max // 10}")


def tighten_constraints(X: Polytope, U: Polytope, Z: Polytope,
                        K: np.ndarray) -> Tuple[Polytope, Polytope]:
    """Tube constraint tightening (Mayne 2005 eqs. (9)-(10)):
    ``Xc = X - Z``, ``Uc = U - (-K) Z`` (``TubeRegulatorMPC.py:80-89``).

    Returns ``(Xc, Uc)``.
    """
    K = np.atleast_2d(np.asarray(K, dtype=np.float64))
    Xc = pont_diff(X, Z)
    KZ = scale(Z, -K)
    Uc = pont_diff(U, KZ)
    return Xc, Uc
