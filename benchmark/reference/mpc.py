"""The tube-tracking MPC of a configuration, solved exactly in float64.

The controller of Limon et al. 2008 with the tube of Mayne et al. 2005, as
Umsonst & Barbosa (CDC 2024) run it: at each step, from the estimate
``x0`` and the reference ``r``,

    minimize  sum_{i<N} |x_i - xbar|_Q^2 + |u_i - ubar|_R^2
              + |x_N - xbar|_P^2 + |xbar - r|_T^2          (T = 10 P)
    s.t.      x_{i+1} = A x_i + B u_i,  x_0 = x0,
              x_i in Xc (i < N),  u_i in Uc (i < N),
              (x_N, xbar, ubar) in the terminal set,
              (A - I) xbar + B ubar = 0.

The reference solves it in its own form, not the program's: the states are
eliminated through the dynamics, the steady state is written in the null
space of its equality, and the rest is a dense inequality-constrained QP
over ``w = [u_0 .. u_{N-1} | coefficients of the steady state]``, solved
by a primal-dual interior point (Mehrotra's predictor-corrector) to a
mean complementarity of 1e-12 of the gradient's scale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg as sla

from .sets import (box_rows, lqr, support_lp, terminal_set,
                   tube_rows_darup, tube_vertices_rakovic)

__all__ = ["Controller", "build_controller", "solve_qp"]


@dataclasses.dataclass
class Controller:
    """Everything a step needs: the model, the gain, and the QP in ``w``:
    ``0.5 w'Hw + (Gx x0 + Gr r)'w`` under ``G w <= h + Hx0 x0``."""
    A: np.ndarray
    B: np.ndarray
    K: np.ndarray             # LQR gain, u = -K x
    N: int
    H: np.ndarray
    Gx: np.ndarray
    Gr: np.ndarray
    G: np.ndarray
    h: np.ndarray
    Hx0: np.ndarray
    U_of_w: np.ndarray        # (N nu, dim w): the inputs
    xbar_of_w: np.ndarray     # (nx, dim w)
    ubar_of_w: np.ndarray     # (nu, dim w)
    Hxc: np.ndarray           # tightened state constraints, Hxc x <= hxc
    hxc: np.ndarray

    def packet(self, x0, r):
        """``(U, feasible)``: the packet ``[u_0 .. u_{N-1}, ubar + K xbar]``
        as an ``(N + 1, nu)`` array, or None where the QP has no solution
        (x0 outside ``Xc`` included)."""
        if np.any(self.Hxc @ x0 > self.hxc + 1e-9):
            return None
        w = solve_qp(self.H, self.Gx @ x0 + self.Gr @ r, self.G,
                     self.h + self.Hx0 @ x0)
        if w is None:
            return None
        nu = self.B.shape[1]
        U = (self.U_of_w @ w).reshape(self.N, nu)
        u_ss = self.ubar_of_w @ w + self.K @ (self.xbar_of_w @ w)
        return np.vstack([U, u_ss[None]])


def build_controller(cfg: dict) -> Controller:
    """The controller of a configuration file's ``plant`` and
    ``controller`` sections (tube tracking, fixed initial state)."""
    plant, ctl = cfg["plant"], cfg["controller"]
    A, B = np.array(plant["A"], float), np.array(plant["B"], float)
    Q, R = np.array(ctl["Q"], float), np.array(ctl["R"], float)
    N, lam, eps = int(ctl["N"]), float(ctl["lambda"]), float(ctl["eps"])
    nx, nu = B.shape
    K, P = lqr(A, B, Q, R)
    Acl = A - B @ K
    Hx, hx = box_rows(plant["x_box"])
    Hu, hu = box_rows(plant["u_box"])
    if ctl["rpi_method"] == 0:
        Vz = tube_vertices_rakovic(Acl, plant["w_box"], eps)

        def h_Z(d):
            return np.max(Vz @ d)
    else:
        Hd, hd = np.vstack([Hx, -Hu @ K]), np.concatenate([hx, hu])
        Hz, hz = tube_rows_darup(Acl, plant["w_box"], Hd, hd, eps)

        def h_Z(d):
            return support_lp(Hz, hz, d)
    hxc = hx - np.array([h_Z(r) for r in Hx])
    huc = hu - np.array([h_Z(-K.T @ r) for r in Hu])

    # the augmented system (x, xbar, ubar) under u = ubar - K (x - xbar)
    Z = np.zeros
    A_e = np.block([[Acl, B @ K, B],
                    [Z((nx, nx)), np.eye(nx), Z((nx, nu))],
                    [Z((nu, nx)), Z((nu, nx)), np.eye(nu)]])
    Hcl = np.block([[Hx, Z((Hx.shape[0], nx + nu))],
                    [-Hu @ K, Hu @ K, Hu],
                    [Z((Hx.shape[0], nx)), Hx, Z((Hx.shape[0], nu))],
                    [Z((Hu.shape[0], 2 * nx)), Hu]])
    hcl = np.concatenate([hxc, huc, lam * hxc, lam * huc])
    # the box that the rows on x, xbar and ubar alone imply
    bx = np.minimum(hxc[:nx], hxc[nx:])
    bu = np.minimum(huc[:nu], huc[nu:])
    Hf, hf = terminal_set(A_e, Hcl, hcl, np.concatenate([bx, lam * bx,
                                                         lam * bu]))

    # the steady states: [xbar; ubar] = Ns c
    Ns = sla.null_space(np.hstack([A - np.eye(nx), B]))
    k = Ns.shape[1]
    nw = N * nu + k
    Nx = np.hstack([Z((nx, N * nu)), Ns[:nx]])
    Nu = np.hstack([Z((nu, N * nu)), Ns[nx:]])
    # x_i = Phi[i] x0 + Gam[i] w
    Phi, Gam = [np.eye(nx)], [Z((nx, nw))]
    for i in range(N):
        Ei = Z((nu, nw))
        Ei[:, i * nu:(i + 1) * nu] = np.eye(nu)
        Phi.append(A @ Phi[-1])
        Gam.append(A @ Gam[-1] + B @ Ei)

    # the cost, 0.5 w'Hw + (Gx x0 + Gr r)'w, term by term
    H, Gx, Gr = Z((nw, nw)), Z((nw, nx)), Z((nw, nx))

    def term(L, Cx, Cr, W):
        nonlocal H, Gx, Gr
        H = H + 2 * L.T @ W @ L
        Gx = Gx + 2 * L.T @ W @ Cx
        Gr = Gr + 2 * L.T @ W @ Cr
    for i in range(N):
        Ei = Z((nu, nw))
        Ei[:, i * nu:(i + 1) * nu] = np.eye(nu)
        term(Gam[i] - Nx, Phi[i], Z((nx, nx)), Q)
        term(Ei - Nu, Z((nu, nx)), Z((nu, nx)), R)
    term(Gam[N] - Nx, Phi[N], Z((nx, nx)), P)
    term(Nx, Z((nx, nx)), -np.eye(nx), 10 * P)

    # the constraints, G w <= h + Hx0 x0
    G, h, Hx0 = [], [], []
    for i in range(1, N):
        G.append(Hx @ Gam[i])
        h.append(hxc)
        Hx0.append(-Hx @ Phi[i])
    for i in range(N):
        Ei = Z((nu, nw))
        Ei[:, i * nu:(i + 1) * nu] = np.eye(nu)
        G.append(Hu @ Ei)
        h.append(huc)
        Hx0.append(Z((Hu.shape[0], nx)))
    Hfx, Hfxb, Hfub = Hf[:, :nx], Hf[:, nx:2 * nx], Hf[:, 2 * nx:]
    G.append(Hfx @ Gam[N] + Hfxb @ Nx + Hfub @ Nu)
    h.append(hf)
    Hx0.append(-Hfx @ Phi[N])
    U_of_w = np.hstack([np.eye(N * nu), Z((N * nu, k))])
    return Controller(A=A, B=B, K=K, N=N, H=(H + H.T) / 2, Gx=Gx, Gr=Gr,
                      G=np.vstack(G), h=np.concatenate(h),
                      Hx0=np.vstack(Hx0), U_of_w=U_of_w, xbar_of_w=Nx,
                      ubar_of_w=Nu, Hxc=Hx, hxc=hxc)


def solve_qp(H, g, G, h, tol=1e-12, max_iter=100) -> Optional[np.ndarray]:
    """``argmin 0.5 w'Hw + g'w`` under ``G w <= h`` (H positive definite),
    by Mehrotra's predictor-corrector; None if it does not converge."""
    m, n = G.shape
    w = np.zeros(n)
    s = np.maximum(h - G @ w, 1.0)
    lam = np.ones(m)
    scale_d = 1.0 + np.abs(g).max()
    scale_p = 1.0 + np.abs(h).max()
    for _ in range(max_iter):
        r_d = H @ w + g + G.T @ lam
        r_p = G @ w + s - h
        mu = s @ lam / m
        done = (np.abs(r_d).max() <= 1e-10 * scale_d
                and np.abs(r_p).max() <= 1e-10 * scale_p)
        if done and mu <= tol * scale_d:
            return w
        D = lam / s
        try:
            cf = sla.cho_factor(H + G.T @ (D[:, None] * G))
        except np.linalg.LinAlgError:
            # the Newton matrix of a nearly converged iterate: stop there
            return w if done and mu <= 1e4 * tol * scale_d else None

        def step(r_c):
            dw = sla.cho_solve(cf, -r_d - G.T @ (D * r_p + r_c / s))
            dlam = D * (G @ dw + r_p) + r_c / s
            ds = (r_c - s * dlam) / lam
            return dw, ds, dlam

        def max_step(ds, dlam):
            a = 1.0
            for v, dv in ((s, ds), (lam, dlam)):
                neg = dv < 0
                if np.any(neg):
                    a = min(a, np.min(-v[neg] / dv[neg]))
            return a

        dw, ds, dlam = step(-s * lam)
        a = max_step(ds, dlam)
        mu_aff = (s + a * ds) @ (lam + a * dlam) / m
        sigma = (mu_aff / mu) ** 3
        dw, ds, dlam = step(-s * lam - ds * dlam + sigma * mu)
        a = min(1.0, 0.99 * max_step(ds, dlam))
        w, s, lam = w + a * dw, s + a * ds, lam + a * dlam
    return None
