"""Structured interior point, batched: Mehrotra with the Riccati/arrowhead
KKT solve (counterpart of ``rtmpc_tpu/ops/ip_riccati.py``).

Same algorithm as the JAX package's ``ip_riccati_solve`` (see its module
note): the stage variables couple only through the dynamics, so each
Newton system is solved by a backward/forward Riccati sweep over the N
stages, and the tracking block w = (xbar, ubar) is eliminated through a
small (nw + nss) Schur complement whose columns are nw extra sweeps.

The port runs a batch of B instances at once: every tensor carries the
batch as its leading axis (``vmap`` in the JAX package), the N-stage
``lax.scan`` sweeps become Python loops over stages of batched
``(B, ., .)`` products, and the ``lax.while_loop`` becomes a Python loop
with a per-lane ``go`` mask.  Every update goes through ``torch.where``,
so a lane that has stopped keeps its state and its best iterate exactly as
a single-instance run leaves them; the loop ends when no lane is active or
after ``iters`` iterations (one host sync an iteration).

The four inequality groups (stage state rows, stage input rows, the
initial tube, the terminal set) are kept as one flat ``(B, m_i)`` tensor in
that order; ``_split`` gives the per-group views.

Ported: ``prepare_ip_riccati``, the unrolled pivoted LU, the Riccati
factor and solve, the cold-start ``ip_riccati_solve`` (with the
iterative refinement the f32 and free-initial-state solves use) and
``init_ip_state``.  Not ported: the f32->f64 hybrid (the GPU computes in
float64 natively) and the ``state0`` warm starts (the rollout engine
solves cold every step).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..tree import tree_to
from .assembly import QPTemplate

__all__ = ["RiccatiIPSpec", "IPSolution", "prepare_ip_riccati",
           "ip_riccati_solve", "init_ip_state"]


# ---------------------------------------------------------------------------
# Small batched pivoted LU, unrolled (the JAX package's _plu_factor and
# _plu_solve, same pivot choice: the first maximum, rows above k masked)
# ---------------------------------------------------------------------------

def _plu_factor(A: torch.Tensor):
    """Partially pivoted LU of small matrices ``(..., n, n)``.

    Returns ``(M, swaps)``: ``M`` holds U on and above the diagonal and
    the multipliers below it; ``swaps[k]`` is ``(e_k - onehot(p_k), p_k)``,
    the row exchange of step k in the JAX package's arithmetic form and
    its pivot row.  For
    n = 1 there is nothing to exchange or eliminate: the result is A where
    A is finite and non-zero and NaN elsewhere, as the general steps give.
    """
    n = A.shape[-1]
    if n == 1:
        return A + 0.0 * (A / A), []
    dt = A.dtype
    idx = torch.arange(n, device=A.device)
    big = torch.finfo(dt).max
    below_all = [(idx > k).to(dt) for k in range(n)]
    cols_all = [(idx >= k).to(dt) for k in range(n)]
    M = A
    swaps = []
    for k in range(n):
        col = M[..., :, k].abs()
        if k:
            col = col.masked_fill(idx < k, -big)
        p = col.argmax(dim=-1)
        ek = (idx == k).to(dt)
        sw = ek - torch.nn.functional.one_hot(p, n).to(dt)
        rowp = torch.take_along_dim(
            M, p[..., None, None].expand(*p.shape, 1, n), dim=-2)[..., 0, :]
        M = M + sw[..., :, None] * (rowp - M[..., k, :])[..., None, :]
        swaps.append((sw, p))
        piv = M[..., k, k]
        fac = below_all[k] * M[..., :, k] / piv[..., None]
        # eliminate columns >= k only: columns < k hold earlier multipliers
        M = M - fac[..., :, None] * (M[..., k, :] * cols_all[k])[..., None, :]
        M = M + fac[..., :, None] * ek
    return M, swaps


def _plu_solve(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` from ``_plu_factor``; ``b`` is ``(..., n)`` or
    ``(..., n, m)``."""
    M, swaps = fac
    n = M.shape[-1]
    vec = b.dim() == M.dim() - 1
    if vec:
        b = b[..., None]
    if n == 1:
        out = b / M
        return out[..., 0] if vec else out
    for k, (sw, p) in enumerate(swaps):
        rowp = torch.take_along_dim(
            b, p[..., None, None].expand(*p.shape, 1, b.shape[-1]),
            dim=-2)[..., 0, :]
        b = b + sw[..., :, None] * (rowp - b[..., k, :])[..., None, :]
    y = [None] * n
    for i in range(n):
        v = b[..., i, :]
        for kk in range(i):
            v = v - M[..., i, kk][..., None] * y[kk]
        y[i] = v
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for kk in range(i + 1, n):
            v = v - M[..., i, kk][..., None] * x[kk]
        x[i] = v / M[..., i, i][..., None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


# ---------------------------------------------------------------------------
# Problem data
# ---------------------------------------------------------------------------

class RiccatiIPSpec(NamedTuple):
    """Stage-structured IP problem data (tensors, no batch axis).

    Cost matrices carry the template's 1/2 z'Pz convention scaled by the
    scalar ``c_obj``; variables are scaled per component (``Sx``, ``Su``)
    and inequality rows are 2-norm-equilibrated; none of the scalings
    changes the primal.  Shapes encode the structure: ``Ht.shape[0] == 0``
    is a fixed initial state, ``Hww.shape[0] == 0`` no tracking block,
    ``GN.shape[0] == 0`` no terminal rows.
    """
    A: torch.Tensor       # (nx, nx) dynamics
    B: torch.Tensor       # (nx, nu)
    Qx: torch.Tensor      # (nx, nx) stage state cost block
    Ru: torch.Tensor      # (nu, nu) stage input cost block
    QN: torch.Tensor      # (nx, nx) terminal cost block
    Cxw: torch.Tensor     # (nx, nw) stage x_k <-> w cost coupling
    Cuw: torch.Tensor     # (nu, nw) stage u_k <-> w cost coupling
    CNw: torch.Tensor     # (nx, nw) terminal x_N <-> w cost coupling
    Hww: torch.Tensor     # (nw, nw) w cost block
    qw0: torch.Tensor     # (nw,)
    Mqw: torch.Tensor     # (nw, ntheta)  qw = qw0 + Mqw theta
    Ass: torch.Tensor     # (nss, nw) steady-state equality rows (b = 0)
    b00: torch.Tensor     # (nx,) fixed-init b = b00 + Mb0 theta
    Mb0: torch.Tensor     # (nx, ntheta)
    Hx: torch.Tensor      # (mx, nx) stage state rows
    hx: torch.Tensor      # (mx,)
    Hu: torch.Tensor      # (mu, nu)
    hu: torch.Tensor      # (mu,)
    Ht: torch.Tensor      # (mt, nx) initial-tube rows on x_0
    ht0: torch.Tensor     # (mt,)
    Mht: torch.Tensor     # (mt, ntheta)
    GN: torch.Tensor      # (mN, nx) terminal rows, x_N part
    GNw: torch.Tensor     # (mN, nw) terminal rows, w part
    hN: torch.Tensor      # (mN,)
    c_obj: torch.Tensor   # () cost scaling applied at prep
    Sx: torch.Tensor      # (nx,) x_template = Sx * x_internal
    Su: torch.Tensor      # (nu,)

    def to(self, device) -> "RiccatiIPSpec":
        return tree_to(self, device)


class IPSolution(NamedTuple):
    z_primal: torch.Tensor  # (B, n) primal in the template's layout
    r_prim: torch.Tensor    # (B,) primal residual (scaled metric)
    r_dual: torch.Tensor    # (B,) dual residual (scaled metric)
    gap: torch.Tensor       # (B,) complementarity mu


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"prepare_ip_riccati: {what}")


def prepare_ip_riccati(template: QPTemplate, dtype: torch.dtype =
                       torch.float64, device="cpu") -> RiccatiIPSpec:
    """Extract the stage structure from an uncondensed template (NumPy,
    float64, the JAX package's code), then cast to ``dtype`` on
    ``device``.

    Every structural assumption is checked against the flat matrices and
    raises ``ValueError``: besides the JAX package's checks, the stage
    blocks must repeat over every stage (also at N = 1, where the JAX
    package's check reads the terminal block) and the input rows must
    carry no linear cost.
    """
    t = template
    meta = t.row_meta
    _require(meta is not None and t.S is None,
             "needs an uncondensed template built by build_mpc_qp")
    _require(not meta["terminal_eq_fallback"],
             "tracking without a terminal set (x_N == xbar fallback) is "
             "not supported; pass a terminal set")
    nx, nu, N = t.nx, t.nu, t.N
    _require(N >= 1, f"horizon N = {N} < 1")
    nw = nx + nu if t.tracking else 0
    mt, mx, mu_, mN = meta["mt"], meta["mx"], meta["mu"], meta["mN"]
    nss = nx if meta["has_ss"] else 0
    fixed = meta["init_mode"] == "fixed"

    # ---- row slices in build_mpc_qp's emission order ----------------------
    r = 0
    sl_dyn = slice(r, r + N * nx); r += N * nx
    n_init = nx if fixed else mt
    sl_init = slice(r, r + n_init); r += n_init
    sl_ss = slice(r, r + nss); r += nss
    sl_x = slice(r, r + N * mx); r += N * mx
    sl_u = slice(r, r + N * mu_); r += N * mu_
    sl_N = slice(r, r + mN); r += mN
    _require(r == t.m, f"row_meta layout mismatch: {r} != {t.m}")
    _require(bool(t.is_eq[sl_dyn].all()), "dynamics rows must be equalities")
    if fixed:
        _require(bool(t.is_eq[sl_init].all()),
                 "fixed initial-state rows must be equalities")
    else:
        _require(not t.is_eq[sl_init].any(),
                 "initial-tube rows must be inequalities")
    _require(bool(t.is_eq[sl_ss].all()), "steady-state rows must be "
             "equalities")
    _require(not t.is_eq[sl_x].any() and not t.is_eq[sl_u].any()
             and not t.is_eq[sl_N].any(),
             "state, input and terminal rows must be inequalities")

    xs = t.x_slice
    us = t.u_slice
    A = -t.A[sl_dyn][:nx, xs(0)]
    B = -t.A[sl_dyn][:nx, us(0)]

    # ---- cost blocks ------------------------------------------------------
    Qx = t.P[xs(0), xs(0)]
    Ru = t.P[us(0), us(0)]
    QN = t.P[xs(N), xs(N)]
    if t.tracking:
        wsl = slice(t.xbar_slice.start, t.ubar_slice.stop)
        Cxw = t.P[xs(0), wsl]
        Cuw = t.P[us(0), wsl]
        CNw = t.P[xs(N), wsl]
        Hww = t.P[wsl, wsl]
        qw0 = t.q0[wsl]
        Mqw = t.Mq[wsl]
        Ass = t.A[sl_ss][:, wsl]
        _require(np.allclose(t.A[sl_ss][:, :wsl.start], 0),
                 "steady-state rows touch stage variables")
    else:
        Cxw = np.zeros((nx, 0)); Cuw = np.zeros((nu, 0))
        CNw = np.zeros((nx, 0)); Hww = np.zeros((0, 0))
        qw0 = np.zeros(0); Mqw = np.zeros((0, t.ntheta))
        Ass = np.zeros((0, 0))
    # the stage blocks repeat at every stage, and nothing else is in P/q
    for k in range(1, N):
        _require(np.allclose(t.P[xs(k), xs(k)], Qx)
                 and np.allclose(t.P[us(k), us(k)], Ru),
                 f"stage {k} cost blocks differ from stage 0's")
        if t.tracking:
            _require(np.allclose(t.P[xs(k), wsl], Cxw)
                     and np.allclose(t.P[us(k), wsl], Cuw),
                     f"stage {k} tracking coupling differs from stage 0's")
    if N > 1:
        _require(np.allclose(t.P[xs(0), xs(1)], 0),
                 "stage costs couple x_0 and x_1")
    n_stage = us(N - 1).stop          # x_0..x_N and u_0..u_{N-1}
    _require(not t.q0[:n_stage].any() and not t.Mq[:n_stage].any(),
             "stage states or inputs carry a linear cost")

    # ---- inequality groups ------------------------------------------------
    if mx:
        Hx = t.A[sl_x][:mx, xs(0)]
        hx = t.u0[sl_x][:mx]
        if N > 1:
            _require(np.allclose(t.A[sl_x][mx:2 * mx, xs(1)], Hx),
                     "state rows differ between stages")
        _require(not t.Ml[sl_x].any() and not t.Mu[sl_x].any(),
                 "state rows depend on theta")
        _require(not np.isfinite(t.l0[sl_x]).any(),
                 "state rows must be one-sided")
    else:
        Hx = np.zeros((0, nx)); hx = np.zeros(0)
    if mu_:
        Hu = t.A[sl_u][:mu_, us(0)]
        hu = t.u0[sl_u][:mu_]
        _require(not np.isfinite(t.l0[sl_u]).any(),
                 "input rows must be one-sided")
    else:
        Hu = np.zeros((0, nu)); hu = np.zeros(0)
    if fixed:
        Ht = np.zeros((0, nx)); ht0 = np.zeros(0)
        Mht = np.zeros((0, t.ntheta))
        b00 = t.u0[sl_init].copy()
        Mb0 = t.Mu[sl_init].copy()
        _require(np.allclose(t.A[sl_init][:, xs(0)], np.eye(nx)),
                 "fixed initial-state rows must be x_0 = x_init")
    else:
        Ht = t.A[sl_init][:, xs(0)]
        ht0 = t.u0[sl_init].copy()
        Mht = t.Mu[sl_init].copy()
        b00 = np.zeros(nx); Mb0 = np.zeros((nx, t.ntheta))
        _require(not np.isfinite(t.l0[sl_init]).any(),
                 "initial-tube rows must be one-sided")
    if mN:
        GN = t.A[sl_N][:, xs(N)]
        GNw = t.A[sl_N][:, wsl] if t.tracking else np.zeros((mN, 0))
        hN = t.u0[sl_N].copy()
        _require(not np.isfinite(t.l0[sl_N]).any(),
                 "terminal rows must be one-sided")
        _require(not t.Ml[sl_N].any() and not t.Mu[sl_N].any(),
                 "terminal rows depend on theta")
    else:
        GN = np.zeros((0, nx)); GNw = np.zeros((0, nw)); hN = np.zeros(0)

    # ---- scalings (cost scale, per-component variable scale, row norms) --
    c = 1.0 / max(1.0, np.abs(QN).max() if QN.size else 0.0,
                  np.abs(Qx).max(),
                  np.abs(Hww).max() if Hww.size else 0.0)
    Qx, Ru, QN = c * Qx, c * Ru, c * QN
    Cxw, Cuw, CNw, Hww = c * Cxw, c * Cuw, c * CNw, c * Hww
    qw0, Mqw = c * qw0, c * Mqw

    dQx = np.abs(np.diag(Qx))
    dQN = np.abs(np.diag(QN)) if QN.size else dQx
    sxv = 1.0 / np.sqrt(np.sqrt(np.maximum(dQx * np.maximum(dQN, dQx),
                                           1e-16)))
    suv = 1.0 / np.sqrt(np.maximum(np.abs(np.diag(Ru)), 1e-16))
    swv = np.concatenate([sxv, suv]) if nw else np.zeros(0)
    Sx, Su = np.diag(sxv), np.diag(suv)
    Sw = np.diag(swv) if nw else np.zeros((0, 0))
    Sxi = np.diag(1.0 / sxv)
    A = Sxi @ A @ Sx
    B = Sxi @ B @ Su
    Qx, Ru, QN = Sx @ Qx @ Sx, Su @ Ru @ Su, Sx @ QN @ Sx
    Cxw, Cuw, CNw = Sx @ Cxw @ Sw, Su @ Cuw @ Sw, Sx @ CNw @ Sw
    Hww = Sw @ Hww @ Sw
    qw0, Mqw = Sw @ qw0, Sw @ Mqw
    Ass = Ass @ Sw
    b00, Mb0 = Sxi @ b00, Sxi @ Mb0
    Hx, Hu, Ht = Hx @ Sx, Hu @ Su, Ht @ Sx
    GN, GNw = GN @ Sx, GNw @ Sw

    def rnorm(M, *Ms):
        full = np.hstack([M, *Ms]) if Ms else M
        nrm = np.linalg.norm(full, axis=1)
        return np.where(nrm > 0, nrm, 1.0)

    sx = rnorm(Hx) if mx else np.ones(0)
    su = rnorm(Hu) if mu_ else np.ones(0)
    st = rnorm(Ht) if mt else np.ones(0)
    sN = rnorm(GN, GNw) if mN else np.ones(0)
    sss = rnorm(Ass) if nss else np.ones(0)

    def arr(v):
        return torch.tensor(np.array(v, np.float64, order="C"), dtype=dtype,
                            device=device)

    def div(M, s_):
        return M / s_[:, None] if M.shape[0] else M

    return RiccatiIPSpec(
        A=arr(A), B=arr(B),
        Qx=arr(Qx), Ru=arr(Ru), QN=arr(QN),
        Cxw=arr(Cxw), Cuw=arr(Cuw), CNw=arr(CNw),
        Hww=arr(Hww), qw0=arr(qw0), Mqw=arr(Mqw),
        Ass=arr(div(Ass, sss)), b00=arr(b00), Mb0=arr(Mb0),
        Hx=arr(div(Hx, sx)), hx=arr(hx / sx if mx else hx),
        Hu=arr(div(Hu, su)), hu=arr(hu / su if mu_ else hu),
        Ht=arr(div(Ht, st)), ht0=arr(ht0 / st if mt else ht0),
        Mht=arr(div(Mht, st)),
        GN=arr(div(GN, sN)), GNw=arr(div(GNw, sN)),
        hN=arr(hN / sN if mN else hN),
        c_obj=arr(c), Sx=arr(sxv), Su=arr(suv),
    )


# ---------------------------------------------------------------------------
# Riccati sweep: factor once per Newton system, solve many RHS columns
# ---------------------------------------------------------------------------

def _tr(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _riccati_factor(spec: RiccatiIPSpec, Qhat, Rhat, QhatN, reg, fixed):
    """Backward value recursion on the weighted stage blocks
    ``Qhat (B, N, nx, nx)``, ``Rhat (B, N, nu, nu)``, ``QhatN (B, nx, nx)``.

    Returns ``(V0, Vn, Ks, facF, facV0)``: ``Vn[:, k] = V_{k+1}``,
    ``Ks[:, k] = K_k``, ``facF[k]`` the LU of ``F_k`` (kept for the RHS
    sweeps, which the JAX package re-factors), and the LU of ``V0`` for a
    free initial state (None when it is fixed)."""
    A, Bm = spec.A, spec.B
    At, Bt = A.T, Bm.T
    N, nx = Qhat.shape[1], A.shape[0]
    reg_eye = reg * torch.eye(nx, dtype=A.dtype, device=A.device)
    V = QhatN + reg_eye
    Vs, Ks, facF = [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        BtV = Bt @ V
        F = Rhat[:, k] + BtV @ Bm
        G = BtV @ A
        fac = _plu_factor(F)
        K = _plu_solve(fac, G)
        Vn = Qhat[:, k] + At @ (V @ A) - _tr(G) @ K
        Vn = 0.5 * (Vn + _tr(Vn)) + reg_eye
        Vs[k], Ks[k], facF[k] = V, K, fac
        V = Vn
    facV0 = None if fixed else _plu_factor(V)
    return V, torch.stack(Vs, 1), torch.stack(Ks, 1), facF, facV0


def _riccati_solve(spec: RiccatiIPSpec, fact, rx, ru, rd, rxN, dx0=None):
    """Solve the stage KKT for a batch of RHS columns (axis 1).

    In the Riccati convention the stage system is

        Qhat_k x_k - rx_k + [k>0] y_k - A' y_{k+1} = 0
        Rhat_k u_k - ru_k            - B' y_{k+1} = 0
        QhatN x_N - rxN + y_N                     = 0
        x_{k+1} = A x_k + B u_k + rd_k

    with x_0 = dx0 fixed (or free when ``dx0`` is None).
    ``rx``/``rd`` ``(B, R, N, nx)``, ``ru`` ``(B, R, N, nu)``, ``rxN``
    ``(B, R, nx)``.  Returns ``xs (B, R, N+1, nx)``, ``us (B, R, N, nu)``,
    ``ys (B, R, N, nx)`` (the dynamics multipliers y_1..y_N)."""
    A, Bm = spec.A, spec.B
    _, Vn, Ks, facF, facV0 = fact
    N = Vn.shape[1]
    Vrd_all = torch.einsum('brki,bkji->brkj', rd, Vn)   # rd_k V_{k+1}'
    v = -rxN
    vN = v
    gs, vs = [None] * N, [None] * N
    for k in reversed(range(N)):
        Vrd = Vrd_all[:, :, k]
        tB = (Vrd + v) @ Bm
        e = tB - ru[:, :, k]
        gs[k] = _tr(_plu_solve(facF[k], _tr(e)))
        v = -rx[:, :, k] + (v + Vrd) @ A - e @ Ks[:, k]
        vs[k] = v
    if dx0 is None:
        dx0 = -_tr(_plu_solve(facV0, _tr(v)))
    x = dx0
    xs, us = [], []
    for k in range(N):
        u = -(x @ _tr(Ks[:, k])) - gs[k]
        xs.append(x)
        us.append(u)
        x = x @ A.T + u @ Bm.T + rd[:, :, k]
    xs.append(x)
    xs = torch.stack(xs, 2)
    us = torch.stack(us, 2)
    # costates: y_k = -(V_k x_k + v_k), k = 1..N
    vk = torch.stack(vs[1:] + [vN], 2)
    ys = -(torch.einsum('bkij,brkj->brki', Vn, xs[:, :, 1:]) + vk)
    return xs, us, ys


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def _where(mask, new, old):
    """Per-lane select over tensors or tuples of tensors."""
    def sel(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)
    if isinstance(new, torch.Tensor):
        return sel(new, old)
    return tuple(_where(mask, a, b) for a, b in zip(new, old))


def ip_riccati_solve(spec: RiccatiIPSpec, theta: torch.Tensor, N: int,
                     iters: int = 25) -> IPSolution:
    """Mehrotra predictor-corrector with the Riccati/arrowhead KKT solve,
    cold start, for a batch ``theta (B, ntheta)``.

    Returns the primal in the template layout ``[x_0..x_N | u_0..u_{N-1}
    | xbar ubar]`` and the residuals in the scaled metric, like the JAX
    package's ``ip_riccati_solve`` under ``vmap``.
    ``ip_riccati_solve.iterations`` and ``.calls`` count the loop's
    iterations and the calls."""
    dt, dev = spec.A.dtype, spec.A.device
    theta = theta.to(dt)
    Bsz = theta.shape[0]
    nx, nu = spec.B.shape
    nw, nss = spec.Hww.shape[0], spec.Ass.shape[0]
    mx, mu_, mt, mN = (spec.Hx.shape[0], spec.Hu.shape[0],
                       spec.Ht.shape[0], spec.GN.shape[0])
    fixed = mt == 0
    sizes = (N * mx, N * mu_, mt, mN)
    mi = sum(sizes)
    m_total = max(mi, 1)
    eps = torch.finfo(dt).eps
    reg = 10.0 * eps
    kw = dict(dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(*shape, **kw)

    def split(flat):
        gx, gu, gt, gN = torch.split(flat, sizes, dim=1)
        return gx.reshape(Bsz, N, mx), gu.reshape(Bsz, N, mu_), gt, gN

    qw = spec.qw0 + theta @ spec.Mqw.T
    b0 = spec.b00 + theta @ spec.Mb0.T
    ht = spec.ht0 + theta @ spec.Mht.T
    h = torch.cat([spec.hx.repeat(N).expand(Bsz, -1),
                   spec.hu.repeat(N).expand(Bsz, -1), ht,
                   spec.hN.expand(Bsz, -1)], 1)
    GNc = torch.cat([spec.GN, spec.GNw], 1)       # terminal rows on (x_N, w)

    def ineq_products(x, u, w):
        """A_i z of the inequality rows, flat (B, m_i)."""
        return torch.cat([(x[:, :N] @ spec.Hx.T).flatten(1),
                          (u @ spec.Hu.T).flatten(1),
                          x[:, 0] @ spec.Ht.T,
                          x[:, N] @ spec.GN.T + w @ spec.GNw.T], 1)

    def build_factor(lam, s):
        """Weighted stage blocks, Riccati factorization and w-Schur."""
        D = lam / s
        Dx, Du, Dt, DN = split(D)
        Qhat = spec.Qx + spec.Hx.T @ (Dx[..., None] * spec.Hx)
        if mt:
            Qhat = Qhat.clone()
            Qhat[:, 0] += spec.Ht.T @ (Dt[..., None] * spec.Ht)
        Rhat = spec.Ru + spec.Hu.T @ (Du[..., None] * spec.Hu)
        T = GNc.T @ (DN[..., None] * GNc)        # (B, nx+nw, nx+nw)
        QhatN = spec.QN + T[:, :nx, :nx]
        CNd = spec.CNw + T[:, :nx, nx:]
        Hwwd = spec.Hww + T[:, nx:, nx:]
        return finish_factor(Qhat, Rhat, QhatN, CNd, Hwwd) + (D,)

    def finish_factor(Qhat, Rhat, QhatN, CNd, Hwwd):
        fact = _riccati_factor(spec, Qhat, Rhat, QhatN, reg, fixed)
        if not nw:
            return fact, None, None, CNd
        # sensitivity columns: stage solves with rx = -C e_j
        rx_s = -spec.Cxw.T[None, :, None, :].expand(Bsz, nw, N, nx)
        ru_s = -spec.Cuw.T[None, :, None, :].expand(Bsz, nw, N, nu)
        rd_s = zeros(Bsz, nw, N, nx)
        dx0_s = zeros(Bsz, nw, nx) if fixed else None
        xs_s, us_s, ys_s = _riccati_solve(spec, fact, rx_s, ru_s, rd_s,
                                          -_tr(CNd), dx0_s)
        CtZ = (torch.einsum('iw,bjki->bwj', spec.Cxw, xs_s[:, :, :N])
               + torch.einsum('iw,bjki->bwj', spec.Cuw, us_s)
               + torch.einsum('biw,bji->bwj', CNd, xs_s[:, :, N]))
        # w-Schur saddle [[M11, Ass'], [Ass, -reg]], pivoted-LU factored
        M11 = Hwwd + 0.5 * (CtZ + _tr(CtZ))
        M = zeros(Bsz, nw + nss, nw + nss)
        M[:, :nw, :nw] = M11
        M[:, :nw, nw:] = spec.Ass.T
        M[:, nw:, :nw] = spec.Ass
        M[:, nw:, nw:] = -reg * torch.eye(nss, **kw)
        return fact, _plu_factor(M), (xs_s, us_s, ys_s), CNd

    def solve_kkt_once(factpack, rx, ru, rxN, rw, rd, rss, dx0):
        """Raw arrowhead solve for one RHS (no refinement)."""
        fact, M_fac, sens, CNd = factpack
        xsb, usb, ysb = _riccati_solve(
            spec, fact, rx[:, None], ru[:, None], rd[:, None], rxN[:, None],
            None if dx0 is None else dx0[:, None])
        xsb, usb, ysb = xsb[:, 0], usb[:, 0], ysb[:, 0]
        if not nw:
            return xsb, usb, zeros(Bsz, 0), zeros(Bsz, 0), ysb
        Cz = (torch.einsum('iw,bki->bw', spec.Cxw, xsb[:, :N])
              + torch.einsum('iw,bki->bw', spec.Cuw, usb)
              + torch.einsum('biw,bi->bw', CNd, xsb[:, N]))
        sol = _plu_solve(M_fac, torch.cat([rw - Cz, rss], 1))
        dw, dmu = sol[:, :nw], sol[:, nw:]
        xs_s, us_s, ys_s = sens
        dx = xsb + torch.einsum('bjki,bj->bki', xs_s, dw)
        du = usb + torch.einsum('bjki,bj->bki', us_s, dw)
        dy = ysb + torch.einsum('bjki,bj->bki', ys_s, dw)
        return dx, du, dw, dmu, dy

    def apply_kkt(D, dx, du, dw, dmu, dy):
        """Exact Newton-operator application (weights applied row-wise),
        which iterative refinement needs."""
        Dx, Du, Dt, DN = split(D)
        aNd = dx[:, N] @ spec.GN.T + dw @ spec.GNw.T
        ox = (dx[:, :N] @ spec.Qx.T + (dw @ spec.Cxw.T)[:, None]
              + (Dx * (dx[:, :N] @ spec.Hx.T)) @ spec.Hx
              - dy @ spec.A)
        ox = ox.clone()
        ox[:, 0] += (Dt * (dx[:, 0] @ spec.Ht.T)) @ spec.Ht
        ox[:, 1:] += dy[:, :N - 1]
        ou = (du @ spec.Ru.T + (dw @ spec.Cuw.T)[:, None]
              + (Du * (du @ spec.Hu.T)) @ spec.Hu - dy @ spec.B)
        oxN = (dx[:, N] @ spec.QN.T + dw @ spec.CNw.T
               + (DN * aNd) @ spec.GN + dy[:, N - 1])
        ow = (torch.einsum('bki,iw->bw', dx[:, :N], spec.Cxw)
              + torch.einsum('bki,iw->bw', du, spec.Cuw)
              + dx[:, N] @ spec.CNw + dw @ spec.Hww.T
              + (DN * aNd) @ spec.GNw + dmu @ spec.Ass)
        od = dx[:, 1:] - dx[:, :N] @ spec.A.T - du @ spec.B.T
        oss = dw @ spec.Ass.T
        return ox, ou, oxN, ow, od, oss

    # Iterative refinement is an f32 need (and a free-initial-state need);
    # f64 with a fixed initial state solves accurately without it.
    default_refine = 0 if (dt == torch.float64 and fixed) else 1

    def solve_newton(factpack, t, rdx, rdu, rdxN, rdw, re_d, re_ss, re_0,
                     refine=None):
        """One Newton solve with ``refine`` rounds of iterative refinement.
        ``t``: eliminated-inequality terms (flat); ``rd*``: stationarity
        residuals; ``re_*``: equality residuals; the fixed initial state
        enters as dx0 = -re_0.  Returns (dx, du, dw, dmu, dy)."""
        if refine is None:
            refine = default_refine
        D = factpack[4]
        tx, tu, tt, tN = split(t)
        rx_eff = -(rdx + tx @ spec.Hx)
        if mt:
            rx_eff = rx_eff.clone()
            rx_eff[:, 0] += -(tt @ spec.Ht)
        ru_eff = -(rdu + tu @ spec.Hu)
        rxN_eff = -(rdxN + tN @ spec.GN)
        rw_eff = -(rdw + tN @ spec.GNw)
        rd_eff = -re_d
        rss_eff = -re_ss
        dx0 = -re_0 if fixed else None
        d = solve_kkt_once(factpack[:4], rx_eff, ru_eff, rxN_eff, rw_eff,
                           rd_eff, rss_eff, dx0)
        for _ in range(refine):
            ox, ou, oxN, ow, od, oss = apply_kkt(D, *d)
            ex = rx_eff - ox
            if fixed:
                ex = ex.clone()
                ex[:, 0] = 0.0
            e = solve_kkt_once(
                factpack[:4], ex, ru_eff - ou, rxN_eff - oxN, rw_eff - ow,
                rd_eff - od, rss_eff - oss,
                zeros(Bsz, nx) if fixed else None)
            d = tuple(a + b for a, b in zip(d, e))
        return d

    def residuals(x, u, w, y, mu_ss, lam, s):
        """Stationarity/equality/inequality residuals (stage-0
        stationarity omitted with a fixed initial state)."""
        lx, lu, lt, lN = split(lam)
        rdx = (x[:, :N] @ spec.Qx.T + (w @ spec.Cxw.T)[:, None]
               + lx @ spec.Hx)
        if mt:
            rdx[:, 0] += lt @ spec.Ht
        rdx = rdx - y @ spec.A
        rdx[:, 1:] += y[:, :N - 1]
        if fixed:
            rdx[:, 0] = 0.0
        rdu = (u @ spec.Ru.T + (w @ spec.Cuw.T)[:, None] + lu @ spec.Hu
               - y @ spec.B)
        rdxN = (x[:, N] @ spec.QN.T + w @ spec.CNw.T + lN @ spec.GN
                + y[:, N - 1])
        rdw = (torch.einsum('bki,iw->bw', x[:, :N], spec.Cxw)
               + torch.einsum('bki,iw->bw', u, spec.Cuw)
               + x[:, N] @ spec.CNw + w @ spec.Hww.T + qw
               + lN @ spec.GNw + mu_ss @ spec.Ass)
        re_d = x[:, 1:] - x[:, :N] @ spec.A.T - u @ spec.B.T
        re_0 = (x[:, 0] - b0) if fixed else zeros(Bsz, nx)
        re_ss = w @ spec.Ass.T
        ri = ineq_products(x, u, w) + s - h
        return rdx, rdu, rdxN, rdw, re_d, re_0, re_ss, ri

    def kkt_norm(rdx, rdu, rdxN, rdw, re_d=None, re_0=None, re_ss=None):
        parts = [rdx, rdu, rdxN, rdw]
        if re_d is not None:
            parts += [re_d, re_0, re_ss]
        return torch.cat([p.abs().flatten(1) for p in parts]
                         + [zeros(Bsz, 1)], 1).amax(1)

    # ----- initial point: equality-feasible regularized minimizer ----------
    eye_x = torch.eye(nx, **kw)
    Qh0 = (spec.Qx + eye_x).expand(Bsz, N, nx, nx)
    Rh0 = (spec.Ru + torch.eye(nu, **kw)).expand(Bsz, N, nu, nu)
    pack0 = finish_factor(Qh0, Rh0, (spec.QN + eye_x).expand(Bsz, nx, nx),
                          spec.CNw.expand(Bsz, nx, nw),
                          (spec.Hww + torch.eye(nw, **kw)).expand(Bsz, nw,
                                                                  nw))
    pack0 = pack0 + (zeros(Bsz, mi),)
    # refine=0: the start system is deliberately regularized (cost + I)
    x, u, w, _, _ = solve_newton(
        pack0, zeros(Bsz, mi), zeros(Bsz, N, nx), zeros(Bsz, N, nu),
        zeros(Bsz, nx), qw, zeros(Bsz, N, nx), zeros(Bsz, nss), -b0,
        refine=0)
    s = torch.clamp_min(h - ineq_products(x, u, w), 1.0)
    lam = torch.ones(Bsz, mi, **kw)
    y = zeros(Bsz, N, nx)
    mu_ss = zeros(Bsz, nss)

    # freeze floors (see the JAX package): barrier and residual bars
    if dt == torch.float64:
        stop_mu, stop_r, tiny = 1e-18, 1e-11, 1e-25
    else:
        stop_mu, stop_r, tiny = 1e-6, 1e-4, 1e-10

    def max_step(v, dv):
        neg = dv < 0
        ratios = torch.where(neg, -v / torch.where(neg, dv, -1.0), 1.0)
        return torch.cat([ratios, torch.ones(Bsz, 1, **kw)], 1).amin(1)

    def lane(a):
        return a.reshape(Bsz, *([1] * 2))

    cur = (x, u, w, y, mu_ss, lam, s)
    best = cur
    best_score = torch.full((Bsz,), torch.finfo(dt).max, **kw)
    go = torch.ones(Bsz, dtype=torch.bool, device=dev)
    it = 0
    while it < iters and bool(go.any()):
        x, u, w, y, mu_ss, lam, s = cur
        rdx, rdu, rdxN, rdw, re_d, re_0, re_ss, ri = residuals(*cur)
        mu = (lam * s).sum(1) / m_total
        rnorm = kkt_norm(rdx, rdu, rdxN, rdw, re_d, re_0, re_ss)
        # best-iterate tracking: Mehrotra can blow up after passing
        # through an excellent point; the solve returns the best visited
        score = rnorm + mu
        better = go & (score < best_score) & torch.isfinite(score)
        best_score = torch.where(better, score, best_score)
        best = _where(better, cur, best)
        pack = build_factor(lam, s)

        def directions(rc):
            t = (-rc + lam * ri) / s
            dx, du, dw, dmu, dy = solve_newton(pack, t, rdx, rdu, rdxN, rdw,
                                               re_d, re_ss, re_0)
            da = ineq_products(dx, du, dw)
            ds = -ri - da
            dlam = (-rc - lam * ds) / s
            return dx, du, dw, dmu, dy, ds, dlam

        # predictor
        dx_a, du_a, dw_a, dmu_a, dy_a, ds_a, dlam_a = directions(lam * s)
        ap = max_step(s, ds_a)
        ad = max_step(lam, dlam_a)
        mu_aff = ((lam + ad[:, None] * dlam_a)
                  * (s + ap[:, None] * ds_a)).sum(1) / m_total
        sigma = ((mu_aff / torch.clamp_min(mu, eps)) ** 3).clamp(0.0, 1.0)
        # corrector
        rc = lam * s + dlam_a * ds_a - (sigma * mu)[:, None]
        dx, du, dw, dmu, dy, ds, dlam = directions(rc)
        ap = torch.clamp_max(0.99 * max_step(s, ds), 1.0)
        ad = torch.clamp_max(0.99 * max_step(lam, dlam), 1.0)

        # stop once both the barrier and the KKT residuals are down; a
        # non-finite direction is neither applied nor re-attempted
        done = (mu < stop_mu) & (rnorm < stop_r)
        step_ok = torch.isfinite(
            ap + ad + dx.sum((1, 2)) + du.sum((1, 2)) + dw.sum(1)
            + dy.sum((1, 2)) + ds.sum(1) + dlam.sum(1))
        go = (go & ~done & torch.isfinite(mu) & (mu > 0.01 * stop_mu)
              & step_ok)
        new = (x + lane(ap) * dx, u + lane(ap) * du, w + ap[:, None] * dw,
               y + lane(ad) * dy, mu_ss + ad[:, None] * dmu,
               torch.clamp_min(lam + ad[:, None] * dlam, tiny),
               torch.clamp_min(s + ap[:, None] * ds, tiny))
        cur = _where(go, new, cur)
        it += 1
    ip_riccati_solve.iterations += it
    ip_riccati_solve.calls += 1

    # final point: the best iterate visited, unless the last one beats it
    rdx, rdu, rdxN, rdw, re_d, re_0, re_ss, _ = residuals(*cur)
    score_c = (kkt_norm(rdx, rdu, rdxN, rdw, re_d, re_0, re_ss)
               + (cur[5] * cur[6]).sum(1) / m_total)
    take_cur = (score_c < best_score) & torch.isfinite(score_c)
    x, u, w, y, mu_ss, lam, s = _where(take_cur, cur, best)

    # ----- final residuals (scaled metric) ---------------------------------
    prim = [(x[:, 1:] - x[:, :N] @ spec.A.T - u @ spec.B.T).abs().flatten(1),
            ineq_products(x, u, w) - h, zeros(Bsz, 1)]
    if fixed:
        prim.append((x[:, 0] - b0).abs())
    if nss:
        prim.append((w @ spec.Ass.T).abs())
    r_prim = torch.cat(prim, 1).amax(1)
    rdx, rdu, rdxN, rdw, *_ = residuals(x, u, w, y, mu_ss, lam, s)
    r_dual = kkt_norm(rdx, rdu, rdxN, rdw)
    gap = (lam * s).sum(1) / m_total

    # unscale the primal back to template units (x = Sx x~, etc.)
    sw = torch.cat([spec.Sx, spec.Su])[:nw]
    z = torch.cat([(x * spec.Sx).flatten(1), (u * spec.Su).flatten(1),
                   w * sw], 1)
    return IPSolution(z_primal=z, r_prim=r_prim, r_dual=r_dual, gap=gap)


ip_riccati_solve.iterations = 0
ip_riccati_solve.calls = 0


def init_ip_state(spec: RiccatiIPSpec, N: int, batch: int,
                  dtype: Optional[torch.dtype] = None):
    """Neutral interior state (x = 0, s = lam = 1) of ``batch`` instances:
    ``(x, u, w, y, mu_ss, lam, s)`` with ``lam``/``s`` flat ``(B, m_i)``."""
    dt = dtype if dtype is not None else spec.A.dtype
    kw = dict(dtype=dt, device=spec.A.device)
    nx, nu = spec.B.shape
    nw, nss = spec.Hww.shape[0], spec.Ass.shape[0]
    mi = (N * spec.Hx.shape[0] + N * spec.Hu.shape[0] + spec.Ht.shape[0]
          + spec.GN.shape[0])
    return (torch.zeros(batch, N + 1, nx, **kw),
            torch.zeros(batch, N, nu, **kw), torch.zeros(batch, nw, **kw),
            torch.zeros(batch, N, nx, **kw), torch.zeros(batch, nss, **kw),
            torch.ones(batch, mi, **kw), torch.ones(batch, mi, **kw))

