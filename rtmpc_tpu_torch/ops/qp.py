"""Batched OSQP-style ADMM for the canonical MPC box-QP (counterpart of
``rtmpc_tpu/ops/qp.py``).

Host preparation is the JAX package's NumPy code (Ruiz equilibration,
cost scaling, rho auto-tune on ``default_rng(0)`` probe thetas, padding,
K^{-1} and the composite iteration matrices, all in float64), cast to the
requested dtype at the end, so both packages solve bit-identical data.

On the device, ``admm_solve`` runs the three-matmul iteration of
``_admm_body`` on batch-explicit ``(B, .)`` tensors in place of ``vmap``.
The fused composite form lives in ``ops/qp_cuda.py`` (the CUDA kernel and
its plain PyTorch version).

``infeasibility_certificates`` is the JAX package's OSQP-style primal and
dual infeasibility test, batched.

Not ported yet: the active-set polish and the residual-based early exit;
asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..tree import tree_to
from .assembly import QPTemplate
from .precision import DEFAULT_DTYPE

__all__ = ["ADMMSpec", "ADMMState", "ADMMSolution", "prepare_admm",
           "init_admm_state", "admm_solve", "problem_vectors",
           "infeasibility_certificates"]

# The JAX package's prepare_admm defaults, which every caller of the
# flagship keeps.
RHO_EQ_SCALE = 1e3      # rho multiplier on equality rows
SIGMA = 1e-6            # proximal term on x
PAD_TO = 8              # variables and rows padded to a multiple of this
BIG = 1e20              # stands in for an infinite bound
RHO_CANDIDATES = (0.5, 2.0, 5.0, 15.0, 50.0, 200.0)


class ADMMSpec(NamedTuple):
    """Padded, pre-scaled problem data (n_p padded vars, m_p padded rows).

    The composites are compact: with ``s = rho z - y`` one ADMM linear step
    is ``[xt | zt] = x Gxc + s Gsc - q Kcat``, each of width n_p + m_p.
    """
    Kinv: torch.Tensor      # (n_p, n_p) inverse of P_s + sigma I + A_s' rho A_s
    Ps: torch.Tensor        # (n_p, n_p) scaled quadratic cost
    As: torch.Tensor        # (m_p, n_p) scaled constraint matrix
    rho: torch.Tensor       # (m_p,)
    rho_inv: torch.Tensor   # (m_p,)
    q0: torch.Tensor        # (n_p,) scaled
    Mq: torch.Tensor        # (n_p, ntheta) scaled
    l0: torch.Tensor        # (m_p,) scaled (-big for one-sided)
    Ml: torch.Tensor        # (m_p, ntheta)
    u0: torch.Tensor        # (m_p,)
    Mu: torch.Tensor        # (m_p, ntheta)
    D: torch.Tensor         # (n_p,) primal unscaling diag
    E: torch.Tensor         # (m_p,) row scaling diag
    cinv: torch.Tensor      # () 1/cost-scale (dual unscaling)
    sigma: torch.Tensor     # ()
    alpha: torch.Tensor     # () over-relaxation
    Gxc: torch.Tensor       # (n_p, n_p+m_p) [(sigma Kinv)' | (As sigma Kinv)']
    Gsc: torch.Tensor       # (m_p, n_p+m_p) [(Kinv As')' | (As Kinv As')']
    Kcat: torch.Tensor      # (n_p, n_p+m_p) [Kinv' | Kinv' As']

    def to(self, device) -> "ADMMSpec":
        return tree_to(self, device)


class ADMMState(NamedTuple):
    """Warm-startable batched iterate (scaled space)."""
    x: torch.Tensor         # (B, n_p)
    y: torch.Tensor         # (B, m_p)
    z: torch.Tensor         # (B, m_p)

    def to(self, device) -> "ADMMState":
        return tree_to(self, device)


class ADMMSolution(NamedTuple):
    z_primal: torch.Tensor  # (B, n_p) UNSCALED primal solution
    state: ADMMState        # final iterate for warm starting
    r_prim: torch.Tensor    # (B,) inf-norm primal residual (scaled)
    r_dual: torch.Tensor    # (B,) inf-norm dual residual (scaled)


def _ruiz_equilibrate(P, A, q_cols, iters=15):
    """Modified Ruiz equilibration on [[P, A'], [A, 0]] + cost scaling.

    Returns (Ps, As, D, E, c) with Ps = c D P D, As = E A D.
    """
    n, m = P.shape[0], A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Ps, As = P.copy(), A.copy()
    qc = q_cols.copy()  # running scaled linear-term columns: c * D * q_cols
    for _ in range(iters):
        col = np.maximum(np.abs(Ps).max(axis=0), np.abs(As).max(axis=0)
                         if m else 0.0)
        col[col == 0] = 1.0
        d = 1.0 / np.sqrt(col)
        row = np.abs(As).max(axis=1) if m else np.ones(0)
        row[row == 0] = 1.0
        e = 1.0 / np.sqrt(row)
        Ps = (Ps * d[None, :]) * d[:, None]
        As = (As * d[None, :]) * e[:, None]
        D *= d
        E *= e
        qc = qc * d[:, None]
        # cost scaling (OSQP): gamma from the current scaled cost
        pcol = np.abs(Ps).max(axis=0)
        qn = np.abs(qc).max() if qc.size else 0.0
        gamma = 1.0 / max(np.mean(pcol), max(qn, 1e-6))
        gamma = min(max(gamma, 1e-6), 1e6)
        Ps *= gamma
        qc *= gamma
        c *= gamma
    return Ps, As, D, E, c


def _admm_numpy_trial(Ps, As, q, l, u, rho_vec, sigma, alpha, iters):
    """Host NumPy ADMM (same iteration as the device path) for rho tuning."""
    n, m = Ps.shape[0], As.shape[0]
    K = Ps + sigma * np.eye(n) + (As.T * rho_vec) @ As
    try:
        Kinv = np.linalg.inv(K)
    except np.linalg.LinAlgError:
        return np.inf
    x = np.zeros(n)
    y = np.zeros(m)
    z = np.zeros(m)
    for _ in range(iters):
        rhs = sigma * x - q + As.T @ (rho_vec * z - y)
        xt = Kinv @ rhs
        zt = As @ xt
        x = alpha * xt + (1 - alpha) * x
        z_mix = alpha * zt + (1 - alpha) * z
        z_new = np.clip(z_mix + y / rho_vec, l, u)
        y = y + rho_vec * (z_mix - z_new)
        z = z_new
    r_p = np.max(np.abs(As @ x - z))
    r_d = np.max(np.abs(Ps @ x + q + As.T @ y))
    return max(r_p, r_d)


def prepare_admm(
    template: QPTemplate,
    alpha: float = 1.6,
    dtype: torch.dtype = DEFAULT_DTYPE,
    device="cpu",
    tune_iters: int = 150,
    rho2_scale: Optional[float] = None,
):
    """Host-side preparation: equilibrate, build K^{-1} in float64, pad,
    cast to ``dtype`` on ``device``.

    rho is the first of ``RHO_CANDIDATES`` with the smallest worst-case
    KKT residual of a ``tune_iters``-iteration NumPy trial over the probe
    thetas (zeros and three ``default_rng(0)`` draws).  ``rho2_scale`` set
    returns the pair ``(spec1, spec2)`` of the two-phase schedule: one
    equilibration, every rho of ``spec2`` scaled.
    """
    P, A = template.P, template.A
    n, m = template.n, template.m
    sigma, big = SIGMA, BIG

    qcols = np.column_stack([template.q0.reshape(-1, 1), template.Mq]) \
        if template.Mq.size else template.q0.reshape(-1, 1)
    Ps, As, D, E, c = _ruiz_equilibrate(P, A, qcols)

    rng = np.random.default_rng(0)
    probe_thetas = np.vstack([
        np.zeros((1, template.ntheta)),
        rng.uniform(-2.0, 2.0, size=(3, template.ntheta)),
    ])
    rho, best_score = RHO_CANDIDATES[0], np.inf
    for cand in RHO_CANDIDATES:
        rv = np.where(template.is_eq, cand * RHO_EQ_SCALE, cand)
        score = 0.0
        for th in probe_thetas:
            q_s = c * D * (template.q0 + template.Mq @ th)
            l_s = E * np.where(np.isfinite(template.l0),
                               template.l0 + template.Ml @ th, -big)
            u_s = E * np.where(np.isfinite(template.u0),
                               template.u0 + template.Mu @ th, big)
            score = max(score, _admm_numpy_trial(
                Ps, As, q_s, l_s, u_s, rv, sigma, alpha, tune_iters))
        if score < best_score:
            rho, best_score = cand, score

    rho_vec = np.where(template.is_eq, rho * RHO_EQ_SCALE, rho)

    q0s = c * D * template.q0
    Mqs = c * D[:, None] * template.Mq
    l0s = E * np.where(np.isfinite(template.l0), template.l0,
                       -big / np.maximum(E, 1e-30))
    u0s = E * np.where(np.isfinite(template.u0), template.u0,
                       big / np.maximum(E, 1e-30))
    Mls = E[:, None] * template.Ml
    Mus = E[:, None] * template.Mu

    def rup(v, k):
        return ((v + k - 1) // k) * k

    n_p, m_p = rup(n, PAD_TO), rup(m, PAD_TO)

    def padm(M, r, cdim):
        out = np.zeros((r, cdim))
        out[:M.shape[0], :M.shape[1]] = M
        return out

    def padv(v, r, fill=0.0):
        out = np.full(r, fill)
        out[:v.shape[0]] = v
        return out

    def tensor(a):
        return torch.tensor(np.array(a, order="C"), dtype=dtype,
                            device=device)

    Ps_p = padm(Ps, n_p, n_p)
    np.fill_diagonal(Ps_p[n:, n:], 1.0)
    As_p = padm(As, m_p, n_p)

    def phase_spec(rv, rho_fill):
        K = Ps + sigma * np.eye(n) + (As.T * rv) @ As
        Kinv = np.linalg.inv(K)
        Kinv_p = padm(Kinv, n_p, n_p)
        np.fill_diagonal(Kinv_p[n:, n:], 1.0 / (1.0 + sigma))
        rho_p = padv(rv, m_p, fill=rho_fill)
        M1 = sigma * Kinv_p                    # (n_p, n_p)
        M2 = Kinv_p @ As_p.T                   # (n_p, m_p)
        return ADMMSpec(
            Kinv=tensor(Kinv_p),
            Ps=tensor(Ps_p),
            As=tensor(As_p),
            rho=tensor(rho_p),
            rho_inv=tensor(1.0 / rho_p),
            q0=tensor(padv(q0s, n_p)),
            Mq=tensor(padm(Mqs, n_p, template.ntheta)),
            l0=tensor(padv(l0s, m_p, fill=-1.0)),
            Ml=tensor(padm(Mls, m_p, template.ntheta)),
            u0=tensor(padv(u0s, m_p, fill=1.0)),
            Mu=tensor(padm(Mus, m_p, template.ntheta)),
            D=tensor(padv(D, n_p, fill=1.0)),
            E=tensor(padv(E, m_p, fill=1.0)),
            cinv=tensor(1.0 / c),
            sigma=tensor(sigma),
            alpha=tensor(alpha),
            Gxc=tensor(np.concatenate([M1.T, (As_p @ M1).T], axis=1)),
            Gsc=tensor(np.concatenate([M2.T, (As_p @ M2).T], axis=1)),
            Kcat=tensor(np.concatenate([Kinv_p.T, Kinv_p.T @ As_p.T],
                                       axis=1)),
        )

    spec = phase_spec(rho_vec, rho)
    if rho2_scale is None:
        return spec
    spec2 = phase_spec(rho_vec * rho2_scale, rho * rho2_scale)
    return spec, spec2


def init_admm_state(spec: ADMMSpec, batch: int) -> ADMMState:
    """Cold-start iterate for ``batch`` instances."""
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    kw = dict(dtype=spec.Kinv.dtype, device=spec.Kinv.device)
    return ADMMState(x=torch.zeros(batch, n_p, **kw),
                     y=torch.zeros(batch, m_p, **kw),
                     z=torch.zeros(batch, m_p, **kw))


def problem_vectors(spec: ADMMSpec, theta: torch.Tensor):
    """Per-instance ``(q, l, u)``, each ``(B, .)``, from ``theta (B, ntheta)``."""
    return (spec.q0 + theta @ spec.Mq.T,
            spec.l0 + theta @ spec.Ml.T,
            spec.u0 + theta @ spec.Mu.T)


def admm_solve(spec: ADMMSpec, theta: torch.Tensor,
               state: Optional[ADMMState] = None,
               iters: int = 100,
               polish: bool = False,
               early_tol: Optional[float] = None) -> ADMMSolution:
    """Fixed-count batched solve: ``theta`` is ``(B, ntheta)``, the state
    leaves ``(B, n_p)`` / ``(B, m_p)``; residuals come back ``(B,)``.

    The iteration is ``_admm_body`` of the JAX package with ``A' v``
    written ``v @ A`` for a batch of row vectors ``v``."""
    if polish:
        raise NotImplementedError("admm_solve: polish is not ported yet")
    if early_tol is not None:
        raise NotImplementedError("admm_solve: early_tol is not ported yet")
    theta = theta.to(spec.q0.dtype)
    if state is None:
        state = init_admm_state(spec, theta.shape[0])
    q, l, u = problem_vectors(spec, theta)
    sigma, alpha = spec.sigma, spec.alpha
    x, y, z = state
    for _ in range(iters):
        rhs = sigma * x - q + (spec.rho * z - y) @ spec.As
        xt = rhs @ spec.Kinv.T
        zt = xt @ spec.As.T
        x_new = alpha * xt + (1.0 - alpha) * x
        z_mix = alpha * zt + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_mix + y * spec.rho_inv, l), u)
        y = y + spec.rho * (z_mix - z_new)
        x, z = x_new, z_new
    r_prim = (x @ spec.As.T - z).abs().amax(dim=1)
    r_dual = (x @ spec.Ps.T + q + y @ spec.As).abs().amax(dim=1)
    return ADMMSolution(z_primal=spec.D * x, state=ADMMState(x, y, z),
                        r_prim=r_prim, r_dual=r_dual)


# The JAX package's certificate defaults, which every caller keeps.
CERT_EPS = 1e-3         # primal and dual infeasibility tolerance
CERT_ITERS = 25         # extra iterations whose averaged deltas are tested
CERT_BIG = 1e19         # a bound at or above this counts as infinite


def infeasibility_certificates(spec: ADMMSpec, theta: torch.Tensor,
                               state: ADMMState,
                               solve: Callable = admm_solve):
    """OSQP primal/dual infeasibility certificates from the ADMM deltas
    (``rtmpc_tpu/ops/qp.py:infeasibility_certificates``), batched.

    Runs ``CERT_ITERS = k`` more iterations from ``state`` as one ADMM
    phase through ``solve`` (``admm_solve``, or ``admm_solve_cuda``: one
    kernel launch on the card) and tests the averaged deltas
    ``(state_{+k} - state) / k``
    in the scaled space:

    * primal infeasible (a dy ray certifying an empty feasible set):
      ``|A' dy| <= eps |dy|``, ``u' max(dy, 0) + l' min(dy, 0) <= -eps
      |dy|``, and dy has no component against an infinite bound;
    * dual infeasible (a dx ray of an unbounded objective):
      ``|P dx| <= eps |dx|``, ``q' dx <= -eps |dx|``, and ``A dx`` within
      the recession cone of ``[l, u]``.

    ``theta (B, ntheta)``; returns ``(prim_infeas, dual_infeas)``, each
    ``(B,)`` bool."""
    theta = theta.to(spec.q0.dtype)
    q, l, u = problem_vectors(spec, theta)
    x, y = state.x, state.y
    eps_pinf = eps_dinf = CERT_EPS
    big = CERT_BIG
    new = solve(spec, theta, state, iters=CERT_ITERS).state
    dx = (new.x - x) / float(CERT_ITERS)
    dy = (new.y - y) / float(CERT_ITERS)
    dy_norm = dy.abs().amax(1)
    dx_norm = dx.abs().amax(1)
    tiny = 1e-30

    # primal-infeasibility test on dy; infinite bounds are masked, not
    # multiplied (inf * 0)
    fin_u = torch.isfinite(u) & (u.abs() < big)
    fin_l = torch.isfinite(l) & (l.abs() < big)
    Atdy = (dy @ spec.As).abs().amax(1)
    dy_pos, dy_neg = dy.clamp_min(0.0), dy.clamp_max(0.0)
    sup = (torch.where(fin_u, u, 0.0) * dy_pos
           + torch.where(fin_l, l, 0.0) * dy_neg).sum(1)
    ray_tol = eps_pinf * dy_norm.clamp_min(tiny)
    ok_ray = ((torch.where(fin_u, 0.0, dy_pos).abs().amax(1) <= ray_tol)
              & (torch.where(fin_l, 0.0, dy_neg).abs().amax(1) <= ray_tol))
    prim_infeas = ((dy_norm > tiny) & (Atdy <= eps_pinf * dy_norm)
                   & (sup <= -eps_pinf * dy_norm) & ok_ray)

    # dual-infeasibility test on dx
    Pdx = (dx @ spec.Ps.T).abs().amax(1)
    qdx = (q * dx).sum(1)
    Adx = dx @ spec.As.T
    cone_ok = (torch.where(fin_u & fin_l, Adx, 0.0).abs().amax(1)
               <= eps_dinf * dx_norm.clamp_min(tiny))
    dual_infeas = ((dx_norm > tiny) & (Pdx <= eps_dinf * dx_norm)
                   & (qdx <= -eps_dinf * dx_norm) & cone_ok)
    return prim_infeas, dual_infeas
