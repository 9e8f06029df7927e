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

``polish_solution`` is the JAX package's OSQP-style active-set polish,
batched: one regularised KKT solve per instance on its detected active
set, kept only where it lowers the KKT residual; ``admm_solve(...,
polish=True)`` and the rollout engine (``cfg.polish``) apply it after the
last ADMM phase.  ``admm_solve(..., early_tol=...)`` is the JAX
package's residual early exit under ``vmap``: chunks of ``check_every``
iterations, each lane frozen once its scaled residuals are below the bars.
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
           "infeasibility_certificates", "polish_solution", "apply_polish"]

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
    probe_thetas: Optional[np.ndarray] = None,
):
    """Host-side preparation: equilibrate, build K^{-1} in float64, pad,
    cast to ``dtype`` on ``device``.

    rho is the first of ``RHO_CANDIDATES`` with the smallest worst-case
    KKT residual of a ``tune_iters``-iteration NumPy trial over the probe
    thetas: ``probe_thetas`` (rows of representative parameters), by
    default zeros and three ``default_rng(0)`` draws.  ``rho2_scale`` set
    returns the pair ``(spec1, spec2)`` of the two-phase schedule: one
    equilibration, every rho of ``spec2`` scaled.
    """
    P, A = template.P, template.A
    n, m = template.n, template.m
    sigma, big = SIGMA, BIG

    qcols = np.column_stack([template.q0.reshape(-1, 1), template.Mq]) \
        if template.Mq.size else template.q0.reshape(-1, 1)
    Ps, As, D, E, c = _ruiz_equilibrate(P, A, qcols)

    if probe_thetas is None:
        rng = np.random.default_rng(0)
        probe_thetas = np.vstack([
            np.zeros((1, template.ntheta)),
            rng.uniform(-2.0, 2.0, size=(3, template.ntheta)),
        ])
    probe_thetas = np.atleast_2d(probe_thetas)
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
               early_tol: Optional[float] = None,
               early_dual_factor: float = 25.0,
               check_every: int = 25,
               early_exit: Optional[bool] = None) -> ADMMSolution:
    """Batched solve: ``theta`` is ``(B, ntheta)``, the state leaves
    ``(B, n_p)`` / ``(B, m_p)``; residuals come back ``(B,)``.

    The iteration is ``_admm_body`` of the JAX package with ``A' v``
    written ``v @ A`` for a batch of row vectors ``v``.  Without
    ``early_tol`` it runs ``iters`` iterations.  With it, the JAX
    package's residual early exit under ``vmap``: the loop runs in chunks
    of ``check_every`` iterations while ``iters`` is not spent (so up to
    ``check_every * ceil(iters / check_every)`` iterations); after each
    chunk a lane is done once ``max|As x - z| < early_tol`` and ``max|Ps x
    + q + As' y| < early_tol * early_dual_factor`` (scaled), and a done
    lane keeps its state from then on (``torch.where``, as the vmapped
    ``while_loop`` selects).  ``early_exit``: end the loop once every lane
    is done, which reads the device once a chunk; None (the default) means
    yes unless a CUDA graph is being captured, where the loop runs the
    whole budget to the same iterate.  ``admm_solve.early_calls``,
    ``.chunks`` and ``.max_chunks`` count the early-exit calls, their
    chunks and the most chunks of one call; ``.lane_chunks`` holds the
    last such call's chunks per lane ``(B,)``.

    ``polish=True`` polishes the returned primal and residuals
    (``apply_polish``); the state stays the raw ADMM iterate."""
    theta = theta.to(spec.q0.dtype)
    if state is None:
        state = init_admm_state(spec, theta.shape[0])
    q, l, u = problem_vectors(spec, theta)
    sigma, alpha = spec.sigma, spec.alpha

    def run(x, y, z, n):
        for _ in range(n):
            rhs = sigma * x - q + (spec.rho * z - y) @ spec.As
            xt = rhs @ spec.Kinv.T
            zt = xt @ spec.As.T
            x_new = alpha * xt + (1.0 - alpha) * x
            z_mix = alpha * zt + (1.0 - alpha) * z
            z_new = torch.minimum(torch.maximum(z_mix + y * spec.rho_inv, l),
                                  u)
            y = y + spec.rho * (z_mix - z_new)
            x, z = x_new, z_new
        return x, y, z

    def residuals(x, y, z):
        return ((x @ spec.As.T - z).abs().amax(dim=1),
                (x @ spec.Ps.T + q + y @ spec.As).abs().amax(dim=1))

    x, y, z = state
    if early_tol is None:
        x, y, z = run(x, y, z, iters)
    else:
        if early_exit is None:
            early_exit = not (x.device.type == "cuda"
                              and torch.cuda.is_current_stream_capturing())
        tol_d = early_tol * early_dual_factor
        done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        lane_chunks = torch.zeros(x.shape[0], dtype=torch.int32,
                                  device=x.device)
        it = trips = 0
        while it < iters and (not early_exit or not bool(done.all())):
            xn, yn, zn = run(x, y, z, check_every)
            rp, rd = residuals(xn, yn, zn)
            go = ~done[:, None]
            x = torch.where(go, xn, x)
            y = torch.where(go, yn, y)
            z = torch.where(go, zn, z)
            lane_chunks = lane_chunks + (~done).to(torch.int32)
            done = done | ((rp < early_tol) & (rd < tol_d))
            it += check_every
            trips += 1
        admm_solve.early_calls += 1
        admm_solve.chunks += trips
        admm_solve.max_chunks = max(admm_solve.max_chunks, trips)
        admm_solve.lane_chunks = lane_chunks
    r_prim, r_dual = residuals(x, y, z)
    sol = ADMMSolution(z_primal=spec.D * x, state=ADMMState(x, y, z),
                       r_prim=r_prim, r_dual=r_dual)
    return apply_polish(spec, theta, sol) if polish else sol


admm_solve.early_calls = admm_solve.chunks = admm_solve.max_chunks = 0
admm_solve.lane_chunks = None


# The JAX package's polish default, which every caller keeps.
ACTIVE_TOL = 1e-6       # bound proximity, multiplier sign and equality test
POLISH_REFINE = 2       # iterative-refinement passes a KKT solve
POLISH_PASSES = 3       # active-set correction passes


def polish_solution(spec: ADMMSpec, q, l, u, x, y, z, r_prim, r_dual):
    """OSQP-style active-set polish of a batch of scaled ADMM iterates
    (``rtmpc_tpu/ops/qp.py:polish_solution``), batched over the leading
    axis: ``q``/``x`` ``(B, n_p)``, ``l``/``u``/``y``/``z`` ``(B, m_p)``,
    ``r_prim``/``r_dual`` ``(B,)``.

    Per instance: the active set from the iterate (bound proximity within
    ``max(10 max(r_prim, r_dual), ACTIVE_TOL)``, or a multiplier above
    ``1e-3 max(|y|, 1)``), the bound picked by proximity and then the
    multiplier's sign; a direct solve of the regularised KKT system on it,
    inactive rows replaced by ``-y_i = 0``::

        [ Ps + sx I     (d As)'        ] [x]   [ -q    ]
        [ d As      -(sy d + (1 - d))  ] [y] = [ d b   ]

    (``sx = sy = 100 eps``) by LU with ``POLISH_REFINE`` refinement
    passes; then ``POLISH_PASSES`` corrections (rows whose multiplier has
    the wrong sign leave, rows the polished point violates join) each
    followed by a new solve.  The polished primal is kept only where its
    KKT residual ``max(|clip(As x, l, u) - As x|, |Ps x + q + As' y|)``
    is below ``max(r_prim, r_dual)``.  Returns ``(x, r_prim, r_dual)``."""
    dt, dev = x.dtype, x.device
    n_p, m_p = x.shape[1], spec.As.shape[0]
    As, Ps = spec.As, spec.Ps

    def kkt_res(xv, yv):
        Axv = xv @ As.T
        rp = (torch.minimum(torch.maximum(Axv, l), u) - Axv).abs().amax(1)
        rd = (xv @ Ps.T + q + yv @ As).abs().amax(1)
        return rp, rd

    # active set from the final iterate: the proximity window scales with
    # the accuracy the ADMM reached
    act_tol_z = torch.clamp_min(10.0 * torch.maximum(r_prim, r_dual),
                                ACTIVE_TOL)[:, None]
    act_tol_y = 1e-3 * torch.clamp_min(y.abs().amax(1), 1.0)[:, None]
    near_u = (u - z) < act_tol_z
    near_l = (z - l) < act_tol_z
    act = near_u | near_l | (y.abs() > act_tol_y)
    b_act = torch.where(y < 0, l, u)
    b_act = torch.where(near_l & ~near_u, l, b_act)
    b_act = torch.where(near_u & ~near_l, u, b_act)
    is_eq = (u - l).abs() < ACTIVE_TOL
    eps = torch.finfo(dt).eps
    sig_x = sig_y = eps * 100
    B = x.shape[0]
    K_xx = (Ps + sig_x * torch.eye(n_p, dtype=dt, device=dev)).expand(
        B, n_p, n_p)

    def kkt_solve(act_k, b_k):
        d = act_k.to(dt)
        Ad = As * d[:, :, None]                                  # (B, m, n)
        K = torch.cat([
            torch.cat([K_xx, Ad.transpose(1, 2)], dim=2),
            torch.cat([Ad, torch.diag_embed(-(sig_y * d + (1.0 - d)))],
                      dim=2)], dim=1)
        rhs = torch.cat([-q, d * b_k], dim=1)[:, :, None]
        # the _ex form checks nothing on the host, so a CUDA graph captures
        # it; a singular K gives non-finite values, which ``better`` rejects
        LU, piv, _ = torch.linalg.lu_factor_ex(K)
        s = torch.linalg.lu_solve(LU, piv, rhs)
        for _ in range(POLISH_REFINE):
            s = s + torch.linalg.lu_solve(LU, piv, rhs - K @ s)
        s = s[:, :, 0]
        return s[:, :n_p], s[:, n_p:] * d

    xp, yp = kkt_solve(act, b_act)
    for _ in range(POLISH_PASSES):
        wrong_sign = torch.where(b_act == u, yp < -ACTIVE_TOL,
                                 yp > ACTIVE_TOL) & ~is_eq
        Axp = xp @ As.T
        viol_u = Axp > u + ACTIVE_TOL
        viol_l = Axp < l - ACTIVE_TOL
        act = (act & ~wrong_sign) | viol_u | viol_l | is_eq
        b_act = torch.where(viol_l, l, b_act)
        b_act = torch.where(viol_u, u, b_act)
        xp, yp = kkt_solve(act, b_act)
    rp_p, rd_p = kkt_res(xp, yp)
    better = torch.maximum(rp_p, rd_p) < torch.maximum(r_prim, r_dual)
    return (torch.where(better[:, None], xp, x),
            torch.where(better, rp_p, r_prim),
            torch.where(better, rd_p, r_dual))


def apply_polish(spec: ADMMSpec, theta: torch.Tensor,
                 sol: ADMMSolution) -> ADMMSolution:
    """``sol`` of a batch with its primal and residuals polished
    (``polish_solution`` at the instances' ``theta (B, ntheta)``); the
    state stays the raw ADMM iterate, whose duals would poison the next
    solve's warm start."""
    q, l, u = problem_vectors(spec, theta.to(spec.q0.dtype))
    x, rp, rd = polish_solution(spec, q, l, u, *sol.state, sol.r_prim,
                                sol.r_dual)
    return sol._replace(z_primal=spec.D * x, r_prim=rp, r_dual=rd)


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
