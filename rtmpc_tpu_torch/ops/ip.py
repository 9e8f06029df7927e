"""Batched dense Mehrotra interior point for the canonical MPC QP
(counterpart of ``rtmpc_tpu/ops/ip.py``).

The accuracy mode of the single-instance controllers (``--solver ip``, the
JAX examples' default on the CPU): a primal-dual predictor-corrector with a
fixed iteration count, one dense KKT factorization per instance and
iteration, 1e-8-class residuals on every instance.  The JAX package wrote
it in plain ``jnp`` (no Pallas kernel), so its port is plain PyTorch: the
batch is the leading axis in place of ``vmap``, the factorizations are
``torch.linalg.lu_factor_ex`` / ``lu_solve`` (the ``_ex`` form checks no
error on the host, so an iteration never waits for the device), and a
converged instance freezes by a select, as in the JAX loop.

``prepare_ip`` is the JAX package's host preparation, statement for
statement (Ruiz scaling with the ADMM's ``_ruiz_equilibrate``, the split
into equality and box rows, padding), cast to the requested dtype at the
end.

Problem form (from ``QPTemplate``)::

    minimize   0.5 x' P x + q(theta)' x
    subject to A_e x = b(theta)                    (equality rows)
               lo(theta) <= A_i x <= up(theta)     (box rows, may be one-sided)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..tree import tree_to
from .assembly import QPTemplate
from .precision import DEFAULT_DTYPE
from .qp import PAD_TO, _ruiz_equilibrate

__all__ = ["IPSpec", "IPSolution", "prepare_ip", "ip_solve"]


class IPSpec(NamedTuple):
    """The parametrized IP problem, Ruiz-scaled and padded (the JAX
    package's ``IPSpec``, field for field).  ``Dscale`` is the primal
    unscaling diagonal (``z_template = Dscale * x``)."""
    P: torch.Tensor        # (n_p, n_p)
    q0: torch.Tensor       # (n_p,)
    Mq: torch.Tensor       # (n_p, ntheta)
    Ae: torch.Tensor       # (me_p, n_p)
    b0: torch.Tensor       # (me_p,)
    Mb: torch.Tensor       # (me_p, ntheta)
    Ai: torch.Tensor       # (mi_p, n_p)
    lo0: torch.Tensor      # (mi_p,)
    Mlo: torch.Tensor      # (mi_p, ntheta)
    up0: torch.Tensor      # (mi_p,)
    Mup: torch.Tensor      # (mi_p, ntheta)
    has_lo: torch.Tensor   # (mi_p,) 0/1: finite lower bound
    has_up: torch.Tensor   # (mi_p,) 0/1: finite upper bound
    Dscale: torch.Tensor   # (n_p,)

    def to(self, device) -> "IPSpec":
        return tree_to(self, device)


class IPSolution(NamedTuple):
    z_primal: torch.Tensor  # (B, n_p) unscaled primal
    r_prim: torch.Tensor    # (B,) primal residual (scaled)
    r_dual: torch.Tensor    # (B,) dual residual (scaled)
    gap: torch.Tensor       # (B,) complementarity measure mu


def _rup(v, k):
    return ((v + k - 1) // k) * k


def prepare_ip(template: QPTemplate, dtype: torch.dtype = DEFAULT_DTYPE,
               device="cpu") -> IPSpec:
    """Split the template's rows into equality and box blocks, Ruiz-scale,
    pad to ``PAD_TO``, cast (``rtmpc_tpu/ops/ip.py:prepare_ip`` with its
    defaults)."""
    qc = (np.column_stack([template.q0.reshape(-1, 1), template.Mq])
          if template.Mq.size else template.q0.reshape(-1, 1))
    Ps, As, Dv, Ev, c = _ruiz_equilibrate(template.P, template.A, qc)
    q0_s = c * Dv * template.q0
    Mq_s = c * Dv[:, None] * template.Mq
    fin_l = np.isfinite(template.l0)
    fin_u = np.isfinite(template.u0)
    l0_s = np.where(fin_l, Ev * template.l0, -np.inf)
    u0_s = np.where(fin_u, Ev * template.u0, np.inf)
    Ml_s = Ev[:, None] * template.Ml
    Mu_s = Ev[:, None] * template.Mu

    eq = template.is_eq
    ineq = ~eq
    Ae, Ai = As[eq], As[ineq]
    b0, Mb = u0_s[eq], Mu_s[eq]
    lo0, Mlo = l0_s[ineq], Ml_s[ineq]
    up0, Mup = u0_s[ineq], Mu_s[ineq]
    has_lo = np.isfinite(lo0).astype(np.float64)
    has_up = np.isfinite(up0).astype(np.float64)
    lo0 = np.where(np.isfinite(lo0), lo0, 0.0)
    up0 = np.where(np.isfinite(up0), up0, 0.0)

    n = template.n
    me, mi = Ae.shape[0], Ai.shape[0]
    nt = template.ntheta
    n_p = _rup(n, PAD_TO)
    me_p, mi_p = _rup(max(me, 1), PAD_TO), _rup(max(mi, 1), PAD_TO)
    # each padded equality row gets a unit column on a padded variable
    # (the KKT matrix keeps full rank); make sure enough of them exist
    if n_p - n < me_p - me:
        n_p = _rup(n + (me_p - me), PAD_TO)

    def padm(M, r, cdim):
        out = np.zeros((r, cdim))
        out[:M.shape[0], :M.shape[1]] = M
        return out

    def padv(v, r, fill=0.0):
        out = np.full(r, fill)
        out[:v.shape[0]] = v
        return out

    P_p = padm(Ps, n_p, n_p)
    np.fill_diagonal(P_p[n:, n:], 1.0)
    Ae_p = padm(Ae, me_p, n_p)
    for i in range(me, me_p):
        Ae_p[i, n + (i - me)] = 1.0
    Ai_p = padm(Ai, mi_p, n_p)

    def tensor(a):
        return torch.tensor(np.array(a, order="C"), dtype=dtype,
                            device=device)

    return IPSpec(
        P=tensor(P_p), q0=tensor(padv(q0_s, n_p)),
        Mq=tensor(padm(Mq_s, n_p, nt)),
        Ae=tensor(Ae_p), b0=tensor(padv(b0, me_p)),
        Mb=tensor(padm(Mb, me_p, nt)),
        Ai=tensor(Ai_p), lo0=tensor(padv(lo0, mi_p, fill=-1.0)),
        Mlo=tensor(padm(Mlo, mi_p, nt)),
        up0=tensor(padv(up0, mi_p, fill=1.0)),
        Mup=tensor(padm(Mup, mi_p, nt)),
        has_lo=tensor(padv(has_lo, mi_p, fill=1.0)),
        has_up=tensor(padv(has_up, mi_p, fill=1.0)),
        Dscale=tensor(padv(Dv, n_p, fill=1.0)))


def _max_step(v, dv, mask):
    """Per instance the largest a in (0, 1] with ``v + a dv >= 0`` on the
    masked rows."""
    neg = (dv < 0) & (mask > 0)
    ratios = torch.where(neg, -v / torch.where(neg, dv, -1.0), 1.0)
    return torch.clamp_max(ratios.amin(1), 1.0)


def _kkt(H, Ae, reg_x, reg_y):
    """``[[H + reg_x I, Ae'], [Ae, -reg_y I]]`` for a batch of
    ``H (B, n, n)``."""
    B, n = H.shape[0], H.shape[1]
    me = Ae.shape[0]
    eye_n = torch.eye(n, dtype=H.dtype, device=H.device)
    eye_e = torch.eye(me, dtype=H.dtype, device=H.device)
    return torch.cat([
        torch.cat([H + reg_x * eye_n, Ae.T.expand(B, n, me)], dim=2),
        torch.cat([Ae.expand(B, me, n), (-reg_y * eye_e).expand(B, me, me)],
                  dim=2)], dim=1)


def ip_solve(spec: IPSpec, theta: torch.Tensor, iters: int = 25
             ) -> IPSolution:
    """Mehrotra predictor-corrector for a batch, ``theta (B, ntheta)``,
    ``iters`` iterations (``rtmpc_tpu/ops/ip.py:ip_solve`` under ``vmap``).

    Infinite bounds enter with zero barrier weight through the
    ``has_lo``/``has_up`` masks; an instance whose mu has reached the
    barrier floor (``100 eps^2`` in float64, ``1e-6`` in float32) or gone
    non-finite keeps its iterate from then on."""
    dt = spec.P.dtype
    theta = theta.to(dt)
    B = theta.shape[0]
    q = spec.q0 + theta @ spec.Mq.T
    b = spec.b0 + theta @ spec.Mb.T
    lo = spec.lo0 + theta @ spec.Mlo.T
    up = spec.up0 + theta @ spec.Mup.T
    Ai, Ae, P = spec.Ai, spec.Ae, spec.P
    n = P.shape[0]
    hl, hu = spec.has_lo, spec.has_up
    n_active = torch.clamp_min(hl.sum() + hu.sum(), 1.0)
    eps = torch.finfo(dt).eps
    stop_mu = 100.0 * eps * eps if dt == torch.float64 else 1e-6

    # start: x from the equality-regularized system, unit slacks/duals
    LU0, piv0, _ = torch.linalg.lu_factor_ex(_kkt(P[None], Ae, 1.0,
                                                  1e-8)[0])
    xy = torch.linalg.lu_solve(LU0, piv0, torch.cat([-q, b], dim=1).T).T
    x = xy[:, :n]
    Aix = x @ Ai.T
    su = torch.where(hu > 0, torch.clamp_min(hu * (up - Aix), 1.0), 1.0)
    sl = torch.where(hl > 0, torch.clamp_min(hl * (Aix - lo), 1.0), 1.0)
    # unit multipliers; on a side without a bound they only keep the
    # masked products benign
    lu_ = torch.ones_like(su)
    ll_ = torch.ones_like(sl)
    y = torch.zeros(B, Ae.shape[0], dtype=dt, device=theta.device)

    def mu_of(su_, lu_v, sl_, ll_v):
        return ((hu * su_ * lu_v).sum(1) + (hl * sl_ * ll_v).sum(1)) \
            / n_active

    for _ in range(iters):
        Aix = x @ Ai.T
        rd = x @ P.T + q + y @ Ae + (hu * lu_ - hl * ll_) @ Ai
        re = x @ Ae.T - b
        riu = hu * (Aix + su - up)
        ril = hl * (Aix - sl - lo)
        mu = mu_of(su, lu_, sl, ll_)

        D = hu * lu_ / su + hl * ll_ / sl
        H = P + (Ai.T * D[:, None, :]) @ Ai
        LU, piv, _ = torch.linalg.lu_factor_ex(_kkt(H, Ae, 1e-10, 1e-10))

        def directions(rcu, rcl):
            # (ds, dlam) of both bound sides eliminated:
            #   dsu = -riu - Ai dx,  dsl = ril + Ai dx,
            #   dlam_u = (-rcu - lam_u dsu) / su, dlam_l likewise
            tmp_u = hu * (-rcu + lu_ * riu) / su
            tmp_l = hl * (-rcl - ll_ * ril) / sl
            rhs_x = -rd - (tmp_u - tmp_l) @ Ai
            sol = torch.linalg.lu_solve(
                LU, piv, torch.cat([rhs_x, -re], dim=1)[:, :, None])[:, :, 0]
            dx, dy = sol[:, :n], sol[:, n:]
            dAix = dx @ Ai.T
            dsu = hu * (-riu - dAix)
            dsl = hl * (ril + dAix)
            dlu = hu * (-rcu - lu_ * dsu) / su
            dll = hl * (-rcl - ll_ * dsl) / sl
            return dx, dy, dsu, dsl, dlu, dll

        # predictor
        dx_a, dy_a, dsu_a, dsl_a, dlu_a, dll_a = directions(
            hu * lu_ * su, hl * ll_ * sl)
        ap = torch.minimum(_max_step(su, dsu_a, hu), _max_step(sl, dsl_a, hl))
        ad = torch.minimum(_max_step(lu_, dlu_a, hu),
                           _max_step(ll_, dll_a, hl))
        mu_aff = mu_of(su + ap[:, None] * dsu_a, lu_ + ad[:, None] * dlu_a,
                       sl + ap[:, None] * dsl_a, ll_ + ad[:, None] * dll_a)
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, eps)) ** 3,
                            0.0, 1.0)

        # corrector
        smu = (sigma * mu)[:, None]
        rcu = hu * (lu_ * su + dlu_a * dsu_a - smu)
        rcl = hl * (ll_ * sl + dll_a * dsl_a - smu)
        dx, dy, dsu, dsl, dlu, dll = directions(rcu, rcl)
        ap = torch.clamp_max(0.99 * torch.minimum(
            _max_step(su, dsu, hu), _max_step(sl, dsl, hl)), 1.0)[:, None]
        ad = torch.clamp_max(0.99 * torch.minimum(
            _max_step(lu_, dlu, hu), _max_step(ll_, dll, hl)), 1.0)[:, None]
        # freeze once converged: past the barrier floor the lam/s ratios
        # overflow under the fixed iteration count
        go = ((mu > stop_mu) & torch.isfinite(mu))[:, None]
        x = torch.where(go, x + ap * dx, x)
        y = torch.where(go, y + ad * dy, y)
        su = torch.where(go & (hu > 0), su + ap * dsu, su)
        sl = torch.where(go & (hl > 0), sl + ap * dsl, sl)
        lu_ = torch.where(go & (hu > 0), lu_ + ad * dlu, lu_)
        ll_ = torch.where(go & (hl > 0), ll_ + ad * dll, ll_)

    Aix = x @ Ai.T
    r_prim = torch.maximum(
        (x @ Ae.T - b).abs().amax(1),
        torch.maximum((hu * torch.clamp_min(Aix - up, 0.0)).amax(1),
                      (hl * torch.clamp_min(lo - Aix, 0.0)).amax(1)))
    r_dual = (x @ P.T + q + y @ Ae + (hu * lu_ - hl * ll_) @ Ai
              ).abs().amax(1)
    return IPSolution(z_primal=spec.Dscale * x, r_prim=r_prim,
                      r_dual=r_dual, gap=mu_of(su, lu_, sl, ll_))

