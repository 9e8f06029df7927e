"""Closed-loop lossy-network rollout engine, batched (counterpart of
``rtmpc_tpu/parallel/rollout.py``).

A Python loop over time replaces ``lax.scan`` and every tensor carries the
batch as its leading axis in place of ``vmap``.  Per step t, for all B
rollouts at once:

  1. the QP solve from the current estimate: the two-phase ADMM solve,
     warm-started from the previous step's iterate (solver "admm": batched
     PyTorch, ``ops/qp.py``; solver "cuda": one launch of the fused kernel
     per phase, ``ops/qp_cuda.py``), its primal polished after the last
     phase where ``cfg.polish`` is set, the last phase with the residual
     early exit where ``cfg.early_tol`` is set (solver "admm"), or an
     interior point, cold every step (solver "ip": the dense one,
     ``ops/ip.py``; solver "ip_riccati": the structured one,
     ``ops/ip_riccati.py``; solver "ip_hybrid": the structured one in
     float32, then float64 from its iterate);
  2. the packet ``U_t = [u_nom(0..N-1), ubar + K xbar]``;
  3. the estimator records the optimal initial nominal state;
  4. the actuator processes the packet gated by theta;
  5. the plant: ``x+ = A x + B u + w``, or the caller's ``plant_step``
     (the nonlinear cartpole of ``apps/results_nonlinear.py``);
  6. the estimator processes the reply gated by gamma.

An extended controller (``cfg.extended``, paper Section IV.F) has two QPs:
the normal one and the packet-received one, whose initial tube is
``Z - W``.  A rollout uses the packet-received QP's solution at step t when
the PREVIOUS step's reply arrived (``prev_gamma == 1``, which starts at 1),
its actuator and estimator run in their extended and robust variants, and
under the ADMM solvers both QPs are solved every step so that both warm
starts advance, the unselected one too.  The interior point is cold every
step, so where the two QPs differ in the initial tube's bounds alone (they
do unless ``compat_reference_bug`` is set) it solves once, each rollout
with the bounds of the QP it uses (``_one_solve_spec``).

A rollout whose QP solution goes non-finite is frozen (state kept,
``feasible`` False, timers still advancing).  With
``infeas_mode="certificate"`` (the non-robust arm of the Results apps) a
rollout also freezes once its QP is certified infeasible for
``INFEAS_PERSIST`` consecutive steps: under the ADMM solvers by the
OSQP-style certificates (``ops/qp.py:infeasibility_certificates``, taken
with the spec whose rho produced the final state), under "ip_riccati" and
"ip_hybrid" by a final primal residual above 1e-2, under "ip" by none (the
dense interior point diverges to non-finite values on an infeasible QP, as
in the JAX engine); an extended controller is certified on the QP it used
that step.

``make_batched_rollout``'s rollout resumes from a carry it is given, so a
session advances window by window (``parallel/session.py``).
``make_direct_rollout`` is the non-networked loop of the reference's
example controllers: the QP from the measured state, its first input
applied, optionally with the tube's ancillary law.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.specs import RIC_SOLVERS, ControllerArrays, ControllerConfig
from ..ops.ip import ip_solve
from ..ops.ip_riccati import (RiccatiIPSpec, ip_riccati_solve,
                              ip_riccati_solve_hybrid)
from ..ops.qp import (ADMMSolution, ADMMState, admm_solve, apply_polish,
                      infeasibility_certificates, init_admm_state)
from ..ops.qp_cuda import admm_solve_cuda
from ..protocol.actuator import ActuatorState, actuator_step, init_actuator
from ..protocol.estimator import (EstimatorState, estimator_update,
                                  init_estimator, store_sequence)
from ..tree import tree_map, tree_to
from ..utils.spans import span

__all__ = ["RolloutCarry", "StepOutputs", "DirectOutputs", "init_carry",
           "make_batched_rollout", "make_direct_rollout",
           "tracking_error_rms"]

# consecutive certified steps that stop an arm (the JAX package's
# infeas_persist default, which every caller keeps): one borderline
# certificate does not flap the arm
INFEAS_PERSIST = 2
# the solvers that carry a warm-started ADMM iterate from step to step
ADMM_SOLVERS = ("admm", "cuda")


class RolloutCarry(NamedTuple):
    x: torch.Tensor           # (B, nx) plant state
    act: ActuatorState
    est: EstimatorState
    admm: Optional[ADMMState]  # ADMM warm-start iterate (None under the IPs)
    admm_pr: Optional[ADMMState]  # same, packet-received QP (extended ADMM)
    prev_gamma: torch.Tensor  # (B,) int32 gamma of the previous step
    feasible: torch.Tensor    # (B,) bool
    infeas_count: torch.Tensor  # (B,) int32 consecutive certified steps

    def to(self, device) -> "RolloutCarry":
        return tree_to(self, device)


class StepOutputs(NamedTuple):
    x: torch.Tensor           # (B, nx) plant state AFTER the step (x_{t+1})
    u: torch.Tensor           # (B, nu) applied input
    x_nom: torch.Tensor       # (B, nx) actuator nominal state at step t
    x_hat: torch.Tensor       # (B, nx) estimate the controller used at step t
    Theta: torch.Tensor       # (B,) int32 consistency indicator
    r_prim: torch.Tensor      # (B,) QP primal residual (scaled)
    r_dual: torch.Tensor      # (B,) QP dual residual (scaled)
    feasible: torch.Tensor    # (B,) bool after this step


def init_carry(arrays: ControllerArrays, cfg: ControllerConfig,
               x0: torch.Tensor) -> RolloutCarry:
    """Initial carry for the batch of initial states ``x0 (B, nx)``."""
    x0 = x0.to(dtype=arrays.A.dtype, device=arrays.A.device)
    B = x0.shape[0]
    admm = cfg.solver in ADMM_SOLVERS
    return RolloutCarry(
        x=x0,
        act=init_actuator(cfg.N, cfg.nu, x0),
        est=init_estimator(x0),
        admm=init_admm_state(arrays.admm, B) if admm else None,
        admm_pr=(init_admm_state(arrays.admm_pr, B)
                 if admm and cfg.extended else None),
        # 1: step 0 of an extended controller uses the packet-received QP
        prev_gamma=torch.ones(B, dtype=torch.int32, device=x0.device),
        feasible=torch.ones(B, dtype=torch.bool, device=x0.device),
        infeas_count=torch.zeros(B, dtype=torch.int32, device=x0.device))


def _extract_packet(arrays: ControllerArrays, cfg: ControllerConfig,
                    z: torch.Tensor):
    """Encapsulation (``TubeTrackingMPC.encapsulate`` :211-227):
    ``U_t = [u_nom(.), ubar + K xbar]`` (B, N+1, nu), plus the optimal
    initial nominal state x_nom(0) and xbar, each (B, nx); a regulator
    (no tracking block) has ``xbar = 0`` and a zero terminal input."""
    B = z.shape[0]
    u_traj = z[:, cfg.u_off:cfg.u_off + cfg.N * cfg.nu].reshape(
        B, cfg.N, cfg.nu)
    if cfg.tracking:
        xbar = z[:, cfg.xbar_off:cfg.xbar_off + cfg.nx]
        ubar = z[:, cfg.ubar_off:cfg.ubar_off + cfg.nu]
        u_ss = ubar + xbar @ arrays.K_ss.T
    else:
        xbar = z.new_zeros(B, cfg.nx)
        u_ss = z.new_zeros(B, cfg.nu)
    U_t = torch.cat([u_traj, u_ss[:, None]], dim=1)
    return U_t, z[:, :cfg.nx], xbar


def _phase_solver(cfg: ControllerConfig) -> Callable:
    return admm_solve_cuda if cfg.solver == "cuda" else admm_solve


def _solve(arrays: ControllerArrays, cfg: ControllerConfig,
           theta_qp: torch.Tensor, warm: Optional[ADMMState],
           pr: bool = False, ric: Optional[RiccatiIPSpec] = None
           ) -> ADMMSolution:
    """One QP solve for the batch, of the packet-received QP if ``pr``.

    Solver "ip_riccati": one cold interior-point solve (the warm state
    passes through) on ``ric`` if given, else on the arrays' spec; solver
    "ip_hybrid" likewise, one cold hybrid solve (``cfg.ip_iters`` float32
    then ``cfg.ip_hybrid_iters`` float64 iterations), its primal and
    residuals cast to the engine's dtype
    (``rtmpc_tpu/parallel/rollout.py:143-170``); solver "ip" one cold
    solve on the dense interior point's spec.  Otherwise the two-phase
    schedule as a state hand-off: phase 1 at ``admm``, phase 2 at
    ``admm2`` (rho scaled) from phase 1's iterate; residuals are phase
    2's; ``cfg.early_tol`` reaches the last phase only (phase 2, else the
    single phase, ``rtmpc_tpu/parallel/rollout.py:171-190``); with
    ``cfg.polish`` the primal and residuals are polished on the last
    phase's spec (``rtmpc_tpu/parallel/rollout.py:407-416``).  A
    condensed controller's primal comes back in the full layout
    (``_recover``)."""
    if cfg.solver == "ip":
        sol = ip_solve(arrays.ip_pr if pr else arrays.ip, theta_qp,
                       iters=cfg.ip_iters)
        return _recover(arrays, cfg, ADMMSolution(
            z_primal=sol.z_primal, state=warm, r_prim=sol.r_prim,
            r_dual=sol.r_dual), pr)
    if cfg.solver in RIC_SOLVERS:
        if ric is None:
            ric = arrays.ric_pr if pr else arrays.ric
        if cfg.solver == "ip_hybrid":
            sol = ip_riccati_solve_hybrid(ric, theta_qp, cfg.N,
                                          iters32=cfg.ip_iters,
                                          iters64=cfg.ip_hybrid_iters)
        else:
            sol = ip_riccati_solve(ric, theta_qp, cfg.N, iters=cfg.ip_iters)
        edt = arrays.A.dtype
        return ADMMSolution(z_primal=sol.z_primal.to(edt), state=warm,
                            r_prim=sol.r_prim.to(edt),
                            r_dual=sol.r_dual.to(edt))
    spec, spec2 = ((arrays.admm_pr, arrays.admm2_pr) if pr
                   else (arrays.admm, arrays.admm2))
    solve = _phase_solver(cfg)
    early = ({} if cfg.early_tol is None else dict(
        early_tol=cfg.early_tol, early_dual_factor=cfg.early_dual_factor,
        check_every=cfg.check_every))
    sol = solve(spec, theta_qp, warm, iters=cfg.iters,
                **({} if cfg.iters2 > 0 else early))
    if cfg.iters2 > 0:
        sol = solve(spec2, theta_qp, sol.state, iters=cfg.iters2, **early)
        spec = spec2
    if cfg.polish:
        sol = apply_polish(spec, theta_qp, sol)
    return _recover(arrays, cfg, sol, pr)


def _recover(arrays: ControllerArrays, cfg: ControllerConfig,
             sol: ADMMSolution, pr: bool) -> ADMMSolution:
    """A condensed controller's primal mapped back to the full layout,
    ``z_full = S_rec v`` (``rtmpc_tpu/parallel/rollout.py:119-128``), so
    every offset downstream holds; a full controller's as it is."""
    if not cfg.n_red:
        return sol
    S, n_red = ((arrays.S_rec_pr, cfg.n_red_pr) if pr
                else (arrays.S_rec, cfg.n_red))
    return sol._replace(z_primal=sol.z_primal[:, :n_red] @ S.T)


def _select(keep, a, b):
    """``a`` where the per-row flag ``keep (B,)`` is set, else ``b``."""
    return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)), a, b)


def _certified_infeasible(arrays: ControllerArrays, cfg: ControllerConfig,
                          theta_qp, sol: ADMMSolution,
                          pr: bool = False) -> torch.Tensor:
    """The per-step infeasibility verdict of ``infeas_mode="certificate"``
    (``rtmpc_tpu/parallel/rollout.py:324-357``) on one QP's solution."""
    if cfg.solver == "ip":
        # the dense interior point diverges to non-finite values instead,
        # which the step's finite check catches
        return torch.zeros_like(sol.r_prim, dtype=torch.bool)
    if cfg.solver in RIC_SOLVERS:
        # the best-iterate return keeps z finite on infeasible instances:
        # feasible solves land at <= 1e-6, infeasible ones stall >= 1e-2
        return sol.r_prim > 1e-2
    # the spec whose rho produced the final state
    spec = ((arrays.admm2_pr if pr else arrays.admm2) if cfg.iters2 > 0
            else (arrays.admm_pr if pr else arrays.admm))
    pinf, dinf = infeasibility_certificates(spec, theta_qp, sol.state,
                                            solve=_phase_solver(cfg))
    return pinf | dinf


def _one_solve_eligible(arrays: ControllerArrays,
                        cfg: ControllerConfig) -> bool:
    """Whether an extended controller under the structured interior point
    ("ip_riccati", "ip_hybrid") can solve once a step: the two QPs' specs
    are equal in every field but the initial tube's bounds ``ht0``."""
    if not (cfg.extended and cfg.solver in RIC_SOLVERS):
        return False
    return all(f == "ht0" or (a.shape == b.shape and torch.equal(a, b))
               for f, a, b in zip(RiccatiIPSpec._fields, arrays.ric,
                                  arrays.ric_pr))


def _one_solve_spec(arrays: ControllerArrays,
                    use_pr: torch.Tensor) -> RiccatiIPSpec:
    """The interior point's spec with each rollout's own initial-tube
    bounds: the packet-received QP's where ``use_pr (B,)``, else the normal
    QP's (``ht0`` becomes ``(B, mt)``; the solve broadcasts it)."""
    return arrays.ric._replace(
        ht0=_select(use_pr, arrays.ric_pr.ht0.expand(use_pr.shape[0], -1),
                    arrays.ric.ht0))


def _solve_step(arrays: ControllerArrays, cfg: ControllerConfig,
                infeas_mode: Optional[str], one_solve: bool,
                carry: RolloutCarry, theta_qp: torch.Tensor):
    """The solve stage of a step: ``(sol, admm_pr_new, cert_bad)``, where
    ``sol`` holds the solution the step uses (an extended controller's
    pick on the previous step's gamma) and the normal QP's warm state,
    ``admm_pr_new`` the packet-received QP's, and ``cert_bad (B,)`` the
    infeasibility verdict on the QP that was used (False without
    ``infeas_mode``)."""
    certify = infeas_mode == "certificate"
    no_cert = torch.zeros_like(carry.feasible)
    use_pr = carry.prev_gamma == 1
    if not cfg.extended or one_solve:
        ric = _one_solve_spec(arrays, use_pr) if one_solve else None
        sol = _solve(arrays, cfg, theta_qp, carry.admm, ric=ric)
        bad = (_certified_infeasible(arrays, cfg, theta_qp, sol)
               if certify else no_cert)
        return sol, carry.admm_pr, bad
    sol = _solve(arrays, cfg, theta_qp, carry.admm)
    sol_pr = _solve(arrays, cfg, theta_qp, carry.admm_pr, pr=True)
    bad = no_cert
    if certify:
        bad = _select(use_pr,
                      _certified_infeasible(arrays, cfg, theta_qp, sol_pr,
                                            pr=True),
                      _certified_infeasible(arrays, cfg, theta_qp, sol))
    used = ADMMSolution(
        z_primal=_select(use_pr, sol_pr.z_primal, sol.z_primal),
        state=sol.state,
        r_prim=_select(use_pr, sol_pr.r_prim, sol.r_prim),
        r_dual=_select(use_pr, sol_pr.r_dual, sol.r_dual))
    return used, sol_pr.state, bad


def _step(arrays: ControllerArrays, cfg: ControllerConfig,
          actuator_mode: str, infeas_mode: Optional[str],
          plant_step: Callable, one_solve: bool,
          carry: RolloutCarry, ref_t, w_t, theta_t, gamma_t):
    with span("solve"):
        theta_qp = torch.cat([carry.est.x_hat, ref_t.to(carry.x.dtype)],
                             dim=-1)
        sol, admm_pr_new, cert_bad = _solve_step(arrays, cfg, infeas_mode,
                                                 one_solve, carry, theta_qp)
    # the packet, the estimator's store, the actuator, the plant, the
    # estimator's update and the freeze
    with span("protocol"):
        z = sol.z_primal
        U_t, x_nom0, _ = _extract_packet(arrays, cfg, z)
        finite = torch.isfinite(z.sum(dim=1))
        bad_now = cert_bad | ~finite
        infeas_count = torch.where(bad_now, carry.infeas_count + 1,
                                   torch.zeros_like(carry.infeas_count))
        feasible = carry.feasible & (infeas_count < INFEAS_PERSIST) & finite

        est1 = store_sequence(carry.est, U_t, x_nom0)
        u_t, plant_pkt, act_new, aux = actuator_step(
            carry.act, U_t, carry.est.q, x_nom0, carry.x, theta_t,
            arrays.A, arrays.B, arrays.K_ss, arrays.K_plant, cfg.N,
            mode=actuator_mode, extended=cfg.extended)
        x_next = plant_step(carry.x, u_t, w_t)
        est_new = estimator_update(est1, plant_pkt, gamma_t, arrays.A,
                                   arrays.B, U_t, robust=cfg.extended)

        new_carry = RolloutCarry(x=x_next, act=act_new, est=est_new,
                                 admm=sol.state, admm_pr=admm_pr_new,
                                 prev_gamma=gamma_t, feasible=feasible,
                                 infeas_count=infeas_count)
        # a frozen rollout keeps its state, but its timers advance so the
        # indices stay aligned with the time loop
        frozen = RolloutCarry(
            x=carry.x,
            act=carry.act._replace(t=carry.act.t + 1),
            est=carry.est._replace(t=carry.est.t + 1),
            admm=carry.admm, admm_pr=carry.admm_pr, prev_gamma=gamma_t,
            feasible=feasible, infeas_count=infeas_count)
        out_carry = tree_map(lambda a, b: _select(feasible, a, b),
                             new_carry, frozen)
        out = StepOutputs(
            x=out_carry.x, u=u_t, x_nom=aux["x_nom"], x_hat=carry.est.x_hat,
            Theta=aux["Theta"], r_prim=sol.r_prim, r_dual=sol.r_dual,
            feasible=feasible)
    return out_carry, out


def make_batched_rollout(arrays: ControllerArrays, cfg: ControllerConfig,
                         T: int, actuator_mode: str = "consistent",
                         infeas_mode: Optional[str] = None,
                         plant_step: Optional[Callable] = None,
                         one_solve: Optional[bool] = None) -> Callable:
    """Build ``rollout(x0, refs, w, theta, gamma, carry0=None) -> (carry,
    StepOutputs)``.

    Inputs are batch-major: ``x0 (B, nx)``, ``refs``/``w`` ``(B, T, nx)``,
    ``theta``/``gamma`` ``(B, T)`` int32, on the arrays' device.  Outputs
    are batch-major too (``(B, T, .)``), as the JAX batched engine returns
    them.  ``carry0`` resumes from a carry (``x0`` is then ignored), as
    JAX's ``make_rollout_fn`` does: T steps from a carry equal the same
    steps inside one longer rollout.  ``cfg.solver`` picks the QP solve of step 1;
    ``actuator_mode`` is "consistent" or "smart"; ``infeas_mode`` None or
    "certificate" (see the module note); ``plant_step(x (B, nx), u (B, nu),
    w (B, nx)) -> x_next`` defaults to the linear plant; ``one_solve`` (an
    extended controller under "ip_riccati" or "ip_hybrid": one solve a
    step with per-rollout bounds, see the module note) defaults to
    wherever the two QPs allow it, and False solves both and selects."""
    if infeas_mode not in (None, "certificate"):
        raise ValueError(f"unknown infeas_mode {infeas_mode!r}")
    if plant_step is None:
        def plant_step(x, u, w):
            return x @ arrays.A.T + u @ arrays.B.T + w
    eligible = _one_solve_eligible(arrays, cfg)
    if one_solve is None:
        one_solve = eligible
    elif one_solve and not eligible:
        raise ValueError("one_solve needs an extended controller under "
                         "solver 'ip_riccati' or 'ip_hybrid' whose two QPs "
                         "differ in the initial tube's bounds alone")

    def rollout(x0, refs, w, theta, gamma, carry0=None):
        carry = init_carry(arrays, cfg, x0) if carry0 is None else carry0
        w = w.to(carry.x.dtype)
        outs = []
        for t in range(T):
            carry, out = _step(arrays, cfg, actuator_mode, infeas_mode,
                               plant_step, one_solve, carry, refs[:, t],
                               w[:, t], theta[:, t], gamma[:, t])
            outs.append(out)
        stacked = tree_map(lambda *a: torch.stack(a, dim=1), *outs)
        return carry, stacked

    return rollout


class DirectOutputs(NamedTuple):
    x: torch.Tensor           # (B, T, nx) plant state AFTER each step
    u: torch.Tensor           # (B, T, nu) applied input
    x_nom: torch.Tensor       # (B, T, nx) optimal initial nominal state
    xbar: torch.Tensor        # (B, T, nx) artificial steady state (0 if none)
    r_prim: torch.Tensor      # (B, T) QP primal residual (scaled)
    r_dual: torch.Tensor      # (B, T) QP dual residual (scaled)


def make_direct_rollout(arrays: ControllerArrays, cfg: ControllerConfig,
                        T: int, ancillary: bool = False,
                        plant_step: Optional[Callable] = None) -> Callable:
    """Build ``rollout(x0, refs, w) -> ((x_T, warm), DirectOutputs)``, the
    non-networked closed loop (``rtmpc_tpu/parallel/rollout.py:
    make_direct_rollout``): each step solves the QP from the MEASURED state
    and applies its first input, ``u = u*_0`` (the loops of the
    reference's regulator and tracking examples), or with ``ancillary``
    Mayne's tube law ``u = u*_0 - K (x - x*_nom0)`` (its tube examples).

    Batch-major: ``x0 (B, nx)``, ``refs``/``w`` ``(B, T, nx)``.  The ADMM
    solvers warm-start each solve from the previous one (``warm``, None
    under the interior points)."""
    if plant_step is None:
        def plant_step(x, u, w):
            return x @ arrays.A.T + u @ arrays.B.T + w

    def rollout(x0, refs, w):
        x = x0.to(dtype=arrays.A.dtype, device=arrays.A.device)
        w = w.to(x.dtype)
        warm = (init_admm_state(arrays.admm, x.shape[0])
                if cfg.solver in ADMM_SOLVERS else None)
        outs = []
        for t in range(T):
            theta_qp = torch.cat([x, refs[:, t].to(x.dtype)], dim=-1)
            sol = _solve(arrays, cfg, theta_qp, warm)
            z = sol.z_primal
            u = z[:, cfg.u_off:cfg.u_off + cfg.nu]
            x_nom0 = z[:, :cfg.nx]
            if ancillary:
                u = u - (x - x_nom0) @ arrays.K_plant.T
            xbar = (z[:, cfg.xbar_off:cfg.xbar_off + cfg.nx] if cfg.tracking
                    else torch.zeros_like(x))
            x = plant_step(x, u, w[:, t])
            warm = sol.state
            outs.append(DirectOutputs(x, u, x_nom0, xbar, sol.r_prim,
                                      sol.r_dual))
        stacked = tree_map(lambda *a: torch.stack(a, dim=1), *outs)
        return (x, warm), stacked

    return rollout


def tracking_error_rms(x0, xs, refs, feasible=None):
    """The reference's RMS tracking-error metric
    (``results_linear_system.py:291``) over t = 0..T-1 (x0 included, the
    final state left out):

        1/T * sqrt( sum_t (x_1(t) - ref(t))^2 + sum_{j>=2} x_j(t)^2 )

    ``xs``: ``(..., T, nx)`` post-step states; ``refs``: ``(..., T, nx)``;
    ``x0``: ``(..., nx)``.  NaN where ``feasible`` is False."""
    traj = torch.cat([x0.unsqueeze(-2), xs[..., :-1, :]], dim=-2)
    T = traj.shape[-2]
    err2 = ((traj[..., 0] - refs[..., 0]) ** 2).sum(dim=-1)
    err2 = err2 + (traj[..., 1:] ** 2).sum(dim=(-2, -1))
    err = torch.sqrt(err2) / T
    if feasible is not None:
        err = torch.where(feasible, err, torch.full_like(err, float("nan")))
    return err
