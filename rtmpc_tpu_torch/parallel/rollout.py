"""Closed-loop lossy-network rollout engine, batched (counterpart of
``rtmpc_tpu/parallel/rollout.py``).

A Python loop over time replaces ``lax.scan`` and every tensor carries the
batch as its leading axis in place of ``vmap``.  Per step t, for all B
rollouts at once:

  1. the QP solve from the current estimate: the two-phase ADMM solve,
     warm-started from the previous step's iterate (solver "admm": batched
     PyTorch, ``ops/qp.py``; solver "cuda": one launch of the fused kernel
     per phase, ``ops/qp_cuda.py``), or the structured interior point,
     cold every step (solver "ip_riccati", ``ops/ip_riccati.py``);
  2. the packet ``U_t = [u_nom(0..N-1), ubar + K xbar]``;
  3. the estimator records the optimal initial nominal state;
  4. the actuator processes the packet gated by theta;
  5. the linear plant ``x+ = A x + B u + w``;
  6. the estimator processes the reply gated by gamma.

A rollout whose QP solution goes non-finite is frozen (state kept,
``feasible`` False, timers still advancing).  With
``infeas_mode="certificate"`` (the non-robust arm of the Results apps) a
rollout also freezes once its QP is certified infeasible for
``INFEAS_PERSIST`` consecutive steps: under the ADMM solvers by the
OSQP-style certificates (``ops/qp.py:infeasibility_certificates``, taken
with the spec whose rho produced the final state), under "ip_riccati" by a
final primal residual above 1e-2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.specs import ControllerArrays, ControllerConfig
from ..ops.ip_riccati import ip_riccati_solve
from ..ops.qp import (ADMMSolution, ADMMState, admm_solve,
                      infeasibility_certificates, init_admm_state)
from ..ops.qp_cuda import admm_solve_cuda
from ..protocol.actuator import ActuatorState, actuator_step, init_actuator
from ..protocol.estimator import (EstimatorState, estimator_update,
                                  init_estimator, store_sequence)
from ..tree import tree_map, tree_to

__all__ = ["RolloutCarry", "StepOutputs", "init_carry",
           "make_batched_rollout", "tracking_error_rms"]

# consecutive certified steps that stop an arm (the JAX package's
# infeas_persist default, which every caller keeps): one borderline
# certificate does not flap the arm
INFEAS_PERSIST = 2


class RolloutCarry(NamedTuple):
    x: torch.Tensor           # (B, nx) plant state
    act: ActuatorState
    est: EstimatorState
    admm: Optional[ADMMState]  # ADMM warm-start iterate (None under IP)
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
    return RolloutCarry(
        x=x0,
        act=init_actuator(cfg.N, cfg.nu, x0),
        est=init_estimator(x0),
        admm=(None if cfg.solver == "ip_riccati"
              else init_admm_state(arrays.admm, B)),
        feasible=torch.ones(B, dtype=torch.bool, device=x0.device),
        infeas_count=torch.zeros(B, dtype=torch.int32, device=x0.device))


def _extract_packet(arrays: ControllerArrays, cfg: ControllerConfig,
                    z: torch.Tensor):
    """Encapsulation (``TubeTrackingMPC.encapsulate`` :211-227):
    ``U_t = [u_nom(.), ubar + K xbar]`` (B, N+1, nu), plus the optimal
    initial nominal state x_nom(0) and xbar, each (B, nx)."""
    B = z.shape[0]
    u_traj = z[:, cfg.u_off:cfg.u_off + cfg.N * cfg.nu].reshape(
        B, cfg.N, cfg.nu)
    xbar = z[:, cfg.xbar_off:cfg.xbar_off + cfg.nx]
    ubar = z[:, cfg.ubar_off:cfg.ubar_off + cfg.nu]
    u_ss = ubar + xbar @ arrays.K_ss.T
    U_t = torch.cat([u_traj, u_ss[:, None]], dim=1)
    return U_t, z[:, :cfg.nx], xbar


def _phase_solver(cfg: ControllerConfig) -> Callable:
    return admm_solve_cuda if cfg.solver == "cuda" else admm_solve


def _solve(arrays: ControllerArrays, cfg: ControllerConfig,
           theta_qp: torch.Tensor, warm: Optional[ADMMState]
           ) -> ADMMSolution:
    """Solver "ip_riccati": one cold interior-point solve (the warm state
    passes through).  Otherwise the two-phase schedule as a state
    hand-off: phase 1 at ``admm``, phase 2 at ``admm2`` (rho scaled) from
    phase 1's iterate; residuals are phase 2's."""
    if cfg.solver == "ip_riccati":
        sol = ip_riccati_solve(arrays.ric, theta_qp, cfg.N, iters=cfg.ip_iters)
        return ADMMSolution(z_primal=sol.z_primal, state=warm,
                            r_prim=sol.r_prim, r_dual=sol.r_dual)
    solve = _phase_solver(cfg)
    sol = solve(arrays.admm, theta_qp, warm, iters=cfg.iters)
    if cfg.iters2 > 0:
        sol = solve(arrays.admm2, theta_qp, sol.state, iters=cfg.iters2)
    return sol


def _select(keep, a, b):
    """``a`` where the per-row flag ``keep (B,)`` is set, else ``b``."""
    return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - 1)), a, b)


def _certified_infeasible(arrays: ControllerArrays, cfg: ControllerConfig,
                          theta_qp, sol: ADMMSolution) -> torch.Tensor:
    """The per-step infeasibility verdict of ``infeas_mode="certificate"``
    (``rtmpc_tpu/parallel/rollout.py:324-357``)."""
    if cfg.solver == "ip_riccati":
        # the best-iterate return keeps z finite on infeasible instances:
        # feasible solves land at <= 1e-6, infeasible ones stall >= 1e-2
        return sol.r_prim > 1e-2
    spec = arrays.admm2 if cfg.iters2 > 0 else arrays.admm
    pinf, dinf = infeasibility_certificates(spec, theta_qp, sol.state,
                                            solve=_phase_solver(cfg))
    return pinf | dinf


def _step(arrays: ControllerArrays, cfg: ControllerConfig,
          actuator_mode: str, infeas_mode: Optional[str],
          carry: RolloutCarry, ref_t, w_t, theta_t, gamma_t):
    theta_qp = torch.cat([carry.est.x_hat, ref_t.to(carry.x.dtype)], dim=-1)
    sol = _solve(arrays, cfg, theta_qp, carry.admm)
    z = sol.z_primal
    U_t, x_nom0, _ = _extract_packet(arrays, cfg, z)
    finite = torch.isfinite(z.sum(dim=1))
    bad_now = ~finite
    if infeas_mode == "certificate":
        bad_now = bad_now | _certified_infeasible(arrays, cfg, theta_qp, sol)
    infeas_count = torch.where(bad_now, carry.infeas_count + 1,
                               torch.zeros_like(carry.infeas_count))
    feasible = carry.feasible & (infeas_count < INFEAS_PERSIST) & finite

    est1 = store_sequence(carry.est, U_t, x_nom0)
    u_t, plant_pkt, act_new, aux = actuator_step(
        carry.act, U_t, carry.est.q, x_nom0, carry.x, theta_t,
        arrays.A, arrays.B, arrays.K_ss, arrays.K_plant, cfg.N,
        mode=actuator_mode)
    x_next = carry.x @ arrays.A.T + u_t @ arrays.B.T + w_t
    est_new = estimator_update(est1, plant_pkt, gamma_t, arrays.A, arrays.B,
                               U_t)

    new_carry = RolloutCarry(x=x_next, act=act_new, est=est_new,
                             admm=sol.state, feasible=feasible,
                             infeas_count=infeas_count)
    # a frozen rollout keeps its state, but its timers advance so the
    # indices stay aligned with the time loop
    frozen = RolloutCarry(
        x=carry.x,
        act=carry.act._replace(t=carry.act.t + 1),
        est=carry.est._replace(t=carry.est.t + 1),
        admm=carry.admm, feasible=feasible, infeas_count=infeas_count)
    out_carry = tree_map(lambda a, b: _select(feasible, a, b),
                         new_carry, frozen)
    out = StepOutputs(
        x=out_carry.x, u=u_t, x_nom=aux["x_nom"], x_hat=carry.est.x_hat,
        Theta=aux["Theta"], r_prim=sol.r_prim, r_dual=sol.r_dual,
        feasible=feasible)
    return out_carry, out


def make_batched_rollout(arrays: ControllerArrays, cfg: ControllerConfig,
                         T: int, actuator_mode: str = "consistent",
                         infeas_mode: Optional[str] = None) -> Callable:
    """Build ``rollout(x0, refs, w, theta, gamma) -> (carry, StepOutputs)``.

    Inputs are batch-major: ``x0 (B, nx)``, ``refs``/``w`` ``(B, T, nx)``,
    ``theta``/``gamma`` ``(B, T)`` int32, on the arrays' device.  Outputs
    are batch-major too (``(B, T, .)``), as the JAX batched engine returns
    them.  ``cfg.solver`` picks the QP solve of step 1;
    ``actuator_mode`` is "consistent" or "smart"; ``infeas_mode`` None or
    "certificate" (see the module note)."""
    if infeas_mode not in (None, "certificate"):
        raise ValueError(f"unknown infeas_mode {infeas_mode!r}")

    def rollout(x0, refs, w, theta, gamma):
        carry = init_carry(arrays, cfg, x0)
        w = w.to(carry.x.dtype)
        outs = []
        for t in range(T):
            carry, out = _step(arrays, cfg, actuator_mode, infeas_mode,
                               carry, refs[:, t], w[:, t], theta[:, t],
                               gamma[:, t])
            outs.append(out)
        stacked = tree_map(lambda *a: torch.stack(a, dim=1), *outs)
        return carry, stacked

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
