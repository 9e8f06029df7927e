"""Sequential float64 NumPy oracle of the full lossy-network protocol (the
port's own copy of the JAX repo's ``tests/oracle_protocol.py``).

An *independent* re-implementation of the reference's per-step loop
(SmartActuator/ConsistentActuator/Estimator/RobustEstimator semantics,
SURVEY.md section 3.2/3.3) in the most literal style possible: Python
lists, dict packets, explicit branches, one rollout at a time, every MPC
QP solved by the float64 dense interior point
(``QPTemplate.solve_dense``, ``utils/qp_ref.py``).  It calls nothing of
the port's engine (``parallel/``, ``ops/qp*.py``, ``protocol/``): the
batched, branchless rollout is held against it, so a protocol slip the
engine shares with its own float64 path still shows here.  Used by the
hardware parity gate (``apps/device_checks.py``) and its tests.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..models.specs import MPCSetup

__all__ = ["OracleActuator", "OracleEstimator", "oracle_solve",
           "run_oracle_rollout"]


class OracleActuator:
    """ConsistentActuator/SmartActuator semantics (``SmartActuator.py``)."""

    def __init__(self, setup: MPCSetup, x0, mode="consistent",
                 extended=False):
        self.K_ss = setup.K
        self.K_plant = (setup.ancillary_gain()
                        if mode == "consistent" else None)
        self.A, self.B = setup.A, setup.B
        self.N = setup.N
        self.mode = mode
        self.extended = extended
        self.t = 0
        self.q = 0
        self.s = 0
        self.theta_hist = []
        self.Theta = 0
        self.u_buf = None
        self.x_nom = np.asarray(x0, float).reshape(-1).copy()

    def process_packet(self, packet, x_t, theta_t):
        x_t = np.asarray(x_t, float).reshape(-1)
        self.theta_hist.append(theta_t)
        # update_Theta_t (eq. 17): product over theta[q+1 : t] inclusive
        if theta_t == 1:
            self.q = packet["q_t"]
            self.Theta = int(np.prod(self.theta_hist[self.q + 1:]))
        else:
            self.Theta = 0
        # update_s_t (eq. 18)
        self.s = int(self.Theta * self.t + (1 - self.Theta) * self.s)
        # accept
        if self.Theta == 1:
            self.u_buf = np.asarray(packet["U_t"], float)  # (nu, N+1)
            if self.extended and packet.get("x_nom_0") is not None:
                self.x_nom = np.asarray(packet["x_nom_0"],
                                        float).reshape(-1).copy()
        # nominal state used at THIS step (after any extended reset)
        x_nom_t = self.x_nom.copy()
        # playback / terminal law
        law_state = self.x_nom if self.mode == "consistent" else x_t
        idx = self.t - self.s
        if idx < self.N:
            u_nom = self.u_buf[:, idx]
        else:
            u_nom = self.u_buf[:, -1] - self.K_ss @ law_state
        if self.mode == "consistent":
            u = u_nom - self.K_plant @ (x_t - self.x_nom)
            if self.extended:
                reply = {"x_t": x_t.copy(), "s_t": self.s,
                         "x_nom_t": self.x_nom.copy()}
            else:
                reply = {"x_t": self.x_nom.copy(), "s_t": self.s}
            self.x_nom = self.A @ self.x_nom + self.B @ u_nom
        else:
            u = u_nom
            reply = {"x_t": x_t.copy(), "s_t": self.s}
        self.t += 1
        return u, reply, x_nom_t


class OracleEstimator:
    """Estimator/RobustEstimator semantics (``Estimator.py``)."""

    def __init__(self, setup: MPCSetup, x0, robust=False):
        self.A, self.B = setup.A, setup.B
        self.K_ss = setup.K
        self.K_plant = setup.ancillary_gain()
        self.N = setup.N
        self.robust = robust
        self.x_hat = np.asarray(x0, float).reshape(-1).copy()
        self.t = 0
        self.q = 0
        self.seqs = []
        self.x_nom0_mpc = None

    def store(self, U_t, x_nom0=None):
        self.seqs.append(np.asarray(U_t, float))
        if x_nom0 is not None:
            self.x_nom0_mpc = np.asarray(x_nom0, float).reshape(-1).copy()

    def update(self, packet, gamma_t):
        if gamma_t == 1:
            x_p = np.asarray(packet["x_t"], float).reshape(-1)
            s_p = packet["s_t"]
            useq = self.seqs[s_p]
            idx = self.t - s_p
            if self.robust:
                x_nom_p = np.asarray(packet["x_nom_t"], float).reshape(-1)
                if idx < self.N:
                    u_nom = useq[:, idx]
                else:
                    u_nom = useq[:, -1] - self.K_ss @ x_nom_p
                u = u_nom - self.K_plant @ (x_p - x_nom_p)
            else:
                if idx < self.N:
                    u = useq[:, idx]
                else:
                    u = useq[:, -1] - self.K_ss @ x_p
            self.x_hat = self.A @ x_p + self.B @ u
        else:
            u = self.seqs[-1][:, 0]
            base = self.x_nom0_mpc if self.robust else self.x_hat
            self.x_hat = self.A @ base + self.B @ u
        self.q = gamma_t * self.t + (1 - gamma_t) * self.q
        self.t += 1


def oracle_solve(setup: MPCSetup, x_hat, ref, packet_received=False):
    """One MPC solve + encapsulation via the f64 interior point oracle."""
    tmpl = (setup.template_pr
            if (packet_received and setup.template_pr is not None)
            else setup.template)
    sol, _ = tmpl.solve_dense(x_hat, ref)
    if sol.status != "optimal":
        return None
    z = sol.z
    nx, nu, N = setup.nx, setup.nu, setup.N
    u_traj = z[nx * (N + 1):nx * (N + 1) + nu * N].reshape(N, nu).T
    out = {"u_traj": u_traj, "x_nom0": z[:nx], "z": z}
    if tmpl.tracking:
        xb = tmpl.xbar_slice
        ub = tmpl.ubar_slice
        xbar, ubar = z[xb], z[ub]
        u_ss = ubar + setup.K @ xbar
        out["U_t"] = np.hstack([u_traj, u_ss.reshape(nu, 1)])
        out["xbar"], out["ubar"] = xbar, ubar
    else:
        out["U_t"] = np.hstack([u_traj, np.zeros((nu, 1))])
    return out


def run_oracle_rollout(setup: MPCSetup, x0, refs, w, theta, gamma,
                       actuator_mode="consistent", plant_step=None):
    """Sequential closed loop; returns dict of trajectories.

    refs: (T, nx); w: (T, nx); theta/gamma: (T,) ints.
    Extended-MPC driver ordering: the QP choice uses the previous step's
    gamma (``results_linear_system_with_extendedMPC.py:260-378``).
    """
    T = refs.shape[0]
    extended = setup.template_pr is not None
    act = OracleActuator(setup, x0, mode=actuator_mode, extended=extended)
    est = OracleEstimator(setup, x0, robust=extended)
    if plant_step is None:
        def plant_step(x, u, wt):
            return setup.A @ x + setup.B @ u + wt
    x = np.asarray(x0, float).reshape(-1).copy()
    xs, us, x_noms, x_hats, Thetas = [], [], [], [], []
    prev_gamma = 1
    feasible = True
    for t in range(T):
        x_hat = est.x_hat.copy()
        sol = oracle_solve(setup, x_hat, refs[t],
                           packet_received=(extended and prev_gamma == 1))
        if sol is None:
            feasible = False
            break
        packet = {"U_t": sol["U_t"], "q_t": est.q}
        if extended:
            packet["x_nom_0"] = sol["x_nom0"]
            est.store(sol["U_t"], sol["x_nom0"])
        else:
            est.store(sol["U_t"])
        u, reply, x_nom_t = act.process_packet(packet, x, theta[t])
        x_noms.append(x_nom_t)
        x = plant_step(x, u, w[t])
        est.update(reply, gamma[t])
        xs.append(x.copy())
        us.append(u.copy())
        x_hats.append(x_hat)
        Thetas.append(act.Theta)
        prev_gamma = gamma[t]
    return {
        "x": np.array(xs), "u": np.array(us), "x_nom": np.array(x_noms),
        "x_hat": np.array(x_hats), "Theta": np.array(Thetas),
        "feasible": feasible, "steps": len(xs),
    }
