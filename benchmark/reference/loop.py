"""The closed loop over a lossy network, one rollout at a time.

The protocol of Umsonst & Barbosa (CDC 2024) as the paper states it, in
the plainest form: lists, explicit branches, one step after another.

* The controller solves the MPC from its estimate ``x_hat`` and sends the
  packet ``U_t`` with ``q_t``, the last time a reply reached it.
* The consistent actuator keeps every delivery flag it has seen.  A packet
  that arrives is consistent (``Theta = 1``) if no packet was lost after
  step ``q_t``; then it is accepted at ``s = t``.  The actuator plays
  ``u_nom = U_s[t - s]`` (past the horizon, ``U_s[N] - K x_nom``), applies
  ``u = u_nom - K (x - x_nom)`` and replies ``(x_nom, s)``; its nominal
  state moves on with ``u_nom``.
* The plant moves: ``x+ = A x + B u + w``.
* The estimator, on a reply, predicts ``x_hat = A x_nom + B u_nom`` from the
  sequence sent at ``s``; on a loss, ``x_hat = A x_hat + B U_t[0]``.
"""

from __future__ import annotations

import numpy as np

from .mpc import Controller

__all__ = ["rollout"]


def rollout(ctl: Controller, x0, refs, w, theta, gamma) -> dict:
    """Run ``T = len(refs)`` steps from ``x0``.  Returns the per-step
    ``x`` (after the step), ``u``, ``x_nom`` (the actuator's at the step)
    and ``Theta``, and ``feasible``: False from the first step whose QP has
    no solution on (the state is then held, as the program holds a
    rollout it freezes)."""
    A, B, K, N = ctl.A, ctl.B, ctl.K, ctl.N
    T = len(refs)
    x = np.array(x0, float)
    x_hat, x_nom = x.copy(), x.copy()
    sent = []                   # the packet sent at each step
    seen = []                   # the actuator's delivery flags
    q_ctl = q_act = s = 0
    u_buf = None
    out = {"x": np.zeros((T, x.size)), "u": np.zeros((T, B.shape[1])),
           "x_nom": np.zeros((T, x.size)), "Theta": np.zeros(T, int),
           "feasible": np.ones(T, bool)}
    for t in range(T):
        U = ctl.packet(x_hat, np.asarray(refs[t], float))
        if U is None:
            out["feasible"][t:] = False
            out["x"][t:] = x
            break
        sent.append(U)
        # the actuator
        seen.append(int(theta[t]))
        if theta[t] == 1:
            q_act = q_ctl
            Theta = int(all(seen[q_act + 1:]))
        else:
            Theta = 0
        if Theta:
            s, u_buf = t, U
        out["x_nom"][t] = x_nom
        u_nom = u_buf[t - s] if t - s < N else u_buf[N] - K @ x_nom
        u = u_nom - K @ (x - x_nom)
        reply = (x_nom.copy(), s)
        x_nom = A @ x_nom + B @ u_nom
        # the plant
        x = A @ x + B @ u + np.asarray(w[t], float)
        # the estimator
        if gamma[t] == 1:
            x_p, s_p = reply
            U_s = sent[s_p]
            u_p = U_s[t - s_p] if t - s_p < N else U_s[N] - K @ x_p
            x_hat = A @ x_p + B @ u_p
            q_ctl = t
        else:
            x_hat = A @ x_hat + B @ U[0]
        out["x"][t], out["u"][t], out["Theta"][t] = x, u, Theta
    return out
