"""Controller-side state estimator, batched (counterpart of
``rtmpc_tpu/protocol/estimator.py``).

O(1) state, as in the JAX package: by the consistency invariant the reply
packet carries exactly the input the actuator applied, so no history of
sent sequences is kept.

* reply received (gamma=1): ``x_hat = A x_pkt + B u_pkt``;
* reply lost (gamma=0): ``x_hat = A x_base + B U_t[0]`` with ``x_base`` the
  previous estimate (or, robust variant, the stored optimal initial
  nominal state of the current solve);
* ``q_t = gamma t + (1 - gamma) q_t``, kept integer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree import tree_to

__all__ = ["EstimatorState", "init_estimator", "store_sequence",
           "estimator_update"]


class EstimatorState(NamedTuple):
    x_hat: torch.Tensor       # (B, nx) current estimate
    t: torch.Tensor           # (B,) int32
    q: torch.Tensor           # (B,) int32 last successful p->c reception time
    x_nom0_mpc: torch.Tensor  # (B, nx) stored optimal x_nom(0) (robust variant)

    def to(self, device) -> "EstimatorState":
        return tree_to(self, device)


def init_estimator(x0: torch.Tensor) -> EstimatorState:
    """Initial state for the batch of initial plant states ``x0 (B, nx)``."""
    zeros = torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)
    return EstimatorState(x_hat=x0, t=zeros, q=zeros,
                          x_nom0_mpc=torch.zeros_like(x0))


def store_sequence(state: EstimatorState, U_t: torch.Tensor,
                   x_nom0: torch.Tensor) -> EstimatorState:
    """Record the optimal ``x_nom(0)`` of this step's solve; the sent
    sequence itself needs no storing (pass ``U_t`` to
    ``estimator_update``)."""
    del U_t
    return state._replace(x_nom0_mpc=x_nom0)


def estimator_update(
    state: EstimatorState,
    plant_packet,              # (x_reply (B, nx), u_reply (B, nu), x_nom)
    gamma_t: torch.Tensor,     # (B,) int32 delivery indicator p->c
    A: torch.Tensor, B: torch.Tensor,
    U_t: torch.Tensor,         # (B, N+1, nu) sequence sent this step
    robust: bool = False,
) -> EstimatorState:
    """One ``update_estimate`` call for the batch; returns the new state."""
    x_pkt, u_pkt = plant_packet[0], plant_packet[1]
    x_hat_recv = x_pkt @ A.T + u_pkt @ B.T
    x_base = state.x_nom0_mpc if robust else state.x_hat
    x_hat_loss = x_base @ A.T + U_t[:, 0] @ B.T
    x_hat = torch.where((gamma_t == 1)[:, None], x_hat_recv, x_hat_loss)
    q_new = gamma_t * state.t + (1 - gamma_t) * state.q
    return state._replace(x_hat=x_hat, t=state.t + 1,
                          q=q_new.to(torch.int32))
