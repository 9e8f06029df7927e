"""Plant-side smart/consistent actuator, batched (counterpart of
``rtmpc_tpu/protocol/actuator.py``).

The same branchless step on ``(B, .)`` tensors: the loss history collapses
to ``last_drop`` (the last time theta was 0, -1 if never), so the
consistency indicator ``Theta_t = theta_t * prod(theta[q_t+1:])`` is
``theta_t == 1 and last_drop <= q_pkt`` (O(1), exact).  The playback
``u = U[t - s_t]`` is a per-row ``torch.gather``; the terminal law
``u = U[N] - K x`` a select.

``mode="smart"`` is the Pezzutto actuator (law on the measured state,
``{x_t, s_t}`` replies); ``mode="consistent"`` runs the nominal model and
the ancillary law ``u = u_nom - K_plant (x - x_nom)``, replying
``{x_nom, s_t}`` — or ``{x_t, s_t, x_nom}`` with ``x_nom_0`` resyncs when
``extended``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..tree import tree_to

__all__ = ["ActuatorState", "init_actuator", "actuator_step"]

_MODES = ("consistent", "smart")


class ActuatorState(NamedTuple):
    t: torch.Tensor          # (B,) int32 internal timer
    q: torch.Tensor          # (B,) int32 last controller-ack time known here
    s: torch.Tensor          # (B,) int32 last accept time
    last_drop: torch.Tensor  # (B,) int32 last time theta == 0 (-1 if never)
    Theta: torch.Tensor      # (B,) int32 consistency indicator of the last step
    u_buf: torch.Tensor      # (B, N+1, nu) accepted control sequence
    x_nom: torch.Tensor      # (B, nx) nominal plant state (consistent mode)

    def to(self, device) -> "ActuatorState":
        return tree_to(self, device)


def init_actuator(N: int, nu: int, x0: torch.Tensor) -> ActuatorState:
    """Initial state for the batch of initial plant states ``x0 (B, nx)``."""
    B = x0.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=x0.device)
    return ActuatorState(
        t=zeros, q=zeros, s=zeros,
        last_drop=torch.full((B,), -1, dtype=torch.int32, device=x0.device),
        Theta=zeros,
        u_buf=torch.zeros(B, N + 1, nu, dtype=x0.dtype, device=x0.device),
        x_nom=x0)


def actuator_step(
    state: ActuatorState,
    U_t: torch.Tensor,         # (B, N+1, nu) controller packet payload
    q_pkt: torch.Tensor,       # (B,) int32 controller packet q_t
    x_nom0_pkt: torch.Tensor,  # (B, nx) optimal initial nominal state
    x_t: torch.Tensor,         # (B, nx) measured plant state
    theta_t: torch.Tensor,     # (B,) int32 delivery indicator c->p
    A: torch.Tensor, B: torch.Tensor,
    K_ss: torch.Tensor, K_plant: torch.Tensor,
    N: int,
    mode: str = "consistent",
    extended: bool = False,
) -> Tuple[torch.Tensor, Tuple, ActuatorState, dict]:
    """One ``process_packet`` call for the batch.  Returns
    ``(u_t, plant_packet, new_state, aux)`` with
    ``plant_packet = (x_reply, u_reply, x_nom_reply)``."""
    if mode not in _MODES:
        raise ValueError(f"actuator mode {mode!r} not in {_MODES}")
    got = theta_t == 1
    last_drop = torch.where(theta_t == 0, state.t, state.last_drop)
    Theta = got & (last_drop <= q_pkt)
    q_new = torch.where(got, q_pkt, state.q)
    s_new = torch.where(Theta, state.t, state.s)

    u_buf = torch.where(Theta[:, None, None], U_t, state.u_buf)
    x_nom = state.x_nom
    if extended:
        x_nom = torch.where(Theta[:, None], x_nom0_pkt, x_nom)

    # control playback vs terminal law
    idx = state.t - s_new
    slot = idx.clamp(0, N - 1).long()[:, None, None].expand(-1, 1, U_t.shape[2])
    u_play = torch.gather(u_buf, 1, slot)[:, 0]
    law_state = x_nom if mode == "consistent" else x_t
    u_term = u_buf[:, N] - law_state @ K_ss.T
    u_nom = torch.where((idx < N)[:, None], u_play, u_term)

    if mode == "consistent":
        u_t = u_nom - (x_t - x_nom) @ K_plant.T
        x_reply = x_t if extended else x_nom
        x_nom_next = x_nom @ A.T + u_nom @ B.T
    else:
        u_t = u_nom
        x_reply = x_t
        x_nom_next = x_nom

    u_reply = u_nom if (mode == "consistent" and not extended) else u_t
    Theta_i = Theta.to(torch.int32)
    new_state = ActuatorState(
        t=state.t + 1, q=q_new, s=s_new, last_drop=last_drop,
        Theta=Theta_i, u_buf=u_buf, x_nom=x_nom_next)
    aux = {"Theta": Theta_i, "x_nom": x_nom, "u_nom": u_nom}
    return u_t, (x_reply, u_reply, x_nom), new_state, aux
