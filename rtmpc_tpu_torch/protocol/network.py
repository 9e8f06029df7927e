"""The simulated lossy channel as pre-drawn mask tensors (counterpart of
``rtmpc_tpu/protocol/network.py``).

Draws come from an explicit ``torch.Generator`` on the device the masks
are wanted on, in float32 (as the JAX package pins its draws), with the
t=0 transmissions forced successful.  The bits differ from
``jax.random``'s: parity tests feed both packages the same masks instead.
"""

from __future__ import annotations

import torch

__all__ = ["draw_loss_masks", "draw_disturbances"]


def draw_loss_masks(generator: torch.Generator, T: int, p_c2p, p_p2c,
                    batch_shape=()) -> tuple:
    """Returns ``(theta, gamma)`` int32 masks of shape ``batch_shape + (T,)``
    on the generator's device.  ``theta[t] = 1``: the controller->plant
    packet at step t arrives (loss probability ``p_c2p``); ``gamma``
    likewise plant->controller.  ``p_*`` are scalars or tensors
    broadcastable to ``batch_shape``."""
    dev = generator.device
    batch_shape = tuple(batch_shape)
    shape = batch_shape + (T,)

    def mask(p):
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        p = p.broadcast_to(batch_shape)[..., None]
        draw = torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=dev)
        m = (draw >= p).to(torch.int32)
        m[..., 0] = 1
        return m

    theta = mask(p_c2p)
    gamma = mask(p_p2c)
    return theta, gamma


def draw_disturbances(generator: torch.Generator, T: int, w_lo, w_hi,
                      batch_shape=()) -> torch.Tensor:
    """Uniform float32 draws from the box ``W = [w_lo, w_hi]``, shape
    ``batch_shape + (T, nx)``, on the generator's device."""
    dev = generator.device
    w_lo = torch.as_tensor(w_lo, dtype=torch.float32, device=dev)
    w_hi = torch.as_tensor(w_hi, dtype=torch.float32, device=dev)
    shape = tuple(batch_shape) + (T, w_lo.shape[-1])
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=dev)
    return w_lo + u * (w_hi - w_lo)
