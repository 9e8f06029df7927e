"""A device-resident closed-loop controller session, advanced window by
window (counterpart of the ``jax.jit`` over a scanned window in
``rtmpc_tpu/apps/serve_controller.py:86``).

A ``Session`` holds one controller's rollout carry (plant state,
estimator, actuator, ADMM warm start) in tensors that stay on the device
for the whole session, and advances it ``window`` ticks a call: the host
copies the window's inputs (refs, w, theta, gamma, each ``(window, .)``)
into static input buffers and gets back the window's outputs.

On a CUDA device the window is one CUDA graph: after a warm-up run of the
window on a side stream (it builds the kernel and the library handles, and
its effect on the carry is undone), ``window`` ticks of the batched step
(``parallel/rollout.py``) are captured once, reading the static input
buffers and the static carry and ending by copying the new carry into it;
the outputs are the graph's own static ``(1, window, .)`` tensors.  Each
call then replays the graph: no Python and no launch overhead a tick.
Every solver of the engine captures, the interior points too: the
structured one runs its whole iteration budget under capture, where its
eager early exit would read the device (``ops/ip_riccati.py``).  A
capture that fails raises; there is no eager fallback on the card.  On a
CPU device the same function runs the ticks eagerly, the only mode the CPU
has.

Kernel launches happen once, at capture, so the kernel's own counter
(``admm_solve_cuda.launches``) sees one window's worth; ``launches`` is
the number the device ran: launches captured a window times replays.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..models.specs import ControllerArrays, ControllerConfig
from ..ops.qp_cuda import admm_solve_cuda
from ..tree import tree_map
from ..utils.spans import span
from .rollout import StepOutputs, init_carry, make_batched_rollout

__all__ = ["Session"]


def _copy_into(dst, src):
    """Copy every leaf of ``src`` into the same leaf of ``dst`` in place."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


class Session:
    """One controller instance (batch 1) served ``window`` ticks a call.

    ``x0`` is the initial plant state ``(nx,)``; ``actuator_mode`` and
    ``plant_step`` are those of ``make_batched_rollout``."""

    def __init__(self, arrays: ControllerArrays, cfg: ControllerConfig,
                 window: int, x0, actuator_mode: str = "consistent",
                 plant_step: Optional[Callable] = None):
        self.window = int(window)
        dev, dt = arrays.A.device, arrays.A.dtype
        self.device = dev
        x0 = torch.as_tensor(x0, dtype=dt).to(dev).reshape(1, cfg.nx)
        self._rollout = make_batched_rollout(
            arrays, cfg, self.window, actuator_mode=actuator_mode,
            plant_step=plant_step)
        self._carry_init = init_carry(arrays, cfg, x0)
        self.carry = tree_map(torch.clone, self._carry_init)
        self.refs = torch.zeros(1, self.window, cfg.nx, dtype=dt, device=dev)
        self.w = torch.zeros_like(self.refs)
        self.theta = torch.ones(1, self.window, dtype=torch.int32, device=dev)
        self.gamma = torch.ones_like(self.theta)
        self.graph = None
        self.outs: Optional[StepOutputs] = None
        self.captured_launches = 0
        self.replays = 0
        # seconds the capture and the instantiation of the graph took
        self.capture_s = self.instantiate_s = None
        if dev.type == "cuda":
            self._capture()

    def _body(self) -> StepOutputs:
        carry, outs = self._rollout(None, self.refs, self.w, self.theta,
                                    self.gamma, carry0=self.carry)
        _copy_into(self.carry, carry)
        return outs

    def _capture(self):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.reset()
        graph = torch.cuda.CUDAGraph()
        before = admm_solve_cuda.launches
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self.outs = self._body()
            t1 = time.perf_counter()
        # leaving the context ends the capture and instantiates the graph
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
        self.captured_launches = admm_solve_cuda.launches - before
        self.graph = graph

    def reset(self):
        """Back to the initial carry (the session's first tick)."""
        _copy_into(self.carry, self._carry_init)

    def snapshot(self):
        """A copy of the current carry (the state before the next tick)."""
        return tree_map(torch.clone, self.carry)

    def advance(self, refs, w, theta, gamma) -> StepOutputs:
        """Advance ``window`` ticks: ``refs``/``w`` ``(window, nx)``,
        ``theta``/``gamma`` ``(window,)``, on any device.  Returns the
        window's outputs, ``(1, window, .)``; on the card they are the
        graph's static tensors, overwritten by the next call, and the call
        returns before the device has finished (synchronize to read
        them)."""
        with span("session.copy_in"):
            self.refs[0].copy_(refs)
            self.w[0].copy_(w)
            self.theta[0].copy_(theta)
            self.gamma[0].copy_(gamma)
        if self.graph is None:
            return self._body()
        with span("session.replay"):
            self.graph.replay()
        self.replays += 1
        return self.outs

    @property
    def launches(self) -> int:
        """Kernel launches the device ran in this session's replays."""
        return self.captured_launches * self.replays
