"""Monte-Carlo packet-loss sweeps as one batched rollout (counterpart of
``rtmpc_tpu/parallel/mc.py``).

The whole sweep, ``n_probs * n_mc`` closed loops with their own loss and
disturbance draws, is one batched rollout (optionally in chunks along the
probability axis, with a checkpoint after each chunk).  ``run_mc_sweep``
returns the artifacts of the reference's Results scripts: per-(p, run) RMS
tracking errors (NaN where the arm stopped), infeasibility counts, and one
sample trajectory per loss probability.

The draws are data.  They come in as ``SweepDraws`` (the loss masks and the
float32 uniforms behind the disturbances), either carried over from the
JAX package (``jax.random`` bits cannot be made in torch; see
``load_draws``) or made by the port's own generator (``draw_sweep``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.specs import ControllerArrays, ControllerConfig
from ..protocol.network import draw_loss_masks
from .rollout import make_batched_rollout, tracking_error_rms

__all__ = ["SweepDraws", "MCSweepResult", "draw_sweep", "load_draws",
           "run_mc_sweep"]


class SweepDraws(NamedTuple):
    """The random inputs of a sweep, batch-major over ``P * M`` rollouts
    (probability-major: rollout ``i * M + j`` is run j at probability i)."""
    theta: torch.Tensor   # (P*M, T) uint8/int delivery mask, controller->plant
    gamma: torch.Tensor   # (P*M, T) delivery mask, plant->controller
    u: torch.Tensor       # (P*M, T, nx) float32 uniforms behind w


def draw_sweep(generator: torch.Generator, T: int, n_mc: int, loss_probs,
               nx: int) -> SweepDraws:
    """The port's own draws for a sweep (other bits than ``jax.random``)."""
    dev = generator.device
    p_flat = torch.tensor(np.repeat(np.asarray(loss_probs, np.float64),
                                    n_mc), dtype=torch.float32, device=dev)
    theta, gamma = draw_loss_masks(generator, T, p_flat, p_flat,
                                   (p_flat.shape[0],))
    u = torch.rand((p_flat.shape[0], T, nx), generator=generator,
                   dtype=torch.float32, device=dev)
    return SweepDraws(theta.to(torch.uint8), gamma.to(torch.uint8), u)


def load_draws(path: str, device="cpu") -> SweepDraws:
    """Draws from an ``.npz`` with arrays ``theta``, ``gamma`` (uint8) and
    ``u`` (float32), as ``tests/test_torch_results.py`` writes them."""
    with np.load(path) as f:
        return SweepDraws(*(torch.from_numpy(np.ascontiguousarray(f[k]))
                            .to(device) for k in SweepDraws._fields))


@dataclasses.dataclass
class MCSweepResult:
    loss_probs: np.ndarray          # (P,)
    tracking_error: np.ndarray      # (P, M) RMS errors, NaN if infeasible
    infeasible_counts: np.ndarray   # (P,) number of infeasible MC runs
    sample_traj: np.ndarray         # (P, T, nx) trajectory of one MC run
    sample_x_nom: np.ndarray        # (P, T, nx)
    feasible: np.ndarray            # (P, M) bool
    wall_time_s: float = 0.0

    @property
    def n_mc(self) -> int:
        return self.tracking_error.shape[1]


def run_mc_sweep(
    arrays: ControllerArrays,
    cfg: ControllerConfig,
    *,
    T: int,
    n_mc: int,
    loss_probs,
    refs: np.ndarray,              # (T, nx) shared reference trajectory
    x0: np.ndarray,                # (nx,)
    w_lo, w_hi,                    # disturbance box
    draws: SweepDraws,
    actuator_mode: str = "consistent",
    infeas_mode: Optional[str] = None,
    sample_mc_index: int = 5,
    checkpoint_path: Optional[str] = None,
    n_chunks: int = 1,
) -> MCSweepResult:
    """Run the full sweep on the arrays' device; returns numpy artifacts.

    The disturbances are ``w = w_lo + u (w_hi - w_lo)`` formed in float64
    from the draws' uniforms (as the JAX package forms them under x64),
    then cast to the engine's dtype.  ``sample_mc_index``: which run's
    trajectory to keep per probability (the reference keeps run
    ``min(5, N_MC - 1)``).

    Checkpoint / resume: with ``checkpoint_path`` set and ``n_chunks > 1``
    the batch runs in chunks along the probability axis and the results
    so far are written atomically to an ``.npz`` after each chunk; a rerun
    with the same path resumes after the last finished chunk.  The
    fingerprint in the file hashes everything that determines the rows
    (shapes, the draws, the probabilities, the chunk plan, x0 and refs),
    so a checkpoint of another sweep is ignored.  Chunked and resumed
    runs are bit-identical to a single-shot run.
    """
    loss_probs = np.asarray(loss_probs, dtype=np.float64)
    P, M = len(loss_probs), int(n_mc)
    nx = cfg.nx
    dt, dev = arrays.A.dtype, arrays.A.device
    for name, a in zip(SweepDraws._fields, draws):
        if a.shape[:2] != (P * M, T):
            raise ValueError(f"run_mc_sweep: draws.{name} has shape "
                             f"{tuple(a.shape)}, expected ({P * M}, {T}, ...)")

    f64 = dict(dtype=torch.float64, device=dev)
    w_lo64 = torch.as_tensor(np.asarray(w_lo, np.float64), **f64)
    w_hi64 = torch.as_tensor(np.asarray(w_hi, np.float64), **f64)
    w = (w_lo64 + draws.u.to(**f64) * (w_hi64 - w_lo64)).to(dt)
    theta = draws.theta.to(device=dev, dtype=torch.int32)
    gamma = draws.gamma.to(device=dev, dtype=torch.int32)
    refs_b = torch.as_tensor(np.asarray(refs, np.float64), dtype=dt,
                             device=dev).expand(P * M, T, nx)
    x0_b = torch.as_tensor(np.asarray(x0, np.float64), dtype=dt,
                           device=dev).reshape(nx).expand(P * M, nx)

    roll = make_batched_rollout(arrays, cfg, T, actuator_mode=actuator_mode,
                                infeas_mode=infeas_mode)

    n_chunks = max(1, min(int(n_chunks), P))
    bounds = np.linspace(0, P, n_chunks + 1).astype(int)   # prob-axis cuts
    start_chunk = 0
    err = np.full((P, M), np.nan)
    feas = np.zeros((P, M), bool)
    si = min(sample_mc_index, M - 1)
    sample_traj = np.zeros((P, T, nx))
    sample_x_nom = np.zeros((P, T, nx))
    wall = 0.0

    hsh = hashlib.sha256()
    for part in (*(a.cpu().numpy() for a in draws),
                 np.asarray([P, M, T, nx], np.int64), loss_probs, bounds,
                 np.asarray(x0, np.float64), np.asarray(refs, np.float64)):
        hsh.update(np.ascontiguousarray(part).tobytes())
    fingerprint = np.frombuffer(hsh.digest(), dtype=np.uint8)
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            if ck["fingerprint"].shape == fingerprint.shape and \
                    np.array_equal(ck["fingerprint"], fingerprint):
                start_chunk = int(ck["next_chunk"])
                err, feas = ck["err"], ck["feas"]
                sample_traj = ck["sample_traj"]
                sample_x_nom = ck["sample_x_nom"]
                wall = float(ck["wall"])

    for ci in range(start_chunk, n_chunks):
        lo, hi = bounds[ci], bounds[ci + 1]
        if hi == lo:
            continue
        sl = slice(lo * M, hi * M)
        t0 = time.perf_counter()
        carry, outs = roll(x0_b[sl], refs_b[sl], w[sl], theta[sl], gamma[sl])
        err_c = tracking_error_rms(x0_b[sl], outs.x, refs_b[sl],
                                   carry.feasible)
        npp = hi - lo
        xs_c = outs.x.double().cpu().numpy().reshape(npp, M, T, nx)
        xn_c = outs.x_nom.double().cpu().numpy().reshape(npp, M, T, nx)
        err[lo:hi] = err_c.double().cpu().numpy().reshape(npp, M)
        feas[lo:hi] = carry.feasible.cpu().numpy().reshape(npp, M)
        dt_chunk = time.perf_counter() - t0
        wall += dt_chunk
        print(f"  [mc] chunk {ci + 1}/{n_chunks} "
              f"(p={loss_probs[lo]:.2f}..{loss_probs[hi - 1]:.2f}) "
              f"{dt_chunk:.1f}s", flush=True)
        sample_traj[lo:hi] = xs_c[:, si]
        sample_x_nom[lo:hi] = xn_c[:, si]
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp.npz"     # atomic write + rename
            np.savez(tmp, fingerprint=fingerprint, next_chunk=ci + 1,
                     err=err, feas=feas, sample_traj=sample_traj,
                     sample_x_nom=sample_x_nom, wall=wall)
            os.replace(tmp, checkpoint_path)

    return MCSweepResult(
        loss_probs=loss_probs,
        tracking_error=err,
        infeasible_counts=(~feas).sum(axis=1),
        sample_traj=sample_traj,
        sample_x_nom=sample_x_nom,
        feasible=feas,
        wall_time_s=wall,
    )
