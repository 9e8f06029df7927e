"""The port's batched closed loop against the JAX engine on the flagship.

Both packages set the flagship up on their own (bit-equal, see
``test_torch_setup.py``) with the bench's solver settings (60+60 ADMM
iterations, alpha 1.8, rho2 scale 0.2) in float64, and run the same
numpy-drawn inputs: B=6 rollouts of T=12 steps at a constant reference,
T=40 steps with the saturating references of ``test_rollout_parity.py``,
and T=12 with non-finite references on two rows (the freeze path).  The
port runs solver "admm" (batched PyTorch ADMM) and solver "cuda" (the
kernel's plain version on the CPU) against the JAX engine's "admm":

* x, u, x_nom, x_hat, residuals and the warm-start carry within 1e-9;
* Theta, feasible and the protocol integers exactly equal;
* ``tracking_error_rms`` within 1e-12 on the same trajectories.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.utils import box as jax_box
from rtmpc_tpu.models import setup_tube_tracking
from rtmpc_tpu.parallel import make_batched_rollout as jax_batched_rollout
from rtmpc_tpu.parallel import tracking_error_rms as jax_tracking_error_rms

from rtmpc_tpu_torch.models import flagship_setup
from rtmpc_tpu_torch.parallel import make_batched_rollout, tracking_error_rms

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
B, NX = 6, 2
TOL = 1e-9


def _inputs(scenario):
    """(x0, refs, w, theta, gamma) as numpy arrays, batch-major."""
    T = 40 if scenario == "saturating" else 12
    rng = np.random.default_rng({"constant": 0, "saturating": 1,
                                 "frozen": 2}[scenario])
    p = 0.7 if scenario == "saturating" else 0.5
    theta = (rng.uniform(size=(B, T)) >= p).astype(np.int32)
    gamma = (rng.uniform(size=(B, T)) >= p).astype(np.int32)
    theta[:, 0] = gamma[:, 0] = 1
    w = rng.uniform(-0.1, 0.1, size=(B, T, NX))
    x0 = rng.uniform(-1.0, 1.0, size=(B, NX))
    refs = np.zeros((B, T, NX))
    if scenario == "saturating":
        refs[:, :10, 0] = 5.0
        refs[:, 10:20, 0] = -9.0    # outside X: the steady state saturates
        refs[:, 20:, 0] = 4.0
    else:
        refs[:, :, 0] = 4.0
    if scenario == "frozen":
        refs[1, 5, 0] = np.nan      # the QP goes non-finite: rows freeze
        refs[4, 8, 0] = np.inf
    return x0, refs, w, theta, gamma


@pytest.fixture(scope="module")
def jax_runs():
    setup = setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10,
        jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
        jax_box(np.array([0.1, 0.1])), fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype=jnp.float64, **KW)
    runs = {}
    for scenario in ("constant", "saturating", "frozen"):
        inp = _inputs(scenario)
        T = inp[1].shape[1]
        carry, outs = jax.jit(jax_batched_rollout(arrays, cfg, T))(
            *map(jnp.asarray, inp))
        runs[scenario] = jax.tree_util.tree_map(np.asarray, (carry, outs))
    return runs


@pytest.fixture(scope="module")
def port_setup():
    return flagship_setup()


def _close(got, want, name):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                               err_msg=name)


@pytest.mark.parametrize("scenario", ["constant", "saturating", "frozen"])
@pytest.mark.parametrize("solver", ["admm", "cuda"])
def test_batched_rollout_matches_jax(jax_runs, port_setup, solver, scenario):
    x0, refs, w, theta, gamma = _inputs(scenario)
    T = refs.shape[1]
    arrays, cfg = port_setup.to_device(torch.float64, "cpu", solver=solver,
                                       **KW)
    carry, outs = make_batched_rollout(arrays, cfg, T)(
        torch.tensor(x0), torch.tensor(refs), torch.tensor(w),
        torch.tensor(theta), torch.tensor(gamma))
    jcarry, jouts = jax_runs[scenario]

    for f in ("x", "u", "x_nom", "x_hat", "r_prim", "r_dual"):
        _close(getattr(outs, f), getattr(jouts, f), f)
        assert getattr(outs, f).shape[:2] == (B, T)
    np.testing.assert_array_equal(outs.Theta.numpy(), jouts.Theta)
    np.testing.assert_array_equal(outs.feasible.numpy(), jouts.feasible)
    np.testing.assert_array_equal(carry.feasible.numpy(), jcarry.feasible)
    _close(carry.x, jcarry.x, "carry.x")
    for f in ("x", "y", "z"):
        _close(getattr(carry.admm, f), getattr(jcarry.admm, f), f"admm.{f}")
    for f in ("t", "q", "s", "last_drop", "Theta"):
        np.testing.assert_array_equal(getattr(carry.act, f).numpy(),
                                      getattr(jcarry.act, f), err_msg=f)
    _close(carry.act.x_nom, jcarry.act.x_nom, "act.x_nom")
    _close(carry.act.u_buf, jcarry.act.u_buf, "act.u_buf")
    for f in ("t", "q"):
        np.testing.assert_array_equal(getattr(carry.est, f).numpy(),
                                      getattr(jcarry.est, f), err_msg=f)
    _close(carry.est.x_hat, jcarry.est.x_hat, "est.x_hat")

    err = tracking_error_rms(torch.tensor(x0), outs.x, torch.tensor(refs),
                             carry.feasible)
    jerr = jax.vmap(jax_tracking_error_rms)(x0, jouts.x, refs,
                                            jcarry.feasible)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-12, err_msg="tracking_error_rms")

    if scenario == "frozen":
        assert carry.feasible.tolist() == [True, False, True, True, False,
                                           True]
        assert bool((carry.act.t == T).all())   # timers kept advancing
    else:
        assert bool(carry.feasible.all())


def test_tracking_error_rms_matches_jax():
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(7, NX))
    xs = rng.normal(size=(7, 30, NX))
    refs = rng.normal(size=(7, 30, NX))
    feasible = rng.uniform(size=7) > 0.3
    want = np.asarray(jax.vmap(jax_tracking_error_rms)(x0, xs, refs,
                                                       feasible))
    got = tracking_error_rms(torch.tensor(x0), torch.tensor(xs),
                             torch.tensor(refs), torch.tensor(feasible))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # unbatched call and the reference's hand-computed value
    f64 = dict(dtype=torch.float64)
    one = tracking_error_rms(torch.zeros(NX, **f64), torch.ones(5, NX, **f64),
                             torch.zeros(5, NX, **f64))
    np.testing.assert_allclose(float(one), np.sqrt(8.0) / 5, rtol=1e-12)
