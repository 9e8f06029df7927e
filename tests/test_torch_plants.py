"""The port's nonlinear cartpole plant against the JAX package's.

* ``linear_plant_step`` (batch-explicit) against the JAX function under
  ``vmap`` on the cartpole's discrete model and numpy-seeded states,
  inputs and disturbances, float64, within 1e-12.
* ``cartpole_derivatives``, ``cartpole_step`` (both methods) and
  ``cartpole_zoh_step`` on numpy-seeded states and forces, float64, within
  1e-12 of the JAX functions under ``vmap``.
* The ODE linearized at the origin (autograd) gives ``cartpole_linearized``.
* The closed loop on the nonlinear plant: the port's batched engine with
  ``build_nonlinear_plant_step`` against ``jax.vmap(make_rollout_fn(...,
  plant_step=...))`` on the cartpole's tube controller, B=4, T=20, one set
  of matrices for both (the JAX package's, through ``arrays_from_numpy``),
  solvers "admm" and "cuda" (the kernel's plain version on the CPU), within
  1e-9.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.results_nonlinear import (build_nonlinear_plant_step as
                                              jax_build_plant_step)
from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario
from rtmpc_tpu.models import plants as jax_plants
from rtmpc_tpu.models.specs import setup_tube_tracking as jax_setup_tube
from rtmpc_tpu.parallel import make_rollout_fn as jax_rollout_fn

from rtmpc_tpu_torch.apps.results_nonlinear import build_nonlinear_plant_step
from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
from rtmpc_tpu_torch.models import (ControllerConfig, arrays_from_numpy,
                                    plants)
from rtmpc_tpu_torch.parallel import make_batched_rollout

TOL = 1e-12
B = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 4)) * np.array([2.0, 3.0, 0.6, 2.5])
    f = rng.uniform(-10, 10, B)
    return x, f


def _close(got, want, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL, err_msg=name)


def test_linear_plant_step_matches_jax():
    sc = cartpole_scenario()
    x, f = _states(2)
    w = np.random.default_rng(3).uniform(sc.w_lo, sc.w_hi, (B, 4))
    u = f[:, None]
    want = jax.vmap(lambda xi, ui, wi: jax_plants.linear_plant_step(
        jnp.asarray(sc.A), jnp.asarray(sc.B), xi, ui, wi))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(w))
    got = plants.linear_plant_step(torch.tensor(sc.A), torch.tensor(sc.B),
                                   torch.tensor(x), torch.tensor(u),
                                   torch.tensor(w))
    assert got.shape == (B, 4) and "linear_plant_step" in plants.__all__
    _close(got, want)


def test_derivatives_match_jax():
    x, f = _states()
    prm = plants.CartpoleParams(b=0.3)       # friction on: every term live
    jprm = jax_plants.CartpoleParams(b=0.3)
    want = jax.vmap(lambda xi, fi: jax_plants.cartpole_derivatives(
        jprm, xi, fi))(jnp.asarray(x), jnp.asarray(f))
    got = plants.cartpole_derivatives(prm, torch.tensor(x), torch.tensor(f))
    assert got.shape == (B, 4) and got.dtype == torch.float64
    _close(got, want)


@pytest.mark.parametrize("method", ["semi_implicit_euler", "rk4"])
def test_step_and_zoh_step_match_jax(method):
    x, f = _states(1)
    prm, jprm = plants.CartpoleParams(), jax_plants.CartpoleParams()
    want = jax.vmap(lambda xi, fi: jax_plants.cartpole_step(
        jprm, xi, fi, 1 / 500, method=method))(jnp.asarray(x), jnp.asarray(f))
    _close(plants.cartpole_step(prm, torch.tensor(x), torch.tensor(f),
                                1 / 500, method=method), want, "step")
    want = jax.vmap(lambda xi, fi: jax_plants.cartpole_zoh_step(
        jprm, xi, fi, 0.02, 10, method=method))(jnp.asarray(x),
                                                jnp.asarray(f))
    _close(plants.cartpole_zoh_step(prm, torch.tensor(x), torch.tensor(f),
                                    0.02, 10, method=method), want, "zoh")


def test_unknown_method_raises():
    x, f = _states()
    with pytest.raises(ValueError, match="unknown method"):
        plants.cartpole_step(plants.CartpoleParams(), torch.tensor(x),
                             torch.tensor(f), 0.002, method="euler")


def test_linearization_at_the_origin():
    """d f / d (x, F) at the upright equilibrium equals (Ac, Bc), at the
    scenario's parameters (no cart friction, as the JAX package's own test
    has it: with b > 0 the ODE's friction term in phi_ddot and the
    reference's Ac entry ``-m l b / p`` have opposite signs, in both
    packages)."""
    prm = plants.CartpoleParams()
    Ac, Bc, _ = plants.cartpole_linearized(prm)

    def ode(xf):
        return plants.cartpole_derivatives(prm, xf[None, :4], xf[None, 4])[0]

    J = torch.autograd.functional.jacobian(ode, torch.zeros(
        5, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(J[:, :4], Ac, rtol=0, atol=1e-14)
    np.testing.assert_allclose(J[:, 4:], Bc, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# the closed loop on the nonlinear plant
# ---------------------------------------------------------------------------

KW = dict(iters=20, iters2=20, alpha=1.8, rho2_scale=0.2)
NB, T = 4, 20


@pytest.fixture(scope="module")
def jax_nonlinear_run():
    js = jax_scenario()
    setup = jax_setup_tube(js.A, js.B, js.Q, js.R, js.N, js.X, js.U, js.W,
                           fixed_initial_state=True, rpi_method=1)
    arrays, cfg = setup.to_device(dtype=jnp.float64, solver="admm", **KW)
    rng = np.random.default_rng(3)
    theta = (rng.uniform(size=(NB, T)) >= 0.5).astype(np.int32)
    gamma = (rng.uniform(size=(NB, T)) >= 0.5).astype(np.int32)
    theta[:, 0] = gamma[:, 0] = 1
    refs = np.zeros((NB, T, 4))
    refs[:, :, 0] = js.ref_value
    x0 = rng.uniform(-1, 1, (NB, 4)) * np.array([0.1, 0.1, 0.02, 0.05])
    inp = (x0, refs, np.zeros((NB, T, 4)), theta, gamma)
    fn = jax_rollout_fn(arrays, cfg, T,
                        plant_step=jax_build_plant_step(jnp, js))
    carry, outs = jax.jit(jax.vmap(fn))(*map(jnp.asarray, inp))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return inp, to_np(arrays), cfg, to_np(carry), to_np(outs)


@pytest.mark.parametrize("solver", ["admm", "cuda"])
def test_nonlinear_closed_loop_matches_jax(jax_nonlinear_run, solver):
    inp, np_arrays, jcfg, jcarry, jouts = jax_nonlinear_run
    sc = cartpole_scenario()
    arrays = arrays_from_numpy(np_arrays)
    cfg = ControllerConfig(
        solver=solver, **{f: getattr(jcfg, f) for f in (
            "nx", "nu", "N", "n", "tracking", "iters", "iters2", "u_off",
            "xbar_off", "ubar_off", "extended")})
    carry, outs = make_batched_rollout(
        arrays, cfg, T, plant_step=build_nonlinear_plant_step(sc))(
            *map(torch.tensor, inp))
    for f in ("x", "u", "x_nom", "x_hat", "r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(outs, f).numpy(),
                                   getattr(jouts, f), rtol=0, atol=1e-9,
                                   err_msg=f)
    np.testing.assert_array_equal(outs.Theta.numpy(), jouts.Theta)
    np.testing.assert_array_equal(carry.feasible.numpy(), jcarry.feasible)
    assert bool(carry.feasible.all())
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(carry.admm, f).numpy(),
                                   getattr(jcarry.admm, f), rtol=0,
                                   atol=1e-9, err_msg=f"admm.{f}")
    # the plant really is the nonlinear one: the linear model's next state
    # from the same (x, u) differs
    x_prev = np.concatenate([inp[0][:, None], jouts.x[:, :-1]], 1)
    lin = x_prev @ np_arrays.A.T + jouts.u @ np_arrays.B.T
    assert np.abs(lin - jouts.x).max() > 1e-6
