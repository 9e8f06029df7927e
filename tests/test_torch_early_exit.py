"""The ADMM's residual early exit (``early_tol``) of the port against the
JAX package's, in float64 on the flagship.

* ``admm_solve(early_tol=1e-3, early_dual_factor=25, check_every=25)``
  against ``jax.vmap`` of the JAX package's ``admm_solve`` with the same
  arguments, on the flagship's phase-2 spec, on a batch that mixes warm
  lanes (started from a 400-iteration iterate of their own QP: done after
  one chunk) with cold lanes (from zero: done after 2 or 3 chunks, or, with
  a reference outside X, running the whole 100-iteration budget, 4 chunks):
  the state, primal and residuals within 1e-10; the chunks per lane differ
  across lanes, so the per-lane freeze is exercised. With
  ``early_exit=False`` (what runs under CUDA graph capture) the loop runs
  the whole budget to the same iterate, bit for bit.
* The flagship closed loop under ``solver="admm", early_tol=1e-3`` (60+60
  iterations, the early exit on phase 2), B=4, T=20, against the JAX
  package's batched rollout under the same configuration: every state
  within 1e-8, ``feasible`` equal.
* ``solver="cuda"`` with ``early_tol`` raises ``ValueError``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models import setup_tube_tracking as jax_setup_tube_tracking
from rtmpc_tpu.ops.qp import ADMMState as JaxADMMState
from rtmpc_tpu.ops.qp import admm_solve as jax_admm_solve
from rtmpc_tpu.parallel import make_batched_rollout as jax_batched_rollout
from rtmpc_tpu.utils import box as jax_box

from rtmpc_tpu_torch.models import arrays_from_numpy, flagship_setup
from rtmpc_tpu_torch.ops.qp import ADMMState, admm_solve
from rtmpc_tpu_torch.parallel import make_batched_rollout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
EARLY = dict(early_tol=1e-3, early_dual_factor=25.0, check_every=25)


@pytest.fixture(scope="module")
def jax_flagship():
    return jax_setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10,
        jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
        jax_box(np.array([0.1, 0.1])), fixed_initial_state=True)


def test_admm_early_exit_matches_vmapped_jax(jax_flagship):
    ja, _ = jax_flagship.to_device(dtype=jnp.float64, **KW)
    spec_j = ja.admm2
    spec = arrays_from_numpy(jax.tree_util.tree_map(np.asarray, ja),
                             torch.float64).admm2
    rng = np.random.default_rng(9)
    B, n_warm = 8, 4
    theta = np.concatenate([rng.uniform(-2, 2, (B, 2)),
                            rng.uniform(-4, 4, (B, 1)), np.zeros((B, 1))],
                           1)
    # two cold lanes with references outside X (the steady state
    # saturates): they do not converge within the budget
    theta[6:] = [[7.5, -1.5, -9.0, 0.0], [-7.0, 2.0, 12.0, 0.0]]
    # warm lanes: a long solve's iterate of their own QP; cold lanes: zero
    long = admm_solve(spec, torch.tensor(theta), iters=400).state
    cold = (torch.arange(B) >= n_warm)[:, None]
    state0 = ADMMState(*(torch.where(cold, 0.0, a) for a in long))

    want = jax.jit(jax.vmap(lambda t, s: jax_admm_solve(
        spec_j, t, s, iters=100, **EARLY)))(
        jnp.asarray(theta),
        JaxADMMState(*(jnp.asarray(a.numpy()) for a in state0)))
    got = admm_solve(spec, torch.tensor(theta), state0, iters=100, **EARLY)
    chunks = admm_solve.lane_chunks.tolist()
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(got.state, f).numpy(),
                                   np.asarray(getattr(want.state, f)),
                                   rtol=0, atol=1e-10, err_msg=f)
    for f in ("z_primal", "r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-10, err_msg=f)
    # measured: the warm lanes stop after one chunk, the cold ones after
    # 2 and 3, the saturating ones run the budget
    assert chunks == [1] * n_warm + [2, 3, 4, 4], chunks

    # the whole budget (as under capture): the same iterate, bit for bit
    full = admm_solve(spec, torch.tensor(theta), state0, iters=100,
                      early_exit=False, **EARLY)
    for a, b in zip(full.state, got.state):
        assert torch.equal(a, b)


def test_closed_loop_early_exit_matches_jax(jax_flagship):
    B, T = 4, 20
    rng = np.random.default_rng(11)
    theta = (rng.uniform(size=(B, T)) >= 0.5).astype(np.int32)
    gamma = (rng.uniform(size=(B, T)) >= 0.5).astype(np.int32)
    theta[:, 0] = gamma[:, 0] = 1
    w = rng.uniform(-0.1, 0.1, size=(B, T, 2))
    x0 = rng.uniform(-1.0, 1.0, size=(B, 2))
    refs = np.zeros((B, T, 2))
    refs[:, :10, 0] = 4.0
    refs[:, 10:, 0] = -3.0
    inputs = (x0, refs, w, theta, gamma)

    ja, jcfg = jax_flagship.to_device(dtype=jnp.float64, **KW, **EARLY)
    _, want = jax.jit(jax_batched_rollout(ja, jcfg, T))(
        *map(jnp.asarray, inputs))
    arrays, cfg = flagship_setup().to_device(torch.float64, "cpu",
                                             solver="admm", **KW, **EARLY)
    assert cfg.early_tol == 1e-3 and cfg.check_every == 25
    admm_solve.early_calls = admm_solve.chunks = 0
    _, got = make_batched_rollout(arrays, cfg, T)(
        *map(torch.as_tensor, inputs))
    # one early-exit call a step (phase 2), fewer chunks than the budget's
    assert admm_solve.early_calls == T
    assert admm_solve.chunks < 3 * T
    for f in ("x", "x_nom", "x_hat", "u"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(want.feasible))


def test_cuda_solver_refuses_early_tol():
    with pytest.raises(ValueError, match="fixed iteration count"):
        flagship_setup().to_device(torch.float32, "cpu", solver="cuda",
                                   early_tol=1e-3, **KW)
