"""Infeasibility certificates and the arm stop of the port against the JAX
package's (``tests/test_certificates.py`` scenarios: the double-integrator
tracking QP, N=10, X=+-8, U=+-1).

* ``infeasibility_certificates`` on the feasible and infeasible QPs of
  ``tests/test_certificates.py:52-70``: the booleans equal the JAX
  package's, with the extra iterations run by ``admm_solve`` and by the
  kernel's plain version (``admm_solve_cuda`` on the CPU).
* The closed-loop arm stop (smart actuator, ``infeas_mode="certificate"``)
  on a benign and a hostile run (a disturbance burst drives the state out
  of X): the per-step ``feasible`` flags, hence the stop step, equal the
  JAX engine's for solvers "admm" (certificates) and "ip_riccati" (primal
  residual above 1e-2); the states agree within 1e-8.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models.specs import setup_tracking as jax_setup_tracking
from rtmpc_tpu.ops.qp import admm_solve as jax_admm_solve
from rtmpc_tpu.ops.qp import (infeasibility_certificates as
                              jax_certificates)
from rtmpc_tpu.ops.qp import prepare_admm as jax_prepare_admm
from rtmpc_tpu.parallel.rollout import (make_batched_rollout as
                                        jax_batched_rollout)
from rtmpc_tpu.utils.polytope import box

from rtmpc_tpu_torch.models import setup_tracking, spec_from_numpy
from rtmpc_tpu_torch.ops.qp import admm_solve, infeasibility_certificates
from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
from rtmpc_tpu_torch.parallel import make_batched_rollout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NX = 2
A = np.array([[1.0, 1.0], [0.0, 1.0]])
B = np.array([[0.0], [1.0]])
ARGS = (A, B, np.eye(2), np.eye(1), 10, box(np.array([8.0, 8.0])),
        box(np.array([1.0])))
THETAS = np.array([[20.0, 0.0, 0.0, 0.0],     # x_init outside X: empty QP
                   [1.0, 2.0, 5.0, 0.0], [0.0, 0.0, -9.0, 0.0],
                   [-4.0, 1.0, 4.0, 0.0]])
T = 30


@pytest.fixture(scope="module")
def jax_setup():
    return jax_setup_tracking(*ARGS)


def test_certificates_match_jax(jax_setup):
    jspec = jax_prepare_admm(jax_setup.template, dtype=jnp.float64)
    want = []
    for th in THETAS:
        sol = jax_admm_solve(jspec, jnp.asarray(th), iters=400)
        want.append([bool(v) for v in
                     jax_certificates(jspec, jnp.asarray(th), sol.state)])
    want = np.array(want)
    assert want.tolist() == [[True, False]] + [[False, False]] * 3

    spec = spec_from_numpy(jax.tree_util.tree_map(np.asarray, jspec))
    theta = torch.tensor(THETAS)
    state = admm_solve(spec, theta, iters=400).state
    for solve in (admm_solve, admm_solve_cuda):
        pinf, dinf = infeasibility_certificates(spec, theta, state,
                                                solve=solve)
        got = torch.stack([pinf, dinf], 1).numpy()
        np.testing.assert_array_equal(got, want, err_msg=solve.__name__)


def _inputs():
    """Row 0 benign, row 1 hostile (``tests/test_certificates.py:73-89``)."""
    rng = np.random.default_rng(3)
    refs = np.zeros((T, NX))
    refs[:, 0] = 5.0
    w = rng.uniform(-0.05, 0.05, size=(T, NX))
    hostile = w.copy()
    hostile[8:14] = np.array([2.5, 2.5])
    ones = np.ones((2, T), np.int32)
    return (np.zeros((2, NX)), np.stack([refs, refs]),
            np.stack([w, hostile]), ones, ones)


@pytest.mark.parametrize("solver", ["admm", "ip_riccati"])
def test_closed_loop_arm_stop_matches_jax(jax_setup, solver):
    kw = (dict(solver="ip_riccati", ip_iters=30) if solver == "ip_riccati"
          else dict(solver="admm", iters=400))
    inputs = _inputs()
    ja, jc = jax_setup.to_device(dtype=jnp.float64, **kw)
    jcarry, jouts = jax.jit(jax_batched_rollout(
        ja, jc, T, actuator_mode="smart", infeas_mode="certificate"))(
            *map(jnp.asarray, inputs))
    pa, pc = setup_tracking(*ARGS).to_device(torch.float64, "cpu", **kw)
    carry, outs = make_batched_rollout(
        pa, pc, T, actuator_mode="smart", infeas_mode="certificate")(
            *map(torch.tensor, inputs))

    want = np.asarray(jouts.feasible)
    np.testing.assert_array_equal(outs.feasible.numpy(), want)
    np.testing.assert_array_equal(carry.feasible.numpy(),
                                  np.asarray(jcarry.feasible))
    np.testing.assert_array_equal(carry.infeas_count.numpy(),
                                  np.asarray(jcarry.infeas_count))
    assert want[0].all() and not want[1].all(), "the hostile run must stop"
    np.testing.assert_allclose(outs.x.numpy(), np.asarray(jouts.x), rtol=0,
                               atol=1e-8)
