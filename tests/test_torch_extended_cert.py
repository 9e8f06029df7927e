"""The extended controller's infeasibility certificate follows the QP that
was used (the port against the JAX package on the extended double
integrator of ``test_torch_extended.py``).

With the packet-received QP made infeasible (and only it), a rollout stops
exactly when the previous step's gamma was 1 for two steps in a row: under
"ip_riccati" with one solve a step and with both solves (a final primal
residual above 1e-2 on the used QP), and under "admm" (the OSQP
certificates of the used QP's final state), with ``feasible`` equal to the
JAX engine's at every step.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models.specs import (setup_extended_tube_tracking as
                                    jax_setup_extended)
from rtmpc_tpu.parallel import make_rollout_fn as jax_rollout_fn
from rtmpc_tpu.utils import box as jax_box

from rtmpc_tpu_torch.models import setup_extended_tube_tracking
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.parallel.rollout import _one_solve_eligible
from rtmpc_tpu_torch.utils import box


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)


def _di(setup_fn, box_fn):
    return setup_fn(np.array([[1.0, 1.0], [0.0, 1.0]]),
                    np.array([[0.0], [1.0]]), np.eye(2), np.eye(1), 10,
                    box_fn(np.array([8.0, 8.0])), box_fn(np.array([1.0])),
                    box_fn(np.array([0.1, 0.1])), fixed_initial_state=False)


@pytest.fixture(scope="module")
def port_setup():
    return _di(setup_extended_tube_tracking, box)


# gamma of four rollouts; the QP used at step t is the packet-received one
# where gamma[t - 1] == 1 (and at step 0)
CERT_GAMMA = np.array([[0, 1, 0, 1, 0, 1, 0, 1],     # never twice in a row
                       [0, 0, 0, 1, 1, 0, 0, 0],     # steps 4 and 5
                       [0, 0, 0, 0, 0, 0, 0, 0],     # step 0 only
                       [1, 1, 1, 1, 1, 1, 1, 1]],    # steps 0 and 1
                      np.int32)
# first step at which each rollout reports feasible == False (None: never)
CERT_STOPS = (None, 5, None, 1)


def _break_pr(arrays, solver, n_init_rows, init_start):
    """``arrays`` with the packet-received QP made infeasible and nothing
    else changed: every initial-tube row's bound set to -1, so that the
    rows ask ``Hz (x_init - x_0) <= -1`` of a bounded Z's whole H-rep.
    Works on the JAX package's arrays and the port's alike."""
    def broken(spec, field):
        b = np.array(getattr(spec, field), copy=True)
        b[init_start:init_start + n_init_rows] = -1.0
        like = getattr(spec, field)
        new = (torch.tensor(b) if isinstance(like, torch.Tensor)
               else jnp.asarray(b))
        return spec._replace(**{field: new})

    if solver == "ip_riccati":
        return arrays._replace(ric_pr=broken(arrays.ric_pr, "ht0"))
    return arrays._replace(admm_pr=broken(arrays.admm_pr, "u0"),
                           admm2_pr=broken(arrays.admm2_pr, "u0"))


def _solver_kw(solver):
    # 15 iterations: the feasible solves here converge in fewer, and an
    # infeasible one runs them all
    return (dict(solver="ip_riccati", ip_iters=15) if solver == "ip_riccati"
            else dict(solver="admm", **KW))


def _cert_inputs():
    B, T = CERT_GAMMA.shape
    rng = np.random.default_rng(13)
    refs = np.zeros((B, T, 2))
    refs[:, :, 0] = 2.0
    return (np.zeros((B, 2)), refs, rng.uniform(-0.1, 0.1, size=(B, T, 2)),
            np.ones((B, T), np.int32), CERT_GAMMA)


def _init_rows(ps, solver):
    """(count, first row) of the initial-tube rows in the bounds that
    ``_break_pr`` edits: the ADMM spec keeps the template's row order
    [dynamics | init | ..], the interior point's ``ht0`` holds them alone."""
    mt = ps.template_pr.row_meta["mt"]
    return mt, 0 if solver == "ip_riccati" else ps.N * ps.nx


@functools.lru_cache(maxsize=None)
def _jax_feasible(solver):
    """``(outs.feasible, carry.feasible)`` of the JAX engine with the broken
    packet-received QP."""
    js, ps = _di(jax_setup_extended, jax_box), _di(
        setup_extended_tube_tracking, box)
    T = CERT_GAMMA.shape[1]
    ja, jc = js.to_device(dtype=jnp.float64, **_solver_kw(solver))
    fn = jax.jit(jax.vmap(jax_rollout_fn(
        _break_pr(ja, solver, *_init_rows(ps, solver)), jc, T,
        infeas_mode="certificate")))
    carry, outs = fn(*map(jnp.asarray, _cert_inputs()))
    return np.asarray(outs.feasible), np.asarray(carry.feasible)


def _port_run(arrays, cfg, T, inp, **kw):
    return make_batched_rollout(arrays, cfg, T, infeas_mode="certificate",
                                **kw)(*map(torch.tensor, inp))


@pytest.mark.parametrize("solver,one_solve", [("ip_riccati", None),
                                              ("ip_riccati", False),
                                              ("admm", None)])
def test_certificate_follows_the_used_qp(port_setup, solver, one_solve):
    ps = port_setup
    T = CERT_GAMMA.shape[1]
    inp = _cert_inputs()
    jouts_feasible, jcarry_feasible = _jax_feasible(solver)
    arrays, cfg = ps.to_device(torch.float64, "cpu", **_solver_kw(solver))
    broken = _break_pr(arrays, solver, *_init_rows(ps, solver))
    extra = {} if one_solve is None else dict(one_solve=one_solve)
    if solver == "ip_riccati":
        assert _one_solve_eligible(broken, cfg)
    carry, outs = _port_run(broken, cfg, T, inp, **extra)
    feasible = outs.feasible.numpy()
    np.testing.assert_array_equal(feasible, jouts_feasible)
    np.testing.assert_array_equal(carry.feasible.numpy(), jcarry_feasible)
    for lane, stop in enumerate(CERT_STOPS):
        want = np.ones(T, bool)
        if stop is not None:
            want[stop:] = False
        np.testing.assert_array_equal(feasible[lane], want, err_msg=str(lane))
    # the normal QP alone is never certified: without the break nothing stops
    carry, _ = _port_run(arrays, cfg, T, inp, **extra)
    assert bool(carry.feasible.all())
