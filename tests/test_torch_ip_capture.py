"""The structured interior point's loop with no read of the device, as a
CUDA graph captures it, against its early-exit loop and the JAX package,
in float64 on the CPU.

While a graph is being captured ``ip_riccati_solve`` runs its whole
iteration budget (the JAX package's ``while_loop`` never reads the host
either); ``early_exit=False`` forces that path here.  A lane that has
stopped is carried by selects, so the fixed budget gives the early-exit
iterate bit for bit: on the flagship's QP (fixed initial state, no
refinement) and on both QPs of an extended double-integrator controller
(the packet-received one has a free initial state, so the refinement
runs).  The fixed-budget solve is held to the JAX package's
``ip_riccati_solve`` as well: r_prim at 1e-9 and z at 1e-6, the bars the
extended arm's interior point meets against the JAX package elsewhere
(``tests/test_torch_extended.py``; the converged iterate of this
degenerate QP moves by ~1e-7 with the order of the float64 sums).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models import (
    setup_extended_tube_tracking as jax_setup_extended_tube_tracking)
from rtmpc_tpu.ops.ip_riccati import ip_riccati_solve as jax_ip_riccati_solve
from rtmpc_tpu.utils import box as jax_box

from rtmpc_tpu_torch.models import (flagship_setup,
                                    setup_extended_tube_tracking)
from rtmpc_tpu_torch.ops.ip_riccati import ip_riccati_solve
from rtmpc_tpu_torch.utils import box

A = np.array([[1.0, 1.0], [0.0, 1.0]])
B = np.array([[0.0], [1.0]])
ITERS = 30
R_TOL, Z_TOL = 1e-9, 1e-6
EXT_ARGS = (A, B, np.eye(2), np.eye(1), 10)


def _thetas(n, seed):
    """Initial states the tube controllers can steer (a lane that stalls
    on an infeasible QP would keep the early-exit loop to its budget) and
    references beyond X = +-8 too (they saturate)."""
    rng = np.random.default_rng(seed)
    th = np.zeros((n, 4))
    th[:, :2] = rng.uniform(-1.5, 1.5, (n, 2))
    th[:, 2] = rng.uniform(-9, 9, n)
    return th


@pytest.fixture(scope="module")
def specs():
    ext = setup_extended_tube_tracking(
        *EXT_ARGS, box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])))
    a_ext, _ = ext.to_device(torch.float64, "cpu", solver="ip_riccati")
    a_fl, _ = flagship_setup().to_device(torch.float64, "cpu",
                                         solver="ip_riccati")
    return {"flagship": a_fl.ric, "extended": a_ext.ric,
            "extended packet-received": a_ext.ric_pr}


@pytest.mark.parametrize("qp", ["flagship", "extended",
                                "extended packet-received"])
def test_fixed_budget_equals_early_exit_bit_for_bit(specs, qp):
    spec = specs[qp]
    th = torch.tensor(_thetas(16, 3))
    runs = {}
    for early in (True, False):
        ip_riccati_solve.iterations = ip_riccati_solve.calls = 0
        runs[early] = ip_riccati_solve(spec, th, 10, iters=ITERS,
                                       early_exit=early)
        runs[early, "iterations"] = ip_riccati_solve.iterations
    # the early exit stops before the budget, so the fixed loop does run
    # iterations in which every lane is frozen
    assert runs[True, "iterations"] < ITERS == runs[False, "iterations"]
    for name, a, b in zip(runs[True]._fields, runs[True], runs[False]):
        assert torch.equal(a, b), name


def test_default_outside_a_capture_exits_early(specs):
    th = torch.tensor(_thetas(4, 5))
    ip_riccati_solve.iterations = 0
    got = ip_riccati_solve(specs["flagship"], th, 10, iters=ITERS)
    assert ip_riccati_solve.iterations < ITERS
    want = ip_riccati_solve(specs["flagship"], th, 10, iters=ITERS,
                            early_exit=False)
    assert torch.equal(got.z_primal, want.z_primal)


def test_fixed_budget_matches_jax_on_the_refined_qp(specs):
    """The packet-received QP of the extended controller (free initial
    state: one refinement round a Newton solve) against the JAX package's
    solve of its own setup's same QP."""
    jext = jax_setup_extended_tube_tracking(
        *EXT_ARGS, jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
        jax_box(np.array([0.1, 0.1])))
    ja, _ = jext.to_device(dtype=jnp.float64, solver="ip_riccati")
    th = _thetas(8, 7)
    want = jax.vmap(lambda t: jax_ip_riccati_solve(ja.ric_pr, t, 10,
                                                   iters=ITERS))(
        jnp.asarray(th))
    got = ip_riccati_solve(specs["extended packet-received"],
                           torch.tensor(th), 10, iters=ITERS,
                           early_exit=False)
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal)[:, :got.z_primal
                                                         .shape[1]],
                               rtol=0, atol=Z_TOL)
    np.testing.assert_allclose(got.r_prim.numpy(), np.asarray(want.r_prim),
                               rtol=0, atol=R_TOL)
