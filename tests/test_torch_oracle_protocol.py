"""The port's copy of the float64 protocol oracle
(``rtmpc_tpu_torch/utils/oracle_protocol.py``) against the JAX repo's
(``tests/oracle_protocol.py``), on the CPU.

The double integrator of ``tests/test_rollout_parity.py`` (N=10, T=40, its
``_draw_inputs``): the JAX setups go to the JAX oracle, the port's setups
(bit-identical to them, ``tests/test_torch_setup.py``) to the port's
oracle.  The consistent tube setup, the smart actuator
(``setup_tracking``) and the extended setup: x, u, x_nom and x_hat equal
to 1e-12, Theta, ``feasible`` and the steps equal.  The copy imports
nothing of the port's engine, which is what makes it an oracle for it.
"""

import ast
import warnings

import numpy as np
import pytest

from rtmpc_tpu.models.specs import (setup_extended_tube_tracking as
                                    jax_setup_extended,
                                    setup_tracking as jax_setup_tracking,
                                    setup_tube_tracking as
                                    jax_setup_tube_tracking)
from rtmpc_tpu.utils.polytope import box as jax_box

from oracle_protocol import run_oracle_rollout as jax_oracle
from test_rollout_parity import A, B, Q, R, X0, _draw_inputs

from rtmpc_tpu_torch.models import (setup_extended_tube_tracking,
                                    setup_tracking, setup_tube_tracking)
from rtmpc_tpu_torch.utils import box
from rtmpc_tpu_torch.utils import oracle_protocol
from rtmpc_tpu_torch.utils.oracle_protocol import run_oracle_rollout

TOL = 1e-12


def _boxes(make_box, w_half):
    return (make_box(np.array([8.0, 8.0])), make_box(np.array([1.0])),
            make_box(np.array([w_half, w_half])))


def _tube(setup_fn, make_box):
    return setup_fn(A, B, Q, R, 10, *_boxes(make_box, 0.1),
                    fixed_initial_state=True)


def _tracking(setup_fn, make_box):
    return setup_fn(A, B, Q, R, 10, *_boxes(make_box, 0.1)[:2])


def _extended(setup_fn, make_box):
    return setup_fn(A, B, Q, R, 10, *_boxes(make_box, 0.05),
                    fixed_initial_state=False)


# name: (JAX setup, port setup, inputs' seed, actuator mode); the inputs of
# test_rollout_parity.py's flagship, smart-actuator and extended cases
CASES = {
    "tube": (lambda: _tube(jax_setup_tube_tracking, jax_box),
             lambda: _tube(setup_tube_tracking, box), 11, "consistent"),
    "smart": (lambda: _tracking(jax_setup_tracking, jax_box),
              lambda: _tracking(setup_tracking, box), 13, "smart"),
    "extended": (lambda: _extended(jax_setup_extended, jax_box),
                 lambda: _extended(setup_extended_tube_tracking, box), 14,
                 "consistent"),
}


def _inputs(name, seed):
    refs, w, theta, gamma = _draw_inputs(seed)
    if name == "smart":
        w = np.zeros_like(w)      # the reference example has no disturbance
    elif name == "extended":
        w = np.clip(w, -0.05, 0.05)
    return refs, w, theta, gamma


@pytest.mark.parametrize("name", list(CASES))
def test_port_oracle_equals_jax_oracle(name):
    make_jax, make_port, seed, mode = CASES[name]
    refs, w, theta, gamma = _inputs(name, seed)
    with warnings.catch_warnings():
        # the float64 IP drives its barrier stiff near convergence
        warnings.filterwarnings("ignore", message=".*ill-conditioned.*")
        want = jax_oracle(make_jax(), X0, refs, w, theta, gamma,
                          actuator_mode=mode)
        got = run_oracle_rollout(make_port(), X0, refs, w, theta, gamma,
                                 actuator_mode=mode)
    assert want["feasible"] and want["steps"] == len(refs)
    for k in ("feasible", "steps"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["Theta"], want["Theta"])
    for k in ("x", "u", "x_nom", "x_hat"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)
    if name != "smart":           # the lossy loop really lost packets
        assert 0 < want["Theta"].sum() < len(refs)


def test_oracle_imports_nothing_of_the_engine():
    """The copy's value is its independence: numpy, and the port's setup
    types for annotations alone; no rollout, solver or protocol module."""
    path = oracle_protocol.__file__
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append("." * node.level + (node.module or ""))
    assert set(imported) == {"__future__", "typing", "numpy",
                             "..models.specs"}, imported
