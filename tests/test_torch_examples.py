"""The port's six example apps against the JAX package's examples, in
float64 on the CPU, at the ``--quick`` length.

For each example the JAX example's own rollout (its setup, ``to_device``
arguments, rollout function and ``jax.random`` draws at seed 0, run here
as the example runs it) and the port example's ``run`` fed the same draws
give the same trajectory under the examples' default solver, the dense
interior point ("ip", float64): states, inputs, nominal states (and the
estimates and Theta of the two lossy examples) within 1e-9, Theta exactly,
r_prim within 1e-9, up to the first step whose JAX solve ends with r_dual
above 1.  Past convergence the reference's interior point lets the duals
drift (its freeze at mu < 100 eps^2 comes late; ``test_torch_polish_ip.py``),
and at one step the drift also moves the primal: step 21 of
``example_tube_tracking`` at seed 0 ends in the JAX example's scan with
r_dual 3.4e5 and an input 2.4e-4 away from what the JAX package's own
``ip_solve`` (eager or jitted alone) and the port both return at that
theta.  From there on the whole run is held within 1e-3 (read 4.8e-4; the
tube's closed loop contracts the gap back to 1e-15 by step 28).  r_dual is
not compared.  Each port example's ``main(["--device", "cpu",
"--quick"])`` returns 0 on the port's own draws.
"""

import argparse
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.common import solver_kwargs as jax_solver_kwargs
from rtmpc_tpu.models import (setup_regulator, setup_tracking,
                              setup_tube_regulator, setup_tube_tracking)
from rtmpc_tpu.parallel.rollout import make_direct_rollout, make_rollout_fn
from rtmpc_tpu.protocol import draw_disturbances, draw_loss_masks
from rtmpc_tpu.utils import Polytope, box

TOL = 1e-9
# after the first step whose reference solve has drifted (r_dual > 1)
DRIFT_TOL = 1e-3
A = np.array([[1.0, 1.0], [0.0, 1.0]])
B = np.array([[0.0], [1.0]])
EXAMPLES = ["regulator", "tracking", "tracking_lossy", "tube_regulator",
            "tube_tracking", "tube_tracking_lossy"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: batch-1 rollouts gain nothing from more, and
    the test workers that run in parallel then do not compete."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refs(T):
    refs = np.zeros((T, 2))
    seg = T // 4
    refs[:seg, 0] = 5.0
    refs[seg:2 * seg, 0] = -9.0
    refs[2 * seg:3 * seg, 0] = 9.0
    refs[3 * seg:, 0] = 4.0
    return refs


def jax_example(name):
    """``(outputs by field, draws)`` of the JAX example ``name`` at
    ``--quick``, seed 0, solver "ip", float64: the statements of
    ``rtmpc_tpu/apps/example_<name>.py`` up to its rollout."""
    args = argparse.Namespace(solver="ip", dtype="float64", quick=True)
    key = jax.random.PRNGKey(0)
    dt = jnp.float64
    x0 = np.array([1.0, 2.0])
    draws = {}
    if name == "regulator":
        T = 20
        setup = setup_regulator(A, B, np.eye(2), np.eye(1), 10,
                                U=box(np.array([1.0])))
        arrays, cfg = setup.to_device(dtype=dt, **jax_solver_kwargs(args))
        _, o = jax.jit(make_direct_rollout(arrays, cfg, T))(
            x0, jnp.zeros((T, 2)), jnp.zeros((T, 2)))
        fields = ("x", "u", "x_nom", "xbar", "r_prim", "r_dual")
    elif name in ("tracking", "tube_tracking"):
        T = 40
        if name == "tracking":
            setup = setup_tracking(A, B, np.eye(2), np.eye(1), 10,
                                   box(np.array([8.0, 8.0])),
                                   box(np.array([1.0])))
            kw, w = jax_solver_kwargs(args, admm_iters=400), jnp.zeros((T, 2))
        else:
            setup = setup_tube_tracking(A, B, np.eye(2), np.eye(1), 10,
                                        box(np.array([8.0, 8.0])),
                                        box(np.array([1.0])),
                                        box(np.array([0.1, 0.1])))
            kw = jax_solver_kwargs(args, admm_iters=600)
            w = draw_disturbances(key, T, -0.1 * np.ones(2),
                                  0.1 * np.ones(2))
            draws["w"] = np.asarray(w)
        arrays, cfg = setup.to_device(dtype=dt, **kw)
        _, o = jax.jit(make_direct_rollout(
            arrays, cfg, T, ancillary=name == "tube_tracking"))(
            x0, jnp.asarray(_refs(T)), w.astype(dt))
        fields = ("x", "u", "x_nom", "xbar", "r_prim", "r_dual")
    elif name == "tube_regulator":
        T = 15
        X = Polytope(np.array([[0.0, 1.0], [0.0, -1.0],
                               [1.0, 0.0], [-1.0, 0.0]]),
                     np.array([2.0, 50.0, 50.0, 50.0]))
        setup = setup_tube_regulator(A, np.array([[0.5], [1.0]]), np.eye(2),
                                     0.01 * np.eye(1), 9, X,
                                     box(np.array([1.0])),
                                     box(np.array([0.1, 0.1])))
        arrays, cfg = setup.to_device(
            dtype=dt, **jax_solver_kwargs(args, admm_iters=1500),
            probe_thetas=np.array([[-5.0, -2.0, 0.0, 0.0], [0.0, 0, 0, 0]]))
        w = draw_disturbances(key, T, -0.1 * np.ones(2), 0.1 * np.ones(2))
        draws["w"] = np.asarray(w)
        _, o = jax.jit(make_direct_rollout(arrays, cfg, T, ancillary=True))(
            np.array([-5.0, -2.0]), jnp.zeros((T, 2)), w.astype(dt))
        fields = ("x", "u", "x_nom", "xbar", "r_prim", "r_dual")
    else:
        T = 40
        if name == "tracking_lossy":
            setup = setup_tracking(A, B, np.eye(2), np.eye(1), 10,
                                   box(np.array([8.0, 8.0])),
                                   box(np.array([1.0])))
            arrays, cfg = setup.to_device(dtype=dt, **jax_solver_kwargs(args))
            theta, gamma = draw_loss_masks(key, T, 0.7, 0.7)
            w = jnp.zeros((T, 2), dt)
            fn = make_rollout_fn(arrays, cfg, T, actuator_mode="smart")
        else:
            setup = setup_tube_tracking(A, B, np.eye(2), np.eye(1), 10,
                                        box(np.array([8.0, 8.0])),
                                        box(np.array([1.0])),
                                        box(np.array([0.1, 0.1])),
                                        fixed_initial_state=True)
            arrays, cfg = setup.to_device(dtype=dt, iters=200, polish=True,
                                          solver="ip")
            kw_, kl = jax.random.split(key)
            theta, gamma = draw_loss_masks(kl, T, 0.7, 0.7)
            w = draw_disturbances(kw_, T, -0.1 * np.ones(2),
                                  0.1 * np.ones(2)).astype(dt)
            draws["w"] = np.asarray(w)
            fn = make_rollout_fn(arrays, cfg, T)
        draws["theta"], draws["gamma"] = np.asarray(theta), np.asarray(gamma)
        _, o = jax.jit(fn)(jnp.asarray(x0, dt), jnp.asarray(_refs(T)), w,
                           theta, gamma)
        o = o._asdict()
        return {k: np.asarray(o[k]) for k in ("x", "u", "x_nom", "x_hat",
                                              "Theta", "r_prim",
                                              "r_dual")}, draws
    return {f: np.asarray(v) for f, v in zip(fields, o)}, draws


def _module(name):
    return importlib.import_module(f"rtmpc_tpu_torch.apps.example_{name}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_rollout_matches_jax(name):
    want, draws = jax_example(name)
    mod = _module(name)
    got = mod.run(mod.parse_args(["--device", "cpu", "--quick"]),
                  draws=draws or None)
    assert got["launches"] == 0                 # "ip": no kernel
    drifted = np.flatnonzero(want.pop("r_dual") > 1.0)
    n = int(drifted[0]) if drifted.size else len(want["x"])
    assert n >= len(want["x"]) // 2, n
    for f, w in want.items():
        g = getattr(got["outs"], f)[0].numpy()
        assert g.shape == w.shape, f
        if f == "Theta":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g[:n], w[:n], rtol=0, atol=TOL,
                                       err_msg=f)
            np.testing.assert_allclose(g, w, rtol=0, atol=DRIFT_TOL,
                                       err_msg=f)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_passes_on_cpu(name):
    assert _module(name).main(["--device", "cpu", "--quick"]) == 0


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_the_structured_ip(name):
    """The examples take the dense interior point and the two ADMM
    solvers; ``ip_riccati`` is the Results apps' solver and is refused."""
    with pytest.raises(SystemExit):
        _module(name).parse_args(["--solver", "ip_riccati"])
    for solver in ("ip", "cuda", "admm"):
        assert _module(name).parse_args(["--solver", solver]).solver == solver
