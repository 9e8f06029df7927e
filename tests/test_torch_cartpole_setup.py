"""The port's jax-free cartpole setup against the JAX package's.

Both packages build the Fig. 3a controllers from the same NumPy code, each
on its own ``utils``/``sets`` (the port's are copies), so everything is
bit-equal: the scenario, the ``setup_tracking`` and ``setup_tube_tracking
(rpi_method=1, fixed_initial_state=True)`` templates, the structured IP's
spec from ``to_device(solver="ip_riccati", float64)`` (against the JAX
package's ``prepare_ip_riccati``, bridged by ``ric_spec_from_numpy``), and
the ADMM specs of the app's ``--solver cuda`` schedule.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario
from rtmpc_tpu.models.specs import setup_tracking as jax_setup_tracking
from rtmpc_tpu.models.specs import (setup_tube_tracking as
                                    jax_setup_tube_tracking)
from rtmpc_tpu.ops.ip_riccati import prepare_ip_riccati as jax_prepare_ric

from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
from rtmpc_tpu_torch.models import (arrays_from_numpy, ric_spec_from_numpy,
                                    setup_tracking, setup_tube_tracking)
from rtmpc_tpu_torch.ops.ip_riccati import RiccatiIPSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEMPLATE_ARRAYS = ("P", "q0", "Mq", "A", "l0", "Ml", "u0", "Mu", "is_eq")
TEMPLATE_SCALARS = ("nx", "nu", "N", "tracking", "ntheta", "row_meta", "S")
ADMM_KW = dict(iters=200, iters2=200, alpha=1.8, rho2_scale=0.2)


@pytest.fixture(scope="module")
def scenarios():
    return jax_scenario(), cartpole_scenario()


@pytest.fixture(scope="module")
def setups(scenarios):
    """{arm: (JAX setup, port setup)} as the app sets the arms up."""
    js, ps = scenarios
    return {
        "tube": (jax_setup_tube_tracking(
                     js.A, js.B, js.Q, js.R, js.N, js.X, js.U, js.W,
                     fixed_initial_state=True, rpi_method=1),
                 setup_tube_tracking(
                     ps.A, ps.B, ps.Q, ps.R, ps.N, ps.X, ps.U, ps.W,
                     fixed_initial_state=True, rpi_method=1)),
        "track": (jax_setup_tracking(js.A, js.B, js.Q, js.R, js.N, js.X,
                                     js.U),
                  setup_tracking(ps.A, ps.B, ps.Q, ps.R, ps.N, ps.X, ps.U)),
    }


def test_scenario_bit_equal(scenarios):
    js, ps = scenarios
    for f in ("A", "B", "Q", "R", "w_lo", "w_hi", "x0"):
        assert np.array_equal(getattr(js, f), getattr(ps, f)), f
    for f in ("N", "Th", "ref_value", "T", "physics_substeps"):
        assert getattr(js, f) == getattr(ps, f), f
    assert dataclasses.asdict(js.params) == dataclasses.asdict(ps.params)
    for f in ("X", "U", "W"):
        assert np.array_equal(getattr(js, f).A, getattr(ps, f).A), f
        assert np.array_equal(getattr(js, f).b, getattr(ps, f).b), f


@pytest.mark.parametrize("arm", ["tube", "track"])
def test_template_bit_equal(setups, arm):
    jt, pt = setups[arm][0].template, setups[arm][1].template
    for f in TEMPLATE_ARRAYS:
        a, b = getattr(jt, f), getattr(pt, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    for f in TEMPLATE_SCALARS:
        assert getattr(jt, f) == getattr(pt, f), f
    for f in ("xbar_slice", "ubar_slice"):
        assert getattr(jt, f) == getattr(pt, f), f
    assert jt.x_slice(3) == pt.x_slice(3) and jt.u_slice(5) == pt.u_slice(5)
    assert (jt.n, jt.m) == {"tube": (109, 792), "track": (109, 834)}[arm]


@pytest.mark.parametrize("arm", ["tube", "track"])
def test_ric_spec_bit_equal(setups, arm):
    jax_setup, port_setup = setups[arm]
    want = ric_spec_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_prepare_ric(jax_setup.template, dtype=jnp.float64)))
    arrays, cfg = port_setup.to_device(torch.float64, "cpu",
                                       solver="ip_riccati", ip_iters=30)
    assert arrays.admm is None and cfg.ip_iters == 30
    for f in RiccatiIPSpec._fields:
        a, b = getattr(arrays.ric, f), getattr(want, f)
        assert a.dtype == b.dtype == torch.float64, f
        assert a.shape == b.shape and torch.equal(a, b), f


@pytest.mark.parametrize("arm", ["tube", "track"])
def test_admm_arrays_bit_equal(setups, arm):
    """The app's --solver cuda schedule: rho, K^{-1}, the compact
    composites and the model matrices, bit-equal (the track arm has no
    tube: a dummy Hz row and K_plant = K)."""
    jax_setup, port_setup = setups[arm]
    ja, jc = jax_setup.to_device(dtype=jnp.float64, **ADMM_KW)
    want = arrays_from_numpy(jax.tree_util.tree_map(np.asarray, ja))
    got, cfg = port_setup.to_device(torch.float64, "cpu", solver="cuda",
                                    **ADMM_KW)
    for f in ("A", "B", "K_ss", "K_plant", "Hz", "hz"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for spec in ("admm", "admm2"):
        for f in got.admm._fields:
            assert torch.equal(getattr(getattr(got, spec), f),
                               getattr(getattr(want, spec), f)), (spec, f)
    assert got.admm.Kinv.shape[0] + got.admm.As.shape[0] == \
        {"tube": 112 + 792, "track": 112 + 840}[arm]
    for f in ("nx", "nu", "N", "n", "tracking", "iters", "iters2", "u_off",
              "xbar_off", "ubar_off"):
        assert getattr(cfg, f) == getattr(jc, f), f
