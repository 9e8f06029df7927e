"""The port's jax-free flagship setup against the JAX package's.

Same NumPy code and the same rho-tuning rng on both sides, so the freeze
must be bit-equal: the QP template, rho, K^{-1}, the composites (the JAX
package's 128-lane slots cut to the compact layout by
``arrays_from_numpy``), the model matrices and the config offsets.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.utils import box as jax_box
from rtmpc_tpu.models import setup_regulator as jax_setup_regulator
from rtmpc_tpu.models import setup_tube_tracking as jax_setup_tube_tracking
from rtmpc_tpu.ops.qp import prepare_admm as jax_prepare_admm

from rtmpc_tpu_torch.models import (arrays_from_numpy, flagship_setup,
                                    spec_from_numpy)
from rtmpc_tpu_torch.ops.qp import ADMMSpec, prepare_admm

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
TEMPLATE_ARRAYS = ("P", "q0", "Mq", "A", "l0", "Ml", "u0", "Mu", "is_eq")
TEMPLATE_SCALARS = ("nx", "nu", "N", "tracking", "ntheta", "row_meta")


def _jax_flagship():
    return jax_setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10,
        jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
        jax_box(np.array([0.1, 0.1])), fixed_initial_state=True)


@pytest.fixture(scope="module")
def setups():
    return _jax_flagship(), flagship_setup()


@pytest.fixture(scope="module")
def frozen64(setups):
    jax_setup, port_setup = setups
    ja, jc = jax_setup.to_device(dtype=jnp.float64, **KW)
    pa, pc = port_setup.to_device(torch.float64, "cpu", **KW)
    bridged = arrays_from_numpy(jax.tree_util.tree_map(np.asarray, ja),
                                torch.float64)
    return ja, jc, pa, pc, bridged


def _assert_spec_equal(got: ADMMSpec, want: ADMMSpec):
    for f in ADMMSpec._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f"ADMMSpec.{f} differs"


def test_template_bit_equal(setups):
    jt, pt = setups[0].template, setups[1].template
    for f in TEMPLATE_ARRAYS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f),
                                      err_msg=f)
    for f in TEMPLATE_SCALARS:
        assert getattr(pt, f) == getattr(jt, f), f
    assert (pt.n, pt.m) == (35, 110)


@pytest.mark.parametrize("phase", ["admm", "admm2"])
def test_admm_spec_bit_equal(frozen64, phase):
    ja, _, pa, _, bridged = frozen64
    _assert_spec_equal(getattr(pa, phase), getattr(bridged, phase))
    spec = getattr(pa, phase)
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    assert (n_p, m_p) == (40, 112)
    for f in ("Gxc", "Gsc", "Kcat"):
        assert getattr(spec, f).shape[1] == n_p + m_p
    # the tuned rho itself, straight from the JAX arrays
    np.testing.assert_array_equal(spec.rho.numpy(),
                                  np.asarray(getattr(ja, phase).rho))


def test_arrays_and_config_bit_equal(frozen64):
    _, jc, pa, pc, bridged = frozen64
    for f in ("A", "B", "K_ss", "K_plant", "Hz", "hz"):
        assert torch.equal(getattr(pa, f), getattr(bridged, f)), f
    for f in ("nx", "nu", "N", "n", "tracking", "iters", "iters2", "u_off",
              "xbar_off", "ubar_off"):
        assert getattr(pc, f) == getattr(jc, f), f
    assert (pc.u_off, pc.xbar_off, pc.ubar_off) == (22, 32, 34)


@pytest.mark.parametrize("tune_iters,want_rho", [(10, 0.5), (40, 5.0)])
def test_rho_autotune_bit_equal(tune_iters, want_rho):
    """On the flagship every candidate budget picks rho = 0.5; a regulator
    with a cheap input (R = 0.01) picks by budget, so the port's probe
    draws, trial iteration and first-best rule are held to the JAX
    package's on a choice that moves."""
    tmpl = jax_setup_regulator(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), 0.01 * np.eye(1), 10,
        jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0]))).template
    want = jax_prepare_admm(tmpl, tune_iters=tune_iters, dtype=jnp.float64)
    got = prepare_admm(tmpl, tune_iters=tune_iters, dtype=torch.float64)
    _assert_spec_equal(got, spec_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), torch.float64))
    assert float(got.rho.min()) == want_rho


def test_float32_freeze_bit_equal(setups):
    """The cast to float32 happens once, from the same float64 data."""
    jax_setup, port_setup = setups
    ja, _ = jax_setup.to_device(dtype=jnp.float32, **KW)
    pa, _ = port_setup.to_device(torch.float32, "cpu", **KW)
    bridged = arrays_from_numpy(jax.tree_util.tree_map(np.asarray, ja),
                                torch.float32)
    _assert_spec_equal(pa.admm, bridged.admm)
    _assert_spec_equal(pa.admm2, bridged.admm2)


def test_arrays_move_between_devices(frozen64):
    """``.to(device)`` moves every leaf, nested specs included."""
    pa = frozen64[2]
    moved = pa.to("meta")
    assert all(t.device.type == "meta" for t in (moved.A, *moved.admm,
                                                 *moved.admm2))
    back = pa.to("cpu")
    _assert_spec_equal(back.admm, pa.admm)


def test_precision_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_unported_solver_raises(setups):
    with pytest.raises(NotImplementedError):
        setups[1].to_device(torch.float64, "cpu", solver="pallas", **KW)
