"""Batched ADMM of the port against the JAX package on the flagship QP.

* ``ops/qp.py:admm_solve`` (three-matmul form) against
  ``jax.vmap(rtmpc_tpu.ops.qp.admm_solve)`` in float64, cold and warm,
  both schedule phases: <= 1e-10.
* The plain PyTorch version of the CUDA kernel (composite form, the CPU
  branch of ``admm_solve_cuda``) against the same in float64 (<= 1e-10),
  and in float32 against the Pallas kernel run in interpret mode at the
  bars of ``tests/test_qp_pallas.py`` (z 1e-5, y 2e-3).

Both packages get the same problem data: the port's spec is bridged from
the JAX package's with ``arrays_from_numpy`` (bit-equality of the port's
own setup is ``test_torch_setup.py``'s job).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.utils import box
from rtmpc_tpu.models import setup_tube_tracking
from rtmpc_tpu.ops.qp import ADMMState as JaxADMMState
from rtmpc_tpu.ops.qp import admm_solve as jax_admm_solve
from rtmpc_tpu.ops.qp_pallas import admm_solve_pallas

from rtmpc_tpu_torch.models import arrays_from_numpy
from rtmpc_tpu_torch.ops.qp import ADMMState, admm_solve
from rtmpc_tpu_torch.ops.qp_cuda import _admm_solve_cuda_plain, admm_solve_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
TOL64 = 1e-10


def _flagship():
    return setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)


@pytest.fixture(scope="module")
def flagship():
    return _flagship()


@pytest.fixture(scope="module")
def specs64(flagship):
    ja, _ = flagship.to_device(dtype=jnp.float64, **KW)
    return ja, arrays_from_numpy(jax.tree_util.tree_map(np.asarray, ja),
                                 torch.float64)


def _jax_solve(spec, theta, state, iters):
    return jax.jit(jax.vmap(
        lambda t, s: jax_admm_solve(spec, t, s, iters=iters)))(theta, state)


def _to_torch_state(state, dtype=torch.float64):
    return ADMMState(*(torch.tensor(np.asarray(a), dtype=dtype)
                       for a in state))


def _cold_jax_state(spec, B):
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    dt = spec.Kinv.dtype
    return JaxADMMState(jnp.zeros((B, n_p), dt), jnp.zeros((B, m_p), dt),
                        jnp.zeros((B, m_p), dt))


def _assert_solution_close(got, want, atol, rtol_res=0.0):
    for name, a, b in (("z_primal", got.z_primal, want.z_primal),
                       ("x", got.state.x, want.state.x),
                       ("y", got.state.y, want.state.y),
                       ("z", got.state.z, want.state.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=name)
    for name, a, b in (("r_prim", got.r_prim, want.r_prim),
                       ("r_dual", got.r_dual, want.r_dual)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=rtol_res, atol=atol, err_msg=name)


def _start(specs, start, B, seed):
    """theta and matching JAX/port start states: zeros, or the iterate of
    an earlier 60-iteration phase-1 solve on other thetas."""
    ja, _ = specs
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-2, 2, (B, 4))
    jstate = _cold_jax_state(ja.admm, B)
    if start == "warm":
        jstate = _jax_solve(ja.admm, jnp.asarray(rng.uniform(-2, 2, (B, 4))),
                            jstate, 60).state
    return theta, jstate, _to_torch_state(jstate)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("phase", ["admm", "admm2"])
def test_admm_solve_matches_jax(specs64, phase, start):
    ja, pa = specs64
    theta, jstate, pstate = _start(specs64, start, 64, seed=1)
    want = _jax_solve(getattr(ja, phase), jnp.asarray(theta), jstate, 60)
    got = admm_solve(getattr(pa, phase), torch.tensor(theta), pstate,
                     iters=60)
    _assert_solution_close(got, want, TOL64)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_kernel_plain_version_matches_jax_f64(specs64, start):
    """Both phases back to back, as the rollout calls them."""
    ja, pa = specs64
    theta, jstate, pstate = _start(specs64, start, 64, seed=2)
    th = jnp.asarray(theta)
    want = _jax_solve(ja.admm2, th, _jax_solve(ja.admm, th, jstate, 60).state,
                      60)
    got1 = _admm_solve_cuda_plain(pa.admm, torch.tensor(theta), pstate, 60)
    got = _admm_solve_cuda_plain(pa.admm2, torch.tensor(theta), got1.state,
                                 60)
    _assert_solution_close(got, want, TOL64)


@pytest.fixture(scope="module")
def specs32(flagship):
    """The spec of tests/test_qp_pallas.py (float32, one phase)."""
    ja, _ = flagship.to_device(dtype=jnp.float32, iters=60)
    return ja.admm, arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, ja), torch.float32).admm


def test_kernel_plain_version_matches_pallas_cold(specs32):
    jspec, pspec = specs32
    rng = np.random.default_rng(0)
    theta = rng.uniform(-2, 2, (12, 4)).astype(np.float32)
    want = admm_solve_pallas(jspec, jnp.asarray(theta), iters=40, block_b=8,
                             interpret=True)
    got = _admm_solve_cuda_plain(pspec, torch.tensor(theta), None, 40)
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), atol=1e-5)
    np.testing.assert_allclose(got.r_prim.numpy(), np.asarray(want.r_prim),
                               rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(got.r_dual.numpy(), np.asarray(want.r_dual),
                               rtol=5e-2, atol=1e-4)


def test_kernel_plain_version_matches_pallas_warm(specs32):
    jspec, pspec = specs32
    rng = np.random.default_rng(1)
    th1 = rng.uniform(-1, 1, (8, 4)).astype(np.float32)
    th2 = rng.uniform(-1, 1, (8, 4)).astype(np.float32)
    pal1 = admm_solve_pallas(jspec, jnp.asarray(th1), iters=25, block_b=8,
                             interpret=True)
    want = admm_solve_pallas(jspec, jnp.asarray(th2), pal1.state, iters=25,
                             block_b=8, interpret=True)
    got1 = _admm_solve_cuda_plain(pspec, torch.tensor(th1), None, 25)
    got = _admm_solve_cuda_plain(pspec, torch.tensor(th2), got1.state, 25)
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), atol=1e-5)
    np.testing.assert_allclose(got.state.y.numpy(), np.asarray(want.state.y),
                               atol=2e-3)


def test_wrapper_runs_plain_version_on_cpu(specs64):
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    counts no kernel launch."""
    pa = specs64[1]
    theta = torch.tensor(np.random.default_rng(3).uniform(-2, 2, (5, 4)))
    before = admm_solve_cuda.launches
    got = admm_solve_cuda(pa.admm, theta, None, 30)
    want = _admm_solve_cuda_plain(pa.admm, theta, None, 30)
    assert admm_solve_cuda.launches == before
    for a, b in zip((got.z_primal, *got.state, got.r_prim, got.r_dual),
                    (want.z_primal, *want.state, want.r_prim, want.r_dual)):
        assert torch.equal(a, b)


def test_wrapper_rejects_other_devices(specs64):
    pa = specs64[1]
    with pytest.raises(ValueError, match="unsupported device"):
        admm_solve_cuda(pa.admm.to("meta"),
                        torch.zeros(4, 4, device="meta"), None, 10)


@pytest.mark.parametrize("option", [{"polish": True}, {"early_tol": 1e-4}])
def test_unported_options_raise(specs64, option):
    pa = specs64[1]
    with pytest.raises(NotImplementedError):
        admm_solve(pa.admm, torch.zeros(2, 4, dtype=torch.float64), None,
                   iters=5, **option)


def test_kernel_plain_version_matches_pallas_cartpole_shape():
    """The large-composite regime: the cartpole tube QP (n_p + m_p = 112 +
    792, the kernel's L2 path), float32, 20 iterations, B=9, against the
    Pallas kernel in interpret mode: z 1e-4 (measured 2.4e-5: float32 sums
    of 904 terms in two orders), y 2e-3."""
    from rtmpc_tpu.apps.scenarios import cartpole_scenario
    from rtmpc_tpu.ops.qp import prepare_admm as jax_prepare_admm
    from rtmpc_tpu_torch.models import spec_from_numpy
    from rtmpc_tpu_torch.ops.qp_cuda import kernel_path
    sc = cartpole_scenario()
    st = setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U, sc.W,
                             fixed_initial_state=True, rpi_method=1)
    jspec = jax_prepare_admm(st.template, dtype=jnp.float32, alpha=1.8)
    pspec = spec_from_numpy(jax.tree_util.tree_map(np.asarray, jspec),
                            torch.float32)
    n_cols = pspec.Kinv.shape[0] + pspec.As.shape[0]
    assert n_cols == 904 and kernel_path(n_cols) == "l2"
    rng = np.random.default_rng(4)
    theta = np.zeros((9, 8), np.float32)
    theta[:, :4] = rng.uniform(-0.2, 0.2, (9, 4))
    theta[:, 4] = rng.uniform(-1.0, 6.0, 9)
    want = admm_solve_pallas(jspec, jnp.asarray(theta), iters=20, block_b=8,
                             interpret=True)
    got = _admm_solve_cuda_plain(pspec, torch.tensor(theta), None, 20)
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.state.y.numpy(), np.asarray(want.state.y),
                               rtol=0, atol=2e-3)


def test_kernel_path_limits():
    from rtmpc_tpu_torch.ops.qp_cuda import kernel_path
    assert kernel_path(152) == "smem" and kernel_path(192) == "smem"
    assert kernel_path(193) == "l2" and kernel_path(2048) == "l2"
    with pytest.raises(ValueError, match="2048"):
        kernel_path(2049)
