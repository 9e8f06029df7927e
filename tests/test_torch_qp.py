"""Batched ADMM of the port against the JAX package on the flagship QP.

* ``ops/qp.py:admm_solve`` (three-matmul form) against
  ``jax.vmap(rtmpc_tpu.ops.qp.admm_solve)`` in float64, cold and warm,
  both schedule phases: <= 1e-10.
* The plain PyTorch versions of the CUDA kernel's paths (the composite
  form of ``"smem"`` and ``"l2"``, the factored form of ``"fac"``; the
  CPU branch of ``admm_solve_cuda`` runs the one of the path the card would
  take) against the same in float64 (<= 1e-10), and in float32 against the
  Pallas kernel run in interpret mode at the bars of
  ``tests/test_qp_pallas.py`` (z 1e-5, y 2e-3), at B=1 too.
* ``kernel_path`` against the dispatch's rule at its edges.

Both packages get the same problem data: the port's spec is bridged from
the JAX package's with ``arrays_from_numpy`` (bit-equality of the port's
own setup is ``test_torch_setup.py``'s job).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.utils import box as jax_box
from rtmpc_tpu.models import setup_tube_tracking
from rtmpc_tpu.ops.qp import ADMMState as JaxADMMState
from rtmpc_tpu.ops.qp import admm_solve as jax_admm_solve
from rtmpc_tpu.ops.qp_pallas import admm_solve_pallas

from rtmpc_tpu_torch.models import arrays_from_numpy
from rtmpc_tpu_torch.ops.qp import ADMMState, admm_solve
from rtmpc_tpu_torch.ops.qp_cuda import (FAC_MAX_B, _admm_solve_cuda_plain,
                                         _admm_solve_factored_plain,
                                         admm_solve_cuda)


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
        jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
        jax_box(np.array([0.1, 0.1])), fixed_initial_state=True)


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
    """On CPU tensors the wrapper is the plain version of the path the card
    would take, bit for bit, and counts no kernel launch: the factored
    form up to ``FAC_MAX_B`` rows of the flagship's 152 columns, the
    composite form one row above."""
    pa = specs64[1]
    rng = np.random.default_rng(3)
    before = dict(admm_solve_cuda.launches_by_path)
    for B, plain in ((5, _admm_solve_factored_plain),
                     (FAC_MAX_B, _admm_solve_factored_plain),
                     (FAC_MAX_B + 1, _admm_solve_cuda_plain)):
        theta = torch.tensor(rng.uniform(-2, 2, (B, 4)))
        got = admm_solve_cuda(pa.admm, theta, None, 30)
        want = plain(pa.admm, theta, None, 30)
        for a, b in zip((got.z_primal, *got.state, got.r_prim, got.r_dual),
                        (want.z_primal, *want.state, want.r_prim,
                         want.r_dual)):
            assert torch.equal(a, b)
    assert admm_solve_cuda.launches_by_path == before


def test_wrapper_rejects_other_devices(specs64):
    pa = specs64[1]
    with pytest.raises(ValueError, match="unsupported device"):
        admm_solve_cuda(pa.admm.to("meta"),
                        torch.zeros(4, 4, device="meta"), None, 10)


@pytest.mark.parametrize("option", [{"early_tol": 1e-4, "polish": True},
                                    {"early_tol": 1e-4}])
def test_unported_options_raise(specs64, option):
    """The options that raised while they were not ported, the residual
    early exit with and without the polish, now solve.  The early exit
    against ``jax.vmap`` of the JAX package's ``admm_solve`` with the same
    ``early_tol`` (``iters=5`` is one chunk of 25 iterations in both): the
    state and primal within 1e-10.  With ``polish=True`` the state stays
    the raw early-exit iterate (bit for bit) and the primal is the one
    ``apply_polish`` gives from it: the polish runs after the loop."""
    from rtmpc_tpu_torch.ops.qp import apply_polish
    ja, pa = specs64
    th = np.random.default_rng(4).uniform(-2, 2, (3, 4))
    got = admm_solve(pa.admm, torch.tensor(th), None, iters=5, **option)
    raw = admm_solve(pa.admm, torch.tensor(th), None, iters=5,
                     early_tol=1e-4)
    want = jax.jit(jax.vmap(lambda t: jax_admm_solve(
        ja.admm, t, None, iters=5, early_tol=1e-4)))(jnp.asarray(th))
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(raw.state, f).numpy(),
                                   np.asarray(getattr(want.state, f)),
                                   rtol=0, atol=TOL64, err_msg=f)
    for a, b in zip(got.state, raw.state):
        assert torch.equal(a, b)
    if option.get("polish"):
        assert torch.equal(got.z_primal,
                           apply_polish(pa.admm, torch.tensor(th),
                                        raw).z_primal)
    else:
        np.testing.assert_allclose(got.z_primal.numpy(),
                                   np.asarray(want.z_primal), rtol=0,
                                   atol=TOL64)


@pytest.fixture(scope="module")
def cartpole_specs32():
    """The cartpole tube QP (n_p + m_p = 112 + 792) in float32: the JAX
    package's spec and the port's copy of it."""
    from rtmpc_tpu.apps.scenarios import cartpole_scenario
    from rtmpc_tpu.ops.qp import prepare_admm as jax_prepare_admm
    from rtmpc_tpu_torch.models import spec_from_numpy
    sc = cartpole_scenario()
    st = setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U, sc.W,
                             fixed_initial_state=True, rpi_method=1)
    jspec = jax_prepare_admm(st.template, dtype=jnp.float32, alpha=1.8)
    return jspec, spec_from_numpy(jax.tree_util.tree_map(np.asarray, jspec),
                                  torch.float32)


def _both_plains_match_pallas(jspec, pspec, theta, iters, z_atol, y_atol):
    want = admm_solve_pallas(jspec, jnp.asarray(theta), iters=iters,
                             block_b=8, interpret=True)
    for plain in (_admm_solve_cuda_plain, _admm_solve_factored_plain):
        got = plain(pspec, torch.tensor(theta), None, iters)
        np.testing.assert_allclose(got.z_primal.numpy(),
                                   np.asarray(want.z_primal), rtol=0,
                                   atol=z_atol, err_msg=plain.__name__)
        np.testing.assert_allclose(got.state.y.numpy(),
                                   np.asarray(want.state.y), rtol=0,
                                   atol=y_atol, err_msg=plain.__name__)


@pytest.mark.parametrize("B", [9, 1])
def test_kernel_plain_version_matches_pallas_cartpole_shape(cartpole_specs32,
                                                            B):
    """The large-composite regime: the cartpole tube QP (n_p + m_p = 112 +
    792: the kernel's L2 path by width, its "fac" path up to FAC_MAX_B
    rows), float32, 20 iterations, B=9 and B=1, against the Pallas kernel
    in interpret mode: both plain versions (the composite form and the
    factored form) at z 1e-4 (measured 2.4e-5: float32 sums of 904 terms
    in two orders), y 2e-3."""
    from rtmpc_tpu_torch.ops.qp_cuda import kernel_path
    jspec, pspec = cartpole_specs32
    n_cols = pspec.Kinv.shape[0] + pspec.As.shape[0]
    assert n_cols == 904 and kernel_path(n_cols) == "l2"
    assert kernel_path(n_cols, B, pspec.Kinv.shape[0]) == "fac"
    rng = np.random.default_rng(4)
    theta = np.zeros((B, 8), np.float32)
    theta[:, :4] = rng.uniform(-0.2, 0.2, (B, 4))
    theta[:, 4] = rng.uniform(-1.0, 6.0, B)
    _both_plains_match_pallas(jspec, pspec, theta, 20, 1e-4, 2e-3)


@pytest.mark.parametrize("B", [9, 1])
def test_kernel_plain_versions_match_pallas_flagship(specs32, B):
    """The same on the flagship's QP (40 + 112 columns, the "fac" path up to
    FAC_MAX_B rows and the smem path above): both plain versions against
    the Pallas kernel in interpret mode, cold, 40 iterations, float32, z
    1e-4, y 2e-3."""
    jspec, pspec = specs32
    theta = np.random.default_rng(7).uniform(-2, 2, (B, 4)).astype(np.float32)
    _both_plains_match_pallas(jspec, pspec, theta, 40, 1e-4, 2e-3)


@pytest.mark.parametrize("n_p,m_p", [(112, 1648), (41, 152)])
def test_factored_and_composite_plain_versions_agree(n_p, m_p):
    """The "fac" path's plain version (factored form, ``q Kinv'`` hoisted)
    and the composite paths' are the same function: on a random QP at the
    extended controller's 112 + 1648 columns and at 41 + 152, float64,
    B=3, cold then warm, they agree to float64 rounding."""
    from rtmpc_tpu_torch.ops.qp_cuda import _synthetic_spec
    spec = _synthetic_spec(n_p, m_p, 4, seed=11, dtype=torch.float64)
    rng = np.random.default_rng(12)
    state = None
    for phase in range(2):
        theta = torch.tensor(rng.uniform(-2, 2, (3, 4)))
        a = _admm_solve_factored_plain(spec, theta, state, 60)
        b = _admm_solve_cuda_plain(spec, theta, state, 60)
        assert (a.z_primal - b.z_primal).abs().max().item() < 1e-11
        assert (a.state.x - b.state.x).abs().max().item() < 1e-11
        assert (a.state.z - b.state.z).abs().max().item() < 1e-11
        assert (a.state.y - b.state.y).abs().max().item() < 1e-9
        assert (a.r_prim - b.r_prim).abs().max().item() < 1e-11
        assert (a.r_dual - b.r_dual).abs().max().item() < 1e-9
        state = a.state


def test_kernel_path_mirrors_the_dispatch_at_its_edges():
    """``kernel_path(n_cols, B, n_p)`` follows the C dispatch
    (``admm_kernel.cu:admm_path``): "fac" up to ``FAC_MAX_B`` rows at any
    width and above 1024 columns at any batch, where its operator fits
    shared memory, the composite path of the width elsewhere; without B,
    the composite path of the width; above 2048 columns, refused."""
    from rtmpc_tpu_torch.ops.qp_cuda import FAC_WIDE_COLS, kernel_path
    assert FAC_WIDE_COLS == 1024
    for n_p, n_cols, composite in ((40, 152, "smem"), (48, 192, "smem"),
                                   (112, 904, "l2"), (100, 1024, "l2")):
        assert kernel_path(n_cols) == composite
        assert kernel_path(n_cols, 1, n_p) == "fac"
        assert kernel_path(n_cols, FAC_MAX_B, n_p) == "fac"
        assert kernel_path(n_cols, FAC_MAX_B + 1, n_p) == composite
        assert kernel_path(n_cols, 16384, n_p) == composite
    for n_p, n_cols in ((100, 1025), (112, 1760), (100, 2048)):
        assert kernel_path(n_cols) == "l2"
        for B in (1, FAC_MAX_B, FAC_MAX_B + 1, 200, 16384):
            assert kernel_path(n_cols, B, n_p) == "fac"
    # operators that do not fit stay on the composite paths at any batch:
    # the widest random QP, Kinv alone above about 238 variables, and a
    # cluster whose last block would own fewer than no rows of As
    for n_p, n_cols, composite in ((256, 2048, "l2"), (240, 260, "l2"),
                                   (128, 2048, "l2"), (100, 120, "smem")):
        for B in (1, FAC_MAX_B, 200):
            assert kernel_path(n_cols, B, n_p) == composite
    with pytest.raises(ValueError, match="n_p"):
        kernel_path(152, 1)
    for B in (None, 1, 200):
        with pytest.raises(ValueError, match="2048"):
            kernel_path(2049, B, 100)


@pytest.mark.parametrize("n_p,m_p,fits", [
    (40, 112, True), (16, 96, True), (112, 792, True), (32, 760, True),
    (112, 1648, True), (100, 49, True), (100, 20, False), (100, 41, False),
    (256, 1792, False), (128, 1920, False), (230, 100, False)])
def test_fac_layout_fits_the_controllers_qps(n_p, m_p, fits):
    """``_fac_fits`` (the mirror of ``admm_factored.cu:factored_fits``):
    every controller's QP fits a block's shared memory at each rows a
    group "fac" may run (1 on one block; 1, 4 and 16 on a cluster), the
    widest random QPs do not, and a cluster whose last block would own
    fewer than no rows of As (100 + 20: 8 blocks of ceil(20 / 8) = 3 rows
    need 21) is refused; one that owns none (100 + 49) is not.  The bytes
    are those ``fac_layout`` computes (the extended QP's 112 + 1648 at 16
    rows 3 KB under the limit)."""
    from rtmpc_tpu_torch.ops.qp_cuda import (_FAC_SMEM_LIMIT, _fac_blocks,
                                             _fac_fits, _fac_smem_bytes)
    assert _fac_fits(n_p, m_p) == fits
    cl = _fac_blocks(n_p, m_p)
    slices = m_p >= (cl - 1) * -(-m_p // cl)
    assert slices == ((n_p, m_p) not in ((100, 20), (100, 41)))
    if slices:
        rcs = (1,) if cl == 1 else (1, 4, 16)
        sizes = [_fac_smem_bytes(n_p, m_p, rc) for rc in rcs]
        assert (max(sizes) <= _FAC_SMEM_LIMIT) == fits
        want = {(40, 112): [30080], (112, 1648): [159952, 168096, 228160]}
        assert sizes == want.get((n_p, m_p), sizes)


def test_kernel_path_limits():
    from rtmpc_tpu_torch.ops.qp_cuda import kernel_path
    assert kernel_path(152) == "smem" and kernel_path(192) == "smem"
    assert kernel_path(193) == "l2" and kernel_path(2048) == "l2"
    with pytest.raises(ValueError, match="2048"):
        kernel_path(2049)


@pytest.mark.parametrize("n_p,m_p", [(48, 144), (41, 152), (64, 320)])
def test_plain_version_on_random_qps_matches_admm_solve(n_p, m_p):
    """``_synthetic_spec`` (the random QPs that hold the kernel to its plain
    version at widths no controller has, odd ones included) is a consistent
    prepared problem: on it the composite-form plain version and the
    three-matmul ``admm_solve`` are the same iteration, to float64
    rounding, and the iterates stay bounded and approach feasibility."""
    from rtmpc_tpu_torch.ops.qp_cuda import _synthetic_spec
    spec = _synthetic_spec(n_p, m_p, 4, seed=3, dtype=torch.float64)
    assert spec.Gxc.shape == (n_p, n_p + m_p)
    assert spec.Gsc.shape == (m_p, n_p + m_p)
    theta = torch.tensor(np.random.default_rng(4).uniform(-2, 2, (6, 4)))
    a = _admm_solve_cuda_plain(spec, theta, None, 80)
    b = admm_solve(spec, theta, None, iters=80)
    assert (a.z_primal - b.z_primal).abs().max().item() < 1e-11
    assert (a.state.y - b.state.y).abs().max().item() < 1e-9
    assert (a.r_prim - b.r_prim).abs().max().item() < 1e-11
    short = _admm_solve_cuda_plain(spec, theta, None, 10)
    assert a.r_prim.max().item() < short.r_prim.max().item() < 10.0


def test_compare_with_plain_holds_its_bars():
    """The comparison that holds the kernel to its plain version on the
    card (``kernel_bench.compare_with_plain``), run where the wrapper takes
    the plain version: float32 against itself is exact, against float64 it
    is within ``F64_RATIO`` of itself, and an absolute float64 bar that the
    float32 rounding exceeds raises on a composite path (B above
    ``FAC_MAX_B``); on the "fac" path (B=9) a launch passes within either
    the absolute bar or ``F64_RATIO`` times plain float32's own error."""
    from rtmpc_tpu_torch.ops.kernel_bench import compare_with_plain
    from rtmpc_tpu_torch.ops.qp_cuda import _synthetic_spec, kernel_path
    spec = _synthetic_spec(12, 40, 4, seed=5)
    spec64 = _synthetic_spec(12, 40, 4, seed=5, dtype=torch.float64)
    rng = np.random.default_rng(6)
    for B in (9, FAC_MAX_B + 1):
        th = torch.tensor(rng.uniform(-2, 2, (B, 4)), dtype=torch.float32)
        for warm_from_kernel in (False, True):
            errs = compare_with_plain(spec, spec, th, th, (30, 20),
                                      (0.0, 0.0),
                                      warm_from_kernel=warm_from_kernel,
                                      specs64=(spec64, spec64))
            assert (errs["cold_z"] == errs["warm_y"] == errs["warm_rdual"]
                    == 0.0)
            assert 0.0 < errs["f64_cold_y"] == errs["plain_f64_cold_y"] < 1e-2
        compare_with_plain(spec, spec, th, th, (30, 20),
                           specs64=(spec64, spec64), f64_bars=(1e-3, 1e-2))
        if kernel_path(52, B, 12) == "fac":
            compare_with_plain(spec, spec, th, th, (30, 20),
                               specs64=(spec64, spec64), f64_bars=(0.0, 0.0))
        else:
            with pytest.raises(RuntimeError, match="f64_cold_z"):
                compare_with_plain(spec, spec, th, th, (30, 20),
                                   specs64=(spec64, spec64),
                                   f64_bars=(0.0, 1e-2))


@pytest.mark.parametrize("n_p,m_p,B,iters,want_ms,ratio", [
    (40, 112, 16384, 60, 0.31504, 2.1879),
    (40, 112, 1, 60, 1.92287e-5, 2.1879),
    (112, 792, 200, 200, 0.22794, 4.3022),
    (112, 840, 200, 200, 0.24084, 4.5156),
    (112, 1648, 200, 200, 0.45804, 8.1154)])
def test_kernel_bound_counts_the_factored_form(n_p, m_p, B, iters, want_ms,
                                               ratio):
    """``roofline_ms`` counts the least operations an ADMM phase needs,
    ``2 B (n^2 + 2 n m)`` an iteration and the residuals, at the FP32 peak;
    the composite product the kernel runs is ``ratio`` times as many."""
    from rtmpc_tpu_torch.ops.kernel_bench import (PEAK_FP32_FLOPS,
                                                  composite_over_factored,
                                                  roofline_ms)
    ms, by = roofline_ms(B, n_p, m_p, 8, iters)
    flops = 2.0 * B * (n_p * n_p + 2 * n_p * m_p) * (iters + 1)
    assert by == "operations"
    assert ms == pytest.approx(flops / PEAK_FP32_FLOPS * 1e3, rel=1e-12)
    assert ms == pytest.approx(want_ms, rel=1e-4)
    assert composite_over_factored(n_p, m_p) == pytest.approx(ratio, rel=1e-4)


def test_kernel_bound_bytes_count_the_factored_form():
    """Where bytes bound a phase (one iteration at B=1 on the flagship's
    40 + 112 columns), ``roofline_ms`` counts the factored form's inputs
    and outputs, not the composites the kernel reads: Kinv, As, Ps, the
    maps of q, l, u in theta, rho, 1/rho, sigma, and theta, the state in
    and out and the residuals of the one row."""
    from rtmpc_tpu_torch.ops.kernel_bench import (PEAK_BYTES_PER_S,
                                                  roofline_ms)
    n_p, m_p, nt = 40, 112, 4
    floats = (n_p * n_p + m_p * n_p + n_p * n_p
              + (n_p + 2 * m_p) * (nt + 1) + 2 * m_p + 1
              + nt + 2 * (n_p + 2 * m_p) + 2)
    assert floats == 9759
    ms, by = roofline_ms(1, n_p, m_p, nt, 1)
    assert by == "bytes"
    assert ms == pytest.approx(4.0 * floats / PEAK_BYTES_PER_S * 1e3,
                               rel=1e-12)
