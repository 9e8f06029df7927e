"""The port's structured interior point against the JAX package's.

* The unrolled pivoted LU at n = 1, 2, 5 and 9 against numpy: 1e-10.
* ``prepare_ip_riccati`` of the port on the JAX package's templates:
  bit-equal to the JAX package's spec; its new checks (N = 1 and 2, a
  linear cost on the inputs) raise ``ValueError`` or solve right.
* Batched ``ip_riccati_solve`` against ``jax.vmap(ip_riccati_solve)`` in
  float64, 30 iterations:
  - the double-integrator tracking QP of ``tests/test_ip_riccati.py`` with
    its thetas and three more (saturating references among them): z,
    r_prim and r_dual within 1e-9, and z within 1e-6 of
    ``QPTemplate.solve_dense`` (stopped at ``DENSE_TOL``);
  - the free-initial-state tube regulator of ``tests/test_ip_riccati.py``
    (iterative refinement on in float64): z within 1e-9;
  - both cartpole QPs, 6 thetas from a closed loop (one with a saturating
    reference, one perturbed state): after 10 iterations, before the barrier
    endgame, z within 1e-7 (measured 2.0e-8); after the full solve the
    primal residuals within 1e-9, the dual residuals within 1e-6 (measured
    4.6e-7) and the objectives within 1e-8 relative.
    The converged z is not compared: the cartpole's scaled cost has cond
    ~1e20 (``tests/test_cartpole_parity.py``) and its optimal face is flat,
    so rounding differences of 1e-16 early in the solve move the endgame
    iterate along it (measured: up to 1e-3 in z at equal objectives, 1e-12
    relative, and primal residuals of 1e-18);
  - one float32 case (refinement on) on the double integrator: z within
    1e-4 of the JAX package's float32 solve.
* The warm starts on one cartpole QP (the tube arm's step-3 theta of the
  closed loop below), float64, 30 iterations, against the JAX function on
  the same state (``ip_state_from_jax``): ``"resume"`` from 8 JAX
  iterations on that theta, ``"shifted"`` from the converged state of the
  step-0 theta; the primal and the returned state within 1e-9 (measured
  3.4e-15 and 5.8e-12: from a shared state the two runs stay together
  through the endgame).
* The float32 -> float64 hybrid (``iters32=25, iters64=12``, the apps'
  budget) on the tube arm's 6 closed-loop thetas against the JAX float64
  solve (30 iterations) and the JAX hybrid: on the first three (steps 0,
  3 and 8), which every solve converges, z within 1e-5 of both (measured
  1.5e-7).  The last three (step 15, the saturating reference, the
  perturbed state) are hard: there neither package's hybrid converges in
  25 + 12 iterations (dual residuals 1.3e-3 to 2.7e-2 in both) and where
  each stops follows the rounding of its float32 phase (the port's and
  the JAX package's primals read up to 1.24 apart on the saturating one;
  float64 converges there in 30 iterations): held to a primal residual of
  1e-3 and a dual residual above 1e-4 in both packages, which records the
  shortfall rather than hiding it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.scenarios import cartpole_scenario
from rtmpc_tpu.models.specs import setup_tracking as jax_setup_tracking
from rtmpc_tpu.models.specs import setup_tube_regulator
from rtmpc_tpu.models.specs import (setup_tube_tracking as
                                    jax_setup_tube_tracking)
from rtmpc_tpu.ops.assembly import QPTemplate as JaxQPTemplate
from rtmpc_tpu.ops.ip_riccati import ip_riccati_solve as jax_solve
from rtmpc_tpu.ops.ip_riccati import (ip_riccati_solve_hybrid as
                                      jax_solve_hybrid)
from rtmpc_tpu.ops.ip_riccati import prepare_ip_riccati as jax_prepare
from rtmpc_tpu.utils.polytope import box as jax_box

from rtmpc_tpu_torch.models import ric_spec_from_numpy, setup_tracking
from rtmpc_tpu_torch.utils import box
from rtmpc_tpu_torch.ops.ip_riccati import (_plu_factor, _plu_solve,
                                            init_ip_state, ip_riccati_solve,
                                            ip_riccati_solve_hybrid,
                                            ip_state_from_jax,
                                            prepare_ip_riccati)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.0], [1.0]])


def _bridge(jspec, dtype=torch.float64):
    return ric_spec_from_numpy(jax.tree_util.tree_map(np.asarray, jspec),
                               dtype)


def _jax_batched(jspec, N):
    """``jax.vmap(ip_riccati_solve)`` with the iteration cap traced, so
    one compile serves every cap."""
    return jax.jit(jax.vmap(
        lambda th, k: jax_solve(jspec, th, N, iters=k), in_axes=(0, None)))


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_small_pivoted_lu(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((4, n, n))
    b = rng.standard_normal((4, n))
    Bm = rng.standard_normal((4, n, 3))
    fac = _plu_factor(torch.tensor(A))
    x = _plu_solve(fac, torch.tensor(b)).numpy()
    X = _plu_solve(fac, torch.tensor(Bm)).numpy()
    assert np.abs(x - np.linalg.solve(A, b[..., None])[..., 0]).max() < 1e-10
    assert np.abs(X - np.linalg.solve(A, Bm)).max() < 1e-10


@pytest.fixture(scope="module")
def di_tracking():
    st = jax_setup_tracking(DI_A, DI_B, np.eye(2), np.array([[0.1]]), 10,
                            jax_box(np.array([8.0, 8.0])),
                            jax_box(np.array([1.0])))
    return st.template, jax_prepare(st.template, dtype=jnp.float64)


# The dense oracle's stopping tolerance.  At its default of 1e-9 it stops
# at gaps up to ~1e-9, which leaves up to 7.1e-6 of z error on the
# saturating references (measured on the terminal set that scipy's LP
# gives when the native LP library is absent); at 1e-12 its z is within
# 3.6e-9 of the interior point's on every theta here, with or without it.
DENSE_TOL = 1e-12

DI_THETAS = np.array([[1.0, 0.0, 5.0, 0.0], [-3.0, 2.0, -9.0, 0.0],
                      [0.0, 0.0, 9.0, 0.0], [0.5, -0.5, 3.0, 0.0],
                      [4.0, -1.0, 12.0, 0.0], [-2.5, 0.5, -1.0, 0.0]])


def test_prepare_bit_equal_on_jax_templates(di_tracking):
    tmpl, jspec = di_tracking
    got = prepare_ip_riccati(tmpl)
    want = _bridge(jspec)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_di_tracking_matches_jax_and_dense(di_tracking):
    tmpl, jspec = di_tracking
    want = _jax_batched(jspec, tmpl.N)(jnp.asarray(DI_THETAS), 30)
    got = ip_riccati_solve(_bridge(jspec), torch.tensor(DI_THETAS), tmpl.N,
                           iters=30)
    for f in ("z_primal", "r_prim", "r_dual", "gap"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    for i, th in enumerate(DI_THETAS):
        sol, _ = tmpl.solve_dense(th[:2], th[2:], tol=DENSE_TOL)
        assert sol.status == "optimal"
        assert np.abs(got.z_primal[i].numpy() - sol.z).max() < 1e-6, i


def test_free_initial_state_matches_jax():
    """Tube-init (free x_0): iterative refinement runs in float64 too."""
    st = setup_tube_regulator(
        DI_A, np.array([[0.5], [1.0]]), np.eye(2), np.array([[0.01]]), 9,
        jax_box(np.array([100.0, 2.0])), jax_box(np.array([1.0])),
        jax_box(np.array([0.1, 0.1])))
    jspec = jax_prepare(st.template, dtype=jnp.float64)
    th = np.array([[-6.0, 0.0, 0.0, 0.0], [-4.0, 1.0, 0.0, 0.0],
                   [3.0, -0.5, 0.0, 0.0]])
    want = _jax_batched(jspec, 9)(jnp.asarray(th), 30)
    got = ip_riccati_solve(_bridge(jspec), torch.tensor(th), 9, iters=30)
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), rtol=0, atol=1e-9)
    assert float(got.r_prim.max()) < 1e-8


def test_float32_with_refinement(di_tracking):
    tmpl, _ = di_tracking
    jspec32 = jax_prepare(tmpl, dtype=jnp.float32)
    th = DI_THETAS[:4].astype(np.float32)
    want = _jax_batched(jspec32, tmpl.N)(jnp.asarray(th), 25)
    got = ip_riccati_solve(prepare_ip_riccati(tmpl, torch.float32),
                           torch.tensor(th), tmpl.N, iters=25)
    assert got.z_primal.dtype == torch.float32
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), rtol=0, atol=1e-4)


def _closed_loop_thetas(sc, spec):
    """6 thetas of a short direct closed loop under the port's IP: steps
    0, 3, 8 and 15, step 10 with a saturating reference (6 m, outside the
    5 m state box), and step 12 with a perturbed state."""
    rng = np.random.default_rng(3)
    x, ths = np.zeros(4), []
    for _ in range(16):
        th = np.concatenate([x, [sc.ref_value, 0.0, 0.0, 0.0]])
        ths.append(th)
        z = ip_riccati_solve(spec, torch.tensor(th[None]), sc.N,
                             iters=30).z_primal[0].numpy()
        u0 = z[4 * (sc.N + 1):4 * (sc.N + 1) + 1]
        x = sc.A @ x + sc.B @ u0 + rng.uniform(sc.w_lo, sc.w_hi)
    ths = np.array(ths)
    sat = ths[10].copy()
    sat[4] = 6.0
    pert = ths[12].copy()
    pert[:4] += np.array([0.05, -0.1, 0.01, 0.05])
    return np.vstack([ths[[0, 3, 8, 15]], sat, pert])


@functools.lru_cache(maxsize=None)
def _cartpole(arm):
    """``(sc, template, JAX spec, port spec, closed-loop thetas)`` of a
    cartpole arm, set up once a test process."""
    sc = cartpole_scenario()
    if arm == "tube":
        st = jax_setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X,
                                     sc.U, sc.W, fixed_initial_state=True,
                                     rpi_method=1)
    else:
        st = jax_setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U)
    jspec = jax_prepare(st.template, dtype=jnp.float64)
    spec = _bridge(jspec)
    return sc, st.template, jspec, spec, _closed_loop_thetas(sc, spec)


@pytest.mark.parametrize("arm", ["tube", "track"])
def test_cartpole_matches_jax(arm):
    sc, tmpl, jspec, spec, th = _cartpole(arm)
    jsolve = _jax_batched(jspec, sc.N)

    early_j = jsolve(jnp.asarray(th), 10)
    early = ip_riccati_solve(spec, torch.tensor(th), sc.N, iters=10)
    dz = np.abs(early.z_primal.numpy() - np.asarray(early_j.z_primal)).max()
    assert dz <= 1e-7, dz

    want = jsolve(jnp.asarray(th), 30)
    got = ip_riccati_solve(spec, torch.tensor(th), sc.N, iters=30)
    np.testing.assert_allclose(got.r_prim.numpy(), np.asarray(want.r_prim),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.r_dual.numpy(), np.asarray(want.r_dual),
                               rtol=0, atol=1e-6)

    def objective(z, t):
        q = tmpl.q0 + tmpl.Mq @ t
        return 0.5 * z @ tmpl.P @ z + q @ z

    for i in range(len(th)):
        a = objective(got.z_primal[i].numpy(), th[i])
        b = objective(np.asarray(want.z_primal[i]), th[i])
        assert abs(a - b) <= 1e-8 * abs(b), (i, a, b)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("warm", ["resume", "shifted"])
def test_cartpole_warm_starts_match_jax(warm):
    sc, _, jspec, spec, th = _cartpole("tube")
    N = sc.N
    prev, k0 = (th[1:2], 8) if warm == "resume" else (th[0:1], 30)
    st0 = jax.jit(jax.vmap(lambda t: jax_solve(
        jspec, t, N, iters=k0, want_state=True)[1]))(jnp.asarray(prev))
    jsol, jst = jax.jit(jax.vmap(lambda t, s: jax_solve(
        jspec, t, N, iters=30, state0=s, warm=warm, want_state=True)))(
        jnp.asarray(th[1:2]), st0)
    sol, st = ip_riccati_solve(spec, torch.tensor(th[1:2]), N, iters=30,
                               state0=ip_state_from_jax(_np(st0), N),
                               warm=warm, want_state=True)
    np.testing.assert_allclose(sol.z_primal.numpy(),
                               np.asarray(jsol.z_primal), rtol=0, atol=1e-9)
    for name, a, b in zip(("x", "u", "w", "y", "mu_ss", "lam", "s"), st,
                          ip_state_from_jax(_np(jst), N)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9,
                                   err_msg=name)


def test_cartpole_hybrid_matches_jax():
    sc, _, jspec, spec, th = _cartpole("tube")
    N = sc.N
    want64 = _jax_batched(jspec, N)(jnp.asarray(th), 30)
    want_h = jax.jit(jax.vmap(lambda t: jax_solve_hybrid(
        jspec, t, N, iters32=25, iters64=12)))(jnp.asarray(th))
    got = ip_riccati_solve_hybrid(spec, torch.tensor(th), N, iters32=25,
                                  iters64=12)
    z = got.z_primal.numpy()
    for want in (want64, want_h):
        np.testing.assert_allclose(z[:3], np.asarray(want.z_primal)[:3],
                                   rtol=0, atol=1e-5)
    assert float(got.r_prim.max()) <= 1e-3
    assert float(want_h.r_prim.max()) <= 1e-3
    assert float(got.r_dual[3:].min()) > 1e-4
    assert float(want_h.r_dual[3:].min()) > 1e-4


@pytest.mark.parametrize("N", [1, 2])
def test_short_horizons_solve(N):
    """N = 1 (the JAX package's stage-repeat check reads the terminal
    block there and refuses) and N = 2 against the dense oracle."""
    setup = setup_tracking(DI_A, DI_B, np.eye(2), np.array([[0.1]]), N,
                           box(np.array([8.0, 8.0])), box(np.array([1.0])))
    tmpl = setup.template
    th = np.array([[1.0, 0.0, 3.0, 0.0], [-2.0, 0.5, -1.0, 0.0]])
    got = ip_riccati_solve(prepare_ip_riccati(tmpl), torch.tensor(th), N,
                           iters=30)
    for i in range(2):
        sol, _ = JaxQPTemplate.solve_dense(tmpl, th[i, :2], th[i, 2:],
                                            tol=DENSE_TOL)
        assert sol.status == "optimal"
        assert np.abs(got.z_primal[i].numpy() - sol.z).max() < 1e-6


def test_structure_checks_raise(di_tracking):
    tmpl, _ = di_tracking
    q0 = tmpl.q0.copy()
    q0[tmpl.u_slice(3)] = 1.0          # a linear cost on an input
    with pytest.raises(ValueError, match="linear cost"):
        prepare_ip_riccati(dataclasses.replace(tmpl, q0=q0))
    P = tmpl.P.copy()
    P[tmpl.x_slice(4), tmpl.x_slice(4)] *= 2.0   # a stage block that differs
    with pytest.raises(ValueError, match="stage 4"):
        prepare_ip_riccati(dataclasses.replace(tmpl, P=P))


def test_init_ip_state_shapes(di_tracking):
    spec = _bridge(di_tracking[1])
    x, u, w, y, mu_ss, lam, s = init_ip_state(spec, 10, 3)
    assert x.shape == (3, 11, 2) and u.shape == (3, 10, 1)
    assert w.shape == (3, 3) and y.shape == (3, 10, 2)
    assert mu_ss.shape == (3, 2)
    assert lam.shape == s.shape == (3, 10 * 4 + 10 * 2 + spec.GN.shape[0])
    assert bool((lam == 1).all()) and bool((x == 0).all())
