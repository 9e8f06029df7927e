"""The port's structured interior point with warm starts and its
float32 -> float64 hybrid (``solver="ip_hybrid"``) against the JAX
package's, on the double integrator (the cartpole cases are in
``test_torch_ip_riccati.py``).

* Warm starts: ``ip_riccati_solve(state0=..., warm=w)`` against the JAX
  function under ``vmap`` on the same state, carried across by
  ``ip_state_from_jax``, 30 iterations, float64, on the tracking QP of
  ``tests/test_ip_riccati.py`` at its 6 thetas.  ``"resume"``: the state of
  6 JAX iterations on the same thetas; ``"shifted"``: the converged state
  of the previous thetas, each moved by a step of the closed loop.  The
  primal and the returned state within 1e-9: both are the same float64
  algorithm (measured: 2e-10 and below).
* The hybrid, single solves, at ``iters32=25, iters64=15``, on the 6
  random thetas of ``tests/test_ip_riccati.py:96-112``: the primal within
  1e-5 of the JAX float64 ``ip_riccati_solve`` (the JAX test's own bar)
  and of the JAX hybrid (measured: 8.5e-12 and below to both); the one
  infeasible theta of the six, where every solver stalls at a point set
  by rounding, within 5e-5 of both and flagged by its primal residual
  (see the test).
* The hybrid in the closed loop: ``make_batched_rollout`` under
  ``solver="ip_hybrid"`` (float64 engine, ``ip_iters=25``,
  ``ip_hybrid_iters=12``) against the JAX package's batched rollout on
  the same draws of the JAX package's ``protocol/network.py``: the
  flagship, B=4, T=20, and the extended double integrator, B=2, T=10
  (the port's one-solve path; the JAX engine solves both QPs): states
  within 1e-5, ``feasible`` equal.
* Refusals: the hybrid on a float32 spec, and ``"ip_hybrid"`` with
  ``condensed=True``, raise ``ValueError``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models.specs import (setup_extended_tube_tracking as
                                    jax_setup_extended)
from rtmpc_tpu.models.specs import setup_tracking as jax_setup_tracking
from rtmpc_tpu.models.specs import (setup_tube_tracking as
                                    jax_setup_tube_tracking)
from rtmpc_tpu.ops.ip_riccati import ip_riccati_solve as jax_solve
from rtmpc_tpu.ops.ip_riccati import (ip_riccati_solve_hybrid as
                                      jax_solve_hybrid)
from rtmpc_tpu.ops.ip_riccati import prepare_ip_riccati as jax_prepare
from rtmpc_tpu.parallel import make_batched_rollout as jax_batched_rollout
from rtmpc_tpu.protocol import draw_disturbances, draw_loss_masks
from rtmpc_tpu.utils.polytope import box as jax_box

from rtmpc_tpu_torch.models import (flagship_setup, ric_spec_from_numpy,
                                    setup_extended_tube_tracking)
from rtmpc_tpu_torch.ops.ip_riccati import (ip_riccati_solve,
                                            ip_riccati_solve_hybrid,
                                            ip_state_from_jax,
                                            prepare_ip_riccati)
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.parallel.rollout import _one_solve_eligible
from rtmpc_tpu_torch.utils import box


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.0], [1.0]])
DI_THETAS = np.array([[1.0, 0.0, 5.0, 0.0], [-3.0, 2.0, -9.0, 0.0],
                      [0.0, 0.0, 9.0, 0.0], [0.5, -0.5, 3.0, 0.0],
                      [4.0, -1.0, 12.0, 0.0], [-2.5, 0.5, -1.0, 0.0]])
N = 10


@pytest.fixture(scope="module")
def di_tracking():
    st = jax_setup_tracking(DI_A, DI_B, np.eye(2), np.array([[0.1]]), N,
                            jax_box(np.array([8.0, 8.0])),
                            jax_box(np.array([1.0])))
    jspec = jax_prepare(st.template, dtype=jnp.float64)
    return st.template, jspec, ric_spec_from_numpy(
        jax.tree_util.tree_map(np.asarray, jspec))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_states(di_tracking):
    """``jax.vmap`` of the JAX solve's final state, the iteration cap
    traced (one compile serves every cap)."""
    jspec = di_tracking[1]
    return jax.jit(jax.vmap(lambda t, k: jax_solve(
        jspec, t, N, iters=k, want_state=True)[1], in_axes=(0, None)))


@pytest.mark.parametrize("warm", ["resume", "shifted"])
def test_warm_starts_match_jax(di_tracking, jax_states, warm):
    _, jspec, spec = di_tracking
    if warm == "resume":
        prev, th = DI_THETAS, DI_THETAS
        k0 = 6
    else:
        # the previous step's QPs: states one step back, the same refs
        prev = DI_THETAS.copy()
        prev[:, :2] += np.array([-0.4, 0.3])
        th, k0 = DI_THETAS, 30
    st0 = jax_states(jnp.asarray(prev), k0)
    jsol, jst = jax.jit(jax.vmap(lambda t, s: jax_solve(
        jspec, t, N, iters=30, state0=s, warm=warm, want_state=True)))(
        jnp.asarray(th), st0)
    sol, st = ip_riccati_solve(spec, torch.tensor(th), N, iters=30,
                               state0=ip_state_from_jax(_np(st0), N),
                               warm=warm, want_state=True)
    np.testing.assert_allclose(sol.z_primal.numpy(),
                               np.asarray(jsol.z_primal), rtol=0, atol=1e-9)
    for name, a, b in zip(("x", "u", "w", "y", "mu_ss", "lam", "s"), st,
                          ip_state_from_jax(_np(jst), N)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9,
                                   err_msg=name)


def test_state_bridge_layout(jax_states):
    """One instance and a stack give the same rows; the flat groups are in
    ``init_ip_state``'s order (state rows, input rows, tube, terminal)."""
    stacked_np = _np(jax_states(jnp.asarray(DI_THETAS[:2]), 5))
    st = jax.tree_util.tree_map(lambda a: a[1], stacked_np)
    one = ip_state_from_jax(st, N)
    stacked = ip_state_from_jax(stacked_np, N)
    for a, b in zip(one, stacked):
        assert a.shape[0] == 1 and torch.equal(a[0], b[1])
    lam = one[5][0].numpy()
    assert np.array_equal(lam, np.concatenate([g.ravel() for g in st[5]]))
    with pytest.raises(ValueError, match="stages"):
        ip_state_from_jax(st, N + 1)


def test_hybrid_single_solves_match_jax(di_tracking):
    _, jspec, spec = di_tracking
    rng = np.random.default_rng(1)
    th = np.array([np.concatenate([rng.uniform(-4, 4, size=2),
                                   [rng.uniform(-8, 8), 0.0]])
                   for _ in range(6)])
    want64 = jax.jit(jax.vmap(lambda t: jax_solve(
        jspec, t, N, iters=30)))(jnp.asarray(th))
    want_h = jax.jit(jax.vmap(lambda t: jax_solve_hybrid(
        jspec, t, N, iters32=25, iters64=15)))(jnp.asarray(th))
    before = (ip_riccati_solve_hybrid.iterations32,
              ip_riccati_solve_hybrid.iterations64)
    got = ip_riccati_solve_hybrid(spec, torch.tensor(th), N, iters32=25,
                                  iters64=15)
    zh = got.z_primal.numpy()
    assert got.z_primal.dtype == torch.float64
    assert ip_riccati_solve_hybrid.iterations32 > before[0]
    assert ip_riccati_solve_hybrid.iterations64 > before[1]
    z64, zh_j = np.asarray(want64.z_primal), np.asarray(want_h.z_primal)
    # theta 0 (x0 = (0.095, 3.60): too fast to stop inside |x1| <= 8 with
    # |u| <= 1) is an infeasible QP: every solver stalls there (the dense
    # oracle runs out of iterations; float64 at r_prim 4.3e-3), and where
    # the hybrid stalls follows the rounding of its float32 phase: the JAX
    # package's own hybrid lands 2.3e-6 (jit, one instance), 5.7e-6 (jit
    # of vmap) and 1.44e-5 (vmap, not jitted) from its float64 stall point
    # there.  The port's reads 1.76e-5 from the float64 one and 1.18e-5
    # from the jitted JAX hybrid: on that theta the primal is held to 5e-5
    # and every solve must flag the QP (r_prim above 1e-3).  The five
    # feasible thetas: 1e-5 to both (measured: 8.5e-12 and below).
    np.testing.assert_allclose(zh[1:], z64[1:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(zh[1:], zh_j[1:], rtol=0, atol=1e-5)
    assert np.abs(zh[0] - z64[0]).max() < 5e-5
    assert np.abs(zh[0] - zh_j[0]).max() < 5e-5
    for r in (got.r_prim.numpy(), want64.r_prim, want_h.r_prim):
        assert float(r[0]) > 1e-3 and float(np.max(r[1:])) < 1e-9


def _jax_draws(B, T, seed, p=0.5):
    """Loss masks and disturbances from the JAX package's
    ``protocol/network.py``, as numpy arrays."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    theta, gamma = draw_loss_masks(k1, T, p, p, batch_shape=(B,))
    w = draw_disturbances(k2, T, -0.1 * np.ones(2), 0.1 * np.ones(2),
                          batch_shape=(B,))
    return (np.asarray(theta).astype(np.int32),
            np.asarray(gamma).astype(np.int32), np.asarray(w, np.float64))


HYBRID = dict(solver="ip_hybrid", ip_iters=25, ip_hybrid_iters=12)


@pytest.mark.parametrize("arm", ["flagship", "extended"])
def test_hybrid_closed_loop_matches_jax(arm):
    if arm == "flagship":
        B, T = 4, 20
        jst = jax_setup_tube_tracking(
            DI_A, DI_B, np.eye(2), np.eye(1), N,
            jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
            jax_box(np.array([0.1, 0.1])), fixed_initial_state=True)
        pst = flagship_setup()
    else:
        B, T = 2, 10
        jst, pst = (fn(DI_A, DI_B, np.eye(2), np.eye(1), N, bx(np.array(
            [8.0, 8.0])), bx(np.array([1.0])), bx(np.array([0.1, 0.1])),
            fixed_initial_state=False)
            for fn, bx in ((jax_setup_extended, jax_box),
                           (setup_extended_tube_tracking, box)))
    theta, gamma = _jax_draws(B, T, 5)[:2]
    w = _jax_draws(B, T, 5)[2]
    x0 = np.random.default_rng(5).uniform(-1.0, 1.0, size=(B, 2))
    refs = np.zeros((B, T, 2))
    refs[:, :T // 2, 0] = 4.0
    refs[:, T // 2:, 0] = -3.0
    inputs = (x0, refs, w, theta, gamma)

    ja, jcfg = jst.to_device(dtype=jnp.float64, **HYBRID)
    _, want = jax.jit(jax_batched_rollout(ja, jcfg, T))(
        *map(jnp.asarray, inputs))
    arrays, cfg = pst.to_device(torch.float64, "cpu", **HYBRID)
    assert arrays.ric.A.dtype == torch.float64 and cfg.ip_hybrid_iters == 12
    assert _one_solve_eligible(arrays, cfg) == (arm == "extended")
    _, got = make_batched_rollout(arrays, cfg, T)(
        *(torch.tensor(np.array(a)) for a in inputs))
    for f in ("x", "x_nom", "x_hat"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(want.feasible))
    assert bool(got.feasible.all())


def test_hybrid_float32_engine_keeps_float64_spec():
    """The apps' default under the hybrid: a float32 engine, the interior
    point's spec in float64; the primal comes back in the engine's dtype."""
    arrays, cfg = flagship_setup().to_device(torch.float32, "cpu", **HYBRID)
    assert arrays.A.dtype == torch.float32
    assert arrays.ric.A.dtype == torch.float64
    B, T = 2, 4
    refs = torch.zeros(B, T, 2)
    refs[:, :, 0] = 4.0
    ones = torch.ones(B, T, dtype=torch.int32)
    _, out = make_batched_rollout(arrays, cfg, T)(
        torch.zeros(B, 2), refs, torch.zeros(B, T, 2), ones, ones)
    assert out.x.dtype == out.r_prim.dtype == torch.float32
    assert bool(out.feasible.all()) and bool(torch.isfinite(out.x).all())


def test_hybrid_refusals(di_tracking):
    tmpl, _, _ = di_tracking
    with pytest.raises(ValueError, match="float64 spec"):
        ip_riccati_solve_hybrid(prepare_ip_riccati(tmpl, torch.float32),
                                torch.tensor(DI_THETAS[:1]), N)
    with pytest.raises(ValueError, match="uncondensed"):
        flagship_setup().to_device(torch.float64, "cpu", solver="ip_hybrid",
                                   condensed=True)
