"""The condensed (state-eliminated) QP of the port against the JAX package
and against the full template's oracle, in float64 on the CPU
(counterpart of ``tests/test_condensed.py``).

* ``condense_template`` gives the JAX package's condensed template bit
  for bit on the four double-integrator setups, and the port's ADMM on it,
  recovered through S, equals the full template's ``solve_dense`` oracle
  (relative 2e-5, the JAX test's bar);
* a condensed closed loop equals the full one under the dense interior
  point (1e-6, the JAX test's bar), on the tube-tracking and the extended
  controller;
* the port's condensed ADMM rollout (solver "admm" and the kernel's plain
  version, "cuda") equals the JAX engine's at 1e-9;
* the port's dense QP oracle (``utils/qp_ref.py``) equals the JAX
  package's on the cases of ``tests/test_synthesis_and_qp_ref.py:48-86``;
* what cannot be condensed raises ``ValueError``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models import specs as jax_specs
from rtmpc_tpu.ops.assembly import condense_template as jax_condense
from rtmpc_tpu.parallel.rollout import make_rollout_fn
from rtmpc_tpu.utils import box as jax_box
from rtmpc_tpu.utils.qp_ref import solve_qp_dense as jax_solve_qp_dense

from rtmpc_tpu_torch.models import specs
from rtmpc_tpu_torch.ops.assembly import condense_template
from rtmpc_tpu_torch.ops.qp import admm_solve, prepare_admm
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.utils import box
from rtmpc_tpu_torch.utils.qp_ref import solve_qp_dense

A = np.array([[1.0, 1.0], [0.0, 1.0]])
B = np.array([[0.0], [1.0]])
KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
T = 50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this CPU build of torch can deadlock in a
    batched LU factorization (the polish) run on several threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setups(mod, bx):
    X, U, W = bx(np.array([8.0, 8.0])), bx(np.array([1.0])), \
        bx(np.array([0.1, 0.1]))
    Q, R = np.eye(2), np.eye(1)
    return {
        "regulator": lambda: mod.setup_regulator(A, B, Q, R, 10, X, U),
        "tracking": lambda: mod.setup_tracking(A, B, Q, R, 10, X, U),
        "tube_regulator": lambda: mod.setup_tube_regulator(A, B, Q, R, 9, X,
                                                           U, W),
        "tube_tracking": lambda: mod.setup_tube_tracking(
            A, B, Q, R, 10, X, U, W, fixed_initial_state=True),
        "extended": lambda: mod.setup_extended_tube_tracking(
            A, B, Q, R, 10, X, U, bx(np.array([0.05, 0.05])),
            fixed_initial_state=False),
    }


@pytest.fixture(scope="module")
def port():
    return {k: f() for k, f in _setups(specs, box).items()}


def _inputs():
    rng = np.random.default_rng(4)
    theta = (rng.uniform(size=T) >= 0.7).astype(np.int32)
    gamma = (rng.uniform(size=T) >= 0.7).astype(np.int32)
    theta[0] = gamma[0] = 1
    w = rng.uniform(-0.1, 0.1, size=(T, 2))
    refs = np.zeros((T, 2))
    refs[:20, 0] = 5.0
    refs[20:, 0] = 4.0
    return np.array([1.0, 2.0]), refs, w, theta, gamma


def _port_rollout(setup, condensed, **kw):
    arrays, cfg = setup.to_device(torch.float64, "cpu", condensed=condensed,
                                  **kw)
    x0, refs, w, theta, gamma = _inputs()
    _, outs = make_batched_rollout(arrays, cfg, T)(
        torch.tensor(x0)[None], torch.tensor(refs)[None],
        torch.tensor(w)[None], torch.tensor(theta)[None],
        torch.tensor(gamma)[None])
    return outs


@pytest.mark.parametrize("name", ["regulator", "tracking", "tube_regulator",
                                  "tube_tracking"])
def test_condensed_solution_matches_full_oracle(port, name):
    t = port[name].template
    tc = condense_template(t)
    assert tc.n < t.n and tc.m == t.m - t.N * t.nx
    jt = _setups(jax_specs, jax_box)[name]().template
    jtc = jax_condense(jt)
    for f in ("P", "q0", "Mq", "A", "l0", "Ml", "u0", "Mu", "is_eq", "S"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jtc, f), f)

    spec = prepare_admm(tc, dtype=torch.float64)
    rng = np.random.default_rng(0)
    ths = np.zeros((3, t.ntheta))
    for th in ths:                      # the JAX test's draws, in its order
        th[:2] = rng.uniform(-2, 2, 2)
        th[2] = rng.uniform(-4, 4)
    v = admm_solve(spec, torch.tensor(ths), iters=1500,
                   polish=True).z_primal.numpy()[:, :tc.n]
    for th, vi in zip(ths, v):
        sol, _ = t.solve_dense(th[:2], th[2:4])
        assert sol.status == "optimal"
        err = np.max(np.abs(tc.S @ vi - sol.z)) / (1 + np.abs(sol.z).max())
        assert err < 2e-5, f"{name}: condensed-vs-full rel err {err:.2e}"


@pytest.mark.parametrize("name", ["tube_tracking", "extended"])
def test_condensed_rollout_ip_solver(port, name):
    """Closed-loop equivalence through the exact (dense IP) solver; equal
    ADMM budgets do not give equal loops (condensing changes the ADMM's
    convergence rate, see the JAX test)."""
    full = _port_rollout(port[name], False, solver="ip", ip_iters=30)
    cond = _port_rollout(port[name], True, solver="ip", ip_iters=30)
    np.testing.assert_allclose(cond.x.numpy(), full.x.numpy(), atol=1e-6)
    assert bool(cond.feasible.all())


@pytest.mark.parametrize("solver", ["admm", "cuda"])
def test_condensed_admm_rollout_matches_jax(port, solver):
    setup = port["tube_tracking"]
    arrays, cfg = setup.to_device(torch.float64, "cpu", condensed=True,
                                  solver=solver, **KW)
    assert (cfg.n_red, arrays.S_rec.shape) == (15, (cfg.n, 15))
    assert arrays.admm.Kinv.shape[0] + arrays.admm.As.shape[0] == 112
    got = _port_rollout(setup, True, solver=solver, **KW)
    jsetup = _setups(jax_specs, jax_box)["tube_tracking"]()
    ja, jc = jsetup.to_device(dtype=jnp.float64, condensed=True, **KW)
    x0, refs, w, theta, gamma = _inputs()
    _, jouts = jax.jit(make_rollout_fn(ja, jc, T))(
        jnp.asarray(x0), jnp.asarray(refs), jnp.asarray(w),
        jnp.asarray(theta), jnp.asarray(gamma))
    for f in ("x", "u", "x_nom", "x_hat"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(jouts, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(got.Theta[0].numpy(),
                                  np.asarray(jouts.Theta))


def test_condensed_refusals(port):
    setup = port["tube_tracking"]
    with pytest.raises(ValueError, match="uncondensed"):
        setup.to_device(torch.float64, "cpu", solver="ip_riccati",
                        condensed=True)
    tc = condense_template(setup.template)
    with pytest.raises(ValueError, match="full-layout"):
        tc.solve_dense(np.zeros(2), np.zeros(2))
    # a template whose leading rows are not the dynamics equalities
    with pytest.raises(ValueError, match="dynamics"):
        condense_template(tc)


def _qp_cases():
    """The problems of ``tests/test_synthesis_and_qp_ref.py:48-86``."""
    cases = {
        "unconstrained": dict(P=np.diag([2.0, 4.0]), q=np.array([-2.0, -4.0])),
        "equality_only": dict(P=2 * np.eye(2), q=np.zeros(2),
                              A=np.array([[1.0, 1.0]]), b=np.array([1.0])),
        "inequality_active": dict(P=np.array([[2.0]]), q=np.array([-4.0]),
                                  G=np.array([[1.0]]), h=np.array([1.0])),
    }
    rng = np.random.default_rng(42)
    for i in range(5):
        target = rng.normal(size=8) * 2
        cases[f"box_projection_{i}"] = dict(
            P=2 * np.eye(8), q=-2 * target,
            G=np.vstack([np.eye(8), -np.eye(8)]), h=np.ones(16))
    rng = np.random.default_rng(7)
    n, meq, mi = 12, 3, 10
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    q = rng.normal(size=n)
    Ae = rng.normal(size=(meq, n))
    b = rng.normal(size=meq)
    G = rng.normal(size=(mi, n))
    h = rng.normal(size=mi) + 1.0
    cases["mixed_random_kkt"] = dict(P=P, q=q, A=Ae, b=b, G=G, h=h)
    return cases


@pytest.mark.parametrize("case", list(_qp_cases()))
def test_qp_ref_matches_jax(case):
    kw = _qp_cases()[case]
    got, want = solve_qp_dense(**kw), jax_solve_qp_dense(**kw)
    assert (got.status, got.iters) == (want.status, want.iters)
    for f in ("z", "y", "lam", "s"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, f)
    assert got.obj == want.obj and got.gap == want.gap
    assert got.status == "optimal"
