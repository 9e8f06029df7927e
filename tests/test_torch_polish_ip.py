"""The polish, the dense interior point, the two regulator setups and the
direct rollout of the port against the JAX package, in float64 on the CPU.

* ``polish_solution`` on the same scaled ADMM iterates (the flagship's QP
  after 120 iterations at 8 thetas): x, r_prim, r_dual within 1e-12 (read
  9e-16); with the input residuals set to 0 on half of the rows the polish
  is rejected there and the iterate comes back unchanged, in both
  packages alike; ``admm_solve(..., polish=True)`` against the JAX one,
  z_primal within 1e-12 and the state the raw iterate.
* ``ip_solve`` against ``jax.vmap(ip_solve)`` at 8 thetas (30 iterations):
  z_primal within 1e-8 (read 2e-15 on the flagship, 1.9e-9 on the tube
  regulator, whose R = 0.01 makes its KKT systems the worst conditioned),
  r_prim and gap within 1e-12, on the flagship's QP and on the two
  regulators'; r_dual within 1e-12 on the first two.  Past convergence the
  reference's freeze (mu below 100 eps^2) comes late: mu falls to ~1e-31
  and the duals drift in both packages alike, so on the tube regulator
  r_dual is rounding noise (0.053 in the JAX package, 2.0 in the port at
  one theta, the primal equal to 6e-17) and is only held below 1e-8 where
  the JAX one is.
* ``prepare_ip``, ``setup_regulator`` and ``setup_tube_regulator``: the
  templates, the ADMM specs (through ``arrays_from_numpy``) and the dense
  IP's spec bit-equal to the JAX package's.
* ``make_direct_rollout``, both modes (``ancillary`` False on the
  regulator, True on the tube regulator) under "ip" and under "admm" with
  polish: x, u, x_nom, xbar and r_prim within 1e-9, r_dual within 1e-9
  under "admm" (under "ip" see above).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models import setup_regulator as jax_setup_regulator
from rtmpc_tpu.models import setup_tube_regulator as jax_setup_tube_regulator
from rtmpc_tpu.models import setup_tube_tracking as jax_setup_tube_tracking
from rtmpc_tpu.ops.ip import ip_solve as jax_ip_solve
from rtmpc_tpu.ops.qp import admm_solve as jax_admm_solve
from rtmpc_tpu.ops.qp import polish_solution as jax_polish_solution
from rtmpc_tpu.parallel.rollout import (
    make_direct_rollout as jax_make_direct_rollout)
from rtmpc_tpu.utils import Polytope as JPolytope
from rtmpc_tpu.utils import box as jax_box

from rtmpc_tpu_torch.models import (arrays_from_numpy, flagship_setup,
                                    setup_regulator, setup_tube_regulator)
from rtmpc_tpu_torch.ops.ip import ip_solve, prepare_ip
from rtmpc_tpu_torch.ops.qp import (admm_solve, polish_solution,
                                    problem_vectors)
from rtmpc_tpu_torch.parallel import make_direct_rollout
from rtmpc_tpu_torch.utils import Polytope, box

DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.0], [1.0]])
TUBE_B = np.array([[0.5], [1.0]])
KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
THETAS = np.random.default_rng(0).uniform(-2, 2, (8, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread.  The batches here are small, and this CPU
    build of torch can deadlock in a batched LU factorization (batch > 1)
    run on several intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tube_regulator(pkg_box, poly):
    X = poly(np.array([[0.0, 1.0], [0.0, -1.0], [1.0, 0.0], [-1.0, 0.0]]),
             np.array([2.0, 50.0, 50.0, 50.0]))
    return (DI_A, TUBE_B, np.eye(2), 0.01 * np.eye(1), 9, X,
            pkg_box(np.array([1.0])), pkg_box(np.array([0.1, 0.1])))


@pytest.fixture(scope="module")
def setups():
    """By name, ``(JAX setup, port setup)``: the flagship, the regulator
    of ``example_regulator`` and the tube regulator of
    ``example_tube_regulator``."""
    return {
        "flagship": (jax_setup_tube_tracking(
            DI_A, DI_B, np.eye(2), np.eye(1), 10,
            jax_box(np.array([8.0, 8.0])), jax_box(np.array([1.0])),
            jax_box(np.array([0.1, 0.1])), fixed_initial_state=True),
            flagship_setup()),
        "regulator": (
            jax_setup_regulator(DI_A, DI_B, np.eye(2), np.eye(1), 10,
                                U=jax_box(np.array([1.0]))),
            setup_regulator(DI_A, DI_B, np.eye(2), np.eye(1), 10,
                            U=box(np.array([1.0])))),
        "tube_regulator": (
            jax_setup_tube_regulator(*_tube_regulator(jax_box, JPolytope)),
            setup_tube_regulator(*_tube_regulator(box, Polytope))),
    }


def _jax_arrays(setup, **kw):
    arrays, cfg = setup.to_device(dtype=jnp.float64, **kw)
    return arrays, cfg, jax.tree_util.tree_map(np.asarray, arrays)


def _equal(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("name", ["regulator", "tube_regulator"])
def test_new_setups_bit_equal(setups, name):
    """Templates, ADMM specs and the dense IP's spec of both regulators
    bit-equal to the JAX package's (float64)."""
    jst, pst = setups[name]
    for f in ("P", "q0", "Mq", "A", "l0", "u0", "Ml", "Mu", "is_eq"):
        _equal(getattr(pst.template, f), getattr(jst.template, f), f)
    assert pst.template.tracking == jst.template.tracking is False
    if name == "tube_regulator":
        _equal(pst.Z.A, jst.Z.A, "Z.A")
        _equal(pst.Z.b, jst.Z.b, "Z.b")
        _equal(pst.K, jst.K, "K")
    _, _, npa = _jax_arrays(jst, **KW)
    via_numpy = arrays_from_numpy(npa)
    pa, pcfg = pst.to_device(torch.float64, "cpu", **KW)
    for field in ("admm", "admm2"):
        for f, a, b in zip(pa.admm._fields, getattr(pa, field),
                           getattr(via_numpy, field)):
            _equal(a.numpy(), b.numpy(), f"{field}.{f}")
    for f in ("A", "B", "K_ss", "K_plant", "Hz", "hz"):
        _equal(getattr(pa, f).numpy(), getattr(via_numpy, f).numpy(), f)
    pip = prepare_ip(pst.template, torch.float64)
    for f, a, b in zip(pip._fields, pip, via_numpy.ip):
        _equal(a.numpy(), b.numpy(), f"ip.{f}")
    assert pcfg.xbar_off == pcfg.ubar_off == -1


@pytest.mark.parametrize("name", ["flagship", "regulator", "tube_regulator"])
def test_ip_solve_matches_jax(setups, name):
    jst, _ = setups[name]
    jarrays, _, npa = _jax_arrays(jst, **KW)
    pa = arrays_from_numpy(npa)
    th = THETAS.copy()
    if name == "tube_regulator":
        th[:, :2] = np.array([-5.0, -2.0]) + 0.1 * th[:, :2]
    want = jax.vmap(lambda t: jax_ip_solve(jarrays.ip, t, iters=30))(
        jnp.asarray(th))
    got = ip_solve(pa.ip, torch.tensor(th), iters=30)
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), rtol=0, atol=1e-8)
    for f in ("r_prim", "gap") + (("r_dual",) if name != "tube_regulator"
                                  else ()):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    assert float(got.r_prim.max()) < 1e-8
    converged = np.asarray(want.r_dual) < 1e-8
    assert bool((got.r_dual.numpy()[converged] < 1e-8).all())


def test_polish_matches_jax_and_rejects_alike(setups):
    jst, _ = setups["flagship"]
    jarrays, _, npa = _jax_arrays(jst, **KW)
    pa = arrays_from_numpy(npa)
    spec, jspec = pa.admm, jarrays.admm
    th = torch.tensor(THETAS)
    raw = admm_solve(spec, th, iters=120)
    # rows 0..3 keep their residuals, rows 4..7 claim an exact iterate:
    # no polish can beat it there, so it is rejected
    rp = raw.r_prim.clone()
    rd = raw.r_dual.clone()
    rp[4:] = rd[4:] = 0.0
    q, l, u = problem_vectors(spec, th)
    x, rp2, rd2 = polish_solution(spec, q, l, u, *raw.state, rp, rd)

    def one(t, xv, yv, zv, a, b):
        return jax_polish_solution(
            jspec, jspec.q0 + jspec.Mq @ t, jspec.l0 + jspec.Ml @ t,
            jspec.u0 + jspec.Mu @ t, xv, yv, zv, a, b)

    jx, jrp, jrd = jax.vmap(one)(jnp.asarray(THETAS),
                                 *(jnp.asarray(t.numpy()) for t in raw.state),
                                 jnp.asarray(rp.numpy()),
                                 jnp.asarray(rd.numpy()))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(rp2.numpy(), np.asarray(jrp), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rd2.numpy(), np.asarray(jrd), rtol=0,
                               atol=1e-12)
    # accepted where the residuals were real, rejected where they were 0
    assert bool((rp2[:4] < raw.r_prim[:4]).all())
    assert torch.equal(x[4:], raw.state.x[4:])
    assert torch.equal(rp2[4:], rp[4:]) and torch.equal(rd2[4:], rd[4:])


def test_admm_solve_polish_matches_jax(setups):
    jst, _ = setups["flagship"]
    jarrays, _, npa = _jax_arrays(jst, **KW)
    pa = arrays_from_numpy(npa)
    th = torch.tensor(THETAS)
    got = admm_solve(pa.admm, th, iters=120, polish=True)
    raw = admm_solve(pa.admm, th, iters=120)
    want = jax.vmap(lambda t: jax_admm_solve(jarrays.admm, t, iters=120,
                                             polish=True))(
        jnp.asarray(THETAS))
    np.testing.assert_allclose(got.z_primal.numpy(),
                               np.asarray(want.z_primal), rtol=0, atol=1e-12)
    for f in ("r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    for a, b in zip(got.state, raw.state):       # the raw ADMM iterate
        assert torch.equal(a, b)
    assert float(got.r_prim.max()) < 1e-9


@pytest.mark.parametrize("solver", ["ip", "admm"])
@pytest.mark.parametrize("name,ancillary", [("regulator", False),
                                            ("tube_regulator", True)])
def test_direct_rollout_matches_jax(setups, name, ancillary, solver):
    """The direct loop over T=8 steps from two initial states, both modes,
    against the JAX function under ``vmap`` on the same arrays."""
    T = 8
    kw = (dict(solver="ip", ip_iters=30) if solver == "ip"
          else dict(KW, polish=True))
    jst, _ = setups[name]
    jarrays, jcfg, npa = _jax_arrays(jst, **kw)
    pa = arrays_from_numpy(npa)
    _, pcfg = setups[name][1].to_device(torch.float64, "cpu",
                                        solver=solver, **(
                                            dict(ip_iters=30) if solver
                                            == "ip" else dict(KW, polish=True)
                                        ))
    rng = np.random.default_rng(3)
    x0 = (np.array([[1.0, 2.0], [-0.5, 0.3]]) if name == "regulator"
          else np.array([[-5.0, -2.0], [-3.0, 1.0]]))
    refs = np.zeros((2, T, 2))
    w = (np.zeros((2, T, 2)) if name == "regulator"
         else rng.uniform(-0.1, 0.1, (2, T, 2)))
    (jxT, _), jouts = jax.vmap(jax_make_direct_rollout(
        jarrays, jcfg, T, ancillary=ancillary))(
        jnp.asarray(x0), jnp.asarray(refs), jnp.asarray(w))
    (xT, _), outs = make_direct_rollout(pa, pcfg, T, ancillary=ancillary)(
        torch.tensor(x0), torch.tensor(refs), torch.tensor(w))
    for f, want in zip(("x", "u", "x_nom", "xbar", "r_prim", "r_dual"),
                       jouts):
        if f == "r_dual" and solver == "ip":
            continue
        np.testing.assert_allclose(getattr(outs, f).numpy(), np.asarray(want),
                                   rtol=0, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(xT.numpy(), np.asarray(jxT), rtol=0,
                               atol=1e-9)


def test_new_setups_raise_value_error():
    """Bad arguments raise ``ValueError`` (the reference asserts or fails
    further down)."""
    with pytest.raises(ValueError, match="horizon"):
        setup_regulator(DI_A, DI_B, np.eye(2), np.eye(1), 0)
    with pytest.raises(ValueError, match="fit one system"):
        setup_regulator(DI_A, DI_B, np.eye(3), np.eye(1), 5)
    with pytest.raises(ValueError, match="needs X, U and W"):
        setup_tube_regulator(DI_A, TUBE_B, np.eye(2), np.eye(1), 5,
                             box(np.array([8.0, 8.0])), box(np.array([1.0])),
                             None)
