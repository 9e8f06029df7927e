"""The port's extended tube-tracking MPC (paper Section IV.F) against the
JAX package's: setup, frozen arrays and the closed loop with its two QPs.

* ``setup_extended_tube_tracking`` gives templates array-equal to the JAX
  package's: on the double integrator with ``compat_reference_bug`` False
  and True, and on the cartpole as the Results apps set it up
  (``fixed_initial_state=False``, ``rpi_method=1``).  ``Z - W`` empty
  raises.
* ``to_device`` of an extended setup equals the JAX package's ``admm_pr``,
  ``admm2_pr`` and ``ric_pr`` (through ``arrays_from_numpy``) within 1e-12;
  a setup without a packet-received QP keeps them None.
* The closed loop on the extended double integrator, B=6, T=30, 70%/70%
  loss, solvers "admm" and "cuda" (the kernel's plain version on the CPU)
  against ``jax.vmap(make_rollout_fn(...))`` under "admm": x, u, x_nom,
  x_hat, residuals and BOTH warm-start carries within 1e-9; Theta,
  ``feasible``, ``prev_gamma`` and the protocol integers equal.
* The same on the cartpole under "ip_riccati", B=4, T=8: primal residuals
  within 1e-9, dual residuals within 1e-6 (the bars of
  ``test_torch_ip_riccati.py``), x, x_hat and x_nom within 1e-7 (the
  trajectory bar of ``test_torch_results.py``) and u within 5e-6 (measured
  6.7e-7 on inputs of 9 N: the interior point's endgame on the cartpole's
  flat optimal face moves the applied input by rounding).
* (The certificate on the QP that was used: ``test_torch_extended_cert.py``.)
* The interior point's one solve a step (per-rollout initial-tube bounds)
  against solve-both-then-select: every output within 1e-12.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario
from rtmpc_tpu.models.specs import (setup_extended_tube_tracking as
                                    jax_setup_extended)
from rtmpc_tpu.parallel import make_rollout_fn as jax_rollout_fn
from rtmpc_tpu.utils import box as jax_box

from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
from rtmpc_tpu_torch.models import (ControllerArrays, arrays_from_numpy,
                                    flagship_setup,
                                    setup_extended_tube_tracking)
from rtmpc_tpu_torch.ops import ADMMSpec, RiccatiIPSpec
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.parallel.rollout import _one_solve_eligible
from rtmpc_tpu_torch.utils import box


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
DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.0], [1.0]])
KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)


def _di(setup_fn, box_fn, **kw):
    """The flagship's double integrator as an extended controller (initial
    state in the tube, as the Results apps set the extended arm up)."""
    return setup_fn(DI_A, DI_B, np.eye(2), np.eye(1), 10,
                    box_fn(np.array([8.0, 8.0])), box_fn(np.array([1.0])),
                    box_fn(np.array([0.1, 0.1])), fixed_initial_state=False,
                    **kw)


def _assert_templates_equal(jt, pt):
    for f in TEMPLATE_ARRAYS:
        a, b = getattr(jt, f), getattr(pt, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    for f in TEMPLATE_SCALARS:
        assert getattr(jt, f) == getattr(pt, f), f


@pytest.fixture(scope="module")
def di_setups():
    return _di(jax_setup_extended, jax_box), _di(setup_extended_tube_tracking,
                                                 box)


@pytest.fixture(scope="module")
def cartpole_setups():
    js, ps = jax_scenario(), cartpole_scenario()
    return ps, tuple(
        fn(s.A, s.B, s.Q, s.R, s.N, s.X, s.U, s.W, fixed_initial_state=False,
           rpi_method=1)
        for fn, s in ((jax_setup_extended, js),
                      (setup_extended_tube_tracking, ps)))


# ---------------------------------------------------------------------------
# setup and frozen arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compat", [False, True])
def test_di_templates_equal_jax(di_setups, compat):
    if compat:
        js = _di(jax_setup_extended, jax_box, compat_reference_bug=True)
        ps = _di(setup_extended_tube_tracking, box, compat_reference_bug=True)
    else:
        js, ps = di_setups
    assert ps.kind == js.kind == "extended_tube_tracking"
    _assert_templates_equal(js.template, ps.template)
    _assert_templates_equal(js.template_pr, ps.template_pr)
    # the two QPs: equal but for the initial tube's bounds, or, under the
    # reference's bug, the packet-received QP without its terminal rows
    if compat:
        assert ps.template_pr.row_meta["mN"] == 0
        assert ps.template_pr.m < ps.template.m
    else:
        for f in TEMPLATE_ARRAYS:
            same = np.array_equal(getattr(ps.template, f),
                                  getattr(ps.template_pr, f))
            assert same == (f != "u0"), f


def test_cartpole_templates_equal_jax(cartpole_setups):
    _, (js, ps) = cartpole_setups
    _assert_templates_equal(js.template, ps.template)
    _assert_templates_equal(js.template_pr, ps.template_pr)
    assert ps.Z.nrows == 854
    assert (ps.template.n, ps.template.m, ps.template_pr.m) == (109, 1642,
                                                                1642)


def test_empty_z_minus_w_raises(monkeypatch):
    """A tube thinner than the disturbance set along a direction Z
    constrains: the packet-received QP's initial tube is empty."""
    import rtmpc_tpu_torch.models.specs as specs
    monkeypatch.setattr(specs, "pont_diff",
                        lambda Z, W: type(Z)(Z.A, Z.b - 1e3))
    with pytest.raises(ValueError, match="Z - W is empty"):
        _di(setup_extended_tube_tracking, box)


def _assert_specs_close(got, want, fields, name):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, f)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12,
                                   err_msg=f"{name}.{f}")


@pytest.mark.parametrize("which", ["di", "cartpole"])
def test_to_device_pr_specs_equal_jax(di_setups, cartpole_setups, which):
    js, ps = di_setups if which == "di" else cartpole_setups[1]
    kw = KW if which == "di" else dict(KW, iters=200, iters2=200)
    ja, jc = js.to_device(dtype=jnp.float64, solver="admm", **kw)
    want = arrays_from_numpy(jax.tree_util.tree_map(np.asarray, ja))
    got, cfg = ps.to_device(torch.float64, "cpu", solver="cuda", **kw)
    assert cfg.extended and jc.extended
    for name in ("admm", "admm2", "admm_pr", "admm2_pr"):
        _assert_specs_close(getattr(got, name), getattr(want, name),
                            ADMMSpec._fields, name)
    assert got.ric is None and got.ric_pr is None
    # its rho is tuned on its own: the packet-received spec is its own
    # object, and phase 2 differs from phase 1
    assert got.admm_pr is not got.admm
    assert not torch.equal(got.admm_pr.rho, got.admm2_pr.rho)

    got, cfg = ps.to_device(torch.float64, "cpu", solver="ip_riccati",
                            ip_iters=30)
    assert cfg.extended and got.admm is None and got.admm_pr is None
    for name in ("ric", "ric_pr"):
        _assert_specs_close(getattr(got, name), getattr(want, name),
                            RiccatiIPSpec._fields, name)
    assert _one_solve_eligible(got, cfg)
    if which == "cartpole":
        assert got.ric.Ht.shape == (854, 4)


def test_plain_setup_keeps_no_pr_specs():
    for solver in ("cuda", "ip_riccati"):
        arrays, cfg = flagship_setup().to_device(torch.float64, "cpu",
                                                 solver=solver, **KW)
        assert not cfg.extended
        assert arrays.admm_pr is arrays.admm2_pr is arrays.ric_pr is None
    assert ControllerArrays._fields[-3:] == ("admm_pr", "admm2_pr", "ric_pr")


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

def _inputs(B, T, nx, p, seed, ref, x0_scale):
    rng = np.random.default_rng(seed)
    theta = (rng.uniform(size=(B, T)) >= p).astype(np.int32)
    gamma = (rng.uniform(size=(B, T)) >= p).astype(np.int32)
    theta[:, 0] = 1
    refs = np.zeros((B, T, nx))
    refs[:, :, 0] = ref
    x0 = rng.uniform(-1.0, 1.0, size=(B, nx)) * x0_scale
    return x0, refs, theta, gamma, rng


def _jax_run(arrays, cfg, T, inp, **kw):
    fn = jax.jit(jax.vmap(jax_rollout_fn(arrays, cfg, T, **kw)))
    return jax.tree_util.tree_map(np.asarray, fn(*map(jnp.asarray, inp)))


def _port_run(arrays, cfg, T, inp, **kw):
    return make_batched_rollout(arrays, cfg, T, **kw)(*map(torch.tensor, inp))


def _assert_protocol_equal(carry, jcarry, tol):
    for f in ("t", "q", "s", "last_drop", "Theta"):
        np.testing.assert_array_equal(getattr(carry.act, f).numpy(),
                                      getattr(jcarry.act, f), err_msg=f)
    for f in ("t", "q"):
        np.testing.assert_array_equal(getattr(carry.est, f).numpy(),
                                      getattr(jcarry.est, f), err_msg=f)
    np.testing.assert_array_equal(carry.prev_gamma.numpy(),
                                  jcarry.prev_gamma)
    np.testing.assert_array_equal(carry.feasible.numpy(), jcarry.feasible)
    for got, want, name in ((carry.x, jcarry.x, "x"),
                            (carry.act.x_nom, jcarry.act.x_nom, "act.x_nom"),
                            (carry.act.u_buf, jcarry.act.u_buf, "act.u_buf"),
                            (carry.est.x_hat, jcarry.est.x_hat, "est.x_hat")):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def di_closed_loop(di_setups):
    js, _ = di_setups
    B, T = 6, 30
    x0, refs, theta, gamma, rng = _inputs(B, T, 2, 0.7, 11, 4.0, 1.0)
    inp = (x0, refs, rng.uniform(-0.1, 0.1, size=(B, T, 2)), theta, gamma)
    arrays, cfg = js.to_device(dtype=jnp.float64, solver="admm", **KW)
    return inp, T, _jax_run(arrays, cfg, T, inp)


@pytest.mark.parametrize("solver", ["admm", "cuda"])
def test_di_closed_loop_matches_jax(di_setups, di_closed_loop, solver):
    inp, T, (jcarry, jouts) = di_closed_loop
    arrays, cfg = di_setups[1].to_device(torch.float64, "cpu", solver=solver,
                                         **KW)
    carry, outs = _port_run(arrays, cfg, T, inp)
    for f in ("x", "u", "x_nom", "x_hat", "r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(outs, f).numpy(),
                                   getattr(jouts, f), rtol=0, atol=1e-9,
                                   err_msg=f)
    np.testing.assert_array_equal(outs.Theta.numpy(), jouts.Theta)
    np.testing.assert_array_equal(outs.feasible.numpy(), jouts.feasible)
    assert bool(carry.feasible.all())
    for name in ("admm", "admm_pr"):
        for f in ("x", "y", "z"):
            np.testing.assert_allclose(
                getattr(getattr(carry, name), f).numpy(),
                getattr(getattr(jcarry, name), f), rtol=0, atol=1e-9,
                err_msg=f"{name}.{f}")
    # the two warm starts are two iterates, both advanced every step
    assert not torch.equal(carry.admm.y, carry.admm_pr.y)
    _assert_protocol_equal(carry, jcarry, 1e-9)
    # the loop used both QPs: some steps followed a lost reply, some not
    prev = np.concatenate([np.ones((6, 1), np.int32), inp[4][:, :-1]], 1)
    assert 0.2 < prev.mean() < 0.8


def test_cartpole_closed_loop_ip_matches_jax(cartpole_setups):
    sc, (js, ps) = cartpole_setups
    B, T = 4, 8
    x0, refs, theta, gamma, rng = _inputs(
        B, T, 4, 0.5, 12, sc.ref_value, np.array([0.05, 0.05, 0.01, 0.02]))
    w = rng.uniform(sc.w_lo, sc.w_hi, size=(B, T, 4))
    inp = (x0, refs, w, theta, gamma)
    ja, jc = js.to_device(dtype=jnp.float64, solver="ip_riccati", ip_iters=30)
    jcarry, jouts = _jax_run(ja, jc, T, inp)
    arrays, cfg = ps.to_device(torch.float64, "cpu", solver="ip_riccati",
                               ip_iters=30)
    carry, outs = _port_run(arrays, cfg, T, inp)
    np.testing.assert_allclose(outs.r_prim.numpy(), jouts.r_prim, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(outs.r_dual.numpy(), jouts.r_dual, rtol=0,
                               atol=1e-6)
    for f, tol in (("x", 1e-7), ("x_hat", 1e-7), ("x_nom", 1e-7),
                   ("u", 5e-6)):
        np.testing.assert_allclose(getattr(outs, f).numpy(),
                                   getattr(jouts, f), rtol=0, atol=tol,
                                   err_msg=f)
    np.testing.assert_array_equal(outs.Theta.numpy(), jouts.Theta)
    assert bool(carry.feasible.all()) and bool(jcarry.feasible.all())
    assert carry.admm is None and carry.admm_pr is None
    _assert_protocol_equal(carry, jcarry, 1e-7)


# ---------------------------------------------------------------------------
# one interior-point solve a step against solve-both-then-select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["di", "cartpole"])
def test_one_solve_equals_solve_both(di_setups, cartpole_setups, which):
    if which == "di":
        ps, (B, T, nx, ref, scale) = di_setups[1], (6, 12, 2, 4.0, 1.0)
        w_box = np.array([0.1, 0.1])
    else:
        sc, (_, ps) = cartpole_setups
        B, T, nx, ref = 4, 5, 4, sc.ref_value
        scale, w_box = np.array([0.05, 0.05, 0.01, 0.02]), sc.w_hi
    x0, refs, theta, gamma, rng = _inputs(B, T, nx, 0.6, 14, ref, scale)
    inp = (x0, refs, rng.uniform(-w_box, w_box, size=(B, T, nx)), theta,
           gamma)
    arrays, cfg = ps.to_device(torch.float64, "cpu", solver="ip_riccati",
                               ip_iters=30)
    c1, o1 = _port_run(arrays, cfg, T, inp)                   # one solve
    c2, o2 = _port_run(arrays, cfg, T, inp, one_solve=False)  # both
    for f in o1._fields:
        a, b = getattr(o1, f), getattr(o2, f)
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12, err_msg=f)
        else:
            assert torch.equal(a, b), f
    np.testing.assert_allclose(c1.x.numpy(), c2.x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(c1.est.x_hat.numpy(), c2.est.x_hat.numpy(),
                               rtol=0, atol=1e-12)


def test_one_solve_needs_matching_qps():
    """Under the reference's bug the two QPs' row counts differ: no
    shortcut, and asking for it raises."""
    ps = _di(setup_extended_tube_tracking, box, compat_reference_bug=True)
    arrays, cfg = ps.to_device(torch.float64, "cpu", solver="ip_riccati",
                               ip_iters=30)
    assert not _one_solve_eligible(arrays, cfg)
    with pytest.raises(ValueError, match="one_solve"):
        make_batched_rollout(arrays, cfg, 3, one_solve=True)
    inp = _inputs(2, 3, 2, 0.5, 15, 1.0, 0.5)
    x0, refs, theta, gamma, _ = inp
    carry, outs = _port_run(arrays, cfg, 3,
                            (x0, refs, np.zeros((2, 3, 2)), theta, gamma))
    assert bool(carry.feasible.all()) and bool(torch.isfinite(outs.x).all())
    plain, pcfg = flagship_setup().to_device(torch.float64, "cpu",
                                             solver="ip_riccati")
    with pytest.raises(ValueError, match="one_solve"):
        make_batched_rollout(plain, pcfg, 3, one_solve=True)
