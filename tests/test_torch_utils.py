"""The port's host setup toolbox against the JAX package's, bit for bit.

``rtmpc_tpu_torch.utils`` and ``rtmpc_tpu_torch.sets`` are the port's own
copies of ``rtmpc_tpu.utils`` and ``rtmpc_tpu.sets`` (float64 NumPy, no JAX,
no torch).  Every function the controller setups reach gets the same
numpy-seeded inputs in both packages and must return the same float64
bits: same statements, same LAPACK/Qhull/LP calls.  Both packages read
``RTMPC_NO_NATIVE`` alike, so both solve their LPs with the native library
or both with scipy; the cases are small enough to be quick either way.
"""

import numpy as np
import pytest

import rtmpc_tpu.sets as jsets
import rtmpc_tpu.utils as jutils
import rtmpc_tpu_torch.sets as psets
import rtmpc_tpu_torch.utils as putils
from rtmpc_tpu.utils._native import native_available as jax_native_available
from rtmpc_tpu_torch.utils._native import native_available

DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.5], [1.0]])


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b), np.abs(a - b).max()


def _same_poly(p, q):
    _same(p.A, q.A)
    _same(p.b, q.b)
    assert (p.vertices is None) == (q.vertices is None)
    if p.vertices is not None:
        _same(p.vertices, q.vertices)


def _pair(fn):
    """``fn(package)`` on both packages' ``utils``."""
    return fn(putils), fn(jutils)


def _random_poly(u, seed, dim=2, rows=9):
    """A bounded polytope around the origin: a box cut by random rows."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((rows, dim))
    b = rng.uniform(0.5, 2.0, rows)
    base = u.box(np.full(dim, 3.0))
    return u.Polytope(np.vstack([base.A, A]), np.concatenate([base.b, b]))


def _gain(u):
    K, _, _ = u.dlqr(DI_A, DI_B, np.eye(2), 0.1 * np.eye(1))
    return -K


def test_both_packages_choose_the_same_lp_solver():
    assert native_available() == jax_native_available()


@pytest.mark.parametrize("args", [
    (np.array([8.0, 8.0]),), (np.array([1.0]),),
    (np.array([-1.0, -2.0, 0.5]), np.array([0.25, 3.0, 0.75]))])
def test_box(args):
    _same_poly(*_pair(lambda u: u.box(*args)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_support_lp_and_vertices(seed):
    dirs = np.random.default_rng(100 + seed).standard_normal((7, 2))
    for use_vrep in (False, True):
        def run(u):
            p = _random_poly(u, seed)
            if use_vrep:
                p.get_vertices()
            return np.array([u.support(p, d, use_vrep=use_vrep)
                             for d in dirs])
        _same(*_pair(run))
    _same(*_pair(lambda u: u.support_many(_random_poly(u, seed), dirs)))
    _same(*_pair(lambda u: u.support_lp_batch(
        _random_poly(u, seed).A, _random_poly(u, seed).b, dirs)))
    _same(*_pair(lambda u: u.extreme(_random_poly(u, seed))))


@pytest.mark.parametrize("seed", [0, 3])
def test_pont_diff(seed):
    _same_poly(*_pair(lambda u: u.pont_diff(
        _random_poly(u, seed), u.box(np.array([0.1, 0.05])))))


@pytest.mark.parametrize("other", ["polytope", "vector", "vertices"])
def test_mink_sum(other):
    def run(u):
        p = _random_poly(u, 4)
        q = {"polytope": u.box(np.array([0.2, 0.1])),
             "vector": np.array([0.3, -0.2]),
             "vertices": np.array([[0.1, 0.0], [0.0, 0.1], [-0.1, -0.1]])}
        return u.mink_sum(p, q[other])
    _same_poly(*_pair(run))


@pytest.mark.parametrize("s", [2.5, 0.0, -0.5, "matrix", "row"])
def test_scale(s):
    def run(u):
        m = {"matrix": np.array([[1.0, 0.5], [-0.25, 2.0]]),
             "row": np.array([[0.7, -1.3]])}.get(s, s)
        return u.scale(_random_poly(u, 5), m)
    _same_poly(*_pair(run))


@pytest.mark.parametrize("kw", [
    {}, {"angular_tol": 1e-9, "slack_tol": 1e-7}, {"slack_tol": 1e-2}])
def test_reduce_poly(kw):
    def run(u):
        p = _random_poly(u, 6, rows=14)
        # near-duplicate and scaled-duplicate rows, as the mRPI sets carry
        A = np.vstack([p.A, p.A[:3] * (1 + 1e-13), 2.0 * p.A[4:6]])
        b = np.concatenate([p.b, p.b[:3] + 1e-9, 2.0 * p.b[4:6]])
        return u.reduce_poly(u.Polytope(A, b), **kw)
    _same_poly(*_pair(run))


def test_containment_and_equality():
    def run(u):
        p, q = _random_poly(u, 7), u.box(np.array([3.0, 3.0]))
        inside = np.array([0.1, -0.1])
        return (u.poly_subset(p, q), u.poly_subset(q, p), u.poly_equal(p, p),
                p == q, inside in p, np.array([9.0, 0.0]) in p)
    got, want = _pair(run)
    assert got == want == (True, False, True, False, True, False)


def test_synthesis():
    rng = np.random.default_rng(8)
    Ac = rng.standard_normal((4, 4))
    Bc = rng.standard_normal((4, 2))
    got, want = _pair(lambda u: u.c2d(Ac, Bc, 0.02))
    for a, b in zip(got, want):
        _same(a, b)
    A, B = got
    Q, R = np.diag([100.0, 10.0, 100.0, 10.0]), 0.1 * np.eye(2)
    got, want = _pair(lambda u: u.dlqr(A, B, Q, R))
    for a, b in zip(got, want):
        _same(a, b)
    Acl = A - B @ got[0]
    _same(*_pair(lambda u: u.dlyap(Acl, Q)))
    _same(*_pair(lambda u: u.dlqr(DI_A, DI_B, np.eye(2), np.eye(1))[0]))


@pytest.mark.parametrize("rpi_method,eps", [(0, 1.9e-5), (0, 1e-3),
                                            (1, 1e-2), (1, 1e-4)])
def test_determine_mrpi_double_integrator(rpi_method, eps):
    def run(u, s):
        K = _gain(u)
        return s.determine_mrpi(
            DI_A + DI_B @ K, u.box(np.array([0.1, 0.1])),
            u.box(np.array([8.0, 8.0])), u.box(np.array([1.0])), -K,
            eps_var=eps, rpi_method=rpi_method)
    _same_poly(run(putils, psets), run(jutils, jsets))


@pytest.mark.parametrize("eps", [1e-1, 1e-2, 1e-3])
def test_rpi_darup_with_container(eps):
    def run(u, s):
        K = _gain(u)
        return s.rpi_darup(
            DI_A + DI_B @ K, u.box(np.array([0.1, 0.1])),
            u.box(np.array([8.0, 8.0])), u.box(np.array([1.0])), -K,
            eps_var=eps, return_container=True)
    (rpi, cont, status), (jrpi, jcont, jstatus) = (run(putils, psets),
                                                    run(jutils, jsets))
    assert status == jstatus == 0 and rpi._k_star == jrpi._k_star
    _same_poly(rpi, jrpi)
    _same_poly(cont, jcont)


def test_mrpi_rakovic_reports_failure_alike():
    def run(u, s):
        return s.mrpi_rakovic(DI_A + DI_B @ _gain(u),
                              u.box(np.array([0.1, 0.1])), eps_var=1e-9,
                              s_max=4)
    assert run(putils, psets) == run(jutils, jsets) == (None, -1)


def test_determine_mrpi_refuses_unstable():
    for s, u in ((psets, putils), (jsets, jutils)):
        with pytest.raises(ValueError, match="Schur"):
            s.determine_mrpi(DI_A, u.box(np.array([0.1, 0.1])))


@pytest.mark.parametrize("case", ["double_integrator", "augmented"])
def test_max_admissible_set(case):
    def run(u, s):
        K = _gain(u)
        Acl = DI_A + DI_B @ K
        if case == "double_integrator":
            X = u.Polytope(
                np.vstack([u.box(np.array([8.0, 8.0])).A,
                           u.box(np.array([1.0])).A @ K]),
                np.concatenate([u.box(np.array([8.0, 8.0])).b,
                                u.box(np.array([1.0])).b]))
            return s.max_admissible_set(Acl, X)
        # a 3-D system with a marginally stable (lambda-contracted) mode,
        # the shape of the tracking controllers' terminal sets
        A3 = np.zeros((3, 3))
        A3[:2, :2] = Acl
        A3[:2, 2] = [0.05, 0.1]
        A3[2, 2] = 0.99
        return s.max_admissible_set(A3, u.box(np.array([8.0, 8.0, 1.0])))
    _same_poly(run(putils, psets), run(jutils, jsets))


def test_tighten_constraints():
    def run(u, s):
        K = _gain(u)
        Z = s.determine_mrpi(DI_A + DI_B @ K, u.box(np.array([0.1, 0.1])))
        return s.tighten_constraints(u.box(np.array([8.0, 8.0])),
                                     u.box(np.array([1.0])), Z, -K)
    (Xc, Uc), (jXc, jUc) = run(putils, psets), run(jutils, jsets)
    _same_poly(Xc, jXc)
    _same_poly(Uc, jUc)


def test_small_4d_case_darup_and_tightening():
    """A stable 4-D system (two coupled double integrators under LQR):
    Darup RPI, tightening and the admissible set of the tightened
    constraints, the call sequence of ``setup_tube_tracking`` on the
    cartpole at a size that is quick without the native library."""
    A = np.kron(np.eye(2), DI_A)
    A[0, 3] = 0.05
    B = np.kron(np.eye(2), DI_B)

    def run(u, s):
        K = -u.dlqr(A, B, np.eye(4), 0.1 * np.eye(2))[0]
        Acl = A + B @ K
        X, U = u.box(np.array([8.0, 8.0, 6.0, 6.0])), u.box(np.ones(2))
        W = u.box(np.full(4, 0.02))
        Z = s.determine_mrpi(Acl, W, X, U, -K, eps_var=1e-2, rpi_method=1)
        Xc = u.pont_diff(X, Z)
        Uc = u.Polytope(U.A.copy(),
                        U.b - u.support_lp_batch(Z.A, Z.b, U.A @ K))
        XU = u.Polytope(np.vstack([Xc.A, Uc.A @ K]),
                        np.concatenate([Xc.b, Uc.b]))
        return Z, Xc, Uc, s.max_admissible_set(Acl, XU)
    for p, q in zip(run(putils, psets), run(jutils, jsets)):
        _same_poly(p, q)
