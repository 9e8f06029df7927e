"""The set demos (``apps/set_operations``) and ``intersect`` of the port
against the JAX package, on the host in float64.

* ``intersect`` is bit-equal to the JAX package's;
* each demo's checks give the JAX app's verdicts, and the sets it builds
  have the areas of the sets the JAX package's own functions build from
  the same inputs (relative 1e-9: the two packages may solve their
  support LPs with different solvers, native or scipy), the Darup RPI its
  k* too;
* the figures are written as non-empty PNGs.
"""

import argparse

import numpy as np
import pytest

from rtmpc_tpu.apps import set_operations as jax_app
from rtmpc_tpu import sets as jax_sets
from rtmpc_tpu import utils as jax_utils
from rtmpc_tpu.utils.synthesis import dlqr as jax_dlqr

from rtmpc_tpu_torch.apps import set_operations
from rtmpc_tpu_torch.utils import Polytope, intersect

A_DI, B_DI = set_operations.A_DI, set_operations.B_DI


def test_intersect_bit_equal_to_jax():
    rng = np.random.default_rng(11)
    for m1, m2 in ((4, 6), (1, 9), (7, 3)):
        A1, b1 = rng.normal(size=(m1, 3)), rng.uniform(0.5, 2, m1)
        A2, b2 = rng.normal(size=(m2, 3)), rng.uniform(0.5, 2, m2)
        got = intersect(Polytope(A1, b1), Polytope(A2, b2))
        want = jax_utils.intersect(jax_utils.Polytope(A1, b1),
                                   jax_utils.Polytope(A2, b2))
        np.testing.assert_array_equal(got.A, want.A)
        np.testing.assert_array_equal(got.b, want.b)


def _jax_sets(name):
    """The sets each demo builds, made with the JAX package's functions
    from the demo's inputs (``rtmpc_tpu/apps/set_operations.py``)."""
    box = jax_utils.box
    if name == "ops":
        P1, P2 = box(np.array([2.0, 2.0])), box(np.array([1.0, 1.0]))
        th = np.pi / 6
        Rm = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        return {"P1+P2": jax_utils.mink_sum(P1, P2),
                "P1-P2": jax_utils.pont_diff(P1, P2),
                "R P2": jax_utils.scale(P2, Rm)}
    if name == "rakovic":
        Bm = np.array([[1.0], [1.0]])
        Acl = np.array([[1.0, 1.0], [0.0, 1.0]]) - Bm @ np.array([[1.17,
                                                                   1.03]])
        Z, _ = jax_sets.mrpi_rakovic(Acl, box(np.array([1.0, 1.0])),
                                     eps_var=1.9e-5, s_max=60)
        return {"F_inf": Z}
    if name == "darup":
        X = jax_utils.Polytope(np.vstack([np.eye(2), -np.eye(2)]),
                               np.array([4.0, 2.0, 8.0, 4.0]))
        K, _, _ = jax_dlqr(A_DI, B_DI, np.eye(2), np.eye(1))
        out = {}
        for eps in (1e-1, 1e-2, 1e-3):
            out[f"P_inf eps={eps:g}"], _ = jax_sets.rpi_darup(
                A_DI - B_DI @ K, box(np.array([0.1, 0.1])), X,
                box(np.array([1.0])), K, eps_var=eps, s_max=50)
        return out
    K, _, _ = jax_dlqr(A_DI, B_DI, np.eye(2), 0.01 * np.eye(1))
    Acl = A_DI - B_DI @ K
    X = jax_utils.Polytope(np.array([[0.0, 1.0], [0.0, -1.0], [1.0, 0.0],
                                     [-1.0, 0.0]]),
                           np.array([2.0, 50.0, 50.0, 50.0]))
    U = box(np.array([1.0]))
    Z = jax_sets.determine_mrpi(Acl, box(np.array([0.1, 0.1])))
    Xc, Uc = jax_sets.tighten_constraints(X, U, Z, K)
    XU = jax_utils.Polytope(np.vstack([Xc.A, -Uc.A @ K]),
                            np.concatenate([Xc.b, Uc.b]))
    Xf = jax_sets.max_admissible_set(Acl, XU)
    return {"Z": Z, "Xf": Xf, "Xf+Z": jax_utils.mink_sum(Xf, Z)}


@pytest.mark.parametrize("name", ["ops", "rakovic", "darup", "mayne"])
def test_demo_matches_jax(name):
    got = set_operations.DEMOS[name](False)
    want_ok = getattr(jax_app, f"demo_{name}")(
        argparse.Namespace(no_figures=True))
    assert got["ok"] is True and bool(want_ok) is True
    want = _jax_sets(name)
    assert set(got["sets"]) == set(want)
    for label, poly in got["sets"].items():
        np.testing.assert_allclose(set_operations.area(poly),
                                   set_operations.area(want[label]),
                                   rtol=1e-9, err_msg=label)
        if name == "darup":
            assert poly._k_star == want[label]._k_star


def test_figures_are_written(tmp_path, monkeypatch):
    monkeypatch.setenv("RTMPC_RESULTS_DIR", str(tmp_path))
    assert set_operations.main(["--demo", "ops"]) == 0
    png = tmp_path / "set_operations.png"
    assert png.stat().st_size > 1000
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_figures_without_matplotlib_exit_naming_the_flag(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr("importlib.import_module",
                        lambda name: no_matplotlib(name))
    with pytest.raises(SystemExit, match="--no-figures"):
        set_operations.main(["--demo", "ops"])
