"""Set-operation demos: the reference's four ``Examples of Set Operations``
scripts (counterpart of ``rtmpc_tpu/apps/set_operations.py``).

    python3 -m rtmpc_tpu_torch.apps.set_operations \\
        [--demo all|ops|rakovic|darup|mayne] [--no-figures]

Host-only float64 NumPy on the port's own ``utils`` and ``sets``; nothing
runs on the device.

* ``ops``     - Minkowski sum, Pontryagin difference, matrix scaling
                (``Example of Several Set Operations.py``)
* ``rakovic`` - Rakovic Fig. 1 mRPI approximation, K=[1.17,1.03],
                eps=1.9e-5 (``Example of Approximation of mRPI_Rakovic.py``)
* ``darup``   - Darup Fig. 3 RPI with the k* = 5/6/10 known answers
                (``Example of Approximation of mRPI_Darup.py:50-55``)
* ``mayne``   - Mayne Fig. 2 terminal-set construction: tighten, build XU,
                Gilbert-Tan, Xf + Z
                (``Example of Output Admissible Set Calculation.py``)

Each demo runs the JAX app's checks and draws its sets under
``results/rtmpc_tpu_torch/`` (matplotlib; ``--no-figures`` to skip them).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..sets import (determine_mrpi, max_admissible_set, mrpi_rakovic,
                    rpi_darup, tighten_constraints)
from ..utils import (Polytope, box, contains, intersect, mink_sum,
                     poly_equal, poly_subset, pont_diff, scale)
from ..utils.synthesis import dlqr
from .common import add_figure_args, check, figures_on, savefig

# the double integrator of the Darup and Mayne examples
A_DI = np.array([[1.0, 1.0], [0.0, 1.0]])
B_DI = np.array([[0.5], [1.0]])


def _ordered_vertices(poly: Polytope) -> np.ndarray:
    """The vertices of a 2-D polytope in angular order around their mean."""
    V = poly.get_vertices()
    order = np.argsort(np.arctan2(V[:, 1] - V[:, 1].mean(),
                                  V[:, 0] - V[:, 0].mean()))
    return V[order]


def area(poly: Polytope) -> float:
    """The area of a 2-D polytope (shoelace formula on its vertices)."""
    V = _ordered_vertices(poly)
    x, y = V[:, 0], V[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _plot_polys(polys_labels, name, figures: bool):
    if not figures:
        return
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 5))
    for poly, label in polys_labels:
        V = _ordered_vertices(poly)
        V = np.vstack([V, V[:1]])
        ax.plot(V[:, 0], V[:, 1], label=label)
    ax.legend()
    ax.grid()
    savefig(fig, name)


def demo_ops(figures: bool) -> dict:
    P1 = box(np.array([2.0, 2.0]))
    P2 = box(np.array([1.0, 1.0]))
    S = mink_sum(P1, P2)
    D = pont_diff(P1, P2)
    ok = check("mink_sum(box2, box1) == box3",
               poly_equal(S, box(np.array([3.0, 3.0]))))
    ok &= check("pont_diff(box2, box1) == box1",
                poly_equal(D, box(np.array([1.0, 1.0]))))
    th = np.pi / 6
    Rm = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    Rot = scale(P2, Rm)
    ok &= check("matrix scale preserves volume (rotation)",
                abs(area(Rot) - area(P2)) < 1e-6)
    _plot_polys([(P1, "P1"), (P2, "P2"), (S, "P1+P2"), (D, "P1-P2"),
                 (Rot, "R P2")], "set_operations.png", figures)
    return dict(ok=ok, sets={"P1+P2": S, "P1-P2": D, "R P2": Rot})


def demo_rakovic(figures: bool) -> dict:
    B = np.array([[1.0], [1.0]])
    K = np.array([[1.17, 1.03]])
    Acl = np.array([[1.0, 1.0], [0.0, 1.0]]) - B @ K
    W = box(np.array([1.0, 1.0]))
    Z, status = mrpi_rakovic(Acl, W, eps_var=1.9e-5, s_max=60)
    ok = check("Rakovic mRPI converged", status == 0)
    AZ_W = mink_sum(scale(Z, Acl), W)
    ok &= check("invariance Acl Z + W inside Z (within eps)",
                poly_subset(AZ_W, Z, tol=1e-3))
    _plot_polys([(Z, "F_inf (eps=1.9e-5)"), (W, "W")],
                "rakovic_mrpi.png", figures)
    return dict(ok=ok, sets={"F_inf": Z})


def demo_darup(figures: bool) -> dict:
    W = box(np.array([0.1, 0.1]))
    X = Polytope(np.vstack([np.eye(2), -np.eye(2)]),
                 np.array([4.0, 2.0, 8.0, 4.0]))
    U = box(np.array([1.0]))
    K, _, _ = dlqr(A_DI, B_DI, np.eye(2), np.eye(1))
    Acl = A_DI - B_DI @ K
    ok, polys, sets = True, [], {}
    for eps, want in [(1e-1, 5), (1e-2, 6), (1e-3, 10)]:
        rpi, status = rpi_darup(Acl, W, X, U, K, eps_var=eps, s_max=50)
        ok &= check(f"Darup eps={eps:g} -> k*={want}",
                    status == 0 and rpi._k_star == want,
                    f"got k*={getattr(rpi, '_k_star', None)}")
        polys.append((rpi, f"P_inf eps={eps:g}"))
        sets[f"P_inf eps={eps:g}"] = rpi
    _plot_polys(polys, "darup_rpi.png", figures)
    return dict(ok=ok, sets=sets)


def demo_mayne(figures: bool) -> dict:
    K, _, _ = dlqr(A_DI, B_DI, np.eye(2), 0.01 * np.eye(1))
    Acl = A_DI - B_DI @ K
    X = Polytope(np.array([[0.0, 1.0], [0.0, -1.0],
                           [1.0, 0.0], [-1.0, 0.0]]),
                 np.array([2.0, 50.0, 50.0, 50.0]))
    U = box(np.array([1.0]))
    W = box(np.array([0.1, 0.1]))
    Z = determine_mrpi(Acl, W)
    Xc, Uc = tighten_constraints(X, U, Z, K)
    # the tightened state constraints and the input ones under u = -K x
    XU = intersect(Xc, Polytope(-Uc.A @ K, Uc.b))
    Xf = max_admissible_set(Acl, XU)
    XfpZ = mink_sum(Xf, Z)
    ok = check("Xf invariant under Acl",
               poly_subset(scale(Xf, Acl), Xf, tol=1e-6))
    ok &= check("Xf inside tightened constraints", poly_subset(Xf, XU))
    ok &= check("Xf + Z inside X", poly_subset(XfpZ, X, tol=1e-6))
    ok &= check("origin in Xf", contains(Xf, np.zeros(2)))
    _plot_polys([(X, "X"), (Xf, "Xf"), (XfpZ, "Xf+Z"), (Z, "Z")],
                "mayne_sets.png", figures)
    return dict(ok=ok, sets={"Z": Z, "Xf": Xf, "Xf+Z": XfpZ})


DEMOS = {"ops": demo_ops, "rakovic": demo_rakovic, "darup": demo_darup,
         "mayne": demo_mayne}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--demo", default="all", choices=["all", *DEMOS])
    return add_figure_args(p).parse_args(argv)


def run(args) -> dict:
    """Run the demos; returns ``ok`` and each demo's result (its ``ok``
    and its sets) by name."""
    figures = figures_on(args)
    names = list(DEMOS) if args.demo == "all" else [args.demo]
    out = {}
    for name in names:
        print(f"--- {name} ---")
        out[name] = DEMOS[name](figures)
    return dict(ok=all(r["ok"] for r in out.values()), demos=out)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
