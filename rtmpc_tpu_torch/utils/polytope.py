"""Host-side polytope toolbox (float64 NumPy).

The port's own copy of the setup-time set calculus of
``rtmpc_tpu/utils/polytope.py``, restricted to what the controller setups
of ``models/specs.py`` reach: it runs once per scenario on the host and
produces static-shape H-representations that are later padded and moved
to the device.  The algorithms follow the Kolmanovsky-Gilbert
support-function calculus, statement for statement as in the JAX package,
so both packages freeze bit-identical problem data
(``tests/test_torch_utils.py``).

* ``Polytope`` carries an H-rep ``{x: Ax<=b}`` and a lazily computed,
  cached V-rep.
* ``support`` uses the cached V-rep (one matvec + max) when available and
  an LP otherwise; ``support_many`` batches it over many directions, the
  workhorse of the mRPI iterations.
* Vertex enumeration (``extreme``) uses polar duality + Qhull.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import scipy.optimize as sopt
import scipy.spatial as sspatial

__all__ = [
    "Polytope", "box", "support", "support_many", "pont_diff", "mink_sum",
    "scale", "convex_hull", "extreme", "reduce_poly", "contains",
    "poly_subset", "poly_equal", "chebyshev_center",
]

_LP_METHOD = "highs"
_DEFAULT_TOL = 1e-9


@dataclasses.dataclass
class Polytope:
    """Convex polytope ``{x : A x <= b}`` with optional cached vertices.

    ``A`` is (m, d), ``b`` is (m,), ``vertices`` is (nv, d) rows-as-vertices
    (same convention as the reference / ``pc.extreme``).
    """

    A: np.ndarray
    b: np.ndarray
    vertices: Optional[np.ndarray] = None

    def __post_init__(self):
        self.A = np.atleast_2d(np.asarray(self.A, dtype=np.float64))
        self.b = np.asarray(self.b, dtype=np.float64).reshape(-1)
        if self.A.shape[0] != self.b.shape[0]:
            raise ValueError(
                f"A has {self.A.shape[0]} rows but b has {self.b.shape[0]}")
        if self.vertices is not None:
            self.vertices = np.atleast_2d(
                np.asarray(self.vertices, dtype=np.float64))

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    @property
    def nrows(self) -> int:
        return self.A.shape[0]

    def copy(self) -> "Polytope":
        return Polytope(
            self.A.copy(), self.b.copy(),
            None if self.vertices is None else self.vertices.copy())

    def get_vertices(self) -> np.ndarray:
        """Vertex enumeration with caching (lazy V-rep)."""
        if self.vertices is None:
            self.vertices = extreme(self)
        return self.vertices

    def __contains__(self, x) -> bool:
        return contains(self, x)

    def __eq__(self, other) -> bool:  # set equality, like pc.Polytope.__eq__
        if not isinstance(other, Polytope):
            return NotImplemented
        return poly_equal(self, other)

    def __repr__(self):
        return f"Polytope(dim={self.dim}, rows={self.nrows})"


def box(lo, hi=None) -> Polytope:
    """Axis-aligned box ``{x : lo <= x <= hi}``; ``box(r)`` gives ``|x|<=r``.

    Row order matches the reference convention ``[I; -I]`` with
    ``b = [hi; -lo]`` (e.g. the W/X/U boxes in
    ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py:38-52``).
    """
    lo = np.asarray(lo, dtype=np.float64).reshape(-1)
    if hi is None:
        hi = lo
        lo = -lo
    else:
        hi = np.asarray(hi, dtype=np.float64).reshape(-1)
    d = lo.shape[0]
    A = np.vstack([np.eye(d), -np.eye(d)])
    b = np.concatenate([hi, -lo])
    return Polytope(A, b)


# ---------------------------------------------------------------------------
# Support functions
# ---------------------------------------------------------------------------

def support_lp_batch(A: np.ndarray, b: np.ndarray,
                     X: np.ndarray, on_fail: str = "raise") -> np.ndarray:
    """``h[j] = max{X[j] @ y : A y <= b}`` by dense LP, one per row of X.

    Uses the native batched simplex library (``native/rtmpc_lp.cpp``, see
    ``_native.py``) when available, scipy/HiGHS otherwise.  Unbounded
    directions return ``+inf``.  A failed LP (infeasible / numerically
    degenerate) raises by default; ``on_fail="nan"`` returns NaN for that
    row instead so callers can apply a conservative fallback per row.
    """
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    from ._native import native_available, support_batch_native
    if native_available():
        h, status = support_batch_native(A, b, X)
        bad = status == 2
        if not np.any(bad):
            return h
        # fall through to scipy only for the failed rows (robustness)
        for i in np.where(bad)[0]:
            h[i] = _support_scipy(A, b, X[i], on_fail)
        return h
    return np.array([_support_scipy(A, b, x, on_fail) for x in X])


def _support_scipy(A, b, x, on_fail: str = "raise") -> float:
    res = sopt.linprog(c=-x, A_ub=A, b_ub=b,
                       bounds=(None, None), method=_LP_METHOD)
    if res.status == 3:        # unbounded
        return np.inf
    if res.status != 0:
        if on_fail == "nan":
            return np.nan
        raise RuntimeError(
            f"support LP failed with status {res.status}: {res.message}")
    return float(-res.fun)


def support(poly: Polytope, x: np.ndarray, use_vrep: bool = True) -> float:
    """Support function ``h_P(x) = max{ x^T y : A y <= b }``.

    Reference: ``utils_polytope.py:12-23`` (one LP per call).  Here: if the
    V-rep is cached the LP collapses to ``max(V @ x)``; otherwise one
    native-kernel (or scipy) LP.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    if use_vrep and poly.vertices is not None:
        return float(np.max(poly.vertices @ x))
    return float(support_lp_batch(poly.A, poly.b, x[None])[0])


def support_many(poly: Polytope, X: np.ndarray,
                 force_vertices: bool = False) -> np.ndarray:
    """Batched support function over directions in the *rows* of ``X``.

    This is the hot call of the mRPI algorithms (each iteration needs the
    support of W in many directions).  If the polytope is bounded we
    enumerate its vertices once and evaluate all supports with a single
    matmul; otherwise we use one batched-LP kernel call.
    """
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    if force_vertices or poly.vertices is not None:
        V = poly.get_vertices()
        return np.max(X @ V.T, axis=1)
    try:
        V = poly.get_vertices()
        return np.max(X @ V.T, axis=1)
    except (ValueError, sspatial.QhullError):
        # Expected failure modes of vertex enumeration: empty / degenerate
        # (``extreme`` raises ValueError) or Qhull precision trouble.  The
        # LP path still answers these exactly (or raises on a genuinely
        # empty set); anything else propagates.
        return support_lp_batch(poly.A, poly.b, X)


# ---------------------------------------------------------------------------
# Set algebra
# ---------------------------------------------------------------------------

def pont_diff(poly1: Polytope, poly2: Polytope) -> Polytope:
    """Pontryagin difference ``P1 - P2 = {x : x + y in P1 for all y in P2}``.

    Kolmanovsky–Gilbert Thm 3.2: per-row support offsets
    ``b1_i - h_{P2}(A1_i)``.  Reference: ``utils_polytope.py:25-38``.
    """
    offs = support_many(poly2, poly1.A)
    return Polytope(poly1.A.copy(), poly1.b - offs)


def mink_sum(poly1: Polytope,
             poly2: Union[Polytope, np.ndarray]) -> Polytope:
    """Minkowski sum ``P1 + P2``.

    ``poly2`` may be a Polytope, a single translation vector (1-D array), or
    a (nv, d) matrix of vertices.  Reference: ``utils_polytope.py:40-113``.
    Translation by a vector stays in H-rep (``b + A @ v``); polytope/vertex
    sums go through pairwise vertex sums + convex hull.
    """
    if isinstance(poly2, Polytope):
        V2 = poly2.get_vertices()
    else:
        arr = np.asarray(poly2, dtype=np.float64)
        if arr.ndim == 1:
            # Pure translation: H-rep shift, vertices shift too.
            v = arr.reshape(-1)
            verts = (None if poly1.vertices is None
                     else poly1.vertices + v[None, :])
            return Polytope(poly1.A.copy(), poly1.b + poly1.A @ v, verts)
        elif arr.ndim == 2:
            V2 = arr
        else:
            raise ValueError("poly2 array must be 1-D (vector) or 2-D "
                             "(vertex matrix)")
    V1 = poly1.get_vertices()
    # All pairwise vertex sums; the hull discards interior points.
    Vsum = (V1[:, None, :] + V2[None, :, :]).reshape(-1, V1.shape[1])
    return convex_hull(Vsum)


def scale(poly: Polytope, s: Union[float, np.ndarray]) -> Polytope:
    """Scale a polytope by a scalar or map it through a matrix ``M``.

    Scalar: ``s*P = {s*x : x in P}`` (b-scaling for s>0; singleton at the
    origin for s=0; A-scaling for s<0).  Matrix: image ``M P`` via vertex
    mapping + hull.  Reference: ``utils_polytope.py:115-158``.
    """
    s_arr = np.asarray(s)
    if s_arr.ndim == 0:
        sv = float(s_arr)
        if sv == 1.0:
            return poly.copy()
        if sv == 0.0:
            d = poly.dim
            return Polytope(np.vstack([np.eye(d), -np.eye(d)]),
                            np.zeros(2 * d))
        if sv > 0:
            verts = None if poly.vertices is None else sv * poly.vertices
            return Polytope(poly.A.copy(), sv * poly.b, verts)
        # negative scalar: {s x : Ax<=b} = {y : (A/s) y <= b}
        verts = None if poly.vertices is None else sv * poly.vertices
        return Polytope(poly.A / sv, poly.b.copy(), verts)
    M = np.atleast_2d(s_arr.astype(np.float64))
    V = poly.get_vertices()
    Vout = V @ M.T
    if Vout.shape[1] == 1 or np.linalg.matrix_rank(Vout - Vout[0]) < Vout.shape[1]:
        # Degenerate image (e.g. K Z for a 1-D input space): keep as interval
        # box in each coordinate if 1-D, else fall back to qhull with jitter.
        if Vout.shape[1] == 1:
            lo, hi = float(Vout.min()), float(Vout.max())
            return Polytope(np.array([[1.0], [-1.0]]), np.array([hi, -lo]),
                            np.array([[lo], [hi]]))
        raise ValueError("matrix scale produced a degenerate (lower-"
                         "dimensional) polytope; not representable in H-rep")
    return convex_hull(Vout)


def convex_hull(vertices: np.ndarray) -> Polytope:
    """V-rep -> H-rep via Qhull; 1-D handled directly.

    Reference: ``utils_polytope.py:160-178``.
    """
    vertices = np.atleast_2d(np.asarray(vertices, dtype=np.float64))
    if vertices.shape[1] == 1:
        lo, hi = float(vertices.min()), float(vertices.max())
        return Polytope(np.array([[1.0], [-1.0]]), np.array([hi, -lo]),
                        np.array([[lo], [hi]]))
    hull = sspatial.ConvexHull(vertices)
    eq = hull.equations  # rows [a, c] with a@x + c <= 0 inside
    A = eq[:, :-1]
    b = -eq[:, -1]
    vout = vertices[hull.vertices, :]
    return Polytope(A, b, vout)


def extreme(poly: Polytope, tol: float = 1e-9) -> np.ndarray:
    """Vertex enumeration of a bounded H-rep polytope (rows are vertices).

    Polar-duality method: translate so the Chebyshev center is the origin,
    the polar dual's vertices are ``A_i / b_i``, its facets (via Qhull)
    correspond to the primal's vertices.  Replaces ``pc.extreme``.
    """
    d = poly.dim
    if d == 1:
        hi = support(poly, np.array([1.0]), use_vrep=False)
        lo = -support(poly, np.array([-1.0]), use_vrep=False)
        return np.array([[lo], [hi]])
    c, r = chebyshev_center(poly)
    if not np.isfinite(r) or r < -tol:
        raise ValueError("polytope is empty; cannot enumerate vertices")
    bshift = poly.b - poly.A @ c
    if np.any(bshift <= tol):
        # Chebyshev center on the boundary => degenerate/flat polytope.
        raise ValueError("polytope is degenerate (no interior); vertex "
                         "enumeration in H-rep requires full dimension")
    D = poly.A / bshift[:, None]  # dual points
    hull = sspatial.ConvexHull(D, qhull_options="QJ Pp")
    eq = hull.equations
    a = eq[:, :-1]
    cpart = eq[:, -1]
    # Each dual facet {y: a@y + c = 0} maps to primal vertex -a/c.
    with np.errstate(divide="ignore", invalid="ignore"):
        verts = -a / cpart[:, None]
    verts = verts[np.isfinite(verts).all(axis=1)]
    verts = verts + c[None, :]
    # Dedupe and keep only actual extreme points via a second hull.
    if verts.shape[0] > d:
        try:
            hull2 = sspatial.ConvexHull(verts, qhull_options="QJ Pp")
            verts = verts[hull2.vertices]
        except Exception:
            pass
    return _dedupe_rows(verts)


def _dedupe_rows(V: np.ndarray, decimals: int = 9) -> np.ndarray:
    if V.shape[0] == 0:
        return V
    _, idx = np.unique(np.round(V, decimals=decimals), axis=0,
                       return_index=True)
    return V[np.sort(idx)]


def chebyshev_center(poly: Polytope):
    """Largest inscribed ball: returns (center, radius) via one LP."""
    norms = np.linalg.norm(poly.A, axis=1)
    d = poly.dim
    # variables [x (d), r]; maximize r s.t. A x + ||a_i|| r <= b
    c = np.zeros(d + 1)
    c[-1] = -1.0
    A_ub = np.hstack([poly.A, norms[:, None]])
    res = sopt.linprog(c=c, A_ub=A_ub, b_ub=poly.b,
                       bounds=[(None, None)] * d + [(0, None)],
                       method=_LP_METHOD)
    if res.status != 0:
        return np.full(d, np.nan), -np.inf
    return res.x[:d], float(res.x[-1])


# ---------------------------------------------------------------------------
# Redundancy removal, containment
# ---------------------------------------------------------------------------

def reduce_poly(poly: Polytope, tol: float = 1e-9,
                angular_tol: float = 0.0,
                slack_tol: float = 0.0) -> Polytope:
    """Remove redundant rows (LP per candidate row). Replaces ``pc.reduce``.

    Row i is redundant iff ``max{A_i x : all other rows} <= b_i``.
    Rows are first normalized and exact duplicates dropped.

    Epsilon mode (outer approximation, set can only GROW by <= the given
    slack): ``angular_tol > 0`` merges rows whose normalized directions
    satisfy ``1 - cos(angle) < angular_tol`` keeping the tightest offset
    (mRPI approximations produce near-duplicate directions — cosines of
    1-1e-15 — which are exactly-irredundant but degenerate the QP duals and
    stall ADMM); ``slack_tol > 0`` additionally drops rows violated by at
    most ``slack_tol`` (epsilon-redundant rows).
    """
    A, b = poly.A.copy(), poly.b.copy()
    norms = np.linalg.norm(A, axis=1)
    keepmask = norms > tol
    A, b, norms = A[keepmask], b[keepmask], norms[keepmask]
    A = A / norms[:, None]
    b = b / norms
    # Drop duplicate rows (keep the tightest b).
    order = np.lexsort(np.round(np.column_stack([A, b]), 10).T)
    A, b = A[order], b[order]
    uniq = []
    for i in range(A.shape[0]):
        if uniq and np.allclose(A[uniq[-1]], A[i], atol=1e-10):
            if b[i] < b[uniq[-1]]:
                uniq[-1] = i
        else:
            uniq.append(i)
    A, b = A[uniq], b[uniq]

    if angular_tol > 0.0 and A.shape[0] > 1:
        # Greedy direction clustering: keep the tightest row per cluster.
        taken = np.zeros(A.shape[0], dtype=bool)
        rows_a, rows_b = [], []
        order2 = np.argsort(b)  # tightest offsets claim clusters first
        for i in order2:
            if taken[i]:
                continue
            cos = A @ A[i]
            members = (1.0 - cos < angular_tol) & ~taken
            taken |= members
            rows_a.append(A[i])
            rows_b.append(b[members].min())
        A = np.vstack(rows_a)
        b = np.asarray(rows_b)

    keep = np.ones(A.shape[0], dtype=bool)
    for i in range(A.shape[0]):
        mask = keep.copy()
        mask[i] = False
        if not mask.any():
            continue
        # A failed LP (degenerate/ill-conditioned polytope) returns NaN;
        # the NaN comparison below is False, so the row is conservatively
        # KEPT (redundant rows are harmless; dropped essential rows are not).
        sup = support_lp_batch(A[mask], b[mask] + tol, A[i][None],
                               on_fail="nan")[0]
        if np.isfinite(sup) and sup <= b[i] + max(tol, slack_tol):
            keep[i] = False
    return Polytope(A[keep], b[keep])


def contains(poly: Polytope, x, tol: float = 1e-7) -> bool:
    """Point membership ``x in P`` (the reference uses ``x in Z`` checks,
    e.g. ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py:169-184``)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    return bool(np.all(poly.A @ x <= poly.b + tol))


def poly_subset(p: Polytope, q: Polytope, tol: float = 1e-7) -> bool:
    """``P ⊆ Q`` iff for every row (a, c) of Q: ``h_P(a) <= c``.

    A failed per-row LP (NaN) conservatively answers "not contained", so
    degenerate inputs keep fixed-point iterations (Gilbert–Tan) running
    rather than crashing or terminating early on a false equality.
    """
    sup = support_lp_batch(p.A, p.b, q.A, on_fail="nan")
    return bool(np.all(sup <= q.b + tol))


def poly_equal(p: Polytope, q: Polytope, tol: float = 1e-7) -> bool:
    """Set equality via mutual containment (used by the Gilbert–Tan fixed-
    point test; the reference relies on ``pc.Polytope.__eq__``)."""
    return poly_subset(p, q, tol) and poly_subset(q, p, tol)
