"""Host setup toolbox of the port (float64 NumPy, no JAX, no torch):
polytopes and discrete-time synthesis, the port's own copies of
``rtmpc_tpu.utils``."""

from .polytope import (
    Polytope,
    box,
    support,
    support_lp_batch,
    support_many,
    pont_diff,
    mink_sum,
    scale,
    convex_hull,
    extreme,
    reduce_poly,
    contains,
    poly_subset,
    poly_equal,
)
from .synthesis import dlqr, dlyap, c2d

__all__ = [
    "Polytope", "box", "support", "support_lp_batch", "support_many",
    "pont_diff", "mink_sum", "scale", "convex_hull", "extreme",
    "reduce_poly", "contains", "poly_subset", "poly_equal", "dlqr", "dlyap",
    "c2d",
]
