"""The benchmark's arithmetic: rates over a window and quantiles."""

from __future__ import annotations

import numpy as np

__all__ = ["window_rate", "quantile"]


def window_rate(work: float, t_start: float, t_end: float) -> float:
    """Work done per second over a window that ran from ``t_start`` to
    ``t_end`` (host clock, seconds): ``t_end`` is read after the
    synchronize that ends the window's last chunk, so the rate counts the
    whole of every chunk and no part of one is left out at the edge."""
    if t_end <= t_start:
        raise ValueError("the window has no length")
    return work / (t_end - t_start)


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by linear interpolation between
    order statistics (NumPy's default, as the reference's latency report
    takes it)."""
    return float(np.quantile(np.asarray(values, float), q))

