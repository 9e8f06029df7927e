"""Per-step solve-latency measurement, the reference's methodology
(counterpart of ``rtmpc_tpu/parallel/latency.py``).

The reference wraps every solve in wall-clock timing and reports a
histogram and max/95/90/75/median/mean over the individual solves
(``results_linear_system.py:304-320``).  A batched engine amortizes
thousands of QPs a dispatch, so a time a solve derived from its throughput
is no latency a deployed single-instance controller would see.

* ``measure_step_latencies``: one dispatch a control tick, the carry kept
  on the device between ticks (a one-tick ``Session``: on the card one
  graph replay and one synchronize a tick), each tick timed on the host
  clock, dispatch included.
* ``device_step_time``: the device time of a tick from CUDA events around
  a chained window (one graph replay of T ticks, batch 1).
* ``dispatch_floor_s``: the host time of replaying a graph that holds one
  tiny kernel, plus a synchronize: what any dispatch costs on this host.
* ``latency_report``: the reference's quantile report and histogram,
  copied from the JAX package.

The timing functions need a CUDA device and raise without one, except
``measure_step_latencies``, which on a CPU device times the eager ticks.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .session import Session

__all__ = ["measure_step_latencies", "device_step_time", "dispatch_floor_s",
           "latency_report"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _require_cuda(device, what):
    if device.type != "cuda":
        raise RuntimeError(f"{what} times the card: it needs tensors on a "
                           f"CUDA device, got {device}")


def _window_inputs(refs, w, theta, gamma, device, dtype):
    return (torch.as_tensor(refs, dtype=dtype).to(device),
            torch.as_tensor(w, dtype=dtype).to(device),
            torch.as_tensor(theta, dtype=torch.int32).to(device),
            torch.as_tensor(gamma, dtype=torch.int32).to(device))


def measure_step_latencies(arrays, cfg, refs, w, theta, gamma, x0=None,
                           actuator_mode: str = "consistent") -> np.ndarray:
    """Wall-clock latencies [s] of a T-tick closed loop from ``x0`` (zero
    if None), one dispatch a tick, under ``actuator_mode``.  ``refs``/``w``
    ``(T, nx)``, ``theta``/``gamma`` ``(T,)``.  The carry (estimator,
    actuator, warm starts) stays on the device between ticks, so the
    trajectory is the windowed one's; only the granularity differs (the
    estimator's state is O(1), so no buffer has to span the experiment).
    Any solver: on the card each tick is one replay of the one-tick graph,
    the interior points' loops included (they run their whole iteration
    budget there, ``ops/ip_riccati.py``).  One untimed tick (the first
    replay) comes first, and the carry is reset after it."""
    dev, dt = arrays.A.device, arrays.A.dtype
    refs, w, theta, gamma = _window_inputs(refs, w, theta, gamma, dev, dt)
    T = refs.shape[0]
    session = Session(arrays, cfg, 1,
                      torch.zeros(cfg.nx) if x0 is None else x0,
                      actuator_mode=actuator_mode)
    session.advance(refs[:1], w[:1], theta[:1], gamma[:1])
    _sync(dev)
    session.reset()
    times = np.empty(T)
    for t in range(T):
        t0 = time.perf_counter()
        session.advance(refs[t:t + 1], w[t:t + 1], theta[t:t + 1],
                        gamma[t:t + 1])
        _sync(dev)
        times[t] = time.perf_counter() - t0
    return times


def device_step_time(arrays, cfg, refs, w, theta, gamma) -> float:
    """The device time [s] of a tick: CUDA events around each of five
    replays of a T-tick window graph from x0 = 0 (the carry reset before
    each, so every replay does the same work), median over the replays,
    divided by T: the window's time on the device alone (its input copies
    included), without the host's dispatch and synchronize."""
    dev, dt = arrays.A.device, arrays.A.dtype
    _require_cuda(dev, "device_step_time")
    refs, w, theta, gamma = _window_inputs(refs, w, theta, gamma, dev, dt)
    T = refs.shape[0]
    chain = Session(arrays, cfg, T, torch.zeros(cfg.nx))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    window_ms = []
    for _ in range(5):
        chain.reset()
        start.record()
        chain.advance(refs, w, theta, gamma)
        end.record()
        torch.cuda.synchronize(dev)
        window_ms.append(start.elapsed_time(end))
    return float(np.median(window_ms)) / 1e3 / T


def dispatch_floor_s(device) -> float:
    """Median host time over 20 replays of a graph of one tiny kernel,
    each with a synchronize: the floor under any one-dispatch-a-tick
    latency."""
    device = torch.device(device)
    _require_cuda(device, "dispatch_floor_s")
    v = torch.zeros((), device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        v.add_(1.0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v.add_(1.0)
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def latency_report(times_s: np.ndarray, label: str = "",
                   budget_ms: Optional[float] = 20.0) -> dict:
    """The reference's quantile report (``results_linear_system.py:304-320``)
    over REAL per-solve measurements, plus its histogram counts
    (bins 2.5..20 ms, clipped, like ``:319``)."""
    ms = np.asarray(times_s, float) * 1e3
    stats = {
        "n_solves": int(ms.size),
        "max_ms": float(np.max(ms)),
        "p99_ms": float(np.quantile(ms, 0.99)),
        "p95_ms": float(np.quantile(ms, 0.95)),
        "p90_ms": float(np.quantile(ms, 0.90)),
        "p75_ms": float(np.quantile(ms, 0.75)),
        "median_ms": float(np.median(ms)),
        "mean_ms": float(np.mean(ms)),
    }
    # the reference's 2.5..20 ms bins (``results_linear_system.py:319``),
    # extended past the observed max so nothing clips into the last bin
    # (round-4 artifacts clipped 50-105 ms solves into "17.5-20", making
    # the stored histogram misrepresent the distribution)
    edges = np.arange(2.5, 20.0 + 2.5, 2.5)
    if ms.max() > edges[-1]:
        extra = np.arange(edges[-1] + 10.0, ms.max() + 10.0, 10.0)
        edges = np.concatenate([edges, extra])
    clipped = np.clip(ms, edges[0], edges[-1])
    hist, _ = np.histogram(clipped, bins=edges)
    stats["hist_bins_ms"] = edges.tolist()
    stats["hist_counts"] = hist.tolist()
    print(f"Solve-time stats{(' (' + label + ')') if label else ''} "
          f"over {stats['n_solves']} solves [ms]: "
          f"max={stats['max_ms']:.3f} p95={stats['p95_ms']:.3f} "
          f"p90={stats['p90_ms']:.3f} p75={stats['p75_ms']:.3f} "
          f"median={stats['median_ms']:.3f} mean={stats['mean_ms']:.3f}")
    if budget_ms is not None:
        ok = stats["p99_ms"] < budget_ms
        print(f"  p99 {stats['p99_ms']:.3f} ms vs {budget_ms:.0f} ms "
              f"real-time budget: {'within' if ok else 'EXCEEDS'}")
    return stats
