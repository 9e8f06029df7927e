"""Device-resident 50 Hz controller session (counterpart of
``rtmpc_tpu/apps/serve_controller.py``).

    python3 -m rtmpc_tpu_torch.apps.serve_controller --device cuda \\
        [--solver cuda|admm] [--dtype float32] [--ticks 15000] \\
        [--window 150] [--loss-prob 0.4] [--per-dispatch-ticks 120] \\
        [--seed 0]

One continuous closed-loop session of the flagship controller (the
configuration of ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network``:
double integrator, N=10, two-phase ADMM 60+60, fixed initial state), by
default 15,000 ticks = 5 minutes of 50 Hz control from x0 = 0, with loss
0.4 both ways, w in +-0.1 and a piecewise-constant setpoint that changes
every 500 ticks (10 s).  The controller's carry (estimator, actuator, warm
starts) stays on the device; the host streams the setpoints, disturbances
and masks in windows of 150 ticks (3 s), each one dispatch
(``parallel/session.py``: one CUDA graph replay a window on the card).

Prints, with the card's name and power limit:

* the session: ticks/s, the window-mean tick time (a window's wall time,
  input copies and synchronize included, over its ticks) at p50/p99/max
  across windows, the window deadline misses (a window slower than its
  ticks x 20 ms) and the kernel launches (captured a window x replays).
  A window mean hides a slow tick inside its window: the per-dispatch p99
  below is the per-tick tail;
* the same window run eagerly (no graph): its per-tick time, which is what
  the graph buys; and on the card the device time of a tick (CUDA events
  around a replay of the window graph);
* the reference's per-dispatch methodology: one graph replay and one
  synchronize a tick over ``--per-dispatch-ticks`` ticks, its quantile
  report, and the dispatch floor (replay of a one-kernel graph plus a
  synchronize).

Its checks are the JAX app's: the p99 of the window-mean tick time under
the 20 ms budget, zero misses, the session feasible throughout, and
``mean |x1 - ref|`` over the last second under 0.5.  The inputs come from numpy's generator at
``--seed``, as in the JAX app, so both packages serve the same session.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import setup_tube_tracking
from ..ops.kernel_bench import card
from ..ops.qp_cuda import admm_solve_cuda
from ..parallel import make_batched_rollout
from ..parallel.latency import (device_step_time, dispatch_floor_s,
                                latency_report, measure_step_latencies)
from ..parallel.session import Session
from ..tree import tree_map
from ..utils import box
from .common import DI_A, DI_B, check, device_name, make_parser, resolve

BUDGET_MS = 20.0
SCHEDULE = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)


def parse_args(argv=None):
    p = make_parser(__doc__, default_solver="cuda", solvers=("cuda", "admm"))
    p.add_argument("--ticks", type=int, default=15000,
                   help="total control ticks (default 5 min at 50 Hz)")
    p.add_argument("--window", type=int, default=150,
                   help="ticks a device dispatch (3 s at 50 Hz)")
    p.add_argument("--loss-prob", type=float, default=0.4)
    p.add_argument("--per-dispatch-ticks", type=int, default=120,
                   help="ticks of the per-dispatch (reference methodology) "
                        "measurement")
    return p.parse_args(argv)


def flagship():
    """The served controller's setup (the flagship's)."""
    return setup_tube_tracking(
        DI_A, DI_B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)


def session_inputs(seed: int, T: int, p: float):
    """The JAX app's session inputs, from ``np.random.default_rng(seed)``:
    ``refs (T, 2)`` (a level in [-6, 6] every 500 ticks), ``theta``,
    ``gamma`` ``(T,)`` at loss ``p`` (tick 0 delivered), ``w (T, 2)``."""
    rng = np.random.default_rng(seed)
    refs = np.zeros((T, 2))
    levels = rng.uniform(-6, 6, size=(T // 500 + 1,))
    for i in range(len(levels)):
        refs[i * 500:(i + 1) * 500, 0] = levels[i]
    theta = (rng.uniform(size=T) >= p).astype(np.int64)
    gamma = (rng.uniform(size=T) >= p).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(-0.1, 0.1, size=(T, 2))
    return refs, theta, gamma, w


def run(args, setup=None) -> dict:
    """Serve the session and run its checks.  ``setup``: the flagship's
    (``flagship()``) if a caller has it already.  Returns ``ok`` and the
    four ``checks`` by name (``p99``, ``misses``, ``feasible``,
    ``tracks``), the first window's outputs through the session
    (``first``) and eagerly (``first_eager``), both ``StepOutputs``
    ``(1, K, .)``, the last window's states (``last_x``, numpy ``(K,
    2)``), the ``inputs``, the ``session``, ``per_tick_ms`` (the window
    means), ``eager_per_tick_ms``, ``device_per_tick_ms`` (None on the
    CPU), the per-dispatch ``latency`` report, ``floor_ms`` and
    ``misses``."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    setup = setup if setup is not None else flagship()
    arrays, cfg = setup.to_device(dtype, dev, solver=args.solver, **SCHEDULE)
    K = args.window
    n_win = args.ticks // K
    if n_win < 1 or K < 1:
        raise SystemExit("serve_controller: --ticks must be at least "
                         "--window, and --window at least 1")
    T = n_win * K
    refs, theta, gamma, w = session_inputs(args.seed, T, args.loss_prob)
    # the host's copies of the whole session's inputs, streamed a window
    # at a time into the session's static buffers
    inp = (torch.tensor(refs, dtype=dtype), torch.tensor(w, dtype=dtype),
           torch.tensor(theta, dtype=torch.int32),
           torch.tensor(gamma, dtype=torch.int32))
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    if dev.type == "cuda":
        print(card())
    print(f"session: {T} ticks = {T / 50.0:.0f} s of 50 Hz control, "
          f"{n_win} windows x {K} ticks, loss p={args.loss_prob}")

    t0 = time.perf_counter()
    session = Session(arrays, cfg, K, np.zeros(2))
    print(f"window {'graph captured' if session.graph else 'eager (CPU)'} "
          f"in {time.perf_counter() - t0:.2f} s, "
          f"{session.captured_launches} kernel launches a window")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    win_wall = np.empty(n_win)
    t_session = time.perf_counter()
    for iw in range(n_win):
        sl = slice(iw * K, (iw + 1) * K)
        t0 = time.perf_counter()
        outs = session.advance(*(a[sl] for a in inp))
        sync()
        win_wall[iw] = time.perf_counter() - t0
        if iw == 0:
            first = tree_map(torch.clone, outs)
    session_s = time.perf_counter() - t_session
    last_x = outs.x[0].double().cpu().numpy()
    feasible = bool(session.carry.feasible.all())

    per_tick_ms = win_wall / K * 1e3
    p50 = float(np.median(per_tick_ms))
    p99 = float(np.quantile(per_tick_ms, 0.99))
    mx = float(np.max(per_tick_ms))
    misses = int(np.sum(win_wall > K * BUDGET_MS / 1e3))
    rate = T / session_s
    print(f"\ndevice-resident session: {session_s:.3f} s wall for {T} ticks "
          f"-> {rate:,.1f} ticks/s ({rate / 50.0:,.1f}x the 50 Hz "
          f"real-time rate)")
    print(f"window-mean tick time across {n_win} windows [ms]: "
          f"p50={p50:.4f} p99={p99:.4f} max={mx:.4f} (a window's wall time,"
          f" dispatch and copies included, over its {K} ticks)")
    print(f"window deadline misses (window wall > {K} x 20 ms): "
          f"{misses}/{n_win}")
    print(f"kernel launches: {session.launches} ({session.captured_launches}"
          f" a window x {session.replays} replays)")

    # the same first window eagerly, what the graph buys
    rollout = make_batched_rollout(arrays, cfg, K)
    eager_in = [a[:K][None].to(dev) for a in inp]
    x0 = torch.zeros(1, 2, dtype=dtype, device=dev)
    rollout(x0, *eager_in)          # warm-up
    sync()
    before = admm_solve_cuda.launches
    t0 = time.perf_counter()
    _, first_eager = rollout(x0, *eager_in)
    sync()
    eager_ms = (time.perf_counter() - t0) / K * 1e3
    print(f"the first window eagerly: {eager_ms:.4f} ms a tick "
          f"({admm_solve_cuda.launches - before} kernel launches), against "
          f"{per_tick_ms[0]:.4f} ms a tick through the session")
    device_ms = None
    if dev.type == "cuda":
        device_ms = device_step_time(arrays, cfg,
                                     *(a[:K] for a in inp)) * 1e3
        print(f"device time a tick (CUDA events around a replay of the "
              f"first window's graph, median of 5): {device_ms:.4f} ms")

    # the session really controlled something: the last window tracks the
    # final setpoint despite the loss both ways
    final_err = float(np.mean(np.abs(last_x[-50:, 0] - refs[-1, 0])))
    checks = {
        "p99": check("p99 of the window-mean tick time within the 20 ms "
                     "budget", p99 < BUDGET_MS, f"p99 {p99:.4f} ms"),
        "misses": check("zero window deadline misses", misses == 0),
        "feasible": check("session stayed feasible", feasible),
        "tracks": check("closed loop tracks the served setpoint",
                        final_err < 0.5,
                        f"mean |x1 - ref| over last second = "
                        f"{final_err:.3f} (ref {refs[-1, 0]:+.2f})")}

    # per-dispatch granularity (the reference's methodology)
    Tpd = args.per_dispatch_ticks
    lats = measure_step_latencies(arrays, cfg, *(a[:Tpd] for a in inp))
    stats = latency_report(lats, "one dispatch a tick: one graph replay and "
                                 "one synchronize" if dev.type == "cuda"
                           else "one dispatch a tick, eager")
    floor_ms = None
    if dev.type == "cuda":
        floor_ms = dispatch_floor_s(dev) * 1e3
        print(f"  (dispatch floor, replay of a one-kernel graph and a "
              f"synchronize: {floor_ms:.4f} ms)")
    return dict(ok=all(checks.values()), checks=checks, first=first,
                first_eager=first_eager, last_x=last_x, session=session,
                inputs=(refs, theta, gamma, w), per_tick_ms=per_tick_ms,
                eager_per_tick_ms=eager_ms, device_per_tick_ms=device_ms,
                latency=stats, floor_ms=floor_ms, misses=misses)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
