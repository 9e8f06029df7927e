"""Traffic kind ``tick``: one served controller ticking back to back.

The program's served session (``rtmpc_tpu_torch.parallel.session.Session``
at one tick a call: on the card one replay of a one-tick CUDA graph) runs
the controller of the configuration for one instance.  A tick is timed on
the host clock from before its inputs are copied into the session to after
the synchronize that follows the replay, as the program's
``latency.measure_step_latencies`` times one; the quantity ``tick_p99_ms``
is the 99th percentile over every tick of the window.

The inputs are the served session's own kind, made on the device from the
seed at set-up: a setpoint level on ``x_1`` drawn in ``level_range`` every
``level_every`` ticks, the delivery flags at loss ``loss`` both ways (the
first tick delivered), the disturbances uniform in the configuration's
``W``.  The controller serves episodes of ``episode`` ticks from ``x0``
(the session reset between two ticks), the ``e``-th on input set ``e mod
pool``.  After each tick, outside its timing, its outputs are copied aside
by input set; the check compares ``sample`` input sets whose latest
episode the window completed.  The session's reset and the copies end in
a synchronize, so each tick starts on an idle device, as a tick of a
deployed controller does.

Set-up builds the session (the graph's capture) and runs ``warmup_ticks``
ticks as the window runs them, then resets.  The traced run profiles the
ticks ``trace.start`` to ``trace.start + trace.chunks``; the device's
share of a tick is read from that profile, the tick's span (``harness.
tick``) naming which of its operations are the tick's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.check import Answer
from benchmark.harness import Window
from benchmark.measure import quantile
from benchmark.trace import Profiled


def run(ctx) -> Window:
    from rtmpc_tpu_torch.parallel.session import Session

    p, dev = ctx.cell.traffic, ctx.device
    E, P = p["episode"], p["pool"]
    dt = ctx.arrays.A.dtype
    nx, nu = ctx.cfg.nx, ctx.cfg.nu
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    n_lv = -(-E // p["level_every"])
    lo, hi = p["level_range"]
    levels = lo + (hi - lo) * torch.rand((P, n_lv), generator=gen,
                                         device=dev, dtype=torch.float64)
    refs = torch.zeros(P, E, nx, dtype=dt, device=dev)
    refs[..., 0] = levels.repeat_interleave(p["level_every"], 1)[:, :E]

    def flags():
        f = (torch.rand((P, E), generator=gen, device=dev) >= p["loss"]
             ).to(torch.int32)
        f[:, 0] = 1
        return f
    theta, gamma = flags(), flags()
    w_box = torch.tensor(ctx.cell.config["plant"]["w_box"],
                         dtype=torch.float32, device=dev)
    w = ((2 * torch.rand((P, E, nx), generator=gen, device=dev) - 1)
         * w_box).to(dt)
    x0 = np.array(p["x0"], float)

    session = Session(ctx.arrays, ctx.cfg, 1, x0)
    rec = {"x": torch.zeros(P, E, nx, dtype=dt, device=dev),
           "u": torch.zeros(P, E, nu, dtype=dt, device=dev),
           "x_nom": torch.zeros(P, E, nx, dtype=dt, device=dev),
           "Theta": torch.zeros(P, E, dtype=torch.int32, device=dev),
           "feasible": torch.zeros(P, E, dtype=torch.bool, device=dev)}
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    complete = [False] * P

    def tick(i, lat):
        e, j = divmod(i, E)
        s = e % P
        if j == 0:
            session.reset()
            complete[s] = False
            ctx.sync()
        t0 = time.perf_counter()
        with ctx.span("tick"):
            out = session.advance(refs[s, j:j + 1], w[s, j:j + 1],
                                  theta[s, j:j + 1], gamma[s, j:j + 1])
            ctx.sync()
        lat.append(time.perf_counter() - t0)
        with ctx.span("record"):
            for key in ("x", "u", "x_nom", "Theta", "feasible"):
                rec[key][s, j] = getattr(out, key)[0, 0]
            failed.add_((~out.feasible).sum())
            ctx.sync()
        if j == E - 1:
            complete[s] = True

    warm = []
    for i in range(p["warmup_ticks"]):
        tick(i, warm)
    ctx.sync()
    complete[:] = [False] * P
    failed.zero_()

    trace_at = ctx.cell.workload["trace"]
    first, last = trace_at["start"], trace_at["start"] + trace_at["chunks"]
    lat, prof, prof_wall = [], None, 0.0
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    i = 0
    while True:
        if ctx.trace and i == first:
            t_prof = time.perf_counter()
            prof = Profiled(ctx.sync).__enter__()
        tick(i, lat)
        i += 1
        if prof is not None and i == last:
            prof.__exit__(None, None, None)
            prof_wall = time.perf_counter() - t_prof
        # the profiled ticks and the profiler's processing are no part of
        # the window's length: a traced run holds the ticks of an untraced
        if time.perf_counter() - t_start - prof_wall >= ctx.seconds and (
                not ctx.trace or i >= last):
            break
    t_end = time.perf_counter()

    done = [s for s in range(P) if complete[s]]
    rng = np.random.default_rng(ctx.seed)
    picked = sorted(rng.choice(done, min(len(done),
                                         ctx.cell.workload["sample"]
                                         ["episodes"]), replace=False))
    host = {key: (v.double() if v.is_floating_point() else v).cpu().numpy()
            for key, v in rec.items()}
    th, gm = theta.cpu().numpy(), gamma.cpu().numpy()
    w_h, refs_h = w.cpu().double().numpy(), refs.cpu().double().numpy()
    answers = [Answer(x0, refs_h[s], w_h[s], th[s], gm[s], host["x"][s],
                      host["u"][s], host["x_nom"][s], host["Theta"][s],
                      host["feasible"][s, -1]) for s in picked]
    lat_ms = np.array(lat) * 1e3
    window_s = t_end - t_start
    out_spans = {"window_s": window_s, "tick_median_ms": quantile(lat_ms, .5)}
    return Window(
        quantities={"tick_p99_ms": quantile(lat_ms, 0.99),
                    "setup_s": setup_s},
        answers=answers, attempted=i, failed=int(failed),
        counters={"ticks": i}, spans=out_spans, profiled=prof,
        steps_profiled=trace_at["chunks"] if prof else 0)
