"""Where the time of one closed-loop step goes on the GPU.

    python3 -m rtmpc_tpu_torch.parallel.step_profile [--controller flagship]
        [--solver cuda] [--plant linear] [--batch B] [--steps 10]
        [--session] [--out PATH]

Sets up a controller, runs one warm-up rollout of ``--steps`` steps, then
the same window twice: timed with CUDA events alone, and under
``torch.profiler`` (CPU and CUDA activities).  ``--controller flagship``
(default): the 2-D flagship at the bench's 60+60-iteration schedule,
B=16384.  ``--controller extended``: the cartpole's extended tube-tracking
controller of ``apps/results_linear_extended.py`` (two QPs of 112 + 1648
columns), ``--controller tube`` its tube-tracking one (RT-MPC, the Fig. 3a
arm of ``apps/results_linear.py``), B=200, 70%/70% loss, the apps'
200+200 schedule under ``--solver cuda`` (float32) or the float64
interior point under ``--solver ip_riccati``; ``--plant nonlinear`` steps
the nonlinear cartpole of ``apps/results_nonlinear.py`` in place of the
linear model.  ``--session``
profiles the served session instead: one controller (B=1) in a
``Session`` of one tick a call, ``--steps`` ticks back to back, each its
inputs' copy, one replay of the one-tick graph and a synchronize.

From the profiler's device events it reports, under ``--solver cuda``, the
ADMM kernel's time per launch and its share of the device time; always
the other device operations' count and time per step, the device's busy
share of the profiled window, the program's spans (``spans``, from
``span_breakdown``: each span's count and host time, and the device time
and operations it launched) and what they give (``span_quantities``; the
session's ``tick_copy_in_host_ms`` and ``tick_replay_host_ms``), and
(``plant_*``) the device operations, the device time and the host time of
one call of the plant alone.  Prints one JSON object and, with ``--out``,
also writes it and the kernel table there.  Every time comes from this
run.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

from ..utils.spans import PREFIX as SPAN_PREFIX

ITERS = ITERS2 = 60
ALPHA, RHO2_SCALE = 1.8, 0.2
P_LOSS = 0.7
K1_NAME = "admm_kernel"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _window_ms(fn) -> float:
    """Device-clock span of one call of ``fn`` (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _is_span(e) -> bool:
    """A program span, or its copy on the device's timeline (no
    operation)."""
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(SPAN_PREFIX))


def span_breakdown(events) -> dict:
    """The program's spans (``utils/spans.py``) in a profile's events:
    ``{name: {"count", "host_ms", "device_ms", "device_ops"}}``.

    ``count`` and ``host_ms`` are the spans' own number and host extents
    (the spans nested in them included).  A device operation is credited
    to the innermost span that launched it.  The profiler copies a span
    onto the device's timeline (a user annotation) from the first to the
    last operation launched inside it, by the correlation of each
    operation with its launch, not by the host's clock; on the one stream
    the port runs, every operation between those two was launched inside
    the span.  So each operation goes to the shortest copy that holds it,
    and an operation no copy holds to ``"(no span)"``.  (The profiler's
    ``kernels`` of a host event miss the kernels that K1's library
    launches.)"""
    from torch.autograd import DeviceType
    out = defaultdict(lambda: {"count": 0, "host_ms": 0.0, "device_ms": 0.0,
                               "device_ops": 0})
    copies, ops = defaultdict(list), defaultdict(list)
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(SPAN_PREFIX):
                out[e.name]["count"] += 1
                out[e.name]["host_ms"] += (end - start) / 1e3
        elif not _is_span(e):
            ops[e.device_index].append((start, end))
        elif e.name.startswith(SPAN_PREFIX):
            # by start, the outer of two copies that start together first
            copies[e.device_index].append((start, -end, e.name))
    for dev, dev_ops in ops.items():
        held = sorted(copies[dev])
        stack, i = [], 0
        for start, end in sorted(dev_ops):
            while i < len(held) and held[i][0] <= start:
                stack.append(held[i])
                i += 1
            while stack and -stack[-1][1] < end:
                stack.pop()
            row = out[stack[-1][2] if stack else "(no span)"]
            row["device_ms"] += (end - start) / 1e3
            row["device_ops"] += 1
    return dict(out)


def nested_host_ms(events, outer: str, inner: str) -> float:
    """Host time of the spans named ``inner`` that lie inside a span named
    ``outer`` (the host's spans nest on their thread)."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    outs = sorted((e.time_range.start, e.time_range.end) for e in host
                  if e.name == outer)
    starts = [s for s, _ in outs]
    ms = 0.0
    for e in host:
        if e.name == inner:
            s, end = e.time_range.start, e.time_range.end
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and end <= outs[k][1]:
                ms += (end - s) / 1e3
    return ms


def span_quantities(spans: dict, events, steps: int) -> dict:
    """What the spans give a step or an iteration, each only where its
    spans are: ``protocol_device_ms_per_step``, the device time launched
    inside ``rtmpc.protocol``; ``ip_dispatch_ms_per_iteration``, the host
    time of the ``rtmpc.ip.iteration`` spans less the exit reads inside
    them; ``ip_exit_wait_ms_per_iteration``, the host time of every
    ``rtmpc.ip.exit_read`` (the host blocked on the device), both over the
    number of iteration spans."""
    out = {}
    if "rtmpc.protocol" in spans:
        out["protocol_device_ms_per_step"] = (
            spans["rtmpc.protocol"]["device_ms"] / steps)
    it = spans.get("rtmpc.ip.iteration")
    if it:
        read = spans.get("rtmpc.ip.exit_read", {"host_ms": 0.0})
        out["ip_dispatch_ms_per_iteration"] = (
            it["host_ms"] - nested_host_ms(events, "rtmpc.ip.iteration",
                                           "rtmpc.ip.exit_read")
        ) / it["count"]
        out["ip_exit_wait_ms_per_iteration"] = read["host_ms"] / it["count"]
    return out


def _profiled(run):
    """``(ms, {kernel name: [count, device us]}, table, events)`` of one
    call of ``run`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = _window_ms(run)
    events = prof.events()
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CUDA and not _is_span(e):
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device events")
    return ms, by_name, prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=25), events


def _case(controller: str, solver: str, plant: str, batch: int, steps: int):
    """``(arrays, cfg, rollout inputs, plant_step or None)`` on the card."""
    from ..protocol import draw_disturbances, draw_loss_masks
    dev = torch.device("cuda", 0)
    dtype = torch.float32 if solver == "cuda" else torch.float64
    g = torch.Generator(device=dev).manual_seed(0)
    theta, gamma = draw_loss_masks(g, steps, P_LOSS, P_LOSS, (batch,))
    plant_step = None
    if controller == "flagship":
        from ..models import flagship_setup
        setup, nx, ref, w_box = flagship_setup(), 2, 5.0, [0.1, 0.1]
        kw = dict(iters=ITERS, iters2=ITERS2, alpha=ALPHA,
                  rho2_scale=RHO2_SCALE)
    else:
        from ..apps.common import ADMM_SCHEDULE, cartpole_controllers
        from ..apps.results_nonlinear import build_nonlinear_plant_step
        from ..apps.scenarios import cartpole_scenario
        sc = cartpole_scenario()
        name = "ext" if controller == "extended" else "tube"
        setup, nx, ref, w_box = (cartpole_controllers(sc, (name,))[name], 4,
                                 sc.ref_value, sc.w_hi)
        kw = ADMM_SCHEDULE
        if plant == "nonlinear":
            plant_step, w_box = build_nonlinear_plant_step(sc), [0.0] * 4
    if solver == "ip_riccati":
        kw = dict(ip_iters=30)
    arrays, cfg = setup.to_device(dtype, dev, solver=solver, **kw)
    w = draw_disturbances(g, steps, [-b for b in w_box], list(w_box),
                          (batch,)).to(dtype)
    refs = torch.zeros(batch, steps, nx, device=dev, dtype=dtype)
    refs[..., 0] = ref
    x0 = torch.zeros(batch, nx, device=dev, dtype=dtype)
    return arrays, cfg, (x0, refs, w, theta, gamma), plant_step


def profile_steps(batch: int, steps: int, controller: str = "flagship",
                  solver: str = "cuda", plant: str = "linear") -> dict:
    from ..ops.ip_riccati import ip_riccati_solve
    from .rollout import make_batched_rollout

    arrays, cfg, inputs, plant_step = _case(controller, solver, plant, batch,
                                            steps)
    rollout = make_batched_rollout(arrays, cfg, steps, plant_step=plant_step)

    def run():
        rollout(*inputs)

    run()                                   # warm-up: build, allocator
    ip_riccati_solve.iterations = 0
    plain_ms = _window_ms(run)
    ip_iterations = ip_riccati_solve.iterations
    profiled_ms, by_name, table, events = _profiled(run)
    spans = span_breakdown(events)

    dev_us = sum(us for _, us in by_name.values())
    n_ops = sum(c for c, _ in by_name.values())
    res = {
        "card": _card(), "controller": controller, "solver": solver,
        "plant": plant, "batch": batch, "steps": steps,
        "step_ms": plain_ms / steps,
        "step_ms_profiled": profiled_ms / steps,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "busy_share_profiled": dev_us / 1e3 / profiled_ms,
    }
    k1_count, k1_us = 0, 0.0
    if solver == "cuda":
        k1 = [(n, c, us) for n, (c, us) in by_name.items() if K1_NAME in n]
        if len(k1) != 1:
            raise RuntimeError(f"expected one kernel named {K1_NAME}, got "
                               f"{k1}")
        _, k1_count, k1_us = k1[0]
        a_step = 4 if cfg.extended else 2   # 2 phases a QP
        if k1_count != a_step * steps:
            raise RuntimeError(f"{k1_count} ADMM launches for {steps} steps")
        from ..ops.qp_cuda import kernel_path
        n_p, m_p = arrays.admm.Kinv.shape[0], arrays.admm.As.shape[0]
        res.update({
            "k1_path": kernel_path(n_p + m_p, batch, n_p),
            "k1_ms_per_launch": k1_us / 1e3 / k1_count,
            "k1_launches_per_step": k1_count / steps,
            "k1_share_of_device_time": k1_us / dev_us})
    else:
        res["ip_iterations_per_step"] = ip_iterations / steps
    other = sorted(((us, c, n) for n, (c, us) in by_name.items()
                    if K1_NAME not in n), reverse=True)
    res.update({
        "other_device_ops_per_step": (n_ops - k1_count) / steps,
        "other_device_ms_per_step": (dev_us - k1_us) / 1e3 / steps,
        "other_top": [{"name": n[:80], "count": c, "us": us}
                      for us, c, n in other[:8]],
        "spans": spans, **span_quantities(spans, events, steps)})
    if plant_step is not None:
        res.update(profile_plant(plant_step, inputs[0]))
    res["table"] = table
    return res


def profile_plant(plant_step, x0, calls: int = 20) -> dict:
    """Device operations, device time and host time of one call of the
    plant alone, at the rollout's batch and dtype."""
    u = torch.ones(x0.shape[0], 1, dtype=x0.dtype, device=x0.device)

    def run():
        x = x0
        for _ in range(calls):
            x = plant_step(x, u, None)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    by_name = _profiled(run)[1]
    return {"plant_device_ops_per_call":
                sum(c for c, _ in by_name.values()) / calls,
            "plant_device_ms_per_call":
                sum(us for _, us in by_name.values()) / 1e3 / calls,
            "plant_host_ms_per_call": host_ms}


def profile_session(ticks: int, controller: str = "flagship",
                    solver: str = "cuda", plant: str = "linear") -> dict:
    """The served session (``Session``, one tick a call, B=1) ticking
    ``ticks`` times back to back, a tick its inputs' copy, one replay of
    the one-tick graph and a synchronize, as a deployed controller's tick
    runs; ``tick_copy_in_host_ms`` and ``tick_replay_host_ms`` are the mean
    host times of its ``rtmpc.session.copy_in`` and ``.replay`` spans."""
    from .session import Session

    arrays, cfg, (x0, refs, w, theta, gamma), plant_step = _case(
        controller, solver, plant, 1, ticks)
    session = Session(arrays, cfg, 1, x0[0], plant_step=plant_step)

    def run():
        for t in range(ticks):
            session.advance(refs[0, t:t + 1], w[0, t:t + 1],
                            theta[0, t:t + 1], gamma[0, t:t + 1])
            torch.cuda.synchronize()

    run()                                   # warm-up
    plain_ms = _window_ms(run)
    profiled_ms, by_name, table, events = _profiled(run)
    spans = span_breakdown(events)
    copy_in = spans.get("rtmpc.session.copy_in")
    replay = spans.get("rtmpc.session.replay")
    if not copy_in or not replay:
        raise RuntimeError(f"no session spans in the profile: {sorted(spans)}")
    dev_us = sum(us for _, us in by_name.values())
    return {
        "card": _card(), "controller": controller, "solver": solver,
        "plant": plant, "session": True, "ticks": ticks,
        "tick_ms": plain_ms / ticks,
        "tick_ms_profiled": profiled_ms / ticks,
        "device_ops_per_tick": sum(c for c, _ in by_name.values()) / ticks,
        "device_ms_per_tick": dev_us / 1e3 / ticks,
        "busy_share_profiled": dev_us / 1e3 / profiled_ms,
        "captured_launches": session.captured_launches,
        "k1_launches_per_tick": sum(c for n, (c, _) in by_name.items()
                                    if K1_NAME in n) / ticks,
        "spans": spans,
        "tick_copy_in_host_ms": copy_in["host_ms"] / copy_in["count"],
        "tick_replay_host_ms": replay["host_ms"] / replay["count"],
        "table": table}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--controller", default="flagship",
                    choices=["flagship", "tube", "extended"])
    ap.add_argument("--solver", default="cuda",
                    choices=["cuda", "ip_riccati"])
    ap.add_argument("--plant", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--batch", type=int, default=None,
                    help="default 16384 (flagship) or 200 (the cartpole)")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps, or with --session ticks")
    ap.add_argument("--session", action="store_true",
                    help="profile the served session's ticks (B=1)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA device")
    if args.plant == "nonlinear" and args.controller == "flagship":
        raise SystemExit("step_profile: the nonlinear plant is the "
                         "cartpole's (--controller tube or extended)")
    if args.session:
        if args.batch not in (None, 1):
            raise SystemExit("step_profile: a session serves one "
                             "controller (--batch 1)")
        res = profile_session(args.steps, args.controller, args.solver,
                              args.plant)
    else:
        batch = args.batch or (16384 if args.controller == "flagship"
                               else 200)
        res = profile_steps(batch, args.steps, args.controller, args.solver,
                            args.plant)
    table = res.pop("table")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        with open(os.path.splitext(args.out)[0] + "_table.txt", "w") as f:
            f.write(table)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
