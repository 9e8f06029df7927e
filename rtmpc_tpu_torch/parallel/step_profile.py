"""Where the time of one closed-loop step goes on the GPU.

    python3 -m rtmpc_tpu_torch.parallel.step_profile [--controller flagship]
        [--solver cuda] [--plant linear] [--batch B] [--steps 10]
        [--out PATH]

Sets up a controller, runs one warm-up rollout of ``--steps`` steps, then
the same window twice: timed with CUDA events alone, and under
``torch.profiler`` (CPU and CUDA activities).  ``--controller flagship``
(default): the 2-D flagship at the bench's 60+60-iteration schedule,
B=16384.  ``--controller extended``: the cartpole's extended tube-tracking
controller of ``apps/results_linear_extended.py`` (two QPs of 112 + 1648
columns), B=200, 70%/70% loss, the apps' 200+200 schedule under ``--solver
cuda`` (float32) or the float64 interior point under ``--solver
ip_riccati``; ``--plant nonlinear`` steps the nonlinear cartpole of
``apps/results_nonlinear.py`` in place of the linear model.

From the profiler's device events it reports, under ``--solver cuda``, the
ADMM kernel's time per launch and its share of the device time; always
the other device operations' count and time per step, the device's busy
share of the profiled window, and (``plant_*``) the device operations, the
device time and the host time of one call of the plant alone.  Prints one
JSON object and, with ``--out``, also writes it and the kernel table there.

Every time comes from this run.  ``k1_tflops_derived`` is the analytic
FLOP count of the kernel's matrix products over its measured time, not a
counter reading: 2 (n_p+m_p)^2 a row and an iteration on the composite
paths, 2 (n_p^2 + 2 n_p m_p) on "fac" (``k1_path``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

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


def _profiled(run):
    """``(ms, {kernel name: [count, device us]}, table)`` of one call of
    ``run`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = _window_ms(run)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device events")
    return ms, by_name, prof.key_averages().table(sort_by="cuda_time_total",
                                                  row_limit=25)


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
        setup, nx, ref, w_box = (cartpole_controllers(sc, ("ext",))["ext"], 4,
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
    profiled_ms, by_name, table = _profiled(run)

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
        path = kernel_path(n_p + m_p, batch, n_p)
        # the products the path runs a row an iteration: the composite
        # form's (n + m)^2, or the factored form's n^2 + 2 n m
        per_row = ((n_p + m_p) ** 2 if path != "fac"
                   else n_p * n_p + 2 * n_p * m_p)
        k1_ms = k1_us / 1e3 / k1_count
        res.update({
            "k1_path": path,
            "k1_ms_per_launch": k1_ms,
            "k1_launches_per_step": k1_count / steps,
            "k1_share_of_device_time": k1_us / dev_us,
            "k1_tflops_derived":
                2 * per_row * batch * cfg.iters / (k1_ms * 1e9)})
    else:
        res["ip_iterations_per_step"] = ip_iterations / steps
    other = sorted(((us, c, n) for n, (c, us) in by_name.items()
                    if K1_NAME not in n), reverse=True)
    res.update({
        "other_device_ops_per_step": (n_ops - k1_count) / steps,
        "other_device_ms_per_step": (dev_us - k1_us) / 1e3 / steps,
        "other_top": [{"name": n[:80], "count": c, "us": us}
                      for us, c, n in other[:8]]})
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
    _, by_name, _ = _profiled(run)
    return {"plant_device_ops_per_call":
                sum(c for c, _ in by_name.values()) / calls,
            "plant_device_ms_per_call":
                sum(us for _, us in by_name.values()) / 1e3 / calls,
            "plant_host_ms_per_call": host_ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--controller", default="flagship",
                    choices=["flagship", "extended"])
    ap.add_argument("--solver", default="cuda",
                    choices=["cuda", "ip_riccati"])
    ap.add_argument("--plant", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--batch", type=int, default=None,
                    help="default 16384 (flagship) or 200 (extended)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA device")
    if args.plant == "nonlinear" and args.controller != "extended":
        raise SystemExit("step_profile: the nonlinear plant is the "
                         "cartpole's (--controller extended)")
    batch = args.batch or (16384 if args.controller == "flagship" else 200)
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
