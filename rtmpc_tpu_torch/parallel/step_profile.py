"""Where the time of one closed-loop step goes on the GPU.

    python3 -m rtmpc_tpu_torch.parallel.step_profile [--batch 16384]
        [--steps 10] [--out chiprun_out/step_profile.json]

Sets up the flagship (float32, solver "cuda", the bench's 60+60-iteration
schedule), runs one warm-up rollout of ``--steps`` steps, then the same
window twice: timed with CUDA events alone, and under ``torch.profiler``
(CPU and CUDA activities).  From the profiler's device events it reports
the ADMM kernel's time per launch and its share of the device time, the
other device operations' count and time per step, and the device's busy
share of the profiled window.  Prints one JSON object and, with ``--out``,
also writes it and the kernel table there.

Every time comes from this run.  ``k1_tflops_derived`` is the analytic
FLOP count of the kernel's matrix products (2 (n_p+m_p)^2 a row and an
iteration) over its measured time, not a counter reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
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


def profile_steps(batch: int, steps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..models import flagship_setup
    from ..protocol import draw_disturbances, draw_loss_masks
    from .rollout import make_batched_rollout

    dev = torch.device("cuda", 0)
    arrays, cfg = flagship_setup().to_device(
        torch.float32, dev, iters=ITERS, iters2=ITERS2, alpha=ALPHA,
        rho2_scale=RHO2_SCALE, solver="cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    theta, gamma = draw_loss_masks(g, steps, P_LOSS, P_LOSS, (batch,))
    w = draw_disturbances(g, steps, [-0.1, -0.1], [0.1, 0.1], (batch,))
    refs = torch.zeros(batch, steps, 2, device=dev)
    refs[..., 0] = 5.0
    x0 = torch.zeros(batch, 2, device=dev)
    rollout = make_batched_rollout(arrays, cfg, steps)

    def run():
        rollout(x0, refs, w, theta, gamma)

    run()                                   # warm-up: build, allocator
    plain_ms = _window_ms(run)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = _window_ms(run)

    by_name = defaultdict(lambda: [0, 0.0])   # name -> [count, device us]
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device events")
    k1 = [(n, c, us) for n, (c, us) in by_name.items() if K1_NAME in n]
    if len(k1) != 1:
        raise RuntimeError(f"expected one kernel named {K1_NAME}, got {k1}")
    _, k1_count, k1_us = k1[0]
    if k1_count != 2 * steps:
        raise RuntimeError(f"{k1_count} ADMM launches for {steps} steps")
    dev_us = sum(us for _, us in by_name.values())
    n_ops = sum(c for c, _ in by_name.values())
    other = sorted(((us, c, n) for n, (c, us) in by_name.items()
                    if K1_NAME not in n), reverse=True)
    nm = arrays.admm.Kinv.shape[0] + arrays.admm.As.shape[0]
    k1_ms = k1_us / 1e3 / k1_count
    return {
        "card": _card(),
        "batch": batch, "steps": steps,
        "step_ms": plain_ms / steps,
        "step_ms_profiled": profiled_ms / steps,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "busy_share_profiled": dev_us / 1e3 / profiled_ms,
        "k1_ms_per_launch": k1_ms,
        "k1_launches_per_step": k1_count / steps,
        "k1_share_of_device_time": k1_us / dev_us,
        "k1_tflops_derived": 2 * nm * nm * batch * ITERS / (k1_ms * 1e9),
        "other_device_ops_per_step": (n_ops - k1_count) / steps,
        "other_device_ms_per_step": (dev_us - k1_us) / 1e3 / steps,
        "other_top": [{"name": n[:80], "count": c, "us": us}
                      for us, c, n in other[:8]],
        "table": prof.key_averages().table(sort_by="cuda_time_total",
                                           row_limit=25),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA device")
    res = profile_steps(args.batch, args.steps)
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
