"""Traffic kind ``sweep``: a Monte-Carlo batch of closed-loop rollouts.

``batch`` rollouts of ``steps`` steps from ``x0``, run ``chunk`` steps a
call of the program's batched rollout
(``rtmpc_tpu_torch.parallel.rollout.make_batched_rollout``, the
configuration's solver inside it).  A rollout's draws: the delivery flags
both ways at its loss probability (``loss``, one for every row, or
``loss_groups``: ``rows_per_group`` rows at each probability, the paper's
Fig. 3a layout), the first transmission delivered, and its disturbances
uniform in the configuration's ``W``; ``draw_sets`` such sets, made on the
device from the seed at set-up.  The reference on ``x_1`` is piecewise
constant (``reference``: ``[first step, value]`` pairs), the rest zero.

The window runs whole chunks until ``--seconds`` have passed; a rollout
that reaches ``steps`` starts again from ``x0`` on the next draw set.  The
quantity ``steps_per_s`` is the rollout-steps of every chunk the window
ran over the time from its start to the synchronize after its last chunk.
The rows that the check compares (a sample drawn from the seed) have their
outputs copied aside as each chunk produces them; the check compares each
draw set's latest rollout over the steps it reached.

Set-up runs ``warmup_chunks`` chunks (the shapes of the window, the
record's copies included) before the window, unrecorded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.check import Answer
from benchmark.harness import Window
from benchmark.measure import window_rate
from benchmark.trace import Profiled


def _sample(p: dict, sample: dict, rng) -> np.ndarray:
    """The rows the check compares: ``per_group`` rows of every loss
    group, or ``rows`` rows of the batch."""
    B = p["batch"]
    if "loss_groups" in p:
        n = p["rows_per_group"]
        return np.sort(np.concatenate([
            g * n + rng.choice(n, sample["per_group"], replace=False)
            for g in range(len(p["loss_groups"]))]))
    return np.sort(rng.choice(B, sample["rows"], replace=False))


def run(ctx) -> Window:
    from rtmpc_tpu_torch.ops.ip_riccati import ip_riccati_solve
    from rtmpc_tpu_torch.parallel.rollout import make_batched_rollout

    p, dev = ctx.cell.traffic, ctx.device
    B, T, chunk, D = p["batch"], p["steps"], p["chunk"], p["draw_sets"]
    dt = ctx.arrays.A.dtype
    nx, nu = ctx.cfg.nx, ctx.cfg.nu
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    if "loss_groups" in p:
        probs = np.repeat(p["loss_groups"], p["rows_per_group"])
    else:
        probs = np.full(B, p["loss"])
    if len(probs) != B:
        raise ValueError("loss_groups x rows_per_group must be the batch")
    probs = torch.tensor(probs, dtype=torch.float32, device=dev)

    def flags():
        f = (torch.rand((D, B, T), generator=gen, device=dev)
             >= probs[None, :, None]).to(torch.int32)
        f[..., 0] = 1
        return f
    theta, gamma = flags(), flags()
    w_box = torch.tensor(ctx.cell.config["plant"]["w_box"],
                         dtype=torch.float32, device=dev)
    w = ((2 * torch.rand((D, B, T, nx), generator=gen, device=dev) - 1)
         * w_box).to(dt)
    rng = np.random.default_rng(ctx.seed)
    ref1 = np.zeros(T)
    for first, value in p["reference"]:
        ref1[first:] = value
    refs = torch.zeros(B, T, nx, dtype=dt, device=dev)
    refs[..., 0] = torch.tensor(ref1, dtype=dt, device=dev)
    x0 = torch.tensor(p["x0"], dtype=dt, device=dev).expand(B, nx)

    rows = _sample(p, ctx.cell.workload["sample"], rng)
    idx = torch.tensor(rows, device=dev)
    k = len(rows)
    rec = {"x": torch.zeros(D, k, T, nx, dtype=dt, device=dev),
           "u": torch.zeros(D, k, T, nu, dtype=dt, device=dev),
           "x_nom": torch.zeros(D, k, T, nx, dtype=dt, device=dev),
           "Theta": torch.zeros(D, k, T, dtype=torch.int32, device=dev),
           "feasible": torch.zeros(D, k, dtype=torch.bool, device=dev)}
    reached = [0] * D
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    rollout = make_batched_rollout(ctx.arrays, ctx.cfg, chunk)
    state = {"carry": None, "t": 0, "d": 0}

    def one_chunk():
        t, d = state["t"], state["d"]
        sl = slice(t, t + chunk)
        with ctx.span("rollout_chunk"):
            carry, out = rollout(x0, refs[:, sl], w[d, :, sl],
                                 theta[d, :, sl], gamma[d, :, sl],
                                 carry0=state["carry"])
        with ctx.span("record"):
            for key in ("x", "u", "x_nom", "Theta"):
                rec[key][d, :, sl] = getattr(out, key).index_select(0, idx)
            rec["feasible"][d] = out.feasible[:, -1].index_select(0, idx)
            failed.add_((~out.feasible).sum())
        reached[d] = t + chunk
        if t + chunk >= T:
            state.update(carry=None, t=0, d=(d + 1) % D)
        else:
            state.update(carry=carry, t=t + chunk)

    for _ in range(p["warmup_chunks"]):
        one_chunk()
    ctx.sync()
    state.update(carry=None, t=0, d=0)
    reached[:] = [0] * D
    failed.zero_()
    iters0 = ip_riccati_solve.iterations

    trace_at = ctx.cell.workload["trace"]
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    first, last = trace_at["start"], trace_at["start"] + trace_at["chunks"]
    n, prof, prof_wall = 0, None, 0.0
    while True:
        if ctx.trace and n == first:
            t_prof = time.perf_counter()
            prof = Profiled(ctx.sync).__enter__()
        one_chunk()
        n += 1
        if prof is not None and n == last:
            prof.__exit__(None, None, None)
            prof_wall = time.perf_counter() - t_prof
        # the profiled chunks and the profiler's processing are no part of
        # the window's length: a traced run holds the chunks of an untraced
        if time.perf_counter() - t_start - prof_wall >= ctx.seconds and (
                not ctx.trace or n >= last):
            break
    ctx.sync()
    t_end = time.perf_counter()
    steps = n * chunk

    host = {key: (v.double() if v.is_floating_point() else v).cpu().numpy()
            for key, v in rec.items()}
    th, gm = theta.cpu().numpy(), gamma.cpu().numpy()
    w_h, refs_h = w.cpu().double().numpy(), refs.cpu().double().numpy()
    x0_h = np.array(p["x0"], float)
    answers = []
    for d in range(D):
        L = reached[d]
        for i, r in enumerate(rows):
            if L == 0:
                continue
            answers.append(Answer(
                x0_h, refs_h[r, :L], w_h[d, r, :L], th[d, r, :L],
                gm[d, r, :L], host["x"][d, i, :L], host["u"][d, i, :L],
                host["x_nom"][d, i, :L], host["Theta"][d, i, :L],
                host["feasible"][d, i]))
    return Window(
        quantities={"steps_per_s": window_rate(B * steps, t_start, t_end),
                    "setup_s": setup_s},
        answers=answers, attempted=B * steps, failed=int(failed),
        counters={"ip_iterations": ip_riccati_solve.iterations - iters0,
                  "steps": steps},
        spans={"window_s": t_end - t_start}, profiled=prof,
        steps_profiled=trace_at["chunks"] * chunk if prof else 0)
