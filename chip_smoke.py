"""Smoke run of the PyTorch/CUDA port (``rtmpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the flagship lossy-network tube-tracking MPC
closed loop of ``bench.py``, at full width on the card, in phases that each
fail loudly (non-zero exit) on any error:

  1. a CUDA device is required (no CPU fallback: without one the script
     exits non-zero and prints no result);
  2. the card's name and power limit (``nvidia-smi``);
  3. the ADMM kernel K1 (``rtmpc_tpu_torch/csrc/admm_kernel.cu`` and
     ``admm_factored.cu``, one nvcc a source, side by side) is built from
     this checkout.  K1 has three paths, picked by (B, n_p, m_p): "fac"
     (the factored form, the operator resident in shared memory) for every
     batch up to ``qp_cuda.FAC_MAX_B`` rows and every batch above 1024
     columns, "smem" and "l2" (the composite form) for the rest.  Every
     comparison below holds a launch to the plain version of the path it
     takes (``kernel_bench.compare_with_plain``);
  4. the flagship is set up with the port's own jax-free setup (any
     ``import jax`` raises in this script);
  5. the kernel against its plain PyTorch version on the card, cold
     phase 1 then warm phase 2, in f32, and against the plain version in
     f64 (no further from it than the plain f32 version): at B=4099
     (ragged tail) and at the main path's B=16384 (phase 2 from the
     kernel's own phase-1 state), and at B=1 and one row less and more
     than a thread block owns (B=1 and 63 on "fac", 65 on "smem"; there
     against absolute float64 bars, see
     ``rtmpc_tpu_torch/ops/kernel_bench.py``); times of kernel and plain
     version for one 60-iteration phase at B=16384;
 5b. the kernel against its plain version on random QPs at the widest
     shape of each path and the narrowest of the large one (n_p + m_p =
     192, 193, 2048), at tiny and ragged batches;
  6. the full-width closed loop through the kernel: B=16384 rollouts of
     T=120 steps, 70%/70% loss, the bench's reference profile; every
     rollout feasible, every output finite, 2 kernel launches per step,
     the tube invariant at every step and Proposition 1 (``Hz (x_t -
     x_hat_t) <= hz``) at every step with ``Theta_t = 1``;
  7. closed-loop parity at B=256: solver "cuda" against solver "admm" on
     the card and against solver "admm" in float64 on the CPU.

Then the paper's Fig. 3a slice, the 4-D cartpole (N=20) of
``rtmpc_tpu_torch.apps.results_linear``:

  8. the kernel at the cartpole's shapes, both QPs (112 + 792 and 112 +
     840 columns; the cluster path ``admm_kernel_cluster`` at B=200, "fac"
     at the others), at B=200 (phase 2 warm from the kernel's own
     phase-1 state), B=37 (ragged), B=1 and one row less and more than a
     cluster owns, 200 cold then 200 warm iterations: against its plain
     version in float32, and against the plain version in float64 no
     further than 3x plain float32 (absolute bars at the small batches);
     times of kernel and
     plain version for one 200-iteration phase at B=200, and for all
     three main shapes the kernel's time beside its FP32 bound (the
     factored form's operations, the least the function needs) and the
     library's time for the products alone (``iters`` back-to-back
     ``torch.mm`` in float32, TF32 off); then the crossover of "fac"
     against the composite paths (one phase's device time on each at B in
     1, 2, ..., 64 on the flagship's and the cartpole tube QP) beside the
     dispatch's ``FAC_MAX_B``, failing where "fac" is not the faster at
     every one of them;
  9. (run after 15, whose trajectories give its inputs) the structured
     interior point in float64 on the card against the CPU, on 64 thetas
     from the sample trajectories of a full-size float64 sweep;
 10. the sweep on the card in float64 ``ip_riccati``, both arms, at the
     app's ``--quick`` depth (4 loss probabilities x 4 runs x 60 steps,
     cut from the full size to leave the time to phases 14 and 15): the
     tube arm is feasible everywhere, every output is finite, the app's
     own checks pass.  The full-size run that ``compare_linear`` holds to
     ``RESULTS_LINEAR_CPU_F64_r05.json`` is ``python3 -m
     rtmpc_tpu_torch.apps.results_linear --device cuda``;
 11. the same sweep under ``--solver cuda`` (the ADMM kernel, float32):
     2 kernel launches a step on the tube arm, 3 on the tracking arm (the
     certificate's extra iterations are one more), all on the cluster path
     (B=200), Fig. 3d's B=1 ticks on "fac", every output finite,
     the tube arm feasible, the tube invariant on the sample trajectories;
     its rows are printed against the truth but not gated (the ADMM does
     not reach trajectory parity on this geometry).

Then the rest of the paper's Results, the extended tube-tracking arm
(Section IV.F) and the nonlinear cartpole plant (Figs. 3b/3c), the apps
``rtmpc_tpu_torch.apps.results_linear_extended`` and ``results_nonlinear``:

 12. the extended controller is set up (two QPs of 112 + 1648 columns: the
     initial state lies in the tube, one row for each of Z's 854);
 13. the kernel at that shape (above 1024 columns every batch takes
     "fac"), both QPs, as in phase 8: B=200, B=37, B=1 and one row less
     and more than a cluster of the composite path owns; times at B=200
     and B=1 beside the cluster path's in the same call, bound and
     ``torch.mm``;
 14. both apps at full size under ``--solver cuda`` (3 arms x 200
     rollouts x 250 steps each, ``results_nonlinear`` with ``--extended``):
     every output finite, both tube arms feasible, the kernel launches as
     reckoned (2 a step on RT-MPC, 3 on R-MPC, 4 on Ext-RT-MPC: 2 QPs x 2
     phases; 6 where that arm runs on certificates; the extended arm and
     Fig. 3d on "fac", the other arms on the cluster path), each arm's rows
     printed beside the float64 truth (largest relative distance, stopped
     runs), the tube invariant of
     the RT-MPC arm on the sample trajectories (the extended arm's margin
     is printed: its actuator resets the nominal state to the QP's, which
     after a lost reply starts from a prediction and not from the plant's
     state, so ``x - x_nom`` is not held to Z, in the JAX package
     neither), ``max |phi| <= 0.3 + 1e-3`` on the nonlinear plant; rows
     and the apps' own checks printed, not gated (ADMM);
 15. at full size in float64 ``ip_riccati``, each in a worker process
     (one after the other they took 604 s of a 905 s run on an NVIDIA
     H100 80GB HBM3 machine with a slow host, three quarters of the time
     this script may take): the Ext-RT-MPC arm on the linear plant
     and the RT-MPC arm on the nonlinear plant (B=200, T=250, the
     committed draws): feasible everywhere, the per-p mean RMS within
     1e-4 (relative) of the JAX package's float64 rows
     (``RESULTS_LINEAR_EXT_CPU_F64_JAX.json``,
     ``RESULTS_NONLINEAR_EXT_CPU_F64_JAX.json``), the extended arm's error
     at p=0.9 below 1.5x the reference's RT-MPC error there, ``max |phi|
     <= 0.3 + 1e-3``;
 16. ``cartpole_zoh_step`` on the card against the CPU, float64, 1e-12.

Then the single-instance controllers (run right after phase 7, on the
flagship's setup):

 17. the served session of ``rtmpc_tpu_torch.apps.serve_controller`` at
     its defaults (15,000 ticks in windows of 150, loss 0.4, solver
     "cuda", float32), each window one CUDA graph replay with K1 at B=1
     inside it (every launch on "fac"): the app's four checks pass (window-mean tick p99 under
     20 ms, no window deadline misses, feasible, ``mean |x1 - ref|`` over
     the last second under 0.5); 2 kernel launches a tick captured, 30,000 run
     (captured x replays); the first window through the graph equals the
     same window run eagerly (1e-6); its first 120 ticks within 1e-3 of a
     float64 CPU run of solver "admm" (the flagship bar of phase 7);
     prints the window-mean tick times through the graph, the tick time
     eagerly, the device time a tick, the per-dispatch report and the
     dispatch floor;
 18. K1 at B=1, the served shape (40 + 112 columns, 60 iterations, the
     "fac" path): against its plain version (the small-batch bars of
     ``kernel_bench.py``), its time (device time of a CUDA graph of
     launches) beside the smem path's in the same call, the plain
     version's, its FP32 bound and 60 x ``torch.mm`` (1, 152) @ (152,
     152);
 19. the six example apps (``rtmpc_tpu_torch.apps.example_*``) at full
     length, under the dense interior point in float64 and under
     ``--solver cuda``: each one's checks pass; their seconds and kernel
     launches are printed.

Then the rest of the paper's figures and apps, and the condensed QP (run
after phase 16; the Results apps run with ``--no-figures``, since figures
need matplotlib):

 20. Fig. 3d under the structured interior point in float64: a one-tick
     CUDA graph of the RT-MPC controller holds the whole interior point
     (its fixed iteration budget, no read of the device); its capture and
     instantiation times; its first 5 ticks equal the same ticks run
     eagerly to 1e-9; then ``results_linear``'s solve-time statistics at
     its full T=250, one replay and one synchronize a tick, p50, p99 and
     max printed beside the card's name.  The same statistics under
     ``--solver cuda`` come with phases 11 and 14 (each arm's one-tick
     graph launches K1 twice through the wrapper: its warm-up tick and
     its captured tick), the extended arm's under ``ip_riccati`` with
     phase 15;
 21. ``estimate_w`` at its defaults (100 LQR rollouts of 150 steps of the
     nonlinear plant, float64): its two checks, and its box equal to the
     port's CPU run on the same initial states to 1e-10;
 22. ``create_animations.run`` under ``--solver cuda`` at full T (K1 at
     B=1 on the cartpole's QPs, "fac", 2 launches a step on each arm), its checks
     (both arms finite, the tube arm's |phi| < 0.3; the tracking arm's
     bound printed, not gated, as ``phase_animations`` says), no
     rendering; K1's time at B=1 there beside the cluster path's, its
     bound and ``torch.mm``;
 23. the condensed QPs (``condense_template``): K1 against its plain
     version on the condensed flagship (16 + 96, smem path; "fac" at B=1)
     at B=16384 and B=1 and on the condensed cartpole QPs (32 + 712 and 32
     + 760, cluster path, 16 rows a cluster; "fac" at B=1) at B=200 and
     B=1, each timed beside its bound and ``torch.mm``, B=1 beside the
     composite path's time; the condensed flagship closed loop at
     B=16384, T=120 (240 launches, feasible, finite, the tube invariant at
     every step; on phase 7's inputs within 1e-3 of the plain float32
     loop and no further from float64 on the CPU than 1e-3 or 3x plain
     float32's own distance); a condensed RT-MPC cartpole loop (B=200,
     T=60, 2 launches a step, finite).

Then data parallelism over rollouts (``rtmpc_tpu_torch/parallel/
distributed.py``, ``parallel/ranks.py``, ``entry.py``):

 24. (a) the flagship sweep at full width, ``run_mc_sweep(group=...)`` at
     B=16384 (one probability, 0.7), T=120, solver "cuda", float32,
     sharded over 2 ranks that share cuda:0 over gloo (8192 rows a rank),
     held to the same sweep in one process on the same draws: both ranks'
     results identical, feasible equal and everywhere, every row finite,
     max |dx| of the gathered trajectories within ``DP_DX``, K1 240 launches
     a rank; each rank's wall time and the one process's printed with the
     card (two processes time-share one card: no speed-up is expected or
     claimed); (b) the Fig. 3a tube arm under "cuda" at full size (10 x 20 x
     250, the cluster path, 100 rows a rank) in the same ranks: per-p rows
     within 1e-6 (relative) of phase 11's one process, stopped runs equal,
     500 launches a rank; (c) ``dryrun_multichip(2)`` (gloo, printed);
     (d) a one-rank NCCL group on cuda:0 (``all_reduce``,
     ``all_gather_into_tensor`` on CUDA tensors), and (a) over NCCL on
     cuda:0 and cuda:1 where the machine has two cards (else printed as not
     run); (a)-(d) run beside phase 15, after phase 26.  K1 at a rank's
     B=8192 against its plain version, timed (after phase 23).

Then the last solver modes (``rtmpc_tpu_torch/ops/ip_riccati.py:
ip_riccati_solve_hybrid``, ``ops/qp.py:admm_solve(early_tol=...)``):

 25. (a) Fig. 3a's RT-MPC tube arm at full width (B=200: 10 loss
     probabilities x 20 runs, N=20, the committed draws), T cut from 250
     to 20, under ``ip_hybrid`` (30 float32 + 12 float64 iterations,
     float32 engine) and float64 ``ip_riccati`` on the same draws: both
     feasible everywhere and finite, the same stops, every per-p mean RMS
     of the hybrid within 1% (relative) of the float64 row; each one's
     seconds a step, IP iterations a step (the hybrid's phases apart) and
     the IP's device launches a step (launches an iteration from
     ``torch.profiler`` over short fixed-budget solves, times the
     iterations) printed; (b) Fig. 3d under ``ip_hybrid`` (phase 20's
     method: the hybrid captured whole in a one-tick graph, its first 5
     ticks equal the eager ones to 1e-9, p50, p99 and max over 40 ticks,
     capture and instantiation seconds) beside phase 20's float64
     numbers; (c) the
     flagship's served shape (B=1, T=120) eagerly under solver "admm",
     float32, 60+60 iterations with ``early_tol=1e-3`` on phase 2 and with
     the fixed budget: chunks a step and ms a step of each; feasible, the
     tube invariant at every step, the early-exit trajectory within 1e-3
     of the port's float64 CPU run under the same ``early_tol``.

The interior points that run eagerly, bound by one host thread's
launches (phases 10, 15, 19's dense IP half and 25 (a)), run side by side
in three worker processes, started after phase 14, while this process
runs the hardware parity gate (``rtmpc_tpu_torch/apps/device_checks.py``,
the counterpart of ``tools/tpu_checks.py``) and then phase 24 (a)-(d);
their times are times beside one another:

 26. ``device_checks.run("cuda")``: the closed loops on the card held to the
     independent float64 protocol oracle
     (``rtmpc_tpu_torch/utils/oracle_protocol.py``) on the JAX gate's
     inputs: the flagship under the bench's float32 ADMM through K1 at B=1,
     64 ("fac") and 65 ("smem"), the cartpole under the dense float32, the
     hybrid and the float64 structured interior points and its ADMM at
     200 + 200 iterations through K1 at B=1 ("fac") and 65 ("l2"), the
     extended arm on the double integrator under the hybrid, the float64
     structured IP and K1; Proposition 1 and tube membership on the card's
     outputs; every check printed, its readings written to
     ``build/chip_smoke/device_checks.json`` and printed a line each; any
     failed check fails the script.

Prints the kernels' JSON record on the line before the last and, as the
last line, ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import contextlib
import dataclasses
import importlib
import importlib.abc
import io
import json
import multiprocessing
import os
import sys
import time
import traceback

import numpy as np
import torch

B_CHECK = 4099          # kernel vs plain: 64 blocks of 64 rows and a tail of 3
B_FULL = 16384          # the bench's batch
B_PARITY = 256
T = 120
ITERS = ITERS2 = 60
ALPHA, RHO2_SCALE = 1.8, 0.2
P_LOSS = 0.7
# The bars of the kernel against its plain version are those of
# rtmpc_tpu_torch/ops/kernel_bench.py (one comparison, compare_with_plain,
# for this script, the kernel's own bench and the card tests).
TUBE_TOL = 1e-4
# Closed-loop max |dx|: 6-9x what an NVIDIA H100 80GB HBM3 at 700 W read
# (1.7e-4 against solver "admm" on the card, 1.1e-4 against the float64
# CPU run).
DX_PARITY = 1e-3

# Phase 8, the cartpole QPs through the kernel's L2 path.
CP_BATCHES = (200, 37)
CP_ITERS = 200
# Phase 9, the interior point on the card against the CPU, both float64.
# The cartpole's optimal face is flat (scaled cost cond ~1e20): summing in
# other orders moves the converged z along it at equal objectives.  Read on
# the same card: max|dz| 1.34e-2, objectives 2.8e-10 relative, r_prim
# <= 4.8e-11 and r_dual <= 1.24e-6 on both.  The thetas are nominal states
# of a full-size float64 sweep (phase 15's): the objectives are 2e5 to 2e7
# (the offset cost) and the multipliers as large, so on the rougher states
# of a float32 ADMM sweep or of a sweep's first 60 steps alone a primal
# residual of 1.5e-10 already moves an objective by 6.1e-8 relative.
IP_B = 64
IP_Z_ATOL = 5e-2
IP_OBJ_RTOL = 1e-8
IP_R_PRIM = 1e-9        # both runs' primal residuals at or below this
IP_R_DUAL = 1e-5        # and their dual residuals


class _NoJax(importlib.abc.MetaPathFinder):
    """Makes any import of jax or of the JAX package ``rtmpc_tpu`` fail:
    the port must run without them."""

    def find_spec(self, name, path=None, target=None):
        if (name in ("jax", "rtmpc_tpu")
                or name.startswith(("jax.", "jaxlib", "rtmpc_tpu."))):
            raise ImportError(f"chip_smoke.py: {name} must not be imported")
        return None


def _require(ok, what="") -> None:
    """Fail the run (explicitly, also under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke.py check failed: {what!r}")


def _max_err(a, b) -> float:
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def _bench_refs(B, dev, dtype):
    refs = torch.zeros(T, 2, dtype=dtype)
    refs[:T // 4, 0] = 5.0
    refs[T // 4:T // 2, 0] = -9.0
    refs[T // 2:, 0] = 4.0
    return refs.to(dev).expand(B, T, 2)


def _inputs(B, dev, seed):
    from rtmpc_tpu_torch.protocol import draw_disturbances, draw_loss_masks
    g = torch.Generator(device=dev).manual_seed(seed)
    theta, gamma = draw_loss_masks(g, T, P_LOSS, P_LOSS, (B,))
    w = draw_disturbances(g, T, [-0.1, -0.1], [0.1, 0.1], (B,))
    return theta, gamma, w


def _compare(specs, specs64, th1, th2, warm_from_kernel, iters, bars,
             label="", f64_bars=None):
    """``kernel_bench.compare_with_plain`` on a QP's two phases (``specs``:
    phase 1's spec, then phase 2's, run warm), held against float64 too
    (``specs64``); prints the errors and returns the largest of z and y
    against the plain version."""
    from rtmpc_tpu_torch.ops.kernel_bench import compare_with_plain
    errs = compare_with_plain(
        *specs, th1, th2, iters, bars, warm_from_kernel=warm_from_kernel,
        specs64=specs64, f64_bars=f64_bars)
    print("%skernel vs plain (B=%d, %d+%d iterations, phase 2 warm from the "
          "%s phase-1 state): %s"
          % (label + " " if label else "", th1.shape[0], *iters,
             "kernel's" if warm_from_kernel else "plain version's",
             json.dumps(errs)))
    return max(errs[k] for k in ("cold_z", "warm_z", "cold_y", "warm_y"))


def _product_yardstick(label, B, spec, th, iters, kernel_ms, dev):
    """Prints the kernel's time for one phase beside its FP32 bound, the
    library's time for the products alone and the SM clock under the
    kernel; returns (bound ms, bound by, product ms)."""
    from rtmpc_tpu_torch.ops.kernel_bench import (composite_over_factored,
                                                  mm_product_ms, roofline_ms,
                                                  sm_clock_under)
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    bound, by = roofline_ms(B, n_p, m_p, th.shape[1], iters)
    mm = mm_product_ms(B, n_p + m_p, iters, dev)
    # about two seconds of queued launches, read while they run
    clock = sm_clock_under(lambda: admm_solve_cuda(spec, th, None, iters),
                           int(2000 / kernel_ms))
    print("%s, B=%d, %d iterations: kernel %.4f ms; bound %.4g ms (by %s, "
          "the factored form's; the kernel's composite product is %.2fx "
          "those operations; share reached %.3g); library, products alone "
          "(%d x torch.mm (%d, %d) @ (%d, %d), float32, TF32 off): %.4f ms; "
          "SM clock under the kernel, and its maximum: %s"
          % (label, B, iters, kernel_ms, bound, by,
             composite_over_factored(n_p, m_p), bound / kernel_ms, iters,
             B, n_p + m_p, n_p + m_p, n_p + m_p, mm, clock))
    return bound, by, mm


def _fac_timing(label, B, spec, th, iters, dev, reps=20):
    """A "fac" shape's phase time (the dispatch's path there) beside the
    composite path of the width ("before"), each the device time of a CUDA
    graph of ``reps`` launches (``kernel_bench.graph_time_ms``: a phase of
    ~0.1 ms is shorter than the host's time to issue it), in turns (before,
    fac, fac, before); the plain version's by CUDA events; the bound and
    ``torch.mm``.  Returns (ms, plain ms, (bound ms, bound by, torch.mm
    ms), before ms)."""
    from rtmpc_tpu_torch.ops.kernel_bench import graph_time_ms, time_ms
    from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_cuda_on_path,
                                             _admm_solve_plain,
                                             admm_solve_cuda, kernel_path)
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    old = kernel_path(n_p + m_p)
    _require(kernel_path(n_p + m_p, B, n_p) == "fac", (label, B))
    t = {"fac": [], old: []}
    for path in (old, "fac", "fac", old):
        if path == "fac":
            fn = lambda: admm_solve_cuda(spec, th, None, iters)  # noqa: E731
        else:
            fn = lambda: _admm_solve_cuda_on_path(spec, th, None, iters,  # noqa: E731
                                                  old)
        t[path].append(graph_time_ms(fn, reps))
    plain_ms = time_ms(lambda: _admm_solve_plain(spec, th, None, iters), 3)
    ms, before = float(np.mean(t["fac"])), float(np.mean(t[old]))
    print("%s, one %d-iteration phase, B=%d: fac %s ms, before (%s path, "
          "same call) %s ms, plain %.4f ms"
          % (label, iters, B, t["fac"], old, t[old], plain_ms))
    return ms, plain_ms, _product_yardstick(label, B, spec, th, iters, ms,
                                            dev), before


def phase_kernel_vs_plain(arrays, arrays64, dev):
    from rtmpc_tpu_torch.ops.kernel_bench import (F64_SMALL_B, Y_ATOL,
                                                  Y_ATOL_SMALL_B, Z_ATOL)
    from rtmpc_tpu_torch.ops.kernel_bench import time_ms as _time_ms
    from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_cuda_plain,
                                             admm_solve_cuda, kernel_path,
                                             kernel_rows)
    rng = np.random.default_rng(0)
    iters, bars = (ITERS, ITERS2), (Z_ATOL, Y_ATOL)
    specs, specs64 = ((a.admm, a.admm2) for a in (arrays, arrays64))

    def theta(B):
        return torch.tensor(rng.uniform(-2, 2, (B, 4)), dtype=torch.float32,
                            device=dev)

    # a ragged tail, with different thetas in the two phases
    err = _compare(specs, specs64, theta(B_CHECK), theta(B_CHECK), False,
                   iters, bars)
    # the main path's shape: one theta for both phases, phase 2 from the
    # kernel's own phase-1 state
    thf = theta(B_FULL)
    err = max(err, _compare(specs, specs64, thf, thf, True, iters, bars))
    # tiny and ragged around the rows of a thread block: the small batches'
    # own y bar and absolute bars against float64 (kernel_bench.py); the
    # error returned is the smem path's ("fac" at B=1 has its own, phase 18)
    rows = kernel_rows(arrays.admm.Kinv.shape[0], arrays.admm.As.shape[0])
    paths = {B: kernel_path(152, B, 40) for B in (1, rows - 1, rows + 1)}
    print("small batches: B=1, %d, %d on paths %s" % (
        rows - 1, rows + 1, list(paths.values())))
    for B, path in paths.items():
        e = _compare(specs, specs64, theta(B), theta(B), False, iters,
                     (Z_ATOL, Y_ATOL_SMALL_B), f64_bars=F64_SMALL_B)
        if path == "smem":
            err = max(err, e)

    # one 60-iteration phase at the bench's batch, in turns
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = admm_solve_cuda if which == "kernel" else _admm_solve_cuda_plain
        times[which].append(_time_ms(
            lambda: fn(arrays.admm, thf, None, ITERS), reps=20))
    print("one phase, B=%d, 60 iterations: kernel %s ms, plain %s ms"
          % (B_FULL, times["kernel"], times["plain"]))
    ms = float(np.mean(times["kernel"]))
    bound = _product_yardstick("flagship 40+112", B_FULL, arrays.admm, thf,
                               ITERS, ms, dev)
    return err, ms, float(np.mean(times["plain"])), bound


def phase_full_loop(arrays, cfg, dev):
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    from rtmpc_tpu_torch.parallel import (make_batched_rollout,
                                          tracking_error_rms)
    theta, gamma, w = _inputs(B_FULL, dev, seed=0)
    refs = _bench_refs(B_FULL, dev, torch.float32)
    x0 = torch.zeros(B_FULL, 2, dtype=torch.float32, device=dev)
    rollout = make_batched_rollout(arrays, cfg, T)

    torch.cuda.synchronize()
    admm_solve_cuda.launches = 0
    t0 = time.perf_counter()
    carry, outs = rollout(x0, refs, w, theta, gamma)
    torch.cuda.synchronize()
    dt_first = time.perf_counter() - t0
    launches = admm_solve_cuda.launches

    t0 = time.perf_counter()
    rollout(x0, refs, w, theta, gamma)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    print("full loop B=%d T=%d: kernel launches %d, %.1f rollouts/s "
          "(first run %.1f), %.3f ms a step"
          % (B_FULL, T, launches, B_FULL / dt, B_FULL / dt_first,
             dt * 1e3 / T))
    _require(launches == 2 * T, launches)
    _require(bool(carry.feasible.all()) and bool(outs.feasible.all()))
    for name, t in outs._asdict().items():
        _require(t.shape[:2] == (B_FULL, T), (name, t.shape))
        if t.is_floating_point():
            _require(bool(torch.isfinite(t).all()), name)
    _require(bool(torch.isfinite(carry.x).all()))
    # tube invariant: Hz (x_t - x_nom_t) <= hz at every step t = 0..T-1
    xs = torch.cat([x0[:, None], outs.x[:, :-1]], dim=1)
    viol = ((xs - outs.x_nom) @ arrays.Hz.T - arrays.hz).amax().item()
    print("tube invariant: max Hz(x - x_nom) - hz = %.3e" % viol)
    _require(viol <= TUBE_TOL, viol)
    # Proposition 1: Hz (x_t - x_hat_t) <= hz wherever Theta_t = 1
    consistent = outs.Theta == 1
    prop1 = ((xs - outs.x_hat)[consistent] @ arrays.Hz.T
             - arrays.hz).amax().item()
    print("Proposition 1: max Hz(x - x_hat) - hz = %.3e over %d consistent "
          "steps of %d" % (prop1, int(consistent.sum()), B_FULL * T))
    _require(prop1 <= TUBE_TOL, prop1)
    err = tracking_error_rms(x0, outs.x, refs, carry.feasible).double().cpu()
    print("tracking_error_rms: mean %.6f median %.6f p99 %.6f max %.6f"
          % (err.mean().item(), err.median().item(),
             err.quantile(0.99).item(), err.max().item()))
    return launches, B_FULL / dt


def phase_parity(setup, arrays, cfg, dev):
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    theta, gamma, w = _inputs(B_PARITY, dev, seed=1)
    refs = _bench_refs(B_PARITY, dev, torch.float32)
    x0 = torch.zeros(B_PARITY, 2, dtype=torch.float32, device=dev)
    runs = {}
    for solver in ("cuda", "admm"):
        c = dataclasses.replace(cfg, solver=solver)
        runs[solver] = make_batched_rollout(arrays, c, T)(
            x0, refs, w, theta, gamma)
    a64, c64 = setup.to_device(torch.float64, "cpu", iters=ITERS,
                               iters2=ITERS2, alpha=ALPHA,
                               rho2_scale=RHO2_SCALE, solver="admm")
    runs["admm_f64_cpu"] = make_batched_rollout(a64, c64, T)(
        x0.double().cpu(), refs.double().cpu(), w.cpu(), theta.cpu(),
        gamma.cpu())
    (ck, ok), (ca, oa) = runs["cuda"], runs["admm"]
    c64_, o64 = runs["admm_f64_cpu"]
    dx = _max_err(ok.x, oa.x)
    dx64 = _max_err(ok.x, o64.x)
    print("closed-loop parity B=%d T=%d: max|dx| cuda-vs-admm %.3e, "
          "cuda-vs-admm(f64, CPU) %.3e" % (B_PARITY, T, dx, dx64))
    for other_c, other_o in ((ca, oa), (c64_, o64)):
        _require(torch.equal(ok.Theta.cpu(), other_o.Theta.cpu()))
        _require(torch.equal(ck.feasible.cpu(), other_c.feasible.cpu()))
    _require(dx <= DX_PARITY and dx64 <= DX_PARITY, (dx, dx64))


SERVE_TICKS = 15000
SERVE_F64_TICKS = 120     # the ticks held to the float64 CPU run
GRAPH_TOL = 1e-6          # graph against eager, same kernels (read: 0)
EXAMPLES = ("regulator", "tracking", "tracking_lossy", "tube_regulator",
            "tube_tracking", "tube_tracking_lossy")


def phase_served_session(setup):
    """Phase 17: the serve app at its defaults through the window graph.
    Returns the session's kernel launches (captured x replays)."""
    from rtmpc_tpu_torch.apps import serve_controller
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    args = serve_controller.parse_args(["--device", "cuda"])
    _reset_launches()              # the main path's run: counts from 0
    t0 = time.perf_counter()
    out = serve_controller.run(args, setup)
    torch.cuda.synchronize()
    raw = admm_solve_cuda.launches
    ses = out["session"]
    print("served session done in %.1f s: kernel launches %d run (%d "
          "captured a window x %d replays), %d through the wrapper (warm-up,"
          " capture, the eager window, the per-dispatch run)"
          % (time.perf_counter() - t0, ses.launches, ses.captured_launches,
             ses.replays, raw))
    _require(out["ok"], "the serve app's checks")
    _require(ses.graph is not None and ses.captured_launches == 2 * ses.window,
             ses.captured_launches)
    _require(ses.launches == 2 * SERVE_TICKS and raw > 0,
             (ses.launches, raw))
    by_path = dict(admm_solve_cuda.launches_by_path)
    print("launches through the wrapper by path: %s" % by_path)
    _require(by_path["fac"] == raw, by_path)
    first, eager = out["first"], out["first_eager"]
    dg = max(_max_err(a, b) for a, b in zip(first, eager))
    print("window 1, graph vs eager: max |diff| over all outputs %.3e" % dg)
    _require(dg <= GRAPH_TOL, dg)
    # the flagship bar: the first ticks against float64 on the CPU
    refs, theta, gamma, w = out["inputs"]
    n = SERVE_F64_TICKS
    a64, c64 = setup.to_device(torch.float64, "cpu", solver="admm",
                               **serve_controller.SCHEDULE)
    _, o64 = make_batched_rollout(a64, c64, n)(
        torch.zeros(1, 2, dtype=torch.float64),
        *(torch.tensor(a[:n])[None] for a in (refs, w)),
        *(torch.tensor(a[:n], dtype=torch.int32)[None]
          for a in (theta, gamma)))
    dx = _max_err(first.x[0, :n], o64.x[0])
    print("first %d ticks against solver admm in float64 on the CPU: max "
          "|dx| %.3e (bar %g; K1 at B=1 runs its one 152-term chain, see "
          "phase 18)" % (n, dx, DX_PARITY))
    _require(dx <= DX_PARITY, dx)
    _require(torch.equal(first.Theta[:, :n].cpu(), o64.Theta))
    pt = out["per_tick_ms"]
    print("window-mean tick time through the graph: p50 %.4f p99 %.4f ms; "
          "eagerly %.4f ms a tick; device time a tick %.4f ms; per dispatch "
          "(the per-tick tail) p99 %.4f ms; dispatch floor %.4f ms"
          % (np.median(pt), np.quantile(pt, 0.99), out["eager_per_tick_ms"],
             out["device_per_tick_ms"], out["latency"]["p99_ms"],
             out["floor_ms"]))
    return ses.launches, ses.captured_launches


def phase_k1_b1(arrays, arrays64, dev):
    """Phase 18: K1 at the served shape, B=1 (the "fac" path).  Returns
    (max error, ms, plain ms, (bound ms, bound by, torch.mm ms), the smem
    path's ms in the same call)."""
    from rtmpc_tpu_torch.ops.kernel_bench import (F64_SMALL_B, Y_ATOL_SMALL_B,
                                                  Z_ATOL)
    rng = np.random.default_rng(18)
    th = torch.tensor(rng.uniform(-2, 2, (1, 4)), dtype=torch.float32,
                      device=dev)
    specs, specs64 = ((a.admm, a.admm2) for a in (arrays, arrays64))
    err = _compare(specs, specs64, th, th, True, (ITERS, ITERS2),
                   (Z_ATOL, Y_ATOL_SMALL_B), label="served shape",
                   f64_bars=F64_SMALL_B)
    ms, plain_ms, bound, before = _fac_timing(
        "served shape 40+112", 1, arrays.admm, th, ITERS, dev, reps=50)
    return err, ms, plain_ms, bound, before


def phase_examples(solvers):
    """Phase 19: the six examples at full length under ``solvers``: "ip"
    (the dense IP in float64, run beside phase 15) and "cuda" (the
    kernel)."""
    for name in EXAMPLES:
        mod = importlib.import_module("rtmpc_tpu_torch.apps.example_" + name)
        for solver in solvers:
            args = mod.parse_args(["--device", "cuda", "--solver", solver])
            out = mod.run(args)
            print("example_%s --solver %s (%s): %s in %.3f s, %d kernel "
                  "launches" % (name, solver, args.dtype,
                                "checks pass" if out["ok"] else "FAIL",
                                out["seconds"], out["launches"]))
            _require(out["ok"], (name, solver))
            _require((out["launches"] > 0) == (solver == "cuda"),
                     (name, solver, out["launches"]))


def phase_crossover(flagship_spec, tube_spec, dev):
    """The crossover of the "fac" path against the composite paths: one
    phase's device time on each (graph replay, in turns) at B in
    ``kernel_bench.CROSSOVER_BATCHES`` on the flagship's QP (60
    iterations) and the cartpole tube QP (200); prints the table and the
    largest B up to which "fac" is the faster on both, beside the
    dispatch's ``FAC_MAX_B``; fails if that B is below it."""
    from rtmpc_tpu_torch.ops.kernel_bench import crossover
    from rtmpc_tpu_torch.ops.qp_cuda import FAC_MAX_B
    res = crossover({"flagship 40+112": flagship_spec,
                     "cartpole tube 112+792": tube_spec},
                    {"flagship 40+112": ITERS,
                     "cartpole tube 112+792": CP_ITERS}, dev, reps=3)
    print("crossover: \"fac\" the faster up to B=%s on both shapes (of %s); "
          "the dispatch takes it up to FAC_MAX_B=%d (%s)"
          % (res["b_star"], list(res)[:-1], FAC_MAX_B,
             torch.cuda.get_device_name(0)))
    # the dispatch's rule holds on this card: "fac" the faster at every
    # batch it is given below 1024 columns
    _require(res["b_star"] is not None and res["b_star"] >= FAC_MAX_B,
             (res["b_star"], FAC_MAX_B))
    return res


def _cartpole_thetas(sc, B, rng, dev, dtype):
    theta = np.zeros((B, 8))
    theta[:, :4] = rng.uniform(-1, 1, (B, 4)) * np.array([0.3, 0.5, 0.05,
                                                           0.5])
    theta[:, 4] = rng.uniform(-1.0, 6.0, B)   # 6 m is outside X: saturates
    return torch.tensor(theta, dtype=dtype, device=dev)


def phase_cartpole_kernel(sc, qps, dev, bars, f64_small_bars, seed,
                          time_b1=False):
    """Phases 8 and 13: K1 against its plain version at the cartpole
    controllers' shapes (the cluster path by width; "fac" at the small
    batches, and at every batch above 1024 columns).  ``qps``: by label, a
    QP's ``(specs, specs64)``, each the pair (phase-1 spec, phase-2 spec),
    in float32 and float64 on the card.  Returns by label ``(errors, ms,
    plain ms, (bound ms, bound by, torch.mm ms), before ms)`` of one timed
    phase at B=200 (before: the cluster path's time in the same call where
    B=200 takes "fac", else None), and with ``time_b1`` the same at B=1
    under ``label + " B=1"``; errors: ``{B: (path, max error)}`` of the
    QP's comparisons (``_err_of`` reads them)."""
    from rtmpc_tpu_torch.ops.kernel_bench import time_ms as _time_ms
    from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_plain,
                                             admm_solve_cuda, kernel_path,
                                             kernel_rows)
    rng = np.random.default_rng(seed)
    out = {}
    for label, (specs, specs64) in qps.items():
        n_p, m_p = specs[0].Kinv.shape[0], specs[0].As.shape[0]
        rows = kernel_rows(n_p, m_p)
        batches = CP_BATCHES + (1, rows - 1, rows + 1)
        print("%s QP: n_p + m_p = %d + %d (%s path by width, %d rows a "
              "cluster); paths at B=%s: %s"
              % (label, n_p, m_p, kernel_path(n_p + m_p), rows, batches,
                 [kernel_path(n_p + m_p, B, n_p) for B in batches]))
        _require(kernel_path(n_p + m_p) == "l2", (label, n_p, m_p))
        err = {}
        for B in batches:
            th = _cartpole_thetas(sc, B, rng, dev, torch.float32)
            err[B] = (kernel_path(n_p + m_p, B, n_p), _compare(
                specs, specs64, th, th, B == 200, (CP_ITERS, CP_ITERS),
                bars, label=label,
                f64_bars=None if B in CP_BATCHES else f64_small_bars))
        th = _cartpole_thetas(sc, 200, rng, dev, torch.float32)
        name = "cartpole %s %d+%d" % (label, n_p, m_p)
        if kernel_path(n_p + m_p, 200, n_p) == "fac":
            out[label] = (err,) + _fac_timing(name, 200, specs[0], th,
                                              CP_ITERS, dev, reps=5)
        else:
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = admm_solve_cuda if which == "kernel" else \
                    _admm_solve_plain
                t[which].append(_time_ms(
                    lambda: fn(specs[0], th, None, CP_ITERS), reps=5))
            print("%s QP, one %d-iteration phase, B=200: kernel %s ms, "
                  "plain %s ms" % (label, CP_ITERS, t["kernel"], t["plain"]))
            ms, plain_ms = (float(np.mean(t[k])) for k in ("kernel",
                                                            "plain"))
            out[label] = (err, ms, plain_ms, _product_yardstick(
                name, 200, specs[0], th, CP_ITERS, ms, dev), None)
        if time_b1:
            th = _cartpole_thetas(sc, 1, rng, dev, torch.float32)
            out[label + " B=1"] = (err,) + _fac_timing(
                name, 1, specs[0], th, CP_ITERS, dev)
    return out


def _err_of(by_label, path=None, B=None):
    """The largest kernel-vs-plain error of ``phase_cartpole_kernel``'s
    comparisons over its QPs, of those on ``path`` and at batch ``B``
    (None: any)."""
    return max(e for errs, *_ in by_label.values()
               for b, (p, e) in errs.items()
               if path in (None, p) and B in (None, b))


def _admm_qps(setup, dev, pr=False):
    """``{label: (specs, specs64)}`` of a controller under the apps'
    ``--solver cuda`` schedule, for ``phase_cartpole_kernel``: its QP, or
    with ``pr`` an extended controller's two."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    a32, a64 = (setup.to_device(dt, dev, solver="cuda", **ADMM_SCHEDULE)[0]
                for dt in (torch.float32, torch.float64))
    qps = {"": ((a32.admm, a32.admm2), (a64.admm, a64.admm2))}
    if pr:
        qps = {"normal": qps[""],
               "packet-received": ((a32.admm_pr, a32.admm2_pr),
                                   (a64.admm_pr, a64.admm2_pr))}
    return qps


def phase_ip_card_vs_cpu(sc, setups, dev, traj):
    """Phase 9: ``ip_riccati_solve`` in float64 on the card against the
    CPU on 64 thetas from a sweep: nominal states of its sample runs
    (``traj``, (P, T, 4): the RT-MPC arm of phase 15's float64 sweep on the
    nonlinear plant, run 5 at each loss probability, every 37th step;
    a true plant state can leave the tightened set and make the QP
    infeasible), reference 0.5, every eighth 6 m (outside X: it
    saturates)."""
    from rtmpc_tpu_torch.ops.ip_riccati import ip_riccati_solve
    P, T = traj.shape[:2]
    theta = np.zeros((IP_B, 8))
    for i in range(IP_B):
        theta[i, :4] = traj[i % P, (37 * i) % T]
    theta[:, 4] = sc.ref_value
    theta[::8, 4] = 6.0
    worst = {}
    for arm, setup in setups.items():
        tmpl = setup.template
        sols = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            arrays, cfg = setup.to_device(torch.float64, d,
                                          solver="ip_riccati", ip_iters=30)
            th = torch.tensor(theta, dtype=torch.float64, device=d)
            t0 = time.perf_counter()
            sols[where] = ip_riccati_solve(arrays.ric, th, cfg.N,
                                           iters=cfg.ip_iters)
            if where == "card":
                torch.cuda.synchronize()
            print("%s QP, B=%d, on the %s: %.2f s" % (
                arm, IP_B, where, time.perf_counter() - t0))
        card, cpu = sols["card"], sols["cpu"]
        z_card = card.z_primal.cpu().numpy()
        z_cpu = cpu.z_primal.numpy()
        dz = float(np.abs(z_card - z_cpu).max())
        q = theta @ tmpl.Mq.T + tmpl.q0

        def objective(z):
            return 0.5 * np.einsum("bi,ij,bj->b", z, tmpl.P, z) \
                + (q * z).sum(1)

        o_card, o_cpu = objective(z_card), objective(z_cpu)
        dobj = float((np.abs(o_card - o_cpu) / np.abs(o_cpu)).max())
        res = {k: float(getattr(card, k).max())
               for k in ("r_prim", "r_dual")}
        res_cpu = {k: float(getattr(cpu, k).max())
                   for k in ("r_prim", "r_dual")}
        print("%s QP: card vs CPU max|dz| %.3e, objective rel %.3e; "
              "card r_prim %.3e r_dual %.3e, CPU r_prim %.3e r_dual %.3e"
              % (arm, dz, dobj, res["r_prim"], res["r_dual"],
                 res_cpu["r_prim"], res_cpu["r_dual"]))
        worst[arm] = dict(dz=dz, dobj=dobj, card=res, cpu=res_cpu)
    for arm, w in worst.items():       # after both arms' readings are out
        for r in (w["card"], w["cpu"]):
            _require(r["r_prim"] <= IP_R_PRIM and r["r_dual"] <= IP_R_DUAL,
                     (arm, r))
        _require(w["dobj"] <= IP_OBJ_RTOL, (arm, w["dobj"]))
        _require(w["dz"] <= IP_Z_ATOL, (arm, w["dz"]))
    return worst


def phase_sweep(solver, out_json, setups, quick=False):
    """Phases 10 and 11: the app's sweep on the card, at its ``--quick``
    depth if ``quick``."""
    from rtmpc_tpu_torch.apps import results_linear
    args = results_linear.parse_args(
        ["--device", "cuda", "--solver", solver, "--save-json", out_json,
         "--no-figures"] + (["--quick"] if quick else []))
    t0 = time.perf_counter()
    out = results_linear.run(args, (setups["tube"], setups["track"]))
    print("sweep (%s%s) done in %.1f s" % (solver, ", --quick" if quick
                                            else "", time.perf_counter() - t0))
    for arm in ("tube", "track"):
        res = out[arm]
        _require(res.tracking_error.shape == ((4, 4) if quick else (10, 20)),
                 res.tracking_error.shape)
        for a in (res.sample_traj, res.sample_x_nom):
            _require(bool(np.isfinite(a).all()), (solver, arm))
    _require(bool(out["tube"].feasible.all()), "tube arm feasible")
    _require(bool(np.isfinite(out["tube"].tracking_error).all()))
    return out


def _reset_launches():
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    torch.cuda.synchronize()
    admm_solve_cuda.launches = 0
    for path in admm_solve_cuda.launches_by_path:
        admm_solve_cuda.launches_by_path[path] = 0


def _sample_tube_violation(res, arrays):
    """max ``Hz (x_t - x_nom_t) - hz`` over a sweep's sample trajectories
    (x_0 = 0 and the post-step states but the last)."""
    P = res.sample_traj.shape[0]
    xs = np.concatenate([np.zeros((P, 1, 4)), res.sample_traj[:, :-1]], 1)
    Hz, hz = (t.double().cpu().numpy() for t in (arrays.Hz, arrays.hz))
    return float(((xs - res.sample_x_nom) @ Hz.T - hz).max())


def _require_sweep_finite(out, what):
    for name, res in out["results"].items():
        _require(res.tracking_error.shape == (10, 20), (what, name))
        for a in (res.sample_traj, res.sample_x_nom):
            _require(bool(np.isfinite(a).all()), (what, name))


# Kernel launches through the wrapper of each app's Fig. 3d timing under
# --solver cuda: an arm's one-tick session runs its tick once eagerly
# (warm-up) and once under capture; the replays launch nothing through it.
# RT-MPC solves 1 QP a tick, Ext-RT-MPC 2, in 2 phases each.
FIG3D_LAUNCHES = {"results_linear": 2 * 2,
                  "results_linear_extended": 2 * 2 + 2 * 4,
                  "results_nonlinear": 0}
# kernel launches a step of each arm under --solver cuda: 2 phases a QP,
# and one more for each QP that is certified
LAUNCHES_A_STEP = {
    "results_linear_extended": {"RT-MPC": 2, "Ext-RT-MPC": 4, "R-MPC": 3},
    "results_nonlinear": {"RT-MPC": 2, "R-MPC": 3, "Ext-RT-MPC": 6}}
MAX_ANGLE = 0.3 + 1e-3


def phase_new_apps_cuda(setups, out_dir):
    """Phase 14: both new apps at full size through the kernel.  Returns
    the launches of the extended arms (1760 columns at B=200, the "fac"
    path), of the two apps on the cluster path, and of the Ext-RT-MPC arm
    of Fig. 3d (1760 columns at B=1 on "fac": its one-tick graph's warm-up
    and capture)."""
    from rtmpc_tpu_torch.apps import results_linear_extended, results_nonlinear
    from rtmpc_tpu_torch.apps.common import solve_time_stats
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    ext_launches = l2_launches = fig3d_ext = 0
    for mod, extra in ((results_linear_extended, []),
                       (results_nonlinear, ["--extended"])):
        app = mod.__name__.rsplit(".", 1)[1]
        args = mod.parse_args(
            ["--device", "cuda", "--solver", "cuda", "--no-figures",
             "--save-json", os.path.join(out_dir, app + "_cuda.json")]
            + extra)
        _reset_launches()          # the main path's run: counts from 0
        t0 = time.perf_counter()
        out = mod.run(args, setups)
        torch.cuda.synchronize()
        by_path = dict(admm_solve_cuda.launches_by_path)
        T = out["T"]
        got = {arm: c["kernel_launches"] for arm, c in out["counts"].items()}
        print("%s --solver cuda done in %.1f s; kernel launches %s (by "
              "path %s); the app's checks %s"
              % (app, time.perf_counter() - t0, got, by_path,
                 "pass" if out["ok"] else "FAIL (printed, not gated)"))
        want = {arm: n * T for arm, n in LAUNCHES_A_STEP[app].items()}
        _require(got == want, (app, got, want))
        # the extended arm's QPs (1760 columns) and every B=1 tick of Fig.
        # 3d on "fac", the other arms' B=200 on the cluster path
        _require(by_path["fac"] == want["Ext-RT-MPC"] + FIG3D_LAUNCHES[app]
                 and by_path["l2"] == want["RT-MPC"] + want["R-MPC"]
                 and by_path["smem"] == 0, (app, by_path))
        l2 = by_path["l2"]
        _print_rows_vs_truth(app, out["rows"], mod.TRUTH)
        if FIG3D_LAUNCHES[app]:
            _print_fig3d(app + " --solver cuda", out["payload"])
            fig3d = solve_time_stats.launches
            print("%s Fig. 3d kernel launches through the wrapper by arm "
                  "and path: %s" % (app, fig3d))
            _require(sum(sum(c.values()) for c in fig3d.values())
                     == sum(c["fac"] for c in fig3d.values())
                     == FIG3D_LAUNCHES[app], fig3d)
            fig3d_ext = fig3d["Ext-RT-MPC"]["fac"]
        _require_sweep_finite(out, app)
        res = out["results"]
        for arm in ("RT-MPC", "Ext-RT-MPC"):
            _require(bool(res[arm].feasible.all()), (app, arm, "feasible"))
            viol = _sample_tube_violation(res[arm], out["arrays"][arm])
            print("%s %s: tube invariant on the sample trajectories, max "
                  "Hz(x - x_nom) - hz = %.3e" % (app, arm, viol))
            if arm == "RT-MPC":
                _require(viol <= TUBE_TOL, (app, arm, viol))
        if app == "results_nonlinear":
            _require(out["max_angle"] <= MAX_ANGLE, out["max_angle"])
        ext_launches += got["Ext-RT-MPC"]
        l2_launches += l2
    return ext_launches, l2_launches, fig3d_ext


def _print_rows_vs_truth(app, rows, truth_path):
    """Prints each arm's largest relative distance of its per-p mean RMS to
    the JAX package's float64 interior-point rows, and its stopped runs
    beside theirs (the `cuda` rows of the extended app sit 9-27% from the
    truth: the ADMM's own distance, ``PERF.md`` 6)."""
    with open(truth_path) as f:
        truth = {r["p"]: r for r in json.load(f)["rows"]}
    arms = sorted(k[4:] for k in rows[0] if k.startswith("rms_"))
    for arm in arms:
        d = max(abs(r["rms_" + arm] - truth[r["p"]]["rms_" + arm])
                / truth[r["p"]]["rms_" + arm] for r in rows)
        stops = sum(r["infeasible_" + arm] for r in rows)
        stops_truth = sum(truth[r["p"]]["infeasible_" + arm] for r in rows)
        print("%s --solver cuda, %s: per-p mean RMS at most %.4f relative "
              "from %s; stopped runs %d (float64 IP %d)"
              % (app, arm, d, os.path.basename(truth_path), stops,
                 stops_truth))


# Phase 15's arms: app module, arm label, the controller it needs
F64_ARMS = (("results_linear_extended", "Ext-RT-MPC", "ext"),
            ("results_nonlinear", "RT-MPC", "tube"))


def phase_new_f64(app, arm, setups, out_dir):
    """One arm of phase 15: runs it at full size in float64 ``ip_riccati``
    and fails unless it is feasible everywhere and its rows pass the app's
    comparison with the JAX package's float64 rows.  Returns the arm's
    sweep."""
    mod = importlib.import_module("rtmpc_tpu_torch.apps." + app)
    args = mod.parse_args(
        ["--device", "cuda", "--no-figures", "--save-json",
         os.path.join(out_dir, "%s_%s_ip_riccati.json" % (app, arm))])
    t0 = time.perf_counter()
    out = mod.run(args, setups, arms=(arm,))
    print("%s, arm %s, float64 ip_riccati done in %.1f s (held to %s)"
          % (app, arm, time.perf_counter() - t0, os.path.basename(mod.TRUTH)))
    _require(out["ok"] and out["compared"], (app, "checks"))
    if app == "results_linear_extended":
        _print_fig3d(app + " " + arm + " ip_riccati", out["payload"])
    res = out["results"][arm]
    _require(bool(res.feasible.all()), (app, arm, "feasible"))
    _require_sweep_finite(out, app)
    viol = _sample_tube_violation(res, out["arrays"][arm])
    print("%s: max Hz(x - x_nom) - hz on the sample trajectories %.3e"
          % (arm, viol))
    if app == "results_linear_extended":
        with open(mod.TRUTH) as f:
            e_tube = json.load(f)["rows"][-1]["rms_RT-MPC"]
        e_ext = out["rows"][-1]["rms_Ext-RT-MPC"]
        print("extended arm at p=0.9: %.5f against 1.5 x %.5f (the "
              "reference's RT-MPC there)" % (e_ext, e_tube))
        _require(e_ext < 1.5 * e_tube, (e_ext, e_tube))
    else:
        _require(viol <= TUBE_TOL, (app, arm, viol))
        _require(out["max_angle"] <= MAX_ANGLE, out["max_angle"])
    return res


# The interior points that run eagerly (phases 10, 15, 19's dense IP half
# and 25 (a)) are bound by one host thread's launches and leave the card
# idle nine tenths of the time: they run side by side in worker processes,
# the longest first, while this process runs phases 26 and 24 (a-d).  One
# after the other (15's two arms side by side), phases 10, 15, 19's dense
# IP half, 25 (a) and 26 took 563.7 s of an 896.2 s run on an NVIDIA H100
# 80GB HBM3 at 700 W; side by side, without 24 (a-d), 335.0 s in another
# run on the same model of card.
SIDE_WORKERS = 3


def _side_init():
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _side_job(fn, *args):
    """A worker process's job in ``phase_side_by_side``: ``fn(*args)`` with
    its output captured.  Returns what it printed, its result and, if it
    failed, the traceback."""
    printed, result, failure = io.StringIO(), None, None
    with contextlib.redirect_stdout(printed):
        try:
            result = fn(*args)
            _require("jax" not in sys.modules)
        except Exception:
            failure = traceback.format_exc()
    return printed.getvalue(), result, failure


def _job_f64_arm(app, arm, controller, out_dir):
    """Phase 15, one arm: sets its controller up and runs
    ``phase_new_f64``.  Returns the arm's sampled nominal states."""
    from rtmpc_tpu_torch.apps.common import cartpole_controllers
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    setups = cartpole_controllers(cartpole_scenario(), (controller,))
    return phase_new_f64(app, arm, setups, out_dir).sample_x_nom


def _job_sweep_ip(out_dir):
    """Phase 10: the Fig. 3a sweep in float64 ``ip_riccati`` at the app's
    ``--quick`` depth."""
    from rtmpc_tpu_torch.apps.common import cartpole_controllers
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    sweep = phase_sweep(
        "ip_riccati", os.path.join(out_dir, "results_linear_ip_riccati.json"),
        cartpole_controllers(cartpole_scenario(), ("tube", "track")),
        quick=True)
    _require(sweep["ok"], "phase 10 checks")


def _job_hybrid_sweep():
    """Phase 25 (a), ``phase_hybrid_sweep``."""
    from rtmpc_tpu_torch.apps.common import cartpole_controllers
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    t0 = time.perf_counter()
    sc = cartpole_scenario()
    phase_hybrid_sweep(sc, cartpole_controllers(sc, ("tube",)),
                       torch.device("cuda", 0))
    print("phase 25 (a) took %.1f s" % (time.perf_counter() - t0))


def phase_side_by_side(out_dir, meanwhile):
    """Phases 15 (both arms), 10, 25 (a) and 19's dense interior point in
    ``SIDE_WORKERS`` worker processes, while this process runs
    ``meanwhile()``.  Each job's output is printed once all are done; the
    times it printed are its times beside the others.  Returns phase 15's
    last arm's sampled nominal states and what ``meanwhile()`` returned."""
    jobs = [("phase 15, %s %s" % (app, arm), _job_f64_arm,
             (app, arm, controller, out_dir))
            for app, arm, controller in F64_ARMS]
    jobs += [("phase 10", _job_sweep_ip, (out_dir,)),
             ("phase 25 (a)", _job_hybrid_sweep, ()),
             ("phase 19, the dense interior point", phase_examples,
              (("ip",),))]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            SIDE_WORKERS, multiprocessing.get_context("spawn"),
            initializer=_side_init) as pool:
        futures = [pool.submit(_side_job, fn, *args) for _, fn, args in jobs]
        own = meanwhile()
        t_own = time.perf_counter() - t0
        done = [f.result() for f in futures]
    for (label, _, _), (printed, _, failure) in zip(jobs, done):
        print("--- %s ---\n%s" % (label, printed.rstrip() + "\n"
                                  + (failure or "")))
    print("phases 10, 15, 19 (dense IP) and 25 (a) took %.1f s side by side "
          "in %d processes (this process's own work %.1f s)"
          % (time.perf_counter() - t0, SIDE_WORKERS, t_own))
    _require(not any(failure for _, _, failure in done),
             [label for (label, _, _), d in zip(jobs, done) if d[2]])
    return done[len(F64_ARMS) - 1][1], own


def phase_plant(sc, dev):
    """Phase 16: the nonlinear plant on the card against the CPU."""
    from rtmpc_tpu_torch.models.plants import cartpole_zoh_step
    rng = np.random.default_rng(16)
    x = torch.tensor(rng.uniform(-1, 1, (4096, 4)) * [2.0, 3.0, 0.6, 2.5])
    f = torch.tensor(rng.uniform(-10, 10, 4096))
    worst = 0.0
    for method in ("semi_implicit_euler", "rk4"):
        cpu = cartpole_zoh_step(sc.params, x, f, sc.Th, sc.physics_substeps,
                                method=method)
        card = cartpole_zoh_step(sc.params, x.to(dev), f.to(dev), sc.Th,
                                 sc.physics_substeps, method=method)
        worst = max(worst, _max_err(card, cpu))
    print("cartpole_zoh_step, card vs CPU, float64, B=4096: max |dx| %.3e"
          % worst)
    _require(worst <= 1e-12, worst)


# Phase 20, Fig. 3d through the captured interior point.
T_FIG3D = 250             # results_linear's full T
# captured ticks held to the eager ticks (cut from 20: an eager tick takes
# 0.62 s in float64 and 1.35 s under the hybrid)
GRAPH_TICKS = 5
IP_GRAPH_TOL = 1e-9


def _print_fig3d(label, payload):
    """Prints an app's Fig. 3d statistics (``solve_time_stats`` of its
    JSON payload: one report, or one an arm) beside the card's name."""
    stats = payload["solve_time_stats"]
    if "n_solves" in stats:
        stats = {"RT-MPC": stats}
    for arm, st in stats.items():
        print("Fig. 3d, %s, %s: %d ticks, one dispatch a tick: p50 %.4f p99 "
              "%.4f max %.4f ms (%s)"
              % (label, arm, st["n_solves"], st["median_ms"], st["p99_ms"],
                 st["max_ms"], torch.cuda.get_device_name(0)))
        _require(st["n_solves"] > 0 and np.isfinite(st["max_ms"]), arm)


def phase_fig3d_ip(sc, setups, dev, solver="ip_riccati", n_ticks=T_FIG3D):
    """Phase 20 (and 25 b under ``solver="ip_hybrid"``): Fig. 3d under the
    structured interior point, the app's dtype for the solver (float64;
    float32 under the hybrid, whose interior point is float64 all the
    same), one tick a dispatch, each tick one replay of a one-tick CUDA
    graph that holds the whole interior point (its fixed iteration budget,
    both phases of the hybrid, no read of the device): its first ticks
    equal the same ticks run eagerly (early exit) to ``IP_GRAPH_TOL``, then
    results_linear's statistics over ``n_ticks`` ticks (its full T by
    default).  Returns the statistics and the session's capture and
    instantiation seconds."""
    from rtmpc_tpu_torch.apps import results_linear
    from rtmpc_tpu_torch.apps.common import (fig3d_inputs, resolve,
                                             solve_time_stats, solver_kwargs)
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    from rtmpc_tpu_torch.parallel.session import Session
    args = results_linear.parse_args(["--device", "cuda", "--no-figures",
                                      "--solver", solver])
    resolve(args)
    dtype = getattr(torch, args.dtype)
    arrays, cfg = setups["tube"].to_device(dtype, dev, **solver_kwargs(args))
    inputs = fig3d_inputs(args.seed, sc, T_FIG3D)
    refs, w, theta, gamma = (
        torch.as_tensor(a[:GRAPH_TICKS], dtype=d).to(dev)
        for a, d in zip(inputs, (dtype, dtype, torch.int32, torch.int32)))
    t0 = time.perf_counter()
    ses = Session(arrays, cfg, 1, sc.x0)
    torch.cuda.synchronize()
    print("one-tick %s session (%s) built in %.2f s: capture %.2f s, "
          "instantiation %.2f s (warm-up tick, eager, included in the "
          "first)" % (solver, args.dtype, time.perf_counter() - t0,
                      ses.capture_s, ses.instantiate_s))
    _require(ses.graph is not None)
    ticks = []
    for t in range(GRAPH_TICKS):
        o = ses.advance(refs[t:t + 1], w[t:t + 1], theta[t:t + 1],
                        gamma[t:t + 1])
        ticks.append(tuple(a.clone() for a in o))
    graph = [torch.cat(f, dim=1) for f in zip(*ticks)]
    t0 = time.perf_counter()
    _, eager = make_batched_rollout(arrays, cfg, GRAPH_TICKS)(
        torch.as_tensor(sc.x0, dtype=dtype).to(dev)[None],
        refs[None], w[None], theta[None], gamma[None])
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    dg = max(_max_err(a, b) for a, b in zip(graph, eager))
    print("first %d ticks, graph vs eager (%.3f s a tick eagerly): max "
          "|diff| over all outputs %.3e (bar %g)"
          % (GRAPH_TICKS, t_eager / GRAPH_TICKS, dg, IP_GRAPH_TOL))
    _require(dg <= IP_GRAPH_TOL, dg)
    _require(bool(eager.feasible.all()))
    t0 = time.perf_counter()
    stats = solve_time_stats(args, sc,
                             {"RT-MPC": (arrays, cfg, "consistent")},
                             n_ticks)
    print("results_linear Fig. 3d under %s (%s), %d ticks, in %.1f s"
          % (solver, args.dtype, n_ticks, time.perf_counter() - t0))
    _print_fig3d("results_linear " + solver, {"solve_time_stats":
                                              stats["RT-MPC"]})
    return stats["RT-MPC"], (ses.capture_s, ses.instantiate_s)


def phase_estimate_w(sc, dev):
    """Phase 21: ``estimate_w`` at its defaults on the card, its two
    checks, and its box against the port's float64 run on the CPU from the
    same initial states (1e-10)."""
    from rtmpc_tpu_torch.apps import estimate_w
    args = estimate_w.parse_args(["--device", "cuda"])
    out = estimate_w.run(args)
    _require(out["ok"], "estimate_w checks")
    x0s = estimate_w.draw_initial_states(args.n_rollouts, args.seed)
    box_cpu, _ = estimate_w.estimate_w_box(sc, x0s, 150)
    d = float(np.abs(out["w_box"] - box_cpu).max())
    print("estimate_w: %d rollouts x 150 steps on the card in %.3f s; box "
          "against the CPU run %.3e" % (args.n_rollouts, out["seconds"], d))
    _require(d <= 1e-10, d)


def phase_animations(setups):
    """Phase 22: ``create_animations.run`` under ``--solver cuda`` at full
    T, K1 at B=1 on the cartpole QPs ("fac", 2 launches a step on each arm), the
    JAX app's checks; no rendering.  Gated: both arms finite, the tube
    arm's |phi| < 0.3.  The tracking arm's |phi| bound is printed, not
    gated: the non-robust arm reaches it under ADMM in float64 on the CPU
    too (max |phi| 0.300 on the same seed, 0.177 under ip_riccati), so it
    reads the ADMM's accuracy on the cartpole, not K1's.  Returns the
    launches."""
    from rtmpc_tpu_torch.apps import create_animations
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    args = create_animations.parse_args(
        ["--device", "cuda", "--solver", "cuda", "--no-figures"])
    _reset_launches()              # the main path's run: counts from 0
    out = create_animations.run(args, setups)
    torch.cuda.synchronize()
    T = out["traj"]["tube"].shape[0] - 1
    print("create_animations --solver cuda: T=%d, seconds %s, launches %s "
          "(by path %s); checks %s"
          % (T, {k: round(v, 3) for k, v in out["seconds"].items()},
             out["launches"], dict(admm_solve_cuda.launches_by_path),
             "pass" if out["ok"] else
             "FAIL (printed; the tracking arm's |phi| bound is not gated)"))
    _require(all(bool(np.isfinite(t).all()) for t in out["traj"].values()),
             "create_animations finite")
    _require(out["max_phi"]["tube"] < 0.3, out["max_phi"])
    _require(out["launches"] == {"tube": 2 * T, "track": 2 * T},
             out["launches"])
    fac = admm_solve_cuda.launches_by_path["fac"]
    _require(fac == admm_solve_cuda.launches == 4 * T, fac)
    return fac


def phase_k1_cluster_b1(sc, setups, dev):
    """K1 at B=1 on the cartpole tube QP, the shape of ``create_animations``
    and of Fig. 3d under ``--solver cuda`` (200 iterations; the "fac"
    path): its time beside the cluster path's in the same call, the plain
    version's, its bound and ``torch.mm``.  (Its errors against the plain
    version at B=1 are phase 8's.)"""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    spec = setups["tube"].to_device(torch.float32, dev, solver="cuda",
                                    **ADMM_SCHEDULE)[0].admm
    th = _cartpole_thetas(sc, 1, np.random.default_rng(22), dev,
                          torch.float32)
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    return _fac_timing("cartpole tube %d+%d" % (n_p, m_p), 1, spec, th,
                       CP_ITERS, dev)


# Phase 23, the condensed QPs.
B_COND_CP = 200
T_COND_CP = 60


def _condensed_qps(setup, dev, **kw):
    """``(arrays32, cfg32, (specs, specs64))`` of a condensed controller
    under solver "cuda"."""
    a32, c32 = setup.to_device(torch.float32, dev, solver="cuda",
                               condensed=True, **kw)
    a64, _ = setup.to_device(torch.float64, dev, solver="cuda",
                             condensed=True, **kw)
    return a32, c32, ((a32.admm, a32.admm2), (a64.admm, a64.admm2))


def _timed_phase(label, B, spec, th, iters, dev, reps):
    from rtmpc_tpu_torch.ops.kernel_bench import time_ms as _time_ms
    from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_cuda_plain,
                                             admm_solve_cuda)
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = admm_solve_cuda if which == "kernel" else _admm_solve_cuda_plain
        t[which].append(_time_ms(lambda: fn(spec, th, None, iters),
                                 reps=reps))
    print("%s, one %d-iteration phase, B=%d: kernel %s ms, plain %s ms"
          % (label, iters, B, t["kernel"], t["plain"]))
    ms, plain_ms = (float(np.mean(t[k])) for k in ("kernel", "plain"))
    return ms, plain_ms, _product_yardstick(label, B, spec, th, iters, ms,
                                            dev)


def phase_condensed_flagship(setup, dev):
    """Phase 23a: K1 on the condensed flagship QP (smem path) against its
    plain version at B=16384 and B=1, timed at both; then the condensed
    flagship closed loop at B=16384, T=120 through the kernel: 2 launches
    a step, feasible, finite, the tube invariant at every step, and its
    first B_PARITY rollouts within DX_PARITY of a float64 CPU run of
    solver "admm" on the same condensed QP.  Returns the launches, the
    errors at B=16384 (smem path) and at B=1 ("fac"), and the timings at
    both (at B=1 with the smem path's time in the same call)."""
    from rtmpc_tpu_torch.ops.qp_cuda import (admm_solve_cuda, kernel_path)
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    kw = dict(iters=ITERS, iters2=ITERS2, alpha=ALPHA, rho2_scale=RHO2_SCALE)
    a32, c32, (specs, specs64) = _condensed_qps(setup, dev, **kw)
    n_p, m_p = a32.admm.Kinv.shape[0], a32.admm.As.shape[0]
    print("condensed flagship: %d variables, QP %d+%d (%s path)"
          % (c32.n_red, n_p, m_p, kernel_path(n_p + m_p)))
    _require(kernel_path(n_p + m_p) == "smem", (n_p, m_p))
    from rtmpc_tpu_torch.ops.kernel_bench import (COND_F64_SMALL_B,
                                                  COND_RPRIM_ATOL,
                                                  COND_Y_ATOL, Z_ATOL)
    rng = np.random.default_rng(23)

    def theta(B):
        return torch.tensor(rng.uniform(-2, 2, (B, 4)), dtype=torch.float32,
                            device=dev)

    thf = theta(B_FULL)
    err = _compare(specs, specs64, thf, thf, True, (ITERS, ITERS2),
                   (Z_ATOL, COND_Y_ATOL, COND_RPRIM_ATOL),
                   label="condensed flagship")
    th1 = theta(1)
    err1 = _compare(specs, specs64, th1, th1, True, (ITERS, ITERS2),
                    (Z_ATOL, COND_Y_ATOL, COND_RPRIM_ATOL),
                    label="condensed flagship", f64_bars=COND_F64_SMALL_B)
    full = _timed_phase("condensed flagship %d+%d" % (n_p, m_p), B_FULL,
                        a32.admm, thf, ITERS, dev, 20)
    b1 = _fac_timing("condensed flagship %d+%d" % (n_p, m_p), 1, a32.admm,
                     th1, ITERS, dev, reps=50)

    theta_, gamma, w = _inputs(B_FULL, dev, seed=23)
    refs = _bench_refs(B_FULL, dev, torch.float32)
    x0 = torch.zeros(B_FULL, 2, dtype=torch.float32, device=dev)
    _reset_launches()              # the main path's run: counts from 0
    t0 = time.perf_counter()
    carry, outs = make_batched_rollout(a32, c32, T)(x0, refs, w, theta_,
                                                    gamma)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = admm_solve_cuda.launches
    xs = torch.cat([x0[:, None], outs.x[:, :-1]], dim=1)
    viol = ((xs - outs.x_nom) @ a32.Hz.T - a32.hz).amax().item()
    # parity on phase 7's inputs: against the plain float32 version on the
    # card, and against float64 on the CPU no further than F64_RATIO times
    # plain float32's own distance (condensing makes the float32 loop
    # itself drift further from float64 than the full QP's does)
    from rtmpc_tpu_torch.ops.kernel_bench import F64_RATIO
    n = B_PARITY
    theta_, gamma, w = _inputs(n, dev, seed=1)
    refs, x0 = refs[:n], x0[:n]
    _, ok_ = make_batched_rollout(a32, c32, T)(x0, refs, w, theta_, gamma)
    _, oa = make_batched_rollout(
        a32, dataclasses.replace(c32, solver="admm"), T)(x0, refs, w, theta_,
                                                         gamma)
    a64, c64 = setup.to_device(torch.float64, "cpu", solver="admm",
                               condensed=True, **kw)
    _, o64 = make_batched_rollout(a64, c64, T)(
        x0.double().cpu(), refs.double().cpu(), w.cpu(), theta_.cpu(),
        gamma.cpu())
    dx, dx64, dx_plain64 = (_max_err(ok_.x, oa.x), _max_err(ok_.x, o64.x),
                            _max_err(oa.x, o64.x))
    bar64 = max(DX_PARITY, F64_RATIO * dx_plain64)
    print("condensed flagship loop B=%d T=%d: %.3f s (first run), kernel "
          "launches %d, tube invariant max Hz(x - x_nom) - hz %.3e; parity "
          "B=%d: max|dx| cuda-vs-admm %.3e (bar %g), cuda-vs-admm(f64, CPU) "
          "%.3e (bar %.3e), admm-vs-admm(f64, CPU) %.3e"
          % (B_FULL, T, dt, launches, viol, n, dx, DX_PARITY, dx64, bar64,
             dx_plain64))
    _require(launches == 2 * T, launches)
    _require(bool(carry.feasible.all()) and bool(outs.feasible.all()))
    for name, t in outs._asdict().items():
        if t.is_floating_point():
            _require(bool(torch.isfinite(t).all()), name)
    _require(viol <= TUBE_TOL, viol)
    _require(dx <= DX_PARITY and dx64 <= bar64, (dx, dx64, bar64))
    _require(torch.equal(ok_.Theta.cpu(), o64.Theta))
    return launches, (err, err1), full, b1


def phase_condensed_cartpole(sc, setups, dev):
    """Phase 23b: K1 on the condensed cartpole QPs (cluster path, 16 rows
    a cluster) against its plain version at B=200 and B=1, each timed at
    B=200; then a condensed RT-MPC closed loop through the kernel, B=200
    rollouts of T_COND_CP steps on the sweep's draws: 2 launches a step,
    finite.  Returns the launches, the largest error at B=200 (cluster
    path) and the tube QP's at B=1 ("fac"), the tracking QP's timing and
    the tube QP's at B=1."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    from rtmpc_tpu_torch.ops.kernel_bench import (COND_CP_F64_SMALL_B,
                                                  COND_CP_Y_ATOL, CP_Z_ATOL)
    from rtmpc_tpu_torch.ops.qp_cuda import (admm_solve_cuda, kernel_path,
                                             kernel_rows)
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    from rtmpc_tpu_torch.parallel.mc import draw_sweep
    rng = np.random.default_rng(24)
    err, err1, timing, frozen = 0.0, 0.0, {}, {}
    for name in ("tube", "track"):
        a32, c32, (specs, specs64) = _condensed_qps(setups[name], dev,
                                                    **ADMM_SCHEDULE)
        frozen[name] = (a32, c32)
        n_p, m_p = a32.admm.Kinv.shape[0], a32.admm.As.shape[0]
        rows = kernel_rows(n_p, m_p)
        print("condensed cartpole %s: %d variables, QP %d+%d (%s path, %d "
              "rows a cluster)" % (name, c32.n_red, n_p, m_p,
                                   kernel_path(n_p + m_p), rows))
        _require(kernel_path(n_p + m_p) == "l2" and rows == 16,
                 (name, n_p, m_p, rows))
        for B in (B_COND_CP, 1):
            th = _cartpole_thetas(sc, B, rng, dev, torch.float32)
            e = _compare(
                specs, specs64, th, th, B > 1, (CP_ITERS, CP_ITERS),
                (CP_Z_ATOL, COND_CP_Y_ATOL), label="condensed %s" % name,
                f64_bars=COND_CP_F64_SMALL_B if B == 1 else None)
            if B > 1:
                err = max(err, e)
            elif name == "tube":
                err1 = e
        th = _cartpole_thetas(sc, B_COND_CP, rng, dev, torch.float32)
        timing[name] = _timed_phase("condensed cartpole %s %d+%d"
                                    % (name, n_p, m_p), B_COND_CP,
                                    a32.admm, th, CP_ITERS, dev, 5)
        if name == "tube":
            th = _cartpole_thetas(sc, 1, rng, dev, torch.float32)
            timing["tube B=1"] = _fac_timing(
                "condensed cartpole tube %d+%d" % (n_p, m_p), 1, a32.admm,
                th, CP_ITERS, dev)
    a32, c32 = frozen["tube"]
    g = torch.Generator(device="cpu").manual_seed(24)
    d = draw_sweep(g, T_COND_CP, B_COND_CP // 10, [0.1 * i for i in range(10)],
                   4)
    w = (d.u * torch.tensor(sc.w_hi - sc.w_lo) + torch.tensor(sc.w_lo))
    refs = torch.zeros(B_COND_CP, T_COND_CP, 4, device=dev)
    refs[..., 0] = sc.ref_value
    x0 = torch.tensor(sc.x0, dtype=torch.float32, device=dev).expand(
        B_COND_CP, 4)
    _reset_launches()              # the main path's run: counts from 0
    t0 = time.perf_counter()
    carry, outs = make_batched_rollout(a32, c32, T_COND_CP)(
        x0, refs, w.to(dev, torch.float32), d.theta.to(dev),
        d.gamma.to(dev))
    torch.cuda.synchronize()
    launches = admm_solve_cuda.launches
    xs = torch.cat([x0[:, None], outs.x[:, :-1]], dim=1)
    viol = ((xs - outs.x_nom) @ a32.Hz.T - a32.hz).amax().item()
    print("condensed RT-MPC loop, cartpole, B=%d T=%d: %.3f s, kernel "
          "launches %d, feasible %d of %d, tube invariant max Hz(x - x_nom) "
          "- hz %.3e (printed)" % (B_COND_CP, T_COND_CP,
                                   time.perf_counter() - t0, launches,
                                   int(carry.feasible.sum()), B_COND_CP,
                                   viol))
    _require(launches == 2 * T_COND_CP, launches)
    _require(bool(torch.isfinite(outs.x).all()))
    return launches, (err, err1), timing["track"], timing["tube B=1"]


# Phase 24, data parallelism over rollouts.  On one card two ranks share
# cuda:0 over gloo (NCCL refuses two ranks on one device); no speed-up is
# expected from two processes time-sharing one card, and none is claimed.
DP_RANKS = 2
DP_TIMEOUT_S = 180.0     # each spawn of ranks
# Gathered trajectories against the one-process run.  Read 0 (bitwise) on
# an NVIDIA H100 80GB HBM3 at 700 W, both ranks on cuda:0: rows are
# independent in K1 and in the step, so a shard computes its rows as the
# whole batch does; the bar leaves room for a library that picks another
# kernel at another batch size.
DP_DX = 1e-5
DP_ROWS_RTOL = 1e-6      # the Fig. 3a tube arm's per-p rows


def _dp_flagship_job(setup):
    """(a): the flagship sweep at full width, as ``sweep_rank`` takes it:
    B=16384 runs at 70%/70% loss, T=120, the bench's reference."""
    from rtmpc_tpu_torch.parallel import draw_sweep
    to_dev = dict(dtype=torch.float32, solver="cuda", iters=ITERS,
                  iters2=ITERS2, alpha=ALPHA, rho2_scale=RHO2_SCALE)
    sweep = dict(T=T, n_mc=B_FULL, loss_probs=[P_LOSS],
                 refs=_bench_refs(1, "cpu", torch.float64)[0].numpy(),
                 x0=np.zeros(2), w_lo=-0.1 * np.ones(2),
                 w_hi=0.1 * np.ones(2),
                 draws=draw_sweep(torch.Generator().manual_seed(24), T,
                                  B_FULL, [P_LOSS], 2))
    return setup, to_dev, sweep


def _dp_tube_job(tube_setup):
    """(b): the Fig. 3a tube arm as phase 11 ran it (``results_linear
    --solver cuda`` at full size, the committed seed-0 draws)."""
    from rtmpc_tpu_torch.apps import results_linear
    from rtmpc_tpu_torch.apps.common import (FULL_PROBS, RESULTS_ADMM_ITERS,
                                             solver_kwargs, sweep_draws)
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    args = results_linear.parse_args(["--device", "cuda", "--solver", "cuda",
                                      "--no-figures"])
    sc = cartpole_scenario()
    refs = np.zeros((sc.T, 4))
    refs[:, 0] = sc.ref_value
    draws, _ = sweep_draws(args, torch.device("cpu"), sc.T, args.n_mc,
                           FULL_PROBS, 4, results_linear.DRAWS_SEED0)
    to_dev = dict(dtype=torch.float32,
                  **solver_kwargs(args, admm_iters=RESULTS_ADMM_ITERS))
    sweep = dict(T=sc.T, n_mc=args.n_mc, loss_probs=FULL_PROBS, refs=refs,
                 x0=sc.x0, w_lo=sc.w_lo, w_hi=sc.w_hi, draws=draws,
                 actuator_mode="consistent", n_chunks=args.n_chunks)
    return tube_setup, to_dev, sweep


def _check_dp_flagship(label, ranks, one, one_launches):
    """(a)'s bars on the ranks' results of the flagship job: identical
    across ranks, feasible and finite everywhere, equal to the one-process
    run within ``DP_DX``, K1 2 a step on each rank."""
    res = ranks[0]["result"]
    for r in ranks[1:]:
        for f in ("traj", "x_nom", "tracking_error", "feasible"):
            _require(np.array_equal(getattr(r["result"], f),
                                    getattr(res, f)), (label, "ranks", f))
    launches = [r["launches"] for r in ranks]
    dx = float(np.abs(res.traj - one.traj).max())
    dxn = float(np.abs(res.x_nom - one.x_nom).max())
    print("%s: %d ranks on %s; max |dx| of the gathered trajectories against "
          "the one-process run %.3e%s (nominal states %.3e; bar %.0e); K1 "
          "launches a rank %s (one process %d); wall s a rank %s (sweep "
          "wall, gather included: %s; one process %.4f s); gathers a rank "
          "%s, ms %s"
          % (label, len(ranks), sorted({r["device"] for r in ranks}), dx,
             " (bitwise)" if dx == 0 else "", dxn, DP_DX, launches,
             one_launches, [r["wall_s"] for r in ranks],
             [r["result"].wall_time_s for r in ranks], one.wall_time_s,
             [r["gathers"] for r in ranks],
             [1e3 * r["gather_s"] for r in ranks]))
    _require(np.array_equal(res.feasible, one.feasible), (label, "feasible"))
    _require(bool(res.feasible.all()), (label, "all feasible"))
    for a in (res.traj, res.x_nom, res.tracking_error):
        _require(bool(np.isfinite(a).all()), (label, "finite"))
    _require(dx <= DP_DX and dxn <= DP_DX, (label, dx, dxn))
    _require(all(n == 2 * T for n in launches) and one_launches == 2 * T,
             (label, launches, one_launches))
    _require(all(r["gathers"] == 1 for r in ranks), (label, "one gather"))


def _nccl_one_rank(dev):
    """(d): NCCL's own path in a one-rank group on ``dev``: ``all_reduce``
    and ``all_gather_into_tensor`` on CUDA tensors."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from rtmpc_tpu_torch.parallel.distributed import initialize_from_env
    store = tempfile.mkdtemp(prefix="rtmpc_nccl_")
    try:
        _require(initialize_from_env("nccl", "file://" + store + "/store",
                                     1, 0))
        _require(dist.get_backend() == "nccl", dist.get_backend())
        t = torch.arange(1024, dtype=torch.float32, device=dev)
        s = t.clone()
        dist.all_reduce(s)
        g = torch.empty_like(t)
        dist.all_gather_into_tensor(g, t)
        torch.cuda.synchronize()
        _require(torch.equal(s, t) and torch.equal(g, t), "NCCL one rank")
        print("one-rank NCCL group on %s: all_reduce and "
              "all_gather_into_tensor on CUDA tensors equal their input" % dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def phase_data_parallel(setup, tube_setup, tube_res, dev):
    """Phase 24: the flagship sweep at full width and the Fig. 3a tube arm,
    each sharded over 2 ranks on cuda:0 (gloo) and held to one process;
    ``dryrun_multichip(2)``; NCCL in a one-rank group, and across two cards
    where the machine has them.  ``tube_res``: phase 11's tube arm, the
    one-process run of the same sweep.  Returns K1's launches on the
    ranks' flagship sweeps (each rank counts from 0 just before its sweep
    and reads just after)."""
    from rtmpc_tpu_torch.entry import dryrun_multichip
    from rtmpc_tpu_torch.ops.kernel_bench import card
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    from rtmpc_tpu_torch.parallel import run_mc_sweep
    from rtmpc_tpu_torch.parallel.ranks import spawn_ranks, sweep_rank
    flag, tube = _dp_flagship_job(setup), _dp_tube_job(tube_setup)

    # the one-process run of (a) on the same draws
    arrays, cfg = setup.to_device(device=dev, **flag[1])
    _reset_launches()
    one = run_mc_sweep(arrays, cfg, **flag[2])
    one_launches = admm_solve_cuda.launches

    cards = torch.cuda.device_count()
    print("phase 24: %d ranks over gloo on %s (rank r on card r modulo %d; "
          "on one card NCCL refuses two ranks); %s"
          % (DP_RANKS, ["cuda:%d" % (r % cards) for r in range(DP_RANKS)],
             cards, card()))
    t0 = time.perf_counter()
    ranks = spawn_ranks(sweep_rank, DP_RANKS, ([flag, tube], "cuda"),
                        backend="gloo", timeout=DP_TIMEOUT_S)
    print("phase 24 (a, b): the ranks took %.1f s, start-up included"
          % (time.perf_counter() - t0))
    flag_ranks = [r[0] for r in ranks]
    _check_dp_flagship("(a) flagship B=%d T=%d" % (B_FULL, T), flag_ranks,
                       one, one_launches)

    # (b) the tube arm: rows and stops equal to phase 11's one process
    res = ranks[0][1]["result"]
    for r in ranks[1:]:
        for f in ("traj", "tracking_error", "feasible"):
            _require(np.array_equal(getattr(r[1]["result"], f),
                                    getattr(res, f)), ("(b) ranks", f))
    rows, rows1 = (np.nanmean(x.tracking_error, axis=1)
                   for x in (res, tube_res))
    rel = float(np.max(np.abs(rows - rows1) / np.abs(rows1)))
    T_cp = res.traj.shape[2]
    launches = [r[1]["launches"] for r in ranks]
    print("(b) Fig. 3a tube arm, %d x %d x %d, %d rows a rank: per-p rows "
          "against phase 11's one process, worst relative %.3e (bar %.0e); "
          "stopped runs %s / %s; K1 launches a rank %s; wall s a rank %s "
          "(one process %.4f s); gather ms a rank %s"
          % (*res.tracking_error.shape, T_cp,
             res.tracking_error.size // DP_RANKS, rel, DP_ROWS_RTOL,
             res.infeasible_counts.tolist(),
             tube_res.infeasible_counts.tolist(), launches,
             [r[1]["wall_s"] for r in ranks], tube_res.wall_time_s,
             [1e3 * r[1]["gather_s"] for r in ranks]))
    _require(rel <= DP_ROWS_RTOL, ("(b) rows", rel))
    _require(np.array_equal(res.infeasible_counts,
                            tube_res.infeasible_counts), "(b) stops")
    _require(all(n == 2 * T_cp for n in launches), ("(b)", launches))

    # (c) the dry run
    mean_err, frac = dryrun_multichip(DP_RANKS, "cuda")
    _require(np.isfinite(mean_err) and frac == 1.0, (mean_err, frac))

    # (d) NCCL
    _nccl_one_rank(dev)
    if torch.cuda.device_count() >= 2:
        nccl = spawn_ranks(sweep_rank, 2, ([flag], "cuda"), backend="nccl",
                           timeout=DP_TIMEOUT_S)
        _check_dp_flagship("(d) flagship over NCCL, two cards",
                           [r[0] for r in nccl], one, one_launches)
    else:
        print("one device: NCCL across cards not run")
    return sum(r["launches"] for r in flag_ranks)


# Phase 25: the hybrid interior point and the ADMM's early exit.
# Fig. 3a's T of 250 cut to 20 to fit the time limit: at 40, with the
# launches counted by profiling two whole steps, phase 25 took 335.5 s of
# a 1200 s script that took 682.5-814.3 s without it (NVIDIA H100 80GB
# HBM3, 700 W).
T_HYB = 20
HYB_ROWS_RTOL = 1e-2      # hybrid per-p mean RMS against float64's
EARLY_TOL = 1e-3          # the JAX package's BENCH_EARLY_TOL
# Fig. 3d's ticks under the hybrid (phase 20: 250), cut from 120 to 40 to
# make room for phase 26 (a hybrid tick is ~0.25 s through the graph).
T_FIG3D_HYB = 40


def _tube_sweep(sc, arrays, cfg, draws, T_run, dev):
    from rtmpc_tpu_torch.apps.common import FULL_PROBS
    from rtmpc_tpu_torch.parallel.mc import SweepDraws, run_mc_sweep
    refs = np.zeros((T_run, 4))
    refs[:, 0] = sc.ref_value
    return run_mc_sweep(
        arrays, cfg, T=T_run, n_mc=20, loss_probs=FULL_PROBS, refs=refs,
        x0=sc.x0, w_lo=sc.w_lo, w_hi=sc.w_hi,
        draws=SweepDraws(*(a[:, :T_run] for a in draws)),
        actuator_mode="consistent")


def _ip_launches(sc, arrays, cfg, dev):
    """Device launches of the structured IP at B=200, from
    ``torch.profiler`` over short solves that run a fixed budget: ``{dtype:
    launches an iteration}`` and the launches of a solve with no
    iteration (start, final residuals; the hybrid's two phases)."""
    from rtmpc_tpu_torch.ops.ip_riccati import (ip_riccati_solve,
                                                ip_riccati_solve_hybrid)
    from rtmpc_tpu_torch.parallel.step_profile import _profiled
    th = torch.tensor(np.concatenate([sc.x0, [sc.ref_value, 0, 0, 0]]),
                      dtype=torch.float64, device=dev).expand(200, -1)
    spec = arrays.ric

    def count(fn):
        fn()                                      # warm-up
        return sum(c for c, _ in _profiled(fn)[1].values())

    def solve(s, k):
        return lambda: ip_riccati_solve(s, th, cfg.N, iters=k,
                                        early_exit=False)
    specs = {"float64": spec}
    if cfg.solver == "ip_hybrid":
        specs["float32"] = spec._make(a.float() for a in spec)
        fixed = count(lambda: ip_riccati_solve_hybrid(
            spec, th, cfg.N, iters32=0, iters64=0, early_exit=False))
    else:
        fixed = count(solve(spec, 0))
    per_iter = {dt: (count(solve(s, 2)) - count(solve(s, 0))) / 2
                for dt, s in specs.items()}
    return per_iter, fixed


def phase_hybrid_sweep(sc, setups, dev):
    """Phase 25 (a): Fig. 3a's RT-MPC tube arm at full width (B=200: 10
    loss probabilities x 20 runs, N=20, the committed seed-0 draws), T cut
    to ``T_HYB``, under ``ip_hybrid`` (the apps' 30 float32 + 12 float64
    iterations, float32 engine) and float64 ``ip_riccati`` (30): feasible
    everywhere, finite, the same stops, every per-p mean RMS of the
    hybrid within ``HYB_ROWS_RTOL`` (relative) of the float64 row; per
    step the wall seconds, the IP iterations (the hybrid's two phases
    apart) and the IP's device launches (``_ip_launches``: launches an
    iteration, profiled, times the iterations, plus a solve's fixed
    launches).  Returns the readings by solver."""
    from types import SimpleNamespace
    from rtmpc_tpu_torch.apps.common import solver_kwargs
    from rtmpc_tpu_torch.apps.results_linear import DRAWS_SEED0
    from rtmpc_tpu_torch.ops.ip_riccati import (ip_riccati_solve,
                                                ip_riccati_solve_hybrid)
    from rtmpc_tpu_torch.parallel.mc import load_draws
    draws = load_draws(DRAWS_SEED0, dev)
    out = {}
    for solver, dtype in (("ip_riccati", torch.float64),
                          ("ip_hybrid", torch.float32)):
        args = SimpleNamespace(solver=solver, dtype=str(dtype)[6:])
        arrays, cfg = setups["tube"].to_device(dtype, dev,
                                               **solver_kwargs(args))
        per_iter, fixed = _ip_launches(sc, arrays, cfg, dev)
        ip_riccati_solve.iterations = 0
        ip_riccati_solve_hybrid.iterations32 = 0
        ip_riccati_solve_hybrid.iterations64 = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _tube_sweep(sc, arrays, cfg, draws, T_HYB, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = dict(res=res, wall=wall, step_s=wall / T_HYB,
                 iters=ip_riccati_solve.iterations / T_HYB,
                 iters32=ip_riccati_solve_hybrid.iterations32 / T_HYB,
                 iters64=ip_riccati_solve_hybrid.iterations64 / T_HYB,
                 per_iter=per_iter, fixed=fixed)
        if solver == "ip_hybrid":
            r["launches"] = (fixed + per_iter["float32"] * r["iters32"]
                             + per_iter["float64"] * r["iters64"])
        else:
            r["launches"] = fixed + per_iter["float64"] * r["iters"]
        out[solver] = r
        print("phase 25 (a) %s (%s engine): %.2f s for %d steps of 200 "
              "rollouts, %.4f s a step; IP iterations a step %.3f "
              "(float32 %.3f, float64 %.3f); IP launches a step %.0f (%s "
              "an iteration, profiled, x the iterations, + %d a solve)"
              % (solver, args.dtype, wall, T_HYB, r["step_s"], r["iters"],
                 r["iters32"], r["iters64"], r["launches"],
                 ", ".join("%.0f in %s" % (n, dt)
                           for dt, n in per_iter.items()), fixed))
        _require(bool(res.feasible.all()), (solver, "tube arm feasible"))
        for a in (res.tracking_error, res.sample_traj, res.sample_x_nom):
            _require(bool(np.isfinite(a).all()), (solver, "finite"))
    f64, hyb = out["ip_riccati"]["res"], out["ip_hybrid"]["res"]
    _require(np.array_equal(f64.infeasible_counts, hyb.infeasible_counts),
             (f64.infeasible_counts, hyb.infeasible_counts))
    rows64 = np.nanmean(f64.tracking_error, axis=1)
    rows_h = np.nanmean(hyb.tracking_error, axis=1)
    rel = np.abs(rows_h - rows64) / np.abs(rows64)
    for p, a, b, e in zip(f64.loss_probs, rows64, rows_h, rel):
        print("  p=%.1f  mean RMS float64 %.6f  hybrid %.6f  rel %.3e"
              % (p, a, b, e))
    worst = float(rel.max())
    print("phase 25 (a): hybrid rows against float64, worst relative "
          "%.3e at p=%.1f (bar %g)"
          % (worst, f64.loss_probs[int(rel.argmax())], HYB_ROWS_RTOL))
    _require(worst <= HYB_ROWS_RTOL, worst)
    out["worst_rel"] = worst
    return out


def phase_early_exit_b1(setup, dev):
    """Phase 25 (c): the flagship's served shape (B=1, T=120, the bench's
    references and 70%/70% loss), eagerly, solver "admm", float32, 60+60
    iterations with the residual early exit (``early_tol=1e-3``) on phase
    2, and the same with the fixed budget: chunks a step and ms a step of
    each; gates: feasible, the tube invariant at every step, the early-exit
    trajectory within ``DX_PARITY`` of the port's float64 CPU run under
    the same ``early_tol``."""
    from rtmpc_tpu_torch.ops.qp import admm_solve
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    theta, gamma, w = _inputs(1, dev, seed=25)
    refs = _bench_refs(1, dev, torch.float32)
    x0 = torch.zeros(1, 2, dtype=torch.float32, device=dev)
    kw = dict(iters=ITERS, iters2=ITERS2, alpha=ALPHA, rho2_scale=RHO2_SCALE)
    runs = {}
    for label, early in (("early exit", dict(early_tol=EARLY_TOL)),
                         ("fixed 60+60", {})):
        arrays, cfg = setup.to_device(torch.float32, dev, solver="admm",
                                      **kw, **early)
        roll = make_batched_rollout(arrays, cfg, T)
        roll(x0, refs, w, theta, gamma)           # warm-up
        admm_solve.early_calls = admm_solve.chunks = 0
        admm_solve.max_chunks = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, outs = roll(x0, refs, w, theta, gamma)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T
        if early:
            _require(admm_solve.early_calls == T, admm_solve.early_calls)
            chunks = (admm_solve.chunks / T, admm_solve.max_chunks)
        else:
            chunks = (ITERS2 / 25, ITERS2 / 25)
        print("phase 25 (c) %s: %.4f ms a step eagerly at B=1, phase-2 "
              "chunks of 25 a step mean %.3f max %g"
              % (label, ms, chunks[0], chunks[1]))
        _require(bool(carry.feasible.all()) and bool(outs.feasible.all()))
        xs = torch.cat([x0[:, None], outs.x[:, :-1]], dim=1)
        viol = ((xs - outs.x_nom) @ arrays.Hz.T - arrays.hz).amax().item()
        _require(viol <= TUBE_TOL, (label, viol))
        runs[label] = dict(outs=outs, ms=ms, chunks=chunks, viol=viol)
    a64, c64 = setup.to_device(torch.float64, "cpu", solver="admm", **kw,
                               early_tol=EARLY_TOL)
    _, o64 = make_batched_rollout(a64, c64, T)(
        x0.double().cpu(), refs.double().cpu(), w.cpu(), theta.cpu(),
        gamma.cpu())
    dx = _max_err(runs["early exit"]["outs"].x, o64.x)
    print("phase 25 (c): early exit against float64 on the CPU (same "
          "early_tol): max |dx| %.3e (bar %g); tube invariant max %.3e"
          % (dx, DX_PARITY, runs["early exit"]["viol"]))
    _require(dx <= DX_PARITY, dx)
    return runs


def phase_hybrid_and_early_exit(sc, setups, setup, dev, fig3d_f64):
    """Phase 25 ((a), ``phase_hybrid_sweep``, runs beside phase 15): (b)
    Fig. 3d under the hybrid captured whole, beside phase 20's float64
    numbers; (c) ``phase_early_exit_b1``."""
    t0 = t1 = time.perf_counter()
    st_h, (cap, inst) = phase_fig3d_ip(sc, setups, dev, solver="ip_hybrid",
                                       n_ticks=T_FIG3D_HYB)
    (st64, (cap64, inst64)) = fig3d_f64
    for label, st, c, i in (("ip_hybrid", st_h, cap, inst),
                            ("ip_riccati float64 (phase 20)", st64, cap64,
                             inst64)):
        print("phase 25 (b) Fig. 3d %s, %d ticks: p50 %.4f p99 %.4f max "
              "%.4f ms a tick; capture %.2f s, instantiation %.2f s (%s)"
              % (label, st["n_solves"], st["median_ms"], st["p99_ms"],
                 st["max_ms"], c, i, torch.cuda.get_device_name(0)))
    print("phase 25 (b) took %.1f s" % (time.perf_counter() - t1))
    t1 = time.perf_counter()
    phase_early_exit_b1(setup, dev)
    print("phase 25 (c) took %.1f s" % (time.perf_counter() - t1))
    print("phase 25 (b, c) took %.1f s" % (time.perf_counter() - t0))


def phase_device_checks(out_dir):
    """Phase 26: the hardware parity gate, ``apps/device_checks.py:run``
    on the card (its checks print as they run); prints each reading of
    its JSON on a line of its own and fails on any failed check."""
    from rtmpc_tpu_torch.apps import device_checks
    res = device_checks.run(
        "cuda", out_json=os.path.join(out_dir, "device_checks.json"))
    for key, value in res.items():
        if isinstance(value, (int, float, str)) and key != "pass":
            print("phase 26 %s: %s" % (key, value))
    failed = [c["name"] for c in res["checks"] if not c["ok"]]
    print("phase 26: %d of %d checks passed in %.1f s (%s)"
          % (len(res["checks"]) - len(failed), len(res["checks"]),
             res["seconds"], torch.cuda.get_device_name(0)))
    _require(not failed, failed)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this smoke run needs a GPU")
    t_start = time.perf_counter()
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    from rtmpc_tpu_torch.apps.common import cartpole_controllers
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    from rtmpc_tpu_torch.models import flagship_setup
    from rtmpc_tpu_torch.ops.kernel_bench import (
        CP_F64_SMALL_B, CP_Y_ATOL, CP_Z_ATOL, EXT_F64_SMALL_B, EXT_Y_ATOL,
        EXT_Z_ATOL, WIDTH_SHAPES, Y_ATOL, Z_ATOL, check_shapes)
    from rtmpc_tpu_torch.ops.kernel_bench import card as _card
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda, build_kernel

    dev = torch.device("cuda", 0)
    card = _card()
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    t0 = time.perf_counter()
    lib, log = build_kernel()
    print("kernel build %.1f s -> %s" % (time.perf_counter() - t0,
                                          os.path.relpath(lib)))
    for line in log.splitlines():
        print("  " + line.strip())

    t0 = time.perf_counter()
    setup = flagship_setup()
    kw = dict(iters=ITERS, iters2=ITERS2, alpha=ALPHA, rho2_scale=RHO2_SCALE)
    arrays, cfg = setup.to_device(torch.float32, dev, solver="cuda", **kw)
    arrays64, _ = setup.to_device(torch.float64, dev, solver="cuda", **kw)
    print("setup %.1f s: n_p=%d m_p=%d rho=%g"
          % (time.perf_counter() - t0, arrays.admm.Kinv.shape[0],
             arrays.admm.As.shape[0], arrays.admm.rho.min().item()))
    sc = cartpole_scenario()
    kernel = dict(name="admm_solve_cuda", route="cuda",
                  source="rtmpc_tpu_torch/csrc/admm_kernel.cu",
                  replaces="rtmpc_tpu/ops/qp_pallas.py:106")
    kernels = []

    def record(name, path, launches, err, ms, plain_ms, bound, before=None):
        # library_ms: no single PyTorch call computes an ADMM phase; the
        # time of its products alone in torch.mm is library_product_ms.
        # before_ms: a "fac" shape's time on the composite path of its
        # width in the same call
        kernels.append(dict(
            kernel, name=name, path=path, launches=launches, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            library_ms=None, library_product_ms=bound[2], before_ms=before))
        if path == "fac":
            kernels[-1]["source"] = "rtmpc_tpu_torch/csrc/admm_factored.cu"

    _reset_launches()
    err, ms, plain_ms, bound = phase_kernel_vs_plain(arrays, arrays64, dev)
    # phase 5b: random QPs at the edges of the two paths' widths
    check_shapes(WIDTH_SHAPES, dev)
    launches, _ = phase_full_loop(arrays, cfg, dev)
    phase_parity(setup, arrays, cfg, dev)
    record("admm_solve_cuda (admm_kernel, n_p+m_p <= 192)", "smem", launches,
           err, ms, plain_ms, bound)

    # the single-instance controllers
    t0 = time.perf_counter()
    served, captured = phase_served_session(setup)
    b1 = phase_k1_b1(arrays, arrays64, dev)
    record("admm_solve_cuda (admm_kernel_factored at B=1: the served "
           "session, 40+112)", "fac", served, *b1[:4], before=b1[4])
    kernels[-1]["launches_counted_as"] = (
        "%d captured a window x %d replays of its CUDA graph"
        % (captured, served // captured))
    phase_examples(("cuda",))
    print("phases 17-19 took %.1f s (19's dense IP runs beside phase 15)"
          % (time.perf_counter() - t0))

    # the Fig. 3a slice
    t0 = time.perf_counter()
    setups = cartpole_controllers(sc, ("tube", "track"))
    print("cartpole setup %.1f s" % (time.perf_counter() - t0))
    by_arm = phase_cartpole_kernel(
        sc, {arm: _admm_qps(st, dev)[""] for arm, st in setups.items()},
        dev, (CP_Z_ATOL, CP_Y_ATOL), CP_F64_SMALL_B, seed=8)
    t0 = time.perf_counter()
    phase_crossover(arrays.admm,
                    _admm_qps(setups["tube"], dev)[""][0][0], dev)
    print("crossover sweep took %.1f s" % (time.perf_counter() - t0))
    # phase 10 runs beside phase 15
    # phase 11: the main path of the cluster path; counts from 0
    _reset_launches()
    out = phase_sweep("cuda", os.path.join(out_dir,
                                           "results_linear_cuda.json"),
                      setups)
    torch.cuda.synchronize()
    launches_l2 = admm_solve_cuda.launches_by_path["l2"]
    counts = out["counts"]
    print("phase 11 kernel launches: %s (by path %s)"
          % ({arm: c["kernel_launches"] for arm, c in counts.items()},
             admm_solve_cuda.launches_by_path))
    T_sweep = out["payload"]["T"]
    _require(counts["tube"]["kernel_launches"] == 2 * T_sweep, counts)
    _require(counts["track"]["kernel_launches"] == 3 * T_sweep, counts)
    # B=200 on the cluster path, Fig. 3d's B=1 ticks on "fac"
    _require(launches_l2 == 5 * T_sweep, launches_l2)
    _require(admm_solve_cuda.launches_by_path["fac"]
             == FIG3D_LAUNCHES["results_linear"],
             admm_solve_cuda.launches_by_path)
    _print_fig3d("results_linear --solver cuda", out["payload"])
    viol = _sample_tube_violation(out["tube"], out["arrays_tube"])
    print("tube invariant on the sample trajectories: max Hz(x - x_nom) "
          "- hz = %.3e (Z has %d rows)" % (viol, setups["tube"].Z.nrows))
    _require(viol <= TUBE_TOL, viol)
    record("admm_solve_cuda (admm_kernel_cluster, 192 < n_p+m_p <= 1024: "
           "112+840)", "l2", launches_l2, _err_of(by_arm, path="l2"),
           *by_arm["track"][1:4])

    # the extended arm and the nonlinear plant
    t0 = time.perf_counter()
    fig3a = dict(setups)
    setups.update(cartpole_controllers(sc, ("ext",)))
    ext = setups["ext"]
    print("extended cartpole setup %.1f s: Z %d rows, QP rows %d and %d "
          "(packet-received)" % (time.perf_counter() - t0, ext.Z.nrows,
                                 ext.template.m, ext.template_pr.m))
    by_qp = phase_cartpole_kernel(sc, _admm_qps(ext, dev, pr=True), dev,
                                  (EXT_Z_ATOL, EXT_Y_ATOL), EXT_F64_SMALL_B,
                                  seed=13, time_b1=True)
    ext_launches, _, fig3d_ext = phase_new_apps_cuda(setups, out_dir)
    record("admm_solve_cuda (admm_kernel_factored above 1024 columns: "
           "extended 112+1648, B=200)", "fac", ext_launches,
           _err_of(by_qp, B=200), *by_qp["normal"][1:4],
           before=by_qp["normal"][4])
    record("admm_solve_cuda (admm_kernel_factored, extended 112+1648, B=1: "
           "Fig. 3d's Ext-RT-MPC tick)", "fac", fig3d_ext,
           _err_of(by_qp, B=1), *by_qp["normal B=1"][1:4],
           before=by_qp["normal B=1"][4])
    kernels[-1]["launches_counted_as"] = (
        "through the wrapper in phase 14's Ext-RT-MPC arm of Fig. 3d (the "
        "warm-up tick and the captured tick of its one-tick graph); each of "
        "the graph's replays runs the captured ones")
    # phases 15, 10, 25 (a) and 19's dense IP side by side; the hardware
    # parity gate (phase 26) and the data-parallel ranks (phase 24 (a-d),
    # each rank's counts from 0) in this process meanwhile
    def meanwhile():
        t0 = time.perf_counter()
        phase_device_checks(out_dir)
        print("phase 26 took %.1f s" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        launches = phase_data_parallel(setup, fig3a["tube"], out["tube"], dev)
        print("phase 24 (a-d) took %.1f s" % (time.perf_counter() - t0))
        return launches
    x_nom, dp_launches = phase_side_by_side(out_dir, meanwhile)
    # phase 9, on the nominal states of the last arm (RT-MPC, float64)
    phase_ip_card_vs_cpu(sc, fig3a, dev, x_nom)
    phase_plant(sc, dev)

    # Fig. 3d through the captured interior point, the remaining apps and
    # the condensed QPs
    t0 = time.perf_counter()
    fig3d_f64 = phase_fig3d_ip(sc, fig3a, dev)
    print("phase 20 took %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_estimate_w(sc, dev)
    print("phase 21 took %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    anim_launches = phase_animations(fig3a)
    ms, plain_ms, bound, before = phase_k1_cluster_b1(sc, fig3a, dev)
    record("admm_solve_cuda (admm_kernel_factored at B=1: create_animations "
           "and Fig. 3d under --solver cuda, 112+792 and 112+840)", "fac",
           anim_launches, _err_of(by_arm, B=1), ms, plain_ms, bound,
           before=before)
    print("phase 22 took %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    # the condensed QPs at B=1 run in checks only: launches null
    launches, (err, err1), full, b1 = phase_condensed_flagship(setup, dev)
    record("admm_solve_cuda (admm_kernel, condensed flagship 16+96)", "smem",
           launches, err, *full)
    record("admm_solve_cuda (admm_kernel_factored, condensed flagship 16+96, "
           "B=1)", "fac", None, err1, *b1[:3], before=b1[3])
    kernels[-1]["launches_counted_as"] = "checked and timed only"
    launches, (err, err1), timing, tube_b1 = phase_condensed_cartpole(
        sc, fig3a, dev)
    record("admm_solve_cuda (admm_kernel_factored, condensed cartpole tube "
           "32+712, B=1)", "fac", None, err1, *tube_b1[:3],
           before=tube_b1[3])
    kernels[-1]["launches_counted_as"] = "checked and timed only"
    record("admm_solve_cuda (admm_kernel_cluster, condensed cartpole 32+712 "
           "and 32+760)", "l2", launches, err, *timing)
    print("phase 23 took %.1f s" % (time.perf_counter() - t0))

    # K1 at a data-parallel rank's shard
    t0 = time.perf_counter()
    B_rank = B_FULL // DP_RANKS
    th = torch.tensor(np.random.default_rng(24).uniform(-2, 2, (B_rank, 4)),
                      dtype=torch.float32, device=dev)
    err = _compare((arrays.admm, arrays.admm2),
                   (arrays64.admm, arrays64.admm2), th, th, True,
                   (ITERS, ITERS2), (Z_ATOL, Y_ATOL))
    record("admm_solve_cuda (admm_kernel, a rank's shard of the "
           "data-parallel flagship sweep, B=%d)" % B_rank, "smem", dp_launches,
           err,
           *_timed_phase("flagship 40+112, a rank's shard", B_rank,
                         arrays.admm, th, ITERS, dev, reps=20))
    kernels[-1]["launches_counted_as"] = (
        "%d on each of %d gloo ranks (spawned processes, rank r on card r "
        "modulo the cards)" % (2 * T, DP_RANKS))
    print("phase 24, K1 at a rank's shard, took %.1f s"
          % (time.perf_counter() - t0))

    # the hybrid interior point and the ADMM's early exit
    phase_hybrid_and_early_exit(sc, fig3a, setup, dev, fig3d_f64)
    _require("jax" not in sys.modules)

    print("chip_smoke.py took %.1f s" % (time.perf_counter() - t_start))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
