"""Smoke run of the PyTorch/CUDA port (``rtmpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the flagship lossy-network tube-tracking MPC
closed loop of ``bench.py``, at full width on the card, in phases that each
fail loudly (non-zero exit) on any error:

  1. a CUDA device is required (no CPU fallback: without one the script
     exits non-zero and prints no result);
  2. the card's name and power limit (``nvidia-smi``);
  3. the ADMM kernel (``rtmpc_tpu_torch/csrc/admm_kernel.cu``) is built from
     this checkout with nvcc;
  4. the flagship is set up with the port's own jax-free setup (any
     ``import jax`` raises in this script);
  5. the kernel against its plain PyTorch version on the card, cold
     phase 1 then warm phase 2, in f32, and against the plain version in
     f64 (no further from it than the plain f32 version): at B=4099
     (ragged tail) and at the main path's B=16384 (phase 2 from the
     kernel's own phase-1 state), and at B=1 and one row less and more
     than a thread block owns (there against absolute float64 bars, see
     ``rtmpc_tpu_torch/ops/kernel_bench.py``); times of kernel and plain
     version for one 60-iteration phase at B=16384;
 5b. the kernel against its plain version on random QPs at the widest
     shape of each path and the narrowest of the large one (n_p + m_p =
     192, 193, 2048), at tiny and ragged batches;
  6. the full-width closed loop through the kernel: B=16384 rollouts of
     T=120 steps, 70%/70% loss, the bench's reference profile; every
     rollout feasible, every output finite, 2 kernel launches per step,
     the tube invariant at every step;
  7. closed-loop parity at B=256: solver "cuda" against solver "admm" on
     the card and against solver "admm" in float64 on the CPU.

Then the paper's Fig. 3a slice, the 4-D cartpole (N=20) of
``rtmpc_tpu_torch.apps.results_linear``:

  8. the kernel's large-composite path (``admm_kernel_cluster``) at the
     cartpole's shapes, both QPs (112 + 792 and 112 + 840 columns), at
     B=200 (phase 2 warm from the kernel's own phase-1 state), B=37
     (ragged), B=1 and one row less and more than a cluster owns, 200
     cold then 200 warm iterations: against its plain
     version in float32, and against the plain version in float64 no
     further than 3x plain float32 (absolute bars at the small batches);
     times of kernel and
     plain version for one 200-iteration phase at B=200, and for all
     three main shapes the kernel's time beside its FP32 bound (the
     factored form's operations, the least the function needs) and the
     library's time for the products alone (``iters`` back-to-back
     ``torch.mm`` in float32, TF32 off);
  9. (run after 10, whose trajectories give its inputs) the structured
     interior point in float64 on the card against the CPU, on 64 thetas
     from the sweep's sample trajectories;
 10. the full sweep on the card: float64 ``ip_riccati``, both arms, 10
     loss probabilities x 20 runs x 250 steps from the committed draws;
     ``compare_linear`` against ``RESULTS_LINEAR_CPU_F64_r05.json``
     passes, the tube arm is feasible everywhere, every
     ``track_infeasible`` equals the truth's (the app's own checks);
     the wall time of each arm and of a solve is printed;
 11. the same sweep under ``--solver cuda`` (the ADMM kernel, float32):
     2 kernel launches a step on the tube arm, 3 on the tracking arm (the
     certificate's extra iterations are one more), every output finite,
     the tube arm feasible, the tube invariant on the sample trajectories;
     its rows are printed against the truth but not gated (the ADMM does
     not reach trajectory parity on this geometry).

Prints the kernels' JSON record on the line before the last and, as the
last line, ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import importlib.abc
import json
import os
import sys
import time

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
# <= 4.8e-11 and r_dual <= 1.24e-6 on both.
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


def _compare(arrays, arrays64, th1, th2, warm_from_kernel, iters, bars,
             label="", f64_bars=None):
    """``kernel_bench.compare_with_plain`` on a controller's two phases
    (``admm``, then ``admm2`` warm), held against float64 too; prints the
    errors and returns the largest of z and y against the plain version."""
    from rtmpc_tpu_torch.ops.kernel_bench import compare_with_plain
    errs = compare_with_plain(
        arrays.admm, arrays.admm2, th1, th2, iters, bars,
        warm_from_kernel=warm_from_kernel,
        specs64=(arrays64.admm, arrays64.admm2), f64_bars=f64_bars)
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
    print("%s, B=%d, %d iterations: kernel %.4f ms; bound %.4f ms (by %s, "
          "the factored form's; the kernel's composite product is %.2fx "
          "those operations; share reached %.3f); library, products alone "
          "(%d x torch.mm (%d, %d) @ (%d, %d), float32, TF32 off): %.4f ms; "
          "SM clock under the kernel, and its maximum: %s"
          % (label, B, iters, kernel_ms, bound, by,
             composite_over_factored(n_p, m_p), bound / kernel_ms, iters,
             B, n_p + m_p, n_p + m_p, n_p + m_p, mm, clock))
    return bound, by, mm


def phase_kernel_vs_plain(arrays, arrays64, dev):
    from rtmpc_tpu_torch.ops.kernel_bench import (F64_SMALL_B, Y_ATOL,
                                                  Y_ATOL_SMALL_B, Z_ATOL)
    from rtmpc_tpu_torch.ops.kernel_bench import time_ms as _time_ms
    from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_cuda_plain,
                                             admm_solve_cuda, kernel_rows)
    rng = np.random.default_rng(0)
    iters, bars = (ITERS, ITERS2), (Z_ATOL, Y_ATOL)

    def theta(B):
        return torch.tensor(rng.uniform(-2, 2, (B, 4)), dtype=torch.float32,
                            device=dev)

    # a ragged tail, with different thetas in the two phases
    err = _compare(arrays, arrays64, theta(B_CHECK), theta(B_CHECK), False,
                   iters, bars)
    # the main path's shape: one theta for both phases, phase 2 from the
    # kernel's own phase-1 state
    thf = theta(B_FULL)
    err = max(err, _compare(arrays, arrays64, thf, thf, True, iters, bars))
    # tiny and ragged around the rows of a thread block: the small batches'
    # own y bar and absolute bars against float64 (kernel_bench.py)
    rows = kernel_rows(arrays.admm.Kinv.shape[0], arrays.admm.As.shape[0])
    for B in (1, rows - 1, rows + 1):
        err = max(err, _compare(arrays, arrays64, theta(B), theta(B), False,
                                iters, (Z_ATOL, Y_ATOL_SMALL_B),
                                f64_bars=F64_SMALL_B))

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


def _cartpole_setups():
    """The Fig. 3a controllers as the app sets them up."""
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    from rtmpc_tpu_torch.models import setup_tracking, setup_tube_tracking
    sc = cartpole_scenario()
    tube = setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U,
                               sc.W, fixed_initial_state=True, rpi_method=1)
    track = setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U)
    return sc, {"tube": tube, "track": track}


def _cartpole_thetas(sc, B, rng, dev, dtype):
    theta = np.zeros((B, 8))
    theta[:, :4] = rng.uniform(-1, 1, (B, 4)) * np.array([0.3, 0.5, 0.05,
                                                           0.5])
    theta[:, 4] = rng.uniform(-1.0, 6.0, B)   # 6 m is outside X: saturates
    return torch.tensor(theta, dtype=dtype, device=dev)


def phase_cartpole_kernel(sc, setups, dev):
    """Phase 8: the L2 path against its plain version at the cartpole's
    shapes; returns (max error, kernel ms, plain ms) of the tracking QP's
    timed phase (the wider of the two)."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    from rtmpc_tpu_torch.ops.kernel_bench import (CP_F64_SMALL_B, CP_Y_ATOL,
                                                  CP_Z_ATOL)
    from rtmpc_tpu_torch.ops.kernel_bench import time_ms as _time_ms
    from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_cuda_plain,
                                             admm_solve_cuda, kernel_path,
                                             kernel_rows)
    kw = dict(ADMM_SCHEDULE, solver="cuda")
    rng = np.random.default_rng(8)
    err, times, bounds = 0.0, {}, {}
    for arm, setup in setups.items():
        arrays, _ = setup.to_device(torch.float32, dev, **kw)
        arrays64, _ = setup.to_device(torch.float64, dev, **kw)
        n_cols = arrays.admm.Kinv.shape[0] + arrays.admm.As.shape[0]
        print("%s QP: n_p + m_p = %d (%s path)"
              % (arm, n_cols, kernel_path(n_cols)))
        _require(kernel_path(n_cols) == "l2", (arm, n_cols))
        rows = kernel_rows(arrays.admm.Kinv.shape[0],
                           arrays.admm.As.shape[0])
        for B in CP_BATCHES + (1, rows - 1, rows + 1):
            th = _cartpole_thetas(sc, B, rng, dev, torch.float32)
            err = max(err, _compare(
                arrays, arrays64, th, th, B == 200, (CP_ITERS, CP_ITERS),
                (CP_Z_ATOL, CP_Y_ATOL), label=arm,
                f64_bars=None if B in CP_BATCHES else CP_F64_SMALL_B))
        th = _cartpole_thetas(sc, 200, rng, dev, torch.float32)
        t = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = admm_solve_cuda if which == "kernel" else \
                _admm_solve_cuda_plain
            t[which].append(_time_ms(
                lambda: fn(arrays.admm, th, None, CP_ITERS), reps=5))
        print("%s QP, one %d-iteration phase, B=200: kernel %s ms, plain "
              "%s ms" % (arm, CP_ITERS, t["kernel"], t["plain"]))
        times[arm] = (float(np.mean(t["kernel"])), float(np.mean(t["plain"])))
        bounds[arm] = _product_yardstick(
            "cartpole %s %d+%d" % (arm, arrays.admm.Kinv.shape[0],
                                   arrays.admm.As.shape[0]),
            200, arrays.admm, th, CP_ITERS, times[arm][0], dev)
    return err, times["track"][0], times["track"][1], bounds["track"]


def phase_ip_card_vs_cpu(sc, setups, dev, tube_sweep):
    """Phase 9: ``ip_riccati_solve`` in float64 on the card against the
    CPU on 64 thetas from the sweep: nominal states of phase 10's sample
    runs (the tube arm's run 5 at each loss probability, every 37th step;
    a true plant state can leave the tightened set and make the QP
    infeasible), reference 0.5, every eighth 6 m (outside X: it
    saturates)."""
    from rtmpc_tpu_torch.ops.ip_riccati import ip_riccati_solve
    traj = tube_sweep.sample_x_nom
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
        for r in (res, res_cpu):
            _require(r["r_prim"] <= IP_R_PRIM and r["r_dual"] <= IP_R_DUAL,
                     (arm, r))
        _require(dobj <= IP_OBJ_RTOL, (arm, dobj))
        _require(dz <= IP_Z_ATOL, (arm, dz))
        worst[arm] = dz
    return worst


def phase_sweep(solver, out_json, setups):
    """Phases 10 and 11: the app's full sweep on the card."""
    from rtmpc_tpu_torch.apps import results_linear
    args = results_linear.parse_args(
        ["--device", "cuda", "--solver", solver, "--save-json", out_json])
    t0 = time.perf_counter()
    out = results_linear.run(args, (setups["tube"], setups["track"]))
    print("sweep (%s) done in %.1f s" % (solver, time.perf_counter() - t0))
    for arm in ("tube", "track"):
        res = out[arm]
        _require(res.tracking_error.shape == (10, 20),
                 res.tracking_error.shape)
        for a in (res.sample_traj, res.sample_x_nom):
            _require(bool(np.isfinite(a).all()), (solver, arm))
    _require(bool(out["tube"].feasible.all()), "tube arm feasible")
    _require(bool(np.isfinite(out["tube"].tracking_error).all()))
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this smoke run needs a GPU")
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rtmpc_tpu_torch.models import flagship_setup
    from rtmpc_tpu_torch.ops.kernel_bench import card as _card
    from rtmpc_tpu_torch.ops.qp_cuda import build_kernel

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

    err, ms, plain_ms, bound = phase_kernel_vs_plain(arrays, arrays64, dev)
    # phase 5b: random QPs at the edges of the two paths' widths
    from rtmpc_tpu_torch.ops.kernel_bench import WIDTH_SHAPES, check_shapes
    check_shapes(WIDTH_SHAPES, dev)
    launches, _ = phase_full_loop(arrays, cfg, dev)
    phase_parity(setup, arrays, cfg, dev)

    # the Fig. 3a slice
    from rtmpc_tpu_torch.ops.qp_cuda import admm_solve_cuda
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    sc, setups = _cartpole_setups()
    print("cartpole setup %.1f s" % (time.perf_counter() - t0))
    err_l2, ms_l2, plain_ms_l2, bound_l2 = phase_cartpole_kernel(
        sc, setups, dev)
    sweep = phase_sweep(
        "ip_riccati", os.path.join(out_dir, "results_linear_ip_riccati.json"),
        setups)
    _require(sweep["ok"] and sweep["compared"], "phase 10 checks")
    phase_ip_card_vs_cpu(sc, setups, dev, sweep["tube"])
    # phase 11: the main path of the L2 path; counts from 0
    torch.cuda.synchronize()
    admm_solve_cuda.launches = 0
    for path in admm_solve_cuda.launches_by_path:
        admm_solve_cuda.launches_by_path[path] = 0
    out = phase_sweep("cuda", os.path.join(out_dir,
                                           "results_linear_cuda.json"),
                      setups)
    torch.cuda.synchronize()
    launches_l2 = admm_solve_cuda.launches_by_path["l2"]
    counts = out["counts"]
    print("phase 11 kernel launches: %s (l2 path %d)"
          % ({arm: c["kernel_launches"] for arm, c in counts.items()},
             launches_l2))
    T_sweep = out["payload"]["T"]
    _require(counts["tube"]["kernel_launches"] == 2 * T_sweep, counts)
    _require(counts["track"]["kernel_launches"] == 3 * T_sweep, counts)
    _require(launches_l2 == 5 * T_sweep, launches_l2)
    arrays_tube = out["arrays_tube"]
    tube = out["tube"]
    xs = np.concatenate([np.zeros((10, 1, 4)), tube.sample_traj[:, :-1]], 1)
    viol = float(((xs - tube.sample_x_nom) @ arrays_tube.Hz.double().cpu()
                  .numpy().T - arrays_tube.hz.double().cpu().numpy()).max())
    print("tube invariant on the sample trajectories: max Hz(x - x_nom) - "
          "hz = %.3e (Z has %d rows)" % (viol, setups["tube"].Z.nrows))
    _require(viol <= TUBE_TOL, viol)
    _require("jax" not in sys.modules)

    print(card)
    kernel = dict(name="admm_solve_cuda", route="cuda",
                  source="rtmpc_tpu_torch/csrc/admm_kernel.cu",
                  replaces="rtmpc_tpu/ops/qp_pallas.py:106")
    # library_ms: no single PyTorch call computes an ADMM phase; the time of
    # its products alone in torch.mm is library_product_ms
    print(json.dumps({"kernels": [
        dict(kernel, name="admm_solve_cuda (admm_kernel, n_p+m_p <= 192)",
             launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=bound[0], bound_by=bound[1], library_ms=None,
             library_product_ms=bound[2]),
        dict(kernel, name="admm_solve_cuda (admm_kernel_cluster, n_p+m_p "
             "<= 2048)", launches=launches_l2, max_abs_err=err_l2, ms=ms_l2,
             plain_ms=plain_ms_l2, bound_ms=bound_l2[0],
             bound_by=bound_l2[1], library_ms=None,
             library_product_ms=bound_l2[2]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
