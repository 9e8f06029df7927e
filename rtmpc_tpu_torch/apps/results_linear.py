"""Paper Fig. 3a: the linearized-cartpole Monte-Carlo sweep (counterpart
of ``rtmpc_tpu/apps/results_linear.py``).

    python3 -m rtmpc_tpu_torch.apps.results_linear --device cuda \\
        [--solver ip_riccati|cuda|admm] [--dtype float64] [--n-mc 20] \\
        [--quick] [--seed 0] [--draws PATH] [--checkpoint PATH] \\
        [--n-chunks 1] [--save-json PATH]

Robust tube tracking MPC (RT-MPC: tube tracking, consistent actuator)
against non-robust tracking MPC (R-MPC: smart actuator, the arm stops on
an infeasibility certificate) over loss probabilities 0..0.9, n_mc runs of
T=250 steps each; each arm is one batched rollout of all its runs.  Prints
the mean RMS tracking error per loss probability, the infeasibility counts
of R-MPC, the wall time of each arm and of a solve, and runs the JAX app's
pass/fail checks.  Writes no figures and no solve-time histogram.

The draws: at ``--seed 0`` and the full size, the ones the JAX app feeds
both arms, committed as ``rtmpc_tpu_torch/data/results_linear_seed0.npz``;
otherwise the port's own generator at ``--seed`` (other bits than
``jax.random``).  ``--draws`` names another file of the same layout.

With the committed draws at full size, the rows are compared with the
float64 truth (``RESULTS_LINEAR_CPU_F64_r05.json``) by
``tools/release_gate.py:compare_linear``; the comparison gates the run
under the float64 interior point and is printed only for the ADMM
solvers, which do not reach trajectory parity on this geometry.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from ..models import setup_tracking, setup_tube_tracking
from ..ops.ip_riccati import ip_riccati_solve
from ..ops.qp_cuda import admm_solve_cuda
from ..parallel.mc import draw_sweep, load_draws, run_mc_sweep
from .common import (REPO_ROOT, check, device_name, load_compare_linear,
                     make_parser, resolve, save_summary_json, solver_kwargs)
from .scenarios import cartpole_scenario

DRAWS_SEED0 = os.path.join(REPO_ROOT, "rtmpc_tpu_torch", "data",
                           "results_linear_seed0.npz")
TRUTH = os.path.join(REPO_ROOT, "RESULTS_LINEAR_CPU_F64_r05.json")
FULL_PROBS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
QUICK_PROBS = [0.0, 0.3, 0.6, 0.9]
SEED0_SOURCE = "the JAX app's seed-0 draws (committed file)"


def parse_args(argv=None):
    p = make_parser(__doc__)
    p.add_argument("--n-mc", type=int, default=20)
    p.add_argument("--draws", default=None,
                   help="npz of the sweep's draws (theta, gamma, u); "
                        "default: the committed seed-0 draws where they fit, "
                        "else the port's generator at --seed")
    p.add_argument("--checkpoint", default=None,
                   help="npz path for per-chunk sweep checkpointing; "
                        "re-run with the same path to resume")
    p.add_argument("--n-chunks", type=int, default=1,
                   help="sweep chunks along the probability axis")
    p.add_argument("--save-json", default=None,
                   help="write the per-p rows and the solver config here")
    return p.parse_args(argv)


def _draws(args, dev, T, n_mc, probs, nx):
    """The sweep's draws and a line saying where they came from."""
    shape = (len(probs) * n_mc, T)
    if args.draws:
        return load_draws(args.draws, dev), f"file {args.draws}"
    if args.seed == 0 and os.path.exists(DRAWS_SEED0):
        d = load_draws(DRAWS_SEED0, dev)
        if tuple(d.theta.shape) == shape:
            return d, SEED0_SOURCE
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    d = draw_sweep(g, T, n_mc, probs, nx)
    return (type(d)(*(a.to(dev) for a in d)),
            f"the port's generator at seed {args.seed} (not the JAX app's "
            "draws)")


def run(args, setups=None) -> dict:
    """Run both arms; returns the results, the JSON payload and ``ok``.

    ``setups``: the ``(tube, track)`` controllers already set up as below
    (a caller that runs several sweeps sets them up once)."""
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    sc = cartpole_scenario()
    if args.quick:
        T, n_mc, probs = 60, 4, QUICK_PROBS
    else:
        T, n_mc, probs = sc.T, args.n_mc, FULL_PROBS

    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    print("setting up tube-tracking (rpi_method=1, eq. 8d) and tracking "
          "controllers...")
    t0 = time.perf_counter()
    if setups is None:
        setups = (setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X,
                                      sc.U, sc.W, fixed_initial_state=True,
                                      rpi_method=1),
                  setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U))
    tube, track = setups
    kw = solver_kwargs(args)
    arrays_tube, cfg_tube = tube.to_device(dtype, dev, **kw)
    arrays_track, cfg_track = track.to_device(dtype, dev, **kw)
    print(f"setup done in {time.perf_counter() - t0:.1f}s "
          f"(Z rows {tube.Z.nrows}, Xf rows {tube.Xf.nrows})")

    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    draws, source = _draws(args, dev, T, n_mc, probs, 4)
    from_jax = source == SEED0_SOURCE
    print(f"draws: {source}")
    print(f"running sweep: {len(probs)} probs x {n_mc} runs x {T} steps, "
          f"2 arms, {args.n_chunks} chunk(s)")

    def ckpt(arm):
        return f"{args.checkpoint}.{arm}" if args.checkpoint else None

    counts = {}
    results = {}
    for arm, arrays, cfg, mode, infeas in (
            ("tube", arrays_tube, cfg_tube, "consistent", None),
            ("track", arrays_track, cfg_track, "smart", "certificate")):
        ip_riccati_solve.iterations = ip_riccati_solve.calls = 0
        admm_solve_cuda.launches = 0
        results[arm] = run_mc_sweep(
            arrays, cfg, T=T, n_mc=n_mc, loss_probs=probs, refs=refs,
            x0=sc.x0, w_lo=sc.w_lo, w_hi=sc.w_hi, draws=draws,
            actuator_mode=mode, infeas_mode=infeas,
            checkpoint_path=ckpt(arm), n_chunks=args.n_chunks)
        counts[arm] = dict(ip_iterations=ip_riccati_solve.iterations,
                           ip_calls=ip_riccati_solve.calls,
                           kernel_launches=admm_solve_cuda.launches)
    res_tube, res_track = results["tube"], results["track"]

    n_rollouts = len(probs) * n_mc
    for arm, res in results.items():
        c = counts[arm]
        line = (f"wall time {arm}: {res.wall_time_s:.2f}s for {T} steps of "
                f"{n_rollouts} rollouts, {1e3 * res.wall_time_s / T:.1f} ms "
                f"a step, {1e3 * res.wall_time_s / (n_rollouts * T):.4f} "
                f"ms a solve amortized")
        if c["ip_calls"]:
            line += (f", {c['ip_iterations'] / c['ip_calls']:.2f} IP "
                     f"iterations a step")
        if c["kernel_launches"]:
            line += f", {c['kernel_launches']} kernel launches"
        print(line)

    print("\nTracking-error summary (mean RMS per loss probability):")
    print("  p     RT-MPC (tube)   R-MPC (track)   track infeasible")
    rows = []
    for i, p in enumerate(probs):
        te_tube = np.nanmean(res_tube.tracking_error[i])
        tr = res_track.tracking_error[i]
        all_nan = bool(np.all(np.isnan(tr)))
        te_track = np.nan if all_nan else np.nanmean(tr)
        rows.append({"p": float(p), "rms_tube": float(te_tube),
                     "rms_track": float(te_track),
                     "rms_tube_median":
                         float(np.nanmedian(res_tube.tracking_error[i])),
                     "rms_track_median":
                         float("nan") if all_nan else float(np.nanmedian(tr)),
                     "rms_tube_all": res_tube.tracking_error[i].tolist(),
                     "rms_track_all": tr.tolist(),
                     "track_infeasible":
                         int(res_track.infeasible_counts[i])})
        print(f"  {p:.1f}   {te_tube:12.5f} {te_track:15.5f} "
              f"{int(res_track.infeasible_counts[i]):8d}/{n_mc}")
    payload = {
        "app": "results_linear", "solver": args.solver, "dtype": args.dtype,
        "backend": dev.type, "device": device_name(dev), "n_mc": n_mc,
        "T": T, "seed": args.seed, "draws": source, "rows": rows,
        "wall_time_s": {arm: res.wall_time_s for arm, res in results.items()},
        "counts": counts}
    save_summary_json(args.save_json, payload)

    ok = check("tube arm always feasible", bool(res_tube.feasible.all()))
    e0 = float(np.nanmean(res_tube.tracking_error[0]))
    e9 = float(np.nanmean(res_tube.tracking_error[-1]))
    ok &= check("tube errors bounded across loss probabilities",
                0.3 * e0 < e9 < 3.0 * e0, f"p0 {e0:.4f} vs p0.9 {e9:.4f}")
    if not args.quick:
        # Fig. 3a behaviour: the non-robust arm degrades with loss while
        # the tube arm stays flat
        e_track_hi = float(np.nanmean(res_track.tracking_error[6:8]))
        e_track_lo = float(np.nanmean(res_track.tracking_error[0]))
        e_tube_hi = float(np.nanmean(res_tube.tracking_error[6:8]))
        deg_track = e_track_hi / e_track_lo
        deg_tube = e_tube_hi / e0
        ok &= check(
            "non-robust arm degrades more at high loss (Fig. 3a behavior)",
            deg_track > deg_tube and deg_track > 1.2,
            f"R-MPC x{deg_track:.2f} vs RT-MPC x{deg_tube:.2f} "
            f"(infeasible counts {res_track.infeasible_counts.tolist()})")

    compared = None
    if from_jax and not args.quick and n_mc == 20:
        with tempfile.TemporaryDirectory() as tmp:
            path = args.save_json or os.path.join(tmp, "rows.json")
            if not args.save_json:
                save_summary_json(path, payload)
            compared, msg = load_compare_linear()(path, TRUTH)
        print(f"compare_linear against {os.path.basename(TRUTH)}:\n{msg}")
        gated = args.solver == "ip_riccati" and args.dtype == "float64"
        if gated:
            ok &= check("rows match the float64 truth (compare_linear, 2%)",
                        compared)
        else:
            print(f"[info] compare_linear {'passes' if compared else 'fails'}"
                  " (not gated: the ADMM does not reach trajectory parity "
                  "on the cartpole)")
        tr_inf = [r["track_infeasible"] for r in rows]
        with open(TRUTH) as f:
            tr_truth = [r["track_infeasible"] for r in json.load(f)["rows"]]
        same = tr_inf == tr_truth
        if gated:
            ok &= check("track_infeasible equals the truth's", same,
                        f"{tr_inf} vs {tr_truth}")
        else:
            print(f"[info] track_infeasible {tr_inf} vs truth {tr_truth}")
    return dict(ok=bool(ok), tube=res_tube, track=res_track, rows=rows,
                payload=payload, counts=counts, compared=compared,
                arrays_tube=arrays_tube)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
