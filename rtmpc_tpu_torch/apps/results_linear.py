"""Paper Fig. 3a: the linearized-cartpole Monte-Carlo sweep (counterpart
of ``rtmpc_tpu/apps/results_linear.py``).

    python3 -m rtmpc_tpu_torch.apps.results_linear --device cuda \\
        [--solver ip_riccati|ip_hybrid|ip|cuda|admm] [--dtype float64] \\
        [--n-mc 20] [--quick] [--seed 0] [--draws PATH] [--checkpoint PATH] \\
        [--n-chunks 1] [--save-json PATH] [--no-figures]

Robust tube tracking MPC (RT-MPC: tube tracking, consistent actuator)
against non-robust tracking MPC (R-MPC: smart actuator, the arm stops on
an infeasibility certificate) over loss probabilities 0..0.9, n_mc runs of
T=250 steps each; each arm is one batched rollout of all its runs.  Prints
the mean RMS tracking error per loss probability, the infeasibility counts
of R-MPC, the wall time of each arm and of a solve, and runs the JAX app's
pass/fail checks.  Fig. 3d: the RT-MPC arm's per-step solve times on one
T-step rollout at p=0.4, one dispatch a tick (on the card one replay of a
one-tick CUDA graph, the interior point's loop included), reported as the
JSON's ``solve_time_stats`` (``common.solve_time_stats``).  Figures, under
``results/rtmpc_tpu_torch/`` (matplotlib; ``--no-figures`` to skip them):
the solve-time histogram, the box plots and the sample trajectories.

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

from .common import (DATA_DIR, FULL_PROBS, REPO_ROOT, RESULTS_ADMM_ITERS,
                     RESULTS_SOLVERS, SEED0_SOURCE, add_figure_args,
                     add_sweep_args,
                     boxplot_figure, cartpole_controllers, check, device_name,
                     figures_on, load_compare_linear, make_parser, resolve,
                     run_arms, save_summary_json, solve_time_stats,
                     solver_kwargs, solvetime_hist_figure, sweep_draws,
                     trajectory_figure)
from .scenarios import cartpole_scenario

DRAWS_SEED0 = os.path.join(DATA_DIR, "results_linear_seed0.npz")
TRUTH = os.path.join(REPO_ROOT, "RESULTS_LINEAR_CPU_F64_r05.json")
QUICK_PROBS = [0.0, 0.3, 0.6, 0.9]


def parse_args(argv=None):
    return add_figure_args(add_sweep_args(make_parser(
        __doc__, solvers=RESULTS_SOLVERS))).parse_args(argv)


def run(args, setups=None) -> dict:
    """Run both arms; returns the results, the JSON payload and ``ok``.

    ``setups``: the ``(tube, track)`` controllers already set up as below
    (a caller that runs several sweeps sets them up once)."""
    dev = resolve(args)
    figures = figures_on(args)
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
        setups = cartpole_controllers(sc, ("tube", "track")).values()
    tube, track = setups
    kw = solver_kwargs(args, admm_iters=RESULTS_ADMM_ITERS)
    arrays_tube, cfg_tube = tube.to_device(dtype, dev, **kw)
    arrays_track, cfg_track = track.to_device(dtype, dev, **kw)
    print(f"setup done in {time.perf_counter() - t0:.1f}s "
          f"(Z rows {tube.Z.nrows}, Xf rows {tube.Xf.nrows})")

    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    draws, source = sweep_draws(args, dev, T, n_mc, probs, 4, DRAWS_SEED0)
    from_jax = source == SEED0_SOURCE
    print(f"draws: {source}")
    print(f"running sweep: {len(probs)} probs x {n_mc} runs x {T} steps, "
          f"2 arms, {args.n_chunks} chunk(s)")

    results, counts = run_arms(
        args,
        (("tube", arrays_tube, cfg_tube, "consistent", None),
         ("track", arrays_track, cfg_track, "smart", "certificate")),
        T=T, n_mc=n_mc, loss_probs=probs, refs=refs, x0=sc.x0, w_lo=sc.w_lo,
        w_hi=sc.w_hi, draws=draws)
    res_tube, res_track = results["tube"], results["track"]

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
    stats = solve_time_stats(
        args, sc, {"RT-MPC": (arrays_tube, cfg_tube, "consistent")}, T)
    payload = {
        "app": "results_linear", "solver": args.solver, "dtype": args.dtype,
        "backend": dev.type, "device": device_name(dev), "n_mc": n_mc,
        "T": T, "seed": args.seed, "draws": source, "rows": rows,
        "wall_time_s": {arm: res.wall_time_s for arm, res in results.items()},
        "counts": counts, "solve_time_stats": stats["RT-MPC"]}
    save_summary_json(args.save_json, payload)
    if figures:
        arms = {"RT-MPC": res_tube, "R-MPC": res_track}
        solvetime_hist_figure(stats, "results_linear_solvetime_hist.png")
        boxplot_figure(arms, probs, "results_linear_boxplot.png",
                       "Average Tracking Error")
        trajectory_figure(arms, probs, sc, "results_linear_trajectories.png")

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
                  " (gated under float64 ip_riccati alone: the ADMM does "
                  "not reach trajectory parity on the cartpole)")
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
