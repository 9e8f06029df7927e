"""Extended-MPC 3-arm comparison on the linearized cartpole (counterpart
of ``rtmpc_tpu/apps/results_linear_extended.py``, paper Section IV.F).

    python3 -m rtmpc_tpu_torch.apps.results_linear_extended --device cuda \\
        [--solver ip_riccati|ip_hybrid|ip|cuda|admm] [--dtype float64] \\
        [--n-mc 20] [--quick] [--seed 0] [--draws PATH] [--checkpoint PATH] \\
        [--n-chunks 1] [--save-json PATH] [--no-figures]

Adds the ExtendedTubeTrackingMPC arm (two QPs selected by the previous
step's gamma, robust estimator, consistent actuator in extended mode) to
the RT-MPC / R-MPC sweep of ``results_linear``: three arms over loss
probabilities 0..0.9, n_mc runs of T=250 steps each, every arm one batched
rollout of all its runs.  Prints the mean RMS tracking error per loss
probability and arm, the wall time of each arm, and runs the JAX app's two
checks.  The dual solve-time histograms (the reference's
``results_linear_system_with_extendedMPC.py:409-431``): RT-MPC and
Ext-RT-MPC each time one rollout of ``min(T, 120)`` steps at p=0.4, one
dispatch a tick, reported by arm as the JSON's ``solve_time_stats``.
Figures, under ``results/rtmpc_tpu_torch/`` (matplotlib; ``--no-figures``
to skip them): the dual histogram and the box plots.

The draws: at ``--seed 0`` and the full size, the ones the JAX app feeds
all three arms, committed as
``rtmpc_tpu_torch/data/results_extended_seed0.npz`` (written by ``python
tests/test_torch_results_ext.py``); otherwise the port's own generator.
With those draws a float64 ``ip_riccati`` run is held to the JAX
package's float64 rows, ``RESULTS_LINEAR_EXT_CPU_F64_JAX.json``, at 1e-4
(relative) per loss probability and arm (``common.ROWS_RTOL``).
"""

from __future__ import annotations

import os

import numpy as np

from .common import (REPO_ROOT, RESULTS_SOLVERS, add_figure_args,
                     add_sweep_args, boxplot_figure, check, make_parser,
                     run_labelled_sweep,
                     save_summary_json, solve_time_stats,
                     solvetime_hist_figure)

TRUTH = os.path.join(REPO_ROOT, "RESULTS_LINEAR_EXT_CPU_F64_JAX.json")
# the dual histograms' rollouts are at most this long
# (``rtmpc_tpu/apps/results_linear_extended.py:109``)
T_LAT = 120
ARMS = (("RT-MPC", "tube", "consistent", None),
        ("Ext-RT-MPC", "ext", "consistent", None),
        ("R-MPC", "track", "smart", "certificate"))


def parse_args(argv=None):
    return add_figure_args(add_sweep_args(make_parser(
        __doc__, solvers=RESULTS_SOLVERS))).parse_args(argv)


def run(args, setups=None, arms=None) -> dict:
    """Run the three arms, or those of them whose labels ``arms`` names
    (a check then runs on the arms it has); ``setups``: the controllers
    ``tube``, ``ext`` and ``track`` of ``common.cartpole_controllers``
    already set up.  Returns ``run_labelled_sweep``'s dict with ``ok`` the
    app's verdict."""
    out = run_labelled_sweep(
        args, "results_linear_extended",
        [a for a in ARMS if arms is None or a[0] in arms], setups=setups,
        truth=TRUTH)
    results = out["results"]
    tube_arms = [n for n in ("RT-MPC", "Ext-RT-MPC") if n in results]
    modes = {label: mode for label, _, mode, _ in ARMS}
    stats = solve_time_stats(
        args, out["sc"],
        {n: (out["arrays"][n], out["cfgs"][n], modes[n]) for n in tube_arms},
        min(out["T"], T_LAT))
    out["payload"]["solve_time_stats"] = stats
    save_summary_json(args.save_json, out["payload"])
    if out["figures"]:
        solvetime_hist_figure(stats,
                              "results_linear_extended_solvetime_hist.png")
        boxplot_figure(results, out["probs"],
                       "results_linear_extended_boxplot.png",
                       "Average Tracking Error")
    ok = out["ok"]
    ok &= check("both tube arms always feasible",
                all(bool(results[n].feasible.all()) for n in tube_arms),
                "" if len(tube_arms) == 2 else f"ran {tube_arms}")
    if len(tube_arms) == 2:
        # Section IV.F claim: the extended MPC improves (or at least does
        # not worsen) tracking at high loss vs the basic tube MPC
        e_t = float(np.nanmean(results["RT-MPC"].tracking_error[-1]))
        e_e = float(np.nanmean(results["Ext-RT-MPC"].tracking_error[-1]))
        ok &= check("extended arm comparable-or-better at highest loss",
                    e_e < 1.5 * e_t, f"ext {e_e:.5f} vs tube {e_t:.5f}")
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
