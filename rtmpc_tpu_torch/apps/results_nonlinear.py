"""Paper Figs. 3b/3c: the nonlinear-cartpole Monte-Carlo sweep (counterpart
of ``rtmpc_tpu/apps/results_nonlinear.py``).

    python3 -m rtmpc_tpu_torch.apps.results_nonlinear --device cuda \\
        [--extended] [--solver ip_riccati|ip_hybrid|ip|cuda|admm] \\
        [--dtype float64] \\
        [--n-mc 20] [--quick] [--seed 0] [--draws PATH] \\
        [--checkpoint PATH] [--n-chunks 1] [--save-json PATH] \\
        [--no-figures]

The controllers are designed on the linearized model, but the plant is the
nonlinear cartpole stepped at 500 Hz under a zero-order hold of the 50 Hz
control (``models/plants.py:cartpole_zoh_step``; the reference's PyBullet
plant as the analytic rigid-body ODE).  No process noise is drawn: the
mismatch between the physics and the linearization is the disturbance,
implicitly bounded by the estimated W.  Arms: RT-MPC (tube tracking,
consistent actuator), R-MPC (tracking, smart actuator, stops on an
infeasibility certificate) and, with ``--extended``, Ext-RT-MPC (extended
tube tracking, which the reference's nonlinear benchmark stops on QP
infeasibility too).  Prints the mean RMS tracking error per loss
probability and arm and runs the JAX app's two checks.  Figures, under
``results/rtmpc_tpu_torch/`` (matplotlib; ``--no-figures`` to skip them):
the box plots (Figs. 3b/3c) and the sample trajectories.  Like the JAX
app it reports no solve-time statistics.

The draws: at ``--seed 0`` and the full size, the loss masks the JAX app
feeds every arm (``rtmpc_tpu_torch/data/results_extended_seed0.npz``; its
uniforms are unused here); otherwise the port's own generator.  With those
draws a float64 ``ip_riccati`` run is held to the JAX package's float64
rows, ``RESULTS_NONLINEAR_EXT_CPU_F64_JAX.json``, at 1e-4 (relative) per
loss probability and arm (``common.ROWS_RTOL``).
"""

from __future__ import annotations

import os

import numpy as np

from ..models.plants import cartpole_zoh_step
from .common import (REPO_ROOT, RESULTS_SOLVERS, add_figure_args,
                     add_sweep_args, boxplot_figure, check, make_parser,
                     run_labelled_sweep,
                     save_summary_json, trajectory_figure)
from .scenarios import cartpole_scenario

TRUTH = os.path.join(REPO_ROOT, "RESULTS_NONLINEAR_EXT_CPU_F64_JAX.json")
ARMS = (("RT-MPC", "tube", "consistent", None),
        ("R-MPC", "track", "smart", "certificate"))
# the reference's NONLINEAR extended benchmark stops this arm on QP
# infeasibility too (``ext_tube_feasible``,
# ``results_nonlinear_system_with_extendedMPC.py:324,374``)
EXT_ARM = ("Ext-RT-MPC", "ext", "consistent", "certificate")


def build_nonlinear_plant_step(sc, method: str = "semi_implicit_euler"):
    """``plant_step(x (B, 4), u (B, 1), w) -> x_next`` of the scenario's
    nonlinear cartpole; ``w`` is unused (the model/physics mismatch IS the
    disturbance)."""
    def plant_step(x, u, w):
        return cartpole_zoh_step(sc.params, x, u[:, 0], sc.Th,
                                 sc.physics_substeps, method=method)

    plant_step.plant_id = (f"cartpole_zoh:{sc.params}:{sc.Th}:"
                           f"{sc.physics_substeps}:{method}")
    return plant_step


def parse_args(argv=None):
    p = add_figure_args(add_sweep_args(make_parser(
        __doc__, solvers=RESULTS_SOLVERS)))
    p.add_argument("--extended", action="store_true",
                   help="add the ExtendedTubeTrackingMPC arm "
                        "(results_nonlinear_system_with_extendedMPC)")
    return p.parse_args(argv)


def run(args, setups=None, arms=None) -> dict:
    """Run the arms, or those of them whose labels ``arms`` names (RT-MPC
    among them); ``setups``: the controllers ``tube``, ``track`` (and
    ``ext`` with ``--extended``) of ``common.cartpole_controllers`` already
    set up.  Returns ``run_labelled_sweep``'s dict with ``ok`` the app's
    verdict and ``max_angle`` the tube arm's largest sampled ``|phi|``."""
    every = ARMS + ((EXT_ARM,) if args.extended else ())
    out = run_labelled_sweep(
        args, "results_nonlinear",
        [a for a in every if arms is None or a[0] in arms], setups=setups,
        plant_step=build_nonlinear_plant_step(cartpole_scenario()),
        noise=False, truth=TRUTH, head={"extended": bool(args.extended)})
    save_summary_json(args.save_json, out["payload"])
    if out["figures"]:
        suffix = "_extended" if args.extended else ""
        boxplot_figure(out["results"], out["probs"],
                       f"results_nonlinear{suffix}_boxplot.png",
                       "Average Tracking Error (nonlinear plant)")
        trajectory_figure(out["results"], out["probs"], out["sc"],
                          f"results_nonlinear{suffix}_trajectories.png")
    tube_res = out["results"]["RT-MPC"]
    ok = out["ok"]
    ok &= check("tube arm feasible on the nonlinear plant",
                bool(tube_res.feasible.all()))
    # angle constraint |phi| <= 0.3 on the sampled trajectories
    max_ang = float(np.abs(tube_res.sample_traj[:, :, 2]).max())
    ok &= check("angle constraint held by the tube arm",
                max_ang <= 0.3 + 1e-3, f"max |phi| = {max_ang:.4f}")
    out["ok"], out["max_angle"] = bool(ok), max_ang
    return out


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
