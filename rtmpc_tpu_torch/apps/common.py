"""Shared plumbing of the port's apps (counterpart of
``rtmpc_tpu/apps/common.py``)."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from ..models import (setup_extended_tube_tracking, setup_tracking,
                      setup_tube_tracking)
from ..ops.ip_riccati import ip_riccati_solve
from ..ops.qp_cuda import admm_solve_cuda
from ..parallel.mc import draw_sweep, load_draws, run_mc_sweep
from .scenarios import cartpole_scenario

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The JAX Results apps' ADMM schedule (``rtmpc_tpu/apps/common.py:103-129``
# at ``admm_iters=400``): 200 + 200 iterations, polished in float64 alone.
RESULTS_ADMM_ITERS = 400
ADMM_SCHEDULE = dict(iters=RESULTS_ADMM_ITERS // 2,
                     iters2=RESULTS_ADMM_ITERS - RESULTS_ADMM_ITERS // 2,
                     alpha=1.8, rho2_scale=0.2)
IP_ITERS = 30

DATA_DIR = os.path.join(REPO_ROOT, "rtmpc_tpu_torch", "data")
FULL_PROBS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
SEED0_SOURCE = "the JAX app's seed-0 draws (committed file)"
# The extended and nonlinear JAX apps draw from the seed's key itself, the
# linear app from its first split: other bits, so a file of their own.
DRAWS_EXT_SEED0 = os.path.join(DATA_DIR, "results_extended_seed0.npz")
EXT_QUICK = (60, 3, [0.0, 0.4, 0.8])     # T, n_mc, probs under --quick
# Per-p mean RMS against the JAX package's float64 rows on the same draws.
# A float64 ``ip_riccati`` run is the same algorithm on the same draws and
# is gated at ROWS_RTOL: on an NVIDIA H100 80GB HBM3 the worst relative
# difference of any arm of either app read 1.2e-6 (R-MPC on the nonlinear
# plant; the tube arms 2e-8 to 5e-7), so a float32 run, another iteration
# cap or a wrong QP on a few rollouts fails it.  Other solvers' rows are
# printed against ROWS_RTOL_PRINTED and not gated.
ROWS_RTOL = 1e-4
ROWS_RTOL_PRINTED = 0.02


# The examples' solvers: the dense interior point (the JAX examples'
# default on the CPU) and the two ADMM solvers.
EXAMPLE_SOLVERS = ("ip", "cuda", "admm")
# The Results apps' solvers: those of the other apps and the hybrid
# (``rtmpc_tpu/apps/common.py:32``).
RESULTS_SOLVERS = ("ip_riccati", "ip_hybrid", "ip", "cuda", "admm")


def make_parser(description: str, default_solver: str = "ip_riccati",
                solvers=("ip_riccati", "ip", "cuda", "admm")
                ) -> argparse.ArgumentParser:
    """The apps' common flags; ``default_solver`` is ``ip_riccati`` for the
    Results apps and ``ip`` for the examples (the JAX apps' default on the
    CPU); ``solvers`` the choices of ``--solver`` (``RESULTS_SOLVERS`` for
    the Results apps)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback to the CPU: pass --device cpu for that)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="engine dtype: default float64, float32 under "
                        "--solver cuda (the kernel's type) and --solver "
                        "ip_hybrid (whose interior point is float64 all "
                        "the same)")
    p.add_argument("--solver", default=default_solver, choices=solvers,
                   help="QP solver: 'ip_riccati' (structured interior "
                        "point, the accuracy mode of the Results apps), "
                        "'ip' (dense interior point, the accuracy mode of "
                        "the examples), 'cuda' (the ADMM kernel, two "
                        "phases; polished in float64), 'admm' (the same "
                        "ADMM in plain PyTorch)"
                        + (", 'ip_hybrid' (the structured interior point "
                           "in float32, at most 30 iterations, then at most "
                           "12 in float64 from its iterate)"
                           if "ip_hybrid" in solvers else ""))
    p.add_argument("--quick", action="store_true",
                   help="shrink the workload for smoke runs")
    p.add_argument("--seed", type=int, default=0)
    return p


def add_sweep_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every Monte-Carlo sweep app takes."""
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
    return p


def add_figure_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--no-figures``, for the apps that draw figures."""
    p.add_argument("--no-figures", action="store_true",
                   help="draw no figures (they need matplotlib, and the GIFs "
                        "PIL too)")
    return p


def results_dir() -> str:
    """Where the apps write their figures: ``$RTMPC_RESULTS_DIR``, else
    ``results/rtmpc_tpu_torch`` in the repository (git-ignored)."""
    return os.environ.get("RTMPC_RESULTS_DIR",
                          os.path.join(REPO_ROOT, "results",
                                       "rtmpc_tpu_torch"))


def figures_on(args, *modules) -> bool:
    """Whether the app draws its figures: not under ``--no-figures``.
    Where figures are asked for, matplotlib (and each of ``modules``) must
    import: else the app exits non-zero, before any work, with a message
    that names ``--no-figures``; it never skips them silently."""
    if args.no_figures:
        return False
    for name in ("matplotlib",) + modules:
        try:
            importlib.import_module(name)
        except ImportError:
            sys.exit(f"the figures need {name}, which this Python cannot "
                     "import; pass --no-figures to run without them")
    import matplotlib
    matplotlib.use("Agg")
    return True


def savefig(fig, name: str) -> str:
    """Write ``fig`` as ``name`` under ``results_dir()`` and close it."""
    import matplotlib.pyplot as plt
    os.makedirs(results_dir(), exist_ok=True)
    path = os.path.join(results_dir(), name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"[figure] {path}")
    return path


def solvetime_hist_figure(stats_by_label: dict, name: str) -> str:
    """The reference's solve-time histogram (Fig. 3d,
    ``results_linear_system.py:397-404``; two arms side by side in
    ``results_linear_system_with_extendedMPC.py:409-431``), drawn from
    ``latency_report``'s bins and counts by arm label, as the JAX
    package's ``solvetime_hist_figure`` draws it."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 4))
    n = max(len(stats_by_label), 1)
    for i, (label, st) in enumerate(stats_by_label.items()):
        edges = np.asarray(st["hist_bins_ms"], float)
        counts = np.asarray(st["hist_counts"], float)
        wbin = (edges[1] - edges[0]) / (n + 0.5)
        ax.bar(edges[:-1] + i * wbin, counts, width=wbin, align="edge",
               label=label)
    ax.set_xlabel("Computational time [ms] (clipped to 2.5-20 ms bins)")
    ax.set_ylabel("Occurrences")
    ax.set_title("Per-step solve time (dispatch-inclusive)")
    if len(stats_by_label) > 1:
        ax.legend()
    return savefig(fig, name)


def boxplot_figure(results: dict, probs, name: str, ylabel: str) -> str:
    """Tracking-error box plots per loss probability, one box an arm
    (Figs. 3a-3c; ``results`` by arm label), NaN (stopped) runs left out
    as the reference filters them (``results_linear_system.py:334-339``)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(9, 5))
    n_arms = len(results)
    pos = np.arange(len(probs)) * (n_arms + 0.5)
    handles = []
    for ai, res in enumerate(results.values()):
        data = [e[~np.isnan(e)] for e in res.tracking_error]
        data = [d if d.size else np.array([np.nan]) for d in data]
        bp = ax.boxplot(data, positions=pos + (ai - (n_arms - 1) / 2) * 0.8,
                        widths=0.6, patch_artist=True, sym="x",
                        boxprops=dict(facecolor=f"C{ai}"))
        handles.append(bp["boxes"][0])
    ax.set_xticks(pos)
    ax.set_xticklabels([f"{p:.1f}" for p in probs])
    ax.set_xlabel("Packet Loss Probability")
    ax.set_ylabel(ylabel)
    ax.legend(handles, list(results))
    return savefig(fig, name)


def trajectory_figure(results: dict, probs, sc, name: str) -> str:
    """Each arm's sample trajectory at the loss probability nearest 0.4:
    the cart position against the reference and the pole angle against
    its +-0.3 rad limit (the Fig. 3a inset)."""
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(nrows=2, figsize=(8, 5))
    pi = min(range(len(probs)), key=lambda i: abs(probs[i] - 0.4))
    for label, res in results.items():
        tg = sc.Th * np.arange(res.sample_traj.shape[1])
        ax1.plot(tg, res.sample_traj[pi, :, 0], label=label)
        ax2.plot(tg, res.sample_traj[pi, :, 2], label=label)
    ax1.axhline(sc.ref_value, color="k", lw=1, label="r(k)")
    ax1.set_ylabel("Position p [m]")
    ax1.legend()
    ax1.grid()
    ax2.axhline(0.3, color="r")
    ax2.axhline(-0.3, color="r")
    ax2.set_ylabel("Angle phi [rad]")
    ax2.set_xlabel("Time [s]")
    ax2.grid()
    return savefig(fig, name)


def require_device(name: str) -> torch.device:
    """The torch device ``name``; exits non-zero if it is a CUDA device and
    none is available (there is no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {name}: no CUDA device is available")
    return dev


def resolve(args) -> torch.device:
    """Fill in the defaults that depend on other flags and check that the
    device exists; exits non-zero without a CUDA device for ``cuda``."""
    if args.dtype is None:
        args.dtype = ("float32" if args.solver in ("cuda", "ip_hybrid")
                      else "float64")
    dev = require_device(args.device)
    if dev.type == "cuda" and args.solver == "cuda" \
            and args.dtype != "float32":
        sys.exit("--solver cuda on a CUDA device runs in float32 only")
    return dev


def solver_kwargs(args, ip_iters: int = IP_ITERS,
                  admm_iters: int = 120) -> dict:
    """``to_device`` solver arguments for the parsed flags
    (``rtmpc_tpu/apps/common.py:103-129``): the interior points at
    ``ip_iters`` ("ip" with ``polish``, which it ignores, as in the JAX
    package); the hybrid at ``max(ip_iters, 25)`` float32 then 12 float64
    iterations (the JAX app's 25 + 12, measured there as accurate as its
    25 + 20); the ADMM solvers in two phases of ``admm_iters`` together
    (alpha 1.8, rho2 scale 0.2), polished where the dtype is float64."""
    if args.solver == "ip":
        return dict(solver="ip", ip_iters=ip_iters, polish=True)
    if args.solver == "ip_riccati":
        return dict(solver="ip_riccati", ip_iters=ip_iters)
    if args.solver == "ip_hybrid":
        return dict(solver="ip_hybrid", ip_iters=max(ip_iters, 25),
                    ip_hybrid_iters=12)
    return dict(solver=args.solver, iters=admm_iters // 2,
                iters2=admm_iters - admm_iters // 2, alpha=1.8,
                rho2_scale=0.2, polish=args.dtype == "float64")


def check_tol(args) -> float:
    """The tolerance of the apps' constraint and invariant checks
    (``rtmpc_tpu/apps/common.py:132-139``): 1e-6 for an interior point in
    float64 (the reference's Clarabel at 1e-7), else 2.5e-3 (ADMM to its
    solver tolerance, or float32)."""
    return 1e-6 if (args.solver in ("ip", "ip_riccati")
                    and args.dtype == "float64") else 2.5e-3


# The double integrator of the reference's examples and the serve app.
DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.0], [1.0]])


def example_refs(T: int) -> np.ndarray:
    """The examples' piecewise reference ``x1 = 5, -9, 9, 4`` in quarters of
    ``T`` (the -9/9 quarters lie outside X), ``(T, 2)``."""
    refs = np.zeros((T, 2))
    seg = T // 4
    refs[:seg, 0] = 5.0
    refs[seg:2 * seg, 0] = -9.0
    refs[2 * seg:3 * seg, 0] = 9.0
    refs[3 * seg:, 0] = 4.0
    return refs


def example_draws(args, T: int, w_half=None, p_loss=None, draws=None):
    """An example's random inputs, as ``(T, .)`` tensors on the CPU:
    ``w`` uniform in ``+-w_half`` (if given) and the loss masks ``theta``,
    ``gamma`` at loss probability ``p_loss`` (if given), from a
    ``torch.Generator`` at ``--seed``, masks first.  ``draws`` (a dict of
    arrays, e.g. the JAX example's own draws) replaces them."""
    from ..protocol import draw_disturbances, draw_loss_masks
    if draws is not None:
        return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    g = torch.Generator().manual_seed(args.seed)
    out = {}
    if p_loss is not None:
        out["theta"], out["gamma"] = draw_loss_masks(g, T, p_loss, p_loss)
    if w_half is not None:
        out["w"] = draw_disturbances(g, T, -np.asarray(w_half),
                                     np.asarray(w_half))
    return out


def timed_rollout(fn, dev: torch.device):
    """``(result, seconds, kernel launches)`` of one call of ``fn``,
    synchronized on the card; prints them."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = admm_solve_cuda.launches
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = admm_solve_cuda.launches - before
    print(f"rollout: {seconds:.3f} s, {launches} kernel launches")
    return out, seconds, launches


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor of one rollout (batch 1) as a float64 numpy array."""
    return t[0].double().cpu().numpy()


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def check(name: str, ok: bool, detail: str = "") -> bool:
    print(f"[{'PASS' if ok else 'FAIL'}] {name}" +
          (f" - {detail}" if detail else ""))
    return bool(ok)


def save_summary_json(path, payload: dict):
    """Record the app's rows machine-readably (for
    ``tools/release_gate.py:compare_linear``)."""
    if not path:
        return None

    def _default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return str(o)

    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=_default)
    print(f"[json] {path}")
    return path


def load_compare_linear():
    """``compare_linear`` of ``tools/release_gate.py``, loaded by path (the
    module imports no JAX)."""
    path = os.path.join(REPO_ROOT, "tools", "release_gate.py")
    spec = importlib.util.spec_from_file_location("_release_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compare_linear


def sweep_draws(args, dev, T, n_mc, probs, nx, seed0_file):
    """The sweep's draws and a line saying where they came from:
    ``--draws``, else at ``--seed 0`` the committed ``seed0_file`` (the
    draws the JAX app makes at that seed) where its shape fits, else the
    port's own generator."""
    shape = (len(probs) * n_mc, T)
    if args.draws:
        return load_draws(args.draws, dev), f"file {args.draws}"
    if args.seed == 0 and os.path.exists(seed0_file):
        d = load_draws(seed0_file, dev)
        if tuple(d.theta.shape) == shape:
            return d, SEED0_SOURCE
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    d = draw_sweep(g, T, n_mc, probs, nx)
    return (type(d)(*(a.to(dev) for a in d)),
            f"the port's generator at seed {args.seed} (not the JAX app's "
            "draws)")


# Fig. 3d: the per-tick latencies are taken on one rollout at this loss
# probability (``rtmpc_tpu/apps/results_linear.py:108-113``)
FIG3D_P = 0.4


def fig3d_inputs(seed: int, sc, T: int):
    """The inputs of Fig. 3d's rollout, the JAX apps' own: numpy's
    ``default_rng(seed + 1)``, the loss masks at ``FIG3D_P`` (the first
    packets delivered) then the disturbances, so the same bits; the
    reference at ``sc.ref_value``.  Returns ``(refs, w, theta, gamma)``,
    ``(T, 4)`` and ``(T,)`` numpy arrays."""
    rng = np.random.default_rng(seed + 1)
    theta = (rng.uniform(size=T) >= FIG3D_P).astype(np.int64)
    gamma = (rng.uniform(size=T) >= FIG3D_P).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(sc.w_lo, sc.w_hi, size=(T, 4))
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    return refs, w, theta, gamma


def solve_time_stats(args, sc, arms: dict, T: int) -> dict:
    """Fig. 3d's per-step solve-time statistics (the reference's
    methodology, ``results_linear_system.py:304-320``): each arm ``label:
    (arrays, cfg, actuator_mode)`` runs one T-tick rollout from the
    scenario's x0 on ``fig3d_inputs(args.seed, sc, T)``, one dispatch a
    tick (``parallel/latency.py:measure_step_latencies``); returns
    ``latency_report``'s statistics by label.  ``solve_time_stats.launches``
    holds each arm's kernel launches by path in its timing (K1 launches
    through the wrapper while a one-tick graph is warmed up and captured;
    its replays launch nothing through it)."""
    from ..parallel import latency
    refs, w, theta, gamma = fig3d_inputs(args.seed, sc, T)
    stats, solve_time_stats.launches = {}, {}
    for label, (arrays, cfg, mode) in arms.items():
        before = dict(admm_solve_cuda.launches_by_path)
        lat = latency.measure_step_latencies(arrays, cfg, refs, w, theta,
                                             gamma, x0=sc.x0,
                                             actuator_mode=mode)
        solve_time_stats.launches[label] = {
            path: n - before[path]
            for path, n in admm_solve_cuda.launches_by_path.items()}
        stats[label] = latency.latency_report(
            lat, f"per-step, dispatch-inclusive, {label}")
    return stats


solve_time_stats.launches = {}


def cartpole_controllers(sc, names) -> dict:
    """The Results apps' controllers on the cartpole scenario ``sc``, by
    name: ``"tube"`` (RT-MPC: tube tracking, fixed initial state), ``"ext"``
    (Ext-RT-MPC: extended tube tracking, initial state in the tube) and
    ``"track"`` (R-MPC: tracking, no tube); all with ``rpi_method=1``
    (eq. 8d)."""
    make = {
        "tube": lambda: setup_tube_tracking(
            sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U, sc.W,
            fixed_initial_state=True, rpi_method=1),
        "ext": lambda: setup_extended_tube_tracking(
            sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U, sc.W,
            fixed_initial_state=False, rpi_method=1),
        "track": lambda: setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X,
                                        sc.U),
    }
    return {name: make[name]() for name in names}


def run_arms(args, arms, **sweep) -> tuple:
    """Run each arm ``(name, arrays, cfg, actuator_mode, infeas_mode)`` as
    one ``run_mc_sweep(**sweep)`` and print its wall time; returns
    ``(results, counts)`` by arm name, the counts being the interior
    point's iterations and calls and the kernel's launches in that arm."""
    results, counts = {}, {}
    for name, arrays, cfg, mode, infeas in arms:
        ip_riccati_solve.iterations = ip_riccati_solve.calls = 0
        admm_solve_cuda.launches = 0
        results[name] = res = run_mc_sweep(
            arrays, cfg, actuator_mode=mode, infeas_mode=infeas,
            checkpoint_path=(f"{args.checkpoint}.{name}" if args.checkpoint
                             else None),
            n_chunks=args.n_chunks, **sweep)
        counts[name] = c = dict(ip_iterations=ip_riccati_solve.iterations,
                                ip_calls=ip_riccati_solve.calls,
                                kernel_launches=admm_solve_cuda.launches)
        T, n_rollouts = sweep["T"], len(sweep["loss_probs"]) * sweep["n_mc"]
        line = (f"wall time {name}: {res.wall_time_s:.2f}s for {T} steps of "
                f"{n_rollouts} rollouts, {1e3 * res.wall_time_s / T:.1f} ms "
                f"a step, {1e3 * res.wall_time_s / (n_rollouts * T):.4f} "
                f"ms a solve amortized")
        if c["ip_calls"]:
            line += (f", {c['ip_iterations'] / c['ip_calls']:.2f} IP "
                     f"iterations a step")
        if c["kernel_launches"]:
            line += f", {c['kernel_launches']} kernel launches"
        print(line)
    return results, counts


def arm_rows(results: dict, probs) -> list:
    """The JAX extended and nonlinear apps' rows: per loss probability the
    mean RMS tracking error (``rms_<arm>``, NaN runs left out) and the
    number of stopped runs (``infeasible_<arm>``) of every arm; prints the
    table."""
    print("  p   " + "".join(f"{n:>14s}" for n in results))
    rows = []
    for i, p in enumerate(probs):
        row = {"p": float(p)}
        for name, res in results.items():
            row[f"rms_{name}"] = float(np.nanmean(res.tracking_error[i]))
            row[f"infeasible_{name}"] = int(res.infeasible_counts[i])
        rows.append(row)
        print(f"  {p:.1f} " + "".join(f"{row[f'rms_{n}']:14.5f}"
                                      for n in results))
    return rows


def compare_rows(rows: list, truth_path: str, rtol: float) -> tuple:
    """Hold ``rows`` to the reference rows in ``truth_path`` (a JSON of the
    same app): every ``rms_<arm>`` of ``rows`` within ``rtol`` (relative)
    of the reference's at the same ``p``, every ``infeasible_<arm>`` equal.
    Returns ``(ok, message)``."""
    with open(truth_path) as f:
        truth = {r["p"]: r for r in json.load(f)["rows"]}
    worst, lines, ok = {}, [], True
    for row in rows:
        ref = truth.get(row["p"])
        if ref is None:
            return False, f"no reference row at p={row['p']}"
        for k, v in row.items():
            if k.startswith("rms_"):
                rel = abs(v - ref[k]) / abs(ref[k])
                worst[k] = max(worst.get(k, 0.0), rel)
                ok &= bool(rel <= rtol)          # a NaN fails
            elif k.startswith("infeasible_") and v != ref[k]:
                ok = False
                lines.append(f"  p={row['p']:.1f} {k}: {v} vs {ref[k]}")
    lines = [f"  {k}: worst per-p relative difference {v:.3e} (bar {rtol})"
             for k, v in worst.items()] + lines
    return ok, "\n".join(lines)


def run_labelled_sweep(args, app: str, arms, *, setups=None, plant_step=None,
                       noise: bool = True, truth=None, head=None) -> dict:
    """The sweep of the extended and nonlinear Results apps.

    ``arms``: ``(label, controller, actuator_mode, infeas_mode)`` with
    ``controller`` a name of ``cartpole_controllers``; ``setups``: those
    controllers already set up, by name (a caller that runs several sweeps
    sets them up once).  ``noise=False`` draws no process noise (a
    zero-width disturbance box).  ``truth``: the JAX app's float64 rows;
    with the committed draws at full size the rows are compared with them
    (``compare_rows``): at ``ROWS_RTOL`` as a gate for a float64
    ``ip_riccati`` run, at ``ROWS_RTOL_PRINTED`` and printed only
    otherwise.  ``head``: app keys
    that go first into the JSON payload.

    Returns ``ok`` (the comparison's verdict where it gates, else True),
    ``results``, ``counts``, ``arrays`` and ``cfgs`` by arm label, ``rows``,
    ``payload`` (the app adds its keys and saves it), ``compared`` (None if
    not compared), the steps ``T``, the scenario ``sc``, the loss
    probabilities ``probs`` and ``figures`` (``figures_on``)."""
    dev = resolve(args)
    figures = figures_on(args)
    dtype = getattr(torch, args.dtype)
    sc = cartpole_scenario()
    T, n_mc, probs = EXT_QUICK if args.quick else (sc.T, args.n_mc,
                                                   FULL_PROBS)
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}")
    t0 = time.perf_counter()
    names = [a[1] for a in arms]
    if setups is None:
        setups = cartpole_controllers(sc, names)
    kw = solver_kwargs(args, admm_iters=RESULTS_ADMM_ITERS)
    frozen = {label: setups[name].to_device(dtype, dev, **kw)
              for label, name, _, _ in arms}
    print(f"setups done in {time.perf_counter() - t0:.1f}s (QP rows "
          + ", ".join(f"{label} {setups[name].template.m}"
                      for label, name, _, _ in arms) + ")")

    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    draws, source = sweep_draws(args, dev, T, n_mc, probs, 4,
                                DRAWS_EXT_SEED0)
    print(f"draws: {source}")
    print(f"running sweep: {len(probs)} probs x {n_mc} runs x {T} steps, "
          f"{len(arms)} arms, {args.n_chunks} chunk(s)")
    w_lo, w_hi = (sc.w_lo, sc.w_hi) if noise else (np.zeros(4), np.zeros(4))
    results, counts = run_arms(
        args, [(label, *frozen[label], mode, infeas)
               for label, _, mode, infeas in arms],
        T=T, n_mc=n_mc, loss_probs=probs, refs=refs, x0=sc.x0, w_lo=w_lo,
        w_hi=w_hi, draws=draws, plant_step=plant_step)

    print("\nMean RMS tracking error per loss probability:")
    rows = arm_rows(results, probs)
    print("stopped runs: " + ", ".join(
        f"{n} {r.infeasible_counts.tolist()}" for n, r in results.items()))
    payload = {
        **(head or {}), "app": app, "solver": args.solver,
        "dtype": args.dtype, "backend": dev.type, "device": device_name(dev),
        "n_mc": n_mc, "T": T, "seed": args.seed, "draws": source,
        "rows": rows,
        "wall_time_s": {n: r.wall_time_s for n, r in results.items()},
        "counts": counts}

    ok, compared = True, None
    if (truth and source == SEED0_SOURCE and not args.quick and n_mc == 20):
        gated = args.solver == "ip_riccati" and args.dtype == "float64"
        rtol = ROWS_RTOL if gated else ROWS_RTOL_PRINTED
        compared, msg = compare_rows(rows, truth, rtol)
        print(f"rows against {os.path.basename(truth)}:\n{msg}")
        if gated:
            ok = check(f"rows match the JAX package's float64 rows "
                       f"({rtol:g} relative, per-p mean)", compared)
        else:
            print(f"[info] the comparison {'passes' if compared else 'fails'}"
                  " (gated under float64 ip_riccati alone: the ADMM does not "
                  "reach trajectory parity on the cartpole)")
    return dict(ok=ok, results=results, counts=counts, rows=rows,
                payload=payload, compared=compared, T=T, sc=sc, probs=probs,
                figures=figures,
                arrays={label: a for label, (a, _) in frozen.items()},
                cfgs={label: c for label, (_, c) in frozen.items()})
