"""The port's hardware parity gate (counterpart of ``tools/tpu_checks.py``,
its sections 2-5).

    python3 -m rtmpc_tpu_torch.apps.device_checks [--device cuda|cpu] \\
        [--out PATH]

Holds the port's closed loops on the card to the independent float64
protocol oracle (``rtmpc_tpu_torch/utils/oracle_protocol.py``: one rollout
at a time, explicit branches, every QP solved by the dense float64 interior
point), on the JAX gate's inputs drawn from the same numpy seeds, and checks
the paper's invariants on the card's outputs: Proposition 1 (the estimation
error ``e_t = x_t - x_hat_t`` lies in Z at every step with ``Theta_t = 1``)
and tube membership (``x_{t+1} - x_nom_{t+1}`` in Z), with
``utils/polytope.contains``.  Every solve goes through the port's batched
rollout with x0, refs, w, theta and gamma replicated over B.

Sections:

* ``flagship``: the double integrator of ``bench.py`` (T=120, seed 7, loss
  0.7 both ways, refs 5 / -9 / 4) under the bench's float32 ADMM schedule
  (60 + 60 iterations, alpha 1.8, rho2 scale 0.2) through K1 at B=1 and 64
  (path "fac": one row a group with float64 sums, then rows a group from
  occupancy in float32) and B=65 ("smem"): max |dx| to the oracle, Theta
  equal, feasible, both invariants, the replicated rows equal.
* ``cartpole``: the Results apps' 4-D cartpole RT-MPC (N=20, T=60, seed
  11, loss 0.4) under the dense interior point in float32 (30
  iterations), the hybrid (25 float32 + 20 float64 iterations) and the
  structured one in float64 (30): RMS tracking error, median and max
  per-step |dx| and Theta against the oracle, both invariants; the ADMM
  at 200 + 200 iterations through K1 at B=1 ("fac") and B=65 ("l2"):
  invariants and feasibility, its distance to the oracle recorded and not
  gated (the ADMM does not reach trajectory parity on this geometry).
* ``extended``: the extended tube-tracking arm (two QPs, robust estimator)
  on the double integrator (T=100, seed 23, loss 0.5, refs 5 / -6) under
  the hybrid and the float64 structured interior point (max |dx|, Theta,
  feasible, tube membership) and the bench's ADMM through K1 (max |dx|).

The interior points run at B=1 through a one-tick ``Session`` (on the
card each tick is one replay of a CUDA graph that holds the whole
interior point, its fixed budget), the ADMM runs eagerly.  The oracle's
trajectories are computed in worker processes meanwhile.  Prints one
``[PASS]``/``[FAIL]`` line a check, writes the readings as JSON
(``--out``; the keys of ``PARITY_TPU_r05.json`` where they mean the same)
and exits non-zero on any failure.  The default device is ``cuda``; the
CPU runs only when asked (there solver ``cuda`` runs K1's plain version,
and every run is eager).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..models import setup_extended_tube_tracking, setup_tube_tracking
from ..models.specs import ControllerArrays, ControllerConfig
from ..ops.qp_cuda import admm_solve_cuda, kernel_path, kernel_rows
from ..parallel import make_batched_rollout, tracking_error_rms
from ..parallel.session import Session
from ..tree import tree_map
from ..utils.oracle_protocol import run_oracle_rollout
from ..utils.polytope import box, contains
from .common import (DI_A, DI_B, cartpole_controllers, check, device_name,
                     require_device)
from .scenarios import cartpole_scenario

SECTIONS = ("flagship", "cartpole", "extended")

# The bench's float32 ADMM schedule (bench.py's defaults), the Results
# apps' ADMM (200 + 200) on the cartpole, and the interior points.
BENCH_ADMM = dict(solver="cuda", iters=60, iters2=60, alpha=1.8,
                  rho2_scale=0.2)
CARTPOLE_ADMM = dict(solver="cuda", iters=200, iters2=200, alpha=1.8,
                     rho2_scale=0.2)
DENSE_IP = dict(solver="ip", ip_iters=30)
HYBRID = dict(solver="ip_hybrid", ip_iters=25, ip_hybrid_iters=20)
RICCATI = dict(solver="ip_riccati", ip_iters=30)

FLAGSHIP_BATCHES = (1, 64, 65)    # "fac" one row a group, "fac", "smem"
CARTPOLE_ADMM_BATCHES = (1, 65)   # "fac" (cluster of 8), "l2"

# The JAX gate's bars (tools/tpu_checks.py).
INVARIANT_TOL = 5e-3              # Proposition 1, tube membership
FLAGSHIP_DX = 5e-3
IP_RMS_REL, IP_MEDIAN_DX, IP_MAX_DX = 0.02, 1e-2, 0.15
HYBRID_RMS_REL, HYBRID_MEDIAN_DX = 5e-3, 1e-3
EXT_IP_DX = 5e-3                  # the hybrid's, and float64's alike
EXT_ADMM_DX = 5e-2
# The float64 structured interior point on the cartpole (the port's
# accuracy default) has no JAX gate: about 9x its readings on an NVIDIA
# H100 80GB HBM3 (RMS 5.46e-8 relative, median per-step |dx| 5.75e-8; on
# the CPU 5.54e-8, 5.78e-8), 10^4 below the hybrid's bars.
RICCATI_RMS_REL, RICCATI_MEDIAN_DX = 5e-7, 5e-7
# The replicated rows of a run are equal on the card (read: 0 at B = 1,
# 64 and 65).  On the CPU the actuator's (B, 2) @ (2, 1) product is a BLAS
# matrix-vector product that sums the 65th row in another order: float32
# rounding (read: 3.0e-8 at B=65).
ROWS_ATOL = {"cuda": 0.0, "cpu": 1e-6}


def _masks(rng, T, p):
    theta = (rng.uniform(size=T) >= p).astype(np.int64)
    gamma = (rng.uniform(size=T) >= p).astype(np.int64)
    theta[0] = gamma[0] = 1
    return theta, gamma


def flagship_setup_and_inputs():
    """The flagship controller and section 2's inputs of the JAX gate:
    ``(setup, (x0, refs, w, theta, gamma))`` as numpy."""
    setup = setup_tube_tracking(
        DI_A, DI_B, np.eye(2), np.eye(1), 10, box(np.array([8.0, 8.0])),
        box(np.array([1.0])), box(np.array([0.1, 0.1])),
        fixed_initial_state=True)
    T = 120
    rng = np.random.default_rng(7)
    theta, gamma = _masks(rng, T, 0.7)
    w = rng.uniform(-0.1, 0.1, size=(T, 2))
    refs = np.zeros((T, 2))
    refs[:T // 4, 0] = 5.0
    refs[T // 4:T // 2, 0] = -9.0
    refs[T // 2:, 0] = 4.0
    return setup, (np.zeros(2), refs, w, theta, gamma)


def cartpole_setup_and_inputs():
    """The Results apps' RT-MPC cartpole controller (``rpi_method=1``) and
    section 4's inputs of the JAX gate."""
    sc = cartpole_scenario()
    setup = cartpole_controllers(sc, ("tube",))["tube"]
    T = 60
    rng = np.random.default_rng(11)
    theta, gamma = _masks(rng, T, 0.4)
    w = rng.uniform(sc.w_lo, sc.w_hi, size=(T, 4))
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    return setup, (np.asarray(sc.x0, float), refs, w, theta, gamma)


def extended_setup_and_inputs():
    """The extended controller on the double integrator and section 5's
    inputs of the JAX gate."""
    setup = setup_extended_tube_tracking(
        DI_A, DI_B, np.eye(2), np.eye(1), 10, box(np.array([8.0, 8.0])),
        box(np.array([1.0])), box(np.array([0.1, 0.1])),
        fixed_initial_state=True)
    T = 100
    rng = np.random.default_rng(23)
    theta, gamma = _masks(rng, T, 0.5)
    w = rng.uniform(-0.1, 0.1, size=(T, 2))
    refs = np.zeros((T, 2))
    refs[:T // 2, 0] = 5.0
    refs[T // 2:, 0] = -6.0
    return setup, (np.zeros(2), refs, w, theta, gamma)


SETUPS = {"flagship": flagship_setup_and_inputs,
          "cartpole": cartpole_setup_and_inputs,
          "extended": extended_setup_and_inputs}


def _oracle(setup, inputs):
    """A worker's job: the oracle's rollout (its float64 interior point
    drives the barrier stiff near convergence; scipy's rcond warnings there
    are expected, the accuracy is residual-checked)."""
    warnings.filterwarnings("ignore", message=".*ill-conditioned matrix.*")
    return run_oracle_rollout(setup, *inputs)


@dataclasses.dataclass
class Run:
    """One closed loop of the gate: ``key`` names it in the JSON; ``out``
    is filled by ``_execute``: the outputs as float64 numpy ``(B, T, .)``,
    ``feasible (B,)``, its seconds and K1's launches by path."""
    section: str
    key: str
    label: str
    arrays: ControllerArrays
    cfg: ControllerConfig
    B: int = 1
    out: Optional[dict] = None


def _host(outs, feasible) -> dict:
    out = {k: getattr(outs, k).double().cpu().numpy()
           for k in ("x", "u", "x_nom", "x_hat")}
    out["Theta"] = outs.Theta.cpu().numpy()
    out["feasible"] = feasible.cpu().numpy()
    return out


def _device_inputs(arrays, inputs):
    x0, refs, w, theta, gamma = inputs
    dev, dt = arrays.A.device, arrays.A.dtype
    return (*(torch.as_tensor(np.asarray(a), dtype=dt).to(dev)
              for a in (x0, refs, w)),
            *(torch.as_tensor(np.asarray(a), dtype=torch.int32).to(dev)
              for a in (theta, gamma)))


def _eager(run, inputs) -> dict:
    """The batched rollout with every input replicated over ``run.B``
    rows."""
    carry, outs = make_batched_rollout(run.arrays, run.cfg,
                                       inputs[1].shape[0])(
        *(a.expand(run.B, *a.shape).contiguous()
          for a in _device_inputs(run.arrays, inputs)))
    return _host(outs, carry.feasible)


def _one_tick(run, inputs) -> dict:
    """B=1 through a one-tick ``Session``: on the card each tick is one
    replay of a CUDA graph that holds the whole interior point (its fixed
    budget; eagerly it would exit early, to the same iterate)."""
    x0, refs, w, theta, gamma = _device_inputs(run.arrays, inputs)
    session = Session(run.arrays, run.cfg, 1, x0)
    ticks = []
    for t in range(refs.shape[0]):
        out = session.advance(refs[t:t + 1], w[t:t + 1], theta[t:t + 1],
                              gamma[t:t + 1])
        # on the card the graph's static outputs: copied before the next
        ticks.append(tree_map(torch.clone, out))
    outs = tree_map(lambda *a: torch.cat(a, dim=1), *ticks)
    return _host(outs, session.carry.feasible)


def _execute(run, inputs):
    """Run ``run`` on its device (the interior points through the one-tick
    session, the ADMM eagerly), timed to its end; K1's launches by path
    around it."""
    before = dict(admm_solve_cuda.launches_by_path)
    t0 = time.perf_counter()
    run.out = (_one_tick if run.cfg.solver.startswith("ip") else _eager)(
        run, inputs)
    run.out["seconds"] = time.perf_counter() - t0
    run.out["launches_by_path"] = {
        p: n - before[p] for p, n in admm_solve_cuda.launches_by_path.items()
        if n > before[p]}
    print(f"{run.label}: {run.out['seconds']:.2f} s on "
          f"{device_name(run.arrays.A.device)}")


class Gate:
    """The checks of one run of the gate: each printed as ``[PASS]`` or
    ``[FAIL]`` (``apps/common.py:check``) and kept with its detail."""

    def __init__(self):
        self.checks = []

    def __call__(self, name, ok, detail=""):
        ok = check(name, bool(ok), detail)
        self.checks.append(dict(name=name, ok=ok, detail=detail))
        return ok

    @property
    def ok(self) -> bool:
        return all(c["ok"] for c in self.checks)


def _gate_k1(gate, run, T):
    """Under solver "cuda": K1 launched on the path(s) the dispatch picks
    at ``run.B``, two phases a step for each of the controller's QPs (on
    the card; on the CPU the plain version runs and the path is printed)."""
    if run.cfg.solver != "cuda":
        return
    specs = [run.arrays.admm] + ([run.arrays.admm_pr] if run.cfg.extended
                                 else [])
    paths = {kernel_path(s.Kinv.shape[0] + s.As.shape[0], run.B,
                         s.Kinv.shape[0]) for s in specs}
    per_step = 2 * len(specs)
    if run.arrays.A.device.type != "cuda":
        print(f"{run.label}: K1's plain version on the CPU (the dispatch's "
              f"path on the card: {sorted(paths)})")
        return
    launched = run.out["launches_by_path"]
    spec = run.arrays.admm
    rows = kernel_rows(spec.Kinv.shape[0], spec.As.shape[0], run.B)
    gate(f"{run.label}: K1 launched on path(s) {sorted(paths)}, {per_step} "
         f"a step", set(launched) == paths
         and sum(launched.values()) == per_step * T,
         f"launches by path {launched}, {rows} row(s) a group, block or "
         f"cluster")


def _invariant_margins(Z, x0, out):
    """Proposition 1 and tube membership on every row of ``out``: whether
    each holds at ``INVARIANT_TOL`` (``contains``), the worst margin
    ``max(Hz v - hz)`` and the consistent steps of row 0."""
    x, x_hat, x_nom, Theta = out["x"], out["x_hat"], out["x_nom"], out["Theta"]
    xs = np.concatenate([np.broadcast_to(x0, x[:, :1].shape), x[:, :-1]],
                        axis=1)                # x_t for t = 0..T-1
    e = (xs - x_hat)[Theta == 1]               # e_t where Theta_t = 1
    # x_nom reported at step t is the pre-advance nominal state: x_{t+1}
    # (= x[t]) pairs with x_nom_{t+1} (= x_nom[t + 1])
    d = (x[:, :-1] - x_nom[:, 1:]).reshape(-1, x.shape[-1])

    def worst(v):
        return float(np.max(v @ Z.A.T - Z.b)) if len(v) else -np.inf
    return dict(
        prop1=all(contains(Z, v, tol=INVARIANT_TOL) for v in e),
        prop1_worst=worst(e), prop1_steps=int(Theta[0].sum()),
        tube=all(contains(Z, v, tol=INVARIANT_TOL) for v in d),
        tube_worst=worst(d))


def _against_oracle(out, oracle, x0, refs):
    """Distances of every row of ``out`` to the oracle's trajectory: max
    |dx| and |du|, the median over steps of the per-step max |dx| (the
    worst row's), Theta equal on every row, the RMS tracking error of row 0
    and its relative distance to the oracle's."""
    dx = np.abs(out["x"] - oracle["x"][None]).max(axis=-1)     # (B, T)
    rms = [float(tracking_error_rms(torch.as_tensor(x0),
                                    torch.as_tensor(x),
                                    torch.as_tensor(refs)))
           for x in (out["x"][0], oracle["x"])]
    return dict(
        traj_max_abs_err=float(dx.max()),
        u_max_abs_err=float(np.abs(out["u"] - oracle["u"][None]).max()),
        median_step_err=float(np.median(dx, axis=1).max()),
        theta_equal=bool((out["Theta"] == oracle["Theta"][None]).all()),
        rms=rms[0], rms_oracle=rms[1],
        rms_rel_err=abs(rms[0] - rms[1]) / rms[1])


def _rows_spread(out) -> float:
    """Largest difference of any replicated row from row 0."""
    return max(float(np.abs(out[k] - out[k][:1]).max())
               for k in ("x", "u", "x_nom", "x_hat", "Theta"))


def _gate_invariants(gate, label, inv, prop1=True):
    if prop1:
        gate(f"{label}: Proposition 1 (e in Z when Theta=1, tol "
             f"{INVARIANT_TOL:g})", inv["prop1"],
             f"worst Hz e - hz = {inv['prop1_worst']:.3e}, "
             f"{inv['prop1_steps']} consistent steps")
    gate(f"{label}: tube membership x - x_nom in Z (tol "
         f"{INVARIANT_TOL:g})", inv["tube"],
         f"worst Hz (x - x_nom) - hz = {inv['tube_worst']:.3e}")


def _reading(run, par, inv):
    """What the JSON keeps of one run."""
    return dict(par, **inv, B=run.B, seconds=run.out["seconds"],
                feasible=bool(run.out["feasible"].all()),
                launches_by_path=run.out["launches_by_path"] or None)


def plan_flagship(dev, setup):
    arrays, cfg = setup.to_device(torch.float32, dev, **BENCH_ADMM)
    return [Run("flagship", str(B), f"flagship B={B}", arrays, cfg, B)
            for B in FLAGSHIP_BATCHES]


def check_flagship(gate, setup, inputs, oracle, runs, result):
    x0, refs = inputs[0], inputs[1]
    readings = {}
    for run in runs:
        label, out = run.label, run.out
        _gate_k1(gate, run, refs.shape[0])
        par = _against_oracle(out, oracle, x0, refs)
        inv = _invariant_margins(setup.Z, x0, out)
        gate(f"{label}: float32 bench-config trajectory vs float64 oracle "
             f"(atol {FLAGSHIP_DX:g})", par["traj_max_abs_err"] < FLAGSHIP_DX,
             f"max|dx| = {par['traj_max_abs_err']:.2e}, "
             f"max|du| = {par['u_max_abs_err']:.2e}")
        gate(f"{label}: Theta equal to the oracle's", par["theta_equal"])
        gate(f"{label}: feasible", out["feasible"].all())
        _gate_invariants(gate, label, inv)
        spread = _rows_spread(out)
        tol = ROWS_ATOL[run.arrays.A.device.type]
        gate(f"{label}: replicated rows identical (atol {tol:g})",
             spread <= tol, f"max |row - row 0| = {spread:.3e}")
        readings[run.key] = r = _reading(run, par, inv)
        r["rows_max_abs_diff"] = spread
    result["flagship"] = readings
    result["rollout_traj_max_abs_err"] = readings["1"]["traj_max_abs_err"]
    result["rollout_u_max_abs_err"] = readings["1"]["u_max_abs_err"]
    result["batched_rollout_traj_max_abs_err"] = max(
        r["traj_max_abs_err"] for k, r in readings.items() if k != "1")


def plan_cartpole(dev, setup):
    runs = [
        Run("cartpole", "ip", "cartpole f32 dense IP (30 iterations)",
            *setup.to_device(torch.float32, dev, **DENSE_IP)),
        Run("cartpole", "hybrid", "cartpole hybrid IP (25 + 20 iterations)",
            *setup.to_device(torch.float32, dev, **HYBRID)),
        Run("cartpole", "riccati",
            "cartpole f64 structured IP (30 iterations)",
            *setup.to_device(torch.float64, dev, **RICCATI))]
    arrays, cfg = setup.to_device(torch.float32, dev, **CARTPOLE_ADMM)
    return runs + [Run("cartpole", f"admm_B{B}",
                       f"cartpole ADMM 200+200 B={B}", arrays, cfg, B)
                   for B in CARTPOLE_ADMM_BATCHES]


# The interior points' bars on the cartpole: RMS (relative), median and
# max per-step |dx| (None: not gated).
CARTPOLE_IP_BARS = {"ip": (IP_RMS_REL, IP_MEDIAN_DX, IP_MAX_DX),
                    "hybrid": (HYBRID_RMS_REL, HYBRID_MEDIAN_DX, None),
                    "riccati": (RICCATI_RMS_REL, RICCATI_MEDIAN_DX, None)}


def check_cartpole(gate, setup, inputs, oracle, runs, result):
    x0, refs = inputs[0], inputs[1]
    readings = {}
    for run in runs:
        label, out = run.label, run.out
        _gate_k1(gate, run, refs.shape[0])
        par = _against_oracle(out, oracle, x0, refs)
        inv = _invariant_margins(setup.Z, x0, out)
        if run.key in CARTPOLE_IP_BARS:
            rms_bar, med_bar, max_bar = CARTPOLE_IP_BARS[run.key]
            gate(f"{label}: RMS tracking error within {rms_bar:g} "
                 f"(relative) of the f64 oracle's", par["rms_rel_err"]
                 < rms_bar, f"rms {par['rms']:.6f} vs "
                 f"{par['rms_oracle']:.6f} (rel {par['rms_rel_err']:.3e})")
            gate(f"{label}: median per-step |dx| < {med_bar:g}",
                 par["median_step_err"] < med_bar,
                 f"median {par['median_step_err']:.2e}, "
                 f"max {par['traj_max_abs_err']:.2e}")
            if max_bar is not None:
                gate(f"{label}: max |dx| sanity bound ({max_bar:g})",
                     par["traj_max_abs_err"] < max_bar)
            gate(f"{label}: Theta equal to the oracle's", par["theta_equal"])
            for k in ("traj_max_abs_err", "rms_rel_err"):
                result[f"cartpole_{run.key}_{k}"] = par[k]
            result[f"cartpole_{run.key}_traj_median_step_err"] = \
                par["median_step_err"]
        else:
            gate(f"{label}: feasible", out["feasible"].all())
            print(f"{label}: max |dx| to the oracle "
                  f"{par['traj_max_abs_err']:.3e} (recorded, not gated), "
                  f"Theta equal {par['theta_equal']}")
        _gate_invariants(gate, label, inv)
        readings[run.key] = _reading(run, par, inv)
    result["cartpole"] = readings
    result["cartpole_admm_traj_max_abs_err"] = \
        readings["admm_B1"]["traj_max_abs_err"]


def plan_extended(dev, setup):
    return [
        Run("extended", "hybrid", "extended hybrid IP (25 + 20 iterations)",
            *setup.to_device(torch.float32, dev, **HYBRID)),
        Run("extended", "riccati",
            "extended f64 structured IP (30 iterations)",
            *setup.to_device(torch.float64, dev, **RICCATI)),
        Run("extended", "admm", "extended ADMM (bench config)",
            *setup.to_device(torch.float32, dev, **BENCH_ADMM))]


def check_extended(gate, setup, inputs, oracle, runs, result):
    x0, refs = inputs[0], inputs[1]
    readings = {}
    for run in runs:
        label, out = run.label, run.out
        _gate_k1(gate, run, refs.shape[0])
        par = _against_oracle(out, oracle, x0, refs)
        inv = _invariant_margins(setup.Z, x0, out)
        bar = EXT_ADMM_DX if run.key == "admm" else EXT_IP_DX
        gate(f"{label}: trajectory vs f64 oracle (atol {bar:g})",
             par["traj_max_abs_err"] < bar,
             f"max|dx| = {par['traj_max_abs_err']:.2e}, "
             f"max|du| = {par['u_max_abs_err']:.2e}")
        if run.key != "admm":
            gate(f"{label}: Theta equal to the oracle's", par["theta_equal"])
            gate(f"{label}: feasible", out["feasible"].all())
            # the extended actuator resets x_nom to the QP's: tube
            # membership is gated (as the JAX gate does), Proposition 1
            # (RT-MPC's) is not
            _gate_invariants(gate, label, inv, prop1=False)
            result[f"extended_{run.key}_u_max_abs_err"] = par["u_max_abs_err"]
        result[f"extended_{run.key}_traj_max_abs_err"] = \
            par["traj_max_abs_err"]
        readings[run.key] = _reading(run, par, inv)
    result["extended"] = readings


PLANS = {"flagship": (plan_flagship, check_flagship),
         "cartpole": (plan_cartpole, check_cartpole),
         "extended": (plan_extended, check_extended)}


def _card() -> tuple:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    from ..ops.kernel_bench import card
    name, limit = (s.strip() for s in card().split(",", 1))
    return name, limit


def run(device="cuda", sections=SECTIONS, out_json=None) -> dict:
    """Run the gate's ``sections`` on ``device`` (no fallback to the CPU:
    ``cuda`` without a card exits non-zero).  Returns the readings, with
    ``pass`` and every check under ``checks``; writes them to
    ``out_json`` if given."""
    dev = require_device(device)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; the gate's "
                         f"are {SECTIONS}")
    t_start = time.perf_counter()
    result = {"device": device_name(dev), "power_limit": None,
              "dtype": "float32", **BENCH_ADMM}
    if dev.type == "cuda":
        result["device"], result["power_limit"] = _card()
    print(f"device {result['device']} (power limit "
          f"{result['power_limit']}); sections {list(sections)}")
    gate = Gate()
    setups, inputs, oracles, runs = {}, {}, {}, []
    with concurrent.futures.ProcessPoolExecutor(
            len(sections), multiprocessing.get_context("spawn")) as pool:
        for name in sections:
            t0 = time.perf_counter()
            setups[name], inputs[name] = SETUPS[name]()
            oracles[name] = pool.submit(_oracle, setups[name], inputs[name])
            runs += PLANS[name][0](dev, setups[name])
            print(f"{name} setup {time.perf_counter() - t0:.1f} s")
        for run in runs:
            _execute(run, inputs[run.section])
        for name in sections:
            oracle = oracles[name].result()
            if not (oracle["feasible"]
                    and oracle["steps"] == inputs[name][1].shape[0]):
                raise RuntimeError(f"the oracle's {name} rollout stopped at "
                                   f"step {oracle['steps']}")
            PLANS[name][1](gate, setups[name], inputs[name], oracle,
                           [r for r in runs if r.section == name], result)
    result["seconds"] = time.perf_counter() - t_start
    result["checks"] = gate.checks
    result["pass"] = gate.ok
    print(f"device checks: {sum(c['ok'] for c in gate.checks)} of "
          f"{len(gate.checks)} passed, {result['seconds']:.1f} s")
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {out_json}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback to the CPU: pass --device cpu for that)")
    p.add_argument("--out", default=None, help="write the readings as JSON")
    args = p.parse_args(argv)
    return 0 if run(args.device, out_json=args.out)["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
