"""Fig. 3d's per-step solve-time statistics and the Results figures of the
port against the JAX package, in float64 on the CPU.

* ``apps/common.solve_time_stats`` feeds the one-tick timer the JAX apps'
  inputs (numpy's ``default_rng(seed + 1)``: the same loss masks and
  disturbances, bit for bit, at p=0.4 from the scenario's x0) and reports
  the times as the JAX package's ``latency_report`` does (the same dict);
* a one-tick ``Session`` from a non-zero x0 gives the trajectory of the
  batched rollout, bit for bit: on the extended double-integrator
  controller (two QPs, robust estimator) under the structured interior
  point and the kernel's plain version, and on the smart actuator;
  ``measure_step_latencies`` takes ``x0`` and ``actuator_mode``;
* the figures are written as non-empty PNGs, and an app asked for
  figures without matplotlib exits before any work, naming
  ``--no-figures``.
"""

import builtins

import numpy as np
import pytest
import torch

from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario
from rtmpc_tpu.parallel.latency import latency_report as jax_latency_report

from rtmpc_tpu_torch.apps import common, results_linear
from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
from rtmpc_tpu_torch.models import (flagship_setup,
                                    setup_extended_tube_tracking)
from rtmpc_tpu_torch.parallel import latency, make_batched_rollout
from rtmpc_tpu_torch.parallel.mc import MCSweepResult
from rtmpc_tpu_torch.parallel.session import Session
from rtmpc_tpu_torch.utils import box

T = 24
X0 = np.array([1.5, -0.5])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this CPU build of torch can deadlock in a
    batched LU factorization run on several threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_app_inputs(seed, T_lat):
    """``rtmpc_tpu/apps/results_linear.py:108-113`` (and
    ``results_linear_extended.py:108-113`` at ``T_lat``)."""
    sc = jax_scenario()
    rng = np.random.default_rng(seed + 1)
    th_l = (rng.uniform(size=T_lat) >= 0.4).astype(np.int64)
    gm_l = (rng.uniform(size=T_lat) >= 0.4).astype(np.int64)
    th_l[0] = gm_l[0] = 1
    w_l = rng.uniform(sc.w_lo, sc.w_hi, size=(T_lat, 4))
    return th_l, gm_l, w_l, sc.x0


@pytest.mark.parametrize("seed,T_lat", [(0, 250), (3, 120)])
def test_solve_time_stats_inputs_and_report_match_jax(monkeypatch, capsys,
                                                      seed, T_lat):
    calls = []
    times = np.random.default_rng(seed).gamma(2.0, 5e-3, size=T_lat)

    def fake_timer(arrays, cfg, refs, w, theta, gamma, x0=None,
                   actuator_mode="consistent"):
        calls.append(dict(refs=refs, w=w, theta=theta, gamma=gamma, x0=x0,
                          mode=actuator_mode, arrays=arrays))
        return times

    monkeypatch.setattr(latency, "measure_step_latencies", fake_timer)
    args = results_linear.parse_args(["--seed", str(seed)])
    sc = cartpole_scenario()
    stats = common.solve_time_stats(
        args, sc, {"RT-MPC": ("a", None, "consistent"),
                   "Ext-RT-MPC": ("b", None, "smart")}, T_lat)
    th, gm, w, x0 = _jax_app_inputs(seed, T_lat)
    assert [c["arrays"] for c in calls] == ["a", "b"]
    assert [c["mode"] for c in calls] == ["consistent", "smart"]
    for c in calls:
        np.testing.assert_array_equal(c["theta"], th)
        np.testing.assert_array_equal(c["gamma"], gm)
        np.testing.assert_array_equal(c["w"], w)
        np.testing.assert_array_equal(c["x0"], x0)
        assert c["refs"].shape == (T_lat, 4)
        assert (c["refs"][:, 0] == sc.ref_value).all()
        assert not c["refs"][:, 1:].any()
    capsys.readouterr()
    for label in ("RT-MPC", "Ext-RT-MPC"):
        assert stats[label] == jax_latency_report(times, label)


def _ext_setup():
    return setup_extended_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10, box(np.array([8.0, 8.0])),
        box(np.array([1.0])), box(np.array([0.1, 0.1])))


def _inputs():
    rng = np.random.default_rng(8)
    theta = (rng.uniform(size=T) >= 0.5).astype(np.int32)
    gamma = (rng.uniform(size=T) >= 0.5).astype(np.int32)
    theta[0] = gamma[0] = 1
    refs = np.zeros((T, 2))
    refs[:, 0] = 4.0
    refs[T // 2:, 0] = -3.0
    w = rng.uniform(-0.1, 0.1, size=(T, 2))
    return refs, w, theta, gamma


@pytest.mark.parametrize("controller,solver,mode", [
    ("extended", "ip_riccati", "consistent"),
    ("extended", "cuda", "consistent"),
    ("flagship", "ip", "smart")])
def test_one_tick_session_follows_the_batched_rollout(controller, solver,
                                                      mode):
    setup = _ext_setup() if controller == "extended" else flagship_setup()
    kw = (dict(ip_iters=30) if solver.startswith("ip")
          else dict(iters=40, iters2=40, alpha=1.8, rho2_scale=0.2))
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver=solver, **kw)
    assert cfg.extended == (controller == "extended")
    refs, w, theta, gamma = _inputs()
    ses = Session(arrays, cfg, 1, X0, actuator_mode=mode)
    ticks = []
    for t in range(T):
        o = ses.advance(torch.tensor(refs[t:t + 1]), torch.tensor(w[t:t + 1]),
                        torch.tensor(theta[t:t + 1]),
                        torch.tensor(gamma[t:t + 1]))
        ticks.append(tuple(a.clone() for a in o))
    got = [torch.cat(f, dim=1) for f in zip(*ticks)]
    _, want = make_batched_rollout(arrays, cfg, T, actuator_mode=mode)(
        torch.tensor(X0)[None], *(torch.tensor(a)[None]
                                  for a in (refs, w, theta, gamma)))
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert bool(want.feasible.all())
    # the smart actuator and the consistent one drive other trajectories
    if mode == "smart":
        _, other = make_batched_rollout(arrays, cfg, T)(
            torch.tensor(X0)[None], *(torch.tensor(a)[None]
                                      for a in (refs, w, theta, gamma)))
        assert not torch.equal(other.x, want.x)


def test_measure_step_latencies_takes_x0_and_actuator_mode():
    arrays, cfg = flagship_setup().to_device(
        torch.float64, "cpu", solver="admm", iters=20, iters2=20)
    refs, w, theta, gamma = _inputs()
    times = latency.measure_step_latencies(arrays, cfg, refs, w, theta,
                                           gamma, x0=X0,
                                           actuator_mode="smart")
    assert times.shape == (T,) and (times > 0).all()


def _fake_results(seed, probs, n_mc, T_s):
    rng = np.random.default_rng(seed)
    err = rng.uniform(0.01, 0.05, (len(probs), n_mc))
    err[-1, 0] = np.nan                  # a stopped run is left out
    traj = rng.normal(size=(len(probs), T_s, 4)) * 0.1
    return MCSweepResult(loss_probs=np.array(probs), tracking_error=err,
                         feasible=~np.isnan(err),
                         infeasible_counts=np.isnan(err).sum(1),
                         sample_traj=traj, sample_x_nom=traj,
                         wall_time_s=0.0)


def test_figures_are_written(tmp_path, monkeypatch):
    monkeypatch.setenv("RTMPC_RESULTS_DIR", str(tmp_path))
    assert common.figures_on(results_linear.parse_args([]))
    probs = [0.0, 0.4, 0.8]
    arms = {"RT-MPC": _fake_results(1, probs, 5, 30),
            "R-MPC": _fake_results(2, probs, 5, 30)}
    times = np.random.default_rng(0).gamma(2.0, 4e-3, size=100)
    stats = {label: latency.latency_report(times * k, label)
             for k, label in ((1.0, "RT-MPC"), (3.0, "Ext-RT-MPC"))}
    paths = [common.solvetime_hist_figure(stats, "hist.png"),
             common.boxplot_figure(arms, probs, "box.png", "error"),
             common.trajectory_figure(arms, probs, cartpole_scenario(),
                                      "traj.png")]
    for p in paths:
        data = open(p, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 5000, p


def test_app_without_matplotlib_exits_naming_the_flag(monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr("importlib.import_module",
                        lambda name: no_matplotlib(name))
    args = results_linear.parse_args(["--device", "cpu", "--quick"])
    with pytest.raises(SystemExit, match="--no-figures"):
        results_linear.run(args, setups=("no", "setups"))
    assert not common.figures_on(results_linear.parse_args(["--no-figures"]))
