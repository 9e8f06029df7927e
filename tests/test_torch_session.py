"""The served session of the port against the JAX package, in float64 on
the CPU.

* A ``Session`` of windows of 15 ticks over T=60 (the carry threaded from
  window to window in its static tensors) is bit-equal to one rollout of
  T=60, and within 1e-9 of the JAX engine's ``make_rollout_fn`` fed its
  ``carry0`` window by window, under solver "cuda" (the kernel's plain
  version on the CPU) against JAX "admm" and under "admm" with polish
  against JAX "admm" with polish, on the flagship.
* ``measure_step_latencies`` gives one positive time a tick; the one-tick
  session it times follows the windowed session's trajectory; the
  card-only timers raise on the CPU.
* ``latency_report`` returns the JAX package's dict on the same times.
* The serve app's ``main`` returns 0 on a short session on the CPU, and its
  inputs are the JAX app's.
"""

import argparse

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.models import setup_tube_tracking as jax_setup_tube_tracking
from rtmpc_tpu.parallel.latency import latency_report as jax_latency_report
from rtmpc_tpu.parallel.rollout import init_carry as jax_init_carry
from rtmpc_tpu.parallel.rollout import make_rollout_fn
from rtmpc_tpu.utils import box as jax_box

from rtmpc_tpu_torch.apps import serve_controller
from rtmpc_tpu_torch.models import flagship_setup
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.parallel.latency import (device_step_time,
                                              dispatch_floor_s,
                                              latency_report,
                                              measure_step_latencies)
from rtmpc_tpu_torch.parallel.session import Session

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
T, K = 60, 15
TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread.  The batches here are small, and this CPU
    build of torch can deadlock in a batched LU factorization (batch > 1)
    run on several intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """The serve app's inputs over T ticks at loss 0.4, as numpy."""
    refs, theta, gamma, w = serve_controller.session_inputs(3, T, 0.4)
    refs[30:, 0] = -4.0                  # a setpoint change mid-session
    return refs, w, theta.astype(np.int32), gamma.astype(np.int32)


@pytest.fixture(scope="module")
def jax_flagship():
    return jax_setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10, jax_box(np.array([8.0, 8.0])),
        jax_box(np.array([1.0])), jax_box(np.array([0.1, 0.1])),
        fixed_initial_state=True)


@pytest.fixture(scope="module")
def port_flagship():
    return flagship_setup()


def _windowed(session, inputs):
    outs = []
    for k in range(T // K):
        sl = slice(k * K, (k + 1) * K)
        o = session.advance(*(torch.tensor(a[sl]) for a in inputs))
        outs.append(tuple(t.clone() for t in o))
    return [torch.cat(f, dim=1) for f in zip(*outs)]


@pytest.mark.parametrize("solver,polish", [("cuda", False),
                                           ("admm", True)])
def test_windowed_session_matches_one_shot_and_jax(jax_flagship,
                                                   port_flagship, solver,
                                                   polish):
    inputs = _inputs()
    arrays, cfg = port_flagship.to_device(torch.float64, "cpu",
                                          solver=solver, polish=polish, **KW)
    session = Session(arrays, cfg, K, np.zeros(2))
    assert session.graph is None          # the CPU runs the ticks eagerly
    got = _windowed(session, inputs)
    carry, one = make_batched_rollout(arrays, cfg, T)(
        torch.zeros(1, 2, dtype=torch.float64),
        *(torch.tensor(a)[None] for a in inputs))
    for name, a, b in zip(one._fields, got, one):
        assert torch.equal(a, b), name                   # bit-equal
    for a, b in zip(session.carry.admm, carry.admm):
        assert torch.equal(a, b)
    assert session.launches == 0

    ja, jc = jax_flagship.to_device(dtype=jnp.float64, polish=polish, **KW)
    step = jax.jit(make_rollout_fn(ja, jc, K))
    jcarry = jax_init_carry(ja, jc, np.zeros(2), T)
    jouts = []
    for k in range(T // K):
        sl = slice(k * K, (k + 1) * K)
        jcarry, o = step(jnp.zeros(2), *(jnp.asarray(a[sl]) for a in inputs),
                         jcarry)
        jouts.append(jax.tree_util.tree_map(np.asarray, o))
    for i, name in enumerate(one._fields):
        want = np.concatenate([getattr(o, name) for o in jouts])
        if name in ("Theta", "feasible"):
            np.testing.assert_array_equal(got[i][0].numpy(), want, name)
        else:
            np.testing.assert_allclose(got[i][0].numpy(), want, rtol=0,
                                       atol=TOL, err_msg=name)
    np.testing.assert_allclose(session.carry.x[0].numpy(),
                               np.asarray(jcarry.x), rtol=0, atol=TOL)
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(session.carry.admm, f)[0].numpy(),
                                   np.asarray(getattr(jcarry.admm, f)),
                                   rtol=0, atol=TOL, err_msg=f)


def test_per_dispatch_latencies_and_card_timers(port_flagship):
    refs, w, theta, gamma = _inputs()
    arrays, cfg = port_flagship.to_device(torch.float64, "cpu",
                                          solver="cuda", **KW)
    times = measure_step_latencies(arrays, cfg, refs[:6], w[:6], theta[:6],
                                   gamma[:6])
    assert times.shape == (6,) and bool((times > 0).all())
    # the one-tick session it times follows the windowed session's
    # trajectory: six one-tick advances give six ticks' carry
    one = Session(arrays, cfg, 1, np.zeros(2))
    for t in range(6):
        one.advance(*(torch.tensor(a[t:t + 1])
                      for a in (refs, w, theta, gamma)))
    six = Session(arrays, cfg, 6, np.zeros(2))
    six.advance(*(torch.tensor(a[:6]) for a in (refs, w, theta, gamma)))
    assert torch.equal(one.carry.x, six.carry.x)
    with pytest.raises(RuntimeError, match="CUDA device"):
        device_step_time(arrays, cfg, refs[:4], w[:4], theta[:4], gamma[:4])
    with pytest.raises(RuntimeError, match="CUDA device"):
        dispatch_floor_s("cpu")


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_latency_report_matches_jax(scale, capsys):
    """Times below and above the reference's 20 ms bins (the report
    extends its bins past the largest time)."""
    times = np.random.default_rng(1).gamma(2.0, 2e-3 * scale, size=257)
    want = jax_latency_report(times, "x")
    want_out = capsys.readouterr().out
    got = latency_report(times, "x")
    assert capsys.readouterr().out == want_out
    assert got == want


def test_serve_app_short_session_on_cpu():
    """The app on 600 ticks in windows of 50 (float64, the kernel's plain
    version), one setpoint change: the session stays feasible and tracks
    its last setpoint, and every window and dispatch is timed.  The two
    checks against the 20 ms budget are the card's: on a CPU shared by
    the test workers an eager tick may take longer, so they are not
    asserted here."""
    args = serve_controller.parse_args(
        ["--device", "cpu", "--dtype", "float64", "--ticks", "600",
         "--window", "50", "--per-dispatch-ticks", "4"])
    out = serve_controller.run(args)
    assert out["checks"]["feasible"] and out["checks"]["tracks"]
    assert set(out["checks"]) == {"p99", "misses", "feasible", "tracks"}
    assert out["per_tick_ms"].shape == (12,)
    assert out["latency"]["n_solves"] == 4 and out["floor_ms"] is None
    assert out["device_per_tick_ms"] is None
    assert out["session"].graph is None and out["session"].launches == 0


def test_serve_inputs_are_the_jax_apps():
    """``session_inputs`` draws what ``rtmpc_tpu/apps/serve_controller.py``
    draws: the same numpy calls in the same order."""
    rng = np.random.default_rng(7)
    Tn = 1200
    refs = np.zeros((Tn, 2))
    levels = rng.uniform(-6, 6, size=(Tn // 500 + 1,))
    for i in range(len(levels)):
        refs[i * 500:(i + 1) * 500, 0] = levels[i]
    theta = (rng.uniform(size=Tn) >= 0.4).astype(np.int64)
    gamma = (rng.uniform(size=Tn) >= 0.4).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(-0.1, 0.1, size=(Tn, 2))
    for a, b in zip(serve_controller.session_inputs(7, Tn, 0.4),
                    (refs, theta, gamma, w)):
        np.testing.assert_array_equal(a, b)
    args = serve_controller.parse_args([])
    assert isinstance(args, argparse.Namespace)
    assert (args.ticks, args.window, args.loss_prob, args.solver,
            args.device) == (15000, 150, 0.4, "cuda", "cuda")
