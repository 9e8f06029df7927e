"""The plain reference against the program on the CPU, in float64, at a
small size: the same sets, the same QP optimum, the same closed loop.

The program runs its structured interior point to convergence here (the
exact optimum's stand-in), so that what is compared is the reference's
set-up, QP and protocol, not a solver's truncation.  The bars are about
10x what this CPU read: the program reduces its sets and the reference
does not, and the program's reduction inflates a set by up to 1e-7, which
moves the cartpole's optimum by ~2e-6."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.loop import rollout
from benchmark.reference.mpc import build_controller

# (config, QP's u bar, closed loop's x bar, u bar, initial-state scale,
#  reference on x_1, loss)
CASES = [("flagship-di", 1e-5, 1e-5, 1e-5, 0.3, 3.0, 0.7),
         ("cartpole-n20", 2e-5, 6e-5, 3e-3, 0.05, 0.5, 0.4)]


def _config(name):
    return json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                       f"{name}.json")))


@pytest.mark.parametrize("name,qp_tol,x_tol,u_tol,scale,ref,p", CASES)
def test_reference_matches_the_program(name, qp_tol, x_tol, u_tol, scale,
                                       ref, p):
    from rtmpc_tpu_torch.models import setup_tube_tracking
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    from rtmpc_tpu_torch.utils import box

    config = _config(name)
    ctl = build_controller(config)
    pl, c = config["plant"], config["controller"]
    setup = setup_tube_tracking(
        np.array(pl["A"]), np.array(pl["B"]), np.array(c["Q"]),
        np.array(c["R"]), c["N"], box(np.array(pl["x_box"])),
        box(np.array(pl["u_box"])), box(np.array(pl["w_box"])),
        fixed_initial_state=True, rpi_method=c["rpi_method"],
        eps_var=c["eps"], lambda_param=c["lambda"])
    nx, N = ctl.A.shape[0], ctl.N
    # the tightened state set
    np.testing.assert_allclose(ctl.hxc, setup.Xc.b, atol=1e-7)

    rng = np.random.default_rng(3)
    for _ in range(3):
        x0 = rng.uniform(-1, 1, nx) * np.array(pl["x_box"]) * scale
        r = np.zeros(nx)
        r[0] = ref
        sol, _ = setup.template.solve_dense(x0, r)
        u = sol.z[nx * (N + 1):nx * (N + 1) + N]
        assert np.abs(ctl.packet(x0, r)[:N, 0] - u).max() < qp_tol

    B, T = 3, 12
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver="ip_riccati",
                                  ip_iters=40)
    refs = np.zeros((B, T, nx))
    refs[:, :, 0] = ref
    refs[:, T // 2:, 0] = -ref
    theta = (rng.uniform(size=(B, T)) >= p).astype(np.int32)
    gamma = (rng.uniform(size=(B, T)) >= p).astype(np.int32)
    theta[:, 0] = gamma[:, 0] = 1
    w = rng.uniform(-1, 1, (B, T, nx)) * np.array(pl["w_box"])
    _, out = make_batched_rollout(arrays, cfg, T)(
        torch.zeros(B, nx, dtype=torch.float64), torch.tensor(refs),
        torch.tensor(w), torch.tensor(theta), torch.tensor(gamma))
    for b in range(B):
        o = rollout(ctl, np.zeros(nx), refs[b], w[b], theta[b], gamma[b])
        assert o["feasible"].all() and bool(out.feasible[b, -1])
        np.testing.assert_array_equal(o["Theta"], out.Theta[b].numpy())
        assert np.abs(o["x"] - out.x[b].numpy()).max() < x_tol
        assert np.abs(o["x_nom"] - out.x_nom[b].numpy()).max() < x_tol
        assert np.abs(o["u"] - out.u[b].numpy()).max() < u_tol


def test_check_stops_at_the_first_non_finite_output():
    """A control that diverges reads the gap it reached before its first
    non-finite output, and those outputs are counted (limit 0), so a NaN
    never passes."""
    from benchmark import check
    config = _config("flagship-di")
    T = 12
    rng = np.random.default_rng(3)
    x0 = np.zeros(2)
    refs = np.zeros((T, 2))
    refs[:, 0] = 2.0
    w = rng.uniform(-0.1, 0.1, (T, 2))
    flags = np.ones(T, dtype=np.int32)
    ref = rollout(check.controller(config), x0, refs, w, flags, flags)

    def answer(x):
        return check.Answer(x0, refs, w, flags, flags, x, ref["u"],
                            ref["x_nom"], ref["Theta"], ref["feasible"][-1])
    sound = check.compare(config, [answer(ref["x"])])
    assert sound["nonfinite"] == 0 and sound["x_err"] == 0
    diverged = ref["x"].copy()
    diverged[4:] += 1e3 * np.arange(1, T - 3)[:, None]
    diverged[9:] = np.nan
    n = check.compare(config, [answer(diverged)])
    assert n["nonfinite"] == T - 9
    assert n["x_err"] == pytest.approx(5e3)
    assert np.isfinite(n["rms_err"])
    limits = {k: 0 if k in ("nonfinite", "theta_diff", "feasible_diff")
              else np.inf for k in check.NUMBERS}
    assert check.judge(sound, limits)[0]
    assert not check.judge(n, limits)[0]
