"""The cartpole animations app (``apps/create_animations``) against the
JAX package, in float64 on the CPU.

``run`` (both arms, the nonlinear plant) on the JAX app's own draws gives
the trajectories of the JAX engine's ``make_rollout_fn`` on the same
draws, setups and solver to 1e-9.  The solver is "admm" in float64, two
phases of 60, the one whose JAX program compiles fastest, without the
polish the app's float64 schedule adds (the JAX program with the polish
takes minutes to compile on the CPU; the polish is held to the JAX
package's in ``tests/test_torch_polish_ip.py``); the run is the
``--quick`` one cut from 60 to 20 steps.  The GIF and the strip PNG are
written from ``run``'s trajectories; with ``--strip-dir`` each arm's strip
goes to that directory too (``write_figures``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.results_nonlinear import (
    build_nonlinear_plant_step as jax_plant_step)
from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario
from rtmpc_tpu.models import setup_tracking as jax_setup_tracking
from rtmpc_tpu.models import setup_tube_tracking as jax_setup_tube_tracking
from rtmpc_tpu.parallel.rollout import make_rollout_fn
from rtmpc_tpu.protocol import draw_disturbances, draw_loss_masks

from rtmpc_tpu_torch.apps import create_animations
from rtmpc_tpu_torch.apps.common import cartpole_controllers
from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario

T = 20
P_LOSS = 0.4
SCHEDULE = dict(solver="admm", iters=60, iters2=60, alpha=1.8,
                rho2_scale=0.2, polish=False)
ARGV = ["--device", "cpu", "--quick", "--solver", "admm", "--dtype",
        "float64", "--no-figures"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this CPU build of torch can deadlock in a
    batched LU factorization (the polish) run on several threads, and is
    slower on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(seed):
    """``rtmpc_tpu/apps/create_animations.py:100-103``."""
    sc = jax_scenario()
    kl, kw = jax.random.split(jax.random.PRNGKey(seed))
    theta, gamma = draw_loss_masks(kl, T, P_LOSS, P_LOSS)
    w = draw_disturbances(kw, T, sc.w_lo, sc.w_hi)
    return {"theta": np.asarray(theta), "gamma": np.asarray(gamma),
            "w": np.asarray(w)}


@pytest.fixture(scope="module")
def ran(monkeypatch_module):
    monkeypatch_module.setattr(create_animations, "QUICK_T", T)
    monkeypatch_module.setattr(create_animations, "solver_kwargs",
                               lambda args: SCHEDULE)
    draws = _jax_draws(0)
    sc = cartpole_scenario()
    setups = cartpole_controllers(sc, ("tube", "track"))
    out = create_animations.run(create_animations.parse_args(ARGV), setups,
                                draws=draws)
    return out, draws


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_run_matches_jax_rollouts(ran):
    out, draws = ran
    assert out["ok"]
    sc = jax_scenario()
    setups = {
        "tube": (jax_setup_tube_tracking(
            sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U, sc.W,
            fixed_initial_state=True, rpi_method=1), "consistent"),
        "track": (jax_setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X,
                                     sc.U), "smart")}
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    for arm, (setup, mode) in setups.items():
        arrays, cfg = setup.to_device(dtype=jnp.float64, **SCHEDULE)
        roll = jax.jit(make_rollout_fn(arrays, cfg, T, actuator_mode=mode,
                                       plant_step=jax_plant_step(jnp, sc)))
        _, outs = roll(jnp.asarray(sc.x0), jnp.asarray(refs),
                       jnp.asarray(draws["w"], jnp.float64),
                       jnp.asarray(draws["theta"]),
                       jnp.asarray(draws["gamma"]))
        want = np.vstack([sc.x0[None], np.asarray(outs.x)])
        assert out["traj"][arm].shape == (T + 1, 4)
        np.testing.assert_allclose(out["traj"][arm], want, rtol=0,
                                   atol=1e-9, err_msg=arm)


def test_gif_and_strip_are_written(ran, tmp_path):
    out, _ = ran
    traj = out["traj"]["tube"]
    frames = create_animations.render_gif(traj, 0.02,
                                          str(tmp_path / "a.gif"), "tube",
                                          every=5)
    create_animations.render_strip(frames, str(tmp_path / "a_strip.png"))
    assert len(frames) == len(range(0, T + 1, 5))
    assert (tmp_path / "a.gif").read_bytes()[:6] == b"GIF89a"
    assert (tmp_path / "a_strip.png").stat().st_size > 1000


def test_strip_dir_gets_each_arms_strip(ran, tmp_path, monkeypatch):
    out, _ = ran
    monkeypatch.setenv("RTMPC_RESULTS_DIR", str(tmp_path / "results"))
    args = create_animations.parse_args(
        ARGV + ["--strip-dir", str(tmp_path / "strips")])
    paths = create_animations.write_figures(args, out["traj"], every=10)
    for arm in ("tube", "track"):
        strip = tmp_path / "strips" / f"animation_{arm}_p0.4_strip.png"
        assert str(strip) in paths and strip.stat().st_size > 1000
        assert (tmp_path / "results" / f"animation_{arm}_p0.4.gif").exists()
