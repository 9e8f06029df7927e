"""The Fig. 3a sweep of the port against the JAX package.

* The committed draws (``rtmpc_tpu_torch/data/results_linear_seed0.npz``)
  are bit-equal to what ``rtmpc_tpu/apps/results_linear.py`` feeds both
  arms at ``--seed 0`` (``parallel/mc.py:93-98``), and the port's
  disturbances formed from them equal the JAX package's under x64.
* ``run_mc_sweep`` against the JAX package's on the cartpole, both arms
  as the app sets them (tube: consistent actuator; tracking: smart
  actuator, arm stop on certificates), 2 probabilities x 2 runs x T=8:
  solver "ip_riccati" against JAX "ip_riccati", and solver "cuda" (its
  plain version on the CPU) against JAX "admm" without polish at 20+20
  iterations; ``tracking_error`` within 1e-8, ``sample_traj`` and
  ``sample_x_nom`` within 1e-8 (1e-7 under the interior point: measured
  3.0e-8, see ``TRAJ_TOL``), ``infeasible_counts`` and ``feasible`` equal.
* Checkpoint and resume equal a single-shot run.
* The app's ``--quick`` JSON has the JAX app's row keys.

Write the draws file anew with ``python tests/test_torch_results.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = os.path.join(REPO, "rtmpc_tpu_torch", "data",
                     "results_linear_seed0.npz")
PROBS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
N_MC, T_FULL = 20, 250


def jax_draws(seed=0, probs=PROBS, n_mc=N_MC, T=T_FULL):
    """What ``results_linear.py:74-95`` feeds both arms: the masks and the
    float32 uniforms of ``run_mc_sweep``'s key ``k_tube``
    (``mc.py:93-98``, ``protocol/network.py:34-61``)."""
    from rtmpc_tpu.protocol.network import draw_loss_masks
    key = jax.random.PRNGKey(seed)
    k_tube, _ = jax.random.split(key)
    k1, k2 = jax.random.split(k_tube)
    batch = len(probs) * n_mc
    p_flat = jnp.asarray(np.repeat(np.asarray(probs, np.float64), n_mc))
    theta, gamma = draw_loss_masks(k1, T, p_flat, p_flat,
                                   batch_shape=(batch,))
    u = jax.random.uniform(k2, (batch, T, 4), jnp.float32)
    return (np.asarray(theta).astype(np.uint8),
            np.asarray(gamma).astype(np.uint8), np.asarray(u))


def write_draws(path=DRAWS):
    theta, gamma, u = jax_draws()
    np.savez_compressed(path, theta=theta, gamma=gamma, u=u)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_draws()
    print(f"wrote {DRAWS}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario  # noqa: E402
from rtmpc_tpu.models.specs import setup_tracking as jax_setup_tracking  # noqa: E402
from rtmpc_tpu.models.specs import (  # noqa: E402
    setup_tube_tracking as jax_setup_tube_tracking)
from rtmpc_tpu.parallel.mc import run_mc_sweep as jax_run_mc_sweep  # noqa: E402
from rtmpc_tpu.protocol.network import draw_disturbances  # noqa: E402

from rtmpc_tpu_torch.apps import results_linear  # noqa: E402
from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario  # noqa: E402
from rtmpc_tpu_torch.models import (flagship_setup, setup_tracking,  # noqa: E402
                                    setup_tube_tracking)
from rtmpc_tpu_torch.parallel.mc import (SweepDraws, load_draws,  # noqa: E402
                                         run_mc_sweep)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(probs=[0.3, 0.8], n_mc=2, T=8)
ADMM_KW = dict(iters=20, iters2=20, alpha=1.8, rho2_scale=0.2)
# Trajectories: 1e-8, except under the interior point, whose endgame on
# the cartpole's flat optimal face moves the applied input by rounding
# (test_torch_ip_riccati.py); measured 3.0e-8 on the tracking arm.
TRAJ_TOL = {"cuda": 1e-8, "ip_riccati": 1e-7}


def _small_draws(seed=0):
    theta, gamma, u = jax_draws(seed, **SMALL)
    return SweepDraws(torch.from_numpy(theta), torch.from_numpy(gamma),
                      torch.from_numpy(u))


def test_committed_draws_bit_equal_to_jax():
    theta, gamma, u = jax_draws()
    got = load_draws(DRAWS)
    assert got.theta.dtype == torch.uint8 and got.u.dtype == torch.float32
    np.testing.assert_array_equal(got.theta.numpy(), theta)
    np.testing.assert_array_equal(got.gamma.numpy(), gamma)
    np.testing.assert_array_equal(got.u.numpy(), u)
    assert got.u.shape == (len(PROBS) * N_MC, T_FULL, 4)


def test_disturbances_bit_equal_to_jax():
    """The port's w from the committed uniforms equals the JAX package's
    ``draw_disturbances`` under x64 (float64 affine map of float32
    uniforms)."""
    sc = cartpole_scenario()
    key = jax.random.split(jax.random.split(jax.random.PRNGKey(0))[0])[1]
    want = np.asarray(draw_disturbances(key, T_FULL, sc.w_lo, sc.w_hi,
                                        batch_shape=(len(PROBS) * N_MC,)))
    u = load_draws(DRAWS).u
    w_lo = torch.tensor(sc.w_lo)
    got = w_lo + u.double() * (torch.tensor(sc.w_hi) - w_lo)
    assert want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def cartpole_setups():
    js, ps = jax_scenario(), cartpole_scenario()
    jtube = jax_setup_tube_tracking(js.A, js.B, js.Q, js.R, js.N, js.X, js.U,
                                    js.W, fixed_initial_state=True,
                                    rpi_method=1)
    ptube = setup_tube_tracking(ps.A, ps.B, ps.Q, ps.R, ps.N, ps.X, ps.U,
                                ps.W, fixed_initial_state=True, rpi_method=1)
    jtrack = jax_setup_tracking(js.A, js.B, js.Q, js.R, js.N, js.X, js.U)
    ptrack = setup_tracking(ps.A, ps.B, ps.Q, ps.R, ps.N, ps.X, ps.U)
    return ps, {"tube": (jtube, ptube), "track": (jtrack, ptrack)}


ARMS = {"tube": dict(actuator_mode="consistent", infeas_mode=None),
        "track": dict(actuator_mode="smart", infeas_mode="certificate")}


@pytest.mark.parametrize("arm", ["tube", "track"])
@pytest.mark.parametrize("solver", ["ip_riccati", "cuda"])
def test_mc_sweep_matches_jax(cartpole_setups, solver, arm):
    sc, setups = cartpole_setups
    jax_setup, port_setup = setups[arm]
    if solver == "ip_riccati":
        jkw = pkw = dict(solver="ip_riccati", ip_iters=30)
    else:   # the kernel's plain version against JAX's ADMM, no polish
        jkw, pkw = dict(solver="admm", **ADMM_KW), dict(solver="cuda",
                                                        **ADMM_KW)
    T = SMALL["T"]
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    common = dict(T=T, n_mc=SMALL["n_mc"], loss_probs=SMALL["probs"],
                  refs=refs, x0=sc.x0, w_lo=sc.w_lo, w_hi=sc.w_hi,
                  **ARMS[arm])
    ja, jc = jax_setup.to_device(dtype=jnp.float64, **jkw)
    k_tube = jax.random.split(jax.random.PRNGKey(0))[0]
    want = jax_run_mc_sweep(ja, jc, key=k_tube, **common)
    pa, pc = port_setup.to_device(torch.float64, "cpu", **pkw)
    got = run_mc_sweep(pa, pc, draws=_small_draws(), **common)

    np.testing.assert_allclose(got.tracking_error, want.tracking_error,
                               rtol=0, atol=1e-8)
    tol = TRAJ_TOL[solver]
    np.testing.assert_allclose(got.sample_traj, want.sample_traj, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got.sample_x_nom, want.sample_x_nom, rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got.infeasible_counts,
                                  want.infeasible_counts)
    np.testing.assert_array_equal(got.feasible, want.feasible)


def test_checkpoint_resume_equals_single_shot(tmp_path):
    """A sweep stopped after its first chunk and resumed from the
    checkpoint gives the single-shot rows; a checkpoint of other draws is
    ignored."""
    arrays, cfg = flagship_setup().to_device(torch.float64, "cpu",
                                             solver="cuda", iters=10,
                                             iters2=10)
    T, probs, n_mc = 6, [0.0, 0.4, 0.8], 2
    refs = np.zeros((T, 2))
    refs[:, 0] = 3.0
    common = dict(T=T, n_mc=n_mc, loss_probs=probs, refs=refs,
                  x0=np.zeros(2), w_lo=[-0.1, -0.1], w_hi=[0.1, 0.1])
    g = torch.Generator().manual_seed(5)
    from rtmpc_tpu_torch.parallel.mc import draw_sweep
    draws = draw_sweep(g, T, n_mc, probs, 2)
    single = run_mc_sweep(arrays, cfg, draws=draws, **common)

    path = str(tmp_path / "ck.npz")
    run_mc_sweep(arrays, cfg, draws=draws, checkpoint_path=path,
                 n_chunks=3, **common)
    with np.load(path) as ck:                    # stopped after chunk 1
        part = {k: ck[k].copy() for k in ck.files}
    part["next_chunk"] = np.asarray(1)
    part["err"][1:] = np.nan
    part["feas"][1:] = False
    part["sample_traj"][1:] = 0.0
    part["sample_x_nom"][1:] = 0.0
    np.savez(path, **part)
    resumed = run_mc_sweep(arrays, cfg, draws=draws, checkpoint_path=path,
                           n_chunks=3, **common)
    for f in ("tracking_error", "feasible", "infeasible_counts",
              "sample_traj", "sample_x_nom"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(single, f), err_msg=f)

    other = draw_sweep(torch.Generator().manual_seed(6), T, n_mc, probs, 2)
    part["err"][:] = -1.0                        # would show if it were read
    np.savez(path, **part)
    fresh = run_mc_sweep(arrays, cfg, draws=other, checkpoint_path=path,
                         n_chunks=3, **common)
    assert not (fresh.tracking_error == -1.0).any()


def test_app_quick_json_has_the_jax_row_keys(cartpole_setups, tmp_path):
    """``--quick`` (T=60, 4 probabilities x 4 runs) on the CPU with the
    kernel's plain version, on the module's controllers (the app's own
    setup is the one ``cartpole_setups`` makes); the rows carry the keys
    of the JAX app's rows (read from its committed float64 run)."""
    _, setups = cartpole_setups
    out = tmp_path / "quick.json"
    args = results_linear.parse_args(["--device", "cpu", "--quick",
                                      "--solver", "cuda", "--save-json",
                                      str(out)])
    ran = results_linear.run(args, (setups["tube"][1], setups["track"][1]))
    assert ran["ok"]
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, "RESULTS_LINEAR_CPU_F64_r05.json")) as f:
        truth = json.load(f)
    assert [set(r) for r in got["rows"]] == [set(truth["rows"][0])] * 4
    for k in ("app", "solver", "dtype", "backend", "n_mc", "T", "seed"):
        assert k in got, k
    assert (got["n_mc"], got["T"], got["dtype"]) == (4, 60, "float32")
    assert [r["p"] for r in got["rows"]] == [0.0, 0.3, 0.6, 0.9]
