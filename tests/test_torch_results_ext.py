"""The extended and nonlinear Results sweeps of the port against the JAX
package.

* The committed draws (``rtmpc_tpu_torch/data/results_extended_seed0.npz``)
  are bit-equal to what ``rtmpc_tpu/apps/results_linear_extended.py`` and
  ``results_nonlinear.py`` feed every arm at ``--seed 0``: the masks and
  uniforms of the seed's key itself (``parallel/mc.py:93-98``), other bits
  than ``results_linear``'s, which draws from the key's first split.
* ``run_mc_sweep`` against the JAX package's on the cartpole, 2
  probabilities x 2 runs x T=8, solver "cuda" (its plain version on the
  CPU) against JAX "admm" at 20+20 iterations: the extended arm on the
  linear plant, and the tube arm and the extended arm (stopping on
  certificates) on the nonlinear plant through ``plant_step``;
  ``tracking_error``, ``sample_traj`` and ``sample_x_nom`` within 1e-8,
  ``infeasible_counts`` and ``feasible`` equal.
* The checkpoint's fingerprint tells two plants apart.
* Both apps under ``--quick --device cpu`` (the quick size cut further for
  the test): the JSON's rows carry the keys of the JAX apps' rows (read
  from their committed float64 runs), the extended app's
  ``solve_time_stats`` has RT-MPC's and Ext-RT-MPC's with the keys of the
  JAX package's ``latency_report`` (the nonlinear app, like the JAX one,
  has none), the figures are written, and ``compare_rows`` holds rows to
  a reference file.

Write the draws files anew with ``python tests/test_torch_results_ext.py``.
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
                     "results_extended_seed0.npz")
PROBS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
N_MC, T_FULL = 20, 250


def jax_draws(seed=0, probs=PROBS, n_mc=N_MC, T=T_FULL):
    """What ``results_linear_extended.py:69-78`` and
    ``results_nonlinear.py:84-102`` feed every arm: the masks and the
    float32 uniforms of ``run_mc_sweep`` at the key ``PRNGKey(seed)``
    (``mc.py:93-98``, ``protocol/network.py:34-61``)."""
    from rtmpc_tpu.protocol.network import draw_loss_masks
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    batch = len(probs) * n_mc
    p_flat = jnp.asarray(np.repeat(np.asarray(probs, np.float64), n_mc))
    theta, gamma = draw_loss_masks(k1, T, p_flat, p_flat,
                                   batch_shape=(batch,))
    u = jax.random.uniform(k2, (batch, T, 4), jnp.float32)
    return (np.asarray(theta).astype(np.uint8),
            np.asarray(gamma).astype(np.uint8), np.asarray(u))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # the apps' full size, and n_mc 4 (RESULTS_LINEAR_EXT_ADMM_CPU_F64_JAX's)
    for n_mc, path in ((N_MC, DRAWS), (4, DRAWS.replace(".npz", "_nmc4.npz"))):
        theta, gamma, u = jax_draws(n_mc=n_mc)
        np.savez_compressed(path, theta=theta, gamma=gamma, u=u)
        print(f"wrote {path}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

from rtmpc_tpu.apps.results_nonlinear import (  # noqa: E402
    build_nonlinear_plant_step as jax_build_plant_step)
from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario  # noqa: E402
from rtmpc_tpu.models.specs import (  # noqa: E402
    setup_extended_tube_tracking as jax_setup_extended)
from rtmpc_tpu.models.specs import (  # noqa: E402
    setup_tube_tracking as jax_setup_tube_tracking)
from rtmpc_tpu.parallel.latency import (  # noqa: E402
    latency_report as jax_latency_report)
from rtmpc_tpu.parallel.mc import run_mc_sweep as jax_run_mc_sweep  # noqa: E402

from rtmpc_tpu_torch.apps import (common, results_linear_extended,  # noqa: E402
                                  results_nonlinear)
from rtmpc_tpu_torch.apps.common import (cartpole_controllers,  # noqa: E402
                                         compare_rows)
from rtmpc_tpu_torch.apps.results_nonlinear import (  # noqa: E402
    build_nonlinear_plant_step)
from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario  # noqa: E402
from rtmpc_tpu_torch.models import flagship_setup  # noqa: E402
from rtmpc_tpu_torch.parallel.mc import (SweepDraws, draw_sweep,  # noqa: E402
                                         load_draws, run_mc_sweep)


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


def test_committed_draws_bit_equal_to_jax():
    theta, gamma, u = jax_draws()
    got = load_draws(DRAWS)
    assert got.theta.dtype == torch.uint8 and got.u.dtype == torch.float32
    np.testing.assert_array_equal(got.theta.numpy(), theta)
    np.testing.assert_array_equal(got.gamma.numpy(), gamma)
    np.testing.assert_array_equal(got.u.numpy(), u)
    assert got.u.shape == (len(PROBS) * N_MC, T_FULL, 4)
    # not the linear app's draws (the key's first split)
    linear = load_draws(os.path.join(os.path.dirname(DRAWS),
                                     "results_linear_seed0.npz"))
    assert not torch.equal(linear.theta, got.theta)


@pytest.fixture(scope="module")
def port_setups():
    sc = cartpole_scenario()
    return sc, cartpole_controllers(sc, ("tube", "ext", "track"))


@pytest.fixture(scope="module")
def jax_setups():
    js = jax_scenario()
    kw = dict(rpi_method=1)
    return js, {
        "tube": jax_setup_tube_tracking(js.A, js.B, js.Q, js.R, js.N, js.X,
                                        js.U, js.W, fixed_initial_state=True,
                                        **kw),
        "ext": jax_setup_extended(js.A, js.B, js.Q, js.R, js.N, js.X, js.U,
                                  js.W, fixed_initial_state=False, **kw)}


@pytest.mark.parametrize("arm,plant,infeas", [
    ("ext", "linear", None),
    ("tube", "nonlinear", None),
    ("ext", "nonlinear", "certificate")])
def test_mc_sweep_matches_jax(port_setups, jax_setups, arm, plant, infeas):
    sc, psetups = port_setups
    js, jsetups = jax_setups
    T = SMALL["T"]
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    nonlinear = plant == "nonlinear"
    w_lo, w_hi = ((np.zeros(4), np.zeros(4)) if nonlinear
                  else (sc.w_lo, sc.w_hi))
    common_kw = dict(T=T, n_mc=SMALL["n_mc"], loss_probs=SMALL["probs"],
                     refs=refs, x0=sc.x0, w_lo=w_lo, w_hi=w_hi,
                     actuator_mode="consistent", infeas_mode=infeas)
    ja, jc = jsetups[arm].to_device(dtype=jnp.float64, solver="admm",
                                    **ADMM_KW)
    want = jax_run_mc_sweep(
        ja, jc, key=jax.random.PRNGKey(0),
        plant_step=jax_build_plant_step(jnp, js) if nonlinear else None,
        **common_kw)
    pa, pc = psetups[arm].to_device(torch.float64, "cpu", solver="cuda",
                                    **ADMM_KW)
    draws = SweepDraws(*map(torch.tensor, jax_draws(0, **SMALL)))
    got = run_mc_sweep(
        pa, pc, draws=draws,
        plant_step=build_nonlinear_plant_step(sc) if nonlinear else None,
        **common_kw)
    for f in ("tracking_error", "sample_traj", "sample_x_nom"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(got.infeasible_counts,
                                  want.infeasible_counts)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    assert got.feasible.all()


def test_checkpoint_fingerprint_tells_plants_apart(tmp_path):
    """A checkpoint written under one plant is ignored under another, and
    read again under the same one."""
    arrays, cfg = flagship_setup().to_device(torch.float64, "cpu",
                                             solver="cuda", iters=10,
                                             iters2=10)
    T, probs, n_mc = 5, [0.0, 0.5], 2
    refs = np.zeros((T, 2))
    refs[:, 0] = 3.0
    draws = draw_sweep(torch.Generator().manual_seed(7), T, n_mc, probs, 2)
    kw = dict(T=T, n_mc=n_mc, loss_probs=probs, refs=refs, x0=np.zeros(2),
              w_lo=[-0.1, -0.1], w_hi=[0.1, 0.1], draws=draws, n_chunks=2)

    def damped(x, u, w):
        return 0.9 * (x @ arrays.A.T) + u @ arrays.B.T + w

    def tagged(x, u, w):
        return damped(x, u, w)
    tagged.plant_id = "damped double integrator, 0.9"

    path = str(tmp_path / "ck.npz")
    linear = run_mc_sweep(arrays, cfg, checkpoint_path=path, **kw)
    with np.load(path) as ck:
        mark = {k: ck[k].copy() for k in ck.files}
    mark["err"][:] = -1.0               # would show if the file were read
    np.savez(path, **mark)
    for plant in (damped, tagged):
        other = run_mc_sweep(arrays, cfg, checkpoint_path=path,
                             plant_step=plant, **kw)
        assert not (other.tracking_error == -1.0).any()
        assert not np.allclose(other.tracking_error, linear.tracking_error)
        np.savez(path, **mark)
    again = run_mc_sweep(arrays, cfg, checkpoint_path=path, **kw)
    assert (again.tracking_error == -1.0).all()


@pytest.mark.parametrize("app", ["linear_extended", "nonlinear",
                                 "nonlinear_extended"])
def test_app_quick_json_has_the_jax_row_keys(port_setups, tmp_path,
                                             monkeypatch, app):
    """``--quick --device cpu`` under the default solver (float64
    ``ip_riccati``; the extended arm solves once a step), at 2
    probabilities x 2 runs x T=6 in place of the quick size's 3 x 3 x 60."""
    _, setups = port_setups
    monkeypatch.setattr(common, "EXT_QUICK", (6, 2, [0.0, 0.8]))
    monkeypatch.setenv("RTMPC_RESULTS_DIR", str(tmp_path / "figures"))
    out = tmp_path / "quick.json"
    argv = ["--device", "cpu", "--quick", "--save-json", str(out)]
    if app == "linear_extended":
        mod, truth = results_linear_extended, results_linear_extended.TRUTH
    else:
        mod, truth = results_nonlinear, results_nonlinear.TRUTH
        if app == "nonlinear_extended":
            argv.append("--extended")
    ran = mod.run(mod.parse_args(argv), setups)
    assert ran["ok"] and ran["compared"] is None
    got = json.loads(out.read_text())
    with open(truth) as f:
        ref = json.load(f)
    want_keys = set(ref["rows"][0])
    if app == "nonlinear":
        want_keys = {k for k in want_keys if "Ext" not in k}
    assert [set(r) for r in got["rows"]] == [want_keys] * 2
    for k in ("app", "solver", "dtype", "backend", "n_mc", "T", "seed"):
        assert got[k] == {"n_mc": 2, "T": 6, "backend": "cpu"}.get(k, ref[k])
    if app == "linear_extended":
        keys = set(jax_latency_report(np.ones(3) * 1e-3, "x"))
        stats = got["solve_time_stats"]
        assert set(stats) == {"RT-MPC", "Ext-RT-MPC"}
        assert all(set(st) == keys and st["n_solves"] == 6
                   for st in stats.values())
        figures = ("solvetime_hist", "boxplot")
    else:
        assert "solve_time_stats" not in got
        figures = ("boxplot", "trajectories")
    stem = ("results_linear_extended" if app == "linear_extended"
            else "results_" + app)
    for name in figures:
        png = tmp_path / "figures" / f"{stem}_{name}.png"
        assert png.stat().st_size > 5000, name
    if app != "linear_extended":
        assert got["extended"] == (app == "nonlinear_extended")
        assert ran["max_angle"] <= 0.3
    calls = got["counts"]         # the sweep's, not the one-tick timer's
    assert all(c["ip_calls"] == 6 for c in calls.values()), calls


def test_compare_rows_against_a_reference_file(tmp_path):
    with open(results_linear_extended.TRUTH) as f:
        ref = json.load(f)
    assert (ref["dtype"], ref["backend"], ref["solver"]) == (
        "float64", "cpu", "ip_riccati")
    rows = [dict(r) for r in ref["rows"]]
    ok, msg = compare_rows(rows, results_linear_extended.TRUTH, 0.02)
    assert ok and "rms_Ext-RT-MPC" in msg
    # the float64 gate is far tighter than the figure other solvers print
    rows[3]["rms_Ext-RT-MPC"] *= 1 + 5e-4
    assert compare_rows(rows, results_linear_extended.TRUTH,
                        common.ROWS_RTOL_PRINTED)[0]
    assert not compare_rows(rows, results_linear_extended.TRUTH,
                            common.ROWS_RTOL)[0]
    rows[3]["rms_Ext-RT-MPC"] *= 1.03
    ok, msg = compare_rows(rows, results_linear_extended.TRUTH, 0.02)
    assert not ok
    rows[3]["rms_Ext-RT-MPC"] = float("nan")
    assert not compare_rows(rows, results_linear_extended.TRUTH, 0.02)[0]
    rows = [dict(r) for r in ref["rows"]]
    rows[0]["infeasible_R-MPC"] += 1
    ok, msg = compare_rows(rows, results_linear_extended.TRUTH, 0.02)
    assert not ok and "infeasible_R-MPC" in msg
    # rows of fewer arms are held on the arms they have
    sub = [{k: v for k, v in r.items() if "Ext" not in k}
           for r in ref["rows"]]
    assert compare_rows(sub, results_linear_extended.TRUTH, 0.02)[0]
