"""The port's batched rollout against the port's float64 protocol oracle
(``rtmpc_tpu_torch/utils/oracle_protocol.py``) on the CPU: the
counterpart of ``tests/test_rollout_parity.py``'s assertions, and the
hardware parity gate (``rtmpc_tpu_torch/apps/device_checks.py``) run on
the CPU.

* The flagship (double integrator, N=10, T=40, ``test_rollout_parity.py``'s
  inputs) in float64 under solver "admm" (400 iterations): Proposition 1
  (``e_t = x_t - x_hat_t`` in Z wherever ``Theta_t = 1``, more than 3
  such steps) and tube membership at 1e-6; x, x_nom and u within 2e-4 of
  the oracle, Theta equal.  The smart actuator (``setup_tracking``)
  likewise; the extended arm under the dense interior point within 1e-4.
* The gate's checks flag a protocol slip: an estimate moved out of the
  tube at one consistent step, a Theta flipped.
* ``device_checks.run("cpu", sections=("flagship", "extended"))`` (solver
  "cuda" runs K1's plain version here): every check passes and the JSON
  keys are there.  The extended section's horizon is cut from 100 to its
  first 40 steps (the oracle's too): the float64 structured interior
  point runs ~0.4 s a step eagerly on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from test_rollout_parity import A, B, Q, R, T, X0, _draw_inputs

from rtmpc_tpu_torch.apps import device_checks
from rtmpc_tpu_torch.models import (setup_extended_tube_tracking,
                                    setup_tracking, setup_tube_tracking)
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.utils import box
from rtmpc_tpu_torch.utils.oracle_protocol import run_oracle_rollout

X = box(np.array([8.0, 8.0]))
U = box(np.array([1.0]))
W = box(np.array([0.1, 0.1]))
EXT_T_CPU = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches here are small, and the test
    workers that run in parallel then do not compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tube_setup():
    return setup_tube_tracking(A, B, Q, R, 10, X, U, W,
                               fixed_initial_state=True)


def _engine(setup, refs, w, theta, gamma, mode="consistent", solver="admm"):
    """The port's batched rollout, B=1, float64 on the CPU, as
    ``test_rollout_parity._run_engine`` freezes the JAX engine; returns
    ``feasible`` and the outputs of the one row as numpy."""
    arrays, cfg = setup.to_device(
        torch.float64, "cpu", iters=400, solver=solver,
        probe_thetas=np.array([[1.0, 2.0, 5.0, 0.0], [0.0, 0.0, -9.0, 0.0]]))
    carry, outs = make_batched_rollout(arrays, cfg, T, actuator_mode=mode)(
        torch.tensor(X0)[None], torch.tensor(refs)[None],
        torch.tensor(w)[None], torch.tensor(theta, dtype=torch.int32)[None],
        torch.tensor(gamma, dtype=torch.int32)[None])
    return bool(carry.feasible.all()), {k: v[0].numpy() for k, v in
                                        outs._asdict().items()}


def _oracle(setup, refs, w, theta, gamma, mode="consistent"):
    out = run_oracle_rollout(setup, X0, refs, w, theta, gamma,
                             actuator_mode=mode)
    assert out["feasible"]
    return out


def test_flagship_parity_with_the_oracle(tube_setup):
    refs, w, theta, gamma = _draw_inputs(11)
    oracle = _oracle(tube_setup, refs, w, theta, gamma)
    assert oracle["steps"] == T
    feasible, outs = _engine(tube_setup, refs, w, theta, gamma)
    assert feasible
    for k in ("x", "x_nom", "u"):
        np.testing.assert_allclose(outs[k], oracle[k], atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(outs["Theta"], oracle["Theta"])


def test_flagship_proposition_1_and_tube(tube_setup):
    """The gate's own margins (``_invariant_margins``) at 1e-6, and the
    reference's checks one step at a time."""
    refs, w, theta, gamma = _draw_inputs(12)
    feasible, outs = _engine(tube_setup, refs, w, theta, gamma)
    assert feasible
    Z = tube_setup.Z
    xs = np.vstack([X0[None], outs["x"][:-1]])         # x_t, t = 0..T-1
    hits = 0
    for t in range(T):
        assert np.all(Z.A @ (xs[t] - outs["x_nom"][t]) <= Z.b + 1e-6), t
        if outs["Theta"][t] == 1:
            assert np.all(Z.A @ (xs[t] - outs["x_hat"][t]) <= Z.b + 1e-6), t
            hits += 1
    assert hits > 3
    inv = device_checks._invariant_margins(
        Z, X0, {k: v[None] for k, v in outs.items()})
    assert inv["prop1"] and inv["tube"] and inv["prop1_steps"] == hits
    assert inv["prop1_worst"] <= 1e-6 and inv["tube_worst"] <= 1e-6


def test_smart_actuator_parity_with_the_oracle():
    setup = setup_tracking(A, B, Q, R, 10, X, U)
    refs, w, theta, gamma = _draw_inputs(13)
    w = np.zeros_like(w)
    oracle = _oracle(setup, refs, w, theta, gamma, mode="smart")
    _, outs = _engine(setup, refs, w, theta, gamma, mode="smart")
    n = oracle["steps"]
    np.testing.assert_allclose(outs["x"][:n], oracle["x"], atol=2e-4)
    np.testing.assert_array_equal(outs["Theta"][:n], oracle["Theta"])


def test_extended_parity_with_the_oracle_under_ip():
    setup = setup_extended_tube_tracking(A, B, Q, R, 10, X, U,
                                         box(np.array([0.05, 0.05])),
                                         fixed_initial_state=False)
    refs, w, theta, gamma = _draw_inputs(14)
    w = np.clip(w, -0.05, 0.05)
    oracle = _oracle(setup, refs, w, theta, gamma)
    feasible, outs = _engine(setup, refs, w, theta, gamma, solver="ip")
    assert feasible
    dx = np.abs(outs["x"] - oracle["x"]).max()
    assert dx < 1e-4, dx
    np.testing.assert_array_equal(outs["Theta"], oracle["Theta"])


def test_gate_flags_a_protocol_slip(tube_setup):
    """The oracle's own rollout passes the gate's checks; an estimate moved
    out of Z at one consistent step fails Proposition 1, a nominal state
    moved out fails tube membership, a flipped Theta fails parity."""
    refs, w, theta, gamma = _draw_inputs(11)
    oracle = _oracle(tube_setup, refs, w, theta, gamma)
    run = {k: np.asarray(oracle[k])[None]
           for k in ("x", "u", "x_nom", "x_hat", "Theta")}
    Z = tube_setup.Z
    inv = device_checks._invariant_margins(Z, X0, run)
    assert inv["prop1"] and inv["tube"]
    par = device_checks._against_oracle(run, oracle, X0, refs)
    assert par["theta_equal"] and par["traj_max_abs_err"] == 0.0
    t = int(np.nonzero(oracle["Theta"][1:])[0][0]) + 1
    step = 2.0 * Z.b.max() / np.abs(Z.A).max()          # outside Z
    slipped = dict(run, x_hat=run["x_hat"].copy(), x_nom=run["x_nom"].copy(),
                   Theta=run["Theta"].copy())
    slipped["x_hat"][0, t, 0] += step
    slipped["x_nom"][0, t, 0] += step
    slipped["Theta"][0, -1] = 1 - slipped["Theta"][0, -1]
    inv = device_checks._invariant_margins(Z, X0, slipped)
    assert not inv["prop1"] and not inv["tube"]
    assert inv["prop1_worst"] > device_checks.INVARIANT_TOL
    assert not device_checks._against_oracle(slipped, oracle, X0,
                                             refs)["theta_equal"]


def _cut(make, T_cut):
    def cut():
        setup, (x0, *series) = make()
        return setup, (x0, *(a[:T_cut] for a in series))
    return cut


def test_gate_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(device_checks.SETUPS, "extended",
                        _cut(device_checks.extended_setup_and_inputs,
                             EXT_T_CPU))
    out = tmp_path / "device_checks.json"
    res = device_checks.run("cpu", sections=("flagship", "extended"),
                            out_json=str(out))
    failed = [c["name"] for c in res["checks"] if not c["ok"]]
    assert res["pass"] and not failed, failed
    saved = json.loads(out.read_text())
    for key in ("device", "power_limit", "rollout_traj_max_abs_err",
                "rollout_u_max_abs_err", "batched_rollout_traj_max_abs_err",
                "extended_hybrid_traj_max_abs_err",
                "extended_hybrid_u_max_abs_err",
                "extended_riccati_traj_max_abs_err",
                "extended_admm_traj_max_abs_err", "flagship", "extended",
                "checks", "pass", "seconds"):
        assert key in saved, key
    assert saved["device"] == "cpu" and saved["power_limit"] is None
    assert set(saved["flagship"]) == {"1", "64", "65"}
    # the flagship at each batch: Proposition 1 over its consistent steps,
    # K1's plain version as close to the oracle as the card's bar asks
    for r in saved["flagship"].values():
        assert r["prop1"] and r["tube"] and r["prop1_steps"] > 3
        assert r["traj_max_abs_err"] < device_checks.FLAGSHIP_DX
    names = [c["name"] for c in res["checks"]]
    assert sum("Proposition 1" in n for n in names) == 3
    assert sum("tube membership" in n for n in names) == 5
