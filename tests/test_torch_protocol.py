"""Batched protocol state machines of the port against the JAX package.

The actuator (consistent, consistent+extended and smart modes) and the
estimator (plain and robust) run step by step on random packets, masks
and plant states drawn with numpy; the JAX functions run under ``vmap``
on the same inputs.  Integers (Theta, s, q, t, last_drop) must be equal,
floats within 1e-12 (float64).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.protocol.actuator import actuator_step as jax_actuator_step
from rtmpc_tpu.protocol.actuator import init_actuator as jax_init_actuator
from rtmpc_tpu.protocol.estimator import (
    estimator_update as jax_estimator_update,
    init_estimator as jax_init_estimator,
    store_sequence as jax_store_sequence)

from rtmpc_tpu_torch.protocol import (actuator_step, draw_disturbances,
                                      draw_loss_masks, estimator_update,
                                      init_actuator, init_estimator,
                                      store_sequence)

B, T, N, NX, NU = 16, 30, 10, 2, 1
FLOAT_TOL = 1e-12


def _problem(seed):
    rng = np.random.default_rng(seed)
    mats = dict(A=np.array([[1.0, 1.0], [0.0, 1.0]]) + 0.1 * rng.normal(
        size=(NX, NX)), B=rng.normal(size=(NX, NU)),
        K_ss=rng.normal(size=(NU, NX)), K_plant=rng.normal(size=(NU, NX)))
    theta = (rng.uniform(size=(T, B)) >= 0.5).astype(np.int32)
    gamma = (rng.uniform(size=(T, B)) >= 0.5).astype(np.int32)
    theta[0] = gamma[0] = 1
    draws = dict(U=rng.normal(size=(T, B, N + 1, NU)),
                 x_nom0=rng.normal(size=(T, B, NX)),
                 x=rng.normal(size=(T, B, NX)),
                 # packet q: a recent ack time, so drops land on both sides
                 q=np.maximum(np.arange(T)[:, None]
                              - rng.integers(0, 4, size=(T, B)), 0
                              ).astype(np.int32))
    return mats, theta, gamma, draws, rng.normal(size=(B, NX))


def _t(a):
    a = np.asarray(a)
    return torch.tensor(a, dtype=torch.int32 if a.dtype.kind == "i"
                        else torch.float64)


def _assert_state_equal(got, want, t):
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=f"{f} at t={t}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL,
                                       err_msg=f"{f} at t={t}")


@pytest.mark.parametrize("mode,extended", [("consistent", False),
                                           ("consistent", True),
                                           ("smart", False)])
def test_actuator_matches_jax(mode, extended):
    mats, theta, _, draws, x0 = _problem(seed=0)
    jm = {k: jnp.asarray(v) for k, v in mats.items()}
    tm = {k: _t(v) for k, v in mats.items()}
    jstep = jax.jit(jax.vmap(functools.partial(
        jax_actuator_step, N=N, mode=mode, extended=extended),
        in_axes=(0, 0, 0, 0, 0, 0, None, None, None, None)))
    jst = jax.vmap(lambda x: jax_init_actuator(N, NX, NU, x, jnp.float64))(
        jnp.asarray(x0))
    tst = init_actuator(N, NU, _t(x0))
    _assert_state_equal(tst, jst, -1)
    accepted = 0
    for t in range(T):
        args = [draws["U"][t], draws["q"][t], draws["x_nom0"][t],
                draws["x"][t], theta[t]]
        ju, jpkt, jst, jaux = jstep(jst, *map(jnp.asarray, args), jm["A"],
                                    jm["B"], jm["K_ss"], jm["K_plant"])
        tu, tpkt, tst, taux = actuator_step(
            tst, *map(_t, args), tm["A"], tm["B"], tm["K_ss"], tm["K_plant"],
            N, mode=mode, extended=extended)
        _assert_state_equal(tst, jst, t)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                                   atol=FLOAT_TOL)
        for a, b in zip(tpkt, jpkt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=FLOAT_TOL)
        np.testing.assert_array_equal(taux["Theta"].numpy(),
                                      np.asarray(jaux["Theta"]))
        np.testing.assert_allclose(taux["u_nom"].numpy(),
                                   np.asarray(jaux["u_nom"]), rtol=0,
                                   atol=FLOAT_TOL)
        accepted += int(tst.Theta.sum())
    assert 0.1 * B * T < accepted < 0.9 * B * T   # both outcomes occurred


@pytest.mark.parametrize("robust", [False, True])
def test_estimator_matches_jax(robust):
    mats, _, gamma, draws, x0 = _problem(seed=1)
    A, Bm = mats["A"], mats["B"]
    jupd = jax.jit(jax.vmap(
        lambda s, pkt, g, U: jax_estimator_update(
            s, pkt, g, jnp.asarray(A), jnp.asarray(Bm), U, robust=robust)))
    jstore = jax.vmap(jax_store_sequence)
    jst = jax.vmap(lambda x: jax_init_estimator(T, N, NX, NU, x,
                                                jnp.float64))(jnp.asarray(x0))
    tst = init_estimator(_t(x0))
    _assert_state_equal(tst, jst, -1)
    rng = np.random.default_rng(2)
    for t in range(T):
        U, x_nom0 = draws["U"][t], draws["x_nom0"][t]
        pkt = (draws["x"][t], rng.normal(size=(B, NU)), draws["x_nom0"][t])
        jst = jupd(jstore(jst, jnp.asarray(U), jnp.asarray(x_nom0)),
                   tuple(map(jnp.asarray, pkt)), jnp.asarray(gamma[t]),
                   jnp.asarray(U))
        tst = estimator_update(store_sequence(tst, _t(U), _t(x_nom0)),
                               tuple(map(_t, pkt)), _t(gamma[t]), _t(A),
                               _t(Bm), _t(U), robust=robust)
        _assert_state_equal(tst, jst, t)
    assert tst.q.dtype == torch.int32 and int(tst.q.max()) > 0


def test_network_draws():
    g = torch.Generator().manual_seed(0)
    theta, gamma = draw_loss_masks(g, 200, 0.7, torch.tensor([0.1, 0.9]),
                                   (2,))
    w = draw_disturbances(g, 200, [-0.1, -0.2], [0.1, 0.2], (2,))
    assert theta.shape == gamma.shape == (2, 200)
    assert theta.dtype == gamma.dtype == torch.int32
    assert bool((theta[:, 0] == 1).all()) and bool((gamma[:, 0] == 1).all())
    # delivery rates of the per-row loss probabilities
    assert abs(theta[:, 1:].float().mean().item() - 0.3) < 0.06
    rates = gamma[:, 1:].float().mean(dim=1)
    assert rates[0] > 0.8 and rates[1] < 0.2
    assert w.shape == (2, 200, 2) and w.dtype == torch.float32
    assert bool((w.abs() <= torch.tensor([0.1, 0.2])).all())
    again = draw_loss_masks(torch.Generator().manual_seed(0), 200, 0.7,
                            torch.tensor([0.1, 0.9]), (2,))
    assert torch.equal(again[0], theta) and torch.equal(again[1], gamma)
