"""The data-driven disturbance box of the cartpole (``apps/estimate_w``)
against the JAX package's, in float64 on the CPU.

The initial states are the JAX app's own draws (``jax.random.uniform`` at
``PRNGKey(seed)``, its call); the port's rollouts of the nonlinear plant
from them give the JAX app's box to 1e-10 and its residuals to 1e-12, at
20 rollouts of 60 steps (the JAX app's ``--quick`` size).  The app's
``main`` passes its two checks on the CPU.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps import estimate_w as jax_estimate_w
from rtmpc_tpu.apps.scenarios import cartpole_scenario as jax_scenario

from rtmpc_tpu_torch.apps import estimate_w
from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario

N_ROLLOUTS, T = 20, 60


def _jax_x0s(seed):
    """``rtmpc_tpu/apps/estimate_w.py:46-49``: the initial states it
    draws."""
    scale = jnp.asarray(estimate_w.X0_SCALE, jnp.float64)
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                         (N_ROLLOUTS, 4), jnp.float64,
                                         -1.0, 1.0) * scale)


@pytest.mark.parametrize("seed", [0, 3])
def test_box_matches_jax_on_the_same_initial_states(seed):
    want_box, want_ws = jax_estimate_w.estimate_w_box(
        jax, jnp, jax_scenario(), n_rollouts=N_ROLLOUTS, T=T, seed=seed)
    got_box, got_ws = estimate_w.estimate_w_box(
        cartpole_scenario(), torch.tensor(_jax_x0s(seed)), T)
    np.testing.assert_allclose(got_ws, np.asarray(want_ws), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got_box, want_box, rtol=0, atol=1e-10)


def test_app_checks_pass_on_the_cpu():
    out = estimate_w.run(estimate_w.parse_args(["--device", "cpu",
                                                "--quick"]))
    assert out["ok"] and out["ws"].shape == (N_ROLLOUTS * T, 4)
    assert int(np.argmax(out["w_box"])) == 3
    # the port's own draws lie in the JAX app's box of initial states
    x0s = estimate_w.draw_initial_states(100, 0).numpy()
    assert (np.abs(x0s) <= estimate_w.X0_SCALE).all()
