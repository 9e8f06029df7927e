"""The port's entry points (``rtmpc_tpu_torch/entry.py``) against
``__graft_entry__.py``, on the CPU in float64.

* ``entry(device="cpu", dtype=torch.float64)``: outputs ``(16, 8, 2)``,
  every rollout feasible, trajectories within 1e-9 of the JAX package's
  flagship (``__graft_entry__._flagship("float64")``) through its
  ``make_batched_rollout`` on the same inputs.
* ``dryrun_multichip(2, device="cpu")`` on the JAX dry run's draws
  (``PRNGKey(0)``, loss 0.5/0.5, 8 rollouts of T=6): its mean tracking
  error within 1e-9 of the JAX package's per-rollout RMS mean on those
  draws, every rollout feasible; a rank that fails makes the call raise.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from rtmpc_tpu_torch.entry import dryrun_multichip, entry


def test_entry_matches_graft_entry():
    import jax
    from rtmpc_tpu.parallel import make_batched_rollout
    fn, args = entry(device="cpu", dtype=torch.float64)
    carry, outs = fn(*args)
    assert outs.x.shape == (16, 8, 2)
    assert bool(carry.feasible.all())

    _, arrays, cfg = ge._flagship("float64")
    ref_carry, ref = jax.jit(make_batched_rollout(arrays, cfg, 8))(
        *(a.numpy() for a in args))
    np.testing.assert_array_equal(np.asarray(ref_carry.feasible),
                                  carry.feasible.numpy())
    for name in ("x", "x_nom", "u"):
        np.testing.assert_allclose(getattr(outs, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-9, err_msg=name)


def _jax_dryrun_draws(n):
    """The draws of ``__graft_entry__.dryrun_multichip(n)``, in float64."""
    import jax
    from rtmpc_tpu.protocol import draw_disturbances, draw_loss_masks
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    theta, gamma = draw_loss_masks(k1, 6, 0.5, 0.5, batch_shape=(4 * n,))
    w = draw_disturbances(k2, 6, -0.1 * np.ones(2), 0.1 * np.ones(2),
                          batch_shape=(4 * n,))
    return tuple(np.asarray(a) for a in (theta, gamma, w))


def test_dryrun_multichip_matches_graft_entry():
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.parallel import make_batched_rollout, tracking_error_rms
    draws = _jax_dryrun_draws(2)
    mean_err, frac = dryrun_multichip(2, device="cpu", draws=draws,
                                      dtype=torch.float64)
    assert frac == 1.0

    theta, gamma, w = draws
    _, arrays, cfg = ge._flagship("float64")
    x0 = jnp.zeros((8, 2))
    refs = jnp.zeros((8, 6, 2)).at[:, :, 0].set(4.0)
    carry, outs = jax.jit(make_batched_rollout(arrays, cfg, 6))(
        x0, refs, jnp.asarray(w), jnp.asarray(theta), jnp.asarray(gamma))
    assert bool(jnp.all(carry.feasible))
    want = float(jnp.mean(jax.vmap(tracking_error_rms)(x0, outs.x, refs)))
    assert abs(mean_err - want) <= 1e-9, (mean_err, want)


def test_dryrun_multichip_raises_on_bad_draws():
    theta, gamma, w = _jax_dryrun_draws(2)
    with pytest.raises(ValueError, match="expected 8"):
        dryrun_multichip(2, device="cpu", draws=(theta[:4], gamma[:4], w[:4]),
                         dtype=torch.float64)
