"""The port's data-parallel path (``rtmpc_tpu_torch/parallel/distributed.py``,
``parallel/ranks.py`` and ``run_mc_sweep(group=...)``) on the CPU, over
gloo, against the JAX package.

* ``initialize_from_env``: one process with nothing to coordinate is a
  no-op, several without a coordinator raise (as
  ``tests/test_distributed.py`` holds the JAX launcher).
* ``shard_rows`` / ``gather_rows`` over 3 ranks: 16 rows split 6/6/4, 2
  rows leave a rank empty, the gathered tensor is the input, each row once.
* A two-rank sweep in the configuration of
  ``tests/test_distributed_two_process.py`` (the flagship in float64, ADMM
  60+60, T=30, 4 runs at p = 0.0 and 0.5, the masks and uniforms of
  ``jax.random.PRNGKey(3)``): both ranks' results equal bit for bit, and
  equal to the JAX package's one-process ``run_mc_sweep`` within 1e-10
  (its own bar between layouts, ``tests/test_sharding_determinism.py``),
  feasibility equal; each row gathered once, one gather a chunk.
* An uneven split (9 rows over 2 ranks) equal to the port's one-process
  sweep within 1e-10.
* A checkpointed sweep (2 chunks): rank 0 alone writes, one file, and a
  second run resumes past both chunks with the same arrays.

The ranks are spawned processes (``spawn_ranks``: one torch thread each, a
``file://`` store under the test's directory, a 180 s deadline); the rank
functions below are module-level so that they can be sent to them.
"""

import os

import numpy as np
import pytest
import torch

from rtmpc_tpu_torch.models import flagship_setup
from rtmpc_tpu_torch.parallel.distributed import (dp_group, gather_rows,
                                                  initialize_from_env,
                                                  is_distributed, shard_rows)
from rtmpc_tpu_torch.parallel.mc import SweepDraws, run_mc_sweep
from rtmpc_tpu_torch.parallel.ranks import spawn_ranks, sweep_rank

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
T = 30
REFS = np.zeros((T, 2))
REFS[:, 0] = 4.0
SWEEP = dict(T=T, refs=REFS, x0=np.zeros(2), w_lo=-0.1 * np.ones(2),
             w_hi=0.1 * np.ones(2))
TIMEOUT_S = 180.0


def _clear_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_single_process_is_noop(monkeypatch):
    _clear_env(monkeypatch)
    assert initialize_from_env() is False
    assert not is_distributed()
    assert dp_group() is None
    assert initialize_from_env(world_size=1) is False


def test_initialize_multi_process_without_coordinator_raises(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_from_env()


def _shard_gather_rank(ns):
    """Rank function: for each n, this rank's slice and the gather of rows
    that carry their own global index."""
    out = []
    for n in ns:
        rows = shard_rows(n)
        mine = torch.arange(rows.start, rows.stop, dtype=torch.float64)
        mine = torch.stack([mine, -mine], dim=1)
        calls = gather_rows.calls
        full = gather_rows(mine, n)
        out.append((rows.start, rows.stop, full, gather_rows.calls - calls))
    return out


def test_shard_and_gather_over_three_ranks(tmp_path):
    ns = (16, 2)
    got = spawn_ranks(_shard_gather_rank, 3, (ns,), timeout=TIMEOUT_S,
                      workdir=str(tmp_path))
    for i, n in enumerate(ns):
        sizes = [stop - start for start, stop, _, _ in
                 (rank[i] for rank in got)]
        assert sizes == {16: [6, 6, 4], 2: [1, 1, 0]}[n]
        want = torch.arange(n, dtype=torch.float64)
        want = torch.stack([want, -want], dim=1)
        for rank in got:
            _, _, full, calls = rank[i]
            assert calls == 1
            assert torch.equal(full, want)      # each row once, in order


def _jax_draws(seed, probs, n_mc, T, nx=2):
    """The masks and float32 uniforms the JAX package's ``run_mc_sweep``
    draws from ``PRNGKey(seed)`` (``rtmpc_tpu/parallel/mc.py:93-98``)."""
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.protocol.network import draw_loss_masks
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    batch = len(probs) * n_mc
    p_flat = jnp.asarray(np.repeat(np.asarray(probs, np.float64), n_mc))
    theta, gamma = draw_loss_masks(k1, T, p_flat, p_flat,
                                   batch_shape=(batch,))
    u = jax.random.uniform(k2, (batch, T, nx), jnp.float32)
    return SweepDraws(*(torch.from_numpy(np.asarray(a).astype(dt)) for a, dt
                        in ((theta, np.uint8), (gamma, np.uint8),
                            (u, np.float32))))


def _counting_sweep_rank(jobs, ckpt):
    """Rank function: ``sweep_rank`` on the jobs, each sweep's gathers (calls
    and rows), then a checkpointed sweep run twice, with the checkpoint
    writes this rank made."""
    from rtmpc_tpu_torch.parallel import mc
    out = []
    for job in jobs:
        calls, rows = gather_rows.calls, gather_rows.rows
        res = sweep_rank([job], "cpu")[0]["result"]
        out.append((res, gather_rows.calls - calls, gather_rows.rows - rows))
    writes = []
    savez = mc.np.savez

    def counting_savez(*a, **k):
        writes.append(a[0])
        return savez(*a, **k)

    mc.np.savez = counting_savez
    try:
        setup, to_dev, sweep = ckpt
        for _ in range(2):
            calls = gather_rows.calls
            res = sweep_rank([(setup, to_dev, sweep)], "cpu")[0]["result"]
            out.append((res, gather_rows.calls - calls, len(writes)))
    finally:
        mc.np.savez = savez
    return out


@pytest.fixture(scope="module")
def flagship():
    return flagship_setup()


@pytest.fixture(scope="module")
def two_rank_runs(flagship, tmp_path_factory):
    """One spawn of 2 ranks for the sweeps below: the JAX configuration,
    the uneven split, and the checkpointed sweep run twice."""
    tmp = tmp_path_factory.mktemp("dp_sweeps")
    to_dev = dict(dtype=torch.float64, solver="admm", **KW)
    jax_cfg = dict(SWEEP, n_mc=4, loss_probs=[0.0, 0.5],
                   draws=_jax_draws(3, [0.0, 0.5], 4, T))
    uneven = dict(SWEEP, n_mc=3, loss_probs=[0.0, 0.5, 0.9],
                  draws=_jax_draws(5, [0.0, 0.5, 0.9], 3, T))
    ckpt_path = str(tmp / "sweep.npz")
    ckpt = dict(uneven, n_chunks=2, checkpoint_path=ckpt_path)
    runs = spawn_ranks(
        _counting_sweep_rank, 2,
        ([(flagship, to_dev, jax_cfg), (flagship, to_dev, uneven)],
         (flagship, to_dev, ckpt)),
        timeout=TIMEOUT_S, workdir=str(tmp))
    arrays, cfg = flagship.to_device(torch.float64, "cpu", solver="admm",
                                     **KW)
    one = run_mc_sweep(arrays, cfg, **uneven)
    return dict(runs=runs, one=one, jax_cfg=jax_cfg, tmp=tmp,
                ckpt_path=ckpt_path)


FIELDS = ("tracking_error", "feasible", "infeasible_counts", "sample_traj",
          "sample_x_nom", "traj", "x_nom")


def _assert_bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_two_rank_sweep_equals_jax_package(two_rank_runs):
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.models.specs import setup_tube_tracking
    from rtmpc_tpu.parallel.mc import run_mc_sweep as jax_run_mc_sweep
    from rtmpc_tpu.utils import box

    (r0, calls0, rows0), (r1, calls1, rows1) = (
        rank[0] for rank in two_rank_runs["runs"])
    _assert_bitwise(r0, r1)
    # gathered once: one gather for the single chunk, each of the 8 rows once
    assert (calls0, rows0) == (calls1, rows1) == (1, 8)

    setup = setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10, box(np.array([8.0, 8.0])),
        box(np.array([1.0])), box(np.array([0.1, 0.1])),
        fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype=jnp.float64, **KW)
    ref = jax_run_mc_sweep(arrays, cfg, n_mc=4, loss_probs=[0.0, 0.5],
                           key=jax.random.PRNGKey(3), **SWEEP)
    np.testing.assert_array_equal(r0.feasible, ref.feasible)
    assert r0.feasible.all()
    for f in ("tracking_error", "sample_traj", "sample_x_nom"):
        np.testing.assert_allclose(getattr(r0, f), getattr(ref, f), rtol=0,
                                   atol=1e-10, err_msg=f)


def test_uneven_split_equals_one_process(two_rank_runs):
    (r0, calls0, rows0), (r1, _, _) = (rank[1] for rank in
                                       two_rank_runs["runs"])
    _assert_bitwise(r0, r1)
    assert (calls0, rows0) == (1, 9)     # 5 + 4 rows, each gathered once
    one = two_rank_runs["one"]
    np.testing.assert_array_equal(r0.feasible, one.feasible)
    np.testing.assert_array_equal(r0.infeasible_counts,
                                  one.infeasible_counts)
    for f in ("tracking_error", "traj", "x_nom"):
        np.testing.assert_allclose(getattr(r0, f), getattr(one, f), rtol=0,
                                   atol=1e-10, err_msg=f)


def test_checkpoint_written_by_rank0_and_resumed(two_rank_runs):
    (first0, calls0, writes0), (again0, recalls0, rewrites0) = \
        two_rank_runs["runs"][0][2:]
    (first1, calls1, writes1), (again1, recalls1, rewrites1) = \
        two_rank_runs["runs"][1][2:]
    # 2 chunks: rank 0 wrote after each, rank 1 never; the resumed run
    # gathered and wrote nothing
    assert (writes0, writes1) == (2, 0)
    assert (calls0, calls1) == (2, 2)
    assert (recalls0, recalls1, rewrites0, rewrites1) == (0, 0, 2, 0)
    files = sorted(os.listdir(two_rank_runs["tmp"]))
    assert [f for f in files if f.startswith("sweep")] == ["sweep.npz"]
    for res in (again0, first1, again1):
        _assert_bitwise(first0, res)
    one = two_rank_runs["one"]
    np.testing.assert_allclose(first0.tracking_error, one.tracking_error,
                               rtol=0, atol=1e-10)


def _failing_rank(bad_rank):
    import time
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        raise RuntimeError("rank %d fails on purpose" % bad_rank)
    time.sleep(120)         # the others would go on; they are stopped


def _sleeping_rank(seconds):
    import time
    time.sleep(seconds)


def test_spawn_ranks_raises_when_a_rank_fails(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises(Exception, match="fails on purpose"):
        spawn_ranks(_failing_rank, 2, (1,), timeout=TIMEOUT_S,
                    workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60      # rank 0 was stopped, not waited for


def test_spawn_ranks_raises_past_its_timeout(tmp_path):
    with pytest.raises(TimeoutError, match="not done within"):
        spawn_ranks(_sleeping_rank, 2, (120,), timeout=8.0,
                    workdir=str(tmp_path))
