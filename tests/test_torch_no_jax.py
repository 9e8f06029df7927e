"""The port runs without JAX and without the JAX package ``rtmpc_tpu``, and
its kernel build fails loudly without nvcc.

The run-time checks (every app and module of the port, down to the
condensed QP, Fig. 3d's timer, the hybrid interior point and the ADMM's
early exit; and the data-parallel path and the
entry points in a one-rank gloo group) run in a fresh interpreter (a
subprocess), so nothing this test process imported (JAX included, via
``conftest.py``) leaks in; there every import of ``jax`` or of
``rtmpc_tpu`` raises.  A third check reads the port's sources for such
imports.
"""

import ast

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name in ("jax", "rtmpc_tpu")
                    or name.startswith(("jax.", "jaxlib", "rtmpc_tpu."))):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, NoJax())
""")

_ROLLOUT = _BLOCK_JAX + textwrap.dedent("""
    import torch
    from rtmpc_tpu_torch.models import flagship_setup
    from rtmpc_tpu_torch.parallel import make_batched_rollout
    from rtmpc_tpu_torch.protocol import draw_disturbances, draw_loss_masks

    setup = flagship_setup()
    for solver in ("admm", "cuda"):
        arrays, cfg = setup.to_device(torch.float64, "cpu", iters=60,
                                      iters2=60, alpha=1.8, rho2_scale=0.2,
                                      solver=solver)
        g = torch.Generator().manual_seed(0)
        theta, gamma = draw_loss_masks(g, 3, 0.7, 0.7, (2,))
        w = draw_disturbances(g, 3, [-0.1, -0.1], [0.1, 0.1], (2,))
        refs = torch.zeros(2, 3, 2, dtype=torch.float64)
        refs[..., 0] = 4.0
        x0 = torch.zeros(2, 2, dtype=torch.float64)
        carry, outs = make_batched_rollout(arrays, cfg, 3)(
            x0, refs, w, theta, gamma)
        assert outs.x.shape == (2, 3, 2)
        assert bool(carry.feasible.all()) and bool(torch.isfinite(outs.x).all())

    # the Fig. 3a slice: interior point, certificates, sweep, app
    import numpy as np
    from rtmpc_tpu_torch.apps import results_linear  # noqa: F401
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    from rtmpc_tpu_torch.models import setup_tracking
    from rtmpc_tpu_torch.ops import (infeasibility_certificates,  # noqa: F401
                                     ip_riccati_solve)
    from rtmpc_tpu_torch.parallel import run_mc_sweep  # noqa: F401
    from rtmpc_tpu_torch.utils import box
    st = setup_tracking([[1.0, 1.0], [0.0, 1.0]], [[0.0], [1.0]], np.eye(2),
                        [[0.1]], 5, box(np.array([8.0, 8.0])),
                        box(np.array([1.0])))
    arrays, cfg = st.to_device(torch.float64, "cpu", solver="ip_riccati")
    sol = ip_riccati_solve(arrays.ric, torch.tensor([[1.0, 0.0, 3.0, 0.0]]),
                           cfg.N)
    assert float(sol.r_prim) < 1e-9
    assert cartpole_scenario().N == 20

    # the extended arm and the nonlinear plant, with their two apps
    from rtmpc_tpu_torch.apps import (results_linear_extended,  # noqa: F401
                                      results_nonlinear)
    from rtmpc_tpu_torch.models import setup_extended_tube_tracking
    from rtmpc_tpu_torch.models.plants import CartpoleParams, cartpole_zoh_step
    ext = setup_extended_tube_tracking(
        [[1.0, 1.0], [0.0, 1.0]], [[0.0], [1.0]], np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])))
    for kw in (dict(solver="cuda", iters=20, iters2=20),
               dict(solver="ip_riccati")):
        arrays, cfg = ext.to_device(torch.float64, "cpu", **kw)
        assert cfg.extended
        carry, outs = make_batched_rollout(arrays, cfg, 3)(
            x0, refs, w, theta, gamma)
        assert bool(carry.feasible.all()) and bool(torch.isfinite(outs.x).all())
    plant = results_nonlinear.build_nonlinear_plant_step(cartpole_scenario())
    x4 = plant(torch.zeros(2, 4, dtype=torch.float64),
               torch.ones(2, 1, dtype=torch.float64), None)
    assert x4.shape == (2, 4) and float(x4[0, 1]) > 0
    assert torch.equal(x4, cartpole_zoh_step(
        CartpoleParams(), torch.zeros(2, 4, dtype=torch.float64),
        torch.ones(2, dtype=torch.float64), 0.02, 10))
    # the single-instance controllers: the session, the latency timers, the
    # serve app, the six examples, the dense interior point and the polish
    from rtmpc_tpu_torch.apps import serve_controller  # noqa: F401
    from rtmpc_tpu_torch.apps import (example_regulator,  # noqa: F401
                                      example_tracking, example_tracking_lossy,
                                      example_tube_regulator,
                                      example_tube_tracking,
                                      example_tube_tracking_lossy)
    from rtmpc_tpu_torch.ops.ip import ip_solve  # noqa: F401
    from rtmpc_tpu_torch.parallel.latency import latency_report  # noqa: F401
    from rtmpc_tpu_torch.parallel.session import Session
    assert example_regulator.main(["--device", "cpu"]) == 0
    assert example_tube_tracking_lossy.main(["--device", "cpu", "--quick",
                                             "--solver", "admm"]) == 0
    arrays, cfg = setup.to_device(torch.float64, "cpu", iters=20, iters2=20,
                                  solver="admm", polish=True)
    ses = Session(arrays, cfg, 3, [0.0, 0.0])
    o = ses.advance(refs[0], w[0].double(), theta[0], gamma[0])
    assert o.x.shape == (1, 3, 2) and bool(ses.carry.feasible.all())
    # the rest of the figures and apps, Fig. 3d's one-tick timer on the
    # structured interior point, and the condensed QP with its oracle
    from rtmpc_tpu_torch.apps import (create_animations,  # noqa: F401
                                      estimate_w, set_operations)
    from rtmpc_tpu_torch.parallel.latency import measure_step_latencies
    assert estimate_w.main(["--device", "cpu", "--quick"]) == 0
    assert set_operations.main(["--demo", "ops", "--no-figures"]) == 0
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver="ip_riccati")
    times = measure_step_latencies(arrays, cfg, refs[0], w[0], theta[0],
                                   gamma[0], x0=[0.5, 0.0],
                                   actuator_mode="smart")
    assert times.shape == (3,)
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver="ip",
                                  condensed=True)
    carry, outs = make_batched_rollout(arrays, cfg, 3)(
        x0, refs, w, theta, gamma)
    assert cfg.n_red == 15 and bool(carry.feasible.all())
    sol, _ = setup.template.solve_dense([0.5, 0.0], [4.0, 0.0])
    assert sol.status == "optimal"
    # the hybrid interior point (float32 engine, float64 spec) and the
    # ADMM's early exit
    for kw in (dict(solver="ip_hybrid"),
               dict(solver="admm", iters=20, iters2=20, early_tol=1e-3)):
        arrays, cfg = setup.to_device(torch.float32, "cpu", **kw)
        carry, outs = make_batched_rollout(arrays, cfg, 3)(
            x0, refs, w, theta, gamma)
        assert bool(carry.feasible.all()) and bool(torch.isfinite(outs.x).all())
    for blocked in ("jax", "rtmpc_tpu", "rtmpc_tpu.utils"):
        try:
            __import__(blocked)
        except ImportError:
            pass
        else:
            raise SystemExit("the import of %s was not blocked" % blocked)
    assert not [m for m in sys.modules
                if m in ("jax", "rtmpc_tpu")
                or m.startswith(("jax.", "rtmpc_tpu."))]
    print("OK")
""")

_BUILD = _BLOCK_JAX + textwrap.dedent("""
    import tempfile
    from rtmpc_tpu_torch.ops import qp_cuda

    qp_cuda._CUDA_HOME_DEFAULT = "/nonexistent-cuda-toolkit"
    qp_cuda._BUILD_DIR = tempfile.mkdtemp()
    try:
        qp_cuda.build_kernel()
    except RuntimeError as e:
        assert "nvcc not found" in str(e), e
        print("OK")
    else:
        raise SystemExit("the build without nvcc did not raise")
""")


_ONE_RANK = _BLOCK_JAX + textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from rtmpc_tpu_torch.entry import entry
    from rtmpc_tpu_torch.models import flagship_setup
    from rtmpc_tpu_torch.parallel import draw_sweep, run_mc_sweep
    from rtmpc_tpu_torch.parallel.distributed import (
        dp_group, gather_rows, initialize_from_env, shard_rows)
    from rtmpc_tpu_torch.parallel.ranks import spawn_ranks  # noqa: F401

    store = "file://" + os.path.join(os.getcwd(), "store")
    assert initialize_from_env("gloo", store, world_size=1, rank=0)
    assert initialize_from_env() and dp_group() is None
    assert shard_rows(5) == slice(0, 5)
    t = torch.arange(10.0).reshape(5, 2)
    assert torch.equal(gather_rows(t, 5), t)
    arrays, cfg = flagship_setup().to_device(
        torch.float64, "cpu", iters=20, iters2=20, solver="admm")
    refs = np.zeros((3, 2))
    refs[:, 0] = 4.0
    kw = dict(T=3, n_mc=2, loss_probs=[0.5], refs=refs, x0=np.zeros(2),
              w_lo=-0.1 * np.ones(2), w_hi=0.1 * np.ones(2),
              draws=draw_sweep(torch.Generator().manual_seed(0), 3, 2,
                               [0.5], 2))
    one = run_mc_sweep(arrays, cfg, **kw)
    ranked = run_mc_sweep(arrays, cfg, group=dist.group.WORLD, **kw)
    assert np.array_equal(one.traj, ranked.traj)
    assert bool(entry("cpu")[0](*entry("cpu")[1])[0].feasible.all())
    dist.destroy_process_group()
    assert not [m for m in sys.modules
                if m in ("jax", "rtmpc_tpu")
                or m.startswith(("jax.", "rtmpc_tpu."))]
    print("OK")
""")


def _run(code, env, tmp_path):
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def test_port_runs_with_jax_blocked(tmp_path):
    _run(_ROLLOUT, _env(), tmp_path)


def test_one_gloo_rank_with_jax_blocked(tmp_path):
    """The data-parallel path (``distributed.py``, ``ranks.py``, the
    sharded sweep) and ``entry.py`` in a one-rank gloo group."""
    _run(_ONE_RANK, _env(), tmp_path)


def test_kernel_build_without_nvcc_raises(tmp_path):
    empty = tmp_path / "empty_bin"
    empty.mkdir()
    _run(_BUILD, _env(PATH=str(empty)), tmp_path)


def _imported_modules(path):
    """Module names a source file imports (absolute imports only), read
    from its syntax tree, so docstrings and comments do not count."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_sources_import_nothing_of_the_jax_package():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "rtmpc_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p)
           if m.split(".")[0] in ("rtmpc_tpu", "jax", "jaxlib")]
    assert not bad, bad
