"""The port runs without JAX and without the JAX package ``rtmpc_tpu``, and
its kernel build fails loudly without nvcc.

The run-time checks run in a fresh interpreter (a subprocess), so nothing
this test process imported (JAX included, via ``conftest.py``) leaks in;
there every import of ``jax`` or of ``rtmpc_tpu`` raises.  A third check
reads the port's sources for such imports.
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
