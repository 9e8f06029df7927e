"""The benchmark loads neither JAX nor the JAX package ``rtmpc_tpu``, the
names compared whole (``rtmpc_tpu_torch``, the program, begins with
``rtmpc_tpu`` and is allowed); the reference loads nothing of the program
either; and the command refuses to run without a card, or where the
program is not beside it, printing no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")

_RUN = textwrap.dedent("""
    import importlib.abc, json, sys

    class Blocked(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "rtmpc_tpu"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Blocked())
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(1)
    from benchmark import harness
    res = harness.run("di-tick-b1", 5, 1.5, False, device="cpu",
                      traffic={traffic!r}, sample={{"episodes": 1}})
    assert not harness.blocked_modules(), harness.blocked_modules()
    print(json.dumps({{"correct": res["correct"]}}))
""")


def test_harness_and_reference_run_with_jax_blocked():
    from benchmark.tests.conftest import SMALL
    code = _RUN.format(root=harness.ROOT, traffic=SMALL["di-tick-b1"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_blocked_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtmpc_tpu_torch_x", object())
    assert "rtmpc_tpu_torch_x" not in harness.blocked_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.blocked_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for base, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_sources_import_no_jax():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.BLOCKED, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("rtmpc_tpu_torch", "benchmark", "torch"), \
                (path, name)


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "di-tick-b1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_no_result():
    """A device metric that finds no card fails: no CPU fallback."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _cli(harness.ROOT, env)
    assert out.returncode != 0
    assert "needs 1 CUDA device" in out.stderr
    assert not out.stdout.strip()


def test_no_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = _cli(str(tmp_path))
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 3])
def test_large_seeds(seed):
    assert 0 <= harness.seed64(seed) < 2 ** 64
