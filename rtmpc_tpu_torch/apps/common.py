"""Shared plumbing of the port's apps (counterpart of
``rtmpc_tpu/apps/common.py``)."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The JAX Results apps' ADMM schedule (``rtmpc_tpu/apps/common.py:103-129``
# at ``admm_iters=400``), without polish: 200 + 200 iterations.
ADMM_SCHEDULE = dict(iters=200, iters2=200, alpha=1.8, rho2_scale=0.2)
IP_ITERS = 30


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback to the CPU: pass --device cpu for that)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="engine dtype: default float64, float32 under "
                        "--solver cuda (the kernel's type)")
    p.add_argument("--solver", default="ip_riccati",
                   choices=["ip_riccati", "cuda", "admm"],
                   help="QP solver: 'ip_riccati' (structured interior "
                        "point, the accuracy mode), 'cuda' (the ADMM "
                        "kernel, 200+200 iterations), 'admm' (the same "
                        "ADMM in plain PyTorch)")
    p.add_argument("--quick", action="store_true",
                   help="shrink the workload for smoke runs")
    p.add_argument("--seed", type=int, default=0)
    return p


def resolve(args) -> torch.device:
    """Fill in the defaults that depend on other flags and check that the
    device exists; exits non-zero without a CUDA device for ``cuda``."""
    if args.dtype is None:
        args.dtype = "float32" if args.solver == "cuda" else "float64"
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: no CUDA device is available")
    if dev.type == "cuda" and args.solver == "cuda" \
            and args.dtype != "float32":
        sys.exit("--solver cuda on a CUDA device runs in float32 only")
    return dev


def solver_kwargs(args) -> dict:
    """``to_device`` solver arguments for the parsed flags."""
    if args.solver == "ip_riccati":
        return dict(solver="ip_riccati", ip_iters=IP_ITERS)
    return dict(solver=args.solver, **ADMM_SCHEDULE)


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def check(name: str, ok: bool, detail: str = "") -> bool:
    print(f"[{'PASS' if ok else 'FAIL'}] {name}" +
          (f" - {detail}" if detail else ""))
    return bool(ok)


def save_summary_json(path, payload: dict):
    """Record the app's rows machine-readably (for
    ``tools/release_gate.py:compare_linear``)."""
    if not path:
        return None

    def _default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return str(o)

    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=_default)
    print(f"[json] {path}")
    return path


def load_compare_linear():
    """``compare_linear`` of ``tools/release_gate.py``, loaded by path (the
    module imports no JAX)."""
    path = os.path.join(REPO_ROOT, "tools", "release_gate.py")
    spec = importlib.util.spec_from_file_location("_release_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compare_linear
