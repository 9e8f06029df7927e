"""The benchmark of ``rtmpc_tpu_torch``: one cell, one run.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything
that belongs to it is found by name:

* ``benchmark/configs/<config>.json``: the deployment (plant, controller,
  the solver it runs and the lower-precision control of its check);
* ``benchmark/traffic/<traffic>.json``: the traffic mix, whose ``kind``
  names its generator ``benchmark/traffic/<kind>.py``;
* ``benchmark/workloads/<cell>.json``: which quantity of the generator each
  end-to-end metric is, the sample the check compares, the traced part of
  the window, the limits of the check and, where the configuration's
  control does not reach the cell's path, the cell's own ``control``;
* ``benchmark/metrics/<metric>.py``: one reader a per-layer metric.

A run sets the program up from the configuration, hands the generator the
program and the seed, and gets back the window's quantities, the answers
it produced and, in a traced run, the profiler's record.  Once the window
has closed and the device's peak memory is read, the program's state is
dropped and the plain reference (``benchmark/reference/``) judges the
answers (``check.py``).  The program is imported only inside functions, so
that a checkout without it fails at the first run and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Optional

from . import check, trace

__all__ = ["ROOT", "BLOCKED", "Cell", "Ctx", "Window", "resolve",
           "program_setup", "run", "blocked_modules"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that no run may load
BLOCKED = ("jax", "jaxlib", "flax", "rtmpc_tpu")


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list          # the manifest's entries this cell reports
    per_layer: list
    root: str

    def generator(self):
        """The traffic kind's generator module."""
        kind = self.traffic["kind"]
        return _module(os.path.join(self.root, "benchmark", "traffic",
                                    f"{kind}.py"), f"_bench_traffic_{kind}")

    def reader(self, metric: str):
        """The per-layer metric's reader, ``read(data) -> value | None``."""
        return _module(os.path.join(self.root, "benchmark", "metrics",
                                    f"{metric}.py"),
                       "_bench_metric_" + metric.replace(".", "_")).read


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    man = _json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in man["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no single workload named {name!r} in "
                       "BENCHMARK.json")
    w = entries[0]
    bench = os.path.join(root, "benchmark")
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(os.path.join(bench, "configs",
                                          f"{w['config']}.json")),
                traffic=_json(os.path.join(bench, "traffic",
                                           f"{w['traffic']}.json")),
                workload=_json(os.path.join(bench, "workloads",
                                            f"{name}.json")),
                end_to_end=e2e, per_layer=per_layer, root=root)


def program_setup(config: dict, device, solver: Optional[dict] = None):
    """``(arrays, cfg)``: the program's controller of ``config``, set up on
    the host and frozen on ``device`` for the configuration's solver, or
    for ``solver`` (a control's) where given."""
    import numpy as np
    import torch
    from rtmpc_tpu_torch.models import setup_tube_tracking
    from rtmpc_tpu_torch.utils import box
    p, c = config["plant"], config["controller"]
    setup = setup_tube_tracking(
        np.array(p["A"]), np.array(p["B"]), np.array(c["Q"]),
        np.array(c["R"]), c["N"], box(np.array(p["x_box"])),
        box(np.array(p["u_box"])), box(np.array(p["w_box"])),
        fixed_initial_state=c["fixed_initial_state"],
        rpi_method=c["rpi_method"], eps_var=c["eps"],
        lambda_param=c["lambda"])
    solver = solver or config["solver"]
    # the program switches TF32 off when it is imported; a control that
    # runs in TF32 switches it on after that
    torch.backends.cuda.matmul.allow_tf32 = bool(solver.get("tf32", False))
    return setup.to_device(getattr(torch, solver["dtype"]), device,
                           solver=solver["name"], **solver["options"])


@dataclasses.dataclass
class Ctx:
    """What a traffic generator gets."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    arrays: object
    cfg: object
    t_process: float          # host clock at the process's start

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A named span in the traced run's profile (nothing otherwise)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(trace.SPAN_PREFIX + name)


@dataclasses.dataclass
class Window:
    """What a traffic generator returns."""
    quantities: dict          # the window's end-to-end quantities
    answers: list             # check.Answer, the ones to compare
    attempted: int
    failed: int
    counters: dict            # the program's counters over the window
    spans: dict               # the harness's own timings
    profiled: Optional[trace.Profiled] = None
    steps_profiled: int = 0


def seed64(seed: int) -> int:
    """A seed as the 64 bits that every generator here takes."""
    return int(seed) & (2 ** 64 - 1)


def blocked_modules() -> list:
    """The loaded modules whose top-level name is one of ``BLOCKED``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BLOCKED})


def _card(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    limit = None
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit_w": limit}


def run(name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", root: str = ROOT, control: bool = False,
        traffic: Optional[dict] = None, sample: Optional[dict] = None,
        t_process: Optional[float] = None) -> dict:
    """Run the cell once.  Returns the result line's keys (``checks``
    last), ``numbers`` (the check's numbers) and ``setup_parts_s``.  ``traffic`` replaces
    entries of the traffic mix and ``sample`` the check's sample (the
    tests' small sizes); ``control`` runs the cell's control
    solver (the configuration's, or the cell's own) in the program's
    place."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    cell = resolve(name, root)
    if traffic:
        cell.traffic = {**cell.traffic, **traffic}
    if sample:
        cell.workload = {**cell.workload, "sample": sample}
    t_begin = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    arrays, cfg = program_setup(
        cell.config, dev,
        cell.workload.get("control", cell.config["control"]) if control
        else None)
    host_setup_s = time.perf_counter() - t0
    ctx = Ctx(cell=cell, seed=seed64(seed), seconds=float(seconds),
              trace=traced, device=dev, arrays=arrays, cfg=cfg,
              t_process=t_process)
    shape = _shape(arrays, cfg, cell)
    win = cell.generator().run(ctx)
    win.spans["host_setup_s"] = host_setup_s
    # where set-up went: imports, the device's context, the program's host
    # set-up, the traffic's draws and warm-up
    win.spans["setup_parts_s"] = {
        "imports": t_begin - t_process, "device": t0 - t_begin,
        "host_setup": host_setup_s,
        "traffic": win.quantities["setup_s"] - (t0 - t_process)
        - host_setup_s}
    card = _card(dev)
    card["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)
    del ctx, arrays, cfg
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {"correct": False, "attempted": win.attempted,
           "failed": win.failed}
    if traced:
        reduced = (trace.reduce(win.profiled.device, win.profiled.host)
                   if win.profiled else trace.reduce([], []))
        data = {"trace": {**reduced,
                          "events": win.profiled.device if win.profiled
                          else [],
                          "host_spans": [h for h in win.profiled.host
                                         if h[0].startswith(
                                             trace.SPAN_PREFIX)]
                          if win.profiled else [],
                          "steps": win.steps_profiled},
                "counters": win.counters, "spans": win.spans,
                "shape": shape}
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        card["busy_s"] = reduced["busy_s"]
        card["window_s"] = reduced["window_s"]
        breakdown = {"device_ops": reduced["device_ops"],
                     "idle_gaps": reduced["idle_gaps"]}
    else:
        quantity = cell.workload["end_to_end"]
        metrics = {m["name"]: {"value": win.quantities[quantity[m["name"]]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    out["metrics"] = metrics
    out["device"] = card
    if breakdown is not None:
        out["breakdown"] = breakdown
    numbers = (check.compare(cell.config, win.answers) if win.answers
               else dict.fromkeys(check.NUMBERS, float("inf")))
    out["correct"], checks = check.judge(numbers, cell.workload["limits"])
    out["checks"] = checks
    out["numbers"] = numbers
    out["setup_parts_s"] = win.spans["setup_parts_s"]
    return out


def _shape(arrays, cfg, cell) -> dict:
    """The sizes the per-layer readers count work from: the batch, the
    padded columns K1 runs and the iterations of each of a step's ADMM
    phases (none under the interior points)."""
    admm = arrays.admm
    return {"batch": int(cell.traffic.get("batch", 1)),
            "n": None if admm is None else int(admm.Kinv.shape[0]),
            "m": None if admm is None else int(admm.As.shape[0]),
            "ntheta": 2 * int(cfg.nx),
            "phase_iters": ([cfg.iters, cfg.iters2] if cfg.iters2
                            else [cfg.iters])}
