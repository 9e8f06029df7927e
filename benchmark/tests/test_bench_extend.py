"""A later change adds a cell, a traffic mix and a per-layer metric as new
files and one more entry of each list in ``BENCHMARK.json``: the harness
finds them by name, and no file it had is edited."""

import hashlib
import json
import os
import shutil

from benchmark import harness


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_and_metric_are_found_without_edits(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)

    bench = os.path.join(root, "benchmark")
    mix = json.load(open(os.path.join(bench, "traffic",
                                      "mc-b16384-loss70.json")))
    mix["batch"] = 1024
    json.dump(mix, open(os.path.join(bench, "traffic",
                                     "mc-b1024-loss70.json"), "w"))
    shutil.copy(os.path.join(bench, "workloads", "di-mc-b16384.json"),
                os.path.join(bench, "workloads", "di-mc-b1024.json"))
    with open(os.path.join(bench, "metrics", "launches_per_step.py"),
              "w") as f:
        f.write("def read(data):\n"
                "    t = data['trace']\n"
                "    return len(t['events']) / t['steps'] if t['steps'] "
                "else None\n")
    man_path = os.path.join(root, "BENCHMARK.json")
    man = json.load(open(man_path))
    man["workloads"].append({"name": "di-mc-b1024", "config": "flagship-di",
                             "traffic": "mc-b1024-loss70", "chips": 1,
                             "why": "a small batch"})
    man["end_to_end"][0]["workloads"].append("di-mc-b1024")
    man["per_layer"].append({"name": "launches_per_step", "unit": "ops",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "sweep_steps_per_s",
                             "workloads": ["di-mc-b1024"]})
    json.dump(man, open(man_path, "w"))

    cell = harness.resolve("di-mc-b1024", root)
    assert cell.traffic["batch"] == 1024
    assert [m["name"] for m in cell.per_layer] == ["launches_per_step"]
    read = cell.reader("launches_per_step")
    assert read({"trace": {"events": [("k", 0, 1)] * 6, "steps": 3}}) == 2
    assert {m["name"] for m in cell.end_to_end} == {"sweep_steps_per_s",
                                                     "setup_s"}
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
