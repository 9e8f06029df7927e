"""``BENCHMARK.json`` and the files it names: the contract's shapes, names
and units, and every cell resolving to its configuration, traffic generator,
check limits and metric readers by name."""

import json
import os
import re

import pytest

from benchmark import check, harness

MAN = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], key)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in MAN[group]}) == len(MAN[group])
    assert len({m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]}) \
        == len(MAN["end_to_end"]) + len(MAN["per_layer"])


def test_metric_entries():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(e2e) == {"sweep_steps_per_s", "f64_sweep_steps_per_s",
                        "tick_p99_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_configs():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.resolve(name)
    assert cell.chips == 1
    assert os.path.exists(os.path.join(harness.ROOT, "benchmark", "traffic",
                                       cell.traffic["kind"] + ".py"))
    assert callable(cell.generator().run)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(cell.workload["end_to_end"]) == set(e2e)
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert set(cell.workload["limits"]) == set(check.NUMBERS)
    assert cell.workload["limits"]["theta_diff"] == 0
    assert cell.workload["limits"]["feasible_diff"] == 0


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_reader_finds_nothing_in_an_empty_record(name):
    """A reader with nothing to read returns nothing, never a 0."""
    cell = harness.resolve(MAN["per_layer"][0]["workloads"][0])
    data = {"trace": {"events": [], "steps": 0, "busy_s": 0.0,
                      "window_s": 0.0},
            "counters": {}, "spans": {},
            "shape": {"batch": 1, "n": 40, "m": 112, "ntheta": 4,
                      "phase_iters": [60, 60]}}
    assert cell.reader(name)(data) is None
