"""The benchmark's arithmetic: the window's rate up to the end of its last
chunk, the quantiles, the frozen roofline, and the profile's reduction."""

import time

import numpy as np
import pytest

from benchmark import harness, measure, roofline, trace
from benchmark.tests.conftest import SMALL


def test_window_rate():
    assert measure.window_rate(1200, 10.0, 13.0) == 400.0
    with pytest.raises(ValueError):
        measure.window_rate(1, 2.0, 2.0)


def test_quantile():
    v = np.arange(1, 101, dtype=float)
    assert measure.quantile(v, 0.99) == np.quantile(v, 0.99) == 99.01
    assert measure.quantile(v, 0.5) == 50.5
    # the 0.99 quantile of 10,000 samples has 100 beyond it
    v = np.arange(10000, dtype=float)
    assert np.sum(v > measure.quantile(v, 0.99)) == 100


def test_roofline_ties_to_the_kernel_table():
    """The flagship row of the port's kernel table: 40 + 112 columns,
    B=16384, 60 iterations: 2.11e10 FLOP, 0.3150 ms, bound by the FP32
    operations."""
    flops = roofline.admm_phase_flops(16384, 40, 112, 60)
    assert flops == pytest.approx(2.11e10, rel=1e-3)
    assert roofline.admm_phase_ms(16384, 40, 112, 4, 60) == pytest.approx(
        0.3150, abs=5e-5)
    assert roofline.admm_phase_bytes(16384, 40, 112, 4) \
        / roofline.PEAK_BYTES_PER_S < flops / roofline.PEAK_FP32_FLOPS


def test_k1_roofline_reader():
    cell = harness.resolve("di-mc-b16384")
    read = cell.reader("k1_roofline")
    least = roofline.admm_phase_ms(16384, 40, 112, 4, 60)
    # two launches a step, each at twice its least time: 50%
    events = [("void admm_kernel<8>(...)", 0.0, 2e3 * least),
              ("void admm_kernel<8>(...)", 1e4, 1e4 + 2e3 * least),
              ("elementwise", 0.0, 5.0)]
    data = {"trace": {"events": events, "steps": 1},
            "shape": {"batch": 16384, "n": 40, "m": 112, "ntheta": 4,
                      "phase_iters": [60, 60]}}
    assert read(data) == pytest.approx(50.0)
    other = cell.reader("rollout_device_ms_per_step")
    assert other(data) == pytest.approx(0.005)


def test_tick_readers():
    """The tick's device time counts the device operations that began in a
    tick's span, overlaps once; its idle share is the profile's."""
    cell = harness.resolve("di-tick-b1")
    events = [("replay", 10.0, 40.0), ("k1", 20.0, 50.0),
              ("record copy", 70.0, 80.0), ("replay", 110.0, 130.0)]
    spans = [("harness.tick", 0.0, 60.0), ("harness.record", 60.0, 90.0),
             ("harness.tick", 100.0, 140.0)]
    data = {"trace": {"events": events, "host_spans": spans, "steps": 2,
                      "busy_s": 70e-6, "window_s": 140e-6}}
    # (40 + 20) us over two ticks
    assert cell.reader("tick_device_ms")(data) == pytest.approx(0.03)
    assert cell.reader("idle_share.tick")(data) == pytest.approx(50.0)


def test_trace_reduce():
    device = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("a", 30.0, 40.0)]
    host = [("harness.chunk", 0.0, 50.0), ("aten::mm", 21.0, 29.0)]
    r = trace.reduce(device, host)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == pytest.approx(50e-6)
    assert r["device_ops"][0] == ["a", pytest.approx(20e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["harness.chunk"] == pytest.approx(10e-6)


def test_sweep_rate_counts_the_whole_last_chunk(monkeypatch):
    """The window ends after the chunk in which ``--seconds`` pass, and its
    rate is the work of every chunk it ran over the time up to that
    chunk's end: a window of 0.1 s runs one chunk of 0.5 s or more, whole."""
    import rtmpc_tpu_torch.parallel.rollout as ro
    make = ro.make_batched_rollout

    def slow(*a, **k):
        fn = make(*a, **k)

        def run(*b, **c):
            time.sleep(0.5)
            return fn(*b, **c)
        return run
    monkeypatch.setattr(ro, "make_batched_rollout", slow)
    traffic = {**SMALL["di-mc-b16384"], "batch": 4, "steps": 4, "chunk": 4}
    res = harness.run("di-mc-b16384", 7, 0.1, False, device="cpu",
                      traffic=traffic, sample={"rows": 2})
    assert res["attempted"] == 16
    rate = res["metrics"]["sweep_steps_per_s"]["value"]
    assert 16 / 5.0 < rate <= 16 / 0.5
