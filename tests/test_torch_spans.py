"""The port's spans (``rtmpc_tpu_torch/utils/spans.py``) on the CPU.

* With no profiler attached ``span`` returns one shared null context
  (nothing allocated); under ``torch.profiler`` it records
  ``"rtmpc." + name``.
* A flagship rollout (solver "admm", B=4, T=2) records one
  ``rtmpc.solve`` and one ``rtmpc.protocol`` a step, in that order, the
  two side by side and not nested.
* The float64 structured interior point records one
  ``rtmpc.ip.iteration`` per iteration its counter counts, each holding
  one ``rtmpc.ip.factor``, two ``rtmpc.ip.newton`` (predictor, corrector)
  and, eagerly, one ``rtmpc.ip.exit_read`` (one more before the first
  iteration, none in an iteration that ends the budget, none without the
  early exit); its output is bit for bit the same with the profiler on
  and off.
* ``Session.advance`` on the CPU records ``rtmpc.session.copy_in`` (the
  replay span is the card's: the CPU has no graph).
* ``step_profile.span_breakdown`` credits each device operation to the
  innermost span that launched it, by the spans' copies on the device's
  timeline, not to the span the host was in when the operation ran
  (synthetic events), and counts a real CPU profile's spans.
* ``step_profile.span_quantities`` takes the exit reads inside the
  iterations, and only those, off the iterations' host time (synthetic
  events and a real CPU profile of the interior point).
"""

import contextlib
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rtmpc_tpu_torch.models import flagship_setup
from rtmpc_tpu_torch.ops.ip_riccati import ip_riccati_solve
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.parallel.session import Session
from rtmpc_tpu_torch.parallel.step_profile import (nested_host_ms,
                                                    span_breakdown,
                                                    span_quantities)
from rtmpc_tpu_torch.utils import spans
from rtmpc_tpu_torch.utils.spans import span

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
B, T = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (this CPU build of torch can deadlock in a
    batched LU factorization on several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return flagship_setup()


def _profiled(fn):
    """``(fn's result, the program's span events sorted by start)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e for e in prof.events()
                  if e.name.startswith(spans.PREFIX)),
                 key=lambda e: e.time_range.start)
    return out, evs


def _named(evs, name):
    return [e for e in evs if e.name == spans.PREFIX + name]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = span("solve")
    assert off is span("protocol") is spans._OFF
    assert isinstance(off, contextlib.nullcontext)
    with off, span("nested"):
        pass


def test_span_records_under_a_profiler():
    def work():
        with span("probe"):
            return torch.ones(3).sum()
    _, evs = _profiled(work)
    assert [e.name for e in evs] == ["rtmpc.probe"]
    assert span("probe") is spans._OFF


def _inputs(dtype):
    x0 = torch.zeros(B, 2, dtype=dtype)
    refs = torch.zeros(B, T, 2, dtype=dtype)
    refs[..., 0] = 5.0
    w = 0.05 * torch.ones(B, T, 2, dtype=dtype)
    flags = torch.ones(B, T, dtype=torch.int32)
    flags[1::2, 1] = 0
    return x0, refs, w, flags, flags.clone()


def test_rollout_records_solve_then_protocol_each_step(setup):
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver="admm", **KW)
    rollout = make_batched_rollout(arrays, cfg, T)
    _, evs = _profiled(lambda: rollout(*_inputs(torch.float64)))
    steps = [e for e in evs if e.name in ("rtmpc.solve", "rtmpc.protocol")]
    assert [e.name for e in steps] == ["rtmpc.solve", "rtmpc.protocol"] * T
    for a, b in zip(steps, steps[1:]):
        assert a.time_range.end <= b.time_range.start   # side by side
    assert not _named(evs, "k1")      # solver "admm" runs no kernel


@pytest.fixture(scope="module")
def ric(setup):
    arrays, cfg = setup.to_device(torch.float64, "cpu",
                                  solver="ip_riccati", ip_iters=30)
    theta = torch.tensor([[0.0, 0.0, 5.0, 0.0], [1.0, -1.0, -9.0, 0.0],
                          [3.0, 0.5, 4.0, 0.0], [-2.0, 1.0, 0.0, 0.0]],
                         dtype=torch.float64)
    return arrays.ric, theta, cfg.N


def _solve_counted(spec, theta, N, **kw):
    before = ip_riccati_solve.iterations
    out = _profiled(lambda: ip_riccati_solve(spec, theta, N, **kw))
    return out, ip_riccati_solve.iterations - before


def test_ip_records_one_iteration_span_per_counted_iteration(ric):
    spec, theta, N = ric
    (_, evs), its = _solve_counted(spec, theta, N, iters=30)
    assert 0 < its < 30                # the early exit ended the loop
    iters = _named(evs, "ip.iteration")
    assert len(iters) == its
    for name, each in (("ip.exit_read", 1), ("ip.factor", 1),
                       ("ip.newton", 2)):
        inner = _named(evs, name)
        # and the exit's read before the first iteration
        assert len(inner) == each * its + (name == "ip.exit_read"), name
        assert all(sum(_inside(e, it) for e in inner) == each
                   for it in iters), name


def test_ip_exit_read_spans_follow_the_reads(ric):
    spec, theta, N = ric
    # one read before the first iteration, none after the budget's last
    (_, evs), its = _solve_counted(spec, theta, N, iters=3)
    assert its == 3
    iters = _named(evs, "ip.iteration")
    reads = _named(evs, "ip.exit_read")
    assert len(iters) == len(reads) == 3
    assert reads[0].time_range.end <= iters[0].time_range.start
    assert [sum(_inside(r, it) for r in reads) for it in iters] == [1, 1, 0]
    # no early exit, no read
    (_, evs), its = _solve_counted(spec, theta, N, iters=5,
                                   early_exit=False)
    assert its == 5
    assert len(_named(evs, "ip.iteration")) == 5
    assert not _named(evs, "ip.exit_read")


def test_ip_output_is_bitwise_the_same_under_the_profiler(ric):
    spec, theta, N = ric
    before = ip_riccati_solve.iterations
    off = ip_riccati_solve(spec, theta, N, iters=30)
    its_off = ip_riccati_solve.iterations - before
    (on, _), its_on = _solve_counted(spec, theta, N, iters=30)
    assert its_on == its_off
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_session_advance_records_its_copy_in(setup):
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver="admm", **KW)
    session = Session(arrays, cfg, 1, np.zeros(2))
    _, refs, w, theta, gamma = _inputs(torch.float64)
    _, evs = _profiled(lambda: session.advance(refs[0, :1], w[0, :1],
                                               theta[0, :1], gamma[0, :1]))
    copy_in = _named(evs, "session.copy_in")
    assert len(copy_in) == 1
    assert not _named(evs, "session.replay")       # eager on the CPU
    solve = _named(evs, "solve")
    assert len(solve) == 1
    assert copy_in[0].time_range.end <= solve[0].time_range.start


def _ev(name, start, end, device=DeviceType.CPU, annotation=False):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=device, device_index=0,
              is_user_annotation=annotation)


def test_span_breakdown_credits_each_operation_to_its_launching_span():
    """The host runs ahead of the device: the protocol's operations run
    while the host is in the next ``rtmpc.solve``, and they are the
    protocol's, held by the protocol's copy on the device's timeline; of
    nested copies the innermost takes an operation; one that no program
    span's copy holds (a harness span's does not count) is nobody's."""
    cuda = DeviceType.CUDA
    host = [_ev("rtmpc.solve", 0, 100), _ev("rtmpc.k1", 10, 20),
            _ev("rtmpc.protocol", 100, 140), _ev("aten::mm", 110, 120),
            _ev("rtmpc.solve", 140, 900)]
    copies = [_ev(n, s, e, cuda, annotation=True) for n, s, e in (
        ("harness.rollout_chunk", 0, 2000), ("rtmpc.solve", 200, 712),
        ("rtmpc.k1", 205, 705), ("rtmpc.protocol", 720, 760))]
    ops = [_ev(n, s, e, cuda) for n, s, e in (
        ("cat", 200, 203), ("admm_kernel<8>", 205, 705), ("mul", 710, 712),
        ("mm", 720, 727), ("add", 750, 760), ("copy", 950, 952))]
    got = span_breakdown(host + copies + ops)

    def row(count, host_ms, device_ms, device_ops):
        return {"count": count, "host_ms": pytest.approx(host_ms),
                "device_ms": pytest.approx(device_ms),
                "device_ops": device_ops}
    assert got == {"rtmpc.solve": row(2, 0.86, 0.005, 2),
                   "rtmpc.k1": row(1, 0.01, 0.5, 1),
                   "rtmpc.protocol": row(1, 0.04, 0.017, 2),
                   "(no span)": row(0, 0.0, 0.002, 1)}


def test_span_breakdown_counts_a_real_profile(setup):
    arrays, cfg = setup.to_device(torch.float64, "cpu", solver="admm", **KW)
    rollout = make_batched_rollout(arrays, cfg, T)
    inputs = _inputs(torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rollout(*inputs)
    got = span_breakdown(prof.events())
    assert got["rtmpc.solve"]["count"] == got["rtmpc.protocol"]["count"] == T
    assert got["rtmpc.solve"]["host_ms"] > 0
    assert all(r["device_ms"] == 0 for r in got.values())   # no device


def test_span_quantities_take_the_reads_inside_the_iterations_off():
    """The read before the first iteration is an exit wait, and no part
    of an iteration's host time; the protocol's device time is a
    step's."""
    cuda = DeviceType.CUDA
    host = [_ev("rtmpc.ip.exit_read", 0, 10),
            _ev("rtmpc.ip.iteration", 20, 120),
            _ev("rtmpc.ip.exit_read", 100, 120),
            _ev("rtmpc.ip.iteration", 130, 230),
            _ev("rtmpc.ip.exit_read", 200, 230),
            _ev("rtmpc.protocol", 300, 340)]
    device = [_ev("rtmpc.protocol", 400, 450, cuda, annotation=True),
              _ev("mm", 400, 420, cuda), _ev("add", 430, 450, cuda)]
    events = host + device
    assert nested_host_ms(events, "rtmpc.ip.iteration",
                          "rtmpc.ip.exit_read") == pytest.approx(0.05)
    got = span_quantities(span_breakdown(events), events, 2)
    assert got == {"protocol_device_ms_per_step": pytest.approx(0.02),
                   "ip_dispatch_ms_per_iteration": pytest.approx(0.075),
                   "ip_exit_wait_ms_per_iteration": pytest.approx(0.03)}
    assert span_quantities({}, [], 1) == {}


def test_span_quantities_of_a_real_ip_profile(ric):
    spec, theta, N = ric
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ip_riccati_solve(spec, theta, N, iters=30)
    events = prof.events()
    got = span_quantities(span_breakdown(events), events, 1)
    assert set(got) == {"ip_dispatch_ms_per_iteration",
                        "ip_exit_wait_ms_per_iteration"}
    assert (got["ip_dispatch_ms_per_iteration"]
            > got["ip_exit_wait_ms_per_iteration"] > 0)
