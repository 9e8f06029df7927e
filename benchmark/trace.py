"""The traced run's profiler window and its reduction.

``Profiled`` opens ``torch.profiler`` (CPU and CUDA activities) around a
stated part of the measured window and keeps, once it closes, the device
operations and the host's events as plain tuples in microseconds on the
profiler's one clock.  ``reduce`` turns them into what the per-layer
readers and the result line need: the busy seconds (the union of the
device operations' intervals), the window's length, the device operations
that took most time, and the longest idle gaps of the device named by what
the host was doing at the time (the innermost host event, the harness's
own spans included, that covers the gap's middle).
"""

from __future__ import annotations

from collections import defaultdict

__all__ = ["SPAN_PREFIX", "Profiled", "merge", "reduce"]

# the names of the harness's own spans begin so
SPAN_PREFIX = "harness."


class Profiled:
    """Profile the work of a ``with`` block; ``device`` and ``host`` hold
    ``(name, start_us, end_us)`` tuples once it has closed."""

    def __init__(self, sync):
        self.sync = sync
        self.device, self.host = [], []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType
        self.sync()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        for e in self._prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type != DeviceType.CUDA:
                self.host.append(item)
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name.startswith(SPAN_PREFIX)):
                # a span's copy on the device's timeline is no operation
                self.device.append(item)
        return False


def merge(intervals):
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(device, host, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` of one
    profiled window (see the module note)."""
    spans = [(s, e) for _, s, e in device] + [(s, e) for _, s, e in host]
    if not device or not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    w0 = min(s for s, _ in spans)
    w1 = max(e for _, e in spans)
    busy = merge((s, e) for _, s, e in device)
    by_name = defaultdict(float)
    for name, s, e in device:
        by_name[name] += (e - s) / 1e6
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    # one sweep over the gaps' middles in order: a stack of the host
    # events begun by then, the ended ones popped off its top
    by_host = defaultdict(float)
    host_sorted = sorted(host, key=lambda h: h[1])
    stack, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while i < len(host_sorted) and host_sorted[i][1] <= mid:
            stack.append(host_sorted[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "(no host event)"
        by_host[name] += (g1 - g0) / 1e6
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(([n[:120], v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n[:120], v] for n, v in by_host.items()),
                            key=lambda x: -x[1])[:top],
    }
