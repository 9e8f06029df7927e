"""Named spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function("rtmpc." + name)``
while a profiler is attached to the thread (``torch.profiler.profile``:
Kineto records the range among the host's events, in the same session as
the device's activity, and copies it onto the device's timeline around
the operations launched inside it), and otherwise one shared null context
that allocates nothing: with no profiler a span costs one flag check.
There is no switch: tracing is on exactly when a profiler is.

Code captured into a CUDA graph runs its spans once, at capture, and never
at replay.  The spans, and what reads each, are listed in ``PERF.md``
(section 3); ``parallel/step_profile.py:span_breakdown`` credits each
device operation to the innermost span that launched it.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["PREFIX", "span"]

# the names of the program's spans begin so
PREFIX = "rtmpc."

_OFF = contextlib.nullcontext()


def span(name: str):
    """The span ``"rtmpc." + name`` while a profiler is attached, else the
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
