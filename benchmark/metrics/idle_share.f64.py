"""``idle_share.f64``: the share of the profiled window, in %, in which
no operation ran on the device."""

from benchmark.metrics_common import idle_share as read  # noqa: F401
