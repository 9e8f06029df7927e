"""``idle_share.tick``: the share of the profiled ticks' window, in %, in
which no operation ran on the device (the profiler's record, as the other
cells' idle shares: the host's launch of a tick's graph counts as idle)."""

from benchmark.metrics_common import idle_share as read  # noqa: F401
