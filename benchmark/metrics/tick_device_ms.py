"""``tick_device_ms``: the served session's device time a tick, in ms: the
union of the intervals of the device operations that began inside a
profiled tick's span (``harness.tick``: the inputs' copies into the
session, the graph's replay, the synchronize), over the ticks profiled.
The host's share of a tick is ``tick_p99_ms`` and its median against
this."""

import bisect

from benchmark.trace import SPAN_PREFIX, merge

SPAN = SPAN_PREFIX + "tick"


def read(data):
    t = data["trace"]
    ticks = sorted((s, e) for name, s, e in t.get("host_spans", [])
                   if name == SPAN)
    starts = [s for s, _ in ticks]
    inside = []
    for _, s, e in t["events"]:
        k = bisect.bisect_right(starts, s) - 1   # the last tick begun by s
        if k >= 0 and s < ticks[k][1]:
            inside.append((s, min(e, ticks[k][1])))
    if not inside:
        return None
    return sum(e - s for s, e in merge(inside)) / 1e3 / len(ticks)
