"""Arithmetic that several per-layer readers share."""


def idle_share(data):
    """The share of the profiled window, in %, in which no operation ran
    on the device (nothing to read where none ran)."""
    t = data["trace"]
    if not t["events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
