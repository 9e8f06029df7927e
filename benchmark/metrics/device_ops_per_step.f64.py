"""``device_ops_per_step.f64``: the device operations, a step, that the
profiler recorded in the profiled steps (the eager interior point's
launches and the step loop's)."""


def read(data):
    t = data["trace"]
    if not t["events"] or not t["steps"]:
        return None
    return len(t["events"]) / t["steps"]
