"""``rollout_device_ms_per_step``: the device time, in ms a step, of every
device operation of the profiled steps other than K1's (the step loop
outside the solver: packet, protocol, plant, the solve's own glue)."""

NAME = "admm_kernel"


def read(data):
    t = data["trace"]
    if not t["events"] or not t["steps"]:
        return None
    other = sum(e - s for name, s, e in t["events"] if NAME not in name)
    return other / 1e3 / t["steps"]
