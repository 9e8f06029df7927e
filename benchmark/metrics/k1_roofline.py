"""``k1_roofline``: K1's share of its roofline, in %.

The least time of every K1 launch in the profiled steps (``roofline.py``,
the factored form's work at the QP's padded shape, one launch a phase of
the step's ADMM schedule) over the device time of the profiler's events
whose name holds ``admm_kernel`` (all three of K1's paths).  Nothing to
read where no such event ran."""

from benchmark.roofline import admm_phase_ms

NAME = "admm_kernel"


def read(data):
    shape = data["shape"]
    k1 = [(s, e) for name, s, e in data["trace"]["events"] if NAME in name]
    if not k1 or shape["n"] is None:
        return None
    iters = shape["phase_iters"]
    if len(k1) % len(iters):
        raise RuntimeError(f"{len(k1)} K1 launches are no whole number of "
                           f"steps of {len(iters)} phases")
    least_ms = len(k1) // len(iters) * sum(
        admm_phase_ms(shape["batch"], shape["n"], shape["m"],
                      shape["ntheta"], it) for it in iters)
    return 100.0 * least_ms / (sum(e - s for s, e in k1) / 1e3)
