"""``ip_iterations_per_step``: the interior point's iterations a step of
the window, from the program's own counter
``ip_riccati_solve.iterations`` (the batched loop's iterations)."""


def read(data):
    c = data["counters"]
    if not c.get("ip_iterations") or not c.get("steps"):
        return None
    return c["ip_iterations"] / c["steps"]
