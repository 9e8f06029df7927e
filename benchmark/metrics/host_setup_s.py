"""``host_setup_s``: the seconds of the program's host set-up, from the
harness's timer around ``setup_tube_tracking(...)`` and ``to_device(...)``
(sets, QP data, the solver's preparation, the copy to the device)."""


def read(data):
    return data["spans"].get("host_setup_s")
