"""Whether what the timed path produced is correct: the program's answers
held against the plain reference's (``benchmark/reference/``).

An answer is one rollout of the window: its initial state, its inputs (the
references, disturbances and delivery flags the benchmark made) and what
the program's timed path returned for it, step by step.  The reference
works its own controller out of the configuration and runs the same
rollout in float64; the numbers compared, each against its limit in the
cell's file (``benchmark/workloads/<cell>.json``):

* ``nonfinite``: the steps at which the program returned a state, input
  or nominal state that is no finite number (exact: limit 0);
* ``x_err``: the largest gap of a plant state, over every step of every
  answer before its first non-finite output (the plant's units: so a
  control that diverges gives the gap it reached, not NaN);
* ``x_err_med``: the median over the answers of each one's largest gap of
  a plant state (the widest gap swings from seed to seed, this does not);
* ``x_nom_err``: as ``x_err``, for the actuator's nominal state;
* ``u_err`` and ``u_err_med``: as ``x_err`` and ``x_err_med``, for the
  applied input;
* ``rms_err``: the largest gap of a rollout's RMS tracking error (the
  paper's metric over the steps compared, the finite ones), relative to
  the reference's;
* ``theta_diff``: steps whose consistency flag differs (exact: limit 0);
* ``feasible_diff``: answers whose feasibility differs (exact: limit 0).
"""

from __future__ import annotations

import json

import numpy as np

from .reference.loop import rollout
from .reference.mpc import build_controller

__all__ = ["NUMBERS", "Answer", "compare", "judge"]

NUMBERS = ("nonfinite", "x_err", "x_err_med", "x_nom_err", "u_err", "u_err_med",
           "rms_err", "theta_diff", "feasible_diff")


class Answer:
    """One rollout: the inputs both sides get, and the program's outputs
    (numpy arrays, ``(T, .)``; ``feasible`` the flag after its last
    step)."""

    def __init__(self, x0, refs, w, theta, gamma, x, u, x_nom, Theta,
                 feasible):
        self.x0, self.refs, self.w = x0, refs, w
        self.theta, self.gamma = theta, gamma
        self.x, self.u, self.x_nom = x, u, x_nom
        self.Theta, self.feasible = Theta, bool(feasible)


def _rms(x0, xs, refs):
    """The paper's RMS tracking error over the steps given (x0 included,
    the last state left out)."""
    traj = np.vstack([x0[None], xs[:-1]])
    err2 = np.sum((traj[:, 0] - refs[:, 0]) ** 2) + np.sum(traj[:, 1:] ** 2)
    return np.sqrt(err2) / len(refs)


_CONTROLLERS = {}


def controller(config: dict):
    """The reference's controller of ``config``, worked out once a
    process."""
    key = json.dumps(config, sort_keys=True)
    if key not in _CONTROLLERS:
        _CONTROLLERS[key] = build_controller(config)
    return _CONTROLLERS[key]


def compare(config: dict, answers) -> dict:
    """The numbers of ``NUMBERS`` over ``answers`` (a nonempty list)."""
    ctl = controller(config)
    out = dict.fromkeys(NUMBERS, 0.0)
    per = {"x": [], "u": []}
    for a in answers:
        ref = rollout(ctl, a.x0, a.refs, a.w, a.theta, a.gamma)
        prog = {key: np.asarray(getattr(a, key), float).reshape(len(a.refs),
                                                                -1)
                for key in ("x", "x_nom", "u")}
        bad = ~np.isfinite(np.hstack(list(prog.values()))).all(axis=1)
        out["nonfinite"] += float(bad.sum())
        # the steps before the first non-finite output
        L = int(np.argmax(bad)) if bad.any() else len(bad)
        for key, name in (("x", "x_err"), ("x_nom", "x_nom_err"),
                          ("u", "u_err")):
            gap = np.abs(prog[key][:L] - ref[key].reshape(len(a.refs),
                                                          -1)[:L])
            worst = float(gap.max()) if L else 0.0
            out[name] = max(out[name], worst)
            if key in per:
                per[key].append(worst)
        if L:
            r_ref = _rms(np.asarray(a.x0, float), ref["x"][:L], a.refs[:L])
            r_prog = _rms(np.asarray(a.x0, float), prog["x"][:L],
                          a.refs[:L])
            out["rms_err"] = max(out["rms_err"],
                                 float(abs(r_prog - r_ref) / r_ref))
        out["theta_diff"] += float(np.sum(
            np.asarray(a.Theta) != ref["Theta"]))
        out["feasible_diff"] += float(a.feasible != bool(ref["feasible"][-1]))
    out["x_err_med"] = float(np.median(per["x"]))
    out["u_err_med"] = float(np.median(per["u"]))
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number beside its limit; correct when
    every number is at most its limit (a NaN is not)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(numbers[k] <= limits[k] for k in NUMBERS)
    return ok, checks
