"""The whole of a run on the CPU at a small size, the look for a card
skipped: a sound program is correct, and each fault that a cell can have,
planted in the timed path, makes ``correct`` come out false.

The faults (one chip, so no exchange between chips to leave out):

* ``unchanged``: the step returns its state as it got it;
* ``half``: the step leaves the second half of the batch out (not at B=1);
* ``altered``: the applied input altered, by 0.5, where the actuator
  produces it, at one step of every rollout;
and, on the card at the cell's own size, the configuration's control: the
same solver a precision lower in the program's place.
"""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import SMALL, SMALL_SAMPLE

SECONDS = {"di-mc-b16384": 0.5, "cartpole-ip64-b200": 3.0,
           "di-tick-b1": 1.5}
CELLS = list(SMALL)


def _run(cell, seed=11):
    return harness.run(cell, seed, SECONDS[cell], False, device="cpu",
                       traffic=SMALL[cell], sample=SMALL_SAMPLE[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _unchanged(orig):
    def step(arrays, cfg, am, im, ps, one, carry, *inputs):
        _, out = orig(arrays, cfg, am, im, ps, one, carry, *inputs)
        return carry, out._replace(x=carry.x)
    return step


def _half(orig):
    from rtmpc_tpu_torch.parallel.rollout import _select
    from rtmpc_tpu_torch.tree import tree_map

    def step(arrays, cfg, am, im, ps, one, carry, *inputs):
        new, out = orig(arrays, cfg, am, im, ps, one, carry, *inputs)
        B = carry.x.shape[0]
        keep = torch.arange(B, device=carry.x.device) < B // 2
        new = tree_map(lambda a, b: _select(keep, a, b), new, carry)
        return new, out._replace(x=new.x)
    return step


FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "half", "altered")
          if not (f == "half" and c == "di-tick-b1")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    import rtmpc_tpu_torch.parallel.rollout as ro
    if fault == "altered":
        act = ro.actuator_step

        def altered(state, *a, **k):
            u, pkt, new, aux = act(state, *a, **k)
            return (torch.where((state.t == 2)[:, None], u + 0.5, u), pkt,
                    new, aux)
        monkeypatch.setattr(ro, "actuator_step", altered)
    else:
        monkeypatch.setattr(ro, "_step", {"unchanged": _unchanged,
                                          "half": _half}[fault](ro._step))
    res = _run(cell)
    assert not res["correct"], res["checks"]


# the control's window on the card: as long as a run's where the answers
# depend on it (the cartpole's steps, the tick's whole episodes), else
# enough for the answers
CONTROL_SECONDS = {"di-mc-b16384": 2.0, "cartpole-ip64-b200": 10.0,
                   "di-tick-b1": 10.0}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    """The cell's control at its own size on the card: the flagship
    sweep's plain ADMM in TF32, the served tick's in bfloat16 (TF32 does
    not reach B=1), the cartpole's interior point in float32 (on the CPU
    at the small size it reads within the limits: its error grows with the
    batch and the steps)."""
    res = harness.run(cell, 17, CONTROL_SECONDS[cell], False, control=True)
    assert not res["correct"], res["checks"]
