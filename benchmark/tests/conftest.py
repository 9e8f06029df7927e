"""Small traffic for the benchmark's CPU tests: the cells' own mixes cut to
a size the CPU runs in seconds, by entries that replace the mix's."""

import sys

import pytest
import torch

from benchmark.harness import ROOT

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the flagship's setpoint steps and 70% loss in 24 steps; gentler steps
# than the cell's 5, -9, 4 so that 60 + 60 ADMM iterations settle here
SMALL = {
    "di-mc-b16384": {"batch": 32, "steps": 24, "chunk": 24, "draw_sets": 2,
                     "reference": [[0, 3.0], [12, -2.0]]},
    "cartpole-ip64-b200": {"batch": 10, "rows_per_group": 1, "steps": 10},
    "di-tick-b1": {"episode": 30, "pool": 2, "level_every": 15,
                   "level_range": [-3.0, 3.0], "warmup_ticks": 3},
}
# the sample of each small cell
SMALL_SAMPLE = {"di-mc-b16384": {"rows": 4},
                "cartpole-ip64-b200": {"per_group": 1},
                "di-tick-b1": {"episodes": 2}}


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU build of torch can deadlock in batched LU on several
    intra-op threads; the benchmark's CPU runs take one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check's control runs at the "
                    "cell's own size, and the flagship's in TF32, which only "
                    "the card has")
