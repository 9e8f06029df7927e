from .mc import (MCSweepResult, SweepDraws, draw_sweep, load_draws,
                 run_mc_sweep)
from .rollout import (RolloutCarry, StepOutputs, init_carry,
                      make_batched_rollout, tracking_error_rms)

__all__ = ["RolloutCarry", "StepOutputs", "init_carry",
           "make_batched_rollout", "tracking_error_rms", "MCSweepResult",
           "SweepDraws", "draw_sweep", "load_draws", "run_mc_sweep"]
