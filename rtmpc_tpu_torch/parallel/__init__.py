from .rollout import (RolloutCarry, StepOutputs, init_carry,
                      make_batched_rollout, tracking_error_rms)

__all__ = ["RolloutCarry", "StepOutputs", "init_carry",
           "make_batched_rollout", "tracking_error_rms"]
