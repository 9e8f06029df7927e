from .actuator import ActuatorState, actuator_step, init_actuator
from .estimator import (EstimatorState, estimator_update, init_estimator,
                        store_sequence)
from .network import draw_disturbances, draw_loss_masks

__all__ = ["ActuatorState", "init_actuator", "actuator_step",
           "EstimatorState", "init_estimator", "store_sequence",
           "estimator_update", "draw_loss_masks", "draw_disturbances"]
