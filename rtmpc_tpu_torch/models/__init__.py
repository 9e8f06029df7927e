from .specs import (SOLVERS, ControllerArrays, ControllerConfig, MPCSetup,
                    arrays_from_numpy, flagship_setup, ric_spec_from_numpy,
                    setup_tracking, setup_tube_tracking, spec_from_numpy)

__all__ = ["MPCSetup", "ControllerArrays", "ControllerConfig",
           "setup_tracking", "setup_tube_tracking", "flagship_setup",
           "arrays_from_numpy", "spec_from_numpy", "ric_spec_from_numpy",
           "SOLVERS"]
