"""Runnable apps of the port (counterparts of ``rtmpc_tpu/apps``).

    python3 -m rtmpc_tpu_torch.apps.results_linear --device cuda
    python3 -m rtmpc_tpu_torch.apps.serve_controller --device cuda
    python3 -m rtmpc_tpu_torch.apps.example_tube_tracking_lossy --device cuda

The paper's Results (``results_linear``, ``results_linear_extended``,
``results_nonlinear``) and their cartpole scenario, the served 50 Hz
session (``serve_controller``) and the reference's six example loops
(``example_regulator``, ``example_tracking``, ``example_tracking_lossy``,
``example_tube_regulator``, ``example_tube_tracking``,
``example_tube_tracking_lossy``).  Every app runs on the card unless
``--device cpu`` is given.
"""
