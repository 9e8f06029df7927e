"""Runnable apps of the port (counterparts of ``rtmpc_tpu/apps``).

    python3 -m rtmpc_tpu_torch.apps.results_linear --device cuda

Ported so far: ``results_linear`` (the paper's Fig. 3a sweep) and the
cartpole scenario it runs.
"""
