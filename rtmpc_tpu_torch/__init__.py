"""rtmpc_tpu_torch — the PyTorch/CUDA port of ``rtmpc_tpu``.

Same system, same module layout, run eagerly in PyTorch on batch-explicit
``(B, ...)`` tensors: a Python loop over time replaces ``lax.scan``, a
written-out batch dimension replaces ``vmap``, and the one Pallas TPU
kernel of the main path (the fused ADMM solve) is a hand-written CUDA
kernel for Hopper (``csrc/admm_kernel.cu``, bound in ``ops/qp_cuda.py``).

The JAX package stays the reference each module is tested against
(``tests/test_torch_*.py``).  This package imports ``torch``, never ``jax``
and nothing of ``rtmpc_tpu``: its host setup runs on its own NumPy-only
``utils`` and ``sets`` subpackages (polytopes, synthesis, invariant sets),
copies held bit-equal to the JAX package's by the tests.

Subpackages
-----------
utils     : polytope toolbox, discrete-time synthesis (dlqr/dlyap/c2d), the
            binding of the native LP library.
sets      : invariant-set algorithms (Rakovic mRPI, Darup RPI, Gilbert-Tan
            maximal admissible set), constraint tightening.
ops       : precision policy, QP assembly, batched ADMM, infeasibility
            certificates, the CUDA kernel wrapper, the structured interior
            point.
models    : host setup of the tube-tracking and tracking controllers, the
            cartpole's linearization, and their freeze into tensors.
protocol  : lossy channel draws, consistent/smart actuator, estimator.
parallel  : the batched closed-loop rollout engine and Monte-Carlo sweeps.
apps      : ``results_linear`` (the paper's Fig. 3a sweep) and its
            scenario.
data      : the committed draws of the Fig. 3a sweep at seed 0.
"""

from .ops import precision as _precision  # noqa: F401  (applies the policy)

__version__ = "0.1.0"
