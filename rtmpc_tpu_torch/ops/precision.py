"""Device and dtype policy of the port (counterpart of ``rtmpc_tpu/ops/precision.py``).

The solve path runs in full float32 on the GPU (float64 on the CPU for the
parity tests).  The ADMM and protocol updates are deliberately stiff
(equality rows carry ``rho_eq_scale ~ 1e3``), and the JAX package measured
that single-pass bf16 matmuls diverge on them under batching.  TF32 keeps
the same 10-bit mantissa as bf16, so it is switched off for both matmuls
and cuDNN when this module is imported:

* ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default,
  stated here so that no caller's setting leaks in);
* ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch defaults it to
  True; the port runs no convolution, but the policy is one rule).

The TPU's HIGH/HIGHEST multi-pass bf16 emulation has no counterpart: the
GPU computes float32 products natively.
"""

import torch

__all__ = ["DEFAULT_DTYPE"]

DEFAULT_DTYPE = torch.float32   # the solve path's dtype on the GPU

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
