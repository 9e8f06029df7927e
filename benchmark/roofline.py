"""The yardstick of K1, the batched ADMM kernel: the least time one NVIDIA
H100 SXM could take for one ADMM phase, from the problem's shapes alone.

Frozen here so that no later change to the program can move it: the count
is that of the factored form of an ADMM iteration, whatever form the
running kernel computes,

    xt = (sigma x - q + (rho z - y) As) Kinv',   zt = xt As',

``2 B (n^2 + 2 n m)`` FLOP an iteration plus the residuals' products once a
phase, for ``n`` and ``m`` the padded columns of the QP's variables and
constraints (the layout K1 runs).  Bytes: every input read once and every
output written once: the operators ``Kinv``, ``As`` and ``Ps``, the affine
maps of q, l and u in theta, rho and its inverse, sigma, theta, the state
(x, y, z) in and out and the two residuals, float32.

The peaks are NVIDIA's data sheet for the SXM part at its 700 W limit:
FP32 outside the tensor cores and the HBM3 rate.  A card set below 700 W
runs slower under load; the run reports the card's limit beside the share.
"""

from __future__ import annotations

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BYTES_PER_S", "admm_phase_flops",
           "admm_phase_bytes", "admm_phase_ms"]

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def admm_phase_flops(B: int, n: int, m: int, iters: int) -> float:
    """FLOP of one phase of ``iters`` iterations over ``B`` rows."""
    return (2.0 * B * (n * n + 2 * n * m) * iters
            + 2.0 * B * (2 * n * m + n * n))


def admm_phase_bytes(B: int, n: int, m: int, ntheta: int) -> float:
    """Bytes of one phase: inputs read once, outputs written once."""
    floats = (B * (ntheta + 2 * (n + 2 * m) + 2)       # theta, state x2, r
              + n * n + m * n + n * n                   # Kinv, As, Ps
              + (n + 2 * m) * (ntheta + 1) + 2 * m + 1)
    return 4.0 * floats


def admm_phase_ms(B: int, n: int, m: int, ntheta: int, iters: int) -> float:
    """The least time of one phase on the card: the larger of its FLOP over
    the FP32 peak and its bytes over the memory rate, in ms."""
    return 1e3 * max(admm_phase_flops(B, n, m, iters) / PEAK_FP32_FLOPS,
                     admm_phase_bytes(B, n, m, ntheta) / PEAK_BYTES_PER_S)
