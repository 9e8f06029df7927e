"""Fused batched ADMM solve on the GPU (counterpart of ``rtmpc_tpu/ops/qp_pallas.py``).

``admm_solve_cuda`` runs a whole fixed-count ADMM phase for a batch in one
launch of the hand-written kernel ``csrc/admm_kernel.cu`` (the port of the
Pallas kernel ``_admm_kernel``).  The kernel has two paths, picked by the
width ``n_p + m_p`` of the composites: up to 192 columns [Gxc; Gsc] sits
in shared memory (``admm_kernel``, the flagship's 40 + 112), up to 2048 it
is read from L2 (``admm_kernel_l2``, the cartpole's 112 + 792 and
112 + 840).  On CPU tensors it runs ``_admm_solve_cuda_plain``, the same
composite-form iteration in batched ``torch.matmul``; the CPU tests hold
that plain version against the JAX package, and ``chip_smoke.py`` holds
the kernel against it on the card.

The kernel is built from the source in this checkout at first use, with
``nvcc`` for ``sm_90a``, into ``build/rtmpc_tpu_torch/`` next to the
package; the library's file name carries a hash of the source and flags,
so an edited source is rebuilt.  It is bound with ``ctypes`` (plain C
interface, no PyTorch headers), launched on PyTorch's current stream, and
never synchronised here.  ``admm_solve_cuda.launches`` counts kernel
launches, and ``admm_solve_cuda.launches_by_path`` counts them per path
(``"smem"``, ``"l2"``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

from .qp import (ADMMSolution, ADMMSpec, ADMMState, init_admm_state,
                 problem_vectors)

__all__ = ["admm_solve_cuda", "build_kernel", "kernel_path"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "admm_kernel.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "rtmpc_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_CUDA_HOME_DEFAULT = "/usr/local/cuda"
# n_p + m_p limits of the kernel's two paths (kMaxThreads and
# kThreadsL * kMaxColsL in the source)
_PATH_LIMITS = (("smem", 192), ("l2", 2048))


def _find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location; raises ``RuntimeError`` if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append(os.path.join(_CUDA_HOME_DEFAULT, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the CUDA ADMM kernel: nvcc not found (looked in "
        "$CUDA_HOME/bin, PATH and "
        f"{_CUDA_HOME_DEFAULT}/bin); install the CUDA toolkit or set "
        "CUDA_HOME")


def build_kernel() -> Tuple[str, str]:
    """Compile ``csrc/admm_kernel.cu`` unless a library built from the same
    source and flags exists.  Returns ``(library path, compiler log)``; the
    log (ptxas register/shared-memory report) is empty on a cache hit."""
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode())
    lib = os.path.join(_BUILD_DIR,
                       f"libadmm_kernel_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    nvcc = _find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {_SRC}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    lib = ctypes.CDLL(path)
    fn = lib.rtmpc_admm_solve_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return lib


def kernel_path(n_cols: int) -> str:
    """The kernel path that takes composites ``n_cols = n_p + m_p`` wide;
    raises ``ValueError`` if none does."""
    for path, limit in _PATH_LIMITS:
        if n_cols <= limit:
            return path
    raise ValueError(f"admm_solve_cuda: n_p + m_p = {n_cols} exceeds the "
                     f"kernel's {_PATH_LIMITS[-1][1]} columns")


def _admm_solve_cuda_plain(spec: ADMMSpec, theta: torch.Tensor,
                           state: Optional[ADMMState] = None,
                           iters: int = 100) -> ADMMSolution:
    """The kernel's function in plain PyTorch: the composite-form
    iteration ``[xt | zt] = x Gxc + (rho z - y) Gsc - q Kcat``."""
    theta = theta.to(spec.q0.dtype)
    if state is None:
        state = init_admm_state(spec, theta.shape[0])
    n_p = spec.Kinv.shape[0]
    q, l, u = problem_vectors(spec, theta)
    qcat = q @ spec.Kcat
    alpha = spec.alpha
    x, y, z = state
    for _ in range(iters):
        t = x @ spec.Gxc + (spec.rho * z - y) @ spec.Gsc - qcat
        xt, zt = t[:, :n_p], t[:, n_p:]
        x_new = alpha * xt + (1.0 - alpha) * x
        z_mix = alpha * zt + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_mix + y * spec.rho_inv, l), u)
        y = y + spec.rho * (z_mix - z_new)
        x, z = x_new, z_new
    r_prim = (x @ spec.As.T - z).abs().amax(dim=1)
    r_dual = (x @ spec.Ps.T + q + y @ spec.As).abs().amax(dim=1)
    return ADMMSolution(z_primal=spec.D * x, state=ADMMState(x, y, z),
                        r_prim=r_prim, r_dual=r_dual)


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"admm_solve_cuda: {name} must be float32 on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"admm_solve_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"admm_solve_cuda: {name} must be contiguous")


def admm_solve_cuda(spec: ADMMSpec, theta: torch.Tensor,
                    state: Optional[ADMMState] = None,
                    iters: int = 100) -> ADMMSolution:
    """One fixed-count ADMM phase for a batch: ``theta`` ``(B, ntheta)``,
    state leaves ``(B, n_p)`` / ``(B, m_p)``, residuals ``(B,)``.

    CPU tensors run the plain PyTorch version.  CUDA tensors (float32,
    contiguous) launch the kernel or raise; there is no fallback."""
    if theta.device.type == "cpu":
        return _admm_solve_cuda_plain(spec, theta, state, iters)
    if theta.device.type != "cuda":
        raise ValueError(f"admm_solve_cuda: unsupported device {theta.device}")
    dev = theta.device
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    nm = n_p + m_p
    if theta.dim() != 2:
        raise ValueError("admm_solve_cuda: theta must be (B, ntheta)")
    B, nt = theta.shape
    path = kernel_path(nm)
    if iters < 0:
        raise ValueError("admm_solve_cuda: iters must be >= 0")
    if state is None:
        state = init_admm_state(spec, B)
    shapes = {"Gxc": (n_p, nm), "Gsc": (m_p, nm), "Kcat": (n_p, nm),
              "As": (m_p, n_p), "Ps": (n_p, n_p), "Mq": (n_p, nt),
              "Ml": (m_p, nt), "Mu": (m_p, nt), "q0": (n_p,), "l0": (m_p,),
              "u0": (m_p,), "rho": (m_p,), "rho_inv": (m_p,), "alpha": (),
              "D": (n_p,)}
    for f, shape in shapes.items():
        _check(f"spec.{f}", getattr(spec, f), shape, dev)
    _check("theta", theta, (B, nt), dev)
    _check("state.x", state.x, (B, n_p), dev)
    _check("state.y", state.y, (B, m_p), dev)
    _check("state.z", state.z, (B, m_p), dev)

    x_o = torch.empty_like(state.x)
    y_o = torch.empty_like(state.y)
    z_o = torch.empty_like(state.z)
    rp = torch.empty(B, dtype=torch.float32, device=dev)
    rd = torch.empty(B, dtype=torch.float32, device=dev)
    if B > 0:
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (
            theta, state.x, state.y, state.z, spec.Gxc, spec.Gsc, spec.Kcat,
            spec.As, spec.Ps, spec.Mq, spec.Ml, spec.Mu, spec.q0, spec.l0,
            spec.u0, spec.rho, spec.rho_inv, spec.alpha,
            x_o, y_o, z_o, rp, rd)]
        rc = lib.rtmpc_admm_solve_f32(
            *ptrs, B, n_p, m_p, nt, iters, dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"admm_solve_cuda: kernel launch failed with "
                               f"CUDA error {rc}")
        admm_solve_cuda.launches += 1
        admm_solve_cuda.launches_by_path[path] += 1
    return ADMMSolution(z_primal=x_o * spec.D, state=ADMMState(x_o, y_o, z_o),
                        r_prim=rp, r_dual=rd)


admm_solve_cuda.launches = 0
admm_solve_cuda.launches_by_path = {path: 0 for path, _ in _PATH_LIMITS}
