"""Fused batched ADMM solve on the GPU (counterpart of ``rtmpc_tpu/ops/qp_pallas.py``).

``admm_solve_cuda`` runs a whole fixed-count ADMM phase for a batch in one
launch of the hand-written kernel K1 (``csrc/admm_kernel.cu`` and
``csrc/admm_factored.cu``, the port of the Pallas kernel ``_admm_kernel``).
K1 has three paths; the dispatch is a pure function of the batch ``B`` and
the QP's ``n_p`` and ``m_p`` (``kernel_path`` mirrors it):

* ``"fac"`` (``admm_kernel_factored``): the factored form ``xt = (sigma x
  + (rho z - y) As) Kinv' - q Kinv'``, ``zt = xt As'``, with Kinv and the
  rows of As resident in the shared memory of one block (the flagship) or
  of a cluster of 8 blocks that split As's rows and exchange their partial
  products once an iteration.  Where that operator fits (``_fac_fits``:
  every controller's QP), it takes every launch with ``B <= FAC_MAX_B``
  (the served session, Fig. 3d, the examples, ``create_animations``), and
  every launch above 1024 columns (the extended controller's 112 + 1648)
  at any B.
* ``"smem"`` (``admm_kernel``): the composite form ``[xt | zt] = x Gxc +
  (rho z - y) Gsc - q Kcat`` with [Gxc; Gsc] in shared memory and 8 x 4
  register tiles, for the other launches up to 192 columns (the flagship at
  B=16384).
* ``"l2"`` (``admm_kernel_cluster``): the composite form with the columns
  split over a cluster of 8 blocks that stream their slices of [Gxc; Gsc]
  from L2, for the other launches up to 2048 columns (the cartpole's 112 +
  792 and 112 + 840 at B=200).

On CPU tensors it runs the plain PyTorch version of the path the card
would take: ``_admm_solve_factored_plain`` for ``"fac"``,
``_admm_solve_cuda_plain`` (the composite form) for the others, each in
batched ``torch.matmul``; the CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds the kernel against them on the card.

The kernel is built from the sources in this checkout at first use, with
``nvcc`` for ``sm_90a`` (one compiler process a source, side by side),
into ``build/rtmpc_tpu_torch/`` next to the package; the library's file
name carries a hash of the sources and flags, so an edited source is
rebuilt.  It is bound with ``ctypes`` (plain C interface, no PyTorch
headers), launched on PyTorch's current stream, and never synchronised
here.  ``admm_solve_cuda.launches`` counts kernel launches, and
``admm_solve_cuda.launches_by_path`` counts them per path (``"smem"``,
``"l2"``, ``"fac"``).
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

import numpy as np
import torch

from ..utils.spans import span
from .qp import (ADMMSolution, ADMMSpec, ADMMState, init_admm_state,
                 problem_vectors)

__all__ = ["admm_solve_cuda", "build_kernel", "kernel_path", "kernel_rows"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = tuple(os.path.join(_PKG_DIR, "csrc", f)
              for f in ("admm_kernel.cu", "admm_factored.cu"))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "rtmpc_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_CUDA_HOME_DEFAULT = "/usr/local/cuda"
# n_p + m_p limits of the composite paths (kMaxColsSmall and kMaxColsLarge
# in the source)
_PATH_LIMITS = (("smem", 192), ("l2", 2048))
# The "fac" path: every launch whose operator fits (_fac_fits) with B <=
# FAC_MAX_B or more than FAC_WIDE_COLS columns (kFacMaxB, kFacMinCols - 1 in
# csrc/admm_kernel.cu).  FAC_MAX_B is the upper end of the batches the
# crossover sweep times (kernel_bench.CROSSOVER_BATCHES): "fac" was the
# faster at every one of them on the flagship and the cartpole tube QP
# (PERF.md 6), and chip_smoke.py fails on a card where it is not.
FAC_MAX_B = 64
FAC_WIDE_COLS = 1024
# "fac" runs one row a group with its intermediate arithmetic (the
# products' sums, rho z - y, the right-hand side, xt, zt) in float64 over
# the float32 state and operator on one block (m_p <= 256 and n_p <= 64)
# and up to FAC_ONE_ROW_B rows on a cluster (kFacOneRowB, kOneBlockMaxN in
# csrc/admm_factored.cu); its plain version does the same there.
FAC_ONE_ROW_B = 15
FAC_ONE_BLOCK_N = 64


# The rest of the "fac" kernel's shared-memory layout (admm_factored.cu:
# fac_layout), for _fac_fits: threads a block, blocks a cluster, rows of As
# a block at most, and the bytes a block may use
_FAC_THREADS, _FAC_CLUSTER, _FAC_MAX_SLICE = 256, 8, 256
_FAC_SMEM_LIMIT = 232448 - 1024


def _fac_one_row(B: int, n_p: int, m_p: int) -> bool:
    return B <= FAC_ONE_ROW_B or (m_p <= 256 and n_p <= FAC_ONE_BLOCK_N)


def _fac_blocks(n_p: int, m_p: int) -> int:
    """Blocks a group of "fac": one where As has at most 256 rows and
    n_p is at most 64, else a cluster of 8 (``fac_cl``)."""
    return 1 if m_p <= _FAC_MAX_SLICE and n_p <= FAC_ONE_BLOCK_N else \
        _FAC_CLUSTER


def _fac_smem_bytes(n: int, m: int, rc: int) -> int:
    """Dynamic shared memory of one block of "fac" at ``rc`` rows a group
    (``fac_layout``): As's slice and Kinv at their padded strides, the 8
    partials on a cluster, the iterate buffers (float64 at one row a
    group) and the term slices' partial sums."""
    def r4(v):
        return (v + 3) & ~3

    def ks_log2(units, K):                  # fac_ks_log2
        up, s = (units + 31) & ~31, 0
        while s < 3 and (_FAC_THREADS >> (s + 1)) >= up and K >= (16 << s):
            s += 1
        return s

    cl = _fac_blocks(n, m)
    ms, n4 = -(-m // cl), r4(n)
    ld = (n | 1) if rc > 1 else (n4 if n4 % 8 == 4 else n4 + 4)   # fac_ld
    kt = n4 if rc == 1 else n
    R = min(rc, 8)
    RG = rc // R
    ms_last = m - (cl - 1) * ms
    qf = 0
    for units, K in ((RG * n, ms), (RG * n, ms_last), (RG * n, kt),
                     (RG * ms, kt), (RG * ms_last, kt)):
        ks = 1 << ks_log2(units, K)
        qf = max(qf, ks * units * R if ks > 1 else 0)
    vw = 2 if rc == 1 else 1
    floats = (r4(ms * ld) + r4(n * (ld if rc == 1 else n))
              + (_FAC_CLUSTER * n4 * rc * vw if cl > 1 else 0)
              + r4(ms * rc * vw) + 2 * n4 * rc * vw + r4(qf * vw))
    return 4 * floats


def _fac_fits(n_p: int, m_p: int) -> bool:
    """Whether "fac" takes a QP of this shape (``factored_fits``): no block
    of a cluster would own fewer than no rows of As (m_p >= 7 ceil(m_p /
    8): the kernel does not clamp its slices), its layout fits a block's
    shared memory at every rows a group it may run (1 on one block; 1, 4
    and 16 on a cluster), and n_p <= 256."""
    cl = _fac_blocks(n_p, m_p)
    if n_p > _FAC_MAX_SLICE or m_p < (cl - 1) * -(-m_p // cl):
        return False
    return all(_fac_smem_bytes(n_p, m_p, rc) <= _FAC_SMEM_LIMIT
               for rc in ((1,) if cl == 1 else (1, 4, 16)))


_PATH_CODES = {"smem": 1, "l2": 2, "fac": 3}


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
    """Compile the kernel's sources (``csrc/admm_kernel.cu``,
    ``csrc/admm_factored.cu``; one ``nvcc`` a source, side by side) and
    link them into one library, unless one built from the same sources and
    flags exists.  Returns ``(library path, compiler log)``; the log (ptxas
    register/shared-memory report) is empty on a cache hit."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _SRCS:
        with open(path, "rb") as f:
            digest.update(f.read())
    lib = os.path.join(_BUILD_DIR,
                       f"libadmm_kernel_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    nvcc = _find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=_BUILD_DIR)
    try:
        objs = [os.path.join(tmp_dir, os.path.basename(p) + ".o")
                for p in _SRCS]
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(_SRCS, objs)]
        log = ""
        for p, proc in zip(_SRCS, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}) "
                                   f"building {p}:\n{out}")
        tmp = os.path.join(tmp_dir, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) linking "
                               f"{lib}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib, log + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    lib = ctypes.CDLL(path)
    # 23 pointers, B, n, m, nt, iters, Kinv, sigma[, path], device, stream
    args = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.rtmpc_admm_solve_f32.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    lib.rtmpc_admm_solve_f32_on_path.argtypes = (
        args + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.rtmpc_admm_path.argtypes = [ctypes.c_int] * 3
    lib.rtmpc_admm_rows_per_group.argtypes = [ctypes.c_int] * 3
    for fn in (lib.rtmpc_admm_solve_f32, lib.rtmpc_admm_solve_f32_on_path,
               lib.rtmpc_admm_path, lib.rtmpc_admm_rows_per_group):
        fn.restype = ctypes.c_int
    return lib


def kernel_path(n_cols: int, B: Optional[int] = None,
                n_p: Optional[int] = None) -> str:
    """The kernel path that takes a launch of ``B`` rows of a QP ``n_cols =
    n_p + m_p`` wide, as the C dispatch picks it (``admm_path``; with
    ``B``, ``n_p`` is needed too); without ``B``, the composite path of
    that width (``"smem"`` up to 192 columns, ``"l2"`` up to 2048).
    Raises ``ValueError`` above 2048 columns."""
    for path, limit in _PATH_LIMITS:
        if n_cols <= limit:
            break
    else:
        raise ValueError(f"admm_solve_cuda: n_p + m_p = {n_cols} exceeds "
                         f"the kernel's {_PATH_LIMITS[-1][1]} columns")
    if B is None:
        return path
    if n_p is None or not 0 < n_p < n_cols:
        raise ValueError(f"kernel_path: a launch's path needs n_p (0 < n_p "
                         f"< {n_cols}), got {n_p}")
    if ((B <= FAC_MAX_B or n_cols > FAC_WIDE_COLS)
            and _fac_fits(n_p, n_cols - n_p)):
        return "fac"
    return path


def kernel_rows(n_p: int, m_p: int, B: Optional[int] = None) -> int:
    """Batch rows that one thread block (path ``"smem"``), one cluster
    (``"l2"``) or one group of ``"fac"`` (1, 4 or 16, chosen from B) owns
    for a launch of ``B`` rows at this shape (without ``B``: the composite
    path of the width): a batch that is no multiple of it has a masked
    tail.  Builds the kernel, so it needs the CUDA toolkit."""
    kernel_path(n_p + m_p)
    return int(_library().rtmpc_admm_rows_per_group(n_p, m_p, B or 0))


def _synthetic_spec(n_p: int, m_p: int, ntheta: int = 4, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> ADMMSpec:
    """A random, feasible box-QP of any shape in the solver's prepared
    form (float64 NumPy, then cast), for holding the kernel to its plain
    version at widths no ported controller has: unit-scale strictly convex
    cost, dense constraint rows of unit norm, every eighth row an equality
    (rho 1000 times larger there, as ``prepare_admm`` sets it), bounds that
    contain the origin."""
    rng = np.random.default_rng(seed)
    n, m = n_p, m_p
    F = rng.standard_normal((n, n)) / np.sqrt(n)
    Ps = np.eye(n) + 0.5 * F @ F.T
    As = rng.standard_normal((m, n))
    As /= np.linalg.norm(As, axis=1, keepdims=True)
    is_eq = np.arange(m) % 8 == 0
    rho = np.where(is_eq, 500.0, 0.5)
    sigma, alpha = 1e-6, 1.6
    Kinv = np.linalg.inv(Ps + sigma * np.eye(n) + (As.T * rho) @ As)
    u0 = np.where(is_eq, 0.0, rng.uniform(0.05, 0.5, m))
    l0 = np.where(is_eq, 0.0, -rng.uniform(0.05, 0.5, m))
    Mb = np.where(is_eq[:, None], 0.0,
                  0.01 * rng.standard_normal((m, ntheta)))
    M1, M2 = sigma * Kinv, Kinv @ As.T

    def tensor(a):
        return torch.tensor(np.array(a, order="C"), dtype=dtype,
                            device=device)

    return ADMMSpec(
        Kinv=tensor(Kinv), Ps=tensor(Ps), As=tensor(As), rho=tensor(rho),
        rho_inv=tensor(1.0 / rho), q0=tensor(rng.standard_normal(n)),
        Mq=tensor(rng.standard_normal((n, ntheta))), l0=tensor(l0),
        Ml=tensor(Mb), u0=tensor(u0), Mu=tensor(Mb),
        D=tensor(rng.uniform(0.5, 2.0, n)), E=tensor(np.ones(m)),
        cinv=tensor(1.0), sigma=tensor(sigma), alpha=tensor(alpha),
        Gxc=tensor(np.concatenate([M1.T, (As @ M1).T], axis=1)),
        Gsc=tensor(np.concatenate([M2.T, (As @ M2).T], axis=1)),
        Kcat=tensor(np.concatenate([Kinv.T, Kinv.T @ As.T], axis=1)))


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


def _admm_solve_factored_plain(spec: ADMMSpec, theta: torch.Tensor,
                               state: Optional[ADMMState] = None,
                               iters: int = 100) -> ADMMSolution:
    """The ``"fac"`` path's function in plain PyTorch: ``ops/qp.py:
    admm_solve``'s fixed-count iteration with ``q Kinv'`` hoisted, ``xt =
    (sigma x + (rho z - y) As) Kinv' - q Kinv'``, ``zt = xt As'``.  Up to
    Where the kernel runs one row a group (``_fac_one_row``) the
    intermediates of a float32 spec are float64 (the state and the operator
    stay float32), as the kernel computes them there."""
    theta = theta.to(spec.q0.dtype)
    if state is None:
        state = init_admm_state(spec, theta.shape[0])
    q, l, u = problem_vectors(spec, theta)
    # intermediates' type; contiguous transposes: a product with a
    # transposed view rounds differently at different batch sizes on the
    # CPU, these do not
    wide = spec.Kinv.dtype == torch.float32 and _fac_one_row(
        theta.shape[0], spec.Kinv.shape[0], spec.As.shape[0])
    it = torch.float64 if wide else spec.Kinv.dtype
    KT = spec.Kinv.T.contiguous().to(it)
    As, AsT = spec.As.to(it), spec.As.T.contiguous().to(it)
    rho, rho_inv = spec.rho.to(it), spec.rho_inv.to(it)
    qk = q.to(it) @ KT
    alpha, sigma = spec.alpha, spec.sigma.to(it)
    beta = (1.0 - spec.alpha).to(it)
    x, y, z = state
    for _ in range(iters):
        s = rho * z.to(it) - y.to(it)
        xt = (sigma * x.to(it) + s @ As) @ KT - qk
        zt = xt @ AsT
        x_new = alpha.to(it) * xt + beta * x.to(it)
        z_mix = alpha.to(it) * zt + beta * z.to(it)
        z_new = torch.minimum(torch.maximum(z_mix + y.to(it) * rho_inv,
                                            l.to(it)), u.to(it))
        y = (y.to(it) + rho * (z_mix - z_new)).to(x.dtype)
        x, z = x_new.to(y.dtype), z_new.to(y.dtype)
    x_, y_, z_ = x.to(it), y.to(it), z.to(it)
    r_prim = (x_ @ AsT - z_).abs().amax(dim=1).to(x.dtype)
    r_dual = (x_ @ spec.Ps.T.to(it) + q.to(it) + y_ @ As).abs().amax(
        dim=1).to(x.dtype)
    return ADMMSolution(z_primal=spec.D * x, state=ADMMState(x, y, z),
                        r_prim=r_prim, r_dual=r_dual)


def _plain_for(path: str):
    return _admm_solve_factored_plain if path == "fac" else \
        _admm_solve_cuda_plain


def _spec_path(spec: ADMMSpec, B: int) -> str:
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    return kernel_path(n_p + m_p, B, n_p)


def _admm_solve_plain(spec: ADMMSpec, theta: torch.Tensor,
                      state: Optional[ADMMState] = None,
                      iters: int = 100) -> ADMMSolution:
    """The plain version of the path the card takes for this launch (what
    ``admm_solve_cuda`` runs on CPU tensors, and what the kernel is held
    to on the card)."""
    return _plain_for(_spec_path(spec, theta.shape[0]))(spec, theta, state,
                                                        iters)


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

    CPU tensors run the plain PyTorch version of the path the card would
    take.  CUDA tensors (float32, contiguous) launch the kernel on the path
    of the dispatch or raise; there is no fallback."""
    if theta.device.type == "cpu":
        return _admm_solve_plain(spec, theta, state, iters)
    return _launch(spec, theta, state, iters, None)


def _admm_solve_cuda_on_path(spec: ADMMSpec, theta: torch.Tensor,
                             state: Optional[ADMMState], iters: int,
                             path: str) -> ADMMSolution:
    """``admm_solve_cuda`` on a path the caller names, for timing one path
    against another at the same shape (a composite path only at the
    widths the dispatch gives it, ``"fac"`` only where its operator fits);
    CUDA tensors only.  Not on the main path."""
    return _launch(spec, theta, state, iters, path)


def _launch(spec, theta, state, iters, path):
    if theta.device.type != "cuda":
        raise ValueError(f"admm_solve_cuda: unsupported device {theta.device}")
    dev = theta.device
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    nm = n_p + m_p
    if theta.dim() != 2:
        raise ValueError("admm_solve_cuda: theta must be (B, ntheta)")
    B, nt = theta.shape
    dispatched = _spec_path(spec, B)
    path = path or dispatched
    if iters < 0:
        raise ValueError("admm_solve_cuda: iters must be >= 0")
    if state is None:
        state = init_admm_state(spec, B)
    shapes = {"Gxc": (n_p, nm), "Gsc": (m_p, nm), "Kcat": (n_p, nm),
              "As": (m_p, n_p), "Ps": (n_p, n_p), "Mq": (n_p, nt),
              "Ml": (m_p, nt), "Mu": (m_p, nt), "q0": (n_p,), "l0": (m_p,),
              "u0": (m_p,), "rho": (m_p,), "rho_inv": (m_p,), "alpha": (),
              "D": (n_p,), "Kinv": (n_p, n_p), "sigma": ()}
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
        args = (*ptrs, B, n_p, m_p, nt, iters, spec.Kinv.data_ptr(),
                spec.sigma.data_ptr())
        with span("k1"):
            if path == dispatched:
                rc = lib.rtmpc_admm_solve_f32(*args, dev.index or 0, stream)
            else:
                rc = lib.rtmpc_admm_solve_f32_on_path(
                    *args, _PATH_CODES[path], dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"admm_solve_cuda: kernel launch failed with "
                               f"CUDA error {rc} (path {path})")
        admm_solve_cuda.launches += 1
        admm_solve_cuda.launches_by_path[path] += 1
    return ADMMSolution(z_primal=x_o * spec.D, state=ADMMState(x_o, y_o, z_o),
                        r_prim=rp, r_dual=rd)


admm_solve_cuda.launches = 0
admm_solve_cuda.launches_by_path = {path: 0 for path in _PATH_CODES}
