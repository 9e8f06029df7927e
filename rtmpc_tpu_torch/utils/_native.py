"""ctypes binding for the native batched-LP library (``native/rtmpc_lp.cpp``).

The port's own binding of the same C++ source the JAX package uses for its
host setup.  The shared library is built on first use with ``g++`` (single
translation unit, the flags of ``native/Makefile``; with OpenMP where the
toolchain has it, else without: the LPs of a batch are independent, so the
answers are the same) into ``build/rtmpc_tpu_torch/`` next to the package,
under a file name that carries the source's hash, so the two packages never
write one ``.so`` and concurrent processes never load a half-written one
(the build goes to a temporary file that is renamed into place).  Set
``RTMPC_NO_NATIVE=1`` to switch it off.

If the toolchain or the build is unavailable, ``native_available()``
returns False and the callers solve the same LPs with scipy/HiGHS.  That is
a choice between two host solvers of the setup phase (float64 NumPy, run
once per scenario); it is no fallback of a device path or of a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "rtmpc_lp.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "rtmpc_tpu_torch")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build(so: str, src_hash: str) -> bool:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        for omp in (("-fopenmp",), ()):
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *_CXXFLAGS, *omp,
                     f'-DRTMPC_SRC_HASH="{src_hash}"', "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, so)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open_if_current(so: str, want_hash: str) -> Optional[ctypes.CDLL]:
    """dlopen the library only if its embedded source hash is ``want_hash``."""
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.rtmpc_src_hash.restype = ctypes.c_char_p
        got = lib.rtmpc_src_hash().decode()
    except (OSError, AttributeError):
        return None
    return lib if got == want_hash else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("RTMPC_NO_NATIVE"):
            return None
        if not os.path.exists(_SRC):
            return None
        want = _src_hash()
        so = os.path.join(_BUILD_DIR, f"librtmpc_lp_{want[:16]}.so")
        lib = _open_if_current(so, want)
        if lib is None:
            if not _build(so, want):
                return None
            lib = _open_if_current(so, want)
            if lib is None:
                return None
        lib.rtmpc_support_batch.restype = ctypes.c_int
        lib.rtmpc_support_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),   # A
            ctypes.POINTER(ctypes.c_double),   # b
            ctypes.c_int, ctypes.c_int,        # m, n
            ctypes.POINTER(ctypes.c_double),   # C
            ctypes.c_int,                      # k
            ctypes.POINTER(ctypes.c_double),   # h out
            ctypes.POINTER(ctypes.c_int),      # status out
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def support_batch_native(A: np.ndarray, b: np.ndarray,
                         C: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``h[j] = max{C[j]@y : A y <= b}`` for all rows of C.

    Returns ``(h, status)`` with status 0 = optimal, 1 = unbounded
    (``h = +inf``), 2 = infeasible/failed (``h = NaN``).  Raises
    ``RuntimeError`` if the native library is unavailable: call
    ``native_available()`` first.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native LP library unavailable")
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1)
    C = np.ascontiguousarray(np.atleast_2d(C), dtype=np.float64)
    m, n = A.shape
    k = C.shape[0]
    assert C.shape[1] == n and b.shape[0] == m
    h = np.empty(k, dtype=np.float64)
    status = np.empty(k, dtype=np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rtmpc_support_batch(
        A.ctypes.data_as(dp), b.ctypes.data_as(dp),
        ctypes.c_int(m), ctypes.c_int(n),
        C.ctypes.data_as(dp), ctypes.c_int(k),
        h.ctypes.data_as(dp), status.ctypes.data_as(ip))
    return h, status
