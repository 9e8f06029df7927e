"""Controller setup of the flagship tube-tracking MPC (counterpart of
``rtmpc_tpu/models/specs.py``).

The host setup is float64 NumPy code, statement for statement the JAX
package's, built on the port's own ``utils`` (polytopes, synthesis) and
``sets`` (mRPI, Gilbert-Tan sets, tightening), so the port and the JAX
package freeze bit-identical problem data without the port importing
anything of ``rtmpc_tpu``.  ``MPCSetup.to_device``
freezes it into ``ControllerArrays`` (tensors) and ``ControllerConfig``
(static metadata) for the rollout engine.

Ported so far: the tube-tracking variant (``TubeTrackingMPC.py``, the
flagship of ``bench.py`` and the robust arm of the Results apps) and the
tracking variant (``TrackingMPC.py``, the non-robust arm).  The regulator
variants, the extended (packet-received) problem and condensed templates
are not ported yet.

``arrays_from_numpy`` bridges the other way: it builds the port's arrays
from the JAX package's ``ControllerArrays`` converted to numpy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..sets.invariant import (determine_mrpi, max_admissible_set,
                              tighten_constraints)
from ..utils.polytope import Polytope, box
from ..utils.synthesis import dlqr, dlyap
from ..ops.assembly import QPTemplate, build_mpc_qp
from ..ops.precision import DEFAULT_DTYPE
from ..ops.ip_riccati import RiccatiIPSpec, prepare_ip_riccati
from ..ops.qp import PAD_TO, ADMMSpec, prepare_admm
from ..tree import tree_to

__all__ = ["MPCSetup", "ControllerArrays", "ControllerConfig",
           "setup_tracking", "setup_tube_tracking", "flagship_setup",
           "arrays_from_numpy", "spec_from_numpy", "ric_spec_from_numpy",
           "SOLVERS"]

# "admm": batched PyTorch ADMM (ops/qp.py); "cuda": the fused CUDA kernel
# (ops/qp_cuda.py), which runs its plain PyTorch version on CPU tensors;
# "ip_riccati": the structured interior point (ops/ip_riccati.py).
SOLVERS = ("admm", "cuda", "ip_riccati")

# The JAX package places the [xt | zt] output slots of its composites at
# 128-lane boundaries for the TPU (rtmpc_tpu/ops/qp.py:272-286).
_TPU_LANE = 128


@dataclasses.dataclass
class MPCSetup:
    """Everything the setup phase produces, in float64 on the host."""
    kind: str
    A: np.ndarray
    B: np.ndarray
    Q: np.ndarray
    R: np.ndarray
    N: int
    K: Optional[np.ndarray] = None          # steady-state (LQR) gain
    P: Optional[np.ndarray] = None          # terminal cost
    Tout: Optional[np.ndarray] = None       # offset cost (10 P)
    K_ancillary: Optional[np.ndarray] = None
    X: Optional[Polytope] = None
    U: Optional[Polytope] = None
    W: Optional[Polytope] = None
    Z: Optional[Polytope] = None            # mRPI tube cross-section
    Xc: Optional[Polytope] = None
    Uc: Optional[Polytope] = None
    Xf: Optional[Polytope] = None           # terminal set
    template: Optional[QPTemplate] = None
    fixed_initial_state: bool = False
    lambda_param: float = 0.99999

    @property
    def nx(self) -> int:
        return self.A.shape[1]

    @property
    def nu(self) -> int:
        return self.B.shape[1]

    def ancillary_gain(self) -> np.ndarray:
        """``get_ancillary_controller_gain`` (``TubeTrackingMPC.py:233-238``)."""
        return self.K if self.K_ancillary is None else self.K_ancillary

    def to_device(self, dtype: torch.dtype = DEFAULT_DTYPE, device="cpu",
                  iters: int = 100, iters2: int = 0, rho2_scale: float = 0.1,
                  alpha: float = 1.6, solver: str = "admm",
                  ip_iters: int = 25):
        """Freeze into ``(ControllerArrays, ControllerConfig)``.

        ``solver`` is one of ``SOLVERS``.  The ADMM solvers get the JAX
        package's preparation: rho is tuned at ``max(100, min(iters +
        iters2, 600))`` iterations, and ``iters2 > 0`` adds the phase-2
        spec at ``rho * rho2_scale``.  Solver "ip_riccati" gets the
        structured IP's spec (``arrays.ric``) from the uncondensed template
        and runs at most ``ip_iters`` iterations a solve; it builds no
        ADMM spec (``arrays.admm`` is None).
        """
        if solver not in SOLVERS:
            raise NotImplementedError(
                f"solver {solver!r} is not ported yet (ported: {SOLVERS})")
        tmpl = self.template
        admm = admm2 = ric = None
        if solver == "ip_riccati":
            ric = prepare_ip_riccati(tmpl, dtype=dtype, device=device)
        else:
            tune_iters = max(100, min(iters + iters2, 600))
            r2s = rho2_scale if iters2 > 0 else None
            admm = prepare_admm(tmpl, alpha=alpha, dtype=dtype,
                                device=device, tune_iters=tune_iters,
                                rho2_scale=r2s)
            admm, admm2 = admm if iters2 > 0 else (admm, admm)

        # tube cross-section H-rep for membership checks, padded; a setup
        # without a tube gets one dummy row
        if self.Z is not None:
            Hz, hz = self.Z.A, self.Z.b
        else:
            Hz, hz = np.zeros((1, self.nx)), np.ones(1)
        mz = ((Hz.shape[0] + PAD_TO - 1) // PAD_TO) * PAD_TO
        Hz_p = np.zeros((mz, self.nx))
        hz_p = np.ones(mz)
        Hz_p[:Hz.shape[0]] = Hz
        hz_p[:hz.shape[0]] = hz

        def tensor(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        Kp = (self.ancillary_gain() if self.kind.startswith("tube")
              else self.K)
        arrays = ControllerArrays(
            admm=admm, admm2=admm2,
            A=tensor(self.A), B=tensor(self.B),
            K_ss=tensor(self.K), K_plant=tensor(Kp),
            Hz=tensor(Hz_p), hz=tensor(hz_p), ric=ric)
        return arrays, _config(self.nx, self.nu, self.N, tmpl, iters, iters2,
                               solver, ip_iters)


class ControllerArrays(NamedTuple):
    """Everything the per-step function reads, as tensors."""
    admm: Optional[ADMMSpec]   # phase-1 spec (None under solver ip_riccati)
    admm2: Optional[ADMMSpec]  # phase-2 spec (alias of admm when iters2 == 0)
    A: torch.Tensor            # (nx, nx) plant/nominal model
    B: torch.Tensor            # (nx, nu)
    K_ss: torch.Tensor         # (nu, nx) steady-state gain (terminal law)
    K_plant: torch.Tensor      # (nu, nx) ancillary gain
    Hz: torch.Tensor           # (mz_p, nx) tube H-rep (padded)
    hz: torch.Tensor           # (mz_p,)
    ric: Optional[RiccatiIPSpec] = None   # structured IP (solver ip_riccati)

    def to(self, device) -> "ControllerArrays":
        return tree_to(self, device)


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Static metadata of the rollout engine."""
    nx: int
    nu: int
    N: int
    n: int                     # QP variables (unpadded)
    tracking: bool
    iters: int                 # phase-1 ADMM iterations
    iters2: int                # phase-2 ADMM iterations (0 = one phase)
    solver: str
    u_off: int                 # offset of u_0 in the QP variable layout
    xbar_off: int              # offset of the artificial steady state xbar
    ubar_off: int              # offset of ubar
    ip_iters: int = 25         # interior-point iteration cap (ip_riccati)


def _config(nx, nu, N, tmpl, iters, iters2, solver,
            ip_iters) -> ControllerConfig:
    return ControllerConfig(
        nx=nx, nu=nu, N=N, n=tmpl.n, tracking=tmpl.tracking,
        iters=iters, iters2=iters2, solver=solver, ip_iters=ip_iters,
        u_off=nx * (N + 1),
        xbar_off=nx * (N + 1) + nu * N,
        ubar_off=nx * (N + 1) + nu * N + nx)


def _np_tensor(a, dtype, device):
    return torch.tensor(np.array(a, order="C"), dtype=dtype, device=device)


def spec_from_numpy(np_spec, dtype: torch.dtype = torch.float64,
                    device="cpu") -> ADMMSpec:
    """The port's ``ADMMSpec`` from one of the JAX package's, given as
    numpy leaves: the TPU's 128-lane output slots of ``Gxc``/``Gsc``/``Kcat``
    are cut down to the compact ``(., n_p + m_p)`` composites."""
    n_p, m_p = np_spec.Kinv.shape[0], np_spec.As.shape[0]
    nblk = -(-n_p // _TPU_LANE) * _TPU_LANE

    def leaf(f):
        a = np.asarray(getattr(np_spec, f))
        if f in ("Gxc", "Gsc", "Kcat"):
            a = np.concatenate([a[:, :n_p], a[:, nblk:nblk + m_p]], axis=1)
        return _np_tensor(a, dtype, device)

    return ADMMSpec(**{f: leaf(f) for f in ADMMSpec._fields})


def ric_spec_from_numpy(np_spec, dtype: torch.dtype = torch.float64,
                        device="cpu") -> RiccatiIPSpec:
    """The port's ``RiccatiIPSpec`` from the JAX package's, given as numpy
    leaves (the fields are the same)."""
    return RiccatiIPSpec(**{f: _np_tensor(getattr(np_spec, f), dtype, device)
                            for f in RiccatiIPSpec._fields})


def arrays_from_numpy(np_arrays, dtype: torch.dtype = torch.float64,
                      device="cpu") -> ControllerArrays:
    """The port's ``ControllerArrays`` from the JAX package's, given as
    numpy leaves (``jax.tree_util.tree_map(np.asarray, arrays)``).

    Keeps ``admm``/``admm2`` (through ``spec_from_numpy``), ``ric`` where
    the JAX package built one, and the model matrices; drops the dense
    interior point's ``ip``."""
    def tensor(a):
        return _np_tensor(a, dtype, device)

    return ControllerArrays(
        admm=spec_from_numpy(np_arrays.admm, dtype, device),
        admm2=spec_from_numpy(np_arrays.admm2, dtype, device),
        A=tensor(np_arrays.A), B=tensor(np_arrays.B),
        K_ss=tensor(np_arrays.K_ss), K_plant=tensor(np_arrays.K_plant),
        Hz=tensor(np_arrays.Hz), hz=tensor(np_arrays.hz),
        ric=(None if np_arrays.ric is None
             else ric_spec_from_numpy(np_arrays.ric, dtype, device)))


# ---------------------------------------------------------------------------
# Gain/terminal-cost synthesis and the tube-tracking variant
# ---------------------------------------------------------------------------

def _lqr_terminal(A, B, Q, R):
    """K, P, Acl exactly as the reference (``TrackingMPC.py:25-31``):
    ``K`` from dlqr; ``P = dlyap(Acl, sym(Q + K'RK))``."""
    K, _, _ = dlqr(A, B, Q, R)
    Qlyap = Q + K.T @ R @ K
    Qlyap = (Qlyap + Qlyap.T) / 2
    Acl = A - B @ K
    P = dlyap(Acl, Qlyap)
    return K, P, Acl


def _augmented_terminal_set(Acl, A, B, K, X: Polytope, U: Polytope,
                            lam: float) -> Polytope:
    """Gilbert-Tan terminal set of the augmented (x, xbar, ubar) system
    (``TubeTrackingMPC.determine_Xf`` :35-61).

    Augmented dynamics  A_e = [[Acl, BK, B], [0, I, 0], [0, 0, I]];
    constraint rows: x in X;  ubar + K(xbar - x) in U;  xbar in lam X;
    ubar in lam U.
    """
    nx = A.shape[1]
    nu = B.shape[1]
    Hx, hx = X.A, X.b
    Hu, hu = U.A, U.b
    A_e = np.block([
        [Acl, B @ K, B],
        [np.zeros((nx, nx)), np.eye(nx), np.zeros((nx, nu))],
        [np.zeros((nu, nx)), np.zeros((nu, nx)), np.eye(nu)],
    ])
    Hcl = np.block([
        [Hx, np.zeros((Hx.shape[0], nx)), np.zeros((Hx.shape[0], nu))],
        [-Hu @ K, Hu @ K, Hu],
        [np.zeros((Hx.shape[0], nx)), Hx, np.zeros((Hx.shape[0], nu))],
        [np.zeros((Hu.shape[0], nx)), np.zeros((Hu.shape[0], nx)), Hu],
    ])
    hcl = np.concatenate([hx, hu, lam * hx, lam * hu])
    return max_admissible_set(A_e, Polytope(Hcl, hcl))


def _tube_common(A, B, Q, R, W, X, U, eps_var, rpi_method, K_ancillary):
    """Shared tube machinery: gains, mRPI (with the ancillary closed loop
    if one is given, ``TubeTrackingMPC.determine_mRPI`` :63-88),
    tightening."""
    K, P, Acl = _lqr_terminal(A, B, Q, R)
    if K_ancillary is not None:
        K_anc = np.atleast_2d(np.asarray(K_ancillary, float))
        Acl_plant = A - B @ K_anc
    else:
        K_anc, Acl_plant = K, Acl
    Z = determine_mrpi(Acl_plant, W, X=X, U=U, K=K_anc,
                       eps_var=eps_var, rpi_method=rpi_method)
    Xc, Uc = tighten_constraints(X, U, Z, K_anc)
    return K, P, Acl, K_anc, Z, Xc, Uc


def setup_tracking(A, B, Q, R, N, X: Polytope, U: Polytope,
                   lambda_param: float = 0.99999) -> MPCSetup:
    """TrackingMPC (Limon 2008 / Pezzutto 2022, ``TrackingMPC.py``):
    artificial steady state, Lyapunov terminal cost, Gilbert-Tan augmented
    terminal set, fixed initial state; no tube."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    K, P, Acl = _lqr_terminal(A, B, Q, R)
    Tout = 10 * P
    Xf = _augmented_terminal_set(Acl, A, B, K, X, U, lambda_param)
    tmpl = build_mpc_qp(
        A, B, Q, R, N, tracking=True, P_term=P, Tout=Tout,
        Hx=X.A, hx=X.b, Hu=U.A, hu=U.b,
        HxN=Xf.A, hxN=Xf.b, terminal_augmented=True, init_mode="fixed")
    return MPCSetup(kind="tracking", A=A, B=B, Q=Q, R=R, N=int(N), K=K, P=P,
                    Tout=Tout, X=X, U=U, Xf=Xf, template=tmpl,
                    fixed_initial_state=True, lambda_param=lambda_param)


def setup_tube_tracking(A, B, Q, R, N, X: Polytope, U: Polytope, W: Polytope,
                        fixed_initial_state: bool = False,
                        rpi_method: int = 0, eps_var: float = 1e-4,
                        K_ancillary: Optional[np.ndarray] = None,
                        lambda_param: float = 0.99999) -> MPCSetup:
    """TubeTrackingMPC (Limon 2010 x Umsonst-Barbosa 2024): the flagship."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    K, P, Acl, K_anc, Z, Xc, Uc = _tube_common(
        A, B, Q, R, W, X, U, eps_var, rpi_method, K_ancillary)
    Tout = 10 * P
    Xf = _augmented_terminal_set(Acl, A, B, K, Xc, Uc, lambda_param)
    tmpl = build_mpc_qp(
        A, B, Q, R, N, tracking=True, P_term=P, Tout=Tout,
        Hx=Xc.A, hx=Xc.b, Hu=Uc.A, hu=Uc.b,
        HxN=Xf.A, hxN=Xf.b, terminal_augmented=True,
        init_mode="fixed" if fixed_initial_state else "tube",
        Hz=Z.A, hz=Z.b)
    return MPCSetup(kind="tube_tracking", A=A, B=B, Q=Q, R=R, N=int(N),
                    K=K, P=P, Tout=Tout,
                    K_ancillary=None if K_ancillary is None else K_anc,
                    X=X, U=U, W=W, Z=Z, Xc=Xc, Uc=Uc, Xf=Xf, template=tmpl,
                    fixed_initial_state=fixed_initial_state,
                    lambda_param=lambda_param)


def flagship_setup() -> MPCSetup:
    """The flagship controller of ``bench.py`` (the configuration of
    ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network``): double
    integrator, N=10, X=+-8, U=+-1, W=+-0.1, fixed initial state."""
    return setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
