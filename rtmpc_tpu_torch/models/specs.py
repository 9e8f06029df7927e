"""Controller setup of the flagship tube-tracking MPC (counterpart of
``rtmpc_tpu/models/specs.py``).

The host setup is float64 NumPy code, statement for statement the JAX
package's, built on the port's own ``utils`` (polytopes, synthesis) and
``sets`` (mRPI, Gilbert-Tan sets, tightening), so the port and the JAX
package freeze bit-identical problem data without the port importing
anything of ``rtmpc_tpu``.  ``MPCSetup.to_device``
freezes it into ``ControllerArrays`` (tensors) and ``ControllerConfig``
(static metadata) for the rollout engine.

All five of the reference's controller variants: the regulator
(``RegulatorMPC.py``), the tube regulator (``TubeRegulatorMPC.py``,
Mayne 2005), the tube-tracking variant (``TubeTrackingMPC.py``, the
flagship of ``bench.py`` and the robust arm of the Results apps), the
tracking variant (``TrackingMPC.py``, the non-robust arm) and the extended
tube-tracking variant (``ExtendedTubeTrackingMPC``, paper Section IV.F: a
second, packet-received QP whose initial tube is ``Z - W``).  Invalid
arguments raise ``ValueError`` (the reference asserts).

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
from ..utils.polytope import Polytope, box, pont_diff
from ..utils.synthesis import dlqr, dlyap
from ..ops.assembly import QPTemplate, build_mpc_qp, condense_template
from ..ops.precision import DEFAULT_DTYPE
from ..ops.ip import IPSpec, prepare_ip
from ..ops.ip_riccati import RiccatiIPSpec, prepare_ip_riccati
from ..ops.qp import PAD_TO, ADMMSpec, prepare_admm
from ..tree import tree_to

__all__ = ["MPCSetup", "ControllerArrays", "ControllerConfig",
           "setup_regulator", "setup_tracking", "setup_tube_regulator",
           "setup_tube_tracking", "setup_extended_tube_tracking",
           "flagship_setup", "arrays_from_numpy", "spec_from_numpy",
           "ric_spec_from_numpy", "ip_spec_from_numpy", "SOLVERS"]

# "admm": batched PyTorch ADMM (ops/qp.py); "cuda": the fused CUDA kernel
# (ops/qp_cuda.py), which runs its plain PyTorch version on CPU tensors;
# "ip": the dense interior point (ops/ip.py); "ip_riccati": the structured
# interior point (ops/ip_riccati.py); "ip_hybrid": the structured interior
# point in float32, then a short float64 phase from its iterate.
SOLVERS = ("admm", "cuda", "ip", "ip_riccati", "ip_hybrid")
# the solvers that run the structured interior point
RIC_SOLVERS = ("ip_riccati", "ip_hybrid")

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
    template_pr: Optional[QPTemplate] = None  # extended: packet-received QP
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
                  ip_iters: int = 25, polish: bool = False,
                  probe_thetas: Optional[np.ndarray] = None,
                  condensed: bool = False, ip_hybrid_iters: int = 12,
                  early_tol: Optional[float] = None,
                  early_dual_factor: float = 25.0, check_every: int = 25):
        """Freeze into ``(ControllerArrays, ControllerConfig)``.

        ``solver`` is one of ``SOLVERS``.  The ADMM solvers get the JAX
        package's preparation: rho is tuned at ``max(100, min(iters +
        iters2, 600))`` iterations on ``probe_thetas`` (``prepare_admm``'s
        default probes if None), ``iters2 > 0`` adds the phase-2 spec at
        ``rho * rho2_scale``, and ``polish`` polishes the last phase's
        primal (``ops/qp.py:apply_polish``).  Solver "ip" gets the dense
        interior point's spec (``arrays.ip``), solver "ip_riccati" the
        structured IP's (``arrays.ric``) from the uncondensed template;
        both run at most ``ip_iters`` iterations a solve and build no ADMM
        spec (``arrays.admm`` is None); ``polish`` does nothing there, as
        in the JAX package.  Solver "ip_hybrid" runs the structured IP at
        most ``ip_iters`` iterations in float32, then at most
        ``ip_hybrid_iters`` in float64 (``ip_riccati_solve_hybrid``): its
        ``arrays.ric`` is float64 whatever ``dtype`` is, as in the JAX
        package.

        ``early_tol``: the ADMM's residual early exit (``admm_solve``), with
        ``early_dual_factor`` and ``check_every``, on the last ADMM phase
        of a step.  Solver "cuda" refuses it (``ValueError``): the kernel
        runs a fixed count, as the JAX package's Pallas path does.

        An extended setup (``template_pr`` set) also gets the
        packet-received QP's specs, ``admm_pr``/``admm2_pr``, ``ip_pr`` or
        ``ric_pr``, prepared from ``template_pr`` on its own (its rho is
        tuned on its own); any other setup keeps them None.

        ``condensed`` solves the state-eliminated templates
        (``ops/assembly.py:condense_template``) under "admm", "cuda" and
        "ip": ``arrays.S_rec`` (``S_rec_pr``) maps a solution's first
        ``cfg.n_red`` (``n_red_pr``) entries back to the full layout.  The
        structured interior point needs the stage structure and refuses
        it (``ValueError``), as the JAX package does.
        """
        if solver not in SOLVERS:
            raise NotImplementedError(
                f"solver {solver!r} has no counterpart in the port (its "
                f"solvers: {SOLVERS}; the Pallas kernel's is 'cuda')")
        if condensed and solver in RIC_SOLVERS:
            raise ValueError(f"solver {solver!r} needs the uncondensed "
                             "template (its Riccati sweep is over the stage "
                             "variables)")
        if solver == "cuda" and early_tol is not None:
            raise ValueError("solver 'cuda' has no early exit: the kernel "
                             "runs a fixed iteration count (as the JAX "
                             "package's Pallas path); use solver 'admm' "
                             "for early_tol")
        tmpl, tmpl_pr = self.template, self.template_pr
        if condensed:
            tmpl = condense_template(tmpl)
            if tmpl_pr is not None:
                tmpl_pr = condense_template(tmpl_pr)

        def prepare(t):
            """``(admm, admm2, ip, ric)`` of one template (None: all
            None)."""
            if t is None:
                return None, None, None, None
            if solver == "ip":
                return None, None, prepare_ip(t, dtype=dtype,
                                              device=device), None
            if solver in RIC_SOLVERS:
                return None, None, None, prepare_ip_riccati(
                    t, dtype=(torch.float64 if solver == "ip_hybrid"
                              else dtype), device=device)
            spec = prepare_admm(
                t, alpha=alpha, dtype=dtype, device=device,
                tune_iters=max(100, min(iters + iters2, 600)),
                rho2_scale=rho2_scale if iters2 > 0 else None,
                probe_thetas=probe_thetas)
            return (*(spec if iters2 > 0 else (spec, spec)), None, None)

        admm, admm2, ip, ric = prepare(tmpl)
        admm_pr, admm2_pr, ip_pr, ric_pr = prepare(tmpl_pr)

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

        # a regulator has no steady-state gain: its terminal law is zero
        K = self.K if self.K is not None else np.zeros((self.nu, self.nx))
        Kp = self.ancillary_gain() if self.kind.startswith("tube") else K
        arrays = ControllerArrays(
            admm=admm, admm2=admm2,
            A=tensor(self.A), B=tensor(self.B),
            K_ss=tensor(K), K_plant=tensor(Kp),
            Hz=tensor(Hz_p), hz=tensor(hz_p), ric=ric,
            admm_pr=admm_pr, admm2_pr=admm2_pr, ric_pr=ric_pr,
            ip=ip, ip_pr=ip_pr,
            S_rec=tensor(tmpl.S) if condensed else None,
            S_rec_pr=(tensor(tmpl_pr.S) if condensed and tmpl_pr is not None
                      else None))
        cfg = _config(self.nx, self.nu, self.N, self.template, iters, iters2,
                      solver, ip_iters, polish=polish,
                      extended=self.template_pr is not None)
        cfg = dataclasses.replace(
            cfg, ip_hybrid_iters=ip_hybrid_iters, early_tol=early_tol,
            early_dual_factor=early_dual_factor, check_every=check_every)
        if condensed:
            cfg = dataclasses.replace(
                cfg, n_red=tmpl.n,
                n_red_pr=tmpl_pr.n if tmpl_pr is not None else 0)
        return arrays, cfg


class ControllerArrays(NamedTuple):
    """Everything the per-step function reads, as tensors."""
    admm: Optional[ADMMSpec]   # phase-1 spec (None under the IP solvers)
    admm2: Optional[ADMMSpec]  # phase-2 spec (alias of admm when iters2 == 0)
    A: torch.Tensor            # (nx, nx) plant/nominal model
    B: torch.Tensor            # (nx, nu)
    K_ss: torch.Tensor         # (nu, nx) steady-state gain (terminal law)
    K_plant: torch.Tensor      # (nu, nx) ancillary gain
    Hz: torch.Tensor           # (mz_p, nx) tube H-rep (padded)
    hz: torch.Tensor           # (mz_p,)
    # structured IP (solvers ip_riccati, ip_hybrid: float64 under the hybrid)
    ric: Optional[RiccatiIPSpec] = None
    # a condensed controller's reduced -> full maps, z_full = S_rec v
    # (``(n, n_red)``; None when the templates are full)
    S_rec: Optional[torch.Tensor] = None
    S_rec_pr: Optional[torch.Tensor] = None
    ip: Optional[IPSpec] = None           # dense IP (solver ip)
    # the packet-received QP of an extended setup (None otherwise)
    ip_pr: Optional[IPSpec] = None
    admm_pr: Optional[ADMMSpec] = None
    admm2_pr: Optional[ADMMSpec] = None
    ric_pr: Optional[RiccatiIPSpec] = None

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
    ubar_off: int              # offset of ubar (both -1 without tracking)
    # interior-point iterations (ip, ip_riccati; the float32 phase of
    # ip_hybrid)
    ip_iters: int = 25
    ip_hybrid_iters: int = 12  # float64 iterations of ip_hybrid
    extended: bool = False     # two QPs picked by the previous step's gamma
    polish: bool = False       # polish the last ADMM phase's primal
    # variables of the condensed QP (the packet-received one's); 0: the
    # QPs are full (``n`` is the full layout's either way)
    n_red: int = 0
    n_red_pr: int = 0
    # the ADMM's residual early exit on a step's last phase (admm_solve):
    # None is the fixed count; the JAX package's defaults
    early_tol: Optional[float] = None
    early_dual_factor: float = 25.0
    check_every: int = 25


def _config(nx, nu, N, tmpl, iters, iters2, solver, ip_iters, polish=False,
            extended=False) -> ControllerConfig:
    return ControllerConfig(
        nx=nx, nu=nu, N=N, n=tmpl.n, tracking=tmpl.tracking,
        iters=iters, iters2=iters2, solver=solver, ip_iters=ip_iters,
        extended=extended, polish=polish,
        u_off=nx * (N + 1),
        xbar_off=(nx * (N + 1) + nu * N) if tmpl.tracking else -1,
        ubar_off=(nx * (N + 1) + nu * N + nx) if tmpl.tracking else -1)


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


def ip_spec_from_numpy(np_spec, dtype: torch.dtype = torch.float64,
                       device="cpu") -> IPSpec:
    """The port's dense-IP ``IPSpec`` from the JAX package's, given as numpy
    leaves (the fields are the same)."""
    return IPSpec(**{f: _np_tensor(getattr(np_spec, f), dtype, device)
                     for f in IPSpec._fields})


def arrays_from_numpy(np_arrays, dtype: torch.dtype = torch.float64,
                      device="cpu") -> ControllerArrays:
    """The port's ``ControllerArrays`` from the JAX package's, given as
    numpy leaves (``jax.tree_util.tree_map(np.asarray, arrays)``).

    Keeps ``admm``/``admm2`` and ``admm_pr``/``admm2_pr`` (through
    ``spec_from_numpy``; the JAX package gives a setup without a
    packet-received QP copies of ``admm``/``admm2`` there), ``ip`` and
    ``ip_pr`` (likewise copies of ``ip`` there), ``ric`` and ``ric_pr``
    where the JAX package built them, and the model matrices."""
    def tensor(a):
        return _np_tensor(a, dtype, device)

    def admm(f):
        return spec_from_numpy(getattr(np_arrays, f), dtype, device)

    def S_or_none(a, dtype, device):
        """The JAX package gives a full controller empty ``(0, 0)`` maps."""
        return _np_tensor(a, dtype, device) if np.size(a) else None

    def spec_or_none(f, convert):
        spec = getattr(np_arrays, f)
        return None if spec is None else convert(spec, dtype, device)

    return ControllerArrays(
        admm=admm("admm"), admm2=admm("admm2"),
        A=tensor(np_arrays.A), B=tensor(np_arrays.B),
        K_ss=tensor(np_arrays.K_ss), K_plant=tensor(np_arrays.K_plant),
        Hz=tensor(np_arrays.Hz), hz=tensor(np_arrays.hz),
        ric=spec_or_none("ric", ric_spec_from_numpy),
        admm_pr=admm("admm_pr"), admm2_pr=admm("admm2_pr"),
        ric_pr=spec_or_none("ric_pr", ric_spec_from_numpy),
        ip=spec_or_none("ip", ip_spec_from_numpy),
        ip_pr=spec_or_none("ip_pr", ip_spec_from_numpy),
        S_rec=spec_or_none("S_rec", S_or_none),
        S_rec_pr=spec_or_none("S_rec_pr", S_or_none))


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


def _checked(A, B, Q, R, N):
    """The model and weights as float64 arrays; raises ``ValueError`` on a
    horizon below 1 or shapes that do not fit together."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    nx, nu = A.shape[0], B.shape[1] if B.ndim == 2 else -1
    if int(N) != N or N < 1:
        raise ValueError(f"the horizon N must be a positive integer, got {N}")
    if A.shape != (nx, nx) or B.shape != (nx, nu) or Q.shape != (nx, nx) \
            or R.shape != (nu, nu):
        raise ValueError(f"A {A.shape}, B {B.shape}, Q {Q.shape} and R "
                         f"{R.shape} do not fit one system")
    return A, B, Q, R


def setup_regulator(A, B, Q, R, N, X: Optional[Polytope] = None,
                    U: Optional[Polytope] = None) -> MPCSetup:
    """RegulatorMPC (``RegulatorMPC.py``): regulate to the origin, no
    terminal ingredients (the reference's own TODO at :74), fixed initial
    state; ``X`` and ``U`` optional."""
    A, B, Q, R = _checked(A, B, Q, R, N)
    tmpl = build_mpc_qp(
        A, B, Q, R, N,
        Hx=None if X is None else X.A, hx=None if X is None else X.b,
        Hu=None if U is None else U.A, hu=None if U is None else U.b,
        init_mode="fixed")
    return MPCSetup(kind="regulator", A=A, B=B, Q=Q, R=R, N=int(N),
                    X=X, U=U, template=tmpl, fixed_initial_state=True)


def setup_tube_regulator(A, B, Q, R, N, X: Polytope, U: Polytope,
                         W: Polytope, eps_var: float = 1.9e-5,
                         rpi_method: int = 0) -> MPCSetup:
    """TubeRegulatorMPC (Mayne 2005, ``TubeRegulatorMPC.py``): tightened
    constraints, terminal cost and the Gilbert-Tan set of the tightened
    ``(x, u = -K x)`` polytope, initial state in the tube ``Z`` around
    the nominal one."""
    A, B, Q, R = _checked(A, B, Q, R, N)
    if X is None or U is None or W is None:
        raise ValueError("the tube regulator needs X, U and W")
    K, P, Acl, _, Z, Xc, Uc = _tube_common(
        A, B, Q, R, W, X, U, eps_var, rpi_method, None)
    # ``TubeRegulatorMPC.determine_Xf`` :91-107
    Gxu = np.vstack([Xc.A, -Uc.A @ K])
    fxu = np.concatenate([Xc.b, Uc.b])
    Xf = max_admissible_set(Acl, Polytope(Gxu, fxu))
    tmpl = build_mpc_qp(
        A, B, Q, R, N, P_term=P,
        Hx=Xc.A, hx=Xc.b, Hu=Uc.A, hu=Uc.b,
        HxN=Xf.A, hxN=Xf.b,
        init_mode="tube", Hz=Z.A, hz=Z.b)
    return MPCSetup(kind="tube_regulator", A=A, B=B, Q=Q, R=R, N=int(N),
                    K=K, P=P, X=X, U=U, W=W, Z=Z, Xc=Xc, Uc=Uc, Xf=Xf,
                    template=tmpl)


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


def setup_extended_tube_tracking(A, B, Q, R, N, X: Polytope, U: Polytope,
                                 W: Polytope,
                                 fixed_initial_state: bool = False,
                                 rpi_method: int = 0, eps_var: float = 1e-4,
                                 K_ancillary: Optional[np.ndarray] = None,
                                 lambda_param: float = 0.99999,
                                 compat_reference_bug: bool = False
                                 ) -> MPCSetup:
    """ExtendedTubeTrackingMPC (paper Section IV.F): two QPs, the normal
    tube-tracking problem plus a packet-received variant whose initial tube
    is shrunk to ``Z - W`` (``TubeTrackingMPC.py:265-267``).

    ``compat_reference_bug=True`` reproduces the reference's vacuous
    terminal constraint in the packet-received problem (its eq at :293
    references the *other* problem's CVXPY variables, so the constraint
    never binds); the default applies the corrected constraint.
    """
    setup = setup_tube_tracking(
        A, B, Q, R, N, X, U, W,
        fixed_initial_state=fixed_initial_state, rpi_method=rpi_method,
        eps_var=eps_var, K_ancillary=K_ancillary, lambda_param=lambda_param)
    ZmW = pont_diff(setup.Z, W)
    if np.any(ZmW.b < 0):
        raise ValueError("Z - W is empty: the disturbance set is too large "
                         "relative to the tube for the extended MPC")
    tmpl_pr = build_mpc_qp(
        setup.A, setup.B, setup.Q, setup.R, N,
        tracking=True, P_term=setup.P, Tout=setup.Tout,
        Hx=setup.Xc.A, hx=setup.Xc.b, Hu=setup.Uc.A, hu=setup.Uc.b,
        HxN=None if compat_reference_bug else setup.Xf.A,
        hxN=None if compat_reference_bug else setup.Xf.b,
        terminal_augmented=not compat_reference_bug,
        init_mode="tube", Hz=ZmW.A, hz=ZmW.b)
    if compat_reference_bug:
        # The reference's packet-received problem keeps x_N free of any
        # terminal coupling; build_mpc_qp would add x_N == xbar when no
        # terminal set is given, so strip that equality to mimic the bug.
        neq = tmpl_pr.m - setup.nx
        tmpl_pr = dataclasses.replace(
            tmpl_pr,
            A=tmpl_pr.A[:neq], l0=tmpl_pr.l0[:neq], u0=tmpl_pr.u0[:neq],
            Ml=tmpl_pr.Ml[:neq], Mu=tmpl_pr.Mu[:neq],
            is_eq=tmpl_pr.is_eq[:neq],
            row_meta={**tmpl_pr.row_meta, "terminal_eq_fallback": False,
                      "mN": 0})
    return dataclasses.replace(setup, kind="extended_tube_tracking",
                               template_pr=tmpl_pr)


def flagship_setup() -> MPCSetup:
    """The flagship controller of ``bench.py`` (the configuration of
    ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network``): double
    integrator, N=10, X=+-8, U=+-1, W=+-0.1, fixed initial state."""
    return setup_tube_tracking(
        np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([[0.0], [1.0]]),
        np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
