"""Times and checks of the CUDA ADMM kernel alone, on one NVIDIA GPU.

    python3 -m rtmpc_tpu_torch.ops.kernel_bench

Builds the kernel, holds it against the plain PyTorch version of the path
it takes on random QPs (``qp_cuda._synthetic_spec``) at the shapes of the
main paths (the flagship's 40 + 112 columns at B=16384 and, for the
served session, at B=1, the cartpole's 112 + 792 and 112 + 840 and the
extended controller's 112 + 1648 at B=200), at the widest shape of each
path and at ragged and tiny batches, times one phase at the main shapes
with CUDA events beside

* the FP32 bound of the same work (``roofline_ms``), and
* ``iters`` back-to-back ``torch.mm`` calls ``(B, n+m) @ (n+m, n+m)`` in
  float32 with TF32 off: the library's time for the product alone, a lower
  yardstick than the kernel's whole function, and
* the composite path's time at the same shape (the "before" of the
  ``"fac"`` path's shapes),

and prints the crossover of the ``"fac"`` path against the composite
paths over small batches (``crossover``).

A kernel's speed does not depend on the QP's data, so random QPs of the
right shape stand in for the controllers (whose setup takes minutes).
It needs a card: without one it exits non-zero.  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` use the helpers and the bars below.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# (label, n_p, m_p, ntheta, batch, iterations) of the main paths
MAIN_SHAPES = (("flagship 40+112", 40, 112, 4, 16384, 60),
               ("served session 40+112, B=1", 40, 112, 4, 1, 60),
               ("cartpole tube 112+792", 112, 792, 8, 200, 200),
               ("cartpole tracking 112+840", 112, 840, 8, 200, 200),
               ("cartpole extended 112+1648", 112, 1648, 8, 200, 200))
# the widest shape of each path and the narrowest of the large one
WIDTH_SHAPES = ((48, 144), (41, 152), (256, 1792))

# Kernel against plain version, both float32, max |dz| and max |dy| (cuBLAS
# and the kernel sum in other orders).  The flagship and random QPs: the
# bars of tests/test_qp_pallas.py.  The cartpole QPs: 5-10x what an NVIDIA
# H100 80GB HBM3 at 700 W read (z 2.09e-4, y 2.72e-3: 904- and 952-term
# sums in two orders, scaled into y by rho = 500 on the equality rows).
Z_ATOL, Y_ATOL = 1e-4, 2e-3
CP_Z_ATOL, CP_Y_ATOL = 1.5e-3, 2e-2
# The extended controller's two QPs (112 + 1648 columns): 7-8x what the same
# card read (z 1.01e-4, y 6.03e-4 at B=200; rho = 500 scales fewer of these
# rows than of the 904-column QPs'), and at the small batches absolute float64
# bars of 2x the kernel's readings there (z 1.4e-4, y 2.9e-4; plain float32
# read y 5.8e-5 to 2.2e-4 at those batches, so the ratio is noisy there too).
EXT_Z_ATOL, EXT_Y_ATOL = 7e-4, 5e-3
EXT_F64_SMALL_B = (3e-4, 6e-4)
# Against the plain version in float64 the kernel's error may be at most
# this multiple of the plain float32 version's own error.
F64_RATIO = 3.0
# A known gap of the small path at small batches (1 and around a block's 64
# rows).  There cuBLAS splits the 152-term sums, so the plain version is
# 2-4x closer to float64 than at B >= 257, while the kernel's one FMA chain
# of 152 terms an output stays where it is: on the flagship at B=63 and 65
# the same card read y 1.55-1.79e-3 from float64 for the kernel and
# 4.7-5.8e-4 for plain (ratio 3.1-3.7, over F64_RATIO), and 1.5-1.9e-3
# between the two.  So these batches get a y bar against plain of 2x that
# reading, and absolute (z, y) bars against float64 of 2x the kernel's
# readings there (flagship z 1.7e-5, y 1.79e-3; cartpole z 3.0e-4, y
# 6.2e-4) in place of the ratio, which a handful of rows makes noisy.
Y_ATOL_SMALL_B = 4e-3
F64_SMALL_B = (4e-5, 3.6e-3)
CP_F64_SMALL_B = (6e-4, 1.3e-3)
# The condensed QPs (``ops/assembly.py:condense_template``: the states
# eliminated, so the cost carries A^k and the duals are larger).  z keeps
# the bars above; y gets 2-3x what an NVIDIA H100 80GB HBM3 read against
# plain, where plain float32 is itself as far from float64 (flagship 16 +
# 96 at B=16384: kernel 1.23e-2, plain 3.4e-2 from float64; cartpole
# tracking 32 + 760 at B=200: kernel 4.53, plain 4.44 from float64); at
# the small batches absolute float64 bars of 2x the kernel's readings
# there (flagship z 1.9e-5, y 1.36e-2; cartpole z 7.0e-5, y 0.173).
COND_Y_ATOL = 4e-2
# r_prim = |A x - z| of the condensed flagship: A's rows carry A^k B, so
# the kernel's x, 1.35e-4 from plain's at B=4099 on that card, moves
# r_prim by as much (1.35e-4 read there); 3x that reading
COND_RPRIM_ATOL = 4e-4
COND_F64_SMALL_B = (4e-5, 3e-2)
COND_CP_Y_ATOL = 10.0
COND_CP_F64_SMALL_B = (1.5e-4, 0.35)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured into one
    CUDA graph (after a warm-up call), the graph replayed once to warm up
    and once under CUDA events, divided by ``reps``.  Unlike ``time_ms`` it
    leaves out the host's time to issue a call, which bounds a short phase
    when it is timed call by call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sm_clock_under(fn, reps: int) -> str:
    """``clocks.sm, clocks.max.sm`` as ``nvidia-smi`` reads them while
    ``reps`` queued calls of ``fn`` (a second or two of work) keep the card
    busy: the FP32 peak of ``roofline_ms`` is the data sheet's, at the boost
    clock."""
    for _ in range(reps):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    torch.cuda.synchronize()
    return out.strip().splitlines()[0]


def roofline_ms(B: int, n_p: int, m_p: int, ntheta: int, iters: int):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    for one ADMM phase, the larger of its FP32 operations over the FP32
    peak and its bytes (every input read once, every output written once)
    over the memory rate.

    Both sides count the least work the function needs from its inputs,
    the factored form ``xt = (sigma x - q + (rho z - y) As) Kinv'``, ``zt =
    xt As'`` (``Kinv'`` is ``Kcat``'s first block).  Operations: ``2 B (n^2
    + 2 n m)`` an iteration, plus the residuals' products; the elementwise
    update is left out.  Bytes: ``Kinv``, ``As`` and ``Ps``, the affine
    maps of q, l and u in theta, rho and its inverse, sigma, theta, the
    state (x, y, z) in and out and the two residuals.  The kernel runs the
    composite form on purpose, one product ``2 B (n + m)^2`` an iteration
    (``composite_over_factored`` times the bound's operations) that reads
    the composites ``Gxc``, ``Gsc`` and ``Kcat``, so it cannot reach this
    bound as it is built."""
    flops = 2.0 * B * (n_p * n_p + 2 * n_p * m_p) * iters \
        + 2.0 * B * (2 * n_p * m_p + n_p * n_p)
    floats = (B * (ntheta + 2 * (n_p + 2 * m_p) + 2)     # theta, state x2, r
              + n_p * n_p + m_p * n_p + n_p * n_p         # Kinv, As, Ps
              + (n_p + 2 * m_p) * (ntheta + 1) + 2 * m_p + 1)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4.0 * floats / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def composite_over_factored(n_p: int, m_p: int) -> float:
    """Operations of the composite product the kernel runs an iteration
    over those of the factored form that ``roofline_ms`` counts."""
    return (n_p + m_p) ** 2 / (n_p * n_p + 2 * n_p * m_p)


def mm_product_ms(B: int, nm: int, iters: int, device, reps: int = 5) -> float:
    """The library's time for the products of one phase alone: ``iters``
    back-to-back ``torch.mm((B, nm), (nm, nm))``, float32, TF32 off."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 must be off for the float32 yardstick")
    g = torch.Generator(device=device).manual_seed(0)
    v = torch.randn(B, nm, device=device, generator=g)
    G = torch.randn(nm, nm, device=device, generator=g) / nm ** 0.5
    out = torch.empty_like(v)

    def run():
        a, b = v, out
        for _ in range(iters):
            torch.mm(a, G, out=b)
            a, b = b, a

    return time_ms(run, reps)


def thetas(B: int, ntheta: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(-2, 2, (B, ntheta)), dtype=torch.float32,
                        device=device)


def _max_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def compare_with_plain(spec1, spec2, th1, th2, iters, bars=(Z_ATOL, Y_ATOL),
                       *, warm_from_kernel=False, specs64=None,
                       f64_bars=None) -> dict:
    """The one comparison of the kernel with its plain version (that of the
    path the launch takes, ``qp_cuda._admm_solve_plain``): a cold
    phase of ``iters[0]`` iterations on ``spec1``, then ``iters[1]`` warm
    ones on ``spec2`` from one shared state (the kernel's phase-1 iterate,
    as on the main paths, or the plain version's).

    Raises unless every kernel output is finite, max |dz| and max |dy|
    against the plain version are within ``bars`` ``(z, y)``, and the
    residuals agree (5% and ``bars[0]``, or ``bars[2]`` where given, for
    r_prim; ``bars[1] / 2`` for r_dual).  With
    ``specs64`` (the two specs in float64) both are also held against the
    plain version in float64: the kernel's error at most ``F64_RATIO``
    times plain float32's own, or, where ``f64_bars`` gives absolute (z, y)
    bars, within those (on the ``"fac"`` path within either: its plain
    float32 version, the factored form, is itself up to 3x further from
    float64 than the composite form's at small batches of the cartpole
    QPs, where rho = 500 scales the equality rows' y into the product).
    Returns the errors (``cold_z`` ... and, against float64,
    ``f64_cold_z`` / ``plain_f64_cold_z`` ...)."""
    from .qp_cuda import _admm_solve_plain, _spec_path, admm_solve_cuda
    it1, it2 = iters
    k1 = admm_solve_cuda(spec1, th1, None, it1)
    p1 = _admm_solve_plain(spec1, th1, None, it1)
    start = k1.state if warm_from_kernel else p1.state
    k2 = admm_solve_cuda(spec2, th2, start, it2)
    p2 = _admm_solve_plain(spec2, th2, start, it2)
    d1 = d2 = None
    if specs64 is not None:
        d1 = _admm_solve_plain(specs64[0], th1.double(), None, it1)
        d2 = _admm_solve_plain(
            specs64[1], th2.double(),
            type(start)(*(t.double() for t in start)), it2)
    if th1.is_cuda:
        torch.cuda.synchronize()
    B, (z_bar, y_bar, *rp) = th1.shape[0], bars
    rp_bar = rp[0] if rp else z_bar
    fac = _spec_path(spec1, B) == "fac"
    errs = {}

    def require(ok, *what):
        if not ok:
            raise RuntimeError(f"kernel vs plain, B={B}: {what}; {errs}")

    for phase, k, p, d in (("cold", k1, p1, d1), ("warm", k2, p2, d2)):
        for t in (*k.state, k.r_prim, k.r_dual):
            require(bool(torch.isfinite(t).all()), phase, "not finite")
        errs[phase + "_z"] = _max_err(k.z_primal, p.z_primal)
        errs[phase + "_x"] = _max_err(k.state.x, p.state.x)
        errs[phase + "_y"] = _max_err(k.state.y, p.state.y)
        errs[phase + "_rprim"] = _max_err(k.r_prim, p.r_prim)
        errs[phase + "_rdual"] = _max_err(k.r_dual, p.r_dual)
        if d is not None:
            for which, got in (("f64_", k), ("plain_f64_", p)):
                errs[which + phase + "_z"] = _max_err(got.z_primal,
                                                      d.z_primal)
                errs[which + phase + "_y"] = _max_err(got.state.y, d.state.y)
    for phase, k, p in (("cold", k1, p1), ("warm", k2, p2)):
        for key, bar in ((phase + "_z", z_bar), (phase + "_y", y_bar)):
            require(errs[key] <= bar, key, bar)
            if specs64 is None:
                continue
            ratio_bar = F64_RATIO * errs["plain_f64_" + key] + 1e-6
            if f64_bars is None:
                bar64 = ratio_bar
            elif fac:
                bar64 = max(f64_bars[key.endswith("_y")], ratio_bar)
            else:
                bar64 = f64_bars[key.endswith("_y")]
            require(errs["f64_" + key] <= bar64, "f64_" + key, bar64)
        for name, atol in (("r_prim", rp_bar), ("r_dual", y_bar / 2)):
            got, want = getattr(k, name), getattr(p, name)
            require(bool(((got - want).abs() <= atol + 5e-2 * want.abs())
                         .all()), phase, name)
    return errs


def ragged_batches(rows: int):
    """Tiny and ragged batches around ``rows`` (a block's or a cluster's)."""
    return (1, rows - 1, rows, rows + 1, 2 * rows + 3)


def check_shapes(shapes, device, iters: int = 50) -> None:
    """Holds the kernel to its plain version on a random QP of each
    ``(n_p, m_p)`` at tiny and ragged batches around the rows one thread
    block (or cluster) of its composite path owns there, and prints the
    errors and the path each batch takes."""
    from .qp_cuda import _synthetic_spec, kernel_path, kernel_rows
    for n_p, m_p in shapes:
        spec = _synthetic_spec(n_p, m_p, 4, seed=n_p + m_p, device=device)
        rows = kernel_rows(n_p, m_p)
        for B in ragged_batches(rows):
            th = thetas(B, 4, B, device)
            e = compare_with_plain(spec, spec, th, th, (iters, iters))
            print("random QP %d+%d (%s path, %d rows a group) B=%d: kernel "
                  "vs plain dz %.3e dy %.3e dr %.3e"
                  % (n_p, m_p, kernel_path(n_p + m_p, B, n_p),
                     kernel_rows(n_p, m_p, B), B,
                     max(e["cold_z"], e["warm_z"]),
                     max(e["cold_y"], e["warm_y"]),
                     max(e[k] for k in e if "_r" in k)))


def path_ms(spec, th, iters: int, path: str, reps: int) -> float:
    """One phase's device time on a named path
    (``qp_cuda._admm_solve_cuda_on_path``): ``graph_time_ms``."""
    from .qp_cuda import _admm_solve_cuda_on_path
    return graph_time_ms(lambda: _admm_solve_cuda_on_path(spec, th, None,
                                                          iters, path), reps)


# Batches of the crossover sweep of the "fac" path against the composite
# paths; qp_cuda.FAC_MAX_B is its upper end, and chip_smoke.py fails where
# "fac" is not the faster at every one of them
CROSSOVER_BATCHES = (1, 2, 4, 8, 16, 32, 64)


def crossover(specs, iters, device, batches=CROSSOVER_BATCHES,
              reps: int = 5) -> dict:
    """Times one phase of ``iters[label]`` iterations on the ``"fac"`` path
    and on the composite path of the width, in turns (composite, fac, fac,
    composite), at each batch, for each ``label: spec``; prints a table.
    Returns ``{label: [(B, fac ms, composite ms), ...]}`` and the largest B
    up to which ``"fac"`` is the faster on every shape (``"b_star"``)."""
    from .qp_cuda import kernel_path
    out, b_star = {}, None
    for label, spec in specs.items():
        n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
        old = kernel_path(n_p + m_p)
        rows = []
        for B in batches:
            th = thetas(B, spec.Mq.shape[1], B, device)
            t = {old: [], "fac": []}
            for path in (old, "fac", "fac", old):
                t[path].append(path_ms(spec, th, iters[label], path, reps))
            rows.append((B, float(np.mean(t["fac"])),
                         float(np.mean(t[old]))))
            print("crossover %s (%d+%d, %d iterations) B=%d: fac %.4f ms, "
                  "%s %.4f ms" % (label, n_p, m_p, iters[label], B,
                                  rows[-1][1], old, rows[-1][2]))
        out[label] = rows
        wins = 0
        for B, fac, comp in rows:
            if fac >= comp:
                break
            wins = B
        b_star = wins if b_star is None else min(b_star, wins)
    out["b_star"] = b_star
    return out


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: no CUDA device")
    from .qp_cuda import (_admm_solve_plain, _synthetic_spec, admm_solve_cuda,
                          build_kernel, kernel_path)
    dev = torch.device("cuda", 0)
    name = card()
    print(name)
    lib, log = build_kernel()
    print("built", lib)
    for line in log.splitlines():
        print("  " + line.strip())

    check_shapes(tuple(dict.fromkeys(
        WIDTH_SHAPES + tuple(s[1:3] for s in MAIN_SHAPES))), dev)
    for label, n_p, m_p, nt, B, iters in MAIN_SHAPES:
        spec = _synthetic_spec(n_p, m_p, nt, seed=1, device=dev)
        th = thetas(B, nt, 2, dev)
        e = compare_with_plain(spec, spec, th, th, (iters, iters))
        t = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = admm_solve_cuda if which == "kernel" else _admm_solve_plain
            t[which].append(time_ms(lambda: fn(spec, th, None, iters), 5))
        path, old = kernel_path(n_p + m_p, B, n_p), kernel_path(n_p + m_p)
        bound, by = roofline_ms(B, n_p, m_p, nt, iters)
        clock = sm_clock_under(lambda: admm_solve_cuda(spec, th, None, iters),
                               int(2000 / np.mean(t["kernel"])))
        row = dict(shape=label, B=B, iters=iters, path=path,
                   dz=max(e["cold_z"], e["warm_z"]),
                   dy=max(e["cold_y"], e["warm_y"]),
                   kernel_ms=t["kernel"], plain_ms=t["plain"],
                   before_ms=(path_ms(spec, th, iters, old, 5)
                              if path != old else None),
                   mm_product_ms=mm_product_ms(B, n_p + m_p, iters, dev),
                   bound_ms=bound, bound_by=by,
                   share_of_bound=bound / float(np.mean(t["kernel"])),
                   composite_over_factored=composite_over_factored(n_p, m_p),
                   sm_clock_under_kernel=clock, card=name)
        print(json.dumps(row))
    crossover({"flagship 40+112": _synthetic_spec(40, 112, 4, seed=1,
                                                  device=dev),
               "cartpole tube 112+792": _synthetic_spec(112, 792, 8, seed=1,
                                                        device=dev)},
              {"flagship 40+112": 60, "cartpole tube 112+792": 200}, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
