"""The CUDA ADMM kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU (the kernel is built for sm_90a and has no
CPU mode); without one they skip.  This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtmpc_tpu_torch.models import flagship_setup
from rtmpc_tpu_torch.ops.kernel_bench import (CP_Y_ATOL, CP_Z_ATOL,
                                              EXT_Y_ATOL, EXT_Z_ATOL, Y_ATOL,
                                              Y_ATOL_SMALL_B, Z_ATOL,
                                              compare_with_plain)
from rtmpc_tpu_torch.ops.qp_cuda import (_admm_solve_cuda_plain,
                                         _synthetic_spec, admm_solve_cuda,
                                         kernel_path, kernel_rows)
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.protocol import draw_disturbances, draw_loss_masks

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
# the bars (Z_ATOL, Y_ATOL, ...) are those of ops/kernel_bench.py, which
# chip_smoke.py holds the kernel to as well


@pytest.fixture(scope="module")
def flagship_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ADMM kernel has no CPU mode")
    return flagship_setup().to_device(torch.float32, "cuda", solver="cuda",
                                      **KW)


def _theta(B, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(-2, 2, (B, 4)), dtype=torch.float32,
                        device="cuda")


def _assert_close(got, want):
    torch.testing.assert_close(got.z_primal, want.z_primal, rtol=0,
                               atol=Z_ATOL)
    torch.testing.assert_close(got.state.x, want.state.x, rtol=0, atol=Z_ATOL)
    torch.testing.assert_close(got.state.y, want.state.y, rtol=0,
                               atol=Y_ATOL)
    torch.testing.assert_close(got.r_prim, want.r_prim, rtol=5e-2, atol=1e-4)
    torch.testing.assert_close(got.r_dual, want.r_dual, rtol=5e-2,
                               atol=1e-3)


# B: a batch size, or an offset from the rows one thread block (or cluster)
# of the kernel owns at the shape ("rows-1": one row less than a full group)
@pytest.mark.parametrize("B", [1, 17, "rows-1", "rows+1", 4099])
@pytest.mark.parametrize("shape", ["flagship", "random 48+144"])
def test_kernel_matches_plain_version(flagship_cuda, shape, B):
    """Cold start at phase 1, then warm start at phase 2; the batch tail
    (B not a multiple of a block's rows) is masked in the kernel.  The
    flagship's 40 + 112 columns, and a random QP at the 192 columns that
    are the shared-memory path's most."""
    if shape == "flagship":
        spec1, spec2 = flagship_cuda[0].admm, flagship_cuda[0].admm2
    else:
        spec1 = spec2 = _synthetic_spec(48, 144, 4, seed=192, device="cuda")
    n_p, m_p = spec1.Kinv.shape[0], spec1.As.shape[0]
    assert kernel_path(n_p + m_p) == "smem"
    y_atol = Y_ATOL
    if isinstance(B, str):
        B = kernel_rows(n_p, m_p) + int(B[4:])
        y_atol = Y_ATOL_SMALL_B
    path = kernel_path(n_p + m_p, B, n_p)   # "fac" up to FAC_MAX_B rows
    before = dict(admm_solve_cuda.launches_by_path)
    errs = compare_with_plain(spec1, spec2, _theta(B, 0), _theta(B, 1),
                              (60, 60), (Z_ATOL, y_atol))
    assert admm_solve_cuda.launches_by_path[path] == before[path] + 2
    assert max(errs["cold_x"], errs["warm_x"]) <= Z_ATOL


def test_kernel_zero_iterations_returns_state(flagship_cuda):
    arrays, _ = flagship_cuda
    th = _theta(33, 2)
    start = _admm_solve_cuda_plain(arrays.admm, th, None, 10).state
    k = admm_solve_cuda(arrays.admm2, th, start, 0)
    p = _admm_solve_cuda_plain(arrays.admm2, th, start, 0)
    for a, b in zip(k.state, start):
        assert torch.equal(a, b)
    _assert_close(k, p)


def test_kernel_rejects_bad_inputs(flagship_cuda):
    arrays, _ = flagship_cuda
    th = _theta(8, 3)
    with pytest.raises(ValueError, match="float32"):
        admm_solve_cuda(arrays.admm, th.double(), None, 5)
    with pytest.raises(ValueError, match="contiguous"):
        admm_solve_cuda(arrays.admm, _theta(8, 3).t().contiguous().t(),
                        None, 5)
    with pytest.raises(ValueError, match="shape"):
        admm_solve_cuda(arrays.admm, th[:, :3].contiguous(), None, 5)


def test_closed_loop_cuda_matches_admm(flagship_cuda):
    arrays, cfg = flagship_cuda
    B, T = 64, 30
    g = torch.Generator(device="cuda").manual_seed(0)
    theta, gamma = draw_loss_masks(g, T, 0.7, 0.7, (B,))
    w = draw_disturbances(g, T, [-0.1, -0.1], [0.1, 0.1], (B,))
    refs = torch.zeros(B, T, 2, device="cuda")
    refs[:, :, 0] = 4.0
    x0 = torch.zeros(B, 2, device="cuda")
    runs = {}
    for solver in ("cuda", "admm"):
        c = dataclasses.replace(cfg, solver=solver)
        runs[solver] = make_batched_rollout(arrays, c, T)(x0, refs, w, theta,
                                                          gamma)
    (ck, ok), (ca, oa) = runs["cuda"], runs["admm"]
    assert torch.equal(ok.Theta, oa.Theta)
    assert torch.equal(ck.feasible, ca.feasible) and bool(ck.feasible.all())
    assert (ok.x - oa.x).abs().max().item() <= 1e-3


def test_closed_loop_polish_cuda_matches_admm():
    """``polish=True`` under solver "cuda": the kernel's primal is polished
    by the shared ``polish_solution`` per rollout; the trajectories match
    the plain ADMM engine polished the same way (the JAX package's
    ``tests/test_qp_pallas.py:113-141``: flagship, 30 iterations, B=4,
    T=8, 60% loss, float32; its bars: states 1e-4, ``r_dual`` rtol 0.2 /
    atol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ADMM kernel has no CPU mode")
    setup = flagship_setup()
    arrays, cfg = setup.to_device(torch.float32, "cuda", solver="cuda",
                                  iters=30, polish=True)
    B, T = 4, 8
    g = torch.Generator(device="cuda").manual_seed(3)
    theta, gamma = draw_loss_masks(g, T, 0.6, 0.6, (B,))
    w = draw_disturbances(g, T, [-0.1, -0.1], [0.1, 0.1], (B,))
    refs = torch.zeros(B, T, 2, device="cuda")
    refs[:, :, 0] = 3.0
    x0 = torch.zeros(B, 2, device="cuda")
    runs = {}
    for solver in ("cuda", "admm"):
        c = dataclasses.replace(cfg, solver=solver)
        before = admm_solve_cuda.launches
        runs[solver] = make_batched_rollout(arrays, c, T)(x0, refs, w, theta,
                                                          gamma)
        launched = admm_solve_cuda.launches - before
        assert launched == (T if solver == "cuda" else 0), launched
    (ck, ok), (ca, oa) = runs["cuda"], runs["admm"]
    torch.testing.assert_close(ok.x, oa.x, rtol=0, atol=1e-4)
    torch.testing.assert_close(ok.r_dual, oa.r_dual, rtol=0.2, atol=1e-5)
    assert torch.equal(ck.feasible, ca.feasible)


def _step_profile(*args):
    """``python -m rtmpc_tpu_torch.parallel.step_profile`` in a process of
    its own (a ``torch.profiler`` window opened in a process that captured
    CUDA graphs before has missed a K1 event of the extended step; the
    profiler runs in a fresh process, as the module's users run it);
    returns its JSON report."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "rtmpc_tpu_torch.parallel.step_profile",
         *map(str, args)], cwd=root, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_step_profile_reads_the_kernel(flagship_cuda):
    """The step profiler finds both ADMM launches of every step in the
    profiler's device events, and credits them to the span that launched
    them, ``rtmpc.k1``: 2 a step, with the device time of the events named
    ``admm_kernel``; every device operation is credited once."""
    res = _step_profile("--batch", 64, "--steps", 2)
    assert res["k1_launches_per_step"] == 2
    assert 0 < res["k1_share_of_device_time"] <= 1
    assert 0 < res["busy_share_profiled"] <= 1.05
    assert res["other_device_ops_per_step"] > 0
    spans = res["spans"]
    k1 = spans["rtmpc.k1"]
    assert k1["count"] == k1["device_ops"] == 2 * 2
    assert k1["device_ms"] == pytest.approx(4 * res["k1_ms_per_launch"],
                                            rel=1e-9)
    assert spans["rtmpc.solve"]["count"] == 2
    assert spans["rtmpc.protocol"]["count"] == 2
    assert spans["rtmpc.protocol"]["device_ops"] > 0
    assert sum(r["device_ops"] for r in spans.values()) == 2 * (
        res["k1_launches_per_step"] + res["other_device_ops_per_step"])


def test_step_profile_credits_k1_on_the_sweeps_path(flagship_cuda):
    """At the Monte-Carlo sweep's batch (B=16384: K1's smem path) the
    device time credited by launch to ``rtmpc.k1`` is that of the events
    named ``admm_kernel``, 2 a step; every device operation is credited
    once, and the protocol's are part of the step's other operations."""
    res = _step_profile("--steps", 2)
    assert res["k1_path"] == "smem"
    spans = res["spans"]
    k1 = spans["rtmpc.k1"]
    assert k1["count"] == k1["device_ops"] == 2 * 2
    assert k1["device_ms"] == pytest.approx(4 * res["k1_ms_per_launch"],
                                            rel=1e-9)
    assert sum(r["device_ops"] for r in spans.values()) == 2 * (
        res["k1_launches_per_step"] + res["other_device_ops_per_step"])
    assert res["protocol_device_ms_per_step"] == pytest.approx(
        spans["rtmpc.protocol"]["device_ms"] / 2)
    assert (0 < res["protocol_device_ms_per_step"]
            < res["other_device_ms_per_step"])


def test_step_profile_reads_the_session(flagship_cuda):
    """``--session``: every device operation of a tick is launched inside
    its ``rtmpc.session.copy_in`` (the four input copies) or its
    ``rtmpc.session.replay`` (the captured graph, K1's 2 launches among
    them); the captured step's own spans ran at capture, not at replay."""
    ticks = 20
    res = _step_profile("--session", "--steps", ticks)
    spans = res["spans"]
    assert set(spans) == {"rtmpc.session.copy_in", "rtmpc.session.replay"}
    copy_in, replay = (spans["rtmpc.session.copy_in"],
                       spans["rtmpc.session.replay"])
    assert copy_in["count"] == replay["count"] == ticks
    assert copy_in["device_ops"] == 4 * ticks
    assert res["captured_launches"] == res["k1_launches_per_tick"] == 2
    assert replay["device_ops"] % ticks == 0
    assert replay["device_ops"] > 2 * ticks
    assert (copy_in["device_ops"] + replay["device_ops"]
            == res["device_ops_per_tick"] * ticks)
    assert 0 < res["tick_copy_in_host_ms"]
    assert 0 < res["tick_replay_host_ms"]


# ---------------------------------------------------------------------------
# The Fig. 3a slice: the kernel's L2 path at the cartpole's shapes and the
# structured interior point on the card
# ---------------------------------------------------------------------------

IP_OBJ_RTOL = 1e-8                     # card vs CPU, float64


@pytest.fixture(scope="module")
def cartpole():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ADMM kernel has no CPU mode")
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    from rtmpc_tpu_torch.models import setup_tracking, setup_tube_tracking
    sc = cartpole_scenario()
    return sc, {
        "tube": setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U,
                                    sc.W, fixed_initial_state=True,
                                    rpi_method=1),
        "track": setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U)}


def _cartpole_theta(B, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    theta = np.zeros((B, 8))
    theta[:, :4] = rng.uniform(-1, 1, (B, 4)) * np.array([0.3, 0.5, 0.05,
                                                           0.5])
    theta[:, 4] = rng.uniform(-1.0, 6.0, B)
    return torch.tensor(theta, dtype=dtype, device="cuda")


@pytest.mark.parametrize("B", [1, "rows-1", "rows+1", 37, 200])
@pytest.mark.parametrize("arm", ["tube", "track", "random 41+152",
                                 "random 256+1792"])
def test_l2_path_matches_plain_version(cartpole, arm, B):
    """The large-composite path: the cartpole's 112 + 792 and 112 + 840
    columns (200 cold iterations at phase 1, then 200 warm at phase 2), and
    random QPs at the 193 and 2048 columns that are the path's least and
    most (193 is no multiple of 4: the unaligned loads)."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    if arm.startswith("random"):
        n_p, m_p = (int(v) for v in arm.split()[1].split("+"))
        spec1 = spec2 = _synthetic_spec(n_p, m_p, 8, seed=n_p + m_p,
                                        device="cuda")
        iters, bars = 50, (Z_ATOL, Y_ATOL)
    else:
        arrays, _ = cartpole[1][arm].to_device(torch.float32, "cuda",
                                               solver="cuda", **ADMM_SCHEDULE)
        spec1, spec2 = arrays.admm, arrays.admm2
        iters, bars = 200, (CP_Z_ATOL, CP_Y_ATOL)
    n_p, m_p = spec1.Kinv.shape[0], spec1.As.shape[0]
    assert kernel_path(n_p + m_p) == "l2"
    if isinstance(B, str):
        B = kernel_rows(n_p, m_p) + int(B[4:])
    th = _cartpole_theta(B, 0)
    path = kernel_path(n_p + m_p, B, n_p)   # "fac" up to FAC_MAX_B rows
    before = dict(admm_solve_cuda.launches_by_path)
    compare_with_plain(spec1, spec2, th, th, (iters, iters), bars)
    assert admm_solve_cuda.launches_by_path[path] == before[path] + 2


# ---------------------------------------------------------------------------
# The "fac" path (admm_kernel_factored): small batches at every width, and
# every batch above 1024 columns
# ---------------------------------------------------------------------------

FAC_BATCHES = (1, 15, 16, 17, 37, 61)


def _fac_specs(name, flagship_cuda, cartpole, extended):
    """(phase-1 spec, phase-2 spec, (z bar, y bar)) of a controller's QP."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    if name == "flagship":
        a = flagship_cuda[0]
        return a.admm, a.admm2, (Z_ATOL, Y_ATOL_SMALL_B)
    if name in ("tube", "track"):
        a, _ = cartpole[1][name].to_device(torch.float32, "cuda",
                                           solver="cuda", **ADMM_SCHEDULE)
        return a.admm, a.admm2, (CP_Z_ATOL, CP_Y_ATOL)
    a = extended[1][0]
    return ((a.admm, a.admm2) if name == "extended" else
            (a.admm_pr, a.admm2_pr)) + ((EXT_Z_ATOL, EXT_Y_ATOL),)


@pytest.mark.parametrize("B", FAC_BATCHES + (64, 200))
@pytest.mark.parametrize("name", ["flagship", "tube", "track", "extended",
                                  "extended packet-received"])
def test_fac_path_matches_plain_version(flagship_cuda, cartpole, extended,
                                        name, B):
    """The "fac" path against its plain version (``_admm_solve_factored_
    plain``), cold at phase 1 then warm at phase 2, on the controllers'
    QPs at batches around its groups' rows (1, 4 or 16, from the batch:
    the ragged tails are masked) and, above 1024 columns, at B=200; the
    bars of ``kernel_bench.py`` for each QP."""
    spec1, spec2, bars = _fac_specs(name, flagship_cuda, cartpole, extended)
    n_p, m_p = spec1.Kinv.shape[0], spec1.As.shape[0]
    if kernel_path(n_p + m_p, B, n_p) != "fac":
        assert B > 64 and n_p + m_p <= 1024
        return
    rows = kernel_rows(n_p, m_p, B)
    assert rows in (1, 4, 16)
    th = (_theta(B, 9) if name == "flagship" else _cartpole_theta(B, 9))
    before = dict(admm_solve_cuda.launches_by_path)
    iters = (60, 60) if name == "flagship" else (200, 200)
    compare_with_plain(spec1, spec2, th, th, iters, bars,
                       warm_from_kernel=True)
    assert admm_solve_cuda.launches_by_path["fac"] == before["fac"] + 2


@pytest.mark.parametrize("B", [1, 17])
@pytest.mark.parametrize("m_p", [49, 20, 41])
def test_fac_path_on_clusters_whose_last_block_owns_no_rows(flagship_cuda,
                                                            m_p, B):
    """A cluster's block slices of As are ceil(m / 8) rows, and the kernel
    does not clamp them: 100 + 49 (7 rows to blocks 0-6, none to block 7)
    takes "fac" and matches its plain version, cold then warm, at one row
    a group and at 4; 100 + 20 and 100 + 41 (the last block would own -1
    rows) are refused by "fac" and take the composite path, which matches
    its plain version."""
    from rtmpc_tpu_torch.ops.qp_cuda import _admm_solve_cuda_on_path
    spec = _synthetic_spec(100, m_p, 4, seed=m_p, device="cuda")
    path = kernel_path(100 + m_p, B, 100)
    assert path == ("fac" if m_p == 49 else "smem")
    if path != "fac":
        with pytest.raises(RuntimeError, match="path fac"):
            _admm_solve_cuda_on_path(spec, _theta(B, m_p), None, 10, "fac")
    before = admm_solve_cuda.launches_by_path[path]
    compare_with_plain(spec, spec, _theta(B, m_p), _theta(B, m_p + 1),
                       (50, 50), warm_from_kernel=True)
    assert admm_solve_cuda.launches_by_path[path] == before + 2


def test_kernel_path_mirrors_the_c_dispatch(flagship_cuda):
    """``kernel_path(n_cols, B, n_p)`` (Python) and ``admm_path`` (C) name
    the same path over widths and batches around every edge, and over a
    grid of shapes at B=1 ("fac" wherever its operator fits)."""
    from rtmpc_tpu_torch.ops.qp_cuda import _library
    code = {1: "smem", 2: "l2", 3: "fac"}
    lib = _library()
    for n_p, m_p in ((40, 112), (48, 144), (41, 152), (112, 792), (100, 924),
                     (100, 925), (112, 1648), (256, 1792), (257, 1700),
                     (300, 600), (100, 20), (100, 41), (100, 49), (64, 256),
                     (65, 256), (128, 1920), (240, 20)):
        for B in (1, 2, 15, 16, 17, 63, 64, 65, 200, 16384):
            assert code[lib.rtmpc_admm_path(B, n_p, m_p)] == kernel_path(
                n_p + m_p, B, n_p), (n_p, m_p, B)
    for n_p in range(1, 260, 7):
        for m_p in range(1, 2049 - n_p, 53):
            assert code[lib.rtmpc_admm_path(1, n_p, m_p)] == kernel_path(
                n_p + m_p, 1, n_p), (n_p, m_p)


def test_kernel_refuses_too_wide_qps(flagship_cuda):
    with pytest.raises(ValueError, match="2048"):
        kernel_path(4096)


@pytest.mark.parametrize("arm", ["tube", "track"])
def test_ip_riccati_card_matches_cpu(cartpole, arm):
    """float64 on the card against float64 on the CPU: residuals at the
    solver's stop level on both, objectives within 1e-8 relative."""
    from rtmpc_tpu_torch.ops.ip_riccati import ip_riccati_solve
    sc, setups = cartpole
    rng = np.random.default_rng(1)
    theta = np.zeros((16, 8))
    theta[:, :4] = rng.uniform(-1, 1, (16, 4)) * np.array([0.05, 0.1, 0.01,
                                                           0.1])
    theta[:, 4] = 0.5
    sols = {}
    for dev in ("cuda", "cpu"):
        arrays, cfg = setups[arm].to_device(torch.float64, dev,
                                            solver="ip_riccati", ip_iters=30)
        sols[dev] = ip_riccati_solve(
            arrays.ric, torch.tensor(theta, device=dev), cfg.N, iters=30)
    tmpl = setups[arm].template
    q = theta @ tmpl.Mq.T + tmpl.q0
    obj = {}
    for dev, sol in sols.items():
        z = sol.z_primal.cpu().numpy()
        assert float(sol.r_prim.max()) <= 1e-9
        assert float(sol.r_dual.max()) <= 1e-6
        obj[dev] = 0.5 * np.einsum("bi,ij,bj->b", z, tmpl.P, z) \
            + (q * z).sum(1)
    assert (np.abs(obj["cuda"] - obj["cpu"])
            <= IP_OBJ_RTOL * np.abs(obj["cpu"])).all()


# ---------------------------------------------------------------------------
# The extended arm and the nonlinear plant: the cluster path above 1024
# columns (8 rows a cluster) on the extended controller's two QPs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def extended():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ADMM kernel has no CPU mode")
    from rtmpc_tpu_torch.apps.common import (ADMM_SCHEDULE,
                                             cartpole_controllers)
    from rtmpc_tpu_torch.apps.scenarios import cartpole_scenario
    sc = cartpole_scenario()
    setup = cartpole_controllers(sc, ("ext",))["ext"]
    return sc, setup.to_device(torch.float32, "cuda", solver="cuda",
                               **ADMM_SCHEDULE)


@pytest.mark.parametrize("B", [1, "rows-1", "rows+1", 37, 200])
@pytest.mark.parametrize("qp", ["normal", "packet-received"])
def test_extended_qps_match_plain_version(extended, qp, B):
    """112 + 1648 columns, 200 cold iterations at phase 1 then 200 warm at
    phase 2, on both of the extended controller's QPs."""
    arrays, _ = extended[1]
    spec1, spec2 = ((arrays.admm, arrays.admm2) if qp == "normal"
                    else (arrays.admm_pr, arrays.admm2_pr))
    n_p, m_p = spec1.Kinv.shape[0], spec1.As.shape[0]
    assert (n_p, m_p) == (112, 1648) and kernel_path(n_p + m_p) == "l2"
    assert kernel_rows(n_p, m_p) == 8
    if isinstance(B, str):
        B = kernel_rows(n_p, m_p) + int(B[4:])
    th = _cartpole_theta(B, 1)
    before = dict(admm_solve_cuda.launches_by_path)
    compare_with_plain(spec1, spec2, th, th, (200, 200),
                       (EXT_Z_ATOL, EXT_Y_ATOL))
    # above 1024 columns every batch takes "fac"
    assert kernel_path(n_p + m_p, B, n_p) == "fac"
    assert admm_solve_cuda.launches_by_path["fac"] == before["fac"] + 2


@pytest.mark.parametrize("plant", ["linear", "nonlinear"])
def test_extended_closed_loop_launches_both_qps(extended, plant):
    """Solver "cuda" on the card: 4 launches a step (2 QPs x 2 phases), 6
    where the arm runs on certificates; feasible, finite, and the loss-free
    rollouts agree with solver "admm" on the card."""
    from rtmpc_tpu_torch.apps.results_nonlinear import (
        build_nonlinear_plant_step)
    sc, (arrays, cfg) = extended
    B, T = 16, 6
    g = torch.Generator(device="cuda").manual_seed(2)
    theta, gamma = draw_loss_masks(g, T, 0.5, 0.5, (B,))
    nonlinear = plant == "nonlinear"
    w = draw_disturbances(g, T, -sc.w_hi * (not nonlinear),
                          sc.w_hi * (not nonlinear), (B,))
    refs = torch.zeros(B, T, 4, device="cuda")
    refs[:, :, 0] = sc.ref_value
    x0 = torch.zeros(B, 4, device="cuda")
    kw = dict(plant_step=build_nonlinear_plant_step(sc) if nonlinear
              else None,
              infeas_mode="certificate" if nonlinear else None)
    before = admm_solve_cuda.launches
    ck, ok = make_batched_rollout(arrays, cfg, T, **kw)(x0, refs, w, theta,
                                                       gamma)
    assert admm_solve_cuda.launches - before == (6 if nonlinear else 4) * T
    assert bool(ck.feasible.all()) and bool(torch.isfinite(ok.x).all())
    ca, oa = make_batched_rollout(
        arrays, dataclasses.replace(cfg, solver="admm"), T, **kw)(
            x0, refs, w, theta, gamma)
    assert torch.equal(ok.Theta, oa.Theta)
    assert (ok.x - oa.x).abs().max().item() <= 1e-3


def test_step_profile_reads_the_extended_step(extended):
    res = _step_profile("--batch", 16, "--steps", 2, "--controller",
                        "extended", "--solver", "cuda", "--plant",
                        "nonlinear")
    assert res["k1_launches_per_step"] == 4
    assert res["spans"]["rtmpc.k1"]["device_ops"] == 4 * 2
    assert res["plant_device_ops_per_call"] > 10
    res = _step_profile("--batch", 8, "--steps", 1, "--controller",
                        "extended", "--solver", "ip_riccati", "--plant",
                        "linear")
    assert res["ip_iterations_per_step"] > 3
    assert "k1_ms_per_launch" not in res
    # the profiled step runs the iterations of the timed one
    assert (res["spans"]["rtmpc.ip.iteration"]["count"]
            == res["ip_iterations_per_step"])
    assert (res["ip_dispatch_ms_per_iteration"]
            > res["ip_exit_wait_ms_per_iteration"] > 0)


# ---------------------------------------------------------------------------
# The single-instance controllers: the served session on CUDA graphs (K1 at
# B=1 inside the graph), the dense interior point and the polish
# ---------------------------------------------------------------------------

def _session_inputs(K, seed):
    from rtmpc_tpu_torch.apps.serve_controller import session_inputs
    refs, theta, gamma, w = session_inputs(seed, K, 0.4)
    return (torch.tensor(refs, dtype=torch.float32),
            torch.tensor(w, dtype=torch.float32),
            torch.tensor(theta, dtype=torch.int32),
            torch.tensor(gamma, dtype=torch.int32))


def test_session_graph_equals_eager(flagship_cuda):
    """One window of 40 ticks replayed from the captured graph equals the
    same ticks run eagerly from the same carry (1e-6; the same kernels on
    the same inputs read 0); the next window resumes from the graph's
    carry as an eager rollout resumes from its own."""
    from rtmpc_tpu_torch.parallel.session import Session
    arrays, cfg = flagship_cuda
    K = 40
    session = Session(arrays, cfg, K, [0.0, 0.0])
    assert session.graph is not None
    rollout = make_batched_rollout(arrays, cfg, K)
    carry = session.snapshot()
    for seed in (0, 1):
        inp = _session_inputs(K, seed)
        got = session.advance(*inp)
        carry, want = rollout(None, *(a[None].cuda() for a in inp),
                              carry0=carry)
        torch.cuda.synchronize()
        for name, a, b in zip(want._fields, got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
        torch.testing.assert_close(session.carry.x, carry.x, rtol=0,
                                   atol=1e-6)


def test_session_launches_are_captured_times_replays(flagship_cuda):
    """K1 launches once a phase at capture (2 a tick); replays launch
    nothing on the host, and the session counts captured x replays."""
    from rtmpc_tpu_torch.parallel.session import Session
    arrays, cfg = flagship_cuda
    K = 10
    before = admm_solve_cuda.launches
    session = Session(arrays, cfg, K, [0.0, 0.0])
    assert session.captured_launches == 2 * K
    assert admm_solve_cuda.launches == before + 4 * K   # warm-up + capture
    inp = _session_inputs(K, 2)
    for _ in range(3):
        session.advance(*inp)
    torch.cuda.synchronize()
    assert admm_solve_cuda.launches == before + 4 * K
    assert session.replays == 3 and session.launches == 6 * K


def test_per_dispatch_timers_on_the_card(flagship_cuda):
    from rtmpc_tpu_torch.parallel.latency import (device_step_time,
                                                  dispatch_floor_s,
                                                  measure_step_latencies)
    arrays, cfg = flagship_cuda
    refs, w, theta, gamma = _session_inputs(12, 3)
    times = measure_step_latencies(arrays, cfg, refs, w, theta, gamma)
    assert times.shape == (12,) and bool((times > 0).all())
    dispatch = float(np.median(times))
    per_tick = device_step_time(arrays, cfg, refs, w, theta, gamma)
    assert 0 < per_tick < dispatch
    assert 0 < dispatch_floor_s("cuda") < dispatch


def test_dense_ip_and_polish_card_match_cpu():
    """The dense interior point (30 iterations) and the ADMM polish on the
    card against the CPU, float64, flagship QP, 16 thetas: z within 1e-9,
    r_prim within 1e-12 (the same algorithm; sums in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtmpc_tpu_torch.ops.ip import ip_solve
    from rtmpc_tpu_torch.ops.qp import admm_solve
    setup = flagship_setup()
    th = np.random.default_rng(4).uniform(-2, 2, (16, 4))
    for solver in ("ip", "admm"):
        sols = {}
        for dev in ("cpu", "cuda"):
            arrays, _ = setup.to_device(torch.float64, dev, solver=solver,
                                        ip_iters=30)
            t = torch.tensor(th, device=dev)
            sols[dev] = (ip_solve(arrays.ip, t, 30) if solver == "ip" else
                         admm_solve(arrays.admm, t, iters=120, polish=True))
        torch.testing.assert_close(sols["cuda"].z_primal.cpu(),
                                   sols["cpu"].z_primal, rtol=0, atol=1e-9)
        torch.testing.assert_close(sols["cuda"].r_prim.cpu(),
                                   sols["cpu"].r_prim, rtol=0, atol=1e-12)


def test_session_captures_the_dense_ip():
    """The dense interior point's per-iteration LU factorizations capture
    in a window graph too (float64 on the card, 3 ticks); the graph's
    window equals the same ticks run eagerly (1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtmpc_tpu_torch.parallel.session import Session
    arrays, cfg = flagship_setup().to_device(torch.float64, "cuda",
                                             solver="ip", ip_iters=30)
    session = Session(arrays, cfg, 3, [0.5, -0.2])
    assert session.graph is not None and session.captured_launches == 0
    inp = _session_inputs(3, 4)
    carry = session.snapshot()
    got = session.advance(*(a.double() if a.is_floating_point() else a
                            for a in inp))
    _, want = make_batched_rollout(arrays, cfg, 3)(
        None, *((a.double() if a.is_floating_point() else a)[None].cuda()
                for a in inp), carry0=carry)
    torch.cuda.synchronize()
    for name, a, b in zip(want._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)


# ---------------------------------------------------------------------------
# Fig. 3d: the interior points captured one tick a graph; K1 on the
# condensed QPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["ip_riccati", "ip", "admm"])
def test_one_tick_graph_equals_eager_float64_solvers(solver):
    """A one-tick session of the flagship in float64 under each interior
    point (the structured one runs its whole iteration budget under
    capture, with no read of the device) and under the polished ADMM (the
    polish's LU checks nothing on the host), replayed 10 ticks, equals the
    same 10 ticks run eagerly (the structured IP with its early exit) to
    1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtmpc_tpu_torch.parallel.session import Session
    kw = (dict(ip_iters=30) if solver.startswith("ip")
          else dict(KW, polish=True))
    arrays, cfg = flagship_setup().to_device(torch.float64, "cuda",
                                             solver=solver, **kw)
    K = 10
    session = Session(arrays, cfg, 1, [0.5, -0.2])
    assert session.graph is not None
    assert session.capture_s > 0 and session.instantiate_s > 0
    refs, w, theta, gamma = (a.double() if a.is_floating_point() else a
                             for a in _session_inputs(K, 5))
    ticks = []
    for t in range(K):
        o = session.advance(refs[t:t + 1], w[t:t + 1], theta[t:t + 1],
                            gamma[t:t + 1])
        ticks.append(tuple(a.clone() for a in o))
    got = [torch.cat(f, dim=1) for f in zip(*ticks)]
    _, want = make_batched_rollout(arrays, cfg, K)(
        torch.tensor([[0.5, -0.2]], dtype=torch.float64, device="cuda"),
        *(a[None].cuda() for a in (refs, w, theta, gamma)))
    torch.cuda.synchronize()
    for name, a, b in zip(want._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9, msg=name)


@pytest.mark.parametrize("B", [1, "rows+1", 4099])
def test_condensed_flagship_matches_plain_version(B):
    """K1 on the condensed flagship QP (16 + 96 columns, the smem path)
    against its plain version, at the bars of ``kernel_bench.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtmpc_tpu_torch.ops.kernel_bench import (COND_F64_SMALL_B,
                                                  COND_RPRIM_ATOL,
                                                  COND_Y_ATOL)
    a32, _ = flagship_setup().to_device(torch.float32, "cuda", solver="cuda",
                                        condensed=True, **KW)
    a64, _ = flagship_setup().to_device(torch.float64, "cuda", solver="cuda",
                                        condensed=True, **KW)
    n_p, m_p = a32.admm.Kinv.shape[0], a32.admm.As.shape[0]
    assert (n_p + m_p, kernel_path(n_p + m_p)) == (112, "smem")
    if isinstance(B, str):
        B = kernel_rows(n_p, m_p) + 1
    th = _theta(B, 7)
    compare_with_plain(a32.admm, a32.admm2, th, th, (60, 60),
                       (Z_ATOL, COND_Y_ATOL, COND_RPRIM_ATOL),
                       specs64=(a64.admm, a64.admm2),
                       f64_bars=COND_F64_SMALL_B if B < 200 else None)


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("arm", ["tube", "track"])
def test_condensed_cartpole_matches_plain_version(cartpole, arm, B):
    """K1 on the condensed cartpole QPs (32 + 712 and 32 + 760: the cluster
    path, 16 rows a cluster) against its plain version."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    from rtmpc_tpu_torch.ops.kernel_bench import (COND_CP_F64_SMALL_B,
                                                  COND_CP_Y_ATOL)
    specs = {}
    for dt in (torch.float32, torch.float64):
        a, _ = cartpole[1][arm].to_device(dt, "cuda", solver="cuda",
                                          condensed=True, **ADMM_SCHEDULE)
        specs[dt] = (a.admm, a.admm2)
    n_p, m_p = specs[torch.float32][0].Kinv.shape[0], \
        specs[torch.float32][0].As.shape[0]
    assert kernel_path(n_p + m_p) == "l2" and kernel_rows(n_p, m_p) == 16
    th = _cartpole_theta(B, 3)
    compare_with_plain(*specs[torch.float32], th, th, (200, 200),
                       (CP_Z_ATOL, COND_CP_Y_ATOL),
                       specs64=specs[torch.float64],
                       f64_bars=COND_CP_F64_SMALL_B if B == 1 else None)


# ---------------------------------------------------------------------------
# Data parallelism: K1 on another card than the caller's current one, and a
# sweep sharded over two ranks on one card
# ---------------------------------------------------------------------------

def test_kernel_on_second_card_keeps_current_device():
    """K1 on cuda:1 while the thread's current device is 0: equal to its
    plain version at the flagship shape, and the current device is 0
    again after the launch (a rank must not have its device switched)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: K1 on cuda:1 with the current "
                    "device 0")
    torch.cuda.set_device(0)
    arrays, _ = flagship_setup().to_device(torch.float32, "cuda:1",
                                           solver="cuda", **KW)
    th = _theta(4099, 11).to("cuda:1")
    before = admm_solve_cuda.launches
    got = admm_solve_cuda(arrays.admm, th, None, 60)
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(1)
    assert admm_solve_cuda.launches == before + 1
    assert got.state.x.device == torch.device("cuda", 1)
    want = _admm_solve_cuda_plain(arrays.admm, th, None, 60)
    _assert_close(got, want)


def test_two_rank_gloo_sweep_on_card_equals_one_process():
    """``run_mc_sweep`` sharded over two gloo ranks (on a one-card machine
    both share cuda:0; rank r takes card r modulo the cards): both ranks'
    results identical, equal to the one-process sweep on the same draws
    (trajectories within 1e-5, feasibility equal), K1 launched 2 a step on
    each rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ADMM kernel has no CPU mode")
    from rtmpc_tpu_torch.parallel import draw_sweep, run_mc_sweep
    from rtmpc_tpu_torch.parallel.ranks import spawn_ranks, sweep_rank
    T, n_mc = 30, 512
    refs = np.zeros((T, 2))
    refs[:, 0] = 4.0
    sweep = dict(T=T, n_mc=n_mc, loss_probs=[0.7], refs=refs,
                 x0=np.zeros(2), w_lo=-0.1 * np.ones(2),
                 w_hi=0.1 * np.ones(2),
                 draws=draw_sweep(torch.Generator().manual_seed(3), T, n_mc,
                                  [0.7], 2))
    to_dev = dict(dtype=torch.float32, solver="cuda", **KW)
    setup = flagship_setup()
    ranks = spawn_ranks(sweep_rank, 2, ([(setup, to_dev, sweep)], "cuda"),
                        timeout=180.0)
    arrays, cfg = setup.to_device(device="cuda", **to_dev)
    one = run_mc_sweep(arrays, cfg, **sweep)
    (r0,), (r1,) = ranks
    for f in ("traj", "x_nom", "tracking_error", "feasible"):
        np.testing.assert_array_equal(getattr(r0["result"], f),
                                      getattr(r1["result"], f), err_msg=f)
    assert r0["launches"] == r1["launches"] == 2 * T
    cards = torch.cuda.device_count()
    assert (r0["device"], r1["device"]) == ("cuda:0", f"cuda:{1 % cards}")
    res = r0["result"]
    np.testing.assert_array_equal(res.feasible, one.feasible)
    assert res.feasible.all()
    assert np.abs(res.traj - one.traj).max() <= 1e-5


def test_two_rank_nccl_sweep_across_cards_equals_one_process(tmp_path):
    """The sweep over NCCL, one card a rank (cuda:0 and cuda:1), in two
    chunks with a checkpoint (the ranks meet at a barrier of the NCCL
    group; the gather rides a gloo group beside it): both ranks' results
    identical and equal to one process on cuda:0 (trajectories within
    1e-5), K1 2 launches a step on each rank."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL puts one rank on each")
    from rtmpc_tpu_torch.parallel import draw_sweep, run_mc_sweep
    from rtmpc_tpu_torch.parallel.ranks import spawn_ranks, sweep_rank
    T, n_mc, probs = 30, 256, [0.3, 0.7]
    refs = np.zeros((T, 2))
    refs[:, 0] = 4.0
    sweep = dict(T=T, n_mc=n_mc, loss_probs=probs, refs=refs,
                 x0=np.zeros(2), w_lo=-0.1 * np.ones(2),
                 w_hi=0.1 * np.ones(2), n_chunks=2,
                 draws=draw_sweep(torch.Generator().manual_seed(4), T, n_mc,
                                  probs, 2))
    to_dev = dict(dtype=torch.float32, solver="cuda", **KW)
    setup = flagship_setup()
    ranks = spawn_ranks(
        sweep_rank, 2,
        ([(setup, to_dev,
           dict(sweep, checkpoint_path=str(tmp_path / "ck.npz")))], "cuda"),
        backend="nccl", timeout=180.0)
    arrays, cfg = setup.to_device(device="cuda:0", **to_dev)
    one = run_mc_sweep(arrays, cfg, **sweep)
    (r0,), (r1,) = ranks
    assert (r0["device"], r1["device"]) == ("cuda:0", "cuda:1")
    for f in ("traj", "x_nom", "tracking_error", "feasible"):
        np.testing.assert_array_equal(getattr(r0["result"], f),
                                      getattr(r1["result"], f), err_msg=f)
    assert r0["launches"] == r1["launches"] == 2 * 2 * T
    res = r0["result"]
    np.testing.assert_array_equal(res.feasible, one.feasible)
    assert np.abs(res.traj - one.traj).max() <= 1e-5


# ---------------------------------------------------------------------------
# The "fac" path inside CUDA graphs
# ---------------------------------------------------------------------------

def test_fac_one_tick_graph_equals_eager(cartpole):
    """A one-tick session (one CUDA graph replay a tick, as Fig. 3d runs)
    of the cartpole tube controller under solver "cuda": K1 at B=1 on the
    "fac" path (a cluster of 8 blocks) inside the graph; 6 ticks replayed
    equal the same ticks run eagerly (1e-6; the same kernels on the same
    inputs)."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    from rtmpc_tpu_torch.parallel.session import Session
    sc, setups = cartpole
    arrays, cfg = setups["tube"].to_device(torch.float32, "cuda",
                                           solver="cuda", **ADMM_SCHEDULE)
    K = 6
    rng = np.random.default_rng(6)
    refs = torch.zeros(K, 4)
    refs[:, 0] = sc.ref_value
    w = torch.tensor(rng.uniform(sc.w_lo, sc.w_hi, (K, 4)),
                     dtype=torch.float32)
    theta = torch.tensor(rng.integers(0, 2, K), dtype=torch.int32)
    gamma = torch.tensor(rng.integers(0, 2, K), dtype=torch.int32)
    before = admm_solve_cuda.launches_by_path["fac"]
    session = Session(arrays, cfg, 1, sc.x0)
    assert session.graph is not None
    assert admm_solve_cuda.launches_by_path["fac"] == before + 4
    ticks = []
    for t in range(K):
        o = session.advance(*(a[t:t + 1].cuda() for a in (refs, w, theta,
                                                           gamma)))
        ticks.append(tuple(a.clone() for a in o))
    got = [torch.cat(f, dim=1) for f in zip(*ticks)]
    _, want = make_batched_rollout(arrays, cfg, K)(
        torch.tensor(sc.x0, dtype=torch.float32, device="cuda")[None],
        *(a[None].cuda() for a in (refs, w, theta, gamma)))
    torch.cuda.synchronize()
    for name, a, b in zip(want._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


def test_fac_launches_are_counted_by_path(flagship_cuda, extended):
    """``launches_by_path["fac"]`` counts the served session's launches (a
    window's capture and its warm-up, K1 at B=1) and the extended arm's
    (1760 columns, B=16), and the flagship loop at B=16384 launches none
    of them (the smem path)."""
    from rtmpc_tpu_torch.parallel.session import Session
    arrays, cfg = flagship_cuda
    before = dict(admm_solve_cuda.launches_by_path)
    Session(arrays, cfg, 5, [0.0, 0.0])
    after = dict(admm_solve_cuda.launches_by_path)
    assert after["fac"] - before["fac"] == 4 * 5
    assert after["smem"] == before["smem"] and after["l2"] == before["l2"]
    B, T = 16384, 2
    g = torch.Generator(device="cuda").manual_seed(1)
    theta, gamma = draw_loss_masks(g, T, 0.7, 0.7, (B,))
    w = draw_disturbances(g, T, [-0.1, -0.1], [0.1, 0.1], (B,))
    refs = torch.zeros(B, T, 2, device="cuda")
    make_batched_rollout(arrays, cfg, T)(
        torch.zeros(B, 2, device="cuda"), refs, w, theta, gamma)
    torch.cuda.synchronize()
    later = dict(admm_solve_cuda.launches_by_path)
    assert later["smem"] - after["smem"] == 2 * T
    assert later["fac"] == after["fac"]
    sc, (ext_arrays, ext_cfg) = extended
    B = 16
    theta, gamma = draw_loss_masks(g, T, 0.5, 0.5, (B,))
    w = draw_disturbances(g, T, -sc.w_hi, sc.w_hi, (B,))
    refs = torch.zeros(B, T, 4, device="cuda")
    refs[:, :, 0] = sc.ref_value
    make_batched_rollout(ext_arrays, ext_cfg, T)(
        torch.zeros(B, 4, device="cuda"), refs, w, theta, gamma)
    torch.cuda.synchronize()
    last = dict(admm_solve_cuda.launches_by_path)
    assert last["fac"] - later["fac"] == 4 * T
    assert last["l2"] == later["l2"] and last["smem"] == later["smem"]
