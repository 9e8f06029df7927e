"""The CUDA ADMM kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU (the kernel is built for sm_90a and has no
CPU mode); without one they skip.  This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtmpc_tpu_torch.models import flagship_setup
from rtmpc_tpu_torch.ops.kernel_bench import (CP_Y_ATOL, CP_Z_ATOL, Y_ATOL,
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
    before = dict(admm_solve_cuda.launches_by_path)
    errs = compare_with_plain(spec1, spec2, _theta(B, 0), _theta(B, 1),
                              (60, 60), (Z_ATOL, y_atol))
    assert admm_solve_cuda.launches_by_path["smem"] == before["smem"] + 2
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


def test_step_profile_reads_the_kernel(flagship_cuda):
    """The step profiler finds both ADMM launches of every step in the
    profiler's device events."""
    from rtmpc_tpu_torch.parallel.step_profile import profile_steps
    res = profile_steps(batch=64, steps=2)
    assert res["k1_launches_per_step"] == 2
    assert 0 < res["k1_share_of_device_time"] <= 1
    assert 0 < res["busy_share_profiled"] <= 1.05
    assert res["other_device_ops_per_step"] > 0


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
    before = dict(admm_solve_cuda.launches_by_path)
    compare_with_plain(spec1, spec2, th, th, (iters, iters), bars)
    assert admm_solve_cuda.launches_by_path["l2"] == before["l2"] + 2


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
