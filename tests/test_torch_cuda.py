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
from rtmpc_tpu_torch.ops.qp_cuda import _admm_solve_cuda_plain, admm_solve_cuda
from rtmpc_tpu_torch.parallel import make_batched_rollout
from rtmpc_tpu_torch.protocol import draw_disturbances, draw_loss_masks

KW = dict(iters=60, iters2=60, alpha=1.8, rho2_scale=0.2)
Z_ATOL, Y_ATOL = 1e-4, 2e-3     # float32, as tests/test_qp_pallas.py


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


def _assert_close(got, want, y_atol=Y_ATOL):
    torch.testing.assert_close(got.z_primal, want.z_primal, rtol=0,
                               atol=Z_ATOL)
    torch.testing.assert_close(got.state.x, want.state.x, rtol=0, atol=Z_ATOL)
    torch.testing.assert_close(got.state.y, want.state.y, rtol=0,
                               atol=y_atol)
    torch.testing.assert_close(got.r_prim, want.r_prim, rtol=5e-2, atol=1e-4)
    torch.testing.assert_close(got.r_dual, want.r_dual, rtol=5e-2,
                               atol=1e-3)


@pytest.mark.parametrize("B", [1, 17, 4099])
def test_kernel_matches_plain_version(flagship_cuda, B):
    """Cold start at phase 1, then warm start at phase 2; the batch tail
    (B not a multiple of 16) is masked in the kernel."""
    arrays, _ = flagship_cuda
    th1, th2 = _theta(B, 0), _theta(B, 1)
    before = admm_solve_cuda.launches
    k1 = admm_solve_cuda(arrays.admm, th1, None, 60)
    p1 = _admm_solve_cuda_plain(arrays.admm, th1, None, 60)
    k2 = admm_solve_cuda(arrays.admm2, th2, p1.state, 60)
    p2 = _admm_solve_cuda_plain(arrays.admm2, th2, p1.state, 60)
    torch.cuda.synchronize()
    assert admm_solve_cuda.launches == before + 2
    _assert_close(k1, p1)
    _assert_close(k2, p2)


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

# float32 kernel vs plain version, the bars of chip_smoke.py phase 8 (5-10x
# the z 2.09e-4 / y 2.72e-3 read on an NVIDIA H100 80GB HBM3 at 700 W)
CP_Z_ATOL, CP_Y_ATOL = 1.5e-3, 2e-2
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


@pytest.mark.parametrize("B", [37, 200])
@pytest.mark.parametrize("arm", ["tube", "track"])
def test_l2_path_matches_plain_version(cartpole, arm, B):
    """The large-composite path (112 + 792 and 112 + 840 columns): 200
    cold iterations at phase 1, then 200 warm at phase 2."""
    from rtmpc_tpu_torch.apps.common import ADMM_SCHEDULE
    arrays, _ = cartpole[1][arm].to_device(torch.float32, "cuda",
                                           solver="cuda", **ADMM_SCHEDULE)
    th = _cartpole_theta(B, 0)
    before = dict(admm_solve_cuda.launches_by_path)
    k1 = admm_solve_cuda(arrays.admm, th, None, 200)
    p1 = _admm_solve_cuda_plain(arrays.admm, th, None, 200)
    k2 = admm_solve_cuda(arrays.admm2, th, p1.state, 200)
    p2 = _admm_solve_cuda_plain(arrays.admm2, th, p1.state, 200)
    torch.cuda.synchronize()
    assert admm_solve_cuda.launches_by_path["l2"] == before["l2"] + 2
    for k, p in ((k1, p1), (k2, p2)):
        torch.testing.assert_close(k.z_primal, p.z_primal, rtol=0,
                                   atol=CP_Z_ATOL)
        torch.testing.assert_close(k.state.y, p.state.y, rtol=0,
                                   atol=CP_Y_ATOL)
        assert bool(torch.isfinite(k.r_prim).all())


def test_kernel_refuses_too_wide_qps(flagship_cuda):
    from rtmpc_tpu_torch.ops.qp_cuda import kernel_path
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
