"""Cartpole closed-loop animations of the two controller arms (counterpart
of ``rtmpc_tpu/apps/create_animations.py``).

    python3 -m rtmpc_tpu_torch.apps.create_animations --device cuda \\
        [--solver ip_riccati|ip|cuda|admm] [--dtype float64] \\
        [--loss-prob 0.4] [--quick] [--seed 0] [--no-figures] \\
        [--strip-dir DIR]

Equivalent of ``Results/create_animations.py``: one rollout of each arm on
the nonlinear cartpole at loss probability ``--loss-prob``, the tube arm
(RT-MPC, consistent actuator) and the tracking arm (R-MPC, smart
actuator), from the scenario's x0 over T=250 steps (60 under ``--quick``),
each as one batch-1 rollout on the device (``run``); the JAX app's checks
(finite, ``|phi| < 0.3``) run on the trajectories.  Then, on the host,
each trajectory is drawn as an animated GIF and as a strip of 8 of its
frames (PNG), under ``results/rtmpc_tpu_torch/`` (matplotlib and PIL;
``--no-figures`` skips them; the PyBullet renderer of the reference's
``cartpole.py:48-79`` becomes a matplotlib cart-and-pole drawing);
``--strip-dir`` writes each arm's strip to that directory too.

The draws (loss masks, then disturbances, which the nonlinear plant does
not use) come from a ``torch.Generator`` at ``--seed``; ``run`` takes
other draws (e.g. the JAX app's) as ``draws``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .common import (add_figure_args, cartpole_controllers, check,
                     device_name, example_draws, figures_on, make_parser,
                     resolve, results_dir, solver_kwargs, timed_rollout)
from .results_nonlinear import build_nonlinear_plant_step
from .scenarios import cartpole_scenario

# (arm, controller of common.cartpole_controllers, actuator mode)
ARMS = (("tube", "tube", "consistent"), ("track", "track", "smart"))
QUICK_T = 60


def parse_args(argv=None):
    p = add_figure_args(make_parser(__doc__))
    p.add_argument("--loss-prob", type=float, default=0.4)
    p.add_argument("--strip-dir", default=None,
                   help="also write each arm's strip of frames (PNG) to "
                        "this directory")
    return p.parse_args(argv)


def run(args, setups=None, draws=None) -> dict:
    """Both arms' rollouts on the nonlinear plant; ``setups``: the
    controllers ``tube`` and ``track`` already set up; ``draws``: a dict
    of ``theta``, ``gamma`` ``(T,)`` and ``w`` ``(T, 4)`` arrays in place
    of the drawn ones.  Returns ``ok`` (the checks), ``traj`` by arm
    (``(T+1, 4)`` float64 numpy, x0 first), ``max_phi``, ``seconds`` and
    ``launches`` by arm, and the ``draws``."""
    from ..parallel import make_batched_rollout
    dev = resolve(args)
    dtype = getattr(torch, args.dtype)
    sc = cartpole_scenario()
    T = QUICK_T if args.quick else sc.T
    print(f"device {device_name(dev)}, solver {args.solver}, {args.dtype}, "
          f"T={T}, loss probability {args.loss_prob}")
    if setups is None:
        setups = cartpole_controllers(sc, [c for _, c, _ in ARMS])
    d = example_draws(args, T, w_half=sc.w_hi, p_loss=args.loss_prob,
                      draws=draws)
    plant_step = build_nonlinear_plant_step(sc)
    refs = torch.zeros(1, T, 4, dtype=dtype)
    refs[..., 0] = sc.ref_value
    x0 = torch.tensor(sc.x0, dtype=dtype)[None]
    inputs = [t.to(dev) for t in (x0, refs, d["w"][None].to(dtype),
                                  d["theta"][None].to(torch.int32),
                                  d["gamma"][None].to(torch.int32))]
    ok, traj, max_phi, seconds, launches = True, {}, {}, {}, {}
    for arm, controller, mode in ARMS:
        arrays, cfg = setups[controller].to_device(dtype, dev,
                                                   **solver_kwargs(args))
        roll = make_batched_rollout(arrays, cfg, T, actuator_mode=mode,
                                    plant_step=plant_step)
        (_, outs), seconds[arm], launches[arm] = timed_rollout(
            lambda: roll(*inputs), dev)
        traj[arm] = np.vstack([sc.x0[None],
                               outs.x[0].double().cpu().numpy()])
        phi = max_phi[arm] = float(np.abs(traj[arm][:, 2]).max())
        ok &= check(f"{arm} rollout finite",
                    bool(np.isfinite(traj[arm]).all()))
        ok &= check(f"{arm} pole angle bounded (|phi| < 0.3)", phi < 0.3,
                    f"max |phi| = {phi:.3f}")
    return dict(ok=bool(ok), traj=traj, max_phi=max_phi, seconds=seconds,
                launches=launches, draws=d)


def render_gif(traj: np.ndarray, Th: float, path: str, title: str,
               every: int = 2) -> list:
    """Draw every ``every``-th state of ``traj (T+1, 4)`` as a cart and
    pole and write the frames as an animated GIF at ``path``; returns the
    frames (PIL images)."""
    import matplotlib.pyplot as plt
    from PIL import Image
    frames = []
    half_len = 0.5
    for t in range(0, traj.shape[0], every):
        p, _, phi, _ = traj[t]
        fig, ax = plt.subplots(figsize=(4, 2.6), dpi=80)
        ax.plot([-1.5, 1.5], [0, 0], "k-", lw=1)
        ax.add_patch(plt.Rectangle((p - 0.15, -0.05), 0.3, 0.1, fc="C0"))
        # phi measured from upright
        tip = (p + 2 * half_len * np.sin(phi), 2 * half_len * np.cos(phi))
        ax.plot([p, tip[0]], [0.05, tip[1]], "C1-", lw=3)
        ax.plot(tip[0], tip[1], "C1o", ms=8)
        ax.set_xlim(-1.5, 1.5)
        ax.set_ylim(-0.3, 1.3)
        ax.set_aspect("equal")
        ax.set_title(f"{title}  t={t * Th:.2f}s")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())
        frames.append(Image.fromarray(buf[:, :, :3]))
        plt.close(fig)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:], loop=0,
                   duration=int(1000 * Th * every))
    print(f"[gif] {path} ({len(frames)} frames)")
    return frames


def render_strip(frames: list, path: str, n: int = 8) -> str:
    """A horizontal strip of ``n`` equally spaced frames, the still form of
    the GIF, written as a PNG at ``path``."""
    from PIL import Image
    idx = np.linspace(0, len(frames) - 1, n).astype(int)
    imgs = [frames[i] for i in idx]
    strip = Image.new("RGB", (sum(im.width for im in imgs), imgs[0].height),
                      "white")
    xoff = 0
    for im in imgs:
        strip.paste(im, (xoff, 0))
        xoff += im.width
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    strip.save(path)
    print(f"[strip] {path} ({n} frames)")
    return path


def write_figures(args, traj: dict, every: int = 2) -> list:
    """Each arm's GIF and strip under ``results_dir()``, and its strip
    under ``args.strip_dir`` too where that is set; ``traj`` by arm as
    ``run`` returns it.  Returns the paths written."""
    Th = cartpole_scenario().Th
    paths = []
    for arm, tr in traj.items():
        name = f"animation_{arm}_p{args.loss_prob:.1f}"
        stem = os.path.join(results_dir(), name)
        frames = render_gif(tr, Th, stem + ".gif",
                            f"{arm} MPC, p={args.loss_prob}", every=every)
        paths += [stem + ".gif", render_strip(frames, stem + "_strip.png")]
        if args.strip_dir:
            paths.append(render_strip(frames, os.path.join(
                args.strip_dir, name + "_strip.png")))
    return paths


def main(argv=None) -> int:
    args = parse_args(argv)
    figures = figures_on(args, "PIL")
    out = run(args)
    if figures:
        write_figures(args, out["traj"])
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
