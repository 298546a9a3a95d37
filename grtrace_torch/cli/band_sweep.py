"""Theta-band sweep driver — the port's `grtrace.cli.band_sweep` (the
reference's test-band-axis.py).

Renders the reference driver's scene (M = 1, observer x = 20, boundary 21,
500x500, 30k steps, delta 0.05) through kernel B1 on the card, then builds
N custom rays spanning theta in [0, pi) at phi in pi +/- 10 deg, records
their trajectories through kernel S1 (500 points a ray) and plots them in
3D (matplotlib; --no-plots skips the figure).  --device cpu runs the eager
twins.  Rays are float32 (the JAX driver's on its accelerator; it takes
float64 from jax's x64 flag).  `main` returns the render's result and the
(N, 500, 4) trajectories.

Run: python -m grtrace_torch.cli.band_sweep [flags]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# scene constants of the reference driver (test-band-axis.py:34-39)
BH_MASS, OBS_X, BOUNDARY = 1.0, 20.0, 21.0
N_KEEP = 500


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="theta-band geodesic sweep")
    p.add_argument('--size', type=int, default=500)
    p.add_argument('--fov', type=float, default=90)
    p.add_argument('--steps', type=int, default=30_000)
    p.add_argument('--delta', type=float, default=0.05)
    p.add_argument('--omega', type=float, default=0.001)
    p.add_argument('--n-rays', type=int, default=50)
    p.add_argument('--background', type=str, default=None)
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--out-dir', type=str, default='images')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'])
    p.add_argument('--no-plots', action='store_true',
                   help='skip the 3D figure (needs matplotlib)')
    return p


def scene_from_args(args):
    from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                            SceneConfig)
    return SceneConfig(
        size=args.size, fov_deg=args.fov, background=args.background,
        bh_mass=BH_MASS, boundary_radius=BOUNDARY, observer_distance=OBS_X,
        integrator=IntegratorConfig(
            steps=args.steps, delta=args.delta, omega=1.0,
            backend=JAX_BACKENDS.get(args.backend, args.backend)),
        patch=PatchConfig(center_theta=np.pi / 2, center_phi=np.pi,
                          size_theta=np.deg2rad(126),
                          size_phi=np.deg2rad(224),
                          flip_theta=True, flip_phi=True),
        n_samples=0)


def band_rays(n_rays, seed, dtype=torch.float32, device="cpu"):
    """The custom theta-band rays (test-band-axis.py:73-93): (q0, p0) as
    (n_rays, 4) tensors on `device`."""
    from ..physics.camera import initial_conditions
    rng = np.random.default_rng(seed)
    thetas = np.linspace(0, np.pi, n_rays, endpoint=False)
    phis = rng.uniform(np.pi - np.deg2rad(10), np.pi + np.deg2rad(10),
                       n_rays)
    dirs = np.stack([-np.sin(thetas) * np.cos(phis),
                     np.sin(thetas) * np.sin(phis),
                     np.cos(thetas)], axis=-1)
    obs = np.array([OBS_X, 0.0, 0.0])
    pixel_pos = obs + dirs  # fictitious screen pixels
    q0, p0, *_ = initial_conditions(
        torch.tensor(obs, dtype=dtype, device=device),
        torch.tensor(pixel_pos, dtype=dtype, device=device),
        mass_bh=BH_MASS)
    return q0.contiguous(), p0.contiguous()


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.band_sweep: no CUDA device; "
                         "pass --device cpu to run on the CPU")
    from ..viz import plots
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.band_sweep: the figure needs "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")
    from ..engine.integrate import integrate_full_dispatch
    from ..engine.render import render
    from ..io import artifacts
    from ..physics.coords import spherical_to_cartesian

    scene = scene_from_args(args)
    bg = None
    if artifacts.background_available(args.background):
        bg = artifacts.load_background(args.background,
                                      size=(args.size, args.size))
    res = render(scene, bg_array=bg, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(res.image,
                         os.path.join(args.out_dir, 'theta_band_image.png'))
    print(f"wrote {args.out_dir}/theta_band_image.png")

    q0, p0 = band_rays(args.n_rays, args.seed, device=device)
    traj = integrate_full_dispatch(
        q0, p0, args.steps, args.delta, 2.0 * BH_MASS, BOUNDARY, 1.0,
        n_keep=N_KEEP).cpu().numpy()
    if args.no_plots:
        return res, traj

    # 3D plot (test-band-axis.py:104-136)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection='3d')
    rs = 2 * BH_MASS
    ph_g, th_g = np.mgrid[0:2 * np.pi:40j, 0:np.pi:20j]
    ax.plot_surface(rs * np.sin(th_g) * np.cos(ph_g),
                    rs * np.sin(th_g) * np.sin(ph_g),
                    rs * np.cos(th_g), color='black', alpha=1.0)
    ax.plot_wireframe(rs * np.sin(th_g) * np.cos(ph_g),
                      rs * np.sin(th_g) * np.sin(ph_g),
                      rs * np.cos(th_g), color='yellow', linewidth=0.3)
    ax.scatter([OBS_X], [0], [0], s=60, color='red')
    for k in range(args.n_rays):
        pts = torch.as_tensor(traj[k], dtype=torch.float64)
        keep = ~torch.all(pts == 0, dim=1)
        xx, yy, zz = spherical_to_cartesian(pts[keep, 1], pts[keep, 2],
                                            pts[keep, 3])
        ax.plot(xx.numpy(), yy.numpy(), zz.numpy(), lw=0.8, color='orange')
    ax.set_xlabel('x'); ax.set_ylabel('y'); ax.set_zlabel('z')
    ax.set_title('theta-band (pi +/- 10 deg) null geodesics')
    lim = BOUNDARY * 1.1
    for axis in 'xyz':
        getattr(ax, f'set_{axis}lim')([-lim, lim])
    plt.tight_layout()
    out_png = os.path.join(args.out_dir, 'theta_band_trajectories.png')
    plt.savefig(out_png, dpi=200)
    plt.close(fig)
    print(f"wrote {out_png}")
    return res, traj


def console(argv=None):
    """setuptools console-script entry (must not return a value — sys.exit
    would print it and exit non-zero)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
