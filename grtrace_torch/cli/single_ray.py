"""Single-ray diagnostic driver — the port's `grtrace.cli.single_ray` (the
reference's single_ray_cuda_test.py).

Integrates ONE float64 null geodesic with every step kept (through kernel
S1 on the card, its eager twin with --device cpu), truncates it at the
horizon, and writes the CSV and the 4-panel lambda-coloured figure; the
reference's defaults: its hard-coded momentum, 200k steps, delta 0.03,
omega 0.01, r_max 50, observer at r = 35.  The JAX driver's --platform
(it ran the one ray on the CPU) is --device here; --no-plots skips the
figure, which needs matplotlib.

Run: python -m grtrace_torch.cli.single_ray [--alpha-deg A] [--beta-deg B]
     [--b IMPACT] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

# the reference's hard-coded diagnostic direction (p_r, p_theta, p_phi)
DEFAULT_P_DIR = (-0.026942690335328513, -0.028502831807219468,
                 0.06898831276132347)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Single-ray geodesic diagnostic")
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--r-obs", type=float, default=35.0)
    p.add_argument("--r-max", type=float, default=50.0)
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--delta", type=float, default=0.03)
    p.add_argument("--omega", type=float, default=0.01)
    p.add_argument("--alpha-deg", type=float, default=None,
                   help="camera angle toward +y (deg)")
    p.add_argument("--beta-deg", type=float, default=0.0,
                   help="camera angle toward +z (deg)")
    p.add_argument("--b", type=float, default=None,
                   help="impact parameter; overrides --alpha-deg via "
                        "sin(a) = b/(r0 sqrt(1-2M/r0))")
    p.add_argument("--out-csv", type=str, default="single_ray_test.csv")
    p.add_argument("--out-png", type=str, default="single_ray_test.png")
    p.add_argument("--plot-step", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="run the ray on the CUDA card (kernel S1, the "
                        "default) or on the CPU (its eager twin)")
    p.add_argument("--no-plots", action="store_true",
                   help="skip the 4-panel figure (needs matplotlib)")
    return p


def initial_state(args, device="cpu"):
    """The ray's (q0, p0) as (1, 4) float64 tensors on `device`."""
    from ..physics.camera import angles_to_p_sph
    from ..physics.nullcond import build_null_4momentum
    from ..viz.plots import alpha_from_b

    pos_sph = torch.tensor([args.r_obs, np.pi / 2, 0.0], dtype=torch.float64)
    if args.b is not None or args.alpha_deg is not None:
        alpha = (alpha_from_b(args.b, args.r_obs, args.mass)
                 if args.b is not None else np.deg2rad(args.alpha_deg))
        p_dir = angles_to_p_sph(
            torch.tensor(alpha, dtype=torch.float64),
            np.deg2rad(args.beta_deg), args.r_obs, mass_bh=args.mass)
    else:
        p_dir = torch.tensor(DEFAULT_P_DIR, dtype=torch.float64)
    p0 = build_null_4momentum(p_dir, pos_sph, mass_bh=args.mass, future=True)
    q0 = torch.cat([torch.zeros(1, dtype=torch.float64), pos_sph])
    return (q0[None].to(device).contiguous(),
            p0[None].to(device).contiguous())


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.single_ray: no CUDA device; "
                         "pass --device cpu to run on the CPU")
    from ..viz import plots
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.single_ray: the figure needs "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")
    from ..engine.integrate import integrate_full_dispatch
    from ..io.artifacts import save_single_ray_csv

    q0, p0 = initial_state(args, device)
    print("Spherical position:", q0[0, 1:].cpu().numpy())
    print("Spherical direction:", p0[0, 1:].cpu().numpy())
    print("Null 4-momentum:", p0[0].cpu().numpy())

    print("Starting integration")
    traj = integrate_full_dispatch(
        q0, p0, args.steps, args.delta, 2.0 * args.mass, args.r_max,
        args.omega)[0].cpu().numpy()
    print("Integration complete")
    print(f"Trajectory length: {len(traj)} steps")

    # truncate at horizon capture (single_ray_cuda_test.py:307-310)
    rs = 2.0 * args.mass
    safe = traj[:, 1] > 1.1 * rs
    if not np.all(safe):
        traj = traj[: np.argmax(~safe)]
    print(f"Safe trajectory length: {len(traj)} steps")

    if not args.no_plots:
        print("Drawing trajectory plots...")
        plots.plot_geodesic(traj, mass_bh=args.mass,
                            step=max(1, args.plot_step),
                            out_path=args.out_png)
    save_single_ray_csv(traj, args.out_csv)
    print(f"Saved {args.out_csv}")
    return traj


def console(argv=None):
    """setuptools console-script entry (must not return a value — sys.exit
    would print it and exit non-zero)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
