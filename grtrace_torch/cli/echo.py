"""Lamp-post reverberation driver — the port's `grtrace.cli.echo`: X-ray
echo transfer functions.

    python -m grtrace_torch.cli.echo --spin 0.9 --height 10 --size 192 \
        --no-plots

Two legs (engine/echo.py): the lamp-post source fan (one float64 launch
of kernel B6) and one disk render (B6 again, float32); writes the GR
emissivity profile, the lag profile, a JSON summary and, unless --no-plots
(which the JAX driver does not have), the emissivity and transfer-function
figures; prints one JSON metrics line.  With charge the disk's inner edge
is the autodiff ISCO (physics/epicyclic.py).  --device cpu runs the eager
twins.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="lamp-post reverberation transfer functions")
    p.add_argument('--size', type=int, default=192)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=30_000)
    p.add_argument('--delta', type=float, default=0.05)
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--height', type=float, default=10.0,
                   help='Lamp-post height on the spin axis [M]')
    p.add_argument('--fan-rays', type=int, default=768,
                   help='Rays in the source fan (1D, axisymmetric)')
    p.add_argument('--elevation', type=float, default=30.0,
                   help='Camera elevation above the disk plane (deg)')
    p.add_argument('--r-out', type=float, default=20.0)
    p.add_argument('--weight-power', type=float, default=4.0,
                   help='g_obs exponent of the reflected intensity '
                        '(4 = bolometric, 3 = photon counts)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='write the CSVs and JSON only (the figures need '
                        'matplotlib)')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")
    if args.height <= 0:
        raise SystemExit("--height must be positive (above the hole)")

    import numpy as np
    import torch

    from ..engine.disk import DiskConfig, disk_observer_position, render_disk
    from ..engine.echo import (save_echo_artifacts, trace_lamppost,
                               transfer_function)
    from ..io.scene import IntegratorConfig, PatchConfig, SceneConfig
    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.echo: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.echo: the figures need "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, metric='kerr', spin=args.spin,
        charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta),
        patch=PatchConfig())
    disk = DiskConfig(r_out=args.r_out, elevation_deg=args.elevation,
                      show_background=False)

    fan = trace_lamppost(args.height,
                         [scene.bh_mass, args.spin, args.charge],
                         n_rays=args.fan_rays, steps=args.steps,
                         delta=args.delta, device=args.device)
    result = render_disk(scene, disk, device=args.device)

    obs_pos = disk_observer_position(scene, disk)
    t_direct = float(np.linalg.norm(
        obs_pos - np.array([0.0, 0.0, args.height])))
    tf = transfer_function(result, fan, weight_power=args.weight_power,
                           t_direct=t_direct)

    os.makedirs(args.out_dir, exist_ok=True)
    written, summary = save_echo_artifacts(fan, tf, args.out_dir,
                                           fan["params"],
                                           plots=not args.no_plots)
    metrics = summary | {"spin": args.spin, "t_direct_M": t_direct,
                         "files": len(written)}
    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
