"""Interferometric-visibility driver — the port's `grtrace.cli.visibility`:
render -> u-v observables.

    # M87*-scaled visibilities of the lensed disk (amplitude map, radial
    # profile, first-null ring diameter, closure phases):
    python -m grtrace_torch.cli.visibility --spin 0.9 --no-plots \
        --mass-msun 6.5e9 --distance-mpc 16.8

The default scene is the thin disk around a = 0.9 seen from 12 degrees
(256 x 256, 20k steps, delta 0.02: kernel B6 on the card); --no-disk
renders the lensed procedural starfield instead (B5, or B1 at spin 0).
The FFTs run on the render's device.  Writes visibility_radial.csv
(baseline, azimuthal-mean |V|), closure_phases.csv,
visibility_metrics.json and, unless --no-plots (which the JAX driver does
not have), visibility_amp.png; prints one JSON metrics line (first null,
thin-ring diameter in microarcseconds).

Camera angles convert to Earth angles with theta = alpha_cam * r0 /
sqrt(1 - 2M/r0) * M_geom / D (the camera sits at r0 = 30 M, not at
infinity; engine/visibility.camera_to_earth).
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="u-v-plane visibilities of a rendered scene")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=20_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--metric', type=str, default='kerr',
                   choices=['schwarzschild', 'kerr'])
    p.add_argument('--spin', type=float, default=0.9)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--disk', action='store_true', default=True,
                   help='render the thin-disk scene (default; --no-disk '
                        'for pure background lensing)')
    p.add_argument('--no-disk', dest='disk', action='store_false')
    p.add_argument('--disk-elevation', type=float, default=12.0)
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--mass-msun', type=float, default=None,
                   help='black-hole mass (default: the preset, M87*)')
    p.add_argument('--distance-mpc', type=float, default=None,
                   help='distance (default: the preset, M87*)')
    p.add_argument('--preset', choices=('m87', 'sgra'), default='m87',
                   help='source preset for mass/distance')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='write the CSVs and JSON only (the figure needs '
                        'matplotlib)')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def _triangles(duc):
    """A deterministic fan of grid-aligned closed triangles spanning the
    ring scale (the JAX driver's)."""
    import numpy as np

    tris = []
    for s in (3, 5, 8, 12, 17, 23):
        for rot in range(4):
            l1 = np.array([s, rot - 2]) * duc
            l2 = np.array([rot - 2, s]) * duc
            tris.append([l1, l2, -(l1 + l2)])
    return np.asarray(tris)


def _figure(path, amp, u, v, base, prof, b_null):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.6))
    ext = [u.min() / 1e9, u.max() / 1e9, v.min() / 1e9, v.max() / 1e9]
    im = ax1.imshow(np.log10(np.maximum(amp, 1e-8)), extent=ext,
                    origin="lower", cmap="magma")
    ax1.set_xlabel("u (G$\\lambda$)")
    ax1.set_ylabel("v (G$\\lambda$)")
    ax1.set_title("log$_{10}$ |V(u, v)|")
    fig.colorbar(im, ax=ax1)
    ax2.semilogy(base / 1e9, np.maximum(prof, 1e-8))
    if np.isfinite(b_null):
        ax2.axvline(b_null / 1e9, color="C1", ls="--",
                    label=f"first null {b_null / 1e9:.2f} G$\\lambda$")
        ax2.legend(fontsize=8)
    ax2.set_xlabel("baseline (G$\\lambda$)")
    ax2.set_ylabel("|V|")
    ax2.set_title("azimuthal mean")
    fig.tight_layout()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..engine.visibility import (PRESETS, camera_to_earth,
                                     closure_phases, complex_visibility,
                                     first_null, radial_profile,
                                     ring_diameter_from_null, visibility_map)
    from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                            SceneConfig)
    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.visibility: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.visibility: the figure needs "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")
    os.makedirs(args.out_dir, exist_ok=True)

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov,
        metric='kerr' if (args.spin or args.charge) else 'schwarzschild',
        spin=args.spin, charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(
            steps=args.steps, delta=args.delta,
            backend=JAX_BACKENDS.get(args.backend, args.backend)),
        patch=PatchConfig())
    if args.disk:
        from ..engine.disk import DiskConfig, render_disk
        res = render_disk(scene, DiskConfig(r_out=args.disk_r_out,
                                            elevation_deg=args.disk_elevation),
                          bg_array=None, device=args.device)
    else:
        from ..engine.render import render
        from ..io import textures
        res = render(scene, bg_array=textures.starfield(args.size, args.size),
                     device=args.device)
    image = res.device("image")

    # camera-angle pixel scale, then the impact-parameter map to Earth
    preset = PRESETS[args.preset]
    mass_msun = args.mass_msun if args.mass_msun is not None \
        else preset["mass_msun"]
    distance_mpc = args.distance_mpc if args.distance_mpc is not None \
        else preset["distance_mpc"]
    pixel_cam = 2.0 * np.tan(np.radians(args.fov) / 2.0) / args.size
    to_earth = camera_to_earth(scene.observer_distance, scene.bh_mass,
                               mass_msun, distance_mpc)
    pixel_earth = pixel_cam * to_earth           # radians at Earth
    uas_per_px = np.degrees(pixel_earth) * 3.6e9

    amp, u, v = visibility_map(image, pixel_earth)
    # the ring structure lives far below Nyquist; zoom the profile
    base, prof = radial_profile(amp, u, v, n_bins=400,
                                b_max=min(u.max(), v.max()) / 4.0)

    # closure phases: station phases and image shifts cancel exactly
    visc, uc, vc = complex_visibility(image, pixel_earth)
    tris = _triangles(uc[1] - uc[0])
    cph = closure_phases(visc, uc, vc, tris)
    np.savetxt(
        os.path.join(args.out_dir, "closure_phases.csv"),
        np.column_stack([tris.reshape(len(tris), 6) / 1e9,
                         np.degrees(cph)]),
        delimiter=",", comments="", fmt="%.8g",
        header="u1_Gl,v1_Gl,u2_Gl,v2_Gl,u3_Gl,v3_Gl,closure_deg")
    b_null = first_null(base, prof)
    theta_d = ring_diameter_from_null(b_null) if np.isfinite(b_null) \
        else float("nan")
    np.savetxt(os.path.join(args.out_dir, "visibility_radial.csv"),
               np.column_stack([base / 1e9, prof]), delimiter=",",
               comments="", header="baseline_Glambda,visibility_amp",
               fmt="%.8g")
    if not args.no_plots:
        _figure(os.path.join(args.out_dir, "visibility_amp.png"), amp, u, v,
                base, prof, b_null)

    metrics = {
        "pixel_uas": round(uas_per_px, 4),
        "fov_uas": round(uas_per_px * args.size, 2),
        "closure_rms_deg": round(float(np.sqrt(
            np.mean(np.degrees(cph) ** 2))), 3),
        "first_null_Glambda": (round(b_null / 1e9, 4)
                               if np.isfinite(b_null) else None),
        "ring_diameter_uas": (round(np.degrees(theta_d) * 3.6e9, 3)
                              if np.isfinite(theta_d) else None),
        "mass_msun": mass_msun,
        "distance_mpc": distance_mpc,
        "preset": args.preset,
        "camera_to_earth_note": "camera angles mapped by the "
                                "impact-parameter factor r0/sqrt(1-2M/r0)",
    }
    print(json.dumps(metrics))
    with open(os.path.join(args.out_dir, "visibility_metrics.json"),
              "w") as f:
        json.dump(metrics, f, indent=1)
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
