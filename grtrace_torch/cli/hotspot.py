"""Orbiting hot-spot flare driver — the port's `grtrace.cli.hotspot`.

One geodesic pass (the disk render, kernel B6 on the card) shades the whole
movie: the spacetime is stationary, so every frame is an elementwise
re-paint of the per-pixel crossing invariants (engine/hotspot.py).  Writes
the frames, an animated GIF (Pillow) and the light curve (lightcurve.csv;
its figures unless --no-plots, which the JAX driver does not have).
--transfer shades the movie from a saved transfer map instead, with no
geodesic step.

--closure adds the closure-phase time series on a fan of closed baseline
triangles (closure_vs_time.csv; its figure unless --no-plots), one FFT
per frame on the run's device.

Run: python -m grtrace_torch.cli.hotspot --size 256 --metric kerr --spin 0.9
     [--device cpu] [--no-plots] [--closure]
"""
from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="orbiting hot-spot flares")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=20_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--background', type=str, default=None)
    p.add_argument('--bh-mass', type=float, default=1.0)
    p.add_argument('--boundary-radius', type=float, default=31.0)
    p.add_argument('--observer-distance', type=float, default=30.0)
    p.add_argument('--metric', type=str, default='schwarzschild',
                   choices=['schwarzschild', 'kerr'])
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'float64'])
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    # disk geometry (the blob rides the thin-disk scene)
    p.add_argument('--disk-elevation', type=float, default=12.0)
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--disk-profile', choices=('shakura', 'novikov'),
                   default='shakura')
    # blob
    p.add_argument('--blob-r', type=float, default=None,
                   help='orbit radius (default: placed inside the annulus)')
    p.add_argument('--blob-sigma', type=float, default=0.5)
    p.add_argument('--blob-phi0', type=float, default=0.0)
    p.add_argument('--blob-temp', type=float, default=12000.0)
    p.add_argument('--amplitude', type=float, default=4.0)
    p.add_argument('--frames', type=int, default=64)
    p.add_argument('--periods', type=float, default=1.0)
    p.add_argument('--no-gif', action='store_true')
    p.add_argument('--no-plots', action='store_true',
                   help='skip the light-curve and astrometry figures (they '
                        'need matplotlib)')
    p.add_argument('--closure', action='store_true',
                   help='closure-phase time series on a fan of closed '
                        'baseline triangles (engine/visibility.py) -> '
                        'closure_vs_time.csv (and .png unless --no-plots)')
    p.add_argument('--mass-msun', type=float, default=None,
                   help='black-hole mass in solar masses: adds physical '
                        'time (minutes) to the light curve and the '
                        'printed period')
    p.add_argument('--preset', choices=('sgra', 'm87'), default=None,
                   help='source preset (sets --mass-msun; sgra = the '
                        'GRAVITY flare source)')
    p.add_argument('--transfer', type=str, default=None, metavar='NPZ',
                   help='shade the movie from a saved geodesic transfer '
                        'map (io.transfer) instead of tracing: all '
                        'scene and integrator flags are then ignored')
    p.add_argument('--save-transfer', type=str, default=None, metavar='NPZ',
                   help="persist this run's transfer map for later "
                        're-shading (cli.reshade / --transfer here)')
    p.add_argument('--out-dir', type=str, default='hotspot_out')
    p.add_argument('--bench', action='store_true',
                   help='print one JSON line: the frame shading throughput '
                        '(warm)')
    p.add_argument('--out-json', type=str, default=None)
    return p


def _bench(res, out, args, spin, params, device):
    """The --bench line: frames/s of the movie's shading, warm, on the
    frames of this run (5 repetitions of all frames, fetched to the
    host)."""
    import torch

    from ..engine.hotspot import hotspot_statics, shade_hotspot_frames
    from ..engine.metrics import card

    psi, r_hit, g, valid = hotspot_statics(
        res.device("hit_q"), res.device("status"), res.device("redshift"),
        params, out["omega"])

    def shade(t0):
        return shade_hotspot_frames(
            res.device("image"), psi, r_hit, g, valid, out["times"] + t0,
            out["omega"], out["r_blob"], args.blob_sigma, args.blob_phi0,
            t_blob=args.blob_temp, amplitude=args.amplitude)[0].cpu()

    shade(0.0)                      # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for i in range(reps):
        shade(1e-3 * (i + 1))
    dt = time.perf_counter() - t0
    fps = reps * args.frames / dt
    size = res.device("image").shape[0]
    return {
        "metric": f"hotspot_{size}_shading_frames_per_s",
        "value": round(fps, 1), "unit": "frames/s",
        "vs_baseline": round(fps * size ** 2 / 400 ** 2, 2),
        "frames": args.frames, "size": size,
        "metric_family": "kerr" if spin else "schwarzschild",
        "spin": spin, "wall_s": round(dt, 4),
        "device": card() if device.type == "cuda" else "cpu",
    }


def _closure(out, args, device):
    """--closure: the movie's closure phases on four closed triangles
    whose legs span the ring scale (JAX's fan), written to
    closure_vs_time.csv and, unless --no-plots, drawn against the orbital
    phase; returns the (F, 4) series in radians."""
    import numpy as np

    from ..engine.hotspot import closure_phase_series

    size = out["frames"].shape[1]
    pixel_rad = 2.0 * np.tan(np.radians(args.fov) / 2.0) / size
    du = 1.0 / (2 * size * pixel_rad)        # pad=2 frequency spacing
    tris = []
    for s in (3, 6, 11, 18):
        l1 = np.array([s, 1 - s // 3]) * du
        l2 = np.array([1 - s // 3, s]) * du
        tris.append([l1, l2, -(l1 + l2)])
    tris = np.asarray(tris)
    series = closure_phase_series(out["frames"], pixel_rad, tris,
                                  device=device)
    times = np.asarray(out["times"])
    np.savetxt(os.path.join(args.out_dir, "closure_vs_time.csv"),
               np.column_stack([times, np.degrees(series)]),
               delimiter=",", comments="", fmt="%.8g",
               header="tau," + ",".join(f"tri{k}_deg"
                                        for k in range(len(tris))))
    if not args.no_plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4))
        for k in range(series.shape[1]):
            blen = np.linalg.norm(tris[k, 0]) * pixel_rad * size
            ax.plot(times / out["period"],
                    np.degrees(np.unwrap(series[:, k])),
                    label=f"triangle {k} (leg ~{blen:.0f} cyc/fov)")
        ax.set_xlabel("observer time (orbital periods)")
        ax.set_ylabel("closure phase (deg)")
        ax.set_title("flare closure-phase swings")
        ax.legend(fontsize=8)
        fig.savefig(os.path.join(args.out_dir, "closure_vs_time.png"),
                    dpi=110, bbox_inches="tight")
        plt.close(fig)
    print(f"closure-phase swings: "
          f"{np.round(np.degrees(np.ptp(series, axis=0)), 1)} deg "
          f"-> closure_vs_time.csv")
    return series


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin and args.metric != 'kerr':
        raise SystemExit("--spin requires --metric kerr")
    if args.spin ** 2 + args.charge ** 2 > args.bh_mass ** 2:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import torch

    from ..engine.disk import DiskConfig
    from ..engine.hotspot import (T_SUN_S, HotspotConfig, render_hotspot,
                                  save_hotspot_artifacts)
    from ..engine.visibility import PRESETS
    from ..io import artifacts
    from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                            SceneConfig)
    from ..io.transfer import TransferMap, hotspot_from_transfer, reshade
    from ..viz import plots

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.hotspot: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.hotspot: the figures need "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")

    hs = HotspotConfig(r_blob=args.blob_r, sigma=args.blob_sigma,
                       phi0=args.blob_phi0, t_blob=args.blob_temp,
                       amplitude=args.amplitude, n_frames=args.frames,
                       n_periods=args.periods)

    os.makedirs(args.out_dir, exist_ok=True)
    res = None
    if args.transfer:
        tm = TransferMap.load(args.transfer)
        out = hotspot_from_transfer(tm, hs, device=device)
        if args.bench:              # the per-pixel inputs --bench needs
            res = reshade(tm, device=device)
        params = [float(v) for v in tm.params]
    else:
        scene = SceneConfig(
            size=args.size, fov_deg=args.fov, background=args.background,
            bh_mass=args.bh_mass, spin=args.spin, charge=args.charge,
            metric='kerr' if (args.metric == 'kerr' or args.charge) else
            'schwarzschild',
            boundary_radius=args.boundary_radius,
            observer_distance=args.observer_distance, n_samples=0,
            integrator=IntegratorConfig(
                steps=args.steps, delta=args.delta, omega=1.0,
                backend=JAX_BACKENDS.get(args.backend, args.backend),
                dtype=args.dtype),
            patch=PatchConfig())
        if artifacts.background_available(args.background):
            bg = artifacts.load_background(args.background,
                                           size=(args.size, args.size))
        else:
            from ..io import textures
            bg = textures.starfield(args.size, args.size)
        disk = DiskConfig(r_out=args.disk_r_out, profile=args.disk_profile,
                          elevation_deg=args.disk_elevation)
        out = render_hotspot(scene, disk, hs, bg_array=bg, device=device)
        res = out["result"]
        params = [args.bh_mass, args.spin, args.charge]
        if args.save_transfer:
            TransferMap.from_result(res, scene, disk).save(
                args.save_transfer)
            print(f"transfer map -> {args.save_transfer}")
    mass_msun = args.mass_msun
    if args.preset and mass_msun is None:
        mass_msun = PRESETS[args.preset]["mass_msun"]
    save_hotspot_artifacts(out, args.out_dir, gif=not args.no_gif,
                           mass_msun=mass_msun, plots=not args.no_plots)
    phys = ""
    if mass_msun:
        phys = (f" = {out['period'] * mass_msun * T_SUN_S / 60.0:.1f} min"
                f" at {mass_msun:.3g} M_sun")
    print(f"blob r = {out['r_blob']:.4g} M, period = {out['period']:.5g} M"
          f"{phys}, {args.frames} frames -> {args.out_dir}")

    if args.closure:
        out["closure"] = _closure(out, args, device)

    if args.bench:
        line = json.dumps(_bench(res, out, args, params[1], params, device))
        print(line)
        out["bench"] = json.loads(line)
        if args.out_json:
            with open(args.out_json, "w") as f:
                f.write(line + "\n")
    return out


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
