"""Trace once, derive every observable — the port's counterpart of
`examples/observables_workflow.py`.

One Kerr (a = 0.9) disk render (kernel B6 on the card, its eager twins
with --device cpu) is captured as a transfer map (io/transfer.py), and
everything after it is shading without another geodesic step: the
Novikov-Thorne reshade, the disk maps, the analytic critical curve and its
shape metrics, the u-v visibilities at M87*'s scale and an orbiting
hot-spot light curve.

    python -m grtrace_torch.examples.observables_workflow [out_dir]
        [--size 192] [--steps 12000] [--delta 0.03] [--device cpu]
        [--no-plots]

Products in out_dir: scene.transfer.npz, disk.png, disk_nt.png, the disk
maps (redshift_map.csv, line_profile.csv; redshift_map.png and
line_profile.png with plots), shadow_metrics.json (and shadow_overlay.png
with plots), visibility_profile.csv (and visibility_amp.png with plots),
hotspot/lightcurve.csv and its frames.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def run(out_dir="/tmp/grtrace_workflow", size=192, steps=12_000,
        delta=0.03, spin=0.9, device="cuda", plots=True):
    """The workflow; returns a dict of the numbers it prints."""
    from ..engine.disk import DiskConfig, render_disk, save_disk_maps
    from ..engine.hotspot import HotspotConfig, save_hotspot_artifacts
    from ..engine.shadow import (analytic_boundary, overlay_png,
                                 shadow_metrics)
    from ..engine.visibility import (camera_to_earth, first_null,
                                     radial_profile, visibility_map)
    from ..io import artifacts
    from ..io.scene import IntegratorConfig, PatchConfig, SceneConfig
    from ..io.transfer import TransferMap, hotspot_from_transfer, reshade

    os.makedirs(out_dir, exist_ok=True)
    scene = SceneConfig(size=size, metric="kerr", spin=spin, n_samples=0,
                        integrator=IntegratorConfig(steps=steps,
                                                    delta=delta),
                        patch=PatchConfig())
    disk = DiskConfig(r_out=14.0)

    # 1. the one geodesic pass
    print("tracing...")
    res = render_disk(scene, disk, bg_array=None, device=device)
    tm = TransferMap.from_result(res, scene, disk)
    tm.save(os.path.join(out_dir, "scene.transfer.npz"))
    artifacts.save_image(res.image, os.path.join(out_dir, "disk.png"))
    print(f"  {res.counts}")

    # 2. the disk model explored from the saved invariants (no tracing)
    print("reshading (Novikov-Thorne)...")
    nt = reshade(tm, profile="novikov", t_peak=12000.0, device=device)
    artifacts.save_image(nt.image, os.path.join(out_dir, "disk_nt.png"))
    save_disk_maps(nt, out_dir, plots=plots)   # redshift map, line profile

    # 3. shadow science: the analytic critical curve and its metrics
    print("shadow analysis...")
    psis, rho = analytic_boundary(spin, n_psi=96)
    metrics = shadow_metrics(psis, rho)
    if plots:
        overlay_png(res, psis, rho, os.path.join(out_dir,
                                                 "shadow_overlay.png"),
                    title=f"a = {spin:g}")
    with open(os.path.join(out_dir, "shadow_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(f"  mean diameter {metrics['mean_diameter_px']:.2f} px, "
          f"Delta C = {metrics['circularity_deviation']:.4f}")

    # 4. what an interferometer sees (M87*'s angular scale)
    print("visibilities...")
    pixel_cam = 2.0 * np.tan(scene.fov / 2.0) / size
    to_earth = camera_to_earth(scene.observer_distance, scene.bh_mass,
                               mass_msun=6.5e9, distance_mpc=16.8)
    amp, u, v = visibility_map(res.image, pixel_cam * to_earth,
                               device=device)
    base, prof = radial_profile(amp, u, v, n_bins=400,
                                b_max=min(u.max(), v.max()) / 4.0)
    b0 = first_null(base, prof)
    print(f"  first null {b0 / 1e9:.2f} Glambda" if np.isfinite(b0)
          else "  no null in range")
    np.savetxt(os.path.join(out_dir, "visibility_profile.csv"),
               np.column_stack([base, prof]), delimiter=",", comments="",
               header="baseline_lambda,amplitude", fmt="%.8g")
    if plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.semilogy(base / 1e9, np.maximum(prof, 1e-8))
        ax.set_xlabel("baseline (G$\\lambda$)")
        ax.set_ylabel("|V|")
        fig.savefig(os.path.join(out_dir, "visibility_amp.png"), dpi=110,
                    bbox_inches="tight")
        plt.close(fig)

    # 5. an orbiting hot-spot flare, shaded from the same transfer map
    print("hot-spot light curve...")
    hs_dir = os.path.join(out_dir, "hotspot")
    os.makedirs(hs_dir, exist_ok=True)
    out = hotspot_from_transfer(tm, HotspotConfig(n_frames=32),
                                device=device)
    save_hotspot_artifacts(out, hs_dir, gif=False, plots=plots)
    print(f"  blob r = {out['r_blob']:.3g} M, period = "
          f"{out['period']:.4g} M")

    print(f"all products -> {out_dir}")
    return {"counts": res.counts,
            "mean_diameter_px": metrics["mean_diameter_px"],
            "circularity_deviation": metrics["circularity_deviation"],
            "first_null": float(b0), "r_blob": float(out["r_blob"]),
            "period": float(out["period"]), "out_dir": out_dir}


def build_parser():
    p = argparse.ArgumentParser(description="trace once, derive every "
                                            "observable")
    p.add_argument('out_dir', nargs='?', default="/tmp/grtrace_workflow")
    p.add_argument('--size', type=int, default=192)
    p.add_argument('--steps', type=int, default=12_000)
    p.add_argument('--delta', type=float, default=0.03)
    p.add_argument('--spin', type=float, default=0.9)
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='skip the matplotlib figures')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.examples.observables_workflow: no "
                         "CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.examples.observables_workflow: the "
                         "figures need matplotlib, which this Python does "
                         "not have; pass --no-plots")
    return run(args.out_dir, size=args.size, steps=args.steps,
               delta=args.delta, spin=args.spin, device=args.device,
               plots=not args.no_plots)


if __name__ == "__main__":
    main()
