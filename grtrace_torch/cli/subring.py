"""Photon-ring subring driver — the port's `grtrace.cli.subring`: image
orders rendered as separate layers.

    python -m grtrace_torch.cli.subring --spin 0.9 --size 256 --orders 3 \
        --no-plots [--aa 2] [--visibility] [--sed]

One transparent-disk geodesic pass (engine/subring.py: kernel B7 on the
card; --aa S launches B7 again on the S x S sub-rays of the layer-boundary
pixels) records the first N equatorial-plane crossings per ray.  Writes the
composited image (subring_composite.png), the n = 0 vs n = 1 delay table
(subring_delay_01.csv) and the JSON summary (flux ratios -> the Lyapunov
demagnification exponent, median inter-order delays -> the photon-shell
half-period); with --visibility the per-order |V|(b) profiles
(subring_visibility.csv), with --sed the per-order continuum
(subring_sed.csv); the figures unless --no-plots, which the JAX driver
does not have.  Prints one JSON metrics line, with the photon-shell
prediction (physics/photon_shell.py, float64 on the host) beside it.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="photon-ring subring (image-order) decomposition")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=30_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--order', type=int, default=2,
                   help='FANTASY integrator order (2/4/6/8)')
    p.add_argument('--orders', type=int, default=3,
                   help='Number of image orders (crossing slots) to record')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--elevation', type=float, default=75.0,
                   help='Camera elevation above the disk plane (deg); '
                        'face-on views separate the orders most cleanly')
    p.add_argument('--r-out', type=float, default=14.0)
    p.add_argument('--r-in', type=float, default=None,
                   help='Disk inner edge (default: the prograde ISCO)')
    p.add_argument('--profile', choices=('shakura', 'novikov'),
                   default='shakura')
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--bfield', choices=('vertical', 'toroidal', 'radial'),
                   default=None,
                   help='Polarized imaging: per-order Walker-Penrose EVPA '
                        'maps and the order-to-order polarization twist')
    p.add_argument('--visibility', action='store_true',
                   help='Per-order u-v signatures: |V|(b) radial profile, '
                        'first null and thin-ring diameter per image order '
                        '-> subring_visibility.csv + ring diameters in the '
                        'JSON')
    p.add_argument('--sed', action='store_true',
                   help='Disk continuum SED per image order '
                        '(engine/spectrum.py) -> subring_sed.csv')
    p.add_argument('--t-peak', type=float, default=9000.0,
                   help='Disk display/SED temperature scale (kelvin)')
    p.add_argument('--aa', type=int, default=0, metavar='S',
                   help='Adaptive edge refinement: S^2 stratified sub-rays '
                        'through every layer-boundary pixel; refines the '
                        'displayed image and the per-order intensity maps')
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'],
                   help="integrator: 'auto' (the kernel on the card, its "
                        "twin on the CPU), 'cuda', 'torch' (the twin); the "
                        "JAX names map to these")
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='write the CSVs and JSON only (the figures need '
                        'matplotlib)')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def shell_theory(spin, charge, elevation_deg, n=33):
    """The photon-shell prediction for the rendered inclination: the
    Lyapunov exponent and half-orbit delay along the visible critical
    curve (physics/photon_shell.py, float64 on the host CPU), to sit next
    to the measured gamma_hat / delay_per_order_M."""
    import numpy as np

    from ..physics.photon_shell import critical_curve_observables

    theta_obs = max(np.deg2rad(90.0 - elevation_deg), 1e-4)
    curve = critical_curve_observables((1.0, spin, charge), theta_obs, n=n)
    gam = curve["gamma"].numpy()
    dts = curve["delta_t"].numpy()
    return {
        "gamma_min": float(gam.min()),
        "gamma_max": float(gam.max()),
        "gamma_median": float(np.median(gam)),
        "delay_half_orbit_M_min": float(dts.min()),
        "delay_half_orbit_M_max": float(dts.max()),
        "delay_half_orbit_M_median": float(np.median(dts)),
    }


def _visibility_metrics(result, args, written):
    import numpy as np

    from ..engine.subring import subring_visibilities

    vis = subring_visibilities(result, float(np.deg2rad(args.fov)))
    pop = [v for v in vis if v["baselines"] is not None]
    if pop:
        cols, hdr = [pop[0]["baselines"]], "baseline_per_rad"
        for v in pop:
            cols.append(v["profile"])
            hdr += f",absV_order_{v['order']}"
        np.savetxt(os.path.join(args.out_dir, "subring_visibility.csv"),
                   np.column_stack(cols), delimiter=",", header=hdr,
                   comments="")
        written.append("subring_visibility.csv")
    return {"ring_diameter_rad_per_order": [v["ring_diameter_rad"]
                                            for v in vis],
            "b_null_per_order": [v["b_null"] for v in vis]}


def _sed(result, args, written):
    import numpy as np

    from ..engine.spectrum import disk_sed

    nu, sed = disk_sed(result["intensity"], args.t_peak)
    rows = np.column_stack([nu, sed.T, sed.sum(axis=0)])
    hdr = "nu_hz," + ",".join(f"sed_order_{i}"
                              for i in range(args.orders)) + ",total"
    csv = os.path.join(args.out_dir, "subring_sed.csv")
    np.savetxt(csv, rows, delimiter=",", header=hdr, comments="")
    written.append(csv)
    if args.no_plots:
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4.2))
    for i in range(args.orders):
        if sed[i].max() > 0:
            ax.loglog(nu, sed[i], label=f"n={i}")
    ax.loglog(nu, sed.sum(axis=0), "k--", lw=1, label="total")
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("relative $L_\\nu$")
    ax.set_title("disk continuum SED per image order")
    ax.legend()
    ax.set_ylim(bottom=max(sed.max() * 1e-8, 1e-300))
    png = os.path.join(args.out_dir, "subring_sed.png")
    fig.savefig(png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    written.append(png)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import torch

    from ..engine.disk import DiskConfig
    from ..engine.subring import render_subrings, save_subring_maps
    from ..io import artifacts
    from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                            SceneConfig)
    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.subring: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.subring: the figures need "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, metric='kerr', spin=args.spin,
        charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(
            steps=args.steps, delta=args.delta, order=args.order,
            backend=JAX_BACKENDS.get(args.backend, args.backend)),
        patch=PatchConfig())
    disk = DiskConfig(r_in=args.r_in, r_out=args.r_out,
                      prograde=not args.retrograde, profile=args.profile,
                      elevation_deg=args.elevation, show_background=False,
                      bfield=args.bfield, t_peak=args.t_peak)
    result = render_subrings(scene, disk, n_orders=args.orders,
                             aa_samples=args.aa or None, device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(result["image"],
                         os.path.join(args.out_dir, "subring_composite.png"))
    written, summary = save_subring_maps(result, args.out_dir,
                                         plots=not args.no_plots)
    metrics_vis = (_visibility_metrics(result, args, written)
                   if args.visibility else {})
    if args.sed:
        _sed(result, args, written)

    metrics = {
        "orders": args.orders,
        "spin": args.spin,
        "charge": args.charge,
        "flux_per_order": summary["flux_per_order"],
        "gamma_hat": summary["gamma_hat"],
        "delay_per_order_M": summary["delay_per_order_M"],
        "max_crossings": summary["max_crossings"],
        "files": len(written) + 1,
    } | metrics_vis
    for k in ("evpa_twist_per_order_rad", "beta2_abs_per_order",
              "beta2_arg_per_order_rad"):
        if k in summary:
            metrics[k] = summary[k]
    metrics["theory"] = shell_theory(args.spin, args.charge, args.elevation)
    print(json.dumps(metrics))
    metrics["result"] = result
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
