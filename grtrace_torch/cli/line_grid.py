"""Spin x inclination line-profile grid sweep — the port's
`grtrace.cli.line_grid`: the iron-line spin-fitting forward model, one
sweep over the ('frames', 'rays') mesh (sharding/grid.py), kernel B6 on the
card.

    python -m grtrace_torch.cli.line_grid --spins 0 0.5 0.9 0.998 \
        --inclinations 15 35 55 75 --size 256 --emissivity 3 [--no-plots]

Inclinations follow the X-ray convention (degrees from the disk normal:
0 = face-on); the engine's camera elevation above the plane is their
complement.  Writes line_grid.csv (long format: spin, inclination_deg, q,
g, flux normalized per profile) and, unless --no-plots (the JAX driver's
--no-plot), line_grid.png.  --fisher SIGMA adds the Fisher-forecast map
(sharding/grid.fisher_grid_sharded: the forward-mode Jacobian through the
integrator, kernel B6t on the card, float64) -> fisher_grid.csv.  Under
torchrun (WORLD_SIZE set) it initializes the process group itself and lays
the mesh over the ranks; rank 0 writes the files.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(
        description="relativistic line-profile (spin x inclination) grid")
    p.add_argument('--spins', type=float, nargs='+',
                   default=[0.0, 0.5, 0.9, 0.998])
    p.add_argument('--inclinations', type=float, nargs='+',
                   default=[15.0, 35.0, 55.0, 75.0],
                   help='degrees from the disk normal (0 face-on)')
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=20_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--bh-mass', type=float, default=1.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--boundary-radius', type=float, default=31.0)
    p.add_argument('--observer-distance', type=float, default=30.0)
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--emissivity', type=float, nargs='+', default=[3.0],
                   help='power-law indices q (I_em ~ r^-q); the geodesic '
                        'work is shared across all of them')
    p.add_argument('--bins', type=int, default=96)
    p.add_argument('--g-range', type=float, nargs=2, default=[0.1, 1.6],
                   metavar=('LO', 'HI'))
    p.add_argument('--order', type=int, default=2, choices=[2, 4, 6, 8])
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'float64'])
    p.add_argument('--mesh-frames', type=int, default=None,
                   help='frame shards (default: all ranks on rays)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--no-plots', '--no-plot', dest='no_plots',
                   action='store_true',
                   help='skip the figures (they need matplotlib)')
    p.add_argument('--fisher', type=float, default=None, metavar='SIGMA',
                   help='also compute the sharded Fisher-forecast map: per '
                        'grid point the 1-sigma errors on (spin, '
                        'inclination) a line fit with per-bin noise SIGMA '
                        'would attain (forward-mode AD through the geodesic '
                        'integrator; float64)')
    p.add_argument('--bench', action='store_true',
                   help='print one JSON line: the warm sweep wall time')
    p.add_argument('--out-json', type=str, default=None)
    return p


def check_device(device, name):
    """Exit with a message when `device` is CUDA and there is no card."""
    import torch

    if device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f"grtrace_torch.cli.{name}: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")


def _plot_profiles(args, spins, incls, hist, centers, q_tuple):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    uspins = list(dict.fromkeys(args.spins))
    uincl = list(dict.fromkeys(args.inclinations))
    fig, axes = plt.subplots(1, len(uspins), figsize=(3.4 * len(uspins), 3.2),
                             sharey=True, squeeze=False)
    for c, a in enumerate(uspins):
        ax = axes[0, c]
        for i in uincl:
            k = np.flatnonzero((spins == a) & (incls == i))[0]
            prof = hist[k, 0]
            peak = prof.max()
            ax.plot(centers, prof / peak if peak > 0 else prof,
                    label=f"i = {i:g}°")
        ax.set_title(f"a = {a:g}")
        ax.set_xlabel("g = $E_{obs}/E_{em}$")
        if c == 0:
            ax.set_ylabel("relative flux")
            ax.legend(fontsize=8)
    fig.suptitle(f"relativistic line profiles "
                 f"($r^{{-{q_tuple[0]:g}}}$ emissivity)")
    fig.tight_layout()
    fig.savefig(os.path.join(args.out_dir, "line_grid.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)


def _plot_fisher(args, sig_a, sig_i, corr):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    ns, ni = len(args.spins), len(args.inclinations)
    ext = [min(args.inclinations), max(args.inclinations),
           min(args.spins), max(args.spins)]
    fig, axes = plt.subplots(1, 3, figsize=(14, 3.8))
    panels = [(np.log10(sig_a), "log$_{10}$ $\\sigma$(spin)", "viridis"),
              (np.log10(sig_i), "log$_{10}$ $\\sigma$(incl) [deg]",
               "viridis"),
              (corr, "corr(spin, incl)", "coolwarm")]
    for ax, (z, title, cmap) in zip(axes, panels):
        kw = {"vmin": -1, "vmax": 1} if cmap == "coolwarm" else {}
        im = ax.imshow(z.reshape(ns, ni), origin="lower", aspect="auto",
                       extent=ext, cmap=cmap, **kw)
        ax.set_xlabel("inclination (deg)")
        ax.set_ylabel("spin a")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.suptitle(f"Fisher forecast (per-bin noise $\\sigma$ = "
                 f"{args.fisher:g})")
    fig.tight_layout()
    fig.savefig(os.path.join(args.out_dir, "fisher_grid.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)
    for a in args.spins:
        if a * a + args.charge ** 2 > args.bh_mass ** 2:
            raise SystemExit(f"naked singularity at spin {a}: need "
                             "a^2 + Q^2 <= M^2")
    if not all(0.0 <= i <= 90.0 for i in args.inclinations):
        raise SystemExit("--inclinations must lie in [0, 90] degrees")
    check_device(args.device, "line_grid")

    import numpy as np
    import torch

    from ..engine.metrics import card
    from ..io.scene import JAX_BACKENDS
    from ..sharding.grid import (fisher_grid_sharded, g_bin_centers,
                                 line_profile_grid_sharded)
    from ..sharding.mesh import (init_distributed_from_env, make_mesh,
                                 rank_device)
    from ..viz import plots

    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.line_grid: the figures need "
                         "matplotlib, which this Python does not have; pass "
                         "--no-plots")
    init_distributed_from_env()
    spins = np.repeat(args.spins, len(args.inclinations))
    incls = np.tile(args.inclinations, len(args.spins))
    elevs = np.deg2rad(90.0 - incls)          # engine: elevation above plane
    f = spins.size
    probe = make_mesh(1)
    mf = args.mesh_frames or 1
    mesh = make_mesh(mf, probe.size // mf)
    lead = mesh.rank == 0
    device = rank_device(args.device)
    dtype = torch.float64 if args.dtype == 'float64' else torch.float32
    backend = JAX_BACKENDS.get(args.backend, args.backend)
    q_tuple = tuple(float(q) for q in args.emissivity)
    g_lo, g_hi = (float(v) for v in args.g_range)

    def sweep(spin_arr, elev_arr):
        return line_profile_grid_sharded(
            mesh, spin_arr, elev_arr, args.observer_distance,
            np.deg2rad(args.fov), args.bh_mass, args.charge,
            args.boundary_radius, args.steps, args.delta, 1.0,
            args.disk_r_out, height=args.size, width=args.size,
            order=args.order, backend=backend, dtype=dtype,
            prograde=not args.retrograde, n_bins=args.bins,
            emissivity=q_tuple, g_lo=g_lo, g_hi=g_hi, device=device)

    hist = sweep(spins, elevs).cpu().numpy().astype(np.float64)  # (F, Q, B)
    centers = g_bin_centers(args.bins, g_lo, g_hi)
    result = {"hist": hist, "centers": centers}

    if lead:
        os.makedirs(args.out_dir, exist_ok=True)
        rows = []
        for k in range(f):
            for iq, q in enumerate(q_tuple):
                prof = hist[k, iq]
                peak = prof.max()
                prof = prof / peak if peak > 0 else prof
                for g, fl in zip(centers, prof):
                    rows.append((spins[k], incls[k], q, g, fl))
        np.savetxt(os.path.join(args.out_dir, "line_grid.csv"),
                   np.array(rows), delimiter=",", comments="",
                   header="spin,inclination_deg,q,g,relative_flux",
                   fmt="%.8g")
        if not args.no_plots:
            _plot_profiles(args, spins, incls, hist, centers, q_tuple)
        print(f"{f} grid points ({len(args.spins)} spins x "
              f"{len(args.inclinations)} inclinations), {len(q_tuple)} "
              f"emissivities, {args.bins} bins -> {args.out_dir}")

    if args.fisher is not None:
        # elevation is the inclination's complement: the elevation errors
        # are the inclination errors and the correlation flips sign
        fish = fisher_grid_sharded(
            mesh, spins, elevs, args.fisher, size=args.size,
            steps=args.steps, delta=args.delta, order=args.order,
            r_out=args.disk_r_out, obs_distance=args.observer_distance,
            fov=np.deg2rad(args.fov), mass=args.bh_mass, charge=args.charge,
            boundary_radius=args.boundary_radius,
            prograde=not args.retrograde, emissivity_index=q_tuple[0],
            n_bins=args.bins, g_lo=g_lo, g_hi=g_hi,
            device=device).cpu().numpy()
        sig_a = fish[:, 0]
        sig_i = np.rad2deg(fish[:, 1])
        corr = -fish[:, 2]
        result["fisher"] = fish
        if lead:
            np.savetxt(os.path.join(args.out_dir, "fisher_grid.csv"),
                       np.column_stack([spins, incls, sig_a, sig_i, corr]),
                       delimiter=",", comments="",
                       header="spin,inclination_deg,sigma_spin,"
                              "sigma_inclination_deg,correlation_spin_incl",
                       fmt="%.8g")
            if not args.no_plots:
                _plot_fisher(args, sig_a, sig_i, corr)
            print(f"fisher map: sigma(spin) {sig_a.min():.3g}..."
                  f"{sig_a.max():.3g}, sigma(incl) {sig_i.min():.3g}..."
                  f"{sig_i.max():.3g} deg -> fisher_grid.csv")

    if args.bench:
        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        sync()
        t0 = time.perf_counter()
        reps = 3
        for i in range(reps):
            sweep(spins + 1e-6 * (i + 1), elevs).cpu()
        sync()
        dt = time.perf_counter() - t0
        line = json.dumps({
            "metric": f"line_grid_{args.size}_points_per_s",
            "value": round(reps * f / dt, 3), "unit": "gridpoints/s",
            "grid_points": int(f), "size": args.size, "steps": args.steps,
            "wall_s": round(dt, 4),
            "device": card() if device.type == "cuda" else "cpu"})
        result["bench"] = json.loads(line)
        if lead:
            print(line)
            if args.out_json:
                with open(args.out_json, "w") as fjs:
                    fjs.write(line + "\n")
    return result


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
