"""Fit black-hole spin + inclination to an observed iron-line profile — the
port's `grtrace.cli.fit_line`.

    # demo: synthesize an observation at a hidden truth, then recover it
    python -m grtrace_torch.cli.fit_line --synthesize 0.7 40 --noise 0.03 \
        --spins 0.3 0.5 0.7 0.9 --inclinations 20 40 60 [--no-plots]

    # fit a real profile (CSV with columns g,flux)
    python -m grtrace_torch.cli.fit_line --observed profile.csv

The model grid is one sweep over the ('frames', 'rays') mesh
(sharding/grid.line_profile_grid_sharded: kernel B6 on the card); the fit
is the chi^2 minimum over area-normalized profiles, refined by a parabola
along each grid axis.  --gauss-newton N refines it with the exact
forward-mode Jacobian (engine/sensitivity.gauss_newton_fit) and --fisher
adds the local error bars (line_profile_jacobian -> fisher_forecast): both
run kernel B6t on the card.  Writes fit_chi2.csv and, unless --no-plots,
fit_map.png; prints the best-fit JSON line and returns it.  Under torchrun
the grid is laid over the ranks; rank 0 fits and writes.
"""
from __future__ import annotations

import argparse
import json
import os

from .line_grid import check_device


def _area_norm(prof, axis=-1):
    import numpy as np
    s = prof.sum(axis=axis, keepdims=True)
    return prof / np.maximum(s, 1e-30)


def _parabolic_refine(values, losses, k):
    """Sub-grid minimum along one axis from the 3-point parabola."""
    if k == 0 or k == len(values) - 1:
        return float(values[k])
    la, lb, lc = losses[k - 1], losses[k], losses[k + 1]
    denom = la - 2.0 * lb + lc
    if denom <= 0:
        return float(values[k])
    shift = 0.5 * (la - lc) / denom
    step = 0.5 * (values[k + 1] - values[k - 1])
    return float(values[k] + shift * step)


def build_parser():
    p = argparse.ArgumentParser(
        description="fit (spin, inclination) to a relativistic line "
                    "profile via the sharded forward-model grid")
    p.add_argument('--observed', type=str, default=None,
                   help='CSV with header g,flux (mutually exclusive with '
                        '--synthesize)')
    p.add_argument('--synthesize', type=float, nargs=2, default=None,
                   metavar=('SPIN', 'INCL_DEG'),
                   help='generate the observation from this truth')
    p.add_argument('--noise', type=float, default=0.02,
                   help='relative Gaussian noise for --synthesize')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--spins', type=float, nargs='+',
                   default=[0.0, 0.25, 0.5, 0.7, 0.9, 0.998])
    p.add_argument('--inclinations', type=float, nargs='+',
                   default=[15.0, 30.0, 45.0, 60.0, 75.0])
    p.add_argument('--size', type=int, default=128)
    p.add_argument('--steps', type=int, default=12_000)
    p.add_argument('--delta', type=float, default=0.03)
    p.add_argument('--emissivity', type=float, default=3.0)
    p.add_argument('--bins', type=int, default=64)
    p.add_argument('--g-range', type=float, nargs=2, default=[0.1, 1.6])
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'float64'])
    p.add_argument('--gauss-newton', type=int, default=0, metavar='N',
                   help='refine the grid best fit with N Gauss-Newton steps '
                        'on the exact forward-mode Jacobian '
                        '(engine/sensitivity.gauss_newton_fit)')
    p.add_argument('--fisher', action='store_true',
                   help='exact local error bars at the best fit: the '
                        'profile Jacobian in (spin, inclination) -> Fisher '
                        'matrix, 1-sigma errors and the spin-inclination '
                        'correlation (of the smooth-KDE surrogate profile)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='skip fit_map.png (it needs matplotlib)')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def _plot(args, chi2, ns, ni, spin_fit, incl_fit, obs_g, obs_n, centers,
          grid_n, k, ks, ki):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    im = ax1.imshow(np.log10(chi2.reshape(ns, ni) + 1e-12), origin="lower",
                    aspect="auto",
                    extent=[min(args.inclinations), max(args.inclinations),
                            min(args.spins), max(args.spins)],
                    cmap="viridis")
    ax1.plot(incl_fit, spin_fit, "r*", ms=14, label="best fit")
    if args.synthesize is not None:
        ax1.plot(args.synthesize[1], args.synthesize[0], "wx", ms=10,
                 label="truth")
    ax1.set_xlabel("inclination (deg)")
    ax1.set_ylabel("spin a")
    ax1.set_title("log$_{10}$ $\\chi^2$")
    ax1.legend()
    fig.colorbar(im, ax=ax1)
    ax2.plot(obs_g, obs_n, "k.", ms=3, label="observed")
    ax2.plot(obs_g if args.observed else centers, grid_n[k],
             label=f"best model (a={args.spins[ks]:g}, "
                   f"i={args.inclinations[ki]:g}°)")
    ax2.set_xlabel("g = $E_{obs}/E_{em}$")
    ax2.set_ylabel("normalized flux")
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(args.out_dir, "fit_map.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.observed is None) == (args.synthesize is None):
        raise SystemExit("pass exactly one of --observed / --synthesize")
    probe_spins = list(args.spins) + (
        [args.synthesize[0]] if args.synthesize else [])
    for a in probe_spins:
        if a * a > 1.0:
            raise SystemExit(f"naked singularity at spin {a}: need "
                             "a^2 <= M^2")
    probe_incl = list(args.inclinations) + (
        [args.synthesize[1]] if args.synthesize else [])
    if not all(0.0 <= i <= 90.0 for i in probe_incl):
        raise SystemExit("inclinations must lie in [0, 90] degrees")
    check_device(args.device, "fit_line")

    import numpy as np
    import torch

    from ..engine.sensitivity import (fisher_forecast, gauss_newton_fit,
                                      line_profile_jacobian)
    from ..io.scene import JAX_BACKENDS
    from ..sharding.grid import g_bin_centers, line_profile_grid_sharded
    from ..sharding.mesh import (init_distributed_from_env, make_mesh,
                                 rank_device)
    from ..viz import plots

    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.fit_line: fit_map.png needs "
                         "matplotlib, which this Python does not have; pass "
                         "--no-plots")
    init_distributed_from_env()
    g_lo, g_hi = (float(x) for x in args.g_range)
    centers = g_bin_centers(args.bins, g_lo, g_hi)
    dtype = torch.float64 if args.dtype == 'float64' else torch.float32
    backend = JAX_BACKENDS.get(args.backend, args.backend)
    mesh = make_mesh(1)
    device = rank_device(args.device)

    def sweep(spins, elevs):
        return line_profile_grid_sharded(
            mesh, np.asarray(spins, np.float64),
            np.asarray(elevs, np.float64), 30.0, np.deg2rad(80.0), 1.0,
            0.0, 31.0, args.steps, args.delta, 1.0, args.disk_r_out,
            height=args.size, width=args.size, backend=backend,
            dtype=dtype, n_bins=args.bins,
            emissivity=(float(args.emissivity),), g_lo=g_lo, g_hi=g_hi,
            device=device).cpu().numpy().astype(np.float64)[:, 0]

    # --- the observation ------------------------------------------------
    if args.synthesize is not None:
        true_spin, true_incl = args.synthesize
        obs = sweep([true_spin], [np.deg2rad(90.0 - true_incl)])[0]
        rng = np.random.default_rng(args.seed)
        obs = np.maximum(
            obs + args.noise * obs.max() * rng.standard_normal(obs.shape),
            0.0)
        obs_g = centers
    else:
        data = np.genfromtxt(args.observed, delimiter=",", names=True)
        obs_g = np.asarray(data["g"], np.float64)
        obs = np.asarray(data["flux"], np.float64)
    obs_n = _area_norm(obs)

    # --- the model grid (one sweep over the mesh) -----------------------
    spins = np.repeat(args.spins, len(args.inclinations))
    incls = np.tile(args.inclinations, len(args.spins))
    grid = sweep(spins, np.deg2rad(90.0 - incls))          # (F, B)
    if mesh.rank != 0:
        return None
    if args.observed is not None:
        grid = np.stack([np.interp(obs_g, centers, gp) for gp in grid])
    grid_n = _area_norm(grid)

    chi2 = ((grid_n - obs_n[None]) ** 2).sum(axis=1)
    k = int(np.argmin(chi2))
    ns, ni = len(args.spins), len(args.inclinations)
    ks, ki = divmod(k, ni)
    spin_fit = _parabolic_refine(np.asarray(args.spins),
                                 chi2.reshape(ns, ni)[:, ki], ks)
    incl_fit = _parabolic_refine(np.asarray(args.inclinations),
                                 chi2.reshape(ns, ni)[ks], ki)

    os.makedirs(args.out_dir, exist_ok=True)
    np.savetxt(os.path.join(args.out_dir, "fit_chi2.csv"),
               np.column_stack([spins, incls, chi2]), delimiter=",",
               comments="", header="spin,inclination_deg,chi2", fmt="%.8g")
    if not args.no_plots:
        _plot(args, chi2, ns, ni, spin_fit, incl_fit, obs_g, obs_n, centers,
              grid_n, k, ks, ki)

    result = {
        "spin_fit": round(spin_fit, 4),
        "inclination_fit_deg": round(incl_fit, 3),
        "spin_grid_best": float(args.spins[ks]),
        "inclination_grid_best": float(args.inclinations[ki]),
        "chi2_min": float(chi2[k]),
        "grid_points": int(len(spins)),
    }
    if args.synthesize is not None:
        result |= {"spin_true": float(true_spin),
                   "inclination_true_deg": float(true_incl)}

    sens_knobs = dict(size=args.size, steps=args.steps, delta=args.delta,
                      r_out=args.disk_r_out,
                      emissivity_index=float(args.emissivity),
                      fov=float(np.deg2rad(80.0)), device=device)
    if args.gauss_newton:
        # refine against the observation on the model's bin centers
        obs_c = (obs if args.observed is None
                 else np.interp(centers, obs_g, obs))
        theta0 = np.array([float(args.spins[ks]),
                           np.deg2rad(90.0 - float(args.inclinations[ki]))])
        theta_gn, hist = gauss_newton_fit(theta0, obs_c, centers,
                                          n_iter=args.gauss_newton,
                                          **sens_knobs)
        spin_fit = float(theta_gn[0])
        incl_fit = float(90.0 - np.rad2deg(theta_gn[1]))
        result |= {
            "spin_fit": round(spin_fit, 5),
            "inclination_fit_deg": round(incl_fit, 4),
            "gn_iterations": args.gauss_newton,
            "gn_residual_norms": [round(h[2], 8) for h in hist],
        }

    if args.fisher:
        theta = np.array([spin_fit, np.deg2rad(90.0 - incl_fit)])
        _, jac = line_profile_jacobian(theta, centers, **sens_knobs)
        if args.synthesize is not None:
            # the synthesized noise is args.noise * obs.max() absolute;
            # area normalization divides both by the same sum
            sigma_n = args.noise * float(obs_n.max())
        else:
            # the per-bin noise estimated from the fit residual
            sigma_n = float(np.sqrt(chi2[k] / max(len(obs_n) - 2, 1)))
        fc = fisher_forecast(jac, max(sigma_n, 1e-12))
        # theta[1] is the elevation (90 deg - inclination): the error
        # carries over, the correlation flips sign
        result |= {
            "fisher_spin_err": float(fc["errors"][0]),
            "fisher_incl_err_deg": float(np.rad2deg(fc["errors"][1])),
            "fisher_correlation_spin_incl": (-float(fc["correlation"])
                                             if fc["correlation"] is not None
                                             else None),
            "fisher_noise_sigma": sigma_n,
            "fisher_matrix": fc["fisher"].tolist(),
        }

    print(json.dumps(result))
    return result


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
