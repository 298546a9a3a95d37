"""Shadow-analysis driver — the port's `grtrace.cli.shadow`: the analytic
critical curve, its shape metrics and, with --numeric, the real
integrator's boundary error at every azimuth.

    # metrics + boundary CSV (closed form, no tracing):
    python -m grtrace_torch.cli.shadow --spin 0.9 --azimuths 128

    # + the numeric-vs-analytic pixel error (kernel B5 on the card):
    python -m grtrace_torch.cli.shadow --spin 0.9 --numeric

    # + a rendered overlay (needs matplotlib):
    python -m grtrace_torch.cli.shadow --spin 0.9 --render --numeric

Writes shadow_boundary.csv (psi, rho_px, alpha_deg [, rho_numeric_px,
px_err]), shadow_metrics.json and, with --render, shadow_overlay.png;
prints one summary line.  Boundary radii are in 256-image pixels of the
headline scene (observer at 30 M, fov 80 deg).  --numeric bisects through
kernel B5 (float32, 32-row compensated) and --render renders through B1
at a = Q = 0 and B5 otherwise; --device cpu runs their eager twins.
--metric rotating-bardeen / rotating-hayward (--metric-param g / l) takes
the family's exact conserved-quantity curve, bisects --numeric through
kernel G1r and renders through G1r; a horizonless point exits with a
message.  --metric kerr-ds (--metric-param Lambda) takes Kerr-de Sitter's
exact curve through the unfolded spherical camera, bisects --numeric
through kernel G1d and renders through G1d; a camera at 30 M too close to
the cosmological horizon, or a point with no black-hole horizon, exits
with a message.
"""
from __future__ import annotations

import argparse
import json
import os

# the beyond-Kerr --metric values and their metric names
_BEYOND = {"rotating-bardeen": "RotatingBardeen",
           "rotating-hayward": "RotatingHayward", "kerr-ds": "KerrDS"}
_ROTATING = ("rotating-bardeen", "rotating-hayward")


def build_parser():
    p = argparse.ArgumentParser(description="black-hole shadow analysis")
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--metric', type=str, default='kerr',
                   choices=('kerr', 'rotating-bardeen', 'rotating-hayward',
                            'kerr-ds'),
                   help='Kerr-Newman (closed-form Bardeen curve), a '
                        'rotating regular family (its exact '
                        'conserved-quantity curve, --metric-param g / l) '
                        'or Kerr-de Sitter (--metric-param Lambda)')
    p.add_argument('--metric-param', type=float, default=0.0,
                   help='regular charge g / core length l / Lambda of a '
                        'beyond-Kerr family')
    p.add_argument('--azimuths', type=int, default=64)
    p.add_argument('--render', action='store_true',
                   help='render the scene and write the critical-curve '
                        'overlay PNG (needs matplotlib)')
    p.add_argument('--numeric', action='store_true',
                   help='bisect the real integrator boundary per azimuth '
                        'and report pixel errors (kernel B5 on the card)')
    p.add_argument('--numeric-azimuths', type=int, default=16,
                   help='azimuth fan for --numeric (each bisection round '
                        'traces azimuths x 9 rays)')
    p.add_argument('--size', type=int, default=256,
                   help='overlay render resolution')
    p.add_argument('--steps', type=int, default=8000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--order', type=int, default=4, choices=[2, 4, 6, 8])
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..engine.shadow import (analytic_boundary, analytic_boundary_kds,
                                 analytic_boundary_rotating,
                                 numeric_boundary, overlay_png,
                                 px_to_alpha_deg, shadow_metrics)
    from ..io.scene import JAX_BACKENDS
    from ..viz import plots

    if args.metric == 'kerr' and args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")
    if args.metric != 'kerr' and args.charge:
        raise SystemExit("--charge is Kerr-Newman-only; rotating regular "
                         "families take --metric-param")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.shadow: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if args.render and not plots.available():
        raise SystemExit("grtrace_torch.cli.shadow: the overlay needs "
                         "matplotlib, which this Python does not have; "
                         "drop --render")
    backend = JAX_BACKENDS.get(args.backend, args.backend)
    os.makedirs(args.out_dir, exist_ok=True)

    rotating = _BEYOND.get(args.metric) if args.metric in _ROTATING \
        else None
    if rotating:
        psis, rho = analytic_boundary_rotating(
            args.spin, args.metric_param, rotating, args.azimuths)
        if not np.isfinite(rho).all():
            raise SystemExit(
                f"{args.metric} at (a, p) = ({args.spin:g}, "
                f"{args.metric_param:g}) is horizonless — no shadow "
                "boundary to extract")
    elif args.metric == 'kerr-ds':
        if args.metric_param > 0 and \
                30.0 >= 0.9 * np.sqrt(3.0 / args.metric_param):
            raise SystemExit(
                "kerr-ds shadow: the r_obs = 30 M camera must sit well "
                "inside the cosmological horizon — need Lambda < "
                "0.0027/M^2 (0.9 sqrt(3/Lambda) > 30)")
        psis, rho = analytic_boundary_kds(args.spin, args.metric_param,
                                          args.azimuths)
        if not np.isfinite(rho).all():
            raise SystemExit(
                f"kerr-ds at (a, Lambda) = ({args.spin:g}, "
                f"{args.metric_param:g}) has no black-hole horizon — "
                "no shadow boundary to extract")
    else:
        psis, rho = analytic_boundary(args.spin, args.charge, args.azimuths)
    metrics = shadow_metrics(psis, rho)
    metrics |= {"spin": args.spin, "charge": args.charge,
                "metric": args.metric, "metric_param": args.metric_param,
                "azimuths": args.azimuths}

    alpha_deg = px_to_alpha_deg(rho)
    cols = [psis, rho, alpha_deg]
    header = "psi_rad,rho_px,alpha_deg"

    beyond = _BEYOND.get(args.metric)
    if args.numeric:
        npsis, nrho, bracket = numeric_boundary(
            args.spin, args.metric_param if beyond else args.charge,
            n_psi=args.numeric_azimuths, steps=args.steps, delta=args.delta,
            order=args.order, backend=backend, device=args.device,
            metric=beyond or "KerrSchild")
        if rotating:
            _, ana_at_n = analytic_boundary_rotating(
                args.spin, args.metric_param, rotating,
                args.numeric_azimuths)
        elif args.metric == 'kerr-ds':
            _, ana_at_n = analytic_boundary_kds(
                args.spin, args.metric_param, args.numeric_azimuths)
        else:
            _, ana_at_n = analytic_boundary(args.spin, args.charge,
                                            args.numeric_azimuths)
        err = np.abs(nrho - ana_at_n)
        metrics |= {
            "numeric_px_err_max": float(err.max()),
            "numeric_px_err_mean": float(err.mean()),
            "numeric_bracket_px": float(bracket),
            "numeric_azimuths": args.numeric_azimuths,
        }
        # join onto the analytic fan where azimuths coincide, else NaN
        nmap = dict(zip(np.round(npsis, 9), zip(nrho, err)))
        joined = np.array([nmap.get(k, (np.nan, np.nan))
                           for k in np.round(psis, 9)])
        cols += [joined[:, 0], joined[:, 1]]
        header += ",rho_numeric_px,px_err"

    np.savetxt(os.path.join(args.out_dir, "shadow_boundary.csv"),
               np.column_stack(cols), delimiter=",", comments="",
               header=header, fmt="%.8g")
    with open(os.path.join(args.out_dir, "shadow_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)

    if args.render:
        from ..engine.render import render
        from ..io import textures
        from ..io.scene import IntegratorConfig, PatchConfig, SceneConfig
        scene = SceneConfig(
            size=args.size,
            metric=args.metric if beyond else (
                'kerr' if (args.spin or args.charge) else 'Schwarzschild'),
            spin=args.spin, charge=args.charge,
            metric_param=args.metric_param, n_samples=0,
            integrator=IntegratorConfig(steps=args.steps, delta=args.delta,
                                        order=args.order, backend=backend),
            patch=PatchConfig())
        res = render(scene, bg_array=textures.starfield(args.size,
                                                        args.size),
                     device=args.device)
        title = (f"{args.metric} a = {args.spin:g}, "
                 f"p = {args.metric_param:g}" if beyond
                 else f"a = {args.spin:g}, Q = {args.charge:g}")
        overlay_png(res, psis, rho,
                    os.path.join(args.out_dir, "shadow_overlay.png"),
                    title=title)

    print(f"shadow: mean diameter {metrics['mean_diameter_px']:.3f} px "
          f"({2 * metrics['mean_radius_deg']:.3f} deg), centroid shift "
          f"({metrics['centroid_shift_px'][0]:+.3f}, "
          f"{metrics['centroid_shift_px'][1]:+.3f}) px, "
          f"Delta C = {metrics['circularity_deviation']:.5f} "
          f"-> {args.out_dir}")
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
