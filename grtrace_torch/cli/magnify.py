"""Lensing-magnification driver — the port's `grtrace.cli.magnify`: signed
magnification and parity maps.

    python -m grtrace_torch.cli.magnify --metric kerr --spin 0.9 --no-plots

One curved render in the horizon-regular Kerr-Schild chart
(`render_generic(metric="KerrSchild")`: kernel B5 on the card, its eager
twin with --device cpu), then the magnification as finite differences of
its escape-angle map normalized by the straight-ray twin
(engine/lensing.py).  Writes magnification.csv and, unless --no-plots
(which the JAX driver does not have), magnification.png; prints one JSON
metrics line.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="lensing magnification / image-parity maps")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=20_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--metric', type=str, default='schwarzschild',
                   choices=['schwarzschild', 'kerr'])
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='write the CSV only (the figure needs matplotlib)')
    p.add_argument('--out-dir', type=str, default='.')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")
    if args.spin and args.metric != 'kerr':
        raise SystemExit("--spin requires --metric kerr")

    import numpy as np
    import torch

    from ..engine.lensing import (inverse_magnification_map,
                                  save_magnification_maps)
    from ..engine.render_generic import render_generic
    from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                            SceneConfig)
    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.magnify: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.magnify: the figure needs "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")

    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, metric='kerr', spin=args.spin,
        charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(
            steps=args.steps, delta=args.delta,
            backend=JAX_BACKENDS.get(args.backend, args.backend)),
        patch=PatchConfig())
    # the horizon-regular Cartesian chart: the Boyer-Lindquist chart's polar
    # stripe would contaminate the finite differences near the axis
    res = render_generic(scene, spin=args.spin, charge=args.charge,
                         metric="KerrSchild", bg_array=None,
                         device=args.device)
    mu_inv, valid = inverse_magnification_map(res, scene.boundary_radius)

    os.makedirs(args.out_dir, exist_ok=True)
    save_magnification_maps(mu_inv, valid, args.out_dir,
                            plots=not args.no_plots)

    def _finite(x):
        """NaN/inf -> None so the metrics line stays valid JSON."""
        return float(x) if np.isfinite(x) else None

    mu = 1.0 / mu_inv[valid]
    near_unity = mu[np.abs(mu - 1.0) < 0.5] if mu.size else mu
    metrics = {
        "valid_pixels": int(valid.sum()),
        "flipped_pixels": int((mu_inv[valid] < 0).sum()),
        "max_abs_magnification": _finite(np.abs(mu).max())
        if mu.size else None,
        "far_field_mu": _finite(np.median(np.abs(near_unity)))
        if near_unity.size else None,
        "spin": args.spin, "charge": args.charge,
    }
    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
