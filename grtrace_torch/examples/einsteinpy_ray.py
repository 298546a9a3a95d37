"""The EinsteinPy single-ray example on the port — the counterpart of
`examples/einsteinpy_ray.py`.

Traces one null geodesic with the EinsteinPy-compatible `Nulllike`
(grtrace_torch.compat): r = 4, equatorial, theta-directed momentum
(0, 1, 0), 10,000 steps, delta = 0.001, omega = 0.01, on kernel T1 on the
card (its eager twin with --device cpu); prints the first rows of the
(steps, 8) trajectory with its radius column and the radius range, and
draws the 4-panel lambda-coloured figure (viz.plots.plot_geodesic) unless
--no-plots.  numpy takes the place of the JAX example's pandas.

    python -m grtrace_torch.examples.einsteinpy_ray [out.png] [--device cpu]
        [--no-plots]
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        description="one EinsteinPy-compatible null geodesic")
    p.add_argument('out', nargs='?', default="einsteinpy_ray.png",
                   help='figure path')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='print the trajectory only (the figure needs '
                        'matplotlib)')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..compat import Nulllike
    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.examples.einsteinpy_ray: no CUDA "
                         "device (torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.examples.einsteinpy_ray: the figure "
                         "needs matplotlib, which this Python does not "
                         "have; pass --no-plots")

    # integrate once in spherical coordinates; the Cartesian columns are the
    # trig conversion `trajectory` itself does with return_cartesian=True
    geod = Nulllike(
        metric="Schwarzschild",
        metric_params=(0.0,),
        position=(4.0, np.pi / 2, 0.0),
        momentum=(0.0, 1.0, 0.0),   # theta-directed
        steps=10_000,
        delta=0.001,
        omega=0.01,                 # small omega -> stable integration
        return_cartesian=False,
        suppress_warnings=True,
        device=args.device,
    )
    print(f"Starting geodesic integration... {geod!r}")
    _, sph = geod.trajectory  # rows: t, r, th, ph, pt, pr, pth, pph

    t, r, th, ph = sph[:, 0], sph[:, 1], sph[:, 2], sph[:, 3]
    sin_th = np.sin(th)
    cart = np.stack([t, r * sin_th * np.cos(ph), r * sin_th * np.sin(ph),
                     r * np.cos(th), sph[:, 4], sph[:, 5], sph[:, 6],
                     sph[:, 7]], axis=-1)
    radius = np.linalg.norm(cart[:, 1:4], axis=1)
    table = np.column_stack([cart, radius])
    print("t, x, y, z, pt, pr, pth, pph, r")
    for row in table[:5]:
        print(", ".join(f"{v:.6g}" for v in row))
    print(f"\n{len(table)} samples; r range [{radius.min():.4f}, "
          f"{radius.max():.4f}]  (tangential at r0=4: impact parameter "
          "b = 4/sqrt(1-2/4) = 5.66 > b_crit = 3*sqrt(3) = 5.196, so the "
          "ray slowly spirals out)")

    if not args.no_plots:
        plots.plot_geodesic(sph[:, :4], mass_bh=1.0, step=25,
                            out_path=args.out)
        print(f"wrote {args.out}")
    return table


if __name__ == "__main__":
    main()
