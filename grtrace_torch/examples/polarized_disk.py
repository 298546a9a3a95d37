"""The polarized Novikov-Thorne disk on the port — the counterpart of
`examples/polarized_disk.py`.

Renders a Kerr (a = 0.9) accretion disk with the Novikov-Thorne profile
and a vertical magnetic field (96 x 96, 4,000 steps of 0.05: kernel B6 on
the card, its eager twins with --device cpu), writes the science products
(redshift map, line profile, polarization map; their figures unless
--no-plots), and checks two closed forms inline: the vertical field's
pitch weight on the outer disk of this near-edge-on view, and the
face-on Schwarzschild redshift sqrt(1 - 3M/r) / sqrt(1 - 2M/r_obs).

    python -m grtrace_torch.examples.polarized_disk [out_dir]
        [--device cpu] [--no-plots]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="polarized Novikov-Thorne disk")
    p.add_argument('out_dir', nargs='?', default="polarized_disk_out")
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='render on the CUDA card (the default; exits with '
                        'a message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='write the CSVs only (the figures need matplotlib)')
    return p


def run(out_dir="polarized_disk_out", size=96, steps=4000, face_size=64,
        device="cuda", plots=True):
    """The example (the polarized disk at size x size, the face-on
    Schwarzschild disk at face_size x face_size, `steps` steps of 0.05
    each); returns a dict of the numbers it prints."""
    from ..engine.disk import DiskConfig, render_disk, save_disk_maps
    from ..io.scene import IntegratorConfig, SceneConfig

    os.makedirs(out_dir, exist_ok=True)
    scene = SceneConfig(size=size, metric="kerr", spin=0.9, n_samples=0,
                        integrator=IntegratorConfig(steps=steps, delta=0.05))
    disk = DiskConfig(profile="novikov", bfield="vertical",
                      emissivity_index=3.0)
    res = render_disk(scene, disk, device=device)
    print("counts:", res.counts)
    save_disk_maps(res, out_dir, emissivity_index=disk.emissivity_index,
                   plots=plots)
    print("wrote:", sorted(os.listdir(out_dir)))

    dm = np.asarray(res.cls) == 5
    g = res.device("redshift").cpu().numpy()[dm]
    w = res.device("pol_weight").cpu().numpy()[dm]
    hq = res.device("hit_q").cpu().numpy()[dm]
    r_em = np.sqrt((hq[:, 1:] ** 2).sum(axis=-1))
    print(f"\n{dm.sum()} disk pixels; g in [{g.min():.3f}, {g.max():.3f}] "
          f"(blue horn {np.quantile(g, 0.95):.3f})")

    # check 1: a near-edge-on view of a vertical field: the photons travel
    # almost in the disk plane, nearly perpendicular to B, so the pitch
    # weight sin^2(theta_B) is about 1
    outer = r_em > 11.0
    pitch = float(np.median(w[outer])) if outer.any() else float("nan")
    if outer.any():
        print(f"pitch weight sin^2(theta_B), outer disk: median "
              f"{pitch:.3f} (expect ~1 for this edge-on view)")

    # check 2: the face-on Schwarzschild redshift's closed form
    scene0 = SceneConfig(size=face_size, metric="kerr", spin=0.0,
                         n_samples=0,
                         integrator=IntegratorConfig(steps=steps,
                                                     delta=0.05))
    res0 = render_disk(scene0, DiskConfig(elevation_deg=89.9,
                                          show_background=False),
                       device=device)
    dm0 = np.asarray(res0.cls) == 5
    g0 = res0.device("redshift").cpu().numpy()[dm0]
    hq0 = res0.device("hit_q").cpu().numpy()[dm0]
    r0 = np.sqrt((hq0[:, 1:] ** 2).sum(axis=-1))
    expect = np.sqrt(1 - 3 / r0) / np.sqrt(1 - 2 / 30.0)
    err = float(np.abs(g0 / expect - 1).max())
    print(f"face-on closed-form redshift: max rel err {err:.2e}")
    return {"counts": res.counts, "disk_pixels": int(dm.sum()),
            "g_min": float(g.min()), "g_max": float(g.max()),
            "pitch_outer": pitch, "faceon_err": err,
            "faceon_pixels": int(dm0.sum())}


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..viz import plots

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.examples.polarized_disk: no CUDA "
                         "device (torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.examples.polarized_disk: the "
                         "figures need matplotlib, which this Python does "
                         "not have; pass --no-plots")
    return run(args.out_dir, device=args.device, plots=not args.no_plots)


if __name__ == "__main__":
    main()
