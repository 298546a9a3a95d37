"""Strong-lensing image finder — the port's `grtrace.cli.images`.

    python -m grtrace_torch.cli.images --source-theta 95 --source-phi 166 \
        --spin 0.9 --windings -1 0 1

Finds every lensed image of a source direction (degrees, the background
texture's frame) in the camera plane by damped Newton on the
differentiable semi-analytic escape map (engine/images.py): no rendering,
no integration, exact Jacobians by forward-mode autodiff.  Prints one JSON
line with the image table (fractional pixel positions in the --size
frame, signed magnifications) and, with --overlay, marks the images on
the exact lensed sky (images_overlay.png).  Runs on the CUDA card by
default; --device cpu takes the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="strong-lensing multiple-image finder")
    p.add_argument('--source-theta', type=float, required=True,
                   help='source polar angle, degrees')
    p.add_argument('--source-phi', type=float, required=True,
                   help='source azimuth, degrees')
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--windings', type=int, nargs='+', default=[-1, 0, 1])
    p.add_argument('--scan', type=int, default=96,
                   help='seed-scan resolution (raise to catch '
                        'higher-order images hugging the shadow)')
    p.add_argument('--tol', type=float, default=1e-8)
    p.add_argument('--overlay', action='store_true',
                   help='also render the lensed sky (exact renderer) and '
                        'mark each image')
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import numpy as np
    import torch

    from ..engine.images import find_images

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.images: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    th_s = np.deg2rad(args.source_theta)
    ph_s = np.deg2rad(args.source_phi)
    ph_s = np.mod(ph_s + np.pi, 2 * np.pi) - np.pi
    imgs = find_images(
        th_s, ph_s, params=[1.0, args.spin, args.charge],
        fov=np.deg2rad(args.fov), height=args.size, width=args.size,
        scan=args.scan, windings=tuple(args.windings), tol=args.tol,
        device=args.device)
    metrics = {
        "source_theta_deg": args.source_theta,
        "source_phi_deg": args.source_phi,
        "spin": args.spin, "charge": args.charge, "size": args.size,
        "n_found": sum(im["converged"] for im in imgs),
        "images": imgs,
    }
    if args.overlay:
        from ..engine.render_exact import render_pixels_background_exact
        from ..io import artifacts
        from ..io.textures import checker

        bg = torch.as_tensor(checker(64, 128), dtype=torch.uint8,
                             device=args.device)
        out = render_pixels_background_exact(
            bg, 30.0, math.radians(args.fov), 1.0, args.spin, 31.0,
            math.pi / 2, math.pi, 2 * math.pi, 2 * math.pi,
            height=args.size, width=args.size, charge=args.charge)
        img = np.array(out["image"].cpu().numpy().reshape(args.size,
                                                          args.size, 3))
        for im in imgs:
            if not im["converged"]:
                continue
            i0, j0 = int(round(im["i"])), int(round(im["j"]))
            s = max(2, args.size // 64)
            img[max(0, i0 - s):min(args.size, i0 + s + 1), j0:j0 + 1] = \
                (255, 40, 40)
            img[i0:i0 + 1, max(0, j0 - s):min(args.size, j0 + s + 1)] = \
                (255, 40, 40)
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "images_overlay.png")
        artifacts.save_image(img, path)
        metrics["overlay"] = path
    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
