"""Semi-analytic renders and their parity with the traced engine — the
port's `grtrace.cli.exact`.

    python -m grtrace_torch.cli.exact --spin 0.9 --size 256 --elevation 25
    python -m grtrace_torch.cli.exact --spin 0.7 --size 48 --compare
    python -m grtrace_torch.cli.exact --spin 0.9 --size 256 --background

No integration: every pixel's equatorial crossings come from the
separated-Hamiltonian quadrature (physics/geodesic_exact.py), shaded with
the traced disk pipeline's Killing-constant physics; --background renders
the lensed sky from exact boundary-sphere escape records.  --compare
re-renders the scene with the traced engine and reports the per-pixel
parity: kernel B6 (render_disk) for the disk, kernel B5 in float64
(render_pixels_generic, metric 'KerrSchild') for the sky.  Writes
exact_disk.png, exact_g_map.csv and exact_r_em.csv (or exact_bg.png) and
prints one JSON line, the JAX driver's keys.  Runs on the CUDA card by
default; --device cpu takes the CPU (and the kernels' eager twins).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time


def build_parser():
    p = argparse.ArgumentParser(
        description="semi-analytic (no-stepping) thin-disk render")
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--elevation', type=float, default=25.0)
    p.add_argument('--orders', type=int, default=3)
    p.add_argument('--r-in', type=float, default=None)
    p.add_argument('--r-out', type=float, default=14.0)
    p.add_argument('--profile', choices=('shakura', 'novikov'),
                   default='shakura')
    p.add_argument('--retrograde', action='store_true')
    p.add_argument('--t-peak', type=float, default=9000.0)
    p.add_argument('--background', action='store_true',
                   help='render the lensed background sky (no disk) from '
                        'exact escape records')
    p.add_argument('--bg', type=str, default='procedural:checker',
                   help='background texture for --background '
                        '(procedural:<name> spec or image path)')
    p.add_argument('--compare', action='store_true',
                   help='also run the traced engine and report pixel '
                        'parity (it integrates)')
    p.add_argument('--steps', type=int, default=20_000,
                   help='traced-engine budget for --compare')
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    return p


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin ** 2 + args.charge ** 2 > 1.0:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")

    import numpy as np
    import torch

    from ..engine.disk import DiskConfig
    from ..engine.render_exact import render_disk_exact
    from ..io import artifacts
    from ..io.scene import IntegratorConfig, PatchConfig, SceneConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.exact: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, metric='kerr', spin=args.spin,
        charge=args.charge, n_samples=0,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta),
        patch=PatchConfig())
    if args.background:
        return _background_mode(args, scene)
    disk = DiskConfig(r_in=args.r_in, r_out=args.r_out,
                      prograde=not args.retrograde, profile=args.profile,
                      elevation_deg=args.elevation, show_background=False,
                      t_peak=args.t_peak)

    t0 = time.time()
    out = render_disk_exact(scene, disk, n_orders=args.orders,
                            device=args.device)
    _sync(args.device)
    dt = time.time() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(out["image_u8"],
                         os.path.join(args.out_dir, "exact_disk.png"))
    hw = out["shape"]
    g = out["g"].reshape(hw).cpu().numpy()
    r_em = out["r_em"].reshape(hw).cpu().numpy()
    order = out["order"].reshape(hw).cpu().numpy()
    np.savetxt(os.path.join(args.out_dir, "exact_g_map.csv"), g,
               delimiter=",")
    np.savetxt(os.path.join(args.out_dir, "exact_r_em.csv"), r_em,
               delimiter=",")
    mask = g > 0.0
    metrics = {
        "size": args.size, "spin": args.spin, "charge": args.charge,
        "orders": args.orders, "disk_pixels": int(mask.sum()),
        "pixels_per_order": [int((order == k).sum())
                             for k in range(args.orders)],
        "g_min": float(g[mask].min()) if mask.any() else None,
        "g_max": float(g[mask].max()) if mask.any() else None,
        "render_s": round(dt, 3), "files": 3,
    }
    if args.compare:
        from ..engine.disk import CLS_DISK, render_disk
        t0 = time.time()
        res = render_disk(scene, disk, device=args.device)
        _sync(args.device)
        t_traced = time.time() - t0
        g_tr = res.device("redshift").reshape(hw).cpu().numpy()
        m_tr = res.cls.reshape(hw) == CLS_DISK
        both = mask & m_tr
        dg = np.abs(g_tr[both] - g[both]) if both.any() else np.array([0.0])
        metrics |= {
            "traced_disk_pixels": int(m_tr.sum()),
            "mask_mismatch_pixels": int((mask ^ m_tr).sum()),
            "dg_max": float(dg.max()),
            "dg_median": float(np.median(dg)),
            "traced_render_s": round(t_traced, 3),
        }
    print(json.dumps(metrics))
    return metrics


def _background_mode(args, scene):
    """The exact lensed sky (and, with --compare, its parity with the
    traced Kerr-Schild engine in float64)."""
    import numpy as np
    import torch

    from ..engine.render_exact import render_pixels_background_exact
    from ..io import artifacts
    from ..io.textures import from_spec, is_procedural

    bg_np = (from_spec(args.bg) if is_procedural(args.bg)
             else artifacts.load_background(args.bg,
                                            size=(args.size, args.size)))
    bg = torch.as_tensor(np.asarray(bg_np), dtype=torch.uint8,
                         device=args.device)
    pa = scene.patch
    common = dict(obs_x=float(scene.observer_distance),
                  fov=math.radians(args.fov), mass=float(scene.bh_mass),
                  spin=float(args.spin),
                  boundary_radius=float(scene.boundary_radius),
                  patch_center_theta=pa.center_theta,
                  patch_center_phi=pa.center_phi,
                  patch_size_theta=pa.size_theta,
                  patch_size_phi=pa.size_phi)
    t0 = time.time()
    out = render_pixels_background_exact(
        bg, charge=args.charge, height=args.size, width=args.size,
        flip_theta=pa.flip_theta, flip_phi=pa.flip_phi, **common)
    img = out["image"].cpu().numpy()
    dt = time.time() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    artifacts.save_image(img, os.path.join(args.out_dir, "exact_bg.png"))
    cv = out["count_vec"].tolist()
    metrics = {"size": args.size, "spin": args.spin, "charge": args.charge,
               "captured": int(cv[0]), "escaped": int(cv[2]),
               "background": int(cv[3]), "render_s": round(dt, 3)}
    if args.compare:
        from ..engine.render_generic import render_pixels_generic
        t0 = time.time()
        gen = render_pixels_generic(
            bg, common["obs_x"], common["fov"], common["mass"],
            common["spin"], common["boundary_radius"], args.steps,
            args.delta, 0.0, common["patch_center_theta"],
            common["patch_center_phi"], common["patch_size_theta"],
            common["patch_size_phi"], height=args.size, width=args.size,
            flip_theta=pa.flip_theta, flip_phi=pa.flip_phi,
            dtype=torch.float64, metric="KerrSchild", order=2,
            charge=float(args.charge))
        img_g = gen["image"].cpu().numpy()
        t_traced = time.time() - t0
        cls_mismatch = int((gen["cls"] != out["cls"]).sum())
        qg, qe = gen["final_q"].cpu().numpy(), out["final_q"].cpu().numpy()
        esc = ((gen["status"] == 2) & (out["status"] == 2)).cpu().numpy()
        dth = np.abs(qg[..., 2] - qe[..., 2])[esc]
        dph = np.abs(np.mod(qg[..., 3] - qe[..., 3] + np.pi, 2 * np.pi)
                     - np.pi)[esc]
        metrics |= {
            "cls_mismatch_pixels": cls_mismatch,
            "dtheta_median": float(np.median(dth)) if esc.any() else None,
            "dphi_median": float(np.median(dph)) if esc.any() else None,
            "image_pixels_differing": int(
                (np.abs(img_g.astype(int) - img.astype(int))
                 .max(axis=-1) > 0).sum()),
            "traced_render_s": round(t_traced, 3),
        }
    print(json.dumps(metrics))
    return metrics


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
