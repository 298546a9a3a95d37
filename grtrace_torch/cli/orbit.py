"""Camera-orbit animation driver — the port's `grtrace.cli.orbit`:
multi-frame rendering over the ('frames', 'rays') mesh with per-frame
resume.

Orbiting in the equatorial plane is, by the symmetry about +z, a rotation
of the background patch center (sharding/mesh.orbit_frames), so every
frame is the same render with the patch turned: the Schwarzschild frames
through B1 (float32), --metric kerr through B5 (`render_kerr_sharded`),
--disk through B6 with the inclined camera (`render_disk_sharded`, a
camera on a circular worldline with --camera-omega).  A batch of frames
goes to the card in one launch a rank.

Resume: each finished frame is a PNG under OUT/frames; a rerun with the
same --out-dir renders only the missing ones.  --bench re-renders every
frame, warm, and prints one JSON line with the frames/s.  The driver
draws no figure: --no-plots is accepted for the port's uniform flags.

Run: python -m grtrace_torch.cli.orbit --frames 32 --size 256 [flags]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .line_grid import check_device


def build_parser():
    p = argparse.ArgumentParser(description="camera-orbit animation")
    p.add_argument('--frames', type=int, default=16)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--fov', type=float, default=80.0)
    p.add_argument('--steps', type=int, default=50_000)
    p.add_argument('--delta', type=float, default=0.02)
    p.add_argument('--background', type=str, default=None)
    p.add_argument('--bh-mass', type=float, default=1.0)
    p.add_argument('--boundary-radius', type=float, default=31.0)
    p.add_argument('--observer-distance', type=float, default=30.0)
    p.add_argument('--bg-patch-size-theta', type=float, default=180.0)
    p.add_argument('--bg-patch-size-phi', type=float, default=350.0)
    p.add_argument('--metric', type=str, default='schwarzschild',
                   choices=['schwarzschild', 'kerr'],
                   help='kerr orbits stay exact: equatorial orbits about the '
                        'spin axis are the axisymmetry family')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--charge', type=float, default=0.0)
    p.add_argument('--backend', type=str, default='auto',
                   choices=['auto', 'cuda', 'torch', 'pallas', 'xla'])
    p.add_argument('--disk', action='store_true',
                   help='orbit the thin accretion disk scene (axisymmetric, '
                        'so the patch rotation stays exact with the '
                        'inclined camera)')
    p.add_argument('--disk-elevation', type=float, default=12.0,
                   help='camera elevation above the disk plane (deg)')
    p.add_argument('--disk-r-out', type=float, default=14.0)
    p.add_argument('--camera-omega', type=str, default=None,
                   metavar='W|keplerian|zamo',
                   help='orbit with a camera on a circular worldline (disk '
                        'mode only; see cli.main)')
    p.add_argument('--disk-profile', choices=('shakura', 'novikov'),
                   default='shakura',
                   help='radial temperature law (engine.disk)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='run on the CUDA card (the default; exits with a '
                        'message when there is none) or on the CPU')
    p.add_argument('--no-plots', action='store_true',
                   help='accepted for the uniform flags (no figure here)')
    p.add_argument('--out-dir', type=str, default='orbit_out')
    p.add_argument('--gif', action='store_true',
                   help='also write orbit.gif (needs Pillow)')
    p.add_argument('--frames-per-batch', type=int, default=None,
                   help='frames rendered per call (default: about 4M rays a '
                        'call, 1..16)')
    p.add_argument('--bench', action='store_true',
                   help='after rendering, re-render every frame (warm) and '
                        'print one JSON line with the frames/s')
    p.add_argument('--out-json', type=str, default=None,
                   help='with --bench: also write the JSON line here')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spin and args.metric != 'kerr':
        raise SystemExit("--spin requires --metric kerr")
    if args.spin ** 2 + args.charge ** 2 > args.bh_mass ** 2:
        raise SystemExit("naked singularity: need a^2 + Q^2 <= M^2")
    if args.camera_omega is not None and not args.disk:
        raise SystemExit("--camera-omega requires --disk")
    check_device(args.device, "orbit")

    import dataclasses

    import torch

    from ..engine.metrics import card
    from ..io import artifacts
    from ..io.scene import (JAX_BACKENDS, IntegratorConfig, PatchConfig,
                            SceneConfig)
    from ..physics.orbits import isco_radius
    from ..sharding.mesh import (init_distributed_from_env, make_mesh,
                                 orbit_frames, rank_device,
                                 render_disk_sharded, render_frames_sharded,
                                 render_kerr_sharded)

    init_distributed_from_env()
    backend = JAX_BACKENDS.get(args.backend, args.backend)
    scene = SceneConfig(
        size=args.size, fov_deg=args.fov, background=args.background,
        bh_mass=args.bh_mass, boundary_radius=args.boundary_radius,
        observer_distance=args.observer_distance, n_samples=0,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta,
                                    omega=1.0, backend=backend),
        patch=PatchConfig(
            size_theta=float(np.deg2rad(args.bg_patch_size_theta)),
            size_phi=float(np.deg2rad(args.bg_patch_size_phi))))
    if artifacts.background_available(args.background):
        bg = artifacts.load_background(args.background,
                                       size=(args.size, args.size))
    else:
        from ..io import textures
        bg = textures.starfield(args.size, args.size)

    mesh = make_mesh(1)        # rays over every rank; frames batched in time
    lead = mesh.rank == 0
    device = rank_device(args.device)
    obs, phis = orbit_frames(scene, args.frames)
    frames_dir = os.path.join(args.out_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)

    def frame_path(k):
        return os.path.join(frames_dir, f"frame_{k:04d}.png")

    # resume: skip frames whose PNG already exists and is non-empty
    done = {k for k in range(args.frames)
            if os.path.exists(frame_path(k))
            and os.path.getsize(frame_path(k)) > 0}
    todo = [k for k in range(args.frames) if k not in done]
    if done and lead:
        print(f"resuming: {len(done)} frames already rendered")

    kerr = args.metric == 'kerr' or args.charge != 0.0
    disk_r_in = float(isco_radius(args.bh_mass, args.spin))
    cam_moving, cam_omega = False, 0.0
    if args.camera_omega is not None:
        from ..engine.disk import DiskConfig, resolve_camera_omega
        spec = args.camera_omega
        if spec not in ('keplerian', 'zamo'):
            try:
                spec = float(spec)
            except ValueError:
                raise SystemExit(f"--camera-omega must be a number, "
                                 f"'keplerian' or 'zamo', got {spec!r}")
        cam_scene = dataclasses.replace(scene, metric='kerr', spin=args.spin,
                                        charge=args.charge)
        cam_moving, cam_omega = resolve_camera_omega(
            cam_scene, DiskConfig(r_out=args.disk_r_out,
                                  elevation_deg=args.disk_elevation,
                                  camera_omega=spec))
        if lead:
            print(f"camera worldline: omega = {cam_omega:.6g} "
                  f"({args.camera_omega})")

    default_batch = min(16, max(1, 4_000_000 // (args.size * args.size)))
    batch = args.frames_per_batch or default_batch
    if batch <= 0:
        raise SystemExit("--frames-per-batch must be >= 1")
    common = dict(height=args.size, width=args.size, device=device)

    def render_batch(ks, obs_batch):
        patch = (np.pi / 2, phis[ks], scene.patch.size_theta,
                 scene.patch.size_phi)
        if args.disk:
            return render_disk_sharded(
                mesh, bg, obs_batch, scene.fov, scene.bh_mass, args.spin,
                scene.boundary_radius, args.steps, args.delta, 1.0,
                float(np.deg2rad(args.disk_elevation)), disk_r_in,
                args.disk_r_out, 9000.0, 2.5, *patch, cam_omega,
                backend=backend, charge=args.charge,
                profile=args.disk_profile, camera_moving=cam_moving,
                **common)
        if kerr:
            return render_kerr_sharded(
                mesh, bg, obs_batch, scene.fov, scene.bh_mass, args.spin,
                scene.boundary_radius, args.steps, args.delta, 1.0, *patch,
                backend=backend, charge=args.charge, **common)
        return render_frames_sharded(
            mesh, bg, obs_batch, scene.fov, scene.bh_mass,
            scene.boundary_radius, args.steps, args.delta, 1.0, *patch,
            backend=backend, **common)

    images = {}
    for start in range(0, len(todo), batch):
        ks = todo[start:start + batch]
        imgs = render_batch(ks, obs[ks])["image"].cpu().numpy()
        for j, k in enumerate(ks):
            images[k] = imgs[j]
            if lead:
                artifacts.save_image(imgs[j], frame_path(k))
        if lead:
            print(f"rendered frames {ks}")
    result = {"frames_dir": frames_dir, "images": images}

    if args.bench:
        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        batches = [list(range(s, min(s + batch, args.frames)))
                   for s in range(0, args.frames, batch)]
        for ks in batches:     # warm every batch shape
            render_batch(ks, obs[ks])["image"].cpu()
        sync()
        t0 = time.perf_counter()
        for ks in batches:
            render_batch(ks, obs[ks])["image"].cpu()
        sync()
        t = time.perf_counter() - t0
        fps = args.frames / t
        line = json.dumps({
            "metric": f"orbit_{args.size}_frames_per_s",
            "value": round(fps, 2), "unit": "frames/s",
            "frames": args.frames, "steps_budget": args.steps,
            "metric_family": args.metric, "spin": args.spin,
            "disk": args.disk, "frames_per_batch": batch,
            "wall_s": round(t, 4),
            "device": card() if device.type == "cuda" else "cpu"})
        result["bench"] = json.loads(line)
        if lead:
            print(line)
            if args.out_json:
                with open(args.out_json, "w") as f:
                    f.write(line + "\n")

    if args.gif and lead:
        from PIL import Image
        frames = [Image.open(frame_path(k)) for k in range(args.frames)]
        gif_path = os.path.join(args.out_dir, "orbit.gif")
        frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                       duration=80, loop=0)
        print(f"wrote {gif_path}")
    return result


def console(argv=None):
    main(argv)
    return 0


if __name__ == "__main__":
    main()
