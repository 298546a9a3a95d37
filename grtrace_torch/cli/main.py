"""End-to-end pipeline driver — the port's `grtrace.cli.main`.

Pipeline (the reference main.py's):
  scene -> flat-space reference image (no_gravity.png, scene_full.png)
        -> curved render (manual_output.png, photon_data.csv,
           sampled_rays.csv)
        -> scene diagnostics (topdown, closeup 3D, embedding 3D x 8 azimuths)
        -> photon summary printed from the counts.

Everything runs on the CUDA card by default (--device cpu for the CPU): the
flat render, the curved render through the hand-written kernels (B1 for
float32, B2 for --dtype float64, B5 for --metric kerr, G1 for --metric
kerr-bl, G1s for --metric kottler / bardeen / hayward, G1r for the
rotating regular families, G1d for --metric kerr-ds, B6 for --disk, D1
for --disk around a static family, D2 around a rotating one, D3 around
Kerr-de Sitter; --aa S launches the same kernel again on the S x S
sub-rays of the boundary pixels, engine/aa.py) and the sampled
trajectories through kernel S1 (S2 on the Kerr charts, S2s on the static
one, S2r on the rotating regular families', S2d on Kerr-de Sitter's).
--disk writes the disk's
science products (redshift_map.csv, line_profile.csv and, with
--disk-bfield, polarization_map.csv; their figures unless --no-plots) and,
with --save-transfer, the transfer map that cli/reshade.py and
cli/hotspot.py --transfer read.  The kernels build at first use (there is
no compilation cache to warm).

Run: python -m grtrace_torch.cli.main [flags]  (flags: cli/args.py)
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

from ..engine.disk import render_disk, save_disk_maps
from ..engine.flat import flat_render_scene
from ..engine.metrics import (RenderMetrics, device_summary, roofline_report,
                              trace)
from ..engine.render import KDS_NAMES, STATIC_NAMES, render
from ..io import artifacts
from ..viz import plots
from .args import disk_from_args, parse_args, scene_from_args

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(levelname)s: %(message)s")

# the operation table's entry for the kernel layout each render runs (the
# roofline): B1 or B2 on the headline path; in the Kerr-Schild chart B5's
# 32-row compensated layout for float32 rays, its 16-row plain one for
# float64 rays; in the Boyer-Lindquist chart G1 (render_generic)
_KERNEL = {"float32": "fantasy_eqc", "float64": "fantasy_eq"}
_KERNEL_KS = {"float32": "fantasy_ks", "float64": "fantasy_ks_plain"}


def roofline_kernel(scene, disk=False):
    """The operation table's entry for the layout `render(scene)` (or,
    with `disk`, `render_disk(scene)`: the Kerr-Schild chart, or
    `render_disk_static(scene)` for a static family, `render_disk_kds`
    for Kerr-de Sitter) runs."""
    if scene.metric.lower() in KDS_NAMES:
        return "fantasy_gen_disk_kds" if disk else "fantasy_gen_kds"
    if scene.metric.lower() in STATIC_NAMES:
        return "fantasy_gen_disk_static" if disk else "fantasy_gen_static"
    if not disk and scene.metric.lower() == "kerr-bl":
        return "fantasy_gen"
    ks = disk or scene.metric.lower() == "kerrschild" or scene.charge
    return (_KERNEL_KS if ks else _KERNEL)[scene.integrator.dtype]


def check_ported(args, scene):
    """Raise SystemExit for the options the JAX CLI refuses (and
    NotImplementedError where its engine raises), before any work runs."""
    if args.save_transfer and not args.disk:
        raise SystemExit("--save-transfer requires --disk (the transfer "
                         "map records disk-crossing invariants)")
    if args.camera_omega is not None and not args.disk:
        raise SystemExit("--camera-omega requires --disk (the orbiting "
                         "camera rides the disk pipeline)")
    if args.save_transfer and args.aa:
        raise SystemExit(
            "--save-transfer with --aa is not supported: the transfer map "
            "stores single-ray crossing invariants, so a reshade would "
            "replace the antialiased disk-edge pixels with single-ray "
            "colours; save the transfer from a run without --aa")
    metric = scene.metric.lower()
    if metric in STATIC_NAMES and args.disk:
        # the static families' planar-fold disk (engine/disk_static.py):
        # AA and transfer maps ride the Kerr-Schild path only, as in JAX
        if args.aa:
            raise SystemExit(
                "--aa with --disk is implemented on the Kerr-family disk "
                "path; static-family disks render without edge refinement")
        if args.save_transfer:
            raise SystemExit(
                "--save-transfer records Kerr-Schild chart crossings; not "
                "supported with static-family metrics")
        if args.camera_omega is not None:
            raise NotImplementedError(
                "orbiting cameras (--camera-omega) ride the Kerr-Schild "
                "disk path (engine/disk.py); static-family disks take a "
                "static camera")
    if metric.startswith("rotating") and args.disk and args.save_transfer:
        # the reference's reshade() drops the metric, so a rotating map
        # would reshade as Kerr-Newman: JAX refuses it here
        raise SystemExit(
            "--save-transfer reshading is wired for the Kerr-Newman "
            "family; not supported with rotating regular metrics")
    if metric in KDS_NAMES and args.disk:
        # the Carter chart's theta-crossing disk (engine/disk_kds.py)
        if args.aa:
            raise SystemExit(
                "--aa with --disk rides the Kerr-family path; kerr-ds "
                "disks render without edge refinement")
        if args.save_transfer:
            raise SystemExit(
                "--save-transfer records Kerr-Schild chart crossings; not "
                "supported with kerr-ds")


def _untimed(name):
    return contextlib.nullcontext()


def main(argv=None):
    args = parse_args(argv)
    scene = scene_from_args(args)
    check_ported(args, scene)
    disk_cfg = disk_from_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grtrace_torch.cli.main: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if not args.no_plots and not plots.available():
        raise SystemExit("grtrace_torch.cli.main: the scene plots need "
                         "matplotlib, which this Python does not have; "
                         "pass --no-plots")
    out = args.out_dir
    images_dir = os.path.join(out, "images")
    rm = RenderMetrics() if args.print_metrics else None
    stage = rm.stage if rm is not None else _untimed

    bg_array = None
    with stage("texture"):
        if artifacts.background_available(scene.background):
            # reference behavior: texture resized to the output resolution
            bg_array = artifacts.load_background(
                scene.background, size=(scene.size, scene.size))
        elif scene.background:
            logging.warning(
                "Background %s not found; rendering without it (tip: "
                "--background procedural:starfield needs no asset files)",
                scene.background)

    observer = scene.observer()
    bh = scene.black_hole()

    # --- flat-space reference image ---
    flat_trajs = None
    if not scene.no_flat_trajectories and bg_array is not None:
        logging.info("Saving no-gravity image using background...")
        with stage("flat_render"):
            flat_img, flat_trajs = flat_render_scene(
                observer, bg_array,
                boundary_radius=scene.boundary_radius,
                patch_center_theta=scene.patch.center_theta,
                patch_center_phi=scene.patch.center_phi,
                patch_size_theta=scene.patch.size_theta,
                patch_size_phi=scene.patch.size_phi,
                flip_theta=scene.patch.flip_theta,
                flip_phi=scene.patch.flip_phi,
                n_sampled=10, seed=args.seed,
                override_patch_center=False, device=device)
        with stage("png_writes"):
            artifacts.save_image(flat_img,
                                 os.path.join(images_dir, "no_gravity.png"))
            artifacts.save_image(bg_array,
                                 os.path.join(images_dir, "scene_full.png"))

    # --- curved render ---
    logging.info("Starting manual ray tracing simulation...")
    with trace(os.path.join(out, "torch_trace") if args.profile
               else None) as prof:
        t0 = time.time()
        if disk_cfg is not None and scene.metric.lower() in STATIC_NAMES:
            from ..engine.disk_static import render_disk_static
            result = render_disk_static(scene, disk_cfg, bg_array=bg_array,
                                        metrics=rm, device=device)
        elif disk_cfg is not None and scene.metric.lower() in KDS_NAMES:
            from ..engine.disk_kds import render_disk_kds
            result = render_disk_kds(scene, disk_cfg, bg_array=bg_array,
                                     metrics=rm, device=device)
        elif disk_cfg is not None:
            result = render_disk(scene, disk_cfg, bg_array=bg_array,
                                 metrics=rm, aa_samples=args.aa or None,
                                 device=device)
        else:
            result = render(scene, bg_array=bg_array, seed=args.seed,
                            metrics=rm, aa_samples=args.aa or None,
                            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
    logging.info("Curved render finished in %.2fs (%s backend)",
                 wall, scene.integrator.backend)
    if args.profile:
        logging.info("torch.profiler trace written to %s/torch_trace/"
                     "trace.json (view in chrome://tracing or Perfetto)",
                     out)
        # the device-busy share of the render's wall time
        print(json.dumps({"profile": device_summary(prof, wall)}))
    with stage("png_writes"):
        artifacts.save_image(result.image,
                             os.path.join(images_dir, "manual_output.png"))
    logging.info("Saved manual_output.png")
    if disk_cfg is not None:
        # the disk mode's science products: the per-pixel g = nu_obs/nu_em,
        # the emission radius, the line profile (and the EVPA map)
        with stage("disk_maps"):
            save_disk_maps(result, out,
                           emissivity_index=disk_cfg.emissivity_index,
                           spin=scene.spin, plots=not args.no_plots,
                           chart="spherical"
                           if scene.metric.lower() in STATIC_NAMES
                           or scene.metric.lower() in KDS_NAMES
                           else "ks")
        logging.info("Saved the disk maps (redshift_map, line_profile%s)",
                     ", polarization_map" if disk_cfg.bfield else "")
        if args.save_transfer:
            from ..io.transfer import TransferMap
            TransferMap.from_result(result, scene, disk_cfg).save(
                args.save_transfer)
            logging.info("Saved geodesic transfer map to %s (re-shade with "
                         "python -m grtrace_torch.cli.reshade)",
                         args.save_transfer)

    with stage("csv_writes"):
        artifacts.save_photon_data(result,
                                   os.path.join(out, "photon_data.csv"))
        if result.sampled_trajectories:
            artifacts.save_sampled_rays(
                result, os.path.join(out, "sampled_rays.csv"))
    if rm is not None:
        print(rm)
        if device.type == "cuda":
            print(json.dumps({"roofline": roofline_report(
                rm.steps_per_s, roofline_kernel(scene, disk_cfg is not None),
                scene.integrator.order, scene.integrator.dtype)}))

    # --- scene diagnostics ---
    if not args.no_plots:
        photon_trajs = None
        if result.sampled_trajectories:
            photon_trajs = []
            for traj in result.sampled_trajectories:
                keep = ~np.all(traj == 0, axis=1)
                if keep.any():
                    photon_trajs.append(traj[keep])
            print(f"Filtered {len(photon_trajs)} trajectories")
        logging.info("Saving top-down scene view...")
        plots.plot_scene_topdown(
            bh, observer, scene.image_size, scene.boundary_radius,
            out_path=os.path.join(images_dir, "scene_topdown.png"),
            fov_deg=scene.fov_deg,
            patch_center_theta=scene.patch.center_theta,
            patch_size_theta=scene.patch.size_theta,
            patch_size_phi=scene.patch.size_phi,
            photon_trajectories=photon_trajs)
        logging.info("Saving close-up 3D scene view...")
        plots.plot_scene_closeup_3d(
            bh, observer, scene.image_size,
            out_path=os.path.join(images_dir, "scene_closeup_3d.png"),
            fov_deg=scene.fov_deg, photon_trajectories=photon_trajs)
        logging.info("Saving 3D embedding scene view...")
        plots.plot_scene_embedding_3d(
            bh, observer, scene.image_size, scene.boundary_radius,
            out_path=os.path.join(images_dir, "scene_topdown_3d.png"),
            fov_deg=scene.fov_deg,
            photon_trajectories=photon_trajs, flat_trajectories=flat_trajs,
            patch_center_theta=scene.patch.center_theta,
            patch_center_phi=scene.patch.center_phi,
            patch_size_theta=scene.patch.size_theta,
            patch_size_phi=scene.patch.size_phi,
            override_patch_center=False)

    # --- photon summary ---
    artifacts.print_summary(result.counts)
    return result


def console(argv=None):
    """setuptools console-script entry (must not return a value — sys.exit
    would print it and exit non-zero)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
