"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `grtrace_torch/csrc` and drives both of
the port's paths through them:

  * kernel B1 (csrc/fantasy_eqc.cu): held against its eager twin on the
    card and against the float64 oracle golden, then the headline
    Schwarzschild render (400x400 rays, 200k steps, delta 0.01, float32);
  * kernel B5 (csrc/fantasy_ks.cu): held bitwise against its eager twins
    in the layouts the Kerr frame does not run (order 4 with charge, the
    16-row float and double layouts) at 48x48, its Kerr shadow boundary
    against the Bardeen closed form, then the full-width Kerr render (a =
    0.9, 1024x1024 rays, 30k steps, delta 0.02, float32), whose camera rays
    it is held bitwise against its twin on at the full budget;
  * kernel B6 (the disk mode of csrc/fantasy_ks.cu): held bitwise against
    its eager twins in the layouts the disk frame does not run (16 rows
    float and double) at 48x48, then the full-width thin-disk render (the
    README's disk command: a = 0.9, 512x512 rays, 30k steps, delta 0.02,
    float32, camera 12 deg above the disk, annulus [ISCO, 14]), whose
    camera rays it is held bitwise against its twin on at the full budget;
  * kernel B7 (the subring mode of csrc/fantasy_ks.cu): held bitwise
    against its eager twins at 48x48 (16 rows float and double with 3
    orders, 32 rows with 1 order), then the full-width subring render (the
    photon-ring command `--spin 0.9 --size 256 --orders 3` with the CLI's
    defaults: 256x256 rays, 30k steps, delta 0.02, float32, camera 75 deg
    above the disk, 3 image orders) beside the photon-shell prediction,
    whose camera rays it is held bitwise against its twin on at the full
    budget; then the photon-shell anchor: on-axis rays at the capture /
    escape edge cross the plane at the polar shell orbit's radius, at the
    half-orbit delay that physics/photon_shell.py predicts.

Each render checks that it went through its kernel.  Each phase prints one
line; any failure raises and the script exits non-zero.  The last three
lines are a JSON record of the kernels, the card's name and power limit,
and a JSON status line.

Imports only torch, numpy and grtrace_torch (never jax or grtrace): the
machine with the card has no jax.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "oracle_escape_headline.npz")

# the headline scene (bench.py's): 400x400, 200k steps, delta 0.01, omega 1
SIZE, STEPS, DELTA, OMEGA = 400, 200_000, 0.01, 1.0
OBS_X, FOV_DEG, MASS, R_MAX = 30.0, 80.0, 1.0, 31.0
# the TPU's counts for the headline scene (BENCH_r05.json)
TPU_COUNTS = {"captured": 5712, "escaped": 154288}

# the full-width Kerr scene (the README's Kerr row): a = 0.9, 1024x1024,
# 30k steps, delta 0.02, order 2, float32, same camera and boundary
KERR_SIZE, KERR_STEPS, KERR_DELTA, KERR_SPIN = 1024, 30_000, 0.02, 0.9

# the full-width disk scene (the README's disk command, with the CLI's
# defaults): a = 0.9, 512x512, 30k steps, delta 0.02, order 2, float32, the
# default DiskConfig (camera 12 deg above the plane, annulus [ISCO, 14])
DISK_SIZE, DISK_STEPS, DISK_DELTA, DISK_SPIN = 512, 30_000, 0.02, 0.9

# the full-width subring scene (grtrace/cli/subring.py's first command,
# `--spin 0.9 --size 256 --orders 3`, with the CLI's defaults): a = 0.9,
# 256x256, 30k steps, delta 0.02, order 2, float32, camera 75 deg above the
# plane, 3 image orders, annulus [ISCO, 14], Shakura-Sunyaev, no background
SUB_SIZE, SUB_STEPS, SUB_DELTA, SUB_SPIN = 256, 30_000, 0.02, 0.9
SUB_ORDERS, SUB_ELEV = 3, 75.0

# Bounds: the least time an H100 SXM could take, from its data sheet at
# 700 W: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Floating-point operations per ray-step, counted from the kernel sources
# (each add, subtract, multiply, divide and square root is one; no FMA
# under -fmad=false):
#   fantasy_eqc: per substep B M B A(bridge) = 1 + 3 flows x 42 + mixing 90
#                = 217; the guard's |dr| test 2 per step
#   fantasy_ks (32 rows): per substep 1 + 3 flows x (kick/drift 120 +
#                7 Kahan adds x 5) + mixing 120 = 586; per step the active
#                test 21 and the guard 95; the open and close flows 2 x 155
#                once per ray
#   fantasy_ks disk mode (32 rows): B5's count plus, per accepted step, the
#                two folds of z and their product (3); per hit ray the
#                crossing: t (2), eight lerps on folded rows (8 x 5) and the
#                hit radius (17) = 59 (crossings outside the annulus, which
#                do 39 of these, are not counted: the bound stays a bound)
#   fantasy_ks subring mode (32 rows): B5's count plus the same 3 per
#                accepted step; per recorded crossing t (2) and the eight
#                lerps (40) = 42 (a crossing past the last slot only adds
#                one to an integer count)
# (every scene runs order 2: one substep per step)
EQC_FLOPS_SUBSTEP, EQC_FLOPS_STEP = 217, 2
KS_FLOPS_SUBSTEP, KS_FLOPS_STEP, KS_FLOPS_RAY = 586, 116, 310
DISK_FLOPS_STEP, DISK_FLOPS_HIT = 3, 59
SUB_FLOPS_STEP, SUB_FLOPS_EVENT = 3, 42
# bytes the integration must move per ray: q0 and p0 in, final q and p,
# status and n_steps out (each read or written once); the disk mode also
# writes hit_q and hit_p, the subring mode the count and n_orders slots of
# (q, p)
BYTES_RAY = 8 * 4 + 8 * 4 + 4 + 4  # float32 rays
DISK_BYTES_RAY = BYTES_RAY + 8 * 4
SUB_BYTES_RAY = BYTES_RAY + 4 + SUB_ORDERS * 8 * 4


def phase(n, msg):
    print(f"[{n}] {msg}", flush=True)


def bound(flops, nbytes):
    """(bound in ms, 'operations' | 'bytes')."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def camera(size, device, dtype=torch.float32):
    from grtrace_torch.physics.camera import camera_rays
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device=device)
    q0, p0, *_ = camera_rays(obs, math.radians(FOV_DEG), size, size,
                             mass_bh=MASS, dtype=dtype, device=device)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def ks_camera(size, params, device, dtype=torch.float32):
    from grtrace_torch.physics.camera import camera_rays_cartesian
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device=device)
    q0, p0, _ = camera_rays_cartesian(
        obs, math.radians(FOV_DEG), size, size, params=params,
        g_inv_fn=kerr_schild_g_inv, dtype=dtype, device=device)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def gate_parity(tag, res):
    if (res["status_mismatch"] or res["n_steps_mismatch"]
            or res.get("hit_mismatch", 0) or res.get("count_mismatch", 0)):
        raise AssertionError(f"{tag}: status/n_steps/hit flags/crossing "
                             f"counts differ between kernel and twin")
    equal = [k for k in res if k.endswith("_bitwise_equal")]
    if not all(res[k] for k in equal):
        raise AssertionError(
            f"{tag}: {[k for k in equal if not res[k]]} false (max abs diff "
            f"{res['max_abs_err']:.3e}); the kernel is built with "
            f"-fmad=false to round exactly as the twin's torch ops")


def check_parity(tag, q0, p0, steps, delta, order, n):
    """Kernel B1 against its eager twin, which `backend='torch'` selects
    on the card."""
    from grtrace_torch.engine.integrate import integrate_dispatch
    from grtrace_torch.engine.integrate_cuda import integrate_batch_cuda
    from grtrace_torch.engine.validate import compare_outputs, timed
    args = (steps, delta, 2.0 * MASS, R_MAX, OMEGA)
    integrate_batch_cuda(q0, p0, *args, order=order)  # warm-up
    kern, kern_ms = timed(lambda: integrate_batch_cuda(q0, p0, *args,
                                                       order=order),
                          q0.device)
    twin, twin_ms = timed(lambda: integrate_dispatch(
        q0, p0, *args, backend="torch", equatorial=True, order=order),
        q0.device)
    res = compare_outputs(kern, twin)
    status = kern[2]
    res.update(rays=q0.shape[0], steps=steps, delta=delta, order=order,
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               n_steps_sum=int(kern[3].long().sum()),
               kernel_ms=kern_ms, twin_ms=twin_ms)
    phase(n, f"B1 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)
    return res


def check_parity_ks(tag, size, steps, delta, order, charge, dtype,
                    compensated, n):
    """Kernel B5 against its eager twin on the card, in one of its three
    layouts, on the KS camera (`validate.ks_kernel_parity`)."""
    from grtrace_torch.engine.integrate_ks_cuda import integrate_batch_ks_cuda
    from grtrace_torch.engine.validate import ks_kernel_parity
    params = (MASS, KERR_SPIN, charge)
    q0, p0 = ks_camera(size, params, torch.device("cuda", 0), dtype)
    args = (steps, delta, params, R_MAX, OMEGA)
    integrate_batch_ks_cuda(q0, p0, *args, order=order,
                            compensated=compensated)  # warm-up
    kern, res = ks_kernel_parity(q0, p0, *args, order=order,
                                 compensated=compensated)
    status = kern[2]
    res.update(rows=32 if compensated else 16, dtype=str(dtype)[6:],
               rays=q0.shape[0], steps=steps, delta=delta, order=order,
               spin=KERR_SPIN, charge=charge,
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               n_steps_max=int(kern[3].max()))
    phase(n, f"B5 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)


def golden_probes(device):
    from grtrace_torch.engine.integrate_cuda import integrate_batch_cuda
    g = np.load(GOLDEN)
    q0, p0 = camera(int(g["size"]), device)
    idx = torch.as_tensor(g["flat_idx"], device=device)
    q0, p0 = q0[idx].contiguous(), p0[idx].contiguous()
    fq, fp, st, ns = integrate_batch_cuda(
        q0, p0, int(g["steps"]), float(g["delta"]), 2.0 * float(g["mass"]),
        float(g["rmax"]), float(g["omega"]))
    fq, st, ns = fq.double().cpu().numpy(), st.cpu().numpy(), ns.cpu().numpy()
    oq = g["final_q"]
    dth = np.abs(fq[:, 2] - oq[:, 2])
    dph = np.abs((fq[:, 3] - oq[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    flips = np.flatnonzero(ns != g["n_steps"])
    res = {"rays": len(idx), "steps": int(g["steps"]),
           "all_escaped": bool((st == 2).all()),
           "max_dphi": float(dph.max()), "median_dphi": float(np.median(dph)),
           "max_dtheta": float(dth.max()),
           "exit_step_flips": [[int(i), int(ns[i]), int(g["n_steps"][i])]
                               for i in flips]}
    phase(4, f"golden probes vs float64 oracle: {json.dumps(res)}")
    if not (res["all_escaped"] and res["max_dphi"] < 1e-5
            and res["median_dphi"] < 2e-6 and res["max_dtheta"] < 1e-6):
        raise AssertionError("golden probes outside the f32 accuracy bounds "
                             "(all escaped, max dphi < 1e-5, median < 2e-6, "
                             "dtheta < 1e-6)")


def headline_scene():
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        boundary_radius=R_MAX, observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=STEPS, delta=DELTA, omega=OMEGA,
                                    backend="auto", dtype="float32"),
        patch=PatchConfig(), n_samples=0)


def main_path(device):
    import grtrace_torch
    from grtrace_torch.engine import integrate_cuda
    from grtrace_torch.engine.integrate import schw_true_escape_pred
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield

    scene = headline_scene()
    tex = starfield()
    integrate_cuda.launches = 0
    metrics = RenderMetrics()
    res = grtrace_torch.render(scene, bg_array=tex, device="cuda",
                               metrics=metrics)
    launches = integrate_cuda.launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    image = res.image
    fq = res.final_q
    summary = {"launches": launches, "counts": counts,
               "tpu_counts_BENCH_r05": TPU_COUNTS,
               "stages_s": metrics.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum()),
               "share_full_budget": float((ns == STEPS).mean())}
    phase(5, f"main path render {SIZE}x{SIZE}/{STEPS} steps through the "
             f"kernel: {json.dumps(summary)}")
    if launches < 1:
        raise AssertionError("the render did not launch the CUDA kernel")
    if counts["numerical_error"] or counts["in_domain"]:
        raise AssertionError(f"numerical_error/in_domain not 0: {counts}")
    if image.shape != (SIZE, SIZE, 3) or not np.isfinite(fq).all():
        raise AssertionError("render output has the wrong shape or "
                             "non-finite final positions")
    if (counts["captured"] != TPU_COUNTS["captured"]
            or counts["escaped"] != TPU_COUNTS["escaped"]):
        # The TPU's per-ray classes are not recorded.  After the rescue a
        # ray's status is the exact launch-state predicate, so the rays
        # that can flip between implementations are those whose launch
        # impact parameter rounds across b_crit: print the nearest.
        q0 = res.device("q0").reshape(-1, 4)
        p0 = res.device("p0").reshape(-1, 4)
        pred = schw_true_escape_pred(q0, p0, 2.0 * MASS).cpu().numpy()
        status = res.status.reshape(-1)
        off_pred = np.flatnonzero((status == 1) & pred
                                  | (status == 2) & ~pred)
        b = (p0[:, 3].abs() / p0[:, 0].abs()).double().cpu().numpy()
        b_rel = np.abs(b - 3.0 * math.sqrt(3.0) * MASS) / (
            3.0 * math.sqrt(3.0) * MASS)
        nearest = np.sort(b_rel)[:10]
        phase(5, f"counts differ from the TPU's by "
                 f"{counts['captured'] - TPU_COUNTS['captured']} captured; "
                 f"{len(off_pred)} rays' status disagrees with the exact "
                 f"predicate; nearest-critical |b - b_crit|/b_crit: "
                 f"{nearest.tolist()}")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm render counts {r.counts} differ "
                                 f"from the first render's {counts}")
    wall = float(np.median(walls))
    phase(5, f"headline render warm wall time: median {wall:.6f} s of "
             f"{[round(w, 6) for w in walls]}, {SIZE * SIZE / wall:.1f} rays/s")
    return launches, wall


def kerr_scene():
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=KERR_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric="kerr", spin=KERR_SPIN, boundary_radius=R_MAX,
        observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=KERR_STEPS, delta=KERR_DELTA,
                                    omega=OMEGA, order=2, backend="auto",
                                    dtype="float32"),
        patch=PatchConfig(), n_samples=0)


def kerr_boundary():
    from grtrace_torch.engine.validate import kerr_shadow_errors
    t0 = time.perf_counter()
    res = kerr_shadow_errors(spin=KERR_SPIN, device="cuda")
    res["seconds"] = time.perf_counter() - t0
    phase(8, f"Kerr shadow boundary (B5 kernel, float32, 8 azimuths) vs the "
             f"Bardeen closed form, 256^2 px: {json.dumps(res)}")
    if not res["px_err_max"] <= 0.05:
        raise AssertionError(f"Kerr boundary error {res['px_err_max']} px "
                             f"> 0.05 px")


def kerr_main_path():
    import grtrace_torch
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.integrate_ks import bardeen_escape_pred
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield

    scene = kerr_scene()
    tex = starfield()
    integrate_ks_cuda.launches = 0
    metrics = RenderMetrics()
    res = grtrace_torch.render(scene, bg_array=tex, device="cuda",
                               metrics=metrics)
    launches = integrate_ks_cuda.launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    q0 = res.device("q0").reshape(-1, 4)
    p0 = res.device("p0").reshape(-1, 4)
    pred = bardeen_escape_pred(q0, p0, MASS, KERR_SPIN, 0.0)
    status = res.device("status").reshape(-1)
    off_pred = int((((status == 1) & pred) | ((status == 2) & ~pred)).sum())
    summary = {"launches": launches, "counts": counts,
               "stages_s": metrics.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum()),
               "status_off_bardeen_pred": off_pred}
    phase(9, f"Kerr render {KERR_SIZE}x{KERR_SIZE}/{KERR_STEPS} steps, "
             f"a = {KERR_SPIN}, through the kernel: {json.dumps(summary)}")
    if launches < 1:
        raise AssertionError("the Kerr render did not launch kernel B5")
    if counts["numerical_error"]:
        raise AssertionError(f"numerical_error not 0: {counts}")
    if (res.image.shape != (KERR_SIZE, KERR_SIZE, 3)
            or not np.isfinite(res.final_q).all()):
        raise AssertionError("Kerr render output has the wrong shape or "
                             "non-finite final positions")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm Kerr render counts {r.counts} "
                                 f"differ from the first render's {counts}")
    wall = float(np.median(walls))

    # kernel B5 and its wrapper (sort, pack, launch, unsort, rescue)
    # against its eager twin, on this frame's camera rays and budget
    from grtrace_torch.engine.validate import ks_kernel_parity
    q0c, p0c = q0.contiguous(), p0.contiguous()
    kern, par = ks_kernel_parity(q0c, p0c, KERR_STEPS, KERR_DELTA,
                                 (MASS, KERR_SPIN, 0.0), R_MAX, OMEGA)
    ray_steps = int(kern[3].long().sum())
    n = q0c.shape[0]
    par.update(rays=n, steps=KERR_STEPS, ray_steps=ray_steps,
               n_steps_max=int(kern[3].max()))
    phase(9, f"B5 kernel vs eager twin on the Kerr frame's rays: "
             f"{json.dumps(par)}")
    gate_parity("Kerr frame", par)
    bound_ms, bound_by = bound(
        ray_steps * (KS_FLOPS_SUBSTEP + KS_FLOPS_STEP) + n * KS_FLOPS_RAY,
        n * BYTES_RAY)
    phase(9, f"Kerr render warm wall time: median {wall:.6f} s of "
             f"{[round(w, 6) for w in walls]}, {n / wall:.1f} rays/s; B5 "
             f"kernel+wrapper at this shape {par['kernel_ms']:.3f} ms "
             f"({100 * par['kernel_ms'] / 1e3 / wall:.1f}% of the wall), "
             f"eager twin {par['twin_ms']:.3f} ms, {ray_steps} ray-steps, "
             f"bound {bound_ms:.3f} ms ({bound_by})")
    return {"launches": launches, "wall": wall, "bound_ms": bound_ms,
            "bound_by": bound_by, **par}


def disk_camera(size, device, dtype=torch.float32, elevation_deg=12.0):
    """The disk scene's inclined camera rays (the subring scene's at
    elevation_deg=75), as render_disk and render_subrings make them."""
    from grtrace_torch import DiskConfig, SceneConfig
    from grtrace_torch.engine.disk import disk_observer_position
    from grtrace_torch.physics.camera import (cartesian_ics_from_pixels,
                                              pixel_grid_lookat)
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    obs = torch.tensor(disk_observer_position(
        SceneConfig(), DiskConfig(elevation_deg=elevation_deg)),
        dtype=dtype, device=device)
    pix = pixel_grid_lookat(obs, torch.tensor(math.radians(FOV_DEG),
                                              dtype=dtype, device=device),
                            size, size, dtype=dtype, device=device)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix,
                                          params=(MASS, DISK_SPIN, 0.0),
                                          g_inv_fn=kerr_schild_g_inv)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def disk_annulus():
    from grtrace_torch import DiskConfig
    disk = DiskConfig()
    return disk.inner_edge(MASS, DISK_SPIN), disk.r_out


def check_parity_disk(tag, size, steps, delta, dtype, compensated, n):
    """Kernel B6 against its eager twin on the card, in one of its three
    layouts, on the disk camera (`validate.ks_kernel_parity(disk=...)`)."""
    from grtrace_torch.engine.integrate_ks_cuda import \
        integrate_batch_disk_cuda
    from grtrace_torch.engine.validate import ks_kernel_parity
    params = (MASS, DISK_SPIN, 0.0)
    q0, p0 = disk_camera(size, torch.device("cuda", 0), dtype)
    args = (steps, delta, params, R_MAX, OMEGA)
    annulus = disk_annulus()
    integrate_batch_disk_cuda(q0, p0, *args, *annulus,
                              compensated=compensated)  # warm-up
    kern, res = ks_kernel_parity(q0, p0, *args, compensated=compensated,
                                 disk=annulus)
    status = kern[2]
    res.update(rows=32 if compensated else 16, dtype=str(dtype)[6:],
               rays=q0.shape[0], steps=steps, delta=delta,
               disk=int((status == 3).sum()),
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               n_steps_max=int(kern[3].max()))
    phase(n, f"B6 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)


def disk_scene():
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=DISK_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric="kerr", spin=DISK_SPIN, boundary_radius=R_MAX,
        observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=DISK_STEPS, delta=DISK_DELTA,
                                    omega=OMEGA, order=2, backend="auto",
                                    dtype="float32"),
        patch=PatchConfig(), n_samples=0)


def disk_main_path():
    import grtrace_torch
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield
    from grtrace_torch.physics.kerr_schild import ks_radius_c

    scene = disk_scene()
    tex = starfield()
    r_in, r_out = disk_annulus()
    integrate_ks_cuda.disk_launches = 0
    metrics = RenderMetrics()
    res = grtrace_torch.render_disk(scene, bg_array=tex, device="cuda",
                                    metrics=metrics)
    launches = integrate_ks_cuda.disk_launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    dm = res.device("status").reshape(-1) == 3
    if not bool(dm.any()):
        raise AssertionError(f"the disk render has no disk pixel: {counts}")
    g = res.device("redshift").reshape(-1)[dm]
    hq = res.device("hit_q").reshape(-1, 4)[dm]
    # the kernel's own hit radius, in float32 with the float32 scalars
    a32 = float(torch.tensor(DISK_SPIN, dtype=torch.float32))
    r_hit = ks_radius_c(hq[:, 1], hq[:, 2], hq[:, 3], a32)
    r_in32 = float(torch.tensor(r_in, dtype=torch.float32))
    summary = {"launches": launches, "counts": counts,
               "stages_s": metrics.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum()),
               "r_in": r_in, "r_out": r_out,
               "g_min": float(g.min()), "g_max": float(g.max()),
               "g_finite": bool(torch.isfinite(g).all()),
               "r_hit_min": float(r_hit.min()),
               "r_hit_max": float(r_hit.max())}
    phase(11, f"disk render {DISK_SIZE}x{DISK_SIZE}/{DISK_STEPS} steps, "
              f"a = {DISK_SPIN}, through kernel B6: {json.dumps(summary)}")
    if launches < 1:
        raise AssertionError("the disk render did not launch kernel B6")
    if counts["numerical_error"] or counts["disk"] <= 0:
        raise AssertionError(f"numerical_error not 0 or no disk pixel: "
                             f"{counts}")
    if (res.image.shape != (DISK_SIZE, DISK_SIZE, 3)
            or res.image.dtype != np.uint8):
        raise AssertionError("disk render image is not (512, 512, 3) uint8")
    if not (summary["g_finite"] and summary["g_max"] > 1.0
            and summary["g_min"] < 0.7):
        raise AssertionError("disk redshift not finite with max g > 1 and "
                             "min g < 0.7 on the disk pixels")
    if not (summary["r_hit_min"] >= r_in32 and summary["r_hit_max"] <= r_out):
        raise AssertionError(f"a disk hit lies outside [{r_in32}, {r_out}]")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render_disk(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm disk render counts {r.counts} "
                                 f"differ from the first render's {counts}")
    wall = float(np.median(walls))

    # kernel B6 and its wrapper against its eager twin, on this frame's
    # camera rays and budget
    from grtrace_torch.engine.validate import ks_kernel_parity
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    kern, par = ks_kernel_parity(q0, p0, DISK_STEPS, DISK_DELTA,
                                 (MASS, DISK_SPIN, 0.0), R_MAX, OMEGA,
                                 disk=(r_in, r_out))
    ray_steps = int(kern[3].long().sum())
    hits = int((kern[2] == 3).sum())
    n = q0.shape[0]
    par.update(rays=n, steps=DISK_STEPS, ray_steps=ray_steps, hits=hits,
               n_steps_max=int(kern[3].max()))
    phase(12, f"B6 kernel vs eager twin on the disk frame's rays: "
              f"{json.dumps(par)}")
    gate_parity("disk frame", par)
    bound_ms, bound_by = bound(
        ray_steps * (KS_FLOPS_SUBSTEP + KS_FLOPS_STEP + DISK_FLOPS_STEP)
        + n * KS_FLOPS_RAY + hits * DISK_FLOPS_HIT, n * DISK_BYTES_RAY)
    phase(12, f"disk render warm wall time: median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}, {n / wall:.1f} rays/s; B6 "
              f"kernel+wrapper at this shape {par['kernel_ms']:.3f} ms "
              f"({100 * par['kernel_ms'] / 1e3 / wall:.1f}% of the wall), "
              f"eager twin {par['twin_ms']:.3f} ms, {ray_steps} ray-steps, "
              f"bound {bound_ms:.3f} ms ({bound_by})")
    return {"launches": launches, "wall": wall, "bound_ms": bound_ms,
            "bound_by": bound_by, **par}


def check_parity_subring(tag, size, steps, delta, dtype, compensated,
                         n_orders, n):
    """Kernel B7 against its eager twin on the card, in one of its three
    layouts, on the subring camera
    (`validate.ks_kernel_parity(subrings=...)`)."""
    from grtrace_torch.engine.integrate_ks_cuda import \
        integrate_batch_subrings_cuda
    from grtrace_torch.engine.validate import ks_kernel_parity
    params = (MASS, SUB_SPIN, 0.0)
    q0, p0 = disk_camera(size, torch.device("cuda", 0), dtype, SUB_ELEV)
    args = (steps, delta, params, R_MAX, OMEGA)
    integrate_batch_subrings_cuda(q0, p0, *args, n_orders=n_orders,
                                  compensated=compensated)  # warm-up
    kern, res = ks_kernel_parity(q0, p0, *args, compensated=compensated,
                                 subrings=n_orders)
    count = kern[6]
    res.update(rows=32 if compensated else 16, dtype=str(dtype)[6:],
               rays=q0.shape[0], steps=steps, delta=delta, n_orders=n_orders,
               count_max=int(count.max()),
               rays_past_last_slot=int((count > n_orders).sum()),
               captured=int((kern[2] == 1).sum()),
               escaped=int((kern[2] == 2).sum()),
               n_steps_max=int(kern[3].max()))
    phase(n, f"B7 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)


def subring_scene():
    from grtrace_torch import (DiskConfig, IntegratorConfig, PatchConfig,
                               SceneConfig)
    scene = SceneConfig(
        size=SUB_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric="kerr", spin=SUB_SPIN, boundary_radius=R_MAX,
        observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=SUB_STEPS, delta=SUB_DELTA,
                                    omega=OMEGA, order=2, backend="auto",
                                    dtype="float32"),
        patch=PatchConfig(), n_samples=0)
    disk = DiskConfig(r_out=14.0, prograde=True, profile="shakura",
                      elevation_deg=SUB_ELEV, show_background=False,
                      t_peak=9000.0)
    return scene, disk


def shell_theory():
    """The photon-shell prediction along the critical curve seen from the
    subring camera's latitude (float64 on the host, as the JAX CLI's
    shell_theory computes it)."""
    from grtrace_torch.physics.photon_shell import critical_curve_observables
    theta_obs = max(math.radians(90.0 - SUB_ELEV), 1e-4)
    curve = critical_curve_observables((MASS, SUB_SPIN, 0.0), theta_obs, n=33)
    gam, dts = curve["gamma"].numpy(), curve["delta_t"].numpy()
    return {"gamma_min": float(gam.min()), "gamma_median": float(
                np.median(gam)), "gamma_max": float(gam.max()),
            "delay_half_orbit_M_min": float(dts.min()),
            "delay_half_orbit_M_median": float(np.median(dts)),
            "delay_half_orbit_M_max": float(dts.max())}


def subring_main_path():
    import grtrace_torch
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.metrics import RenderMetrics

    scene, disk = subring_scene()
    r_in = disk.inner_edge(MASS, SUB_SPIN)
    r_in32 = float(torch.tensor(r_in, dtype=torch.float32))
    integrate_ks_cuda.subring_launches = 0
    metrics = RenderMetrics()
    res = grtrace_torch.render_subrings(scene, disk, n_orders=SUB_ORDERS,
                                        device="cuda", metrics=metrics)
    launches = integrate_ks_cuda.subring_launches
    counts = res.counts
    valid, inten = res.valid, res.intensity
    count, ns = res.count, res.n_steps.astype(np.int64)
    r_em = res.r_em[valid]
    summary = grtrace_torch.subring_summary(res)
    t0 = time.perf_counter()
    theory = shell_theory()
    theory_s = time.perf_counter() - t0
    info = {"launches": launches, "counts": counts,
            "stages_s": metrics.stages, "n_steps_max": int(ns.max()),
            "n_steps_sum": int(ns.sum()),
            "valid_per_order": valid.sum(axis=(1, 2)).tolist(),
            "r_em_min": float(r_em.min()), "r_em_max": float(r_em.max()),
            "summary": summary, "shell_theory": theory,
            "shell_theory_s": theory_s}
    phase(14, f"subring render {SUB_SIZE}x{SUB_SIZE}/{SUB_STEPS} steps, "
              f"a = {SUB_SPIN}, {SUB_ORDERS} orders, camera {SUB_ELEV} deg, "
              f"through kernel B7: {json.dumps(info)}")
    if launches < 1:
        raise AssertionError("the subring render did not launch kernel B7")
    if counts["numerical_error"]:
        raise AssertionError(f"numerical_error not 0: {counts}")
    if (res.image.shape != (SUB_SIZE, SUB_SIZE, 3)
            or res.image.dtype != np.uint8
            or inten.shape != (SUB_ORDERS, SUB_SIZE, SUB_SIZE)
            or valid.shape != inten.shape):
        raise AssertionError("subring render: image not (256, 256, 3) uint8 "
                             "or per-order stacks not (3, 256, 256)")
    if not (valid[0].any() and valid[1].any() and count.max() >= 2):
        raise AssertionError("subring render: orders 0 and 1 need pixels "
                             "and some ray two crossings")
    if (inten[~valid] != 0.0).any() or not (inten[valid] > 0.0).all():
        raise AssertionError("subring intensity is not 0 exactly off the "
                             "valid events and > 0 on them")
    if not np.allclose(res.total_intensity, inten.sum(axis=0), rtol=1e-6,
                       atol=0.0):
        raise AssertionError("total_intensity is not the sum over orders")
    if not (r_em.min() >= r_in32 and r_em.max() <= disk.r_out):
        raise AssertionError(f"an emitting event lies outside "
                             f"[{r_in32}, {disk.r_out}]")
    flux = summary["flux_per_order"]
    if not flux[0] > flux[1] > 0.0:
        raise AssertionError(f"flux per order {flux}: need F0 > F1 > 0")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render_subrings(scene, disk, n_orders=SUB_ORDERS,
                                          device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm subring render counts {r.counts} "
                                 f"differ from the first render's {counts}")
    wall = float(np.median(walls))

    # kernel B7 and its wrapper against its eager twin, on this frame's
    # camera rays and budget
    from grtrace_torch.engine.validate import ks_kernel_parity
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    kern, par = ks_kernel_parity(q0, p0, SUB_STEPS, SUB_DELTA,
                                 (MASS, SUB_SPIN, 0.0), R_MAX, OMEGA,
                                 subrings=SUB_ORDERS)
    ray_steps = int(kern[3].long().sum())
    cnt = kern[6]
    recorded = [int((cnt > s).sum()) for s in range(SUB_ORDERS)]
    n = q0.shape[0]
    par.update(rays=n, steps=SUB_STEPS, ray_steps=ray_steps,
               n_steps_max=int(kern[3].max()),
               crossings_recorded_per_order=recorded,
               crossings_total=int(cnt.long().sum()))
    phase(15, f"B7 kernel vs eager twin on the subring frame's rays: "
              f"{json.dumps(par)}")
    gate_parity("subring frame", par)
    bound_ms, bound_by = bound(
        ray_steps * (KS_FLOPS_SUBSTEP + KS_FLOPS_STEP + SUB_FLOPS_STEP)
        + n * KS_FLOPS_RAY + sum(recorded) * SUB_FLOPS_EVENT,
        n * SUB_BYTES_RAY)
    phase(15, f"subring render warm wall time: median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}, {n / wall:.1f} rays/s; B7 "
              f"kernel+wrapper at this shape {par['kernel_ms']:.3f} ms "
              f"({100 * par['kernel_ms'] / 1e3 / wall:.1f}% of the wall), "
              f"eager twin {par['twin_ms']:.3f} ms, {ray_steps} ray-steps, "
              f"bound {bound_ms:.3f} ms ({bound_by})")
    return {"launches": launches, "wall": wall, "bound_ms": bound_ms,
            "bound_by": bound_by, **par}


def photon_shell_anchor():
    """The subring path's closed-form gate (tests/test_photon_shell.py's
    tier 3): on-axis rays (L_z = 0) at the capture/escape edge of a = 0.9
    shadow the polar shell orbit, so their deep equatorial crossings sit at
    its radius, one predicted half-orbit delay apart in BL time.  B7's
    float64 layout at order 4, delta 0.02, omega 0, 10 orders; the edge
    u_crit is bracketed by bisection of 17-ray fans."""
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.hotspot import bl_time_azimuth_offsets
    from grtrace_torch.engine.validate import bisect_boundary
    from grtrace_torch.physics.camera import cartesian_ics_from_pixels
    from grtrace_torch.physics.photon_shell import (critical_parameters,
                                                    polar_shell_radius)
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv, ks_radius

    device, f64 = torch.device("cuda", 0), torch.float64
    params = (MASS, SUB_SPIN, 0.0)
    obs = torch.tensor([0.0, 0.0, OBS_X], dtype=f64, device=device)
    t0 = time.perf_counter()
    steps_max = [0]
    integrate_ks_cuda.subring_launches = 0

    def run(us):
        u = torch.as_tensor(np.asarray(us, np.float64).reshape(-1),
                            device=device)
        pix = torch.stack([u, torch.zeros_like(u), torch.full_like(u, 24.0)],
                          dim=-1)
        q0, p0, _ = cartesian_ics_from_pixels(obs, pix, params=params,
                                              g_inv_fn=kerr_schild_g_inv)
        out = integrate_ks_cuda.integrate_batch_subrings_cuda(
            q0.contiguous(), p0.contiguous(), 300_000, 0.02, params, R_MAX,
            0.0, n_orders=10, order=4, compensated=False)
        steps_max[0] = max(steps_max[0], int(out[3].max()))
        return out

    rounds = 11
    mid, width = bisect_boundary(
        lambda us: (run(us)[2] == 2).reshape(np.shape(us)).cpu().numpy(),
        0.80, 0.92, rounds=rounds, k=17, n_psi=1)
    u_crit = float(mid[0]) + 0.5 * width      # the bracket's escaping end
    _, _, status, _, hq, _, count = run([u_crit + 1e-10])
    hq = hq[:, 0].cpu()
    r_bl = ks_radius(hq[:, 1], hq[:, 2], hq[:, 3], SUB_SPIN)
    t_bl = hq[:, 0] - bl_time_azimuth_offsets(r_bl, params)[0]
    r_polar = polar_shell_radius(params)
    _, dt_pred, *_ = critical_parameters(r_polar, params)
    gaps = [float(t_bl[i] - t_bl[i + 1]) for i in (2, 3)]
    res = {"u_crit": u_crit, "bracket": width, "rounds": rounds,
           "launches": integrate_ks_cuda.subring_launches,
           "n_steps_max": steps_max[0],
           "status": int(status[0]), "count": int(count[0]),
           "r_bl_crossings": [float(r) for r in r_bl[:int(count[0])]],
           "r_polar": float(r_polar), "delta_t_pred": float(dt_pred),
           "gap_23": gaps[0], "gap_34": gaps[1],
           "gap_rel_err": [g / float(dt_pred) - 1.0 for g in gaps],
           "seconds": time.perf_counter() - t0}
    phase(16, f"photon-shell anchor (B7 float64, a = {SUB_SPIN}, on-axis "
              f"camera): {json.dumps(res)}")
    if res["count"] < 5:
        raise AssertionError(f"the edge ray crossed {res['count']} < 5 times")
    if not all(abs(float(r_bl[i]) - float(r_polar)) < 0.02 for i in (2, 3)):
        raise AssertionError("crossings 2 and 3 are not within 0.02 M of the "
                             "polar shell radius")
    if not all(abs(e) < 5e-3 for e in res["gap_rel_err"]):
        raise AssertionError("crossing gaps 2-3 / 3-4 are not within 5e-3 of "
                             "the predicted half-orbit delay")


def build_kernels():
    from grtrace_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    wall = time.perf_counter() - t0
    build.load()
    regs = []
    for stem, (lib, _) in sorted(built.items()):
        log = lib.with_suffix(".log").read_text()
        for k in build.ptxas_summary(log):
            regs.append(f"{k['kernel']}: {k['registers']} registers, "
                        f"{k['spill_stores']}/{k['spill_loads']} bytes "
                        f"spill stores/loads")
    per_lib = {stem: round(s, 2) for stem, (_, s) in built.items()}
    phase(2, f"built {sorted(p.name for p, _ in built.values())} in "
             f"{wall:.2f} s (per nvcc {per_lib}); {' | '.join(regs)}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import grtrace_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    phase(1, f"card: {smi}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}")
    build_kernels()

    # --- kernel B1 and the headline Schwarzschild path --------------------
    q0, p0 = camera(SIZE, device)
    # the headline camera at the full budget: the very call render makes
    a = check_parity(f"headline camera {SIZE}x{SIZE}, {STEPS} steps",
                     q0, p0, STEPS, DELTA, 2, "3a")
    q0s, p0s = camera(64, device)
    for order in (2, 4):
        check_parity(f"64x64 camera, order {order}", q0s, p0s, 2000, 0.05,
                     order, "3b")

    golden_probes(device)
    launches, wall = main_path(device)

    phase(6, f"integration at phase 3a's shapes ({SIZE * SIZE} rays, "
             f"{STEPS} step budget): kernel {a['kernel_ms']:.3f} ms "
             f"({100 * a['kernel_ms'] / 1e3 / wall:.1f}% of the render's "
             f"warm wall time), eager twin {a['twin_ms']:.3f} ms")
    eqc_bound, eqc_by = bound(
        a["n_steps_sum"] * (EQC_FLOPS_SUBSTEP + EQC_FLOPS_STEP),
        a["rays"] * BYTES_RAY)

    # --- kernel B5 and the Kerr path ---------------------------------------
    # order 4 with charge and the 16-row layouts are off the main path and
    # held at small shapes; the main path's order-2 32-row layout is held
    # at the full Kerr frame in phase 9
    check_parity_ks("KS camera 48x48, order 4, charge 0.3, 3000 steps, "
                    "delta 0.05, 32 rows float", 48, 3000, 0.05, 4, 0.3,
                    torch.float32, True, "7a")
    for dtype in (torch.float32, torch.float64):
        check_parity_ks(f"KS camera 48x48, 2000 steps, delta 0.05, 16 rows "
                        f"{str(dtype)[6:]}", 48, 2000, 0.05, 2, 0.0, dtype,
                        False, "7b")
    kerr_boundary()
    kerr = kerr_main_path()

    # --- kernel B6 and the disk path ---------------------------------------
    # the 16-row layouts are off the main path and held at small shapes; the
    # main path's 32-row layout is held at the full disk frame in phase 12
    for dtype in (torch.float32, torch.float64):
        check_parity_disk(f"disk camera 48x48, 2000 steps, delta 0.05, 16 "
                          f"rows {str(dtype)[6:]}", 48, 2000, 0.05, dtype,
                          False, "10")
    disk = disk_main_path()

    # --- kernel B7 and the subring path ------------------------------------
    # the 16-row layouts and a single slot are off the main path and held at
    # small shapes; the main path's 32-row, 3-order layout is held at the
    # full subring frame in phase 15
    for dtype in (torch.float32, torch.float64):
        check_parity_subring(f"subring camera 48x48, 2000 steps, delta 0.05, "
                             f"16 rows {str(dtype)[6:]}, 3 orders", 48, 2000,
                             0.05, dtype, False, 3, "13")
    check_parity_subring("subring camera 48x48, 2000 steps, delta 0.05, 32 "
                         "rows float32, 1 order", 48, 2000, 0.05,
                         torch.float32, True, 1, "13")
    sub = subring_main_path()
    photon_shell_anchor()

    print(json.dumps({"kernels": [
        {"name": "fantasy_eqc",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_eqc.cu",
         "replaces": "grtrace/engine/integrate_pallas.py:77",
         "launches": launches,
         "max_abs_err": a["max_abs_err"],
         "ms": a["kernel_ms"],
         "plain_ms": a["twin_ms"],
         "bound_ms": eqc_bound,
         "bound_by": eqc_by,
         "library_ms": None,
         "shapes": f"ms, plain_ms and bound at {SIZE}x{SIZE} headline rays, "
                   f"{STEPS}-step budget (phase 3a)"},
        {"name": "fantasy_ks",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "grtrace/engine/integrate_pallas_ks.py:72",
         "launches": kerr["launches"],
         "max_abs_err": kerr["max_abs_err"],
         "ms": kerr["kernel_ms"],
         "plain_ms": kerr["twin_ms"],
         "bound_ms": kerr["bound_ms"],
         "bound_by": kerr["bound_by"],
         "library_ms": None,
         "shapes": f"every number at {KERR_SIZE}x{KERR_SIZE} Kerr rays, "
                   f"{KERR_STEPS}-step budget (phase 9)"},
        {"name": "fantasy_ks_disk",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "grtrace/engine/integrate_pallas_ks.py:72",
         "launches": disk["launches"],
         "max_abs_err": disk["max_abs_err"],
         "ms": disk["kernel_ms"],
         "plain_ms": disk["twin_ms"],
         "bound_ms": disk["bound_ms"],
         "bound_by": disk["bound_by"],
         "library_ms": None,
         "shapes": f"the disk mode (B6); every number at "
                   f"{DISK_SIZE}x{DISK_SIZE} disk-camera rays, "
                   f"{DISK_STEPS}-step budget (phase 12)"},
        {"name": "fantasy_ks_subring",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "grtrace/engine/integrate_pallas_ks.py:72",
         "launches": sub["launches"],
         "max_abs_err": sub["max_abs_err"],
         "ms": sub["kernel_ms"],
         "plain_ms": sub["twin_ms"],
         "bound_ms": sub["bound_ms"],
         "bound_by": sub["bound_by"],
         "library_ms": None,
         "shapes": f"the subring mode (B7); every number at "
                   f"{SUB_SIZE}x{SUB_SIZE} subring-camera rays, "
                   f"{SUB_STEPS}-step budget, {SUB_ORDERS} orders "
                   f"(phase 15)"}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
