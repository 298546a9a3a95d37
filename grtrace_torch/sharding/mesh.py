"""Multi-device rendering: rays over one mesh axis, frames over the other —
the torch.distributed counterpart of `grtrace.sharding.mesh`.

A `Mesh` lays ('frames', 'rays') over the ranks of the default process
group (rank = frame_shard * n_ray_shards + ray_shard, the order of JAX's
devices.reshape(F, R)); with no process group the world is this one
process, as JAX's mesh over jax.devices() is one chip.  Each rank computes
the camera initial conditions of its own slice of the flattened pixel
batch (`_local_ray_indices`: the ray axis padded up to a multiple of the
shard count, padding recomputing the last pixel) for its own frames,
integrates, classifies and composites them; the only communication is the
assembly at the end, one `all_gather` (JAX's implicit output gather), or
one `all_reduce` of zero-padded per-frame rows where JAX sums with `psum`
(sharding/grid.py).  Each rank runs on `cuda:{LOCAL_RANK}` unless the caller
asks for the CPU.  Under the nccl backend the collectives run on the card,
under gloo on the host.

The frames of one rank share every scalar of their kernel's vector, so
their rays go to the card in one launch: B1 / B2 (`integrate_dispatch`)
for the Schwarzschild frames, B5 (`integrate_dispatch_ks`) for the Kerr
ones, G1r (`integrate_dispatch_generic`) for the rotating regular
families' ones, B6 (`integrate_dispatch_disk`) for the disk.  A pixel's result does
not depend on the launch it rides in, so the images, classes and step
counts do not depend on the mesh's shape.

Camera orbits exploit the symmetry about +z: orbiting the observer in the
equatorial plane is the background patch rotating by -delta_phi
(`orbit_frames`).
"""
from __future__ import annotations

import atexit
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..engine import classify as _classify
from ..engine.disk import CLS_DISK, shade_disk
from ..engine.integrate import STATUS_CAPTURED, integrate_dispatch
from ..engine.integrate_generic import integrate_dispatch_generic
from ..engine.integrate_ks import (STATUS_DISK, integrate_dispatch_disk,
                                   integrate_dispatch_ks)
from ..physics.camera import (boosted_ics_from_pixels,
                              cartesian_ics_from_pixels, initial_conditions,
                              pixel_positions_fractional,
                              pixel_positions_fractional_lookat)
from ..physics.coords import cartesian_to_spherical
from ..physics.rotating_regular import MASS_FN, rotating_capture_radius
from ..physics.spacetime import (COORDS, METRICS, horizon_radius,
                                 kerr_schild_g_inv, ks_radius)


@dataclass(frozen=True)
class Mesh:
    """('frames', 'rays') over the ranks of the default process group;
    `rank` is this process's."""
    n_frames_shards: int
    n_ray_shards: int
    rank: int = 0

    @property
    def shape(self):
        return {"frames": self.n_frames_shards, "rays": self.n_ray_shards}

    @property
    def size(self):
        return self.n_frames_shards * self.n_ray_shards

    @property
    def frame_shard(self):
        return self.rank // self.n_ray_shards

    @property
    def ray_shard(self):
        return self.rank % self.n_ray_shards


def _world():
    """(rank, world size, process group initialized)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


def make_mesh(n_frames_shards=1, n_ray_shards=None) -> Mesh:
    """('frames', 'rays') mesh over the ranks of the default process group
    (one rank when none is initialized)."""
    rank, world, _ = _world()
    if n_ray_shards is None:
        n_ray_shards = world // n_frames_shards
    if n_frames_shards * n_ray_shards != world:
        raise ValueError(f"mesh {n_frames_shards}x{n_ray_shards} != "
                         f"{world} ranks")
    return Mesh(int(n_frames_shards), int(n_ray_shards), rank)


def rank_device(device="cuda"):
    """The device this rank computes on: 'cuda' becomes cuda:{LOCAL_RANK}
    under a process group (cuda:0 without one); other devices pass."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        _, _, grouped = _world()
        index = int(os.environ.get("LOCAL_RANK", "0")) if grouped else 0
        device = torch.device("cuda", index)
    return device


def init_distributed_from_env():
    """Initialize the default process group from torchrun's environment
    (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) when it is set and no
    group exists: nccl where the card is there, gloo otherwise; the group
    is destroyed at exit.  Returns whether a group is initialized."""
    if "WORLD_SIZE" not in os.environ or not dist.is_available():
        return False
    if not dist.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend=backend, init_method="env://")
        atexit.register(_destroy_group)
    return True


def _destroy_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def _comm_device(device):
    """Where a collective's buffers live: the rank's card under nccl, the
    host under gloo."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def all_gather_rows(x):
    """(world, *x.shape): every rank's x, in rank order; x itself with no
    process group.  Returned on x's device."""
    _, world, grouped = _world()
    if not grouped:
        return x[None]
    comm = _comm_device(x.device)
    xc = x.contiguous().to(comm)
    parts = [torch.empty_like(xc) for _ in range(world)]
    dist.all_gather(parts, xc)
    return torch.stack(parts).to(x.device)


def all_reduce_sum(x):
    """The sum of x over every rank (x itself with no process group),
    on x's device."""
    _, _, grouped = _world()
    if not grouped:
        return x
    comm = _comm_device(x.device)
    xc = x.contiguous().to(comm)
    dist.all_reduce(xc, op=dist.ReduceOp.SUM)
    return xc.to(x.device)


def _local_ray_indices(n, n_ray_shards, shard, device):
    """This rank's flat pixel indices (int64) and their realness: the ray
    axis is padded up to a multiple of the shard count; padding lanes
    recompute the last pixel (cropped, or weight-masked in sums)."""
    n_local = -(-n // n_ray_shards)
    gidx = shard * n_local + torch.arange(n_local, device=device)
    return torch.clamp(gidx, max=n - 1), gidx < n


def _local_frames(mesh, f):
    """The frame indices of this rank's frame shard."""
    if f % mesh.n_frames_shards:
        raise ValueError(f"{f} frames do not split over "
                         f"{mesh.n_frames_shards} frame shards")
    f_local = f // mesh.n_frames_shards
    return range(mesh.frame_shard * f_local, (mesh.frame_shard + 1) * f_local)


def _pixels(flat_idx, width, dtype):
    """Fractional-pixel indices (i, j) of flat indices: integer centres,
    which give pixel_grid's bits (physics/camera.py)."""
    return ((flat_idx // width).to(dtype), (flat_idx % width).to(dtype))


def _assemble(mesh, local, n, height, width):
    """Per-rank (F_local, n_local, ...) blocks -> (F, H, W, ...) on every
    rank: gathered in rank order, frame shards then ray shards, the padded
    ray axis cropped."""
    parts = all_gather_rows(local)              # (world, F_l, n_l, ...)
    fs, rs = mesh.n_frames_shards, mesh.n_ray_shards
    parts = parts.reshape((fs, rs) + tuple(local.shape))
    parts = parts.transpose(1, 2)               # (fs, F_l, rs, n_l, ...)
    f = fs * local.shape[0]
    flat = parts.reshape((f, rs * local.shape[1]) + tuple(local.shape[2:]))
    return flat[:, :n].reshape((f, height, width) + tuple(local.shape[2:]))


def _frame_outputs(mesh, images, classes, steps, n, height, width):
    return {"image": _assemble(mesh, torch.stack(images), n, height, width),
            "cls": _assemble(mesh, torch.stack(classes), n, height, width),
            "n_steps": _assemble(mesh, torch.stack(steps), n, height,
                                 width)}


def _classify_frame(fq, alpha0, beta, bg, *, rs, obs, boundary_radius,
                    patch, flip_theta, flip_phi, has_background):
    """classify_rays + composite for one frame's local rays."""
    cls, _, _, u01, v01 = _classify.classify_rays(
        fq, alpha0, beta, rs=rs, r_obs_x=obs,
        boundary_radius=boundary_radius, patch_center_theta=patch[0],
        patch_center_phi=patch[1], patch_size_theta=patch[2],
        patch_size_phi=patch[3], flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    return _classify.composite(cls, u01, v01, bg), cls


def _kerr_spherical(final_q, status):
    """(t, x, y, z) -> (t, rho, theta, phi), captured rays pinned to
    rho = 0 (the generic render's fold for the classifier)."""
    rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                         final_q[:, 3])
    rho = torch.where(status == STATUS_CAPTURED, torch.zeros_like(rho), rho)
    return torch.stack([final_q[:, 0], rho, th, ph], dim=-1)


def _setup(mesh, bg_array, per_frame, dtype, device, height, width):
    """Device, background, per-frame scalars and this rank's pixels."""
    device = rank_device(device)
    bg = torch.as_tensor(np.asarray(bg_array), dtype=torch.uint8,
                         device=device)
    per_frame = [torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                                 device=device).reshape(-1)
                 for v in per_frame]
    n = height * width
    flat_idx, _ = _local_ray_indices(n, mesh.n_ray_shards, mesh.ray_shard,
                                     device)
    i_f, j_f = _pixels(flat_idx, width, dtype)
    return device, bg, per_frame, n, i_f, j_f


def render_frames_sharded(mesh, bg_array, obs_x, fov, mass, boundary_radius,
                          steps, delta, omega, patch_center_theta,
                          patch_center_phi, patch_size_theta, patch_size_phi,
                          *, height, width, flip_theta=False, flip_phi=False,
                          has_background=True, dtype=torch.float32,
                          backend="auto", device="cuda"):
    """Render F Schwarzschild frames over the ('frames', 'rays') mesh: the
    folded camera, B1 (float32) or B2 (float64) through
    `integrate_dispatch`, one launch for this rank's frames.

    Per-frame arrays (shape (F,)): obs_x, patch_center_phi; scalars:
    everything else.  F must divide over the 'frames' axis.  Returns, on
    every rank, {image (F, H, W, 3) uint8, cls (F, H, W) int32, n_steps
    (F, H, W) int32}, each frame equal to `render_pixels` of it."""
    device, bg, (obs_x, phis), n, i_f, j_f = _setup(
        mesh, bg_array, (obs_x, patch_center_phi), dtype, device, height,
        width)

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    mass_t, fov_t = scalar(mass), scalar(fov)
    frames = _local_frames(mesh, obs_x.numel())
    rays = []
    for k in frames:
        zero = torch.zeros_like(obs_x[k])
        obs_pos = torch.stack([obs_x[k], zero, zero])
        pix = pixel_positions_fractional(obs_pos, fov_t, height, width, i_f,
                                         j_f, dtype=dtype)
        rays.append(initial_conditions(obs_pos, pix, mass_bh=mass_t))
    final_q, _, _, n_steps = integrate_dispatch(
        torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays]),
        steps, float(delta), 2.0 * float(mass), float(boundary_radius),
        float(omega), backend=backend, equatorial=True)
    patch = (scalar(patch_center_theta), None, scalar(patch_size_theta),
             scalar(patch_size_phi))
    images, classes, counts = [], [], []
    n_local = i_f.numel()
    for s, k in enumerate(frames):
        part = slice(s * n_local, (s + 1) * n_local)
        image, cls = _classify_frame(
            final_q[part], rays[s][2], rays[s][4], bg, rs=2.0 * mass_t,
            obs=obs_x[k], boundary_radius=scalar(boundary_radius),
            patch=(patch[0], phis[k]) + patch[2:], flip_theta=flip_theta,
            flip_phi=flip_phi, has_background=has_background)
        images.append(image)
        classes.append(cls)
        counts.append(n_steps[part])
    return _frame_outputs(mesh, images, classes, counts, n, height, width)


def render_kerr_sharded(mesh, bg_array, obs_x, fov, mass, spin,
                        boundary_radius, steps, delta, omega,
                        patch_center_theta, patch_center_phi,
                        patch_size_theta, patch_size_phi, *, height, width,
                        flip_theta=False, flip_phi=False,
                        has_background=True, dtype=torch.float32,
                        metric="KerrSchild", order=2, backend="auto",
                        charge=0.0, device="cuda"):
    """Kerr(-Newman) frames over the ('frames', 'rays') mesh, in the
    Cartesian Kerr-Schild chart end to end: the unfolded camera, B5
    through `integrate_dispatch_ks` (float32 rays: the 32-row compensated
    layout, the single-device production path's), the status-pinned
    classification.  Equatorial orbits about the spin axis keep the
    patch-rotation trick exact.  The rotating regular families (metric
    'RotatingBardeen' / 'RotatingHayward', the family parameter in
    `charge`) take the camera with their g_inv, G1r through
    `integrate_dispatch_generic` and the classifier's shell
    rotating_capture_radius / 1.2, as JAX's XLA route.  A metric of a
    spherical chart (Kerr-de Sitter's, Boyer-Lindquist's) raises
    ValueError, as JAX's assertion refuses it."""
    rotating = metric in MASS_FN
    if COORDS[metric] != "cartesian":
        raise ValueError(
            f"sharded Kerr-family frames use the Cartesian chart "
            f"(KerrSchild or a rotating regular family; got {metric!r})")
    device, bg, (obs_x, phis), n, i_f, j_f = _setup(
        mesh, bg_array, (obs_x, patch_center_phi), dtype, device, height,
        width)

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    if rotating:
        rs_classify = rotating_capture_radius(metric, params).to(
            dtype=dtype, device=device) / 1.2
    else:
        rs_classify = (1.05 / 1.2) * horizon_radius("Kerr", params[0],
                                                    params[1], params[2])
    fov_t = scalar(fov)
    frames = _local_frames(mesh, obs_x.numel())
    q0s, p0s = [], []
    for k in frames:
        zero = torch.zeros_like(obs_x[k])
        obs_pos = torch.stack([obs_x[k], zero, zero])
        pix = pixel_positions_fractional(obs_pos, fov_t, height, width, i_f,
                                         j_f, dtype=dtype)
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                              g_inv_fn=METRICS[metric])
        q0s.append(q0)
        p0s.append(p0)
    hole = (float(mass), float(spin), float(charge))
    if rotating:
        final_q, _, status, n_steps = integrate_dispatch_generic(
            torch.cat(q0s), torch.cat(p0s), steps, float(delta), hole,
            float(boundary_radius), float(omega), order=order,
            metric=metric, backend=backend)
    else:
        final_q, _, status, n_steps = integrate_dispatch_ks(
            torch.cat(q0s), torch.cat(p0s), steps, float(delta), hole,
            float(boundary_radius), float(omega), order=order,
            backend=backend)
    n_local = i_f.numel()
    alpha_off = torch.full((n_local,), math.pi, dtype=dtype, device=device)
    beta0 = torch.zeros((n_local,), dtype=dtype, device=device)
    images, classes, counts = [], [], []
    for s, k in enumerate(frames):
        part = slice(s * n_local, (s + 1) * n_local)
        image, cls = _classify_frame(
            _kerr_spherical(final_q[part], status[part]), alpha_off, beta0,
            bg, rs=rs_classify, obs=obs_x[k],
            boundary_radius=scalar(boundary_radius),
            patch=(scalar(patch_center_theta), phis[k],
                   scalar(patch_size_theta), scalar(patch_size_phi)),
            flip_theta=flip_theta, flip_phi=flip_phi,
            has_background=has_background)
        images.append(image)
        classes.append(cls)
        counts.append(n_steps[part])
    return _frame_outputs(mesh, images, classes, counts, n, height, width)


def render_disk_sharded(mesh, bg_array, obs_x, fov, mass, spin,
                        boundary_radius, steps, delta, omega, elevation,
                        r_in, r_out, t_peak, exposure, patch_center_theta,
                        patch_center_phi, patch_size_theta, patch_size_phi,
                        camera_omega=0.0, *, height, width, flip_theta=False,
                        flip_phi=False, has_background=True,
                        dtype=torch.float32, order=2, backend="auto",
                        charge=0.0, prograde=True, profile="shakura",
                        camera_moving=False, device="cuda"):
    """Accretion-disk frames over the ('frames', 'rays') mesh: the inclined
    look-at camera `elevation` radians above the plane (the boosted
    tetrad of the circular worldline at camera_omega when camera_moving),
    B6 through `integrate_dispatch_disk` (float32 rays: the 32-row
    compensated layout), the disk shaded by `shade_disk` (profile
    'shakura' or 'novikov') over the classified, composited background.
    Per-frame arrays: obs_x (camera distance), patch_center_phi."""
    device, bg, (obs_d, phis), n, i_f, j_f = _setup(
        mesh, bg_array, (obs_x, patch_center_phi), dtype, device, height,
        width)

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    rs_classify = (1.05 / 1.2) * horizon_radius("Kerr", params[0],
                                                params[1], params[2])
    elev, fov_t = scalar(elevation), scalar(fov)
    frames = _local_frames(mesh, obs_d.numel())
    q0s, p0s, cams = [], [], []
    for k in frames:
        obs_pos = torch.stack([obs_d[k] * torch.cos(elev),
                               torch.zeros_like(elev),
                               obs_d[k] * torch.sin(elev)])
        r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
        th_obs = torch.arccos(torch.clamp(
            obs_pos[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
        pix = pixel_positions_fractional_lookat(obs_pos, fov_t, height,
                                                width, i_f, j_f, dtype=dtype)
        if camera_moving:
            q0, p0, _ = boosted_ics_from_pixels(
                obs_pos, pix, params=params, g_inv_fn=kerr_schild_g_inv,
                omega_cam=scalar(camera_omega))
        else:
            q0, p0, _ = cartesian_ics_from_pixels(
                obs_pos, pix, params=params, g_inv_fn=kerr_schild_g_inv)
        q0s.append(q0)
        p0s.append(p0)
        cams.append((r_obs_bl, th_obs))
    final_q, _, status, n_steps, hit_q, hit_p = integrate_dispatch_disk(
        torch.cat(q0s), torch.cat(p0s), steps, float(delta),
        (float(mass), float(spin), float(charge)), float(boundary_radius),
        float(omega), float(r_in), float(r_out), order=order,
        backend=backend)
    n_local = i_f.numel()
    alpha_off = torch.full((n_local,), math.pi, dtype=dtype, device=device)
    beta0 = torch.zeros((n_local,), dtype=dtype, device=device)
    images, classes, counts = [], [], []
    for s, k in enumerate(frames):
        part = slice(s * n_local, (s + 1) * n_local)
        r_obs_bl, th_obs = cams[s]
        _, rgb01 = shade_disk(
            hit_q[part], hit_p[part], params, r_obs_bl, scalar(r_in),
            prograde=prograde, t_peak=scalar(t_peak),
            exposure=scalar(exposure), theta_obs=th_obs, profile=profile,
            r_out=scalar(r_out),
            omega_obs=scalar(camera_omega) if camera_moving else 0.0)
        image, cls = _classify_frame(
            _kerr_spherical(final_q[part], status[part]), alpha_off, beta0,
            bg, rs=rs_classify, obs=obs_d[k],
            boundary_radius=scalar(boundary_radius),
            patch=(scalar(patch_center_theta), phis[k],
                   scalar(patch_size_theta), scalar(patch_size_phi)),
            flip_theta=flip_theta, flip_phi=flip_phi,
            has_background=has_background)
        dm = status[part] == STATUS_DISK
        disk_u8 = torch.clamp(rgb01 * 255.0 + 0.5, 0.0, 255.0).to(
            torch.uint8)
        images.append(torch.where(dm[:, None], disk_u8, image))
        classes.append(torch.where(dm, CLS_DISK, cls))
        counts.append(n_steps[part])
    return _frame_outputs(mesh, images, classes, counts, n, height, width)


def orbit_frames(scene, n_frames):
    """Per-frame parameter arrays for an equatorial camera orbit: frame k
    rotates the camera by 2 pi k / F about +z, which by the symmetry is
    the background patch center rotating by -2 pi k / F."""
    phis = (scene.patch.center_phi
            - 2.0 * np.pi * np.arange(n_frames) / n_frames)
    obs = np.full(n_frames, scene.observer_distance)
    return obs, phis % (2 * np.pi)


def _dryrun_rank(rank, world, init_file, result_file):
    """One gloo rank of `dryrun_multichip`."""
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fs = 2 if world % 2 == 0 and world > 1 else 1
        mesh = make_mesh(fs, world // fs)
        f, size = 2 * fs, 16
        bg = np.zeros((8, 8, 3), np.uint8)
        obs_x = np.full(f, 30.0)
        patch_phi = np.pi + np.linspace(0, 1, f)
        out = render_frames_sharded(
            mesh, bg, obs_x, math.radians(80.0), 1.0, 31.0, 64, 0.1, 1.0,
            math.pi / 2, patch_phi, math.pi, 2 * math.pi, height=size,
            width=size, device="cpu")
        assert out["image"].shape == (f, size, size, 3)
        assert out["cls"].shape == (f, size, size)
        out_k = render_kerr_sharded(
            mesh, bg, obs_x, math.radians(80.0), 1.0, 0.9, 31.0, 64, 0.05,
            1.0, math.pi / 2, patch_phi, math.pi, 2 * math.pi, height=size,
            width=size, charge=0.3, device="cpu")
        assert out_k["image"].shape == (f, size, size, 3)
        if rank == 0:
            torch.save({"image": out["image"], "cls": out["cls"],
                        "kerr_cls": out_k["cls"]}, result_file)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, workdir=None) -> dict:
    """The multi-frame renders over an n-rank mesh on tiny shapes: spawns
    n gloo ranks on the CPU (torch.multiprocessing, a file:// store in
    `workdir`, by default a new temporary directory), lays a frames x rays
    mesh over them (2 x n/2 where n is even, else 1 x n) and runs
    `render_frames_sharded` and `render_kerr_sharded` on 16^2 frames.
    Returns rank 0's {image, cls, kerr_cls}."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_file = os.path.join(tmp, "store")
        result_file = os.path.join(tmp, "result.pt")
        mp.spawn(_dryrun_rank, args=(int(n_devices), init_file, result_file),
                 nprocs=int(n_devices), join=True)
        return torch.load(result_file)
