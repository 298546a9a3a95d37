"""Semi-analytic renders: images without integration — the torch
counterpart of `grtrace.engine.render_exact`.

Each ray's equatorial crossings come from the separated-Hamiltonian
quadrature (physics/geodesic_exact.py) and are shaded with the traced disk
pipeline's Killing-constant shading (disk.shade_disk_constants); the
lensed background sky comes from the exact boundary-sphere escape records
through the ordinary classifier, so the shadow boundary is analytic and
'in_domain' and 'numerical error' cannot occur.  The static families'
background (`render_pixels_background_exact_static`) takes capture as b
<= b_critical and the exit azimuth from the planar quadrature
(physics/static_exact.py).

    render_pixels_exact                     the flat disk render
    render_disk_exact                       its scene-level wrapper
    render_pixels_background_exact          the Kerr-Newman lensed sky
    render_pixels_background_exact_static   the static families' lensed sky

No kernel: the solvers are fixed-count bisections and quadratures, run as
batched float64 torch on the caller's device (`device`, 'cuda' by
default; 'cpu' for the CPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from ..physics.camera import (camera_rays_cartesian,
                              camera_rays_folded_static,
                              cartesian_ics_from_pixels, pixel_grid_lookat)
from ..physics.geodesic_exact import crossing_table, escape_state
from ..physics.spacetime import METRICS, horizon_radius, ks_radius
from . import classify as _classify
from .disk import DiskConfig, disk_observer_position, shade_disk_constants
from .hotspot import bl_time_azimuth_offsets

F64 = torch.float64


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the exact renders default to device='cuda', "
                           "which needs a CUDA GPU; pass device='cpu'")
    return device


def render_pixels_exact(obs_pos, fov, mass, spin, charge, height, width,
                        r_in, r_out, *, n_orders=3, prograde=True,
                        t_peak=9000.0, exposure=2.5, profile="shakura",
                        device="cuda"):
    """Flat (H*W,) semi-analytic disk render on the look-at camera at
    obs_pos: a dict of image (H*W, 3) in [0, 1], g, r_em, order (-1 = no
    disk), disk_mask, and the per-order r_k / valid_k table, lam, eta."""
    device = _device(device)
    params = torch.tensor([mass, spin, charge], dtype=F64, device=device)
    obs = torch.as_tensor(np.asarray(obs_pos, np.float64), dtype=F64,
                          device=device)
    pix = pixel_grid_lookat(obs, torch.tensor(float(fov), dtype=F64,
                                              device=device),
                            height, width, dtype=F64, device=device)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix.reshape(-1, 3),
                                          params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    tab = crossing_table(q0, p0, params, n_orders=n_orders)
    r_k = tab["r"]
    in_disk = tab["valid"] & (r_k >= r_in) & (r_k <= r_out)
    any_hit = in_disk.any(dim=1)
    order = torch.argmax(in_disk.to(torch.int8), dim=1)
    order = torch.where(any_hit, order, -1)
    r_em = torch.gather(r_k, 1, torch.clamp(order, min=0)[:, None])[:, 0]
    r_obs_bl = ks_radius(obs[0], obs[1], obs[2], params[1])
    theta_obs = torch.arccos(torch.clamp(
        obs[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
    g, rgb = shade_disk_constants(
        torch.ones_like(r_em), tab["lam"], r_em, params, r_obs_bl,
        torch.tensor(float(r_in), dtype=F64, device=device),
        prograde=prograde, t_peak=t_peak, exposure=exposure,
        theta_obs=theta_obs, profile=profile, r_out=r_out)
    g = torch.where(any_hit, g, 0.0)
    r_em = torch.where(any_hit, r_em, 0.0)
    image = torch.where(any_hit[:, None], rgb, 0.0)
    return {"image": image, "g": g, "r_em": r_em, "order": order,
            "disk_mask": any_hit, "r_k": r_k, "valid_k": in_disk,
            "lam": tab["lam"], "eta": tab["eta"]}


def _classify_tail(final_q, alpha_off, beta, rs, obs_x, boundary_radius,
                   patch, flip_theta, flip_phi, has_background, bg_array):
    def scalar(x):
        return torch.tensor(float(x), dtype=F64, device=final_q.device)
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        final_q, alpha_off, beta, rs=rs, r_obs_x=scalar(obs_x),
        boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch[0]),
        patch_center_phi=scalar(patch[1]),
        patch_size_theta=scalar(patch[2]), patch_size_phi=scalar(patch[3]),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    image = _classify.composite(cls, u01, v01, bg_array)
    return cls, th_csv, ph_csv, image


def render_pixels_background_exact(bg_array, obs_x, fov, mass, spin,
                                   boundary_radius,
                                   patch_center_theta, patch_center_phi,
                                   patch_size_theta, patch_size_phi,
                                   *, height, width, flip_theta=False,
                                   flip_phi=False, has_background=True,
                                   charge=0.0):
    """The Kerr-Newman lensed sky with no integration, on bg_array's
    device: render_pixels_generic's Kerr-Schild camera and classifier, the
    escape positions from escape_state (the Boyer-Lindquist exit radius
    solved in two passes so the flat-embedding radius is the boundary
    sphere).  Returns image, cls, final_q, final_th, final_ph, q0, p0,
    alpha0, status (1 captured, 2 escaped) and the (5,) count vector."""
    device = bg_array.device
    params = torch.tensor([mass, spin, charge], dtype=F64, device=device)
    obs_pos = torch.tensor([obs_x, 0.0, 0.0], dtype=F64, device=device)
    q0, p0, alpha0 = camera_rays_cartesian(
        obs_pos, torch.tensor(float(fov), dtype=F64, device=device), height,
        width, params=params, g_inv_fn=METRICS["KerrSchild"], dtype=F64,
        device=device)
    n = height * width
    q0f, p0f = q0.reshape(n, 4), p0.reshape(n, 4)
    rho = float(boundary_radius)
    rb0 = math.sqrt(max(rho * rho - spin * spin, 1.0))
    es = escape_state(q0f, p0f, params, rb0)
    sin2 = torch.sin(es["theta"]) ** 2
    rb1 = torch.sqrt(rho * rho - params[1] ** 2 * sin2)
    es = escape_state(q0f, p0f, params, rb1)

    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    phi_ks = (es["e_sign"] * es["phi"]
              + bl_time_azimuth_offsets(rb1, params)[1]
              - bl_time_azimuth_offsets(r_obs_bl, params)[1]
              + torch.atan2(params[1], rb1)
              - torch.atan2(params[1], r_obs_bl))
    th_e = torch.arccos(torch.clamp(rb1 * torch.cos(es["theta"]) / rho,
                                    -1.0, 1.0))
    escaped = es["escaped"]
    zero = torch.zeros_like(rb1)
    final_q = torch.stack([zero, torch.where(escaped, zero + rho, zero),
                           torch.where(escaped, th_e, 0.0),
                           torch.where(escaped, phi_ks, 0.0)],
                          dim=-1).reshape(height, width, 4)
    r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    cls, th_csv, ph_csv, image = _classify_tail(
        final_q, torch.full((height, width), math.pi, dtype=F64,
                            device=device),
        torch.zeros((height, width), dtype=F64, device=device),
        (1.05 / 1.2) * r_plus, obs_x, boundary_radius,
        (patch_center_theta, patch_center_phi, patch_size_theta,
         patch_size_phi), flip_theta, flip_phi, has_background, bg_array)
    status = torch.where(escaped, 2, 1).reshape(height, width)
    return {"image": image, "cls": cls, "final_q": final_q,
            "final_th": th_csv, "final_ph": ph_csv, "q0": q0, "p0": p0,
            "alpha0": alpha0, "status": status,
            "count_vec": _classify.count_vector(cls)}


def render_disk_exact(scene, disk: DiskConfig = None, *, n_orders=3,
                      device="cuda"):
    """render_disk's geometry (disk_observer_position and the look-at
    grid, the annulus from the explicit r_in or the ISCO, the same
    shading knobs) with the exact crossings: render_pixels_exact's dict
    plus image_u8 (H, W, 3) and shape."""
    disk = disk or DiskConfig()
    r_in = disk.inner_edge(scene.bh_mass, float(scene.spin),
                           float(scene.charge))
    obs = disk_observer_position(scene, disk)
    out = render_pixels_exact(
        obs, scene.fov, scene.bh_mass, float(scene.spin),
        float(scene.charge), scene.size, scene.size, r_in, disk.r_out,
        n_orders=n_orders, prograde=disk.prograde, t_peak=disk.t_peak,
        exposure=disk.exposure, profile=disk.profile, device=device)
    hw = (scene.size, scene.size)
    img = out["image"].reshape(hw + (3,)).cpu().numpy()
    out["image_u8"] = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    out["shape"] = hw
    return out


def render_pixels_background_exact_static(bg_array, obs_x, fov, mass,
                                          metric_param, boundary_radius,
                                          patch_center_theta,
                                          patch_center_phi,
                                          patch_size_theta,
                                          patch_size_phi,
                                          *, height, width,
                                          flip_theta=False,
                                          flip_phi=False,
                                          has_background=True,
                                          metric="Bardeen"):
    """The static families' lensed sky with no integration, on bg_array's
    device: the folded camera, capture where |b| <= b_critical, the exit
    azimuth 2 phi_periapsis + the leg from r_obs out to the boundary
    sphere (physics/static_exact.py), render_pixels_generic's static
    classifier.  Returns render_pixels_background_exact's dict with the
    fold angles beta."""
    from ..physics.static_exact import _phi_leg, turning_point_static
    from ..physics.static_metrics import STATIC_F, b_critical
    from .render_generic import classify_radius

    device = bg_array.device
    f_fn = STATIC_F[metric]
    params = torch.tensor([mass, metric_param, 0.0], dtype=F64,
                          device=device)
    obs_pos = torch.tensor([obs_x, 0.0, 0.0], dtype=F64, device=device)
    q0, p0, alpha0, beta = camera_rays_folded_static(
        obs_pos, torch.tensor(float(fov), dtype=F64, device=device), height,
        width, params=params, g_inv_fn=METRICS[metric], dtype=F64,
        device=device)
    n = height * width
    p0f = p0.reshape(n, 4)
    b = torch.abs(p0f[:, 3] / p0f[:, 0])
    b_c = b_critical(f_fn, params.cpu()).to(device)
    escaped = b > b_c
    u_obs = 1.0 / float(obs_x)
    u_bnd = 1.0 / float(boundary_radius)
    b_safe = torch.where(escaped, b, 2.0 * b_c)

    def exit_sweep(bi):
        u_t = turning_point_static(bi, f_fn, params, u_obs, 1.0)
        phi_t = _phi_leg(u_obs, u_t, u_t, bi, f_fn, params)
        leg_out = _phi_leg(u_bnd, u_obs, u_t, bi, f_fn, params)
        return 2.0 * phi_t + leg_out

    sweep = torch.cat([vmap(exit_sweep)(b_safe[i:i + 4096])
                       for i in range(0, n, 4096)])
    phi_exit = torch.sign(p0f[:, 3]) * sweep
    rho = float(boundary_radius)
    final_q = torch.stack([
        torch.zeros_like(phi_exit),
        torch.where(escaped, torch.full_like(phi_exit, rho), 0.0),
        torch.full_like(phi_exit, 0.5 * math.pi),
        torch.where(escaped, phi_exit, 0.0)], dim=-1).reshape(height, width,
                                                             4)
    cls, th_csv, ph_csv, image = _classify_tail(
        final_q, torch.full((height, width), math.pi, dtype=F64,
                            device=device), beta,
        classify_radius(metric, params), obs_x, boundary_radius,
        (patch_center_theta, patch_center_phi, patch_size_theta,
         patch_size_phi), flip_theta, flip_phi, has_background, bg_array)
    status = torch.where(escaped, 2, 1).reshape(height, width)
    return {"image": image, "cls": cls, "final_q": final_q,
            "final_th": th_csv, "final_ph": ph_csv, "q0": q0, "p0": p0,
            "alpha0": alpha0, "beta": beta, "status": status,
            "count_vec": _classify.count_vector(cls)}
