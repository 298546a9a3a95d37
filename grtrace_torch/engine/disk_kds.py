"""Thin accretion disks around Kerr-de Sitter black holes — the torch
counterpart of `grtrace.engine.disk_kds`.

The disk plane is theta = pi/2 of the Carter chart, so the crossing test is
a sign change of cos(theta) between the pre- and post-step q1, with q1 and
the momentum copy p2 lerped at t = c0 / (c0 - c1); the first crossing
inside [r_in, r_out] on a step the guard did not park freezes the ray with
STATUS_DISK.  The loop is the Carter chart's G1d loop (the spherical guard
and the signed step count) and the exact Kerr-de Sitter rescue settles the
parked rays that never hit.  Shading reads E = -p_t and L_z = p_phi at the
crossing (Killing charges), the emitter on the Kerr-de Sitter Keplerian
circle and the receiver the static observer at the camera's position.

    integrate_batch_disk_kds    the eager twin of kernel D3
                                (csrc/fantasy_gen.cu, Mode::kDisk of
                                Chart::kKdS), the loop D3 shares with D2
                                (integrate_generic.integrate_disk_spin_twin),
                                then the rescue
    integrate_dispatch_disk_kds CUDA rays to D3, CPU rays to the twin
    render_disk_kds             the SceneConfig-driven frame

The disk must lie inside the cosmological tide's outermost stable circular
orbit (`kds_disk_bounds`).  A ray that never hits keeps zeros in its hit
rows, as kernels B6, D1 and D2 do; JAX's while_loop leaves the camera's
(q0, p0) there.  Every read of the hit rows is masked by the hit.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..physics.camera import pixel_grid_lookat, unfolded_ics_from_pixels
from ..physics.kerr_de_sitter import (circular_u_t_kds, isco_kds,
                                      kds_functions, osco_kds)
from ..physics.spacetime import METRICS
from . import classify as _classify
from .disk import CLS_DISK, _temp_profile, blackbody_rgb
from .integrate_generic import (disk_spin_params, finish_disk_spin,
                                gen_params, integrate_disk_spin_twin)
from .integrate_ks import STATUS_DISK


def integrate_batch_disk_kds(q0s, p0s, steps, delta, params, r_max, omega,
                             r_in, r_out, order=2):
    """JAX's integrate_batch_disk_kds on the CPU: the eager twin of kernel
    D3, then the rescue.  params = (M, a, Lambda).  Returns (final_q,
    final_p, status, n_steps, hit_q, hit_p)."""
    vec = disk_spin_params(
        gen_params("KerrDS", delta, params, r_max, omega, order, q0s.dtype),
        r_in, r_out)
    out = integrate_disk_spin_twin(q0s, p0s, steps, vec, "KerrDS")
    return finish_disk_spin(*out, q0s, p0s, vec, "KerrDS", params)


def integrate_dispatch_disk_kds(q0s, p0s, steps, delta, params, r_max, omega,
                                r_in, r_out, order=2):
    """Kerr-de Sitter's disk integration on the rays' device: CUDA rays go
    to kernel D3, CPU rays to its twin (`integrate_batch_disk_kds`); any
    other device raises.  Never falls back."""
    kind = q0s.device.type
    if kind == "cpu":
        return integrate_batch_disk_kds(q0s, p0s, steps, delta, params,
                                        r_max, omega, r_in, r_out,
                                        order=order)
    if kind != "cuda":
        raise ValueError(f"no disk integrator for {kind!r} tensors (CUDA "
                         f"runs kernel D3, the CPU its eager twin)")
    from .integrate_generic_cuda import integrate_batch_disk_spin_cuda
    return integrate_batch_disk_spin_cuda(q0s, p0s, steps, delta, params,
                                          r_max, omega, r_in, r_out,
                                          order=order, metric="KerrDS")


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def kds_static_u_t(r, th, params):
    """u^t of the static observer at (r, theta): 1 / sqrt(-g_tt), g_tt =
    (-Delta_r + Delta_th a^2 sin^2 th) / (chi^2 Sigma)."""
    a = params[1]
    delta_r, delta_th, chi, sigma = kds_functions(r, th, params)
    sin2 = torch.sin(th) ** 2
    g_tt = (-delta_r + delta_th * a * a * sin2) / (chi * chi * sigma)
    return 1.0 / torch.sqrt(-g_tt)


def redshift_factor_kds(energy, l_z, r_em, r_obs, params, prograde=True,
                        theta_obs=math.pi / 2):
    """g = nu_obs / nu_em (elementwise): the Kerr-de Sitter Keplerian
    emitter at r_em, the static observer at (r_obs, theta_obs)."""
    u_t_em, omega = circular_u_t_kds(r_em, params, prograde)
    theta_obs = torch.as_tensor(theta_obs, dtype=r_em.dtype,
                                device=r_em.device)
    u_t_obs = kds_static_u_t(r_obs, theta_obs, params)
    return (energy * u_t_obs) / (u_t_em * (energy - omega * l_z))


def shade_disk_kds(hit_q, hit_p, params, r_obs, th_obs, r_in, *,
                   prograde=True, t_peak=9000.0, exposure=2.5):
    """(N, 4) crossings -> (g, rgb01): the Shakura-Sunyaev profile, I_obs =
    g^4 I_em, the blackbody colour at g T_em(r), tone-mapped; E = -p_t and
    L_z = p_phi at the crossing, r_em its r."""
    energy = -hit_p[:, 0]
    l_z = hit_p[:, 3]
    r_em = hit_q[:, 1]
    g = redshift_factor_kds(energy, l_z, r_em, r_obs, params, prograde,
                            th_obs)
    t_obs = g * _temp_profile(r_em, r_in)
    intensity = exposure * t_obs ** 4
    tone = (1.0 - torch.exp(-intensity)) ** (1.0 / 2.2)
    rgb = blackbody_rgb(t_obs * t_peak) * tone[:, None]
    return g, rgb


# ---------------------------------------------------------------------------
# Full-frame render
# ---------------------------------------------------------------------------

def render_pixels_disk_kds(bg_array, obs_pos, fov, mass, spin, lam,
                           boundary_radius, steps, delta, omega, r_in, r_out,
                           t_peak, exposure, patch_center_theta,
                           patch_center_phi, patch_size_theta, patch_size_phi,
                           *, height, width, order=2, flip_theta=False,
                           flip_phi=False, has_background=True,
                           dtype=torch.float32, prograde=True):
    """One frame on bg_array's device: the inclined look-at camera through
    the unfolded spherical chart -> D3 (its twin on the CPU) -> shade +
    classify -> RGB.  Scalars are Python floats (obs_pos a sequence),
    rounded to `dtype` on the device as JAX receives them.  Returns JAX's
    dict of per-pixel tensors and the (6,) count vector."""
    from .render_generic import classify_radius
    device = bg_array.device

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(lam)])
    obs = torch.tensor(np.asarray(obs_pos, np.float64), dtype=dtype,
                       device=device)
    r_obs = torch.linalg.vector_norm(obs)
    th_obs = torch.arccos(torch.clamp(
        obs[2] / torch.clamp(r_obs, min=1e-30), -1.0, 1.0))
    pix = pixel_grid_lookat(obs, scalar(fov), height, width, dtype=dtype,
                            device=device)
    q0, p0, alpha0 = unfolded_ics_from_pixels(obs, pix, params=params,
                                              g_inv_fn=METRICS["KerrDS"])
    n = height * width
    final_q, _, status, n_steps, hit_q, hit_p = integrate_dispatch_disk_kds(
        q0.reshape(n, 4).contiguous(), p0.reshape(n, 4).contiguous(), steps,
        float(delta), (float(mass), float(spin), float(lam)),
        float(boundary_radius), float(omega), float(r_in), float(r_out),
        order=order)

    disk_mask = status == STATUS_DISK
    g_fac, disk_rgb01 = shade_disk_kds(
        hit_q, hit_p, params, r_obs, th_obs, scalar(r_in), prograde=prograde,
        t_peak=t_peak, exposure=exposure)
    g_fac = torch.where(disk_mask, g_fac, 0.0)

    rs_classify = classify_radius("KerrDS", params)
    fq = final_q.reshape(height, width, 4)
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        fq, torch.full((height, width), math.pi, dtype=dtype, device=device),
        torch.zeros((height, width), dtype=dtype, device=device),
        rs=rs_classify, r_obs_x=obs[0],
        boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch_center_theta),
        patch_center_phi=scalar(patch_center_phi),
        patch_size_theta=scalar(patch_size_theta),
        patch_size_phi=scalar(patch_size_phi),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    image = _classify.composite(cls, u01, v01, bg_array)

    disk_u8 = torch.clamp(disk_rgb01 * 255.0 + 0.5, 0.0, 255.0).to(
        torch.uint8).reshape(height, width, 3)
    dm2 = disk_mask.reshape(height, width)
    image = torch.where(dm2[:, :, None], disk_u8, image)
    cls = torch.where(dm2, CLS_DISK, cls)
    count_vec = torch.cat([_classify.count_vector(cls),
                           (cls == CLS_DISK).sum()[None]])
    return {
        "image": image, "cls": cls, "final_q": fq, "final_th": th_csv,
        "final_ph": ph_csv, "q0": q0, "p0": p0, "alpha0": alpha0,
        "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "hit_q": hit_q.reshape(height, width, 4),
        "hit_p": hit_p.reshape(height, width, 4),
        "redshift": g_fac.reshape(height, width), "count_vec": count_vec,
    }


@functools.lru_cache(maxsize=64)
def kds_disk_bounds(mass, spin, lam, r_in, r_out, boundary_radius,
                    prograde=True):
    """Host-side disk edges, JAX's checks in float64: r_in = None -> the
    ISCO (ValueError where there is none); with Lambda > 0 r_out must lie
    inside the outermost stable circular orbit; r_in < r_out <
    boundary_radius.  Returns (r_in, r_out) as floats; memoized (the scans
    and bisections cost host time that every render of a scene would
    repeat)."""
    params = torch.tensor([mass, spin, lam], dtype=torch.float64)
    if r_in is None:
        r_in = float(isco_kds(params, prograde))
        if not np.isfinite(r_in):
            raise ValueError(
                f"kerr-ds at (a, Lambda) = ({spin:g}, {lam:g}) has no "
                "stable circular orbits — no ISCO to anchor the disk")
    if lam > 0.0:
        r_osco = float(osco_kds(params, prograde))
        if np.isfinite(r_osco) and r_out > r_osco:
            raise ValueError(
                f"kerr-ds disk outer edge r_out = {r_out:g} lies beyond "
                f"the outermost stable circular orbit {r_osco:.4g} "
                "(the cosmological tide forbids Keplerian emitters "
                "there) — shrink r_out or Lambda")
    if not r_in < r_out:
        raise ValueError(f"disk edges must satisfy r_in < r_out, got "
                         f"[{r_in:g}, {r_out:g}]")
    if r_out >= boundary_radius:
        raise ValueError(f"disk outer edge {r_out:g} must sit inside the "
                         f"boundary sphere {boundary_radius:g}")
    return float(r_in), float(r_out)


def render_disk_kds(scene, disk=None, *, bg_array=None, dtype=None,
                    metrics=None, device="cuda"):
    """SceneConfig-driven Kerr-de Sitter disk frame -> RenderResult, JAX's
    render_disk_kds: scene.metric 'kerr-ds', scene.spin, scene.metric_param
    = Lambda; `disk` the DiskConfig of engine/disk.py (bfield,
    camera_omega and the Novikov-Thorne profile raise, as in JAX).  The
    counts carry 'disk'; result.device('redshift') is g on disk pixels.
    device defaults to 'cuda' (kernel D3) and raises without a GPU; pass
    device='cpu' for the eager twin."""
    from .disk import DiskConfig, disk_observer_position
    from .render import RenderResult, _untimed

    disk = disk or DiskConfig()
    if disk.bfield is not None:
        raise NotImplementedError(
            "polarized imaging rides the Kerr-Newman disk path")
    if disk.camera_omega is not None:
        raise NotImplementedError(
            "orbiting cameras ride the Kerr-Newman disk path")
    if disk.profile == "novikov":
        raise NotImplementedError(
            "the Novikov-Thorne profile is wired for the Kerr-Newman "
            "and static families; kerr-ds disks use Shakura-Sunyaev")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_disk_kds(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu' for the eager twin")
    stage = metrics.stage if metrics is not None else _untimed
    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = torch.float64 if integ.dtype == "float64" else torch.float32
    has_bg = bg_array is not None and disk.show_background
    with stage("texture_upload"):
        bg_dev = (torch.as_tensor(np.asarray(bg_array), dtype=torch.uint8,
                                  device=device) if has_bg
                  else torch.zeros((1, 1, 3), dtype=torch.uint8,
                                   device=device))
    r_in, r_out = kds_disk_bounds(
        scene.bh_mass, scene.spin, scene.metric_param, disk.r_in, disk.r_out,
        scene.boundary_radius, disk.prograde)
    obs_pos = disk_observer_position(scene, disk)
    with stage("device_pipeline"):
        out = render_pixels_disk_kds(
            bg_dev, obs_pos, scene.fov, scene.bh_mass, scene.spin,
            scene.metric_param, scene.boundary_radius, integ.steps,
            integ.delta, float(integ.omega), r_in, r_out, disk.t_peak,
            disk.exposure, scene.patch.center_theta, scene.patch.center_phi,
            scene.patch.size_theta, scene.patch.size_phi,
            height=h, width=w, order=integ.order,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi, has_background=has_bg,
            dtype=dtype, prograde=disk.prograde)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4], "disk": cv[5]}
    if metrics is not None:
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())
    out["beta"] = torch.zeros((h, w), dtype=dtype, device=device)
    out["heading"] = torch.zeros((h, w, 3), dtype=dtype, device=device)
    return RenderResult(out, counts)
