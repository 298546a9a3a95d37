"""Thin accretion-disk rendering — the torch counterpart of
`grtrace.engine.disk` for the Kerr-Newman family and the rotating regular
families in the Kerr-Schild chart.

An optically thick, geometrically thin equatorial disk between r_in (by
default the prograde ISCO) and r_out, shaded by the exact gravitational +
Doppler shift of circular Keplerian emitters (physics/orbits.py) and a
Shakura-Sunyaev or Novikov-Thorne temperature profile.  Back-traced rays
hit the disk at their first equatorial crossing inside the annulus, which
is the surface an opaque disk shows the camera.

The pipeline: the inclined look-at camera, static or on a circular
worldline (`camera_omega`: physics/camera.boosted_ics_from_pixels) -> the
disk integration (`integrate_dispatch_disk`: kernel B6 on a CUDA device,
its eager twins on the CPU) -> classification of the rays that missed the
disk -> the one shading function `run_shading` on the traced invariants
(hit_q, hit_p, status and the base image), with the Walker-Penrose
polarization maps when `bfield` is set.  io/transfer.reshade calls the
same `run_shading`, so a reshade on the render's device and dtype
reproduces the render's bytes.  `save_disk_maps` writes the science
products (redshift map, line profile, polarization map).

Rays that never hit carry zero hit rows, as the TPU kernel writes them
(JAX's XLA disk engine carries the launch state there instead), so the
redshift map is only meaningful on disk pixels.  `aa_samples` refines the
display image's boundary pixels (engine/aa.py).  A charged hole's inner
edge is the autodiff ISCO of physics/epicyclic.py.

The rotating regular families (scene.metric 'rotating-bardeen' /
'rotating-hayward', the family parameter scene.metric_param in the charge
slot) share the pipeline: their camera takes the family's g_inv, the
integration runs kernel D2 (`integrate_generic.
integrate_dispatch_disk_rotating`; its eager twin on the CPU), the
classifier's shell is the family's 1.05 capture shell, and the inner edge,
the redshift and the Novikov-Thorne table come from
physics/rotating_orbits.py.  As in JAX, they take no `bfield`, no
`camera_omega` and no `aa_samples`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from ..physics.camera import (_lookat_frame, boosted_ics_from_pixels,
                              cartesian_ics_from_pixels, pixel_grid_lookat)
from ..physics.coords import cartesian_to_spherical
from ..physics.orbits import (_invert_bl_metric, isco_radius, keplerian_omega,
                              page_thorne_flux, redshift_factor, zamo_omega)
from ..physics.polarization import (bl_from_ks, emission_polarization,
                                    observer_evpa)
from ..physics.rotating_orbits import (page_thorne_flux_rotating,
                                       redshift_factor_rotating,
                                       rotating_disk_inner_edge)
from ..physics.rotating_regular import MASS_FN, rotating_capture_radius
from ..physics.spacetime import (METRICS, horizon_radius, kerr_g_inv,
                                 kerr_schild_g_inv, ks_radius)
from . import classify as _classify
from .integrate import STATUS_CAPTURED
from .integrate_generic import integrate_dispatch_disk_rotating
from .integrate_ks import STATUS_DISK, _unit_grid, integrate_dispatch_disk

CLS_DISK = 5             # extends classify.CLS_* (0..4)


@dataclasses.dataclass
class DiskConfig:
    """Thin-disk geometry and shading knobs (geometrized units); the fields
    of `grtrace.engine.disk.DiskConfig`."""
    r_in: Optional[float] = None   # inner edge; None -> prograde ISCO
    r_out: float = 14.0            # outer edge
    prograde: bool = True          # disk co-rotates with the hole
    t_peak: float = 9000.0         # color temperature (K) at the profile peak
    exposure: float = 2.5          # tone-mapping gain
    show_background: bool = True   # compose lensed sky behind the disk
    # 'shakura' (Newtonian Shakura-Sunyaev) or 'novikov' (relativistic
    # Novikov-Thorne via the Page-Thorne integral)
    profile: str = "shakura"
    emissivity_index: float = 3.0  # line-profile index q (I_em ~ r^-q)
    # magnetic-field geometry of the Walker-Penrose EVPA maps: None
    # (unpolarized), 'vertical', 'toroidal' or 'radial'
    bfield: Optional[str] = None
    elevation_deg: float = 12.0    # camera elevation above the disk plane
    # camera worldline: None = static; a float = the circular worldline
    # u^t (d_t + omega d_phi); 'keplerian' = the circular-geodesic rate at
    # the camera's BL radius; 'zamo' = the zero-angular-momentum observer
    camera_omega: "float | str | None" = None

    def __post_init__(self):
        if self.profile not in ("shakura", "novikov"):
            raise ValueError(
                f"DiskConfig.profile must be 'shakura' or 'novikov', "
                f"got {self.profile!r}")
        if self.bfield not in (None, "vertical", "toroidal", "radial"):
            raise ValueError(
                f"DiskConfig.bfield must be None, 'vertical', 'toroidal' "
                f"or 'radial', got {self.bfield!r}")
        if isinstance(self.camera_omega, str) and \
                self.camera_omega not in ("keplerian", "zamo"):
            raise ValueError(
                f"DiskConfig.camera_omega must be None, a float, "
                f"'keplerian' or 'zamo', got {self.camera_omega!r}")

    def inner_edge(self, mass, a, charge=0.0):
        """Inner disk edge: the explicit r_in, else the prograde or
        retrograde ISCO, computed in float64: the BPT closed form for Kerr,
        the exact autodiff root of kappa^2 (physics/epicyclic.py) once
        charge makes the closed form an approximation."""
        if self.r_in is not None:
            return self.r_in
        if charge:
            from ..physics.epicyclic import isco_from_kappa
            return float(isco_from_kappa([mass, a, charge], self.prograde))
        return float(isco_radius(mass, a, self.prograde))


def from_jax_disk(disk) -> DiskConfig:
    """Convert a `grtrace.engine.disk.DiskConfig` (duck-typed: any object
    with the same attributes) into the port's DiskConfig."""
    return DiskConfig(**{f.name: getattr(disk, f.name)
                         for f in dataclasses.fields(DiskConfig)})


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def blackbody_rgb(kelvin):
    """Planckian-locus RGB in [0, 1] (Tanner Helland's piecewise fit,
    ~1000-40000 K), elementwise; (..., 3)."""
    t = torch.clamp(kelvin, 1000.0, 40000.0) / 100.0
    r = torch.where(t <= 66.0, 255.0, 329.698727446
                    * torch.clamp(t - 60.0, min=1e-6) ** -0.1332047592)
    g = torch.where(t <= 66.0,
                    99.4708025861 * torch.log(t) - 161.1195681661,
                    288.1221695283
                    * torch.clamp(t - 60.0, min=1e-6) ** -0.0755148492)
    b = torch.where(t >= 66.0, 255.0,
                    torch.where(t <= 19.0, 0.0,
                                138.5177312231 * torch.log(
                                    torch.clamp(t - 10.0, min=1e-6))
                                - 305.0447927307))
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb, 0.0, 255.0) / 255.0


def _temp_profile(r, r_in):
    """Shakura-Sunyaev local effective temperature, normalized to its
    peak: T(r) ~ [r^-3 (1 - sqrt(r_in/r))]^(1/4), peaking at 49/36 r_in and
    zero at the inner edge."""
    r = torch.maximum(r, r_in * (1.0 + 1e-6))
    flux = (1.0 - torch.sqrt(r_in / r)) / (r * r * r)
    r_pk = (49.0 / 36.0) * r_in
    flux_pk = (1.0 - torch.sqrt(r_in / r_pk)) / (r_pk * r_pk * r_pk)
    return (torch.clamp(flux, min=0.0) / flux_pk) ** 0.25


_NT_TABLE_N = 384      # radial quadrature/interp grid for the NT profile


def _nt_temp_table(r_in, r_out, params, prograde, dtype,
                   metric="KerrSchild"):
    """Peak-normalized Novikov-Thorne temperature T(r) ~ F(r)^(1/4) on a
    geometric radial grid over the annulus, from the Page-Thorne quadrature
    (physics.orbits.page_thorne_flux, or page_thorne_flux_rotating for a
    rotating regular family).  r_in, r_out: 0-dim tensors."""
    lo = r_in * (1.0 + 1e-5)
    u = _unit_grid(_NT_TABLE_N, dtype, lo.device)  # jnp.linspace's points
    r_grid = lo * (r_out / lo) ** u
    if metric == "KerrSchild":
        flux = page_thorne_flux(r_grid, params, prograde)
    else:
        flux = page_thorne_flux_rotating(r_grid, params, MASS_FN[metric],
                                         prograde)
    t = flux ** 0.25
    return r_grid, t / torch.clamp(torch.max(t), min=1e-30)


def _interp(x, xp, fp):
    """Piecewise-linear interpolation with jnp.interp's arithmetic (torch
    has none): constant beyond the ends, xp increasing."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.dtype(str(xp.dtype)[6:])).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def shade_disk(hit_q, hit_p, params, r_obs, r_in, *, prograde=True,
               t_peak=9000.0, exposure=2.5, theta_obs=math.pi / 2,
               profile="shakura", r_out=14.0, omega_obs=0.0,
               metric="KerrSchild"):
    """(N, 4) crossings -> (g, rgb01): per-ray redshift factor and shaded
    color, from the Killing constants E = -p_t and L_z = x p_y - y p_x and
    the emission radius."""
    x, y = hit_q[:, 1], hit_q[:, 2]
    energy = -hit_p[:, 0]
    l_z = x * hit_p[:, 2] - y * hit_p[:, 1]
    r_em = ks_radius(hit_q[:, 1], hit_q[:, 2], hit_q[:, 3], params[1])
    return shade_disk_constants(
        energy, l_z, r_em, params, r_obs, r_in, prograde=prograde,
        t_peak=t_peak, exposure=exposure, theta_obs=theta_obs,
        profile=profile, r_out=r_out, omega_obs=omega_obs, metric=metric)


def shade_disk_constants(energy, l_z, r_em, params, r_obs, r_in, *,
                         prograde=True, t_peak=9000.0, exposure=2.5,
                         theta_obs=math.pi / 2, profile="shakura",
                         r_out=14.0, omega_obs=0.0, metric="KerrSchild"):
    """shade_disk's core on (E, L_z, r_em): I_obs = g^4 I_em (Liouville),
    blackbody color at the observed temperature g T_em(r), tone-mapped
    1 - exp(-exposure I) and gamma-encoded.  A rotating regular family
    (`metric`) takes the mass-function emitter algebra of
    physics/rotating_orbits.py and a static receiver."""
    if metric == "KerrSchild":
        g = redshift_factor(energy, l_z, r_em, r_obs, params, prograde,
                            theta_obs, omega_obs)
    else:
        g = redshift_factor_rotating(energy, l_z, r_em, r_obs, params,
                                     MASS_FN[metric], prograde, theta_obs)
    if profile == "novikov":
        r_grid, t_tab = _nt_temp_table(
            r_in, torch.as_tensor(r_out, dtype=r_em.dtype,
                                  device=r_em.device),
            params, prograde, r_em.dtype, metric)
        t_norm = _interp(r_em, r_grid, t_tab)
    else:
        t_norm = _temp_profile(r_em, r_in)      # [0, 1]
    t_obs = g * t_norm                          # observed (redshifted)
    intensity = exposure * t_obs ** 4           # g^4 beaming * T^4
    tone = 1.0 - torch.exp(-intensity)
    tone = tone ** (1.0 / 2.2)
    return g, blackbody_rgb(t_obs * t_peak) * tone[:, None]


def polarization_fields(hit_q, hit_p, q0f, p0f, obs_pos, fov, height, width,
                        params, prograde, bfield, disk_mask, dtype,
                        omega_obs=0.0):
    """Walker-Penrose EVPA per disk pixel on flat (N, 4) tensors: kappa at
    each emission event (hit_q, hit_p), solved for on the screen of the
    camera ray (q0f, p0f) whose worldline rotates at omega_obs (0 = the
    static observer).  obs_pos (3,) and fov are tensors of `dtype`.
    Returns (evpa, pol_weight, pol_check), each masked to disk pixels."""
    q_bl, p_bl = bl_from_ks(hit_q, hit_p, params)
    kap1, kap2, sin2_b = emission_polarization(q_bl, p_bl, params, prograde,
                                               bfield)
    _, _, _, cam_right, cam_up = _lookat_frame(obs_pos, fov, height, width,
                                               dtype)
    evpa, c_norm = observer_evpa(kap1, kap2, q0f, p0f, cam_up, cam_right,
                                 params, omega_obs=omega_obs)
    zero = torch.zeros_like(evpa)
    evpa = torch.where(disk_mask, evpa, zero)
    pol_weight = torch.where(disk_mask, sin2_b, zero)
    pol_check = torch.where(disk_mask, c_norm, torch.ones_like(c_norm))
    return evpa, pol_weight, pol_check


def run_shading(result_arrays, *, height, width, profile, prograde, params,
                obs_pos, r_in, r_out, t_peak, exposure, camera_omega, dtype,
                fov=None, bfield=None, camera_moving=False,
                metric="KerrSchild"):
    """THE disk-shading function: every path that shades disk pixels
    (render_disk and io/transfer.reshade) calls it, with its scalars cast
    here in one canonical way, so equal invariants on one device and dtype
    give equal bytes.

    result_arrays = (hit_q (H, W, 4), hit_p, status (H, W), image
    (H, W, 3) uint8), on one device; disk pixels of the image are
    overwritten, the rest kept.  With `bfield` set (and the camera's `fov`)
    the camera rays the EVPA screen solve needs are recomputed (the
    boosted tetrad when camera_moving: an explicit omega 0.0 is a moving
    camera too).  `metric` 'KerrSchild' or a rotating regular family
    (params = (M, a, p)).  Returns {image, redshift, disk_count} and, with
    bfield, {evpa, pol_weight, pol_check}."""
    hit_q, hit_p, status, image = result_arrays
    device = hit_q.device

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.tensor(np.asarray(params, np.float64), dtype=dtype,
                          device=device)
    obs_pos = torch.tensor(np.asarray(obs_pos, np.float64), dtype=dtype,
                           device=device)
    omega_obs = scalar(camera_omega)
    n = height * width
    hq = hit_q.reshape(n, 4)
    hp = hit_p.reshape(n, 4)
    disk_mask = status.reshape(n) == STATUS_DISK

    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    th_obs = torch.arccos(torch.clamp(
        obs_pos[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
    g, rgb01 = shade_disk(hq, hp, params, r_obs_bl, scalar(r_in),
                          prograde=prograde, t_peak=scalar(t_peak),
                          exposure=scalar(exposure), theta_obs=th_obs,
                          profile=profile, r_out=scalar(r_out),
                          omega_obs=omega_obs, metric=metric)
    disk_u8 = torch.clamp(rgb01 * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    out_img = torch.where(disk_mask[:, None], disk_u8, image.reshape(n, 3))
    out = {"image": out_img.reshape(height, width, 3),
           "redshift": g.reshape(height, width),
           "disk_count": disk_mask.sum()}
    if bfield is not None:
        fov = scalar(fov)
        pix = pixel_grid_lookat(obs_pos, fov, height, width, dtype=dtype,
                                device=device)
        if camera_moving:
            q0, p0, _ = boosted_ics_from_pixels(
                obs_pos, pix, params=params, g_inv_fn=kerr_schild_g_inv,
                omega_cam=omega_obs)
        else:
            q0, p0, _ = cartesian_ics_from_pixels(
                obs_pos, pix, params=params, g_inv_fn=kerr_schild_g_inv)
        evpa, wgt, chk = polarization_fields(
            hq, hp, q0.reshape(n, 4), p0.reshape(n, 4), obs_pos, fov,
            height, width, params, prograde, bfield, disk_mask, dtype,
            omega_obs=omega_obs if camera_moving else 0.0)
        out.update(evpa=evpa.reshape(height, width),
                   pol_weight=wgt.reshape(height, width),
                   pol_check=chk.reshape(height, width))
    return out


def disk_observer_position(scene, disk):
    """Camera position of the disk scene: `disk.elevation_deg` above the
    equatorial plane at the scene's observer distance (float64 numpy)."""
    elev = np.deg2rad(disk.elevation_deg)
    return np.array([scene.observer_distance * np.cos(elev), 0.0,
                     scene.observer_distance * np.sin(elev)])


def resolve_camera_omega(scene, disk):
    """DiskConfig.camera_omega -> (moving, omega), on the host in float64.

    'keplerian' and 'zamo' resolve at the camera's BL (r, theta); an
    explicit float passes through.  Any moving camera must be timelike:
    -(g_tt + 2 w g_tph + w^2 g_phph) > 0 at the camera event, else
    ValueError (no such observer exists)."""
    spec = disk.camera_omega
    if spec is None:
        return False, 0.0
    f64 = torch.float64
    obs = torch.tensor(disk_observer_position(scene, disk), dtype=f64)
    params = torch.tensor([scene.bh_mass, scene.spin, scene.charge],
                          dtype=f64)
    r_bl = ks_radius(obs[0], obs[1], obs[2], params[1])
    th = torch.arccos(torch.clamp(obs[2] / torch.clamp(r_bl, min=1e-30),
                                  -1.0, 1.0))
    if spec == "keplerian":
        omega = float(keplerian_omega(r_bl, params[0], params[1], params[2],
                                      disk.prograde))
    elif spec == "zamo":
        omega = float(zamo_omega(r_bl, params, th))
    else:
        omega = float(spec)
    zero = torch.zeros((), dtype=f64)
    g = _invert_bl_metric(kerr_g_inv(torch.stack([zero, r_bl, th, zero]),
                                     params))
    denom = -(g[0, 0] + 2.0 * omega * g[0, 3] + omega * omega * g[3, 3])
    if not float(denom) > 0.0:
        raise ValueError(
            f"camera_omega = {omega:.6g} is superluminal at the camera "
            f"(BL r = {float(r_bl):.4g}, theta = "
            f"{math.degrees(float(th)):.3g} deg): the circular worldline is "
            f"not timelike there")
    return True, omega


# ---------------------------------------------------------------------------
# Full-frame disk render
# ---------------------------------------------------------------------------

def _trace_flat(q0f, p0f, bg_array, hole, params, r_obs, boundary_radius,
                steps, delta, omega, r_in, r_out, patch_center_theta,
                patch_center_phi, patch_size_theta, patch_size_phi, *, order,
                backend, flip_theta, flip_phi, has_background,
                stage=contextlib.nullcontext, metric="KerrSchild"):
    """The per-ray disk chain on flat (N, 4) phase points: integrate with
    crossing capture -> classify the rays that missed -> composite, with
    the disk pixels marked CLS_DISK.  JAX's `_trace_shade_flat` without its
    shading: `run_shading` alone colors the disk pixels.  The
    integration reads Python floats (hole = (M, a, Q); all rounded to the
    ray dtype on the host); the classifier 0-dim tensors of the rays'
    dtype and device (params = (M, a, Q) as one such tensor).  `stage()` is
    the context the integration runs in (engine/aa.py times it).  A
    rotating regular family (`metric`, hole = (M, a, p)) integrates
    through D2 and classifies at its own capture shell."""
    dtype, device = q0f.dtype, q0f.device
    n = q0f.shape[0]
    with stage():
        if metric == "KerrSchild":
            final_q, final_p, status, n_steps, hit_q, hit_p = \
                integrate_dispatch_disk(
                    q0f, p0f, steps, float(delta), hole,
                    float(boundary_radius), float(omega), float(r_in),
                    float(r_out), order=order, backend=backend)
        else:
            final_q, final_p, status, n_steps, hit_q, hit_p = \
                integrate_dispatch_disk_rotating(
                    q0f, p0f, steps, float(delta), hole,
                    float(boundary_radius), float(omega), float(r_in),
                    float(r_out), order=order, metric=metric)
    disk_mask = status == STATUS_DISK

    rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                         final_q[:, 3])
    rho = torch.where(status == STATUS_CAPTURED, torch.zeros_like(rho), rho)
    fq_sph = torch.stack([final_q[:, 0], rho, th, ph], dim=-1)

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    if metric == "KerrSchild":
        r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    else:
        # the integrator's 1.05 shell over the bisected horizon (or the
        # horizonless floor), as render_generic's classify_radius
        r_plus = rotating_capture_radius(metric, params).to(
            dtype=dtype, device=device) / 1.05
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        fq_sph, torch.full((n,), math.pi, dtype=dtype, device=device),
        torch.zeros((n,), dtype=dtype, device=device),
        rs=(1.05 / 1.2) * r_plus, r_obs_x=r_obs,
        boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch_center_theta),
        patch_center_phi=scalar(patch_center_phi),
        patch_size_theta=scalar(patch_size_theta),
        patch_size_phi=scalar(patch_size_phi),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    image = _classify.composite(cls, u01, v01, bg_array)
    cls = torch.where(disk_mask, CLS_DISK, cls)
    return {"colors": image, "cls": cls, "status": status,
            "n_steps": n_steps, "hit_q": hit_q, "hit_p": hit_p,
            "fq_sph": fq_sph, "th_csv": th_csv, "ph_csv": ph_csv}


def render_pixels_disk(bg_array, obs_pos, fov, mass, spin, charge,
                       boundary_radius, steps, delta, omega, r_in, r_out,
                       patch_center_theta, patch_center_phi,
                       patch_size_theta, patch_size_phi, *, height, width,
                       order=2, flip_theta=False, flip_phi=False,
                       has_background=True, dtype=torch.float32,
                       backend="auto", camera_omega=0.0,
                       camera_moving=False, metric="KerrSchild"):
    """The device pipeline of one disk frame, on bg_array's device: the
    look-at camera (static, or the boosted tetrad of the circular worldline
    at camera_omega when camera_moving) -> disk integration -> classify +
    composite.  obs_pos is a full (3,) position.  Scalars are Python
    floats (obs_pos a sequence), rounded to `dtype` on the device as the
    JAX pipeline receives them.  `metric` 'KerrSchild' (charge the hole's
    Q) or a rotating regular family (charge its parameter), whose g_inv the
    camera takes.  Returns per-pixel tensors, the base image (disk pixels
    not yet shaded: see `run_shading`) and the (6,) count vector."""
    device = bg_array.device

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    obs = torch.tensor(np.asarray(obs_pos, np.float64), dtype=dtype,
                       device=device)
    r_obs = torch.linalg.vector_norm(obs)
    pix = pixel_grid_lookat(obs, scalar(fov), height, width, dtype=dtype,
                            device=device)
    if camera_moving:
        q0, p0, alpha0 = boosted_ics_from_pixels(
            obs, pix, params=params, g_inv_fn=kerr_schild_g_inv,
            omega_cam=scalar(camera_omega))
    else:
        q0, p0, alpha0 = cartesian_ics_from_pixels(
            obs, pix, params=params, g_inv_fn=METRICS[metric])
    n = height * width
    flat = _trace_flat(
        q0.reshape(n, 4).contiguous(), p0.reshape(n, 4).contiguous(),
        bg_array, (float(mass), float(spin), float(charge)), params, r_obs,
        boundary_radius, steps, delta, omega, r_in,
        r_out, patch_center_theta, patch_center_phi, patch_size_theta,
        patch_size_phi, order=order, backend=backend, flip_theta=flip_theta,
        flip_phi=flip_phi, has_background=has_background, metric=metric)
    cls = flat["cls"].reshape(height, width)
    count_vec = torch.cat([_classify.count_vector(cls),
                           (cls == CLS_DISK).sum()[None]])
    return {
        "image": flat["colors"].reshape(height, width, 3),
        "cls": cls,
        "final_q": flat["fq_sph"].reshape(height, width, 4),
        "final_th": flat["th_csv"].reshape(height, width),
        "final_ph": flat["ph_csv"].reshape(height, width),
        "q0": q0,
        "p0": p0,
        "alpha0": alpha0,
        "n_steps": flat["n_steps"].reshape(height, width),
        "status": flat["status"].reshape(height, width),
        "hit_q": flat["hit_q"].reshape(height, width, 4),
        "hit_p": flat["hit_p"].reshape(height, width, 4),
        "count_vec": count_vec,
    }


def render_disk(scene, disk: DiskConfig = None, *, bg_array=None,
                dtype=None, metrics=None, aa_samples=None, device="cuda"):
    """SceneConfig-driven thin-disk render -> engine.render.RenderResult.

    scene.spin and scene.charge select the hole (Schwarzschild is spin 0);
    every scene is traced in the Kerr-Schild chart.  scene.metric
    'rotating-bardeen' / 'rotating-hayward' selects a rotating regular
    family with scene.metric_param (kernel D2; no bfield, camera_omega or
    aa_samples, as in JAX).  The counts carry an
    extra 'disk' entry; result.device('redshift') is the per-pixel g
    factor (meaningful on disk pixels), result.device('hit_q') /
    ('hit_p') the recorded crossings.  device defaults to 'cuda' (kernel
    B6) and raises without a GPU; pass device='cpu' for the eager twins.
    aa_samples = s (>= 2) refines the display image's boundary pixels
    (engine/aa.py: s x s sub-rays through B6 and run_shading; the class
    map, counts, redshift and polarization maps keep the centre sample).
    """
    from .render import ROTATING_NAMES, RenderResult, _untimed

    disk = disk or DiskConfig()
    metric = ROTATING_NAMES.get(
        getattr(scene, "metric", "Schwarzschild").lower(), "KerrSchild")
    if metric == "KerrSchild":
        charge_slot = scene.charge
        camera_moving, camera_omega = resolve_camera_omega(scene, disk)
        r_in = disk.inner_edge(scene.bh_mass, scene.spin, scene.charge)
    else:
        if disk.bfield is not None:
            raise NotImplementedError(
                "polarized imaging (DiskConfig.bfield) requires the "
                "Walker-Penrose constant of the exact Kerr-Newman "
                "family — not wired for the mass-function metrics")
        if disk.camera_omega is not None:
            raise NotImplementedError(
                "orbiting cameras (DiskConfig.camera_omega) are wired "
                "for the Kerr-Newman disk path only")
        if aa_samples:
            raise NotImplementedError(
                "--aa on the disk mode rides the Kerr-Newman sub-ray "
                "chain; rotating regular disks render without edge "
                "refinement")
        charge_slot = float(getattr(scene, "metric_param", 0.0))
        r_in = (disk.r_in if disk.r_in is not None
                else rotating_disk_inner_edge(metric, scene.bh_mass,
                                              scene.spin, charge_slot,
                                              disk.prograde))
        camera_moving, camera_omega = False, 0.0
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_disk(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu' for the eager twins")

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
    obs_pos = disk_observer_position(scene, disk)

    with stage("device_pipeline"):
        out = render_pixels_disk(
            bg_dev, obs_pos, scene.fov, scene.bh_mass, scene.spin,
            charge_slot, scene.boundary_radius, integ.steps, integ.delta,
            float(integ.omega), r_in, disk.r_out,
            scene.patch.center_theta, scene.patch.center_phi,
            scene.patch.size_theta, scene.patch.size_phi,
            height=h, width=w, order=integ.order,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi, has_background=has_bg,
            dtype=dtype, backend=integ.backend, camera_omega=camera_omega,
            camera_moving=camera_moving, metric=metric)
        shaded = run_shading(
            (out["hit_q"], out["hit_p"], out["status"], out["image"]),
            height=h, width=w, profile=disk.profile, prograde=disk.prograde,
            params=[scene.bh_mass, scene.spin, charge_slot],
            obs_pos=obs_pos, fov=scene.fov, r_in=r_in, r_out=disk.r_out,
            t_peak=disk.t_peak, exposure=disk.exposure,
            camera_omega=camera_omega, dtype=dtype, bfield=disk.bfield,
            camera_moving=camera_moving, metric=metric)
        shaded.pop("disk_count")
        out.update(shaded)
        if aa_samples:
            from .aa import refine_edges_disk
            with stage("device_pipeline/aa"):
                out["image"], out["aa_mask"] = refine_edges_disk(
                    out["cls"], out["image"], bg_dev, obs_pos, scene.fov,
                    scene.bh_mass, scene.spin, scene.charge,
                    scene.boundary_radius, integ.steps, integ.delta,
                    float(integ.omega), r_in, disk.r_out, disk.t_peak,
                    disk.exposure, scene.patch.center_theta,
                    scene.patch.center_phi, scene.patch.size_theta,
                    scene.patch.size_phi, camera_omega, height=h, width=w,
                    samples=int(aa_samples), order=integ.order,
                    backend=integ.backend,
                    flip_theta=scene.patch.flip_theta,
                    flip_phi=scene.patch.flip_phi, has_background=has_bg,
                    dtype=dtype, prograde=disk.prograde,
                    profile=disk.profile, camera_moving=camera_moving,
                    stage=stage)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4], "disk": cv[5]}
    if metrics is not None:  # costs one (H, W) reduction and fetch
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())
    out["beta"] = torch.zeros((h, w), dtype=dtype, device=device)
    out["heading"] = torch.zeros((h, w, 3), dtype=dtype, device=device)
    return RenderResult(out, counts)


# ---------------------------------------------------------------------------
# Science products
# ---------------------------------------------------------------------------

def _host(result, name):
    return result.device(name).cpu().numpy()


def save_disk_maps(result, out_dir, emissivity_index=3.0, spin=0.0, *,
                   plots=True, chart="ks"):
    """Write the disk mode's science products from a render_disk (or
    io/transfer.reshade) result, as `grtrace.engine.disk.save_disk_maps`:

    redshift_map.csv: one row per disk pixel: i, j, g (= nu_obs/nu_em) and
    r_em (the BL radius of the Kerr-Schild crossing; with chart
    'spherical', the static families' disk, the crossing's own r);
    line_profile.csv: the relativistic line profile, observed flux vs g for
    a monochromatic line with emissivity I_em ~ r^-q, q = emissivity_index
    (pixel flux ~ g^4 r_em^-q, 48 bins);
    polarization_map.csv (when the result has 'evpa'): i, j, evpa (mod pi,
    from camera-up toward camera-right), pol_weight, pol_check.

    The CSVs are always written; the figures (redshift_map.png,
    line_profile.png, polarization_map.png) only with `plots`, which needs
    matplotlib (viz.plots.available())."""
    g = _host(result, "redshift")
    status = _host(result, "status")
    hq = _host(result, "hit_q")
    dm = status == STATUS_DISK
    ii, jj = np.nonzero(dm)
    if chart == "spherical":
        r_em = hq[dm, 1]
    else:
        r_em = ks_radius(*(torch.from_numpy(hq[dm, k]) for k in (1, 2, 3)),
                         spin).numpy()
    rows = np.column_stack([ii, jj, g[dm], r_em])
    np.savetxt(os.path.join(out_dir, "redshift_map.csv"), rows,
               delimiter=",", header="i,j,redshift_g,r_emission",
               comments="", fmt=("%d", "%d", "%.8g", "%.8g"))

    g_disk = g[dm]
    if g_disk.size:
        flux = g_disk ** 4 * r_em ** -float(emissivity_index)
        hist, edges = np.histogram(g_disk, bins=48, weights=flux)
        centers = 0.5 * (edges[1:] + edges[:-1])
        peak = hist.max()
        if peak > 0:
            hist = hist / peak
        np.savetxt(os.path.join(out_dir, "line_profile.csv"),
                   np.column_stack([centers, hist]), delimiter=",",
                   header="g,relative_flux", comments="", fmt="%.8g")
    if result.has("evpa"):
        evpa = _host(result, "evpa")
        wgt = _host(result, "pol_weight")
        chk = _host(result, "pol_check")
        np.savetxt(os.path.join(out_dir, "polarization_map.csv"),
                   np.column_stack([ii, jj, evpa[dm], wgt[dm], chk[dm]]),
                   delimiter=",", comments="",
                   header="i,j,evpa_rad,pol_weight,pol_check",
                   fmt=("%d", "%d", "%.8g", "%.8g", "%.8g"))
    if not plots:
        return

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if g_disk.size:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(centers, hist, drawstyle="steps-mid")
        ax.set_xlabel("g = $\\nu_{obs}/\\nu_{em}$")
        ax.set_ylabel("relative flux")
        ax.set_title("relativistic line profile "
                     f"($r^{{-{float(emissivity_index):g}}}$ emissivity)")
        fig.savefig(os.path.join(out_dir, "line_profile.png"), dpi=110,
                    bbox_inches="tight")
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 5))
    gm = np.ma.masked_where(~dm, g)
    span = max(abs(1.0 - gm.min()), abs(gm.max() - 1.0)) if dm.any() else 1.0
    # RdBu (unreversed): low g -> red (redshifted), high g -> blue
    im = ax.imshow(gm, cmap="RdBu", vmin=1.0 - span, vmax=1.0 + span)
    ax.set_facecolor("black")
    ax.set_title("disk redshift factor g = $\\nu_{obs}/\\nu_{em}$")
    fig.colorbar(im, ax=ax, label="g  (<1 redshifted, >1 blueshifted)")
    fig.savefig(os.path.join(out_dir, "redshift_map.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)

    if result.has("evpa"):
        polarization_ticks_png(result, os.path.join(out_dir,
                                                    "polarization_map.png"))


def polarization_ticks_png(result, path, stride=1, dpi=110, scale=28.0,
                           width=0.003):
    """EVPA ticks over the rendered frame (matplotlib): the tick of EVPA
    chi is cos(chi) up + sin(chi) right, rows advancing along camera-up and
    columns along camera-right, its length the pitch-angle weight;
    `stride` subsamples the tick grid."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    evpa = _host(result, "evpa")
    wgt = _host(result, "pol_weight")
    dm = _host(result, "status") == STATUS_DISK
    if stride > 1:
        keep = np.zeros_like(dm)
        keep[::stride, ::stride] = True
        dm = dm & keep
    ii, jj = np.nonzero(dm)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(_host(result, "image"))
    if dm.any():
        ax.quiver(jj, ii, np.sin(evpa[dm]) * wgt[dm],
                  np.cos(evpa[dm]) * wgt[dm], color="white", scale=scale,
                  headwidth=1, headlength=0, headaxislength=0,
                  pivot="middle", width=width)
    ax.set_title("disk polarization (EVPA ticks, length ~ sin$^2\\theta_B$)")
    ax.set_axis_off()
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
