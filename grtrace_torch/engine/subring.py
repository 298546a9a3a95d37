"""Photon-ring subring decomposition — the torch counterpart of
`grtrace.engine.subring`: image orders n = 0, 1, 2, ... of an optically
thin equatorial disk, rendered as separate layers from one geodesic pass.

Light that crossed the equatorial plane n times between emission and the
camera forms the n-th sub-image (Gralla-Holz-Wald image orders): n = 0 the
direct image, n = 1 the lensed far side, n >= 2 the photon ring, with
successive orders demagnified by about e^{-gamma} and delayed by about the
photon-shell half-period (physics/photon_shell.py predicts both).

The pipeline: the inclined look-at camera -> the subring integration
(`integrate_dispatch_subrings`: kernel B7 on a CUDA device, its eager twins
on the CPU), which counts every plane crossing and records the first
n_orders without freezing any ray (the disk is transparent) -> per-order
shading of the recorded events (`shade_subrings`: a crossing emits iff its
slot was filled and its Boyer-Lindquist radius lies in [r_in, r_out]) ->
classification of the ray endpoints -> the additive thin-disk composite
over the lensed sky.  `subring_summary` turns a result into flux per
order, the measured demagnification exponent and the inter-order delays.

With `DiskConfig.bfield` each order gets its own Walker-Penrose EVPA map
(kappa at that order's emission event, solved on the shared camera ray's
screen), and `polarized_moments` reduces them to the beta_m moments; with
`camera_omega` the camera rides a circular worldline (the boosted tetrad).

`aa_samples` refines every pixel a layer boundary crosses, in the image
and the per-order intensities (`aa.refine_subrings`, B7 again on the
sub-rays).  `subring_visibilities` gives each order's u-v signature
(engine/visibility.py) and `save_subring_maps` writes the science products
(CSV and JSON always, the figures when matplotlib is asked for).  A
charged hole's inner edge (`r_in=None` with charge) is the autodiff ISCO of
physics/epicyclic.py, through `DiskConfig.inner_edge`.
"""
from __future__ import annotations

import contextlib
import json
import math
import os

import numpy as np
import torch

from ..physics.camera import (boosted_ics_from_pixels,
                              cartesian_ics_from_pixels, pixel_grid_lookat)
from ..physics.coords import cartesian_to_spherical
from ..physics.orbits import redshift_factor
from ..physics.spacetime import horizon_radius, kerr_schild_g_inv, ks_radius
from . import classify as _classify
from .disk import (CLS_DISK, DiskConfig, _interp, _nt_temp_table,
                   _temp_profile, blackbody_rgb, disk_observer_position,
                   polarization_fields, resolve_camera_omega)
from .hotspot import bl_time_azimuth_offsets
from .integrate import STATUS_CAPTURED
from .integrate_ks import integrate_dispatch_subrings
from .render import RenderResult, _untimed


def shade_subrings(hits_q, hits_p, count, params, r_obs_bl, r_in, r_out, *,
                   prograde=True, theta_obs=math.pi / 2, profile="shakura",
                   t_peak=9000.0, exposure=2.5, omega_obs=0.0):
    """Per-order shading of recorded crossings -> layered observables.

    hits_q, hits_p (n_orders, N, 4), count (N,).  Order n emits iff its
    slot was filled (count > n) and its BL radius lies in [r_in, r_out];
    each valid event gets the exact Killing-constant redshift g_n and the
    Liouville intensity I_n = (g_n T(r_n))^4, and the layers add (optically
    thin).  Returns a dict of (n_orders, N) tensors {g, intensity, r_em,
    t_hit, valid}, the composited (N, 3) rgb01 and the (N,) tone and
    total_intensity; the color is the blackbody at the intensity-weighted
    mean observed temperature across orders."""
    n_orders = hits_q.shape[0]
    spin = params[1]
    x, y = hits_q[..., 1], hits_q[..., 2]
    energy = -hits_p[..., 0]
    l_z = x * hits_p[..., 2] - y * hits_p[..., 1]
    r_em = ks_radius(x, y, hits_q[..., 3], spin)

    orders = torch.arange(n_orders, dtype=count.dtype, device=count.device)
    filled = count[None, :] > orders[:, None]
    valid = filled & (r_em >= r_in) & (r_em <= r_out)

    g = redshift_factor(energy, l_z, r_em, r_obs_bl, params, prograde,
                        theta_obs, omega_obs)
    g = torch.where(valid, g, 0.0)

    if profile == "novikov":
        r_grid, t_tab = _nt_temp_table(r_in, r_out, params, prograde,
                                       r_em.dtype)
        t_norm = _interp(r_em, r_grid, t_tab)
    else:
        t_norm = _temp_profile(r_em, r_in)
    t_obs = g * t_norm
    intensity = torch.where(valid, t_obs ** 4, 0.0)

    total = torch.sum(intensity, dim=0)
    tone = 1.0 - torch.exp(-exposure * total)
    tone_disp = tone ** (1.0 / 2.2)
    t_eff = torch.sum(intensity * t_obs, dim=0) / torch.clamp(total,
                                                               min=1e-30)
    rgb01 = blackbody_rgb(t_eff * t_peak) * tone_disp[:, None]
    return {"g": g, "intensity": intensity, "r_em": r_em,
            "t_hit": hits_q[..., 0], "valid": valid, "rgb01": rgb01,
            "tone": tone_disp, "total_intensity": total}


def _trace_shade_subrings(q0f, p0f, bg_array, hole, params, r_obs, r_obs_bl,
                          th_obs, boundary_radius, steps, delta, omega, r_in,
                          r_out, t_peak, exposure, patch_center_theta,
                          patch_center_phi, patch_size_theta, patch_size_phi,
                          *, n_orders, order, backend, prograde, profile,
                          flip_theta, flip_phi, has_background,
                          omega_obs=0.0, stage=contextlib.nullcontext):
    """The per-ray subring chain on flat (N, 4) phase points: transparent-
    disk integration -> per-order shade -> endpoint classify -> additive
    thin-disk composite.  The integration reads Python floats (hole =
    (M, a, Q), rounded to the ray dtype on the host); the shading and the
    classifier 0-dim tensors of the rays' dtype and device (params =
    (M, a, Q) as one such tensor).  `stage()` is the context the
    integration runs in (engine/aa.py times it)."""
    dtype, device = q0f.dtype, q0f.device
    n = q0f.shape[0]

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    with stage():
        final_q, _, status, n_steps, hq, hp, count = \
            integrate_dispatch_subrings(
                q0f, p0f, steps, float(delta), hole, float(boundary_radius),
                float(omega), n_orders=n_orders, order=order,
                backend=backend)

    shade = shade_subrings(
        hq, hp, count, params, r_obs_bl, scalar(r_in), scalar(r_out),
        prograde=prograde, theta_obs=th_obs, profile=profile,
        t_peak=scalar(t_peak), exposure=scalar(exposure),
        omega_obs=scalar(omega_obs))

    # background classification of the ray endpoints (transparent disk:
    # every escaped ray still lands on the sky)
    rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                         final_q[:, 3])
    rho = torch.where(status == STATUS_CAPTURED, torch.zeros_like(rho), rho)
    fq_sph = torch.stack([final_q[:, 0], rho, th, ph], dim=-1)
    r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    cls, _, _, u01, v01 = _classify.classify_rays(
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
    bg = _classify.composite(cls, u01, v01, bg_array)

    # additive thin-disk blend: out = bg (1 - tone) + disk emission
    tone = shade["tone"]
    disk_rgb = torch.clamp(shade["rgb01"] * 255.0, 0.0, 255.0)
    out = bg.to(dtype) * (1.0 - tone[:, None]) + disk_rgb
    image = torch.clamp(out + 0.5, 0.0, 255.0).to(torch.uint8)
    cls = torch.where(shade["valid"].any(dim=0), CLS_DISK, cls)
    return {"image": image, "cls": cls, "status": status,
            "n_steps": n_steps, "count": count, "hq": hq, "hp": hp,
            "shade": shade}


def render_pixels_subrings(bg_array, obs_pos, fov, mass, spin, charge,
                           boundary_radius, steps, delta, omega, r_in, r_out,
                           t_peak, exposure, patch_center_theta,
                           patch_center_phi, patch_size_theta, patch_size_phi,
                           *, height, width, n_orders=3, order=2,
                           flip_theta=False, flip_phi=False,
                           has_background=True, dtype=torch.float32,
                           prograde=True, profile="shakura", backend="auto",
                           camera_omega=0.0, camera_moving=False,
                           bfield=None):
    """The device pipeline of one subring frame, on bg_array's device: the
    look-at camera (the boosted tetrad at camera_omega when camera_moving)
    -> subring integration -> per-order shade (and, with bfield, per-order
    polarization) -> additive composite over the lensed background.
    obs_pos is a full (3,) position; scalars are Python floats, rounded to
    `dtype` on the device as the JAX pipeline receives them.  Per-order
    observables come back as (n_orders, H, W) stacks, with the (6,) count
    vector (the last entry the emitting pixels)."""
    device = bg_array.device

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    obs = torch.tensor(np.asarray(obs_pos, np.float64), dtype=dtype,
                       device=device)
    r_obs = torch.linalg.vector_norm(obs)
    r_obs_bl = ks_radius(obs[0], obs[1], obs[2], params[1])
    th_obs = torch.arccos(torch.clamp(
        obs[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
    fov_t = scalar(fov)
    pix = pixel_grid_lookat(obs, fov_t, height, width, dtype=dtype,
                            device=device)
    if camera_moving:
        q0, p0, alpha0 = boosted_ics_from_pixels(
            obs, pix, params=params, g_inv_fn=kerr_schild_g_inv,
            omega_cam=scalar(camera_omega))
    else:
        q0, p0, alpha0 = cartesian_ics_from_pixels(
            obs, pix, params=params, g_inv_fn=kerr_schild_g_inv)
    n = height * width
    q0f, p0f = q0.reshape(n, 4).contiguous(), p0.reshape(n, 4).contiguous()
    flat = _trace_shade_subrings(
        q0f, p0f, bg_array, (float(mass), float(spin), float(charge)),
        params, r_obs, r_obs_bl, th_obs, boundary_radius, steps, delta,
        omega, r_in, r_out, t_peak, exposure, patch_center_theta,
        patch_center_phi, patch_size_theta, patch_size_phi,
        n_orders=n_orders, order=order,
        backend=backend, prograde=prograde, profile=profile,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background,
        omega_obs=camera_omega if camera_moving else 0.0)
    shade = flat["shade"]
    cls = flat["cls"].reshape(height, width)
    count_vec = torch.cat([_classify.count_vector(cls),
                           (cls == CLS_DISK).sum()[None]])
    hw = (height, width)
    pol = {}
    if bfield is not None:
        # kappa at each order's emission event, solved on the screen of the
        # camera ray the orders share: one pass gives the EVPA rotation
        # between the direct image and each subring.  As in the JAX
        # package, the screen is the static observer's (omega_obs 0) even
        # for a moving camera.
        maps = [polarization_fields(
            flat["hq"][s], flat["hp"][s], q0f, p0f, obs, fov_t, height,
            width, params, prograde, bfield, shade["valid"][s], dtype)
            for s in range(n_orders)]
        for k, name in enumerate(("evpa", "pol_weight", "pol_check")):
            pol[name] = torch.stack([m[k] for m in maps]).reshape(
                (-1,) + hw)
    return pol | {
        "image": flat["image"].reshape(height, width, 3),
        "cls": cls,
        "status": flat["status"].reshape(hw),
        "n_steps": flat["n_steps"].reshape(hw),
        "count": flat["count"].reshape(hw),
        "q0": q0,
        "p0": p0,
        "alpha0": alpha0,
        "hits_q": flat["hq"].reshape((-1,) + hw + (4,)),
        "hits_p": flat["hp"].reshape((-1,) + hw + (4,)),
        "g": shade["g"].reshape((-1,) + hw),
        "intensity": shade["intensity"].reshape((-1,) + hw),
        "r_em": shade["r_em"].reshape((-1,) + hw),
        "valid": shade["valid"].reshape((-1,) + hw),
        "total_intensity": shade["total_intensity"].reshape(hw),
        "count_vec": count_vec,
    }


class SubringResult(RenderResult):
    """What one subring render produced: the per-pixel and per-order
    tensors stay on the device until first read (as an attribute or as
    result['name'], which is how `subring_summary` reads a JAX result
    dict too), then are cached as numpy arrays; `counts` and the scene
    scalars params, r_in, r_out, obs_pos, n_orders are plain values."""

    _FIELDS = ("image", "cls", "status", "n_steps", "count", "q0", "p0",
               "alpha0", "hits_q", "hits_p", "g", "intensity", "r_em",
               "valid", "total_intensity", "evpa", "pol_weight",
               "pol_check", "aa_mask")
    _SCALARS = ("params", "r_in", "r_out", "obs_pos", "n_orders")

    def __init__(self, device_arrays, counts, **scalars):
        super().__init__(device_arrays, counts)
        self.__dict__.update(scalars)

    def __getitem__(self, name):
        if name in self._FIELDS or name in self._SCALARS:
            return getattr(self, name)
        raise KeyError(name)


def render_subrings(scene, disk: DiskConfig = None, *, n_orders=3,
                    bg_array=None, dtype=None, metrics=None, aa_samples=None,
                    device="cuda"):
    """SceneConfig (+ DiskConfig) -> SubringResult: the transparent-disk
    render with every image order resolved, the torch counterpart of
    `grtrace.engine.subring.render_subrings` (inclined look-at camera,
    ISCO inner edge by default; like JAX's, it traces the Kerr-Newman hole
    of scene.spin and scene.charge in the Kerr-Schild chart whatever
    scene.metric says).

    counts carries a sixth entry, 'disk': the emitting pixels (any order
    valid).  device defaults to 'cuda' (kernel B7) and raises without a
    GPU; pass device='cpu' for the eager twins.  aa_samples = s (>= 2)
    refines every pixel a layer boundary crosses (engine/aa.py: s x s
    sub-rays through B7), in the image and the per-order intensity maps
    (and so total_intensity); aa_mask marks them."""
    disk = disk or DiskConfig()
    moving, omega_cam = resolve_camera_omega(scene, disk)
    r_in = disk.inner_edge(scene.bh_mass, scene.spin, scene.charge)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_subrings(device='cuda') needs a CUDA GPU; "
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
        out = render_pixels_subrings(
            bg_dev, obs_pos, scene.fov, scene.bh_mass, scene.spin,
            scene.charge, scene.boundary_radius, integ.steps, integ.delta,
            float(integ.omega), r_in, disk.r_out, disk.t_peak,
            disk.exposure, scene.patch.center_theta, scene.patch.center_phi,
            scene.patch.size_theta, scene.patch.size_phi,
            height=h, width=w, n_orders=n_orders, order=integ.order,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi, has_background=has_bg,
            dtype=dtype, prograde=disk.prograde, profile=disk.profile,
            backend=integ.backend, camera_omega=omega_cam,
            camera_moving=moving, bfield=disk.bfield)
        if aa_samples:
            from .aa import refine_subrings
            with stage("device_pipeline/aa"):
                (out["image"], out["intensity"], out["total_intensity"],
                 out["aa_mask"]) = refine_subrings(
                    out["cls"], out["count"], out["valid"], out["image"],
                    out["intensity"], bg_dev, obs_pos, scene.fov,
                    scene.bh_mass, scene.spin, scene.charge,
                    scene.boundary_radius, integ.steps, integ.delta,
                    float(integ.omega), r_in, disk.r_out, disk.t_peak,
                    disk.exposure, scene.patch.center_theta,
                    scene.patch.center_phi, scene.patch.size_theta,
                    scene.patch.size_phi, omega_cam, height=h, width=w,
                    samples=int(aa_samples), n_orders=n_orders,
                    order=integ.order, backend=integ.backend,
                    flip_theta=scene.patch.flip_theta,
                    flip_phi=scene.patch.flip_phi, has_background=has_bg,
                    dtype=dtype, prograde=disk.prograde,
                    profile=disk.profile, camera_moving=moving,
                    stage=stage)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4], "disk": cv[5]}
    if metrics is not None:  # costs one (H, W) reduction and fetch
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())
    return SubringResult(
        out, counts, params=np.array([scene.bh_mass, scene.spin,
                                      scene.charge]),
        r_in=float(r_in), r_out=float(disk.r_out),
        obs_pos=np.asarray(obs_pos), n_orders=n_orders)


def _has(result, name):
    """Whether a SubringResult or a result mapping carries `name`."""
    return result.has(name) if hasattr(result, "has") else name in result


def polarized_moments(result, ms=(1, 2)):
    """Azimuthal moments of the complex polarization field per image order,
    beta_m (Palumbo, Wong & Prather 2020), host-side numpy:

        beta_m = sum_px P e^{-i m psi} / sum_px I,   P = p I e^{2 i chi}

    with psi the pixel's screen position angle about the image center (rows
    along camera-up, columns along camera-right, the EVPA's basis), chi the
    EVPA, I the layer intensity and p the pitch-angle weight.  arg(beta_2)
    = 0 is a radial EVPA pattern, +-pi an azimuthal one.  `result` is a
    polarized SubringResult or a mapping with intensity, evpa and
    pol_weight.  Returns {m: [complex per order]}."""
    inten = np.asarray(result["intensity"], dtype=np.float64)
    evpa = np.asarray(result["evpa"], dtype=np.float64)
    wgt = np.asarray(result["pol_weight"], dtype=np.float64)
    n_orders, h, w = inten.shape
    ii, jj = np.mgrid[0:h, 0:w]
    psi = np.arctan2(jj - (w - 1) / 2.0, ii - (h - 1) / 2.0)
    pfield = wgt * inten * np.exp(2j * evpa)
    out = {}
    for m in ms:
        phase = np.exp(-1j * m * psi)
        out[int(m)] = [
            complex((pfield[n] * phase).sum() / max(inten[n].sum(), 1e-300))
            for n in range(n_orders)]
    return out


def subring_summary(result):
    """Flux per order, Lyapunov and delay estimates from a subring render
    (host-side numpy): `result` is a SubringResult or any mapping with the
    keys intensity, valid, params, r_em, hits_q and count (a JAX result
    dict too).

    * flux F_n: the sum of layer n's per-pixel intensity;
    * gamma_hat = ln(F_n / F_{n+1}) between the two highest orders with
      nonzero flux: the measured demagnification exponent;
    * delay_n: the median BL arrival-time gap t_{n-1} - t_n over the
      pixels whose slots n-1 and n were both filled (Kerr-Schild and BL
      time differ by a function of radius, `bl_time_azimuth_offsets`);
    * with polarization maps: the per-order EVPA twist and beta_2
      (`polarized_moments`).
    """
    inten = np.asarray(result["intensity"], dtype=np.float64)
    valid = np.asarray(result["valid"])
    n_orders = inten.shape[0]
    r_em = np.asarray(result["r_em"], dtype=np.float64)
    t_ks = np.asarray(result["hits_q"][..., 0], dtype=np.float64)
    t_off, _ = bl_time_azimuth_offsets(
        torch.tensor(r_em), np.asarray(result["params"], np.float64))
    t_bl = t_ks - t_off.numpy()

    flux = [float(inten[i].sum()) for i in range(n_orders)]
    pix = [int(valid[i].sum()) for i in range(n_orders)]
    ratios = [flux[i + 1] / flux[i] if flux[i] > 0 else float("nan")
              for i in range(n_orders - 1)]
    gamma_hat = float("nan")
    for i in range(n_orders - 2, -1, -1):
        if flux[i] > 0 and flux[i + 1] > 0:
            gamma_hat = float(np.log(flux[i] / flux[i + 1]))
            break
    # the delay masks use slot-filled (count > i), not annulus-valid: a
    # crossing in the ISCO gap emits nothing, but its time is exact
    count = np.asarray(result["count"])
    filled = count.reshape(-1)[None, :] > np.arange(n_orders)[:, None]
    filled = filled.reshape(valid.shape)
    delays = []
    for i in range(1, n_orders):
        both = filled[i] & filled[i - 1]
        # past-directed rays: deeper orders were emitted earlier (more
        # negative t), so the physical delay is t_{n-1} - t_n > 0
        delays.append(float(np.median(t_bl[i - 1][both] - t_bl[i][both]))
                      if both.any() else float("nan"))
    out = {"flux_per_order": flux, "pixels_per_order": pix,
           "flux_ratio": ratios, "gamma_hat": gamma_hat,
           "delay_per_order_M": delays, "max_crossings": int(count.max())}
    if _has(result, "evpa"):
        # the per-order EVPA twist: the median mod-pi angle difference
        # between adjacent orders over pixels emitting in both, and the
        # beta_2 moment of each order
        evpa = np.asarray(result["evpa"], dtype=np.float64)
        twists = []
        for i in range(1, n_orders):
            both = valid[i] & valid[i - 1]
            if both.any():
                d = evpa[i][both] - evpa[i - 1][both]
                d = (d + np.pi / 2) % np.pi - np.pi / 2  # EVPA is mod pi
                twists.append(float(np.median(d)))
            else:
                twists.append(float("nan"))
        out["evpa_twist_per_order_rad"] = twists
        beta = polarized_moments(result, ms=(2,))[2]
        out["beta2_abs_per_order"] = [abs(b) for b in beta]
        out["beta2_arg_per_order_rad"] = [
            float(np.angle(b)) if abs(b) > 0 else float("nan")
            for b in beta]
    return out


# ---------------------------------------------------------------------------
# Science artifacts
# ---------------------------------------------------------------------------

def subring_visibilities(result, fov_rad, pad=6, n_bins=400):
    """Per-order u-v signatures of one subring render: each layer's |V|(b)
    radial profile, first null and thin-ring diameter estimate, in camera
    radians (multiply baselines by visibility.camera_to_earth for a real
    source).  The n >= 1 layers converge onto the critical curve, so the
    thin-ring estimator is cleaner on them than on the composite image.
    The FFTs run on the result's device.  Returns a list of dicts {order,
    baselines, profile, b_null, ring_diameter_rad}; empty layers get NaN
    estimates."""
    from .visibility import (first_null, radial_profile,
                             ring_diameter_from_null, visibility_map)

    inten = (result.device("intensity") if hasattr(result, "device")
             else torch.as_tensor(np.asarray(result["intensity"])))
    inten = inten.to(torch.float64)
    n_orders, h, w = inten.shape
    pixel_cam = 2.0 * np.tan(fov_rad / 2.0) / w
    out = []
    for n in range(n_orders):
        if float(inten[n].sum()) <= 0.0:
            out.append({"order": n, "baselines": None, "profile": None,
                        "b_null": float("nan"),
                        "ring_diameter_rad": float("nan")})
            continue
        amp, u, v = visibility_map(inten[n], pixel_cam, pad=pad)
        base, prof = radial_profile(amp, u, v, n_bins=n_bins,
                                    b_max=min(u.max(), v.max()) / 4.0)
        b_null = first_null(base, prof)
        out.append({"order": n, "baselines": base, "profile": prof,
                    "b_null": b_null,
                    "ring_diameter_rad": ring_diameter_from_null(b_null)})
    return out


def _delay_01(result):
    """The n = 0 - n = 1 Boyer-Lindquist arrival-time gap per pixel (M)
    and the pixels whose first two slots were filled (host numpy)."""
    count = np.asarray(result["count"])
    t_ks = np.asarray(result["hits_q"][..., 0], dtype=np.float64)
    r_em = np.asarray(result["r_em"], dtype=np.float64)
    t_off, _ = bl_time_azimuth_offsets(
        torch.tensor(r_em[:2]), np.asarray(result["params"], np.float64))
    t_off = t_off.numpy()
    return (t_ks[0] - t_off[0]) - (t_ks[1] - t_off[1]), count > 1


def save_subring_maps(result, out_dir, *, plots=True):
    """Write the subring science products, as
    `grtrace.engine.subring.save_subring_maps`: subring_delay_01.csv (i,
    j, the n = 0 - n = 1 delay in M, g and r_em of both orders, for the
    pixels that crossed twice) and subring_summary.json
    (`subring_summary`), always; with `plots` (matplotlib,
    viz.plots.available()) the per-order intensity maps
    subring_order_N.png, the polarized orders' subring_evpa_N.png,
    crossing_count.png and subring_delay_01.png.  Returns (written paths,
    summary)."""
    os.makedirs(out_dir, exist_ok=True)
    inten = np.asarray(result["intensity"])
    valid = np.asarray(result["valid"])
    g = np.asarray(result["g"])
    count = np.asarray(result["count"])
    n_orders = inten.shape[0]
    written = []
    plt = None
    if plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

    def figure(name, data, title, cmap, **kw):
        fig, ax = plt.subplots(figsize=(5, 5))
        im = ax.imshow(data, cmap=cmap, origin="upper", **kw)
        ax.set_title(title)
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.046)
        path = os.path.join(out_dir, name)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    if plots:
        vmax = max(float(inten[0].max()), 1e-30)
        for i in range(n_orders):
            figure(f"subring_order_{i}.png", inten[i],
                   f"subring order n={i}  (flux {inten[i].sum():.3e})",
                   "inferno", vmax=vmax * (1.0 if i == 0 else max(
                       inten[i].max() / vmax, 1e-6)))
        if _has(result, "evpa"):
            # EVPA ticks over each layer's intensity, the tick in (col,
            # row) components (sin chi, cos chi) x pitch weight
            evpa = np.asarray(result["evpa"])
            wgt = np.asarray(result["pol_weight"])
            for i in range(n_orders):
                dm = valid[i]
                if not dm.any():
                    continue
                ii, jj = np.nonzero(dm)
                fig, ax = plt.subplots(figsize=(5, 5))
                ax.imshow(inten[i], cmap="inferno", origin="upper",
                          vmax=max(float(inten[i].max()), 1e-30))
                ax.quiver(jj, ii, np.sin(evpa[i][dm]) * wgt[i][dm],
                          np.cos(evpa[i][dm]) * wgt[i][dm], color="white",
                          scale=28.0, headwidth=1, headlength=0,
                          headaxislength=0, pivot="middle", width=0.003)
                ax.set_title(f"order n={i} polarization (EVPA ticks)")
                ax.set_axis_off()
                path = os.path.join(out_dir, f"subring_evpa_{i}.png")
                fig.savefig(path, dpi=110, bbox_inches="tight")
                plt.close(fig)
                written.append(path)
        figure("crossing_count.png", count, "equatorial crossings per ray",
               "viridis")

    summary = subring_summary(result)

    if n_orders >= 2:
        dt, both = _delay_01(result)
        if plots:
            figure("subring_delay_01.png", np.where(both, dt, np.nan),
                   "subring delay t(n=0) - t(n=1)  [M]", "magma")
        r_em = np.asarray(result["r_em"], dtype=np.float64)
        ii, jj = np.nonzero(both)
        csv = os.path.join(out_dir, "subring_delay_01.csv")
        with open(csv, "w") as f:
            f.write("i,j,delay_M,g0,g1,r0,r1\n")
            for a, b in zip(ii, jj):
                f.write(f"{a},{b},{dt[a, b]:.9g},{g[0, a, b]:.9g},"
                        f"{g[1, a, b]:.9g},{r_em[0, a, b]:.9g},"
                        f"{r_em[1, a, b]:.9g}\n")
        written.append(csv)

    path = os.path.join(out_dir, "subring_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    written.append(path)
    return written, summary
