"""Thin accretion disks around the static beyond-Kerr holes (Kottler,
Bardeen, Hayward) — the torch counterpart of `grtrace.engine.disk_static`.

The disk-tilt formulation: spherical symmetry makes the reference's
equatorial beta-fold exact, so every camera ray integrates in the folded
plane (theta = pi/2, p_theta = 0 up to rounding) of the static chart, and
the disk is tilted by the camera's elevation e instead of the camera
raised above it.  A fold-frame point at azimuth phi lies on the tilted
plane where the linear form

    u = c1 cos phi + c2 sin phi,   c1 = sin e,  c2 = sin(beta) cos e

changes sign, per-ray constants.  The first crossing inside [r_in, r_out]
freezes the ray with STATUS_DISK and records (hit_q, hit_p): q1 and the
momentum copy p2 lerped at t = u0 / (u0 - u1) (the lerp is JAX's, which
takes p2, not p1).  Rays exactly in the disk plane never cross it.  The
shading reads E = -p_t and L_n = p_phi cos(beta) cos(e) from the camera
covectors (Killing constants) and only the emission radius from the
crossing.

    integrate_disk_static_twin      the eager twin of kernel D1
                                    (csrc/fantasy_gen.cu, Mode::kDisk of
                                    Chart::kStatic)
    integrate_dispatch_disk_static  CUDA rays to D1, CPU rays to the twin
    render_disk_static              the SceneConfig-driven frame

A ray that never hits keeps zeros in its hit rows, as kernel B6 and its
twin do; JAX's while_loop leaves the camera's (q0, p0) there.  Every read
of the hit rows is masked by the hit, so no output differs.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..physics.camera import camera_rays_folded_static
from ..physics.hamiltonian import pack_state
from ..physics.spacetime import METRICS
from ..physics.static_metrics import STATIC_F, _as_params
from ..physics.static_orbits import (isco_static, osco_static,
                                     page_thorne_flux_static,
                                     redshift_factor_static)
from . import classify as _classify
from . import integrate_generic as _generic
from .disk import (CLS_DISK, _NT_TABLE_N, _interp, _temp_profile,
                   blackbody_rgb)
from .integrate import (_EXIT_CHECK, STATUS_ALIVE, STATUS_CAPTURED,
                        STATUS_ESCAPED)
from .integrate_generic import gen_params, split_params
from .integrate_ks import STATUS_DISK, _unit_grid
from .render import STATIC_NAMES

def disk_params(vec, r_in, r_out):
    """D1's scalar vector: the static chart's gen_params vector followed
    by r_in and r_out, rounded to its dtype."""
    tail = torch.tensor([float(r_in), float(r_out)], dtype=vec.dtype)
    return torch.cat([vec, tail])


def integrate_disk_static_twin(q0s, p0s, disk, steps, vec, metric, r_in,
                               r_out):
    """The loop of kernel D1 on (N, 4) folded rays from a static chart's
    gen_params vector; disk (N, 2) the plane constants (c1, c2), r_in and
    r_out floats in the rays' dtype.  Per step, JAX's
    integrate_batch_disk_static: the masked, guarded G1s step of the rays
    that are active and not hit, then the sign test of u at the pre- and
    post-step q1 and the lerp of q1 and p2.  Returns (state, ns, hit,
    hit_q, hit_p), ns negated for guard-parked rays."""
    # through the module, so that a caller may wrap the factory (the step
    # replayed from a CUDA graph, as chip_smoke.py does)
    active, opening, step = _generic.make_generic_step(metric, vec)
    n = q0s.shape[0]
    c1, c2 = disk[:, 0], disk[:, 1]
    state = pack_state(q0s, p0s)
    ka = opening(state)
    ns = torch.zeros((n,), dtype=torch.int32, device=q0s.device)
    hit = torch.zeros((n,), dtype=torch.bool, device=q0s.device)
    hq = torch.zeros((n, 4), dtype=q0s.dtype, device=q0s.device)
    hp = torch.zeros_like(hq)

    def u_form(ph):
        return c1 * torch.cos(ph) + c2 * torch.sin(ph)

    for k in range(steps):
        act = active(state) & ~hit
        if k % _EXIT_CHECK == 0 and not bool(act.any()):
            break
        bad, new, ka = step(state, ka)
        u0, u1 = u_form(state[3]), u_form(new[3])
        crossed = (u0 * u1) < 0.0
        t = torch.where(crossed, u0 / (u0 - u1), 0.0)
        cq = torch.stack([state[m] + t * (new[m] - state[m])
                          for m in range(4)], dim=-1)
        cp = torch.stack([state[12 + m] + t * (new[12 + m] - state[12 + m])
                          for m in range(4)], dim=-1)
        r_hit = cq[:, 1]
        new_hit = act & ~bad & crossed & (r_hit >= r_in) & (r_hit <= r_out)
        hq = torch.where(new_hit[:, None], cq, hq)
        hp = torch.where(new_hit[:, None], cp, hp)
        hit = hit | new_hit
        ns = ns + act.to(torch.int32)
        ns = torch.where(act & bad, -ns, ns)
        state = tuple(torch.where(act, nw, o) for nw, o in zip(new, state))
    return state, ns, hit, hq, hp


def _finish(q1, p1, ns, hit, hq, hp, vec):
    """(final_q, final_p, status, n_steps, hit_q, hit_p): JAX's read-out."""
    (_, _, _, r_cap, r_max, *_), _ = split_params(vec)
    status = torch.where(
        q1[:, 1] <= r_cap, STATUS_CAPTURED,
        torch.where(q1[:, 1] >= r_max, STATUS_ESCAPED, STATUS_ALIVE))
    status = torch.where(hit, STATUS_DISK, status)
    return q1, p1, status, torch.abs(ns), hq, hp


def integrate_batch_disk_static(q0s, p0s, c1, c2, steps, delta, params,
                                r_max, omega, r_in, r_out, order=2,
                                metric="Bardeen"):
    """The CPU path of JAX's integrate_batch_disk_static: the eager twin of
    D1.  Returns (final_q, final_p, status, n_steps, hit_q, hit_p)."""
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    tail = disk_params(vec, r_in, r_out)[-2:].tolist()
    disk = torch.stack([c1, c2], dim=-1)
    state, ns, hit, hq, hp = integrate_disk_static_twin(
        q0s, p0s, disk, steps, vec, metric, tail[0], tail[1])
    return _finish(torch.stack(state[0:4], dim=-1),
                   torch.stack(state[4:8], dim=-1), ns, hit, hq, hp, vec)


def integrate_dispatch_disk_static(q0s, p0s, c1, c2, steps, delta, params,
                                   r_max, omega, r_in, r_out, order=2,
                                   metric="Bardeen"):
    """integrate_batch_disk_static on the rays' device: CUDA rays go to
    kernel D1, CPU rays to its twin; any other device raises.  Never falls
    back."""
    kind = q0s.device.type
    if kind == "cpu":
        return integrate_batch_disk_static(q0s, p0s, c1, c2, steps, delta,
                                           params, r_max, omega, r_in, r_out,
                                           order=order, metric=metric)
    if kind != "cuda":
        raise ValueError(f"no disk integrator for {kind!r} tensors (CUDA "
                         f"runs kernel D1, the CPU its eager twin)")
    from .integrate_generic_cuda import launch_fantasy_gen_disk
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    disk = torch.stack([c1, c2], dim=-1).contiguous()
    out, ns, hit = launch_fantasy_gen_disk(q0s, p0s, disk,
                                           disk_params(vec, r_in, r_out),
                                           steps)
    return _finish(out[0:4].T, out[4:8].T, ns, hit, out[8:12].T,
                   out[12:16].T, vec)


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def _nt_temp_table_static(r_in, r_out, f_fn, params, prograde, dtype):
    """Peak-normalized Novikov-Thorne temperature table of a static
    family (static_orbits.page_thorne_flux_static) on JAX's geometric
    grid."""
    lo = r_in * (1.0 + 1e-5)
    u = _unit_grid(_NT_TABLE_N, dtype, lo.device)
    r_grid = lo * (r_out / lo) ** u
    t = page_thorne_flux_static(r_grid, f_fn, params, prograde) ** 0.25
    return r_grid, t / torch.clamp(torch.max(t), min=1e-30)


def shade_disk_static(hit_q, p0_flat, ln_scale, f_fn, params, r_obs, r_in, *,
                      prograde=True, t_peak=9000.0, exposure=2.5,
                      profile="shakura", r_out=14.0):
    """(N, 4) folded crossings -> (g, rgb01): I_obs = g^4 I_em, the
    blackbody colour at g T_em(r), tone-mapped; E = -p_t and L_n = p_phi
    ln_scale from the camera covectors, r_em from the crossing."""
    energy = -p0_flat[:, 0]
    l_n = p0_flat[:, 3] * ln_scale
    r_em = hit_q[:, 1]
    g = redshift_factor_static(energy, l_n, r_em, r_obs, f_fn, params,
                               prograde)
    if profile == "novikov":
        r_grid, t_tab = _nt_temp_table_static(
            r_in, torch.as_tensor(r_out, dtype=r_em.dtype,
                                  device=r_em.device),
            f_fn, params, prograde, r_em.dtype)
        t_norm = _interp(r_em, r_grid, t_tab)
    else:
        t_norm = _temp_profile(r_em, r_in)
    t_obs = g * t_norm
    intensity = exposure * t_obs ** 4
    tone = (1.0 - torch.exp(-intensity)) ** (1.0 / 2.2)
    rgb = blackbody_rgb(t_obs * t_peak) * tone[:, None]
    return g, rgb


# ---------------------------------------------------------------------------
# Full-frame render
# ---------------------------------------------------------------------------

def render_pixels_disk_static(bg_array, obs_x, fov, mass, metric_param,
                              boundary_radius, steps, delta, omega,
                              r_in, r_out, t_peak, exposure, elevation,
                              patch_center_theta, patch_center_phi,
                              patch_size_theta, patch_size_phi,
                              *, height, width, order=2, flip_theta=False,
                              flip_phi=False, has_background=True,
                              dtype=torch.float32, prograde=True,
                              profile="shakura", metric="Bardeen"):
    """One frame on bg_array's device: the folded camera -> D1 (its twin
    on the CPU) -> shade + classify -> RGB.  `elevation` is the camera's
    angle above the disk plane in radians (the disk is tilted).  Scalars
    are Python floats, rounded to `dtype` on the device as JAX receives
    them.  Returns JAX's dict of per-pixel tensors and the (6,) count
    vector."""
    device = bg_array.device

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    f_fn = STATIC_F[metric]
    params = torch.stack([scalar(mass), scalar(metric_param), scalar(0.0)])
    obs_x_t = scalar(obs_x)
    zero = torch.zeros_like(obs_x_t)
    obs_pos = torch.stack([obs_x_t, zero, zero])
    q0, p0, alpha0, beta_fold = camera_rays_folded_static(
        obs_pos, scalar(fov), height, width, params=params,
        g_inv_fn=METRICS[metric], dtype=dtype, device=device)

    elev = scalar(elevation)
    c1 = torch.sin(elev).expand(beta_fold.shape).reshape(-1)
    c2 = (torch.sin(beta_fold) * torch.cos(elev)).reshape(-1)
    ln_scale = (torch.cos(beta_fold) * torch.cos(elev)).reshape(-1)

    n = height * width
    q0f, p0f = q0.reshape(n, 4).contiguous(), p0.reshape(n, 4).contiguous()
    final_q, _, status, n_steps, hit_q, hit_p = \
        integrate_dispatch_disk_static(
            q0f, p0f, c1.contiguous(), c2.contiguous(), steps, float(delta),
            (float(mass), float(metric_param), 0.0), float(boundary_radius),
            float(omega), float(r_in), float(r_out), order=order,
            metric=metric)

    disk_mask = status == STATUS_DISK
    g_fac, disk_rgb01 = shade_disk_static(
        hit_q, p0f, ln_scale, f_fn, params, obs_x_t, scalar(r_in),
        prograde=prograde, t_peak=t_peak, exposure=exposure,
        profile=profile, r_out=r_out)
    g_fac = torch.where(disk_mask, g_fac, 0.0)

    # the classification tail of render_pixels_generic's static branch
    from .render_generic import classify_radius
    rs_classify = classify_radius(metric, params)
    fq = final_q.reshape(height, width, 4)
    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        fq, torch.full((height, width), math.pi, dtype=dtype, device=device),
        beta_fold, rs=rs_classify, r_obs_x=obs_x_t,
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
        "final_ph": ph_csv, "q0": q0, "p0": p0, "beta": beta_fold,
        "alpha0": alpha0, "n_steps": n_steps.reshape(height, width),
        "status": status.reshape(height, width),
        "hit_q": hit_q.reshape(height, width, 4),
        "hit_p": hit_p.reshape(height, width, 4),
        "redshift": g_fac.reshape(height, width), "count_vec": count_vec,
    }


@functools.lru_cache(maxsize=64)
def static_disk_bounds(metric, mass, metric_param, r_in, r_out,
                       boundary_radius, prograde=True):
    """Host-side disk edges for a static family, JAX's checks: r_in = None
    -> the ISCO (static_orbits.isco_static; ValueError where there is
    none); Kottler's r_out must lie inside the outermost stable circular
    orbit; r_in < r_out < boundary_radius.  Returns (r_in, r_out) as
    floats; memoized (the ISCO's scan and bisections cost host time that
    every render of a scene would repeat)."""
    f_fn = STATIC_F[metric]
    params = _as_params([mass, metric_param, 0.0])
    if r_in is None:
        r_in = float(isco_static(f_fn, params))
        if not np.isfinite(r_in):
            raise ValueError(
                f"{metric} with parameter {metric_param:g} has no stable "
                "circular orbits — no ISCO to anchor the disk; pass an "
                "explicit r_in")
    if metric == "Kottler" and metric_param > 0.0:
        static_r = (3.0 * mass / metric_param) ** (1.0 / 3.0)
        r_osco = float(osco_static(f_fn, params, r_hi=0.98 * static_r))
        if np.isfinite(r_osco) and r_out > r_osco:
            raise ValueError(
                f"Kottler disk outer edge r_out = {r_out:g} lies beyond "
                f"the outermost stable circular orbit {r_osco:.4g} (the "
                "cosmological tide destabilizes Keplerian emitters there) "
                "— shrink r_out or Lambda")
    if not r_in < r_out:
        raise ValueError(f"disk edges must satisfy r_in < r_out, got "
                         f"[{r_in:g}, {r_out:g}]")
    if r_out >= boundary_radius:
        raise ValueError(f"disk outer edge {r_out:g} must sit inside the "
                         f"boundary sphere {boundary_radius:g}")
    return float(r_in), float(r_out)


def render_disk_static(scene, disk=None, *, bg_array=None, dtype=None,
                       metrics=None, device="cuda"):
    """SceneConfig-driven static-family disk frame -> RenderResult, JAX's
    render_disk_static: scene.metric 'kottler' / 'sds', 'bardeen' or
    'hayward' with scene.metric_param; `disk` the DiskConfig of
    engine/disk.py (bfield and camera_omega raise, as in JAX).  The counts
    carry 'disk'; result.device('redshift') is g on disk pixels.  device
    defaults to 'cuda' (kernel D1) and raises without a GPU; pass
    device='cpu' for the eager twin."""
    from .disk import DiskConfig
    from .render import RenderResult, _untimed

    disk = disk or DiskConfig()
    if disk.bfield is not None:
        raise NotImplementedError(
            "polarized imaging (DiskConfig.bfield) is implemented on the "
            "Kerr-Schild disk path (engine.disk) — use metric "
            "'schwarzschild'/'kerr' for EVPA maps")
    if disk.camera_omega is not None:
        raise NotImplementedError(
            "orbiting cameras (DiskConfig.camera_omega) ride the "
            "Kerr-Schild disk path (engine.disk)")
    metric = STATIC_NAMES[scene.metric.lower()]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_disk_static(device='cuda') needs a CUDA "
                           "GPU; pass device='cpu' for the eager twin")
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
    r_in, r_out = static_disk_bounds(
        metric, scene.bh_mass, scene.metric_param, disk.r_in, disk.r_out,
        scene.boundary_radius, disk.prograde)
    with stage("device_pipeline"):
        out = render_pixels_disk_static(
            bg_dev, scene.observer_distance, scene.fov, scene.bh_mass,
            scene.metric_param, scene.boundary_radius, integ.steps,
            integ.delta, float(integ.omega), r_in, r_out, disk.t_peak,
            disk.exposure, math.radians(disk.elevation_deg),
            scene.patch.center_theta, scene.patch.center_phi,
            scene.patch.size_theta, scene.patch.size_phi,
            height=h, width=w, order=integ.order,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi, has_background=has_bg,
            dtype=dtype, prograde=disk.prograde, profile=disk.profile,
            metric=metric)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4], "disk": cv[5]}
    if metrics is not None:
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())
    out["heading"] = torch.zeros((h, w, 3), dtype=dtype, device=device)
    return RenderResult(out, counts)
