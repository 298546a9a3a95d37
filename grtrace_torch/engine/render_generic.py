"""Full-frame Kerr / Kerr-Newman rendering in the horizon-regular Cartesian
Kerr-Schild chart — the torch counterpart of `grtrace.engine.render_generic`
for metric='KerrSchild'.

Same scene layout as the Schwarzschild path (pinhole camera, boundary
sphere, background patch), with what the physics forces:
  * no equatorial fold (axisymmetry only): the Cartesian camera and full
    3-D integration, through kernel B5 on a CUDA device
    (engine/integrate_ks_cuda.py) or its eager twins on the CPU;
  * capture by the integration's outcome (the 1.05 r_+ shell and the exact
    Bardeen rescue), not the b_crit shortcut;
  * classification reuses engine.classify with beta = 0 and the shortcut
    disabled (alpha0 = pi).
The Boyer-Lindquist chart, the other metric families, antialiasing and
the trajectory sampler are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..physics.camera import camera_rays_cartesian
from ..physics.coords import cartesian_to_spherical
from ..physics.spacetime import horizon_radius, kerr_schild_g_inv
from . import classify as _classify
from .integrate import STATUS_CAPTURED
from .integrate_ks import integrate_dispatch_ks


def render_pixels_generic(bg_array, obs_x, fov, mass, spin, boundary_radius,
                          steps, delta, omega,
                          patch_center_theta, patch_center_phi,
                          patch_size_theta, patch_size_phi,
                          *, height, width, flip_theta=False, flip_phi=False,
                          has_background=True, dtype=torch.float32,
                          order=2, backend="auto", charge=0.0):
    """The device pipeline for one frame, on bg_array's device: camera ->
    integrate -> fold to (rho, theta, phi) -> classify -> RGB.

    Scalars are Python floats, rounded to `dtype` as 0-dim tensors on the
    device, as the JAX pipeline receives them.  Returns a dict of per-pixel
    tensors plus the (5,) count vector.
    """
    device = bg_array.device

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    obs_x_t = scalar(obs_x)
    zero = torch.zeros_like(obs_x_t)
    obs_pos = torch.stack([obs_x_t, zero, zero])
    q0, p0, alpha0 = camera_rays_cartesian(
        obs_pos, scalar(fov), height, width, params=params,
        g_inv_fn=kerr_schild_g_inv, dtype=dtype, device=device)

    n = height * width
    # float32 rays take the Kahan-compensated 32-row layout, float64 rays
    # the plain 16-row one; the scalars are rounded to dtype on the host
    final_q, final_p, status, n_steps = integrate_dispatch_ks(
        q0.reshape(n, 4), p0.reshape(n, 4), steps, float(delta),
        (float(mass), float(spin), float(charge)), float(boundary_radius),
        float(omega), order=order, backend=backend)
    final_q = final_q.reshape(height, width, 4)
    status = status.reshape(height, width)

    # classify in spherical terms, (t, x, y, z) -> (t, rho, theta, phi):
    # rho is the flat embedding radius the escape test used; captured rays
    # stop at the Kerr-Schild r_+, where rho can exceed the classifier's
    # capture threshold at high spin, so they are pinned to rho = 0
    rho, th, ph = cartesian_to_spherical(
        final_q[..., 1], final_q[..., 2], final_q[..., 3])
    rho = torch.where(status == STATUS_CAPTURED, torch.zeros_like(rho), rho)
    final_q = torch.stack([final_q[..., 0], rho, th, ph], dim=-1)

    # the radius test fires exactly at the integrator's 1.05 r_+ shell; the
    # analytic capture shortcut is off (alpha0 = pi); no fold (beta = 0)
    r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    rs_classify = (1.05 / 1.2) * r_plus
    beta0 = torch.zeros((height, width), dtype=dtype, device=device)
    alpha_off = torch.full((height, width), math.pi, dtype=dtype,
                           device=device)

    cls, th_csv, ph_csv, u01, v01 = _classify.classify_rays(
        final_q, alpha_off, beta0, rs=rs_classify, r_obs_x=obs_x_t,
        boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch_center_theta),
        patch_center_phi=scalar(patch_center_phi),
        patch_size_theta=scalar(patch_size_theta),
        patch_size_phi=scalar(patch_size_phi),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)

    image = _classify.composite(cls, u01, v01, bg_array)

    return {
        "image": image,
        "cls": cls,
        "final_q": final_q,
        "final_th": th_csv,
        "final_ph": ph_csv,
        "q0": q0,
        "p0": p0,
        "beta": beta0,
        "alpha0": alpha0,
        "n_steps": n_steps.reshape(height, width),
        "status": status,
        "count_vec": _classify.count_vector(cls),
    }


def render_generic(scene, *, bg_array=None, dtype=None, n_samples=None,
                   metrics=None, aa_samples=None, device="cuda"):
    """SceneConfig-driven Kerr / Kerr-Newman render in the Kerr-Schild
    chart -> engine.render.RenderResult.

    Spin and charge are the scene's.  device defaults to 'cuda'
    (kernel B5) and raises without a GPU; pass device='cpu' for the eager
    twins.  aa_samples and n_samples > 0 raise NotImplementedError.
    """
    from .render import RenderResult, _untimed

    if aa_samples:
        raise NotImplementedError(
            "adaptive antialiasing (engine/aa.py) is not ported to "
            "grtrace_torch yet (ROADMAP Queue A item 8)")
    n_samples = scene.n_samples if n_samples is None else n_samples
    if n_samples and n_samples > 0:
        raise NotImplementedError(
            "sampled trajectories on the Kerr path need the generic "
            "engine's trajectory sampler, not ported to grtrace_torch yet "
            "(ROADMAP Queue A item 5b); pass n_samples=0")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu' for the eager twins")
    spin, charge = float(scene.spin), float(scene.charge)

    stage = metrics.stage if metrics is not None else _untimed
    h, w = scene.image_size
    integ = scene.integrator
    if dtype is None:
        dtype = torch.float64 if integ.dtype == "float64" else torch.float32
    has_bg = bg_array is not None
    with stage("texture_upload"):
        bg_dev = (torch.as_tensor(np.asarray(bg_array), dtype=torch.uint8,
                                  device=device) if has_bg
                  else torch.zeros((1, 1, 3), dtype=torch.uint8,
                                   device=device))

    with stage("device_pipeline"):
        out = render_pixels_generic(
            bg_dev, scene.observer_distance, scene.fov, scene.bh_mass, spin,
            scene.boundary_radius, integ.steps, integ.delta,
            float(integ.omega),
            scene.patch.center_theta, scene.patch.center_phi,
            scene.patch.size_theta, scene.patch.size_phi,
            height=h, width=w,
            flip_theta=scene.patch.flip_theta,
            flip_phi=scene.patch.flip_phi,
            has_background=has_bg, dtype=dtype,
            order=integ.order, backend=integ.backend, charge=charge)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4]}
    if metrics is not None:  # costs one (H, W) reduction and fetch
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())
    # no heading on this path (unfolded chart)
    out["heading"] = torch.zeros((h, w, 3), dtype=dtype, device=device)
    return RenderResult(out, counts)
