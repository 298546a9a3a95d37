"""Full-frame Kerr / Kerr-Newman and beyond-Kerr rendering — the torch
counterpart of `grtrace.engine.render_generic`: metric 'KerrSchild' (the
horizon-regular Cartesian chart), metric 'Kerr' (Boyer-Lindquist), the
static families 'Kottler', 'Bardeen', 'Hayward' (the family's parameter in
the spin slot, charge 0), the rotating regular families
'RotatingBardeen', 'RotatingHayward' (the spin, and the family's parameter
in the charge slot), and Kerr-de Sitter 'KerrDS' (the spin, and Lambda in
the charge slot).

Same scene layout as the Schwarzschild path (pinhole camera, boundary
sphere, background patch), with what the physics forces:
  * no equatorial fold for Kerr (axisymmetry only): full 3-D integration,
    with the Cartesian camera through kernel B5 (engine/integrate_ks_cuda.py)
    in the Kerr-Schild chart, with the unfolded spherical camera through
    kernel G1 (engine/integrate_generic_cuda.py) in the Boyer-Lindquist
    one; the static families keep the reference's beta-fold (exact under
    spherical symmetry: physics/camera.py's camera_rays_folded_static)
    and run kernel G1s; the rotating regular families take the Cartesian
    camera with their own g_inv and run kernel G1r (the mass-function
    Kerr-Schild chart); Kerr-de Sitter takes the unfolded spherical camera
    and runs kernel G1d (the Carter chart); their eager twins on the CPU;
  * capture by the integration's outcome (the capture shell and the exact
    Bardeen rescue), not the b_crit shortcut;
  * classification reuses engine.classify with the shortcut disabled
    (alpha0 = pi), with beta = 0, or the static families' fold angles,
    which un-fold the exit angles, and the capture shell 1.1 x the bisected
    outer horizon (or the horizonless floor) for the static families and
    Kerr-de Sitter, 1.05 x it for the rotating ones.
The sampled trajectories run through kernel S2 (S2s, S2r, S2d; its twin on
the CPU) and are rotated back by their beta, and the adaptive antialiasing
pass (engine/aa.py) through B5, G1, G1s, G1r or G1d again.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..physics.camera import (camera_rays_cartesian,
                              camera_rays_folded_static,
                              camera_rays_unfolded)
from ..physics.coords import cartesian_to_spherical
from ..physics.kerr_de_sitter import kds_capture_radius
from ..physics.rotating_regular import MASS_FN, rotating_capture_radius
from ..physics.spacetime import COORDS, METRICS, horizon_radius
from ..physics.static_metrics import STATIC_F, static_capture_radius
from . import classify as _classify
from .integrate import STATUS_CAPTURED
from .integrate_generic import (integrate_dispatch_generic,
                                trajectory_dispatch_generic)


def render_pixels_generic(bg_array, obs_x, fov, mass, spin, boundary_radius,
                          steps, delta, omega,
                          patch_center_theta, patch_center_phi,
                          patch_size_theta, patch_size_phi,
                          *, height, width, flip_theta=False, flip_phi=False,
                          has_background=True, dtype=torch.float32,
                          metric="Kerr", order=2, backend="auto", charge=0.0):
    """The device pipeline for one frame, on bg_array's device: camera ->
    integrate -> (Kerr-Schild: fold to (rho, theta, phi)) -> classify ->
    RGB.

    Scalars are Python floats, rounded to `dtype` as 0-dim tensors on the
    device, as the JAX pipeline receives them.  Returns a dict of per-pixel
    tensors plus the (5,) count vector.
    """
    device = bg_array.device
    cartesian = COORDS[metric] == "cartesian"

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    obs_x_t = scalar(obs_x)
    zero = torch.zeros_like(obs_x_t)
    obs_pos = torch.stack([obs_x_t, zero, zero])
    static = metric in STATIC_F
    beta_fold = None
    if static:
        # spherically symmetric: the reference's beta-fold is exact
        q0, p0, alpha0, beta_fold = camera_rays_folded_static(
            obs_pos, scalar(fov), height, width, params=params,
            g_inv_fn=METRICS[metric], dtype=dtype, device=device)
    else:
        camera = camera_rays_cartesian if cartesian else camera_rays_unfolded
        q0, p0, alpha0 = camera(obs_pos, scalar(fov), height, width,
                                params=params, g_inv_fn=METRICS[metric],
                                dtype=dtype, device=device)

    n = height * width
    # Kerr-Schild: float32 rays take B5's Kahan-compensated 32-row layout,
    # float64 rays the plain 16-row one; Boyer-Lindquist: G1; the static
    # chart: G1s (the scalars are rounded to dtype on the host)
    final_q, final_p, status, n_steps = integrate_dispatch_generic(
        q0.reshape(n, 4), p0.reshape(n, 4), steps, float(delta),
        (float(mass), float(spin), float(charge)), float(boundary_radius),
        float(omega), order=order, metric=metric, backend=backend)
    final_q = final_q.reshape(height, width, 4)
    status = status.reshape(height, width)

    if cartesian:
        # classify in spherical terms, (t, x, y, z) -> (t, rho, theta,
        # phi): rho is the flat embedding radius the escape test used;
        # captured rays stop at the Kerr-Schild r_+, where rho can exceed
        # the classifier's capture threshold at high spin, so they are
        # pinned to rho = 0
        rho, th, ph = cartesian_to_spherical(
            final_q[..., 1], final_q[..., 2], final_q[..., 3])
        rho = torch.where(status == STATUS_CAPTURED, torch.zeros_like(rho),
                          rho)
        final_q = torch.stack([final_q[..., 0], rho, th, ph], dim=-1)

    # the radius test fires exactly at the integrator's capture shell (1.1
    # r_+ in Boyer-Lindquist and the static chart, 1.05 r_+ in
    # Kerr-Schild); the analytic capture shortcut is off (alpha0 = pi); no
    # fold (beta = 0) but the static families' own
    rs_classify = classify_radius(metric, params)
    beta0 = (beta_fold if static
             else torch.zeros((height, width), dtype=dtype, device=device))
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


def classify_radius(metric, params):
    """The classifier's rs for the generic render: (shell / 1.2) r_+ with
    the integrator's capture shell, 1.05 r_+ (Kerr-Schild) or 1.1 r_+
    (Boyer-Lindquist; for the static families r_+ = static_capture_radius
    / 1.1, a float64 tensor on params' device, as JAX's x64 bisection
    gives it; for the rotating families rotating_capture_radius / 1.05 and
    for Kerr-de Sitter kds_capture_radius / 1.1, in params' dtype, as JAX's
    bisection in that dtype gives it)."""
    if metric in STATIC_F:
        r_plus = static_capture_radius(metric, params[:2].cpu()) / 1.1
        return ((1.1 / 1.2) * r_plus).to(params.device)
    if metric in MASS_FN:
        r_plus = rotating_capture_radius(metric, params).to(
            dtype=params.dtype, device=params.device) / 1.05
        return (1.05 / 1.2) * r_plus
    if metric == "KerrDS":
        r_plus = kds_capture_radius(params).to(
            dtype=params.dtype, device=params.device) / 1.1
        return (1.1 / 1.2) * r_plus
    r_plus = horizon_radius("Kerr", params[0], params[1], params[2])
    return ((1.05 if COORDS[metric] == "cartesian" else 1.1) / 1.2) * r_plus


def _sample_trajectories_generic(q0, p0, sampled_ij, scene, spin, metric,
                                 dtype, charge=0.0, beta=None):
    """Re-integrate K sampled rays with decimated trajectory capture (kernel
    S2 on the card, its eager twin on the CPU:
    `trajectory_dispatch_generic`): K (P, 3) float64 numpy arrays of
    Cartesian positions, on the host.  Kerr-Schild rows are Cartesian
    already; Boyer-Lindquist and static rows go through
    spherical_to_cartesian and the rotation by the ray's beta (0 for the
    unfolded camera, the fold angle for the static families:
    `trajectories_to_cartesian`), as JAX converts them."""
    from .render import MAX_TRAJ_POINTS, trajectories_to_cartesian
    h, w = scene.image_size
    flat_idx = torch.as_tensor(sampled_ij[:, 0] * w + sampled_ij[:, 1],
                               device=q0.device)
    integ = scene.integrator
    traj = trajectory_dispatch_generic(
        q0.reshape(-1, 4)[flat_idx].to(dtype).contiguous(),
        p0.reshape(-1, 4)[flat_idx].to(dtype).contiguous(), integ.steps,
        integ.delta, (scene.bh_mass, spin, charge), scene.boundary_radius,
        float(integ.omega), order=integ.order, metric=metric,
        n_keep=min(MAX_TRAJ_POINTS, integ.steps))
    if COORDS[metric] == "cartesian":
        traj = traj.cpu().double()
        return [traj[k, :, 1:4].numpy() for k in range(traj.shape[0])]
    betas = (torch.zeros(traj.shape[0], dtype=torch.float64) if beta is None
             else beta.reshape(-1)[flat_idx].cpu().double())
    return trajectories_to_cartesian(traj, betas)


def render_generic(scene, *, spin=None, metric="Kerr", bg_array=None,
                   dtype=None, n_samples=None, seed=0, metrics=None,
                   charge=None, aa_samples=None, device="cuda"):
    """SceneConfig-driven Kerr / Kerr-Newman render in the named chart
    ('Kerr' = Boyer-Lindquist, 'KerrSchild') -> engine.render.RenderResult,
    with the sampled trajectories (scene.n_samples, or n_samples, rays
    drawn with numpy's default_rng(seed), as the JAX render draws them).

    spin and charge default to the scene's.  device defaults to 'cuda'
    (kernels B5, G1 or G1s, and S2 or S2s) and raises without a GPU; pass
    device='cpu' for the eager twins.  aa_samples = s (>= 2) runs the
    adaptive edge-refinement pass (engine/aa.py: the sub-rays through B5,
    G1, G1s or G1r).  For the static families ('Kottler', 'Bardeen',
    'Hayward') `spin` carries the family parameter and charge is 0; for
    the rotating ones ('RotatingBardeen', 'RotatingHayward') `charge`
    carries it, for Kerr-de Sitter ('KerrDS') Lambda.
    Prefer the top-level render, which routes scene.metric to the right
    chart.
    """
    from .render import RenderResult, _untimed

    METRICS[metric]  # a KeyError for an unknown metric
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu' for the eager twins")
    spin = float(scene.spin if spin is None else spin)
    charge = float(scene.charge if charge is None else charge)

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
            has_background=has_bg, dtype=dtype, metric=metric,
            order=integ.order, backend=integ.backend, charge=charge)
        if aa_samples:
            from .aa import refine_edges_generic
            with stage("device_pipeline/aa"):
                out["image"], out["aa_mask"] = refine_edges_generic(
                    out["cls"], out["image"], bg_dev,
                    scene.observer_distance, scene.fov, scene.bh_mass, spin,
                    charge, scene.boundary_radius, integ.steps, integ.delta,
                    float(integ.omega),
                    scene.patch.center_theta, scene.patch.center_phi,
                    scene.patch.size_theta, scene.patch.size_phi,
                    height=h, width=w, samples=int(aa_samples),
                    metric=metric, order=integ.order,
                    backend=integ.backend,
                    flip_theta=scene.patch.flip_theta,
                    flip_phi=scene.patch.flip_phi,
                    has_background=has_bg, dtype=dtype, stage=stage)
        cv = out.pop("count_vec").tolist()  # the one host fetch
    counts = {"captured": cv[0], "in_domain": cv[1], "escaped": cv[2],
              "background": cv[3], "numerical_error": cv[4]}
    if metrics is not None:  # costs one (H, W) reduction and fetch
        metrics.rays = h * w
        metrics.geodesic_steps = int(out["n_steps"].sum())
    # no heading on this path
    out["heading"] = torch.zeros((h, w, 3), dtype=dtype, device=device)

    n_samples = scene.n_samples if n_samples is None else n_samples
    sampled_ij = None
    sampled_trajs = None
    if n_samples and n_samples > 0:
        with stage("sample_trajectories"):
            rng = np.random.default_rng(seed)
            flat = rng.choice(h * w, size=min(n_samples, h * w),
                              replace=False)
            sampled_ij = np.stack([flat // w, flat % w], axis=-1)
            sampled_trajs = _sample_trajectories_generic(
                out["q0"], out["p0"], sampled_ij, scene, spin, metric, dtype,
                charge=charge, beta=out["beta"] if metric in STATIC_F
                else None)
    return RenderResult(out, counts, sampled_indices=sampled_ij,
                        sampled_trajectories=sampled_trajs)
