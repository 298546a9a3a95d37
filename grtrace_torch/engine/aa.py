"""Adaptive shadow-edge antialiasing: sub-pixel rays only where they matter
— the torch counterpart of `grtrace.engine.aa`.

The shadow boundary, photon ring and patch seams are the only places a
geodesic render aliases; everywhere else the ray bundle is smooth at pixel
scale.  Each pass

  1. scores every pixel by how many of its 4 neighbours classify
     differently (`edge_scores`),
  2. picks the top k_edge pixels by score (`_select_edges`: a stable
     descending sort, so ties go to the lower index as under JAX's
     `lax.top_k`),
  3. re-traces s^2 stratified sub-rays for each pick with a score above
     zero through the base render's own camera -> integrate -> classify ->
     composite chain, and
  4. averages the sub-colours and scatters them back into the image.

The JAX pass traces all k_edge * s^2 sub-rays (XLA needs static shapes)
and then discards the colours of the zero-score picks; this one traces
only the picks that score, at the cost of one host read of their count.
The image and `aa_mask` are the same.

The passes go through the port's dispatchers, so on a CUDA device each is
one more launch of the base render's kernel on the sub-rays:
`refine_edges_schwarzschild` B1 (float32) or B2 (float64),
`refine_edges_generic` B5 (Kerr-Schild) or G1 (Boyer-Lindquist),
`refine_edges_disk` B6 and `refine_subrings` B7.  With s = 2 a sub-ray
sits at the image-plane position of a pixel of the 2H x 2W frame, bit for
bit (physics/camera.py), so a refined pixel is that frame's 2 x 2 block
averaged.  The class map, the counts and the CSV fields keep the centre
sample: antialiasing touches the displayed colours (and, for the subrings,
the per-order intensities) only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..physics.camera import (boosted_ics_from_pixels,
                              cartesian_ics_from_pixels,
                              folded_ics_from_pixels_static,
                              initial_conditions,
                              pixel_positions_fractional,
                              pixel_positions_fractional_lookat,
                              unfolded_ics_from_pixels)
from ..physics.coords import cartesian_to_spherical
from ..physics.spacetime import (COORDS, METRICS, horizon_radius,
                                 kerr_schild_g_inv, ks_radius)
from ..physics.static_metrics import STATIC_F
from . import classify as _classify
from .integrate import STATUS_CAPTURED, integrate_dispatch
from .integrate_generic import integrate_dispatch_generic
from .render_generic import classify_radius
from .render import _untimed

# the timed part of a pass, nested in the render's device_pipeline stage
INTEGRATE_STAGE = "device_pipeline/aa/integrate"


def edge_scores(cls):
    """(H, W) int32: how many of the 4 neighbours classify differently
    (edge-replicated at the frame border)."""
    left = torch.cat([cls[:, :1], cls[:, :-1]], dim=1)
    right = torch.cat([cls[:, 1:], cls[:, -1:]], dim=1)
    up = torch.cat([cls[:1], cls[:-1]], dim=0)
    down = torch.cat([cls[1:], cls[-1:]], dim=0)
    return ((left != cls).to(torch.int32) + (right != cls).to(torch.int32)
            + (up != cls).to(torch.int32) + (down != cls).to(torch.int32))


def default_k_edge(height, width):
    """The pick budget: an eighth of the frame, a multiple of 256 —
    comfortably above any real boundary length (O(perimeter))."""
    return int(min(height * width,
                   max(256, -(-(height * width // 8) // 256) * 256)))


def _select_edges(cls, k_edge):
    """Flat indices of the top-k_edge pixels by edge score that score
    above zero, highest score first and, among equal scores, lower index
    first (JAX's top_k order).  Reads their count on the host."""
    score = edge_scores(cls).reshape(-1)
    vals, order = torch.sort(score, descending=True, stable=True)
    n = int((vals[:k_edge] > 0).sum())
    return order[:n]


def _subpixel_indices(idx, width, samples, dtype):
    """(K,) flat pixel indices -> (K * s^2,) stratified fractional (i, j),
    sub-ray k * s^2 + a * s + b at (i + off[a], j + off[b])."""
    ii = torch.div(idx, width, rounding_mode="floor").to(dtype)
    jj = torch.remainder(idx, width).to(dtype)
    # built on the host in the ray dtype, so every device gets the same
    # offsets (a CUDA division by a Python scalar multiplies by its
    # reciprocal)
    off = ((torch.arange(samples, dtype=dtype) + 0.5) / samples
           - 0.5).to(idx.device)
    oi = off.repeat_interleave(samples)
    oj = off.repeat(samples)
    return ((ii[:, None] + oi[None, :]).reshape(-1),
            (jj[:, None] + oj[None, :]).reshape(-1))


def _scatter_averaged(image, idx, colors, samples):
    """Mean the s^2 sub-colours per refined pixel (float32, + 0.5,
    clipped) into a copy of the image; returns (image, aa_mask)."""
    height, width = image.shape[:2]
    avg = colors.reshape(-1, samples * samples, 3).to(torch.float32).mean(1)
    flat = image.reshape(-1, 3).clone()
    flat[idx] = torch.clamp(avg + 0.5, 0.0, 255.0).to(torch.uint8)
    mask = torch.zeros(height * width, dtype=torch.bool, device=idx.device)
    mask[idx] = True
    return flat.reshape(height, width, 3), mask.reshape(height, width)


def _unrefined(image):
    return image, torch.zeros(image.shape[:2], dtype=torch.bool,
                              device=image.device)


def _scalars(dtype, device):
    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)
    return scalar


def refine_edges_schwarzschild(cls, image, bg_array, obs_x, fov, mass,
                               boundary_radius, steps, delta, omega,
                               patch_center_theta, patch_center_phi,
                               patch_size_theta, patch_size_phi,
                               *, height, width, samples=2,
                               order=2, backend="auto", flip_theta=False,
                               flip_phi=False, has_background=True,
                               dtype=torch.float32, stage=_untimed):
    """The headline path's pass: sub-rays through the folded equatorial
    camera and render.render_pixels' chain (integrate_dispatch with
    equatorial=True: B1 for float32, B2 for float64 on the card; the
    b_crit shortcut in the classifier).  Scalars are Python floats, as
    render_pixels takes them.  Returns (image, aa_mask)."""
    idx = _select_edges(cls, default_k_edge(height, width))
    if idx.numel() == 0:
        return _unrefined(image)
    device = cls.device
    scalar = _scalars(dtype, device)
    obs_x_t, mass_t = scalar(obs_x), scalar(mass)
    zero = torch.zeros_like(obs_x_t)
    obs_pos = torch.stack([obs_x_t, zero, zero])
    i_f, j_f = _subpixel_indices(idx, width, samples, dtype)
    pix = pixel_positions_fractional(obs_pos, scalar(fov), height, width,
                                     i_f, j_f, dtype=dtype)
    q0, p0, alpha0, _, beta = initial_conditions(obs_pos, pix,
                                                 mass_bh=mass_t)
    with stage(INTEGRATE_STAGE):
        final_q, _, _, _ = integrate_dispatch(
            q0, p0, steps, float(delta), 2.0 * float(mass),
            float(boundary_radius), float(omega), backend=backend,
            equatorial=True, order=order)
    sub_cls, _, _, u01, v01 = _classify.classify_rays(
        final_q, alpha0, beta, rs=2.0 * mass_t, r_obs_x=obs_x_t,
        boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch_center_theta),
        patch_center_phi=scalar(patch_center_phi),
        patch_size_theta=scalar(patch_size_theta),
        patch_size_phi=scalar(patch_size_phi),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    colors = _classify.composite(sub_cls, u01, v01, bg_array)
    return _scatter_averaged(image, idx, colors, samples)


def refine_edges_generic(cls, image, bg_array, obs_x, fov, mass, spin,
                         charge, boundary_radius, steps, delta, omega,
                         patch_center_theta, patch_center_phi,
                         patch_size_theta, patch_size_phi,
                         *, height, width, samples=2,
                         metric="KerrSchild", order=2, backend="auto",
                         flip_theta=False, flip_phi=False,
                         has_background=True, dtype=torch.float32,
                         stage=_untimed):
    """The generic engine's pass: sub-rays through render_generic's camera
    (Cartesian in the Kerr-Schild chart, unfolded spherical in the
    Boyer-Lindquist one, folded for the static families, whose fold angles
    un-fold the sub-rays' exit angles) and its chain
    (integrate_dispatch_generic: B5, G1 with the Boyer-Lindquist rescue,
    G1s, or G1r with the rotating families' rescue on the card; the
    rs_classify shell, no b_crit shortcut).  The rotating regular
    families take the Cartesian camera with their own g_inv, Kerr-de
    Sitter the unfolded spherical one and G1d.  Kerr-de Sitter's sub-rays
    are classified, as JAX's pass classifies them, at the Kerr-Newman
    horizon with Lambda in the charge slot, not at the render's capture
    surface (ROADMAP Queue C).
    Returns (image, aa_mask)."""
    g_inv_fn = METRICS[metric]
    cartesian = COORDS[metric] == "cartesian"
    idx = _select_edges(cls, default_k_edge(height, width))
    if idx.numel() == 0:
        return _unrefined(image)
    device = cls.device
    scalar = _scalars(dtype, device)
    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    obs_x_t = scalar(obs_x)
    zero = torch.zeros_like(obs_x_t)
    obs_pos = torch.stack([obs_x_t, zero, zero])
    i_f, j_f = _subpixel_indices(idx, width, samples, dtype)
    pix = pixel_positions_fractional(obs_pos, scalar(fov), height, width,
                                     i_f, j_f, dtype=dtype)
    beta = None
    if metric in STATIC_F:
        q0, p0, _, beta = folded_ics_from_pixels_static(
            obs_pos, pix, params=params, g_inv_fn=g_inv_fn)
    else:
        camera = cartesian_ics_from_pixels if cartesian \
            else unfolded_ics_from_pixels
        q0, p0, _ = camera(obs_pos, pix, params=params, g_inv_fn=g_inv_fn)
    with stage(INTEGRATE_STAGE):
        final_q, _, status, _ = integrate_dispatch_generic(
            q0, p0, steps, float(delta),
            (float(mass), float(spin), float(charge)),
            float(boundary_radius), float(omega), order=order,
            metric=metric, backend=backend)
    if cartesian:
        rho, th, ph = cartesian_to_spherical(final_q[:, 1], final_q[:, 2],
                                             final_q[:, 3])
        rho = torch.where(status == STATUS_CAPTURED, torch.zeros_like(rho),
                          rho)
        final_q = torch.stack([final_q[:, 0], rho, th, ph], dim=-1)
    if metric == "KerrDS":
        # grtrace/engine/aa.py:160-170: horizon_radius('Kerr', M, a,
        # Lambda) with the 1.1 shell
        rs_classify = (1.1 / 1.2) * horizon_radius("Kerr", params[0],
                                                   params[1], params[2])
    else:
        rs_classify = classify_radius(metric, params)
    n = final_q.shape[0]
    if beta is None:
        beta = torch.zeros((n,), dtype=dtype, device=device)
    sub_cls, _, _, u01, v01 = _classify.classify_rays(
        final_q, torch.full((n,), math.pi, dtype=dtype, device=device),
        beta.reshape(-1), rs=rs_classify,
        r_obs_x=obs_x_t, boundary_radius=scalar(boundary_radius),
        patch_center_theta=scalar(patch_center_theta),
        patch_center_phi=scalar(patch_center_phi),
        patch_size_theta=scalar(patch_size_theta),
        patch_size_phi=scalar(patch_size_phi),
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background)
    colors = _classify.composite(sub_cls, u01, v01, bg_array)
    return _scatter_averaged(image, idx, colors, samples)


def _lookat_subrays(idx, obs_pos, fov, mass, spin, charge, *, height, width,
                    samples, dtype, camera_moving, camera_omega):
    """The disk scenes' sub-rays: (q0, p0, params, obs, r_obs, r_obs_bl,
    th_obs) on the look-at camera, boosted when camera_moving, with the
    scalar rounding of the disk and subring render pipelines."""
    device = idx.device
    scalar = _scalars(dtype, device)
    params = torch.stack([scalar(mass), scalar(spin), scalar(charge)])
    obs = torch.tensor(np.asarray(obs_pos, np.float64), dtype=dtype,
                       device=device)
    r_obs = torch.linalg.vector_norm(obs)
    r_obs_bl = ks_radius(obs[0], obs[1], obs[2], params[1])
    th_obs = torch.arccos(torch.clamp(
        obs[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
    i_f, j_f = _subpixel_indices(idx, width, samples, dtype)
    pix = pixel_positions_fractional_lookat(obs, scalar(fov), height, width,
                                            i_f, j_f, dtype=dtype)
    if camera_moving:
        q0, p0, _ = boosted_ics_from_pixels(
            obs, pix, params=params, g_inv_fn=kerr_schild_g_inv,
            omega_cam=scalar(camera_omega))
    else:
        q0, p0, _ = cartesian_ics_from_pixels(
            obs, pix, params=params, g_inv_fn=kerr_schild_g_inv)
    return (q0.contiguous(), p0.contiguous(), params, obs, r_obs, r_obs_bl,
            th_obs)


def refine_edges_disk(cls, image, bg_array, obs_pos, fov, mass, spin, charge,
                      boundary_radius, steps, delta, omega, r_in, r_out,
                      t_peak, exposure, patch_center_theta, patch_center_phi,
                      patch_size_theta, patch_size_phi, camera_omega=0.0,
                      *, height, width, samples=2, order=2,
                      backend="auto", flip_theta=False, flip_phi=False,
                      has_background=True, dtype=torch.float32,
                      prograde=True, profile="shakura", camera_moving=False,
                      stage=_untimed):
    """The thin-disk pass: sub-rays ride the inclined look-at camera
    (boosted when the camera moves) and disk._trace_flat (B6 on the card),
    and their colours come from disk.run_shading, the one shading function
    of render_disk's display image.  The edge score sees the CLS_DISK
    transitions, since it compares class labels.  obs_pos is the (3,)
    camera position; scalars are Python floats.  Returns (image,
    aa_mask)."""
    from .disk import _trace_flat, run_shading

    idx = _select_edges(cls, default_k_edge(height, width))
    if idx.numel() == 0:
        return _unrefined(image)
    q0, p0, params, _, r_obs, _, _ = _lookat_subrays(
        idx, obs_pos, fov, mass, spin, charge, height=height, width=width,
        samples=samples, dtype=dtype, camera_moving=camera_moving,
        camera_omega=camera_omega)
    flat = _trace_flat(
        q0, p0, bg_array, (float(mass), float(spin), float(charge)), params,
        r_obs, boundary_radius, steps, delta, omega, r_in, r_out,
        patch_center_theta, patch_center_phi, patch_size_theta,
        patch_size_phi, order=order, backend=backend, flip_theta=flip_theta,
        flip_phi=flip_phi, has_background=has_background,
        stage=lambda: stage(INTEGRATE_STAGE))
    n = q0.shape[0]
    shaded = run_shading(
        (flat["hit_q"], flat["hit_p"], flat["status"], flat["colors"]),
        height=n, width=1, profile=profile, prograde=prograde,
        params=[mass, spin, charge], obs_pos=obs_pos, r_in=r_in,
        r_out=r_out, t_peak=t_peak, exposure=exposure,
        camera_omega=camera_omega, dtype=dtype)
    return _scatter_averaged(image, idx, shaded["image"], samples)


def subring_edge_labels(cls, count, valid):
    """(H, W) int32 label whose 4-neighbour transitions mark every aliased
    boundary of a subring render: the classification edges, the
    crossing-count bands (the n-th subring is a count >= n + 1 band) and
    each order's annulus membership.  One edge_scores pass scores them
    all."""
    n_orders = valid.shape[0]
    weights = (2 ** torch.arange(n_orders, dtype=torch.int32,
                                 device=cls.device))[:, None, None]
    bits = torch.sum(valid.to(torch.int32) * weights, dim=0,
                     dtype=torch.int32)
    cc = torch.clamp(count.to(torch.int32), 0, n_orders + 1)
    return ((cls.to(torch.int32) * (n_orders + 2) + cc) * (2 ** n_orders)
            + bits)


def _scatter_averaged_stack(maps, idx, vals, samples):
    """Per-layer mean of the s^2 sub-values per refined pixel, scattered
    into a copy of the (L, H, W) maps."""
    shape = maps.shape
    avg = vals.reshape(shape[0], -1, samples * samples).mean(2)
    flat = maps.reshape(shape[0], -1).clone()
    flat[:, idx] = avg
    return flat.reshape(shape)


def refine_subrings(cls, count, valid, image, intensity, bg_array, obs_pos,
                    fov, mass, spin, charge, boundary_radius, steps, delta,
                    omega, r_in, r_out, t_peak, exposure, patch_center_theta,
                    patch_center_phi, patch_size_theta, patch_size_phi,
                    camera_omega=0.0, *, height, width, samples=2,
                    n_orders=3, order=2, backend="auto",
                    flip_theta=False, flip_phi=False, has_background=True,
                    dtype=torch.float32, prograde=True, profile="shakura",
                    camera_moving=False, stage=_untimed):
    """The subring pass: s^2 sub-rays through every pixel where a layer
    boundary lands (`subring_edge_labels`), through
    subring._trace_shade_subrings (B7 on the card); both the displayed
    colours and the per-order intensity maps take the sub-ray means (the
    n >= 1 subrings are exponentially thin, so their flux sits in boundary
    pixels).  Returns (image, intensity, total_intensity, aa_mask)."""
    from .subring import _trace_shade_subrings

    labels = subring_edge_labels(cls, count, valid)
    idx = _select_edges(labels, default_k_edge(height, width))
    if idx.numel() == 0:
        image, mask = _unrefined(image)
        return image, intensity, torch.sum(intensity, dim=0), mask
    q0, p0, params, _, r_obs, r_obs_bl, th_obs = _lookat_subrays(
        idx, obs_pos, fov, mass, spin, charge, height=height, width=width,
        samples=samples, dtype=dtype, camera_moving=camera_moving,
        camera_omega=camera_omega)
    flat = _trace_shade_subrings(
        q0, p0, bg_array, (float(mass), float(spin), float(charge)), params,
        r_obs, r_obs_bl, th_obs, boundary_radius, steps, delta, omega, r_in,
        r_out, t_peak, exposure, patch_center_theta, patch_center_phi,
        patch_size_theta, patch_size_phi, n_orders=n_orders, order=order,
        backend=backend, prograde=prograde, profile=profile,
        flip_theta=flip_theta, flip_phi=flip_phi,
        has_background=has_background,
        omega_obs=camera_omega if camera_moving else 0.0,
        stage=lambda: stage(INTEGRATE_STAGE))
    image, aa_mask = _scatter_averaged(image, idx, flat["image"], samples)
    intensity = _scatter_averaged_stack(intensity, idx,
                                        flat["shade"]["intensity"], samples)
    return image, intensity, torch.sum(intensity, dim=0), aa_mask
