"""Flat-space (no-gravity) reference renderer — the torch counterpart of
`grtrace.engine.flat`.

Analytic ray-sphere intersection, spherical hit coordinates, the interval
patch test with phi wrap-around and an equirectangular texture gather, all
batched over the pixel grid on the texture's device.  The flat path's patch
test and texture rounding differ from the curved path's (interval test and
int truncation here, centre distance and int(x + 0.5) there), as in the
reference.  Scalars are Python floats (rounded to the rays' dtype by the
ops that read them), as the JAX function receives them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .integrate_ks import _unit_grid


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(v, keepdim=False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def flat_ray_dirs(obs_pos, fov, height, width, dtype=torch.float32,
                  device=None):
    """Unit ray directions (H, W, 3) of the flat camera, whose basis comes
    from the black hole's direction by cross products (optical axis -x,
    right -y, up +z for an observer on +x)."""
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    optical_axis = -obs_pos / _norm(obs_pos)
    up_guess = torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                            device=obs_pos.device)
    right = _cross(up_guess, optical_axis)
    right = right / _norm(right)
    up_vec = _cross(optical_axis, right)
    up_vec = up_vec / _norm(up_vec)

    plane_dist = 0.2 * _norm(obs_pos)
    plane_center = obs_pos + optical_axis * plane_dist
    plane_width = 2.0 * plane_dist * math.tan(fov / 2.0)
    plane_height = plane_width * (height / width)

    jj = torch.arange(width, dtype=dtype, device=obs_pos.device)
    ii = torch.arange(height, dtype=dtype, device=obs_pos.device)
    u = (jj + 0.5) / width - 0.5
    v = (ii + 0.5) / height - 0.5
    pix = (plane_center + u[None, :, None] * plane_width * right
           + v[:, None, None] * plane_height * up_vec)
    ray = pix - obs_pos
    return ray / _norm(ray, keepdim=True)


def _in_phi_patch(phi, phi0, phi1):
    """Wrapped interval membership, phi a tensor, phi0/phi1 floats."""
    two_pi = 2.0 * math.pi
    phi = torch.remainder(phi, two_pi)
    phi0, phi1 = phi0 % two_pi, phi1 % two_pi
    if phi0 <= phi1:
        return (phi >= phi0) & (phi <= phi1)
    return (phi >= phi0) | (phi <= phi1)


def flat_raytrace(obs_pos, ray_dirs, boundary_radius,
                  patch_center_theta, patch_center_phi,
                  patch_size_theta, patch_size_phi,
                  bg_array, *, flip_theta=False, flip_phi=False):
    """(..., 3) ray directions -> ((..., 3) uint8 RGB, (..., 3) hit points)
    on the boundary sphere: the far intersection t = (-b + sqrt(disc)) / 2a,
    truncated texture indices."""
    dtype = ray_dirs.dtype
    obs = torch.as_tensor(obs_pos, dtype=dtype, device=ray_dirs.device)
    d = ray_dirs
    a = (d * d).sum(-1)
    b = 2.0 * (obs * d).sum(-1)
    c = (obs * obs).sum() - boundary_radius ** 2
    disc = b * b - 4.0 * a * c
    hit_ok = disc >= 0.0
    t = (-b + torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    hit = obs + t[..., None] * d

    r = _norm(hit)
    theta = torch.arccos(hit[..., 2] / r)
    phi = torch.atan2(hit[..., 1], hit[..., 0])

    theta0 = patch_center_theta - patch_size_theta / 2
    theta1 = patch_center_theta + patch_size_theta / 2
    phi0 = patch_center_phi - patch_size_phi / 2
    phi1 = patch_center_phi + patch_size_phi / 2
    two_pi = 2.0 * math.pi
    phi_span = (phi1 - phi0) % two_pi
    phi_span = two_pi if phi_span == 0.0 else phi_span

    in_patch = ((theta >= theta0) & (theta <= theta1)
                & _in_phi_patch(phi, phi0, phi1) & hit_ok)

    theta_map = (math.pi - theta) if flip_theta else theta
    phi_map = -phi if flip_phi else phi
    th_res, tw_res = bg_array.shape[0], bg_array.shape[1]
    u_bg = (theta_map - theta0) / (theta1 - theta0) * (th_res - 1)
    phi_mod = torch.remainder(phi_map - phi0, two_pi)
    v_bg = phi_mod / phi_span * (tw_res - 1)
    u_i = torch.clamp(u_bg.to(torch.int32), 0, th_res - 1).long()
    v_i = torch.clamp(v_bg.to(torch.int32), 0, tw_res - 1).long()

    texel = bg_array[u_i, v_i]
    rgb = torch.where(in_patch[..., None], texel, torch.zeros_like(texel))
    return rgb, hit


def flat_render_scene(observer, bg_array, *, boundary_radius=None,
                      patch_center_theta=None, patch_center_phi=None,
                      patch_size_theta=None, patch_size_phi=None,
                      flip_theta=False, flip_phi=False,
                      n_sampled=10, seed=0, dtype=torch.float32,
                      override_patch_center=False, device="cuda"):
    """The flat-space render pass on `device`: returns (image (H, W, 3)
    uint8 numpy, a list of (100, 3) straight-line trajectories of
    `n_sampled` random pixels).  Defaults as the reference's: the boundary
    at twice the observer distance, the patch centred on the boundary point
    opposite the observer unless overridden, 10 degrees wide."""
    h, w = observer.image_size
    obs = np.asarray(observer.position, dtype=float)
    if boundary_radius is None:
        boundary_radius = float(np.linalg.norm(obs) * 2)
    if (not override_patch_center or patch_center_theta is None
            or patch_center_phi is None):
        opp = -obs
        r_opp = np.linalg.norm(opp)
        patch_center_theta = float(np.arccos(opp[2] / r_opp))
        patch_center_phi = float(np.arctan2(opp[1], opp[0]))
    if patch_size_theta is None:
        patch_size_theta = float(np.deg2rad(10.0))
    if patch_size_phi is None:
        patch_size_phi = float(np.deg2rad(10.0))

    device = torch.device(device)
    obs_t = torch.as_tensor(obs, dtype=dtype, device=device)
    dirs = flat_ray_dirs(obs_t, observer.fov, h, w, dtype=dtype,
                         device=device)
    bg = torch.as_tensor(np.asarray(bg_array), dtype=torch.uint8,
                         device=device)
    rgb, hits = flat_raytrace(obs_t, dirs, boundary_radius,
                              patch_center_theta, patch_center_phi,
                              patch_size_theta, patch_size_phi, bg,
                              flip_theta=flip_theta, flip_phi=flip_phi)
    trajs = []
    if n_sampled and n_sampled > 0:
        rng = np.random.default_rng(seed)
        flat = rng.choice(h * w, size=min(n_sampled, h * w), replace=False)
        sampled_hits = hits.reshape(-1, 3)[torch.as_tensor(flat,
                                                           device=device)]
        trajs = list(flat_trajectories(obs_t, sampled_hits).cpu().numpy())
    return rgb.cpu().numpy(), trajs


def flat_trajectories(obs_pos, hits, n_points=100):
    """Straight-line sample points (K, n_points, 3) from the observer to
    each hit, at jnp.linspace(0, 1, n_points)'s points."""
    obs = torch.as_tensor(obs_pos, dtype=hits.dtype, device=hits.device)
    alphas = _unit_grid(n_points, hits.dtype, hits.device)
    return obs + alphas[None, :, None] * (hits[:, None, :] - obs)
