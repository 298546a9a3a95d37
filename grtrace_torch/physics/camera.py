"""Pinhole camera: pixel grid -> null-geodesic phase-space initial
conditions — the torch counterpart of the folded Schwarzschild camera in
`grtrace.physics.camera` (`pixel_grid`, `angles_to_p_sph`,
`initial_conditions`, `camera_rays`), of its Cartesian-chart camera
(`camera_rays_cartesian`, `cartesian_ics_from_pixels`), of the unfolded
spherical-chart camera of the generic engine (`camera_rays_unfolded`,
`unfolded_ics_from_pixels`: no fold, for axisymmetric metrics such as
Kerr in Boyer-Lindquist coordinates), of the folded camera of the static
beyond-Kerr families (`camera_rays_folded_static`,
`folded_ics_from_pixels_static`), of the inclined
look-at grid of the disk renderer (`_lookat_frame`, `pixel_grid_lookat`),
of the fractional-pixel positions the antialiasing pass traces
(`pixel_positions_fractional`, `pixel_positions_fractional_lookat`) and of
the moving camera's tetrad (`boosted_ics_from_pixels`).

Camera geometry (the reference's):
  * observer on the +x axis, optical axis -x, right = +y, up = +z
  * image plane at distance 0.2*|obs| with width 2*d*tan(fov/2),
    height = width * (h/w)
  * pixel (i, j): offset u = (j+0.5)/w - 0.5 along +y, v = (i+0.5)/h - 0.5
    along +z.

The Schwarzschild camera folds every ray into the x-y plane by a rotation
beta about +x, so the integrator sees theta = pi/2 and p_theta = 0
exactly.  Scalars (observer
position, fov, mass) are tensors of the working dtype on the working
device, as the JAX pipeline passes them, so scalar arithmetic rounds in
that dtype.
"""
from __future__ import annotations

import math

import torch

from . import spacetime
from .coords import cartesian_to_spherical, rotate_x
from .nullcond import null_p_t


def _axis_frame(obs_pos, fov, height, width, dtype, device):
    """(plane_center, plane_width, plane_height, right, up) of the image
    plane of the observer on the +x axis: optical axis -x, right +y, up
    +z, the plane at 0.2 |obs|."""
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    device = obs_pos.device
    fov = torch.as_tensor(fov, dtype=dtype, device=device)
    optical_axis = torch.tensor([-1.0, 0.0, 0.0], dtype=dtype, device=device)
    right = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)

    plane_dist = 0.2 * torch.linalg.vector_norm(obs_pos)
    plane_center = obs_pos + optical_axis * plane_dist
    plane_width = 2.0 * plane_dist * torch.tan(fov / 2.0)
    plane_height = plane_width * (height / width)
    return plane_center, plane_width, plane_height, right, up


def pixel_grid(obs_pos, fov, height, width, dtype=torch.float32,
               device=None):
    """Return (H, W, 3) pixel positions on the image plane."""
    plane_center, plane_width, plane_height, right, up = _axis_frame(
        obs_pos, fov, height, width, dtype, device)
    device = plane_center.device
    jj = torch.arange(width, dtype=dtype, device=device)
    ii = torch.arange(height, dtype=dtype, device=device)
    u = (jj + 0.5) / width - 0.5   # (W,) along +y
    v = (ii + 0.5) / height - 0.5  # (H,) along +z
    offsets = (u[None, :, None] * plane_width * right
               + v[:, None, None] * plane_height * up)
    return plane_center + offsets


def _fractional_offsets(i_f, j_f, height, width, plane_width, plane_height,
                        right, up):
    """(N, 3) image-plane offsets at fractional pixel indices, with
    pixel_grid's arithmetic (so an integer centre gives its bits)."""
    u = (j_f + 0.5) / width - 0.5
    v = (i_f + 0.5) / height - 0.5
    return (u[:, None] * plane_width * right
            + v[:, None] * plane_height * up)


def pixel_positions_fractional(obs_pos, fov, height, width, i_f, j_f,
                               dtype=torch.float32):
    """(N, 3) image-plane positions at fractional pixel indices (i_f, j_f)
    of an H x W frame, pixel_grid's geometry and association: integer
    centres give pixel_grid's bits, and with s = 2 the sub-pixel
    (i +- 0.25, j +- 0.25) gives the bits of pixel (2i + si, 2j + sj) of
    the 2H x 2W grid (the two differ by exact power-of-two scalings).  The
    adaptive edge-refinement pass (engine/aa.py) feeds its stratified
    sub-pixel indices through here."""
    plane_center, plane_width, plane_height, right, up = _axis_frame(
        obs_pos, fov, height, width, dtype, i_f.device)
    return plane_center + _fractional_offsets(
        i_f, j_f, height, width, plane_width, plane_height, right, up)


def _lookat_frame(obs_pos, fov, height, width, dtype=torch.float32,
                  device=None):
    """(plane_center, plane_width, plane_height, right, up) of the
    origin-aimed image plane for an observer anywhere.  The up-reference
    is +z (the spin axis), so the equatorial plane stays level, with a
    right = +y fallback for near-polar observers (|axis x z| ~ 0)."""
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    device = obs_pos.device
    fov = torch.as_tensor(fov, dtype=dtype, device=device)
    d = torch.linalg.vector_norm(obs_pos)
    axis = -obs_pos / d
    z_hat = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    r_raw = torch.linalg.cross(axis, z_hat)
    r_norm = torch.linalg.vector_norm(r_raw)
    right = torch.where(r_norm > 1e-6, r_raw / torch.clamp(r_norm, min=1e-30),
                        torch.tensor([0.0, 1.0, 0.0], dtype=dtype,
                                     device=device))
    up = torch.linalg.cross(right, axis)

    plane_dist = 0.2 * d
    plane_center = obs_pos + axis * plane_dist
    plane_width = 2.0 * plane_dist * torch.tan(fov / 2.0)
    plane_height = plane_width * (height / width)
    return plane_center, plane_width, plane_height, right, up


def pixel_grid_lookat(obs_pos, fov, height, width, dtype=torch.float32,
                      device=None):
    """(H, W, 3) pixel positions for an observer anywhere, optical axis
    aimed at the origin (the inclined camera of the disk renderer).  For
    the equatorial +x observer it reduces to `pixel_grid` (right = +y,
    up = +z)."""
    plane_center, plane_width, plane_height, right, up = _lookat_frame(
        obs_pos, fov, height, width, dtype, device)
    device = plane_center.device
    jj = torch.arange(width, dtype=dtype, device=device)
    ii = torch.arange(height, dtype=dtype, device=device)
    u = (jj + 0.5) / width - 0.5
    v = (ii + 0.5) / height - 0.5
    offsets = (u[None, :, None] * plane_width * right
               + v[:, None, None] * plane_height * up)
    return plane_center + offsets


def pixel_positions_fractional_lookat(obs_pos, fov, height, width, i_f, j_f,
                                      dtype=torch.float32):
    """(N, 3) look-at image-plane positions at fractional pixel indices:
    the inclined-camera twin of pixel_positions_fractional, with
    pixel_grid_lookat's arithmetic and the same bit identities (the disk
    and subring refinement passes of engine/aa.py)."""
    plane_center, plane_width, plane_height, right, up = _lookat_frame(
        obs_pos, fov, height, width, dtype, i_f.device)
    return plane_center + _fractional_offsets(
        i_f, j_f, height, width, plane_width, plane_height, right, up)


def angles_to_p_sph(alpha, beta, r_obs, *, mass_bh=1.0):
    """Camera angles -> reference-convention spatial momentum triplet:
        n = (-cos a cos b, -sin b, sin a cos b)   orthonormal (rhat, thhat, phhat)
        p = (n_r * sqrt(1 - 2M/r), n_th * r, n_ph * r)
    alpha/beta/r_obs are tensors that broadcast elementwise.
    """
    alpha = torch.as_tensor(alpha)
    beta = torch.as_tensor(beta, dtype=alpha.dtype, device=alpha.device)
    r_obs = torch.as_tensor(r_obs, dtype=alpha.dtype, device=alpha.device)
    f_r = torch.sqrt(1.0 - 2.0 * mass_bh / r_obs)
    n_rhat = -torch.cos(alpha) * torch.cos(beta)
    n_phhat = torch.sin(alpha) * torch.cos(beta)
    n_thhat = -torch.sin(beta)
    p_r = n_rhat * f_r
    p_th = n_thhat * r_obs
    p_ph = n_phhat * r_obs
    p_r, p_th, p_ph = torch.broadcast_tensors(p_r, p_th, p_ph)
    return torch.stack([p_r, p_th, p_ph], dim=-1)


def initial_conditions(obs_pos, pixel_pos, *, mass_bh=1.0):
    """Batched pixel positions -> (q0, p0, alpha0, heading, beta).

    q0 : (..., 4)   initial position (0, r_obs, th_obs, ph_obs)
    p0 : (..., 4)   null 4-momentum, future-directed root
    alpha0 : (...)  angle off the optical axis
    heading : (..., 3)  (h_r, h_theta, h_phi) of the lab-frame ray direction
    beta : (...)    fold angle about +x (equatorial-plane trick)
    """
    obs_pos = torch.as_tensor(obs_pos, dtype=pixel_pos.dtype,
                              device=pixel_pos.device)
    ray = pixel_pos - obs_pos
    ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]

    # fold the ray into the x-y plane: beta = angle out of plane;
    # atan2(0, 0) = 0 handles the exact center pixel
    beta = torch.atan2(rz, ry)
    xy_x, xy_y, _ = rotate_x(rx, ry, rz, -beta)

    r_obs, th_obs, ph_obs = cartesian_to_spherical(
        obs_pos[..., 0], obs_pos[..., 1], obs_pos[..., 2])

    # in-plane theta = pi/2, so h_phi = atan2(y, x); alpha_cam = pi - h_phi
    h_phi_xy = torch.atan2(xy_y, xy_x)
    alpha_cam = math.pi - h_phi_xy

    p_spatial = angles_to_p_sph(alpha_cam, 0.0, r_obs, mass_bh=mass_bh)

    p_t = null_p_t(p_spatial, r_obs, th_obs, mass_bh=mass_bh, future=True)
    p0 = torch.cat([p_t[..., None], p_spatial], dim=-1)

    zeros = torch.zeros_like(beta)
    q0 = torch.stack([zeros, r_obs.expand(beta.shape),
                      th_obs.expand(beta.shape),
                      ph_obs.expand(beta.shape)], dim=-1)

    h_r, h_th, h_ph = cartesian_to_spherical(rx, ry, rz)
    heading = torch.stack([h_r, h_th, h_ph], dim=-1)

    # angle off the optical axis, renormalized to flat geometry
    f_r = torch.sqrt(1.0 - 2.0 * mass_bh / r_obs)
    alpha0 = torch.arccos(torch.clamp(-p_spatial[..., 0] / f_r, -1.0, 1.0))

    return q0, p0, alpha0, heading, beta


def camera_rays(obs_pos, fov, height, width, *, mass_bh=1.0,
                dtype=torch.float32, device=None):
    """Camera parameters -> per-pixel initial conditions.

    Shapes: q0/p0 (H, W, 4), alpha0/beta (H, W), heading (H, W, 3).
    """
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype,
                     device=obs_pos.device)
    return initial_conditions(obs_pos, pix, mass_bh=mass_bh)


def folded_ics_from_pixels_static(obs, pix, *, params, g_inv_fn):
    """The folded (equatorial) camera of the static families for pixel
    positions pix (..., 3): `initial_conditions`' beta-fold, exact under
    spherical symmetry, with p_t closing the null condition in the
    family's own metric (`spacetime.null_p_t`) and the Schwarzschild
    sqrt(1 - 2M/r) radial normalization kept, as JAX keeps it.  Returns
    (q0, p0, alpha0, beta); classify_rays(beta) un-folds the exit angles
    and the sampled trajectories rotate back by beta about +x."""
    obs = torch.as_tensor(obs, dtype=pix.dtype, device=pix.device)
    ray = pix - obs
    ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]

    beta = torch.atan2(rz, ry)
    xy_x, xy_y, _ = rotate_x(rx, ry, rz, -beta)
    r_obs, th_obs, ph_obs = cartesian_to_spherical(
        obs[..., 0], obs[..., 1], obs[..., 2])
    alpha_cam = math.pi - torch.atan2(xy_y, xy_x)

    params = torch.as_tensor(params, dtype=pix.dtype, device=pix.device)
    mass = params[0]
    p_spatial = angles_to_p_sph(alpha_cam, 0.0, r_obs, mass_bh=mass)
    zeros = torch.zeros_like(beta)
    q0 = torch.stack([zeros, r_obs.expand(beta.shape),
                      th_obs.expand(beta.shape),
                      ph_obs.expand(beta.shape)], dim=-1)
    p_t = spacetime.null_p_t(p_spatial, q0, params, g_inv_fn, future=True)
    p0 = torch.cat([p_t[..., None], p_spatial], dim=-1)

    f_r = torch.sqrt(1.0 - 2.0 * mass / r_obs)
    alpha0 = torch.arccos(torch.clamp(-p_spatial[..., 0] / f_r, -1.0, 1.0))
    return q0, p0, alpha0, beta


def camera_rays_folded_static(obs_pos, fov, height, width, *, params,
                              g_inv_fn, dtype=torch.float32, device=None):
    """Full-grid folded camera of the static families: pixel_grid ->
    folded_ics_from_pixels_static.  Returns (q0, p0, alpha0, beta), (H, W,
    4 | 4 | - | -)."""
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype,
                     device=obs_pos.device)
    return folded_ics_from_pixels_static(obs_pos, pix, params=params,
                                         g_inv_fn=g_inv_fn)


def _dot3(v, w):
    """v . w over the last axis of length 3, summed left to right."""
    return v[..., 0] * w[..., 0] + v[..., 1] * w[..., 1] + v[..., 2] * w[..., 2]


def camera_rays_cartesian(obs_pos, fov, height, width, *, params, g_inv_fn,
                          dtype=torch.float32, device=None):
    """Camera for Cartesian-chart metrics (Kerr-Schild): the ray direction
    is the spatial covector, and p_t closes the exact null quadratic with
    all g^{t i} cross terms.

    Returns (q0, p0, alpha0): q0 = (0, x, y, z) and p0 = (p_t, n_x, n_y,
    n_z), (H, W, 4) each; alpha0 (H, W) is the flat angle off the optical
    axis (diagnostics only)."""
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype,
                     device=obs_pos.device)
    return cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                     g_inv_fn=g_inv_fn)


def cartesian_ics_from_pixels(obs, pix, *, params, g_inv_fn):
    """Core of the Cartesian-chart camera for arbitrary pixel positions
    pix (..., 3).

    The reference camera scales the radial covector component by
    sqrt(1 - 2M/r); in Cartesian components that is
    n + (sqrt(f) - 1)(n . rhat) rhat.  This reproduces the spherical
    camera's covector components, not its physical pixel -> viewing-angle
    map (an O(2M/r_obs) apparent-size gauge; see the JAX module)."""
    dtype, device = pix.dtype, pix.device
    obs = torch.as_tensor(obs, dtype=dtype, device=device)
    ray = pix - obs
    ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)

    shape = ray.shape[:-1]
    q0 = torch.cat([torch.zeros(shape + (1,), dtype=dtype, device=device),
                    obs.expand(shape + (3,))], dim=-1)

    params = torch.as_tensor(params, dtype=dtype, device=device)
    r_obs = torch.linalg.vector_norm(obs)
    rhat = obs / r_obs
    f_r = torch.sqrt(1.0 - 2.0 * params[0] / r_obs)
    n_r = _dot3(ray, rhat)
    p_sp = ray + (f_r - 1.0) * n_r[..., None] * rhat

    p_t = spacetime.null_p_t(p_sp, q0, params, g_inv_fn)
    p0 = torch.cat([p_t[..., None], p_sp], dim=-1)

    axis = -obs / torch.linalg.vector_norm(obs)
    alpha0 = torch.arccos(torch.clamp(_dot3(ray, axis), -1.0, 1.0))
    return q0, p0, alpha0


def camera_rays_unfolded(obs_pos, fov, height, width, *, params, g_inv_fn,
                         dtype=torch.float32, device=None):
    """Camera for spherical-chart metrics without the equatorial fold
    (Kerr is only axisymmetric, so rays keep their true headings):
    pixel_grid -> unfolded_ics_from_pixels.  Returns (q0, p0, alpha0), (H,
    W, 4 | 4 | -)."""
    obs_pos = torch.as_tensor(obs_pos, dtype=dtype, device=device)
    pix = pixel_grid(obs_pos, fov, height, width, dtype=dtype,
                     device=obs_pos.device)
    return unfolded_ics_from_pixels(obs_pos, pix, params=params,
                                    g_inv_fn=g_inv_fn)


def unfolded_ics_from_pixels(obs, pix, *, params, g_inv_fn):
    """Core of the unfolded spherical-chart camera for pixel positions pix
    (..., 3).  The spatial covector is the reference camera's
    normalization (n_rhat sqrt(1 - 2M/r), n_thhat r, n_phhat r) in the
    observer's orthonormal spherical basis, and p_t closes the exact null
    quadratic of the metric, frame-dragging cross term included
    (`spacetime.null_p_t(future=True)`).  alpha0 is arccos(-p_r / f_r),
    the angle off the optical axis."""
    dtype, device = pix.dtype, pix.device
    obs = torch.as_tensor(obs, dtype=dtype, device=device)
    ray = pix - obs
    ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)

    r_obs, th_obs, ph_obs = cartesian_to_spherical(obs[0], obs[1], obs[2])
    st, ct = torch.sin(th_obs), torch.cos(th_obs)
    sp, cp = torch.sin(ph_obs), torch.cos(ph_obs)
    rhat = torch.stack([st * cp, st * sp, ct])
    thhat = torch.stack([ct * cp, ct * sp, -st])
    phhat = torch.stack([-sp, cp, torch.zeros_like(sp)])
    n_r, n_th, n_ph = _dot3(ray, rhat), _dot3(ray, thhat), _dot3(ray, phhat)

    params = torch.as_tensor(params, dtype=dtype, device=device)
    f_r = torch.sqrt(1.0 - 2.0 * params[0] / r_obs)
    p_sp = torch.stack([n_r * f_r, n_th * r_obs, n_ph * r_obs], dim=-1)
    q0 = torch.cat([torch.zeros_like(n_r)[..., None],
                    torch.stack([r_obs, th_obs, ph_obs]).expand(
                        n_r.shape + (3,))], dim=-1)
    p_t = spacetime.null_p_t(p_sp, q0, params, g_inv_fn, future=True)
    p0 = torch.cat([p_t[..., None], p_sp], dim=-1)
    alpha0 = torch.arccos(torch.clamp(-p_sp[..., 0] / f_r, -1.0, 1.0))
    return q0, p0, alpha0


def _gdot(a, g, b):
    """a . g . b for one 4-vector pair and a (4, 4) metric."""
    return torch.einsum("i,ij,j->", a, g, b)


def boosted_ics_from_pixels(obs, pix, *, params, g_inv_fn, omega_cam):
    """Initial conditions for a camera on the circular worldline
    u = u^t (d_t + omega_cam d_phi): exact GR aberration and Doppler through
    an orthonormal camera tetrad, at the camera event on the Cartesian
    chart:
      1. the covariant metric g = inv(g_inv) (one 4x4);
      2. e0 = the camera 4-velocity (1, -omega y, omega x, 0) / norm;
      3. {e1, e2, e3} = Gram-Schmidt of the look-at frame's (axis, right,
         up) coordinate vectors against e0 under g;
      4. each pixel's image-plane coefficients (c_ax, c_r, c_up) give the
         unit rest-frame direction d = sum c_i e_i / |c|, and the photon
         momentum is p = d - e0 (null, unit camera-frame frequency),
         lowered with g.
    omega_cam is a 0-dim tensor (or number) in pix's dtype.  Returns
    (q0, p0, alpha0) shaped like cartesian_ics_from_pixels."""
    dtype, device = pix.dtype, pix.device
    obs = torch.as_tensor(obs, dtype=dtype, device=device)
    params = torch.as_tensor(params, dtype=dtype, device=device)
    omega_cam = torch.as_tensor(omega_cam, dtype=dtype, device=device)
    zero1 = torch.zeros((1,), dtype=dtype, device=device)

    shape = pix.shape[:-1]
    q0 = torch.cat([torch.zeros(shape + (1,), dtype=dtype, device=device),
                    obs.expand(shape + (3,))], dim=-1)

    g = torch.linalg.inv(g_inv_fn(torch.cat([zero1, obs]), params))
    v0 = torch.cat([torch.ones((1,), dtype=dtype, device=device),
                    omega_cam * torch.stack([-obs[1], obs[0], zero1[0]])])
    e0 = v0 / torch.sqrt(torch.clamp(-_gdot(v0, g, v0), min=1e-30))

    axis = -obs / torch.linalg.vector_norm(obs)
    z_hat = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    r_raw = torch.linalg.cross(axis, z_hat)
    r_nrm = torch.linalg.vector_norm(r_raw)
    right = torch.where(r_nrm > 1e-6, r_raw / torch.clamp(r_nrm, min=1e-30),
                        torch.tensor([0.0, 1.0, 0.0], dtype=dtype,
                                     device=device))
    up = torch.linalg.cross(right, axis)

    triad = []
    for v3 in (axis, right, up):
        v = torch.cat([zero1, v3])
        w = v + _gdot(v, g, e0) * e0          # project out e0 (e0.e0 = -1)
        for e in triad:
            w = w - _gdot(v, g, e) * e
        triad.append(w / torch.sqrt(torch.clamp(_gdot(w, g, w),
                                                min=1e-30)))
    e1, e2, e3 = triad

    rel = pix - obs
    c = torch.stack([_dot3(rel, axis), _dot3(rel, right), _dot3(rel, up)],
                    dim=-1)
    c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    d = c[..., 0:1] * e1 + c[..., 1:2] * e2 + c[..., 2:3] * e3
    p_up = d - e0
    p0 = torch.einsum("...j,ij->...i", p_up, g)
    alpha0 = torch.arccos(torch.clamp(c[..., 0], -1.0, 1.0))
    return q0, p0, alpha0
