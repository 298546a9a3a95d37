"""Spin x inclination sweeps on the ('frames', 'rays') mesh — the
torch.distributed counterpart of `grtrace.sharding.grid`.

Grid points ride the 'frames' axis (each an independent spacetime and
camera), rays the 'rays' axis (mesh._local_ray_indices); each rank reduces
its own rays' contributions into fixed per-point rows, and one
`all_reduce` sums the rows over every rank, where JAX `psum`s over 'rays'
and gathers over 'frames'.  Padding lanes recompute the last pixel and are
weight-masked to zero.  The sums are taken in a fixed order for a given
shape (no atomics), so a call is reproducible bit for bit and the mesh's
shape moves a sum only by rounding.

    line_profile_grid_sharded   kernel B6 (float32 rays: the 32-row
                                compensated layout), one launch per
                                distinct spin of a rank's points
    subring_grid_sharded        kernel B7, one launch per grid point
    fisher_grid_sharded         the forward-mode Jacobian of
                                engine/sensitivity.line_profile_model in
                                float64 per point: one B6t launch with
                                both directions

Per ray the physics is engine.disk.save_disk_maps' line profile: pixel
flux g^4 r_em^-q for a narrow line with power-law emissivity.
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine.hotspot import bl_time_azimuth_offsets
from ..engine.integrate_ks import (STATUS_DISK, integrate_dispatch_disk,
                                   integrate_dispatch_subrings)
from ..engine.sensitivity import _linearize, _profile
from ..physics.camera import (cartesian_ics_from_pixels,
                              pixel_positions_fractional_lookat)
from ..physics.orbits import isco_radius, redshift_factor
from ..physics.spacetime import kerr_schild_g_inv, ks_radius
from .mesh import (_local_frames, _local_ray_indices, _pixels,
                   all_reduce_sum, rank_device)


class _Points:
    """The per-point camera and spacetime of a grid sweep on this rank."""

    def __init__(self, mesh, spins, elevations, obs_distance, fov, mass,
                 charge, height, width, dtype, device):
        self.device = rank_device(device)
        self.dtype = dtype
        self.spins = self._frame_array(spins)
        self.elevs = self._frame_array(elevations)
        self.f = self.spins.numel()
        self.frames = _local_frames(mesh, self.f)
        self.height, self.width = height, width
        self.obs_distance, self.fov = self.scalar(obs_distance), \
            self.scalar(fov)
        self.mass, self.charge = float(mass), float(charge)
        n = height * width
        flat_idx, self.real = _local_ray_indices(n, mesh.n_ray_shards,
                                                 mesh.ray_shard, self.device)
        self.i_f, self.j_f = _pixels(flat_idx, width, dtype)

    def scalar(self, x):
        return torch.tensor(float(x), dtype=self.dtype, device=self.device)

    def _frame_array(self, v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=self.dtype,
                               device=self.device).reshape(-1)

    def hole(self, k):
        """(M, a, Q) Python floats in the rays' dtype."""
        return (self.mass, float(self.spins[k]), self.charge)

    def params(self, k):
        return torch.stack([self.scalar(self.mass), self.spins[k],
                            self.scalar(self.charge)])

    def camera(self, k):
        """(q0, p0, r_obs_bl, th_obs) of point k's local rays."""
        elev = self.elevs[k]
        obs_pos = torch.stack([self.obs_distance * torch.cos(elev),
                               torch.zeros_like(elev),
                               self.obs_distance * torch.sin(elev)])
        r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2],
                             self.spins[k])
        th_obs = torch.arccos(torch.clamp(
            obs_pos[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
        pix = pixel_positions_fractional_lookat(
            obs_pos, self.fov, self.height, self.width, self.i_f, self.j_f,
            dtype=self.dtype)
        q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix,
                                              params=self.params(k),
                                              g_inv_fn=kerr_schild_g_inv)
        return q0, p0, r_obs_bl, th_obs

    def redshift(self, k, hit_q, hit_p, r_obs_bl, th_obs, prograde):
        """(g, r_em) of crossings (..., 4): Killing constants E = -p_t and
        L_z = x p_y - y p_x, the emission radius in the Boyer-Lindquist
        chart."""
        x, y = hit_q[..., 1], hit_q[..., 2]
        energy = -hit_p[..., 0]
        l_z = x * hit_p[..., 2] - y * hit_p[..., 1]
        r_em = ks_radius(x, y, hit_q[..., 3], self.spins[k])
        g = redshift_factor(energy, l_z, r_em, r_obs_bl, self.params(k),
                            prograde, th_obs)
        return g, r_em


def _bin_sum(w, b, n_bins):
    """sum of w per bin index b, (n,) -> (n_bins,), in a fixed order."""
    bins = torch.arange(n_bins, device=b.device)
    return torch.where(b[None, :] == bins[:, None], w[None, :],
                       torch.zeros_like(w)[None, :]).sum(dim=1)


def line_profile_grid_sharded(mesh, spins, elevations, obs_distance, fov,
                              mass, charge, boundary_radius, steps, delta,
                              omega, r_out, *, height, width, order=2,
                              backend="auto", dtype=torch.float32,
                              prograde=True, n_bins=96, emissivity=(3.0,),
                              g_lo=0.1, g_hi=1.6, device="cuda"):
    """(F,) spins x (F,) elevations -> (F, Q, B) line-profile flux
    histograms over fixed g bins, on every rank.

    Point k traces a height x width camera `elevations[k]` radians above
    the disk plane through a hole of spin `spins[k]`, disk annulus
    [ISCO(spin), r_out]; `emissivity` is a tuple of power-law indices q
    sharing the geodesic work.  Bin b covers [g_lo + b dg, g_lo + (b+1)
    dg), dg = (g_hi - g_lo) / n_bins; out-of-range g is dropped.  The
    points of one spin on a rank go to kernel B6 in one launch."""
    pts = _Points(mesh, spins, elevations, obs_distance, fov, mass, charge,
                  height, width, dtype, device)
    q_tuple = tuple(float(q) for q in emissivity)
    out = torch.zeros((pts.f, len(q_tuple), n_bins), dtype=dtype,
                      device=pts.device)
    dg = pts.scalar((g_hi - g_lo) / n_bins)
    n_local = pts.i_f.numel()
    groups = {}
    for k in pts.frames:
        groups.setdefault(float(pts.spins[k]), []).append(k)
    for spin, ks in groups.items():
        r_in = float(isco_radius(pts.mass, spin, prograde))
        cams = [pts.camera(k) for k in ks]
        _, _, status, _, hit_q, hit_p = integrate_dispatch_disk(
            torch.cat([c[0] for c in cams]), torch.cat([c[1] for c in cams]),
            steps, float(delta), pts.hole(ks[0]), float(boundary_radius),
            float(omega), r_in, float(r_out), order=order, backend=backend)
        for s, k in enumerate(ks):
            part = slice(s * n_local, (s + 1) * n_local)
            g, r_em = pts.redshift(k, hit_q[part], hit_p[part], cams[s][2],
                                   cams[s][3], prograde)
            b = torch.clamp(torch.floor((g - g_lo) / dg).to(torch.int64), 0,
                            n_bins - 1)
            keep = ((status[part] == STATUS_DISK) & pts.real & (g >= g_lo)
                    & (g < g_hi))
            for iq, q in enumerate(q_tuple):
                w = torch.where(keep, g ** 4 * torch.clamp(r_em, min=1e-30)
                                ** (-q), torch.zeros_like(g))
                out[k, iq] = _bin_sum(w, b, n_bins)
    return all_reduce_sum(out)


def g_bin_centers(n_bins=96, g_lo=0.1, g_hi=1.6):
    """Centers of the histogram lattice line_profile_grid_sharded fills."""
    edges = np.linspace(g_lo, g_hi, n_bins + 1)
    return 0.5 * (edges[1:] + edges[:-1])


def subring_grid_sharded(mesh, spins, elevations, obs_distance, fov, mass,
                         charge, boundary_radius, steps, delta, omega, r_out,
                         *, height, width, order=2, n_orders=3,
                         dtype=torch.float32, prograde=True,
                         emissivity_q=3.0, device="cuda"):
    """Photon-ring subring scan over the mesh: (F,) spins x elevations ->
    per-order flux, pixel counts and the n0 - n1 crossing delay, through
    kernel B7 (one launch per grid point).

    Per-order flux is g^4 r^-q over the pixels whose order-n crossing lands
    in [ISCO(spin), r_out]; delay01 is the mean Boyer-Lindquist time gap
    t(n=0) - t(n=1) over rays with both crossings recorded (anywhere on
    the plane).  Returns (flux (F, N), pixels (F, N), delay01_mean (F,),
    delay01_rays (F,)) on every rank."""
    pts = _Points(mesh, spins, elevations, obs_distance, fov, mass, charge,
                  height, width, dtype, device)
    rows = torch.zeros((pts.f, 2 * n_orders + 2), dtype=dtype,
                       device=pts.device)
    order_ids = torch.arange(n_orders, device=pts.device)
    for k in pts.frames:
        r_in = float(isco_radius(pts.mass, float(pts.spins[k]), prograde))
        q0, p0, r_obs_bl, th_obs = pts.camera(k)
        out = integrate_dispatch_subrings(
            q0, p0, steps, float(delta), pts.hole(k), float(boundary_radius),
            float(omega), n_orders=n_orders, order=order)
        hq, hp, count = out[4], out[5], out[6]
        filled = count[None, :] > order_ids[:, None]
        g, r_em = pts.redshift(k, hq, hp, r_obs_bl, th_obs, prograde)
        valid = (filled & pts.real[None, :] & (r_em >= r_in)
                 & (r_em <= float(r_out)))
        w = torch.where(valid, g ** 4 * torch.clamp(r_em, min=1e-30)
                        ** (-emissivity_q), torch.zeros_like(g))
        both = (count > 1) & pts.real
        t_off = bl_time_azimuth_offsets(r_em, pts.params(k))[0]
        t_bl = hq[..., 0] - t_off
        d01 = torch.where(both, t_bl[0] - t_bl[1], torch.zeros_like(t_bl[0]))
        rows[k] = torch.cat([w.sum(dim=1), valid.to(dtype).sum(dim=1),
                             d01.sum()[None], both.to(dtype).sum()[None]])
    rows = all_reduce_sum(rows)
    flux, pixels = rows[:, :n_orders], rows[:, n_orders:2 * n_orders]
    d_sum, d_cnt = rows[:, 2 * n_orders], rows[:, 2 * n_orders + 1]
    return flux, pixels, d_sum / torch.clamp(d_cnt, min=1.0), d_cnt


def fisher_grid_sharded(mesh, spins, elevations, noise_sigma, *, size=48,
                        steps=4000, delta=0.1, omega=1.0, order=2,
                        r_out=14.0, obs_distance=30.0, fov=1.396263,
                        mass=1.0, charge=0.0, boundary_radius=31.0,
                        prograde=True, emissivity_index=3.0, n_bins=48,
                        g_lo=0.1, g_hi=1.6, device="cuda"):
    """Fisher forecast map over the (spin, elevation) plane: per grid point
    the 1-sigma marginalized errors sigma(spin), sigma(elevation) and the
    spin-elevation correlation that a line-profile fit at that truth
    attains with per-bin noise `noise_sigma`, from the forward-mode
    Jacobian of engine/sensitivity.line_profile_model (one B6t launch with
    both directions a point, no B6 launch) in float64, the widest dtype.
    Grid points ride the 'frames' axis; each point's size x size camera
    runs whole on the first rank of its frame shard.  Returns (F, 3)
    float64 on every rank: [sigma_spin, sigma_elev_rad, correlation]."""
    wide = torch.float64
    device = rank_device(device)
    spins = np.asarray(spins, np.float64).reshape(-1)
    elevs = np.asarray(elevations, np.float64).reshape(-1)
    half = 0.5 * (g_hi - g_lo) / n_bins
    centers = torch.as_tensor(np.linspace(g_lo + half, g_hi - half, n_bins),
                              dtype=wide, device=device)
    knobs = dict(size=size, steps=steps, delta=delta, omega=omega,
                 order=order, r_out=r_out, obs_distance=obs_distance,
                 fov=fov, mass=mass, charge=charge,
                 boundary_radius=boundary_radius, prograde=prograde,
                 emissivity_index=emissivity_index)
    out = torch.zeros((spins.size, 3), dtype=wide, device=device)
    sigma2 = torch.tensor(float(noise_sigma), dtype=wide, device=device) ** 2
    # the ray shards of a frame shard would repeat its points: the first
    # computes them, the others contribute zero rows to the sum
    frames = _local_frames(mesh, spins.size) if mesh.ray_shard == 0 else ()
    for k in frames:
        theta = torch.tensor([spins[k], elevs[k]], dtype=wide, device=device)
        _, jac = _linearize(
            lambda t, lin: _profile(t, centers, lin, **knobs), theta)
        cov = torch.linalg.inv((jac.T @ jac) / sigma2)
        err = torch.sqrt(torch.diagonal(cov))
        corr = cov[0, 1] / torch.clamp(err[0] * err[1], min=1e-300)
        out[k] = torch.stack([err[0], err[1], corr])
    return all_reduce_sum(out)
