"""Orbiting hot-spot flares: time-resolved light curves from one geodesic
pass — the torch counterpart of `grtrace.engine.hotspot`.

The spacetime and the camera are stationary, so the bundle of null
geodesics from the camera to the disk never changes; only the emissivity
painted on the disk does.  One disk render (engine/disk.py: kernel B6 on
the card) records, per pixel, the equatorial crossing event hit_q and the
Keplerian redshift g; every frame of the movie is an elementwise shading
of those invariants, batched over frame times (`shade_hotspot_frames`).

Time axis: the camera launches past-directed rays, so a hit at coordinate
time t_hit < 0 is the emission event.  A photon observed at camera time
tau left the disk at tau + t_bl(hit), when the blob sat at azimuth
phi0 + Omega_s (tau + t_bl), so the per-pixel blob-coincidence phase is
psi = phi_bl(hit) - Omega_s t_bl(hit) and the blob lights a pixel when
wrap(psi - phi0 - Omega_s tau) ~ 0.  Light-travel delays and lensed
secondary images come out of the per-pixel (t_bl, phi_bl, g).

Crossings are recorded on the Cartesian Kerr-Schild chart, whose time and
azimuth differ from Boyer-Lindquist by functions of r:
t_ks = t_bl + T(r), phi_ks = phi_bl + Phi(r); `bl_time_azimuth_offsets`
integrates T' = (2 M r - Q^2) / Delta and Phi' = a / Delta in closed form
(the subring summary reads it too).  `closure_phase_series` turns a movie
into its closure-phase time series (engine/visibility.py).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from ..physics.orbits import keplerian_omega
from ..physics.spacetime import _charge, ks_radius
from .integrate_ks import STATUS_DISK

# geometrized time unit GM_sun / c^3 in seconds: coordinate times (in M)
# times mass_msun * T_SUN_S are seconds
T_SUN_S = 4.925490947e-6


@dataclasses.dataclass
class HotspotConfig:
    """Orbiting-blob geometry, photometry and movie sampling; the fields of
    `grtrace.engine.hotspot.HotspotConfig`."""
    r_blob: Optional[float] = None  # orbit radius; None -> inside the annulus
    sigma: float = 0.5              # Gaussian blob radius (geometrized)
    phi0: float = 0.0               # blob azimuth at observer time tau = 0
    t_blob: float = 12000.0         # blob color temperature (K) at g = 1
    amplitude: float = 4.0          # emissivity gain vs the disk tone map
    n_frames: int = 64              # movie frames
    n_periods: float = 1.0          # movie length in orbital periods

    def __post_init__(self):
        if self.sigma <= 0.0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")
        if self.n_frames < 2:
            raise ValueError(f"n_frames must be >= 2, got {self.n_frames}")
        if self.n_periods <= 0.0:
            raise ValueError(f"n_periods must be > 0, got {self.n_periods}")

    def orbit_radius(self, r_in, r_out):
        """Blob radius: configured, else placed well inside the annulus."""
        if self.r_blob is not None:
            return float(self.r_blob)
        return float(max(1.6 * r_in, r_in + 3.0 * self.sigma))


def from_jax_hotspot(hotspot) -> HotspotConfig:
    """Convert a `grtrace.engine.hotspot.HotspotConfig` (duck-typed: any
    object with the same attributes) into the port's HotspotConfig."""
    return HotspotConfig(**{f.name: getattr(hotspot, f.name)
                            for f in dataclasses.fields(HotspotConfig)})


def bl_time_azimuth_offsets(r, params):
    """Closed-form T(r), Phi(r) with T' = (2 M r - Q^2)/Delta and
    Phi' = a/Delta, elementwise on r (a tensor).

    Delta = (r - r_plus)(r - r_minus); partial fractions give
    T = c_plus ln(r - r_plus) + c_minus ln(r - r_minus) with
    c_pm = +-(2 M r_pm - Q^2)/(r_plus - r_minus), and
    Phi = a/(r_plus - r_minus) ln((r - r_plus)/(r - r_minus)).
    Schwarzschild (a = Q = 0) degenerates to T = 2M ln(r - 2M), Phi = 0.
    params = (M, a[, Q]) as numbers or a tensor, taken in r's dtype."""
    params = torch.as_tensor(params, dtype=r.dtype, device=r.device)
    mass, a = params[0], params[1]
    qc = _charge(params)
    disc = torch.sqrt(torch.clamp(mass * mass - a * a - qc * qc, min=1e-30))
    r_p, r_m = mass + disc, mass - disc
    two = r_p - r_m
    c_p = (2.0 * mass * r_p - qc * qc) / two
    c_m = -(2.0 * mass * r_m - qc * qc) / two
    lp = torch.log(torch.clamp(r - r_p, min=1e-30))
    lm = torch.log(torch.clamp(r - r_m, min=1e-30))
    return c_p * lp + c_m * lm, (a / two) * (lp - lm)


def hotspot_statics(hit_q, status, redshift, params, omega_s):
    """Per-pixel frame-independent invariants of one disk render:
    (psi, r_hit, g, valid): the blob-coincidence phase
    psi = phi_bl - Omega_s t_bl, the BL emission radius, the redshift
    factor and the disk-hit mask, shaped like hit_q's leading dims."""
    params = torch.as_tensor(params, dtype=hit_q.dtype, device=hit_q.device)
    x, y, z = hit_q[..., 1], hit_q[..., 2], hit_q[..., 3]
    a = params[1]
    r = ks_radius(x, y, z, a)
    # KS azimuth from x + i y = sin(theta) (r + i a) e^{i phit}
    phit = torch.atan2(y * r - x * a, x * r + y * a)
    t_off, phi_off = bl_time_azimuth_offsets(r, params)
    t_bl = hit_q[..., 0] - t_off
    phi_bl = phit - phi_off
    psi = phi_bl - omega_s * t_bl
    return psi, r, redshift, status == STATUS_DISK


def _wrap_pi(x):
    """Wrap to (-pi, pi]."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def shade_hotspot_frames(image, psi, r_hit, g, valid, times, omega_s,
                         r_blob, sigma, phi0, *, t_blob=12000.0,
                         amplitude=4.0):
    """All frames of a movie chunk and its light curve in one batch of
    elementwise work on psi's device.

    image: (H, W, 3) uint8 base disk render; times: (F,) observer times.
    Per frame the blob weight is a Gaussian in disk-plane distance,
    w = exp(-[(r - r_b)^2 + (r_b dphi)^2] / (2 sigma^2)),
    dphi = wrap(psi - phi0 - Omega_s tau); Liouville beaming g^4 scales
    the excess, and the light curve is the pixel sum.

    Returns (frames (F, H, W, 3) uint8, flux (F,), weighted_g (F,),
    centroid (F, 2): the flux-weighted image position in pixels about the
    frame center, (column/right, row/up)), as tensors."""
    from .disk import blackbody_rgb

    dtype, device = psi.dtype, psi.device
    times = torch.as_tensor(np.asarray(times), dtype=dtype, device=device)
    dphi = _wrap_pi(psi[None] - phi0 - omega_s * times[:, None, None])
    d2 = (r_hit - r_blob) ** 2 + (r_blob * dphi) ** 2
    zero = torch.zeros((), dtype=dtype, device=device)
    w = torch.where(valid[None], torch.exp(-0.5 * d2 / (sigma * sigma)),
                    zero)
    g4 = torch.where(valid, g ** 4, zero)
    lum = w * g4[None]                                    # (F, H, W)
    flux = torch.sum(lum, dim=(1, 2))
    safe = torch.clamp(flux, min=1e-30)
    # off the disk g is NaN where the kernel left zero hit rows, and
    # lum * NaN would poison the sum: weigh the disk pixels only
    weighted_g = torch.sum(lum * torch.where(valid, g, zero)[None],
                           dim=(1, 2)) / safe
    h_px, w_px = psi.shape
    ii = torch.arange(h_px, dtype=dtype, device=device) - (h_px - 1) / 2.0
    jj = torch.arange(w_px, dtype=dtype, device=device) - (w_px - 1) / 2.0
    cen_col = torch.sum(lum * jj[None, None, :], dim=(1, 2)) / safe
    cen_row = torch.sum(lum * ii[None, :, None], dim=(1, 2)) / safe
    centroid = torch.stack([cen_col, cen_row], dim=-1)    # (F, 2)

    # additive glow at the observed blob temperature, with the disk's
    # tone-map and gamma conventions
    tone = (1.0 - torch.exp(-amplitude * lum)) ** (1.0 / 2.2)
    rgb = blackbody_rgb(torch.where(valid, g, torch.ones_like(g)) * t_blob)
    glow = tone[..., None] * rgb[None] * 255.0
    frames = torch.clamp(image[None].to(torch.float32) + glow, 0.0,
                         255.0).to(torch.uint8)
    return frames, flux, weighted_g, centroid


def hotspot_movie(image, hit_q, status, redshift, params, r_in, r_out,
                  prograde=True, hotspot=None, *, frames_per_chunk=None,
                  camera_omega=0.0):
    """Movie and light curve from per-pixel invariants, no geodesic work:
    the base image, hit_q, status and redshift of a disk render or of a
    reshaded io.transfer.TransferMap (tensors on one device), and the
    annulus.  Returns the render_hotspot dict without 'result', as host
    numpy arrays.

    `camera_omega`: the camera worldline's rate when the render used a
    rotating camera; the scene then turns with the camera, so the pattern
    speed in the frame-time term is Omega_s - camera_omega.
    `frames_per_chunk` bounds device memory for many frames at large
    sizes (the shading is elementwise, so chunking is exact)."""
    hotspot = hotspot if hotspot is not None else HotspotConfig()
    params = np.asarray(params, np.float64)

    r_blob = hotspot.orbit_radius(r_in, r_out)
    if not (r_in <= r_blob <= r_out):
        raise ValueError(f"blob radius {r_blob} outside the disk annulus "
                         f"[{r_in:.3g}, {r_out:.3g}]")
    omega_s = float(keplerian_omega(
        torch.tensor(r_blob, dtype=torch.float64), float(params[0]),
        float(params[1]), float(params[2]), prograde))
    period = 2.0 * np.pi / abs(omega_s)
    times = np.linspace(0.0, hotspot.n_periods * period, hotspot.n_frames,
                        endpoint=False)

    psi, r_hit, g, valid = hotspot_statics(hit_q, status, redshift, params,
                                           omega_s)
    omega_pattern = omega_s - float(camera_omega)
    chunk = frames_per_chunk or hotspot.n_frames
    frames, flux, wg, cen = [], [], [], []
    for k in range(0, hotspot.n_frames, chunk):
        f, fl, w, c = shade_hotspot_frames(
            image, psi, r_hit, g, valid, times[k:k + chunk], omega_pattern,
            r_blob, hotspot.sigma, hotspot.phi0, t_blob=hotspot.t_blob,
            amplitude=hotspot.amplitude)
        frames.append(f.cpu().numpy())
        flux.append(fl.cpu().numpy().astype(np.float64))
        wg.append(w.cpu().numpy().astype(np.float64))
        cen.append(c.cpu().numpy().astype(np.float64))
    flux = np.concatenate(flux)
    return {
        "frames": np.concatenate(frames),
        "times": times,
        "flux": flux,
        "flux_norm": flux / max(flux.max(), 1e-30),
        "weighted_g": np.concatenate(wg),
        "centroid": np.concatenate(cen),
        "period": period,
        "omega": omega_s,
        "r_blob": r_blob,
    }


def render_hotspot(scene, disk=None, hotspot=None, *, bg_array=None,
                   metrics=None, frames_per_chunk=None, device="cuda"):
    """Disk render (kernel B6 on the card, the default; raises without a
    GPU) + hot-spot movie.  Returns a dict: result (the disk render's
    RenderResult), frames (F, H, W, 3) uint8, times (F,), flux, flux_norm,
    weighted_g, centroid (F, 2), period, omega, r_blob."""
    from .disk import DiskConfig, render_disk, resolve_camera_omega

    disk = disk if disk is not None else DiskConfig()
    result = render_disk(scene, disk, bg_array=bg_array, metrics=metrics,
                         device=device)
    r_in = disk.inner_edge(scene.bh_mass, scene.spin, scene.charge)
    _, camera_omega = resolve_camera_omega(scene, disk)
    out = hotspot_movie(
        result.device("image"), result.device("hit_q"),
        result.device("status"), result.device("redshift"),
        np.array([scene.bh_mass, scene.spin, scene.charge]),
        r_in, disk.r_out, disk.prograde, hotspot,
        frames_per_chunk=frames_per_chunk, camera_omega=camera_omega)
    out["result"] = result
    return out


def closure_phase_series(frames, pixel_rad, triangles, device=None):
    """(F, T) closure phases of a movie, the dynamical-imaging observable:
    an orbiting hot spot swings the closure phases on Earth-sized
    triangles, while station gains and image translation cancel.
    frames: (F, H, W, 3) uint8; `triangles` as
    engine.visibility.closure_phases.  One FFT per frame, on `device` (by
    default the frames' own: the CPU for a numpy movie)."""
    from .visibility import closure_phases, complex_visibility

    series = []
    for fr in frames:
        vis, u, v = complex_visibility(fr, pixel_rad, pad=2, device=device)
        series.append(closure_phases(vis, u, v, triangles))
    return np.asarray(series)


def save_hotspot_artifacts(out, out_dir, gif=True, mass_msun=None, *,
                           plots=True):
    """Write the hot-spot products:

    frames/frame_%04d.png  the movie (io/artifacts.save_image);
    hotspot.gif            animated (Pillow; with `gif`);
    lightcurve.csv         tau, flux, flux_norm, weighted_g and the
                           flux-weighted centroid (cx, cy px) per frame;
    lightcurve.png, astrometry.png  the light curve with its Doppler
                           tracker and the centroid track (matplotlib;
                           with `plots`).

    `mass_msun` adds physical time (minutes) to the light-curve figure."""
    from ..io import artifacts

    frames_dir = os.path.join(out_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    for k, fr in enumerate(out["frames"]):
        artifacts.save_image(fr, os.path.join(frames_dir,
                                              f"frame_{k:04d}.png"))
    if gif:
        from PIL import Image
        pils = [Image.fromarray(fr) for fr in out["frames"]]
        pils[0].save(os.path.join(out_dir, "hotspot.gif"), save_all=True,
                     append_images=pils[1:], duration=70, loop=0)

    rows = np.column_stack([out["times"], out["flux"], out["flux_norm"],
                            out["weighted_g"], out["centroid"]])
    np.savetxt(os.path.join(out_dir, "lightcurve.csv"), rows, delimiter=",",
               header="tau,flux,flux_norm,weighted_g,centroid_x_px,"
                      "centroid_y_px", comments="", fmt="%.8g")
    if not plots:
        return

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(out["times"] / out["period"], out["flux_norm"],
            label="blob flux (normalized)")
    ax2 = ax.twinx()
    ax2.plot(out["times"] / out["period"], out["weighted_g"], color="C1",
             alpha=0.7, label="flux-weighted g")
    ax2.axhline(1.0, color="C1", lw=0.5, ls=":")
    ax.set_xlabel("observer time (orbital periods)")
    ax.set_ylabel("normalized flux")
    ax2.set_ylabel("weighted redshift g")
    title = (f"hot-spot light curve (r = {out['r_blob']:.3g} M, "
             f"P = {out['period']:.4g} M")
    if mass_msun:
        p_min = out["period"] * mass_msun * T_SUN_S / 60.0
        title += f" = {p_min:.1f} min at {mass_msun:.3g} M_sun"
        sec = ax.secondary_xaxis(
            -0.18, functions=(lambda t: t * p_min, lambda m: m / p_min))
        sec.set_xlabel("observer time (minutes)")
    ax.set_title(title + ")")
    lines = ax.get_lines() + ax2.get_lines()[:1]
    ax.legend(lines, [ln.get_label() for ln in lines], loc="upper right")
    fig.savefig(os.path.join(out_dir, "lightcurve.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)

    cen = out["centroid"]
    fig, ax = plt.subplots(figsize=(5.4, 5))
    sc = ax.scatter(cen[:, 0], cen[:, 1], c=out["times"] / out["period"],
                    s=8.0 + 60.0 * out["flux_norm"], cmap="viridis")
    ax.plot(cen[:, 0], cen[:, 1], color="gray", lw=0.5, alpha=0.6)
    ax.set_xlabel("centroid offset, camera-right (px)")
    ax.set_ylabel("centroid offset, camera-up (px)")
    ax.set_title("flare centroid track (flux-weighted)")
    ax.set_aspect("equal")
    ax.invert_yaxis()       # image rows advance along up; match imshow
    fig.colorbar(sc, ax=ax, label="observer time (periods)")
    fig.savefig(os.path.join(out_dir, "astrometry.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)
