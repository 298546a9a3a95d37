"""Interferometric visibilities: the u-v-plane observables of a render — the
torch counterpart of `grtrace.engine.visibility`.

Radio interferometers (the EHT) sample an image's 2-D Fourier transform,
the complex visibility V(u, v), at baselines u, v measured in wavelengths.
This module turns a render into those observables:

  * the normalized visibility amplitude map |V(u, v)| (V(0,0) = 1) and
    the complex map, by `torch.fft.fft2` on the image's device (JAX runs
    `jnp.fft.fft2` outside any kernel, so this is its counterpart),
  * the azimuthally averaged radial profile |V|(b) vs baseline length,
  * the first-null baseline, the thin-ring diameter estimator: a ring of
    angular diameter theta_d has V(b) = J0(pi theta_d b), first null at
    b = j01/(pi theta_d), so theta_d = j01/(pi b_null),
  * closure phases on closed baseline triangles.

The profile, null, closure and unit conversions are host numpy, copied
from the JAX module.  The camera sits at r_obs (30 M by default), not at
infinity: `camera_to_earth` maps camera angles to angles at Earth.
"""
from __future__ import annotations

import numpy as np
import torch

J01 = 2.404825557695773        # first zero of the Bessel J0
M_SUN_M = 1476.62504           # geometrized solar mass GM_sun/c^2 (m)
PC_M = 3.0856775814913673e16   # meters per parsec

# the two sources black-hole imaging targets (EHT 2019/2022; GRAVITY 2018):
# mass in solar masses, distance in Mpc
PRESETS = {
    "m87": {"mass_msun": 6.5e9, "distance_mpc": 16.8},
    "sgra": {"mass_msun": 4.297e6, "distance_mpc": 8.277e-3},
}


def camera_to_earth(r_obs, mass, mass_msun, distance_mpc):
    """Camera-angle -> Earth-angle conversion factor: a small camera angle
    alpha maps to impact parameter b = alpha r_obs / sqrt(1 - 2 mass /
    r_obs), which subtends b M_geom / D at Earth."""
    return (r_obs / np.sqrt(1.0 - 2.0 * mass / r_obs)
            * mass_msun * M_SUN_M / (distance_mpc * 1e6 * PC_M))


def _luminance(image, device=None):
    """(H, W [,3]) uint8 or float array or tensor -> (H, W) float64
    intensity (Rec.601) on the image's device (a numpy image on `device`,
    by default the CPU)."""
    img = torch.as_tensor(np.asarray(image) if not isinstance(
        image, torch.Tensor) else image, device=device).to(torch.float64)
    if img.ndim == 3:
        img = img @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float64,
                                 device=img.device)
    return img


def _axes(ph, pw, pixel_rad):
    u = np.fft.fftshift(np.fft.fftfreq(pw, d=pixel_rad))
    v = np.fft.fftshift(np.fft.fftfreq(ph, d=pixel_rad))
    return u, v


def visibility_map(image, pixel_rad, pad=4, device=None):
    """|V(u, v)| of an image with square pixels of `pixel_rad` radians.

    Returns (amp (pH, pW) with the zero baseline at the centre, u (pW,),
    v (pH,) baselines in wavelengths), as host numpy; the FFT runs on the
    image's device.  `pad` zero-pads the image by that factor, which
    interpolates the u-v plane and sharpens the null's localization."""
    lum = _luminance(image, device)
    h, w = lum.shape
    ph, pw = int(pad) * h, int(pad) * w
    vis = torch.fft.fft2(lum, s=(ph, pw))
    amp = torch.abs(vis) / torch.clamp(torch.abs(vis[0, 0]), min=1e-30)
    amp = torch.fft.fftshift(amp).cpu().numpy()
    return (amp,) + _axes(ph, pw, pixel_rad)


def complex_visibility(image, pixel_rad, pad=4, device=None):
    """Complex V(u, v) (fftshifted, V(0,0) = 1, complex64 as in the JAX
    module) + (u, v) axes: the phase-bearing twin of visibility_map, for
    closure quantities."""
    lum = _luminance(image, device).to(torch.complex64)
    h, w = lum.shape
    ph, pw = int(pad) * h, int(pad) * w
    vis = torch.fft.fft2(lum, s=(ph, pw))
    vis = torch.fft.fftshift(vis / vis[0, 0]).cpu().numpy()
    return (vis,) + _axes(ph, pw, pixel_rad)


def radial_profile(amp, u, v, n_bins=None, b_max=None):
    """Azimuthal average of |V|: (baseline (B,), mean amp (B,)).  `b_max`
    crops the profile (the structure lives at a small fraction of the
    Nyquist baseline); empty bins are dropped (zeros there would fake
    nulls)."""
    uu, vv = np.meshgrid(u, v)
    b = np.hypot(uu, vv).ravel()
    a = np.asarray(amp).ravel()
    if b_max is None:
        b_max = min(u.max(), v.max())
    if n_bins is None:
        n_bins = min(len(u), len(v)) // 2
    edges = np.linspace(0.0, b_max, n_bins + 1)
    idx = np.clip(np.digitize(b, edges) - 1, 0, n_bins - 1)
    keep = b <= b_max
    sums = np.bincount(idx[keep], weights=a[keep], minlength=n_bins)
    cnts = np.bincount(idx[keep], minlength=n_bins)
    centers = 0.5 * (edges[1:] + edges[:-1])
    filled = cnts > 0
    return centers[filled], sums[filled] / cnts[filled]


def first_null(baselines, amps, prominence=0.005, depth=0.25):
    """Baseline of the first significant local minimum of |V|(b), refined
    by a parabola: deep (below `depth`) and followed by a rebound of at
    least `prominence`.  np.nan when there is none in range."""
    a = np.asarray(amps)
    for k in range(1, len(a) - 1):
        if a[k] <= a[k - 1] and a[k] < a[k + 1]:
            if a[k] >= depth:
                continue
            rebound = a[k + 1:min(k + 1 + max(3, len(a) // 20),
                                  len(a))].max() - a[k]
            if rebound < prominence:
                continue
            denom = a[k - 1] - 2.0 * a[k] + a[k + 1]
            shift = 0.5 * (a[k - 1] - a[k + 1]) / denom if denom != 0 \
                else 0.0
            db = 0.5 * (baselines[k + 1] - baselines[k - 1])
            return float(baselines[k] + shift * db)
    return float("nan")


def ring_diameter_from_null(b_null):
    """Thin-ring estimator: angular diameter (radians) from the first
    visibility null, theta_d = j01 / (pi b_null)."""
    return J01 / (np.pi * b_null)


def closure_phases(vis, u, v, triangles):
    """Closure phases (radians, in (-pi, pi]) on (T, 3, 2) baseline
    triangles whose legs sum to about zero.  Each leg's V is the nearest
    grid point's; the snapped legs must close exactly, which makes any
    image translation cancel."""
    tri = np.asarray(triangles, np.float64)
    if tri.ndim != 3 or tri.shape[1:] != (3, 2):
        raise ValueError(f"triangles must be (T, 3, 2), got {tri.shape}")

    du = u[1] - u[0]
    dv = v[1] - v[0]
    ju = np.clip(np.round((tri[..., 0] - u[0]) / du).astype(int),
                 0, len(u) - 1)
    jv = np.clip(np.round((tri[..., 1] - v[0]) / dv).astype(int),
                 0, len(v) - 1)
    snapped_sum = np.abs(u[ju].sum(axis=1)).max() + \
        np.abs(v[jv].sum(axis=1)).max()
    if snapped_sum > 1e-6 * max(u.max(), v.max()):
        raise ValueError("triangle legs do not close on the u-v grid "
                         "(snapped sum != 0)")
    legs = np.asarray(vis)[jv, ju]                     # (T, 3)
    return np.angle(legs.prod(axis=1))
