"""Disk continuum spectra from rendered intensity maps: SED per image order
— a copy of the numpy-only `grtrace.engine.spectrum`, kept in the port so
that it never imports the JAX package.

Liouville plus the Planck law collapse spectral ray tracing into
post-processing: the observed specific intensity of a thermal surface is

    I_nu_obs(nu) = g^3 B_nu(nu / g, T_em) = B_nu(nu, g T_em)

— a blackbody at the OBSERVED temperature T_obs = g T_em (the g^3
Liouville factor is exactly absorbed by Planck's shape-invariance).  Every
rendered disk/subring pixel already carries intensity = (g T_norm)^4
(engine/disk.shade_disk, engine/subring.shade_subrings), so

    T_obs = t_peak * intensity^{1/4}

recovers the full spectrum of every pixel from the intensity map alone —
no extra geodesics, no per-frequency render passes.  The disk-integrated
SED, its per-order decomposition (the photon ring's contribution to the
continuum), and frequency-sliced image cubes are all elementwise algebra
on data every render computes.

Normalization: B_nu here drops the global 2h/c^2 and the pixel solid
angle — all products are RELATIVE spectra (the framework renders shapes,
not calibrated fluxes; t_peak is the display temperature scale in K,
io.scene/DiskConfig).  The closed-form anchor used by the tests:
integrating B_nu over frequency returns (pi^4/15)(k/h)^4 T_obs^4, i.e.
the SED integral must reproduce the intensity map up to ONE global
constant — pinned to ~1e-3 with a wide log-frequency grid.

No reference counterpart: the reference renders a single bolometric
image (simulation/raytracing.py) and has no disk, no temperatures, no
spectra.
"""
from __future__ import annotations

import numpy as np

# h / k_B in kelvin seconds: x = (h nu) / (k T) = PLANCK_H_K * nu / T
PLANCK_H_K = 4.799243073e-11
# Wien displacement (frequency form): nu_peak = WIEN_HZ_PER_K * T
WIEN_HZ_PER_K = 5.878925757e10


def planck_nu(nu_hz, t_kelvin):
    """Relative Planck curve nu^3 / (e^{h nu / k T} - 1) (2h/c^2 dropped).

    Host-side float64 numpy deliberately: nu^3 at the grid's blue end
    (~1e49) overflows float32, and this is post-processing on maps
    already fetched to the host — there is nothing to accelerate.
    T = 0 pixels (off-disk / unfilled slots) return exactly 0 at every
    frequency: x overflows expm1 to inf and nu^3 / inf == 0.
    """
    t = np.asarray(t_kelvin, np.float64)
    nu = np.asarray(nu_hz, np.float64)
    with np.errstate(over="ignore", divide="ignore"):
        x = PLANCK_H_K * nu / np.maximum(t, 1e-300)
        return nu ** 3 / np.expm1(x)


def spectral_cube(intensity, t_peak, nu_grid_hz):
    """(...pixels) intensity map -> (n_nu, ...pixels) relative I_nu cube.

    Works on any intensity layout — (H, W) disk maps or the subring
    (n_orders, H, W) stack — the frequency axis is prepended.
    """
    t_obs = float(t_peak) * np.asarray(intensity, np.float64) ** 0.25
    nu = np.asarray(nu_grid_hz, np.float64)
    nu = nu.reshape((-1,) + (1,) * t_obs.ndim)
    return planck_nu(nu, t_obs[None])


def default_nu_grid(t_peak, n=160, decades_below=3.0, decades_above=1.6):
    """Log frequency grid bracketing the Wien peak of t_peak: wide enough
    that the trapezoid SED integral captures ~all of T_obs^4 for every
    T_obs <= t_peak (and the redshifted tail below)."""
    nu_pk = WIEN_HZ_PER_K * float(t_peak)
    return np.logspace(np.log10(nu_pk) - decades_below,
                       np.log10(nu_pk) + decades_above, n)


def disk_sed(intensity, t_peak, nu_grid_hz=None):
    """Disk-integrated relative SED per leading layer axis.

    intensity: (H, W) or (n_orders, H, W).  Returns (nu_grid_hz,
    sed) with sed of shape (n_nu,) or (n_orders, n_nu): the pixel sum of
    the spectral cube — the continuum spectrum an unresolved observer
    measures, decomposed by image order for the subring stack.
    """
    inten = np.asarray(intensity, np.float64)
    if nu_grid_hz is None:
        nu_grid_hz = default_nu_grid(t_peak)
    cube = np.asarray(spectral_cube(inten, t_peak, nu_grid_hz))
    sed = cube.sum(axis=(-2, -1))        # (n_nu,) or (n_nu, n_orders)
    if inten.ndim == 3:
        sed = sed.T                      # (n_orders, n_nu)
    return np.asarray(nu_grid_hz), sed
