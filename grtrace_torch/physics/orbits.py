"""Equatorial circular orbits in the Kerr-Newman family — the torch
counterpart of `grtrace.physics.orbits`, and what a thin accretion disk
needs to shade itself: the Keplerian angular velocity of a circular
equatorial geodesic, the emitter 4-velocity normalization, the ISCO (the
inner disk edge), the Novikov-Thorne flux and the combined gravitational +
Doppler redshift of a photon received from an orbiting emitter.

All quantities are chart-invariant scalars (Omega = dphi/dt, u^t, the
redshift g = nu_obs/nu_em), evaluated from the Boyer-Lindquist equatorial
metric (`spacetime.kerr_g_inv`): rays traced on the Cartesian Kerr-Schild
chart are shaded with them directly, because E = -p_t and
L_z = x p_y - y p_x are the same Killing constants in both charts.

Functions are elementwise on tensors, with the JAX module's association.
`zamo_omega` and `keplerian_omega` also give the moving disk camera its
rate (engine/disk.resolve_camera_omega).
"""
from __future__ import annotations

import math

import torch

from .spacetime import _charge, kerr_g_inv


def _tensor(x):
    """A number as a float64 tensor; a tensor as it is."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float64)


def _cbrt(x):
    """Real cube root that keeps the sign (torch has no cbrt): within a
    few float64 ulps of jnp.cbrt (tests/test_torch_orbits.py)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def isco_radius(mass, a, prograde=True):
    """ISCO radius of a Kerr hole (Bardeen-Press-Teukolsky 1972):
    Z1 = 1 + (1-chi^2)^(1/3) [(1+chi)^(1/3) + (1-chi)^(1/3)],
    Z2 = sqrt(3 chi^2 + Z1^2),
    r_isco = M (3 + Z2 -+ sqrt((3-Z1)(3+Z1+2Z2)))   (- prograde, + retro).
    Numbers are taken as float64."""
    mass, a = _tensor(mass), _tensor(a)
    chi = torch.clamp(a / mass, -1.0, 1.0)
    z1 = 1.0 + _cbrt(1.0 - chi * chi) * (_cbrt(1.0 + chi) + _cbrt(1.0 - chi))
    z2 = torch.sqrt(3.0 * chi * chi + z1 * z1)
    root = torch.sqrt(torch.clamp((3.0 - z1) * (3.0 + z1 + 2.0 * z2),
                                  min=0.0))
    sign = -1.0 if prograde else 1.0
    return mass * (3.0 + z2 + sign * root)


def keplerian_omega(r, mass, a, charge=0.0, prograde=True):
    """Angular velocity Omega = dphi/dt of an equatorial circular geodesic:
    +- sqrt(M r - Q^2) / (r^2 +- a sqrt(M r - Q^2))."""
    s = torch.sqrt(torch.clamp(mass * r - charge * charge, min=0.0))
    sign = 1.0 if prograde else -1.0
    return sign * s / (r * r + sign * a * s)


def _invert_bl_metric(g_inv):
    """Invert Boyer-Lindquist-structured (..., 4, 4) metrics in closed form:
    (r, theta) are diagonal and only (t, phi) couple, so the inverse is the
    reciprocal diagonals plus the 2x2 (t, phi) inverse."""
    det2 = g_inv[..., 0, 0] * g_inv[..., 3, 3] \
        - g_inv[..., 0, 3] * g_inv[..., 3, 0]
    z = torch.zeros_like(det2)
    rows = ((g_inv[..., 3, 3] / det2, z, z, -g_inv[..., 0, 3] / det2),
            (z, 1.0 / g_inv[..., 1, 1], z, z),
            (z, z, 1.0 / g_inv[..., 2, 2], z),
            (-g_inv[..., 3, 0] / det2, z, z, g_inv[..., 0, 0] / det2))
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _bl_point(r, theta):
    """(..., 4) Boyer-Lindquist points (0, r, theta, 0)."""
    zero = torch.zeros_like(r)
    th = torch.as_tensor(theta, dtype=r.dtype, device=r.device)
    return torch.stack([zero, r, th.expand(r.shape), zero], dim=-1)


def equatorial_g_cov(r, params):
    """Covariant Boyer-Lindquist metric at (r, theta = pi/2), (..., 4, 4):
    the inverse of the contravariant kerr_g_inv."""
    return _invert_bl_metric(kerr_g_inv(_bl_point(r, math.pi / 2), params))


def circular_u_t(r, params, prograde=True):
    """(u^t, Omega) of the circular equatorial emitter at BL radius r:
    u^t = 1 / sqrt(-(g_tt + 2 Omega g_tph + Omega^2 g_phph))."""
    omega = keplerian_omega(r, params[0], params[1], _charge(params),
                            prograde)
    g = equatorial_g_cov(r, params)
    denom = -(g[..., 0, 0] + 2.0 * omega * g[..., 0, 3]
              + omega * omega * g[..., 3, 3])
    return 1.0 / torch.sqrt(torch.clamp(denom, min=1e-30)), omega


def static_u_t(r, params, theta=math.pi / 2):
    """u^t of a static observer at BL (r, theta): 1/sqrt(-g_tt)."""
    g = _invert_bl_metric(kerr_g_inv(_bl_point(r, theta), params))
    return 1.0 / torch.sqrt(torch.clamp(-g[..., 0, 0], min=1e-30))


def rotating_u_t(r, params, theta=math.pi / 2, omega=0.0):
    """u^t of the rotating observer u = u^t (d_t + omega d_phi) at BL
    (r, theta); a static observer at omega = 0 (the sqrt is clamped,
    callers validate the regime)."""
    g = _invert_bl_metric(kerr_g_inv(_bl_point(r, theta), params))
    denom = -(g[..., 0, 0] + 2.0 * omega * g[..., 0, 3]
              + omega * omega * g[..., 3, 3])
    return 1.0 / torch.sqrt(torch.clamp(denom, min=1e-30))


def zamo_omega(r, params, theta=math.pi / 2):
    """Angular velocity omega = -g_tph / g_phph of the zero-angular-momentum
    observer (ZAMO) at BL (r, theta): the locally nonrotating frame dragged
    by the hole (static in Schwarzschild, where g_tph = 0)."""
    g = _invert_bl_metric(kerr_g_inv(_bl_point(r, theta), params))
    return -g[..., 0, 3] / g[..., 3, 3]


def circular_e_lz(r, params, prograde=True):
    """Specific energy E = -u_t and axial angular momentum L = u_phi of the
    circular equatorial geodesic at BL radius r, lowered through the
    metric."""
    u_t, omega = circular_u_t(r, params, prograde)
    g = equatorial_g_cov(r, params)
    energy = -u_t * (g[..., 0, 0] + omega * g[..., 0, 3])
    l_z = u_t * (g[..., 0, 3] + omega * g[..., 3, 3])
    return energy, l_z


def _sqrt_g3_equatorial(r, params):
    """sqrt(-det g3) of the equatorial (t, r, phi) metric block, the
    proper-area measure of the Page-Thorne flux."""
    g = equatorial_g_cov(r, params)
    idx = torch.tensor([0, 1, 3], device=g.device)
    g3 = g[..., idx, :][..., :, idx]
    return torch.sqrt(torch.clamp(-torch.linalg.det(g3), min=1e-30))


def page_thorne_flux(r_grid, params, prograde=True):
    """Time-averaged flux F(r) of the relativistic thin disk (Novikov-
    Thorne) on the 1-D `r_grid`, from the Page & Thorne (1974) law (11b):
        F(r) = -(Mdot / (4 pi sqrt(-g3))) dOmega/dr (E - Omega L)^-2
               * int_{r0}^{r} (E - Omega L) dL/dr dr'
    with Mdot = 1, the radial derivatives by autodiff (`torch.func.grad`
    under `vmap`, as JAX's `jax.grad`) and the integral by trapezoid from
    r_grid[0], the torque-free inner boundary."""
    params = torch.as_tensor(params, dtype=r_grid.dtype,
                             device=r_grid.device)
    mass, a, q = params[0], params[1], _charge(params)

    e, l = circular_e_lz(r_grid, params, prograde)
    omega = keplerian_omega(r_grid, mass, a, q, prograde)
    dl_dr = torch.func.vmap(torch.func.grad(
        lambda r: circular_e_lz(r, params, prograde)[1]))(r_grid)
    domega_dr = torch.func.vmap(torch.func.grad(
        lambda r: keplerian_omega(r, mass, a, q, prograde)))(r_grid)

    integrand = (e - omega * l) * dl_dr
    dr = torch.diff(r_grid)
    segments = 0.5 * (integrand[1:] + integrand[:-1]) * dr
    cumulative = torch.cat([torch.zeros((1,), dtype=r_grid.dtype,
                                        device=r_grid.device),
                            torch.cumsum(segments, dim=0)])
    sqrt_g3 = _sqrt_g3_equatorial(r_grid, params)
    flux = (-domega_dr * cumulative
            / ((e - omega * l) ** 2 * 4.0 * math.pi * sqrt_g3))
    return torch.clamp(flux, min=0.0)


def redshift_factor(energy, l_z, r_em, r_obs, params, prograde=True,
                    theta_obs=math.pi / 2, omega_obs=0.0):
    """g = nu_obs / nu_em for photons with conserved (E = -p_t, L_z)
    emitted by circular equatorial geodesics at r_em and received by the
    observer u^t (d_t + omega_obs d_phi) at (r_obs, theta_obs):
        g = u_obs^t (E - omega_obs L_z) / (u_em^t (E - Omega L_z)).
    Homogeneous of degree zero in (E, L_z), so the past-directed tracing
    convention cancels."""
    u_t_em, omega = circular_u_t(r_em, params, prograde)
    u_t_obs = rotating_u_t(r_obs, params, theta_obs, omega_obs)
    return ((energy - omega_obs * l_z) * u_t_obs) / (
        u_t_em * (energy - omega * l_z))
