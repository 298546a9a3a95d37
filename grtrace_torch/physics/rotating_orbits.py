"""Equatorial circular orbits of the rotating regular families — the torch
counterpart of `grtrace.physics.rotating_orbits`.

Every quantity comes from the covariant Boyer-Lindquist block of the
mass-function family on the equator,

    g_tt = -(1 - 2 m(r) / r),  g_tph = -2 a m(r) / r,
    g_phph = r^2 + a^2 + 2 a^2 m(r) / r,

through the standard circular-geodesic formulas, with the radial
derivatives by autodiff (`torch.func.grad`, batched by `torch.func.vmap`,
where JAX takes `jax.grad` / `jax.vmap`):

    Omega = (-g_tph,r +- sqrt(g_tph,r^2 - g_tt,r g_phph,r)) / g_phph,r
    u^t   = 1 / sqrt(-(g_tt + 2 Omega g_tph + Omega^2 g_phph))
    E     = -(g_tt + Omega g_tph) u^t,   L = (g_tph + Omega g_phph) u^t

The ISCO is the minimum of E(r) outside the circular photon orbit (scan and
bisection, JAX's grids and counts); the Novikov-Thorne flux is the Page &
Thorne quadrature with these quantities; `epicyclic_rotating` the
radial and vertical epicyclic frequencies from the Boyer-Lindquist inverse
metric `rotating_bl_g_inv`.  With m(r) = M - Q^2 / 2r they reproduce the
Kerr-Newman layer (physics/orbits.py).  These run on the host in float64
(the theory layer) or elementwise on the rays' device (the disk's
redshift); `m_fn` is a mass function of physics/rotating_regular.py.
"""
from __future__ import annotations

import math

import torch
from torch.func import grad, vmap

from .rotating_regular import MASS_FN


def bl_equatorial_metric(r, params, m_fn):
    """(g_tt, g_tph, g_phph) of the equatorial Boyer-Lindquist block."""
    a = params[1]
    m = m_fn(r, params)
    return (-(1.0 - 2.0 * m / r),
            -2.0 * a * m / r,
            r * r + a * a + 2.0 * a * a * m / r)


def _d_metric(r, params, m_fn):
    """(g_tt,r, g_tph,r, g_phph,r) elementwise in r."""
    out = []
    for i in range(3):
        d = vmap(grad(lambda rr, i=i: bl_equatorial_metric(rr, params,
                                                           m_fn)[i]))
        out.append(d(r.reshape(-1)).reshape(r.shape))
    return out


def keplerian_omega_rotating(r, params, m_fn, prograde=True):
    """Coordinate angular velocity of the circular equatorial geodesic at
    r (elementwise), from the metric-derivative quadratic (prograde: the +
    branch for a >= 0)."""
    d_tt, d_tph, d_phph = _d_metric(r, params, m_fn)
    disc = torch.sqrt(torch.clamp(d_tph * d_tph - d_tt * d_phph, min=0.0))
    sign = 1.0 if prograde else -1.0
    return (-d_tph + sign * disc) / d_phph


def circular_u_t_rotating(r, params, m_fn, prograde=True):
    """(u^t, Omega) of the circular geodesic at Boyer-Lindquist radius r."""
    omega = keplerian_omega_rotating(r, params, m_fn, prograde)
    g_tt, g_tph, g_phph = bl_equatorial_metric(r, params, m_fn)
    norm = -(g_tt + 2.0 * omega * g_tph + omega * omega * g_phph)
    return 1.0 / torch.sqrt(norm), omega


def circular_e_l_rotating(r, params, m_fn, prograde=True):
    """Killing charges (E = -u_t, L = u_phi) of the circular geodesic."""
    u_t, omega = circular_u_t_rotating(r, params, m_fn, prograde)
    g_tt, g_tph, g_phph = bl_equatorial_metric(r, params, m_fn)
    energy = -(g_tt + omega * g_tph) * u_t
    l_z = (g_tph + omega * g_phph) * u_t
    return energy, l_z


def _scalar_grad(fn):
    """d fn / dr of a scalar function of a 0-dim r, applied elementwise."""
    d = vmap(grad(fn))
    return lambda r: d(r.reshape(-1)).reshape(r.shape)


def _photon_orbit_radius(params, m_fn, prograde=True, iters=60):
    """Equatorial circular photon orbit: where the circular-geodesic
    normalization -(g_tt + 2 W g_tph + W^2 g_phph) crosses zero, by an
    inward scan from 4 M (256 points) and `iters` bisections; 0.3 M when
    the scan finds none."""
    from .rotating_regular import _linspace
    mass = params[0]

    def norm(r):
        omega = keplerian_omega_rotating(r, params, m_fn, prograde)
        g_tt, g_tph, g_phph = bl_equatorial_metric(r, params, m_fn)
        return -(g_tt + 2.0 * omega * g_tph + omega * omega * g_phph)

    rs = _linspace(4.0 * mass, 0.3 * mass, 256)
    neg = ~(norm(rs) > 0.0)                   # inside/at the photon orbit
    has = bool(neg.any())
    idx = int(torch.argmax(neg.to(torch.int8)))
    lo, hi = rs[idx], rs[max(idx - 1, 0)]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        inside = bool(~(norm(mid[None])[0] > 0.0))
        lo, hi = (mid, hi) if inside else (lo, mid)
    return 0.5 * (lo + hi) if has else 0.3 * mass


def isco_rotating(params, m_fn, prograde=True, n_scan=512, iters=60):
    """ISCO of the mass-function family: the minimum of E(r) outside the
    circular photon orbit, by a geometric scan of dE/dr from 1.02 r_ph to
    40 M (n_scan points) and `iters` bisections; NaN when no stable
    circular orbit exists."""
    from .rotating_regular import _linspace
    mass = params[0]
    r_ph = _photon_orbit_radius(params, m_fn, prograde)
    de = _scalar_grad(lambda r: circular_e_l_rotating(
        r, params, m_fn, prograde)[0])
    u = _linspace(torch.zeros_like(mass), torch.ones_like(mass), n_scan)
    r_lo = r_ph * 1.02
    rs = r_lo * (40.0 * mass / r_lo) ** u
    sl = de(rs)
    want = (sl[:-1] < 0.0) & (sl[1:] > 0.0)
    has = bool(want.any())
    idx = int(torch.argmax(want.to(torch.int8)))
    lo, hi = rs[idx], rs[idx + 1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = bool(de(mid[None])[0] < 0.0)
        lo, hi = (mid, hi) if neg else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if has else torch.full_like(root, math.nan)


def static_observer_u_t_rotating(r, theta, params, m_fn):
    """u^t of the static observer at Boyer-Lindquist (r, theta):
    1 / sqrt(-g_tt), g_tt = -(1 - 2 m(r) r / Sigma)."""
    a = params[1]
    m = m_fn(r, params)
    sigma = r * r + a * a * torch.cos(theta) ** 2
    return 1.0 / torch.sqrt(1.0 - 2.0 * m * r / sigma)


def redshift_factor_rotating(energy, l_z, r_em, r_obs, params, m_fn,
                             prograde=True, theta_obs=math.pi / 2):
    """g = nu_obs / nu_em for photons with Killing charges (E, L_z)
    emitted by the circular equatorial geodesic at r_em (elementwise),
    received by a static observer at (r_obs, theta_obs)."""
    u_t_em, omega = circular_u_t_rotating(r_em, params, m_fn, prograde)
    theta_obs = torch.as_tensor(theta_obs, dtype=r_em.dtype,
                                device=r_em.device)
    u_t_obs = static_observer_u_t_rotating(r_obs, theta_obs, params, m_fn)
    return (energy * u_t_obs) / (u_t_em * (energy - omega * l_z))


def page_thorne_flux_rotating(r_grid, params, m_fn, prograde=True):
    """Novikov-Thorne flux of the mass-function family on an increasing
    radial grid: the Page & Thorne (1974) quadrature with the circular-
    orbit quantities above and sqrt(-det g3) = sqrt(g_rr (g_tt g_phph -
    g_tph^2)), g_rr = r^2 / Delta on the equator."""
    a = params[1]
    e, l_z = circular_e_l_rotating(r_grid, params, m_fn, prograde)
    omega = keplerian_omega_rotating(r_grid, params, m_fn, prograde)
    dl_dr = _scalar_grad(lambda r: circular_e_l_rotating(
        r, params, m_fn, prograde)[1])(r_grid)
    domega_dr = _scalar_grad(lambda r: keplerian_omega_rotating(
        r, params, m_fn, prograde))(r_grid)

    g_tt, g_tph, g_phph = bl_equatorial_metric(r_grid, params, m_fn)
    delta = r_grid * r_grid - 2.0 * m_fn(r_grid, params) * r_grid + a * a
    g_rr = r_grid * r_grid / delta
    g3 = torch.sqrt(torch.clamp(-g_rr * (g_tt * g_phph - g_tph * g_tph),
                                min=1e-30))

    integrand = (e - omega * l_z) * dl_dr
    dr = torch.diff(r_grid)
    segments = 0.5 * (integrand[1:] + integrand[:-1]) * dr
    cumulative = torch.cat([torch.zeros((1,), dtype=r_grid.dtype,
                                        device=r_grid.device),
                            torch.cumsum(segments, 0)])
    flux = (-domega_dr * cumulative
            / ((e - omega * l_z) ** 2 * 4.0 * math.pi * g3))
    return torch.clamp(flux, min=0.0)


def rotating_disk_inner_edge(metric, mass, spin, p1, prograde=True):
    """The family's ISCO on the host in float64, the disk's default inner
    edge; raises ValueError when it has no stable circular orbits."""
    params = torch.tensor([mass, spin, p1], dtype=torch.float64)
    r = float(isco_rotating(params, MASS_FN[metric], prograde))
    if not math.isfinite(r):
        raise ValueError(
            f"{metric} at (a, p) = ({spin:g}, {p1:g}) has no stable "
            "circular orbits — pass an explicit disk r_in")
    return r


def rotating_bl_g_inv(q, params, m_fn):
    """Contravariant Boyer-Lindquist metric of the mass-function family at
    q (4,) = (t, r, theta, phi): spacetime.kerr_g_inv with Delta = r^2 -
    2 m(r) r + a^2 and r^2 + a^2 - Delta = 2 m(r) r in the t-phi term."""
    a = params[1]
    r, th = q[1], q[2]
    m = m_fn(r, params)
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = sin_th * sin_th
    sigma = r * r + a * a * cos_th * cos_th
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a

    inv_sd = 1.0 / (sigma * delta)
    g_tt = -(r2a2 * r2a2 - a * a * delta * sin2) * inv_sd
    g_tp = -(r2a2 - delta) * a * inv_sd
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_pp = (delta - a * a * sin2) * inv_sd / sin2
    zero = torch.zeros_like(g_tt)
    return torch.stack([torch.stack([g_tt, zero, zero, g_tp]),
                        torch.stack([zero, g_rr, zero, zero]),
                        torch.stack([zero, zero, g_thth, zero]),
                        torch.stack([g_tp, zero, zero, g_pp])])


def epicyclic_rotating(r, params, m_fn, prograde=True):
    """(Omega_phi, kappa, Omega_theta) of the circular orbit at r (a
    0-dim tensor): the radial and polar effective potentials' second
    derivatives by nested autodiff, with the circular-orbit Killing
    charges above and `rotating_bl_g_inv` (rotation keeps Omega_theta !=
    Omega_phi: Lense-Thirring precession survives the regular core)."""
    r = torch.as_tensor(r, dtype=params.dtype)
    energy, l_z = circular_e_l_rotating(r[None], params, m_fn, prograde)
    u_t, omega = circular_u_t_rotating(r[None], params, m_fn, prograde)
    energy, l_z, u_t, omega = energy[0], l_z[0], u_t[0], omega[0]
    half_pi = torch.full_like(r, 0.5 * math.pi)

    def w_quad(rr, th):
        zero = torch.zeros_like(rr)
        g = rotating_bl_g_inv(torch.stack([zero, rr, th, zero]), params,
                              m_fn)
        return (g[0, 0] * energy * energy - 2.0 * g[0, 3] * energy * l_z
                + g[3, 3] * l_z * l_z)

    def rad_pot(rr):
        zero = torch.zeros_like(rr)
        g = rotating_bl_g_inv(torch.stack([zero, rr, 0.5 * math.pi + zero,
                                           zero]), params, m_fn)
        return -g[1, 1] * (1.0 + w_quad(rr, 0.5 * math.pi + zero))

    def pol_pot(th):
        g = rotating_bl_g_inv(torch.stack([torch.zeros_like(th),
                                           r + 0.0 * th, th,
                                           torch.zeros_like(th)]), params,
                              m_fn)
        return -g[2, 2] * (1.0 + w_quad(r + 0.0 * th, th))

    kappa2 = -0.5 * grad(grad(rad_pot))(r) / (u_t * u_t)
    vert2 = -0.5 * grad(grad(pol_pot))(half_pi) / (u_t * u_t)
    return (torch.abs(omega), torch.sqrt(torch.clamp(kappa2, min=0.0)),
            torch.sqrt(torch.clamp(vert2, min=0.0)))
