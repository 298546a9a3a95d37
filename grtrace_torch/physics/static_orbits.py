"""Circular orbits and disk physics for the static families — the torch
counterpart of `grtrace.physics.static_orbits`.

For ds^2 = -f dt^2 + dr^2/f + r^2 dOmega^2 the circular timelike geodesic
at areal radius r has

    Omega^2 = f'(r) / (2 r),   u^t = 1 / sqrt(f - r f' / 2),
    E = f u^t,   L = r^2 Omega u^t,

and the ISCO (and Kottler's outer marginally stable orbit) is where
d(L^2)/dr changes sign, found by a geometric scan and fixed-count
bisection.  Every derivative is `torch.func.grad` (JAX takes `jax.grad`),
nested for the second derivatives; the scans and bisections keep JAX's
counts.  Host float64 unless the caller passes other tensors.
"""
from __future__ import annotations

import math

import torch
from torch.func import grad, vmap

from .static_metrics import STATIC_F, _as_params, photon_sphere


def _fp(f_fn, r, params):
    return grad(f_fn, argnums=0)(r, params)


def _map(fn, r):
    """fn over the elements of r (any shape)."""
    r = torch.as_tensor(r)
    if r.dim() == 0:
        return fn(r)
    return vmap(fn)(r.reshape(-1)).reshape(r.shape)


def keplerian_omega_static(r, f_fn, params, prograde=True):
    """Omega = +-sqrt(f' / (2 r)); NaN where f' < 0."""
    def one(rr):
        mag = torch.sqrt(_fp(f_fn, rr, params) / (2.0 * rr))
        return mag if prograde else -mag
    return _map(one, r)


def circular_u_t_static(r, f_fn, params):
    """u^t = 1 / sqrt(f - r f' / 2); NaN inside the photon sphere."""
    def one(rr):
        return 1.0 / torch.sqrt(f_fn(rr, params)
                                - 0.5 * rr * _fp(f_fn, rr, params))
    return _map(one, r)


def circular_e_l_static(r, f_fn, params, prograde=True):
    """Killing charges (E, L) = (f u^t, r^2 Omega u^t)."""
    u_t = circular_u_t_static(r, f_fn, params)
    omega = keplerian_omega_static(r, f_fn, params, prograde)
    return f_fn(r, params) * u_t, r * r * omega * u_t


def _l2(r, f_fn, params):
    """L^2(r) = r^3 f' / (2 f - r f')."""
    f = f_fn(r, params)
    fp = _fp(f_fn, r, params)
    return r ** 3 * fp / (2.0 * f - r * fp)


def _stability_scan(f_fn, params, r_lo, r_hi, n_scan, rising, iters):
    """First sign change of d(L^2)/dr (-/+ when `rising`, the ISCO; +/-
    otherwise, the OSCO) on a geometric scan of [r_lo, r_hi], refined by
    `iters` bisections; NaN when there is none."""
    dl2 = grad(_l2, argnums=0)
    r_lo = torch.as_tensor(r_lo, dtype=params.dtype)
    r_hi = torch.as_tensor(r_hi, dtype=params.dtype)
    u = torch.linspace(0.0, 1.0, n_scan, dtype=params.dtype)
    rs = r_lo * (r_hi / r_lo) ** u
    sl = vmap(lambda r: dl2(r, f_fn, params))(rs)
    if rising:
        want = (sl[:-1] < 0.0) & (sl[1:] > 0.0)
    else:
        want = (sl[:-1] > 0.0) & (sl[1:] < 0.0)
    has = bool(want.any())
    idx = int(torch.argmax(want.to(torch.int8)))
    lo, hi = rs[idx], rs[idx + 1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = dl2(mid, f_fn, params)
        neg = bool(s < 0.0) if rising else bool(s > 0.0)
        lo, hi = (mid, hi) if neg else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if has else torch.full_like(root, math.nan)


def isco_static(f_fn, params, r_hi=None, n_scan=512, iters=60):
    """Innermost stable circular orbit on [1.001 r_ph, r_hi (40 M)]."""
    params = _as_params(params)
    r_ph = photon_sphere(f_fn, params)
    if r_hi is None:
        r_hi = 40.0 * params[0]
    return _stability_scan(f_fn, params, r_ph * 1.001, r_hi, n_scan, True,
                           iters)


def osco_static(f_fn, params, r_hi, n_scan=512, iters=60):
    """Outermost stable circular orbit (Kottler's cosmological tide); NaN
    for the asymptotically flat families."""
    params = _as_params(params)
    r_ph = photon_sphere(f_fn, params)
    return _stability_scan(f_fn, params, r_ph * 1.001, r_hi, n_scan, False,
                           iters)


def _w_second(r, f_fn, params, l2):
    def w(rr):
        return f_fn(rr, params) * (1.0 + l2 / (rr * rr))
    return grad(grad(w))(r)


def epicyclic_static(r, f_fn, params):
    """Coordinate-time (Omega_phi, kappa_r, Omega_theta) of the circular
    orbit at r: kappa^2 = W''(r) / (2 (u^t)^2) with W = f (1 + L^2 / r^2)
    at the circular L; Omega_theta = Omega_phi."""
    params = _as_params(params)
    r = torch.as_tensor(r, dtype=params.dtype)
    omega = keplerian_omega_static(r, f_fn, params, True)
    u_t = circular_u_t_static(r, f_fn, params)
    _, l_c = circular_e_l_static(r, f_fn, params, True)
    w2 = _w_second(r, f_fn, params, l_c * l_c)
    kappa = torch.sqrt(0.5 * w2) / u_t
    return omega, kappa, omega


def radial_stability_static(r, f_fn, params):
    """Signed kappa^2: positive on stable circular orbits."""
    params = _as_params(params)
    r = torch.as_tensor(r, dtype=params.dtype)
    u_t = circular_u_t_static(r, f_fn, params)
    _, l_c = circular_e_l_static(r, f_fn, params, True)
    return 0.5 * _w_second(r, f_fn, params, l_c * l_c) / (u_t * u_t)


def qpo_frequencies_static_hz(r, f_fn, params, mass_msun):
    """The QPO frequencies in Hz at r (physics.epicyclic's dict and unit
    chain); the nodal precession is identically zero."""
    from .epicyclic import T_SUN_S
    params = _as_params(params)
    om, ka, ot = epicyclic_static(r, f_fn, params)
    scale = params[0] / (2.0 * math.pi * mass_msun * T_SUN_S)
    nu_phi, nu_r, nu_th = om * scale, ka * scale, ot * scale
    return {"nu_phi": nu_phi, "nu_r": nu_r, "nu_theta": nu_th,
            "nu_periastron": nu_phi - nu_r, "nu_nodal": nu_phi - nu_th}


def page_thorne_flux_static(r_grid, f_fn, params, prograde=True):
    """Novikov-Thorne flux F(r) on r_grid (Page & Thorne 1974, eq. 11b)
    with the static circular orbits; sqrt(-det g3) = r; r_grid[0] is the
    torque-free inner edge; Mdot = 1."""
    params = torch.as_tensor(params, dtype=r_grid.dtype,
                             device=r_grid.device)
    e, l = circular_e_l_static(r_grid, f_fn, params, prograde)
    omega = keplerian_omega_static(r_grid, f_fn, params, prograde)
    dl_dr = vmap(grad(lambda r: circular_e_l_static(
        r, f_fn, params, prograde)[1]))(r_grid)
    domega_dr = vmap(grad(lambda r: keplerian_omega_static(
        r, f_fn, params, prograde)))(r_grid)
    integrand = (e - omega * l) * dl_dr
    dr = torch.diff(r_grid)
    segments = 0.5 * (integrand[1:] + integrand[:-1]) * dr
    cumulative = torch.cat([torch.zeros((1,), dtype=r_grid.dtype,
                                        device=r_grid.device),
                            torch.cumsum(segments, dim=0)])
    flux = (-domega_dr * cumulative
            / ((e - omega * l) ** 2 * 4.0 * math.pi * r_grid))
    return torch.clamp(flux, min=0.0)


def redshift_factor_static(energy, l_n, r_em, r_obs, f_fn, params,
                           prograde=True):
    """g = nu_obs / nu_em for a photon of Killing energy E and angular
    momentum L_n about the disk normal, from the Keplerian emitter at r_em
    to the static observer at r_obs; elementwise."""
    u_t_em = circular_u_t_static(r_em, f_fn, params)
    omega = keplerian_omega_static(r_em, f_fn, params, prograde)
    r_obs = torch.as_tensor(r_obs, dtype=r_em.dtype, device=r_em.device)
    u_t_obs = 1.0 / torch.sqrt(f_fn(r_obs, params))
    return (energy * u_t_obs) / (u_t_em * (energy - omega * l_n))


def static_disk_inner_edge(metric, params, prograde=True):
    """The disk's inner edge for a named family: the ISCO (host float)."""
    return float(isco_static(STATIC_F[metric], _as_params(params)))
