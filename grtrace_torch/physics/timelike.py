"""Timelike geodesics: massive test particles on the same integrator — the
torch counterpart of `grtrace.physics.timelike`.

The FANTASY flows integrate H = 1/2 g^ab p_a p_b for any covector p, so a
particle of mass mu (g^ab p_a p_b = -mu^2) runs on the very kernels a
photon does; only the p_t solve differs.  This module builds the initial
conditions and the integrator-independent anchors:

  * `timelike_p_t` / `build_timelike_4momentum`: the mass-shell p_t solve,
    future-directed (u^t > 0, E = -p_t > 0, the particle convention);
  * `pr2_of_r` / `equatorial_ics`: (E, L_z) -> the squared radial covector
    on the Boyer-Lindquist equator and the FANTASY launch state;
  * `bound_orbit_e_lz`: the turning points (r_peri, r_apo) -> (E, L_z), a
    linear solve in (E^2, L^2) for Schwarzschild polished by a fixed
    number of Newton iterations on its autodiff Jacobian for Kerr-Newman;
  * `radial_potential_factored`, `periapsis_advance_quadrature` and
    `weak_field_precession`: the periastron advance by midpoint quadrature
    and its Mercury limit.

Host float64 functions: every tensor takes the dtype of `params` (a 1-D
tensor or a sequence of numbers, float64 by default), as JAX takes its
callers' dtype; nothing here runs on the card.
"""
from __future__ import annotations

import math

import torch

from .spacetime import _charge, kerr_g_inv


def _params(params, like=None):
    """params as a 1-D tensor: its own dtype if it is a tensor, else that
    of `like`, else float64."""
    if isinstance(params, torch.Tensor):
        return params
    dtype = like.dtype if isinstance(like, torch.Tensor) else torch.float64
    return torch.as_tensor(params, dtype=dtype)


def timelike_p_t(p_sph, q, params, g_inv_fn, mu=1.0, future=True):
    """Solve g^ab p_a p_b = -mu^2 for p_t with the cross terms: A p_t^2 +
    B p_t + (C + mu^2) = 0 with A = g^tt, B = 2 g^{t i} p_i, C = g^{ij}
    p_i p_j.  future=True picks (-B + disc) / (2A), the root with u^t > 0
    outside the ergosphere (E = -p_t > 0) — the opposite branch from the
    renderer's backward rays (`spacetime.null_p_t`)."""
    g = g_inv_fn(q, params)
    a_c = g[..., 0, 0]
    b_c = 2.0 * (g[..., 0, 1:] * p_sph).sum(-1)
    c_c = (p_sph[..., :, None] * g[..., 1:, 1:]
           * p_sph[..., None, :]).sum((-2, -1)) + mu * mu
    disc = torch.sqrt(torch.clamp(b_c * b_c - 4.0 * a_c * c_c, min=0.0))
    if future:
        return (-b_c + disc) / (2.0 * a_c)
    return (-b_c - disc) / (2.0 * a_c)


def build_timelike_4momentum(p_sph, pos_sph, params, g_inv_fn, mu=1.0,
                             future=True):
    """(..., 3) spatial covectors at (..., 3) positions (r, theta, phi) ->
    (..., 4) timelike covectors."""
    q4 = torch.cat([torch.zeros_like(pos_sph[..., :1]), pos_sph], dim=-1)
    p_t = timelike_p_t(p_sph, q4, params, g_inv_fn, mu=mu, future=future)
    return torch.cat([p_t[..., None], p_sph], dim=-1)


def _equator(r):
    """(..., 4) Boyer-Lindquist points (0, r, pi/2, 0)."""
    zero = torch.zeros_like(r)
    return torch.stack([zero, r, torch.full_like(r, math.pi / 2), zero], -1)


def pr2_of_r(r, energy, l_z, params, mu=1.0):
    """Squared radial covector p_r^2(r) on the Boyer-Lindquist equator from
    the mass shell with Killing charges (E, L_z): g^rr p_r^2 = -mu^2 -
    (g^tt E^2 - 2 g^tph E L + g^phph L^2); positive where the orbit is
    allowed, its simple roots the turning points."""
    r = torch.as_tensor(r, dtype=_params(params).dtype)
    g = kerr_g_inv(_equator(r), _params(params, r))
    quad = (g[..., 0, 0] * energy * energy
            - 2.0 * g[..., 0, 3] * energy * l_z
            + g[..., 3, 3] * l_z * l_z)
    return (-mu * mu - quad) / g[..., 1, 1]


def equatorial_ics(r0, energy, l_z, params, sign_ur=-1.0, mu=1.0,
                   dtype=torch.float64):
    """(E, L_z) at Boyer-Lindquist radius r0 -> (q0, p0) (4,) each, with
    p_r = sign_ur sqrt(p_r^2(r0)) (clamped at 0, so a turning point is a
    valid start); p_theta = 0 stays exact on the equator."""
    r0 = torch.as_tensor(r0, dtype=dtype)
    params = torch.as_tensor(params, dtype=dtype)
    q0 = _equator(r0)
    pr2 = pr2_of_r(r0, energy, l_z, params, mu)
    p_r = sign_ur * torch.sqrt(torch.clamp(pr2, min=0.0))
    p0 = torch.stack([-torch.as_tensor(energy, dtype=dtype), p_r,
                      torch.zeros_like(r0),
                      torch.as_tensor(l_z, dtype=dtype)])
    return q0, p0


def bound_orbit_e_lz(r_peri, r_apo, params, prograde=True, mu=1.0,
                     newton_iters=12):
    """(E, L_z) of the equatorial bound orbit with turning points (r_peri,
    r_apo): the Schwarzschild seed E^2 = (1 - 2M/r)(mu^2 + L^2/r^2) at
    both radii (linear in (E^2, L^2)), then `newton_iters` Newton steps on
    the exact residual [p_r^2(r_p), p_r^2(r_a)] with its autodiff Jacobian
    (JAX's count; JAX takes it with `jax.jacfwd`, the port with
    torch.autograd.functional.jacobian)."""
    from torch.autograd.functional import jacobian

    params = _params(params)
    dtype = params.dtype
    r_p = torch.as_tensor(r_peri, dtype=dtype)
    r_a = torch.as_tensor(r_apo, dtype=dtype)
    m = params[0]
    fp = 1.0 - 2.0 * m / r_p
    fa = 1.0 - 2.0 * m / r_a
    l2 = (mu * mu * (fp - fa)) / (fa / (r_a * r_a) - fp / (r_p * r_p))
    e2 = fp * (mu * mu + l2 / (r_p * r_p))
    sgn = 1.0 if prograde else -1.0
    el = torch.stack([torch.sqrt(torch.clamp(e2, min=0.0)),
                      sgn * torch.sqrt(torch.clamp(l2, min=0.0))])

    def residual(v):
        return torch.stack([pr2_of_r(r_p, v[0], v[1], params, mu),
                            pr2_of_r(r_a, v[0], v[1], params, mu)])

    for _ in range(newton_iters):
        el = el - torch.linalg.solve(jacobian(residual, el), residual(el))
    return el[0], el[1]


def radial_potential_factored(r, r_peri, r_apo, energy, l_z, params,
                              mu=1.0):
    """R(r) = r^4 (u^r)^2 on the Boyer-Lindquist equator, free of
    cancellation: the Kerr-Newman quartic c4 r^4 + ... + c0 with its two
    known roots (r_peri, r_apo) deflated by Vieta, R = c4 (r - r_p)(r -
    r_a)(r^2 - (r3 + r4) r + r3 r4)."""
    params = _params(params, r)
    m, a = params[0], params[1]
    qq = _charge(params)
    x = l_z - a * energy
    c4 = energy * energy - mu * mu
    c3 = 2.0 * m * mu * mu
    c0 = -(qq * qq) * x * x
    root_sum = -c3 / c4 - r_peri - r_apo
    root_prod = c0 / (c4 * r_peri * r_apo)
    quad = r * r - root_sum * r + root_prod
    return c4 * (r - r_peri) * (r - r_apo) * quad


def periapsis_advance_quadrature(r_peri, r_apo, params, prograde=True,
                                 mu=1.0, n=20001):
    """The exact periastron advance per radial period, Delta phi = 2
    int_{r_p}^{r_a} u^phi / |u^r| dr - 2 pi, by the midpoint rule in chi
    with r = r_p + (r_a - r_p) sin^2 chi (every node strictly inside the
    turning points), u^r from `radial_potential_factored`."""
    params = _params(params)
    dtype = params.dtype
    r_p = torch.as_tensor(r_peri, dtype=dtype)
    r_a = torch.as_tensor(r_apo, dtype=dtype)
    energy, l_z = bound_orbit_e_lz(r_p, r_a, params, prograde, mu)

    chi = (torch.arange(n, dtype=dtype) + 0.5) * (0.5 * math.pi / n)
    s = torch.sin(chi)
    r = r_p + (r_a - r_p) * s * s
    dr_dchi = (r_a - r_p) * torch.sin(2.0 * chi)

    g = kerr_g_inv(_equator(r), params)
    u_phi = -g[:, 0, 3] * energy + g[:, 3, 3] * l_z
    big_r = radial_potential_factored(r, r_p, r_a, energy, l_z, params, mu)
    u_r = torch.sqrt(torch.clamp(big_r, min=0.0)) / (r * r)
    u_r_safe = torch.where(big_r > 0.0, u_r, torch.ones_like(u_r))
    integrand = torch.where(big_r > 0.0, u_phi / u_r_safe * dr_dchi,
                            torch.zeros_like(u_r))
    dphi = 2.0 * torch.sum(integrand) * (0.5 * math.pi / n)
    sgn = 1.0 if prograde else -1.0
    return sgn * dphi - 2.0 * math.pi


def weak_field_precession(r_peri, r_apo, mass=1.0):
    """Leading-order periastron advance 6 pi M / (a (1 - e^2)) of the
    ellipse with the given turning points, a = (r_p + r_a) / 2, e = (r_a -
    r_p) / (r_a + r_p)."""
    a_sl = 0.5 * (r_peri + r_apo)
    ecc = (r_apo - r_peri) / (r_apo + r_peri)
    return 6.0 * math.pi * mass / (a_sl * (1.0 - ecc * ecc))
