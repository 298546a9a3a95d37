"""Polarized ray tracing by Walker-Penrose transport in Kerr — the torch
counterpart of `grtrace.physics.polarization`.

Kerr is Petrov type D, so along every null geodesic the complex
Walker-Penrose constant

    kappa = (A - iB) (r - i a cos(theta))                      [BL chart]
    A = (k^t f^r - k^r f^t) + a sin^2(theta) (k^r f^phi - k^phi f^r)
    B = [(r^2 + a^2)(k^phi f^theta - k^theta f^phi)
         - a (k^t f^theta - k^theta f^t)] sin(theta)

is conserved for any vector f parallel-transported along the photon
momentum k (Walker & Penrose 1970).  Polarization transport is therefore
algebra: kappa is evaluated once at the emission event and the
polarization direction at the camera is reconstructed from it.  Nothing is
added to the integration, so kernels B6 and B7 run unchanged.

The rays live on the Cartesian Kerr-Schild chart, so this module carries
the exact KS -> Boyer-Lindquist phase-space map: covariant components
transform with the forward Jacobian d(x_KS)/d(x_BL) and indices are raised
with the closed-form BL inverse metric (spacetime.kerr_g_inv).

Every function is batched over the leading axes of its (..., 4) arguments,
where the JAX module maps one event at a time with `vmap`.  No autodiff.
"""
from __future__ import annotations

import math

import torch

from .orbits import _invert_bl_metric, circular_u_t
from .spacetime import _charge, kerr_g_inv, kerr_schild_g_inv, ks_radius


def _matvec(m, v):
    """(..., 4, 4) @ (..., 4) -> (..., 4)."""
    return torch.einsum("...ij,...j->...i", m, v)


# ---------------------------------------------------------------------------
# Kerr-Schild <-> Boyer-Lindquist phase-space map
# ---------------------------------------------------------------------------

def _ks_chart_geometry(q_ks, params):
    """Shared pieces of the KS -> BL Jacobian at each event.  The chart:
        x + i y = sin(theta) (r + i a) e^{i phit},   z = r cos(theta)
        t_ks = t_bl + T(r),   T' = (2 M r - Q^2) / Delta
        phit = phi_bl + Phi(r),  Phi' = a / Delta."""
    mass, a = params[0], params[1]
    qc = _charge(params)
    x, y, z = q_ks[..., 1], q_ks[..., 2], q_ks[..., 3]
    r = ks_radius(x, y, z, a)
    w = r * r + a * a
    cth = torch.clamp(z / torch.clamp(r, min=1e-30), -1.0, 1.0)
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=1e-30))
    cph = (x * r + y * a) / (sth * w)
    sph = (y * r - x * a) / (sth * w)
    delta = r * r - 2.0 * mass * r + a * a + qc * qc
    t_prime = (2.0 * mass * r - qc * qc) / delta
    phi_prime = a / delta
    return r, cth, sth, cph, sph, t_prime, phi_prime


def bl_cov_from_ks_cov(q_ks, w_cov, params):
    """A covariant 4-vector from the KS Cartesian chart to BL:
    w_bl_mu = (d x_ks^nu / d x_bl^mu) w_ks_nu (the forward Jacobian, no
    inversion)."""
    x, y = q_ks[..., 1], q_ks[..., 2]
    r, cth, sth, cph, sph, t_prime, phi_prime = _ks_chart_geometry(q_ks,
                                                                   params)
    wt, wx, wy, wz = w_cov[..., 0], w_cov[..., 1], w_cov[..., 2], \
        w_cov[..., 3]
    dxdr = sth * cph - y * phi_prime
    dydr = sth * sph + x * phi_prime
    w_r = t_prime * wt + dxdr * wx + dydr * wy + cth * wz
    w_th = (cth / sth) * (x * wx + y * wy) - r * sth * wz
    w_ph = x * wy - y * wx
    return torch.stack([wt, w_r, w_th, w_ph], dim=-1)


def bl_from_ks(q_ks, p_ks, params):
    """(q, covariant p) on the KS Cartesian chart -> the BL chart.  The BL
    azimuth is the KS one (they differ by a function of r, which nothing
    axisymmetric reads); theta = arccos(z / r)."""
    r, cth, sth, cph, sph, _, _ = _ks_chart_geometry(q_ks, params)
    q_bl = torch.stack([q_ks[..., 0], r, torch.arccos(cth),
                        torch.atan2(sph, cph)], dim=-1)
    return q_bl, bl_cov_from_ks_cov(q_ks, p_ks, params)


def raise_bl(q_bl, w_cov, params):
    """Covariant -> contravariant in BL via the closed-form inverse
    metric."""
    return _matvec(kerr_g_inv(q_bl, params), w_cov)


def ks_lower(q_ks, v_up, params):
    """Lower a contravariant KS-chart vector with the closed-form covariant
    metric g = eta + 2 H l l (l_mu = (1, lx, ly, lz))."""
    mass, a = params[0], params[1]
    qc = _charge(params)
    x, y, z = q_ks[..., 1], q_ks[..., 2], q_ks[..., 3]
    r = ks_radius(x, y, z, a)
    r2 = r * r
    w = r2 + a * a
    big_d = r2 + (a * z / r) * (a * z / r)
    h = (mass * r - 0.5 * qc * qc) / big_d
    lx = (r * x + a * y) / w
    ly = (r * y - a * x) / w
    lz = z / r
    l_dot_v = v_up[..., 0] + lx * v_up[..., 1] + ly * v_up[..., 2] \
        + lz * v_up[..., 3]
    eta_v = torch.stack([-v_up[..., 0], v_up[..., 1], v_up[..., 2],
                         v_up[..., 3]], dim=-1)
    l_cov = torch.stack([torch.ones_like(lx), lx, ly, lz], dim=-1)
    return eta_v + (2.0 * h * l_dot_v)[..., None] * l_cov


def ks_dot(q_ks, a_up, b_up, params):
    """Metric inner product of two contravariant vectors, KS chart."""
    return torch.sum(ks_lower(q_ks, a_up, params) * b_up, dim=-1)


# ---------------------------------------------------------------------------
# The Walker-Penrose constant
# ---------------------------------------------------------------------------

def walker_penrose(q_bl, k_up, f_up, a):
    """(kappa1, kappa2) = Re, Im of the WP constant for contravariant
    BL-chart k (photon momentum) and f (any transported vector); linear in
    f and invariant under f -> f + lambda k."""
    r, th = q_bl[..., 1], q_bl[..., 2]
    sth, cth = torch.sin(th), torch.cos(th)
    kt, kr, kth, kph = (k_up[..., i] for i in range(4))
    ft, fr, fth, fph = (f_up[..., i] for i in range(4))
    a_term = (kt * fr - kr * ft) + a * sth * sth * (kr * fph - kph * fr)
    b_term = ((r * r + a * a) * (kph * fth - kth * fph)
              - a * (kt * fth - kth * ft)) * sth
    # (A - iB)(r - i a cos th)
    kappa1 = r * a_term - a * cth * b_term
    kappa2 = -(r * b_term + a * cth * a_term)
    return kappa1, kappa2


def _sqrt_neg_det_bl(q_bl, params):
    """sqrt(-det g_cov) in BL from the block-sparse inverse metric:
    det g_inv = g^rr g^thth (g^tt g^phph - (g^tph)^2)."""
    g = kerr_g_inv(q_bl, params)
    det_inv = g[..., 1, 1] * g[..., 2, 2] * (
        g[..., 0, 0] * g[..., 3, 3] - g[..., 0, 3] * g[..., 3, 0])
    return 1.0 / torch.sqrt(torch.clamp(-det_inv, min=1e-30))


def _eps_contract(q_bl, u_cov, k_cov, b_cov, params):
    """f^mu = eps^{mu nu rho sigma} u_nu k_rho b_sigma, the generalized
    cross product: cofactor 3x3 determinants over the stacked covariant
    rows, divided by sqrt(-g)."""
    rows = torch.stack([u_cov, k_cov, b_cov], dim=-2)      # (..., 3, 4)

    def det3(c0, c1, c2):
        m = rows[..., [c0, c1, c2]]
        return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                                - m[..., 1, 2] * m[..., 2, 1])
                - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                                  - m[..., 1, 2] * m[..., 2, 0])
                + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                                  - m[..., 1, 1] * m[..., 2, 0]))

    f_up = torch.stack([-det3(1, 2, 3), det3(0, 2, 3), -det3(0, 1, 3),
                        det3(0, 1, 2)], dim=-1)
    return f_up / _sqrt_neg_det_bl(q_bl, params)[..., None]


# ---------------------------------------------------------------------------
# Emission: synchrotron polarization of a Keplerian disk element
# ---------------------------------------------------------------------------

_FIELD_COV = {"vertical": (0.0, 0.0, -1.0, 0.0),   # -d_theta: +z at the
              "radial": (0.0, 1.0, 0.0, 0.0),      # equator
              "toroidal": (0.0, 0.0, 0.0, 1.0)}


def _bl_lower_matrix(q_bl, params):
    """Covariant BL metric via the closed-form block inverse of
    kerr_g_inv."""
    return _invert_bl_metric(kerr_g_inv(q_bl, params))


def disk_field_b(q_bl, u_up, params, bfield):
    """Unit magnetic-field 4-vector in the emitter frame (b.u = 0,
    b.b = 1) for 'vertical', 'toroidal' or 'radial' disk fields: the
    coordinate direction projected orthogonal to u with the metric."""
    if bfield not in _FIELD_COV:
        raise ValueError(f"unknown bfield {bfield!r}")
    g = kerr_g_inv(q_bl, params)
    v_cov = torch.tensor(_FIELD_COV[bfield], dtype=q_bl.dtype,
                         device=q_bl.device)
    v_up = _matvec(g, v_cov.expand(q_bl.shape))
    # project out the u component:  v -> v + (v.u) u   (u.u = -1)
    g_cov = _bl_lower_matrix(q_bl, params)
    u_cov = _matvec(g_cov, u_up)
    v_up = v_up + torch.sum(u_cov * v_up, dim=-1, keepdim=True) * u_up
    norm = torch.sqrt(torch.clamp(
        torch.sum(_matvec(g_cov, v_up) * v_up, dim=-1), min=1e-30))
    return v_up / norm[..., None]


def emission_polarization(q_bl, p_bl, params, prograde=True,
                          bfield="vertical"):
    """Walker-Penrose constant and fractional-polarization weight of
    photons (covariant BL momenta p_bl) leaving circular Keplerian emitters
    at the equatorial events q_bl: the E-vector lies along eps(u, k, b),
    with polarized weight sin^2(theta_B), the pitch angle between photon
    and field in the emitter frame.  Returns (kappa1, kappa2,
    sin2_theta_b)."""
    u_t, omega = circular_u_t(q_bl[..., 1], params, prograde)
    zero = torch.zeros_like(u_t)
    u_up = torch.stack([u_t, zero, zero, u_t * omega], dim=-1)
    b_up = disk_field_b(q_bl, u_up, params, bfield)

    g_cov = _bl_lower_matrix(q_bl, params)
    k_up = _matvec(kerr_g_inv(q_bl, params), p_bl)
    u_cov = _matvec(g_cov, u_up)
    b_cov = _matvec(g_cov, b_up)
    f_raw = _eps_contract(q_bl, u_cov, p_bl, b_cov, params)

    f_norm2 = torch.sum(_matvec(g_cov, f_raw) * f_raw, dim=-1)
    nu_em = -torch.sum(p_bl * u_up, dim=-1)    # photon frequency in frame
    sin2_theta_b = f_norm2 / torch.clamp(nu_em * nu_em, min=1e-30)
    f_up = f_raw / torch.sqrt(torch.clamp(f_norm2, min=1e-30))[..., None]
    kappa1, kappa2 = walker_penrose(q_bl, k_up, f_up, params[1])
    return kappa1, kappa2, sin2_theta_b


# ---------------------------------------------------------------------------
# Camera: reconstruct the screen EVPA from the conserved constant
# ---------------------------------------------------------------------------

def _ks_raise_matrix(q_ks, params):
    """Contravariant KS metric as a matrix."""
    return kerr_schild_g_inv(q_ks, params)


def observer_evpa(kappa1, kappa2, q0_ks, p0_ks, up3, right3, params,
                  omega_obs=0.0):
    """Electric-vector position angle on the camera screen, from the
    conserved WP constants of the rays whose camera-end phase points are
    (q0_ks, p0_ks) (..., 4) on the KS chart.

    up3 / right3: the camera's spatial basis directions (3,) in KS
    Cartesian coordinates.  omega_obs: the camera worldline's coordinate
    angular velocity (0 = static; nonzero for the circular camera of
    physics.camera.boosted_ics_from_pixels).  The observer's orthonormal
    screen {e1 (up), e2 (right)} is built orthogonal to u_obs and to the
    photon's spatial direction; kappa is linear in f and k-gauge
    invariant, so f = c1 e1 + c2 e2 and (c1, c2) solve a 2x2 real system.

    Returns (EVPA = atan2(c2, c1) mod pi, from camera-up toward
    camera-right; |c|, ~1 for a unit f: the screen solve's check)."""
    dtype = q0_ks.dtype
    zero = torch.zeros_like(q0_ks[..., 0])
    one = torch.ones_like(zero)

    def dot(a_up, b_up):
        return ks_dot(q0_ks, a_up, b_up, params)

    def unit(v):
        return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-30))[..., None]

    # the circular worldline's 4-velocity direction (1, -w y, w x, 0)
    w = torch.as_tensor(omega_obs, dtype=dtype, device=q0_ks.device)
    u_obs = torch.stack([one, -w * q0_ks[..., 2], w * q0_ks[..., 1], zero],
                        dim=-1)
    u_obs = u_obs / torch.sqrt(torch.clamp(-dot(u_obs, u_obs),
                                           min=1e-30))[..., None]

    k_up = _matvec(_ks_raise_matrix(q0_ks, params), p0_ks)
    n_hat = unit(k_up + dot(k_up, u_obs)[..., None] * u_obs)

    def screen_vec(v3):
        v3 = torch.as_tensor(v3, dtype=dtype, device=q0_ks.device)
        e = torch.stack([zero, v3[0].expand(zero.shape),
                         v3[1].expand(zero.shape),
                         v3[2].expand(zero.shape)], dim=-1)
        e = e + dot(e, u_obs)[..., None] * u_obs
        return e - dot(e, n_hat)[..., None] * n_hat

    e1 = unit(screen_vec(up3))
    e2 = screen_vec(right3)
    e2 = unit(e2 - dot(e2, e1)[..., None] * e1)

    q_bl, p_bl = bl_from_ks(q0_ks, p0_ks, params)
    k_bl_up = raise_bl(q_bl, p_bl, params)

    def kappa_of(e_up):
        e_cov_ks = ks_lower(q0_ks, e_up, params)
        e_bl_up = raise_bl(q_bl, bl_cov_from_ks_cov(q0_ks, e_cov_ks,
                                                    params), params)
        return walker_penrose(q_bl, k_bl_up, e_bl_up, params[1])

    k11, k12 = kappa_of(e1)
    k21, k22 = kappa_of(e2)
    # solve [[k11, k21], [k12, k22]] @ (c1, c2) = (kappa1, kappa2)
    det = k11 * k22 - k21 * k12
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det,
                          torch.zeros_like(det))
    c1 = (k22 * kappa1 - k21 * kappa2) * inv_det
    c2 = (k11 * kappa2 - k12 * kappa1) * inv_det
    evpa = torch.remainder(torch.atan2(c2, c1), math.pi)
    return evpa, torch.sqrt(c1 * c1 + c2 * c2)
