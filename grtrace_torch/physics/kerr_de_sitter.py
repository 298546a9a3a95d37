"""Kerr-de Sitter: a spinning black hole in an expanding universe — the
torch counterpart of `grtrace.physics.kerr_de_sitter`.

The Carter (1968) solution with rotation and a cosmological constant
Lambda, in Boyer-Lindquist-like coordinates,

    Delta_r  = (r^2 + a^2)(1 - Lambda r^2/3) - 2 M r
    Delta_th = 1 + (Lambda a^2/3) cos^2(theta)
    chi      = 1 + Lambda a^2/3
    Sigma    = r^2 + a^2 cos^2(theta)

with the contravariant metric of the separated Hamiltonian

    g^{ab} p_a p_b = (1/Sigma) [ -chi^2/Delta_r ((r^2+a^2) p_t + a p_phi)^2
                     + chi^2/(Delta_th sin^2 th) (a sin^2 th p_t + p_phi)^2
                     + Delta_r p_r^2 + Delta_th p_th^2 ].

params = (M, a, Lambda): Lambda rides the third (charge) slot.  Lambda = 0
is Kerr in Boyer-Lindquist coordinates; a = 0 is Kottler.  Delta_r is a
quartic whose roots r_- < r_+ < r_c are the inner, outer and cosmological
horizons; the capture surface is 1.1 r_+.

The theory layer keeps JAX's grids, iteration counts and brackets, on host
tensors in the params' dtype (the rays' dtype where the engine asks), as
JAX's traced bisections run in it.  `kds_outer_horizon` copies the
reference's scan of [1e-3, 2.5] M only: for near-critical Lambda, where
r_+ lies beyond 2.5 M, it returns 2.5 M (ROADMAP Queue C).  The capture
radius and the outer horizon the engine reads are memoized, as
`rotating_regular.rotating_capture_radius` is.  `kds_escape_pred` is the
exact conserved-quantity escape predicate (the Carter bracket with the
Delta_th and chi factors) that the generic engine's rescue reads on
guard-parked rays; it runs in chunks on the rays' own device.

The equatorial circular orbits (Omega, u^t, E, L, ISCO, OSCO and the
epicyclic frequencies) take their radial derivatives by `torch.func.grad`
(batched by `torch.func.vmap`), where JAX takes `jax.grad` / `jax.vmap`.
The closed-form kick and drift that the kernels G1d, S2d, T2d and D3 and
their twins evaluate are physics/kds_chart.py's.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.func import grad, vmap

from .rotating_regular import _as_params, _linspace, turning_point


def kds_functions(r, th, params):
    """(Delta_r, Delta_th, chi, Sigma) at (r, theta); params = (M, a,
    Lambda), JAX's association."""
    a, lam = params[1], params[2]
    cos2 = torch.cos(th) ** 2
    sigma = r * r + a * a * cos2
    delta_th = 1.0 + (lam * a * a / _three(lam)) * cos2
    chi = 1.0 + lam * a * a / _three(lam)
    return _delta_r(r, params), delta_th, chi, sigma


def kerr_de_sitter_g_inv(q, params):
    """Contravariant Kerr-de Sitter metric at every point of q (..., 4) =
    (t, r, theta, phi): returns (..., 4, 4), JAX's components in its
    association."""
    params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
    r, th = q[..., 1], q[..., 2]
    a = params[1]
    delta_r, delta_th, chi, sigma = kds_functions(r, th, params)
    sin2 = torch.sin(th) ** 2
    r2a2 = r * r + a * a
    chi2 = chi * chi
    g_tt = chi2 * (-r2a2 * r2a2 / delta_r + a * a * sin2 / delta_th) / sigma
    g_tp = chi2 * a * (-r2a2 / delta_r + 1.0 / delta_th) / sigma
    g_pp = chi2 * (-a * a / delta_r + 1.0 / (delta_th * sin2)) / sigma
    g_rr = delta_r / sigma
    g_thth = delta_th / sigma
    zero = torch.zeros_like(g_tt)
    rows = ((g_tt, zero, zero, g_tp), (zero, g_rr, zero, zero),
            (zero, zero, g_thth, zero), (g_tp, zero, zero, g_pp))
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _three(lam):
    """3 as a tensor like Lambda: a CUDA tensor divided by a Python scalar
    is multiplied by its reciprocal, by a tensor divided, as JAX divides."""
    return torch.full_like(torch.as_tensor(lam), 3.0)


def _delta_r(r, params):
    """Delta_r(r), JAX's association."""
    mass, a, lam = params[0], params[1], params[2]
    return ((r * r + a * a) * (1.0 - lam * r * r / _three(lam))
            - 2.0 * mass * r)


def kds_outer_horizon(params, n_scan=1024, iters=60):
    """The outer black-hole horizon r_+ in params' dtype: the -/+ sign
    change of Delta_r on the way out, by JAX's scan of n_scan points on
    [1e-3, 2.5] M (the last negative point and its outer neighbour bracket
    it) and `iters` bisections; NaN when Delta_r never goes negative (no
    black-hole horizon).  Where r_+ lies beyond 2.5 M the scan's last point
    is negative and the bracket [2.5 M, 2.5 M] returns 2.5 M: the
    reference's fault, copied (ROADMAP Queue C)."""
    params = _as_params(params)
    mass = params[0]
    rs = _linspace(1e-3 * mass, 2.5 * mass, n_scan)
    neg = _delta_r(rs, params) < 0.0
    has = bool(neg.any())
    idx = (n_scan - 1) - int(torch.argmax(neg.flip(0).to(torch.int8)))
    lo = rs[idx]
    hi = rs[min(idx + 1, n_scan - 1)]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        inside = bool(_delta_r(mid, params) < 0.0)
        lo, hi = (mid, hi) if inside else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if has else torch.full_like(root, math.nan)


def kds_cosmological_horizon(params, iters=60):
    """The cosmological horizon r_c in params' dtype: the +/- sign change
    of Delta_r bisected on [3 M, 2 sqrt(3 / Lambda)]; NaN for Lambda <=
    0."""
    params = _as_params(params)
    mass, a, lam = params[0], params[1], params[2]
    lam_safe = torch.clamp(lam, min=1e-30)
    lo = 3.0 * mass
    hi = 2.0 * torch.sqrt(3.0 / lam_safe)
    safe = torch.stack([mass, a, lam_safe])
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = bool(_delta_r(mid, safe) > 0.0)
        lo, hi = (mid, hi) if pos else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if bool(lam > 0.0) else torch.full_like(root, math.nan)


def _dtype_of(name):
    return getattr(torch, name[6:])


@functools.lru_cache(maxsize=256)
def _outer_horizon_cached(mass, spin, lam, dtype):
    params = torch.tensor([mass, spin, lam], dtype=_dtype_of(dtype))
    return float(kds_outer_horizon(params))


def outer_horizon_cached(params):
    """kds_outer_horizon of params (a tensor or a sequence), memoized on
    (M, a, Lambda, dtype): a 0-dim CPU tensor in params' dtype."""
    p = _as_params(params).detach().cpu()
    return torch.tensor(_outer_horizon_cached(
        float(p[0]), float(p[1]), float(p[2]), str(p.dtype)), dtype=p.dtype)


def kds_capture_radius(params):
    """The generic engine's capture-shell radius, a float64 0-dim tensor:
    1.1 r_+, or 1e-2 M where there is no black-hole horizon, both in
    params' dtype, as JAX's traced bisection gives it.  Memoized on (M, a,
    Lambda, dtype): the bisection costs host time that every render would
    repeat."""
    r_h = outer_horizon_cached(params)
    if bool(torch.isnan(r_h)):
        mass = _as_params(params).detach().cpu()[0]
        return (1e-2 * mass).to(torch.float64)
    return (1.1 * r_h).to(torch.float64)


# rays per chunk of the (N, n_grid) radial grid (float64: 48 MiB a chunk)
_PRED_CHUNK = 32768


def kds_escape_pred(q0s, p0s, params, n_grid=192, iters=30):
    """The exact escape predicate of Kerr-de Sitter per (N, 4) launch ray
    of the spherical chart, on the rays' device and dtype: with the Carter
    bracket at the camera event

        K = Delta_th p_th^2 + chi^2 (a sin th p_t + p_phi / sin th)^2
            / Delta_th,

    the backward ray escapes iff the radial potential R(r) = chi^2 ((r^2 +
    a^2) p_t + a p_phi)^2 - Delta_r K has a turning point (R <= 0) in
    (r_+, r0): an n_grid-point argmin refined by `iters` golden-section
    steps (JAX's).  False everywhere without a black-hole horizon.
    Elementwise in the rays, so it runs in chunks of _PRED_CHUNK rays;
    params = (M, a, Lambda)."""
    dtype, device = q0s.dtype, q0s.device
    params = torch.as_tensor(_as_params(params), dtype=dtype).cpu()
    r_h = outer_horizon_cached(params)
    if q0s.shape[0] == 0 or not bool(torch.isfinite(r_h)):
        return torch.zeros(q0s.shape[:1], dtype=torch.bool, device=device)
    params_d = params.to(device)
    r_lo = (r_h + 1e-3).to(device)
    from ..engine.integrate_ks import _unit_grid
    ts = _unit_grid(n_grid, dtype, device)  # jnp.linspace(0, 1, n_grid)
    out = [_pred_chunk(q0s[i:i + _PRED_CHUNK], p0s[i:i + _PRED_CHUNK],
                       params_d, r_lo, ts, iters)
           for i in range(0, q0s.shape[0], _PRED_CHUNK)]
    return torch.cat(out)


def _pred_chunk(q0s, p0s, params, r_lo, ts, iters):
    a = params[1]
    r0, th = q0s[:, 1], q0s[:, 2]
    p_t, p_th, p_ph = p0s[:, 0], p0s[:, 2], p0s[:, 3]
    _, delta_th, chi, _ = kds_functions(r0, th, params)
    sin_th = torch.sin(th)
    K = (delta_th * p_th * p_th
         + chi * chi * (a * sin_th * p_t + p_ph / sin_th) ** 2 / delta_th)
    chi2 = chi * chi
    pt_, pp_, K_ = p_t[:, None], p_ph[:, None], K[:, None]

    def R(r):
        quad = (r * r + a * a) * pt_ + a * pp_
        return chi2 * quad * quad - _delta_r(r, params) * K_

    return turning_point(R, r_lo, r0, ts, iters)


# ---------------------------------------------------------------------------
# Equatorial circular orbits / QPO observables
# ---------------------------------------------------------------------------

def kds_equatorial_cov(r, params):
    """(g_tt, g_tph, g_phph) of the covariant equatorial block, from the
    Carter line element at theta = pi/2 (Sigma = r^2, Delta_th = 1)."""
    a = params[1]
    delta_r = _delta_r(r, params)
    chi = 1.0 + params[2] * a * a / _three(params[2])
    r2a2 = r * r + a * a
    inv = 1.0 / (chi * chi * r * r)
    g_tt = (-delta_r + a * a) * inv
    g_tph = (delta_r * a - a * r2a2) * inv
    g_phph = (-delta_r * a * a + r2a2 * r2a2) * inv
    return g_tt, g_tph, g_phph


def _map(fn, r):
    """fn of a 0-dim r over the elements of r (any shape)."""
    if r.dim() == 0:
        return fn(r)
    return vmap(fn)(r.reshape(-1)).reshape(r.shape)


def keplerian_omega_kds(r, params, prograde=True):
    """Circular-geodesic angular velocity at r (elementwise) from the
    metric-derivative quadratic, Omega = (-g_tph,r +- sqrt(g_tph,r^2 -
    g_tt,r g_phph,r)) / g_phph,r; Kottler limit Omega^2 = M / r^3 - Lambda
    / 3."""
    def one(rr):
        d_tt, d_tph, d_phph = (
            grad(lambda x, i=i: kds_equatorial_cov(x, params)[i])(rr)
            for i in range(3))
        disc = torch.sqrt(torch.clamp(d_tph * d_tph - d_tt * d_phph,
                                      min=0.0))
        sign = 1.0 if prograde else -1.0
        return (-d_tph + sign * disc) / d_phph
    return _map(one, r)


def circular_u_t_kds(r, params, prograde=True):
    """(u^t, Omega) of the circular equatorial geodesic at r."""
    omega = keplerian_omega_kds(r, params, prograde)
    g_tt, g_tph, g_phph = kds_equatorial_cov(r, params)
    norm = -(g_tt + 2.0 * omega * g_tph + omega * omega * g_phph)
    return 1.0 / torch.sqrt(norm), omega


def circular_e_l_kds(r, params, prograde=True):
    """Killing charges (E = -u_t, L = u_phi) of the circular geodesic."""
    u_t, omega = circular_u_t_kds(r, params, prograde)
    g_tt, g_tph, g_phph = kds_equatorial_cov(r, params)
    return (-(g_tt + omega * g_tph) * u_t,
            (g_tph + omega * g_phph) * u_t)


def _stability_scan_kds(params, prograde, rising, r_lo, r_hi, n_scan=512,
                        iters=60):
    """The first sign change of dE/dr on a geometric scan of [r_lo, r_hi]
    (- to + when rising, + to - otherwise), bisected `iters` times; NaN
    when there is none (JAX's grid and counts)."""
    def de(rr):
        return grad(lambda x: circular_e_l_kds(x, params, prograde)[0])(rr)

    u = _linspace(torch.zeros_like(r_lo), torch.ones_like(r_lo), n_scan)
    rs = r_lo * (r_hi / r_lo) ** u
    sl = vmap(de)(rs)
    want = ((sl[:-1] < 0.0) & (sl[1:] > 0.0) if rising
            else (sl[:-1] > 0.0) & (sl[1:] < 0.0))
    has = bool(want.any())
    idx = int(torch.argmax(want.to(torch.int8)))
    lo, hi = rs[idx], rs[idx + 1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = bool((de(mid) < 0.0) == rising)
        lo, hi = (mid, hi) if neg else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if has else torch.full_like(root, math.nan)


def _r_hi(params, frac):
    mass, lam = params[0], params[2]
    if bool(lam > 0.0):
        return frac * (3.0 * mass / torch.clamp(lam, min=1e-30)) ** (1.0 / 3.0)
    return 40.0 * mass


def isco_kds(params, prograde=True):
    """ISCO: the inner minimum of E(r), scanned from 1.02 r_+ to 0.9 of the
    static radius (3 M / Lambda)^(1/3) (40 M at Lambda = 0); NaN when the
    cosmological tide leaves no stable circular orbit."""
    params = _as_params(params)
    r_lo = 1.02 * kds_outer_horizon(params)
    return _stability_scan_kds(params, prograde, True, r_lo,
                               _r_hi(params, 0.9))


def osco_kds(params, prograde=True):
    """The outermost stable circular orbit (the cosmological tide's outer
    stability edge), scanned to 0.98 of the static radius; NaN for Lambda
    = 0."""
    params = _as_params(params)
    r_lo = 1.02 * kds_outer_horizon(params)
    return _stability_scan_kds(params, prograde, False, r_lo,
                               _r_hi(params, 0.98))


def epicyclic_kds(r, params, prograde=True):
    """(Omega_phi, kappa, Omega_theta) of the circular orbit at r (a
    number or a 0-dim tensor): the radial and polar potentials' second
    derivatives by nested autodiff with `kerr_de_sitter_g_inv` and the
    circular orbit's Killing charges.  Lambda = 0 is the Kerr layer, a = 0
    the static Kottler one."""
    params = _as_params(params)
    r = torch.as_tensor(r, dtype=params.dtype, device=params.device)
    energy, l_z = circular_e_l_kds(r, params, prograde)
    u_t, omega = circular_u_t_kds(r, params, prograde)
    half_pi = torch.full_like(r, 0.5 * math.pi)

    def w_quad(rr, th):
        zero = torch.zeros_like(rr)
        g = kerr_de_sitter_g_inv(torch.stack([zero, rr, th, zero]), params)
        return (g[0, 0] * energy * energy - 2.0 * g[0, 3] * energy * l_z
                + g[3, 3] * l_z * l_z)

    def rad_pot(rr):
        zero = torch.zeros_like(rr)
        g = kerr_de_sitter_g_inv(torch.stack([zero, rr, 0.5 * math.pi + zero,
                                              zero]), params)
        return -g[1, 1] * (1.0 + w_quad(rr, 0.5 * math.pi + zero))

    def pol_pot(th):
        g = kerr_de_sitter_g_inv(torch.stack([torch.zeros_like(th),
                                              r + 0.0 * th, th,
                                              torch.zeros_like(th)]), params)
        return -g[2, 2] * (1.0 + w_quad(r + 0.0 * th, th))

    kappa2 = -0.5 * grad(grad(rad_pot))(r) / (u_t * u_t)
    vert2 = -0.5 * grad(grad(pol_pot))(half_pi) / (u_t * u_t)
    return (torch.abs(omega), torch.sqrt(torch.clamp(kappa2, min=0.0)),
            torch.sqrt(torch.clamp(vert2, min=0.0)))
