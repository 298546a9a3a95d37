"""Rotating regular black holes — the torch counterpart of
`grtrace.physics.rotating_regular`: Kerr-Schild metrics with a mass
function.

The Kerr-Schild form is kept,

    g^{mu nu} = eta^{mu nu} - 2 H l^mu l^nu,
    H = m(r) r^3 / (r^4 + a^2 z^2),

with the constant Kerr mass replaced by the family's mass function

    rotating Bardeen   m(r) = M r^3 / (r^2 + g^2)^{3/2}
    rotating Hayward   m(r) = M r^3 / (r^3 + 2 M l^2)

and r the Kerr-Schild radius (the positive root of r^4 - (rho^2 - a^2)
r^2 = a^2 z^2).  params = (M, a, g | l): the family parameter rides the
charge slot.  At g = l = 0 both are Kerr; at a = 0 the static families of
physics/static_metrics.py.

Horizons solve Delta(r) = r^2 - 2 m(r) r + a^2 = 0, which has no closed
form here: `rotating_horizon` scans inward from 2.2 M and bisects, NaN
where there is none (spin and the family parameter together can remove
the horizon: at a = 0.9, Bardeen keeps one only for g below about 0.28 M).
The theory layer keeps JAX's grids, iteration counts and brackets, on
host tensors in the params' dtype; the capture radius is memoized, as
`static_metrics.static_capture_radius` is.  `escape_pred_rotating` is the
exact conserved-quantity escape predicate (the Carter constant survives any
radial mass function) that the generic engine's rescue reads on
guard-parked rays; it runs in chunks on the rays' own device.

The closed-form kick and drift that the kernels G1r, S2r, T2r and D2 and
their twins evaluate are physics/rotating_chart.py's.
"""
from __future__ import annotations

import functools
import math

import torch

from .kerr_schild import ks_radius_c


def bardeen_mass(r, params):
    """Bardeen mass function; params[2] = g (magnetic charge): m -> M as
    r -> inf, m ~ M r^3 / g^3 at the core."""
    mass, g = params[0], params[2]
    r2 = r * r
    return mass * r2 * r / torch.pow(r2 + g * g, 1.5)


def hayward_mass(r, params):
    """Hayward mass function; params[2] = l (core length)."""
    mass, ell = params[0], params[2]
    r3 = r * r * r
    return mass * r3 / (r3 + 2.0 * mass * ell * ell)


MASS_FN = {"RotatingBardeen": bardeen_mass,
           "RotatingHayward": hayward_mass}


def make_rotating_ks_g_inv(m_fn):
    """The contravariant Kerr-Schild metric with mass function m_fn(r,
    params) at every point of q (..., 4) = (t, x, y, z): returns (..., 4,
    4), the components of JAX's `make_rotating_ks_g_inv` in its
    association (spacetime.kerr_schild_g_inv with m(r) in the place of
    M - Q^2 / 2r)."""
    def g_inv(q, params):
        params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
        a = params[1]
        x, y, z = q[..., 1], q[..., 2], q[..., 3]
        r = ks_radius_c(x, y, z, a)
        r2 = r * r
        r2a2 = r2 + a * a
        H = m_fn(r, params) * r * r2 / (r2 * r2 + a * a * z * z)
        lx = (r * x + a * y) / r2a2
        ly = (r * y - a * x) / r2a2
        lz = z / r
        l_up = torch.stack([-1.0 * torch.ones_like(r), lx, ly, lz], dim=-1)
        eta = torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=q.dtype,
                                      device=q.device))
        return eta - (2.0 * H)[..., None, None] * (l_up[..., :, None]
                                                   * l_up[..., None, :])

    return g_inv


rotating_bardeen_g_inv = make_rotating_ks_g_inv(bardeen_mass)
rotating_hayward_g_inv = make_rotating_ks_g_inv(hayward_mass)


def delta_bl(r, m_fn, params):
    """Delta(r) = r^2 - 2 m(r) r + a^2, whose positive roots are the
    horizons (the Kerr-Schild chart shares Boyer-Lindquist's r)."""
    a = params[1]
    return r * r - 2.0 * m_fn(r, params) * r + a * a


def _as_params(params, dtype=torch.float64):
    if isinstance(params, torch.Tensor):
        return params
    return torch.as_tensor([float(x) for x in params], dtype=dtype)


def _linspace(start, stop, num):
    """jnp.linspace(start, stop, num) for 0-dim tensors: start (1 - t) +
    stop t on the points t of XLA's linspace, the last point stop."""
    from ..engine.integrate_ks import _unit_grid
    t = _unit_grid(num, start.dtype, start.device)
    out = start * (1.0 - t) + stop * t
    out[-1] = stop
    return out


def rotating_horizon(metric, params, n_scan=512, iters=60):
    """The outer event horizon of a rotating regular family, in params'
    dtype: the largest root of Delta on (0, 2.2 M], by an inward scan of
    n_scan points (the first point where Delta < 0 and its outer
    neighbour bracket it) and `iters` bisections; NaN when Delta never
    goes negative (the horizonless region of the (a, p) plane)."""
    params = _as_params(params)
    m_fn = MASS_FN[metric]
    mass = params[0]
    rs = _linspace(2.2 * mass, 1e-3 * mass, n_scan)
    neg = delta_bl(rs, m_fn, params) < 0.0
    has = bool(neg.any())
    idx = int(torch.argmax(neg.to(torch.int8)))
    lo = rs[idx]
    hi = rs[max(idx - 1, 0)]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        inside = bool(delta_bl(mid, m_fn, params) < 0.0)
        lo, hi = (mid, hi) if inside else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if has else torch.full_like(root, math.nan)


@functools.lru_cache(maxsize=256)
def _capture_radius_cached(metric, mass, spin, param, dtype):
    params = torch.tensor([mass, spin, param],
                          dtype=getattr(torch, dtype[6:]))
    r_h = rotating_horizon(metric, params)
    if bool(torch.isnan(r_h)):
        return float((1e-2 * params[0]).to(torch.float64))
    return float(1.05 * r_h)


def rotating_capture_radius(metric, params):
    """The generic engine's capture-shell radius, a float64 0-dim tensor:
    the Kerr-Schild chart's 1.05 shell over the horizon, or 1e-2 M where
    there is none, both in params' dtype.  Memoized on (metric, M, a, p,
    dtype): the bisection costs milliseconds of host time, and every
    render asks several times."""
    params = _as_params(params)
    p = params.detach().cpu()
    return torch.tensor(_capture_radius_cached(
        metric, float(p[0]), float(p[1]), float(p[2]), str(p.dtype)),
        dtype=torch.float64)


# golden-section refinement's 1 / phi
_INV_PHI = 0.6180339887498949
# rays per chunk of the (N, n_grid) radial grid (float64: 48 MiB a chunk)
_PRED_CHUNK = 32768


def escape_pred_rotating(metric, q0s, p0s, params, n_grid=192, iters=30):
    """The exact escape predicate of a mass-function Kerr-Schild metric,
    per (N, 4) launch ray, on the rays' device and dtype: the backward
    ray escapes iff the radial potential

        R(r) = [E (r^2 + a^2) - a L]^2 - Delta(r) [(L - a E)^2 + Q]

    has a turning point (R <= 0) in (r_+, r0) — an n_grid-point argmin
    refined by `iters` golden-section steps.  False everywhere without a
    horizon (a ray that reaches the core crosses the r = 0 disc, where
    the fixed-step chart cannot follow it).  Elementwise in the rays, so
    it runs in chunks of _PRED_CHUNK rays; params = (M, a, p)."""
    dtype, device = q0s.dtype, q0s.device
    params = torch.as_tensor(_as_params(params), dtype=dtype).cpu()
    r_h = rotating_horizon(metric, params)
    if q0s.shape[0] == 0 or not bool(torch.isfinite(r_h)):
        return torch.zeros(q0s.shape[:1], dtype=torch.bool, device=device)
    params_d = params.to(device)
    r_lo = (r_h + 1e-3).to(device)
    from ..engine.integrate_ks import _unit_grid
    ts = _unit_grid(n_grid, dtype, device)  # jnp.linspace(0, 1, n_grid)
    out = [_pred_chunk(metric, q0s[i:i + _PRED_CHUNK],
                       p0s[i:i + _PRED_CHUNK], params_d, r_lo, ts, iters)
           for i in range(0, q0s.shape[0], _PRED_CHUNK)]
    return torch.cat(out)


def _pred_chunk(metric, q0s, p0s, params, r_lo, ts, iters):
    m_fn = MASS_FN[metric]
    a = params[1]
    x, y, z = q0s[:, 1], q0s[:, 2], q0s[:, 3]
    E = -p0s[:, 0]
    L = x * p0s[:, 2] - y * p0s[:, 1]
    r0_bl = ks_radius_c(x, y, z, a)
    cos_th = z / r0_bl
    sin2 = torch.clamp(1.0 - cos_th * cos_th, min=1e-30)
    sin_th = torch.sqrt(sin2)
    p_th = (cos_th / sin_th) * (x * p0s[:, 1] + y * p0s[:, 2]) \
        - r0_bl * sin_th * p0s[:, 3]
    Q = p_th * p_th + cos_th * cos_th * (L * L / sin2 - a * a * E * E)

    c1 = (L - a * E) ** 2 + Q
    B = E * a * a - a * L
    E_, B_, c1_ = E[:, None], B[:, None], c1[:, None]

    def R(r):
        quad = E_ * r * r + B_
        return quad * quad - delta_bl(r, m_fn, params) * c1_

    return turning_point(R, r_lo, r0_bl, ts, iters)


def turning_point(R, r_lo, r0, ts, iters):
    """Whether the (N, ...) radial potential R(r) of each ray reaches R <= 0
    in [r_lo, r0]: JAX's argmin of R on the grid r_lo + (r0 - r_lo) ts,
    refined by `iters` golden-section steps about it (the shared tail of
    the exact escape predicates)."""
    lo = (r_lo + torch.zeros_like(r0))[:, None]
    hi = r0[:, None]
    grid = lo + (hi - lo) * ts[None, :]
    Rg = R(grid)
    jmin = torch.argmin(Rg, dim=1)
    R_grid_min = torch.gather(Rg, 1, jmin[:, None])[:, 0]
    n_grid = ts.numel()
    j_lo = torch.clamp(jmin - 1, min=0)
    j_hi = torch.clamp(jmin + 1, max=n_grid - 1)
    gl = torch.gather(grid, 1, j_lo[:, None])
    gh = torch.gather(grid, 1, j_hi[:, None])
    for _ in range(iters):
        x1 = gh - _INV_PHI * (gh - gl)
        x2 = gl + _INV_PHI * (gh - gl)
        keep_lo = R(x1)[:, 0] < R(x2)[:, 0]
        gl, gh = (torch.where(keep_lo[:, None], gl, x1),
                  torch.where(keep_lo[:, None], x2, gh))
    R_min = torch.minimum(R_grid_min, R(0.5 * (gl + gh))[:, 0])
    return R_min <= 0.0


def critical_parameter(metric, spin, mass=1.0, iters=48):
    """The largest family parameter (g or l) that keeps a horizon at the
    given spin, by `iters` bisections of horizon existence on [0, 1.5 M]
    in float64 (a = 0 gives the static sqrt(16/27) M)."""
    lo, hi = 0.0, 1.5 * mass
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        r = rotating_horizon(metric, torch.tensor([mass, spin, mid],
                                                  dtype=torch.float64))
        lo, hi = (mid, hi) if bool(torch.isfinite(r)) else (lo, mid)
    return 0.5 * (lo + hi)
