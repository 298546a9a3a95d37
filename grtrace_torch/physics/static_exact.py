"""Semi-analytic planar null geodesics of the static families — the torch
counterpart of `grtrace.physics.static_exact`.

In a spherically symmetric metric every null geodesic is planar, and in
its plane the orbit is (du/dphi)^2 = P(u) = 1/b^2 - u^2 f(1/u), u = 1/r,
b = L/E.  The turning point is the smallest root of P above u_obs (a
512-point scan and 60 bisections); each leg's azimuth is a 384-node
midpoint quadrature after u = u_a + (u_b - u_a) sin^2 theta, which
cancels the turning point's 1/sqrt singularity; phi -> u is inverted by
60 bisections on the monotone inbound leg.  JAX's counts, as batched torch
over the rays (`torch.func.vmap` of the per-ray functions), float64.
"""
from __future__ import annotations

import math

import torch
from torch.func import vmap

from .static_metrics import STATIC_F

F64 = torch.float64
_N_QUAD = 384
_N_SCAN = 512


def radial_potential_static(u, b, f_fn, params):
    """P(u) = 1/b^2 - u^2 f(1/u); orbits live where P >= 0."""
    return 1.0 / (b * b) - u * u * f_fn(1.0 / u, params)


def _linspace(lo, hi, n):
    i = torch.arange(n, dtype=F64, device=torch.as_tensor(lo).device)
    pts = lo + i * ((hi - lo) / (n - 1))
    return torch.cat([pts[:-1], torch.as_tensor(hi, dtype=F64).reshape(1)
                      .to(pts.device)])


def turning_point_static(b, f_fn, params, u_obs, u_max, iters=60):
    """Smallest root of P(u) in (u_obs, u_max) for one ray (0-dim b): the
    periapsis of an escaping ray; NaN when there is none (captured)."""
    u_obs = torch.as_tensor(u_obs, dtype=F64, device=b.device) + 0.0 * b
    u_max = torch.as_tensor(u_max, dtype=F64, device=b.device) + 0.0 * b
    us = _linspace(u_obs, u_max, _N_SCAN)
    neg = radial_potential_static(us, b, f_fn, params) <= 0.0
    has = neg.any()
    idx = torch.argmax(neg.to(torch.int8))
    lo = us[torch.clamp(idx - 1, min=0)]
    hi = us[idx]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = radial_potential_static(mid, b, f_fn, params) > 0.0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    return torch.where(has, 0.5 * (lo + hi), torch.full_like(lo, math.nan))


def _phi_leg(u_a, u_b, u_t, b, f_fn, params):
    """Azimuth swept between u_a and u_b on one monotone leg (the midpoint
    rule after u = u_a + (u_b - u_a) sin^2 th)."""
    device = torch.as_tensor(b).device
    th = (torch.arange(_N_QUAD, dtype=F64, device=device) + 0.5) * (
        0.5 * math.pi / _N_QUAD)
    s, c = torch.sin(th), torch.cos(th)
    du = u_b - u_a
    u = u_a + du * s * s
    p = radial_potential_static(u, b, f_fn, params)
    integrand = 2.0 * du * s * c / torch.sqrt(torch.clamp(p, min=1e-300))
    return torch.sum(integrand) * (0.5 * math.pi / _N_QUAD)


def _per_ray(fn, *tensors):
    """fn over the rays (the leading dim of each tensor, or one 0-dim
    ray)."""
    if tensors[0].dim() == 0:
        return fn(*tensors)
    return vmap(fn)(*tensors)


def _params(params, device):
    return torch.as_tensor([float(x) for x in params], dtype=F64,
                           device=device) \
        if not isinstance(params, torch.Tensor) else params.to(F64)


def deflection_static(b, f_fn, params, r_obs, r_exit=None):
    """Total azimuth an escaping ray sweeps from the camera at r_obs to
    periapsis and back out to r_exit (default r_obs), per ray of b."""
    b = torch.as_tensor(b, dtype=F64)
    params = _params(params, b.device)
    u_obs = 1.0 / r_obs
    u_exit = u_obs if r_exit is None else 1.0 / r_exit

    def one(bi):
        u_t = turning_point_static(bi, f_fn, params, u_obs, 1.0)
        return (_phi_leg(u_obs, u_t, u_t, bi, f_fn, params)
                + _phi_leg(u_exit, u_t, u_t, bi, f_fn, params))
    return _per_ray(one, b)


def _u_at_phi_one(phi_target, b, f_fn, params, r_obs, iters=60):
    u_obs = 1.0 / r_obs
    u_t = turning_point_static(b, f_fn, params, u_obs, 1.0)
    has_t = torch.isfinite(u_t)
    u_end = torch.where(has_t, u_t, torch.ones_like(u_t))
    phi_t = _phi_leg(u_obs, u_end, u_end, b, f_fn, params)
    inbound = phi_target <= phi_t
    target = torch.where(inbound, phi_target, 2.0 * phi_t - phi_target)
    lo, hi = torch.full_like(u_end, u_obs), u_end
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = _phi_leg(u_obs, mid, u_end, b, f_fn, params) < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    u = 0.5 * (lo + hi)
    valid = torch.where(has_t, phi_target <= 2.0 * phi_t,
                        phi_target <= phi_t)
    return torch.where(valid, u, torch.full_like(u, math.nan))


def u_at_phi_static(phi_target, b, f_fn, params, r_obs, iters=60):
    """The u = 1/r at which a ray launched inward from r_obs has swept
    azimuth phi_target (either leg); NaN past the sweep back out to r_obs,
    and for plungers past their inbound sweep (bounded at u = 1/M)."""
    b = torch.as_tensor(b, dtype=F64)
    phi_target = torch.as_tensor(phi_target, dtype=F64, device=b.device)
    phi_target, b = torch.broadcast_tensors(phi_target, b)
    params = _params(params, b.device)
    return _per_ray(lambda pt, bi: _u_at_phi_one(pt, bi, f_fn, params,
                                                 r_obs, iters),
                    phi_target, b)


def disk_crossing_exact(p0, beta, elevation, metric, params, r_obs, k=0):
    """The exact radius of a folded camera ray's k-th crossing of the
    tilted disk plane, and the swept fold azimuth there: (r_cross, swept),
    per ray of p0 (..., 4) (the folded covector) and beta; NaN where the
    ray is captured or has left r < r_obs first.  The crossings sit at
    fold azimuths phi0 + k pi, phi0 = atan2(-c1, c2)."""
    f_fn = STATIC_F[metric]
    p0 = torch.as_tensor(p0, dtype=F64)
    beta = torch.as_tensor(beta, dtype=F64, device=p0.device)
    elevation = torch.as_tensor(elevation, dtype=F64, device=p0.device)
    b = torch.abs(p0[..., 3] / p0[..., 0])
    c1 = torch.sin(elevation)
    c2 = torch.sin(beta) * torch.cos(elevation)
    phi0 = torch.atan2(-c1 + 0.0 * c2, c2)
    sgn = torch.sign(p0[..., 3])
    swept = torch.remainder(sgn * phi0, math.pi)
    swept = torch.where(swept < 1e-12, torch.full_like(swept, math.pi),
                        swept)
    swept = swept + k * math.pi
    u = u_at_phi_static(swept, b, f_fn, params, r_obs)
    return 1.0 / u, swept
