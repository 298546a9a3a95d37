"""The static beyond-Kerr families — the torch counterpart of
`grtrace.physics.static_metrics`.

Three static, spherically symmetric spacetimes share one chart,
q = (t, r, theta, phi), with

    ds^2 = -f(r) dt^2 + dr^2 / f(r) + r^2 dOmega^2
    g_inv = diag(-1/f, f, 1/r^2, 1/(r^2 sin^2 theta)),

    Kottler (Schwarzschild-de Sitter)  f = 1 - 2M/r - (Lambda/3) r^2
    Bardeen                            f = 1 - 2M r^2 / (r^2 + g^2)^(3/2)
    Hayward                            f = 1 - 2M r^2 / (r^3 + 2M l^2)

params = (M, p[, unused]): the second slot is the family's own parameter
(Lambda, g or l).  Bardeen and Hayward have horizons for p <= sqrt(16/27)
M; above it they are horizonless (`outer_horizon` is NaN and the capture
radius falls to a 1e-2 M floor).

The theory layer (photon sphere, critical impact parameter, shadow angle,
horizons, Lyapunov exponent) keeps JAX's fixed-count Newton and bisection
loops, grids and brackets, on host float64 tensors; where JAX takes
`jax.grad`, the port takes `torch.func.grad`.  The closed-form f'(r) that
the static chart of the generic engine evaluates (kernel G1s) is
physics/static_chart.py's `lapse`.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.func import grad, vmap

def _split(params):
    return params[0], params[1]


def kottler_f(r, params):
    """Schwarzschild-de Sitter lapse; params[1] = Lambda (1/M^2)."""
    mass, lam = _split(params)
    return 1.0 - 2.0 * mass / r - (lam / 3.0) * r * r


def bardeen_f(r, params):
    """Bardeen regular-black-hole lapse; params[1] = g (magnetic
    charge)."""
    mass, g = _split(params)
    r2 = r * r
    return 1.0 - 2.0 * mass * r2 / torch.pow(r2 + g * g, 1.5)


def hayward_f(r, params):
    """Hayward regular-black-hole lapse; params[1] = l (core length)."""
    mass, ell = _split(params)
    r3 = r * r * r
    return 1.0 - 2.0 * mass * r * r / (r3 + 2.0 * mass * ell * ell)


STATIC_F = {"Kottler": kottler_f, "Bardeen": bardeen_f,
            "Hayward": hayward_f}


def _as_params(params, dtype=torch.float64):
    if isinstance(params, torch.Tensor):
        return params
    return torch.as_tensor([float(x) for x in params], dtype=dtype)


def make_static_g_inv(f_fn):
    """g_inv(q, params) for ds^2 = -f dt^2 + dr^2/f + r^2 dOmega^2 at
    every point of q (..., 4): returns (..., 4, 4), the components of
    JAX's make_static_g_inv."""
    def g_inv(q, params):
        params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
        r, th = q[..., 1], q[..., 2]
        f = f_fn(r, params)
        sin_th = torch.sin(th)
        inv_r2 = 1.0 / (r * r)
        return torch.diag_embed(torch.stack(
            [-1.0 / f, f, inv_r2, inv_r2 / (sin_th * sin_th)], dim=-1))
    return g_inv


kottler_g_inv = make_static_g_inv(kottler_f)
bardeen_g_inv = make_static_g_inv(bardeen_f)
hayward_g_inv = make_static_g_inv(hayward_f)


# ---------------------------------------------------------------------------
# Theory layer (host float64, JAX's iteration counts)
# ---------------------------------------------------------------------------

def photon_sphere(f_fn, params, r0=None, iters=40):
    """Circular-photon-orbit radius, the root of h(r) = 2 f - r f': Newton
    from 3M with h' by autodiff, `iters` steps."""
    params = _as_params(params)
    if r0 is None:
        r0 = 3.0 * params[0]
    fp = grad(f_fn, argnums=0)

    def h(r):
        return 2.0 * f_fn(r, params) - r * fp(r, params)

    hp = grad(h)
    r = torch.as_tensor(r0, dtype=torch.float64) + 0.0 * params[0]
    for _ in range(iters):
        r = r - h(r) / hp(r)
    return r


def b_critical(f_fn, params, **kw):
    """Critical impact parameter b_c = r_ph / sqrt(f(r_ph))."""
    params = _as_params(params)
    r_ph = photon_sphere(f_fn, params, **kw)
    return r_ph / torch.sqrt(f_fn(r_ph, params))


def shadow_angle(f_fn, params, r_obs, **kw):
    """Apparent shadow angular radius for a static observer at r_obs:
    sin(alpha) = b_c sqrt(f(r_obs)) / r_obs."""
    params = _as_params(params)
    r_obs = torch.as_tensor(r_obs, dtype=params.dtype)
    b_c = b_critical(f_fn, params, **kw)
    s = b_c * torch.sqrt(f_fn(r_obs, params)) / r_obs
    return torch.arcsin(torch.clamp(s, -1.0, 1.0))


def outer_horizon(f_fn, params, n_scan=256, iters=60):
    """Outermost black-hole horizon: the largest root of f below the
    photon sphere (inward scan from r_ph to 1e-3 M, first sign change,
    `iters` bisections); NaN when there is none (super-critical regular
    holes)."""
    params = _as_params(params)
    r_ph = photon_sphere(f_fn, params)
    rs = torch.linspace(float(r_ph), float(1e-3 * params[0]), n_scan,
                        dtype=r_ph.dtype)
    fv = vmap(lambda r: f_fn(r, params))(rs)
    neg = fv < 0.0
    has = bool(neg.any())
    idx = int(torch.argmax(neg.to(torch.int8)))
    lo = rs[idx]
    hi = rs[max(idx - 1, 0)]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        inside = bool(f_fn(mid, params) < 0.0)
        lo, hi = (mid, hi) if inside else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if has else torch.full_like(root, math.nan)


def cosmological_horizon(params, iters=60):
    """Kottler's cosmological horizon, the largest positive root of f:
    bisection on [3M, 2 sqrt(3/Lambda)]; NaN for Lambda <= 0."""
    params = _as_params(params)
    mass, lam = params[0], params[1]
    lam_safe = torch.clamp(lam, min=1e-30)
    lo, hi = 3.0 * mass, 2.0 * torch.sqrt(3.0 / lam_safe)
    p_safe = torch.stack([mass, lam_safe])
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = bool(kottler_f(mid, p_safe) > 0.0)
        lo, hi = (mid, hi) if pos else (lo, mid)
    root = 0.5 * (lo + hi)
    return root if bool(lam > 0.0) else torch.full_like(root, math.nan)


def impact_parameter_cam(alpha_cam, f_fn, params, r_obs):
    """Impact parameter b = L/E of the unfolded spherical camera's ray at
    camera angle alpha_cam (the radial direction cosine scaled by the
    Schwarzschild sqrt(1 - 2M/r_obs), p_t closing the null condition in
    f): b = r_obs sin a / sqrt(f (f f_s^2 cos^2 a + sin^2 a))."""
    params = _as_params(params)
    alpha_cam = torch.as_tensor(alpha_cam, dtype=params.dtype)
    r_obs = torch.as_tensor(r_obs, dtype=params.dtype)
    mass = params[0]
    f = f_fn(r_obs, params)
    fs2 = 1.0 - 2.0 * mass / r_obs
    s, c = torch.sin(alpha_cam), torch.cos(alpha_cam)
    return r_obs * s / torch.sqrt(f * (f * fs2 * c * c + s * s))


def static_capture_radius(metric, params):
    """Capture-shell radius of the generic integrator: 1.1 x the outer
    horizon, or 1e-2 M (in params' dtype) where there is none; a float64
    0-dim tensor.  Memoized on (metric, M, p, dtype): the bisections cost
    tens of milliseconds of host time, and every render asks several
    times."""
    params = _as_params(params)
    return torch.tensor(_capture_radius_cached(
        metric, float(params[0]), float(params[1]),
        str(params.dtype)), dtype=torch.float64)


@functools.lru_cache(maxsize=256)
def _capture_radius_cached(metric, mass, param, dtype):
    params = torch.tensor([mass, param], dtype=getattr(torch, dtype[6:]))
    r_h = outer_horizon(STATIC_F[metric], params)
    if bool(torch.isnan(r_h)):
        return float((1e-2 * params[0]).to(torch.float64))
    return float(1.1 * r_h)


@functools.lru_cache(maxsize=256)
def b_critical_cached(metric, mass, param):
    """b_critical of a named family at float64 (M, p), memoized (the
    generic engine's cost key asks it once a launch)."""
    return float(b_critical(STATIC_F[metric],
                            torch.tensor([mass, param], dtype=torch.float64)))


def lyapunov_static(f_fn, params, **kw):
    """Lyapunov exponent of the unstable circular photon orbit per radian:
    gamma = sqrt(P''(u_ph) / 2) with P(u) = 1/b_c^2 - u^2 f(1/u)."""
    params = _as_params(params)
    r_ph = photon_sphere(f_fn, params, **kw)
    b_c = b_critical(f_fn, params, **kw)
    u_ph = 1.0 / r_ph

    def p_of_u(u):
        return 1.0 / (b_c * b_c) - u * u * f_fn(1.0 / u, params)

    p2 = grad(grad(p_of_u))(u_ph)
    return torch.sqrt(torch.clamp(0.5 * p2, min=0.0))
