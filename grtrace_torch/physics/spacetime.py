"""The Kerr-Newman pieces of `grtrace.physics.spacetime`, in torch: the
contravariant Boyer-Lindquist metric (the disk's orbit algebra reads it),
the Boyer-Lindquist radius of a Kerr-Schild point, the contravariant
Kerr-Schild metric (batched, closed form), the outer horizon radius and the
null quadratic for p_t.

The autodiff flow engine of the JAX module (`make_flows`, the generic
integrator and the other metric families) is not ported yet: ROADMAP Queue A
items 5b and 9.

Metric parameters are `params = (M, a[, Q])`: a 1-D tensor, or a sequence
of numbers, in the working dtype; the charge slot is optional, as in JAX.
"""
from __future__ import annotations

import torch


def _charge(params):
    """Q from an optional third params slot."""
    return params[2] if len(params) > 2 else params[0] * 0.0


def kerr_g_inv(q, params):
    """Contravariant Kerr(-Newman) metric in Boyer-Lindquist coordinates
    at every point of q (..., 4) = (t, r, theta, phi): returns (..., 4, 4).

    The charge enters only through Delta = r^2 - 2 M r + a^2 + Q^2 and the
    identity r^2 + a^2 - Delta = 2 M r - Q^2 in the t-phi term.  Each
    component keeps the JAX function's association (inv_sd = 1/(sigma
    delta), ...)."""
    params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
    mass, a = params[0], params[1]
    qc = _charge(params)
    r, th = q[..., 1], q[..., 2]
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = sin_th * sin_th
    sigma = r * r + a * a * cos_th * cos_th
    delta = r * r - 2.0 * mass * r + a * a + qc * qc
    r2a2 = r * r + a * a

    inv_sd = 1.0 / (sigma * delta)
    g_tt = -(r2a2 * r2a2 - a * a * delta * sin2) * inv_sd
    g_tp = -(r2a2 - delta) * a * inv_sd
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_pp = (delta - a * a * sin2) * inv_sd / sin2

    zero = torch.zeros_like(g_tt)
    rows = ((g_tt, zero, zero, g_tp), (zero, g_rr, zero, zero),
            (zero, zero, g_thth, zero), (g_tp, zero, zero, g_pp))
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def ks_radius(x, y, z, a):
    """Boyer-Lindquist radius from Kerr-Schild Cartesian coordinates:
    the positive root of r^4 - (rho^2 - a^2) r^2 - a^2 z^2 = 0."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    r2 = 0.5 * (b + torch.sqrt(b * b + 4.0 * a * a * z * z))
    return torch.sqrt(r2)


def kerr_schild_g_inv(q, params):
    """Contravariant Kerr(-Newman) metric in ingoing Kerr-Schild Cartesian
    coordinates at every point of q (..., 4) = (t, x, y, z): returns
    (..., 4, 4).  g^{mu nu} = eta^{mu nu} - 2 H l^mu l^nu with
    H = (M r - Q^2/2) r^2 / (r^4 + a^2 z^2) and
    l_mu = (1, (r x + a y)/(r^2 + a^2), (r y - a x)/(r^2 + a^2), z/r)."""
    params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
    mass, a = params[0], params[1]
    qc = _charge(params)
    x, y, z = q[..., 1], q[..., 2], q[..., 3]
    r = ks_radius(x, y, z, a)
    r2 = r * r
    r2a2 = r2 + a * a
    H = (mass * r - 0.5 * qc * qc) * r2 / (r2 * r2 + a * a * z * z)
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / r
    l_up = torch.stack([-1.0 * torch.ones_like(r), lx, ly, lz], dim=-1)
    eta = torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=q.dtype,
                                  device=q.device))
    return eta - (2.0 * H)[..., None, None] * (l_up[..., :, None]
                                               * l_up[..., None, :])


def horizon_radius(metric: str, mass, a=0.0, q=0.0):
    """Outer event-horizon radius r_+ of the Kerr-Newman family:
    M + sqrt(max(M^2 - a^2 - Q^2, 0)).  Arguments
    are tensors or numbers; numbers take the dtype and device of the first
    tensor argument (the default dtype if there is none)."""
    if metric in ("Kerr", "KerrSchild"):
        ref = next((v for v in (mass, a, q) if isinstance(v, torch.Tensor)),
                   torch.zeros(()))
        mass, a, q = (torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
                      for v in (mass, a, q))
        return mass + torch.sqrt(torch.clamp(mass * mass - a * a - q * q,
                                             min=0.0))
    raise NotImplementedError(
        f"horizon_radius({metric!r}): only the Kerr-Newman family is "
        f"ported to grtrace_torch (ROADMAP Queue A item 9)")


def null_p_t(p_sp, q, params, g_inv_fn):
    """Solve g^{ab} p_a p_b = 0 for p_t, with the g^{t i} cross terms, for
    a batch: p_sp (..., 3) spatial covectors, q (..., 4) positions.

    A p_t^2 + B p_t + C = 0 with A = g^tt, B = 2 g^{t i} p_i,
    C = g^{ij} p_i p_j; the future-directed root (-B - disc) / (2A), the
    branch that reduces to the positive Schwarzschild root (A < 0 outside
    the ergosphere)."""
    g = g_inv_fn(q, params)
    A = g[..., 0, 0]
    B = 2.0 * (g[..., 0, 1:] * p_sp).sum(-1)
    C = (p_sp[..., :, None] * g[..., 1:, 1:] * p_sp[..., None, :]).sum(
        (-2, -1))
    disc = torch.sqrt(torch.clamp(B * B - 4.0 * A * C, min=0.0))
    return (-B - disc) / (2.0 * A)
