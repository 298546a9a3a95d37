"""Schwarzschild metric (contravariant, diagonal) and its partial
derivatives — the torch counterpart of `grtrace.physics.metric`.

Geometrized units G = c = 1, r_s = 2M.  Same expressions, in the same
association, as the JAX module (general-mass derivative forms).
"""
from __future__ import annotations

import torch


def contravariant_diag(r, theta, rs):
    """Diagonal of g^{mu nu} at (r, theta): (g^tt, g^rr, g^thth, g^phph)."""
    inv_fac = 1.0 - rs / r
    g_tt = -1.0 / inv_fac
    g_rr = inv_fac
    g_thth = 1.0 / (r * r)
    sin_th = torch.sin(theta)
    g_phph = 1.0 / ((r * sin_th) * (r * sin_th))
    return g_tt, g_rr, g_thth, g_phph


def dcontravariant_dr(r, theta, rs):
    """d/dr of the metric diagonal."""
    denom = r - rs
    d_tt = rs / (denom * denom)
    d_rr = rs / (r * r)
    r3 = r * r * r
    d_thth = -2.0 / r3
    sin_th = torch.sin(theta)
    d_phph = -2.0 / (r3 * sin_th * sin_th)
    return d_tt, d_rr, d_thth, d_phph


def dcontravariant_dth(r, theta, rs):
    """d/dtheta of the metric diagonal: only g^{phph} depends on theta."""
    sin_th = torch.sin(theta)
    cos_th = torch.cos(theta)
    return (-2.0 * cos_th) / ((r * r) * sin_th * sin_th * sin_th)


def christoffel_nonzero(r, theta, rs):
    """Non-zero Schwarzschild Christoffel symbols as a dict of tensors,
    keyed (upper, lower1, lower2), symmetric partners implied — the legacy
    Euler integrator's (engine/euler.py)."""
    sin_th = torch.sin(theta)
    cos_th = torch.cos(theta)
    return {
        (0, 1, 0): rs / (2.0 * r * (r - rs)),
        (1, 0, 0): (r - rs) * rs / (2.0 * r * r * r),
        (1, 1, 1): -rs / (2.0 * r * (r - rs)),
        (1, 2, 2): -(r - rs),
        (1, 3, 3): -(r - rs) * sin_th * sin_th,
        (2, 1, 2): 1.0 / r,
        (2, 3, 3): -sin_th * cos_th,
        (3, 1, 3): 1.0 / r,
        (3, 2, 3): cos_th / sin_th,
    }
