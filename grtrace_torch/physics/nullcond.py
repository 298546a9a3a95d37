"""Null-condition closure: solve g^{mu nu} p_mu p_nu = 0 for p_t — the torch
counterpart of `grtrace.physics.nullcond`."""
from __future__ import annotations

import torch


def null_p_t(p_sph, r, theta, *, mass_bh=1.0, future=True):
    """Return p_t solving the Schwarzschild null quadratic.

    p_sph: (..., 3) spatial momentum (p_r, p_th, p_ph); r, theta: the
    observer position (tensors).  future=True picks the positive root.
    """
    pr = p_sph[..., 0]
    pth = p_sph[..., 1]
    pph = p_sph[..., 2]

    f = 1.0 - 2.0 * mass_bh / r
    gtt = -1.0 / f
    grr = f
    gthth = 1.0 / (r * r)
    sin_th = torch.sin(theta)
    gphph = 1.0 / (r * r * sin_th * sin_th)

    a_coef = gtt  # < 0 outside horizon
    c_coef = grr * pr * pr + gthth * pth * pth + gphph * pph * pph

    disc = -4.0 * a_coef * c_coef  # B = 0 in Schwarzschild
    p_t = torch.sqrt(disc) / (2.0 * (-a_coef))  # always positive
    return p_t if future else -p_t


def build_null_4momentum(p_sph, pos_sph, *, mass_bh=1.0, future=True):
    """(..., 3) spatial momentum + (..., 3) position (r, theta, phi) ->
    (..., 4) null momentum (p_t, p_r, p_th, p_ph)."""
    p_t = null_p_t(p_sph, pos_sph[..., 0], pos_sph[..., 1], mass_bh=mass_bh,
                   future=future)
    return torch.cat([p_t[..., None], p_sph], dim=-1)
