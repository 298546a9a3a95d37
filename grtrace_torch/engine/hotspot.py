"""The Kerr-Schild -> Boyer-Lindquist time and azimuth offsets of
`grtrace.engine.hotspot`, in torch.

Crossing events are recorded on the Cartesian Kerr-Schild chart, whose time
and azimuth differ from Boyer-Lindquist ones by pure functions of r:
t_ks = t_bl + T(r), phi_ks = phi_bl + Phi(r).  The subring summary
(engine/subring.py) subtracts T to compare crossings at different radii in
BL time.  Only this conversion is ported here; the orbiting hot-spot movie
(`HotspotConfig`, `hotspot_statics`, the light curves) waits for the rest
of ROADMAP Queue A item 6.
"""
from __future__ import annotations

import torch

from ..physics.spacetime import _charge


def bl_time_azimuth_offsets(r, params):
    """Closed-form T(r), Phi(r) with T' = (2 M r - Q^2)/Delta and
    Phi' = a/Delta, elementwise on r (a tensor).

    Delta = (r - r_plus)(r - r_minus); partial fractions give
    T = c_plus ln(r - r_plus) + c_minus ln(r - r_minus) with
    c_pm = +-(2 M r_pm - Q^2)/(r_plus - r_minus), and
    Phi = a/(r_plus - r_minus) ln((r - r_plus)/(r - r_minus)).
    Schwarzschild (a = Q = 0) degenerates to T = 2M ln(r - 2M), Phi = 0.
    params = (M, a[, Q]) as numbers or a tensor, taken in r's dtype."""
    params = torch.as_tensor(params, dtype=r.dtype, device=r.device)
    mass, a = params[0], params[1]
    qc = _charge(params)
    disc = torch.sqrt(torch.clamp(mass * mass - a * a - qc * qc, min=1e-30))
    r_p, r_m = mass + disc, mass - disc
    two = r_p - r_m
    c_p = (2.0 * mass * r_p - qc * qc) / two
    c_m = -(2.0 * mass * r_m - qc * qc) / two
    lp = torch.log(torch.clamp(r - r_p, min=1e-30))
    lm = torch.log(torch.clamp(r - r_m, min=1e-30))
    return c_p * lp + c_m * lm, (a / two) * (lp - lm)
