"""Ray classification + RGB compositing as masks and gathers — the torch
counterpart of `grtrace.engine.classify`.

Classification codes:
    0 'bh'               captured: r <= 1.2*rs OR alpha0 <= bh_angle
    1 'numerical error'  r >= 100 -> red pixel
    2 'escape_bg'        on the boundary sphere, inside the background patch
    3 'escape_no_patch'  on the boundary sphere, outside the patch
    4 'in_domain'        step budget exhausted inside the domain

The reference's quirks are kept as in the JAX module: b_crit = 3 sqrt(3) rs
and bh_angle = arcsin(b_crit / r_obs) / 2; the escape direction is the final
position's angles, un-folded by the per-ray beta; patch membership by
center distance with wrapped delta-phi.  Scalar arguments are tensors of
the ray dtype (0-dim), as the JAX pipeline passes them.
"""
from __future__ import annotations

import math

import torch

from ..physics.coords import (cartesian_to_spherical, rotate_x,
                              spherical_to_cartesian)

CLS_BH = 0
CLS_NUMERICAL = 1
CLS_ESCAPE_BG = 2
CLS_ESCAPE_NO_PATCH = 3
CLS_IN_DOMAIN = 4


def unfold_hit(final_q, beta):
    """Rotate final positions back by +beta about +x.

    final_q: (..., 4) -> (r, theta, phi) after un-folding.
    """
    r = final_q[..., 1]
    x, y, z = spherical_to_cartesian(r, final_q[..., 2], final_q[..., 3])
    x, y, z = rotate_x(x, y, z, beta)
    _, th, ph = cartesian_to_spherical(x, y, z)
    return r, th, ph


def classify_rays(final_q, alpha0, beta, *, rs, r_obs_x, boundary_radius,
                  patch_center_theta, patch_center_phi,
                  patch_size_theta, patch_size_phi,
                  flip_theta=False, flip_phi=False, has_background=True):
    """Return (cls, th_hit, ph_hit, patch_u01, patch_v01).

    cls is the int32 class per ray; (th_hit, ph_hit) the reported hit
    angles (photon_data.csv values); patch_u01/patch_v01 continuous texture
    coordinates in [0, 1] for escape_bg rays (undefined elsewhere).
    """
    r_bh, th_hit, ph_hit = unfold_hit(final_q, beta)

    theta0 = patch_center_theta - patch_size_theta / 2
    theta1 = patch_center_theta + patch_size_theta / 2
    phi0 = patch_center_phi - patch_size_phi / 2
    phi_span = patch_size_phi

    two_pi = 2.0 * math.pi
    th_m = torch.remainder(th_hit, two_pi)
    ph_m = torch.remainder(ph_hit, two_pi)

    dtheta = (th_m - patch_center_theta).abs()
    ph_f = -ph_m if flip_phi else ph_m
    phi_rel = torch.remainder(ph_f - phi0, two_pi)
    dphi = (torch.remainder(ph_f - patch_center_phi + math.pi, two_pi)
            - math.pi).abs()
    inside_patch = (dtheta <= patch_size_theta / 2) & (dphi <= phi_span / 2)

    theta_map = math.pi - th_m if flip_theta else th_m
    u01 = (theta_map - theta0) / (theta1 - theta0)
    v01 = phi_rel / phi_span

    # precedence chain: bh > numerical > boundary > in_domain
    b_crit = 3.0 * math.sqrt(3.0) * rs
    bh_angle = torch.arcsin(b_crit / r_obs_x) / 2.0
    is_bh = (r_bh <= rs * 1.2) | (alpha0 <= bh_angle)
    is_numerical = r_bh >= 100.0
    is_boundary = r_bh >= boundary_radius

    cls = torch.full(r_bh.shape, CLS_IN_DOMAIN, dtype=torch.int32,
                     device=r_bh.device)
    if has_background:
        cls = torch.where(is_boundary,
                          torch.where(inside_patch, CLS_ESCAPE_BG,
                                      CLS_ESCAPE_NO_PATCH), cls)
    else:
        cls = torch.where(is_boundary, CLS_ESCAPE_NO_PATCH, cls)
    cls = torch.where(is_numerical, CLS_NUMERICAL, cls)
    cls = torch.where(is_bh, CLS_BH, cls)

    # photon_data.csv parity: only the boundary-with-background branch
    # reports the mod-2pi/flip-massaged phi
    reaches_patch_branch = (~is_bh) & (~is_numerical) & is_boundary
    ph_csv = torch.where(reaches_patch_branch & bool(has_background),
                         ph_f, ph_hit)

    return cls, th_m, ph_csv, u01, v01


def composite(cls, u01, v01, bg_array):
    """Class + texture coords -> (..., 3) uint8 RGB.

    bg_array: (th, tw, 3) uint8 tensor on the rays' device.  Index rounding
    int(x * (n-1) + 0.5), clipped.
    """
    th, tw = bg_array.shape[0], bg_array.shape[1]
    u = torch.clamp((u01 * (th - 1) + 0.5).to(torch.int32), 0, th - 1)
    v = torch.clamp((v01 * (tw - 1) + 0.5).to(torch.int32), 0, tw - 1)
    texel = bg_array[u.long(), v.long()]  # gather

    rgb = torch.zeros(cls.shape + (3,), dtype=torch.uint8, device=cls.device)
    red = torch.tensor([255, 0, 0], dtype=torch.uint8, device=cls.device)
    rgb = torch.where((cls == CLS_NUMERICAL)[..., None], red, rgb)
    rgb = torch.where((cls == CLS_ESCAPE_BG)[..., None], texel, rgb)
    return rgb


def count_vector(cls):
    """(captured, in_domain, escaped, background, numerical_error) as one
    (5,) int64 tensor on the rays' device — one host fetch for all five."""
    return torch.stack([
        (cls == CLS_BH).sum(),
        (cls == CLS_IN_DOMAIN).sum(),
        ((cls == CLS_ESCAPE_NO_PATCH) | (cls == CLS_ESCAPE_BG)).sum(),
        (cls == CLS_ESCAPE_BG).sum(),
        (cls == CLS_NUMERICAL).sum(),
    ])


def summary_counts(cls):
    """Captured / in-domain / escaped / background / numerical-error counts
    as Python ints."""
    cv = count_vector(cls).tolist()
    return dict(zip(("captured", "in_domain", "escaped", "background",
                     "numerical_error"), cv))
