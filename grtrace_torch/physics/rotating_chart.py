"""Closed-form FANTASY flows for the rotating regular families — the
mass-function Kerr-Schild chart of the generic engine, and the arithmetic
of the CUDA kernels G1r, S2r, T2r and D2 (`Chart::kKSMass` of
csrc/fantasy_gen.cu).

The JAX package takes these kicks and drifts as `jax.grad` of
Ham = 1/2 g^{ab} p_a p_b with `grtrace.physics.rotating_regular.
make_rotating_ks_g_inv`; here they are written out, as
physics/kerr_schild.py writes out the Kerr-Newman chart, and the tests hold
them against that autodiff.

With s = sqrt(b^2 + 4 a^2 z^2) (kerr_schild._geom's D), the chart's scalar
is H = N / s, N = m(r) r, so that

    H_q = (N' r_q - H s_q) / s,     N' = m + r m'

is kerr_schild._kick_drift's H_q with M r - Q^2 / 2 replaced by N and M by
N'.  With X = r^2 + k (Bardeen, k = g^2) or r^3 + k (Hayward,
k = 2 M l^2), both mass functions and their derivatives close in the same
form:

    Bardeen   m = M u^3, u = r / sqrt(X)    r m' = 3 M r^3 g^2 X^{-5/2}
    Hayward   m = M (r^3 / X)               r m' = 6 M^2 l^2 r^3 / X^2
    both      r m' = 3 m k / X

so N' = m + 3 m k / X.  At k = 0, u = r / sqrt(r r) = 1 and r^3 / r^3 = 1
exactly, so m = M and N' = M to the bit: the chart is kerr_schild.
_kick_drift at Q = 0.  JAX differentiates jnp.power(r^2 + g^2, 1.5) by
autodiff; the closed form differs from it in the last bits (ROADMAP Queue
C, "Closed-form mass-function derivatives").  k is rounded on the host in
the working dtype, in JAX's association: g * g, (2 M l) l
(`family_constant`).

The state is the 16-tuple of (N,) component tensors of
kerr_schild.py; the scalars (M, a, k) are Python floats exact in the
working dtype and `family` an int (FAMILY_CODE).  Every expression is
written in the order the kernel evaluates it, with only plain binary
tensor ops.
"""
from __future__ import annotations

import torch

ROT_BARDEEN, ROT_HAYWARD = 1, 2
# the family codes that the chart's scalar vector carries
FAMILY_CODE = {"RotatingBardeen": ROT_BARDEEN,
               "RotatingHayward": ROT_HAYWARD}


def family_constant(metric, mass, param):
    """The family's constant k in the dtype of the 0-dim tensors mass and
    param: g * g (Bardeen), (2 M l) l (Hayward)."""
    if FAMILY_CODE[metric] == ROT_BARDEEN:
        return param * param
    return (2.0 * mass * param) * param


def mass_function(r, mass, k, family):
    """(m, N') at the Kerr-Schild radius r: the family's mass function and
    N' = d(m r)/dr = m + 3 m k / X."""
    rr = r * r
    if family == ROT_BARDEEN:
        x = rr + k
        u = r / torch.sqrt(x)
        m = mass * (u * u * u)
    else:
        r3 = rr * r
        x = r3 + k
        m = mass * (r3 / x)
    return m, m + 3.0 * m * k / x


def _geom(x, y, z, mass, a, k, family):
    """kerr_schild._geom with H = m(r) r / s, and N' besides."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    az = a * z
    s = torch.sqrt(b * b + 4.0 * az * az)
    r2 = 0.5 * (b + s)
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    inv_D = 1.0 / s
    w = r2 + a * a
    inv_w = 1.0 / w
    m, dn = mass_function(r, mass, k, family)
    H = m * r * inv_D
    lx = (r * x + a * y) * inv_w
    ly = (r * y - a * x) * inv_w
    lz = z * inv_r
    return r, inv_r, inv_D, b, w, inv_w, H, dn, lx, ly, lz


def _kick_drift(x, y, z, pt, px, py, pz, mass, a, k, family):
    """dHam/dq (x, y, z) and dHam/dp (all 4) at one phase point: (kx, ky,
    kz, dt_, dx_, dy_, dz_), kerr_schild._kick_drift's terms with H_q =
    (N' r_q - H s_q) / s."""
    r, inv_r, inv_D, b, w, inv_w, H, dn, lx, ly, lz = _geom(
        x, y, z, mass, a, k, family)

    S = -pt + lx * px + ly * py + lz * pz
    HS2 = 2.0 * H * S

    dt_ = -pt + HS2
    dx_ = px - HS2 * lx
    dy_ = py - HS2 * ly
    dz_ = pz - HS2 * lz

    r_x = x * r * inv_D
    r_y = y * r * inv_D
    r_z = z * w * inv_r * inv_D
    D_x = 2.0 * x * b * inv_D
    D_y = 2.0 * y * b * inv_D
    D_z = 2.0 * z * (b + 2.0 * a * a) * inv_D

    H_x = (dn * r_x - H * D_x) * inv_D
    H_y = (dn * r_y - H * D_y) * inv_D
    H_z = (dn * r_z - H * D_z) * inv_D

    inv_r2 = inv_r * inv_r
    G = (x * px + y * py - 2.0 * r * (lx * px + ly * py)) * inv_w \
        - z * pz * inv_r2
    S_x = r_x * G + (r * px - a * py) * inv_w
    S_y = r_y * G + (a * px + r * py) * inv_w
    S_z = r_z * G + pz * inv_r

    S2 = S * S
    kx = -H_x * S2 - HS2 * S_x
    ky = -H_y * S2 - HS2 * S_y
    kz = -H_z * S2 - HS2 * S_z
    return kx, ky, kz, dt_, dx_, dy_, dz_


def flow_b(state, dt, mass, a, k, family):
    """Flow B: the metric at q2 and the momenta p1; kick p2 (x, y, z),
    drift q1 (all 4)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q2x, q2y, q2z, p1t, p1x, p1y, p1z, mass, a, k, family)
    p2x = p2x - dt * kx
    p2y = p2y - dt * ky
    p2z = p2z - dt * kz
    q1t = q1t + dt * dt_
    q1x = q1x + dt * dx_
    q1y = q1y + dt * dy_
    q1z = q1z + dt * dz_
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z)


def hamiltonian(x, y, z, pt, px, py, pz, mass, a, k, family):
    """Ham = 1/2 eta^{ab} p_a p_b - H S^2, elementwise: the null invariant
    the blow-up guard tests (kerr_schild.hamiltonian_ks's form)."""
    _, _, _, _, _, _, H, _, lx, ly, lz = _geom(x, y, z, mass, a, k, family)
    S = -pt + lx * px + ly * py + lz * pz
    return 0.5 * (-pt * pt + px * px + py * py + pz * pz) - H * S * S
