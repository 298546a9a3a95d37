"""Closed-form FANTASY flows for the static beyond-Kerr families — the
static chart of the generic engine, and the arithmetic of the CUDA kernels
G1s, S2s, T2s and D1 (`Chart::kStatic` of csrc/fantasy_gen.cu).

The JAX package takes these kicks and drifts as `jax.grad` of
H = 1/2 g^{ab} p_a p_b with `grtrace.physics.static_metrics.make_static_g_inv`;
here they are written out (the tests hold them against that autodiff).

The state is a 16-tuple of (N,) component tensors (hamiltonian.pack_state):
(q1, p1, q2, p2), each (t, r, theta, phi).

Metric (s = sin theta, c = cos theta):
    H = 1/2 (-p_t^2 / f + f p_r^2 + p_th^2 / r^2 + p_ph^2 / (r^2 s^2))
Derivatives (inv_f = 1 / f, inv_r = 1 / r, g^thth = inv_r^2,
g^phph = g^thth / s^2):
    kick dH/dr  = 1/2 (f' inv_f^2 p_t^2 + f' p_r^2 - 2 g^thth inv_r p_th^2
                       - 2 g^phph inv_r p_ph^2)
    kick dH/dth = 1/2 (-2 g^phph c s / s^2) p_ph^2
    drift dH/dp = (-inv_f p_t, f p_r, g^thth p_th, g^phph p_ph)
All four components are kept: the folded camera starts its rays at
theta = fl(pi/2) with p_theta = 0, but cos(fl(pi/2)) is not 0 in floating
point (6.1e-17 in float64, -4.4e-8 in float32), so the theta kick moves
p_theta off 0 as JAX's autodiff step moves it.

The lapse and its derivative, per family (m2 = 2M; `k` the family's
constant, rounded to the working dtype on the host by
integrate_generic.gen_params):
    Kottler  (k = Lambda / 3):     f = 1 - m2 inv_r - k r^2,
                                   f' = m2 inv_r inv_r - 2 k r
    Bardeen  (k = g^2), x = r^2 + k, x15 = x sqrt(x):
                                   f = 1 - m2 r^2 / x15,
                                   f' = m2 r (r^2 - 2 k) / (x15 x)
    Hayward  (k = 2 M l^2), D = r^2 r + k:
                                   f = 1 - m2 r^2 / D,
                                   f' = m2 r (r^2 r - 2 k) / (D D)
(JAX's Bardeen lapse takes jnp.power(x, 1.5); x sqrt(x) differs from it in
the last bits, within the tests' stated tolerance.)

Every expression is written in the order the kernel evaluates it: only
plain binary tensor ops, a Python scalar exact in the working dtype on one
side, and no tensor divided by a Python scalar.
"""
from __future__ import annotations

import torch

KOTTLER, BARDEEN, HAYWARD = 0, 1, 2
# the family codes that the static chart's scalar vector carries
FAMILY_CODE = {"Kottler": KOTTLER, "Bardeen": BARDEEN, "Hayward": HAYWARD}


def lapse(r, mass, k, family):
    """(f, f', inv_r) at r for the family code `family` (0 Kottler, 1
    Bardeen, 2 Hayward) with the family constant k."""
    m2 = 2.0 * mass
    inv_r = 1.0 / r
    rr = r * r
    if family == KOTTLER:
        f = 1.0 - m2 * inv_r - k * rr
        fp = m2 * inv_r * inv_r - 2.0 * k * r
    elif family == BARDEEN:
        x = rr + k
        x15 = x * torch.sqrt(x)
        f = 1.0 - m2 * rr / x15
        fp = m2 * r * (rr - 2.0 * k) / (x15 * x)
    else:
        r3 = rr * r
        d = r3 + k
        f = 1.0 - m2 * rr / d
        fp = m2 * r * (r3 - 2.0 * k) / (d * d)
    return f, fp, inv_r


def _kick_drift(r, th, pt, pr, pth, pph, mass, k, family):
    """dH/dr and dH/dtheta (the kick, SUBTRACTED scaled by dt) and dH/dp
    (the drift, ADDED scaled by dt) at one phase point:
    (k_r, k_th, d_t, d_r, d_th, d_ph).  The signature of kerr_bl's, the
    scalars (M, k, family) in the place of (M, a, Q)."""
    f, fp, inv_r = lapse(r, mass, k, int(family))
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = sin_th * sin_th
    inv_f = 1.0 / f
    inv_sin2 = 1.0 / sin2
    g_hh = inv_r * inv_r
    g_pp = g_hh * inv_sin2

    tt_r = fp * inv_f * inv_f
    hh_r = -2.0 * g_hh * inv_r
    pp_r = hh_r * inv_sin2
    pp_th = -2.0 * g_pp * cos_th * sin_th * inv_sin2

    pppp = pph * pph
    k_r = 0.5 * (tt_r * (pt * pt) + fp * (pr * pr) + hh_r * (pth * pth)
                 + pp_r * pppp)
    k_th = 0.5 * (pp_th * pppp)

    d_t = -inv_f * pt
    d_r = f * pr
    d_th = g_hh * pth
    d_ph = g_pp * pph
    return k_r, k_th, d_t, d_r, d_th, d_ph


def flow_b(state, dt, mass, k, family):
    """Flow B: the metric at q2 and the momenta p1; kick p2 (r, theta
    rows), drift q1 (all 4)."""
    (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph) = state
    k_r, k_th, d_t, d_r, d_th, d_ph = _kick_drift(
        q2r, q2th, p1t, p1r, p1th, p1ph, mass, k, family)
    p2r = p2r - dt * k_r
    p2th = p2th - dt * k_th
    q1t = q1t + dt * d_t
    q1r = q1r + dt * d_r
    q1th = q1th + dt * d_th
    q1ph = q1ph + dt * d_ph
    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)
