"""Closed-form FANTASY flows for Kerr(-Newman) in Boyer-Lindquist
coordinates — the spherical-chart counterpart of physics/kerr_schild.py,
and the arithmetic of the CUDA kernels G1 and S2 (csrc/fantasy_gen.cu).

The JAX package has no such module: its generic engine takes the kicks and
drifts as `jax.grad` of H = 1/2 g^{ab} p_a p_b with the metric of
`grtrace.physics.spacetime.kerr_g_inv`.  Here they are written out by hand
(the tests hold them against that autodiff and against the port's own
`spacetime.make_flows`).

The state is a 16-tuple of (N,) component tensors (the layout of
hamiltonian.pack_state): (q1, p1, q2, p2), each (t, r, theta, phi).

Metric (q = (t, r, theta, phi), parameters M, a, Q; s = sin theta,
c = cos theta), the association of spacetime.kerr_g_inv:
    Sigma = r^2 + a^2 c^2,  Delta = r^2 - 2 M r + a^2 + Q^2,  w = r^2 + a^2
    inv_sd = 1 / (Sigma Delta)
    g^tt = -(w^2 - a^2 Delta s^2) inv_sd,  g^tphi = -(w - Delta) a inv_sd
    g^rr = Delta / Sigma,  g^thth = 1 / Sigma
    g^phph = (Delta - a^2 s^2) inv_sd / s^2
Derivatives (D = Sigma Delta, x = r or theta; N_tt, N_tp, N_pp the
numerators above):
    Sigma_r = 2 r,  Sigma_th = -a^2 (2 s c),  Delta_r = 2 r - 2 M
    D_x / D = (Sigma_x Delta + Sigma Delta_x) inv_sd
    g^tt_x = -(N_tt,x - N_tt D_x / D) inv_sd
             with N_tt,r = 2 w (2 r) - a^2 Delta_r s^2,
                  N_tt,th = -a^2 Delta (2 s c)
    g^tphi_x = -(N_tp,x - N_tp D_x / D) a inv_sd  with N_tp,r = 2 M,
               N_tp,th = 0
    g^rr_x = (Delta_x - g^rr Sigma_x) / Sigma,
    g^thth_x = -(g^thth Sigma_x) / Sigma
    g^phph_r = (Delta_r - N_pp D_r / D) inv_sd / s^2
    g^phph_th = (N_pp,th - N_pp D_th / D) inv_sd / s^2 - 2 g^phph c / s,
               N_pp,th = Sigma_th
    kick dH/dx = 1/2 (g^tt_x p_t^2 + 2 g^tphi_x p_t p_phi + g^rr_x p_r^2
                      + g^thth_x p_th^2 + g^phph_x p_phi^2)
    drift dH/dp = (g^tt p_t + g^tphi p_phi, g^rr p_r, g^thth p_th,
                   g^tphi p_t + g^phph p_phi)
The chart is stationary and axisymmetric: the kick on p_t and p_phi is
exactly 0, so the flows leave those rows as they are.  The derivatives
multiply by g^thth = 1 / Sigma and by one 1 / s^2 where the formulas
divide by Sigma, s^2 and s (c / s = c s / s^2): an evaluation divides five
times, the metric's four and 1 / s^2; the metric itself keeps
spacetime.kerr_g_inv's association, since the drift reads it.

Every expression is written in the order the kernel evaluates it, since
the kernel must round exactly as these functions do.  The scalars M, a, Q,
dt and the mixing trig are Python floats exact in the working dtype; a
product of two of them (a * a) rounds once when the tensor op casts it,
as the same product does in the working dtype.  Only plain binary tensor
ops appear, and no tensor is divided by a Python scalar.
"""
from __future__ import annotations

import torch


def _geom(r, th, mass, a, charge):
    """The metric at (r, theta) (spacetime.kerr_g_inv's components, in its
    association) and what its derivatives share."""
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = sin_th * sin_th
    rr = r * r
    sigma = rr + a * a * cos_th * cos_th
    delta = rr - 2.0 * mass * r + a * a + charge * charge
    w = rr + a * a
    inv_sd = 1.0 / (sigma * delta)
    n_tt = w * w - a * a * delta * sin2
    n_tp = w - delta
    n_pp = delta - a * a * sin2
    g_tt = -n_tt * inv_sd
    g_tp = -n_tp * a * inv_sd
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_pp = n_pp * inv_sd / sin2
    return (g_tt, g_tp, g_rr, g_thth, g_pp, sin_th, cos_th, sin2, sigma,
            delta, w, inv_sd, n_tt, n_tp, n_pp)


def _kick_drift(r, th, pt, pr, pth, pph, mass, a, charge=0.0):
    """dH/dr and dH/dtheta (the kick, SUBTRACTED scaled by dt) and dH/dp
    (the drift, ADDED scaled by dt) at one phase point:
    (k_r, k_th, d_t, d_r, d_th, d_ph)."""
    (g_tt, g_tp, g_rr, g_thth, g_pp, sin_th, cos_th, sin2, sigma, delta, w,
     inv_sd, n_tt, n_tp, n_pp) = _geom(r, th, mass, a, charge)

    two_r = 2.0 * r
    sc2 = 2.0 * sin_th * cos_th
    sig_th = -a * a * sc2
    del_r = two_r - 2.0 * mass
    q_r = (two_r * delta + sigma * del_r) * inv_sd
    q_th = sig_th * delta * inv_sd

    tt_r = -(2.0 * w * two_r - a * a * del_r * sin2 - n_tt * q_r) * inv_sd
    tt_th = -(-a * a * delta * sc2 - n_tt * q_th) * inv_sd
    tp_r = -(2.0 * mass - n_tp * q_r) * a * inv_sd
    tp_th = n_tp * q_th * a * inv_sd
    inv_sin2 = 1.0 / sin2
    rr_r = (del_r - g_rr * two_r) * g_thth
    rr_th = -(g_rr * sig_th) * g_thth
    hh_r = -(g_thth * two_r) * g_thth
    hh_th = -(g_thth * sig_th) * g_thth
    pp_r = (del_r - n_pp * q_r) * inv_sd * inv_sin2
    pp_th = ((sig_th - n_pp * q_th) * inv_sd * inv_sin2
             - 2.0 * g_pp * cos_th * sin_th * inv_sin2)

    ptpt, ptpp = pt * pt, pt * pph
    prpr, phph, pppp = pr * pr, pth * pth, pph * pph
    k_r = 0.5 * (tt_r * ptpt + 2.0 * tp_r * ptpp + rr_r * prpr
                 + hh_r * phph + pp_r * pppp)
    k_th = 0.5 * (tt_th * ptpt + 2.0 * tp_th * ptpp + rr_th * prpr
                  + hh_th * phph + pp_th * pppp)

    d_t = g_tt * pt + g_tp * pph
    d_r = g_rr * pr
    d_th = g_thth * pth
    d_ph = g_tp * pt + g_pp * pph
    return k_r, k_th, d_t, d_r, d_th, d_ph


def flow_b(state, dt, mass, a, charge=0.0):
    """Flow B: metric at q2 and momenta p1; kick p2 (r, theta rows),
    drift q1 (all 4)."""
    (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph) = state
    k_r, k_th, d_t, d_r, d_th, d_ph = _kick_drift(
        q2r, q2th, p1t, p1r, p1th, p1ph, mass, a, charge)
    p2r = p2r - dt * k_r
    p2th = p2th - dt * k_th
    q1t = q1t + dt * d_t
    q1r = q1r + dt * d_r
    q1th = q1th + dt * d_th
    q1ph = q1ph + dt * d_ph
    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)
