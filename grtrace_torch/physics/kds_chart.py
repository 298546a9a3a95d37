"""Closed-form FANTASY flows for Kerr-de Sitter in its Boyer-Lindquist-like
Carter chart — the arithmetic of the CUDA kernels G1d, S2d, T2d and D3
(`Chart::kKdS` of csrc/fantasy_gen.cu).

The JAX package takes these kicks and drifts as `jax.grad` of H = 1/2
g^{ab} p_a p_b with `grtrace.physics.kerr_de_sitter.kerr_de_sitter_g_inv`;
here they are written out, as physics/kerr_bl.py writes out Kerr's, and
the tests hold them against that autodiff.

With L = Lambda / 3 (rounded once, on the host, in the working dtype and
carried in the charge slot), chi^2 = (1 + L a^2)^2, s = sin theta, c = cos
theta and A = a^2 c^2:

    Sigma = r^2 + A,   w = r^2 + a^2,   Delta = r^2 - 2 M r + a^2 - L r^2 w
    E = Delta_th = 1 + L A,   F = chi^2 / E,   inv_sd = 1 / (Sigma Delta)
    g^tt = -(w^2 E - a^2 Delta s^2) inv_sd F
    g^tphi = -(w E - Delta) a inv_sd F
    g^rr = Delta / Sigma,   g^thth = E / Sigma
    g^phph = (Delta - a^2 s^2 E) inv_sd F / s^2

which is kerr_bl's association with E and F inserted.  The theta
dependence of E (absent in Boyer-Lindquist) enters the theta derivatives
through E_th = L Sigma_th and the log-derivative q_th + E_th / E of
Sigma Delta E / chi^2; the r derivatives read Delta_r = 2 r - 2 M - L 2 r
(w + r^2) and, for g^tphi, N_tp,r = 2 M + L 2 r (A + w + r^2), which is
2 M exactly at L = 0 (where the difference 2 r E - Delta_r would round).
p_t and p_phi stay exact invariants; the kicked rows are r and theta.

At Lambda = 0 every added term is an exact zero and every added factor an
exact one (x - 0 = x, x * 1 = x), so the chart is kerr_bl._kick_drift at
Q = 0 bit for bit.  An evaluation divides six times (1 / E, 1 / Sigma,
1 / (Sigma Delta), Delta / Sigma, 1 / s^2 and g^phph's / s^2).

The state is the 16-tuple of (N,) component tensors of kerr_bl.py; the
scalars M, a, L and chi^2 are Python floats exact in the working dtype
(`chi_squared` rounds chi^2 as the kernel does).  Every expression is
written in the order the kernel evaluates it, with only plain binary
tensor ops.
"""
from __future__ import annotations

import torch


def chi_squared(lam3, a, dtype):
    """chi^2 = (1 + L a a)^2 rounded in `dtype`, operation by operation, as
    the kernel forms it once per ray: a Python float."""
    chi = 1.0 + torch.tensor(lam3, dtype=dtype) * a * a
    return float(chi * chi)


def _kick_drift(r, th, pt, pr, pth, pph, mass, a, lam3, chi2):
    """dH/dr and dH/dtheta (the kick, SUBTRACTED scaled by dt) and dH/dp
    (the drift, ADDED scaled by dt) at one phase point: (k_r, k_th, d_t,
    d_r, d_th, d_ph)."""
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = sin_th * sin_th
    rr = r * r
    ac2 = a * a * cos_th * cos_th
    sigma = rr + ac2
    w = rr + a * a
    delta = rr - 2.0 * mass * r + a * a - lam3 * rr * w
    dth = 1.0 + lam3 * ac2
    inv_dth = 1.0 / dth
    kf = chi2 * inv_dth
    inv_sig = 1.0 / sigma
    inv_sd = 1.0 / (sigma * delta)
    n_tt = w * w * dth - a * a * delta * sin2
    n_tp = w * dth - delta
    n_pp = delta - a * a * sin2 * dth
    g_tt = -n_tt * inv_sd * kf
    g_tp = -n_tp * a * inv_sd * kf
    g_rr = delta / sigma
    g_thth = dth * inv_sig
    g_pp = n_pp * inv_sd * kf / sin2

    two_r = 2.0 * r
    lam_x = lam3 * two_r
    sc2 = 2.0 * sin_th * cos_th
    sig_th = -a * a * sc2
    e_th = lam3 * sig_th
    del_r = two_r - 2.0 * mass - lam_x * (w + rr)
    q_r = (two_r * delta + sigma * del_r) * inv_sd
    q_th = sig_th * delta * inv_sd
    q_thk = q_th + e_th * inv_dth

    tt_r = -(2.0 * w * two_r * dth - a * a * del_r * sin2
             - n_tt * q_r) * inv_sd * kf
    tt_th = -(-a * a * delta * sc2 + w * w * e_th
              - n_tt * q_thk) * inv_sd * kf
    ntp_r = 2.0 * mass + lam_x * (ac2 + w + rr)
    tp_r = -(ntp_r - n_tp * q_r) * a * inv_sd * kf
    tp_th = (n_tp * q_thk - w * e_th) * a * inv_sd * kf
    inv_sin2 = 1.0 / sin2
    rr_r = (del_r - g_rr * two_r) * inv_sig
    rr_th = -(g_rr * sig_th) * inv_sig
    hh_r = -(g_thth * two_r) * inv_sig
    hh_th = (e_th - g_thth * sig_th) * inv_sig
    pp_r = (del_r - n_pp * q_r) * inv_sd * kf * inv_sin2
    pp_th = ((sig_th * dth - a * a * sin2 * e_th - n_pp * q_thk) * inv_sd
             * kf * inv_sin2
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


def flow_b(state, dt, mass, a, lam3, chi2):
    """Flow B: metric at q2 and momenta p1; kick p2 (r, theta rows),
    drift q1 (all 4)."""
    (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph) = state
    k_r, k_th, d_t, d_r, d_th, d_ph = _kick_drift(
        q2r, q2th, p1t, p1r, p1th, p1ph, mass, a, lam3, chi2)
    p2r = p2r - dt * k_r
    p2th = p2th - dt * k_th
    q1t = q1t + dt * d_t
    q1r = q1r + dt * d_r
    q1th = q1th + dt * d_th
    q1ph = q1ph + dt * d_ph
    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)
