"""Semi-analytic null geodesics from the separated Kerr-Newman Hamiltonian
— the torch counterpart of `grtrace.physics.geodesic_exact`.

In Mino time the null Hamiltonian separates (physics/photon_shell.py):

    (dr/dtau)^2 = R(r) = -Delta(r) (eta + W_r(r)),
    (dtheta/dtau)^2 = Theta(th) = eta - W_th(th),
    dt/dtau = T_r(r) + T_th(th),  dphi/dtau = P_r(r) + P_th(th),

so a ray is two 1-D motions and four path quadratures, no stepping.
`crossing_table` gives the Boyer-Lindquist (tau, r, t, phi) of each ray's
first equatorial crossings; `escape_state` where each scattering ray
leaves the sphere r = r_bound.  Every turning-point singularity is removed
by the substitution x = sqrt(r - r4) (or sqrt(th - th_minus)) and 96-node
Gauss-Legendre; turning points come from scans and fixed-count
bisections, each polished by one Newton step from the detached root, so
that forward-mode derivatives (engine/images.py) carry the implicit
gradient.

Torch idiom, as in physics/photon_shell.py: `jax.vmap` over rays is
`torch.func.vmap`, each `fori_loop` a Python loop of the same count of
`torch.where` selects, `jax.grad` `torch.func.grad`, `stop_gradient` a
`.detach()`.  Float64.  The rays run in chunks of `CHUNK` (a 1024-point
radial grid a ray makes a 256^2 frame's float64 grids half a GiB each);
a chunk gives the values one batch would.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, vmap

from .photon_shell import _delta, _theta_turning, w_polar, w_radial
from .polarization import bl_from_ks
from .spacetime import _charge, kerr_g_inv

F64 = torch.float64
_HALF_PI = 0.5 * math.pi
_GL_X_NP, _GL_W_NP = np.polynomial.legendre.leggauss(96)
CHUNK = 4096  # rays per vmapped batch


def _nodes(device):
    return (torch.tensor(_GL_X_NP, dtype=F64, device=device),
            torch.tensor(_GL_W_NP, dtype=F64, device=device))


def _linspace(lo, hi, n):
    """n points from lo to hi (tensors), jnp.linspace's arithmetic: lo +
    i (hi - lo) / (n - 1), the last point hi."""
    i = torch.arange(n, dtype=F64, device=lo.device)
    pts = lo + i * ((hi - lo) / (n - 1))
    return torch.cat([pts[:-1], hi.reshape(1)])


def radial_potential(r, lam, eta, params):
    """R(r) = -Delta (eta + W_r): (dr/dtau)^2 along the ray."""
    return -_delta(r, params) * (eta + w_radial(r, lam, params))


def _sigma_pt_pphi(r, th, lam, params):
    """(Sigma p^t, Sigma p^phi) for p = -dt + lam dphi."""
    zero = torch.zeros_like(r + th)
    g = kerr_g_inv(torch.stack([zero, r + zero, th + zero, zero], dim=-1),
                   params)
    sigma = 1.0 / g[..., 2, 2]
    return (sigma * (-g[..., 0, 0] + g[..., 0, 3] * lam),
            sigma * (-g[..., 0, 3] + g[..., 3, 3] * lam))


def t_phi_r_parts(r, lam, params):
    """(T_r, P_r): the radial halves of dt/dtau, dphi/dtau."""
    return _sigma_pt_pphi(r, torch.full_like(r, _HALF_PI), lam, params)


def t_phi_theta_parts(th, lam, params, r_ref=10.0):
    """(T_th, P_th): the polar halves (zero at the equator)."""
    r = torch.full_like(th, r_ref)
    t_full, p_full = _sigma_pt_pphi(r, th, lam, params)
    t_eq, p_eq = _sigma_pt_pphi(r, torch.full_like(th, _HALF_PI), lam,
                                params)
    return t_full - t_eq, p_full - p_eq


def conserved_from_ks(q0, p0, params):
    """(lam, eta, theta_o, s_theta, s_r, r_o, e_sign) of one Kerr-Schild
    camera ray: lam = p_phi / e and eta = (p_th / e)^2 + W_th(th_0) with
    e = -p_t signed (the backward camera's time reversal and azimuth
    mirror), s_theta and s_r the raw signs of p_th and p_r."""
    q_bl, p_bl = bl_from_ks(q0, p0, params)
    e = -p_bl[0]
    lam = p_bl[3] / e
    p_th = p_bl[2] / e
    th_o = q_bl[2]
    eta = p_th * p_th + w_polar(th_o, lam, params)
    return (lam, eta, th_o, torch.sign(p_bl[2]), torch.sign(p_bl[1]),
            q_bl[1], torch.sign(e))


def _r_hor(params):
    mass, a = params[0], params[1]
    qc = _charge(params)
    return mass + torch.sqrt(torch.clamp(mass * mass - a * a - qc * qc,
                                         min=0.0))


def radial_turning(lam, eta, params, r_obs, n_grid=1024, iters=60):
    """(has_turn, r4) of one ray: whether R has a root in (r_horizon,
    r_obs) and the largest such root, by a downward scan of n_grid points
    (a near-critical dip refined by 90 ternary steps), `iters`
    bisections and one Newton polish from the detached root, clipped to a
    scan cell; r4 = the horizon where there is none.  The scan, the
    ternary steps and the bisections run on detached values: the root they
    find is detached anyway, so a forward-mode caller's tangents need not
    ride through them."""
    r_hor = _r_hor(params)
    lam_d, eta_d = lam.detach(), eta.detach()
    grid = _linspace(r_hor + 1e-6, r_obs.detach(), n_grid)
    rv = radial_potential(grid, lam_d, eta_d, params)
    neg = rv < 0.0
    any_neg = neg.any()

    i_min = torch.clamp(torch.argmin(rv), 1, n_grid - 2)
    tlo, thi = grid[i_min - 1], grid[i_min + 1]
    for _ in range(90):
        m1 = tlo + (thi - tlo) / 3.0
        m2 = thi - (thi - tlo) / 3.0
        take_left = (radial_potential(m1, lam_d, eta_d, params)
                     < radial_potential(m2, lam_d, eta_d, params))
        tlo, thi = torch.where(take_left, tlo, m1), torch.where(take_left,
                                                                m2, thi)
    r_dip = 0.5 * (tlo + thi)
    dip_neg = radial_potential(r_dip, lam_d, eta_d, params) < 0.0

    has_turn = any_neg | dip_neg
    last_neg = n_grid - 1 - torch.argmax(torch.flip(neg, (0,)).to(
        torch.int8))
    idx = torch.minimum(torch.where(any_neg, last_neg, i_min),
                        torch.tensor(n_grid - 2, device=grid.device))
    lo = torch.where(any_neg, grid[idx], r_dip)
    hi = grid[idx + 1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg_mid = radial_potential(mid, lam_d, eta_d, params) < 0.0
        lo, hi = torch.where(neg_mid, mid, lo), torch.where(neg_mid, hi, mid)
    r_d = 0.5 * (lo + hi)
    rv_d = radial_potential(r_d, lam, eta, params)
    dr_d = grad(radial_potential, argnums=0)(r_d, lam, eta, params)
    ok = has_turn & (torch.abs(dr_d) > 1e-30)
    cell = (grid[1] - grid[0]).detach()
    step = rv_d / torch.where(ok, dr_d, torch.ones_like(dr_d))
    delta_r = torch.minimum(torch.maximum(step, -cell), cell)
    root = torch.where(ok, r_d - delta_r, r_d)
    return has_turn, torch.where(has_turn, root, r_hor + 0.0 * root)


def _leg_theta(th_a, th_b, th_minus, lam, eta, params, nodes):
    """(Mino time, t gain, phi gain) over one monotone polar leg folded
    into [th_minus, pi/2], th = th_minus + x^2."""
    gl_x, gl_w = nodes
    xa = torch.sqrt(torch.clamp(th_a - th_minus, min=1e-300))
    xb = torch.sqrt(torch.clamp(th_b - th_minus, min=1e-300))
    mid, half = 0.5 * (xa + xb), 0.5 * (xb - xa)
    x = mid + half * gl_x
    th = th_minus + x * x
    theta_pot = eta - w_polar(th, lam, params)
    g = torch.clamp(theta_pot / torch.clamp(th - th_minus, min=1e-120),
                    min=1e-120)
    base = 2.0 / torch.sqrt(g)
    t_th, p_th = t_phi_theta_parts(th, lam, params)
    w = gl_w * half
    return (torch.sum(w * base), torch.sum(w * base * t_th),
            torch.sum(w * base * p_th))


def _leg_r(r_a, r_b, anchor, lam, eta, params, nodes):
    """(Mino time, t gain, phi gain) over one monotone radial leg [r_a,
    r_b], r = anchor + x^2."""
    gl_x, gl_w = nodes
    xa = torch.sqrt(torch.clamp(r_a - anchor, min=1e-300))
    xb = torch.sqrt(torch.clamp(r_b - anchor, min=1e-300))
    mid, half = 0.5 * (xa + xb), 0.5 * (xb - xa)
    x = mid + half * gl_x
    r = anchor + x * x
    rad = radial_potential(r, lam, eta, params)
    g = torch.clamp(rad / torch.clamp(r - anchor, min=1e-120), min=1e-120)
    base = 2.0 / torch.sqrt(g)
    t_r, p_r = t_phi_r_parts(r, lam, params)
    w = gl_w * half
    return (torch.sum(w * base), torch.sum(w * base * t_r),
            torch.sum(w * base * p_r))


def _invert_r_leg(tau_target, r_lo, r_hi, anchor, lam, eta, params,
                  from_high, nodes, iters=50):
    """The radius at Mino time tau_target along one monotone leg (ingoing
    from r_hi with from_high, outgoing from r_lo otherwise): `iters`
    bisections (on detached values, as in radial_turning), then a Newton
    polish clipped to [r_lo, r_hi]."""
    def leg(r, r_lo, r_hi, anchor, lam, eta):
        if from_high:
            return _leg_r(r, r_hi, anchor, lam, eta, params, nodes)[0]
        return _leg_r(r_lo, r, anchor, lam, eta, params, nodes)[0]

    def f(r):
        return leg(r, r_lo, r_hi, anchor, lam, eta)

    det = [x.detach() for x in (r_lo, r_hi, anchor, lam, eta)]
    target_d = tau_target.detach()
    lo, hi = det[0], det[1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        val = leg(mid, *det)
        too_far = (val > target_d) if from_high else (val < target_d)
        lo, hi = torch.where(too_far, mid, lo), torch.where(too_far, hi, mid)
    r_d = 0.5 * (lo + hi)
    res = f(r_d) - tau_target
    rad = torch.clamp(radial_potential(r_d, lam, eta, params), min=1e-30)
    sgn = 1.0 if from_high else -1.0
    return torch.minimum(torch.maximum(r_d + sgn * res * torch.sqrt(rad),
                                       r_lo), r_hi)


def _chunked(one, tensors, chunk=CHUNK):
    """vmap(one) over the leading dim of `tensors`, in chunks; the dict
    outputs concatenated."""
    n = tensors[0].shape[0]
    if n == 0:
        return {}
    parts = [vmap(one)(*(t[i:i + chunk] for t in tensors))
             for i in range(0, n, chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def crossing_table(q0s, p0s, params, n_orders=3, r_min_margin=1.02):
    """The Boyer-Lindquist records of the first n_orders equatorial
    crossings of (N, 4) Kerr-Schild camera rays: a dict of (N, n_orders)
    tensors tau, r, t, phi, valid and (N,) lam, eta, e_sign, captured.  A
    crossing is valid before a scattering ray retreats past its start
    radius, outside r_min_margin x the horizon for a captured one, and for
    an ordinary (eta > 0), ingoing ray."""
    params = torch.as_tensor(params, dtype=F64, device=q0s.device)
    r_hor = _r_hor(params)
    nodes = _nodes(q0s.device)
    ks = torch.arange(n_orders, dtype=F64, device=q0s.device)

    def one_ray(q0, p0):
        lam, eta, th_o, s_th, s_r, r_o, e_sign = conserved_from_ks(
            q0, p0, params)
        ordinary = eta > 0.0
        ingoing = s_r < 0.0
        eta_s = torch.where(ordinary, eta, torch.ones_like(eta))

        below = th_o > _HALF_PI
        th_f = torch.where(below, math.pi - th_o, th_o)
        s_f = torch.where(below, -s_th, s_th)
        th_minus = _theta_turning(lam, eta_s, params)
        th_f = torch.minimum(torch.maximum(th_f, th_minus),
                             torch.full_like(th_f, _HALF_PI))
        half_pi = torch.full_like(th_f, _HALF_PI)

        to_eq = _leg_theta(th_f, half_pi, th_minus, lam, eta_s, params,
                           nodes)
        to_turn = _leg_theta(th_minus, th_f, th_minus, lam, eta_s, params,
                             nodes)
        half = _leg_theta(th_minus, half_pi, th_minus, lam, eta_s, params,
                          nodes)
        toward = s_f > 0.0
        first = tuple(torch.where(toward, te, tt + h)
                      for te, tt, h in zip(to_eq, to_turn, half))
        half2 = tuple(2.0 * h for h in half)
        tau_k = first[0] + ks * half2[0]
        t_th_k = first[1] + ks * half2[1]
        phi_th_k = first[2] + ks * half2[2]

        has_turn, r4 = radial_turning(lam, eta_s, params, r_o)
        anchor_in = torch.where(has_turn, r4, r_hor + 0.0 * r4)
        r_low = torch.where(has_turn, r4, r_hor * r_min_margin + 0.0 * r4)
        leg_in_full = _leg_r(r_low, r_o, anchor_in, lam, eta_s, params,
                             nodes)
        tau_turn = leg_in_full[0]
        tau_max = torch.where(has_turn, 2.0 * tau_turn, tau_turn)

        def at_tau(tau):
            on_in = tau <= tau_turn
            r_in = _invert_r_leg(tau, r_low, r_o, anchor_in, lam, eta_s,
                                 params, True, nodes)
            r_out = _invert_r_leg(tau - tau_turn, r4, r_o, r4, lam, eta_s,
                                  params, False, nodes)
            r_here = torch.where(on_in, r_in, r_out)
            in_part = _leg_r(r_in, r_o, anchor_in, lam, eta_s, params, nodes)
            out_part = _leg_r(r4, r_out, r4, lam, eta_s, params, nodes)
            t_r = torch.where(on_in, in_part[1],
                              leg_in_full[1] + out_part[1])
            p_r = torch.where(on_in, in_part[2],
                              leg_in_full[2] + out_part[2])
            return r_here, t_r, p_r

        r_k, t_r_k, phi_r_k = vmap(at_tau)(tau_k)
        valid = (ordinary & ingoing & (tau_k < tau_max)
                 & (r_k > r_hor * r_min_margin))
        return {"tau": tau_k, "r": r_k, "t": t_r_k + t_th_k,
                "phi": phi_r_k + phi_th_k, "valid": valid, "lam": lam,
                "eta": eta, "e_sign": e_sign,
                "captured": ordinary & ~has_turn}

    return _chunked(one_ray, (q0s.to(F64), p0s.to(F64)))


def _invert_theta_phase(u, th_minus, lam, eta, params, nodes, iters=50):
    """theta in [th_minus, pi/2] whose Mino phase from the turning point
    is u: `iters` bisections (on detached values) and a Newton polish
    clipped to the domain."""
    th_m, lam_d, eta_d, u_d = (x.detach() for x in (th_minus, lam, eta, u))
    lo, hi = th_m, torch.full_like(th_m, _HALF_PI)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        val = _leg_theta(th_m, mid, th_m, lam_d, eta_d, params, nodes)[0]
        too_far = val > u_d
        lo, hi = torch.where(too_far, lo, mid), torch.where(too_far, mid, hi)
    th_d = 0.5 * (lo + hi)
    res = _leg_theta(th_minus, th_d, th_minus, lam, eta, params, nodes)[0] - u
    theta_pot = torch.clamp(eta - w_polar(th_d, lam, params), min=1e-30)
    return torch.minimum(torch.maximum(th_d - res * torch.sqrt(theta_pot),
                                       th_minus),
                         torch.full_like(th_d, _HALF_PI))


def escape_state_one(q0, p0, rb, params, nodes):
    """escape_state for one ray (q0, p0 (4,), rb 0-dim): a dict of 0-dim
    tensors (theta, phi, t, tau, escaped, e_sign, lam, eta)."""
    lam, eta, th_o, s_th, s_r, r_o, e_sign = conserved_from_ks(q0, p0,
                                                               params)
    a = params[1]
    eta = torch.where(torch.abs(eta) <= 1e-12 * (1.0 + lam * lam + a * a),
                      torch.zeros_like(eta), eta)
    ordinary = eta > 0.0
    equatorial = eta == 0.0
    one = torch.ones_like(eta)
    eta_s = torch.where(ordinary, eta, one)
    eta_r = torch.where(eta >= 0.0, eta, one)
    th_minus = _theta_turning(lam, eta_s, params)

    has_turn, r4 = radial_turning(lam, eta_r, params, r_o)
    leg_in = _leg_r(r4, r_o, r4, lam, eta_r, params, nodes)
    leg_out = _leg_r(r4, rb, r4, lam, eta_r, params, nodes)
    tau_esc = leg_in[0] + leg_out[0]
    t_r = leg_in[1] + leg_out[1]
    phi_r = leg_in[2] + leg_out[2]

    half_pi = torch.full_like(th_minus, _HALF_PI)
    half = _leg_theta(th_minus, half_pi, th_minus, lam, eta_s, params, nodes)
    g_half = 2.0 * half[0]
    below = th_o > _HALF_PI
    th_fold = torch.where(below, math.pi - th_o, th_o)
    th_fold = torch.minimum(torch.maximum(th_fold, th_minus), half_pi)
    seg = _leg_theta(th_minus, th_fold, th_minus, lam, eta_s, params, nodes)
    x0 = torch.where(below, g_half - seg[0], seg[0])
    y0 = torch.where(s_th > 0.0, x0, 2.0 * g_half - x0)
    y1 = y0 + tau_esc
    full = (2.0 * half[0], 2.0 * half[1], 2.0 * half[2])

    def q_acc(y):
        k = torch.floor(y / g_half)
        u = y - k * g_half
        asc = torch.remainder(k, 2.0) == 0.0
        x = torch.where(asc, u, g_half - u)
        lower = x > 0.5 * g_half
        x_up = torch.where(lower, g_half - x, x)
        th_up = _invert_theta_phase(x_up, th_minus, lam, eta_s, params,
                                    nodes)
        th_true = torch.where(lower, math.pi - th_up, th_up)
        part = _leg_theta(th_minus, th_up, th_minus, lam, eta_s, params,
                          nodes)
        p_x = tuple(torch.where(lower, f - p, p) for f, p in zip(full, part))
        vals = tuple(k * f + torch.where(asc, px, f - px)
                     for f, px in zip(full, p_x))
        return vals, th_true, k

    (_, t1, p1), th_esc, k1 = q_acc(y1)
    (_, t0_, p0_), _, k0 = q_acc(y0)
    pole_flips = torch.where((lam == 0.0) & ~equatorial, k1 - k0,
                             torch.zeros_like(k1))
    return {
        "theta": torch.where(equatorial, half_pi, th_esc),
        "phi": (phi_r + torch.where(equatorial, torch.zeros_like(p1),
                                    p1 - p0_) + math.pi * pole_flips),
        "t": t_r + torch.where(equatorial, torch.zeros_like(t1), t1 - t0_),
        "tau": tau_esc,
        "escaped": (ordinary | equatorial) & has_turn & (s_r < 0.0),
        "e_sign": e_sign,
        "lam": lam,
        "eta": eta,
    }


def escape_state(q0s, p0s, params, r_bound):
    """Exact boundary-sphere escape records of (N, 4) Kerr-Schild camera
    rays at the Boyer-Lindquist sphere r = r_bound (a number or (N,)):
    per-ray theta, phi and t (the gains from the camera, e_sign as in
    crossing_table), tau, escaped (False: captured, the analytic shadow),
    e_sign, lam, eta.  The polar motion is a triangle wave in Mino phase,
    accumulated as whole half-sweeps and a partial leg."""
    params = torch.as_tensor(params, dtype=F64, device=q0s.device)
    q0s, p0s = q0s.to(F64), p0s.to(F64)
    rb = torch.as_tensor(r_bound, dtype=F64, device=q0s.device)
    rb = torch.broadcast_to(rb, q0s.shape[:1]).contiguous()
    nodes = _nodes(q0s.device)
    return _chunked(lambda q0, p0, r: escape_state_one(q0, p0, r, params,
                                                       nodes),
                    (q0s, p0s, rb))
