"""Photon-shell critical parameters: Lyapunov exponent, delay, winding — the
torch counterpart of `grtrace.physics.photon_shell`.

The photon ring of every subring render (engine/subring.py) is the image of
the photon shell: the bound spherical photon orbits r = r~ that
near-critical rays shadow for a few polar periods before escaping.  Three
numbers per shell orbit set its observable structure (Gralla, Holz & Wald
2019; Johnson et al. 2020): the Lyapunov exponent gamma per polar
half-orbit (consecutive image orders are demagnified by e^{-gamma}), the
coordinate-time lapse delta_t per half-orbit (the delay between
consecutive subrings) and the azimuthal winding delta_phi.

As in the JAX module nothing restates a textbook formula: the Kerr-Newman
null condition multiplied by Sigma = 1/g^{thth} splits into the Mino-time
potentials R(r) = -Delta(r) (K + W_r(r)) and Theta(th) = K - W_th(th), with
W(r, th) = Sigma (g^{tt} - 2 g^{tphi} xi + g^{phiphi} xi^2) evaluated from
the same `kerr_g_inv` the disk shading reads (E = 1, xi = L_z/E).
Criticality R = R' = 0 reduces to dW_r/dr(r~, xi) = 0, a quadratic in xi
whose coefficients come from three derivative evaluations; gamma, delta_t
and delta_phi follow from a second derivative and a turning-point-
regularized 64-node Gauss-Legendre quadrature.

Torch idiom: `jax.grad` is `torch.func.grad` (nested for R''), `jax.vmap`
is `torch.func.vmap`, each `lax.fori_loop` bisection a fixed-count Python
loop of `torch.where` selects, `lax.stop_gradient` a `.detach()`.  The
module works in float64 (the JAX CLI runs it under scoped x64): params and
radii are taken as float64 tensors, whatever they are given as.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .spacetime import _charge, kerr_g_inv

F64 = torch.float64
_HALF_PI = 0.5 * math.pi

# Gauss-Legendre nodes/weights for the polar quadrature, computed once on
# the host in float64; 64 nodes resolve the smooth substituted integrand
# to ~1e-12
_GL_X_NP, _GL_W_NP = np.polynomial.legendre.leggauss(64)
_GL_X = torch.tensor(_GL_X_NP, dtype=F64)
_GL_W = torch.tensor(_GL_W_NP, dtype=F64)
_XI_PROBES = torch.tensor([0.0, 1.0, -1.0], dtype=F64)


def _f64(x):
    """A number, sequence or tensor as a float64 tensor."""
    return torch.as_tensor(x, dtype=F64)


def _g_at(r, th, params):
    """kerr_g_inv at the Boyer-Lindquist points (0, r, th, 0), broadcast
    over r and th: (..., 4, 4)."""
    zero = torch.zeros_like(r + th)
    return kerr_g_inv(torch.stack([zero, r + zero, th + zero, zero], dim=-1),
                      params)


def w_quad(r, th, xi, params):
    """Sigma g^{ab} p_a p_b restricted to the Killing covector
    p = -dt + xi dphi (E = 1), with Sigma = 1/g^{thth} from the metric."""
    g = _g_at(r, th, params)
    sigma = 1.0 / g[..., 2, 2]
    return sigma * (g[..., 0, 0] - 2.0 * g[..., 0, 3] * xi
                    + g[..., 3, 3] * xi * xi)


def w_radial(r, xi, params):
    """The radial separated potential W_r(r) (gauge W_th(pi/2) = 0)."""
    return w_quad(r, _HALF_PI, xi, params)


def w_polar(th, xi, params, r_ref=10.0):
    """The polar separated potential W_th(th); r_ref is arbitrary by
    separability."""
    r = torch.as_tensor(r_ref, dtype=F64)
    return w_quad(r, th, xi, params) - w_quad(r, _HALF_PI, xi, params)


def _delta(r, params):
    """Delta(r) = Sigma g^{rr}, from the metric."""
    g = _g_at(r, _HALF_PI, params)
    return g[..., 1, 1] / g[..., 2, 2]


def critical_orbit(r_tilde, params):
    """(xi, K) of the bound spherical photon orbit at BL radius r~ (a 0-dim
    tensor).

    dW_r/dr(r~, xi) = 0 is exactly quadratic in xi, so three derivative
    evaluations at xi = -1, 0, +1 give its coefficients; of the two roots
    the physical one has the larger K = -W_r (JAX's argmax of two values,
    the first on ties or NaN).  At a = 0 every xi is critical at r~ = 3M;
    the coefficients vanish and the polar orbit xi = 0 is returned."""
    params = _f64(params)
    # the three derivatives, at xi = 0, +1, -1, as one batched evaluation
    dwr = torch.func.vmap(torch.func.grad(w_radial, argnums=0),
                          in_dims=(None, 0, None))
    f0, fp, fm = dwr(r_tilde, _XI_PROBES, params)
    c1 = 0.5 * (fp - fm)
    c2 = 0.5 * (fp + fm) - f0
    disc = torch.sqrt(torch.clamp(c1 * c1 - 4.0 * c2 * f0, min=0.0))
    degenerate = torch.abs(c2) < 1e-12
    c2s = torch.where(degenerate, 1.0, c2)
    root_a = (-c1 + disc) / (2.0 * c2s)
    root_b = (-c1 - disc) / (2.0 * c2s)
    k_a = -w_radial(r_tilde, root_a, params)
    k_b = -w_radial(r_tilde, root_b, params)
    first = (k_a >= k_b) | torch.isnan(k_a)
    xi = torch.where(degenerate, 0.0, torch.where(first, root_a, root_b))
    return xi, -w_radial(r_tilde, xi, params)


def _theta_turning(xi, k_const, params, iters=60):
    """Upper-hemisphere polar turning point theta_- in (0, pi/2]: the root
    of Theta(th) = K - W_th(th), bisected, then one Newton step from the
    detached root (it carries the implicit-function gradient the select
    chain cannot); ~0 for the circulating polar orbit xi = 0."""
    def f(th):
        return k_const - w_polar(th, xi, params)

    lo = torch.full_like(xi, 1e-9)
    hi = torch.full_like(xi, _HALF_PI)
    exists = f(lo) < 0.0   # a forbidden polar cap to turn around in
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = f(mid) < 0.0   # inside the forbidden polar cap
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    th_d = (0.5 * (lo + hi)).detach()
    fd = f(th_d)
    fp = torch.func.grad(f)(th_d)
    denom = torch.where(exists & (torch.abs(fp) > 1e-300), fp, 1.0)
    # clipped to the domain, not to the collapsed bracket (see JAX)
    polished = torch.clamp(th_d - fd / denom, 1e-9, _HALF_PI)
    return torch.where(exists, polished, th_d)


def critical_parameters(r_tilde, params):
    """(gamma, delta_t, delta_phi, xi, K) at shell radius r~ (a 0-dim
    float64 tensor): Lyapunov exponent, coordinate-time lapse and azimuthal
    winding per polar half-orbit of the bound photon orbit.

    The integrals run over one polar libration, substituted
    th = pi/2 + A sin(pi u / 2) so that the 1/sqrt(Theta) turning points
    cancel against the Jacobian; polar orbits circulate and the same
    formula covers them."""
    params = _f64(params)
    r_tilde = _f64(r_tilde)
    xi, k_const = critical_orbit(r_tilde, params)

    # radial instability rate from R'' at the double root
    def rad(rr):
        return -_delta(rr, params) * (k_const + w_radial(rr, xi, params))

    d2r = torch.func.grad(torch.func.grad(rad))(r_tilde)
    lam = torch.sqrt(torch.clamp(0.5 * d2r, min=0.0))

    th_min = _theta_turning(xi, k_const, params)
    amp = _HALF_PI - th_min
    th = _HALF_PI + amp * torch.sin(_HALF_PI * _GL_X)

    # Theta = (amp^2 - (th - pi/2)^2) h(th) with h smooth > 0, so
    # dth / sqrt(Theta) = (pi/2) du / sqrt(h); evaluated on all nodes at
    # once (JAX maps the same elementwise integrand over them)
    theta_pot = k_const - w_polar(th, xi, params)
    dev = th - _HALF_PI
    quad = torch.clamp(amp * amp - dev * dev, min=1e-300)
    h = torch.clamp(theta_pot / quad, min=1e-300)
    base = 1.0 / torch.sqrt(h)
    g = _g_at(r_tilde, th, params)
    sigma = 1.0 / g[..., 2, 2]
    p_t_up = -g[..., 0, 0] + g[..., 0, 3] * xi       # p^t for p_t = -1
    p_phi_up = -g[..., 0, 3] + g[..., 3, 3] * xi     # p^phi

    t_half = _HALF_PI * torch.sum(_GL_W * base)
    delta_t = _HALF_PI * torch.sum(_GL_W * (base * sigma * p_t_up))
    delta_phi = _HALF_PI * torch.sum(_GL_W * (base * sigma * p_phi_up))
    return lam * t_half, delta_t, delta_phi, xi, k_const


def _bisect(pred, lo, hi, iters=60):
    """Bisection of the bracket [lo, hi] whose hi end satisfies pred and
    whose lo end does not: the JAX module's fori_loops of selects.  lo and
    hi may hold several independent brackets, which pred then takes as a
    batch."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        p = pred(mid)
        lo, hi = torch.where(p, lo, mid), torch.where(p, mid, hi)
    return 0.5 * (lo + hi)


def polar_shell_radius(params, iters=60):
    """The shell radius of the POLAR (L_z = 0) orbit, the one on-axis
    observers' critical rays shadow: xi_c(r~) falls monotonically from the
    prograde (+) to the retrograde (-) edge; bisect its zero."""
    params = _f64(params)
    r_min, r_max = shell_radius_range(params)
    return _bisect(lambda r: ~(critical_orbit(r, params)[0] > 0.0),
                   r_min + 1e-9, r_max - 1e-9, iters)


def theta_potential(th, xi, k_const, params):
    """The polar potential Theta(th) = K - W_th(th): the orbit reaches
    latitude th iff Theta(th) >= 0."""
    return k_const - w_polar(_f64(th), xi, _f64(params))


def _spherical_photon_radius(params, iters=60):
    """a = 0 photon-sphere radius: the root of dW_r/dr(r, xi=0) = 0 in
    (r_horizon, 5M], from the metric (closed form
    (3M + sqrt(9M^2 - 8Q^2))/2)."""
    params = _f64(params)
    mass = params[0]
    dwr = torch.func.grad(w_radial, argnums=0)

    def f(r):
        return dwr(r, torch.zeros_like(r), params)

    qc = _charge(params)
    lo = mass * (1.0 + torch.sqrt(torch.clamp(1.0 - qc * qc / (mass * mass),
                                              min=0.0))) + 1e-6
    hi = 5.0 * mass
    sign_hi = f(hi) > 0.0
    return _bisect(lambda r: (f(r) > 0.0) == sign_hi, lo, hi, iters)


def shell_visible_range(params, theta_obs, iters=60):
    """(r_lo, r_hi): the sub-range of the photon shell whose orbits reach
    the observer latitude theta_obs, i.e. the shell radii on the critical
    curve of a theta_obs-inclined image: Theta(theta_obs; xi(r~), K(r~)) = 0
    bisected from the polar orbit, which every latitude sees."""
    params = _f64(params)
    theta_obs = _f64(theta_obs)
    r_min, r_max = shell_radius_range(params)
    r_polar = polar_shell_radius(params)

    def vis(r):
        xi, k_const = critical_orbit(r, params)
        return theta_potential(theta_obs, xi, k_const, params) > 0.0

    # both edges at once: (invisible end, visible end) brackets
    pad = 1e-9
    edges = _bisect(torch.func.vmap(vis), torch.stack([r_min + pad,
                                                       r_max - pad]),
                    torch.stack([r_polar, r_polar]), iters)
    return edges[0], edges[1]


def critical_curve_observables(params, theta_obs, n=64):
    """The critical curve seen from latitude theta_obs, with the GHW triple
    at every point: a dict of (n,) float64 tensors r, alpha, beta, gamma,
    delta_t, delta_phi, xi, eta (alpha = -xi / sin(theta_obs), beta =
    +sqrt(Theta(theta_obs)), the observer-at-infinity screen).

    a = 0 is spherically symmetric: the curve is returned as the circle of
    the one photon-sphere radius, parametrized by screen angle, with a
    constant triple."""
    params = _f64(params)
    theta_obs = _f64(theta_obs)
    if abs(float(params[1])) < 1e-8:
        r_ph = _spherical_photon_radius(params)
        gam, dt, dphi, xi, eta = critical_parameters(r_ph, params)
        b_c = torch.sqrt(eta)
        psi = torch.linspace(0.0, math.pi, n, dtype=F64)
        ones = torch.ones((n,), dtype=F64)
        return {"r": r_ph * ones, "alpha": b_c * torch.cos(psi),
                "beta": b_c * torch.sin(psi), "gamma": gam * ones,
                "delta_t": dt * ones, "delta_phi": dphi * ones,
                "xi": xi * ones, "eta": eta * ones}

    r_lo, r_hi = shell_visible_range(params, theta_obs)
    # inset so Theta >= 0 holds strictly at the sample points
    eps = 1e-9 + 1e-6 * (r_hi - r_lo)
    rs = torch.linspace(float(r_lo + eps), float(r_hi - eps), n, dtype=F64)
    gam, dt, dphi, xi, eta = torch.func.vmap(
        lambda r: critical_parameters(r, params))(rs)
    theta_pot = theta_potential(theta_obs, xi, eta, params)
    return {"r": rs, "alpha": -xi / torch.sin(theta_obs),
            "beta": torch.sqrt(torch.clamp(theta_pot, min=0.0)),
            "gamma": gam, "delta_t": dt, "delta_phi": dphi, "xi": xi,
            "eta": eta}


def shell_radius_range(params, prograde_pad=1e-6, n_scan=512, iters=60):
    """(r_min, r_max): the radial extent of the photon shell, where the
    critical orbit's Carter constant K crosses zero (the equatorial
    prograde / retrograde circular photon orbits): bisection from a
    bracketing scan."""
    params = _f64(params)
    mass = params[0]

    k_pos = torch.func.vmap(lambda r: critical_orbit(r, params)[1] > 0.0)
    grid = torch.linspace(float(1.0 * mass + prograde_pad),
                          float(4.5 * mass), n_scan, dtype=F64)
    pos = k_pos(grid).to(torch.int8)
    # the innermost positive-K run, bisected against its two neighbours
    # (both edges at once: K > 0 at the hi end of the inner bracket, K <= 0
    # at the hi end of the outer one)
    first = int(torch.argmax(pos))
    last = n_scan - 1 - int(torch.argmax(pos.flip(0)))
    want = torch.tensor([True, False])
    edges = _bisect(lambda r: k_pos(r) == want,
                    grid[[max(first - 1, 0), last]],
                    grid[[first, min(last + 1, n_scan - 1)]], iters)
    return edges[0], edges[1]
