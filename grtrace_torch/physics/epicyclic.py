"""Epicyclic frequencies and the autodiff ISCO — the torch counterpart of
`grtrace.physics.epicyclic` (the QPO observables).

A circular equatorial geodesic perturbed radially or vertically oscillates
at the radial epicyclic frequency kappa and the vertical one Omega_theta;
with the orbital Omega_phi they are the three frequencies of every
relativistic QPO model.  Both come from second derivatives of the radial
and polar potentials built from `spacetime.kerr_g_inv`, with the circular
orbit's Killing charges (E, L_z) from physics/orbits.py:

    rdot^2     = R(r)      = -g^{rr}(r, pi/2) (1 + W(r, pi/2))
    thetadot^2 = Theta(th) = -g^{thth}(r0, th) (1 + W(r0, th))
    W = g^{tt} E^2 - 2 g^{tphi} E L_z + g^{phiphi} L_z^2

    omega_proper^2 = -(1/2) d^2R/dr^2  (resp. d^2Theta/dth^2),
    coordinate-time frequency = omega_proper / u^t.

JAX takes the second derivatives with `jax.grad(jax.grad(...))`; the port
with `torch.autograd.grad(..., create_graph=True)` twice on float64 host
scalars.  `isco_from_kappa` roots kappa^2(r) = 0 with JAX's grid scan and
bisection rounds: the exact ISCO of the whole Kerr-Newman family (the
Bardeen-Press-Teukolsky radius at Q = 0, 4 M for the extremal
Reissner-Nordstrom hole), which engine/disk.py takes as the inner edge of
a charged hole's disk.  Geometrized units; `qpo_frequencies_hz` converts
to Hz.
"""
from __future__ import annotations

import math

import torch

from .orbits import circular_e_lz, circular_u_t
from .spacetime import _charge, kerr_g_inv

# seconds per geometrized solar mass, GM_sun / c^3
T_SUN_S = 4.925490947e-6


def _params(params):
    """params as a 1-D tensor (float64 unless it is a tensor already)."""
    return params if isinstance(params, torch.Tensor) else torch.as_tensor(
        params, dtype=torch.float64)


def _bl(r, th):
    """The Boyer-Lindquist point (0, r, th, 0)."""
    zero = torch.zeros_like(r)
    return torch.stack([zero, r, th + zero, zero], -1)


def _w_quad(r, th, energy, l_z, params):
    """W = g^{ab} p_a p_b restricted to the Killing directions, for p_t =
    -E, p_phi = L_z."""
    g = kerr_g_inv(_bl(r, th), params)
    return (g[..., 0, 0] * energy * energy
            - 2.0 * g[..., 0, 3] * energy * l_z
            + g[..., 3, 3] * l_z * l_z)


def _second_derivative(fn, x):
    """d^2 fn / dx^2 at each element of x, by reverse mode twice (fn is
    elementwise, so the gradient of its sum is its derivative)."""
    x = x.detach().clone().requires_grad_(True)
    (d1,) = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), x)
    return d2.detach()


def _rad_pot(energy, l_z, params):
    """R(r) = -g^rr (1 + W) on the equator, for the charges (E, L_z)."""
    def rad_pot(rr):
        half_pi = torch.full_like(rr, 0.5 * math.pi)
        g = kerr_g_inv(_bl(rr, half_pi), params)
        return -g[..., 1, 1] * (1.0 + _w_quad(rr, half_pi, energy, l_z,
                                              params))
    return rad_pot


def epicyclic_frequencies(r, params, prograde=True):
    """(Omega_phi, kappa, Omega_theta) at Boyer-Lindquist radius r (a
    number or a 0-d tensor): the coordinate-time angular frequencies of the
    circular equatorial geodesic and of its radial and vertical
    perturbations, as magnitudes; kappa^2 < 0 (inside the ISCO) and
    Omega_theta^2 < 0 clamp to 0 (`radial_stability` keeps the sign)."""
    params = _params(params)
    r = torch.as_tensor(r, dtype=params.dtype)
    energy, l_z = circular_e_lz(r, params, prograde)
    u_t, omega = circular_u_t(r, params, prograde)

    def pol_pot(th):
        g = kerr_g_inv(_bl(r + 0.0 * th, th), params)
        return -g[..., 2, 2] * (1.0 + _w_quad(r, th, energy, l_z, params))

    kappa2 = -0.5 * _second_derivative(_rad_pot(energy, l_z, params),
                                       r) / (u_t * u_t)
    vert2 = -0.5 * _second_derivative(
        pol_pot, torch.full_like(r, 0.5 * math.pi)) / (u_t * u_t)
    kappa = torch.sqrt(torch.clamp(kappa2, min=0.0))
    omega_theta = torch.sqrt(torch.clamp(vert2, min=0.0))
    return torch.abs(omega), kappa, omega_theta


def radial_stability(r, params, prograde=True):
    """kappa^2 (signed, coordinate time): negative inside the ISCO;
    elementwise on a tensor r."""
    params = _params(params)
    r = torch.as_tensor(r, dtype=params.dtype)
    energy, l_z = circular_e_lz(r, params, prograde)
    u_t, _ = circular_u_t(r, params, prograde)
    return -0.5 * _second_derivative(_rad_pot(energy, l_z, params),
                                     r) / (u_t * u_t)


def isco_from_kappa(params, prograde=True, iters=50):
    """The ISCO radius as the root of kappa^2(r) = 0: the topmost sign
    change of kappa^2 on 65 points of [1.02 r_+, 9.5 M] brackets it, then
    `iters` bisection rounds (JAX's grid and rounds; plain Newton diverges
    from a seed beyond kappa^2's maximum).  Returns a 0-d tensor in
    params' dtype.  Not valid within about 2% of the extremal prograde
    limit."""
    params = _params(params)
    mass = params[0]
    qc = _charge(params)

    horizon = mass + torch.sqrt(torch.clamp(
        mass * mass - params[1] * params[1] - qc * qc, min=0.0))
    grid = torch.linspace(float(1.02 * horizon), float(9.5 * mass), 65,
                          dtype=params.dtype)
    neg = torch.nonzero(radial_stability(grid, params, prograde) < 0.0)
    top = min(max(int(neg.max()) if neg.numel() else -1, 0),
              grid.shape[0] - 2)
    lo, hi = grid[top], grid[top + 1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if float(radial_stability(mid, params, prograde)) < 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def qpo_frequencies_hz(r, params, mass_msun, prograde=True):
    """{nu_phi, nu_r, nu_theta, nu_periastron, nu_nodal} in Hz for a hole
    of `mass_msun` solar masses: nu = Omega M_code / (2 pi mass_msun
    T_SUN_S), since Omega scales as 1/M at fixed a/M, Q/M, r/M."""
    params = _params(params)
    omega_phi, kappa, omega_th = epicyclic_frequencies(r, params, prograde)
    scale = params[0] / (2.0 * math.pi * mass_msun * T_SUN_S)
    nu_phi = omega_phi * scale
    nu_r = kappa * scale
    nu_th = omega_th * scale
    return {"nu_phi": nu_phi, "nu_r": nu_r, "nu_theta": nu_th,
            "nu_periastron": nu_phi - nu_r, "nu_nodal": nu_phi - nu_th}
