"""Differentiable observables: exact parameter sensitivities through the
full geodesic integrator, and Fisher forecasts for (spin, inclination) —
the torch counterpart of `grtrace.engine.sensitivity`.

The chain

    camera -> the 16-row disk loop (B6) -> crossing capture ->
    Killing-constant redshift -> emissivity weights -> smooth binning

differentiates end to end in forward mode (torch.autograd.forward_ad).
Everything around the loop is plain torch under forward AD; the loop enters
it as one op, `_DiskLoop`, whose forward is the 16-row disk dispatcher
(kernel B6's 16-row layout on CUDA, its twin on the CPU) and whose jvp is
`integrate_dispatch_disk_tangent` with one direction (kernel B6t on CUDA,
its explicit-tangent twin on the CPU): the eager loop never runs under AD
on CUDA rays.  Like JAX's `line_profile_model`, which differentiates the
uncompensated XLA loop, the model runs the 16-row layout in float32 and
float64 alike.

`line_profile_jacobian` is JAX's `jax.linearize` + one tangent sweep per
parameter, with the loop run once for all of them (`_linearize`): the
camera's tangents in every direction, then one tangent dispatch that
returns the loop's primal outputs and each direction's crossing tangents
(one B6t launch with two directions on CUDA rays, no B6 launch); the
primal pass and each forward-mode pass read their outputs, and the
camera's rays, from it.

The two differentiability caveats of the JAX module hold: hard histograms
have zero derivative almost everywhere, so the profile bins smoothly
(`smooth_line_profile`, `soft_bin_profile`), and ray classification flips
are discrete, so the derivative is exact between flips.  The guard, the
capture test and the annulus test carry no tangent, nor does the ISCO inner
edge, which enters only the annulus test.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..physics.camera import cartesian_ics_from_pixels, pixel_grid_lookat
from ..physics.orbits import isco_radius, redshift_factor
from ..physics.spacetime import kerr_schild_g_inv, ks_radius
from .integrate_ks import (STATUS_DISK, integrate_dispatch_disk,
                           integrate_dispatch_disk_tangent)


def smooth_line_profile(g, w, centers, sigma):
    """Gaussian-kernel line profile sum_i w_i N(c - g_i; sigma): the
    differentiable replacement for the hard histogram."""
    k = torch.exp(-0.5 * ((centers[:, None] - g[None, :]) / sigma) ** 2)
    return (k * w[None, :]).sum(dim=1) / (sigma * math.sqrt(2.0 * math.pi))


def soft_bin_profile(g, w, centers, softness):
    """Differentiable histogram: each ray's weight lands in bin b with the
    erf-smoothed indicator of |c_b - g| < dg/2 (exact hard binning as
    softness -> 0), so a fit can compare against hard-binned data bin for
    bin."""
    dg = centers[1] - centers[0]
    s = softness * math.sqrt(2.0)
    d = centers[:, None] - g[None, :]
    k = 0.5 * (torch.special.erf((d + dg / 2) / s)
               - torch.special.erf((d - dg / 2) / s))
    return (k * w[None, :]).sum(dim=1)


class _Linearization:
    """One linearization's disk loop, run once for every direction of
    theta: `run` forms the camera's forward-mode tangents along each unit
    direction, then makes one tangent dispatch with all of them (kernel
    B6t with K = theta.numel() directions on CUDA rays), which returns the
    loop's primal outputs, bitwise B6's, and each direction's crossing
    tangents, bitwise a one-direction launch's.  `_DiskLoop` hands them
    out without a launch: the primal to every pass, direction `direction`'s
    tangents to the forward-mode pass along it.  The loop reads no tangent
    of its rays then, so every pass takes the camera's rays from `run`
    and forms no camera of its own."""

    def __init__(self):
        self.rays = None        # the camera's (q0, p0)
        self.primal = None      # (status, hit_q, hit_p)
        self.tangents = None    # (hit_q_d, hit_p_d), each (K, N, 4)
        self.direction = None   # the forward-mode pass's direction

    def run(self, theta, camera, cfg):
        """camera(theta) -> (q0, p0, params); cfg as `_DiskLoop`'s."""
        dirs = []
        for k in range(theta.numel()):
            e = torch.zeros_like(theta)
            e[k] = 1.0
            with fwAD.dual_level():
                duals = camera(fwAD.make_dual(theta, e))
                (q0, dq0), (p0, dp0), (params, dpar) = (
                    fwAD.unpack_dual(t)[:2] for t in duals)
            dirs.append(tuple(torch.zeros_like(x) if d is None else d
                              for x, d in ((q0, dq0), (p0, dp0),
                                           (params, dpar))))
        dq0, dp0, dpar = (torch.stack(t) for t in zip(*dirs))
        self.rays = (q0, p0)
        steps, delta, r_max, omega, r_in, r_out, order = cfg
        out = integrate_dispatch_disk_tangent(
            q0, p0, dq0, dp0, steps, delta, tuple(params.tolist()),
            dpar.tolist(), r_max, omega, r_in, r_out, order=order)
        self.primal = (out[2], out[4], out[5])
        self.tangents = (out[6], out[7])


class _DiskLoop(torch.autograd.Function):
    """The 16-row disk integration as one forward-differentiable op:
    (q0, p0, params) -> (status, hit_q, hit_p).  forward runs the 16-row
    disk dispatcher, or, under a `_Linearization` `lin`, returns its
    primal outputs without a launch; jvp runs the tangent dispatcher with
    one direction (one B6t launch), or returns lin's tangents along its
    current direction.  cfg = (steps, delta, r_max, omega, r_in, r_out,
    order)."""

    @staticmethod
    def forward(ctx, q0, p0, params, cfg, lin):
        ctx.save_for_forward(q0, p0, params)
        ctx.cfg, ctx.lin = cfg, lin
        if lin is not None:
            status, hit_q, hit_p = (t.clone() for t in lin.primal)
        else:
            steps, delta, r_max, omega, r_in, r_out, order = cfg
            _, _, status, _, hit_q, hit_p = integrate_dispatch_disk(
                q0, p0, steps, delta, tuple(params.tolist()), r_max, omega,
                r_in, r_out, order=order, plain=True)
        ctx.mark_non_differentiable(status)
        return status, hit_q, hit_p

    @staticmethod
    def jvp(ctx, dq0, dp0, dparams, _cfg, _lin):
        if ctx.lin is not None:
            k = ctx.lin.direction
            return None, *(t[k].clone() for t in ctx.lin.tangents)
        q0, p0, params = ctx.saved_tensors
        steps, delta, r_max, omega, r_in, r_out, order = ctx.cfg
        dq0 = torch.zeros_like(q0) if dq0 is None else dq0
        dp0 = torch.zeros_like(p0) if dp0 is None else dp0
        dparams = (torch.zeros_like(params) if dparams is None
                   else dparams)
        out = integrate_dispatch_disk_tangent(
            q0, p0, dq0[None].contiguous(), dp0[None].contiguous(), steps,
            delta, tuple(params.tolist()), [dparams.tolist()], r_max, omega,
            r_in, r_out, order=order)
        return None, out[6][0], out[7][0]


def _hole_and_observer(theta, mass, charge, obs_distance):
    """`disk_camera`'s params [mass, spin, charge] and observer position."""
    dtype, device = theta.dtype, theta.device
    spin, elev = theta[0], theta[1]

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    params = torch.stack([scalar(mass), spin, scalar(charge)])
    obs = torch.stack([obs_distance * torch.cos(elev),
                       torch.zeros_like(elev),
                       obs_distance * torch.sin(elev)])
    return params, obs


def disk_camera(theta, size, fov=1.396263, mass=1.0, charge=0.0,
                obs_distance=30.0):
    """The model's size x size look-at camera for theta = [spin,
    elevation_rad] (a dual theta carries its tangent through): (q0, p0)
    (size^2, 4), params [mass, spin, charge] and the observer position,
    in theta's dtype and device."""
    dtype, device = theta.dtype, theta.device
    params, obs = _hole_and_observer(theta, mass, charge, obs_distance)
    pix = pixel_grid_lookat(obs, torch.tensor(float(fov), dtype=dtype,
                                              device=device),
                            size, size, dtype=dtype, device=device)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix.reshape(-1, 3),
                                          params=params,
                                          g_inv_fn=kerr_schild_g_inv)
    return q0.contiguous(), p0.contiguous(), params, obs


def _profile(theta, centers, lin=None, *, size=48, steps=4000, delta=0.1,
             omega=1.0, order=2, r_out=14.0, obs_distance=30.0,
             fov=1.396263, mass=1.0, charge=0.0, boundary_radius=31.0,
             prograde=True, emissivity_index=3.0, sigma=None,
             normalize=True, binning="kde"):
    """`line_profile_model` on a theta tensor (dual or not); under a
    `_Linearization` `lin` the loop's outputs come from its one tangent
    dispatch, which the first pass makes."""
    dtype, device = theta.dtype, theta.device
    spin = theta[0]
    if isinstance(centers, torch.Tensor):
        centers = centers.to(dtype=dtype, device=device)
    else:
        centers = torch.as_tensor(np.asarray(centers, np.float64),
                                  dtype=dtype, device=device)
    if sigma is None:
        sigma = centers[1] - centers[0]

    spin_p = float(fwAD.unpack_dual(spin).primal)
    r_in = float(isco_radius(float(mass), spin_p, prograde))
    cfg = (int(steps), float(delta), float(boundary_radius), float(omega),
           r_in, float(r_out), int(order))
    if lin is None:
        q0, p0, params, obs = disk_camera(theta, size, fov, mass, charge,
                                          obs_distance)
    else:
        if lin.primal is None:
            lin.run(theta, lambda t: disk_camera(t, size, fov, mass, charge,
                                                 obs_distance)[:3], cfg)
        q0, p0 = lin.rays
        params, obs = _hole_and_observer(theta, mass, charge, obs_distance)
    status, hit_q, hit_p = _DiskLoop.apply(q0, p0, params, cfg, lin)

    x, y = hit_q[:, 1], hit_q[:, 2]
    energy = -hit_p[:, 0]
    l_z = x * hit_p[:, 2] - y * hit_p[:, 1]
    r_em = ks_radius(hit_q[:, 1], hit_q[:, 2], hit_q[:, 3], spin)
    r_obs_bl = ks_radius(obs[0], obs[1], obs[2], spin)
    th_obs = torch.arccos(torch.clamp(
        obs[2] / torch.clamp(r_obs_bl, min=1e-30), -1.0, 1.0))
    g = redshift_factor(energy, l_z, r_em, r_obs_bl, params, prograde,
                        th_obs)

    hit = status == STATUS_DISK
    w = torch.where(hit, g ** 4 * torch.clamp(r_em, min=1e-30)
                    ** (-emissivity_index), torch.zeros_like(g))
    g_safe = torch.where(hit, g, centers[0].expand_as(g))
    if binning == "soft":
        prof = soft_bin_profile(g_safe, w, centers, sigma)
    else:
        prof = smooth_line_profile(g_safe, w, centers, sigma)
    if normalize:
        prof = prof / torch.clamp(prof.sum(), min=1e-30)
    return prof


def _theta(theta, device):
    """theta as a 1-D float tensor on `device` (numbers as float64)."""
    if isinstance(theta, torch.Tensor):
        return theta.to(device)
    return torch.as_tensor(np.asarray(theta, np.float64), device=device)


def line_profile_model(theta, centers, *, size=48, steps=4000, delta=0.1,
                       omega=1.0, order=2, r_out=14.0, obs_distance=30.0,
                       fov=1.396263, mass=1.0, charge=0.0,
                       boundary_radius=31.0, prograde=True,
                       emissivity_index=3.0, sigma=None, normalize=True,
                       binning="kde", device="cuda"):
    """theta = [spin, elevation_rad] -> smooth iron-line profile on the
    given g-bin centers, in theta's dtype (numbers: float64) on `device`.
    Same physics as the line-profile sweep (sharding/grid.
    line_profile_grid_sharded): disk annulus [ISCO(spin), r_out],
    Killing-constant redshift, weight g^4 r^-q, binned smoothly so that
    forward AD of it (`line_profile_jacobian`) is the exact profile
    sensitivity.  A dual theta (torch.autograd.forward_ad) carries its
    tangent through."""
    return _profile(
        _theta(theta, device), centers, size=size, steps=steps, delta=delta,
        omega=omega, order=order, r_out=r_out, obs_distance=obs_distance,
        fov=fov, mass=mass, charge=charge, boundary_radius=boundary_radius,
        prograde=prograde, emissivity_index=emissivity_index, sigma=sigma,
        normalize=normalize, binning=binning)


def _linearize(fn, theta):
    """(fn(theta), J) for fn(theta, lin) -> out (JAX's jax.linearize +
    one tangent sweep a column): one primal pass, which runs the loop once
    for every direction (`_Linearization`), then one forward-mode pass per
    parameter that reads its loop outputs from that run."""
    lin = _Linearization()
    out = fn(theta, lin)
    cols = []
    for k in range(theta.numel()):
        e = torch.zeros_like(theta)
        e[k] = 1.0
        lin.direction = k
        with fwAD.dual_level():
            tangent = fwAD.unpack_dual(fn(fwAD.make_dual(theta, e),
                                          lin)).tangent
        cols.append(torch.zeros_like(out) if tangent is None else tangent)
    return out, torch.stack(cols, dim=1)


def line_profile_jacobian(theta, centers, *, device="cuda", **knobs):
    """(profile, J) with J[b, k] = d profile[b] / d theta[k], as numpy
    float arrays: one linearization, a single tangent dispatch with both
    directions (B6t once, B6 never)."""
    prof, jac = _linearize(
        lambda t, lin: _profile(t, centers, lin, **knobs),
        _theta(theta, device))
    return prof.cpu().numpy(), jac.cpu().numpy()


def gauss_newton_fit(theta0, obs_flux, centers, *, n_iter=4, damping=1e-3,
                     spin_max=0.999, smooth_width=5.0, device="cuda",
                     **knobs):
    """Gauss-Newton refinement of (spin, elevation) against an observed
    line profile, using the exact forward-mode Jacobian: JAX's local
    sub-grid refiner, with its three measured design choices — the model
    soft-bins its rays (`soft_bin_profile`, softness 0.4 bin widths unless
    `sigma` is given) so that model and data live in the same space; both
    pass through one shared Gaussian smoothing matrix (smooth_width bin
    widths) before area normalization; a backtracking line search halves
    any step that increases the residual.  Start it within about one grid
    cell of the optimum.

    Returns (theta, history) with history = per-iteration [spin,
    elevation, residual_norm_before_step].  Each iteration costs one
    linearization (B6t once) and one to six primal passes (B6 once
    each)."""
    centers = np.asarray(centers, np.float64)
    dg = float(centers[1] - centers[0])
    softness = knobs.pop("sigma", None) or 0.4 * dg
    smooth = np.exp(-0.5 * ((centers[:, None] - centers[None, :])
                            / (smooth_width * dg)) ** 2)
    smooth_t = torch.as_tensor(smooth, device=device)

    def fwd(t, lin):
        hist = _profile(t, centers, lin, binning="soft", sigma=softness,
                        normalize=False, **knobs)
        sm = smooth_t.to(hist.dtype) @ hist
        return sm / torch.clamp(sm.sum(), min=1e-30)

    def clipped(t):
        return np.array([float(np.clip(t[0], -spin_max, spin_max)),
                         float(np.clip(t[1], 1e-3, np.pi / 2 - 1e-3))])

    obs_s = smooth @ np.asarray(obs_flux, np.float64)
    obs_s = obs_s / max(obs_s.sum(), 1e-30)

    theta = clipped(np.asarray(theta0, np.float64))
    history = []
    for _ in range(n_iter):
        prof, jac = _linearize(fwd, _theta(theta, device))
        jac = jac.cpu().numpy().astype(np.float64)
        r = obs_s - prof.cpu().numpy()
        rn = float(np.linalg.norm(r))
        jtj = jac.T @ jac
        step = np.linalg.solve(jtj + damping * np.diag(np.diag(jtj)),
                               jac.T @ r)
        cand = clipped(theta + step)
        improved = False
        for _bt in range(6):   # backtracking line search
            model = fwd(_theta(cand, device), None).cpu().numpy()
            rn_new = float(np.linalg.norm(obs_s - model))
            if rn_new < rn:
                improved = True
                break
            step = 0.5 * step
            cand = clipped(theta + step)
        if not improved:       # at the residual floor: converged
            history.append([theta[0], theta[1], rn])
            break
        theta = cand
        history.append([theta[0], theta[1], rn])
    return theta, history


def fisher_forecast(jac, noise_sigma):
    """Gaussian Fisher analysis of a profile Jacobian: F = J^T J / s^2.

    Returns {"fisher", "covariance", "errors" (1-sigma marginalized),
    "correlation"} — the exact local error geometry of the fit."""
    jac = np.asarray(jac, np.float64)
    f = jac.T @ jac / float(noise_sigma) ** 2
    cov = np.linalg.inv(f)
    err = np.sqrt(np.diag(cov))
    corr = cov[0, 1] / (err[0] * err[1]) if jac.shape[1] == 2 else None
    return {"fisher": f, "covariance": cov, "errors": err,
            "correlation": corr}
