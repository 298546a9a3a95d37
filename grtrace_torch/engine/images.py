"""Strong-lensing multiple images: where a point source appears — the torch
counterpart of `grtrace.engine.images`.

Given a source direction (theta_s, phi_s) on the celestial sphere,
`find_images` solves the lens equation exit(i, j) = (theta_s, phi_s + 2 pi
k) for fractional camera-plane positions, one root per azimuthal winding
k: a coarse scan of the continuous pixel -> sky map seeds each winding,
damped Newton with the exact Jacobian (`torch.func.jacfwd` through the
semi-analytic escape map of physics/geodesic_exact.py, whose turning
points carry the implicit gradient) polishes it, and the signed
magnification is the solid-angle ratio to the same camera's flat twin
(negative: a mirror-flipped image).

Float64 on the caller's device (`device`, 'cuda' by default); no kernel.
"""
from __future__ import annotations


import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..physics.camera import (cartesian_ics_from_pixels,
                              pixel_positions_fractional)
from ..physics.geodesic_exact import _nodes, escape_state_one
from ..physics.spacetime import METRICS, ks_radius
from .hotspot import bl_time_azimuth_offsets

F64 = torch.float64


def _one_ray_exit(i_f, j_f, params, obs_pos, fov, height, width,
                  boundary_radius, nodes):
    """(theta_flat, phi_flat_unwrapped, escaped, t_arrival) of one
    fractional pixel (0-dim i_f, j_f): the differentiable pixel -> sky
    map, with render_pixels_background_exact's conventions and the
    azimuth not wrapped; t_arrival = |the coordinate-time gain|."""
    pix = pixel_positions_fractional(obs_pos, fov, height, width,
                                     i_f.reshape(1), j_f.reshape(1),
                                     dtype=F64)
    q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    rho = float(boundary_radius)
    rb0 = torch.sqrt(torch.clamp(rho * rho - params[1] ** 2, min=1.0))
    es = escape_state_one(q0[0], p0[0], rb0, params, nodes)
    sin2 = torch.sin(es["theta"]) ** 2
    rb1 = torch.sqrt(rho * rho - params[1] ** 2 * sin2)
    es = escape_state_one(q0[0], p0[0], rb1, params, nodes)
    r_obs_bl = ks_radius(obs_pos[0], obs_pos[1], obs_pos[2], params[1])
    t_b, phi_b = bl_time_azimuth_offsets(rb1, params)
    t_o, phi_o = bl_time_azimuth_offsets(r_obs_bl, params)
    phi = (es["e_sign"] * es["phi"] + phi_b - phi_o
           + torch.atan2(params[1], rb1) - torch.atan2(params[1], r_obs_bl))
    th = torch.arccos(torch.clamp(rb1 * torch.cos(es["theta"]) / rho,
                                  -1.0, 1.0))
    t_arr = torch.abs(es["e_sign"] * es["t"] + t_b - t_o)
    return th, phi, es["escaped"], t_arr


def _one_ray_exit_flat(i_f, j_f, obs_pos, fov, height, width,
                       boundary_radius, params):
    """The flat twin: the same camera's covector straight to the boundary
    sphere, (theta, phi)."""
    pix = pixel_positions_fractional(obs_pos, fov, height, width,
                                     i_f.reshape(1), j_f.reshape(1),
                                     dtype=F64)
    q0, p0, _ = cartesian_ics_from_pixels(obs_pos, pix, params=params,
                                          g_inv_fn=METRICS["KerrSchild"])
    x0 = q0[0, 1:]
    n = p0[0, 1:]
    n = n / torch.linalg.vector_norm(n)
    rho = float(boundary_radius)
    b = torch.dot(x0, n)
    s = -b + torch.sqrt(torch.clamp(b * b + rho * rho - torch.dot(x0, x0),
                                    min=0.0))
    e = x0 + s * n
    return (torch.arccos(torch.clamp(e[2] / rho, -1.0, 1.0)),
            torch.atan2(e[1], e[0]))


def exit_map(ij, params, obs_pos, fov, height, width, boundary_radius,
             chunk=4096):
    """`_one_ray_exit` over (K, 2) fractional pixels, vmapped in chunks:
    (theta, phi, escaped, t_arrival), each (K,); the scan of
    find_images."""
    nodes = _nodes(ij.device)

    def one(i_f, j_f):
        return _one_ray_exit(i_f, j_f, params, obs_pos, fov, height, width,
                             boundary_radius, nodes)
    parts = [vmap(one)(ij[k:k + chunk, 0], ij[k:k + chunk, 1])
             for k in range(0, ij.shape[0], chunk)]
    return tuple(torch.cat([p[m] for p in parts]) for m in range(4))


def find_images(source_theta, source_phi, *, params, obs_x=30.0,
                fov=np.deg2rad(80.0), height=256, width=256,
                boundary_radius=31.0, scan=96, windings=(-1, 0, 1),
                newton_iters=12, tol=1e-8, seed_cut=0.35, device="cuda"):
    """Solve the lens equation for every requested winding: a list of
    dicts, one per winding with a seed (JAX's keys): winding, i, j,
    residual, converged, and for a converged image theta, phi (unwrapped),
    mu (signed, flat-normalized) and t_arrival.  Seeds farther than
    seed_cut radians on the sky are not pursued."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("find_images(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu'")
    params = torch.as_tensor([float(x) for x in params], dtype=F64,
                             device=device)
    obs_pos = torch.tensor([obs_x, 0.0, 0.0], dtype=F64, device=device)
    fov_t = torch.tensor(float(fov), dtype=F64, device=device)
    nodes = _nodes(device)
    th_s, ph_s = float(source_theta), float(source_phi)

    def exit_th_phi(ij):
        th, ph, esc, t_arr = _one_ray_exit(ij[0], ij[1], params, obs_pos,
                                           fov_t, height, width,
                                           boundary_radius, nodes)
        return torch.stack([th, ph]), esc, t_arr

    def sky_aux(ij):
        out = exit_th_phi(ij)
        return out[0], out

    # the exact Jacobian and the map's value in one forward-mode pass
    jac_and_value = jacfwd(sky_aux, has_aux=True)

    def flat_fn(ij):
        return torch.stack(_one_ray_exit_flat(
            ij[0], ij[1], obs_pos, fov_t, height, width, boundary_radius,
            params))

    ii = torch.linspace(0.0, height - 1.0, scan, dtype=F64, device=device)
    jj = torch.linspace(0.0, width - 1.0, scan, dtype=F64, device=device)
    gi, gj = torch.meshgrid(ii, jj, indexing="ij")
    flat_ij = torch.stack([gi.reshape(-1), gj.reshape(-1)], dim=-1)
    scan_th, scan_ph, scan_esc, _ = exit_map(flat_ij, params, obs_pos, fov_t,
                                             height, width, boundary_radius)
    scan_th, scan_ph = scan_th.cpu().numpy(), scan_ph.cpu().numpy()
    scan_esc = scan_esc.cpu().numpy()

    results = []
    for k in windings:
        target = np.array([th_s, ph_s + 2.0 * np.pi * k])
        res = np.hypot(scan_th - target[0], scan_ph - target[1])
        res[~scan_esc] = np.inf
        best = int(np.argmin(res))
        if not np.isfinite(res[best]) or res[best] > seed_cut:
            continue
        ij = flat_ij[best].clone()
        tgt = torch.as_tensor(target, dtype=F64, device=device)
        converged = False
        resid = float(res[best])
        for _ in range(newton_iters):
            j_c, (f, esc, t_arr) = jac_and_value(ij)
            resid = float(torch.linalg.vector_norm(f - tgt))
            if not bool(esc):
                break
            if resid < tol:
                converged = True
                break
            step = torch.linalg.solve(j_c, f - tgt)
            norm = torch.linalg.vector_norm(step)
            if float(norm) > 2.0:
                step = step * (2.0 / norm)
            ij = ij - step
        else:
            j_c, (f, esc, t_arr) = jac_and_value(ij)
            resid = float(torch.linalg.vector_norm(f - tgt))
            converged = bool(esc) and resid < tol
        if not converged:
            results.append({"winding": k, "i": float(ij[0]),
                            "j": float(ij[1]), "residual": resid,
                            "converged": False})
            continue
        det_c = (j_c[0, 0] * j_c[1, 1] - j_c[0, 1] * j_c[1, 0]) \
            * torch.sin(f[0])
        j_f = jacfwd(flat_fn)(ij)
        det_f = (j_f[0, 0] * j_f[1, 1] - j_f[0, 1] * j_f[1, 0]) \
            * torch.sin(flat_fn(ij)[0])
        results.append({"winding": k, "i": float(ij[0]), "j": float(ij[1]),
                        "theta": float(f[0]), "phi": float(f[1]),
                        "residual": resid, "mu": float(det_f / det_c),
                        "t_arrival": float(t_arr), "converged": True})
    return results
