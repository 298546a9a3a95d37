"""Lamp-post reverberation mapping: X-ray echo transfer functions — the
torch counterpart of `grtrace.engine.echo`.

A point corona at height h on the spin axis flares; its photons rain onto
the disk, which reprocesses them, and the observer sees the flare followed
by its lensed, delayed, energy-shifted echo.  The observable is the
transfer function Psi(tau, g), response against lag and line shift.  Two
geodesic legs:

  * the source leg (`trace_lamppost`): one meridional fan from the lamp,
    parametrized by the rest-frame polar emission angle psi (the
    illumination is axisymmetric), launched from the static observer's
    tetrad (physics/camera.boosted_ics_from_pixels with omega_cam = 0, so
    the momentum has unit lamp-frame frequency) and traced to its first
    plane crossing anywhere outside the horizon through
    `integrate_ks.integrate_dispatch_disk`: kernel B6 on the card (float64
    rays, the 16-row layout), its eager twin on the CPU;
  * the observer leg: any disk render (engine/disk.py) already carries per
    pixel (t_obs, g_obs, r_em), so the transfer function is a weighted 2-D
    histogram over its pixels (`transfer_function`).

Both legs trace past-directed rays; lags are quoted against the direct
lamp -> camera line of sight.  The emissivity is g_sd^2 |d cos psi / dA|
on the fan's primary branch, dA the proper equatorial annulus area
(`emissivity_profile`).  Host float64 numpy outside the fan's trace, with
JAX's arithmetic.

A ray that never hits the disk carries zero hit rows here (B6 and its
twins write them so), where JAX's XLA disk engine carries the launch state
(ROADMAP Queue C): every crossing quantity is masked by `hit`, so r,
t_src, g_sd and the transfer function are the same; the unmasked
`energy` and `l_z` of a non-hitting ray read 0 here.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..physics.camera import boosted_ics_from_pixels
from ..physics.spacetime import (_charge, horizon_radius, kerr_schild_g_inv,
                                 ks_radius)
from .hotspot import bl_time_azimuth_offsets
from .integrate_ks import STATUS_DISK, integrate_dispatch_disk


def lamppost_ics(h, params, psi, dtype=torch.float64, device="cpu"):
    """Null initial conditions at the lamp post (0, 0, h) for the
    rest-frame polar emission angles `psi` (radians from straight down),
    unit lamp-frame frequency: (q0, p0, alpha0) with alpha0 == psi.  The
    static observer's tetrad on the Kerr-Schild chart (regular on the
    axis), "pixels" at unit offsets cos(psi) down and sin(psi) sideways."""
    psi = torch.as_tensor(psi, dtype=dtype, device=device)
    obs = torch.tensor([0.0, 0.0, float(h)], dtype=dtype, device=device)
    # look-at frame at (0, 0, h): axis (0, 0, -1), 'right' falls back to
    # (0, 1, 0) on the pole
    axis = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device)
    side = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device)
    pix = (obs[None, :] + torch.cos(psi)[:, None] * axis[None, :]
           + torch.sin(psi)[:, None] * side[None, :])
    return boosted_ics_from_pixels(
        obs, pix, params=torch.as_tensor(params, dtype=dtype, device=device),
        g_inv_fn=kerr_schild_g_inv,
        omega_cam=torch.zeros((), dtype=dtype, device=device))


def _host(t):
    return t.detach().cpu().numpy()


def trace_lamppost(h, params, *, n_rays=512, psi_max=None, steps=40_000,
                   delta=0.05, r_max=None, order=2, prograde=True,
                   dtype=torch.float64, device="cuda"):
    """Trace the lamp-post fan; return its per-ray crossing data (host
    numpy): psi, alpha0, hit, r (Boyer-Lindquist crossing radius), t_src
    (light-travel time lamp -> crossing), energy (|p_t|), l_z, g_sd (lamp
    -> Keplerian disk shift), g_sd_static (lamp -> static receiver), and
    the scalars h, r_plus, params.  The fan's integration is one launch
    of `integrate_dispatch_disk` (kernel B6 on the card); device defaults
    to 'cuda' and raises without a GPU, device='cpu' runs the twin."""
    from ..physics.orbits import circular_u_t, static_u_t

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("trace_lamppost(device='cuda') needs a CUDA GPU; "
                           "pass device='cpu' for the eager twin")
    params = torch.as_tensor(params, dtype=dtype)
    r_plus = float(horizon_radius("Kerr", params[0], params[1],
                                  _charge(params)))
    if r_max is None:
        r_max = max(4.0 * float(h), 60.0)
    if psi_max is None:
        psi_max = np.pi * 0.75
    # open interval: psi = 0 is the exact axis ray (crosses at r = 0)
    psi = torch.linspace(1e-4, float(psi_max), n_rays, dtype=dtype)
    q0, p0, alpha0 = lamppost_ics(h, params, psi, dtype, device)

    # first plane crossing anywhere outside the horizon: the annulus spans
    # [just above r_plus, just inside the escape sphere]
    r_in = 1.0001 * r_plus
    r_out = 0.999 * r_max
    p_list = params.tolist()
    _, _, status, _, hit_q, hit_p = integrate_dispatch_disk(
        q0.contiguous(), p0.contiguous(), steps, delta, p_list, r_max, 0.0,
        r_in, r_out, order=order)

    hit_q, hit_p = hit_q.cpu(), hit_p.cpu()
    hit = _host(status) == STATUS_DISK
    r_bl = ks_radius(hit_q[:, 1], hit_q[:, 2], hit_q[:, 3], params[1])
    t_off = bl_time_azimuth_offsets(r_bl, params)[0]
    t_src = torch.abs(hit_q[:, 0] - t_off)

    energy = torch.abs(hit_p[:, 0])          # |E| = |-p_t|, conserved
    # L_z = 0 exactly (axis launch): the receiver frequency is u^t |E| terms
    u_t_kep, omega_k = circular_u_t(r_bl, params, prograde)
    x, y = hit_q[:, 1], hit_q[:, 2]
    l_z = x * hit_p[:, 2] - y * hit_p[:, 1]
    g_sd = torch.abs(u_t_kep * (hit_p[:, 0] + omega_k * l_z))
    g_sd_static = static_u_t(r_bl, params) * energy

    def on_hit(t):
        return np.where(hit, _host(t), np.nan)

    return {
        "psi": _host(psi),
        "alpha0": _host(alpha0),
        "hit": hit,
        "r": on_hit(r_bl),
        "t_src": on_hit(t_src),
        "energy": _host(energy),
        "l_z": _host(l_z),
        "g_sd": on_hit(g_sd),
        "g_sd_static": on_hit(g_sd_static),
        "h": float(h),
        "r_plus": r_plus,
        "params": _host(params),
    }


def emissivity_profile(fan, params, r_lo=None, r_hi=None):
    """The lamp-post emissivity epsilon(r) ~ g_sd^2 |d cos psi / dA| on the
    fan's primary (monotone-in-psi) illumination branch, dA the proper
    equatorial annulus area 2 pi sqrt(g_rr g_phiphi) dr.  Host numpy.
    Returns (r, eps, t_src, g_sd) sorted by r."""
    from ..physics.orbits import equatorial_g_cov

    hit = fan["hit"]
    r = fan["r"][hit]
    psi = fan["psi"][hit]
    g_sd = fan["g_sd"][hit]
    t_src = fan["t_src"][hit]
    if r.size < 8:
        raise ValueError("fan too sparse: fewer than 8 disk crossings")
    # primary branch: the longest contiguous run where r increases with psi
    dr = np.diff(r)
    mono = np.concatenate([[True], dr > 0])
    best_s = best_e = 0
    s = 0
    for i in range(1, len(mono) + 1):
        if i == len(mono) or not mono[i]:
            if i - s > best_e - best_s:
                best_s, best_e = s, i
            s = i + 1
    sel = slice(best_s, best_e)
    r, psi, g_sd, t_src = r[sel], psi[sel], g_sd[sel], t_src[sel]
    if r_lo is not None:
        keep = (r >= r_lo) & (r <= (r_hi or np.inf))
        r, psi, g_sd, t_src = r[keep], psi[keep], g_sd[keep], t_src[keep]

    dcos = np.gradient(np.cos(psi))
    drad = np.gradient(r)
    g_cov = _host(equatorial_g_cov(torch.as_tensor(r, dtype=torch.float64),
                                   torch.as_tensor(fan["params"],
                                                   dtype=torch.float64)))
    g_rr = g_cov[:, 1, 1]
    g_ph = g_cov[:, 3, 3]
    area = 2.0 * np.pi * np.sqrt(np.maximum(g_rr * g_ph, 0.0)) * drad
    eps = g_sd ** 2 * np.abs(dcos) / np.maximum(np.abs(area), 1e-300)
    order_idx = np.argsort(r)
    return (r[order_idx], eps[order_idx], t_src[order_idx],
            g_sd[order_idx])


def transfer_function(disk_result, fan, *, n_tau=96, n_g=64, tau_max=None,
                      weight_power=4.0, t_direct=0.0):
    """The 2-D reverberation transfer function Psi(tau, g_obs) from a disk
    render and a lamp-post fan.  Per disk pixel: lag tau = t_src(r_em) +
    t_obs - t_direct (t_src interpolated on the fan's primary branch),
    line shift g_obs (the render's per-pixel redshift), weight
    epsilon(r_em) g_obs^weight_power (4 bolometric, 3 photon counts).
    Accepts a render_disk RenderResult or a dict with hit_q, status and
    redshift.  Returns the histogram, its axes, the lag profile and scalar
    lag metrics."""
    def get(name):
        if hasattr(disk_result, "device"):
            return disk_result.device(name).cpu().numpy()
        return np.asarray(disk_result[name])

    hit_q = np.asarray(get("hit_q"), dtype=np.float64)
    status = get("status")
    g_obs = np.asarray(get("redshift"), dtype=np.float64)
    params = fan["params"]

    disk_mask = status == STATUS_DISK
    hq = torch.as_tensor(hit_q)
    r_em_t = ks_radius(hq[..., 1], hq[..., 2], hq[..., 3],
                       torch.tensor(float(params[1]), dtype=torch.float64))
    r_em = _host(r_em_t)
    t_off = _host(bl_time_azimuth_offsets(
        r_em_t.reshape(-1), torch.as_tensor(params))[0]).reshape(r_em.shape)
    t_obs = np.abs(hit_q[..., 0] - t_off)

    r_tab, eps_tab, t_tab, _ = emissivity_profile(fan, params)
    in_range = disk_mask & (r_em >= r_tab[0]) & (r_em <= r_tab[-1])
    t_src = np.interp(r_em, r_tab, t_tab)
    eps = np.interp(r_em, r_tab, eps_tab)

    # zero point: the direct lamp -> camera time (callers pass the flat
    # distance |camera - lamp|, or 0 for absolute light-travel times)
    tau = t_src + t_obs - float(t_direct)

    w = eps * np.power(np.maximum(g_obs, 0.0), weight_power)
    tau_v = tau[in_range]
    g_v = g_obs[in_range]
    w_v = w[in_range]
    if tau_max is None:
        tau_max = float(np.percentile(tau_v, 99.5)) if tau_v.size else 1.0
    hist, tau_edges, g_edges = np.histogram2d(
        tau_v, g_v, bins=[n_tau, n_g],
        range=[[float(tau_v.min()) if tau_v.size else 0.0, tau_max],
               [float(g_v.min()) if g_v.size else 0.0,
                float(g_v.max()) if g_v.size else 1.0]],
        weights=w_v)
    lag_profile = hist.sum(axis=1)
    tau_centers = 0.5 * (tau_edges[:-1] + tau_edges[1:])
    g_centers = 0.5 * (g_edges[:-1] + g_edges[1:])
    total = float(w_v.sum())
    return {
        "psi_tau_g": hist,
        "tau": tau_centers,
        "g": g_centers,
        "lag_profile": lag_profile,
        "tau_peak": float(tau_centers[np.argmax(lag_profile)])
        if lag_profile.size else float("nan"),
        "tau_centroid": float((tau_v * w_v).sum() / total)
        if total > 0 else float("nan"),
        "response_total": total,
        "pixels": int(in_range.sum()),
    }


def _figures(fan, tf, r, eps, out_dir):
    """echo_emissivity.png and echo_transfer.png (matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = []
    fig, ax = plt.subplots(figsize=(5.5, 4))
    ax.loglog(r, eps / eps.max(), lw=1.5, label="GR lamp-post")
    h = fan["h"]
    newt = h / (2.0 * np.pi * (h * h + r * r) ** 1.5)
    ax.loglog(r, newt / newt.max(), "--", lw=1.0,
              label=r"Newtonian $h/2\pi(h^2+r^2)^{3/2}$")
    ax.set_xlabel("r [M]")
    ax.set_ylabel("emissivity (normalized)")
    ax.set_title(f"lamp-post emissivity, h = {h:g} M")
    ax.legend()
    p = os.path.join(out_dir, "echo_emissivity.png")
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    fig, ax = plt.subplots(figsize=(6, 4.5))
    im = ax.pcolormesh(tf["g"], tf["tau"],
                       tf["psi_tau_g"] / max(tf["psi_tau_g"].max(), 1e-300),
                       cmap="inferno", shading="auto")
    ax.set_xlabel("line shift g = E_obs / E_rest")
    ax.set_ylabel("lag tau [M]")
    ax.set_title("reverberation transfer function Psi(tau, g)")
    fig.colorbar(im, ax=ax, fraction=0.046)
    p = os.path.join(out_dir, "echo_transfer.png")
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    written.append(p)
    return written


def save_echo_artifacts(fan, tf, out_dir, params, plots=True):
    """Write the echo products: echo_emissivity.csv, echo_lag_profile.csv,
    echo_summary.json and, unless plots=False, the emissivity and
    transfer-function figures.  Returns (paths, summary)."""
    os.makedirs(out_dir, exist_ok=True)
    r, eps, t_src, g_sd = emissivity_profile(fan, params)
    written = []

    p = os.path.join(out_dir, "echo_emissivity.csv")
    with open(p, "w") as f:
        f.write("r,emissivity,t_src_M,g_sd\n")
        for row in zip(r, eps, t_src, g_sd):
            f.write(",".join(f"{v:.9g}" for v in row) + "\n")
    written.append(p)
    if plots:
        written += _figures(fan, tf, r, eps, out_dir)

    p = os.path.join(out_dir, "echo_lag_profile.csv")
    with open(p, "w") as f:
        f.write("tau_M,response\n")
        for t, v in zip(tf["tau"], tf["lag_profile"]):
            f.write(f"{t:.9g},{v:.9g}\n")
    written.append(p)

    summary = {
        "h": fan["h"],
        "tau_peak_M": tf["tau_peak"],
        "tau_centroid_M": tf["tau_centroid"],
        "response_total": tf["response_total"],
        "pixels": tf["pixels"],
        "fan_hits": int(fan["hit"].sum()),
    }
    p = os.path.join(out_dir, "echo_summary.json")
    with open(p, "w") as f:
        json.dump(summary, f, indent=2)
    written.append(p)
    return written, summary
