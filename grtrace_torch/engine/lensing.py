"""Lensing magnification maps from the escape angles — the torch
counterpart of `grtrace.engine.lensing`.

Every curved render already computes, per pixel, where its backward ray
lands on the celestial sphere (final_th, final_ph).  The lensing
magnification is the Jacobian of that map:

    mu^-1 = dOmega_sky / dOmega_image
          = [ sin(th) det d(th, ph)/d(i, j) ]_curved
          / [ sin(th) det d(th, ph)/d(i, j) ]_flat,

by centered finite differences across neighboring pixels: no extra
geodesics.  The flat twin propagates the camera's own initial covectors
straight to the boundary sphere, so the camera's pixel -> angle
convention cancels in the ratio and mu -> 1 far from the hole.  The
signed determinant carries image parity: mu^-1 < 0 marks the
mirror-flipped images between the shadow edge and the first Einstein
ring.

Host float64 numpy on a render result's final_th, final_ph, status, q0 and
p0 (engine.render.RenderResult fetches each from the device once), with
JAX's arithmetic; `save_magnification_maps` draws its figure with
matplotlib unless the caller asks for none.
"""
from __future__ import annotations

import numpy as np

from .integrate import STATUS_ESCAPED


def _wrap_diff(a):
    """Centered differences of an angle array along both axes, each
    difference wrapped to (-pi, pi] BEFORE averaging (phi jumps 2 pi
    across the seam; naive np.gradient would see a huge derivative)."""
    def wrap(x):
        return (x + np.pi) % (2.0 * np.pi) - np.pi

    di = np.empty_like(a)
    dj = np.empty_like(a)
    di[1:-1] = 0.5 * (wrap(a[2:] - a[1:-1]) + wrap(a[1:-1] - a[:-2]))
    di[0] = wrap(a[1] - a[0])
    di[-1] = wrap(a[-1] - a[-2])
    dj[:, 1:-1] = 0.5 * (wrap(a[:, 2:] - a[:, 1:-1])
                         + wrap(a[:, 1:-1] - a[:, :-2]))
    dj[:, 0] = wrap(a[:, 1] - a[:, 0])
    dj[:, -1] = wrap(a[:, -1] - a[:, -2])
    return di, dj


def _solid_angle_jacobian(theta, phi):
    """sin(theta) * det d(theta, phi)/d(i, j) by centered FD."""
    ti, tj = _wrap_diff(theta)
    pi_, pj = _wrap_diff(phi)
    return np.sin(theta) * (ti * pj - tj * pi_)


def _flat_escape_angles(result, boundary_radius, chart="cartesian"):
    """Straight-propagate the camera's initial covectors to the boundary
    sphere; return the same (theta, phi) the curved map would produce
    with gravity off.

    `chart` names the IC storage format of the render result:
    'cartesian' (Kerr-Schild path: q = (t, x, y, z), spatial covector ==
    flat ray direction) or 'spherical' (BL path: q = (t, r, th, ph),
    covariant p = (p_t, p_r, p_th, p_ph) — index-raised to
    d = p_r rhat + (p_th / r) thhat + (p_ph / (r sin th)) phhat)."""
    p0 = np.asarray(result.p0, np.float64)
    q0 = np.asarray(result.q0, np.float64)
    shape = p0.shape[:-1]
    if chart == "cartesian":
        d = p0[..., 1:]
        obs = q0[..., 1:]
    else:
        r0 = q0[..., 1]
        th0 = q0[..., 2]
        ph0 = q0[..., 3]
        st, ct = np.sin(th0), np.cos(th0)
        sp, cp = np.sin(ph0), np.cos(ph0)
        rhat = np.stack([st * cp, st * sp, ct], axis=-1)
        thhat = np.stack([ct * cp, ct * sp, -st], axis=-1)
        phhat = np.stack([-sp, cp, np.zeros_like(sp)], axis=-1)
        d = (p0[..., 1:2] * rhat
             + (p0[..., 2:3] / r0[..., None]) * thhat
             + (p0[..., 3:4] / (r0 * st)[..., None]) * phhat)
        obs = r0[..., None] * rhat
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = 2.0 * np.sum(obs * d, axis=-1)
    c = np.sum(obs * obs, axis=-1) - boundary_radius ** 2
    t = (-b + np.sqrt(np.maximum(b * b - 4.0 * c, 0.0))) / 2.0
    hit = obs + t[..., None] * d
    r = np.linalg.norm(hit, axis=-1)
    theta = np.arccos(np.clip(hit[..., 2] / r, -1.0, 1.0))
    phi = np.arctan2(hit[..., 1], hit[..., 0])
    return theta.reshape(shape), phi.reshape(shape)


def inverse_magnification_map(result, boundary_radius, chart="cartesian"):
    """(mu_inv (H, W) float64, valid (H, W) bool) for a curved render
    (engine.render_generic / engine.disk RenderResult; `chart` names the
    result's IC storage format, see _flat_escape_angles).

    mu_inv is SIGNED: negative values are parity-flipped (secondary)
    images; |mu_inv| -> 0 marks the critical curves where the
    magnification diverges.  valid requires the pixel and its FD stencil
    neighbors to have escaped (the map is undefined into the shadow)."""
    theta_c = np.asarray(result.final_th, np.float64)
    phi_c = np.asarray(result.final_ph, np.float64)
    status = np.asarray(result.status)
    h, w = theta_c.shape

    theta_f, phi_f = _flat_escape_angles(result, boundary_radius, chart)
    if theta_f.shape != (h, w):
        theta_f = theta_f.reshape(h, w)
        phi_f = phi_f.reshape(h, w)

    jac_c = _solid_angle_jacobian(theta_c, phi_c)
    jac_f = _solid_angle_jacobian(theta_f, phi_f)

    esc = status == STATUS_ESCAPED
    stencil = esc.copy()
    stencil[1:] &= esc[:-1]
    stencil[:-1] &= esc[1:]
    stencil[:, 1:] &= esc[:, :-1]
    stencil[:, :-1] &= esc[:, 1:]

    with np.errstate(divide="ignore", invalid="ignore"):
        mu_inv = jac_c / jac_f
    mu_inv = np.where(stencil & np.isfinite(mu_inv), mu_inv, np.nan)
    return mu_inv, stencil & np.isfinite(mu_inv)


def save_magnification_maps(mu_inv, valid, out_dir, plots=True):
    """magnification.csv (sparse: i, j, mu_inv, mu) and, unless
    plots=False, magnification.png (log10 |mu| beside the image parity)."""
    import os

    ii, jj = np.nonzero(valid)
    mu = 1.0 / mu_inv[valid]
    np.savetxt(os.path.join(out_dir, "magnification.csv"),
               np.column_stack([ii, jj, mu_inv[valid], mu]),
               delimiter=",", comments="",
               header="i,j,inverse_magnification,magnification",
               fmt=("%d", "%d", "%.8g", "%.8g"))
    if not plots:
        return

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    log_mu = np.full(mu_inv.shape, np.nan)
    log_mu[valid] = np.log10(np.abs(mu))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.8))
    im = ax1.imshow(log_mu, cmap="inferno")
    ax1.set_title("log$_{10}$ |$\\mu$| (diverges at the critical curve)")
    ax1.set_facecolor("black")
    fig.colorbar(im, ax=ax1)
    parity = np.full(mu_inv.shape, np.nan)
    parity[valid] = np.sign(mu_inv[valid])
    im2 = ax2.imshow(parity, cmap="coolwarm", vmin=-1, vmax=1)
    ax2.set_title("image parity (red = +, blue = mirror-flipped)")
    ax2.set_facecolor("black")
    fig.colorbar(im2, ax=ax2)
    for ax in (ax1, ax2):
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "magnification.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)
