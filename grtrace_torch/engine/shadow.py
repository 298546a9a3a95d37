"""Black-hole shadow analysis — the torch counterpart of
`grtrace.engine.shadow`: the analytic critical curve, the EHT-style shape
metrics, and the real integrator's boundary, in the renderer's own
image-plane coordinates.

The critical curve is where the Bardeen (1973) radial potential first
admits a turning point outside the horizon; `engine.validate.
bardeen_escapes` evaluates that closed-form predicate through the port's
Kerr-Schild camera (host float64), and `analytic_boundary` bisects it
radially on an azimuth fan.  `shadow_metrics` reduces a curve to the mean
radius and diameter, the centroid shift, the EHT circularity deviation
Delta C and the axis ratio.  `numeric_boundary` bisects the real
integrator's capture/escape transition at the same azimuths: the fan goes
through `integrate_ks.integrate_dispatch_ks`, so on the card kernel B5
(float32 rays in its 32-row compensated layout, as the JAX package's
Pallas path) and on the CPU B5's eager twin.  `overlay_png` draws a curve
over a render (matplotlib).

Boundary radii are quoted in 256-image pixels of the headline scene
(observer at 30 M on +x, fov 80 deg).  The rotating regular families'
exact curve (`analytic_boundary_rotating`) bisects their conserved-quantity
predicate (physics/rotating_regular.escape_pred_rotating) on the host, and
`numeric_boundary(metric='RotatingBardeen' | 'RotatingHayward')` traces
its fan through kernel G1r (`integrate_generic.
integrate_dispatch_generic`; its eager twin on the CPU).  Kerr-de
Sitter's exact curve (`analytic_boundary_kds`) bisects its predicate
(physics/kerr_de_sitter.kds_escape_pred) through the unfolded spherical
camera on the host, and `numeric_boundary(metric='KerrDS')` traces that
camera's fan through kernel G1d (its eager twin on the CPU); the
spherical camera's pixel gauge differs from the Kerr-Schild camera's by
O(2 M / r_obs), so these curves compare with each other, not with
`analytic_boundary`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics.camera import (cartesian_ics_from_pixels,
                              unfolded_ics_from_pixels)
from ..physics.kerr_de_sitter import kds_escape_pred, outer_horizon_cached
from ..physics.rotating_regular import (MASS_FN, escape_pred_rotating,
                                        rotating_horizon)
from ..physics.spacetime import METRICS, kerr_schild_g_inv
from .integrate import STATUS_ESCAPED
from .integrate_generic import integrate_dispatch_generic
from .integrate_ks import integrate_dispatch_ks
from .validate import (BOUNDARY, PLANE_D, PLANE_W, R0, SIZE,
                       _pixel_positions, bardeen_escapes, bisect_boundary,
                       schwarzschild_analytic_rho)


def px_to_alpha_deg(rho_px):
    """256-image pixel radius -> apparent camera angle (degrees), with the
    renderer's image-plane geometry."""
    return np.degrees(np.arctan(np.asarray(rho_px) / SIZE
                                * PLANE_W / PLANE_D))


def analytic_boundary(spin, charge=0.0, n_psi=64, rounds=6):
    """(psis, rho_px): the critical curve in 256-image pixel radii at n_psi
    azimuths (psi = 0 along +y of the +x equatorial camera, increasing
    toward +z), by radial bisection of the closed-form Bardeen escape
    predicate; rounds=6 resolves about 1e-3 px."""
    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    rho, _ = bisect_boundary(
        lambda r: bardeen_escapes(r, spin, charge, psis=psis),
        6.0, 40.0, rounds=rounds, n_psi=n_psi)
    return psis, rho


def analytic_boundary_rotating(spin, p1, metric="RotatingBardeen",
                               n_psi=64, rounds=6):
    """(psis, rho_px): the exact critical curve of a rotating regular
    family (M = 1, spin, family parameter p1), by radial bisection of its
    conserved-quantity escape predicate (`escape_pred_rotating`) on the
    Cartesian camera's rays through each pixel radius, on the host in
    float64: no ray is traced.  NaN radii where (a, p1) has no horizon
    (no shadow to bound)."""
    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    params = torch.tensor([1.0, spin, p1], dtype=torch.float64)
    if not bool(torch.isfinite(rotating_horizon(metric, params))):
        return psis, np.full(n_psi, np.nan)

    def escape(rhos):
        q0, p0 = fan_rays(rhos, psis, params, torch.float64, "cpu",
                          metric=metric)
        pred = escape_pred_rotating(metric, q0, p0, params)
        return pred.reshape(rhos.shape).numpy()

    rho, _ = bisect_boundary(escape, 2.0, 40.0, rounds=rounds, n_psi=n_psi)
    return psis, rho


def analytic_boundary_kds(spin, lam, n_psi=64, rounds=6):
    """(psis, rho_px): the exact Kerr-de Sitter critical curve (M = 1), by
    radial bisection of its conserved-quantity escape predicate
    (`kds_escape_pred`) on the unfolded spherical camera's rays through
    each pixel radius, on the host in float64: no ray is traced.  NaN
    radii where (a, Lambda) has no black-hole horizon."""
    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    params = torch.tensor([1.0, spin, lam], dtype=torch.float64)
    if not bool(torch.isfinite(outer_horizon_cached(params))):
        return psis, np.full(n_psi, np.nan)

    def escape(rhos):
        q0, p0 = fan_rays(rhos, psis, params, torch.float64, "cpu",
                          metric="KerrDS")
        pred = kds_escape_pred(q0, p0, params)
        return pred.reshape(rhos.shape).numpy()

    rho, _ = bisect_boundary(escape, 2.0, 40.0, rounds=rounds, n_psi=n_psi)
    return psis, rho


def shadow_metrics(psis, rho_px):
    """Standard shape observables of a boundary curve (pixel units); the
    angles are apparent camera angles alpha = atan(rho / SIZE * W / D),
    and the radius is also quoted against the a = Q = 0 curve of the same
    (Kerr-Schild camera) convention."""
    y = rho_px * np.cos(psis)
    z = rho_px * np.sin(psis)
    cy, cz = y.mean(), z.mean()
    # radii about the centroid (the EHT circularity is centroid-relative)
    r_c = np.hypot(y - cy, z - cz)
    mean_r = r_c.mean()
    delta_c = float(np.sqrt(((r_c - mean_r) ** 2).mean()) / mean_r)

    alpha = px_to_alpha_deg(rho_px)
    _, rho0 = analytic_boundary(0.0, 0.0, n_psi=1)
    return {
        "mean_radius_px": float(mean_r),
        "mean_diameter_px": float(2.0 * mean_r),
        "mean_radius_deg": float(alpha.mean()),
        "centroid_shift_px": [float(cy), float(cz)],
        "circularity_deviation": delta_c,
        "axis_ratio": float(r_c.max() / r_c.min()),
        "radius_vs_schwarzschild": float(mean_r / rho0[0]),
        "rho_min_px": float(rho_px.min()),
        "rho_max_px": float(rho_px.max()),
        "convention": "kerr-schild camera, 256-image px "
                      "(spherical-chart camera: "
                      f"{schwarzschild_analytic_rho():.3f} px at a=0)",
    }


def fan_rays(rhos, psis, params, dtype, device, metric="KerrSchild"):
    """The Kerr-Schild camera rays (q0, p0), each (P*K, 4), through the
    (P, K) pixel radii `rhos` at the P azimuths `psis`, with `metric`'s
    g_inv (the Kerr-Newman one, or a rotating regular family's), or for
    'KerrDS' the unfolded spherical camera's: the fan that
    `numeric_boundary` traces each round."""
    obs = torch.tensor([R0, 0.0, 0.0], dtype=dtype, device=device)
    pix = torch.as_tensor(_pixel_positions(rhos, np.asarray(psis)[:, None]),
                          dtype=dtype, device=device)
    g_inv_fn = kerr_schild_g_inv if metric == "KerrSchild" \
        else METRICS[metric]
    camera = unfolded_ics_from_pixels if metric == "KerrDS" \
        else cartesian_ics_from_pixels
    q0, p0, _ = camera(obs, pix, params=params, g_inv_fn=g_inv_fn)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def numeric_boundary(spin, charge=0.0, n_psi=16, steps=8_000, delta=0.02,
                     order=4, backend="auto", dtype=None, rounds=3,
                     metric="KerrSchild", device="cuda"):
    """(psis, rho_px, bracket): the real integrator's shadow boundary at
    n_psi azimuths, by `rounds` rounds of radial bisection with 9 rays an
    azimuth.  Each round's fan goes through `integrate_dispatch_ks`: kernel
    B5 on the card (float32 rays, the default, in its 32-row compensated
    layout), its eager twin on the CPU or with backend='torch'.  device
    defaults to 'cuda' and raises without a GPU; pass device='cpu' for the
    twin.  For a rotating regular family (`metric` 'RotatingBardeen' /
    'RotatingHayward', its parameter in `charge`'s slot) the fan takes the
    family's camera and goes through `integrate_dispatch_generic`: kernel
    G1r on the card, its twin on the CPU; for Kerr-de Sitter ('KerrDS',
    Lambda in `charge`'s slot) the unfolded spherical camera and kernel
    G1d.  Any other metric raises NotImplementedError."""
    if metric not in ("KerrSchild", "KerrDS") and metric not in MASS_FN:
        raise NotImplementedError(
            f"numeric_boundary of grtrace_torch traces the Kerr-Schild "
            f"charts and Kerr-de Sitter's only (got {metric!r})")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("numeric_boundary(device='cuda') needs a CUDA "
                           "GPU; pass device='cpu' for the eager twin")
    if dtype is None:
        dtype = torch.float32
    psis = np.linspace(0.0, 2.0 * np.pi, n_psi, endpoint=False)
    params = (1.0, spin, charge)

    def escape(rhos):
        q0, p0 = fan_rays(rhos, psis, params, dtype, device, metric=metric)
        if metric == "KerrSchild":
            _, _, status, _ = integrate_dispatch_ks(
                q0, p0, steps, delta, params, BOUNDARY, 1.0, order=order,
                backend=backend)
        else:
            _, _, status, _ = integrate_dispatch_generic(
                q0, p0, steps, delta, params, BOUNDARY, 1.0, order=order,
                metric=metric, backend=backend)
        return status.reshape(rhos.shape).cpu().numpy() == STATUS_ESCAPED

    rho, bracket = bisect_boundary(escape, 6.0, 40.0, rounds=rounds, k=9,
                                   n_psi=n_psi)
    return psis, rho, bracket


def overlay_png(result, psis, rho_px, path, title=None):
    """A render with a critical curve drawn over it (matplotlib).  The
    curve is in 256-image pixel radii about the image centre, rescaled to
    the render's resolution; image rows advance along the camera's up
    vector (+z) and columns along right (+y), as physics.camera.pixel_grid
    lays them out."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(result.image)
    h, w = img.shape[:2]
    jj = (rho_px / SIZE * np.cos(psis) + 0.5) * w - 0.5
    ii = (rho_px / SIZE * np.sin(psis) + 0.5) * h - 0.5

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(img)
    order = np.argsort(psis)
    ax.plot(np.append(jj[order], jj[order][0]),
            np.append(ii[order], ii[order][0]),
            color="#00e5ff", lw=1.2, ls="--",
            label="Bardeen critical curve")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
