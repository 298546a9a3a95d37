"""Validation of the Schwarzschild and Kerr paths against closed-form GR —
the torch counterpart of `grtrace.engine.validate`.

  * `schwarzschild_shadow_error` — the shadow boundary of the equatorial
    Schwarzschild path (`integrate_dispatch`: kernel B1 for float32 and B2
    for float64 CUDA rays, the eager paths for CPU rays) against the exact
    arcsin formula (`schwarzschild_analytic_rho`), by sub-pixel bisection
    along 8 image azimuths;
  * `kerr_shadow_errors` — the shadow boundary of the float32 Kerr-Schild
    path (kernel B5 on a CUDA device, its eager twin on the CPU) against
    the Bardeen (1973) radial-potential construction, per image azimuth,
    by sub-pixel bisection;
  * `chunk_parity` — a checkpoint chunk kernel (B3 or B4) against its
    eager twin on the same carry, the state bit for bit;
  * `ks_kernel_parity` — kernel B5 (with disk=(r_in, r_out) kernel B6,
    with subrings=n_orders kernel B7) against its eager twin on the same
    rays: q and p bit for bit, status and exit step exactly; in disk mode
    the hit flag exactly and hit_q and hit_p bit for bit; in subring mode
    the crossing count exactly and hits_q and hits_p bit for bit in every
    slot, filled or not;
  * `traj_parity` — kernel S1, the trajectory recorder, against its eager
    twin `integrate_batch_full` on the same rays, every slot bit for bit;
  * `gen_kernel_parity` — kernel G1, the generic engine's Boyer-Lindquist
    integrator, against its eager twin `integrate_batch_generic(metric=
    'Kerr')` on the same rays: q and p bit for bit, status and exit step
    exactly;
  * `disk_kds_parity` — kernel D3, Kerr-de Sitter's disk, against its
    eager twin `disk_kds.integrate_batch_disk_kds` on the same rays;
  * `gen_traj_parity` — kernel S2, the generic engine's trajectory
    recorder, against its eager twin `trajectory_batch_decimated` in
    either chart, every slot bit for bit.

Boundary positions are quoted in 256x256-image pixels whatever the probe
resolution.  Scene: observer at r0 = 30 M on +x, fov 80 deg, boundary
sphere 31 M — the headline configuration.  The host-side pieces
(`_pixel_positions`, `bisect_boundary`, `bardeen_escapes`) are numpy and
float64.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..physics.camera import cartesian_ics_from_pixels, initial_conditions
from ..physics.spacetime import kerr_schild_g_inv
from . import integrate_ks_cuda
from .integrate import STATUS_ESCAPED, integrate_dispatch
from .integrate_ks import (STATUS_DISK, integrate_batch_disk_ks,
                           integrate_batch_disk_ksc, integrate_batch_ks,
                           integrate_batch_ksc, integrate_batch_subrings_ks,
                           integrate_batch_subrings_ksc,
                           integrate_dispatch_ks)

R0 = 30.0
FOV = np.radians(80.0)
SIZE = 256                      # pixel scale the errors are quoted at
BOUNDARY = 31.0
PLANE_D = 0.2 * R0              # image plane distance (as pixel_grid)
PLANE_W = 2.0 * PLANE_D * np.tan(FOV / 2.0)
N_PSI = 8
PSIS = np.linspace(0.0, 2 * np.pi, N_PSI, endpoint=False)


def _pixel_positions(rho_px, psi):
    """Continuous pixel radius (256-image units) + azimuth -> image-plane
    points (the plane geometry of physics.camera.pixel_grid)."""
    off = np.asarray(rho_px) / SIZE * PLANE_W
    y = off * np.cos(psi)
    z = off * np.sin(psi)
    x = np.full_like(y, R0 - PLANE_D)
    return np.stack([x, y, z], axis=-1)


def bisect_boundary(escape_fn, lo, hi, rounds=3, k=17, n_psi=N_PSI):
    """Per-azimuth radial bisection of the capture -> escape transition.

    escape_fn((P, K) pixel radii) -> (P, K) bool.  Returns (midpoints (P,),
    max bracket width).
    """
    lo = np.full(n_psi, float(lo))
    hi = np.full(n_psi, float(hi))
    for _ in range(rounds):
        rhos = np.linspace(lo, hi, k, axis=-1)           # (P, K)
        esc = np.asarray(escape_fn(rhos))
        if esc[:, 0].any() or not esc[:, -1].all():
            raise ValueError("bisection bracket does not straddle the "
                             "shadow boundary")
        first = esc.argmax(axis=1)                       # first escaped idx
        idx = np.arange(n_psi)
        lo = rhos[idx, first - 1]
        hi = rhos[idx, first]
    return 0.5 * (lo + hi), float((hi - lo).max())


def schwarzschild_analytic_rho(mass=1.0):
    """Closed-form shadow pixel radius: sin(alpha_phys) = b_crit sqrt(f)/r0
    (exact for a static observer at finite r0), tan(alpha_cam) =
    f tan(alpha_phys) (the camera scales the radial covector by sqrt(f)),
    pinhole tan mapping to the plane."""
    f = 1.0 - 2.0 * mass / R0
    b_crit = 3.0 * np.sqrt(3.0) * mass
    alpha_phys = np.arcsin(b_crit * np.sqrt(f) / R0)
    tan_cam = f * np.tan(alpha_phys)
    return tan_cam * PLANE_D / PLANE_W * SIZE


def schwarzschild_shadow_error(steps=19_968, delta=0.01, omega=1.0,
                               backend="auto", dtype=torch.float32,
                               device="cuda"):
    """{'px_err': max |boundary - analytic| in 256^2 pixels, 'bracket_px',
    'rho_num': per azimuth, 'rho_analytic'} for the equatorial
    Schwarzschild path at `dtype` (`integrate_dispatch`: kernel B1 for
    float32 and B2 for float64 CUDA rays, the eager paths for CPU rays)."""
    obs = torch.tensor([R0, 0.0, 0.0], dtype=dtype, device=device)

    def escape(rhos):
        pix = torch.as_tensor(_pixel_positions(rhos, PSIS[:, None]),
                              dtype=dtype, device=device)
        q0, p0, *_ = initial_conditions(obs, pix, mass_bh=1.0)
        _, _, status, _ = integrate_dispatch(
            q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous(),
            steps, delta, 2.0, BOUNDARY, omega, backend=backend,
            equatorial=True)
        return status.reshape(rhos.shape).cpu().numpy() == STATUS_ESCAPED

    rho_num, bracket = bisect_boundary(escape, 15.0, 32.0)
    rho_ana = schwarzschild_analytic_rho()
    return {
        "px_err": float(np.abs(rho_num - rho_ana).max()),
        "bracket_px": round(bracket, 4),
        "rho_num": [round(float(r), 3) for r in rho_num],
        "rho_analytic": round(float(rho_ana), 3),
    }


def bardeen_escapes(rhos, spin, charge=0.0, psis=None):
    """Analytic escape predicate for camera rays at the given pixel radii:
    each ray's conserved (xi, eta) = (L_z/E, Q/E^2) follows from its
    initial covector (the port's Cartesian camera, float64 on the host);
    the backward ray escapes iff the Bardeen radial potential has a real
    root in (r_+, r0) (quartic roots with numpy)."""
    if psis is None:
        psis = PSIS
    pix = torch.as_tensor(_pixel_positions(rhos, np.asarray(psis)[:, None]))
    _, p0, _ = cartesian_ics_from_pixels(
        torch.tensor([R0, 0.0, 0.0], dtype=torch.float64), pix,
        params=(1.0, spin, charge), g_inv_fn=kerr_schild_g_inv)
    p0 = p0.numpy()
    E = -p0[..., 0]
    L = R0 * p0[..., 2]                      # x p_y - y p_x at (R0, 0, 0)
    r_bl_obs = np.sqrt(R0 ** 2 - spin ** 2)  # spheroidal radius at z = 0
    p_th = -r_bl_obs * p0[..., 3]            # dz/dtheta = -r at the equator
    xi = L / E
    eta = (p_th / E) ** 2

    r_plus = 1.0 + np.sqrt(max(1.0 - spin ** 2 - charge ** 2, 0.0))
    out = np.zeros(xi.shape, dtype=bool)
    for idx in np.ndindex(xi.shape):
        c = (xi[idx] - spin) ** 2 + eta[idx]
        p1 = np.poly1d([1.0, 0.0, spin ** 2 - spin * xi[idx]]) ** 2
        p2 = np.poly1d([1.0, -2.0, spin ** 2 + charge ** 2]) * c
        roots = (p1 - p2).roots
        real = roots[np.abs(roots.imag) < 1e-9].real
        out[idx] = bool(((real > r_plus + 1e-9) & (real < r_bl_obs)).any())
    return out


def kerr_shadow_errors(spin=0.9, charge=0.0, steps=8_000, delta=0.02,
                       order=4, backend="auto", dtype=torch.float32,
                       device="cuda"):
    """{'px_err': per-azimuth |boundary - Bardeen| in 256^2 pixels, ...}
    for the float32 Kerr-Schild path (+ the Bardeen rescue): kernel B5 for
    CUDA rays, the eager twin for CPU rays (`integrate_dispatch_ks`)."""
    params = (1.0, spin, charge)
    obs = torch.tensor([R0, 0.0, 0.0], dtype=dtype, device=device)

    def escape(rhos):
        pix = torch.as_tensor(_pixel_positions(rhos, PSIS[:, None]),
                              dtype=dtype, device=device)
        q0, p0, _ = cartesian_ics_from_pixels(obs, pix, params=params,
                                              g_inv_fn=kerr_schild_g_inv)
        _, _, status, _ = integrate_dispatch_ks(
            q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous(),
            steps, delta, params, BOUNDARY, 1.0, order=order,
            backend=backend)
        return status.reshape(rhos.shape).cpu().numpy() == STATUS_ESCAPED

    rho_ana, _ = bisect_boundary(
        lambda r: bardeen_escapes(r, spin, charge), 10.0, 34.0, rounds=4)
    rho_num, br_n = bisect_boundary(escape, 10.0, 34.0, rounds=3, k=9)
    err = np.abs(rho_num - rho_ana)
    return {
        "spin": spin,
        "charge": charge,
        "px_err": [round(float(e), 4) for e in err],
        "px_err_max": float(err.max()),
        "bracket_px": round(br_n, 4),
        "rho_num": [round(float(r), 3) for r in rho_num],
        "rho_bardeen": [round(float(r), 3) for r in rho_ana],
    }


def _bitwise_equal(a, b):
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.view(ints), b.view(ints)))


def _max_abs_err(pairs):
    return max(float((a - b).abs().nan_to_num(float("inf")).max())
               if a.numel() else 0.0 for a, b in pairs)


def compare_outputs(kern, twin):
    """Mismatch counts of a kernel's (q, p, status, n_steps) against its
    twin's: q and p compared bit for bit, status and n_steps exactly.
    With the disk mode's (hit_q, hit_p) appended to both, also the hit
    flag (status == STATUS_DISK) exactly and hit_q and hit_p bit for bit;
    with the subring mode's (hits_q, hits_p, count), the count exactly and
    hits_q and hits_p bit for bit in every slot, filled or not.
    max_abs_err covers every floating-point output compared."""
    (qk, pk, sk, nk), (qt, pt, st, nt) = kern[:4], twin[:4]
    res = {"status_mismatch": int((sk != st).sum()),
           "n_steps_mismatch": int((nk != nt).sum()),
           "q_bitwise_equal": _bitwise_equal(qk, qt),
           "p_bitwise_equal": _bitwise_equal(pk, pt)}
    pairs = [(qk, qt), (pk, pt)]
    if len(kern) == 6:
        hqk, hpk, hqt, hpt = kern[4], kern[5], twin[4], twin[5]
        res.update(hit_mismatch=int(((sk == STATUS_DISK)
                                     != (st == STATUS_DISK)).sum()),
                   hit_q_bitwise_equal=_bitwise_equal(hqk, hqt),
                   hit_p_bitwise_equal=_bitwise_equal(hpk, hpt))
        pairs += [(hqk, hqt), (hpk, hpt)]
    elif len(kern) == 7:
        (hqk, hpk, ck), (hqt, hpt, ct) = kern[4:], twin[4:]
        res.update(count_mismatch=int((ck != ct).sum()),
                   hits_q_bitwise_equal=_bitwise_equal(hqk, hqt),
                   hits_p_bitwise_equal=_bitwise_equal(hpk, hpt))
        pairs += [(hqk, hqt), (hpk, hpt)]
    res["max_abs_err"] = _max_abs_err(pairs)
    return res


def timed(fn, device):
    """(result, milliseconds) of one call: CUDA events on a CUDA device,
    the host clock elsewhere."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chunk_parity(kernel, twin, state, steps, delta, rs, r_max, omega,
                 order=2):
    """A checkpoint chunk kernel (B3's `advance_state_cuda`, B4's
    `advance_state_eqc_cuda`) against its eager twin (`checkpoint.
    _advance_fused`, `_advance_eqc`) on the same carry.

    Returns (the kernel's (state, n_steps_applied), the mismatch counts:
    the state rows bit for bit, the steps applied exactly, and the domain
    status of row 1 (captured r <= 1.1 rs, escaped r >= r_max, else alive)
    exactly; plus the kernel+wrapper and twin times in ms).
    """
    args = (state, steps, delta, rs, r_max, omega)
    (sk, nk), kernel_ms = timed(lambda: kernel(*args, order=order),
                                state.device)
    (st, nt), twin_ms = timed(lambda: twin(*args, order=order), state.device)

    def domain(s):
        r = s[1]
        return torch.where(r >= r_max, 2, torch.where(r <= 1.1 * rs, 1, 0))

    res = {"status_mismatch": int((domain(sk) != domain(st)).sum()),
           "n_steps_mismatch": int((nk != nt).sum()),
           "state_bitwise_equal": _bitwise_equal(sk, st),
           "max_abs_err": _max_abs_err([(sk, st)]),
           "kernel_ms": kernel_ms, "twin_ms": twin_ms}
    return (sk, nk), res


def ks_kernel_parity(q0, p0, steps, delta, params, r_max=BOUNDARY,
                     omega=1.0, order=2, compensated=True, disk=None,
                     subrings=None):
    """Kernel B5 (`integrate_batch_ks_cuda`, 32 rows or, with
    compensated=False, 16 rows) against its eager twin
    (`integrate_batch_ksc` / `integrate_batch_ks`) on the same (N, 4) rays;
    with disk=(r_in, r_out), kernel B6 (`integrate_batch_disk_cuda`)
    against `integrate_batch_disk_ksc` / `integrate_batch_disk_ks`; with
    subrings=n_orders, kernel B7 (`integrate_batch_subrings_cuda`) against
    `integrate_batch_subrings_ksc` / `integrate_batch_subrings_ks`.

    Returns (the kernel's outputs, `compare_outputs`'s counts plus the
    kernel+wrapper and twin times in ms).  The kernel's wrapper raises for
    CPU rays: nothing falls back to the twin.
    """
    args, kw = (steps, delta, params, r_max, omega), {"order": order}
    if disk is not None:
        args += tuple(disk)
        twin = (integrate_batch_disk_ksc if compensated
                else integrate_batch_disk_ks)
        kernel = integrate_ks_cuda.integrate_batch_disk_cuda
    elif subrings is not None:
        kw["n_orders"] = subrings
        twin = (integrate_batch_subrings_ksc if compensated
                else integrate_batch_subrings_ks)
        kernel = integrate_ks_cuda.integrate_batch_subrings_cuda
    else:
        twin = integrate_batch_ksc if compensated else integrate_batch_ks
        kernel = integrate_ks_cuda.integrate_batch_ks_cuda
    kern, kernel_ms = timed(lambda: kernel(
        q0, p0, *args, compensated=compensated, **kw), q0.device)
    ref, twin_ms = timed(lambda: twin(q0, p0, *args, **kw), q0.device)
    res = compare_outputs(kern, ref)
    res.update(kernel_ms=kernel_ms, twin_ms=twin_ms)
    return kern, res


def traj_parity(q0s, p0s, steps, delta, rs, r_max, omega, n_keep=None,
                order=2, reps=3):
    """Kernel S1, through `integrate_batch_full_cuda` (the entry that the
    render's sampler and the drivers call), against its eager twin
    `integrate_batch_full` on the same CUDA rays; every timed call's
    record is held against the twin.

    Returns (the first call's (traj, ns), a dict: traj_bitwise_equal over
    every slot of every call (+0.0 past each exit included), max_abs_err,
    the rays' longest and summed step counts, the calls' times (median
    and each, CUDA events) and the twin's time (one call), in ms)."""
    from .integrate import integrate_batch_full, traj_layout
    from .integrate_cuda import integrate_batch_full_cuda
    args = (steps, delta, rs, r_max, omega)
    runs = [timed(lambda: integrate_batch_full_cuda(
        q0s, p0s, *args, n_keep=n_keep, order=order, return_steps=True),
        q0s.device) for _ in range(reps)]
    twin, twin_ms = timed(lambda: integrate_batch_full(
        q0s, p0s, *args, n_keep=n_keep, order=order), q0s.device)
    return runs[0][0], _traj_report(runs, twin, twin_ms,
                                    traj_layout(steps, n_keep))


def _traj_report(runs, twin, twin_ms, layout):
    """The comparison dict of a recorder's timed runs [((traj, ns), ms)]
    against its twin's record."""
    (traj, ns), _ = runs[0]
    times = [ms for _, ms in runs]
    return {"traj_bitwise_equal": all(_bitwise_equal(t, twin)
                                      for (t, _), _ in runs),
            "max_abs_err": _max_abs_err([(t, twin) for (t, _), _ in runs]),
            "rays": traj.shape[0], "n_keep": layout[1], "stride": layout[0],
            "n_steps_max": int(ns.max()) if ns.numel() else 0,
            "n_steps_sum": int(ns.long().sum()),
            "kernel_ms": float(np.median(times)), "kernel_ms_all": times,
            "twin_ms": twin_ms}


def gen_kernel_parity(q0, p0, steps, delta, params, r_max=BOUNDARY,
                      omega=1.0, order=2, metric="Kerr"):
    """Kernel G1 (`integrate_batch_generic_cuda`; G1s for a static
    `metric`) against its eager twin (`integrate_batch_generic(metric=
    ...)`) on the same (N, 4) CUDA rays.  Returns (the kernel's outputs,
    `compare_outputs`'s counts plus the kernel+wrapper and twin times in
    ms)."""
    from .integrate_generic import integrate_batch_generic
    from .integrate_generic_cuda import integrate_batch_generic_cuda
    args = (steps, delta, params, r_max, omega)
    kern, kernel_ms = timed(lambda: integrate_batch_generic_cuda(
        q0, p0, *args, order=order, metric=metric), q0.device)
    ref, twin_ms = timed(lambda: integrate_batch_generic(
        q0, p0, *args, order=order, metric=metric), q0.device)
    res = compare_outputs(kern, ref)
    res.update(kernel_ms=kernel_ms, twin_ms=twin_ms)
    return kern, res


def disk_static_parity(q0, p0, c1, c2, steps, delta, params, r_max, omega,
                       r_in, r_out, metric, order=2):
    """Kernel D1 (`integrate_dispatch_disk_static` on CUDA rays) against
    its eager twin (`integrate_batch_disk_static`) on the same rays and
    plane constants.  Returns (the kernel's outputs, `compare_outputs`'s
    counts with the hit rows, plus the kernel+wrapper and twin times in
    ms)."""
    from .disk_static import (integrate_batch_disk_static,
                              integrate_dispatch_disk_static)
    args = (q0, p0, c1, c2, steps, delta, params, r_max, omega, r_in, r_out)
    kern, kernel_ms = timed(lambda: integrate_dispatch_disk_static(
        *args, order=order, metric=metric), q0.device)
    ref, twin_ms = timed(lambda: integrate_batch_disk_static(
        *args, order=order, metric=metric), q0.device)
    res = compare_outputs(kern, ref)
    res.update(kernel_ms=kernel_ms, twin_ms=twin_ms)
    return kern, res


def disk_rotating_parity(q0, p0, steps, delta, params, r_max, omega, r_in,
                         r_out, metric, order=2):
    """Kernel D2 (`integrate_dispatch_disk_rotating` on CUDA rays) against
    its eager twin (`integrate_batch_disk_rotating`) on the same rays.
    Returns (the kernel's outputs, `compare_outputs`'s counts with the hit
    rows, plus the kernel+wrapper and twin times in ms)."""
    from .integrate_generic import (integrate_batch_disk_rotating,
                                    integrate_dispatch_disk_rotating)
    args = (q0, p0, steps, delta, params, r_max, omega, r_in, r_out)
    kern, kernel_ms = timed(lambda: integrate_dispatch_disk_rotating(
        *args, order=order, metric=metric), q0.device)
    ref, twin_ms = timed(lambda: integrate_batch_disk_rotating(
        *args, order=order, metric=metric), q0.device)
    res = compare_outputs(kern, ref)
    res.update(kernel_ms=kernel_ms, twin_ms=twin_ms)
    return kern, res


def disk_kds_parity(q0, p0, steps, delta, params, r_max, omega, r_in,
                    r_out, order=2):
    """Kernel D3 (`disk_kds.integrate_dispatch_disk_kds` on CUDA rays)
    against its eager twin (`disk_kds.integrate_batch_disk_kds`) on the
    same rays.  Returns (the kernel's outputs, `compare_outputs`'s counts
    with the hit rows, plus the kernel+wrapper and twin times in ms)."""
    from .disk_kds import (integrate_batch_disk_kds,
                           integrate_dispatch_disk_kds)
    args = (q0, p0, steps, delta, params, r_max, omega, r_in, r_out)
    kern, kernel_ms = timed(lambda: integrate_dispatch_disk_kds(
        *args, order=order), q0.device)
    ref, twin_ms = timed(lambda: integrate_batch_disk_kds(
        *args, order=order), q0.device)
    res = compare_outputs(kern, ref)
    res.update(kernel_ms=kernel_ms, twin_ms=twin_ms)
    return kern, res


def gen_traj_parity(q0s, p0s, steps, delta, params, r_max, omega,
                    metric="Kerr", n_keep=1000, order=2, reps=3):
    """Kernel S2, through `trajectory_batch_decimated_cuda` (the entry the
    render's sampler calls), against its eager twin
    `trajectory_batch_decimated` on the same CUDA rays, in `metric`'s
    chart; every timed call's record is held against the twin.  Returns
    (the first call's (traj, ns), the dict of `traj_parity`)."""
    from .integrate import traj_layout
    from .integrate_generic import trajectory_batch_decimated
    from .integrate_generic_cuda import trajectory_batch_decimated_cuda
    args = (steps, delta, params, r_max, omega)
    kw = {"order": order, "metric": metric, "n_keep": n_keep}
    runs = [timed(lambda: trajectory_batch_decimated_cuda(
        q0s, p0s, *args, return_steps=True, **kw), q0s.device)
        for _ in range(reps)]
    twin, twin_ms = timed(lambda: trajectory_batch_decimated(
        q0s, p0s, *args, **kw), q0s.device)
    return runs[0][0], _traj_report(runs, twin, twin_ms,
                                    traj_layout(steps, n_keep))
