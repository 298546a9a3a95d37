"""Kerr-Schild step machinery and the eager twins of kernel B5 — the torch
counterpart of `grtrace.engine.integrate_ks`.

The CUDA kernel (csrc/fantasy_ks.cu, wrapped by engine/integrate_ks_cuda.py)
and the twins here compute the same thing from the same host-built scalar
vector (`ks_params`): the staggered composed step, the in-loop
null-invariant blow-up guard, the parking and the sign-encoded park flag
of `make_ks_step`.  The twins define what the kernel computes; the kernel
matches them bit for bit on the card.

    integrate_batch_ksc   32-row Kahan-compensated layout (float32 rays)
    integrate_batch_ks    16-row plain layout (float64 rays; JAX runs it
                          only as integrate_batch_pallas_ks(compensated=
                          False), which has no XLA twin)

Both return (final_q, final_p, status, n_steps) after the exact Bardeen
rescue (`apply_bardeen_rescue`), which runs in plain torch after the
integration and is shared by the kernel path.  Status codes are those of
engine/integrate.py, plus STATUS_DISK.

The disk mode (kernel B6, `integrate_batch_pallas_disk` in JAX) adds the
first-equatorial-crossing recorder of `make_ks_step(disk=...)`:

    integrate_batch_disk_ksc   32 rows (float32 rays)
    integrate_batch_disk_ks    16 rows (float64 rays)

which return (final_q, final_p, status, n_steps, hit_q, hit_p).  Its
tangent mode (kernel B6t) carries K = 1 or 2 forward-mode directions
beside the 16 rows (`make_ks_step(tangent=...)`, the flows' tangents of
physics/kerr_schild.py, each direction a leading axis of its rows):

    integrate_batch_disk_tangent_ks   16 rows (float32 or float64 rays)

which returns the six and the crossing's tangents (hit_q_d, hit_p_d, each
(K, N, 4)); engine/sensitivity.py linearizes the line profile through it
in both parameters at once.

The subring mode (kernel B7, `integrate_batch_pallas_subrings` in JAX)
counts every equatorial-plane crossing and records the first n_orders
(`make_ks_step(subrings=...)`); no ray freezes:

    integrate_batch_subrings_ksc   32 rows (float32 rays; JAX's XLA twin
                                   is `integrate_batch_subrings_ksc`)
    integrate_batch_subrings_ks    16 rows (float64 rays; JAX runs it only
                                   as integrate_batch_pallas_subrings(
                                   compensated=False))

which return (final_q, final_p, status, n_steps, hits_q (n_orders, N, 4),
hits_p, count (N,) int32).

The Boyer-Lindquist chart's predicate and rescue (`bardeen_escape_pred_bl`,
`apply_bardeen_rescue_bl`), which the generic engine applies to kernel
G1's output and its twin's (engine/integrate_generic.py), live here beside
the Kerr-Schild ones, as in JAX.
"""
from __future__ import annotations

import torch

from ..physics.hamiltonian import bridge_sizes, pack_state, substep_schedule
from ..physics.kerr_schild import (close_ks, close_ksc, core_ks, core_ks_tan,
                                   core_ksc, hamiltonian_ks, ks_radius_c,
                                   open_ks, open_ks_tan, open_ksc,
                                   pack_state_ksc, unpack_ksc)
from ..physics.spacetime import horizon_radius
from .integrate import (_EXIT_CHECK, STATUS_ALIVE, STATUS_CAPTURED,
                        STATUS_ESCAPED, _in_dtype, resolve_backend)

# extends the STATUS_* codes of engine/integrate.py: the ray hit the disk
STATUS_DISK = 3

# [mass, a, charge, r_cap, r_max, plunge_zone] lead the scalar vector; then
# (d_j, cw_j, sw_j, bridge_j) per substep of the staggered schedule
N_SCAL = 6


def ks_scene_scalars(params, dtype):
    """(mass, a, charge, r_cap, plunge_zone) as Python floats, computed once
    on the host in `dtype` from params = (M, a[, Q]).

    r_cap: the thin 1.05 r_+ capture shell (backward rays freeze toward
    the past horizon in any future chart).  plunge_zone: the outer edge of
    the photon region, r_ph- = 2M(1 + cos((2/3) arccos(|a|/M))) (Bardeen
    1973), the guard's captured-vs-numerical arbiter."""
    p = torch.as_tensor(params, dtype=dtype).cpu()
    mass, a = p[0], p[1]
    charge = p[2] if p.numel() > 2 else torch.zeros((), dtype=dtype)
    r_cap = 1.05 * horizon_radius("Kerr", mass, a, charge)
    plunge_zone = 2.0 * mass * (1.0 + torch.cos(
        (2.0 / 3.0) * torch.arccos(torch.abs(a) / mass)))
    return tuple(float(x) for x in (mass, a, charge, r_cap, plunge_zone))


def ks_substeps(delta, omega, order, compensated=False, dtype=torch.float32):
    """Per-substep (d_j, cw_j, sw_j, bridge_j) of the staggered schedule as
    Python floats exact in `dtype`: cw is cos(2 omega d) for the plain
    flows and one-minus-cos, 2 sin^2(omega d), for the compensated ones."""
    subs = substep_schedule(delta, omega, order, omc=compensated, dtype=dtype)
    bridges = bridge_sizes([s[0] for s in subs], dtype=dtype)
    return tuple(s + (br,) for s, br in zip(subs, bridges))


def ks_params(delta, params, r_max, omega, order, compensated=False,
              dtype=torch.float32, disk=None):
    """The KS integration's scalars as one CPU tensor in `dtype`:
    [mass, a, charge, r_cap, r_max, plunge_zone, (d, cw, sw, bridge) x
    n_sub], then [r_in, r_out] when disk=(r_in, r_out) — the layout of the
    TPU kernel's SMEM vector (`integrate_batch_pallas_ks`,
    `integrate_batch_pallas_disk`).  The CUDA kernel and the twins both
    read this vector, so a host/device difference in sin or sqrt cannot
    enter between them."""
    mass, a, charge, r_cap, plunge_zone = ks_scene_scalars(params, dtype)
    scal = [mass, a, charge, r_cap, _in_dtype(r_max, dtype), plunge_zone]
    for sub in ks_substeps(delta, omega, order, compensated, dtype):
        scal += list(sub)
    if disk is not None:
        scal += [_in_dtype(r, dtype) for r in disk]
    return torch.tensor(scal, dtype=dtype)


def n_substeps(vec):
    """Substeps in a ks_params vector (with or without the disk pair)."""
    return (vec.numel() - N_SCAL) // 4


def split_params(vec):
    """ks_params vector -> (mass, a, charge, r_cap, r_max, plunge_zone),
    substeps, all Python floats (a trailing disk pair is left out; see
    `disk_annulus`)."""
    p = vec.tolist()
    subs = tuple(tuple(p[N_SCAL + 4 * j:N_SCAL + 4 * j + 4])
                 for j in range(n_substeps(vec)))
    return tuple(p[:N_SCAL]), subs


def disk_annulus(vec):
    """(r_in, r_out) of a disk-mode ks_params vector, Python floats."""
    tail = vec.tolist()[N_SCAL + 4 * n_substeps(vec):]
    if len(tail) != 2:
        raise ValueError("not a disk-mode ks_params vector")
    return tuple(tail)


def make_ks_step(subs, mass, a, charge, r_cap, r_max, plunge_zone,
                 compensated=False, disk=None, subrings=None, *,
                 dtype=torch.float32, tangent=None):
    """(active, masked_step, open_fn, close_fn) for one KS integration.

    active(comps) -> bool mask; masked_step(comps, ns) -> (comps, ns)
    applies one full staggered composed step to the active rays, with the
    null-invariant blow-up guard and parking; open_fn/close_fn are the
    staggered boundary half-A flows (the caller masks them by the
    initially active set).  Scalars are Python floats exact in `dtype`.

    disk=(r_in, r_out) swaps masked_step for kernel B6's disk-crossing
    variant masked_step(comps, ns, hit, hq, hp) -> the same five: a ray
    whose q1 z row changes sign within a step, at a lerped Boyer-Lindquist
    radius inside [r_in, r_out], freezes with hit = True and the crossing
    recorded in hq (q1 rows) and hp (p2 rows: like q1, they hold the exact
    step-boundary values in the staggered state).  The caller's early-exit
    test becomes active(comps) & ~hit.

    subrings=n_orders swaps it for kernel B7's subring variant
    masked_step(comps, ns, cnt, slots) -> the same four: every plane
    crossing of an accepted step is counted in cnt (int32), and the first
    n_orders are lerped as in disk mode and stored in slots (n_orders, 8,
    N): slot s holds the q1 rows then the p2 rows of crossing s.  No ray
    freezes, so the early-exit test stays active(comps).

    disk with tangent=(d mass, d a, d charge) (16 rows; each a (K, 1)
    tensor, one row a direction) is kernel B6t's step: masked_step(comps,
    ns, hit, hq, hp, tan, hq_d, hp_d) returns the five and (tan, hq_d,
    hp_d): the flows carry the tangent rows `tan` ((K, N) each, the
    primal rows broadcast against them, so that each direction's rows are
    bitwise those of a run on it alone), which revert with their rows on
    a park (the parked coordinates' tangents are zero), and a new hit
    records the crossing's tangents in hq_d and hp_d, the lerp fraction
    differentiated.
    """
    core = core_ksc if compensated else core_ks
    open_raw = open_ksc if compensated else open_ks
    close_raw = close_ksc if compensated else close_ks
    # r_cap / 1.05 rounded in dtype, as the kernel divides it
    r_plus = float(torch.tensor(r_cap, dtype=dtype)
                   / torch.tensor(1.05, dtype=dtype))
    r_max2 = r_max * r_max  # exact in a Python float; rounds once on use

    def open_fn(comps, d0):
        return open_raw(comps, d0, mass, a, charge)

    def close_fn(comps, d0):
        return close_raw(comps, d0, mass, a, charge)

    def active(comps):
        r_bl = ks_radius_c(comps[1], comps[2], comps[3], a)
        rho2 = comps[1] * comps[1] + comps[2] * comps[2] + comps[3] * comps[3]
        return (r_bl > r_cap) & (rho2 < r_max2)

    def _act(comps, frozen=None):
        r_old = ks_radius_c(comps[1], comps[2], comps[3], a)
        rho2 = (comps[1] * comps[1] + comps[2] * comps[2]
                + comps[3] * comps[3])
        act = (r_old > r_cap) & (rho2 < r_max2)
        if frozen is not None:
            act = act & ~frozen
        return act, r_old

    def _guard(comps, new, ns, act, r_old):
        """The step's guard and park: (out, ns_new, ok, park)."""
        # null-invariant blow-up guard, on the (q1, p2) rows, which hold
        # the exact plain-composition boundary values in the staggered
        # state; finiteness of all 16 rows through one aggregate sum; the
        # |h| test in negated-<= form so a NaN Hamiltonian trips it
        agg = new[0]
        for i in range(1, 16):
            agg = agg + new[i]
        finite = torch.isfinite(agg)
        h = hamiltonian_ks(new[1], new[2], new[3], new[12], new[13],
                           new[14], new[15], mass, a, charge)
        p2n = new[13] * new[13] + new[14] * new[14] \
            + new[15] * new[15] + 1.0
        exploded = ~(finite & (torch.abs(h) <= 3e-2 * p2n))
        r_new = ks_radius_c(new[1], new[2], new[3], a)
        crossed = finite & (r_new < r_plus) & ~exploded
        # pre-step radial heading, p1 copy
        inward = (comps[1] * comps[5] + comps[2] * comps[6]
                  + comps[3] * comps[7]) < 0.0
        capture = crossed | (exploded & (inward | (r_old < plunge_zone)))
        bad = exploded | crossed
        # bad rays keep their old values except the parked q1 coordinates:
        # captured -> on-axis (0, 0, 0.5 r_cap); numerical -> (150, 0, 0)
        ok = act & ~bad
        park = act & bad
        out = [torch.where(ok, n, o) for n, o in zip(new, comps)]
        zero = torch.zeros_like(out[1])
        park_x = torch.where(capture, zero, zero + 150.0)
        park_z = torch.where(capture, zero + 0.5 * r_cap, zero)
        out[1] = torch.where(park, park_x, out[1])
        out[2] = torch.where(park, zero, out[2])
        out[3] = torch.where(park, park_z, out[3])
        if compensated:
            # parked coordinates are fresh exact values: zero their deficits
            for row in (17, 18, 19):
                out[row] = torch.where(park, zero, out[row])
        # the park flag rides in the SIGN of the step counter
        ns_new = ns + act.to(torch.int32)
        ns_new = torch.where(park, -ns_new, ns_new)
        return tuple(out), ns_new, ok, park

    def _advance(comps, ns):
        act, r_old = _act(comps)
        new = comps
        for d_j, cw_j, sw_j, bridge_j in subs:
            new = core(new, d_j, mass, a, cw_j, sw_j, bridge_j, charge)
        out, ns_new, ok, _ = _guard(comps, new, ns, act, r_old)
        return out, ns_new, new, ok

    def masked_step(comps, ns):
        out, ns_new, _, _ = _advance(comps, ns)
        return out, ns_new

    if disk is None and subrings is None:
        return active, masked_step, open_fn, close_fn

    # crossing reads fold the Kahan deficits (true = s - c)
    def best(state, i):
        return state[i] - state[16 + i] if compensated else state[i]

    def crossing(comps, new, ok):
        """(crossed, t): an accepted step whose folded q1 z changes sign,
        and its lerp fraction (0 elsewhere)."""
        z0, z1 = best(comps, 3), best(new, 3)
        crossed = ok & (z0 * z1 < 0.0)
        return crossed, torch.where(crossed, z0 / (z0 - z1), 0.0)

    def lerp(comps, new, t, rows):
        return tuple(best(comps, i) + t * (best(new, i) - best(comps, i))
                     for i in rows)

    if subrings is not None:
        n_orders = int(subrings)

        def masked_step_subrings(comps, ns, cnt, slots):
            out, ns_new, new, ok = _advance(comps, ns)
            # every crossing counts; the one that finds slot cnt free (cnt
            # before this crossing, cnt < n_orders) lands there
            crossed, t = crossing(comps, new, ok)
            event = torch.stack(lerp(comps, new, t, (0, 1, 2, 3,
                                                     12, 13, 14, 15)))
            orders = torch.arange(n_orders, dtype=cnt.dtype,
                                  device=cnt.device)
            take = crossed & (cnt == orders[:, None])
            slots = torch.where(take[:, None, :], event, slots)
            return out, ns_new, cnt + crossed.to(cnt.dtype), slots

        return active, masked_step_subrings, open_fn, close_fn

    r_in, r_out = disk
    sc, sc_d = (mass, a, charge), tangent

    def masked_step_disk(comps, ns, hit, hq, hp, tan=None, hq_d=None,
                         hp_d=None):
        act, r_old = _act(comps, frozen=hit)
        new, new_d = comps, tan
        for d_j, cw_j, sw_j, bridge_j in subs:
            if tan is None:
                new = core(new, d_j, mass, a, cw_j, sw_j, bridge_j, charge)
            else:
                new, new_d = core_ks_tan(new, new_d, d_j, cw_j, sw_j,
                                         bridge_j, sc, sc_d)
        out, ns_new, ok, park = _guard(comps, new, ns, act, r_old)
        # the first equatorial crossing inside the annulus, lerped within
        # the step on the (q1, p2) rows; ok excludes guard-parked rays
        crossed, t = crossing(comps, new, ok)
        rows = (0, 1, 2, 3, 12, 13, 14, 15)
        cross = lerp(comps, new, t, rows)
        r_hit = ks_radius_c(cross[1], cross[2], cross[3], a)
        new_hit = crossed & (r_hit >= r_in) & (r_hit <= r_out)

        def keep(c, h):
            return tuple(torch.where(new_hit, x, y) for x, y in zip(c, h))
        step = (out, ns_new, hit | new_hit, keep(cross[:4], hq),
                keep(cross[4:], hp))
        if tan is None:
            return step
        # the tangent rows revert with their rows; the parked coordinates
        # are constants
        out_d = [torch.where(ok, n, o) for n, o in zip(new_d, tan)]
        for row in (1, 2, 3):
            out_d[row] = torch.where(park, torch.zeros_like(out_d[row]),
                                     out_d[row])
        t_d = torch.where(crossed, (tan[3] - t * (tan[3] - new_d[3]))
                          / (comps[3] - new[3]), 0.0)
        cross_d = tuple(tan[i] + (t_d * (new[i] - comps[i])
                                  + t * (new_d[i] - tan[i]))
                        for i in rows)
        return step + (tuple(out_d), keep(cross_d[:4], hq_d),
                       keep(cross_d[4:], hp_d))

    return active, masked_step_disk, open_fn, close_fn


def _scalar_tensors(like, *xs):
    """Numbers -> 0-dim tensors of `like`'s dtype and device (the JAX
    rescue computes with traced scalars of the ray dtype)."""
    return tuple(torch.as_tensor(x, dtype=like.dtype, device=like.device)
                 for x in xs)


def bardeen_escape_pred(q0s, p0s, mass, a, charge):
    """Closed-form capture/escape predicate per ray (Bardeen 1973), from
    the launch covector in the KS Cartesian chart.

    E = -p_t, L_z = x p_y - y p_x, p_theta from the oblate map, and Carter
    Q = p_theta^2 + cos^2 th (L^2/sin^2 th - a^2 E^2).  The backward ray
    escapes iff the radial potential R(r) = [E(r^2+a^2) - a L]^2
    - Delta(r) [(L - aE)^2 + Q] has a turning point in (r_+, r0), i.e.
    min R <= 0 there (`_bardeen_min_R`)."""
    mass, a, charge = _scalar_tensors(q0s, mass, a, charge)
    x, y, z = q0s[:, 1], q0s[:, 2], q0s[:, 3]
    E = -p0s[:, 0]
    L = x * p0s[:, 2] - y * p0s[:, 1]
    r0_bl = ks_radius_c(x, y, z, a)
    cos_th = z / r0_bl
    sin2 = torch.clamp(1.0 - cos_th * cos_th, min=1e-30)
    sin_th = torch.sqrt(sin2)
    p_th = (cos_th / sin_th) * (x * p0s[:, 1] + y * p0s[:, 2]) \
        - r0_bl * sin_th * p0s[:, 3]
    Q = p_th * p_th + cos_th * cos_th * (L * L / sin2 - a * a * E * E)
    return _bardeen_min_R(E, L, Q, r0_bl, mass, a, charge)


def bardeen_escape_pred_bl(q0s, p0s, mass, a, charge):
    """The Bardeen predicate from the launch covector in the
    Boyer-Lindquist chart: E = -p_t, L = p_phi and Carter
    Q = p_theta^2 + cos^2 th (L^2/sin^2 th - a^2 E^2) read off directly
    (the covector's overall sign cancels in R(r))."""
    mass, a, charge = _scalar_tensors(q0s, mass, a, charge)
    E = -p0s[:, 0]
    L = p0s[:, 3]
    th = q0s[:, 2]
    sin2 = torch.sin(th) ** 2
    cos2 = torch.cos(th) ** 2
    Q = p0s[:, 2] ** 2 + cos2 * (L * L / torch.clamp(sin2, min=1e-30)
                                 - a * a * E * E)
    return _bardeen_min_R(E, L, Q, q0s[:, 1], mass, a, charge)


def _unit_grid(num, dtype, device):
    """num points from 0 to 1 with the values jnp.linspace(0, 1, num)
    gives under XLA, which turns its i / (num - 1) into i * (1 / (num - 1))
    (torch.linspace rounds some points differently)."""
    step = float(torch.tensor(1.0, dtype=dtype)
                 / torch.tensor(num - 1.0, dtype=dtype))
    ts = torch.arange(num, dtype=dtype, device=device) * step
    ts[-1] = 1.0
    return ts


def _bardeen_min_R(E, L, Q, r0_bl, mass, a, charge):
    """Does R(r) have a turning point in (r_+, r0)?  A 64-point grid
    argmin (first minimum on ties) polished by 8 Newton steps on the
    depressed cubic R'."""
    c1 = (L - a * E) ** 2 + Q
    B = E * a * a - a * L
    aq = a * a + charge * charge
    r_plus = mass + torch.sqrt(torch.clamp(mass * mass - aq, min=0.0))

    E_, B_, c1_ = E[:, None], B[:, None], c1[:, None]
    lin = 4.0 * E_ * B_ - 2.0 * c1_

    def R(r):
        quad = E_ * r * r + B_
        delta = r * r - 2.0 * mass * r + aq
        return quad * quad - delta * c1_

    def dR(r):
        return 4.0 * E_ * E_ * r ** 3 + lin * r + 2.0 * mass * c1_

    def ddR(r):
        return 12.0 * E_ * E_ * r * r + lin

    lo = ((r_plus + 1e-3) + torch.zeros_like(r0_bl))[:, None]
    hi = r0_bl[:, None]
    grid = lo + (hi - lo) * _unit_grid(64, E.dtype, E.device)[None, :]
    Rg = R(grid)
    jmin = torch.argmin(Rg, dim=1)
    r_n = torch.gather(grid, 1, jmin[:, None])
    R_grid_min = torch.gather(Rg, 1, jmin[:, None])[:, 0]
    tiny = torch.full_like(r_n, 1e-30)
    for _ in range(8):
        dd = ddR(r_n)
        r_n = r_n - dR(r_n) / torch.where(torch.abs(dd) > 1e-30, dd, tiny)
        r_n = torch.clamp(r_n, lo, hi)
    R_min = torch.minimum(R_grid_min, R(r_n)[:, 0])
    return R_min <= 0.0


def ks_status(final_q, a, r_cap, r_max):
    """(N, 4) final positions -> status codes (every KS path)."""
    r_bl = ks_radius_c(final_q[:, 1], final_q[:, 2], final_q[:, 3], a)
    rho = torch.linalg.vector_norm(final_q[:, 1:], dim=1)
    alive = torch.full_like(r_bl, STATUS_ALIVE, dtype=torch.int32)
    return torch.where(r_bl <= r_cap, STATUS_CAPTURED,
                       torch.where(rho >= r_max, STATUS_ESCAPED, alive))


def apply_bardeen_rescue(final_q, final_p, n_steps_signed, q2_spatial,
                         q0s, p0s, mass, a, charge, r_cap, r_max, pred=None):
    """Reclassify guard-parked rays (n_steps_signed < 0) by the exact
    predicate (`pred`, by default `bardeen_escape_pred`; the rotating
    regular families pass theirs, which only its parked rays need):
    escape -> parked at 1.001 r_max along the last-resolved direction of
    the second copy (q2_spatial), ESCAPED; capture -> the on-axis capture
    point (0, 0, 0.5 r_cap), CAPTURED.  Unparked rays pass through.
    Returns (final_q, final_p, status, n_steps)."""
    dtype = final_q.dtype
    parked = n_steps_signed < 0
    n_steps = torch.abs(n_steps_signed)
    if pred is None:
        pred = bardeen_escape_pred(q0s, p0s, mass, a, charge)
    esc_r = parked & pred
    cap_r = parked & ~pred

    norm = torch.linalg.vector_norm(q2_spatial, dim=1, keepdim=True)
    # 1.001 r_max rounded as JAX rounds it, so the rescued radius stays
    # >= r_max after rounding
    r_esc = float(torch.tensor(1.001, dtype=dtype)
                  * torch.tensor(r_max, dtype=dtype))
    esc_pos = q2_spatial / torch.clamp(norm, min=1e-30) * r_esc
    zero = torch.zeros_like(final_q[:, 0])
    cap_pos = torch.stack([zero, zero, zero + 0.5 * r_cap], dim=1)
    new_sp = torch.where(esc_r[:, None], esc_pos,
                         torch.where(cap_r[:, None], cap_pos,
                                     final_q[:, 1:]))
    final_q = torch.cat([final_q[:, :1], new_sp], dim=1)
    return final_q, final_p, ks_status(final_q, a, r_cap, r_max), n_steps


def apply_bardeen_rescue_bl(final_q, final_p, n_steps_signed, q2, q0s, p0s,
                            mass, a, charge, r_cap, r_max, pred=None):
    """The Boyer-Lindquist chart's rescue of guard-parked rays
    (n_steps_signed < 0), by the exact predicate (`pred`, by default
    `bardeen_escape_pred_bl`): escape -> radius 1.001 r_max along the
    last-resolved direction (theta, phi of the reverted second copy q2),
    capture -> radius 0.99 r_cap; then the status from the radius.
    Returns (final_q, final_p, status, n_steps)."""
    r_cap, r_max = _scalar_tensors(final_q, r_cap, r_max)
    parked = n_steps_signed < 0
    n_steps = torch.abs(n_steps_signed)
    if pred is None:
        pred = bardeen_escape_pred_bl(q0s, p0s, mass, a, charge)
    esc_r = parked & pred
    cap_r = parked & ~pred
    r_out = torch.where(esc_r, 1.001 * r_max,
                        torch.where(cap_r, 0.99 * r_cap, final_q[:, 1]))
    th_out = torch.where(esc_r, q2[:, 2], final_q[:, 2])
    ph_out = torch.where(esc_r, q2[:, 3], final_q[:, 3])
    final_q = torch.stack([final_q[:, 0], r_out, th_out, ph_out], dim=1)
    alive = torch.full_like(n_steps, STATUS_ALIVE)
    status = torch.where(r_out <= r_cap, STATUS_CAPTURED,
                         torch.where(r_out >= r_max, STATUS_ESCAPED, alive))
    return final_q, final_p, status, n_steps


def finish_ks(state, ns_signed, q0s, p0s, vec, compensated):
    """Shared read-out of the KS integrators (kernel and twins): fold the
    deficits (true = s - c), then the Bardeen rescue from the launch
    state."""
    (mass, a, charge, r_cap, r_max, _), _ = split_params(vec)
    best = unpack_ksc(state) if compensated else tuple(state[:16])
    final_q = torch.stack(best[0:4], dim=-1)
    final_p = torch.stack(best[4:8], dim=-1)
    q2_spatial = torch.stack(best[9:12], dim=-1)
    return apply_bardeen_rescue(final_q, final_p, ns_signed, q2_spatial,
                                q0s, p0s, mass, a, charge, r_cap, r_max)


def finish_disk(state, ns_signed, disk_rows, q0s, p0s, vec, compensated):
    """Read-out of the disk integrators (kernel B6 and its twins):
    `finish_ks`, then STATUS_DISK for the hit rays.  disk_rows are the 9
    recorder rows in the ray dtype: the hit flag (1.0 / 0.0), hit_q,
    hit_p.  Returns (final_q, final_p, status, n_steps, hit_q, hit_p)."""
    final_q, final_p, status, n_steps = finish_ks(state, ns_signed, q0s, p0s,
                                                  vec, compensated)
    hit = disk_rows[0] > 0.5
    status = torch.where(hit, STATUS_DISK, status)
    hit_q = torch.stack(tuple(disk_rows[1:5]), dim=-1)
    hit_p = torch.stack(tuple(disk_rows[5:9]), dim=-1)
    return final_q, final_p, status, n_steps, hit_q, hit_p


def finish_subrings(state, ns_signed, count, slot_rows, q0s, p0s, vec,
                    compensated):
    """Read-out of the subring integrators (kernel B7 and its twins):
    `finish_ks`, then the slots.  slot_rows (8 n_orders, N) in the ray
    dtype hold crossing s's q1 rows in 8 s .. 8 s + 3 and its p2 rows in
    8 s + 4 .. 8 s + 7; count (N,) int32.  Returns (final_q, final_p,
    status, n_steps, hits_q (n_orders, N, 4), hits_p, count)."""
    final_q, final_p, status, n_steps = finish_ks(state, ns_signed, q0s, p0s,
                                                  vec, compensated)
    slots = slot_rows.reshape(-1, 8, slot_rows.shape[-1]).transpose(1, 2)
    return (final_q, final_p, status, n_steps, slots[..., :4].contiguous(),
            slots[..., 4:].contiguous(), count)


def _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega, order,
                    compensated, disk=None, n_orders=None):
    dtype = q0s.dtype
    vec = ks_params(delta, params, r_max, omega, order, compensated, dtype,
                    disk=disk)
    (mass, a, charge, r_cap, r_max, plunge_zone), subs = split_params(vec)
    active, masked_step, open_fn, close_fn = make_ks_step(
        subs, mass, a, charge, r_cap, r_max, plunge_zone,
        compensated=compensated,
        disk=None if disk is None else disk_annulus(vec), subrings=n_orders,
        dtype=dtype)
    d0 = subs[0][0]

    pack = pack_state_ksc if compensated else pack_state
    state = pack(q0s, p0s)
    n, device = q0s.shape[0], q0s.device
    ns = torch.zeros((n,), dtype=torch.int32, device=device)
    if disk is not None:  # the recorder: hit flag, hit_q, hit_p
        hit = torch.zeros((n,), dtype=torch.bool, device=device)
        hq = hp = (torch.zeros_like(q0s[:, 0]),) * 4
    if n_orders is not None:  # crossing count and zero-filled slots
        cnt = torch.zeros((n,), dtype=torch.int32, device=device)
        slots = torch.zeros((n_orders, 8, n), dtype=dtype, device=device)
    act0 = active(state)
    if steps > 0:  # steps == 0 must be an exact no-op (matches the kernel)
        opened = open_fn(state, d0)
        state = tuple(torch.where(act0, o, s) for o, s in zip(opened, state))

    # masked steps on inactive (or, in disk mode, hit) rays are exact
    # no-ops, so checking for an early exit only every _EXIT_CHECK steps
    # changes nothing
    for k in range(steps):
        if k % _EXIT_CHECK == 0:
            live = active(state) if disk is None else active(state) & ~hit
            if not bool(live.any()):
                break
        if disk is not None:
            state, ns, hit, hq, hp = masked_step(state, ns, hit, hq, hp)
        elif n_orders is not None:
            state, ns, cnt, slots = masked_step(state, ns, cnt, slots)
        else:
            state, ns = masked_step(state, ns)

    # undo the pending half-A for every opened ray; no park exclusion: the
    # park points are regular chart points and flow A cannot move q1
    # (hit rays too: the recorded crossing, not the final state, shades
    # them)
    if steps > 0:
        closed = close_fn(state, d0)
        state = tuple(torch.where(act0, c, s) for c, s in zip(closed, state))
    if disk is not None:
        rows = (hit.to(dtype),) + tuple(hq) + tuple(hp)
        return finish_disk(state, ns, rows, q0s, p0s, vec, compensated)
    if n_orders is not None:
        return finish_subrings(state, ns, cnt, slots.reshape(8 * n_orders, n),
                               q0s, p0s, vec, compensated)
    return finish_ks(state, ns, q0s, p0s, vec, compensated)


def integrate_batch_ksc(q0s, p0s, steps, delta, params, r_max, omega,
                        order=2):
    """Eager twin of the 32-row compensated kernel (float32 production
    layout).  params = (M, a[, Q]); returns (final_q, final_p, status,
    n_steps)."""
    return _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega,
                           order, compensated=True)


def integrate_batch_ks(q0s, p0s, steps, delta, params, r_max, omega,
                       order=2):
    """Eager twin of the 16-row plain kernel (the float64 layout): the
    loop of integrate_batch_ksc on the uncompensated flows."""
    return _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega,
                           order, compensated=False)


def integrate_batch_disk_ksc(q0s, p0s, steps, delta, params, r_max, omega,
                             r_in, r_out, order=2):
    """Eager twin of kernel B6 in the 32-row compensated layout (float32
    production): the plain loop with the disk recorder, early exit on
    active & ~hit.  Returns (final_q, final_p, status, n_steps, hit_q,
    hit_p) with STATUS_DISK rays frozen at their first equatorial crossing
    inside [r_in, r_out]; rays that never hit carry zero hit rows, as the
    TPU kernel writes them."""
    return _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega,
                           order, compensated=True, disk=(r_in, r_out))


def integrate_batch_disk_ks(q0s, p0s, steps, delta, params, r_max, omega,
                            r_in, r_out, order=2):
    """Eager twin of kernel B6 in the 16-row plain layout (float64 rays):
    integrate_batch_disk_ksc on the uncompensated flows."""
    return _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega,
                           order, compensated=False, disk=(r_in, r_out))


def ks_tangent_params(dparams, dtype=torch.float32):
    """The tangents of the scalar vector, one direction a row: (K, 3) [d
    mass, d a, d charge] as a CPU tensor in `dtype` (dparams = K rows of
    (dM, da[, dQ])).  The substep scalars, r_cap, r_max, plunge_zone and
    the annulus carry no tangent: they are step constants or the
    thresholds of discrete tests."""
    d = torch.as_tensor(dparams, dtype=torch.float64)
    d = d.reshape(-1, d.shape[-1])
    pad = torch.zeros((d.shape[0], 3 - d.shape[1]), dtype=torch.float64)
    return torch.cat([d, pad], dim=1).to(dtype)


def integrate_batch_disk_tangent_ks(q0s, p0s, dq0s, dp0s, steps, delta,
                                    params, dparams, r_max, omega, r_in,
                                    r_out, order=2):
    """Eager twin of kernel B6t, the forward-mode tangent mode of B6 in the
    16-row plain layout: `integrate_batch_disk_ks` carrying K tangent
    directions (dq0s, dp0s (K, N, 4); dparams K rows of (dM, da[, dQ]))
    beside its rows (`make_ks_step(tangent=...)`).

    The flows' tangents are `kerr_schild.core_ks_tan`'s; the guard, the
    capture test and the annulus test are discrete and carry none (a parked
    ray's tangent is reverted with its rows, its parked coordinates' set to
    zero); the crossing's lerp fraction t = z0 / (z0 - z1) is
    differentiated, t_d = (z0_d - t (z0_d - z1_d)) / (z0 - z1), and so is
    each lerp, b_old_d + (t_d (b_new - b_old) + t (b_new_d - b_old_d)).
    The primal rows are B6's 16-row twin's, bit for bit.

    Returns B6's six outputs and the tangents of the crossing, (final_q,
    final_p, status, n_steps, hit_q, hit_p, hit_q_d, hit_p_d), the last
    two (K, N, 4); rays that never hit carry zero tangent rows, as zero
    hit rows.  Each direction's tangents are bitwise those of a call on
    it alone: the tangent expressions are elementwise."""
    dtype = q0s.dtype
    vec = ks_params(delta, params, r_max, omega, order, False, dtype,
                    disk=(r_in, r_out))
    (mass, a, charge, r_cap, r_max, plunge_zone), subs = split_params(vec)
    dvec = ks_tangent_params(dparams, dtype).to(q0s.device)
    if dq0s.dim() != 3 or dvec.shape[0] != dq0s.shape[0]:
        raise ValueError("the tangents must be (K, N, 4) with K rows of "
                         "dparams")
    sc_d = tuple(dvec[:, j:j + 1] for j in range(3))
    active, masked_step, _, close_fn = make_ks_step(
        subs, mass, a, charge, r_cap, r_max, plunge_zone,
        disk=disk_annulus(vec), dtype=dtype, tangent=sc_d)
    d0 = subs[0][0]

    state, tan = pack_state(q0s, p0s), pack_state(dq0s, dp0s)
    n, device = q0s.shape[0], q0s.device
    ns = torch.zeros((n,), dtype=torch.int32, device=device)
    hit = torch.zeros((n,), dtype=torch.bool, device=device)
    hq = hp = (torch.zeros_like(q0s[:, 0]),) * 4
    hq_d = hp_d = (torch.zeros_like(dq0s[..., 0]),) * 4
    act0 = active(state)
    if steps > 0:
        opened, opened_d = open_ks_tan(state, tan, d0, (mass, a, charge),
                                       sc_d)
        state = tuple(torch.where(act0, o, s) for o, s in zip(opened, state))
        tan = tuple(torch.where(act0, o, s) for o, s in zip(opened_d, tan))
    for k in range(steps):
        if k % _EXIT_CHECK == 0 and not bool((active(state) & ~hit).any()):
            break
        state, ns, hit, hq, hp, tan, hq_d, hp_d = masked_step(
            state, ns, hit, hq, hp, tan, hq_d, hp_d)
    if steps > 0:  # the closing half-A of the primal rows, as B6's
        closed = close_fn(state, d0)
        state = tuple(torch.where(act0, c, s) for c, s in zip(closed, state))
    rows = (hit.to(dtype),) + tuple(hq) + tuple(hp)
    out = finish_disk(state, ns, rows, q0s, p0s, vec, False)
    return out + (torch.stack(hq_d, dim=-1), torch.stack(hp_d, dim=-1))


def integrate_dispatch_disk_tangent(q0s, p0s, dq0s, dp0s, steps, delta,
                                   params, dparams, r_max, omega, r_in, r_out,
                                   order=2, backend="auto"):
    """Backend-dispatching tangent disk integrate: CUDA rays go to kernel
    B6t (16 rows, float32 or float64), CPU rays to its twin
    `integrate_batch_disk_tangent_ks`; backend='torch' picks the twin on
    any device; an unknown backend or device raises.  Never falls back.
    Returns (final_q, final_p, status, n_steps, hit_q, hit_p, hit_q_d,
    hit_p_d)."""
    if q0s.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"KS rays must be float32 or float64 "
                         f"(got {q0s.dtype})")
    kind = q0s.device.type
    if backend == "auto" and kind not in ("cpu", "cuda"):
        raise ValueError(f"no tangent disk integrator for {kind!r} tensors "
                         f"(CUDA runs kernel B6t, the CPU its eager twin)")
    backend = resolve_backend(backend, q0s.device)
    if backend == "cuda":
        from .integrate_ks_cuda import integrate_batch_disk_tangent_cuda
        return integrate_batch_disk_tangent_cuda(
            q0s, p0s, dq0s, dp0s, steps, delta, params, dparams, r_max,
            omega, r_in, r_out, order=order)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected 'auto', 'cuda' or 'torch')")
    return integrate_batch_disk_tangent_ks(q0s, p0s, dq0s, dp0s, steps, delta,
                                           params, dparams, r_max, omega,
                                           r_in, r_out, order=order)


def _check_orders(n_orders):
    """n_orders as an int >= 1 (JAX's `subrings or None` would silently
    run the plain mode for 0)."""
    if int(n_orders) != n_orders or n_orders < 1:
        raise ValueError(f"n_orders must be an integer >= 1 (got {n_orders})")
    return int(n_orders)


def integrate_batch_subrings_ksc(q0s, p0s, steps, delta, params, r_max,
                                 omega, n_orders=3, order=2):
    """Eager twin of kernel B7 in the 32-row compensated layout (float32
    production; JAX's `integrate_batch_subrings_ksc`): the plain loop with
    the subring recorder, early exit on the plain active test.  Returns
    (final_q, final_p, status, n_steps, hits_q (n_orders, N, 4), hits_p,
    count (N,) int32); count totals every crossing, hits hold the first
    n_orders, and unfilled slots are zero, as the TPU kernel writes them."""
    return _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega,
                           order, compensated=True,
                           n_orders=_check_orders(n_orders))


def integrate_batch_subrings_ks(q0s, p0s, steps, delta, params, r_max,
                                omega, n_orders=3, order=2):
    """Eager twin of kernel B7 in the 16-row plain layout (float64 rays):
    integrate_batch_subrings_ksc on the uncompensated flows."""
    return _integrate_twin(q0s, p0s, steps, delta, params, r_max, omega,
                           order, compensated=False,
                           n_orders=_check_orders(n_orders))


def select_path_ks(backend, device, dtype):
    """Which KS integrator `integrate_dispatch_ks` runs:
    ('kernel' | 'twin', compensated).  float32 rays take the 32-row
    compensated layout and float64 rays the 16-row plain one; CUDA tensors
    go to the kernel and CPU tensors to the twins, and backend='torch'
    picks the twin on any device.  Never falls back."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"KS rays must be float32 or float64 (got {dtype})")
    compensated = dtype == torch.float32
    backend = resolve_backend(backend, device)
    if backend == "cuda":
        return "kernel", compensated
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected 'auto', 'cuda' or 'torch')")
    return "twin", compensated


def integrate_dispatch_ks(q0s, p0s, steps, delta, params, r_max, omega,
                          order=2, backend="auto"):
    """Backend-dispatching KS integrate, one contract for every path."""
    path, compensated = select_path_ks(backend, q0s.device, q0s.dtype)
    if path == "kernel":
        from .integrate_ks_cuda import integrate_batch_ks_cuda
        return integrate_batch_ks_cuda(q0s, p0s, steps, delta, params, r_max,
                                       omega, order=order,
                                       compensated=compensated)
    twin = integrate_batch_ksc if compensated else integrate_batch_ks
    return twin(q0s, p0s, steps, delta, params, r_max, omega, order=order)


def integrate_dispatch_disk(q0s, p0s, steps, delta, params, r_max, omega,
                            r_in, r_out, order=2, backend="auto",
                            plain=False):
    """Backend-dispatching disk integrate: CUDA float32 rays go to kernel
    B6's 32-row layout, CUDA float64 rays to its 16-row one, CPU rays to
    the matching twin; backend='torch' picks the twin on any device.
    plain=True takes the 16-row layout for float32 rays too (the layout
    that engine/sensitivity.py differentiates, B6t's primal).  Never falls
    back.  Returns (final_q, final_p, status, n_steps, hit_q, hit_p)."""
    path, compensated = select_path_ks(backend, q0s.device, q0s.dtype)
    compensated = compensated and not plain
    if path == "kernel":
        from .integrate_ks_cuda import integrate_batch_disk_cuda
        return integrate_batch_disk_cuda(q0s, p0s, steps, delta, params,
                                         r_max, omega, r_in, r_out,
                                         order=order,
                                         compensated=compensated)
    twin = integrate_batch_disk_ksc if compensated else integrate_batch_disk_ks
    return twin(q0s, p0s, steps, delta, params, r_max, omega, r_in, r_out,
                order=order)


def integrate_dispatch_subrings(q0s, p0s, steps, delta, params, r_max, omega,
                                n_orders=3, order=2, backend="auto"):
    """Backend-dispatching subring integrate: CUDA float32 rays go to kernel
    B7's 32-row layout, CUDA float64 rays to its 16-row one, CPU rays to
    the matching twin; backend='torch' picks the twin on any device.
    Never falls back.  Returns (final_q, final_p, status, n_steps, hits_q,
    hits_p, count)."""
    n_orders = _check_orders(n_orders)
    path, compensated = select_path_ks(backend, q0s.device, q0s.dtype)
    if path == "kernel":
        from .integrate_ks_cuda import integrate_batch_subrings_cuda
        return integrate_batch_subrings_cuda(q0s, p0s, steps, delta, params,
                                             r_max, omega, n_orders=n_orders,
                                             order=order,
                                             compensated=compensated)
    twin = (integrate_batch_subrings_ksc if compensated
            else integrate_batch_subrings_ks)
    return twin(q0s, p0s, steps, delta, params, r_max, omega,
                n_orders=n_orders, order=order)
