"""The generic engine for the Kerr(-Newman) charts, the static beyond-Kerr
families, the rotating regular families and Kerr-de Sitter — the torch
counterpart of `grtrace.engine.integrate_generic`, and the eager twins of
the CUDA kernels G1, S2, T2, their static-chart modes G1s, S2s, T2s, their
mass-function Kerr-Schild modes G1r, S2r, T2r and D2, and their Carter-chart
modes G1d, S2d, T2d (csrc/fantasy_gen.cu, wrapped by
engine/integrate_generic_cuda.py; D3's twin is engine/disk_kds.py's).

JAX runs this engine as a masked `lax.while_loop` (or `scan`) over
`vmap`ped `jax.grad` flows.  The port keeps its semantics and takes the
flows in closed form: physics/kerr_bl.py in the Boyer-Lindquist chart
(metric 'Kerr'), physics/kerr_schild.py's unstaggered flows in the
Kerr-Schild chart (metric 'KerrSchild'), physics/static_chart.py in the
static chart (metrics 'Kottler', 'Bardeen', 'Hayward', with the spherical
guard and no rescue), physics/rotating_chart.py in the mass-function
Kerr-Schild chart (metrics 'RotatingBardeen', 'RotatingHayward', with the
invariant guard and the rescue by `rotating_regular.escape_pred_rotating`),
physics/kds_chart.py in Kerr-de Sitter's Carter chart (metric 'KerrDS',
with the spherical guard and the rescue by
`kerr_de_sitter.kds_escape_pred`).
Every composed step is the
unstaggered A(d/2) B(d/2) M B(d/2) A(d/2) per substep of
`spacetime.make_step`, followed by the chart's blow-up guard.

    integrate_batch_generic     metric 'Kerr': the eager twin of G1, then
                                the exact Boyer-Lindquist rescue; the
                                static families: the twin of G1s; the
                                rotating families: the twin of G1r, then
                                the rescue; 'KerrDS': the twin of G1d,
                                then the rescue; metric 'KerrSchild': the
                                Kerr-Schild integrators (kernel B5's twins,
                                integrate_dispatch_ks)
    trajectory_batch_decimated  every chart: the eager twin of S2 (S2s), q1
                                recorded every `stride` steps
    trajectory_generic          metric 'Kerr', a static or a rotating
                                family, 'KerrDS': one ray's (q1, p1) after
                                every step, no exit (the EinsteinPy
                                semantics); its loop
                                trajectory_generic_unmasked is the eager
                                twin of T2 (T2s, T2r, T2d)
    integrate_batch_disk_rotating  the rotating families' disk: the twin of
                                D2 (G1r's loop and the first z crossing
                                inside the annulus), then the rescue;
                                its loop integrate_disk_spin_twin is also
                                D3's (G1d's loop, cos theta), which
                                engine/disk_kds.py drives

`integrate_dispatch_generic`, `trajectory_dispatch_generic`,
`trajectory_generic` and `integrate_dispatch_disk_rotating` send CUDA rays
to the kernels (B5 for the Kerr-Schild frame) and CPU rays to the twins;
the samplers and the disk raise for any other device.  A kernel and its twin read the same
host-built scalar vector (`gen_params`), so they round alike.
"""
from __future__ import annotations

import math

import torch

from ..physics import (kds_chart, kerr_bl, kerr_schild, rotating_chart,
                       static_chart)
from ..physics.hamiltonian import _flow_mixed, pack_state, substep_schedule
from ..physics.kerr_de_sitter import kds_capture_radius, kds_escape_pred
from ..physics.kerr_schild import _flow_b_ks, hamiltonian_ks, ks_radius_c
from ..physics.rotating_regular import (MASS_FN, escape_pred_rotating,
                                        rotating_capture_radius)
from ..physics.spacetime import COORDS, horizon_radius
from ..physics.static_metrics import STATIC_F, static_capture_radius
from .integrate import STATUS_ALIVE, STATUS_CAPTURED, STATUS_ESCAPED
from .integrate import _EXIT_CHECK, resolve_backend, traj_layout
from .integrate_ks import (STATUS_DISK, apply_bardeen_rescue,
                           apply_bardeen_rescue_bl, integrate_dispatch_ks)

# [mass, a, charge, r_cap, r_max, r_plus, plunge_zone, jump_cap, cap_park,
# err_park] lead the scalar vector; then (d_j, cos_j, sin_j) per substep
N_SCAL = 10
# the charts the engine integrates, by metric
CHARTS = ("Kerr", "KerrSchild", "Kottler", "Bardeen", "Hayward",
          "RotatingBardeen", "RotatingHayward", "KerrDS")


def _capture_radius(metric, params):
    """The capture surface, in params' dtype: 1.1 r_+ in the spherical
    charts (Boyer-Lindquist goes stiff as Delta -> 0, so one stops short),
    1.05 r_+ in the Kerr-Schild chart (regular at r_+, but backward rays
    freeze toward the past horizon).  params = (M, a[, Q]) or (M,) for
    Schwarzschild; for the static families (M, p[, 0]), whose capture
    radius is 1.1 x the bisected outer horizon or the horizonless 1e-2 M
    floor (`static_capture_radius`, a float64 tensor); for the rotating
    regular families (M, a, p), 1.05 x theirs or the same floor
    (`rotating_capture_radius`); for Kerr-de Sitter (M, a, Lambda), 1.1 x
    the bisected outer horizon or the floor (`kds_capture_radius`), as a
    float64 tensor of the params' dtype's value."""
    params = torch.as_tensor(params)
    if metric in STATIC_F:
        return static_capture_radius(metric, params[:2])
    if metric in MASS_FN:
        return rotating_capture_radius(metric, params)
    if metric == "KerrDS":
        return kds_capture_radius(params)
    charge = params[2] if len(params) > 2 else params[0] * 0.0
    if metric == "KerrSchild":
        return 1.05 * horizon_radius("Kerr", params[0], params[1], charge)
    if metric == "Kerr":
        return 1.1 * horizon_radius("Kerr", params[0], params[1], charge)
    COORDS[metric]  # a KeyError for an unknown metric
    if metric == "Schwarzschild":
        return 1.1 * horizon_radius("Schwarzschild", params[0])
    raise KeyError(metric)


def _check_metric(metric):
    if metric not in CHARTS:
        raise NotImplementedError(
            f"the generic engine of grtrace_torch integrates the Kerr-Newman "
            f"charts, the static and the rotating regular families and "
            f"Kerr-de Sitter {CHARTS} (got {metric!r}); "
            f"Schwarzschild rays take engine.integrate")


def gen_params(metric, delta, params, r_max, omega, order, dtype):
    """The engine's scalars as one CPU tensor in `dtype`:
    [M, a, Q, r_cap, r_max, r_plus, plunge_zone, jump_cap, cap_park,
    err_park, (d, cos, sin) x n_sub], each rounded as the JAX engine rounds
    it (`_domain_tools`):
      r_cap      the capture radius (`_capture_radius`);
      r_plus     r_cap / 1.1 (Boyer-Lindquist) or / 1.05 (Kerr-Schild):
                 a step that ends inside it crossed the horizon;
      plunge_zone  where an exploded step counts as a capture: r_cap + M/2
                 (BL), the retrograde photon orbit 2M(1 + cos((2/3)
                 arccos(|a|/M))) (KS);
      jump_cap   the largest legitimate radius change of a step,
                 max(5, 20 delta) (BL; unused in KS);
      cap_park   the radius a captured ray parks at: 0.99 r_cap (BL), the
                 on-axis point's z = 0.5 r_cap (KS);
      err_park   the numerical-error park radius max(150, 2 r_max).
    The kernels and the twins read this vector, so a host/device
    difference in sqrt or arccos cannot enter between them.

    In the static chart params = (M, p[, 0]) and the vector's second and
    third slots hold the family's lapse constant k (Lambda / 3, g^2 or
    2 M l^2, rounded to `dtype`; physics/static_chart.py) and its code
    (static_chart.FAMILY_CODE); r_cap comes from the bisection of the
    dtype-rounded (M, p), then is rounded to `dtype`.

    In the mass-function Kerr-Schild chart params = (M, a, p): the third
    slot holds the family's constant k (g^2 or 2 M l^2, rounded to
    `dtype`: rotating_chart.family_constant) and the jump_cap slot, which
    the Kerr-Schild guard never reads, the family code
    (rotating_chart.FAMILY_CODE); r_cap as in the static chart, with the
    1.05 shell.

    In the Carter chart of Kerr-de Sitter params = (M, a, Lambda): the
    third slot holds L = Lambda / 3 rounded to `dtype` (the kernel forms
    chi^2 = (1 + L a^2)^2 from it); r_cap is 1.1 x the bisected horizon in
    the dtype-rounded params, rounded to `dtype`; the rest is the
    Boyer-Lindquist chart's."""
    _check_metric(metric)
    p = torch.as_tensor(params, dtype=dtype).cpu()
    mass, a = p[0], p[1]
    charge = p[2] if p.numel() > 2 else torch.zeros((), dtype=dtype)
    r_cap = _capture_radius(metric, torch.stack([mass, a, charge]))
    if metric in STATIC_F:
        r_cap = r_cap.to(dtype)
        a, charge = static_constants(metric, mass, a)
    rotating = metric in MASS_FN
    if rotating:
        r_cap = r_cap.to(dtype)
        charge = rotating_chart.family_constant(metric, mass, charge)
    if metric == "KerrDS":
        r_cap = r_cap.to(dtype)
        charge = charge / torch.tensor(3.0, dtype=dtype)
    r_max_t = torch.tensor(r_max, dtype=dtype)
    if metric == "KerrSchild" or rotating:
        r_plus = r_cap / torch.tensor(1.05, dtype=dtype)
        plunge_zone = 2.0 * mass * (1.0 + torch.cos(
            (2.0 / 3.0) * torch.arccos(torch.abs(a) / mass)))
        cap_park = 0.5 * r_cap
    else:
        r_plus = r_cap / torch.tensor(1.1, dtype=dtype)
        plunge_zone = r_cap + 0.5 * mass
        cap_park = 0.99 * r_cap
    jump_cap = torch.maximum(torch.tensor(5.0, dtype=dtype),
                             20.0 * torch.tensor(delta, dtype=dtype))
    err_park = torch.maximum(torch.tensor(150.0, dtype=dtype),
                             2.0 * r_max_t)
    if rotating:
        jump_cap = torch.tensor(float(rotating_chart.FAMILY_CODE[metric]),
                                dtype=dtype)
    scal = [float(x) for x in (mass, a, charge, r_cap, r_max_t, r_plus,
                               plunge_zone, jump_cap, cap_park, err_park)]
    for sub in substep_schedule(delta, omega, order, dtype=dtype):
        scal += list(sub)
    return torch.tensor(scal, dtype=dtype)


def static_constants(metric, mass, param):
    """(k, family code) of a static family in the dtype of `mass` (0-dim
    tensors): k = Lambda / 3 (Kottler), g^2 (Bardeen), 2 M l^2 (Hayward),
    each operation rounded in that dtype, as the kernel's would be."""
    code = static_chart.FAMILY_CODE[metric]
    if code == static_chart.KOTTLER:
        k = param / torch.tensor(3.0, dtype=param.dtype)
    elif code == static_chart.BARDEEN:
        k = param * param
    else:
        k = 2.0 * mass * (param * param)
    return k, torch.tensor(float(code), dtype=param.dtype)


def split_params(vec):
    """gen_params vector -> (the N_SCAL scalars, substeps), all Python
    floats."""
    p = vec.tolist()
    return tuple(p[:N_SCAL]), tuple(tuple(p[N_SCAL + 3 * j:N_SCAL + 3 * j + 3])
                                    for j in range((len(p) - N_SCAL) // 3))


def make_composed_step(metric, vec):
    """(opening, composed) of the chart's unstaggered step from a
    gen_params vector: opening(state) -> flow A's kick/drift at the
    state's (q1, p2); composed(state, ka) -> (state, ka) after one composed
    step of every ray from the carry ka, with no guard (the loop of kernel
    T2; `make_generic_step` guards it)."""
    (mass, a, charge, _, _, _, _, code, _, _), subs = split_params(vec)
    if metric == "KerrSchild":
        kick_drift, n_kick, flow_b = kerr_schild._kick_drift, 3, _flow_b_ks
    elif metric in MASS_FN:
        # (mass, a, charge) carry (M, a, k); the family code rides jump_cap
        family, n_kick = int(code), 3

        def kick_drift(*args):
            return rotating_chart._kick_drift(*args, family)

        def flow_b(state, dt, mass, a, k):
            return rotating_chart.flow_b(state, dt, mass, a, k, family)
    elif metric in STATIC_F:
        # (mass, a, charge) carry (M, k, family code): static_constants
        kick_drift, n_kick = static_chart._kick_drift, 2
        flow_b = static_chart.flow_b
    elif metric == "KerrDS":
        # (mass, a, charge) carry (M, a, Lambda / 3); chi^2 once, as the
        # kernel forms it per ray
        n_kick = 2
        chi2 = kds_chart.chi_squared(charge, a, vec.dtype)

        def kick_drift(*args):
            return kds_chart._kick_drift(*args, chi2)

        def flow_b(state, dt, mass, a, lam3):
            return kds_chart.flow_b(state, dt, mass, a, lam3, chi2)
    else:
        kick_drift, n_kick, flow_b = kerr_bl._kick_drift, 2, kerr_bl.flow_b

    def opening(s):
        """Flow A's kick/drift: the metric at q1 with the momenta p2."""
        return kick_drift(*s[1:1 + n_kick], *s[12:16], mass, a, charge)

    def flow_a(s, ka, dt):
        """Flow A applied with its kick/drift ka: kick p1 (its n_kick
        spatial rows), drift q2 (all 4)."""
        s = list(s)
        for m in range(n_kick):
            s[5 + m] = s[5 + m] - dt * ka[m]
        for m in range(4):
            s[8 + m] = s[8 + m] + dt * ka[n_kick + m]
        return tuple(s)

    def composed(state, ka):
        # flow A reads q1 and p2 and writes neither, and nothing runs
        # between one flow A and the next: each takes the kick/drift the one
        # before it formed, and applies it with its own dt
        for d_j, cos_j, sin_j in subs:
            half = 0.5 * d_j
            state = flow_a(state, ka, half)
            state = flow_b(state, half, mass, a, charge)
            state = _flow_mixed(state, cos_j, sin_j)
            state = flow_b(state, half, mass, a, charge)
            ka = opening(state)
            state = flow_a(state, ka, half)
        return state, ka

    return opening, composed


def make_generic_step(metric, vec):
    """(active, opening, step) for one integration from a gen_params
    vector.

    active(state) -> the rays inside the domain before a step: r_cap < r <
    r_max (BL and the static chart), ks_radius > r_cap and |x| < r_max
    (the Kerr-Schild charts).  opening(state) ->
    flow A's kick/drift at the state's (q1, p2), the carry the first step
    takes.  step(state, ka) -> (bad, new state, ka): one composed step of
    every ray from the carry ka, then the chart's blow-up guard, which
    reverts the rays it flags (bad) to the pre-step state and parks their
    q1 (`grtrace.engine.integrate_generic._domain_tools`'s guard_spherical
    / guard_cartesian; the static chart takes the spherical one, the
    mass-function chart the Cartesian one with its own H); the carry
    it returns is flow A's at the new state's
    (q1, p2), except on the reverted rays, which the park leaves outside
    the domain for good."""
    (mass, a, charge, r_cap, r_max, r_plus, plunge_zone, jump_cap, cap_park,
     err_park), _ = split_params(vec)
    opening, composed = make_composed_step(metric, vec)
    if metric in MASS_FN:
        family = int(jump_cap)

        def ham(*args):
            return rotating_chart.hamiltonian(*args, mass, a, charge, family)
    else:
        def ham(*args):
            return hamiltonian_ks(*args, mass, a, charge)

    def finite_q1p1(new):
        finite = torch.isfinite(new[0])
        for i in range(1, 8):
            finite = finite & torch.isfinite(new[i])
        return finite

    def active_bl(s):
        return (s[1] > r_cap) & (s[1] < r_max)

    def active_ks(s):
        rho = torch.sqrt(s[1] * s[1] + s[2] * s[2] + s[3] * s[3])
        return (ks_radius_c(s[1], s[2], s[3], a) > r_cap) & (rho < r_max)

    def step_bl(old, ka):
        new, ka = composed(old, ka)
        r_b = old[1]
        finite = finite_q1p1(new)
        exploded = (~finite | (torch.abs(new[1] - r_b) > jump_cap)
                    | (torch.abs(new[2] - old[2]) > 1.5))
        crossed = finite & (new[1] < r_plus) & ~exploded
        inward = old[5] < 0.0
        capture = crossed | (exploded & (inward | (r_b < plunge_zone)))
        bad = exploded | crossed
        out = [torch.where(bad, o, n) for o, n in zip(old, new)]
        zero = torch.zeros_like(r_b)
        out[1] = torch.where(bad, torch.where(capture, zero + cap_park,
                                              zero + err_park), out[1])
        return bad, tuple(out), ka

    def step_ks(old, ka):
        new, ka = composed(old, ka)
        r_b = ks_radius_c(old[1], old[2], old[3], a)
        finite = finite_q1p1(new)
        x, y, z, pt, px, py, pz = (torch.where(finite, new[i], old[i])
                                   for i in range(1, 8))
        h = ham(x, y, z, pt, px, py, pz)
        p2n = px * px + py * py + pz * pz + 1.0
        exploded = ~finite | (torch.abs(h) > 3e-2 * p2n)
        crossed = finite & (ks_radius_c(x, y, z, a) < r_plus) & ~exploded
        inward = (old[1] * old[5] + old[2] * old[6] + old[3] * old[7]) < 0.0
        capture = crossed | (exploded & (inward | (r_b < plunge_zone)))
        bad = exploded | crossed
        out = [torch.where(bad, o, n) for o, n in zip(old, new)]
        # on-axis park points: (0, 0, cap_park) captured, (err_park, 0, 0)
        # numerical
        zero = torch.zeros_like(r_b)
        out[1] = torch.where(bad, torch.where(capture, zero, zero + err_park),
                             out[1])
        out[2] = torch.where(bad, zero, out[2])
        out[3] = torch.where(bad, torch.where(capture, zero + cap_park, zero),
                             out[3])
        return bad, tuple(out), ka

    if COORDS[metric] == "cartesian":
        return active_ks, opening, step_ks
    return active_bl, opening, step_bl


def integrate_generic_twin(q0s, p0s, steps, vec, metric="Kerr"):
    """The loop of kernel G1 (G1s for a static family, G1r for a rotating
    one) on (N, 4) rays from a gen_params vector: at most `steps`
    masked, guarded steps; a ray the guard parks freezes with its step
    count negated (-(n + 1)).  Returns (state, ns) before the read-out
    (the rescue, or `finish_generic_static`)."""
    # through the module's global, so that a caller may wrap the factory
    # (the step replayed from a CUDA graph, as chip_smoke.py does)
    active, opening, step = make_generic_step(metric, vec)
    state = pack_state(q0s, p0s)
    ka = opening(state)
    ns = torch.zeros(q0s.shape[:1], dtype=torch.int32, device=q0s.device)
    # masked steps on inactive rays are exact no-ops, so checking for an
    # early exit only every _EXIT_CHECK steps changes nothing; a ray that is
    # inactive (or parked) once stays so, so its carry is never read again
    for k in range(steps):
        act = active(state)
        if k % _EXIT_CHECK == 0 and not bool(act.any()):
            break
        bad, new, ka = step(state, ka)
        ns = ns + act.to(torch.int32)
        ns = torch.where(act & bad, -ns, ns)
        state = tuple(torch.where(act, n, o) for n, o in zip(new, state))
    return state, ns


def finish_generic_bl(state, ns, q0s, p0s, vec):
    """Read-out of G1 and its twin: the first copy's q and p, then the
    exact Boyer-Lindquist rescue with the reverted second copy's q2."""
    (mass, a, charge, r_cap, r_max, *_), _ = split_params(vec)
    return apply_bardeen_rescue_bl(
        torch.stack(state[0:4], dim=-1), torch.stack(state[4:8], dim=-1), ns,
        torch.stack(state[8:12], dim=-1), q0s, p0s, mass, a, charge, r_cap,
        r_max)


def finish_generic_static(state, ns, vec):
    """Read-out of G1s and its twin, JAX's for the static families (no
    rescue): (q1, p1, status, |ns|), captured where r <= r_cap, escaped
    where r >= r_max, alive otherwise."""
    (_, _, _, r_cap, r_max, *_), _ = split_params(vec)
    q1 = torch.stack(state[0:4], dim=-1)
    status = torch.where(
        q1[:, 1] <= r_cap, STATUS_CAPTURED,
        torch.where(q1[:, 1] >= r_max, STATUS_ESCAPED, STATUS_ALIVE))
    return q1, torch.stack(state[4:8], dim=-1), status, torch.abs(ns)


def parked_pred(escape_pred, q0s, p0s, parked):
    """escape_pred(q0s, p0s) of the (N,) parked rays, False on the rest:
    the rescue reads it on parked rays only, and the exact predicates
    (`escape_pred_rotating`, `kds_escape_pred`) are elementwise, so this
    gives JAX's booleans there at a fraction of the (N, 192) grid's memory
    and time."""
    pred = torch.zeros_like(parked)
    idx = torch.nonzero(parked)[:, 0]
    if idx.numel():
        pred[idx] = escape_pred(q0s[idx], p0s[idx])
    return pred


def finish_generic_rotating(state, ns, q0s, p0s, vec, metric, params):
    """Read-out of G1r and its twin, JAX's for the rotating families: the
    first copy's q and p, then `apply_bardeen_rescue` with the family's
    exact predicate (`escape_pred_rotating` of the parked launch rays,
    params = (M, a, p)) and the reverted second copy's q2."""
    (mass, a, _, r_cap, r_max, *_), _ = split_params(vec)
    q1 = torch.stack(state[0:4], dim=-1)
    pred = parked_pred(lambda q, p: escape_pred_rotating(metric, q, p,
                                                         params),
                       q0s, p0s, ns < 0)
    return apply_bardeen_rescue(
        q1, torch.stack(state[4:8], dim=-1), ns,
        torch.stack(state[9:12], dim=-1), q0s, p0s, mass, a, 0.0, r_cap,
        r_max, pred=pred)


def finish_generic_kds(state, ns, q0s, p0s, vec, params):
    """Read-out of G1d and its twin, JAX's for Kerr-de Sitter: the first
    copy's q and p, then `apply_bardeen_rescue_bl` with the exact
    predicate (`kds_escape_pred` of the parked launch rays, params = (M, a,
    Lambda)) and the reverted second copy's q2."""
    (mass, a, _, r_cap, r_max, *_), _ = split_params(vec)
    pred = parked_pred(lambda q, p: kds_escape_pred(q, p, params), q0s, p0s,
                       ns < 0)
    return apply_bardeen_rescue_bl(
        torch.stack(state[0:4], dim=-1), torch.stack(state[4:8], dim=-1), ns,
        torch.stack(state[8:12], dim=-1), q0s, p0s, mass, a, 0.0, r_cap,
        r_max, pred=pred)


def integrate_batch_generic(q0s, p0s, steps, delta, params, r_max, omega,
                            order=2, metric="Kerr"):
    """Integrate an (N, 4) batch in the named chart to completion:
    (final_q, final_p, status, n_steps), the status codes of
    engine/integrate.py.

    metric 'Kerr' (Boyer-Lindquist): the eager twin of kernel G1 and the
    exact rescue of its guard-parked rays.  metric 'KerrSchild': the
    Kerr-Schild integrators' twins (kernel B5's; JAX's Pallas route).
    The static families: the eager twin of kernel G1s, no rescue.  The
    rotating families: the eager twin of kernel G1r, then the rescue by
    their exact predicate; Kerr-de Sitter: the twin of G1d, then the
    Boyer-Lindquist rescue by its exact predicate.  params = (M, a[, Q]),
    (M, p[, 0]) for a static family, (M, a, p) for a rotating one, (M, a,
    Lambda) for Kerr-de Sitter."""
    _check_metric(metric)
    if metric == "KerrSchild":
        return integrate_dispatch_ks(q0s, p0s, steps, delta, params, r_max,
                                     omega, order=order, backend="torch")
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    if metric in STATIC_F:
        state, ns = integrate_generic_twin(q0s, p0s, steps, vec, metric)
        return finish_generic_static(state, ns, vec)
    if metric in MASS_FN:
        state, ns = integrate_generic_twin(q0s, p0s, steps, vec, metric)
        return finish_generic_rotating(state, ns, q0s, p0s, vec, metric,
                                       params)
    if metric == "KerrDS":
        state, ns = integrate_generic_twin(q0s, p0s, steps, vec, metric)
        return finish_generic_kds(state, ns, q0s, p0s, vec, params)
    state, ns = integrate_generic_twin(q0s, p0s, steps, vec)
    return finish_generic_bl(state, ns, q0s, p0s, vec)


def trajectory_generic_twin(q0s, p0s, steps, vec, metric, stride, n_keep):
    """The loop of kernel S2: (traj (N, n_keep, 4), ns (N,) int32).  At
    step k < steps, slot k / stride takes q1 when k % stride == 0 and the
    ray is still alive (+0.0 otherwise); a ray dies on the first step it
    is inactive, so the first position outside the domain is recorded
    when it falls on a slot.  Once no ray is alive, the remaining slots
    would all be zero, so the loop stops there.  (S2s and S2r in the
    static and mass-function charts.)"""
    active, opening, step = make_generic_step(metric, vec)
    n = q0s.shape[0]
    traj = torch.zeros((n, n_keep, 4), dtype=q0s.dtype, device=q0s.device)
    ns = torch.zeros((n,), dtype=torch.int32, device=q0s.device)
    state = pack_state(q0s, p0s)
    ka = opening(state)
    alive = torch.ones((n,), dtype=torch.bool, device=q0s.device)
    for k in range(steps):
        if k % _EXIT_CHECK == 0 and not bool(alive.any()):
            break
        act = active(state)
        if k % stride == 0:
            traj[:, k // stride, :] = torch.where(
                alive[:, None], torch.stack(state[0:4], dim=-1), 0.0)
        alive = alive & act
        _, new, ka = step(state, ka)
        ns = ns + act.to(torch.int32)
        state = tuple(torch.where(act, nw, o) for nw, o in zip(new, state))
    return traj, ns


def trajectory_batch_decimated(q0s, p0s, steps, delta, params, r_max, omega,
                               order=2, metric="Kerr", n_keep=1000):
    """(N, n_keep', 4) trajectories decimated to at most n_keep points: q1
    every `stride` steps (`engine.integrate.traj_layout`), rows after a
    ray's exit +0.0, the same guard as integrate_batch_generic (a parked
    ray freezes at its park point; no rescue).  The eager twin of kernel
    S2, in the Boyer-Lindquist chart (metric 'Kerr'), the Kerr-Schild one
    ('KerrSchild'), the static (S2s) or the mass-function chart (S2r)."""
    stride, n_keep_eff = traj_layout(steps, n_keep)
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    return trajectory_generic_twin(q0s, p0s, steps, vec, metric, stride,
                                   n_keep_eff)[0]


def integrate_dispatch_generic(q0s, p0s, steps, delta, params, r_max, omega,
                               order=2, metric="Kerr", backend="auto"):
    """integrate_batch_generic on the rays' device: in the Boyer-Lindquist
    chart CUDA rays go to kernel G1, in the static chart to G1s, in the
    mass-function chart to G1r, in the Carter chart to G1d, and CPU rays to
    their twins (the
    backend resolved as `integrate_dispatch_ks` resolves it, which takes
    the Kerr-Schild chart: B5 or its twins).  Never falls back."""
    _check_metric(metric)
    if metric == "KerrSchild":
        return integrate_dispatch_ks(q0s, p0s, steps, delta, params, r_max,
                                     omega, order=order, backend=backend)
    backend = resolve_backend(backend, q0s.device)
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected 'auto', 'cuda' or 'torch')")
    if backend == "cuda":
        from .integrate_generic_cuda import integrate_batch_generic_cuda
        return integrate_batch_generic_cuda(q0s, p0s, steps, delta, params,
                                            r_max, omega, order=order,
                                            metric=metric)
    return integrate_batch_generic(q0s, p0s, steps, delta, params, r_max,
                                   omega, order=order, metric=metric)


def trajectory_dispatch_generic(q0s, p0s, steps, delta, params, r_max, omega,
                                order=2, metric="Kerr", n_keep=1000):
    """trajectory_batch_decimated on the rays' device: CUDA rays go to
    kernel S2 (S2s, S2r, S2d in the static, mass-function and Carter
    charts), CPU rays
    to its twin; any other device raises (as
    `integrate.integrate_full_dispatch` routes S1).  Never falls back."""
    _check_metric(metric)
    kind = q0s.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no trajectory sampler for {kind!r} tensors "
                         f"(CUDA runs kernel S2, the CPU its eager twin)")
    if kind == "cuda":
        from .integrate_generic_cuda import trajectory_batch_decimated_cuda
        return trajectory_batch_decimated_cuda(
            q0s, p0s, steps, delta, params, r_max, omega, order=order,
            metric=metric, n_keep=n_keep)
    return trajectory_batch_decimated(q0s, p0s, steps, delta, params, r_max,
                                      omega, order=order, metric=metric,
                                      n_keep=n_keep)


def trajectory_generic_unmasked(q0s, p0s, steps, vec, metric="Kerr"):
    """The loop of kernel T2 (T2s for a static family, T2r for a rotating
    one, T2d for Kerr-de Sitter) on (N, 4) rays from a gen_params vector:
    (N, steps, 8), (q1, p1) after each of `steps` composed steps (flow A's
    kick/drift carried, as in G1), every step taken: no domain test, no
    guard, no park."""
    opening, composed = make_composed_step(metric, vec)
    out = torch.empty((q0s.shape[0], steps, 8), dtype=q0s.dtype,
                      device=q0s.device)
    state = pack_state(q0s, p0s)
    ka = opening(state)
    for k in range(steps):
        state, ka = composed(state, ka)
        out[:, k, :] = torch.stack(state[:8], dim=-1)
    return out


def trajectory_generic(q0, p0, steps, delta, params, omega, order=2,
                       metric="Kerr"):
    """Single-ray unmasked trajectory, JAX's signature: (qs (steps, 4), ps
    (steps, 4)), q and p after each step, with no early exit (EinsteinPy's
    `Nulllike` semantics, for the compat classes).  CUDA rays go to kernel
    T2 (`integrate_generic_cuda.trajectory_generic_unmasked_cuda`; T2s
    for a static family, T2r for a rotating one, T2d for Kerr-de Sitter),
    CPU rays to its twin `trajectory_generic_unmasked`; any other device
    raises.  The Boyer-Lindquist chart, metric 'Kerr' (the one JAX's
    compat classes pass), the static families 'Kottler', 'Bardeen',
    'Hayward' (params (M, p[, 0])), the rotating ones 'RotatingBardeen',
    'RotatingHayward' (params (M, a, p)) and 'KerrDS' (params (M, a,
    Lambda)); any other metric raises NotImplementedError.  JAX takes the
    flows by autodiff, the port in closed form (physics/kerr_bl.py,
    physics/static_chart.py, physics/rotating_chart.py,
    physics/kds_chart.py): they agree within 1e-12 relative an evaluation
    (ROADMAP Queue C)."""
    if (metric not in ("Kerr", "KerrDS") and metric not in STATIC_F
            and metric not in MASS_FN):
        raise NotImplementedError(
            f"trajectory_generic of grtrace_torch integrates the "
            f"Boyer-Lindquist chart 'Kerr' only, besides the static "
            f"families {tuple(STATIC_F)}, the rotating ones "
            f"{tuple(MASS_FN)} and 'KerrDS' (got {metric!r})")
    q0s, p0s = q0.reshape(1, 4).contiguous(), p0.reshape(1, 4).contiguous()
    vec = gen_params(metric, delta, params, math.inf, omega, order,
                     q0s.dtype)
    kind = q0s.device.type
    if kind == "cuda":
        from .integrate_generic_cuda import trajectory_generic_unmasked_cuda
        out = trajectory_generic_unmasked_cuda(q0s, p0s, steps, vec, metric)
    elif kind == "cpu":
        out = trajectory_generic_unmasked(q0s, p0s, steps, vec, metric)
    else:
        raise ValueError(f"no trace for {kind!r} tensors (CUDA runs kernel "
                         f"T2, the CPU its eager twin)")
    return out[0, :, :4], out[0, :, 4:]


# --- the spinning families' disks (kernels D2 and D3) ---------------------

def disk_spin_params(vec, r_in, r_out):
    """D2's and D3's scalar vector: the mass-function or the Carter chart's
    gen_params vector followed by r_in and r_out, rounded to its dtype."""
    tail = torch.tensor([float(r_in), float(r_out)], dtype=vec.dtype)
    return torch.cat([vec, tail])


def _disk_level_radius(metric, a):
    """The disk plane's level function of a chart state row set and the
    crossing's radius: z and the Kerr-Schild radius for a rotating family
    (D2), cos(theta) and r for 'KerrDS' (D3)."""
    if metric == "KerrDS":
        return (lambda q: torch.cos(q[2])), (lambda cq: cq[1])
    if metric in MASS_FN:
        return (lambda q: q[3]), (lambda cq: ks_radius_c(cq[1], cq[2], cq[3],
                                                         a))
    raise ValueError(f"the 20-row disk kernels integrate {tuple(MASS_FN)} "
                     f"and 'KerrDS' (got {metric!r})")


def integrate_disk_spin_twin(q0s, p0s, steps, vec, metric):
    """The loop of kernel D2 (a rotating family) or D3 ('KerrDS') on (N, 4)
    rays of its chart from its disk vector (`disk_spin_params`).  Per step,
    JAX's integrate_batch_disk (integrate_batch_disk_kds): the masked,
    guarded G1r (G1d) step of the rays that are active and not hit, then
    the sign test of the plane's level (z; cos theta) at the pre- and
    post-step q1; where it changes, q1 and p2 are lerped at t = c0 / (c0 -
    c1) and the crossing counts if its radius (Kerr-Schild; r) lies in
    [r_in, r_out] on an unguarded step.  Returns (state, ns, hit, hit_q,
    hit_p), ns negated for guard-parked rays, the hit rows zero where the
    ray never hit."""
    r_in, r_out = vec[-2:].tolist()
    base = vec[:-2]
    level, radius = _disk_level_radius(metric, float(base[1]))
    # through the module's global, so that a caller may wrap the factory
    active, opening, step = make_generic_step(metric, base)
    n = q0s.shape[0]
    state = pack_state(q0s, p0s)
    ka = opening(state)
    ns = torch.zeros((n,), dtype=torch.int32, device=q0s.device)
    hit = torch.zeros((n,), dtype=torch.bool, device=q0s.device)
    hq = torch.zeros((n, 4), dtype=q0s.dtype, device=q0s.device)
    hp = torch.zeros_like(hq)
    for k in range(steps):
        act = active(state) & ~hit
        if k % _EXIT_CHECK == 0 and not bool(act.any()):
            break
        bad, new, ka = step(state, ka)
        c0, c1 = level(state), level(new)
        crossed = (c0 * c1) < 0.0
        t = torch.where(crossed, c0 / (c0 - c1), 0.0)
        cq = [state[m] + t * (new[m] - state[m]) for m in range(4)]
        cp = [state[12 + m] + t * (new[12 + m] - state[12 + m])
              for m in range(4)]
        r_hit = radius(cq)
        new_hit = act & ~bad & crossed & (r_hit >= r_in) & (r_hit <= r_out)
        hq = torch.where(new_hit[:, None], torch.stack(cq, dim=-1), hq)
        hp = torch.where(new_hit[:, None], torch.stack(cp, dim=-1), hp)
        hit = hit | new_hit
        ns = ns + act.to(torch.int32)
        ns = torch.where(act & bad, -ns, ns)
        state = tuple(torch.where(act, nw, o) for nw, o in zip(new, state))
    return state, ns, hit, hq, hp


def finish_disk_spin(state, ns, hit, hq, hp, q0s, p0s, vec, metric, params):
    """Read-out of D2 or D3 and its twin: `finish_generic_rotating` or
    `finish_generic_kds` (the rescue of the parked rays), then STATUS_DISK
    for the hit rays.  Returns (final_q, final_p, status, n_steps, hit_q,
    hit_p)."""
    if metric == "KerrDS":
        out = finish_generic_kds(state, ns, q0s, p0s, vec[:-2], params)
    else:
        out = finish_generic_rotating(state, ns, q0s, p0s, vec[:-2], metric,
                                      params)
    q1, p1, status, n_steps = out
    return q1, p1, torch.where(hit, STATUS_DISK, status), n_steps, hq, hp


def integrate_batch_disk_rotating(q0s, p0s, steps, delta, params, r_max,
                                  omega, r_in, r_out, order=2,
                                  metric="RotatingBardeen"):
    """JAX's integrate_batch_disk(metric=...) for a rotating regular
    family on the CPU: the eager twin of kernel D2, then the rescue.
    params = (M, a, p).  Returns (final_q, final_p, status, n_steps,
    hit_q, hit_p)."""
    vec = disk_spin_params(
        gen_params(metric, delta, params, r_max, omega, order, q0s.dtype),
        r_in, r_out)
    out = integrate_disk_spin_twin(q0s, p0s, steps, vec, metric)
    return finish_disk_spin(*out, q0s, p0s, vec, metric, params)


def integrate_dispatch_disk_rotating(q0s, p0s, steps, delta, params, r_max,
                                     omega, r_in, r_out, order=2,
                                     metric="RotatingBardeen"):
    """The rotating families' disk integration on the rays' device: CUDA
    rays go to kernel D2, CPU rays to its twin
    (`integrate_batch_disk_rotating`); any other device raises.  Never
    falls back."""
    if metric not in MASS_FN:
        raise ValueError(f"D2 integrates the rotating regular families "
                         f"{tuple(MASS_FN)} (got {metric!r})")
    kind = q0s.device.type
    if kind == "cpu":
        return integrate_batch_disk_rotating(
            q0s, p0s, steps, delta, params, r_max, omega, r_in, r_out,
            order=order, metric=metric)
    if kind != "cuda":
        raise ValueError(f"no disk integrator for {kind!r} tensors (CUDA "
                         f"runs kernel D2, the CPU its eager twin)")
    from .integrate_generic_cuda import integrate_batch_disk_spin_cuda
    return integrate_batch_disk_spin_cuda(
        q0s, p0s, steps, delta, params, r_max, omega, r_in, r_out,
        order=order, metric=metric)
