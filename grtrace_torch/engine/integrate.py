"""Batched geodesic integration in eager PyTorch — the torch counterpart of
`grtrace.engine.integrate`, and the plain version of the CUDA kernel in
`engine/integrate_cuda.py`.

The whole (N,) ray batch advances in a Python loop whose body applies a
masked FANTASY step to every ray; the loop stops once every ray has been
captured or has escaped (checked every `_EXIT_CHECK` steps, so the host
does not wait on the device every step — masked steps on finished rays
are exact no-ops) or when the step budget runs out.

Status codes:
    ALIVE (0)    still inside the domain when the budget ran out
    CAPTURED (1) r <= 1.1 * rs
    ESCAPED (2)  r >= r_max

Scalars follow the dtype of the rays: every scalar a loop body reads is a
Python float rounded to that dtype on the host (see `_in_dtype`), so
each tensor op rounds once, in the ray dtype, as the JAX program does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..physics.hamiltonian import (bridge_sizes, fantasy_step,
                                   fantasy_step_ord2_fused, pack_state,
                                   pack_state_eq, pack_state_eqc,
                                   staggered_eq, staggered_eqc,
                                   substep_schedule, unpack_eqc, unpack_p1,
                                   unpack_q1)

STATUS_ALIVE = 0
STATUS_CAPTURED = 1
STATUS_ESCAPED = 2

# masked steps between `any(active)` exit checks (each check waits on the
# device); the result does not depend on it
_EXIT_CHECK = 64


def _in_dtype(x, dtype):
    """x rounded to `dtype`, as a Python float."""
    return float(torch.tensor(x, dtype=dtype))


def _capture_radius(rs, dtype):
    """1.1 * rs rounded in `dtype` — the capture threshold."""
    return float(torch.tensor(1.1, dtype=dtype) * torch.tensor(rs, dtype=dtype))


def resolve_backend(backend: str, device) -> str:
    """'auto' -> 'cuda' for CUDA tensors, 'torch' for CPU tensors."""
    if backend != "auto":
        return backend
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def select_path(backend, device, dtype, equatorial):
    """Which integrator `integrate_dispatch` runs.

    On CUDA: 'kernel' (B1, float32 equatorial), 'kernel_eq' (B2, float64
    equatorial) or 'kernel_generic' (B3, any ray, float32 or float64) —
    the JAX package's `integrate_batch_pallas` routes.  With the eager
    backend ('torch', and 'auto' on the CPU): 'compensated' (B1's twin)
    for float32 equatorial rays, 'plain' (the 16-row integrate_batch, the
    JAX package's own CPU path) for the rest.  A CUDA route never falls
    back to an eager path."""
    backend = resolve_backend(backend, device)
    if backend == "cuda":
        if not equatorial:
            return "kernel_generic"
        return "kernel" if dtype == torch.float32 else "kernel_eq"
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected 'auto', 'cuda' or 'torch')")
    if equatorial and dtype == torch.float32:
        return "compensated"
    return "plain"


def integrate_dispatch(q0s, p0s, steps, delta, rs, r_max, omega,
                       backend="auto", equatorial=False, order=2):
    """Backend-dispatching integrate: same signature/returns for every path.

    equatorial=True promises theta == pi/2 and p_theta == 0 for every ray
    (true for the folded camera).  On CUDA tensors float32 equatorial rays
    go to kernel B1 (Kahan-compensated), float64 equatorial rays to kernel
    B2 and the rest to kernel B3 (`select_path`); on CPU tensors float32
    equatorial rays take B1's eager twin and the rest the 16-row
    integrate_batch, the JAX package's own CPU path.
    """
    path = select_path(backend, q0s.device, q0s.dtype, equatorial)
    from . import integrate_cuda as tc
    integrator = {"kernel": tc.integrate_batch_cuda,
                  "kernel_eq": tc.integrate_batch_eq_cuda,
                  "kernel_generic": tc.integrate_batch_generic_cuda,
                  "compensated": integrate_batch_compensated,
                  "plain": integrate_batch}[path]
    return integrator(q0s, p0s, steps, delta, rs, r_max, omega, order=order)


def _active_mask(q1r, r_capture, r_max):
    """Pre-step domain check: r_capture < r < r_max."""
    return (q1r > r_capture) & (q1r < r_max)


# Blow-up guard row indices per state layout: (q1_r, q2_r, *kahan_deficits).
_R_ROWS = {16: (1, 9), 12: (1, 7), 24: (1, 7, 13, 19)}


def jump_cap(delta, dtype):
    """Max legitimate per-step |dr|: max(5, 20 |delta|) in `dtype`."""
    return float(torch.maximum(torch.tensor(5.0, dtype=dtype),
                               20.0 * torch.tensor(delta, dtype=dtype).abs()))


def guard_state(old, new, rs, cap):
    """Horizon blow-up guard: a ray whose radius jumps by more than `cap`
    (or turns non-finite) in one step is reverted to its last resolved
    state and parked at r = rs (CAPTURED); the compensated layout's
    parked deficit rows are zeroed.  Works on the 16-, 12- and 24-row
    layouts."""
    rows = _R_ROWS[len(old)]
    r_old = old[rows[0]]
    r_new = new[rows[0]]
    bad = ~torch.isfinite(r_new) | ((r_new - r_old).abs() > cap)
    out = [torch.where(bad, o, nw) for o, nw in zip(old, new)]
    park = torch.full_like(r_new, rs)
    for row in rows[:2]:
        out[row] = torch.where(bad, park, out[row])
    for row in rows[2:]:
        out[row] = torch.where(bad, torch.zeros_like(r_new), out[row])
    return tuple(out)


def impact_parameter(p0s):
    """Exact per-ray impact parameter b = |L/E| = |p_phi / p_t|."""
    return p0s[..., 3].abs() / p0s[..., 0].abs().clamp(min=1e-30)


def schw_true_escape_pred(q0s, p0s, rs):
    """Exact capture/escape predicate per ray, from the LAUNCH state:
    r0 >= 3M: outward rays escape, inward rays escape iff b > b_crit;
    r0 < 3M: only outward rays with b <= b_crit escape."""
    dtype = q0s.dtype
    m = 0.5 * torch.tensor(rs, dtype=dtype)
    b_crit = float(3.0 * torch.sqrt(torch.tensor(3.0, dtype=dtype)) * m)
    b = impact_parameter(p0s)
    outward = p0s[..., 1] >= 0.0
    far = q0s[..., 1] >= float(3.0 * m)
    return torch.where(far, outward | (b > b_crit), outward & (b <= b_crit))


def schw_escape_rescue(final_q, final_p, status, esc_pred, rs, r_max):
    """Reconcile the integrator's classification with the exact one:
    fake escapes (pred says capture) are parked at r = rs, CAPTURED; fake
    near-critical captures (pred says escape) are parked at 1.001 r_max
    along the last resolved heading, ESCAPED.  Rays the predicate agrees
    with, and ALIVE rays, pass through untouched."""
    dtype = final_q.dtype
    to_cap = (status == STATUS_ESCAPED) & ~esc_pred
    to_esc = (status == STATUS_CAPTURED) & esc_pred
    status = torch.where(to_cap, STATUS_CAPTURED,
                         torch.where(to_esc, STATUS_ESCAPED, status))
    r_park = float(torch.tensor(1.001, dtype=dtype)
                   * torch.tensor(r_max, dtype=dtype))
    r_new = torch.where(to_cap, _in_dtype(rs, dtype),
                        torch.where(to_esc, r_park, final_q[..., 1]))
    final_q = final_q.clone()
    final_q[..., 1] = r_new
    return final_q, status


def _status(q1r, r_capture, r_max):
    status = torch.full_like(q1r, STATUS_ALIVE, dtype=torch.int32)
    status = torch.where(q1r >= r_max, STATUS_ESCAPED, status)
    return torch.where(q1r <= r_capture, STATUS_CAPTURED, status)


def _run_masked(state, steps, step_fn, r_capture, r_max):
    """Apply `step_fn` to the active rays until none is active or the
    budget runs out; returns (state, n_steps) with n_steps (N,) int32."""
    n_steps = torch.zeros(state[1].shape, dtype=torch.int32,
                          device=state[1].device)
    for k in range(steps):
        active = _active_mask(state[1], r_capture, r_max)
        if k % _EXIT_CHECK == 0 and not bool(active.any()):
            break
        new = step_fn(state)
        state = tuple(torch.where(active, nw, o) for nw, o in zip(new, state))
        n_steps += active.to(torch.int32)
    return state, n_steps


def classify_final(final_q, final_p, esc_pred, rs, r_max):
    """Status from the final radius (captured at r <= 1.1 rs, escaped at
    r >= r_max, else alive), then the exact-predicate rescue unless
    esc_pred is None: returns (final_q, status).  rs and r_max are exact
    in final_q's dtype."""
    status = _status(final_q[..., 1], _capture_radius(rs, final_q.dtype),
                     r_max)
    if esc_pred is None:
        return final_q, status
    return schw_escape_rescue(final_q, final_p, status, esc_pred, rs, r_max)


def finish_generic(state, q0s, p0s, rs, r_max):
    """Read-out of the 16-row integrators: the first copy's q and p,
    classified and rescued from the launch state; (final_q, final_p,
    status)."""
    final_q, final_p = unpack_q1(state), unpack_p1(state)
    final_q, status = classify_final(
        final_q, final_p, schw_true_escape_pred(q0s, p0s, rs), rs, r_max)
    return final_q, final_p, status


def integrate_batch(q0s, p0s, steps, delta, rs, r_max, omega, order=2):
    """Integrate a flat (N, 4) batch with the 16-row generic step.

    Returns (final_q, final_p, status, n_steps); final_q is the first
    copy's position, n_steps the per-ray count of steps applied.
    """
    state, n_steps = plain_cores(pack_state(q0s, p0s), steps, delta, rs,
                                 r_max, omega, order)
    dtype = q0s.dtype
    return (*finish_generic(state, q0s, p0s, _in_dtype(rs, dtype),
                            _in_dtype(r_max, dtype)), n_steps)


def plain_cores(state, steps, delta, rs, r_max, omega, order=2):
    """At most `steps` masked, guarded unfused steps on a 16-row state
    (integrate_batch's loop, the JAX package's XLA path): (state,
    n_steps)."""
    dtype = state[1].dtype
    delta = _in_dtype(delta, dtype)
    rs = _in_dtype(rs, dtype)
    r_max = _in_dtype(r_max, dtype)
    subs = substep_schedule(delta, omega, order, dtype=dtype)
    cap = jump_cap(delta, dtype)

    def step(state):
        return guard_state(state, fantasy_step(state, subs, rs), rs, cap)

    return _run_masked(state, steps, step, _capture_radius(rs, dtype), r_max)


def substep_params(delta, rs, r_max, omega, order, dtype=torch.float32,
                   compensated=True, staggered=True):
    """The integrators' scalars as one CPU tensor in `dtype`:
    [rs, r_max, cap, (d_i, c_i, sin_i[, bridge_i]) x n_sub], with c_i
    one_minus_cos of the mixing angle (compensated) or its cos (plain),
    and the bridge only in the staggered layouts — the JAX kernel's SMEM
    vector (`integrate_pallas._substep_params(compensated, staggered)`).
    Kernel B1 reads the compensated staggered vector, B2 the plain
    staggered one, B3 the plain triples; each kernel and its eager twin
    read the same vector."""
    delta = _in_dtype(delta, dtype)
    subs = substep_schedule(delta, omega, order, omc=compensated,
                            dtype=dtype)
    bridges = bridge_sizes([s[0] for s in subs], dtype=dtype)
    scal = [_in_dtype(rs, dtype), _in_dtype(r_max, dtype),
            jump_cap(delta, dtype)]
    for trip, br_i in zip(subs, bridges):
        scal += list(trip) + ([br_i] if staggered else [])
    return torch.tensor(scal, dtype=dtype)


def split_params(vec, width):
    """(rs, r_max, cap, [substep tuples of `width`]) as Python floats from
    a `substep_params` vector (width 4 staggered, 3 plain)."""
    p = vec.tolist()
    subs = [tuple(p[3 + width * j:3 + width * (j + 1)])
            for j in range((len(p) - 3) // width)]
    return p[0], p[1], p[2], subs


def staggered_open(state, vec, open_fn):
    """The masked opening half-A of a staggered integrator, applied to the
    initially active rays: returns (state, act0)."""
    rs, r_max, _, subs = split_params(vec, 4)
    act0 = _active_mask(state[1], _capture_radius(rs, state[1].dtype), r_max)
    opened = open_fn(state, subs[0][0], rs)
    return tuple(torch.where(act0, o, s) for o, s in zip(opened, state)), act0


def staggered_cores(state, steps, vec, core_fn):
    """At most `steps` masked, guarded core steps B(d/2) M B(d/2)
    A(bridge) per substep on an opened state: (state, n_steps)."""
    rs, r_max, cap, subs = split_params(vec, 4)

    def step(state):
        new = state
        for d_i, c_i, sin_i, br_i in subs:
            new = core_fn(new, d_i, rs, c_i, sin_i, br_i)
        return guard_state(state, new, rs, cap)

    return _run_masked(state, steps, step,
                       _capture_radius(rs, state[1].dtype), r_max)


def staggered_close(state, opened, vec, close_fn):
    """Undo the pending half-A of the `opened` rays, except those the
    guard parked at exactly r == rs (flow A divides by r - rs there)."""
    rs, _, _, subs = split_params(vec, 4)
    closed = close_fn(state, subs[0][0], rs)
    mask = opened & (state[1] != rs)
    return tuple(torch.where(mask, c, s) for c, s in zip(closed, state))


def _integrate_staggered(state, steps, vec, flows):
    """Open, cores, close — the loop of kernels B1 and B2; steps == 0 is an
    exact no-op, as in the kernels."""
    open_fn, core_fn, close_fn = flows
    if steps <= 0:
        return state, torch.zeros(state[1].shape, dtype=torch.int32,
                                  device=state[1].device)
    state, act0 = staggered_open(state, vec, open_fn)
    state, n_steps = staggered_cores(state, steps, vec, core_fn)
    return staggered_close(state, act0, vec, close_fn), n_steps


def finish_compensated(state, q0s, p0s, rs, r_max):
    """Shared read-out of the compensated integrators (kernel and twin):
    fold the deficits (true = s - c), rebuild the invariant theta slots
    (pi/2 and 0), classify, and apply the exact-predicate rescue from the
    launch state."""
    best = unpack_eqc(state)
    th = torch.full_like(best[1], math.pi / 2)
    zero = torch.zeros_like(best[1])
    final_q = torch.stack([best[0], best[1], th, best[2]], dim=-1)
    final_p = torch.stack([best[3], best[4], zero, best[5]], dim=-1)
    final_q, status = classify_final(
        final_q, final_p, schw_true_escape_pred(q0s, p0s, rs), rs, r_max)
    return final_q, final_p, status


def integrate_batch_compensated(q0s, p0s, steps, delta, rs, r_max, omega,
                                order=2):
    """Eager twin of kernel B1, the compensated CUDA kernel (equatorial
    rays only).

    Runs the staggered compensated flows (physics.hamiltonian.staggered_eqc)
    on the 24-row state: one masked opening half-A, masked cores
    B(d/2) M B(d/2) A(bridge) per substep with the blow-up guard, one
    masked closing half-A (skipped for rays parked at r == rs).  Requires
    theta == pi/2 and p_theta == 0 for every ray.
    """
    vec = substep_params(delta, rs, r_max, omega, order, q0s.dtype)
    state, n_steps = _integrate_staggered(pack_state_eqc(q0s, p0s), steps,
                                          vec, staggered_eqc)
    return (*finish_compensated(state, q0s, p0s, float(vec[0]),
                                float(vec[1])), n_steps)


def finish_eq(state, q0s, p0s, rs, r_max):
    """Read-out of the plain 12-row integrators (kernel B2 and its twin):
    the theta slots come back from the launch state, as the JAX kernel's
    `_unpack_tiles` rebuilds them (pi/2 and 0 for equatorial rays), then
    classify and rescue."""
    final_q = torch.stack([state[0], state[1], q0s[..., 2], state[2]], dim=-1)
    final_p = torch.stack([state[3], state[4], p0s[..., 2], state[5]], dim=-1)
    final_q, status = classify_final(
        final_q, final_p, schw_true_escape_pred(q0s, p0s, rs), rs, r_max)
    return final_q, final_p, status


def integrate_batch_eq(q0s, p0s, steps, delta, rs, r_max, omega, order=2):
    """Eager twin of kernel B2: the plain staggered 12-row equatorial
    integrator (physics.hamiltonian.staggered_eq, the cos/sin mixing flow)
    with B1's loop — the float64 render's integrator on the card, the JAX
    package's `integrate_batch_pallas(equatorial=True, compensated=False)`.
    Requires theta == pi/2 and p_theta == 0 for every ray."""
    vec = substep_params(delta, rs, r_max, omega, order, q0s.dtype,
                         compensated=False)
    state, n_steps = _integrate_staggered(pack_state_eq(q0s, p0s), steps,
                                          vec, staggered_eq)
    return (*finish_eq(state, q0s, p0s, float(vec[0]), float(vec[1])),
            n_steps)


def fused_cores(state, steps, vec):
    """At most `steps` masked, guarded fused-flow steps on a 16-row state
    (the loop of kernel B3), from a plain-triples `substep_params`
    vector: (state, n_steps)."""
    rs, r_max, cap, subs = split_params(vec, 3)

    def step(state):
        new = fantasy_step(state, subs, rs, step2_fn=fantasy_step_ord2_fused)
        return guard_state(state, new, rs, cap)

    return _run_masked(state, steps, step,
                       _capture_radius(rs, state[1].dtype), r_max)


def integrate_batch_fused(q0s, p0s, steps, delta, rs, r_max, omega,
                          order=2):
    """Eager twin of kernel B3: the 16-row generic integrator on the fused
    flows (`fantasy_step_ord2_fused`), masked and guarded — the JAX
    package's `integrate_batch_pallas(equatorial=False)`, for rays in any
    plane.  Not bit-equal to integrate_batch, whose unfused flows round
    differently."""
    vec = substep_params(delta, rs, r_max, omega, order, q0s.dtype,
                         compensated=False, staggered=False)
    state, n_steps = fused_cores(pack_state(q0s, p0s), steps, vec)
    return (*finish_generic(state, q0s, p0s, float(vec[0]), float(vec[1])),
            n_steps)


def traj_layout(steps, n_keep):
    """(stride, n_keep_eff) of a trajectory record: q1 every `stride` steps,
    at most n_keep samples; n_keep None or >= steps keeps every step."""
    if n_keep is None or n_keep >= steps:
        return 1, steps
    stride = -(-steps // n_keep)
    return stride, -(-steps // stride)


def integrate_batch_full(q0s, p0s, steps, delta, rs, r_max, omega,
                         n_keep=None, order=2):
    """Trajectory-capturing variant: returns (N, n_keep, 4) positions, and
    the eager twin of kernel S1 (the record mode of csrc/fantasy_schw16.cu).

    q1 is recorded every `stride` steps (`traj_layout`) so that at most
    n_keep samples exist, including the step on which a ray exits; rows
    after a ray's exit stay +0.0 (the JAX package multiplies by the alive
    mask, which leaves -0.0 in a dead ray's negative components; a kernel
    that exits per ray cannot reproduce that sign, so both write +0.0).
    n_keep=None keeps every step (stride 1).  Once every ray has exited,
    the remaining records would all be zero, so the loop stops there.
    The step is kernel B3's fused 16-row one (`fantasy_step_ord2_fused`,
    as `fused_cores`) with the guard, from the plain-triples
    `substep_params` vector that S1 reads too.  The JAX package's loop
    steps with the unfused flows, so the two records differ in the last
    ulps (a deliberate divergence in rounding, ROADMAP Queue C).
    """
    stride, n_keep_eff = traj_layout(steps, n_keep)
    dtype = q0s.dtype
    vec = substep_params(delta, rs, r_max, omega, order, dtype,
                         compensated=False, staggered=False)
    rs, r_max, cap, subs = split_params(vec, 3)
    r_capture = _capture_radius(rs, dtype)

    n = q0s.shape[0]
    traj = torch.zeros((n, n_keep_eff, 4), dtype=dtype, device=q0s.device)
    state = pack_state(q0s, p0s)
    alive = torch.ones((n,), dtype=torch.bool, device=q0s.device)
    for k in range(steps):
        if k % _EXIT_CHECK == 0 and not bool(alive.any()):
            break
        active = _active_mask(state[1], r_capture, r_max)
        if k % stride == 0:
            traj[:, k // stride, :] = torch.where(alive[:, None],
                                                  unpack_q1(state), 0.0)
        alive = alive & active
        new = guard_state(state, fantasy_step(
            state, subs, rs, step2_fn=fantasy_step_ord2_fused), rs, cap)
        state = tuple(torch.where(active, nw, o) for nw, o in zip(new, state))
    return traj


def integrate_full_dispatch(q0s, p0s, steps, delta, rs, r_max, omega,
                            n_keep=None, order=2):
    """The trajectory sampler on the rays' device: CUDA rays go to kernel
    S1 (`integrate_cuda.integrate_batch_full_cuda`), CPU rays to its eager
    twin `integrate_batch_full`; any other device raises.  The card never
    runs the eager loop."""
    kind = q0s.device.type
    if kind == "cuda":
        from .integrate_cuda import integrate_batch_full_cuda
        return integrate_batch_full_cuda(q0s, p0s, steps, delta, rs, r_max,
                                         omega, n_keep=n_keep, order=order)
    if kind != "cpu":
        raise ValueError(f"no trajectory sampler for {kind!r} tensors "
                         f"(CUDA runs kernel S1, the CPU its eager twin)")
    return integrate_batch_full(q0s, p0s, steps, delta, rs, r_max, omega,
                                n_keep=n_keep, order=order)


def trace_params(delta, rs, omega, order, dtype):
    """The scalar vector of kernel T1 and its twin: `substep_params`' plain
    triples, whose r_max and cap a trace never reads (it stops no ray)."""
    return substep_params(delta, rs, math.inf, omega, order, dtype,
                          compensated=False, staggered=False)


def trajectory_unmasked(q0s, p0s, steps, delta, rs, omega, order=2):
    """(N, steps, 8): (q1, p1) of (N, 4) rays after each of `steps` steps,
    every step taken — the eager twin of kernel T1 (the trace mode of
    csrc/fantasy_schw16.cu), and the counterpart of the XLA scan
    `grtrace.compat.einsteinpy._trajectory` that the EinsteinPy-compatible
    classes run.  No domain test, no horizon guard, no park: a ray that
    falls through the horizon records whatever the arithmetic gives, NaN
    included, as JAX's scan does.  The step is B3's fused one
    (`fantasy_step_ord2_fused`, as the sampler's); JAX's scan steps with
    the unfused flows, so the two records differ in the last ulps (a
    deliberate divergence in rounding, ROADMAP Queue C)."""
    vec = trace_params(delta, rs, omega, order, q0s.dtype)
    rs, _, _, subs = split_params(vec, 3)
    out = torch.empty((q0s.shape[0], steps, 8), dtype=q0s.dtype,
                      device=q0s.device)
    state = pack_state(q0s, p0s)
    for k in range(steps):
        state = fantasy_step(state, subs, rs,
                             step2_fn=fantasy_step_ord2_fused)
        out[:, k, :] = torch.stack(state[:8], dim=-1)
    return out


def trajectory_dispatch(q0s, p0s, steps, delta, rs, omega, order=2):
    """`trajectory_unmasked` on the rays' device: CUDA rays go to kernel
    T1 (`integrate_cuda.trajectory_unmasked_cuda`), CPU rays to the eager
    twin; any other device raises.  The card never runs the eager loop."""
    kind = q0s.device.type
    if kind == "cuda":
        from .integrate_cuda import trajectory_unmasked_cuda
        return trajectory_unmasked_cuda(q0s, p0s, steps, delta, rs, omega,
                                        order=order)
    if kind != "cpu":
        raise ValueError(f"no trace for {kind!r} tensors (CUDA runs kernel "
                         f"T1, the CPU its eager twin)")
    return trajectory_unmasked(q0s, p0s, steps, delta, rs, omega,
                               order=order)


class SchwarzschildIntegrator:
    """Counterpart of `grtrace.engine.integrate.SchwarzschildIntegrator`
    (the reference CUDASchwarzschildIntegrator's constructor signature).

    backend 'torch' runs the 16-row integrate_batch on `device` (the JAX
    class's 'xla'); 'cuda' runs kernel B3, the 16-row generic kernel on
    the fused flows (the JAX class's 'pallas', `integrate_batch_pallas`
    with equatorial=False), and raises for CPU rays.  device defaults to
    'cuda', as the JAX class runs on the default device, and raises
    RuntimeError when no GPU is present; pass device='cpu' for the CPU.
    """

    def __init__(self, steps=500, delta=0.2, mass=1.0, omega=1.0, r_max=1e6,
                 backend="torch", dtype=torch.float32, order=2,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SchwarzschildIntegrator(device='cuda') needs "
                               "a CUDA GPU; pass device='cpu' for the CPU")
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r} "
                             f"(expected 'torch' or 'cuda')")
        self.steps = int(steps)
        self.delta = float(delta)
        self.rs = 2.0 * float(mass)
        self.omega = float(omega)
        self.r_max = float(r_max)
        self.backend = backend
        self.dtype = dtype
        self.order = int(order)
        self.device = device

    def _tensors(self, q0s, p0s):
        return tuple(torch.as_tensor(
            x if isinstance(x, torch.Tensor) else np.array(x),
            dtype=self.dtype, device=self.device).contiguous()
            for x in (q0s, p0s))

    def integrate_batch(self, q0s, p0s):
        q0s, p0s = self._tensors(q0s, p0s)
        args = (q0s, p0s, self.steps, self.delta, self.rs, self.r_max,
                self.omega)
        if self.backend == "cuda":
            from .integrate_cuda import integrate_batch_generic_cuda
            return integrate_batch_generic_cuda(*args, order=self.order)
        return integrate_batch(*args, order=self.order)

    def integrate_batch_full(self, q0s, p0s, n_keep=None):
        """Trajectories on the integrator's device: kernel S1 on the card,
        its eager twin on the CPU (`integrate_full_dispatch`)."""
        q0s, p0s = self._tensors(q0s, p0s)
        return integrate_full_dispatch(q0s, p0s, self.steps, self.delta,
                                       self.rs, self.r_max, self.omega,
                                       n_keep, order=self.order)
