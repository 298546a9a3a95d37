"""FANTASY order-2 symplectic flows for Schwarzschild null geodesics — the
torch counterpart of `grtrace.physics.hamiltonian`.

Phase-space-doubled Hamiltonian integrator (Christian & Chan 2021,
arXiv:2010.02237).  The state is a tuple of component tensors, one per row,
exactly as in the JAX module, and every expression keeps the JAX module's
association, so a reader can hold the two side by side.

Arithmetic rules that the CUDA kernels (csrc/fantasy_eqc.cu,
csrc/fantasy_schw16.cu) rely on to be bit-equal to these flows on the card:
  * only plain binary tensor ops: no addcmul, lerp, or torch.compile;
  * `1.0 / x` is torch's reciprocal (an IEEE-rounded 1/x), which is what
    the kernel's `1.0f / x` gives under -prec-div;
  * the fused flows' `torch.sin` / `torch.cos` are the card's `sin` /
    `cos` of the ray type, the functions the kernel calls;
  * scalars (dt, rs, trig of the mixing angle) are Python floats that are
    exact in the working dtype — a torch op casts such a scalar to the
    tensor's dtype without rounding, so the op rounds once, in that dtype.

State layouts (see the JAX module):
    16 rows: (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
              q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)
    12 rows (equatorial): (q1t, q1r, q1ph, p1t, p1r, p1ph,
                           q2t, q2r, q2ph, p2t, p2r, p2ph)
    24 rows (compensated): the 12 equatorial rows + their 12 Kahan
                           deficit rows (true value = s - c)
"""
from __future__ import annotations

import torch

from .metric import contravariant_diag, dcontravariant_dr, dcontravariant_dth

N_STATE = 16
N_STATE_EQ = 12


def pack_state(q0, p0):
    """(N,4) q0/p0 -> 16-tuple of (N,) component tensors with q2=q1, p2=p1."""
    comps = [q0[..., a] for a in range(4)] + [p0[..., a] for a in range(4)]
    return tuple(comps + comps)


def unpack_q1(state):
    """First copy's position as (..., 4) — the integrator's output."""
    return torch.stack(state[0:4], dim=-1)


def unpack_p1(state):
    return torch.stack(state[4:8], dim=-1)


def _flow_a(state, dt, rs):
    """Flow A: update p1 (r,theta slots) and drift q2, using metric at q1."""
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    d_tt, d_rr, d_thth, d_phph = dcontravariant_dr(q1r, q1th, rs)
    dH_r = 0.5 * (d_tt * p2t * p2t + d_rr * p2r * p2r
                  + d_thth * p2th * p2th + d_phph * p2ph * p2ph)
    dH_th = 0.5 * dcontravariant_dth(q1r, q1th, rs) * p2ph * p2ph

    p1r = p1r - dt * dH_r
    p1th = p1th - dt * dH_th

    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q1r, q1th, rs)
    q2t = q2t + dt * g_tt * p2t
    q2r = q2r + dt * g_rr * p2r
    q2th = q2th + dt * g_thth * p2th
    q2ph = q2ph + dt * g_phph * p2ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def _flow_b(state, dt, rs):
    """Flow B: update p2 (r,theta slots) and drift q1, using metric at q2."""
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    d_tt, d_rr, d_thth, d_phph = dcontravariant_dr(q2r, q2th, rs)
    dH_r = 0.5 * (d_tt * p1t * p1t + d_rr * p1r * p1r
                  + d_thth * p1th * p1th + d_phph * p1ph * p1ph)
    dH_th = 0.5 * dcontravariant_dth(q2r, q2th, rs) * p1ph * p1ph

    p2r = p2r - dt * dH_r
    p2th = p2th - dt * dH_th

    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q2r, q2th, rs)
    q1t = q1t + dt * g_tt * p1t
    q1r = q1r + dt * g_rr * p1r
    q1th = q1th + dt * g_thth * p1th
    q1ph = q1ph + dt * g_phph * p1ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def _flow_mixed(state, cos_w, sin_w):
    """Mixing rotation between the two phase-space copies."""
    q1 = state[0:4]
    p1 = state[4:8]
    q2 = state[8:12]
    p2 = state[12:16]

    new = [None] * N_STATE
    for a in range(4):
        q_sum = q1[a] + q2[a]
        q_dif = q1[a] - q2[a]
        p_sum = p1[a] + p2[a]
        p_dif = p1[a] - p2[a]
        new[a] = 0.5 * (q_sum + q_dif * cos_w + p_dif * sin_w)        # q1'
        new[4 + a] = 0.5 * (p_sum + p_dif * cos_w - q_dif * sin_w)    # p1'
        new[8 + a] = 0.5 * (q_sum - q_dif * cos_w - p_dif * sin_w)    # q2'
        new[12 + a] = 0.5 * (p_sum - p_dif * cos_w + q_dif * sin_w)   # p2'
    return tuple(new)


def fantasy_step_ord2(state, delta, rs, cos_w, sin_w):
    """One order-2 step: A(d/2) B(d/2) M(d) B(d/2) A(d/2)."""
    half = 0.5 * delta
    state = _flow_a(state, half, rs)
    state = _flow_b(state, half, rs)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b(state, half, rs)
    state = _flow_a(state, half, rs)
    return state


def _flow_a_fused(state, dt, rs):
    """Flow A with shared reciprocals and trig: the formulas of _flow_a
    factored as the JAX module factors them (3 divisions, 1 sin, 1 cos)."""
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    r = q1r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    inv_rms = 1.0 / (r - rs)
    sin_th = torch.sin(q1th)
    cos_th = torch.cos(q1th)
    inv_sin = 1.0 / sin_th
    inv_sin2 = inv_sin * inv_sin

    pt2 = p2t * p2t
    pr2 = p2r * p2r
    pth2 = p2th * p2th
    pph2_s = p2ph * p2ph * inv_sin2

    dH_r = (0.5 * rs) * (inv_rms * inv_rms * pt2 + inv_r2 * pr2) \
        - inv_r3 * (pth2 + pph2_s)
    dH_th = -cos_th * inv_sin * inv_r2 * pph2_s

    p1r = p1r - dt * dH_r
    p1th = p1th - dt * dH_th

    q2t = q2t - (dt * r * inv_rms) * p2t          # g^tt = -r/(r-rs)
    q2r = q2r + dt * (1.0 - rs * inv_r) * p2r     # g^rr = 1 - rs/r
    q2th = q2th + (dt * inv_r2) * p2th
    q2ph = q2ph + (dt * inv_r2 * inv_sin2) * p2ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def _flow_b_fused(state, dt, rs):
    """Flow B twin of _flow_a_fused (metric at q2, drift q1, kick p2)."""
    (q1t, q1r, q1th, q1ph,
     p1t, p1r, p1th, p1ph,
     q2t, q2r, q2th, q2ph,
     p2t, p2r, p2th, p2ph) = state

    r = q2r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    inv_rms = 1.0 / (r - rs)
    sin_th = torch.sin(q2th)
    cos_th = torch.cos(q2th)
    inv_sin = 1.0 / sin_th
    inv_sin2 = inv_sin * inv_sin

    pt2 = p1t * p1t
    pr2 = p1r * p1r
    pth2 = p1th * p1th
    pph2_s = p1ph * p1ph * inv_sin2

    dH_r = (0.5 * rs) * (inv_rms * inv_rms * pt2 + inv_r2 * pr2) \
        - inv_r3 * (pth2 + pph2_s)
    dH_th = -cos_th * inv_sin * inv_r2 * pph2_s

    p2r = p2r - dt * dH_r
    p2th = p2th - dt * dH_th

    q1t = q1t - (dt * r * inv_rms) * p1t
    q1r = q1r + dt * (1.0 - rs * inv_r) * p1r
    q1th = q1th + (dt * inv_r2) * p1th
    q1ph = q1ph + (dt * inv_r2 * inv_sin2) * p1ph

    return (q1t, q1r, q1th, q1ph, p1t, p1r, p1th, p1ph,
            q2t, q2r, q2th, q2ph, p2t, p2r, p2th, p2ph)


def fantasy_step_ord2_fused(state, delta, rs, cos_w, sin_w):
    """Fused-flow order-2 step (the step of kernel B3): the algorithm of
    fantasy_step_ord2 with fewer divisions; not bit-equal to it."""
    half = 0.5 * delta
    state = _flow_a_fused(state, half, rs)
    state = _flow_b_fused(state, half, rs)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b_fused(state, half, rs)
    state = _flow_a_fused(state, half, rs)
    return state


# ---------------------------------------------------------------------------
# Equatorial specialization (12 rows): theta == pi/2, p_theta == 0 are
# invariants of all three flows for the folded camera rays.
# ---------------------------------------------------------------------------


def pack_state_eq(q0, p0):
    """(N,4) q0/p0 (theta slots dropped) -> 12-tuple with q2=q1, p2=p1."""
    comps = [q0[..., 0], q0[..., 1], q0[..., 3],
             p0[..., 0], p0[..., 1], p0[..., 3]]
    return tuple(comps + comps)


def _flow_a_eq(state, dt, rs):
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state
    r = q1r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    pph2 = p2ph * p2ph
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p2t * p2t
                         + inv_r2 * p2r * p2r) - inv_r2 * inv_r * pph2
    p1r = p1r - dt * dH_r
    q2t = q2t - (dt * r * inv_rms) * p2t
    q2r = q2r + dt * (1.0 - rs * inv_r) * p2r
    q2ph = q2ph + (dt * inv_r2) * p2ph
    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph)


def _flow_b_eq(state, dt, rs):
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state
    r = q2r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    pph2 = p1ph * p1ph
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p1t * p1t
                         + inv_r2 * p1r * p1r) - inv_r2 * inv_r * pph2
    p2r = p2r - dt * dH_r
    q1t = q1t - (dt * r * inv_rms) * p1t
    q1r = q1r + dt * (1.0 - rs * inv_r) * p1r
    q1ph = q1ph + (dt * inv_r2) * p1ph
    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph)


def _flow_mixed_eq(state, cos_w, sin_w):
    q1 = state[0:3]
    p1 = state[3:6]
    q2 = state[6:9]
    p2 = state[9:12]
    new = [None] * N_STATE_EQ
    for a in range(3):
        q_sum = q1[a] + q2[a]
        q_dif = q1[a] - q2[a]
        p_sum = p1[a] + p2[a]
        p_dif = p1[a] - p2[a]
        new[a] = 0.5 * (q_sum + q_dif * cos_w + p_dif * sin_w)
        new[3 + a] = 0.5 * (p_sum + p_dif * cos_w - q_dif * sin_w)
        new[6 + a] = 0.5 * (q_sum - q_dif * cos_w - p_dif * sin_w)
        new[9 + a] = 0.5 * (p_sum - p_dif * cos_w + q_dif * sin_w)
    return tuple(new)


def fantasy_step_ord2_eq(state, delta, rs, cos_w, sin_w):
    """Equatorial order-2 step: trig-free, 2 divisions per flow."""
    half = 0.5 * delta
    state = _flow_a_eq(state, half, rs)
    state = _flow_b_eq(state, half, rs)
    state = _flow_mixed_eq(state, cos_w, sin_w)
    state = _flow_b_eq(state, half, rs)
    state = _flow_a_eq(state, half, rs)
    return state


# ---------------------------------------------------------------------------
# Compensated (Kahan double-float32) equatorial specialization (24 rows).
# Every flow is in increment form and each increment is added with
# _kahan_add; EVERY row's compensation is load-bearing, the t rows
# included (see the JAX module's section comment for the measurements).
# ---------------------------------------------------------------------------


def _kahan_add(s, c, inc):
    """One compensated accumulate: returns (s', c') with s' ~ s + inc and
    the rounding deficit carried in c' (subtract c' to recover the true
    sum).  MUST stay exactly this op sequence — do not 'simplify'."""
    y = inc - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def pack_state_eqc(q0, p0):
    """(N,4) q0/p0 -> 24-tuple: equatorial 12-tuple + zero deficit rows."""
    hi = pack_state_eq(q0, p0)
    zero = torch.zeros_like(hi[0])
    return hi + tuple(zero for _ in range(N_STATE_EQ))


def unpack_eqc(state):
    """Best-estimate 12-tuple from a compensated 24-tuple (s - c)."""
    return tuple(state[i] - state[N_STATE_EQ + i] for i in range(N_STATE_EQ))


def _flow_a_eqc(state, dt, rs):
    """Increment-form flow A with Kahan accumulation (metric at q1,
    kick p1r, drift q2)."""
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state[:12]
    c = list(state[12:])

    r = q1r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p2t * p2t
                         + inv_r2 * p2r * p2r) - inv_r2 * inv_r * (p2ph * p2ph)

    p1r, c[4] = _kahan_add(p1r, c[4], -dt * dH_r)
    q2t, c[6] = _kahan_add(q2t, c[6], -(dt * r * inv_rms) * p2t)
    q2r, c[7] = _kahan_add(q2r, c[7], dt * (1.0 - rs * inv_r) * p2r)
    q2ph, c[8] = _kahan_add(q2ph, c[8], (dt * inv_r2) * p2ph)

    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph) + tuple(c)


def _flow_b_eqc(state, dt, rs):
    """Increment-form flow B with Kahan accumulation (metric at q2,
    kick p2r, drift q1)."""
    (q1t, q1r, q1ph, p1t, p1r, p1ph,
     q2t, q2r, q2ph, p2t, p2r, p2ph) = state[:12]
    c = list(state[12:])

    r = q2r
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_rms = 1.0 / (r - rs)
    dH_r = (0.5 * rs) * (inv_rms * inv_rms * p1t * p1t
                         + inv_r2 * p1r * p1r) - inv_r2 * inv_r * (p1ph * p1ph)

    p2r, c[10] = _kahan_add(p2r, c[10], -dt * dH_r)
    q1t, c[0] = _kahan_add(q1t, c[0], -(dt * r * inv_rms) * p1t)
    q1r, c[1] = _kahan_add(q1r, c[1], dt * (1.0 - rs * inv_r) * p1r)
    q1ph, c[2] = _kahan_add(q1ph, c[2], (dt * inv_r2) * p1ph)

    return (q1t, q1r, q1ph, p1t, p1r, p1ph,
            q2t, q2r, q2ph, p2t, p2r, p2ph) + tuple(c)


def _flow_mixed_eqc(state, omc_w, sin_w):
    """Mixing rotation in increment form: omc_w = 1 - cos(2*omega*delta).
    The copy differences fold in the deficits (true value = s - c)."""
    hi = state[:12]
    c = list(state[12:])
    q1, p1 = hi[0:3], hi[3:6]
    q2, p2 = hi[6:9], hi[9:12]
    new = list(hi)
    for a in range(3):
        q_dif = (q1[a] - q2[a]) - (c[a] - c[6 + a])
        p_dif = (p1[a] - p2[a]) - (c[3 + a] - c[9 + a])
        dq1 = 0.5 * (sin_w * p_dif - omc_w * q_dif)
        dp1 = 0.5 * (-sin_w * q_dif - omc_w * p_dif)
        new[a], c[a] = _kahan_add(q1[a], c[a], dq1)
        new[3 + a], c[3 + a] = _kahan_add(p1[a], c[3 + a], dp1)
        new[6 + a], c[6 + a] = _kahan_add(q2[a], c[6 + a], -dq1)
        new[9 + a], c[9 + a] = _kahan_add(p2[a], c[9 + a], -dp1)
    return tuple(new) + tuple(c)


def fantasy_step_ord2_eqc(state, delta, rs, omc_w, sin_w):
    """Compensated equatorial order-2 step: A(d/2) B(d/2) M(d) B(d/2) A(d/2).
    The third trig argument is ONE-MINUS-COS of the mixing angle."""
    half = 0.5 * delta
    state = _flow_a_eqc(state, half, rs)
    state = _flow_b_eqc(state, half, rs)
    state = _flow_mixed_eqc(state, omc_w, sin_w)
    state = _flow_b_eqc(state, half, rs)
    state = _flow_a_eqc(state, half, rs)
    return state


# ---------------------------------------------------------------------------
# Staggered (half-A-fused) step forms: evolve w = A(d0/2)(s) so each
# (sub)step runs B(d/2) M B(d/2) A(bridge) — one A flow per substep.
# ---------------------------------------------------------------------------


def make_staggered_flows(flow_a, flow_b, flow_m):
    """(open, core, close) staggered-step functions for a flow family."""

    def open_fn(state, d0, rs):
        """s -> w: apply the pending opening half-A of the first substep."""
        return flow_a(state, 0.5 * d0, rs)

    def core_fn(state, delta, rs, cw, sw, bridge):
        """One staggered (sub)step: B(d/2) M B(d/2) A(bridge)."""
        half = 0.5 * delta
        state = flow_b(state, half, rs)
        state = flow_m(state, cw, sw)
        state = flow_b(state, half, rs)
        return flow_a(state, bridge, rs)

    def close_fn(state, d0, rs):
        """w -> s: undo the pending half-A.  MUST be masked off for rays
        parked at exactly r == rs (flow A divides by r - rs there)."""
        return flow_a(state, -0.5 * d0, rs)

    return open_fn, core_fn, close_fn


staggered_eq = make_staggered_flows(_flow_a_eq, _flow_b_eq, _flow_mixed_eq)
staggered_eqc = make_staggered_flows(_flow_a_eqc, _flow_b_eqc,
                                     _flow_mixed_eqc)


def bridge_sizes(deltas, dtype=torch.float32):
    """Trailing-A sizes for the staggered schedule (cyclic):
    bridge_j = 0.5 * (d_j + d_{(j+1) mod n}), rounded in `dtype` as the
    JAX schedule rounds it."""
    n = len(deltas)
    d = torch.tensor(deltas, dtype=dtype)
    return tuple(float(0.5 * (d[j] + d[(j + 1) % n])) for j in range(n))


# ---------------------------------------------------------------------------
# Higher-order composition (orders 4, 6, 8): Yoshida triple jump.
# ---------------------------------------------------------------------------

_VALID_ORDERS = (2, 4, 6, 8)


def yoshida_gammas(order: int):
    """Static substep-size fractions for the composed order-n step
    (length 3^((order-2)/2), summing to 1.0)."""
    if order not in _VALID_ORDERS:
        raise ValueError(f"order must be one of {_VALID_ORDERS}, got {order}")
    gammas = [1.0]
    for k in range(1, (order - 2) // 2 + 1):
        z = 2.0 ** (1.0 / (2 * k + 1))
        z1 = 1.0 / (2.0 - z)
        z0 = -z * z1
        gammas = ([g * z1 for g in gammas] + [g * z0 for g in gammas]
                  + [g * z1 for g in gammas])
    return tuple(gammas)


def substep_schedule(delta, omega, order: int, omc=False,
                     dtype=torch.float32):
    """Per-substep (delta_i, cos_i, sin_i) triples for a composed step, as
    Python floats exact in `dtype`.

    Computed once on the host, in `dtype` arithmetic on CPU tensors, with
    the JAX schedule's association: d_i = g_i * delta, and either
    (cos, sin) of 2*omega*d_i or, with omc=True, one_minus_cos =
    2*sin^2(omega*d_i) in the cos slot.  The CUDA kernel and the eager
    twin read the same floats.
    """
    delta = torch.tensor(delta, dtype=dtype)
    omega = torch.tensor(omega, dtype=dtype)
    subs = []
    for g in yoshida_gammas(order):
        d_i = torch.tensor(g, dtype=dtype) * delta
        if omc:
            sh = torch.sin(omega * d_i)
            trip = (d_i, 2.0 * sh * sh, torch.sin(2.0 * omega * d_i))
        else:
            angle = 2.0 * omega * d_i
            trip = (d_i, torch.cos(angle), torch.sin(angle))
        subs.append(tuple(float(x) for x in trip))
    return tuple(subs)


def fantasy_step(state, subs, rs, step2_fn=fantasy_step_ord2):
    """One composed step of any order: apply step2_fn per substep
    (fantasy_step_ord2, fantasy_step_ord2_fused, or a 12- or 24-row step
    for its layout)."""
    for d_i, cos_i, sin_i in subs:
        state = step2_fn(state, d_i, rs, cos_i, sin_i)
    return state


def hamiltonian(q, p, rs):
    """H = 0.5 g^{ab}(q) p_a p_b — a conserved diagnostic (0 for null rays)."""
    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q[..., 1], q[..., 2], rs)
    return 0.5 * (g_tt * p[..., 0] ** 2 + g_rr * p[..., 1] ** 2
                  + g_thth * p[..., 2] ** 2 + g_phph * p[..., 3] ** 2)

