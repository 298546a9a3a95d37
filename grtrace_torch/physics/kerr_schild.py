"""Analytic FANTASY flows for Kerr(-Newman) in Cartesian Kerr-Schild
coordinates — the torch counterpart of `grtrace.physics.kerr_schild`, and
the arithmetic of the CUDA kernel `csrc/fantasy_ks.cu`, with the flows'
forward-mode tangents of its tangent mode (`_kick_drift_tan`,
`open_ks_tan`, `core_ks_tan`).

The state is a tuple of (N,) component tensors, one per row:
    16 rows: (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
              q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z)
    32 rows (compensated): the 16 rows followed by their Kahan deficits
                           (deficit of row i at 16 + i; true value s - c)

Geometry (q = (t, x, y, z), parameters M, a, Q):
    rho^2 = x^2 + y^2 + z^2,  b = rho^2 - a^2,  s = sqrt(b^2 + 4 a^2 z^2)
    r^2 = (b + s)/2 (the Boyer-Lindquist radius),  D == s,  w = r^2 + a^2
    H = (M r - Q^2/2)/D,  l = ((r x + a y)/w, (r y - a x)/w, z/r),  l^t = -1
    S = l^a p_a,  Ham = 1/2 eta^{ab} p_a p_b - H S^2
The JAX module's docstring derives the gradients written out in
`_kick_drift`.

Every expression keeps the JAX module's association, since the kernel must
round exactly as these functions do; in particular `(2.0 * a) * a`,
`4.0 * az * az` in `_geom` against `4.0 * a * a * z * z` in `ks_radius_c`
(two different roundings, both kept), and `inv_r * inv_r`.  The scalars
M, a, Q, dt and the mixing trig are Python floats exact in the working
dtype (`engine.integrate_ks.ks_params` rounds them); a product of two of
them, such as `a * a`, is exact in a Python float and rounds once when the
tensor op casts it, which is the rounding of the same product in the
working dtype.  Only plain binary tensor ops appear (see
physics/hamiltonian.py).
"""
from __future__ import annotations

import torch

from .hamiltonian import _flow_mixed, _kahan_add, pack_state

N_STATE = 16
N_STATE_KSC = 32


def _geom(x, y, z, mass, a, charge=0.0):
    """Shared Kerr-Schild geometry at one spatial point (elementwise)."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    az = a * z
    s = torch.sqrt(b * b + 4.0 * az * az)
    r2 = 0.5 * (b + s)
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    inv_D = 1.0 / s
    w = r2 + a * a
    inv_w = 1.0 / w
    H = (mass * r - 0.5 * charge * charge) * inv_D
    lx = (r * x + a * y) * inv_w
    ly = (r * y - a * x) * inv_w
    lz = z * inv_r
    return r, inv_r, inv_D, b, w, inv_w, H, lx, ly, lz


def _kick_drift(x, y, z, pt, px, py, pz, mass, a, charge=0.0):
    """dHam/dq (x, y, z slots) and dHam/dp (all 4) at one phase point:
    (kx, ky, kz, dt_, dx_, dy_, dz_).  The kick is SUBTRACTED scaled by
    dt, the drift ADDED scaled by dt."""
    r, inv_r, inv_D, b, w, inv_w, H, lx, ly, lz = _geom(x, y, z, mass, a,
                                                        charge)

    S = -pt + lx * px + ly * py + lz * pz
    HS2 = 2.0 * H * S

    dt_ = -pt + HS2
    dx_ = px - HS2 * lx
    dy_ = py - HS2 * ly
    dz_ = pz - HS2 * lz

    r_x = x * r * inv_D
    r_y = y * r * inv_D
    r_z = z * w * inv_r * inv_D
    D_x = 2.0 * x * b * inv_D
    D_y = 2.0 * y * b * inv_D
    D_z = 2.0 * z * (b + 2.0 * a * a) * inv_D

    H_x = (mass * r_x - H * D_x) * inv_D
    H_y = (mass * r_y - H * D_y) * inv_D
    H_z = (mass * r_z - H * D_z) * inv_D

    inv_r2 = inv_r * inv_r
    G = (x * px + y * py - 2.0 * r * (lx * px + ly * py)) * inv_w \
        - z * pz * inv_r2
    S_x = r_x * G + (r * px - a * py) * inv_w
    S_y = r_y * G + (a * px + r * py) * inv_w
    S_z = r_z * G + pz * inv_r

    S2 = S * S
    kx = -H_x * S2 - HS2 * S_x
    ky = -H_y * S2 - HS2 * S_y
    kz = -H_z * S2 - HS2 * S_z
    return kx, ky, kz, dt_, dx_, dy_, dz_


def _flow_a_ks(state, dt, mass, a, charge=0.0):
    """Flow A: metric at q1, kick p1 spatial slots, drift q2 (all 4)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q1x, q1y, q1z, p2t, p2x, p2y, p2z, mass, a, charge)
    p1x = p1x - dt * kx
    p1y = p1y - dt * ky
    p1z = p1z - dt * kz
    q2t = q2t + dt * dt_
    q2x = q2x + dt * dx_
    q2y = q2y + dt * dy_
    q2z = q2z + dt * dz_
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z)


def _flow_b_ks(state, dt, mass, a, charge=0.0):
    """Flow B: metric at q2, kick p2 spatial slots, drift q1 (all 4)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q2x, q2y, q2z, p1t, p1x, p1y, p1z, mass, a, charge)
    p2x = p2x - dt * kx
    p2y = p2y - dt * ky
    p2z = p2z - dt * kz
    q1t = q1t + dt * dt_
    q1x = q1x + dt * dx_
    q1y = q1y + dt * dy_
    q1z = q1z + dt * dz_
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z)


# --- forward-mode tangents (kernel B6t) ------------------------------------
# One tangent direction rides beside the 16-row state: the tangent of every
# row and of the scalars mass, a and charge (the substep scalars and the
# thresholds carry none).  The primal operations are `_kick_drift`'s, in its
# association, so the primal rows stay bitwise equal to the plain 16-row
# flows; the tangent of each intermediate X is X_d, formed by hand in the
# order csrc/fantasy_ks.cu's tangent mode writes it.  A quotient's tangent
# reuses the primal reciprocal: (1/u)_d = -(u_d (1/u)) (1/u).


def _kick_drift_tan(x, y, z, pt, px, py, pz, x_d, y_d, z_d, pt_d, px_d,
                    py_d, pz_d, mass, a, charge, mass_d, a_d, charge_d):
    """`_kick_drift` and its tangent: ((kx, ky, kz, dt_, dx_, dy_, dz_),
    the same seven tangents).  Scalars and their tangents are Python
    floats exact in the working dtype."""
    rho2 = x * x + y * y + z * z
    rho2_d = 2.0 * (x * x_d + y * y_d + z * z_d)
    b = rho2 - a * a
    b_d = rho2_d - 2.0 * a * a_d
    az = a * z
    az_d = a_d * z + a * z_d
    s = torch.sqrt(b * b + 4.0 * az * az)
    r2 = 0.5 * (b + s)
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    inv_D = 1.0 / s
    s_d = (b * b_d + 4.0 * az * az_d) * inv_D
    r2_d = 0.5 * (b_d + s_d)
    r_d = 0.5 * r2_d * inv_r
    inv_r_d = -(r_d * inv_r * inv_r)
    inv_D_d = -(s_d * inv_D * inv_D)
    w = r2 + a * a
    w_d = r2_d + 2.0 * a * a_d
    inv_w = 1.0 / w
    inv_w_d = -(w_d * inv_w * inv_w)
    hn = mass * r - 0.5 * charge * charge
    hn_d = (mass_d * r + mass * r_d) - charge * charge_d
    H = hn * inv_D
    H_d = hn_d * inv_D + hn * inv_D_d
    lxn = r * x + a * y
    lxn_d = (r_d * x + r * x_d) + (a_d * y + a * y_d)
    lx = lxn * inv_w
    lx_d = lxn_d * inv_w + lxn * inv_w_d
    lyn = r * y - a * x
    lyn_d = (r_d * y + r * y_d) - (a_d * x + a * x_d)
    ly = lyn * inv_w
    ly_d = lyn_d * inv_w + lyn * inv_w_d
    lz = z * inv_r
    lz_d = z_d * inv_r + z * inv_r_d

    S = -pt + lx * px + ly * py + lz * pz
    S_d = (-pt_d + (lx_d * px + lx * px_d) + (ly_d * py + ly * py_d)
           + (lz_d * pz + lz * pz_d))
    HS2 = 2.0 * H * S
    HS2_d = 2.0 * (H_d * S + H * S_d)

    dt_ = -pt + HS2
    dx_ = px - HS2 * lx
    dy_ = py - HS2 * ly
    dz_ = pz - HS2 * lz
    dt_d = -pt_d + HS2_d
    dx_d = px_d - (HS2_d * lx + HS2 * lx_d)
    dy_d = py_d - (HS2_d * ly + HS2 * ly_d)
    dz_d = pz_d - (HS2_d * lz + HS2 * lz_d)

    xr = x * r
    r_x = xr * inv_D
    r_x_d = (x_d * r + x * r_d) * inv_D + xr * inv_D_d
    yr = y * r
    r_y = yr * inv_D
    r_y_d = (y_d * r + y * r_d) * inv_D + yr * inv_D_d
    zw = z * w
    zw_d = z_d * w + z * w_d
    zwr = zw * inv_r
    zwr_d = zw_d * inv_r + zw * inv_r_d
    r_z = zwr * inv_D
    r_z_d = zwr_d * inv_D + zwr * inv_D_d
    xb = 2.0 * x * b
    xb_d = 2.0 * (x_d * b + x * b_d)
    D_x = xb * inv_D
    D_x_d = xb_d * inv_D + xb * inv_D_d
    yb = 2.0 * y * b
    yb_d = 2.0 * (y_d * b + y * b_d)
    D_y = yb * inv_D
    D_y_d = yb_d * inv_D + yb * inv_D_d
    bz = b + 2.0 * a * a
    bz_d = b_d + 4.0 * a * a_d
    zb = 2.0 * z * bz
    zb_d = 2.0 * (z_d * bz + z * bz_d)
    D_z = zb * inv_D
    D_z_d = zb_d * inv_D + zb * inv_D_d

    hx = mass * r_x - H * D_x
    hx_d = (mass_d * r_x + mass * r_x_d) - (H_d * D_x + H * D_x_d)
    H_x = hx * inv_D
    H_x_d = hx_d * inv_D + hx * inv_D_d
    hy = mass * r_y - H * D_y
    hy_d = (mass_d * r_y + mass * r_y_d) - (H_d * D_y + H * D_y_d)
    H_y = hy * inv_D
    H_y_d = hy_d * inv_D + hy * inv_D_d
    hz = mass * r_z - H * D_z
    hz_d = (mass_d * r_z + mass * r_z_d) - (H_d * D_z + H * D_z_d)
    H_z = hz * inv_D
    H_z_d = hz_d * inv_D + hz * inv_D_d

    inv_r2 = inv_r * inv_r
    inv_r2_d = 2.0 * (inv_r * inv_r_d)
    lp = lx * px + ly * py
    lp_d = (lx_d * px + lx * px_d) + (ly_d * py + ly * py_d)
    rlp = 2.0 * r * lp
    rlp_d = 2.0 * (r_d * lp + r * lp_d)
    gn = x * px + y * py - rlp
    gn_d = (x_d * px + x * px_d) + (y_d * py + y * py_d) - rlp_d
    zp = z * pz
    zp_d = z_d * pz + z * pz_d
    zpr = zp * inv_r2
    zpr_d = zp_d * inv_r2 + zp * inv_r2_d
    G = gn * inv_w - zpr
    G_d = (gn_d * inv_w + gn * inv_w_d) - zpr_d
    sxn = r * px - a * py
    sxn_d = (r_d * px + r * px_d) - (a_d * py + a * py_d)
    S_x = r_x * G + sxn * inv_w
    S_x_d = (r_x_d * G + r_x * G_d) + (sxn_d * inv_w + sxn * inv_w_d)
    syn = a * px + r * py
    syn_d = (a_d * px + a * px_d) + (r_d * py + r * py_d)
    S_y = r_y * G + syn * inv_w
    S_y_d = (r_y_d * G + r_y * G_d) + (syn_d * inv_w + syn * inv_w_d)
    S_z = r_z * G + pz * inv_r
    S_z_d = (r_z_d * G + r_z * G_d) + (pz_d * inv_r + pz * inv_r_d)

    S2 = S * S
    S2_d = 2.0 * (S * S_d)
    kx = -H_x * S2 - HS2 * S_x
    ky = -H_y * S2 - HS2 * S_y
    kz = -H_z * S2 - HS2 * S_z
    kx_d = -(H_x_d * S2 + H_x * S2_d) - (HS2_d * S_x + HS2 * S_x_d)
    ky_d = -(H_y_d * S2 + H_y * S2_d) - (HS2_d * S_y + HS2 * S_y_d)
    kz_d = -(H_z_d * S2 + H_z * S2_d) - (HS2_d * S_z + HS2 * S_z_d)
    return ((kx, ky, kz, dt_, dx_, dy_, dz_),
            (kx_d, ky_d, kz_d, dt_d, dx_d, dy_d, dz_d))


def _flow_tan(state, tan, dt, sc, sc_d, flow):
    """Flow A (flow='a': metric at q1, momenta p2, kick p1, drift q2) or B
    ('b': metric at q2, momenta p1, kick p2, drift q1) on the state and its
    tangent; sc = (mass, a, charge), sc_d their tangents."""
    pos, mom, kick, drift = ((1, 12, 5, 8) if flow == "a"
                             else (9, 4, 13, 0))
    k, k_d = _kick_drift_tan(*state[pos:pos + 3], *state[mom:mom + 4],
                             *tan[pos:pos + 3], *tan[mom:mom + 4], *sc,
                             *sc_d)
    state, tan = list(state), list(tan)
    for i in range(3):
        state[kick + i] = state[kick + i] - dt * k[i]
        tan[kick + i] = tan[kick + i] - dt * k_d[i]
    for i in range(4):
        state[drift + i] = state[drift + i] + dt * k[3 + i]
        tan[drift + i] = tan[drift + i] + dt * k_d[3 + i]
    return tuple(state), tuple(tan)


def open_ks_tan(state, tan, d0, sc, sc_d):
    """`open_ks` and its tangent."""
    return _flow_tan(state, tan, 0.5 * d0, sc, sc_d, "a")


def core_ks_tan(state, tan, delta, cos_w, sin_w, bridge, sc, sc_d):
    """`core_ks` and its tangent: B(d/2) M B(d/2) A(bridge); the mixing is
    linear, so the tangent rows take the same rotation."""
    half = 0.5 * delta
    state, tan = _flow_tan(state, tan, half, sc, sc_d, "b")
    state, tan = (_flow_mixed(state, cos_w, sin_w),
                  _flow_mixed(tan, cos_w, sin_w))
    state, tan = _flow_tan(state, tan, half, sc, sc_d, "b")
    return _flow_tan(state, tan, bridge, sc, sc_d, "a")


# --- staggered (half-A-fused) step forms -----------------------------------
# Flow A reads only q1 and p2 and writes only p1 and q2, so the trailing and
# leading half-A of consecutive (sub)steps fuse into one A(bridge); the
# (q1, p2) rows then hold the exact plain-composition boundary values, on
# which the blow-up guard tests the null invariant.


def open_ks(state, d0, mass, a, charge=0.0):
    """s -> w: apply the pending opening half-A of the first substep."""
    return _flow_a_ks(state, 0.5 * d0, mass, a, charge)


def core_ks(state, delta, mass, a, cos_w, sin_w, bridge, charge=0.0):
    """One staggered (sub)step: B(d/2) M B(d/2) A(bridge)."""
    half = 0.5 * delta
    state = _flow_b_ks(state, half, mass, a, charge)
    state = _flow_mixed(state, cos_w, sin_w)
    state = _flow_b_ks(state, half, mass, a, charge)
    return _flow_a_ks(state, bridge, mass, a, charge)


def close_ks(state, d0, mass, a, charge=0.0):
    """w -> s: undo the pending half-A (safe on parked rays: the park
    points are regular chart points and A cannot move q1)."""
    return _flow_a_ks(state, -0.5 * d0, mass, a, charge)


# --- compensated (Kahan double-float32) flows, 32 rows ---------------------
# Every row carries a Kahan deficit and each flow accumulates its increments
# through _kahan_add.  The geometry reads the raw accumulator rows s, not
# s - c (the deficit is below an ulp of s); the mixing flow folds the
# deficits into the copy differences.


def pack_state_ksc(q0, p0):
    """(N, 4) q0/p0 -> 32-tuple: the 16-row state (the layout of
    hamiltonian.pack_state) + zero deficit rows."""
    hi = pack_state(q0, p0)
    zero = torch.zeros_like(hi[0])
    return hi + tuple(zero for _ in range(N_STATE))


def unpack_ksc(state):
    """Best-estimate 16-tuple from a compensated 32-tuple (s - c)."""
    return tuple(state[i] - state[N_STATE + i] for i in range(N_STATE))


def _flow_a_ksc(state, dt, mass, a, charge=0.0):
    """Increment-form flow A with Kahan accumulation (metric at q1, kick
    p1 spatial slots, drift q2)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state[:16]
    c = list(state[16:])
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q1x, q1y, q1z, p2t, p2x, p2y, p2z, mass, a, charge)
    p1x, c[5] = _kahan_add(p1x, c[5], -dt * kx)
    p1y, c[6] = _kahan_add(p1y, c[6], -dt * ky)
    p1z, c[7] = _kahan_add(p1z, c[7], -dt * kz)
    q2t, c[8] = _kahan_add(q2t, c[8], dt * dt_)
    q2x, c[9] = _kahan_add(q2x, c[9], dt * dx_)
    q2y, c[10] = _kahan_add(q2y, c[10], dt * dy_)
    q2z, c[11] = _kahan_add(q2z, c[11], dt * dz_)
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) + tuple(c)


def _flow_b_ksc(state, dt, mass, a, charge=0.0):
    """Increment-form flow B with Kahan accumulation (metric at q2, kick
    p2 spatial slots, drift q1)."""
    (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
     q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) = state[:16]
    c = list(state[16:])
    kx, ky, kz, dt_, dx_, dy_, dz_ = _kick_drift(
        q2x, q2y, q2z, p1t, p1x, p1y, p1z, mass, a, charge)
    p2x, c[13] = _kahan_add(p2x, c[13], -dt * kx)
    p2y, c[14] = _kahan_add(p2y, c[14], -dt * ky)
    p2z, c[15] = _kahan_add(p2z, c[15], -dt * kz)
    q1t, c[0] = _kahan_add(q1t, c[0], dt * dt_)
    q1x, c[1] = _kahan_add(q1x, c[1], dt * dx_)
    q1y, c[2] = _kahan_add(q1y, c[2], dt * dy_)
    q1z, c[3] = _kahan_add(q1z, c[3], dt * dz_)
    return (q1t, q1x, q1y, q1z, p1t, p1x, p1y, p1z,
            q2t, q2x, q2y, q2z, p2t, p2x, p2y, p2z) + tuple(c)


def _flow_mixed_ksc(state, omc_w, sin_w):
    """Mixing rotation in increment form, omc_w = 1 - cos(2 omega delta);
    the copy differences fold in the deficits (true value = s - c)."""
    hi = state[:16]
    c = list(state[16:])
    q1, p1 = hi[0:4], hi[4:8]
    q2, p2 = hi[8:12], hi[12:16]
    new = list(hi)
    for i in range(4):
        q_dif = (q1[i] - q2[i]) - (c[i] - c[8 + i])
        p_dif = (p1[i] - p2[i]) - (c[4 + i] - c[12 + i])
        dq1 = 0.5 * (sin_w * p_dif - omc_w * q_dif)
        dp1 = 0.5 * (-sin_w * q_dif - omc_w * p_dif)
        new[i], c[i] = _kahan_add(q1[i], c[i], dq1)
        new[4 + i], c[4 + i] = _kahan_add(p1[i], c[4 + i], dp1)
        new[8 + i], c[8 + i] = _kahan_add(q2[i], c[8 + i], -dq1)
        new[12 + i], c[12 + i] = _kahan_add(p2[i], c[12 + i], -dp1)
    return tuple(new) + tuple(c)


def open_ksc(state, d0, mass, a, charge=0.0):
    """s -> w: apply the pending opening half-A (compensated layout)."""
    return _flow_a_ksc(state, 0.5 * d0, mass, a, charge)


def core_ksc(state, delta, mass, a, omc_w, sin_w, bridge, charge=0.0):
    """One compensated staggered (sub)step: B(d/2) M B(d/2) A(bridge).
    The mixing argument is ONE-MINUS-COS of the mixing angle."""
    half = 0.5 * delta
    state = _flow_b_ksc(state, half, mass, a, charge)
    state = _flow_mixed_ksc(state, omc_w, sin_w)
    state = _flow_b_ksc(state, half, mass, a, charge)
    return _flow_a_ksc(state, bridge, mass, a, charge)


def close_ksc(state, d0, mass, a, charge=0.0):
    """w -> s: undo the pending half-A (compensated layout)."""
    return _flow_a_ksc(state, -0.5 * d0, mass, a, charge)


def hamiltonian_ks(x, y, z, pt, px, py, pz, mass, a, charge=0.0):
    """Ham = 1/2 eta^{ab} p_a p_b - H S^2, elementwise: the null invariant
    the blow-up guard tests."""
    _, _, _, _, _, _, H, lx, ly, lz = _geom(x, y, z, mass, a, charge)
    S = -pt + lx * px + ly * py + lz * pz
    return 0.5 * (-pt * pt + px * px + py * py + pz * pz) - H * S * S


def ks_radius_c(x, y, z, a):
    """BL radius from KS Cartesian coordinates, elementwise (the component
    form of physics.spacetime.ks_radius)."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    return torch.sqrt(0.5 * (b + torch.sqrt(b * b + 4.0 * a * a * z * z)))
