"""Legacy forward-Euler geodesic integrator, a cheap cross-check of the
FANTASY path — the torch counterpart of `grtrace.engine.euler`.

dq^a/dlam = p^a ;  dp^a/dlam = -Gamma^a_{bc} p^b p^c, in fixed Euler steps
with no early exit, on the analytic Christoffel symbols.  Both integrators
agree to O(delta) over short arcs once the FANTASY momenta are raised to
contravariant form (`raise_index`).  A Python loop of a few tensor ops a
step: a diagnostic, not a render path, so it has no kernel.
"""
from __future__ import annotations

import torch

from ..physics.metric import christoffel_nonzero, contravariant_diag


def raise_index(q, p_lower, rs):
    """FANTASY-convention (covariant) momenta -> contravariant
    p^a = g^{ab} p_b."""
    g_tt, g_rr, g_thth, g_phph = contravariant_diag(q[..., 1], q[..., 2], rs)
    return torch.stack([g_tt * p_lower[..., 0], g_rr * p_lower[..., 1],
                        g_thth * p_lower[..., 2], g_phph * p_lower[..., 3]],
                       dim=-1)


def _geodesic_rhs(q, p, rs):
    """(..., 4) q, p -> dp/dlam via the non-zero Schwarzschild symbols."""
    G = christoffel_nonzero(q[..., 1], q[..., 2], rs)
    p_t, p_r, p_th, p_ph = (p[..., a] for a in range(4))

    # dp^a = -Gamma^a_{bc} p^b p^c  (symmetric pairs count twice)
    dp_t = -2.0 * G[(0, 1, 0)] * p_r * p_t
    dp_r = -(G[(1, 0, 0)] * p_t * p_t + G[(1, 1, 1)] * p_r * p_r
             + G[(1, 2, 2)] * p_th * p_th + G[(1, 3, 3)] * p_ph * p_ph)
    dp_th = -(2.0 * G[(2, 1, 2)] * p_r * p_th + G[(2, 3, 3)] * p_ph * p_ph)
    dp_ph = -(2.0 * G[(3, 1, 3)] * p_r * p_ph
              + 2.0 * G[(3, 2, 3)] * p_th * p_ph)
    return torch.stack([dp_t, dp_r, dp_th, dp_ph], dim=-1)


def euler_integrate_batch(q0s, p0s, steps, delta, rs):
    """(N, 4) batch, `steps` fixed Euler steps, no early exit.  Returns
    (final_q, final_p)."""
    q, p = q0s, p0s
    for _ in range(steps):
        dp = _geodesic_rhs(q, p, rs)
        q, p = q + delta * p, p + delta * dp
    return q, p


def euler_integrate_batch_full(q0s, p0s, steps, delta, rs):
    """Trajectory variant: (N, steps, 4) positions, each stored before its
    step."""
    q, p = q0s, p0s
    traj = torch.empty((q0s.shape[0], steps, 4), dtype=q0s.dtype,
                       device=q0s.device)
    for k in range(steps):
        traj[:, k] = q
        dp = _geodesic_rhs(q, p, rs)
        q, p = q + delta * p, p + delta * dp
    return traj
