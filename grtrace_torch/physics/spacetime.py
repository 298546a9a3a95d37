"""The generic metric API of `grtrace.physics.spacetime`, in torch: the
contravariant Schwarzschild and Kerr(-Newman) metrics in Boyer-Lindquist
coordinates and the Kerr-Schild one (batched, closed form), the
Boyer-Lindquist radius of a Kerr-Schild point, the outer horizon radius,
the Hamiltonian, the null quadratic for p_t, the `METRICS` / `COORDS`
tables, and the autodiff FANTASY flows `make_flows` / `make_step`
(`torch.func.grad`, batched with `torch.func.vmap`).

The autodiff flows are the metric-generic API that the beyond-Kerr
families plug into, and the CPU reference that the closed-form flows
(physics/kerr_bl.py, physics/kerr_schild.py, physics/static_chart.py) are
tested against; no path on the card runs them.  The static beyond-Kerr
families (Kottler, Bardeen, Hayward: physics/static_metrics.py) take the
family's own parameter in the second params slot; the rotating regular
families (RotatingBardeen, RotatingHayward: physics/rotating_regular.py)
the spin in the second and their own parameter in the third; Kerr-de
Sitter (KerrDS: physics/kerr_de_sitter.py) the spin in the second and the
cosmological constant Lambda in the third.

Metric parameters are `params = (M, a[, Q])`: a 1-D tensor, or a sequence
of numbers, in the working dtype; the charge slot is optional, as in JAX.
"""
from __future__ import annotations

import torch

from .kerr_de_sitter import kds_outer_horizon, kerr_de_sitter_g_inv
from .rotating_regular import (MASS_FN, rotating_bardeen_g_inv,
                               rotating_hayward_g_inv, rotating_horizon)
from .static_metrics import (STATIC_F, bardeen_g_inv, hayward_g_inv,
                             kottler_g_inv, outer_horizon)


def _charge(params):
    """Q from an optional third params slot."""
    return params[2] if len(params) > 2 else params[0] * 0.0


def schwarzschild_g_inv(q, params):
    """Contravariant Schwarzschild metric at every point of q (..., 4) =
    (t, r, theta, phi), params = (M, ...): returns (..., 4, 4)."""
    params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
    mass = params[0]
    r, th = q[..., 1], q[..., 2]
    f = 1.0 - 2.0 * mass / r
    sin_th = torch.sin(th)
    return torch.diag_embed(torch.stack(
        [-1.0 / f, f, 1.0 / (r * r), 1.0 / (r * r * sin_th * sin_th)],
        dim=-1))


def kerr_g_inv(q, params):
    """Contravariant Kerr(-Newman) metric in Boyer-Lindquist coordinates
    at every point of q (..., 4) = (t, r, theta, phi): returns (..., 4, 4).

    The charge enters only through Delta = r^2 - 2 M r + a^2 + Q^2 and the
    identity r^2 + a^2 - Delta = 2 M r - Q^2 in the t-phi term.  Each
    component keeps the JAX function's association (inv_sd = 1/(sigma
    delta), ...)."""
    params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
    mass, a = params[0], params[1]
    qc = _charge(params)
    r, th = q[..., 1], q[..., 2]
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = sin_th * sin_th
    sigma = r * r + a * a * cos_th * cos_th
    delta = r * r - 2.0 * mass * r + a * a + qc * qc
    r2a2 = r * r + a * a

    inv_sd = 1.0 / (sigma * delta)
    g_tt = -(r2a2 * r2a2 - a * a * delta * sin2) * inv_sd
    g_tp = -(r2a2 - delta) * a * inv_sd
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_pp = (delta - a * a * sin2) * inv_sd / sin2

    zero = torch.zeros_like(g_tt)
    rows = ((g_tt, zero, zero, g_tp), (zero, g_rr, zero, zero),
            (zero, zero, g_thth, zero), (g_tp, zero, zero, g_pp))
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def ks_radius(x, y, z, a):
    """Boyer-Lindquist radius from Kerr-Schild Cartesian coordinates:
    the positive root of r^4 - (rho^2 - a^2) r^2 - a^2 z^2 = 0."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    r2 = 0.5 * (b + torch.sqrt(b * b + 4.0 * a * a * z * z))
    return torch.sqrt(r2)


def kerr_schild_g_inv(q, params):
    """Contravariant Kerr(-Newman) metric in ingoing Kerr-Schild Cartesian
    coordinates at every point of q (..., 4) = (t, x, y, z): returns
    (..., 4, 4).  g^{mu nu} = eta^{mu nu} - 2 H l^mu l^nu with
    H = (M r - Q^2/2) r^2 / (r^4 + a^2 z^2) and
    l_mu = (1, (r x + a y)/(r^2 + a^2), (r y - a x)/(r^2 + a^2), z/r)."""
    params = torch.as_tensor(params, dtype=q.dtype, device=q.device)
    mass, a = params[0], params[1]
    qc = _charge(params)
    x, y, z = q[..., 1], q[..., 2], q[..., 3]
    r = ks_radius(x, y, z, a)
    r2 = r * r
    r2a2 = r2 + a * a
    H = (mass * r - 0.5 * qc * qc) * r2 / (r2 * r2 + a * a * z * z)
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / r
    l_up = torch.stack([-1.0 * torch.ones_like(r), lx, ly, lz], dim=-1)
    eta = torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=q.dtype,
                                  device=q.device))
    return eta - (2.0 * H)[..., None, None] * (l_up[..., :, None]
                                               * l_up[..., None, :])


METRICS = {"Schwarzschild": schwarzschild_g_inv, "Kerr": kerr_g_inv,
           "KerrSchild": kerr_schild_g_inv,
           # the static families: params = (M, Lambda | g | l[, 0])
           "Kottler": kottler_g_inv, "Bardeen": bardeen_g_inv,
           "Hayward": hayward_g_inv,
           # the rotating regular families: params = (M, a, g | l)
           "RotatingBardeen": rotating_bardeen_g_inv,
           "RotatingHayward": rotating_hayward_g_inv,
           # Kerr-de Sitter: params = (M, a, Lambda)
           "KerrDS": kerr_de_sitter_g_inv}

# coordinate chart per metric: 'spherical' q = (t, r, theta, phi),
# 'cartesian' q = (t, x, y, z)
COORDS = {"Schwarzschild": "spherical", "Kerr": "spherical",
          "KerrSchild": "cartesian", "Kottler": "spherical",
          "Bardeen": "spherical", "Hayward": "spherical",
          "RotatingBardeen": "cartesian", "RotatingHayward": "cartesian",
          "KerrDS": "spherical"}


def horizon_radius(metric: str, mass, a=0.0, q=0.0):
    """Outer event-horizon radius r_+: 2M for Schwarzschild,
    M + sqrt(max(M^2 - a^2 - Q^2, 0)) for the Kerr-Newman family, and for
    the static families (`a` carrying the family parameter) the bisected
    outer horizon of static_metrics.outer_horizon, for the rotating
    regular families (`q` carrying theirs) rotating_regular.
    rotating_horizon, for Kerr-de Sitter (`q` carrying Lambda)
    kerr_de_sitter.kds_outer_horizon, each NaN where there is none.
    Arguments are tensors or numbers; numbers take the dtype and device of
    the first tensor argument (the default dtype if there is none)."""
    ref = next((v for v in (mass, a, q) if isinstance(v, torch.Tensor)),
               torch.zeros(()))
    mass, a, q = (torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
                  for v in (mass, a, q))
    if metric == "Schwarzschild":
        return 2.0 * mass
    if metric in ("Kerr", "KerrSchild"):
        return mass + torch.sqrt(torch.clamp(mass * mass - a * a - q * q,
                                             min=0.0))
    if metric in STATIC_F:
        return outer_horizon(STATIC_F[metric], torch.stack([mass, a]))
    if metric in MASS_FN:
        return rotating_horizon(metric, torch.stack([mass, a, q]))
    if metric == "KerrDS":
        return kds_outer_horizon(torch.stack([mass, a, q]))
    raise KeyError(metric)


def hamiltonian(q, p, params, g_inv_fn):
    """H = 0.5 g^{ab}(q) p_a p_b for one ray, q and p (4,); vmap for
    batches."""
    g = g_inv_fn(q, params)
    return 0.5 * p @ g @ p


def null_p_t(p_sp, q, params, g_inv_fn, future=True):
    """Solve g^{ab} p_a p_b = 0 for p_t, with the g^{t i} cross terms, for
    a batch: p_sp (..., 3) spatial covectors, q (..., 4) positions.

    A p_t^2 + B p_t + C = 0 with A = g^tt, B = 2 g^{t i} p_i,
    C = g^{ij} p_i p_j.  future=True picks (-B - disc) / (2A), the branch
    that reduces to the positive Schwarzschild root (A < 0 outside the
    ergosphere); future=False the other one."""
    g = g_inv_fn(q, params)
    A = g[..., 0, 0]
    B = 2.0 * (g[..., 0, 1:] * p_sp).sum(-1)
    C = (p_sp[..., :, None] * g[..., 1:, 1:] * p_sp[..., None, :]).sum(
        (-2, -1))
    disc = torch.sqrt(torch.clamp(B * B - 4.0 * A * C, min=0.0))
    return ((-B - disc) if future else (-B + disc)) / (2.0 * A)


def build_null_4momentum(p_sp, pos_sph, params, g_inv_fn, future=True):
    """(..., 3) spatial momenta at (..., 3) positions (r, theta, phi) ->
    (..., 4) null covectors."""
    q4 = torch.cat([torch.zeros_like(pos_sph[..., :1]), pos_sph], dim=-1)
    p_t = null_p_t(p_sp, q4, params, g_inv_fn, future=future)
    return torch.cat([p_t[..., None], p_sp], dim=-1)


# ---------------------------------------------------------------------------
# FANTASY flows for any metric (autodiff kicks and drifts)
# ---------------------------------------------------------------------------

def make_flows(g_inv_fn):
    """(flow_a, flow_b, flow_mixed) for a metric function, per ray: the
    state is (q1, p1, q2, p2), each (4,).  The kick -dH/dq and the drift
    +dH/dp are `torch.func.grad` of the scalar Hamiltonian; batch them
    with `torch.func.vmap` (`make_step`'s batched form does)."""
    from torch.func import grad
    dq = grad(hamiltonian, argnums=0)
    dp = grad(hamiltonian, argnums=1)

    def flow_a(q1, p1, q2, p2, dt, params):
        p1 = p1 - dt * dq(q1, p2, params, g_inv_fn)
        q2 = q2 + dt * dp(q1, p2, params, g_inv_fn)
        return q1, p1, q2, p2

    def flow_b(q1, p1, q2, p2, dt, params):
        p2 = p2 - dt * dq(q2, p1, params, g_inv_fn)
        q1 = q1 + dt * dp(q2, p1, params, g_inv_fn)
        return q1, p1, q2, p2

    def flow_mixed(q1, p1, q2, p2, cos_w, sin_w):
        q_sum, q_dif = q1 + q2, q1 - q2
        p_sum, p_dif = p1 + p2, p1 - p2
        return (0.5 * (q_sum + q_dif * cos_w + p_dif * sin_w),
                0.5 * (p_sum + p_dif * cos_w - q_dif * sin_w),
                0.5 * (q_sum - q_dif * cos_w - p_dif * sin_w),
                0.5 * (p_sum - p_dif * cos_w + q_dif * sin_w))

    return flow_a, flow_b, flow_mixed


def make_step(g_inv_fn):
    """The composed FANTASY step for the metric on (N, 4) batches:
    step(q1, p1, q2, p2, params, subs), subs the (delta_i, cos_i, sin_i)
    schedule of hamiltonian.substep_schedule; per substep A(d/2) B(d/2) M
    B(d/2) A(d/2), the flows `torch.func.vmap`ped over the rays."""
    from torch.func import vmap
    flow_a, flow_b, flow_mixed = make_flows(g_inv_fn)
    flow_a = vmap(flow_a, in_dims=(0, 0, 0, 0, None, None))
    flow_b = vmap(flow_b, in_dims=(0, 0, 0, 0, None, None))

    def step(q1, p1, q2, p2, params, subs):
        for d_i, cos_i, sin_i in subs:
            half = 0.5 * d_i
            q1, p1, q2, p2 = flow_a(q1, p1, q2, p2, half, params)
            q1, p1, q2, p2 = flow_b(q1, p1, q2, p2, half, params)
            q1, p1, q2, p2 = flow_mixed(q1, p1, q2, p2, cos_i, sin_i)
            q1, p1, q2, p2 = flow_b(q1, p1, q2, p2, half, params)
            q1, p1, q2, p2 = flow_a(q1, p1, q2, p2, half, params)
        return q1, p1, q2, p2

    return step
