"""The generic engine's Kerr-Newman kernels, hand-written in CUDA
(`csrc/fantasy_gen.cu`):

  * G1, the Boyer-Lindquist integrator (`integrate_batch_generic_cuda`;
    the JAX package's `integrate_batch_generic(metric='Kerr')`);
  * S2, the trajectory recorder in the Boyer-Lindquist and Kerr-Schild
    charts (`trajectory_batch_decimated_cuda`; JAX's
    `trajectory_batch_decimated`);
  * T2, the Boyer-Lindquist trace, every step recorded and none stopped
    (`trajectory_generic_unmasked_cuda`; JAX's `trajectory_generic`);
  * G1s, S2s and T2s, the same three in the static chart of the
    beyond-Kerr families Kottler, Bardeen and Hayward (the same wrappers
    with a static `metric`);
  * D1, G1s's loop with the first crossing of the tilted disk plane
    recorded (`integrate_batch_disk_static_cuda`; JAX's
    `disk_static.integrate_batch_disk_static`);
  * G1r, S2r and T2r, the same three in the mass-function Kerr-Schild
    chart of the rotating regular families (the same wrappers with a
    rotating `metric`), and D2, G1r's loop with the first equatorial
    crossing inside the annulus recorded
    (`integrate_batch_disk_spin_cuda`; JAX's
    `disk.integrate_batch_disk(metric=...)`);
  * G1d, S2d and T2d, the same three in Kerr-de Sitter's Carter chart
    (the same wrappers with metric 'KerrDS'), and D3, G1d's loop with the
    first equatorial crossing (cos theta changing sign) inside the annulus
    recorded (`integrate_batch_disk_spin_cuda` with metric 'KerrDS'; JAX's
    `disk_kds.integrate_batch_disk_kds`).

Port-side kernels: JAX runs this engine in XLA loops, not in Pallas, so
they replace no TPU kernel.  One thread integrates one ray, float32 or
float64; G1's wrapper launches the rays sorted by a cost key and puts the
results back in the caller's order.  Their eager twins,
`integrate_generic_twin`, `trajectory_generic_twin`,
`trajectory_generic_unmasked` and `integrate_disk_spin_twin`
(engine/integrate_generic.py) define their results, and each kernel and
its twin read the same host-built scalar vector (`gen_params`).  This module only launches: it never falls back to
a twin, and every wrapper raises for CPU tensors.  Rays on the CPU belong
to `integrate_dispatch_generic`, `trajectory_dispatch_generic` and
`trajectory_generic`, which send them to the twins.
"""
from __future__ import annotations

import math

import torch

from .integrate import traj_layout
from .integrate_cuda import KernelLaunchError, _check_inputs
from .integrate_ks_cuda import _cost_sort_key_ks
from ..physics.rotating_regular import MASS_FN
from ..physics.static_metrics import STATIC_F, b_critical_cached
from .integrate_generic import (N_SCAL, disk_spin_params,
                                finish_disk_spin, finish_generic_bl,
                                finish_generic_kds, finish_generic_rotating,
                                finish_generic_static, gen_params)

# Kernel launches since the process started (or since a caller reset it):
# G1, S2 in the BL and KS charts, T2; G1s, S2s in the static chart, T2s,
# D1; G1r, S2r in the mass-function chart, T2r, D2; G1d, S2d in the
# Carter chart, T2d, D3.
launches = 0
traj_launches = 0
trace_launches = 0
static_launches = 0
static_traj_launches = 0
static_trace_launches = 0
disk_launches = 0
rot_launches = 0
rot_traj_launches = 0
rot_trace_launches = 0
rot_disk_launches = 0
kds_launches = 0
kds_traj_launches = 0
kds_trace_launches = 0
kds_disk_launches = 0

F32, F64 = torch.float32, torch.float64
# (mode, chart) -> (C entry stem, launch counter); a dtype's entry is
# f"{stem}_f32_launch" or f"{stem}_f64_launch" (kernels/build.py)
KERNELS = {
    ("gen", "bl"): ("grt_fantasy_gen_bl", "launches"),
    ("gen", "static"): ("grt_fantasy_gen_static", "static_launches"),
    ("gen", "rot"): ("grt_fantasy_gen_rot", "rot_launches"),
    ("traj", "bl"): ("grt_fantasy_gen_traj_bl", "traj_launches"),
    ("traj", "ks"): ("grt_fantasy_gen_traj_ks", "traj_launches"),
    ("traj", "static"): ("grt_fantasy_gen_traj_static",
                         "static_traj_launches"),
    ("traj", "rot"): ("grt_fantasy_gen_traj_rot", "rot_traj_launches"),
    ("trace", "bl"): ("grt_fantasy_gen_trace_bl", "trace_launches"),
    ("trace", "static"): ("grt_fantasy_gen_trace_static",
                          "static_trace_launches"),
    ("trace", "rot"): ("grt_fantasy_gen_trace_rot", "rot_trace_launches"),
    ("disk", "static"): ("grt_fantasy_gen_disk_static", "disk_launches"),
    ("disk", "rot"): ("grt_fantasy_gen_disk_rot", "rot_disk_launches"),
    ("gen", "kds"): ("grt_fantasy_gen_kds", "kds_launches"),
    ("traj", "kds"): ("grt_fantasy_gen_traj_kds", "kds_traj_launches"),
    ("trace", "kds"): ("grt_fantasy_gen_trace_kds", "kds_trace_launches"),
    ("disk", "kds"): ("grt_fantasy_gen_disk_kds", "kds_disk_launches"),
}
OUT_ROWS = 12  # G1 writes q1, p1, q2
DISK_ROWS = 16  # D1 writes q1, p1, hit_q, hit_p
SPIN_DISK_ROWS = 20  # D2 and D3 write q1, p1, hit_q, hit_p, q2


def _n_sub(params, dtype, extra=0):
    n_sub = (params.numel() - N_SCAL - extra) // 3
    if (params.dtype != dtype or n_sub < 1
            or params.numel() != N_SCAL + 3 * n_sub + extra):
        raise ValueError("params must be the gen_params vector [M, a, Q, "
                         "r_cap, r_max, r_plus, plunge_zone, jump_cap, "
                         "cap_park, err_park, (d, cos, sin) x n_sub] in the "
                         "rays' dtype")
    return n_sub


def chart_of(mode, metric):
    """The kernel chart of `metric` in `mode` ('gen', 'traj', 'trace',
    'disk'): 'bl', 'ks' ('KerrSchild'), 'static' (the static families),
    'rot' (the rotating regular ones) or 'kds' ('KerrDS'); raises where
    `mode` has no kernel in that chart."""
    chart = ("static" if metric in STATIC_F else "rot" if metric in MASS_FN
             else "ks" if metric == "KerrSchild"
             else "kds" if metric == "KerrDS" else "bl")
    if (mode, chart) not in KERNELS:
        raise ValueError(f"no {mode} kernel for metric {metric!r} (have "
                         f"{sorted(c for m, c in KERNELS if m == mode)} "
                         f"charts)")
    return chart


def entry(mode, chart, dtype):
    """The C entry of `mode` in `chart` for rays of `dtype`."""
    suffix = "f32" if dtype == F32 else "f64"
    return f"{KERNELS[mode, chart][0]}_{suffix}_launch"


def _call(mode, chart, q0s, ptrs, params, ints):
    """Launch `mode` in `chart` on the rays' card and count it."""
    from ..kernels.build import load
    lib = load()
    name = entry(mode, chart, q0s.dtype)
    params_dev = params.to(q0s.device)
    with torch.cuda.device(q0s.device):  # launch on the data's card
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(q0s.data_ptr(), *ptrs,
                                 params_dev.data_ptr(), *ints, stream)
    if err != 0:
        raise KernelLaunchError(f"{name} failed: cudaError {err}")
    counter = KERNELS[mode, chart][1]
    globals()[counter] += 1


def launch_fantasy_gen(q0s, p0s, params, steps, metric="Kerr"):
    """Launch G1 ('Kerr'), G1s (a static family), G1r (a rotating one) or
    G1d ('KerrDS') on (N, 4) float32 or float64 CUDA rays; `params` is
    that chart's `gen_params` vector in the rays' dtype.  Returns (out (12,
    N): q1, p1, q2 rows; ns (N,) int32, negative for guard-parked rays)."""
    _check_inputs(q0s, p0s, (F32, F64))
    chart = chart_of("gen", metric)
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype)
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((OUT_ROWS, n), dtype=q0s.dtype, device=q0s.device)
    ns = torch.empty((n,), dtype=torch.int32, device=q0s.device)
    if n == 0:
        return out, ns
    _call("gen", chart, q0s, (p0s.data_ptr(), out.data_ptr(),
                              ns.data_ptr()), params, (n, n_sub, int(steps)))
    return out, ns


def launch_fantasy_gen_traj(q0s, p0s, params, steps, stride, n_keep,
                            metric="Kerr"):
    """Launch S2 in `metric`'s chart ('Kerr', 'KerrSchild', S2s for a
    static family, S2r for a rotating one, S2d for 'KerrDS') on (N, 4)
    float32 or float64 CUDA rays; `params` is that chart's `gen_params`
    vector in the rays' dtype.  Returns (traj (N, n_keep, 4), zero past
    each ray's exit; ns (N,) int32, the steps each ray took)."""
    _check_inputs(q0s, p0s, (F32, F64))
    chart = chart_of("traj", metric)
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype)
    if (not 0 <= steps < 2 ** 31 or not 1 <= stride < 2 ** 31
            or not 0 <= n_keep < 2 ** 31 or n >= 2 ** 31
            or n_keep * stride < steps):
        raise ValueError(f"steps={steps}, stride={stride}, n_keep={n_keep} "
                         f"or N={n} out of the kernel's range")
    # the slots past a ray's exit stay +0.0
    traj = torch.zeros((n, n_keep, 4), dtype=q0s.dtype, device=q0s.device)
    ns = torch.zeros((n,), dtype=torch.int32, device=q0s.device)
    if n == 0:
        return traj, ns
    _call("traj", chart, q0s,
          (p0s.data_ptr(), traj.data_ptr(), ns.data_ptr()), params,
          (n, n_sub, int(steps), int(stride), int(n_keep)))
    return traj, ns


# sin^2 theta below this is taken as this in the cost key, so that a ray at
# the chart's pole gets a finite key
_SIN2_FLOOR = 1e-12


def _cost_sort_key_bl(q0s, p0s, mass, b_crit=None):
    """Predicted cost key of (N, 4) rays of the spherical charts: the
    impact parameter b = sqrt(p_theta^2 + p_phi^2 / sin^2 theta) / |p_t|,
    keyed as |b - b_crit| (b_crit = 3 sqrt(3) M unless given: the static
    family's `b_critical_cached`), in float64.  It only has to cluster the
    long-running photon-ring rays into the same warps."""
    q, p = q0s.double(), p0s.double()
    sin2 = torch.clamp(torch.sin(q[:, 2]) ** 2, min=_SIN2_FLOOR)
    ell = torch.sqrt(p[:, 2] * p[:, 2] + p[:, 3] * p[:, 3] / sin2)
    b = ell / torch.clamp(torch.abs(p[:, 0]), min=1e-30)
    if b_crit is None:
        b_crit = 3.0 * math.sqrt(3.0) * mass
    return torch.abs(b - b_crit)


def launch_order(q0s, p0s, mass, metric="Kerr", b_crit=None):
    """The order in which G1's and the 20-row disk kernels' wrappers
    launch (N, 4) rays, for every chart and every N: by the chart's cost
    key, stable (`_cost_sort_key_ks` for the rotating families, whose
    chart is Cartesian; `_cost_sort_key_bl` with `b_crit` otherwise).
    Against frame order and against the sorted warps dealt round-robin
    over the blocks, on launches of a fraction of one wave as on launches
    of several, the sort was as fast as either or faster, within 3% where
    it was not the fastest (PERF.md section 6, tools/gen_ablation.py)."""
    key = (_cost_sort_key_ks(q0s, p0s, mass) if metric in MASS_FN
           else _cost_sort_key_bl(q0s, p0s, mass, b_crit))
    return torch.argsort(key, stable=True)


def _sorted_rays(q0s, p0s, mass, b_crit=None):
    """(launch order, q0s and p0s in that order): the rays by cost key."""
    order_idx = launch_order(q0s, p0s, mass, b_crit=b_crit)
    return order_idx, q0s[order_idx], p0s[order_idx]


def _unsorted(order_idx, out, ns):
    """G1's (12, N) rows and (N,) step counts, launched in `order_idx`,
    back in the caller's order."""
    out_u, ns_u = torch.empty_like(out), torch.empty_like(ns)
    out_u[:, order_idx] = out
    ns_u[order_idx] = ns
    return out_u, ns_u


def integrate_batch_generic_cuda(q0s, p0s, steps, delta, params, r_max,
                                 omega, order=2, metric="Kerr"):
    """Integrate (N, 4) rays through G1 ('Kerr', then the exact rescue),
    G1s (a static family, no rescue), G1r (a rotating family, then the
    rescue by its exact predicate) or G1d ('KerrDS', then the
    Boyer-Lindquist rescue by its exact predicate): (final_q, final_p,
    status, n_steps), the contract of `integrate_batch_generic(metric=
    ...)`, which it matches bit for bit on the card.  Rays are launched
    in `launch_order` (cost-sorted: about the family's critical impact
    parameter, or by `integrate_ks_cuda._cost_sort_key_ks` in the
    Cartesian chart) and come back in the caller's.  Raises for CPU,
    misshapen or non-contiguous inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F32, F64))
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    static = metric in STATIC_F
    b_crit = (b_critical_cached(metric, *[float(x) for x in params][:2])
              if static else None)
    order_idx = launch_order(q0s, p0s, float(vec[0]), metric, b_crit)
    out, ns = _unsorted(order_idx, *launch_fantasy_gen(
        q0s[order_idx], p0s[order_idx], vec, steps, metric))
    if metric in MASS_FN:
        return finish_generic_rotating(tuple(out), ns, q0s, p0s, vec, metric,
                                       params)
    if static:
        return finish_generic_static(tuple(out), ns, vec)
    if metric == "KerrDS":
        return finish_generic_kds(tuple(out), ns, q0s, p0s, vec, params)
    return finish_generic_bl(tuple(out), ns, q0s, p0s, vec)


def trajectory_batch_decimated_cuda(q0s, p0s, steps, delta, params, r_max,
                                    omega, order=2, metric="Kerr",
                                    n_keep=1000, return_steps=False):
    """Record the trajectories of (N, 4) CUDA rays through S2: (N, n_keep',
    4) positions, q1 every `stride` steps (`traj_layout`), the contract of
    `trajectory_batch_decimated`, which it matches bit for bit on the
    card; with return_steps, also the (N,) int32 steps each ray took.
    Rays keep the caller's order.  Raises for CPU, misshapen or
    non-contiguous inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F32, F64))
    stride, n_keep_eff = traj_layout(steps, n_keep)
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    traj, ns = launch_fantasy_gen_traj(q0s, p0s, vec, steps, stride,
                                       n_keep_eff, metric)
    return (traj, ns) if return_steps else traj


def launch_fantasy_gen_trace(q0s, p0s, params, steps, metric="Kerr"):
    """Launch T2 ('Kerr'), T2s (a static family), T2r (a rotating one) or
    T2d ('KerrDS') on (N, 4) float32 or float64 CUDA rays; `params` is
    that chart's `gen_params` vector in the rays' dtype.  Returns (N,
    steps, 8): (q1, p1) after each step, every element written by the
    kernel."""
    _check_inputs(q0s, p0s, (F32, F64))
    chart = chart_of("trace", metric)
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype)
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((n, steps, 8), dtype=q0s.dtype, device=q0s.device)
    if n == 0 or steps == 0:
        return out
    _call("trace", chart, q0s, (p0s.data_ptr(), out.data_ptr()), params,
          (n, n_sub, int(steps)))
    return out


def trajectory_generic_unmasked_cuda(q0s, p0s, steps, vec, metric="Kerr"):
    """Trace (N, 4) CUDA rays through T2 ('Kerr'), T2s (a static family),
    T2r (a rotating one) or T2d ('KerrDS') from that chart's gen_params
    vector: (N, steps, 8), the contract of `trajectory_generic_unmasked`,
    which it matches bit for bit on the card.  Raises for CPU, misshapen or
    non-contiguous inputs, and for a failed build or launch."""
    return launch_fantasy_gen_trace(q0s, p0s, vec, steps, metric)


def launch_fantasy_gen_disk(q0s, p0s, disk, params, steps):
    """Launch D1 on (N, 4) float32 or float64 CUDA rays of the static
    chart; disk (N, 2) holds each ray's plane constants (c1, c2), params
    is the static chart's `gen_params` vector followed by r_in and r_out
    (`disk_static.disk_params`), all in the rays' dtype.  Returns (out
    (16, N): q1, p1, hit_q, hit_p rows, the hit rows zero where the ray
    never hit; ns (N,) int32, negative for guard-parked rays; hit (N,)
    bool)."""
    _check_inputs(q0s, p0s, (F32, F64))
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype, extra=2)
    if (disk.shape != (n, 2) or disk.dtype != q0s.dtype
            or disk.device != q0s.device or not disk.is_contiguous()):
        raise ValueError("disk must be the contiguous (N, 2) plane "
                         "constants in the rays' dtype, on their device")
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((DISK_ROWS, n), dtype=q0s.dtype, device=q0s.device)
    ns = torch.empty((n,), dtype=torch.int32, device=q0s.device)
    hit = torch.empty((n,), dtype=torch.int32, device=q0s.device)
    if n == 0:
        return out, ns, hit.bool()
    _call("disk", "static", q0s,
          (p0s.data_ptr(), disk.data_ptr(), out.data_ptr(), ns.data_ptr(),
           hit.data_ptr()), params, (n, n_sub, int(steps)))
    return out, ns, hit.bool()


def launch_fantasy_gen_disk_spin(q0s, p0s, params, steps, metric):
    """Launch D2 (a rotating family) or D3 ('KerrDS'), the 20-row disk
    kernels of `metric`'s chart (`chart_of('disk', metric)`: 'rot' or
    'kds'), on (N, 4) float32 or float64 CUDA rays; params is that chart's
    `gen_params` vector followed by r_in and r_out
    (`integrate_generic.disk_spin_params`), in the rays' dtype.  Returns
    (out (20, N): q1, p1, hit_q, hit_p, q2 rows, the hit rows zero where
    the ray never hit; ns (N,) int32, negative for guard-parked rays; hit
    (N,) bool)."""
    _check_inputs(q0s, p0s, (F32, F64))
    chart = chart_of("disk", metric)
    if chart not in ("rot", "kds"):
        raise ValueError(f"no 20-row disk kernel for metric {metric!r}")
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype, extra=2)
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((SPIN_DISK_ROWS, n), dtype=q0s.dtype,
                      device=q0s.device)
    ns = torch.empty((n,), dtype=torch.int32, device=q0s.device)
    hit = torch.empty((n,), dtype=torch.int32, device=q0s.device)
    if n == 0:
        return out, ns, hit.bool()
    _call("disk", chart, q0s,
          (p0s.data_ptr(), None, out.data_ptr(), ns.data_ptr(),
           hit.data_ptr()), params, (n, n_sub, int(steps)))
    return out, ns, hit.bool()


def integrate_batch_disk_spin_cuda(q0s, p0s, steps, delta, params, r_max,
                                   omega, r_in, r_out, order=2,
                                   metric="RotatingBardeen"):
    """The disk integration of (N, 4) CUDA rays through D2 (a rotating
    family, params = (M, a, p)) or D3 ('KerrDS', params = (M, a, Lambda)),
    launched in `launch_order` (G1r's or G1d's) and put back in the
    caller's, then the rescue and STATUS_DISK (`finish_disk_spin`):
    (final_q, final_p, status, n_steps, hit_q, hit_p), the contract of
    `integrate_batch_disk_rotating` and `disk_kds.integrate_batch_disk_kds`,
    which it matches bit for bit on the card.  Raises for CPU, misshapen
    or non-contiguous inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F32, F64))
    vec = disk_spin_params(
        gen_params(metric, delta, params, r_max, omega, order, q0s.dtype),
        r_in, r_out)
    order_idx = launch_order(q0s, p0s, float(vec[0]), metric)
    out_s, ns_s, hit_s = launch_fantasy_gen_disk_spin(
        q0s[order_idx], p0s[order_idx], vec, steps, metric)
    out, ns = _unsorted(order_idx, out_s, ns_s)
    hit = torch.empty_like(hit_s)
    hit[order_idx] = hit_s
    # the read-out takes the state rows (q1, p1, q2)
    state = tuple(out[0:8]) + tuple(out[16:20])
    return finish_disk_spin(state, ns, hit, out[8:12].T, out[12:16].T, q0s,
                            p0s, vec, metric, params)
