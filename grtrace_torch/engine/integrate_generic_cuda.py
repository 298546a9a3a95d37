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
    `disk_static.integrate_batch_disk_static`).

Port-side kernels: JAX runs this engine in XLA loops, not in Pallas, so
they replace no TPU kernel.  One thread integrates one ray, float32 or
float64; G1's wrapper launches the rays sorted by a cost key and puts the
results back in the caller's order.  Their eager twins,
`integrate_generic_twin`, `trajectory_generic_twin` and
`trajectory_generic_unmasked` (engine/integrate_generic.py), define their
results, and each kernel and
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
from ..physics.static_metrics import STATIC_F, b_critical_cached
from .integrate_generic import (N_SCAL, finish_generic_bl,
                                finish_generic_static, gen_params)

# Kernel launches since the process started (or since a caller reset it):
# G1, S2 in every chart, T2; G1s, S2s in the static chart, T2s, D1.
launches = 0
traj_launches = 0
trace_launches = 0
static_launches = 0
static_traj_launches = 0
static_trace_launches = 0
disk_launches = 0

F32, F64 = torch.float32, torch.float64
ENTRIES = {F32: "grt_fantasy_gen_bl_f32_launch",
           F64: "grt_fantasy_gen_bl_f64_launch"}
TRAJ_ENTRIES = {("Kerr", F32): "grt_fantasy_gen_traj_bl_f32_launch",
                ("Kerr", F64): "grt_fantasy_gen_traj_bl_f64_launch",
                ("KerrSchild", F32): "grt_fantasy_gen_traj_ks_f32_launch",
                ("KerrSchild", F64): "grt_fantasy_gen_traj_ks_f64_launch"}
TRACE_ENTRIES = {F32: "grt_fantasy_gen_trace_bl_f32_launch",
                 F64: "grt_fantasy_gen_trace_bl_f64_launch"}
STATIC_ENTRIES = {F32: "grt_fantasy_gen_static_f32_launch",
                  F64: "grt_fantasy_gen_static_f64_launch"}
STATIC_TRAJ_ENTRIES = {F32: "grt_fantasy_gen_traj_static_f32_launch",
                       F64: "grt_fantasy_gen_traj_static_f64_launch"}
STATIC_TRACE_ENTRIES = {F32: "grt_fantasy_gen_trace_static_f32_launch",
                        F64: "grt_fantasy_gen_trace_static_f64_launch"}
DISK_ENTRIES = {F32: "grt_fantasy_gen_disk_static_f32_launch",
                F64: "grt_fantasy_gen_disk_static_f64_launch"}
OUT_ROWS = 12  # G1 writes q1, p1, q2
DISK_ROWS = 16  # D1 writes q1, p1, hit_q, hit_p


def _n_sub(params, dtype, extra=0):
    n_sub = (params.numel() - N_SCAL - extra) // 3
    if (params.dtype != dtype or n_sub < 1
            or params.numel() != N_SCAL + 3 * n_sub + extra):
        raise ValueError("params must be the gen_params vector [M, a, Q, "
                         "r_cap, r_max, r_plus, plunge_zone, jump_cap, "
                         "cap_park, err_park, (d, cos, sin) x n_sub] in the "
                         "rays' dtype")
    return n_sub


def _call(entry, q0s, ptrs, params, ints):
    from ..kernels.build import load
    lib = load()
    params_dev = params.to(q0s.device)
    with torch.cuda.device(q0s.device):  # launch on the data's card
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(q0s.data_ptr(), *ptrs,
                                  params_dev.data_ptr(), *ints, stream)
    if err != 0:
        raise KernelLaunchError(f"{entry} failed: cudaError {err}")


def launch_fantasy_gen(q0s, p0s, params, steps, static=False):
    """Launch G1 (G1s with `static`) on (N, 4) float32 or float64 CUDA
    rays; `params` is the Boyer-Lindquist (static chart's) `gen_params`
    vector in the rays' dtype.  Returns (out (12, N): q1, p1, q2 rows; ns
    (N,) int32, negative for guard-parked rays)."""
    global launches, static_launches
    _check_inputs(q0s, p0s, (F32, F64))
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype)
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((OUT_ROWS, n), dtype=q0s.dtype, device=q0s.device)
    ns = torch.empty((n,), dtype=torch.int32, device=q0s.device)
    if n == 0:
        return out, ns
    _call((STATIC_ENTRIES if static else ENTRIES)[q0s.dtype], q0s,
          (p0s.data_ptr(), out.data_ptr(), ns.data_ptr()), params,
          (n, n_sub, int(steps)))
    if static:
        static_launches += 1
    else:
        launches += 1
    return out, ns


def launch_fantasy_gen_traj(q0s, p0s, params, steps, stride, n_keep,
                            metric="Kerr"):
    """Launch S2 in `metric`'s chart ('Kerr', 'KerrSchild', or S2s for a
    static family) on (N, 4) float32 or float64 CUDA rays; `params` is
    that chart's `gen_params` vector in the rays' dtype.  Returns (traj (N,
    n_keep, 4), zero past each ray's exit; ns (N,) int32, the steps each
    ray took)."""
    global traj_launches, static_traj_launches
    _check_inputs(q0s, p0s, (F32, F64))
    static = metric in STATIC_F
    entry = (STATIC_TRAJ_ENTRIES.get(q0s.dtype) if static
             else TRAJ_ENTRIES.get((metric, q0s.dtype)))
    if entry is None:
        raise ValueError(f"no S2 entry for metric {metric!r} (have "
                         f"'Kerr', 'KerrSchild' and the static families)")
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
    _call(entry, q0s, (p0s.data_ptr(), traj.data_ptr(), ns.data_ptr()),
          params, (n, n_sub, int(steps), int(stride), int(n_keep)))
    if static:
        static_traj_launches += 1
    else:
        traj_launches += 1
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


def _sorted_rays(q0s, p0s, mass, b_crit=None):
    """(launch order, q0s and p0s in that order): the rays by cost key."""
    order_idx = torch.argsort(_cost_sort_key_bl(q0s, p0s, mass, b_crit),
                              stable=True)
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
    """Integrate (N, 4) rays of the spherical charts through G1 ('Kerr',
    then the exact rescue) or G1s (a static family, no rescue):
    (final_q, final_p, status, n_steps), the contract of
    `integrate_batch_generic(metric=...)`, which it matches bit for bit
    on the card.  Rays are launched in cost-sorted order
    (`_cost_sort_key_bl`, about the family's critical impact parameter)
    and come back in the caller's.  Raises for CPU, misshapen or
    non-contiguous inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F32, F64))
    vec = gen_params(metric, delta, params, r_max, omega, order, q0s.dtype)
    static = metric in STATIC_F
    b_crit = (b_critical_cached(metric, *[float(x) for x in params][:2])
              if static else None)
    order_idx, q_s, p_s = _sorted_rays(q0s, p0s, float(vec[0]), b_crit)
    out, ns = _unsorted(order_idx, *launch_fantasy_gen(q_s, p_s, vec, steps,
                                                       static=static))
    if static:
        return finish_generic_static(tuple(out), ns, vec)
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


def launch_fantasy_gen_trace(q0s, p0s, params, steps, static=False):
    """Launch T2 (T2s with `static`) on (N, 4) float32 or float64 CUDA
    rays; `params` is the 'Kerr' (static chart's) `gen_params` vector in
    the rays' dtype.  Returns (N, steps, 8): (q1, p1) after each step,
    every element written by the kernel."""
    global trace_launches, static_trace_launches
    _check_inputs(q0s, p0s, (F32, F64))
    n = q0s.shape[0]
    n_sub = _n_sub(params, q0s.dtype)
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((n, steps, 8), dtype=q0s.dtype, device=q0s.device)
    if n == 0 or steps == 0:
        return out
    entries = STATIC_TRACE_ENTRIES if static else TRACE_ENTRIES
    _call(entries[q0s.dtype], q0s, (p0s.data_ptr(), out.data_ptr()),
          params, (n, n_sub, int(steps)))
    if static:
        static_trace_launches += 1
    else:
        trace_launches += 1
    return out


def trajectory_generic_unmasked_cuda(q0s, p0s, steps, vec, metric="Kerr"):
    """Trace (N, 4) CUDA rays through T2 ('Kerr') or T2s (a static family)
    from that chart's gen_params vector: (N, steps, 8), the contract of
    `trajectory_generic_unmasked`, which it matches bit for bit on the
    card.  Raises for CPU, misshapen or non-contiguous inputs, and for a
    failed build or launch."""
    return launch_fantasy_gen_trace(q0s, p0s, vec, steps,
                                    static=metric in STATIC_F)


def launch_fantasy_gen_disk(q0s, p0s, disk, params, steps):
    """Launch D1 on (N, 4) float32 or float64 CUDA rays of the static
    chart; disk (N, 2) holds each ray's plane constants (c1, c2), params
    is the static chart's `gen_params` vector followed by r_in and r_out
    (`disk_static.disk_params`), all in the rays' dtype.  Returns (out
    (16, N): q1, p1, hit_q, hit_p rows, the hit rows zero where the ray
    never hit; ns (N,) int32, negative for guard-parked rays; hit (N,)
    bool)."""
    global disk_launches
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
    _call(DISK_ENTRIES[q0s.dtype], q0s,
          (p0s.data_ptr(), disk.data_ptr(), out.data_ptr(), ns.data_ptr(),
           hit.data_ptr()), params, (n, n_sub, int(steps)))
    disk_launches += 1
    return out, ns, hit.bool()
