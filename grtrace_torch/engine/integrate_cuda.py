"""The Schwarzschild FANTASY integrators as hand-written CUDA kernels — the
port of the TPU kernel `grtrace.engine.integrate_pallas._make_kernel` in
all four of its configurations:

  * B1, 24 rows, Kahan-compensated, staggered, open/close
    (`csrc/fantasy_eqc.cu`, `integrate_batch_cuda`; JAX:
    `integrate_batch_pallas(equatorial=True, compensated=True)`);
  * B2, 12 rows, plain, staggered, open/close, float64 (the same template,
    `integrate_batch_eq_cuda`; JAX: `integrate_batch_pallas(equatorial=True,
    compensated=False)` on float64 rays);
  * B3, 16 rows, plain, fused flows, float32 and float64 (the integrate
    mode of `csrc/fantasy_schw16.cu`; `integrate_batch_generic_cuda` and
    the checkpoint chunk `advance_state_cuda`; JAX: `integrate_batch_pallas(
    equatorial=False)` and `advance_state_pallas`);
  * B4, B1's core loop only, on an opened carry (`fantasy_eqc.cu`,
    `advance_state_eqc_cuda`; JAX: `advance_state_pallas_eqc`);

and the port-side trajectory recorder S1 (the record mode of
`csrc/fantasy_schw16.cu`, B3's step; `integrate_batch_full_cuda`) and
trace T1 (its trace mode; `trajectory_unmasked_cuda`), which replace no
TPU kernel: the JAX package samples trajectories in an XLA loop
(`integrate_batch_full`) and runs the EinsteinPy-compatible classes on an
XLA scan (`grtrace.compat.einsteinpy._trajectory`).

One thread integrates one ray.  The eager twins that define the kernels'
results are `integrate_batch_compensated`, `integrate_batch_eq`,
`integrate_batch_fused`, `integrate_batch_full` and `trajectory_unmasked`
(engine/integrate.py)
and the chunk twins of engine/checkpoint.py; each kernel and its twin
read the same host-built scalar vector (`substep_params`).  This module
only launches: it never falls back to a twin, and every wrapper raises for
CPU tensors.  Rays on the CPU belong to `integrate_dispatch`,
`integrate_full_dispatch` and `trajectory_dispatch`, which send them to
the twins.
"""
from __future__ import annotations

import math

import torch

from .integrate import (finish_compensated, finish_eq, finish_generic,
                        substep_params, trace_params, traj_layout)
from ..physics.hamiltonian import pack_state, pack_state_eq, pack_state_eqc

# Kernel launches since the process started (or since a caller reset it),
# one counter per configuration: B1, B2, B3 (monolithic and chunk), B4, S1,
# T1.
launches = 0
eq_launches = 0
generic_launches = 0
chunk_launches = 0
traj_launches = 0
trace_launches = 0

F32, F64 = torch.float32, torch.float64
# configuration -> ({dtype: C entry}, state rows, scalars per substep)
CONFIGS = {
    "eqc": ({F32: "grt_fantasy_eqc_launch"}, 24, 4),
    "eq": ({F64: "grt_fantasy_eq_f64_launch"}, 12, 4),
    "schw16": ({F32: "grt_fantasy_schw16_f32_launch",
                F64: "grt_fantasy_schw16_f64_launch"}, 16, 3),
    "eqc_chunk": ({F32: "grt_fantasy_eqc_chunk_launch"}, 24, 4),
}


class KernelLaunchError(RuntimeError):
    """The kernel launch was refused (cudaGetLastError() != 0)."""


def _check_inputs(q0s, p0s, dtypes):
    for name, t in (("q0s", q0s), ("p0s", p0s)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor "
                             f"(got {getattr(t, 'device', type(t))})")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(str(d)[6:] for d in dtypes)} "
                             f"(got {t.dtype})")
        if t.dim() != 2 or t.shape[1] != 4:
            raise ValueError(f"{name} must be (N, 4) (got {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (q0s.shape != p0s.shape or q0s.device != p0s.device
            or q0s.dtype != p0s.dtype):
        raise ValueError("q0s and p0s must match in shape, dtype and device")


def _impact_parameter(q0s, p0s, rs):
    """The camera ray's impact parameter b = r0 sin(alpha) / sqrt(f), from
    cos(alpha) = -p_r / sqrt(f), f = 1 - rs / r0, term for term as
    `grtrace.engine.integrate_pallas._cost_sort_key` forms it."""
    r0 = q0s[:, 1]
    f = 1.0 - rs / r0
    cos_a = -p0s[:, 1] / torch.sqrt(f)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    return r0 * sin_a / torch.sqrt(f)


def _cost_sort_key(q0s, p0s, rs):
    """Predicted integration cost |b - b_crit|: rays near the critical
    impact parameter b_crit = 3 sqrt(3) M = 1.5 sqrt(3) rs orbit longest,
    and sorting by it lets a warp's rays retire together.  (The JAX
    package's key centres on 3 sqrt(3) rs, twice b_crit; only the launch
    order differs, and no result depends on it.)"""
    b = _impact_parameter(q0s, p0s, rs)
    return (b - 1.5 * math.sqrt(3.0) * rs).abs()


def _call(entry, device, ptrs, params, ints):
    """Launch the C entry `entry` on `device`'s current stream: the tensor
    pointers, then `params` (a CPU vector, copied to the device), then the
    integer arguments; raises KernelLaunchError when the launch fails."""
    from ..kernels.build import load

    lib = load()
    params_dev = params.to(device)
    with torch.cuda.device(device):  # launch on the data's card
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*ptrs, params_dev.data_ptr(), *ints,
                                  stream)
    if err != 0:
        raise KernelLaunchError(f"{entry} failed: cudaError {err}")


def _check_triples(params, dtype):
    """The number of substeps of a plain-triples vector [rs, r_max, cap,
    (d, cos, sin) x n_sub] in `dtype` (S1's and T1's); raises otherwise."""
    n_sub = (params.numel() - 3) // 3
    if params.dtype != dtype or n_sub < 1 or params.numel() != 3 + 3 * n_sub:
        raise ValueError("params must be [rs, r_max, cap, (d, cos, sin) x "
                         "n_sub] in the rays' dtype")
    return n_sub


def _launch(config, state_in, params, steps):
    """Check, allocate and launch one configuration on a packed (rows, N)
    state; returns (state_out, ns (N,) int32, the steps each ray took).
    `params` is the CPU vector from `substep_params` in the state's dtype;
    it is copied to the state's device."""
    entries, rows, width = CONFIGS[config]
    dtypes = " or ".join(str(d)[6:] for d in entries)
    if (not isinstance(state_in, torch.Tensor)
            or state_in.device.type != "cuda" or state_in.dim() != 2
            or state_in.shape[0] != rows or state_in.dtype not in entries
            or not state_in.is_contiguous()):
        raise ValueError(f"state_in must be a contiguous ({rows}, N) "
                         f"{dtypes} CUDA tensor")
    n = state_in.shape[1]
    n_sub = (params.numel() - 3) // width
    if (params.dtype != state_in.dtype or n_sub < 1
            or params.numel() != 3 + width * n_sub):
        raise ValueError(f"params must be [rs, r_max, cap, ({width} "
                         f"scalars) x n_sub] in the state's dtype")
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31 // rows:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    state_out = torch.empty_like(state_in)
    ns = torch.empty((n,), dtype=torch.int32, device=state_in.device)
    if n == 0:  # nothing to launch
        return state_out, ns
    _call(entries[state_in.dtype], state_in.device,
          (state_in.data_ptr(), state_out.data_ptr(), ns.data_ptr()),
          params, (n, n_sub, int(steps)))
    return state_out, ns


def launch_fantasy_eqc(state_in, params, steps):
    """Launch kernel B1 on a packed (24, N) float32 state (open, cores,
    close).  Returns (state_out (24, N), ns (N,) int32)."""
    global launches
    out = _launch("eqc", state_in, params, steps)
    if state_in.shape[1]:
        launches += 1
    return out


def launch_fantasy_eq(state_in, params, steps):
    """Launch kernel B2 on a packed (12, N) float64 state; `params` is the
    plain staggered vector (`substep_params(compensated=False)`)."""
    global eq_launches
    out = _launch("eq", state_in, params, steps)
    if state_in.shape[1]:
        eq_launches += 1
    return out


def launch_fantasy_schw16(state_in, params, steps):
    """Launch kernel B3 on a (16, N) float32 or float64 state; `params` is
    the plain-triples vector (`substep_params(compensated=False,
    staggered=False)`).  ns counts the steps applied in this launch."""
    global generic_launches
    out = _launch("schw16", state_in, params, steps)
    if state_in.shape[1]:
        generic_launches += 1
    return out


def launch_fantasy_eqc_chunk(state_in, params, steps):
    """Launch kernel B4 (B1's core loop, no open or close) on an opened
    (24, N) float32 carry.  ns counts the steps applied in this launch."""
    global chunk_launches
    out = _launch("eqc_chunk", state_in, params, steps)
    if state_in.shape[1]:
        chunk_launches += 1
    return out


def _sorted(q0s, p0s, rs):
    """(launch order, q0s and p0s in that order)."""
    order_idx = torch.argsort(_cost_sort_key(q0s, p0s, rs), stable=True)
    return order_idx, q0s[order_idx], p0s[order_idx]


def _unsort(rows, order_idx):
    """(R, N) or (N,) launch-order rows back to the caller's order."""
    out = torch.empty_like(rows)
    out[..., order_idx] = rows
    return out


def integrate_batch_cuda(q0s, p0s, steps, delta, rs, r_max, omega, order=2):
    """Integrate float32 equatorial camera rays (theta == pi/2,
    p_theta == 0) through kernel B1.

    Rays are launched in cost-sorted order (`_cost_sort_key`) so a warp's
    rays retire together.  Returns (final_q, final_p, status, n_steps) in
    the input ray order — the contract of `integrate_batch_compensated`,
    which it matches bit for bit on the card.  Raises for CPU, float64,
    misshapen or non-contiguous inputs, and for a failed build or launch.
    """
    _check_inputs(q0s, p0s, (F32,))
    params = substep_params(delta, rs, r_max, omega, order, F32)
    rs_f, r_max_f = float(params[0]), float(params[1])
    order_idx, q_s, p_s = _sorted(q0s, p0s, rs_f)
    state_sorted, ns_sorted = launch_fantasy_eqc(
        torch.stack(pack_state_eqc(q_s, p_s)), params, steps)
    final_q, final_p, status = finish_compensated(
        tuple(_unsort(state_sorted, order_idx)), q0s, p0s, rs_f, r_max_f)
    return final_q, final_p, status, _unsort(ns_sorted, order_idx)


def integrate_batch_eq_cuda(q0s, p0s, steps, delta, rs, r_max, omega,
                            order=2):
    """Integrate float64 equatorial camera rays through kernel B2 (the
    float64 render's integrator): cost-sorted launch, results in the
    input order, the contract of `integrate_batch_eq`, which it matches
    bit for bit on the card.  Raises for CPU, float32, misshapen or
    non-contiguous inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F64,))
    params = substep_params(delta, rs, r_max, omega, order, F64,
                            compensated=False)
    rs_f, r_max_f = float(params[0]), float(params[1])
    order_idx, q_s, p_s = _sorted(q0s, p0s, rs_f)
    state_sorted, ns_sorted = launch_fantasy_eq(
        torch.stack(pack_state_eq(q_s, p_s)), params, steps)
    final_q, final_p, status = finish_eq(
        tuple(_unsort(state_sorted, order_idx)), q0s, p0s, rs_f, r_max_f)
    return final_q, final_p, status, _unsort(ns_sorted, order_idx)


def integrate_batch_generic_cuda(q0s, p0s, steps, delta, rs, r_max, omega,
                                 order=2):
    """Integrate (N, 4) float32 or float64 rays in any plane through kernel
    B3 (the 16-row fused-flow kernel): cost-sorted launch, results in the
    input order, the contract of `integrate_batch_fused`, which it matches
    bit for bit on the card.  Raises for CPU, misshapen or non-contiguous
    inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F32, F64))
    params = substep_params(delta, rs, r_max, omega, order, q0s.dtype,
                            compensated=False, staggered=False)
    rs_f, r_max_f = float(params[0]), float(params[1])
    order_idx, q_s, p_s = _sorted(q0s, p0s, rs_f)
    state_sorted, ns_sorted = launch_fantasy_schw16(
        torch.stack(pack_state(q_s, p_s)), params, steps)
    final_q, final_p, status = finish_generic(
        tuple(_unsort(state_sorted, order_idx)), q0s, p0s, rs_f, r_max_f)
    return final_q, final_p, status, _unsort(ns_sorted, order_idx)


def advance_state_cuda(state16, steps, delta, rs, r_max, omega, order=2):
    """Advance a (16, N) phase-space-doubled carry by at most `steps`
    masked steps through kernel B3 — the counterpart of
    `integrate_pallas.advance_state_pallas`, no sorting (the caller owns
    ray order across chunks).  Returns (state16, n_steps_applied)."""
    params = substep_params(delta, rs, r_max, omega, order, state16.dtype,
                            compensated=False, staggered=False)
    return launch_fantasy_schw16(state16, params, steps)


def advance_state_eqc_cuda(state24, steps, delta, rs, r_max, omega,
                           order=2):
    """Advance a (24, N) opened, compensated equatorial carry by at most
    `steps` core steps through kernel B4 — the counterpart of
    `integrate_pallas.advance_state_pallas_eqc`, no sorting.  Returns
    (state24, n_steps_applied).  B4 is float32 only: the JAX package
    makes a float64 'eqc' carry only when a caller forces compensated=True
    on float64 rays."""
    if state24.dtype != F32:
        raise ValueError(f"kernel B4 takes a float32 'eqc' carry (got "
                         f"{state24.dtype}): the JAX package makes a "
                         f"float64 one only when a caller forces "
                         f"compensated=True on float64 rays; advance it "
                         f"with backend='torch'")
    params = substep_params(delta, rs, r_max, omega, order, F32)
    return launch_fantasy_eqc_chunk(state24, params, steps)


# S1's entries, exported by fantasy_schw16.cu's library (its record mode)
TRAJ_ENTRIES = {F32: "grt_fantasy_traj_f32_launch",
                F64: "grt_fantasy_traj_f64_launch"}


def launch_fantasy_traj(q0s, p0s, params, steps, stride, n_keep):
    """Launch kernel S1 on (N, 4) float32 or float64 CUDA rays; `params`
    is the plain-triples vector (`substep_params(compensated=False,
    staggered=False)`) in the rays' dtype.  Returns (traj (N, n_keep, 4),
    zero past each ray's exit; ns (N,) int32, the steps each ray took)."""
    global traj_launches
    _check_inputs(q0s, p0s, (F32, F64))
    n = q0s.shape[0]
    n_sub = _check_triples(params, q0s.dtype)
    if (not 0 <= steps < 2 ** 31 or not 1 <= stride < 2 ** 31
            or not 0 <= n_keep < 2 ** 31 or n >= 2 ** 31
            or n_keep * stride < steps):
        raise ValueError(f"steps={steps}, stride={stride}, n_keep={n_keep} "
                         f"or N={n} out of the kernel's range")
    # the slots past a ray's exit stay +0.0; the kernel indexes them in
    # 64 bits (N * n_keep * 4 may pass 2**31)
    traj = torch.zeros((n, n_keep, 4), dtype=q0s.dtype, device=q0s.device)
    ns = torch.zeros((n,), dtype=torch.int32, device=q0s.device)
    if n == 0:
        return traj, ns
    _call(TRAJ_ENTRIES[q0s.dtype], q0s.device,
          (q0s.data_ptr(), p0s.data_ptr(), traj.data_ptr(), ns.data_ptr()),
          params, (n, n_sub, int(steps), int(stride), int(n_keep)))
    traj_launches += 1
    return traj, ns


def integrate_batch_full_cuda(q0s, p0s, steps, delta, rs, r_max, omega,
                              n_keep=None, order=2, return_steps=False):
    """Record the trajectories of (N, 4) float32 or float64 CUDA rays in
    any plane through kernel S1: (N, n_keep, 4) positions, q1 every
    `stride` steps (`traj_layout`), the contract of `integrate_batch_full`,
    which it matches bit for bit on the card; with return_steps, also the
    (N,) int32 steps each ray took.  Rays keep the caller's order (tens of
    rays fill no more than a warp or two).  Raises for CPU, misshapen or
    non-contiguous inputs, and for a failed build or launch."""
    _check_inputs(q0s, p0s, (F32, F64))
    stride, n_keep_eff = traj_layout(steps, n_keep)
    params = substep_params(delta, rs, r_max, omega, order, q0s.dtype,
                            compensated=False, staggered=False)
    traj, ns = launch_fantasy_traj(q0s, p0s, params, steps, stride,
                                   n_keep_eff)
    return (traj, ns) if return_steps else traj


# T1's entries, exported by fantasy_schw16.cu's library (its trace mode)
TRACE_ENTRIES = {F32: "grt_fantasy_trace_f32_launch",
                 F64: "grt_fantasy_trace_f64_launch"}


def launch_fantasy_trace(q0s, p0s, params, steps):
    """Launch kernel T1 on (N, 4) float32 or float64 CUDA rays; `params` is
    the `trace_params` vector in the rays' dtype.  Returns (N, steps, 8):
    (q1, p1) after each step, every element written by the kernel."""
    global trace_launches
    _check_inputs(q0s, p0s, (F32, F64))
    n = q0s.shape[0]
    n_sub = _check_triples(params, q0s.dtype)
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    out = torch.empty((n, steps, 8), dtype=q0s.dtype, device=q0s.device)
    if n == 0 or steps == 0:
        return out
    _call(TRACE_ENTRIES[q0s.dtype], q0s.device,
          (q0s.data_ptr(), p0s.data_ptr(), out.data_ptr()), params,
          (n, n_sub, int(steps)))
    trace_launches += 1
    return out


def trajectory_unmasked_cuda(q0s, p0s, steps, delta, rs, omega, order=2):
    """Trace (N, 4) float32 or float64 CUDA rays through kernel T1: (N,
    steps, 8), (q1, p1) after every step, the contract of
    `trajectory_unmasked`, which it matches bit for bit on the card.
    Raises for CPU, misshapen or non-contiguous inputs, and for a failed
    build or launch."""
    return launch_fantasy_trace(
        q0s, p0s, trace_params(delta, rs, omega, order, q0s.dtype), steps)
