"""The compensated FANTASY integrator as a hand-written CUDA kernel
(`csrc/fantasy_eqc.cu`) — the port of the TPU kernel
`grtrace.engine.integrate_pallas._make_kernel` in its 24-row layout
(`integrate_batch_pallas(equatorial=True, compensated=True)`).

One thread integrates one ray to its exit; `integrate_batch_compensated`
(engine/integrate.py) is the eager twin that defines its result, and the
two read the same host-built scalar vector (`substep_params`).  This module
only launches: it never falls back to the twin.  Rays on the CPU belong to
`integrate_dispatch`, which sends them to the twin.
"""
from __future__ import annotations

import math

import torch

from .integrate import finish_compensated, substep_params
from ..physics.hamiltonian import pack_state_eqc

# Kernel launches since the process started (or since a caller reset it).
launches = 0


class KernelLaunchError(RuntimeError):
    """The kernel launch was refused (cudaGetLastError() != 0)."""


def _check_inputs(q0s, p0s):
    for name, t in (("q0s", q0s), ("p0s", p0s)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor "
                             f"(got {getattr(t, 'device', type(t))})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (got {t.dtype})")
        if t.dim() != 2 or t.shape[1] != 4:
            raise ValueError(f"{name} must be (N, 4) (got {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q0s.shape != p0s.shape or q0s.device != p0s.device:
        raise ValueError("q0s and p0s must match in shape and device")


def _cost_sort_key(q0s, p0s, rs):
    """Predicted integration cost |b - b_crit| (rays near the critical
    impact parameter b_crit = 3 sqrt(3) rs orbit longest); sorting by it
    lets a warp's rays retire together."""
    r0 = q0s[:, 1]
    f = 1.0 - rs / r0
    cos_a = -p0s[:, 1] / torch.sqrt(f)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    b = r0 * sin_a / torch.sqrt(f)
    return (b - 3.0 * math.sqrt(3.0) * rs).abs()


def launch_fantasy_eqc(state_in, params, steps):
    """Launch the kernel on a packed (24, N) float32 state.

    Returns (state_out (24, N), ns (N,) int32).  `params` is the CPU
    vector from `substep_params`; it is copied to the state's device.
    """
    global launches
    from ..kernels.build import load

    n = state_in.shape[1]
    if (state_in.dtype != torch.float32 or state_in.device.type != "cuda"
            or state_in.shape[0] != 24 or not state_in.is_contiguous()):
        raise ValueError("state_in must be a contiguous (24, N) float32 "
                         "CUDA tensor")
    n_sub = (params.numel() - 3) // 4
    if params.dtype != torch.float32 or params.numel() != 3 + 4 * n_sub:
        raise ValueError("params must be float32 [rs, r_max, cap, "
                         "(d, omc, sin, bridge) x n_sub]")
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31 // 24:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    state_out = torch.empty_like(state_in)
    ns = torch.empty((n,), dtype=torch.int32, device=state_in.device)
    if n == 0:  # nothing to launch
        return state_out, ns
    lib = load()
    params_dev = params.to(state_in.device)
    with torch.cuda.device(state_in.device):  # launch on the data's card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grt_fantasy_eqc_launch(
            state_in.data_ptr(), state_out.data_ptr(), ns.data_ptr(),
            params_dev.data_ptr(), n, n_sub, int(steps), stream)
    if err != 0:
        raise KernelLaunchError(f"fantasy_eqc launch failed: cudaError {err}")
    launches += 1
    return state_out, ns


def integrate_batch_cuda(q0s, p0s, steps, delta, rs, r_max, omega, order=2):
    """Integrate float32 equatorial camera rays (theta == pi/2,
    p_theta == 0) through the CUDA kernel.

    Rays are launched in cost-sorted order (`_cost_sort_key`) so a warp's
    rays retire together.  Returns (final_q, final_p, status, n_steps) in
    the input ray order — the contract of `integrate_batch_compensated`,
    which it matches bit for bit on the card.  Raises for CPU, float64, misshapen or non-contiguous
    inputs, and for a failed build or launch.
    """
    _check_inputs(q0s, p0s)
    params = substep_params(delta, rs, r_max, omega, order, torch.float32)
    rs_f, r_max_f = float(params[0]), float(params[1])
    order_idx = torch.argsort(_cost_sort_key(q0s, p0s, rs_f), stable=True)
    state_in = torch.stack(pack_state_eqc(q0s[order_idx], p0s[order_idx]))
    state_sorted, ns_sorted = launch_fantasy_eqc(state_in, params, steps)
    state_out = torch.empty_like(state_sorted)  # back to the caller's order
    state_out[:, order_idx] = state_sorted
    ns = torch.empty_like(ns_sorted)
    ns[order_idx] = ns_sorted
    final_q, final_p, status = finish_compensated(
        tuple(state_out), q0s, p0s, rs_f, r_max_f)
    return final_q, final_p, status, ns
