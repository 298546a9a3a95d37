"""The Kerr-Schild FANTASY integrator as a hand-written CUDA kernel
(`csrc/fantasy_ks.cu`) — the port of the TPU kernel
`grtrace.engine.integrate_pallas_ks._make_kernel_ks` in plain mode (B5,
the counterpart of `integrate_batch_pallas_ks`), in disk mode (B6, the
counterpart of `integrate_batch_pallas_disk`) and in subring mode (B7, the
counterpart of `integrate_batch_pallas_subrings`).

The tangent mode (B6t, `integrate_batch_disk_tangent_cuda`) is a kernel of
its own in the same source: B6's 16-row disk step carrying one or two
forward-mode tangents, float and double; its twin is
`integrate_batch_disk_tangent_ks`.

Each mode has three instantiations of one kernel template: 32 rows float
(Kahan-compensated, the float32 production layout), 16 rows float and 16
rows double (plain).  One thread integrates one ray to its exit;
`integrate_batch_ksc` / `integrate_batch_ks`, in disk mode
`integrate_batch_disk_ksc` / `integrate_batch_disk_ks` and in subring mode
`integrate_batch_subrings_ksc` / `integrate_batch_subrings_ks`
(engine/integrate_ks.py) are the eager twins that define its result, and
all of them read the same host-built scalar vector (`ks_params`).  This
module only launches: it never falls back to a twin.  Rays on the CPU
belong to `integrate_dispatch_ks` / `_disk` / `_subrings`, which send them
to the twins.
"""
from __future__ import annotations

import math

import torch

from ..physics.hamiltonian import pack_state
from ..physics.kerr_schild import pack_state_ksc
from .integrate_cuda import KernelLaunchError, _unsort
from .integrate_ks import (N_SCAL, _check_orders, finish_disk, finish_ks,
                           finish_subrings, ks_params, ks_tangent_params,
                           n_substeps)

# Kernel launches since the process started (or since a caller reset it):
# plain mode (B5), disk mode (B6) and subring mode (B7) apart.
launches = 0
disk_launches = 0
subring_launches = 0
# the tangent mode (B6t): launches with one forward-mode direction, and
# with two (a linearization in both parameters)
disk_tangent_launches = 0
disk_tangent2_launches = 0

# (rows, dtype) -> C entry of csrc/fantasy_ks.cu, plain and disk mode
ENTRIES = {(32, torch.float32): "grt_fantasy_ks32_f32_launch",
           (16, torch.float32): "grt_fantasy_ks16_f32_launch",
           (16, torch.float64): "grt_fantasy_ks16_f64_launch"}
DISK_ENTRIES = {(32, torch.float32): "grt_fantasy_ks32_f32_disk_launch",
                (16, torch.float32): "grt_fantasy_ks16_f32_disk_launch",
                (16, torch.float64): "grt_fantasy_ks16_f64_disk_launch"}
SUB_ENTRIES = {(32, torch.float32): "grt_fantasy_ks32_f32_sub_launch",
               (16, torch.float32): "grt_fantasy_ks16_f32_sub_launch",
               (16, torch.float64): "grt_fantasy_ks16_f64_sub_launch"}
# (directions, dtype) -> C entry of the tangent mode
TANGENT_ENTRIES = {
    (1, torch.float32): "grt_fantasy_ks16_f32_disk_tangent_launch",
    (1, torch.float64): "grt_fantasy_ks16_f64_disk_tangent_launch",
    (2, torch.float32): "grt_fantasy_ks16_f32_disk_tangent2_launch",
    (2, torch.float64): "grt_fantasy_ks16_f64_disk_tangent2_launch"}
DISK_ROWS = 9  # hit flag, hit_q (4), hit_p (4)


def _check_inputs(q0s, p0s, compensated):
    for name, t in (("q0s", q0s), ("p0s", p0s)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor "
                             f"(got {getattr(t, 'device', type(t))})")
        if t.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"{name} must be float32 or float64 "
                             f"(got {t.dtype})")
        if t.dim() != 2 or t.shape[1] != 4:
            raise ValueError(f"{name} must be (N, 4) (got {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (q0s.shape != p0s.shape or q0s.device != p0s.device
            or q0s.dtype != p0s.dtype):
        raise ValueError("q0s and p0s must match in shape, dtype and device")
    if compensated and q0s.dtype != torch.float32:
        raise ValueError("the compensated (32-row) kernel takes float32 rays")


def _cost_sort_key_ks(q0s, p0s, mass):
    """Predicted cost key: the flat impact parameter's distance to the
    Schwarzschild critical ring 3 sqrt(3) M.  It only has to cluster the
    long-running photon-ring rays into the same warps."""
    lvec = torch.linalg.cross(q0s[:, 1:], p0s[:, 1:], dim=1)
    e = torch.abs(p0s[:, 0])
    b = torch.linalg.vector_norm(lvec, dim=1) / torch.clamp(e, min=1e-30)
    return torch.abs(b - 3.0 * math.sqrt(3.0) * mass)


def _launch(state_in, params, steps, mode="plain", n_orders=0):
    """Check, allocate and launch one entry of `mode` ('plain', 'disk' or
    'subring'); returns (state_out, ns, recorder outputs: () in plain
    mode, (disk_rows,) in disk mode, (count, slot_rows) in subring
    mode)."""
    from ..kernels.build import load

    if (not isinstance(state_in, torch.Tensor)
            or state_in.device.type != "cuda" or state_in.dim() != 2
            or not state_in.is_contiguous()):
        raise ValueError("state_in must be a contiguous (rows, N) CUDA tensor")
    n_rows, n = state_in.shape
    table = {"plain": ENTRIES, "disk": DISK_ENTRIES,
             "subring": SUB_ENTRIES}[mode]
    entry = table.get((n_rows, state_in.dtype))
    if entry is None:
        raise ValueError(f"no KS kernel for {n_rows} rows of "
                         f"{state_in.dtype} (have {sorted(map(str, table))})")
    n_sub = n_substeps(params)
    disk = mode == "disk"
    tail = 2 if disk else 0
    if (params.dtype != state_in.dtype or n_sub < 1
            or params.numel() != N_SCAL + 4 * n_sub + tail):
        raise ValueError("params must be [M, a, Q, r_cap, r_max, plunge_zone, "
                         "(d, cw, sw, bridge) x n_sub"
                         + (", r_in, r_out" if disk else "")
                         + "] in the state's dtype")
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    state_out = torch.empty_like(state_in)
    ns = torch.empty((n,), dtype=torch.int32, device=state_in.device)
    if disk:
        recs = (torch.empty((DISK_ROWS, n), dtype=state_in.dtype,
                            device=state_in.device),)
    elif mode == "subring":
        n_orders = _check_orders(n_orders)
        # zero-filled: unfilled slots stay +0.0 (the TPU's zero carry)
        recs = (torch.empty((n,), dtype=torch.int32, device=state_in.device),
                torch.zeros((8 * n_orders, n), dtype=state_in.dtype,
                            device=state_in.device))
    else:
        recs = ()
    if n == 0:  # nothing to launch
        return state_out, ns, recs
    lib = load()
    params_dev = params.to(state_in.device)
    ptrs = [t.data_ptr() for t in (state_in, state_out, ns) + recs]
    ints = [n, n_sub, int(steps)] + ([n_orders] if mode == "subring" else [])
    with torch.cuda.device(state_in.device):  # launch on the data's card
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*ptrs, params_dev.data_ptr(), *ints,
                                  stream)
    if err != 0:
        raise KernelLaunchError(f"{entry} failed: cudaError {err}")
    return state_out, ns, recs


def launch_fantasy_ks(state_in, params, steps):
    """Launch the plain-mode kernel (B5) on a packed (32 | 16, N) state.

    Returns (state_out, ns (N,) int32, negative for guard-parked rays).
    `params` is the CPU vector from `ks_params` in the state's dtype; it is
    copied to the state's device.
    """
    global launches
    state_out, ns, _ = _launch(state_in, params, steps)
    if state_in.shape[1]:
        launches += 1
    return state_out, ns


def launch_fantasy_ks_disk(state_in, params, steps):
    """Launch the disk-mode kernel (B6) on a packed (32 | 16, N) state;
    `params` is a disk-mode `ks_params` vector (ending with r_in, r_out).

    Returns (state_out, ns, disk_rows (9, N): hit flag 1/0, hit_q, hit_p).
    """
    global disk_launches
    state_out, ns, (rows,) = _launch(state_in, params, steps, mode="disk")
    if state_in.shape[1]:
        disk_launches += 1
    return state_out, ns, rows


def launch_fantasy_ks_subrings(state_in, params, steps, n_orders):
    """Launch the subring-mode kernel (B7) on a packed (32 | 16, N) state;
    `params` is a plain-mode `ks_params` vector.

    Returns (state_out, ns, count (N,) int32, slot_rows (8 n_orders, N):
    crossing s's q1 rows in 8 s .. 8 s + 3, its p2 rows in 8 s + 4 ..
    8 s + 7, zeros where a ray crossed fewer than s + 1 times).
    """
    global subring_launches
    state_out, ns, (count, slots) = _launch(state_in, params, steps,
                                            mode="subring", n_orders=n_orders)
    if state_in.shape[1]:
        subring_launches += 1
    return state_out, ns, count, slots


def _sorted_state(q0s, p0s, vec, compensated):
    """(launch order, packed state in that order)."""
    order_idx = torch.argsort(_cost_sort_key_ks(q0s, p0s, float(vec[0])),
                              stable=True)
    pack = pack_state_ksc if compensated else pack_state
    return order_idx, torch.stack(pack(q0s[order_idx], p0s[order_idx]))


def integrate_batch_ks_cuda(q0s, p0s, steps, delta, params, r_max, omega,
                            order=2, compensated=True):
    """Integrate (N, 4) Kerr-Schild camera rays through the CUDA kernel:
    the 32-row compensated layout (float32 rays) or, with
    compensated=False, the 16-row plain one (float32 or float64).

    Rays are launched in cost-sorted order (`_cost_sort_key_ks`) and the
    results come back in the input order, after the Bardeen rescue:
    (final_q, final_p, status, n_steps), the contract of the twins, which
    it matches bit for bit on the card.  Raises for CPU, misshapen or
    non-contiguous inputs, and for a failed build or launch.
    """
    _check_inputs(q0s, p0s, compensated)
    vec = ks_params(delta, params, r_max, omega, order, compensated,
                    q0s.dtype)
    order_idx, state_in = _sorted_state(q0s, p0s, vec, compensated)
    state_sorted, ns_sorted = launch_fantasy_ks(state_in, vec, steps)
    return finish_ks(tuple(_unsort(state_sorted, order_idx)),
                     _unsort(ns_sorted, order_idx), q0s, p0s, vec,
                     compensated)


def integrate_batch_disk_cuda(q0s, p0s, steps, delta, params, r_max, omega,
                              r_in, r_out, order=2, compensated=True):
    """Integrate (N, 4) Kerr-Schild camera rays through kernel B6, the disk
    mode: the 32-row compensated layout (float32 rays) or, with
    compensated=False, the 16-row plain one (float32 or float64).

    Cost-sorted launch, results (the recorder rows too) back in the input
    order: (final_q, final_p, status, n_steps, hit_q, hit_p) with
    STATUS_DISK for the rays frozen at their first equatorial crossing
    inside [r_in, r_out], the contract of the twins, which it matches bit
    for bit on the card.  Raises for CPU, misshapen or non-contiguous
    inputs, and for a failed build or launch.
    """
    _check_inputs(q0s, p0s, compensated)
    vec = ks_params(delta, params, r_max, omega, order, compensated,
                    q0s.dtype, disk=(r_in, r_out))
    order_idx, state_in = _sorted_state(q0s, p0s, vec, compensated)
    state_sorted, ns_sorted, rows_sorted = launch_fantasy_ks_disk(
        state_in, vec, steps)
    return finish_disk(tuple(_unsort(state_sorted, order_idx)),
                       _unsort(ns_sorted, order_idx),
                       _unsort(rows_sorted, order_idx), q0s, p0s, vec,
                       compensated)


def launch_fantasy_ks_disk_tangent(state_in, tan_in, params, dparams,
                                   steps):
    """Launch kernel B6t, the tangent mode, on a packed (16, N) state and
    the (16 K, N) tangent rows of K = 1 or 2 directions (direction d in
    rows 16 d .. 16 d + 15); `params` is a disk-mode `ks_params` vector and
    `dparams` its (K, 3) tangents (`ks_tangent_params`), CPU tensors in the
    state's dtype.

    Returns (state_out, ns, disk_rows (9, N), disk_d_rows (8 K, N): per
    direction the tangents of hit_q and hit_p, zeros where no ray hit).
    """
    global disk_tangent_launches, disk_tangent2_launches
    from ..kernels.build import load

    for name, t in (("state_in", state_in), ("tan_in", tan_in)):
        if (not isinstance(t, torch.Tensor) or t.device.type != "cuda"
                or t.dim() != 2 or t.shape[0] % 16
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (16 K, N) CUDA "
                             f"tensor")
    k = tan_in.shape[0] // 16
    if (state_in.shape[0] != 16 or tan_in.shape[1] != state_in.shape[1]
            or tan_in.dtype != state_in.dtype
            or tan_in.device != state_in.device):
        raise ValueError("state_in must be (16, N) and tan_in (16 K, N), in "
                         "one dtype on one device")
    entry = TANGENT_ENTRIES.get((k, state_in.dtype))
    if entry is None:
        raise ValueError(f"no tangent KS kernel for {k} directions of "
                         f"{state_in.dtype}")
    n = state_in.shape[1]
    n_sub = n_substeps(params)
    if (params.dtype != state_in.dtype or n_sub < 1
            or params.numel() != N_SCAL + 4 * n_sub + 2
            or dparams.dtype != state_in.dtype
            or tuple(dparams.shape) != (k, 3)):
        raise ValueError("params must be a disk-mode ks_params vector and "
                         "dparams (K, 3) [dM, da, dQ], in the state's dtype")
    if not 0 <= steps < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"steps={steps} or N={n} out of the kernel's range")
    device = state_in.device
    state_out = torch.empty_like(state_in)
    ns = torch.empty((n,), dtype=torch.int32, device=device)
    rows = torch.empty((DISK_ROWS, n), dtype=state_in.dtype, device=device)
    rows_d = torch.empty((8 * k, n), dtype=state_in.dtype, device=device)
    if n == 0:
        return state_out, ns, rows, rows_d
    lib = load()
    vec_dev, dvec_dev = params.to(device), dparams.contiguous().to(device)
    ptrs = [t.data_ptr() for t in (state_in, tan_in, state_out, ns, rows,
                                   rows_d, vec_dev, dvec_dev)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*ptrs, n, n_sub, int(steps), stream)
    if err != 0:
        raise KernelLaunchError(f"{entry} failed: cudaError {err}")
    if k == 1:
        disk_tangent_launches += 1
    else:
        disk_tangent2_launches += 1
    return state_out, ns, rows, rows_d


def integrate_batch_disk_tangent_cuda(q0s, p0s, dq0s, dp0s, steps, delta,
                                      params, dparams, r_max, omega, r_in,
                                      r_out, order=2):
    """Integrate (N, 4) Kerr-Schild camera rays and K = 1 or 2 tangent
    directions (dq0s, dp0s (K, N, 4); dparams K rows of (dM, da[, dQ]))
    through one launch of kernel B6t, the 16-row tangent mode of B6
    (float32 or float64).

    B6's cost sort, applied to the tangents too; results back in the input
    order: (final_q, final_p, status, n_steps, hit_q, hit_p, hit_q_d,
    hit_p_d (K, N, 4)), the contract of the twin
    `integrate_batch_disk_tangent_ks`, which it matches bit for bit on the
    card (its first six bit for bit B6's 16-row launch, each direction bit
    for bit a launch on it alone).  Raises for CPU, misshapen or
    non-contiguous inputs, and for a failed build or launch.
    """
    _check_inputs(q0s, p0s, False)
    for name, t in (("dq0s", dq0s), ("dp0s", dp0s)):
        if (not isinstance(t, torch.Tensor) or t.dim() != 3
                or t.shape[1:] != q0s.shape or t.dtype != q0s.dtype
                or t.device != q0s.device):
            raise ValueError(f"{name} must be (K, N, 4), the rays' dtype and "
                             f"device")
    if dq0s.shape != dp0s.shape:
        raise ValueError("dq0s and dp0s must match in shape")
    vec = ks_params(delta, params, r_max, omega, order, False, q0s.dtype,
                    disk=(r_in, r_out))
    dvec = ks_tangent_params(dparams, q0s.dtype)
    order_idx, state_in = _sorted_state(q0s, p0s, vec, False)
    n = q0s.shape[0]
    tan_in = torch.stack(pack_state(dq0s[:, order_idx], dp0s[:, order_idx]),
                         dim=1).reshape(-1, n)
    state_sorted, ns_sorted, rows_sorted, rows_d_sorted = \
        launch_fantasy_ks_disk_tangent(state_in, tan_in, vec, dvec, steps)
    out = finish_disk(tuple(_unsort(state_sorted, order_idx)),
                      _unsort(ns_sorted, order_idx),
                      _unsort(rows_sorted, order_idx), q0s, p0s, vec, False)
    rows_d = _unsort(rows_d_sorted, order_idx).reshape(-1, 8, n)
    return out + (rows_d[:, :4].transpose(1, 2).contiguous(),
                  rows_d[:, 4:].transpose(1, 2).contiguous())


def integrate_batch_subrings_cuda(q0s, p0s, steps, delta, params, r_max,
                                  omega, n_orders=3, order=2,
                                  compensated=True):
    """Integrate (N, 4) Kerr-Schild camera rays through kernel B7, the
    subring mode: the 32-row compensated layout (float32 rays) or, with
    compensated=False, the 16-row plain one (float32 or float64).

    Cost-sorted launch; the state, the counts and the slot rows come back
    in the input order: (final_q, final_p, status, n_steps, hits_q
    (n_orders, N, 4), hits_p, count), the contract of the twins, which it
    matches bit for bit on the card.  Raises for CPU, misshapen or
    non-contiguous inputs, n_orders < 1, and for a failed build or launch.
    """
    _check_inputs(q0s, p0s, compensated)
    n_orders = _check_orders(n_orders)
    vec = ks_params(delta, params, r_max, omega, order, compensated,
                    q0s.dtype)
    order_idx, state_in = _sorted_state(q0s, p0s, vec, compensated)
    state_sorted, ns_sorted, cnt_sorted, slots_sorted = \
        launch_fantasy_ks_subrings(state_in, vec, steps, n_orders)
    return finish_subrings(tuple(_unsort(state_sorted, order_idx)),
                           _unsort(ns_sorted, order_idx),
                           _unsort(cnt_sorted, order_idx),
                           _unsort(slots_sorted, order_idx), q0s, p0s, vec,
                           compensated)
