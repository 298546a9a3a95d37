"""Observability for the port: per-stage timers and throughput of one render,
the kernels' operation counts and the card's peaks (one table for
`--print-metrics` and chip_smoke.py's bounds), and a torch.profiler trace —
the torch counterpart of `grtrace.engine.metrics`.

PyTorch returns before the card finishes, so on a process that has started
CUDA a stage synchronizes the card before it reads the clock, at both ends:
the time a stage reports is the time its work took, not its enqueue.
A share of the card's peak is reported only for work that ran on a card,
beside that card's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class RenderMetrics:
    """Stage timings and ray/step counts for one render.  A stage named
    "outer/part" times a part of the stage "outer" that encloses it; the
    total counts the outer stages only."""
    stages: Dict[str, float] = field(default_factory=dict)
    rays: int = 0
    geodesic_steps: int = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    @property
    def total_s(self) -> float:
        return sum(v for k, v in self.stages.items() if "/" not in k)

    def _pipeline_s(self) -> float:
        return self.stages.get("device_pipeline", self.total_s)

    @property
    def rays_per_s(self) -> float:
        t = self._pipeline_s()
        return self.rays / t if t > 0 else 0.0

    @property
    def steps_per_s(self) -> float:
        t = self._pipeline_s()
        return self.geodesic_steps / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "stages_s": dict(self.stages),
            "total_s": self.total_s,
            "rays": self.rays,
            "geodesic_steps": self.geodesic_steps,
            "rays_per_s": self.rays_per_s,
            "geodesic_steps_per_s": self.steps_per_s,
        }

    def __str__(self) -> str:
        return json.dumps(self.summary())


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

# An H100 SXM's data sheet at 700 W: 67 TFLOP/s float32 and 34 TFLOP/s
# float64 outside the tensor cores, 3.35 TB/s HBM3.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12

# Floating-point operations a ray costs in each kernel, counted from the
# kernel sources (each add, subtract, multiply, divide and square root is
# one, a negation none; no FMA under -fmad=false): (per substep, per step,
# per ray).
#   fantasy_eqc (B1): per substep B M B A(bridge) = 3 flows x 42 + mixing
#                90 = 216 (at order 2 the kernel forms d / 2 once per ray,
#                not once per substep); the guard's |dr| test 2 per step;
#                once per ray d / 2 and the open flow, 1 + 42 = 43 (the
#                close, which parked rays skip, is not counted: the bound
#                stays a bound)
#   fantasy_eq (B2, float64): per substep 3 flows x 30 + mixing 72 = 162;
#                the guard 2 per step; once per ray d / 2 and the open
#                flow, 1 + 30 = 31 (the close not counted, as in B1)
#   fantasy_schw16 (B3): per substep A B M B A = 1 + 3 metric evaluations
#                x 26 (each sin and each cos counted as one operation,
#                though the card spends several on it: the bound stays a
#                bound; flow A's metric is carried to the next substep) + 4
#                applications of dt x 20 + mixing 96 = 255; the guard 2 per
#                step
#   fantasy_eqc_chunk (B4): B1's 216 per substep and 2 per step; once per
#                ray d / 2 (1), no open or close
#   fantasy_ks (B5, 32 rows): per substep 1 + 3 flows x (kick/drift 120 +
#                7 Kahan adds x 5) + mixing 120 = 586; per step the active
#                test's |q1|^2 (5; the radius is carried from the last
#                guard) and the guard 50: the sum of the 16 rows (15), h
#                from the H and S of the step's last flow A (11), the
#                tolerance |p2|^2 + 1 and its product (7) and the new radius
#                (17); once per ray the open and close flows (2 x 155) and
#                the launch's radius and active test (22) = 332 (the radius
#                a park recomputes is not counted: the bound stays a bound)
#   fantasy_ks_plain (B5, 16 rows, the float64 rays' layout): per substep 1
#                + 3 flows x (kick/drift 120 + 7 plain adds x 2) + mixing 96
#                = 499; per step the same 5 + 50 as the 32 rows; once per
#                ray the open and close flows (2 x 134) and the launch's 22
#                = 290
#   fantasy_traj (S1, the record mode of fantasy_schw16.cu): B3's 255 per
#                substep and 2 per step; once per ray 1.1 rs (1) and the
#                launch's flow A evaluation (26) = 27
#   fantasy_gen (G1; and S2 in the Boyer-Lindquist chart): per substep
#                A B M B A = 1 + 3 kick/drift evaluations x 129 (sin and
#                cos 2, the metric 33 with its 4 divisions, its r and theta
#                derivatives 59 with one 1 / sin^2 theta, the two
#                contracted kicks 22 with the five momentum products 5, the
#                drift 8; flow A's evaluation is carried to the next flow A)
#                + 4 flows applied x 12 (2 kicks and 4 drifts) + mixing 96
#                = 532; the guard's two differences 2 per step; once per ray
#                the launch's flow A evaluation, 129 (the one a park in S2
#                recomputes is not counted: the bound stays a bound)
#   fantasy_gen_traj_ks (S2 in the Kerr-Schild chart): per substep 1 + 3
#                kick/drift evaluations x 120 + 4 flows applied x (3 kicks
#                and 4 drifts) 14 + mixing 96 = 513; per step the active
#                test's radius and |x| (17 + 6) and the guard 81: the
#                geometry at the new point (35), S (6) and h (11), the
#                tolerance (7), the new radius (17) and the inward heading
#                (5); once per ray the launch's flow A evaluation, 120
#   fantasy_trace (T1, the trace mode of fantasy_schw16.cu): B3's 255 per
#                substep, nothing per step (no domain test, no guard); once
#                per ray the launch's flow A evaluation, 26
#   fantasy_gen_trace (T2, the Boyer-Lindquist trace mode of
#                fantasy_gen.cu): G1's 532 per substep, nothing per step;
#                once per ray the launch's flow A evaluation, 129
#   fantasy_gen_static (G1s; S2s as fantasy_gen_traj_static, T2s as
#                fantasy_gen_trace_static, which has nothing per step):
#                per substep 1 + 3 kick/drift evaluations x 47 (the lapse
#                12 in Kottler's branch, the least of the three: 2 M, 1 / r
#                and r^2, f 4 and f' 5, where Bardeen's takes 15 and
#                Hayward's 14; sin and cos 2, sin^2, 1 / f, 1 / sin^2,
#                g^thth and g^phph 5, the four derivative terms 9, the r
#                kick 12, the theta kick 2, the drift 5) + 4 flows applied x
#                12 + mixing 96 = 286; the guard's two differences 2 per
#                step; once per ray the launch's flow A evaluation, 47
#   fantasy_gen_disk_static (D1): G1s's 286 per substep; per step the
#                guard's 2 and the disk form u = c1 cos phi + c2 sin phi
#                with its sign product (sin and cos 2, 3 operations, the
#                product 1) = 8; once per ray the launch's flow A evaluation
#                and the first u, 47 + 5 = 52 (the crossing of a hit ray,
#                t and the lerps, is not counted: the bound stays a bound)
#   fantasy_ks_tangent (B6t, the 16-row tangent mode of B6): per substep
#                1 + 3 flows x (kick/drift 120 + its tangent 262 + 7 plain
#                adds x 2 on the rows and 7 on their tangents x 2) + mixing
#                96 on the rows and 96 on the tangents = 1,423 (the
#                tangent kick/drift, counted from the source: the
#                geometry's 67 (rho^2 6, b 3, a z 3, s 5, r^2 2, r 2, the
#                three reciprocals 3 each, w 3, the numerator of H 5 and H
#                3, l 23), S 13 and 2 H S 4, the drift 14, the radius and D
#                derivatives 49, the H derivatives 30, G 28 with 1 / r^2,
#                the S derivatives 35, S^2 2 and the kick 24); per step
#                B6's 5 + 50 and the crossing's 3 = 58; once per ray the
#                open flow with its tangent (410), the primal close (134)
#                and the launch's 22 = 566 (the crossing of a hit ray, B6's
#                59 and t's and the eight lerps' tangents 52, is not
#                counted: the bound stays a bound)
#   fantasy_ks_tangent2 (B6t with two directions): per substep 1 + 3 flows
#                x (kick/drift 120 + two tangents 2 x 262 + 7 plain adds x 2
#                on the rows and 7 on each direction's tangents x 2 x 2) +
#                mixing 96 on the rows and 2 x 96 on the tangents = 2,347
#                (1,423 + 924: the rows' and the kick/drift's 499 a substep
#                are counted once); per step B6t's 58; once per ray the open
#                flow with both tangents (134 + 2 x 276), the primal close
#                (134) and the launch's 22 = 842
#   fantasy_gen_rot (G1r; S2r as fantasy_gen_traj_rot, T2r as
#                fantasy_gen_trace_rot, which has nothing per step): S2's
#                Kerr-Schild chart with the mass function's H in each of
#                the 3 evaluations a substep: H and N' 11 (Hayward's
#                branch, the least: r^2, r^3, X, r^3 / X, M m, N' 4, m r
#                and H 2; Bardeen's takes 13) where the Kerr-Newman H took
#                5, so 513 + 3 x 6 = 531; per step the active test 23 and
#                the guard 81 + 6 = 110; once per ray the launch's flow A
#                evaluation, 126
#   fantasy_gen_disk_rot (D2): G1r's 531 per substep; per step G1r's 110
#                and the z product 1 = 111; once per ray 126 (the
#                crossing of a hit ray, t, the eight lerps and the hit
#                radius, is not counted: the bound stays a bound)
#   fantasy_gen_kds (G1d; S2d as fantasy_gen_traj_kds, T2d as
#                fantasy_gen_trace_kds, which has nothing per step): G1's
#                evaluation with Delta_th, chi^2 / Delta_th and Lambda / 3
#                inserted, counted from the source on G1's terms: sin and
#                cos 2, the metric 45 (Delta's Lambda term 3, Delta_th and
#                its reciprocal 3, chi^2 / Delta_th 1, the three numerators'
#                Delta_th factors 3, the three chi^2 / Delta_th factors 3,
#                g^thth's 1), the derivatives 88 (Delta_r's Lambda term 4,
#                Delta_th's theta derivative 1 and its log-derivative 2,
#                the numerators' new terms 14, the eight chi^2 / Delta_th
#                factors 8), the kicks 22 with the momentum products 5, the
#                drift 8 = 170; per substep 3 x 170 + 4 flows applied x 12
#                + mixing 96 + 1 = 655; the guard's 2 per step; once per ray
#                the launch's flow A evaluation and chi^2 (4), 174
#   fantasy_gen_disk_kds (D3): G1d's 655 per substep; per step the guard's
#                2 and cos theta with its sign product (sincos 2, the
#                product 1) = 5; once per ray 174 and the first cos theta
#                (2), 176 (the crossing of a hit ray, t and the eight
#                lerps, is not counted: the bound stays a bound)
# The disk mode (B6) adds per accepted step the two folds of z and their
# product (3) and per hit ray the crossing: t (2), eight lerps on folded
# rows (8 x 5) and the hit radius (17) = 59 (crossings outside the annulus,
# which do 34 of these, are not counted); the subring mode (B7) adds the
# same 3 per accepted step and per recorded crossing t (2) and the eight
# lerps (40) = 42 (a crossing past the last slot only adds one to an
# integer count).  Both are counted on the 32-row layout.
KERNEL_OPS = {
    "fantasy_eqc": (216, 2, 43),
    "fantasy_eq": (162, 2, 31),
    "fantasy_schw16": (255, 2, 0),
    "fantasy_eqc_chunk": (216, 2, 1),
    "fantasy_ks": (586, 55, 332),
    "fantasy_ks_plain": (499, 55, 290),
    "fantasy_ks_tangent": (1423, 58, 566),
    "fantasy_ks_tangent2": (2347, 58, 842),
    "fantasy_traj": (255, 2, 27),
    "fantasy_trace": (255, 0, 26),
    "fantasy_gen": (532, 2, 129),
    "fantasy_gen_traj_bl": (532, 2, 129),
    "fantasy_gen_traj_ks": (513, 104, 120),
    "fantasy_gen_trace": (532, 0, 129),
    "fantasy_gen_static": (286, 2, 47),
    "fantasy_gen_traj_static": (286, 2, 47),
    "fantasy_gen_trace_static": (286, 0, 47),
    "fantasy_gen_disk_static": (286, 8, 52),
    "fantasy_gen_rot": (531, 110, 126),
    "fantasy_gen_traj_rot": (531, 110, 126),
    "fantasy_gen_trace_rot": (531, 0, 126),
    "fantasy_gen_disk_rot": (531, 111, 126),
    "fantasy_gen_kds": (655, 2, 174),
    "fantasy_gen_traj_kds": (655, 2, 174),
    "fantasy_gen_trace_kds": (655, 0, 174),
    "fantasy_gen_disk_kds": (655, 5, 176),
}
DISK_OPS_STEP, DISK_OPS_HIT = 3, 59
SUB_OPS_STEP, SUB_OPS_EVENT = 3, 42


def flops_per_ray_step(kernel: str = "fantasy_eqc", order: int = 2) -> int:
    """Floating-point operations one ray costs per composed step in
    `kernel` (KERNEL_OPS; the per-ray terms are left out)."""
    from ..physics.hamiltonian import yoshida_gammas
    sub, step, _ = KERNEL_OPS[kernel]
    return sub * len(yoshida_gammas(order)) + step


def kernel_ops(kernel: str, ray_steps: int, rays: int,
               order: int = 2) -> int:
    """Floating-point operations `rays` rays that took `ray_steps` steps in
    all cost in `kernel`, per-ray terms included."""
    return (ray_steps * flops_per_ray_step(kernel, order)
            + rays * KERNEL_OPS[kernel][2])


def chain_floor_ms(kernel: str, longest_steps: int, order: int,
                   clock_hz: float) -> float:
    """The least time, in ms, that one dependent chain of `longest_steps`
    steps of `kernel` can take: one warp issues at most one instruction a
    cycle, and under -fmad=false each operation that KERNEL_OPS counts is
    at least one instruction.  The bound of a recorder that runs tens of
    rays (S1, S2), where the throughput bound does not apply; clock_hz is
    the SM clock (`sm_clock_hz`)."""
    return flops_per_ray_step(kernel, order) * longest_steps / clock_hz * 1e3


def sm_clock_hz() -> Optional[float]:
    """The current card's maximum SM clock in Hz, as `nvidia-smi
    --query-gpu=clocks.max.sm` reads it, or None without a CUDA device or
    a reading."""
    if not torch.cuda.is_available():
        return None
    rows = nvidia_smi("clocks.max.sm")
    index = torch.cuda.current_device()
    if index >= len(rows):
        return None
    try:
        return float(rows[index].split()[0]) * 1e6  # "1980 MHz"
    except (IndexError, ValueError):
        return None


def nvidia_smi(fields: str) -> list:
    """One row per card of `nvidia-smi --query-gpu=<fields>`, or [] where
    nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    return out.stdout.strip().splitlines() if out.returncode == 0 else []


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them, or None
    without a CUDA device."""
    if not torch.cuda.is_available():
        return None
    index = torch.cuda.current_device()
    smi = nvidia_smi("name,power.limit")
    if index < len(smi):
        return smi[index]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def roofline_report(steps_per_s: float, kernel: str = "fantasy_eqc",
                    order: int = 2, dtype: str = "float32") -> dict:
    """The operations a measured geodesic-steps/s figure sustains, and its
    share of the card's peak, beside the card's name and power limit.
    Only meaningful for work that ran on the card: without a CUDA device
    the share is None."""
    fps = flops_per_ray_step(kernel, order)
    name = card()
    sustained = steps_per_s * fps
    return {
        "kernel": kernel,
        "flops_per_ray_step": fps,
        "peak_flops": PEAK_FLOPS[dtype],
        "sustained_flops": sustained,
        "share_of_peak": sustained / PEAK_FLOPS[dtype] if name else None,
        "card": name or "no CUDA device: not measured",
    }


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU, and the card where there is
    one), written as a Chrome trace to <log_dir>/trace.json; yields the
    profiler, or None when log_dir is None (no-op)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_summary(prof, wall_s: float, top: int = 10) -> dict:
    """From a finished profiler: the `top` device activities (kernels,
    copies) by time in ms, their summed time and its share of `wall_s` (the
    device-busy share; work on one stream does not overlap).  Device time
    0 means the profiler saw no device activity."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:  # older torch
            t = evt.self_cuda_time_total
        if t:
            rows.append((evt.key, t / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"top": [{"op": k, "device_ms": t, "calls": c}
                    for k, t, c in rows[:top]],
            "device_ms": busy_ms,
            "wall_ms": wall_s * 1e3,
            "busy_share": busy_ms / (wall_s * 1e3) if wall_s > 0 else None}
