"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `grtrace_torch/csrc` and drives both of
the port's paths through them:

  * kernel B1 (csrc/fantasy_eqc.cu): held against its eager twin on the
    card and against the float64 oracle golden, then the headline
    Schwarzschild render (400x400 rays, 200k steps, delta 0.01, float32);
  * kernel B5 (csrc/fantasy_ks.cu): held bitwise against its eager twins
    in the layouts the Kerr frame does not run (order 4 with charge, the
    16-row float and double layouts) at 48x48, its Kerr shadow boundary
    against the Bardeen closed form, then the full-width Kerr render (a =
    0.9, 1024x1024 rays, 30k steps, delta 0.02, float32), whose camera rays
    it is held bitwise against its twin on at the full budget;
  * kernel B6 (the disk mode of csrc/fantasy_ks.cu): held bitwise against
    its eager twins in the layouts the disk frame does not run (16 rows
    float and double) at 48x48, then the full-width thin-disk render (the
    README's disk command: a = 0.9, 512x512 rays, 30k steps, delta 0.02,
    float32, camera 12 deg above the disk, annulus [ISCO, 14]), whose
    camera rays it is held bitwise against its twin on at the full budget;
  * kernel B7 (the subring mode of csrc/fantasy_ks.cu): held bitwise
    against its eager twins at 48x48 (16 rows float and double with 3
    orders, 32 rows with 1 order), then the full-width subring render (the
    photon-ring command `--spin 0.9 --size 256 --orders 3` with the CLI's
    defaults: 256x256 rays, 30k steps, delta 0.02, float32, camera 75 deg
    above the disk, 3 image orders) beside the photon-shell prediction,
    whose camera rays it is held bitwise against its twin on at the full
    budget; then the photon-shell anchor: on-axis rays at the capture /
    escape edge cross the plane at the polar shell orbit's radius, at the
    half-orbit delay that physics/photon_shell.py predicts;
  * kernel B2 (the plain 12-row layout of csrc/fantasy_eqc.cu, float64):
    held bitwise against its eager twin at 64x64, then the float64
    headline render (the same frame with IntegratorConfig(dtype=
    "float64")), whose rays it is held bitwise against its twin on at the
    full budget; the oracle golden through B2 and through B3 in float64;
  * kernel B3 (csrc/fantasy_schw16.cu, the 16-row fused-flow layout): the
    card's sinf/cosf (sin/cos) against torch.sin/torch.cos first, then B3
    held bitwise against its eager twin at 64x64 on rays turned out of the
    plane, in float and double, and `SchwarzschildIntegrator(backend=
    'cuda')` routed through it; later its chunk against its twin at
    64x64, and the float64 headline rays through
    `SchwarzschildIntegrator(backend='cuda')` and through the chunked job
    (`integrate_chunked`, the generic layout), both bitwise equal to one
    monolithic B3 launch, which is held bitwise against its twin on those
    rays at the full budget;
  * kernel B4 (the core-loop-only layout of csrc/fantasy_eqc.cu): held
    bitwise against its twin over one chunk at 64x64 and over the
    headline job's 50k-step chunk, then the checkpointed float32 headline
    job (200k budget, 50k-step chunks; and 2,500-step chunks with an .npz
    save and load after the second), bitwise equal to B1's monolithic
    result;
  * the Schwarzschild shadow boundary through B1 (float32) and B2
    (float64) against the closed form, within 0.01 px;
  * the command-line drivers and kernel S1 (the trajectory recorder, the
    record mode of csrc/fantasy_schw16.cu on B3's fused step):
    `grtrace_torch.cli.main` at the headline width
    (400x400, 200k steps, delta 0.01, a procedural sky, 20 sampled
    trajectories, no plots) with B1 and S1 launched once each, no eager
    sampler on CUDA rays, counts equal to a direct render(), the CSVs
    written by the native writer and the PNGs decoding to the arrays in
    memory, each stage timed, the sampler's split into the S1 launch and
    the host conversion (phase 25); S1 bitwise against its eager twin
    on those 20 rays at the full budget, on the single-ray driver's
    float64 ray with every step kept and at order 4, each beside its
    single-chain floor, with S1's registers, spills and step-loop SASS
    counts (26); the band sweep
    (500x500, 30k steps through B1, 50 rays through S1; 27); and the CLI
    with --profile, its top device operations and device-busy share
    printed, ungated (28);
  * the disk product line through B6 and B7: the README's polarized
    Novikov-Thorne disk command through `grtrace_torch.cli.main --disk`
    at 512x512 with --save-transfer (B6 once, EVPA in [0, pi], one CSV
    row per disk pixel; 29); that transfer map reshaded on the card,
    byte-equal to the render, and `cli.reshade` with new knobs (B6 0
    times; 30); the Keplerian camera (B6 once), 'zamo' bit-equal to its
    explicit rate, a superluminal rate refused, and B6 bitwise against its
    twin on the boosted camera's 48x48 rays (31); `cli.hotspot` at
    256x256 with 64 frames (B6 once) and from the transfer map (B6 0
    times; 32); the polarized subrings at 256x256 (B7 once, finite EVPA
    and beta_2) and the face-on toroidal disk's radial EVPA pattern
    (40x40 float64 through B6; 33);
  * the generic engine's kernels G1 (the Boyer-Lindquist integrator) and
    S2 (the trajectory recorder in both Kerr charts; csrc/fantasy_gen.cu):
    G1 bitwise against its eager twin on the 48x48 unfolded camera with
    charge, in float32 and float64 at orders 2 and 4 (34); the README's
    Kerr command at full width in the Boyer-Lindquist chart, `cli.main
    --metric kerr-bl` at 1024x1024, 30k steps (G1 and S2 once each, no
    eager step on CUDA rays, numerical_error 0), G1 bitwise against its
    twin on that frame's rays at the full budget and S2 on its 20
    sampled rays (35); the a = 0 Boyer-Lindquist frame at 400x400 beside
    the Schwarzschild fast path (every G1 capture a B1 capture; 36); the
    same command with `--metric kerr` (B5 and S2 once each) and S2 in the
    Kerr-Schild chart bitwise against its twin on the 20 sampled rays,
    whose rows start at the observer (37);
  * adaptive antialiasing (engine/aa.py, s = 2) on the frames of phases
    5, 18, 9, 35, 11 and 14 at their full widths: the sub-rays through B1
    and B2 (38), B5 (39), G1 (40), B6 (41) and B7 (42); each AA render
    launches its kernel twice (the frame and its one pass) and no twin on
    CUDA rays, its refined pixels are byte-equal to the 2N render of the
    same scene box-averaged (the subrings' per-order intensities within
    rtol 1e-6), and its other pixels, class map and counts to the base
    render's, and the pass's own launch is bitwise equal to the eager
    twin on the card on its sub-rays (those of at most 8,000 steps, at
    least 99% of them); the
    edge and sub-ray counts, the pass's kernel+wrapper time (CUDA events)
    beside its longest sub-ray's single-chain floor and the twin's time,
    and the frame's warm wall with and without AA; then the drivers of
    this line (43): `cli.main --aa 2` at the headline width (B1 twice, S1
    once), `cli.subring --aa 2 --visibility` (B7 twice), `cli.visibility`
    (B6) and `cli.hotspot --closure` (B6), each writing its CSVs;
  * the EinsteinPy-compatible geodesics through the trace kernels T1 (the
    trace mode of csrc/fantasy_schw16.cu) and T2 (the Boyer-Lindquist
    trace mode of csrc/fantasy_gen.cu), which record (q1, p1) after every
    step and stop no ray: `Nulllike` on the golden ray against
    tests/golden/null_geodesic_r10_a60_b60.csv at rtol = atol = 1e-10 and
    its T1 launch bitwise against the eager twin, `Timelike`'s circular
    orbit, the einsteinpy_ray example (44); `Nulllike` on the Kerr and
    Kerr-Newman rays through T2, bitwise against its twin, and Q = 0
    equal to Kerr (45); then the observables: `cli.shadow --spin 0.9
    --numeric` (B5 once a bisection round; every round's launch bitwise
    through B5 and its twin at full depth; each azimuth's error gated
    against the float32 and float64 witnesses of phase 46) and
    `cli.magnify --metric kerr --spin 0.9` at 256x256 (B5 once; 46);
    `cli.echo` at a = 0 and at a = 0.5 with Q = 0.4 (the charged ISCO;
    B6 twice a run, the float64 fan bitwise against its twin; 47);
  * the static beyond-Kerr family through the static chart of
    csrc/fantasy_gen.cu: `cli.main --metric bardeen | hayward | kottler`
    and horizonless Bardeen at the CLI's width (200x200, 200k steps; G1s
    and S2s once each, no twin on CUDA rays), G1s on the whole frame
    beside its bound, bitwise against its twin on every 16th ray at the
    full budget, the float32 fold's drift off theta = pi/2 (48); S2s on
    the first frame's 20 samples and T2s on one of its rays, bitwise
    (49); `render_disk_static` at 512x512, 30k steps (D1 once), D1
    bitwise against its twin on every ray (50); `cli.exact` at 128x128
    (its float64 crossing table against the CPU's on every 16th ray,
    then --compare through B6 and --background --compare through B5;
    51); `cli.images` with the JAX driver's example (52);
  * the line-profile fit and the multi-device drivers: B6t (the tangent
    mode of csrc/fantasy_ks.cu) on the 48x48 disk camera, float32 and
    float64, spin and elevation directions, its eight outputs bitwise
    against its twin and its six primal ones against B6's 16-row launch
    (53); `cli.fit_line --synthesize 0.7 40 --gauss-newton 2 --fisher`
    at its defaults and on the grid of JAX's test (B6 once per spin of
    a sweep and per primal pass, B6t once per tangent pass, no twin on
    CUDA rays; the fit within that test's tolerance), its last Fisher
    pass held the same way at its own shapes (54); `cli.line_grid
    --fisher 0.01 --bench` at its defaults, its last Fisher pass held
    the same way, and `cli.orbit` in its three modes (55); the sharded
    sweep and frames under an nccl group of one, bitwise equal to the
    same calls with no group (56);
  * the rotating regular families through the mass-function Kerr-Schild
    chart of csrc/fantasy_gen.cu: the 1024x1024 rotating-Bardeen frame
    (a = 0.9, g = 0.2, 30k steps, float32; G1r once, no twin on CUDA
    rays), G1r on the whole frame beside its bound and bitwise against
    its graphed twin on every 16th ray, a 256x256 float64
    rotating-Hayward frame and the horizonless one (g = 0.5, its
    numerical-error pixels pinned), each held on every ray (57); the
    README's `cli.main --metric rotating-hayward` at 256x256 (G1r and S2r
    once each) and with --aa 2 (G1r twice, the pass's launch held), S2r
    bitwise on the 20 samples (58); the README's rotating-Bardeen disk at
    256x256 through `cli.main --disk` and the 512x512 disk (D2 once
    each), D2 bitwise against its twin on every ray of both (59);
    `cli.shadow --metric rotating-bardeen` with and without --numeric
    (G1r once a round, each round held), T2r on one float64 ray of 2,000
    steps, and `render_kerr_sharded(metric='RotatingBardeen')` under an
    nccl group of one (60);
  * item 11's examples at their own sizes, in-process with --no-plots:
    analyze_photon_data (B1 once), polarized_disk (B6 twice, its face-on
    redshift and pitch-weight checks gated) and observables_workflow (B6
    once, every observable written from its transfer map), no twin on
    CUDA rays (61);
  * Kerr-de Sitter through the Carter chart of csrc/fantasy_gen.cu: the
    README's scene (a = 0.8, Lambda = 1e-3) at 1024x1024 (30k steps,
    float32; G1d once, no twin on CUDA rays), G1d on the whole frame
    beside its bound and bitwise against its graphed twin on every 16th
    ray, the scene at 256x256 in float64 and at Lambda = 0 (every ray
    held), G1d on the Lambda = 0 frame's rays bitwise equal to G1 on
    them, G1d's registers, spills and warps (62); the README's
    `cli.main --metric kerr-ds` at 256x256 (G1d and S2d once each) and
    with --aa 2 (G1d twice, the pass's launch held), S2d bitwise on the 20
    samples (63); `cli.main --metric kerr-ds --metric-param 1e-4 --disk`
    at 512x512 (D3 once), D3 bitwise against its twin on every ray, the
    counts and the range of g (64); `cli.shadow --metric kerr-ds` with and
    without --numeric (G1d once a round, each round held) and T2d on one
    float64 ray of 2,000 steps (65); `cli.qpo` for the four families on
    the card, each table within 1e-10 relative of the same run on the host
    (66);
  * the benchmark driver `cli.bench_cli` in-process (67): JAX's defaults
    (400x400, 200k steps; B1), `--dtype float64` (B2), `--metric kerr
    --spin 0.9` (B5), the README's disk line (256x256, 20k steps of 0.02;
    B6) and its 3840x3840 line (`--iters 2`; B1 on 14,745,600 rays), one
    launch a render and no twin on CUDA rays, each JSON line printed; the
    defaults' counts those of phase 5 and their `value` at least B1's
    CUDA-event time; the README's two lines beside the TPU's records
    (`DISK_r03.json`, `BENCH4K_r03.json`; not gated), the 3840x3840
    frame with its nearest-critical rays and the card's peak memory.

Beside them it reports what bounds the kernels: the resident blocks per SM,
registers, local and shared bytes of every kernel instantiation
(`cudaOccupancyMaxActiveBlocksPerMultiprocessor` through probe libraries
built from the same sources) and, where the toolkit has `cuobjdump`, the
SASS instruction and MUFU counts of each kernel and its loops (phase 2b;
no kernel may spill); bare B1, B2 and B4 launches on a quarter, a half and
all of the float32 and float64 headline rays (3c: a change to
fantasy_eqc.cu is kept only if B1 drops and B2 and B4 do not rise beyond
their spread), bare B5, B6 and B7 launches on a quarter, a half and all
of their frames' rays (9b, 12b, 15b: a change to fantasy_ks.cu for B5 is
kept only if B6 and B7 do not rise beyond their spread), B3's on the
float64 headline rays (23b) and G1's on the Boyer-Lindquist frame's
(35b); and, in 21a, the sincos that B3's flows and G1's and S2's
Boyer-Lindquist evaluations call, which must equal torch's sin and cos on
every point.

Each render checks that it went through its kernel.  The eager twins that
the kernels are held against run on the card with each step replayed from
a CUDA graph (`graphed_twins`): the same kernels on the same values, so the
same bits, without the host's cost of each operation, which otherwise sets
the twins' time.  Each phase prints its
lines with the seconds since the line before; any failure raises and the
script exits non-zero.  The last four lines are the seconds of every
phase (JSON), a JSON record of the kernels, the card's name and power
limit, and a JSON status line.

Imports only torch, numpy and grtrace_torch (never jax or grtrace): the
machine with the card has no jax.
"""
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from grtrace_torch.engine import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "oracle_escape_headline.npz")

# the headline scene (bench.py's): 400x400, 200k steps, delta 0.01, omega 1
SIZE, STEPS, DELTA, OMEGA = 400, 200_000, 0.01, 1.0
OBS_X, FOV_DEG, MASS, R_MAX = 30.0, 80.0, 1.0, 31.0
# the TPU's counts for the headline scene (BENCH_r05.json)
TPU_COUNTS = {"captured": 5712, "escaped": 154288}

# the full-width Kerr scene (the README's Kerr row): a = 0.9, 1024x1024,
# 30k steps, delta 0.02, order 2, float32, same camera and boundary
KERR_SIZE, KERR_STEPS, KERR_DELTA, KERR_SPIN = 1024, 30_000, 0.02, 0.9

# the full-width disk scene (the README's disk command, with the CLI's
# defaults): a = 0.9, 512x512, 30k steps, delta 0.02, order 2, float32, the
# default DiskConfig (camera 12 deg above the plane, annulus [ISCO, 14])
DISK_SIZE, DISK_STEPS, DISK_DELTA, DISK_SPIN = 512, 30_000, 0.02, 0.9

# the full-width subring scene (grtrace/cli/subring.py's first command,
# `--spin 0.9 --size 256 --orders 3`, with the CLI's defaults): a = 0.9,
# 256x256, 30k steps, delta 0.02, order 2, float32, camera 75 deg above the
# plane, 3 image orders, annulus [ISCO, 14], Shakura-Sunyaev, no background
SUB_SIZE, SUB_STEPS, SUB_DELTA, SUB_SPIN = 256, 30_000, 0.02, 0.9
SUB_ORDERS, SUB_ELEV = 3, 75.0

# Bounds: the least time an H100 SXM could take, from the one table of
# peaks and per-ray-step operation counts that `--print-metrics` reads too
# (grtrace_torch/engine/metrics.py, where each count is derived from its
# kernel source); every scene runs order 2: one substep per step.
PEAK_FLOPS = metrics.PEAK_FLOPS["float32"]
PEAK_FLOPS64 = metrics.PEAK_FLOPS["float64"]
PEAK_BYTES = metrics.PEAK_BYTES
# bytes the integration must move per ray: q0 and p0 in, final q and p,
# status and n_steps out (each read or written once); the disk mode also
# writes hit_q and hit_p, the subring mode the count and n_orders slots of
# (q, p)
BYTES_RAY = 8 * 4 + 8 * 4 + 4 + 4  # float32 rays
BYTES_RAY64 = 8 * 8 + 8 * 8 + 4 + 4  # float64 rays
# a checkpoint chunk of B4 reads its 24-row float32 carry, writes it back
# and the steps applied
CHUNK24_BYTES_RAY = 2 * 24 * 4 + 4
# the chunks of the checkpointed jobs (phases 22, 23): integrate_chunked's,
# and the short one of the jobs saved and loaded after their second chunk
JOB_CHUNK, CHUNK = 50_000, 2_500
# phase 24's gate on the Schwarzschild boundary: a few of its bisection
# brackets (0.0042 px)
SCHW_PX_ERR = 0.01
DISK_BYTES_RAY = BYTES_RAY + 8 * 4
SUB_BYTES_RAY = BYTES_RAY + 4 + SUB_ORDERS * 8 * 4


# the seconds each phase took: every line a phase prints carries the
# seconds since the line before it, and they add up per phase
PHASE_SECONDS = {}
_LAST_LINE = [time.perf_counter()]


def phase(n, msg):
    now = time.perf_counter()
    dt = now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    PHASE_SECONDS[str(n)] = PHASE_SECONDS.get(str(n), 0.0) + dt
    print(f"[{n}] (+{dt:.1f} s) {msg}", flush=True)


def bound(flops, nbytes, peak=PEAK_FLOPS):
    """(bound in ms, 'operations' | 'bytes'); peak: the operations' rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def camera(size, device, dtype=torch.float32):
    from grtrace_torch.physics.camera import camera_rays
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device=device)
    q0, p0, *_ = camera_rays(obs, math.radians(FOV_DEG), size, size,
                             mass_bh=MASS, dtype=dtype, device=device)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def ks_camera(size, params, device, dtype=torch.float32):
    from grtrace_torch.physics.camera import camera_rays_cartesian
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device=device)
    q0, p0, _ = camera_rays_cartesian(
        obs, math.radians(FOV_DEG), size, size, params=params,
        g_inv_fn=kerr_schild_g_inv, dtype=dtype, device=device)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def gate_parity(tag, res):
    if (res["status_mismatch"] or res["n_steps_mismatch"]
            or res.get("hit_mismatch", 0) or res.get("count_mismatch", 0)):
        raise AssertionError(f"{tag}: status/n_steps/hit flags/crossing "
                             f"counts differ between kernel and twin")
    equal = [k for k in res if k.endswith("_bitwise_equal")]
    if not all(res[k] for k in equal):
        raise AssertionError(
            f"{tag}: {[k for k in equal if not res[k]]} false (max abs diff "
            f"{res['max_abs_err']:.3e}); the kernel is built with "
            f"-fmad=false to round exactly as the twin's torch ops")


def check_parity(tag, q0, p0, steps, delta, order, n, kernel="B1"):
    """Kernel B1, B2 or B3 and its wrapper against its eager twin on the
    card: B1's through `integrate_dispatch(backend='torch')`, which selects
    it there, B2's `integrate_batch_eq`, B3's `integrate_batch_fused`."""
    from grtrace_torch.engine import integrate as ti
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import compare_outputs, timed
    args = (steps, delta, 2.0 * MASS, R_MAX, OMEGA)
    wrapper = {"B1": tc.integrate_batch_cuda,
               "B2": tc.integrate_batch_eq_cuda,
               "B3": tc.integrate_batch_generic_cuda}[kernel]
    if kernel == "B1":
        def twin():
            return ti.integrate_dispatch(q0, p0, *args, backend="torch",
                                         equatorial=True, order=order)
    else:
        twin_fn = {"B2": ti.integrate_batch_eq,
                   "B3": ti.integrate_batch_fused}[kernel]

        def twin():
            return twin_fn(q0, p0, *args, order=order)
    wrapper(q0, p0, *args, order=order)  # warm-up
    kern, kern_ms = timed(lambda: wrapper(q0, p0, *args, order=order),
                          q0.device)
    twin_out, twin_ms = timed(twin, q0.device)
    res = compare_outputs(kern, twin_out)
    status = kern[2]
    res.update(dtype=str(q0.dtype)[6:], rays=q0.shape[0], steps=steps,
               delta=delta, order=order,
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               n_steps_sum=int(kern[3].long().sum()),
               n_steps_max=int(kern[3].max()),
               kernel_ms=kern_ms, twin_ms=twin_ms)
    phase(n, f"{kernel} kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)
    return res, kern


def check_parity_ks(tag, size, steps, delta, order, charge, dtype,
                    compensated, n):
    """Kernel B5 against its eager twin on the card, in one of its three
    layouts, on the KS camera (`validate.ks_kernel_parity`)."""
    from grtrace_torch.engine.integrate_ks_cuda import integrate_batch_ks_cuda
    from grtrace_torch.engine.validate import ks_kernel_parity
    params = (MASS, KERR_SPIN, charge)
    q0, p0 = ks_camera(size, params, torch.device("cuda", 0), dtype)
    args = (steps, delta, params, R_MAX, OMEGA)
    integrate_batch_ks_cuda(q0, p0, *args, order=order,
                            compensated=compensated)  # warm-up
    kern, res = ks_kernel_parity(q0, p0, *args, order=order,
                                 compensated=compensated)
    status = kern[2]
    res.update(rows=32 if compensated else 16, dtype=str(dtype)[6:],
               rays=q0.shape[0], steps=steps, delta=delta, order=order,
               spin=KERR_SPIN, charge=charge,
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               n_steps_max=int(kern[3].max()))
    phase(n, f"B5 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)


def golden_probes(device):
    from grtrace_torch.engine.integrate_cuda import integrate_batch_cuda
    g = np.load(GOLDEN)
    q0, p0 = camera(int(g["size"]), device)
    idx = torch.as_tensor(g["flat_idx"], device=device)
    q0, p0 = q0[idx].contiguous(), p0[idx].contiguous()
    fq, fp, st, ns = integrate_batch_cuda(
        q0, p0, int(g["steps"]), float(g["delta"]), 2.0 * float(g["mass"]),
        float(g["rmax"]), float(g["omega"]))
    fq, st, ns = fq.double().cpu().numpy(), st.cpu().numpy(), ns.cpu().numpy()
    oq = g["final_q"]
    dth = np.abs(fq[:, 2] - oq[:, 2])
    dph = np.abs((fq[:, 3] - oq[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    flips = np.flatnonzero(ns != g["n_steps"])
    res = {"rays": len(idx), "steps": int(g["steps"]),
           "all_escaped": bool((st == 2).all()),
           "max_dphi": float(dph.max()), "median_dphi": float(np.median(dph)),
           "max_dtheta": float(dth.max()),
           "exit_step_flips": [[int(i), int(ns[i]), int(g["n_steps"][i])]
                               for i in flips]}
    phase(4, f"golden probes vs float64 oracle: {json.dumps(res)}")
    if not (res["all_escaped"] and res["max_dphi"] < 1e-5
            and res["median_dphi"] < 2e-6 and res["max_dtheta"] < 1e-6):
        raise AssertionError("golden probes outside the f32 accuracy bounds "
                             "(all escaped, max dphi < 1e-5, median < 2e-6, "
                             "dtheta < 1e-6)")


def headline_scene(dtype="float32"):
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        boundary_radius=R_MAX, observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=STEPS, delta=DELTA, omega=OMEGA,
                                    backend="auto", dtype=dtype),
        patch=PatchConfig(), n_samples=0)


def nearest_critical(res):
    """Where a Schwarzschild render's counts can differ from another
    implementation's (the TPU's per-ray classes are not recorded): after
    the rescue a ray's status is the exact launch-state predicate, so the
    rays that can flip are those whose launch impact parameter rounds
    across b_crit.  Returns (the rays whose status disagrees with the
    predicate, the ten smallest |b - b_crit| / b_crit), on the device."""
    from grtrace_torch.engine.integrate import schw_true_escape_pred
    q0 = res.device("q0").reshape(-1, 4)
    p0 = res.device("p0").reshape(-1, 4)
    pred = schw_true_escape_pred(q0, p0, 2.0 * MASS)
    status = res.device("status").reshape(-1)
    off_pred = int(((status == 1) & pred | (status == 2) & ~pred).sum())
    b_crit = 3.0 * math.sqrt(3.0) * MASS
    b_rel = ((p0[:, 3].abs() / p0[:, 0].abs()).double() - b_crit).abs() \
        / b_crit
    return off_pred, torch.topk(b_rel, 10, largest=False).values.tolist()


def main_path(device):
    import grtrace_torch
    from grtrace_torch.engine import integrate_cuda
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield

    scene = headline_scene()
    tex = starfield()
    integrate_cuda.launches = 0
    rm = RenderMetrics()
    res = grtrace_torch.render(scene, bg_array=tex, device="cuda",
                               metrics=rm)
    launches = integrate_cuda.launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    image = res.image
    fq = res.final_q
    summary = {"launches": launches, "counts": counts,
               "tpu_counts_BENCH_r05": TPU_COUNTS,
               "stages_s": rm.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum()),
               "share_full_budget": float((ns == STEPS).mean())}
    phase(5, f"main path render {SIZE}x{SIZE}/{STEPS} steps through the "
             f"kernel: {json.dumps(summary)}")
    if launches < 1:
        raise AssertionError("the render did not launch the CUDA kernel")
    if counts["numerical_error"] or counts["in_domain"]:
        raise AssertionError(f"numerical_error/in_domain not 0: {counts}")
    if image.shape != (SIZE, SIZE, 3) or not np.isfinite(fq).all():
        raise AssertionError("render output has the wrong shape or "
                             "non-finite final positions")
    if (counts["captured"] != TPU_COUNTS["captured"]
            or counts["escaped"] != TPU_COUNTS["escaped"]):
        off_pred, nearest = nearest_critical(res)
        phase(5, f"counts differ from the TPU's by "
                 f"{counts['captured'] - TPU_COUNTS['captured']} captured; "
                 f"{off_pred} rays' status disagrees with the exact "
                 f"predicate; nearest-critical |b - b_crit|/b_crit: "
                 f"{nearest}")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm render counts {r.counts} differ "
                                 f"from the first render's {counts}")
    wall = float(np.median(walls))
    phase(5, f"headline render warm wall time: median {wall:.6f} s of "
             f"{[round(w, 6) for w in walls]}, {SIZE * SIZE / wall:.1f} rays/s")
    return launches, wall, counts


def kerr_scene():
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=KERR_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric="kerr", spin=KERR_SPIN, boundary_radius=R_MAX,
        observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=KERR_STEPS, delta=KERR_DELTA,
                                    omega=OMEGA, order=2, backend="auto",
                                    dtype="float32"),
        patch=PatchConfig(), n_samples=0)


def kerr_boundary():
    from grtrace_torch.engine.validate import kerr_shadow_errors
    t0 = time.perf_counter()
    res = kerr_shadow_errors(spin=KERR_SPIN, device="cuda")
    res["seconds"] = time.perf_counter() - t0
    phase(8, f"Kerr shadow boundary (B5 kernel, float32, 8 azimuths) vs the "
             f"Bardeen closed form, 256^2 px: {json.dumps(res)}")
    if not res["px_err_max"] <= 0.05:
        raise AssertionError(f"Kerr boundary error {res['px_err_max']} px "
                             f"> 0.05 px")


def kerr_main_path():
    import grtrace_torch
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.integrate_ks import bardeen_escape_pred
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield

    scene = kerr_scene()
    tex = starfield()
    integrate_ks_cuda.launches = 0
    rm = RenderMetrics()
    res = grtrace_torch.render(scene, bg_array=tex, device="cuda",
                               metrics=rm)
    launches = integrate_ks_cuda.launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    q0 = res.device("q0").reshape(-1, 4)
    p0 = res.device("p0").reshape(-1, 4)
    pred = bardeen_escape_pred(q0, p0, MASS, KERR_SPIN, 0.0)
    status = res.device("status").reshape(-1)
    off_pred = int((((status == 1) & pred) | ((status == 2) & ~pred)).sum())
    summary = {"launches": launches, "counts": counts,
               "stages_s": rm.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum()),
               "status_off_bardeen_pred": off_pred}
    phase(9, f"Kerr render {KERR_SIZE}x{KERR_SIZE}/{KERR_STEPS} steps, "
             f"a = {KERR_SPIN}, through the kernel: {json.dumps(summary)}")
    if launches < 1:
        raise AssertionError("the Kerr render did not launch kernel B5")
    if counts["numerical_error"]:
        raise AssertionError(f"numerical_error not 0: {counts}")
    if (res.image.shape != (KERR_SIZE, KERR_SIZE, 3)
            or not np.isfinite(res.final_q).all()):
        raise AssertionError("Kerr render output has the wrong shape or "
                             "non-finite final positions")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm Kerr render counts {r.counts} "
                                 f"differ from the first render's {counts}")
    wall = float(np.median(walls))

    # kernel B5 and its wrapper (sort, pack, launch, unsort, rescue)
    # against its eager twin, on this frame's camera rays and budget
    from grtrace_torch.engine.validate import ks_kernel_parity
    q0c, p0c = q0.contiguous(), p0.contiguous()
    kern, par = ks_kernel_parity(q0c, p0c, KERR_STEPS, KERR_DELTA,
                                 (MASS, KERR_SPIN, 0.0), R_MAX, OMEGA)
    ray_steps = int(kern[3].long().sum())
    n = q0c.shape[0]
    par.update(rays=n, steps=KERR_STEPS, ray_steps=ray_steps,
               n_steps_max=int(kern[3].max()))
    phase(9, f"B5 kernel vs eager twin on the Kerr frame's rays: "
             f"{json.dumps(par)}")
    gate_parity("Kerr frame", par)
    bound_ms, bound_by = bound(
        metrics.kernel_ops("fantasy_ks", ray_steps, n), n * BYTES_RAY)
    phase(9, f"Kerr render warm wall time: median {wall:.6f} s of "
             f"{[round(w, 6) for w in walls]}, {n / wall:.1f} rays/s; B5 "
             f"kernel+wrapper at this shape {par['kernel_ms']:.3f} ms "
             f"({100 * par['kernel_ms'] / 1e3 / wall:.1f}% of the wall), "
             f"eager twin {par['twin_ms']:.3f} ms, {ray_steps} ray-steps, "
             f"bound {bound_ms:.3f} ms ({bound_by})")
    return {"launches": launches, "wall": wall, "bound_ms": bound_ms,
            "bound_by": bound_by, "q0": q0c, "p0": p0c, **par}


def disk_camera(size, device, dtype=torch.float32, elevation_deg=12.0):
    """The disk scene's inclined camera rays (the subring scene's at
    elevation_deg=75), as render_disk and render_subrings make them."""
    from grtrace_torch import DiskConfig, SceneConfig
    from grtrace_torch.engine.disk import disk_observer_position
    from grtrace_torch.physics.camera import (cartesian_ics_from_pixels,
                                              pixel_grid_lookat)
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    obs = torch.tensor(disk_observer_position(
        SceneConfig(), DiskConfig(elevation_deg=elevation_deg)),
        dtype=dtype, device=device)
    pix = pixel_grid_lookat(obs, torch.tensor(math.radians(FOV_DEG),
                                              dtype=dtype, device=device),
                            size, size, dtype=dtype, device=device)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix,
                                          params=(MASS, DISK_SPIN, 0.0),
                                          g_inv_fn=kerr_schild_g_inv)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def disk_annulus():
    from grtrace_torch import DiskConfig
    disk = DiskConfig()
    return disk.inner_edge(MASS, DISK_SPIN), disk.r_out


def check_parity_disk(tag, size, steps, delta, dtype, compensated, n):
    """Kernel B6 against its eager twin on the card, in one of its three
    layouts, on the disk camera (`validate.ks_kernel_parity(disk=...)`)."""
    from grtrace_torch.engine.integrate_ks_cuda import \
        integrate_batch_disk_cuda
    from grtrace_torch.engine.validate import ks_kernel_parity
    params = (MASS, DISK_SPIN, 0.0)
    q0, p0 = disk_camera(size, torch.device("cuda", 0), dtype)
    args = (steps, delta, params, R_MAX, OMEGA)
    annulus = disk_annulus()
    integrate_batch_disk_cuda(q0, p0, *args, *annulus,
                              compensated=compensated)  # warm-up
    kern, res = ks_kernel_parity(q0, p0, *args, compensated=compensated,
                                 disk=annulus)
    status = kern[2]
    res.update(rows=32 if compensated else 16, dtype=str(dtype)[6:],
               rays=q0.shape[0], steps=steps, delta=delta,
               disk=int((status == 3).sum()),
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               n_steps_max=int(kern[3].max()))
    phase(n, f"B6 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)


def disk_scene():
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=DISK_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric="kerr", spin=DISK_SPIN, boundary_radius=R_MAX,
        observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=DISK_STEPS, delta=DISK_DELTA,
                                    omega=OMEGA, order=2, backend="auto",
                                    dtype="float32"),
        patch=PatchConfig(), n_samples=0)


def disk_main_path():
    import grtrace_torch
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield
    from grtrace_torch.physics.kerr_schild import ks_radius_c

    scene = disk_scene()
    tex = starfield()
    r_in, r_out = disk_annulus()
    integrate_ks_cuda.disk_launches = 0
    rm = RenderMetrics()
    res = grtrace_torch.render_disk(scene, bg_array=tex, device="cuda",
                                    metrics=rm)
    launches = integrate_ks_cuda.disk_launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    dm = res.device("status").reshape(-1) == 3
    if not bool(dm.any()):
        raise AssertionError(f"the disk render has no disk pixel: {counts}")
    g = res.device("redshift").reshape(-1)[dm]
    hq = res.device("hit_q").reshape(-1, 4)[dm]
    # the kernel's own hit radius, in float32 with the float32 scalars
    a32 = float(torch.tensor(DISK_SPIN, dtype=torch.float32))
    r_hit = ks_radius_c(hq[:, 1], hq[:, 2], hq[:, 3], a32)
    r_in32 = float(torch.tensor(r_in, dtype=torch.float32))
    summary = {"launches": launches, "counts": counts,
               "stages_s": rm.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum()),
               "r_in": r_in, "r_out": r_out,
               "g_min": float(g.min()), "g_max": float(g.max()),
               "g_finite": bool(torch.isfinite(g).all()),
               "r_hit_min": float(r_hit.min()),
               "r_hit_max": float(r_hit.max())}
    phase(11, f"disk render {DISK_SIZE}x{DISK_SIZE}/{DISK_STEPS} steps, "
              f"a = {DISK_SPIN}, through kernel B6: {json.dumps(summary)}")
    if launches < 1:
        raise AssertionError("the disk render did not launch kernel B6")
    if counts["numerical_error"] or counts["disk"] <= 0:
        raise AssertionError(f"numerical_error not 0 or no disk pixel: "
                             f"{counts}")
    if (res.image.shape != (DISK_SIZE, DISK_SIZE, 3)
            or res.image.dtype != np.uint8):
        raise AssertionError("disk render image is not (512, 512, 3) uint8")
    if not (summary["g_finite"] and summary["g_max"] > 1.0
            and summary["g_min"] < 0.7):
        raise AssertionError("disk redshift not finite with max g > 1 and "
                             "min g < 0.7 on the disk pixels")
    if not (summary["r_hit_min"] >= r_in32 and summary["r_hit_max"] <= r_out):
        raise AssertionError(f"a disk hit lies outside [{r_in32}, {r_out}]")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render_disk(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm disk render counts {r.counts} "
                                 f"differ from the first render's {counts}")
    wall = float(np.median(walls))

    # kernel B6 and its wrapper against its eager twin, on this frame's
    # camera rays and budget
    from grtrace_torch.engine.validate import ks_kernel_parity
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    kern, par = ks_kernel_parity(q0, p0, DISK_STEPS, DISK_DELTA,
                                 (MASS, DISK_SPIN, 0.0), R_MAX, OMEGA,
                                 disk=(r_in, r_out))
    ray_steps = int(kern[3].long().sum())
    hits = int((kern[2] == 3).sum())
    n = q0.shape[0]
    par.update(rays=n, steps=DISK_STEPS, ray_steps=ray_steps, hits=hits,
               n_steps_max=int(kern[3].max()))
    phase(12, f"B6 kernel vs eager twin on the disk frame's rays: "
              f"{json.dumps(par)}")
    gate_parity("disk frame", par)
    bound_ms, bound_by = bound(
        metrics.kernel_ops("fantasy_ks", ray_steps, n)
        + ray_steps * metrics.DISK_OPS_STEP + hits * metrics.DISK_OPS_HIT,
        n * DISK_BYTES_RAY)
    phase(12, f"disk render warm wall time: median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}, {n / wall:.1f} rays/s; B6 "
              f"kernel+wrapper at this shape {par['kernel_ms']:.3f} ms "
              f"({100 * par['kernel_ms'] / 1e3 / wall:.1f}% of the wall), "
              f"eager twin {par['twin_ms']:.3f} ms, {ray_steps} ray-steps, "
              f"bound {bound_ms:.3f} ms ({bound_by})")
    return {"launches": launches, "wall": wall, "bound_ms": bound_ms,
            "bound_by": bound_by, "q0": q0, "p0": p0, **par}


def check_parity_subring(tag, size, steps, delta, dtype, compensated,
                         n_orders, n):
    """Kernel B7 against its eager twin on the card, in one of its three
    layouts, on the subring camera
    (`validate.ks_kernel_parity(subrings=...)`)."""
    from grtrace_torch.engine.integrate_ks_cuda import \
        integrate_batch_subrings_cuda
    from grtrace_torch.engine.validate import ks_kernel_parity
    params = (MASS, SUB_SPIN, 0.0)
    q0, p0 = disk_camera(size, torch.device("cuda", 0), dtype, SUB_ELEV)
    args = (steps, delta, params, R_MAX, OMEGA)
    integrate_batch_subrings_cuda(q0, p0, *args, n_orders=n_orders,
                                  compensated=compensated)  # warm-up
    kern, res = ks_kernel_parity(q0, p0, *args, compensated=compensated,
                                 subrings=n_orders)
    count = kern[6]
    res.update(rows=32 if compensated else 16, dtype=str(dtype)[6:],
               rays=q0.shape[0], steps=steps, delta=delta, n_orders=n_orders,
               count_max=int(count.max()),
               rays_past_last_slot=int((count > n_orders).sum()),
               captured=int((kern[2] == 1).sum()),
               escaped=int((kern[2] == 2).sum()),
               n_steps_max=int(kern[3].max()))
    phase(n, f"B7 kernel vs eager twin, {tag}: {json.dumps(res)}")
    gate_parity(tag, res)


def subring_scene():
    from grtrace_torch import (DiskConfig, IntegratorConfig, PatchConfig,
                               SceneConfig)
    scene = SceneConfig(
        size=SUB_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric="kerr", spin=SUB_SPIN, boundary_radius=R_MAX,
        observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=SUB_STEPS, delta=SUB_DELTA,
                                    omega=OMEGA, order=2, backend="auto",
                                    dtype="float32"),
        patch=PatchConfig(), n_samples=0)
    disk = DiskConfig(r_out=14.0, prograde=True, profile="shakura",
                      elevation_deg=SUB_ELEV, show_background=False,
                      t_peak=9000.0)
    return scene, disk


def subring_main_path():
    import grtrace_torch
    from grtrace_torch.cli import subring as sub_cli
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.metrics import RenderMetrics

    scene, disk = subring_scene()
    r_in = disk.inner_edge(MASS, SUB_SPIN)
    r_in32 = float(torch.tensor(r_in, dtype=torch.float32))
    integrate_ks_cuda.subring_launches = 0
    rm = RenderMetrics()
    res = grtrace_torch.render_subrings(scene, disk, n_orders=SUB_ORDERS,
                                        device="cuda", metrics=rm)
    launches = integrate_ks_cuda.subring_launches
    counts = res.counts
    valid, inten = res.valid, res.intensity
    count, ns = res.count, res.n_steps.astype(np.int64)
    r_em = res.r_em[valid]
    summary = grtrace_torch.subring_summary(res)
    t0 = time.perf_counter()
    theory = sub_cli.shell_theory(SUB_SPIN, 0.0, SUB_ELEV)
    theory_s = time.perf_counter() - t0
    info = {"launches": launches, "counts": counts,
            "stages_s": rm.stages, "n_steps_max": int(ns.max()),
            "n_steps_sum": int(ns.sum()),
            "valid_per_order": valid.sum(axis=(1, 2)).tolist(),
            "r_em_min": float(r_em.min()), "r_em_max": float(r_em.max()),
            "summary": summary, "shell_theory": theory,
            "shell_theory_s": theory_s}
    phase(14, f"subring render {SUB_SIZE}x{SUB_SIZE}/{SUB_STEPS} steps, "
              f"a = {SUB_SPIN}, {SUB_ORDERS} orders, camera {SUB_ELEV} deg, "
              f"through kernel B7: {json.dumps(info)}")
    if launches < 1:
        raise AssertionError("the subring render did not launch kernel B7")
    if counts["numerical_error"]:
        raise AssertionError(f"numerical_error not 0: {counts}")
    if (res.image.shape != (SUB_SIZE, SUB_SIZE, 3)
            or res.image.dtype != np.uint8
            or inten.shape != (SUB_ORDERS, SUB_SIZE, SUB_SIZE)
            or valid.shape != inten.shape):
        raise AssertionError("subring render: image not (256, 256, 3) uint8 "
                             "or per-order stacks not (3, 256, 256)")
    if not (valid[0].any() and valid[1].any() and count.max() >= 2):
        raise AssertionError("subring render: orders 0 and 1 need pixels "
                             "and some ray two crossings")
    if (inten[~valid] != 0.0).any() or not (inten[valid] > 0.0).all():
        raise AssertionError("subring intensity is not 0 exactly off the "
                             "valid events and > 0 on them")
    if not np.allclose(res.total_intensity, inten.sum(axis=0), rtol=1e-6,
                       atol=0.0):
        raise AssertionError("total_intensity is not the sum over orders")
    if not (r_em.min() >= r_in32 and r_em.max() <= disk.r_out):
        raise AssertionError(f"an emitting event lies outside "
                             f"[{r_in32}, {disk.r_out}]")
    flux = summary["flux_per_order"]
    if not flux[0] > flux[1] > 0.0:
        raise AssertionError(f"flux per order {flux}: need F0 > F1 > 0")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render_subrings(scene, disk, n_orders=SUB_ORDERS,
                                          device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"warm subring render counts {r.counts} "
                                 f"differ from the first render's {counts}")
    wall = float(np.median(walls))

    # kernel B7 and its wrapper against its eager twin, on this frame's
    # camera rays and budget
    from grtrace_torch.engine.validate import ks_kernel_parity
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    kern, par = ks_kernel_parity(q0, p0, SUB_STEPS, SUB_DELTA,
                                 (MASS, SUB_SPIN, 0.0), R_MAX, OMEGA,
                                 subrings=SUB_ORDERS)
    ray_steps = int(kern[3].long().sum())
    cnt = kern[6]
    recorded = [int((cnt > s).sum()) for s in range(SUB_ORDERS)]
    n = q0.shape[0]
    par.update(rays=n, steps=SUB_STEPS, ray_steps=ray_steps,
               n_steps_max=int(kern[3].max()),
               crossings_recorded_per_order=recorded,
               crossings_total=int(cnt.long().sum()))
    phase(15, f"B7 kernel vs eager twin on the subring frame's rays: "
              f"{json.dumps(par)}")
    gate_parity("subring frame", par)
    bound_ms, bound_by = bound(
        metrics.kernel_ops("fantasy_ks", ray_steps, n)
        + ray_steps * metrics.SUB_OPS_STEP
        + sum(recorded) * metrics.SUB_OPS_EVENT,
        n * SUB_BYTES_RAY)
    phase(15, f"subring render warm wall time: median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}, {n / wall:.1f} rays/s; B7 "
              f"kernel+wrapper at this shape {par['kernel_ms']:.3f} ms "
              f"({100 * par['kernel_ms'] / 1e3 / wall:.1f}% of the wall), "
              f"eager twin {par['twin_ms']:.3f} ms, {ray_steps} ray-steps, "
              f"bound {bound_ms:.3f} ms ({bound_by})")
    return {"launches": launches, "wall": wall, "bound_ms": bound_ms,
            "bound_by": bound_by, "q0": q0, "p0": p0, **par}


def photon_shell_anchor():
    """The subring path's closed-form gate (tests/test_photon_shell.py's
    tier 3): on-axis rays (L_z = 0) at the capture/escape edge of a = 0.9
    shadow the polar shell orbit, so their deep equatorial crossings sit at
    its radius, one predicted half-orbit delay apart in BL time.  B7's
    float64 layout at order 4, delta 0.02, omega 0, 10 orders; the edge
    u_crit is bracketed by bisection of 17-ray fans."""
    from grtrace_torch.engine import integrate_ks_cuda
    from grtrace_torch.engine.hotspot import bl_time_azimuth_offsets
    from grtrace_torch.engine.validate import bisect_boundary
    from grtrace_torch.physics.camera import cartesian_ics_from_pixels
    from grtrace_torch.physics.photon_shell import (critical_parameters,
                                                    polar_shell_radius)
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv, ks_radius

    device, f64 = torch.device("cuda", 0), torch.float64
    params = (MASS, SUB_SPIN, 0.0)
    obs = torch.tensor([0.0, 0.0, OBS_X], dtype=f64, device=device)
    t0 = time.perf_counter()
    steps_max = [0]
    integrate_ks_cuda.subring_launches = 0

    def run(us):
        u = torch.as_tensor(np.asarray(us, np.float64).reshape(-1),
                            device=device)
        pix = torch.stack([u, torch.zeros_like(u), torch.full_like(u, 24.0)],
                          dim=-1)
        q0, p0, _ = cartesian_ics_from_pixels(obs, pix, params=params,
                                              g_inv_fn=kerr_schild_g_inv)
        out = integrate_ks_cuda.integrate_batch_subrings_cuda(
            q0.contiguous(), p0.contiguous(), 300_000, 0.02, params, R_MAX,
            0.0, n_orders=10, order=4, compensated=False)
        steps_max[0] = max(steps_max[0], int(out[3].max()))
        return out

    rounds = 11
    mid, width = bisect_boundary(
        lambda us: (run(us)[2] == 2).reshape(np.shape(us)).cpu().numpy(),
        0.80, 0.92, rounds=rounds, k=17, n_psi=1)
    u_crit = float(mid[0]) + 0.5 * width      # the bracket's escaping end
    _, _, status, _, hq, _, count = run([u_crit + 1e-10])
    hq = hq[:, 0].cpu()
    r_bl = ks_radius(hq[:, 1], hq[:, 2], hq[:, 3], SUB_SPIN)
    t_bl = hq[:, 0] - bl_time_azimuth_offsets(r_bl, params)[0]
    r_polar = polar_shell_radius(params)
    _, dt_pred, *_ = critical_parameters(r_polar, params)
    gaps = [float(t_bl[i] - t_bl[i + 1]) for i in (2, 3)]
    res = {"u_crit": u_crit, "bracket": width, "rounds": rounds,
           "launches": integrate_ks_cuda.subring_launches,
           "n_steps_max": steps_max[0],
           "status": int(status[0]), "count": int(count[0]),
           "r_bl_crossings": [float(r) for r in r_bl[:int(count[0])]],
           "r_polar": float(r_polar), "delta_t_pred": float(dt_pred),
           "gap_23": gaps[0], "gap_34": gaps[1],
           "gap_rel_err": [g / float(dt_pred) - 1.0 for g in gaps],
           "seconds": time.perf_counter() - t0}
    phase(16, f"photon-shell anchor (B7 float64, a = {SUB_SPIN}, on-axis "
              f"camera): {json.dumps(res)}")
    if res["count"] < 5:
        raise AssertionError(f"the edge ray crossed {res['count']} < 5 times")
    if not all(abs(float(r_bl[i]) - float(r_polar)) < 0.02 for i in (2, 3)):
        raise AssertionError("crossings 2 and 3 are not within 0.02 M of the "
                             "polar shell radius")
    if not all(abs(e) < 5e-3 for e in res["gap_rel_err"]):
        raise AssertionError("crossing gaps 2-3 / 3-4 are not within 5e-3 of "
                             "the predicted half-orbit delay")


def golden_probes_f64(device):
    """The oracle golden's pixels as float64 camera rays through B2 and
    through B3 (the golden was made from float64 camera rays by the
    float64 oracle)."""
    from grtrace_torch.engine import integrate_cuda as tc
    g = np.load(GOLDEN)
    q0, p0 = camera(int(g["size"]), device, torch.float64)
    idx = torch.as_tensor(g["flat_idx"], device=device)
    q0, p0 = q0[idx].contiguous(), p0[idx].contiguous()
    args = (int(g["steps"]), float(g["delta"]), 2.0 * float(g["mass"]),
            float(g["rmax"]), float(g["omega"]))
    oq = g["final_q"]
    out = {}
    for name, wrapper in (("B2", tc.integrate_batch_eq_cuda),
                          ("B3", tc.integrate_batch_generic_cuda)):
        fq, _, st, ns = wrapper(q0, p0, *args)
        fq, st, ns = fq.cpu().numpy(), st.cpu().numpy(), ns.cpu().numpy()
        dph = np.abs((fq[:, 3] - oq[:, 3] + np.pi) % (2 * np.pi) - np.pi)
        flips = np.flatnonzero(ns != g["n_steps"])
        out[name] = {"all_escaped": bool((st == 2).all()),
                     "max_dphi": float(dph.max()),
                     "median_dphi": float(np.median(dph)),
                     "max_dtheta": float(np.abs(fq[:, 2] - oq[:, 2]).max()),
                     "exit_step_flips": [[int(i), int(ns[i]),
                                          int(g["n_steps"][i])]
                                         for i in flips]}
    phase(20, f"golden probes ({len(idx)} rays, {args[0]} steps, float64) "
              f"through B2 and B3 vs the float64 oracle: {json.dumps(out)}")
    for name, r in out.items():
        if not (r["all_escaped"] and r["max_dphi"] < 1e-7):
            raise AssertionError(f"{name} golden probes: not all escaped or "
                                 f"max dphi >= 1e-7")


def f64_main_path(device, counts32):
    """The float64 headline render (IntegratorConfig(dtype='float64')):
    kernel B2 through `render`."""
    import grtrace_torch
    from grtrace_torch.engine import integrate_cuda
    from grtrace_torch.engine.integrate import schw_true_escape_pred
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield

    scene = headline_scene("float64")
    tex = starfield()
    integrate_cuda.eq_launches = 0
    rm = RenderMetrics()
    res = grtrace_torch.render(scene, bg_array=tex, device="cuda",
                               metrics=rm)
    launches = integrate_cuda.eq_launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    # the rays whose float32 and float64 launch predicates disagree: after
    # the rescue a finished ray's class is its launch predicate
    pred64 = schw_true_escape_pred(q0, p0, 2.0 * MASS)
    q32, p32 = camera(SIZE, device)
    pred32 = schw_true_escape_pred(q32, p32, 2.0 * MASS)
    summary = {"launches": launches, "counts": counts,
               "float32_counts_phase5": counts32,
               "captured_minus_float32": counts["captured"]
               - counts32["captured"],
               "f32_f64_predicate_disagreements": int(
                   (pred64 != pred32).sum()),
               "stages_s": rm.stages,
               "n_steps_max": int(ns.max()), "n_steps_sum": int(ns.sum())}
    phase(18, f"float64 headline render {SIZE}x{SIZE}/{STEPS} steps through "
              f"kernel B2: {json.dumps(summary)}")
    if launches != 1:
        raise AssertionError(f"the float64 render launched B2 {launches} "
                             f"times, not 1")
    if counts["numerical_error"] or counts["in_domain"]:
        raise AssertionError(f"numerical_error/in_domain not 0: {counts}")
    if counts["captured"] + counts["escaped"] != SIZE * SIZE:
        raise AssertionError(f"captured + escaped != {SIZE * SIZE}: {counts}")
    if (res.image.shape != (SIZE, SIZE, 3)
            or not np.isfinite(res.final_q).all()):
        raise AssertionError("float64 render output has the wrong shape or "
                             "non-finite final positions")

    walls = []
    for _ in range(3):
        before = integrate_cuda.eq_launches
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts or integrate_cuda.eq_launches != before + 1:
            raise AssertionError(f"warm float64 render: counts {r.counts} "
                                 f"or B2 launches differ from the first's")
    wall = float(np.median(walls))
    phase(18, f"float64 headline render warm wall time: median {wall:.6f} s "
              f"of {[round(w, 6) for w in walls]}, {SIZE * SIZE / wall:.1f} "
              f"rays/s")
    return q0, p0, launches, wall, counts


def trig_probe(device):
    """The card's sinf/cosf and sin/cos, as two calls and as the one
    sincosf/sincos call that kernel B3's flows and G1's and S2's
    Boyer-Lindquist evaluations make (built by
    kernels/build.py into fantasy_schw16.cu's library), against torch.sin /
    torch.cos: every float32 in (0, pi), and 1e8 float64 points there."""
    from grtrace_torch.kernels.build import load
    lib = load()
    t0 = time.perf_counter()
    names = ("sin", "cos", "sincos_sin", "sincos_cos")

    def card(x):
        entry = (lib.grt_fantasy_trig_f32_launch if x.dtype == torch.float32
                 else lib.grt_fantasy_trig_f64_launch)
        outs = [torch.empty_like(x) for _ in names]
        err = entry(x.data_ptr(), *(o.data_ptr() for o in outs), x.numel(),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"trig probe launch failed: cudaError {err}")
        return outs

    def diffs(x, stats):
        ints = torch.int32 if x.dtype == torch.float32 else torch.int64
        ref_sin, ref_cos = torch.sin(x), torch.cos(x)
        for name, mine, ref in zip(names, card(x),
                                   (ref_sin, ref_cos, ref_sin, ref_cos)):
            ulp = (mine.view(ints).long() - ref.view(ints).long()).abs()
            bad = ulp != 0
            stats[name] += int(bad.sum())
            stats[f"{name}_max_ulp"] = max(stats[f"{name}_max_ulp"],
                                           int(ulp.max()))
            if bad.any() and len(stats["examples"]) < 4:
                k = int(torch.nonzero(bad)[0])
                stats["examples"].append([name, float(x[k]), float(mine[k]),
                                          float(ref[k])])

    def new_stats():
        stats = {"points": 0, "examples": []}
        for name in names:
            stats.update({name: 0, f"{name}_max_ulp": 0})
        return stats

    f32 = new_stats()
    # float32(pi) lies above pi, so bit patterns 1 .. bits(float32(pi)) - 1
    # are every positive float32 below pi
    end = int(np.array(np.pi, np.float32).view(np.int32))
    for lo in range(1, end, 1 << 27):
        x = torch.arange(lo, min(lo + (1 << 27), end), dtype=torch.int32,
                         device=device).view(torch.float32)
        f32["points"] += x.numel()
        diffs(x, f32)
    f64 = new_stats()
    gen = torch.Generator(device=device).manual_seed(5)
    for _ in range(4):
        x = torch.rand(25_000_000, dtype=torch.float64, device=device,
                       generator=gen) * math.pi
        x = x[x > 0.0]
        f64["points"] += x.numel()
        diffs(x, f64)
    torch.cuda.synchronize()
    res = {"float32": f32, "float64": f64,
           "seconds": time.perf_counter() - t0}
    phase("21a", f"the card's sin/cos and sincos (kernel build) vs "
                 f"torch.sin/torch.cos on (0, pi), differing values (B3's "
                 f"flows and G1's and S2's Boyer-Lindquist evaluations call "
                 f"sincos; their parity in 21b, 34, 35 rests on 0): "
                 f"{json.dumps(res)}")
    for dt, st in (("float32", f32), ("float64", f64)):
        if st["sincos_sin"] or st["sincos_cos"]:
            raise AssertionError(f"{dt} sincos differs from torch.sin/cos "
                                 f"on {st['sincos_sin']} / "
                                 f"{st['sincos_cos']} points")


def rotated_rays(size, device, dtype):
    """The folded camera rays turned out of the plane by their own fold
    angle beta: p_theta <- -sin(beta) p_phi, p_phi <- cos(beta) p_phi (null
    still, since g^thth = g^phph at theta = pi/2), so theta moves."""
    from grtrace_torch.physics.camera import camera_rays
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device=device)
    q0, p0, _, _, beta = camera_rays(obs, math.radians(FOV_DEG), size, size,
                                     mass_bh=MASS, dtype=dtype, device=device)
    q0, p0, beta = q0.reshape(-1, 4), p0.reshape(-1, 4), beta.reshape(-1)
    p_ph = p0[:, 3]
    p0 = torch.stack([p0[:, 0], p0[:, 1], -torch.sin(beta) * p_ph,
                      torch.cos(beta) * p_ph], dim=-1)
    return q0.contiguous(), p0.contiguous()


def generic_phase(device):
    """Kernel B3 at 64x64 on rays out of the plane (21b), and
    SchwarzschildIntegrator(backend='cuda') through it (21c)."""
    from grtrace_torch import SchwarzschildIntegrator
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import compare_outputs
    for dtype in (torch.float32, torch.float64):
        q0, p0 = rotated_rays(64, device, dtype)
        for order in (2, 4):
            check_parity(f"64x64 camera turned out of the plane, "
                         f"{str(dtype)[6:]}, order {order}", q0, p0, 2000,
                         0.05, order, "21b", kernel="B3")
    args = dict(steps=2000, delta=0.05, mass=MASS, omega=OMEGA, r_max=R_MAX)
    integ = SchwarzschildIntegrator(**args, backend="cuda",
                                    dtype=torch.float64, device=device)
    tc.generic_launches = 0
    out = integ.integrate_batch(q0, p0)
    launches = tc.generic_launches
    ref = tc.integrate_batch_generic_cuda(q0, p0, 2000, 0.05, 2.0 * MASS,
                                          R_MAX, OMEGA)
    res = compare_outputs(out, ref)
    res.update(launches=launches, rays=q0.shape[0])
    phase("21c", f"SchwarzschildIntegrator(backend='cuda', float64) on the "
                 f"out-of-plane rays vs integrate_batch_generic_cuda: "
                 f"{json.dumps(res)}")
    if launches != 1:
        raise AssertionError(f"SchwarzschildIntegrator(backend='cuda') "
                             f"launched B3 {launches} times, not 1")
    gate_parity("SchwarzschildIntegrator", res)


def ckpt_path(name):
    d = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def gate_final(tag, st, mono):
    """A chunked job's read-out against a monolithic (final_q, final_p,
    status, n_steps), bit for bit."""
    from grtrace_torch.engine.validate import compare_outputs
    res = compare_outputs((st.final_q, st.final_p, st.status, st.n_steps),
                          mono)
    gate_parity(tag, res)
    return res


def resumed_job(q0, p0, mono, compensated):
    """start, two CHUNK-step chunks, save to and load from an .npz, then
    CHUNK-step chunks to the end; held bitwise against `mono`.  Returns
    (chunks, the chunks' summed kernel+wrapper ms, compare counts)."""
    from grtrace_torch.engine import checkpoint as ck
    from grtrace_torch.engine.validate import timed
    st = ck.start(q0, p0, STEPS, DELTA, 2.0 * MASS, R_MAX, OMEGA,
                  compensated=compensated)
    chunks, ms = 0, 0.0
    while not st.done:
        st, t = timed(lambda: ck.advance(st, CHUNK), q0.device)
        chunks, ms = chunks + 1, ms + t
        if chunks == 2:
            path = ckpt_path(f"resumed_{st.layout}.npz")
            st.save(path)
            st = ck.IntegrationState.load(path, device=q0.device)
    res = gate_final(f"resumed {st.layout} job", st, mono)
    return chunks, ms, res


def checkpoint_eqc(device, q0, p0, mono, mono_ms):
    """Kernel B4: against its twin over one chunk at 64x64, and over the
    headline job's own chunk (JOB_CHUNK steps on the opened headline
    carry, the call integrate_chunked makes), then the checkpointed
    float32 headline job, bitwise equal to B1's monolithic result `mono`
    (phase 3a)."""
    from grtrace_torch.engine import checkpoint as ck
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import chunk_parity, timed
    qs, ps = camera(64, device)
    st = ck.start(qs, ps, 2000, 0.05, 2.0 * MASS, R_MAX, OMEGA,
                  compensated=True)
    _, small = chunk_parity(tc.advance_state_eqc_cuda, ck._advance_eqc,
                            st.state, 2000, 0.05, 2.0 * MASS, R_MAX, OMEGA)
    phase(22, f"B4 kernel vs _advance_eqc, one 2000-step chunk on the "
              f"opened 64x64 carry (delta 0.05): {json.dumps(small)}")
    gate_parity("B4 64x64 chunk", small)

    path = ckpt_path("chunked_eqc.npz")
    tc.chunk_launches = 0
    st, job_ms = timed(lambda: ck.integrate_chunked(
        q0, p0, STEPS, DELTA, 2.0 * MASS, R_MAX, OMEGA,
        chunk_steps=JOB_CHUNK, checkpoint_path=path, backend="auto"), device)
    launches = tc.chunk_launches
    if st.layout != "eqc" or launches < 1:
        raise AssertionError(f"the float32 chunked job took layout "
                             f"{st.layout!r} and {launches} B4 launches")
    job = gate_final("chunked eqc job", st, mono)
    saved = gate_final("chunked eqc job, loaded",
                       ck.IntegrationState.load(path, device=device), mono)
    chunks, chunk_ms, resumed = resumed_job(q0, p0, mono, True)

    # the job's first chunk against its twin: the same call on the same
    # opened carry
    opened = ck.start(q0, p0, STEPS, DELTA, 2.0 * MASS, R_MAX, OMEGA,
                      compensated=True)
    (_, applied), par = chunk_parity(tc.advance_state_eqc_cuda,
                                     ck._advance_eqc, opened.state, JOB_CHUNK,
                                     DELTA, 2.0 * MASS, R_MAX, OMEGA)
    par.update(rays=q0.shape[0], steps=JOB_CHUNK,
               ray_steps=int(applied.long().sum()))
    phase(22, f"B4 kernel vs _advance_eqc, the job's first {JOB_CHUNK}-step "
              f"chunk on the opened headline carry: {json.dumps(par)}")
    gate_parity("B4 headline chunk", par)
    phase(22, f"checkpointed float32 headline ({SIZE}x{SIZE}, {STEPS} "
              f"steps) vs B1's monolithic result: integrate_chunked with "
              f"{JOB_CHUNK}-step chunks: {launches} B4 launch(es) (every ray "
              f"ends inside the first chunk), {job_ms:.3f} ms with its save, "
              f"{json.dumps(job)}; reloaded: {json.dumps(saved)}; "
              f"{CHUNK}-step chunks with a save and load after the second: "
              f"{chunks} chunks, {chunk_ms:.3f} ms summed, "
              f"{json.dumps(resumed)}; B1 monolithic {mono_ms:.3f} ms")
    bound_ms, bound_by = bound(
        metrics.kernel_ops("fantasy_eqc_chunk", par["ray_steps"],
                           par["rays"]), par["rays"] * CHUNK24_BYTES_RAY)
    return {"launches": launches, "bound_ms": bound_ms,
            "bound_by": bound_by, **par}


def checkpoint_generic(device, q0, p0, counts18):
    """Kernel B3: its chunk against its twin at 64x64 on rays out of the
    plane; then B3's float64 headline paths, SchwarzschildIntegrator(
    backend='cuda') on the frame's rays and the chunked job (the generic
    layout), both bitwise equal to one monolithic B3 launch, which is held
    bitwise against its twin `integrate_batch_fused` at the full budget."""
    from grtrace_torch import SchwarzschildIntegrator
    from grtrace_torch.engine import checkpoint as ck
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import chunk_parity, compare_outputs
    from grtrace_torch.engine.validate import timed
    qs, ps = rotated_rays(64, device, torch.float64)
    st = ck.start(qs, ps, 2000, 0.05, 2.0 * MASS, R_MAX, OMEGA)
    _, small = chunk_parity(tc.advance_state_cuda, ck._advance_fused,
                            st.state, 2000, 0.05, 2.0 * MASS, R_MAX, OMEGA)
    phase(23, f"B3 chunk kernel vs _advance_fused, one 2000-step chunk on "
              f"the 64x64 float64 carry turned out of the plane (delta "
              f"0.05): {json.dumps(small)}")
    gate_parity("B3 64x64 chunk", small)

    integ = SchwarzschildIntegrator(steps=STEPS, delta=DELTA, mass=MASS,
                                    omega=OMEGA, r_max=R_MAX, backend="cuda",
                                    dtype=torch.float64, device=device)
    path = ckpt_path("chunked_generic.npz")
    tc.generic_launches = 0
    mono = integ.integrate_batch(q0, p0)
    integ_launches = tc.generic_launches
    st, job_ms = timed(lambda: ck.integrate_chunked(
        q0, p0, STEPS, DELTA, 2.0 * MASS, R_MAX, OMEGA,
        chunk_steps=JOB_CHUNK, checkpoint_path=path, backend="auto"), device)
    launches = tc.generic_launches
    if integ_launches != 1 or st.layout != "generic" or launches < 2:
        raise AssertionError(f"SchwarzschildIntegrator launched B3 "
                             f"{integ_launches} times, not 1; the float64 "
                             f"chunked job took layout {st.layout!r} and "
                             f"{launches - integ_launches} B3 launches")

    # the integrator's call, B3 at the full budget, against its twin
    b3, kern = check_parity(f"float64 headline frame {SIZE}x{SIZE}, {STEPS} "
                            f"steps", q0, p0, STEPS, DELTA, 2, 23,
                            kernel="B3")
    same = compare_outputs(mono, kern)
    gate_parity("SchwarzschildIntegrator on the float64 frame", same)
    job = gate_final("chunked generic job", st, mono)
    chunks, chunk_ms, resumed = resumed_job(q0, p0, mono, False)
    status = st.status
    counts = {"captured": int((status == 1).sum()),
              "escaped": int((status == 2).sum()),
              "alive": int((status == 0).sum())}
    phase(23, f"float64 headline ({SIZE}x{SIZE}, {STEPS} steps, generic "
              f"layout): SchwarzschildIntegrator(backend='cuda') 1 B3 launch, "
              f"bitwise equal to the timed launch {json.dumps(same)}; "
              f"integrate_chunked with {JOB_CHUNK}-step chunks: "
              f"{launches - integ_launches} B3 launch(es), {job_ms:.3f} ms "
              f"with its save, {json.dumps(job)}; {CHUNK}-step chunks with a "
              f"save and load after the second: {chunks} chunks, "
              f"{chunk_ms:.3f} ms summed, {json.dumps(resumed)}; one "
              f"monolithic B3 launch {b3['kernel_ms']:.3f} ms; counts "
              f"{json.dumps(counts)} beside phase 18's render "
              f"{json.dumps(counts18)}; longest ray "
              f"{int(st.n_steps.max())} steps")
    bound_ms, bound_by = bound(
        metrics.kernel_ops("fantasy_schw16", b3["n_steps_sum"], b3["rays"]),
        b3["rays"] * BYTES_RAY64, PEAK_FLOPS64)
    return {"launches": launches, "bound_ms": bound_ms,
            "bound_by": bound_by, **b3}


def schw_boundary(device):
    """The Schwarzschild shadow boundary through B1 (float32) and B2
    (float64) against the closed form (`validate.schwarzschild_shadow_
    error`: 3 bisection rounds of 8 azimuths x 17 radii, 19,968 steps,
    delta 0.01, one kernel launch a round)."""
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import schwarzschild_shadow_error
    out = {}
    for dtype, name, counter in ((torch.float32, "B1", "launches"),
                                 (torch.float64, "B2", "eq_launches")):
        setattr(tc, counter, 0)
        t0 = time.perf_counter()
        res = schwarzschild_shadow_error(dtype=dtype, device=device)
        res.update(launches=getattr(tc, counter),
                   seconds=time.perf_counter() - t0)
        out[f"{str(dtype)[6:]} {name}"] = res
    phase(24, f"Schwarzschild shadow boundary vs the closed form, 256^2 px: "
              f"{json.dumps(out)}")
    for name, res in out.items():
        if res["launches"] != 3:
            raise AssertionError(f"{name}: {res['launches']} launches, not "
                                 f"one per bisection round (3)")
        if not res["px_err"] < SCHW_PX_ERR:
            raise AssertionError(f"{name}: boundary {res['px_err']} px from "
                                 f"the closed form, not < {SCHW_PX_ERR} px")


# --- the command-line drivers and kernel S1 (phases 25-28) ----------------
# the CLI's headline run: the README's quick start at the headline width,
# 200k steps (the CLI's defaults: 20 sampled trajectories of at most 1000
# points, seed 0), without the plots, which need matplotlib
CLI_OUT = os.path.join(HERE, "build", "cli_out")
CLI_ARGV = ["--size", str(SIZE), "--steps", str(STEPS), "--delta",
            str(DELTA), "--observer-distance", "30", "--boundary-radius",
            "31", "--background", "procedural:starfield", "--no-plots",
            "--print-metrics"]
N_SAMPLES, TRAJ_POINTS = 20, 1000
# bytes S1 must move per ray: q0 and p0 in, the steps taken out (the
# record's n_keep x 4 slots are counted per run)
TRAJ_BYTES_RAY = 8 * 4 + 4  # float32 rays


def run_quiet(fn, argv):
    """A driver's main in-process: (its return, its standard output as
    lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue().splitlines()


def run_cli(argv):
    """grtrace_torch.cli.main in-process: (its result, its standard output
    as lines)."""
    from grtrace_torch.cli import main as cli_main
    return run_quiet(cli_main.main, argv)


def json_line(lines, key):
    """The JSON object the CLI printed under `key`."""
    for line in lines:
        if line.startswith("{") and f'"{key}"' in line:
            return json.loads(line)
    raise AssertionError(f"the CLI printed no {key!r} line")


def host_packages():
    """Which of the optional host packages import on this machine."""
    import importlib.util
    return {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "pandas", "matplotlib")}


def cli_phase(device):
    """Phase 25: `python -m grtrace_torch.cli.main` at the headline width,
    in-process, with B1's and S1's counts and the native writer's count set
    to 0 just before and read just after, and the eager sampler counted on
    CUDA rays; then the same SceneConfig through render() directly, and the
    CLI's files held against the arrays in memory."""
    import grtrace_torch
    from grtrace_torch.cli.args import parse_args, scene_from_args
    from grtrace_torch.engine import integrate as ti
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.flat import flat_render_scene
    from grtrace_torch.io import artifacts
    argv = CLI_ARGV + ["--out-dir", CLI_OUT]
    twin = ti.integrate_batch_full
    eager_on_cuda = []

    def counted_twin(q0s, *args, **kw):
        if q0s.is_cuda:
            eager_on_cuda.append(q0s.shape[0])
        return twin(q0s, *args, **kw)

    ti.integrate_batch_full = counted_twin
    tc.launches = tc.traj_launches = 0
    artifacts.writes.update(native=0, python=0)
    t0 = time.perf_counter()
    try:
        res, lines = run_cli(argv)
    finally:
        ti.integrate_batch_full = twin
    wall = time.perf_counter() - t0
    launches = {"B1": tc.launches, "S1": tc.traj_launches}
    writes = dict(artifacts.writes)
    stages = json_line(lines, "stages_s")
    roof = json_line(lines, "roofline")["roofline"]

    scene = scene_from_args(parse_args(argv))
    bg = artifacts.load_background(scene.background, size=(SIZE, SIZE))
    direct = grtrace_torch.render(scene, bg_array=bg, seed=0, device=device)
    flat_img, _ = flat_render_scene(
        scene.observer(), bg, boundary_radius=scene.boundary_radius,
        patch_center_theta=scene.patch.center_theta,
        patch_center_phi=scene.patch.center_phi,
        patch_size_theta=scene.patch.size_theta,
        patch_size_phi=scene.patch.size_phi, n_sampled=10, seed=0,
        device=device)
    with open(os.path.join(CLI_OUT, "photon_data.csv")) as f:
        photon_header = f.readline().strip()
        photon_rows = sum(1 for _ in f)
    with open(os.path.join(CLI_OUT, "sampled_rays.csv")) as f:
        sampled_header = f.readline().strip()
        sampled_rows = sum(1 for _ in f)
    images = {name: artifacts.read_png(os.path.join(CLI_OUT, "images", name))
              for name in ("manual_output.png", "no_gravity.png")}
    # the CLI's csv_writes stage includes the native writer's g++ build at
    # first use: time a second, warm write of photon_data.csv beside it
    t1 = time.perf_counter()
    artifacts.save_photon_data(res, os.path.join(CLI_OUT, "photon_warm.csv"))
    warm_photon_s = time.perf_counter() - t1
    os.remove(os.path.join(CLI_OUT, "photon_warm.csv"))
    summary = {
        "argv": " ".join(argv), "launches": launches,
        "eager_sampler_calls_on_cuda": len(eager_on_cuda),
        "counts": res.counts, "direct_render_counts": direct.counts,
        "csv_writes": writes, "photon_rows": photon_rows,
        "sampled_rows": sampled_rows, "stages_s": stages["stages_s"],
        "photon_csv_warm_write_s": warm_photon_s,
        "rays_per_s": stages["rays_per_s"],
        "geodesic_steps": stages["geodesic_steps"], "cli_wall_s": wall,
        "roofline": roof, "host_packages": host_packages()}
    phase(25, f"grtrace_torch.cli.main at {SIZE}x{SIZE}, {STEPS} steps: "
              f"{json.dumps(summary)}")
    for line in lines:
        if not line.startswith("{"):
            phase(25, f"cli: {line}")
    if launches != {"B1": 1, "S1": 1}:
        raise AssertionError(f"the CLI's launches {launches}: B1 and S1 "
                             f"must each launch once")
    if eager_on_cuda:
        raise AssertionError(f"the eager sampler ran on CUDA rays "
                             f"{eager_on_cuda}")
    if res.counts != direct.counts or res.counts["numerical_error"]:
        raise AssertionError(f"CLI counts {res.counts} against render()'s "
                             f"{direct.counts} (numerical_error must be 0)")
    if writes != {"native": 2, "python": 0}:
        raise AssertionError(f"CSV writers {writes}: the native writer must "
                             f"take both files")
    if (photon_header != ",".join(artifacts.PHOTON_COLUMNS)
            or photon_rows != SIZE * SIZE
            or sampled_header != ",".join(artifacts.SAMPLED_COLUMNS)
            or sampled_rows != N_SAMPLES * TRAJ_POINTS):
        raise AssertionError("photon_data.csv / sampled_rays.csv have the "
                             "wrong header or row count")
    if not (np.array_equal(images["manual_output.png"], res.image)
            and np.array_equal(images["no_gravity.png"], flat_img)):
        raise AssertionError("a PNG does not decode to the array in memory")
    return res, launches


def traj_phase(device, res):
    """Phase 26: S1, through the entry the render's sampler calls, against
    its twin, bit for bit: on phase 25's sampled rays at the full budget
    (float32), with the CLI's own sampled trajectories equal to that
    record's; on the single-ray driver's float64 ray with every step kept;
    and at order 4 on 16 headline rays; each timed beside its twin.
    Returns the first comparison."""
    from grtrace_torch.cli import single_ray
    from grtrace_torch.engine.render import trajectories_to_cartesian
    from grtrace_torch.engine.validate import traj_parity
    idx = torch.as_tensor(res.sampled_indices[:, 0] * SIZE
                          + res.sampled_indices[:, 1], device=device)
    q0 = res.device("q0").reshape(-1, 4)[idx].contiguous()
    p0 = res.device("p0").reshape(-1, 4)[idx].contiguous()
    (traj, _), cli = traj_parity(q0, p0, STEPS, DELTA, 2.0 * MASS, R_MAX,
                                 OMEGA, n_keep=TRAJ_POINTS)
    # the CLI's own sampled trajectories (its S1 launch, converted on the
    # host) against the same conversion of the record just held against
    # the twin
    betas = res.device("beta").reshape(-1)[idx].cpu().double()
    cli["cli_trajectories_equal"] = all(
        np.array_equal(a, b) for a, b in zip(
            res.sampled_trajectories, trajectories_to_cartesian(traj, betas)))
    cli["bound_ms"], cli["bound_by"] = bound(
        metrics.kernel_ops("fantasy_traj", cli["n_steps_sum"], cli["rays"]),
        cli["rays"] * (TRAJ_BYTES_RAY + cli["n_keep"] * 4 * 4))
    cli["chain_floor_ms"] = chain_floor("fantasy_traj", cli["n_steps_max"])
    phase(26, f"S1 vs eager twin on the CLI's {cli['rays']} sampled rays "
              f"({STEPS}-step budget, {TRAJ_POINTS} points, float32; "
              f"{CARD}): {json.dumps(cli)}")
    args = single_ray.build_parser().parse_args([])
    q1, p1 = single_ray.initial_state(args, device)
    _, one = traj_parity(q1, p1, args.steps, args.delta, 2.0 * args.mass,
                         args.r_max, args.omega, reps=1)
    one["chain_floor_ms"] = chain_floor("fantasy_traj", one["n_steps_max"])
    phase(26, f"S1 vs eager twin on single_ray's default ray (float64, "
              f"{args.steps} steps, every step kept): {json.dumps(one)}")
    q4, p4 = camera(64, device)
    _, ord4 = traj_parity(q4[::256].contiguous(), p4[::256].contiguous(),
                          3000, 0.05, 2.0 * MASS, R_MAX, OMEGA, n_keep=100,
                          order=4, reps=1)
    ord4["chain_floor_ms"] = chain_floor("fantasy_traj", ord4["n_steps_max"],
                                         order=4)
    phase(26, f"S1 vs eager twin at order 4, 16 rays of the 64x64 camera, "
              f"3000 steps, delta 0.05, 100 points: {json.dumps(ord4)}")
    phase(26, f"S1's build (the record mode of fantasy_schw16.cu): "
              f"{json.dumps(build_report('fantasy_schw16', S1_BUILDS))}")
    for tag, r in (("CLI rays", cli), ("single ray", one), ("order 4", ord4)):
        if not r["traj_bitwise_equal"]:
            raise AssertionError(f"S1 differs from its twin on the {tag} "
                                 f"(max abs diff {r['max_abs_err']:.3e})")
    if (len(res.sampled_trajectories) != N_SAMPLES
            or not cli["cli_trajectories_equal"]):
        raise AssertionError("the CLI's sampled trajectories differ from "
                             "S1's twin record")
    if one["n_keep"] != args.steps or one["stride"] != 1:
        raise AssertionError("the single ray must keep every step")
    return cli


# S1's instantiations, by the label build_report gives them
S1_BUILDS = {"fantasy_schw16_kernel<f,1>": "float",
             "fantasy_schw16_kernel<d,1>": "double"}


def build_report(stem, record):
    """{instantiation of csrc/<stem>.cu, by its label in `record`: ptxas's
    registers and spilled bytes, and the instructions and MUFU by kind of
    its step loop (the longest loop of `cuobjdump -sass`, where the tool is
    found)}."""
    from grtrace_torch.kernels import build
    lib = build.library_path(build.CSRC_DIR / f"{stem}.cu")
    out = {}
    for k in build.ptxas_summary(lib.with_suffix(".log").read_text()):
        if k["kernel"] in record:
            out[record[k["kernel"]]] = {
                "registers": k["registers"],
                "spill_bytes": (k["spill_stores"], k["spill_loads"])}
    if _cuobjdump():
        for name, counts in sass_counts(lib).items():
            if name in record and counts["loops"]:
                loop = counts["loops"][0]
                out.setdefault(record[name], {}).update(
                    step_loop_instructions=loop["instructions"],
                    step_loop_mufu=loop["mufu_by_kind"])
    return out


def band_phase(device):
    """Phase 27: `python -m grtrace_torch.cli.band_sweep` (500x500, 30k
    steps through B1; its 50 rays through S1), the plot left out where
    matplotlib is missing; the rays' record held against the twin."""
    from grtrace_torch.cli import band_sweep
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import traj_parity
    from grtrace_torch.viz import plots
    out = os.path.join(HERE, "build", "band_sweep_out")
    argv = ["--out-dir", out] + ([] if plots.available() else ["--no-plots"])
    tc.launches = tc.traj_launches = 0
    t0 = time.perf_counter()
    res, traj = band_sweep.main(argv)
    wall = time.perf_counter() - t0
    launches = {"B1": tc.launches, "S1": tc.traj_launches}
    args = band_sweep.build_parser().parse_args(argv)
    q0, p0 = band_sweep.band_rays(args.n_rays, args.seed, torch.float32,
                                  device)
    (kern, _), par = traj_parity(q0, p0, args.steps, args.delta,
                                 2.0 * band_sweep.BH_MASS,
                                 band_sweep.BOUNDARY, 1.0,
                                 n_keep=band_sweep.N_KEEP, reps=1)
    same = bool(np.array_equal(kern.cpu().numpy(), traj))
    phase(27, f"band_sweep {' '.join(argv)}: launches {launches}, counts "
              f"{res.counts}, record {list(traj.shape)}, {wall:.3f} s; S1 "
              f"vs eager twin on its rays: {json.dumps(par)}; the driver's "
              f"record equal to that launch: {same}")
    if launches != {"B1": 1, "S1": 1} or res.counts["numerical_error"]:
        raise AssertionError("band_sweep must launch B1 and S1 once each, "
                             "with no numerical error")
    if (traj.shape != (args.n_rays, band_sweep.N_KEEP, 4)
            or not par["traj_bitwise_equal"] or not same):
        raise AssertionError("band_sweep's record is misshapen or differs "
                             "from S1's twin")


def profile_phase():
    """Phase 28 (ungated): phase 25's CLI run with --profile: the top
    device operations by time and the device-busy share of the render,
    from torch.profiler."""
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        _, lines = run_cli(CLI_ARGV + ["--out-dir", out, "--profile"])
    prof = json_line(lines, "profile")["profile"]
    phase(28, f"torch.profiler over the CLI's curved render: "
              f"{json.dumps(prof)}")
    if not prof["device_ms"]:
        phase(28, "the profiler saw no device time")


# --- the disk product line (phases 29-33) -----------------------------------
# the README's disk commands at the full disk width: the polarized
# Novikov-Thorne frame with its transfer map, the reshade of that map, the
# moving camera, the hot spot (256x256, 64 frames, and from the map) and the
# polarized subrings; each phase reads kernel B6's or B7's count, set to 0
# just before its path
DISK_OUT = os.path.join(HERE, "build", "disk_out")
DISK_MAP = os.path.join(DISK_OUT, "disk.transfer.npz")
DISK_CLI_ARGV = ["--size", str(DISK_SIZE), "--metric", "kerr", "--spin",
                 str(DISK_SPIN), "--disk", "--steps", str(DISK_STEPS),
                 "--delta", str(DISK_DELTA), "--disk-profile", "novikov",
                 "--disk-bfield", "vertical", "--no-plots"]
# phase 31's kernel-vs-twin check on the boosted camera: 48x48 rays with a
# budget whose 32-row twin stays under 10 s
BOOST_SIZE, BOOST_STEPS, BOOST_DELTA = 48, 1000, 0.05
HOT_FRAMES = 64
CARD = ""   # the card's name and power limit (nvidia-smi), set by main
SM_CLOCK_HZ = None  # the card's maximum SM clock (nvidia-smi), set by main


def chain_floor(kernel, longest_steps, order=2):
    """metrics.chain_floor_ms at the card's maximum SM clock: the least
    time of the longest ray's dependent chain (the bound of a recorder
    that runs tens of rays), or None where the clock was not read."""
    if SM_CLOCK_HZ is None:
        return None
    return metrics.chain_floor_ms(kernel, longest_steps, order, SM_CLOCK_HZ)


def csv_rows(path):
    with open(path) as f:
        return sum(1 for _ in f) - 1


def same_bytes(a, b):
    """Whether two tensors hold the same bytes (NaN included)."""
    return a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


def disk_cli_phase():
    """Phase 29: the polarized Novikov-Thorne disk frame through
    `grtrace_torch.cli.main --disk` with --save-transfer; B6 once."""
    import grtrace_torch
    from grtrace_torch.cli.args import disk_from_args, parse_args, \
        scene_from_args
    from grtrace_torch.engine import integrate_ks_cuda as ks
    from grtrace_torch.engine.validate import timed
    from grtrace_torch.io import artifacts
    os.makedirs(DISK_OUT, exist_ok=True)
    argv = DISK_CLI_ARGV + ["--save-transfer", DISK_MAP, "--out-dir",
                            DISK_OUT]
    ks.disk_launches = 0
    t0 = time.perf_counter()
    res, _ = run_cli(argv)
    cli_wall = time.perf_counter() - t0
    launches = ks.disk_launches
    counts = res.counts
    dm = res.device("status") == 3
    evpa = res.device("evpa")[dm]
    chk = res.device("pol_check")[dm]
    wgt = res.device("pol_weight")[dm]
    rows = {name: csv_rows(os.path.join(DISK_OUT, name)) for name in
            ("redshift_map.csv", "polarization_map.csv", "line_profile.csv",
             "photon_data.csv")}
    n_disk = int(dm.sum())
    info = {"argv": " ".join(argv), "launches": launches, "counts": counts,
            "csv_rows": rows, "cli_wall_s": cli_wall,
            "evpa_finite": bool(torch.isfinite(evpa).all()),
            "evpa_min": float(evpa.min()), "evpa_max": float(evpa.max()),
            "max_abs_pol_check_minus_1": float((chk - 1.0).abs().max()),
            "median_abs_pol_check_minus_1": float(
                (chk - 1.0).abs().median()),
            "pol_weight_min": float(wgt.min()),
            "pol_weight_max": float(wgt.max())}
    phase(29, f"polarized disk CLI {DISK_SIZE}x{DISK_SIZE}/{DISK_STEPS} "
              f"steps through kernel B6 ({CARD}): {json.dumps(info)}")
    if launches != 1:
        raise AssertionError(f"the disk CLI launched B6 {launches} times")
    if counts["numerical_error"] or counts["disk"] <= 0:
        raise AssertionError(f"numerical_error not 0 or no disk: {counts}")
    if not (info["evpa_finite"] and info["evpa_min"] >= 0.0
            and info["evpa_max"] <= math.pi):
        raise AssertionError("EVPA not finite in [0, pi] on the disk")
    if not (rows["redshift_map.csv"] == rows["polarization_map.csv"]
            == n_disk == counts["disk"]
            and rows["photon_data.csv"] == DISK_SIZE * DISK_SIZE
            and rows["line_profile.csv"] == 48):
        raise AssertionError(f"the disk CSVs' rows {rows} are not one per "
                             f"disk pixel ({n_disk}) / per pixel / 48 bins")

    args = parse_args(argv)
    scene, disk = scene_from_args(args), disk_from_args(args)
    bg = (artifacts.load_background(scene.background,
                                    size=(DISK_SIZE, DISK_SIZE))
          if artifacts.background_available(scene.background) else None)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render_disk(scene, disk, bg_array=bg,
                                      device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError("a warm polarized render's counts differ")
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    b6 = []
    for _ in range(3):
        b6.append(timed(lambda: ks.integrate_batch_disk_cuda(
            q0, p0, DISK_STEPS, DISK_DELTA, (MASS, DISK_SPIN, 0.0), R_MAX,
            OMEGA, *disk_annulus()), q0.device)[1])
    wall = float(np.median(walls))
    phase(29, f"polarized disk render_disk warm wall time ({CARD}): median "
              f"{wall:.6f} s of {[round(w, 6) for w in walls]}; B6 "
              f"kernel+wrapper on its rays median {np.median(b6):.3f} ms of "
              f"{[round(t, 3) for t in b6]}")
    return {"res": res, "launches": launches, "wall": wall,
            "b6_ms": float(np.median(b6))}


def reshade_phase(cli):
    """Phase 30: the transfer map reshaded on the card with the trace-time
    knobs equals the render byte for byte; then `cli.reshade` with new
    knobs; B6 launched 0 times."""
    import contextlib
    import io
    import grtrace_torch
    from grtrace_torch.cli import reshade as reshade_cli
    from grtrace_torch.engine import integrate_ks_cuda as ks
    res = cli["res"]
    ks.disk_launches = 0
    tm = grtrace_torch.TransferMap.load(DISK_MAP)
    re = grtrace_torch.reshade(tm, device="cuda")
    torch.cuda.synchronize()
    same = {k: same_bytes(re.device(k), res.device(k))
            for k in ("image", "redshift", "evpa", "pol_weight", "pol_check")}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        grtrace_torch.reshade(tm, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = os.path.join(DISK_OUT, "reshade")
    argv = ["--transfer", DISK_MAP, "--disk-profile", "novikov",
            "--disk-bfield", "toroidal", "--disk-emissivity", "2", "3", "4",
            "--out-dir", out, "--no-plots"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rcli = reshade_cli.main(argv)
    cli_wall = time.perf_counter() - t0
    launches = ks.disk_launches
    rows = [csv_rows(os.path.join(out, sub, "polarization_map.csv"))
            for sub in ("", "q3", "q4")]
    info = {"byte_equal": same, "launches": launches,
            "reshade_s": times, "cli_argv": " ".join(argv),
            "cli_wall_s": cli_wall, "cli_disk": rcli.counts["disk"],
            "cli_polarization_rows": rows}
    phase(30, f"transfer map reshaded on the card ({CARD}): "
              f"{json.dumps(info)}")
    if not all(same.values()):
        raise AssertionError(f"reshade is not byte-equal to the render: "
                             f"{same}")
    if launches != 0:
        raise AssertionError(f"reshade launched B6 {launches} times")
    if rows != [res.counts["disk"]] * 3:
        raise AssertionError(f"the reshade CLI's maps have {rows} rows")
    return {"launches": launches, "reshade_s": float(np.median(times))}


def moving_camera_phase():
    """Phase 31: the moving camera: 'keplerian' through B6 once; 'zamo'
    equal to its explicit float bit for bit; a superluminal rate refused;
    B6 against its twin bitwise on the boosted camera's rays."""
    import grtrace_torch
    from grtrace_torch import DiskConfig
    from grtrace_torch.engine import integrate_ks_cuda as ks
    from grtrace_torch.engine.disk import resolve_camera_omega
    from grtrace_torch.engine.validate import ks_kernel_parity
    from grtrace_torch.io.textures import starfield
    from grtrace_torch.physics.camera import (boosted_ics_from_pixels,
                                              pixel_grid_lookat)
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    scene = disk_scene()
    tex = starfield()
    ks.disk_launches = 0
    t0 = time.perf_counter()
    kep = grtrace_torch.render_disk(
        scene, DiskConfig(camera_omega="keplerian"), bg_array=tex,
        device="cuda")
    wall = time.perf_counter() - t0
    launches = ks.disk_launches
    _, zamo = resolve_camera_omega(scene, DiskConfig(camera_omega="zamo"))
    a = grtrace_torch.render_disk(scene, DiskConfig(camera_omega="zamo"),
                                  device="cuda")
    b = grtrace_torch.render_disk(scene, DiskConfig(camera_omega=zamo),
                                  device="cuda")
    zamo_equal = all(same_bytes(a.device(k), b.device(k))
                     for k in ("image", "status", "hit_q", "hit_p",
                               "redshift", "q0", "p0"))
    try:
        resolve_camera_omega(scene, DiskConfig(camera_omega=0.5))
        refused = False
    except ValueError:
        refused = True

    dev = torch.device("cuda", 0)
    _, omega = resolve_camera_omega(scene,
                                    DiskConfig(camera_omega="keplerian"))
    obs = torch.tensor(np.array([OBS_X * math.cos(math.radians(12.0)), 0.0,
                                 OBS_X * math.sin(math.radians(12.0))]),
                       dtype=torch.float32, device=dev)
    pix = pixel_grid_lookat(obs, torch.tensor(math.radians(FOV_DEG),
                                              dtype=torch.float32,
                                              device=dev),
                            BOOST_SIZE, BOOST_SIZE, dtype=torch.float32,
                            device=dev)
    params = torch.tensor([MASS, DISK_SPIN, 0.0], dtype=torch.float32,
                          device=dev)
    q0, p0, _ = boosted_ics_from_pixels(
        obs, pix, params=params, g_inv_fn=kerr_schild_g_inv,
        omega_cam=torch.tensor(omega, dtype=torch.float32, device=dev))
    q0, p0 = q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()
    ks.integrate_batch_disk_cuda(q0, p0, BOOST_STEPS, BOOST_DELTA,
                                 (MASS, DISK_SPIN, 0.0), R_MAX, OMEGA,
                                 *disk_annulus())  # warm-up
    kern, par = ks_kernel_parity(q0, p0, BOOST_STEPS, BOOST_DELTA,
                                 (MASS, DISK_SPIN, 0.0), R_MAX, OMEGA,
                                 disk=disk_annulus())
    par.update(rays=q0.shape[0], steps=BOOST_STEPS, delta=BOOST_DELTA,
               omega=omega, hits=int((kern[2] == 3).sum()))
    info = {"keplerian_launches": launches, "keplerian_counts": kep.counts,
            "keplerian_first_render_s": wall, "zamo_omega": zamo,
            "zamo_equals_explicit": zamo_equal,
            "superluminal_refused": refused, "b6_vs_twin_boosted": par}
    phase(31, f"moving camera, {DISK_SIZE}x{DISK_SIZE} ({CARD}): "
              f"{json.dumps(info)}")
    if launches != 1 or kep.counts["numerical_error"] \
            or kep.counts["disk"] <= 0:
        raise AssertionError("the Keplerian camera's render did not launch "
                             "B6 once with numerical_error 0 and a disk")
    if not zamo_equal or not refused:
        raise AssertionError("'zamo' differs from its value, or a "
                             "superluminal camera was accepted")
    gate_parity("boosted disk camera", par)
    return {"launches": launches}


def hotspot_phase():
    """Phase 32: `grtrace_torch.cli.hotspot` (256x256, a = 0.9, 64 frames:
    B6 once) and with --transfer on phase 29's map (B6 0 times, frames
    and, shaded 16 frames at a time, the same frames and light curve as
    the movie shaded at once);
    the --bench line's frames/s."""
    import contextlib
    import io
    import grtrace_torch
    from grtrace_torch.cli import hotspot as hot_cli
    from grtrace_torch.engine import integrate_ks_cuda as ks
    runs = {}
    for tag, argv in (
            ("render", ["--size", "256", "--metric", "kerr", "--spin",
                        str(DISK_SPIN), "--frames", str(HOT_FRAMES)]),
            ("transfer", ["--transfer", DISK_MAP, "--frames",
                          str(HOT_FRAMES), "--no-gif"])):
        out_dir = os.path.join(DISK_OUT, f"hotspot_{tag}")
        ks.disk_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = hot_cli.main(argv + ["--no-plots", "--bench", "--out-dir",
                                       out_dir])
        wall = time.perf_counter() - t0
        runs[tag] = {"argv": " ".join(argv), "launches": ks.disk_launches,
                     "frames": list(out["frames"].shape),
                     "lightcurve_rows": csv_rows(os.path.join(
                         out_dir, "lightcurve.csv")),
                     "flux_max": float(out["flux"].max()),
                     "light_curve_finite": bool(all(
                         np.isfinite(out[k]).all() for k in
                         ("flux", "weighted_g", "centroid"))),
                     "period_M": out["period"], "cli_wall_s": wall,
                     "bench": out["bench"]}
        runs[tag]["out"] = out
    # the movie from the map again, 16 frames at a time: chunking is exact
    tm = grtrace_torch.TransferMap.load(DISK_MAP)
    ks.disk_launches = 0
    chunked = grtrace_torch.hotspot_from_transfer(
        tm, grtrace_torch.HotspotConfig(n_frames=HOT_FRAMES),
        frames_per_chunk=16, device="cuda")
    whole = runs["transfer"].pop("out")
    runs["render"].pop("out")
    # the frames are elementwise, so equal; the light curve's pixel sums
    # may reduce in another order, so within float32 rounding
    chunk_err = {k: float(np.max(np.abs(chunked[k] - whole[k])
                                 / np.maximum(np.abs(whole[k]), 1e-30)))
                 for k in ("flux", "weighted_g", "centroid")}
    chunks_equal = (np.array_equal(chunked["frames"], whole["frames"])
                    and all(e <= 1e-5 for e in chunk_err.values()))
    runs["transfer_16_frames_per_chunk"] = {
        "launches": ks.disk_launches, "frames_equal_and_curve_close":
        chunks_equal, "max_rel_err": chunk_err}
    phase(32, f"hot spot ({CARD}): {json.dumps(runs)}")
    if runs["render"]["launches"] != 1 or runs["transfer"]["launches"] != 0 \
            or ks.disk_launches != 0:
        raise AssertionError("the hot spot must launch B6 once, and 0 times "
                             "from a transfer map")
    if not chunks_equal:
        raise AssertionError("the movie shaded 16 frames at a time differs "
                             f"from the movie shaded at once: {chunk_err}")
    for tag in ("render", "transfer"):
        r = runs[tag]
        if (r["frames"][0] != HOT_FRAMES or r["lightcurve_rows"]
                != HOT_FRAMES or not r["flux_max"] > 0.0
                or not r["light_curve_finite"]):
            raise AssertionError(f"hot spot {tag}: {r}")
    return runs


def polarized_subring_phase():
    """Phase 33: the polarized subring frame (256x256, 3 orders, vertical
    field) through B7 once; then the face-on toroidal disk (40x40, a = 0,
    float64, through B6): a radial EVPA pattern."""
    import grtrace_torch
    from grtrace_torch import DiskConfig, IntegratorConfig, SceneConfig
    from grtrace_torch.engine import integrate_ks_cuda as ks
    scene, disk = subring_scene()
    disk = DiskConfig(**{**vars(disk), "bfield": "vertical"})
    ks.subring_launches = 0
    t0 = time.perf_counter()
    res = grtrace_torch.render_subrings(scene, disk, n_orders=SUB_ORDERS,
                                        device="cuda")
    wall = time.perf_counter() - t0
    launches = ks.subring_launches
    valid = res.valid
    evpa = res.evpa
    finite = [bool(np.isfinite(evpa[k][valid[k]]).all())
              for k in range(SUB_ORDERS)]
    beta = grtrace_torch.polarized_moments(res, ms=(2,))[2]
    summ = grtrace_torch.subring_summary(res)

    face = SceneConfig(size=40, metric="kerr", spin=0.0, n_samples=0,
                       background=None,
                       integrator=IntegratorConfig(steps=2500, delta=0.06,
                                                   dtype="float64"))
    ks.disk_launches = 0
    fr = grtrace_torch.render_disk(face, DiskConfig(
        elevation_deg=89.9, show_background=False, bfield="toroidal"),
        device="cuda")
    face_launches = ks.disk_launches
    dm = fr.status == 3
    ii, jj = np.nonzero(dm)
    psi = np.mod(np.arctan2(jj - 19.5, ii - 19.5), np.pi)
    d = np.abs(fr.device("evpa").cpu().numpy()[dm] - psi)
    d = np.minimum(d, np.pi - d)           # EVPA is an angle mod pi
    chk = fr.device("pol_check").cpu().numpy()[dm]
    info = {"launches": launches, "counts": res.counts,
            "first_render_s": wall,
            "valid_per_order": valid.sum(axis=(1, 2)).tolist(),
            "evpa_finite_per_order": finite,
            "beta2": [[b.real, b.imag] for b in beta],
            "beta2_abs_per_order": summ["beta2_abs_per_order"],
            "evpa_twist_per_order_rad": summ["evpa_twist_per_order_rad"],
            "face_on": {"launches": face_launches, "disk": int(dm.sum()),
                        "median_circular_err": float(np.median(d)),
                        "max_circular_err": float(d.max()),
                        "max_abs_pol_check_minus_1": float(
                            np.abs(chk - 1.0).max())}}
    phase(33, f"polarized subrings {SUB_SIZE}x{SUB_SIZE}, {SUB_ORDERS} "
              f"orders, and the face-on toroidal disk ({CARD}): "
              f"{json.dumps(info)}")
    if launches != 1 or res.counts["numerical_error"]:
        raise AssertionError("the polarized subring render did not launch "
                             "B7 once with numerical_error 0")
    if not (all(finite) and all(np.isfinite([b.real, b.imag]).all()
                                for b in beta)
            and valid[0].any() and valid[1].any()):
        raise AssertionError("per-order EVPA or beta_2 not finite")
    if face_launches != 1 or dm.sum() <= 100:
        raise AssertionError("the face-on disk did not launch B6 once with "
                             "over 100 disk pixels")
    if not (np.median(d) < 0.05 and d.max() < 0.2
            and np.abs(chk - 1.0).max() < 1e-3):
        raise AssertionError("the face-on toroidal EVPA is not radial")
    return {"launches": launches, "face_launches": face_launches}


# --- the generic engine: kernels G1 and S2 (phases 34-37) -----------------
# the README's Kerr command at full width, in both charts (the default sky
# is not in the repository, so a procedural one, as in phase 25; no plots,
# which need matplotlib): path 1 '--metric kerr' (B5 for the frame, S2 in
# the Kerr-Schild chart for the 20 sampled rays), path 2 '--metric kerr-bl'
# (G1, then the Boyer-Lindquist rescue on the host, then S2 in that chart)
GEN_ARGV = ["--size", str(KERR_SIZE), "--spin", str(KERR_SPIN), "--steps",
            str(KERR_STEPS), "--delta", str(KERR_DELTA), "--background",
            "procedural:starfield", "--no-plots", "--print-metrics"]
GEN_OUT = os.path.join(HERE, "build", "gen_cli_out")
# phase 34's shapes: the unfolded camera at 48x48 with charge, 3000 steps
# (delta 0.1: the twins' loops end when the last ray exits, 7-16 ms a step
# on the card at order 2 and 4)
GEN_SMALL, GEN_SMALL_STEPS, GEN_SMALL_DELTA, GEN_CHARGE = 48, 3000, 0.1, 0.3
# phase 35's full-budget twin holds every ray of the frame unless the
# kernel's longest ray is longer than this (about 8 ms a twin step on the
# frame's million rays); then every 16th ray
GEN_TWIN_MAX_STEPS = 8_000


def gen_camera(size, params, dtype=torch.float32):
    """The unfolded Boyer-Lindquist camera's (N, 4) rays on the card."""
    from grtrace_torch.physics.camera import camera_rays_unfolded
    from grtrace_torch.physics.spacetime import kerr_g_inv
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device="cuda")
    q0, p0, _ = camera_rays_unfolded(obs, math.radians(FOV_DEG), size, size,
                                     params=params, g_inv_fn=kerr_g_inv,
                                     dtype=dtype, device="cuda")
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def gen_parity_phase():
    """Phase 34: G1 bitwise against its twin on the 48x48 unfolded camera,
    a = 0.9, Q = 0.3, 3000 steps, in float32 and float64 at orders 2 and
    4."""
    from grtrace_torch.engine.integrate_generic_cuda import \
        integrate_batch_generic_cuda
    from grtrace_torch.engine.validate import gen_kernel_parity
    params = (MASS, KERR_SPIN, GEN_CHARGE)
    args = (GEN_SMALL_STEPS, GEN_SMALL_DELTA, params, R_MAX, OMEGA)
    for dtype in (torch.float32, torch.float64):
        q0, p0 = gen_camera(GEN_SMALL, params, dtype)
        for order in (2, 4):
            integrate_batch_generic_cuda(q0, p0, *args, order=order)  # warm
            kern, res = gen_kernel_parity(q0, p0, *args, order=order)
            status = kern[2]
            res.update(dtype=str(dtype)[6:], rays=q0.shape[0], order=order,
                       steps=GEN_SMALL_STEPS, delta=GEN_SMALL_DELTA,
                       spin=KERR_SPIN, charge=GEN_CHARGE,
                       captured=int((status == 1).sum()),
                       escaped=int((status == 2).sum()),
                       n_steps_max=int(kern[3].max()))
            tag = (f"unfolded camera {GEN_SMALL}x{GEN_SMALL}, "
                   f"{str(dtype)[6:]}, order {order}")
            phase(34, f"G1 kernel vs eager twin, {tag} ({CARD}): "
                      f"{json.dumps(res)}")
            gate_parity(tag, res)


def gen_cli(metric):
    """`grtrace_torch.cli.main` on the README's Kerr command with
    `--metric metric`, in-process, with G1's, S2's and B5's counts set to
    0 just before and read just after, and the eager twins counted on
    CUDA rays.  Returns (result, {G1, S2, B5: launches}, eager calls on
    CUDA rays, the printed stages, the wall in s)."""
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine import integrate_ks as tks
    from grtrace_torch.engine import integrate_ks_cuda as ks
    eager_on_cuda = []

    def counted(fn, name):
        def twin(q0s, *args, **kw):
            if q0s.is_cuda:
                eager_on_cuda.append(name)
            return fn(q0s, *args, **kw)
        return twin

    twins = {(tig, "integrate_generic_twin"), (tig, "trajectory_generic_twin"),
             (tks, "_integrate_twin")}
    saved = {(mod, name): getattr(mod, name) for mod, name in twins}
    for (mod, name), fn in saved.items():
        setattr(mod, name, counted(fn, name))
    tgc.launches = tgc.traj_launches = ks.launches = 0
    argv = GEN_ARGV + ["--metric", metric, "--out-dir", GEN_OUT]
    t0 = time.perf_counter()
    try:
        res, lines = run_cli(argv)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    wall = time.perf_counter() - t0
    launches = {"G1": tgc.launches, "S2": tgc.traj_launches,
                "B5": ks.launches}
    return res, launches, eager_on_cuda, json_line(lines, "stages_s"), wall


def gen_warm_wall(metric, counts):
    """The path's render (frame and 20 sampled rays), warm: median of 3
    synchronized calls of render() on the CLI's scene."""
    import grtrace_torch
    from grtrace_torch.cli.args import parse_args, scene_from_args
    from grtrace_torch.io import artifacts
    scene = scene_from_args(parse_args(GEN_ARGV + ["--metric", metric]))
    bg = artifacts.load_background(scene.background,
                                   size=(KERR_SIZE, KERR_SIZE))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=bg, seed=0, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"a warm {metric} render's counts "
                                 f"{r.counts} differ from the CLI's {counts}")
    return float(np.median(walls)), walls


def sampled_rays(res, params, metric, tag, n):
    """S2 against its twin on the CLI's sampled rays at the full budget
    (`validate.gen_traj_parity`), with the CLI's own converted
    trajectories' first rows checked; returns the parity dict with its
    bound."""
    from grtrace_torch.engine.validate import gen_traj_parity
    idx = torch.as_tensor(res.sampled_indices[:, 0] * KERR_SIZE
                          + res.sampled_indices[:, 1], device="cuda")
    q0 = res.device("q0").reshape(-1, 4)[idx].contiguous()
    p0 = res.device("p0").reshape(-1, 4)[idx].contiguous()
    _, par = gen_traj_parity(q0, p0, KERR_STEPS, KERR_DELTA, params, R_MAX,
                             OMEGA, metric=metric, n_keep=TRAJ_POINTS)
    first = np.stack([t[0] for t in res.sampled_trajectories])
    rho0 = np.linalg.norm(first, axis=1)
    finite = all(np.isfinite(t).all() for t in res.sampled_trajectories)
    par.update(first_row_rho_min=float(rho0.min()),
               first_row_rho_max=float(rho0.max()),
               trajectories_finite=bool(finite))
    kernel = ("fantasy_gen_traj_bl" if metric == "Kerr"
              else "fantasy_gen_traj_ks")
    par["bound_ms"], par["bound_by"] = bound(
        metrics.kernel_ops(kernel, par["n_steps_sum"], par["rays"]),
        par["rays"] * (TRAJ_BYTES_RAY + par["n_keep"] * 4 * 4))
    par["chain_floor_ms"] = chain_floor(kernel, par["n_steps_max"])
    phase(n, f"S2 ({tag}) vs eager twin on the CLI's {par['rays']} sampled "
             f"rays ({KERR_STEPS}-step budget, {TRAJ_POINTS} points, "
             f"float32; {CARD}): {json.dumps(par)}")
    if not par["traj_bitwise_equal"]:
        raise AssertionError(f"S2 ({tag}) differs from its twin (max abs "
                             f"diff {par['max_abs_err']:.3e})")
    if (len(res.sampled_trajectories) != N_SAMPLES
            or not par["trajectories_finite"]
            or not 29.0 < rho0.min() <= rho0.max() < 31.0):
        raise AssertionError(f"the {tag} samples are not {N_SAMPLES} finite "
                             f"trajectories starting at rho in (29, 31)")
    return par


def gen_cli_checks(tag, launches, want, eager, counts, n):
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, want {want}")
    if eager:
        raise AssertionError(f"{tag}: eager twins ran on CUDA rays {eager}")
    if counts["numerical_error"]:
        raise AssertionError(f"{tag}: numerical_error not 0: {counts}")
    phase(n, f"{tag}: launches {launches}, no eager step on CUDA rays")


def bl_path_phase():
    """Phase 35: path 2 at full width, `cli.main --metric kerr-bl` (G1
    once, the rescue, S2 once; numerical_error 0); G1 bitwise against its
    twin on the frame's own rays at the full budget; S2 bitwise against
    its twin on the 20 sampled rays."""
    from grtrace_torch.engine.validate import gen_kernel_parity
    params = (MASS, KERR_SPIN, 0.0)
    res, launches, eager, stages, cli_wall = gen_cli("kerr-bl")
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    phase(35, f"cli.main --metric kerr-bl {KERR_SIZE}x{KERR_SIZE}/"
              f"{KERR_STEPS} steps ({CARD}): counts {counts}, cli wall "
              f"{cli_wall:.3f} s, stages {json.dumps(stages)}, longest ray "
              f"{int(ns.max())}, ray-steps {int(ns.sum())}")
    gen_cli_checks("path 2 (kerr-bl)", launches, {"G1": 1, "S2": 1, "B5": 0},
                   eager, counts, 35)
    if res.image.shape != (KERR_SIZE, KERR_SIZE, 3) or \
            not np.isfinite(res.final_q).all():
        raise AssertionError("the BL frame is misshapen or not finite")
    wall, walls = gen_warm_wall("kerr-bl", counts)
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    # G1 and its wrapper on the whole frame (CUDA events, median of 3)
    from grtrace_torch.engine.integrate_generic_cuda import \
        integrate_batch_generic_cuda
    from grtrace_torch.engine.validate import timed
    full = [timed(lambda: integrate_batch_generic_cuda(
        q0, p0, KERR_STEPS, KERR_DELTA, params, R_MAX, OMEGA), q0.device)
        for _ in range(3)]
    full_steps = int(full[0][0][3].long().sum())
    full_ms = [ms for _, ms in full]
    full_bound = bound(metrics.kernel_ops("fantasy_gen", full_steps,
                                          q0.shape[0]),
                       q0.shape[0] * BYTES_RAY)
    phase(35, f"G1 kernel+wrapper on the whole BL frame ({q0.shape[0]} "
              f"rays, {full_steps} ray-steps; {CARD}): median "
              f"{float(np.median(full_ms)):.3f} ms of "
              f"{[round(t, 3) for t in full_ms]}, bound {full_bound[0]:.3f} "
              f"ms ({full_bound[1]})")
    phase("35b", f"G1 (bare, cost-sorted) on a quarter, a half and all of "
                 f"the BL frame's rays ({KERR_STEPS}-step budget; {CARD}): "
                 f"{json.dumps(gen_sweep(q0, p0, params))}")
    held = "every ray"
    if int(ns.max()) > GEN_TWIN_MAX_STEPS:
        q0, p0, held = q0[::16].contiguous(), p0[::16].contiguous(), \
            "every 16th ray (the longest ray outlasts the twin's budget)"
    kern, par = gen_kernel_parity(q0, p0, KERR_STEPS, KERR_DELTA, params,
                                  R_MAX, OMEGA)
    ray_steps = int(kern[3].long().sum())
    n = q0.shape[0]
    par.update(rays=n, held=held, ray_steps=ray_steps,
               n_steps_max=int(kern[3].max()))
    par["bound_ms"], par["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen", ray_steps, n), n * BYTES_RAY)
    phase(35, f"G1 kernel vs eager twin on the BL frame's rays, "
              f"{KERR_STEPS}-step budget ({CARD}): {json.dumps(par)}")
    gate_parity("BL frame", par)
    phase(35, f"path 2 render warm wall time (frame and {N_SAMPLES} "
              f"samples): median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}; G1 kernel+wrapper "
              f"{par['kernel_ms']:.3f} ms on {n} rays, bound "
              f"{par['bound_ms']:.3f} ms ({par['bound_by']})")
    s2 = sampled_rays(res, params, "Kerr", "Boyer-Lindquist", 35)
    return {"launches": launches, "wall": wall, "g1": par, "s2": s2,
            "g1_full_ms": float(np.median(full_ms)),
            "g1_full_bound_ms": full_bound[0]}


# the rays of phase 36's float32 frame that JAX's float32 engine captures
# beyond the critical curve (b > 1.02 b_crit), all in the two middle
# columns: `JAX_PLATFORMS=cpu python tools/bl_critical_gap.py --groups
# outside --packages jax`
JAX_F32_POLAR_CAPTURES = 5


def bl_a0_phase():
    """Phase 36: at a = 0 the 400x400 Boyer-Lindquist frame (G1) beside
    the Schwarzschild fast path at the Kerr budget, in float64 (B2) and
    float32 (B1).  In float64, as `tests/test_render_kerr.py` holds it in
    JAX, every pixel G1 captures the fast path captures too (its
    classifier's shortcut only adds captures).  In float32 the reference
    itself does not hold that: JAX's float32 engine captures
    JAX_F32_POLAR_CAPTURES rays of this frame beyond the critical curve,
    all in the two middle columns, whose orbits pass within sin(theta) ~
    0.012 of the chart's pole (`tools/bl_critical_gap.py --groups outside
    --packages jax`; ROADMAP Queue C).  So in float32 the pixels G1 alone
    captures must lie in those columns and number no more than JAX's.
    numerical_error is 0 in both."""
    from dataclasses import replace

    import grtrace_torch
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    b_crit = 3.0 * math.sqrt(3.0) * MASS
    out = {}
    for dtype in ("float64", "float32"):
        base = kerr_scene()
        scene = replace(base, size=SIZE, metric="kerr-bl", spin=0.0,
                        integrator=replace(base.integrator, dtype=dtype))
        tgc.launches = tc.launches = tc.eq_launches = 0
        bl = grtrace_torch.render(scene, device="cuda")
        schw = grtrace_torch.render(replace(scene, metric="Schwarzschild"),
                                    device="cuda")
        launches = {"G1": tgc.launches, "B1": tc.launches,
                    "B2": tc.eq_launches}
        only = np.argwhere((bl.cls == 0) & (schw.cls != 0))
        q0, p0 = bl.q0.astype(np.float64), bl.p0.astype(np.float64)
        b = np.sqrt(p0[..., 2] ** 2 + p0[..., 3] ** 2
                    / np.sin(q0[..., 2]) ** 2) / np.abs(p0[..., 0])
        info = {"launches": launches, "bl_counts": bl.counts,
                "schwarzschild_counts": schw.counts,
                "bl_captured_not_fast_path": len(only),
                "fast_path_captured_not_bl": int(
                    ((schw.cls == 0) & (bl.cls != 0)).sum()),
                "bl_only_pixels": [
                    {"ij": [int(i), int(j)],
                     "b_over_b_crit_minus_1": float(b[i, j] / b_crit - 1),
                     "g1_steps": int(bl.n_steps[i, j])}
                    for i, j in only[:10]]}
        phase(36, f"a = 0, {dtype}: the {SIZE}x{SIZE} BL frame beside the "
                  f"Schwarzschild fast path, {KERR_STEPS} steps, delta "
                  f"{KERR_DELTA} ({CARD}): {json.dumps(info)}")
        want = {"G1": 1, "B1": int(dtype == "float32"),
                "B2": int(dtype == "float64")}
        if launches != want:
            raise AssertionError(f"a = 0 launches {launches}, want {want}")
        if bl.counts["numerical_error"]:
            raise AssertionError(f"a = 0, {dtype}: numerical error pixels")
        if dtype == "float64" and len(only):
            raise AssertionError("a = 0, float64: G1 captured a pixel the "
                                 "fast path did not")
        polar = np.isin(only[:, 1], (SIZE // 2 - 1, SIZE // 2))
        if dtype == "float32" and (len(only) > JAX_F32_POLAR_CAPTURES
                                   or not polar.all()):
            raise AssertionError(
                f"a = 0, float32: G1 captured {len(only)} pixels the fast "
                f"path did not ({int((~polar).sum())} off the polar "
                f"columns); JAX's float32 engine captures "
                f"{JAX_F32_POLAR_CAPTURES}, all polar")
        out[dtype] = info
    return out


def ks_path_phase():
    """Phase 37: path 1 at full width, `cli.main --metric kerr` (B5 once
    for the frame, S2 once in the Kerr-Schild chart for the 20 sampled
    rays, no eager step on CUDA rays); S2 bitwise against its twin on
    those rays at the full budget, their rows starting at rho in (29,
    31)."""
    params = (MASS, KERR_SPIN, 0.0)
    res, launches, eager, stages, cli_wall = gen_cli("kerr")
    counts = res.counts
    phase(37, f"cli.main --metric kerr {KERR_SIZE}x{KERR_SIZE}/{KERR_STEPS} "
              f"steps ({CARD}): counts {counts}, cli wall {cli_wall:.3f} s, "
              f"stages {json.dumps(stages)}")
    gen_cli_checks("path 1 (kerr)", launches, {"G1": 0, "S2": 1, "B5": 1},
                   eager, counts, 37)
    wall, walls = gen_warm_wall("kerr", counts)
    phase(37, f"path 1 render warm wall time (frame and {N_SAMPLES} "
              f"samples): median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}")
    s2 = sampled_rays(res, params, "KerrSchild", "Kerr-Schild", 37)
    return {"launches": launches, "wall": wall, "s2": s2}


# kernels that must not spill: B3, B5-B7 and G1 (with S2), whose
# __launch_bounds__ ask for the most blocks that fit without a spill (a
# spill means a later edit outgrew them), and B1, B2 and B4, whose step
# loop a spill would lengthen
NO_SPILL = ("fantasy_eqc_kernel", "fantasy_ks_kernel",
            "fantasy_schw16_kernel", "fantasy_gen_kernel")


def build_kernels():
    from grtrace_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    wall = time.perf_counter() - t0
    build.load()
    regs, spilled = [], []
    for stem, (lib, _) in sorted(built.items()):
        log = lib.with_suffix(".log").read_text()
        for k in build.ptxas_summary(log):
            regs.append(f"{k['kernel']}: {k['registers']} registers, "
                        f"{k['spill_stores']}/{k['spill_loads']} bytes "
                        f"spill stores/loads")
            if (k["kernel"].startswith(NO_SPILL)
                    and (k["spill_stores"] or k["spill_loads"])):
                spilled.append(k["kernel"])
    per_lib = {stem: round(s, 2) for stem, (_, s) in built.items()}
    phase(2, f"built {sorted(p.name for p, _ in built.values())} in "
             f"{wall:.2f} s (per nvcc {per_lib}); {' | '.join(regs)}")
    if spilled:
        raise AssertionError(f"{spilled} spill registers: lower their "
                             f"min_blocks (or their register use)")


# Every kernel instantiation of the port, for the occupancy report:
# resident blocks per SM of the threads each launches (its
# __launch_bounds__), from the CUDA runtime on the card
OCC_KERNELS = {
    "fantasy_eqc": [f"fantasy_eqc_kernel<{args}>" for args in (
        "float, true, true", "double, false, true", "float, true, false")],
    "fantasy_ks": [f"fantasy_ks_kernel<{t}, {comp}, Mode::{mode}>"
                   for mode in ("kPlain", "kDisk", "kSubring")
                   for t, comp in (("float", "true"), ("float", "false"),
                                   ("double", "false"))]
    + [f"fantasy_ks_kernel<{t}, false, Mode::{m}>"
       for m in ("kDiskTangent", "kDiskTangent2")
       for t in ("float", "double")],
    "fantasy_schw16": [f"fantasy_schw16_kernel<{t}, Mode::{m}>"
                       for m in ("kIntegrate", "kRecord")
                       for t in ("float", "double")],
    "fantasy_gen": [f"fantasy_gen_kernel<{t}, Chart::{c}, Mode::{m}>"
                    for c, m in (("kBL", "kIntegrate"), ("kBL", "kRecord"),
                                 ("kKS", "kRecord"),
                                 ("kStatic", "kIntegrate"),
                                 ("kStatic", "kRecord"),
                                 ("kStatic", "kDisk"),
                                 ("kKSMass", "kIntegrate"),
                                 ("kKSMass", "kRecord"),
                                 ("kKSMass", "kDisk"),
                                 ("kKdS", "kIntegrate"),
                                 ("kKdS", "kRecord"),
                                 ("kKdS", "kDisk"))
                    for t in ("float", "double")],
}
# a probe library that includes one kernel source and asks the runtime
# about each of its kernels, at the block size it launches with (its
# __launch_bounds__, the attribute maxThreadsPerBlock): out = [blocks per
# SM, registers, local bytes a thread, static shared bytes a block,
# threads a block]
OCC_SHIM = """#include "{source}"

namespace {{
template <typename K>
int query(K kernel, int* out) {{
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {{
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, attr.maxThreadsPerBlock, 0);
  }}
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = attr.maxThreadsPerBlock;
  return static_cast<int>(err);
}}
}}  // namespace

extern "C" int grt_occupancy(int which, int* out) {{
  switch (which) {{
{cases}
  }}
  return -1;
}}
"""


def occupancy():
    """{kernel: {blocks_per_sm, warps_per_sm, registers, local_bytes,
    shared_bytes, threads}} for OCC_KERNELS, through probe libraries built
    from the checkout's sources with the kernels' own nvcc flags (all nvcc
    started together)."""
    import ctypes
    from grtrace_torch.kernels import build
    out_dir = build.BUILD_DIR / "occupancy"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, kernels in OCC_KERNELS.items():
        src = out_dir / f"{stem}_occ.cu"
        cases = "\n".join(f"    case {j}: return query(&{k}, out);"
                          for j, k in enumerate(kernels))
        src.write_text(OCC_SHIM.format(source=build.CSRC_DIR / f"{stem}.cu",
                                       cases=cases))
        lib = out_dir / f"lib{stem}_occ.so"
        procs[stem] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res = {}
    for stem, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"occupancy probe of {stem} failed:\n{log}")
        fn = ctypes.CDLL(str(lib)).grt_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        for j, kernel in enumerate(OCC_KERNELS[stem]):
            buf = (ctypes.c_int * 5)()
            err = fn(j, ctypes.addressof(buf))
            if err:
                raise RuntimeError(f"occupancy of {kernel}: cudaError {err}")
            res[kernel] = {"blocks_per_sm": buf[0],
                           "warps_per_sm": buf[0] * buf[4] // 32,
                           "registers": buf[1], "local_bytes": buf[2],
                           "shared_bytes": buf[3], "threads": buf[4]}
    return res


def _cuobjdump():
    from grtrace_torch.kernels import build
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidate = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return candidate if os.path.exists(candidate) else None


def sass_counts(lib):
    """{kernel: counts} from `cuobjdump -sass` of a built library: the
    function's instructions and MUFU (special-function unit) instructions
    by kind, and the same inside its two longest loops (the spans of its
    backward branches; IEEE division and square root issue one MUFU.RCP /
    MUFU.RSQ (64H in double) each on their fast path, their slow paths
    are called subroutines past the function's exit)."""
    import collections
    import re
    from grtrace_torch.kernels.build import _short_name
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(_short_name(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in funcs.items():
        ops = [(a, re.sub(r"^@!?U?P\w+\s+", "", t)) for a, t in ins]
        ops = [(a, t) for a, t in ops if not t.startswith("NOP")]

        def count(lo=0, hi=float("inf")):
            sel = [t for a, t in ops if lo <= a <= hi]
            mufu = collections.Counter(t.split()[0] for t in sel
                                       if t.startswith("MUFU"))
            return {"instructions": len(sel),
                    "mufu": sum(mufu.values()), "mufu_by_kind": dict(mufu)}

        loops = []
        for a, t in ops:
            m = re.match(r"BRA(?:\.\S+)?\s+(?:\S+\s*,\s*)?0x([0-9a-f]+)", t)
            if m and int(m.group(1), 16) < a:
                loops.append((int(m.group(1), 16), a))
        loops.sort(key=lambda span: span[0] - span[1])
        out[name] = {**count(), "loops": [count(lo, hi)
                                          for lo, hi in loops[:2]]}
    return out


def kernel_report():
    """Phase 2b: resident blocks and warps per SM beside the registers of
    every kernel instantiation, and the SASS counts of the libraries."""
    from grtrace_torch.kernels import build
    occ = occupancy()
    phase("2b", f"resident blocks per SM of the threads a block launches "
                f"with (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
                f"registers, local and shared bytes: {json.dumps(occ)}")
    # B1, B2, B4-B7 and B6t use no local memory at all (B3's is sin and
    # cos's argument reduction, not a spill: phase 2 checks its spills)
    local = [k for k, v in occ.items()
             if k.startswith(("fantasy_eqc_kernel", "fantasy_ks_kernel"))
             and v["local_bytes"]]
    if local:
        raise AssertionError(f"{local} use local memory: a spill")
    tool = _cuobjdump()
    if tool is None:
        phase("2b", "SASS counts: no cuobjdump on this machine")
        return occ
    for stem in OCC_KERNELS:
        lib = build.library_path(build.CSRC_DIR / f"{stem}.cu")
        phase("2b", f"SASS of {lib.name} ({tool}): "
                    f"{json.dumps(sass_counts(lib))}")
    return occ


# the ray-count sweep: every 4th, every 2nd and every ray of a frame, so
# that the time shows whether the kernel waits on its longest ray or on the
# bulk of the rays
SWEEP_STRIDES = (4, 2, 1)


def ray_sweep(prepare, q0, p0, reps=3):
    """{'1/k': {rays, ms (median of reps launches, CUDA events), ms_all}}
    for k in SWEEP_STRIDES; prepare(q, p) packs the rays as the wrapper
    does and returns the bare kernel launch."""
    from grtrace_torch.engine.validate import timed
    out = {}
    for k in SWEEP_STRIDES:
        launch = prepare(q0[::k].contiguous(), p0[::k].contiguous())
        launch()  # warm-up
        times = [timed(launch, q0.device)[1] for _ in range(reps)]
        out[f"1/{k}"] = {"rays": q0[::k].shape[0],
                         "ms": float(np.median(times)), "ms_all": times}
    return out


def ks_sweep(q0, p0, steps, delta, spin, mode="plain"):
    """B5 (or, with mode 'disk' / 'subring', B6 with the disk annulus / B7
    with SUB_ORDERS orders) in the 32-row layout on a frame's KS camera
    rays, cost-sorted as the wrappers sort."""
    from grtrace_torch.engine import integrate_ks_cuda as tkc
    from grtrace_torch.engine.integrate_ks import ks_params
    disk = {"disk": disk_annulus()} if mode == "disk" else {}
    vec = ks_params(delta, (MASS, spin, 0.0), R_MAX, OMEGA, 2, True,
                    q0.dtype, **disk)

    def subring(state, vec, steps):
        return tkc.launch_fantasy_ks_subrings(state, vec, steps, SUB_ORDERS)
    launch = {"plain": tkc.launch_fantasy_ks,
              "disk": tkc.launch_fantasy_ks_disk, "subring": subring}[mode]

    def prepare(q, p):
        _, state = tkc._sorted_state(q, p, vec, True)
        return lambda: launch(state, vec, steps)
    return ray_sweep(prepare, q0, p0)


def schw16_sweep(q0, p0, steps, delta):
    """B3 on a frame's rays, cost-sorted as its monolithic wrapper sorts."""
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.integrate import substep_params
    from grtrace_torch.physics.hamiltonian import pack_state
    params = substep_params(delta, 2.0 * MASS, R_MAX, OMEGA, 2, q0.dtype,
                            compensated=False, staggered=False)

    def prepare(q, p):
        _, q_s, p_s = tc._sorted(q, p, float(params[0]))
        state = torch.stack(pack_state(q_s, p_s))
        return lambda: tc.launch_fantasy_schw16(state, params, steps)
    return ray_sweep(prepare, q0, p0)


def gen_sweep(q0, p0, params):
    """G1 on the Boyer-Lindquist frame's rays at the Kerr budget,
    cost-sorted as its wrapper sorts."""
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine.integrate_generic import gen_params
    vec = gen_params("Kerr", KERR_DELTA, params, R_MAX, OMEGA, 2, q0.dtype)

    def prepare(q, p):
        _, q_s, p_s = tgc._sorted_rays(q, p, float(vec[0]))
        return lambda: tgc.launch_fantasy_gen(q_s, p_s, vec, KERR_STEPS)
    return ray_sweep(prepare, q0, p0)


def eqc_sweep(q0, p0, q0d, p0d):
    """Phase 3c: bare launches of fantasy_eqc.cu on cost-sorted, packed
    headline rays, as the wrappers sort and pack them: B1 on the float32
    rays (q0, p0), B2 on the float64 ones (q0d, p0d), both at the STEPS
    budget, and B4 for JOB_CHUNK steps on the carry that `checkpoint.start`
    opens from the sorted float32 rays."""
    from grtrace_torch.engine import checkpoint as ck
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.integrate import substep_params
    from grtrace_torch.physics.hamiltonian import pack_state_eq, pack_state_eqc
    rs = 2.0 * MASS
    p32 = substep_params(DELTA, rs, R_MAX, OMEGA, 2, torch.float32)
    p64 = substep_params(DELTA, rs, R_MAX, OMEGA, 2, torch.float64,
                         compensated=False)

    def b1(q, p):
        _, q_s, p_s = tc._sorted(q, p, float(p32[0]))
        state = torch.stack(pack_state_eqc(q_s, p_s))
        return lambda: tc.launch_fantasy_eqc(state, p32, STEPS)

    def b2(q, p):
        _, q_s, p_s = tc._sorted(q, p, float(p64[0]))
        state = torch.stack(pack_state_eq(q_s, p_s))
        return lambda: tc.launch_fantasy_eq(state, p64, STEPS)

    def b4(q, p):
        _, q_s, p_s = tc._sorted(q, p, float(p32[0]))
        st = ck.start(q_s, p_s, STEPS, DELTA, rs, R_MAX, OMEGA,
                      compensated=True)
        return lambda: tc.launch_fantasy_eqc_chunk(st.state, p32, JOB_CHUNK)
    return {"B1": ray_sweep(b1, q0, p0), "B2": ray_sweep(b2, q0d, p0d),
            "B4": ray_sweep(b4, q0, p0)}


# --- adaptive antialiasing and the observables (phases 38-43) --------------
# engine/aa.py on every render path of the earlier phases, at their full
# widths, with s = 2: the headline frame in float32 (the sub-rays through
# B1) and float64 (B2), the Kerr frame in the Kerr-Schild chart (B5) and
# the Boyer-Lindquist one (G1), the disk (B6) and the subrings (B7).  With
# s = 2 each sub-ray sits at a pixel of the 2N frame bit for bit, so the
# gates are byte equalities against the 2N render of the same scene.
AA_S = 2
AA_OUT = os.path.join(HERE, "build", "aa_out")
# each pass's launch is held against its eager twin on the card on the
# same sub-rays; the twin's loop lasts as long as its longest ray, so the
# sub-rays that took more steps than this are left out (only the
# Boyer-Lindquist pass has such rays: phase 35's bound), and the hold fails
# unless it covers at least AA_HELD_SHARE of the pass's sub-rays
AA_TWIN_MAX_STEPS = GEN_TWIN_MAX_STEPS
AA_HELD_SHARE = 0.99


class EventMetrics(metrics.RenderMetrics):
    """A RenderMetrics whose stages read CUDA events: the card's time
    between the stage's ends, host gaps inside it included (seconds)."""

    @contextlib.contextmanager
    def stage(self, name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + start.elapsed_time(end) / 1e3)


# the eager integration twins, "module:function" under grtrace_torch.engine,
# that a path must not call on CUDA rays: every twin of the Schwarzschild
# and Kerr-Newman kernels, and those of the static (G1s, S2s, D1) and of
# the rotating regular families (G1r, S2r, T2r, D2)
TWINS = ("integrate:integrate_batch", "integrate:integrate_batch_compensated",
         "integrate:trajectory_unmasked",
         "integrate_generic:trajectory_generic_unmasked",
         "integrate_ks:integrate_batch_ks", "integrate_ks:integrate_batch_ksc",
         "integrate_ks:integrate_batch_disk_ks",
         "integrate_ks:integrate_batch_disk_ksc",
         "integrate_ks:integrate_batch_subrings_ks",
         "integrate_ks:integrate_batch_subrings_ksc",
         "integrate_ks:integrate_batch_disk_tangent_ks",
         "integrate_generic:integrate_batch_generic")
STATIC_TWINS = ("integrate_generic:integrate_generic_twin",
                "integrate_generic:trajectory_generic_twin",
                "disk_static:integrate_disk_static_twin")
ROT_TWINS = ("integrate_generic:integrate_generic_twin",
             "integrate_generic:trajectory_generic_twin",
             "integrate_generic:trajectory_generic_unmasked",
             "integrate_generic:integrate_disk_spin_twin")
# launch counters, label -> "module:counter" under grtrace_torch.engine
STATIC_COUNTERS = {"G1s": "integrate_generic_cuda:static_launches",
                   "S2s": "integrate_generic_cuda:static_traj_launches",
                   "T2s": "integrate_generic_cuda:static_trace_launches",
                   "D1": "integrate_generic_cuda:disk_launches"}
ROT_COUNTERS = {"G1r": "integrate_generic_cuda:rot_launches",
                "S2r": "integrate_generic_cuda:rot_traj_launches",
                "T2r": "integrate_generic_cuda:rot_trace_launches",
                "D2": "integrate_generic_cuda:rot_disk_launches"}
DISK_COUNTERS = {"B6": "integrate_ks_cuda:disk_launches",
                 "B6t": "integrate_ks_cuda:disk_tangent_launches",
                 "B6t2": "integrate_ks_cuda:disk_tangent2_launches"}
EXAMPLE_COUNTERS = {"B1": "integrate_cuda:launches",
                    "B6": "integrate_ks_cuda:disk_launches"}


def _engine_attr(ref):
    """(module, name) of a "module:name" reference under
    grtrace_torch.engine."""
    import importlib
    mod, name = ref.split(":")
    return importlib.import_module(f"grtrace_torch.engine.{mod}"), name


def counters(which, reset=False):
    """The launch counts of `which` (label -> "module:counter"), each set
    to 0 first with reset."""
    out = {}
    for label, ref in which.items():
        mod, name = _engine_attr(ref)
        if reset:
            setattr(mod, name, 0)
        out[label] = getattr(mod, name)
    return out


@contextlib.contextmanager
def eager_on_cuda(twins=TWINS):
    """The eager twins of `twins`, counted when they are called on CUDA
    rays while the block runs (the dispatchers look them up at call
    time); yields the list of the names called."""
    saved = [(m, n, getattr(m, n))
             for m, n in (_engine_attr(ref) for ref in twins)]
    calls = []

    def counted(fn, name):
        def twin(q0s, *args, **kw):
            if q0s.is_cuda:
                calls.append(name)
            return fn(q0s, *args, **kw)
        return twin
    for m, n, fn in saved:
        setattr(m, n, counted(fn, n))
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def captured_calls(mod, name, keep=None):
    """Every call of mod.name while the block runs, as (args, kwargs,
    outputs), or the last `keep` of them; yields the list (the callers
    look the name up at call time)."""
    fn = getattr(mod, name)
    calls = []

    def recorder(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        if keep:
            del calls[:-keep]
        return out
    setattr(mod, name, recorder)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


# the eager twins' steps on the card, replayed from CUDA graphs while
# `graphed_twins` is on: graphs captured, and the steps that fell back to
# eager calls (with why); printed on the phase-seconds line
TWIN_GRAPHS = {"captured": 0, "eager_fallbacks": []}
# > 0 while a step is warmed up or captured: a twin step called inside
# another's capture runs as part of that graph
_CAPTURING = [0]


def _graphable(tensors):
    return bool(tensors) and tensors[0].is_cuda and not _CAPTURING[0]


def _fresh_outputs(out, static):
    """fn's outputs, with those that share memory with an input copied
    (inside the capture), so that copying the next call's inputs in
    cannot overwrite an output the caller passes back."""
    from torch.utils._pytree import tree_flatten
    ins = {t.untyped_storage().data_ptr() for t in static
           if isinstance(t, torch.Tensor)}
    leaves, spec = tree_flatten(out)
    return [o.clone() if isinstance(o, torch.Tensor)
            and o.untyped_storage().data_ptr() in ins else o
            for o in leaves], spec


def _capture_step(fn, static, args, kw):
    """One warm-up call of fn on a side stream, then fn captured into a
    CUDA graph on `args` (built of the `static` tensors): (replay, output
    leaves, their tree spec)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        leaves, spec = _fresh_outputs(fn(*args, **kw), static)
    return graph.replay, leaves, spec


def graphed_step(fn, name):
    """An eager twin's step fn (tensors in nested tuples in and out)
    replayed from a CUDA graph: on its first call with CUDA tensors of a
    given layout it is captured (`_capture_step`); each call then copies
    its tensors into the graph's inputs and replays.  The graph launches
    the eager call's kernels on the same values, so every bit is the
    eager step's; it only drops the host's cost of each operation, which
    sets the twins' time.  The outputs are the graph's own tensors, which
    the next call overwrites: the twins' loops read a step's outputs
    before they take the next (the trajectory records copy them).  CPU
    tensors, and calls made inside another step's capture, run eagerly; a
    step that cannot be captured falls back to eager calls, listed in
    TWIN_GRAPHS."""
    from torch.utils._pytree import tree_flatten, tree_unflatten
    graphs = {}

    def step(*args, **kw):
        leaves, spec = tree_flatten((args, kw))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not _graphable(tensors):
            return fn(*args, **kw)
        key = (repr(spec), tuple((x.shape, x.dtype, x.device)
                                 if isinstance(x, torch.Tensor) else x
                                 for x in leaves))
        if key not in graphs:
            static = [x.clone() if isinstance(x, torch.Tensor) else x
                      for x in leaves]
            s_args, s_kw = tree_unflatten(static, spec)
            _CAPTURING[0] += 1
            try:
                graphs[key] = (static,) + _capture_step(fn, static, s_args,
                                                        s_kw)
                TWIN_GRAPHS["captured"] += 1
            except RuntimeError as err:
                torch.cuda.synchronize()
                graphs[key] = None
                TWIN_GRAPHS["eager_fallbacks"].append(
                    f"{name}: {str(err).splitlines()[0][:160]}")
            finally:
                _CAPTURING[0] -= 1
        if graphs[key] is None:
            return fn(*args, **kw)
        static, replay, out, out_spec = graphs[key]
        for s, x in zip(static, leaves):
            if isinstance(s, torch.Tensor) and s is not x:
                s.copy_(x)
        replay()
        return tree_unflatten(out, out_spec)
    return step


@contextlib.contextmanager
def graphed_twins():
    """While the block runs, every eager twin's step on CUDA rays replays
    a CUDA graph (`graphed_step`): the masked loops of B1-B4 and of the
    plain Schwarzschild twin (`integrate._run_masked`), the steps of S1's
    and T1's twins (`integrate.fantasy_step`), of B5-B7's
    (`integrate_ks.make_ks_step`), of G1's and S2's
    (`integrate_generic.make_generic_step`) and of T2's
    (`integrate_generic.make_composed_step`).  The dispatchers, kernels
    and counters are untouched."""
    from grtrace_torch.engine import integrate as ti
    from grtrace_torch.engine import integrate_generic as tg
    from grtrace_torch.engine import integrate_ks as tks
    run_masked, fantasy_step = ti._run_masked, ti.fantasy_step
    make_ks_step, make_generic_step = tks.make_ks_step, tg.make_generic_step
    make_composed_step = tg.make_composed_step

    def graphed_run_masked(state, steps, step_fn, *args):
        return run_masked(state, steps, graphed_step(step_fn, "_run_masked"),
                          *args)

    def graphed_make_ks_step(*args, **kw):
        active, masked_step, open_fn, close_fn = make_ks_step(*args, **kw)
        return (active, graphed_step(masked_step, "make_ks_step"), open_fn,
                close_fn)

    def graphed_make_generic_step(*args, **kw):
        active, opening, step = make_generic_step(*args, **kw)
        return active, opening, graphed_step(step, "make_generic_step")

    def graphed_make_composed_step(*args, **kw):
        opening, composed = make_composed_step(*args, **kw)
        return opening, graphed_step(composed, "make_composed_step")
    ti._run_masked = graphed_run_masked
    ti.fantasy_step = graphed_step(fantasy_step, "fantasy_step")
    tks.make_ks_step = graphed_make_ks_step
    tg.make_generic_step = graphed_make_generic_step
    tg.make_composed_step = graphed_make_composed_step
    try:
        yield TWIN_GRAPHS
    finally:
        ti._run_masked, ti.fantasy_step = run_masked, fantasy_step
        tks.make_ks_step, tg.make_generic_step = (make_ks_step,
                                                  make_generic_step)
        tg.make_composed_step = make_composed_step


def _rays_of(out, idx):
    """A dispatcher's outputs on the rays idx (the subring hit records are
    (n_orders, N, 4))."""
    return tuple(o[:, idx] if o.dim() == 3 else o[idx] for o in out)


def aa_pass_parity(tag, kernel, dispatch, call, n):
    """The AA pass's own launch, as the render made it (the dispatcher's
    captured arguments and outputs), against the eager twin on the same
    sub-rays on the card: the dispatcher with backend='torch' (B2's twin
    is integrate_batch_eq, as in check_parity).  Gated bitwise on
    final_q, final_p, status, n_steps and the hit records, on every
    sub-ray that took at most AA_TWIN_MAX_STEPS steps; fails unless they
    are at least AA_HELD_SHARE of the pass's sub-rays."""
    from grtrace_torch.engine import integrate as ti
    from grtrace_torch.engine.validate import compare_outputs, timed
    args, kw, kern = call
    ns = kern[3].abs()
    rays = ns.shape[0]
    keep = ns <= AA_TWIN_MAX_STEPS
    held = int(keep.sum())
    if held < AA_HELD_SHARE * rays:
        raise AssertionError(f"AA {tag}: {rays - held} of {rays} sub-rays "
                             f"took more than {AA_TWIN_MAX_STEPS} steps; "
                             f"fewer than {AA_HELD_SHARE:.0%} to hold")
    if held < rays:
        idx = torch.nonzero(keep).reshape(-1)
        args = (args[0][idx].contiguous(), args[1][idx].contiguous()) \
            + tuple(args[2:])
        kern = _rays_of(kern, idx)
    if kernel == "B2":
        def twin():
            return ti.integrate_batch_eq(*args, order=kw["order"])
    else:
        def twin():
            return dispatch(*args, **dict(kw, backend="torch"))
    ref, plain_ms = timed(twin, args[0].device)
    res = compare_outputs(kern, ref)
    res.update(rays=rays, rays_held=held,
               n_steps_max_held=int(kern[3].abs().max()), plain_ms=plain_ms)
    phase(n, f"AA {tag}: the pass's {kernel} launch vs the eager twin on "
             f"its sub-rays ({CARD}): {json.dumps(res)}")
    gate_parity(f"AA {tag} pass", res)
    res["held"] = (f"the pass's launch on {held} of its {rays} sub-rays "
                   f"(those of at most {AA_TWIN_MAX_STEPS} steps)")
    return res


def box_average(image, size, s=AA_S):
    """The s x s blocks of the sN frame averaged with engine/aa.py's
    rounding (float32 mean, + 0.5, clipped)."""
    blocks = np.asarray(image, np.float32).reshape(size, s, size, s, 3)
    return np.clip(blocks.mean(axis=(1, 3)) + 0.5, 0, 255).astype(np.uint8)


def warm_walls(fn, n=3):
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def warm_aa_passes(render, size, n=3):
    """n warm AA renders, each with its stages read by CUDA events: (host
    walls, the pass's kernel+wrapper ms, the whole pass's ms)."""
    walls, integrate_ms, pass_ms = [], [], []
    for _ in range(n):
        rm = EventMetrics()
        t0 = time.perf_counter()
        render(size, aa_samples=AA_S, metrics=rm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        integrate_ms.append(1e3 * rm.stages["device_pipeline/aa/integrate"])
        pass_ms.append(1e3 * rm.stages["device_pipeline/aa"])
    return walls, integrate_ms, pass_ms


def aa_phase(n, tag, render, size, kernel, counter, ops_kernel, dispatch,
             subring=False):
    """One path's AA frame at its full width: the base render, the AA
    render (stages by CUDA events, the eager twins counted on CUDA rays,
    the dispatcher's calls captured) and the 2N render, each with the
    path's kernel count set to 0 just before and read just after; then the
    gates: (a) refined pixels byte-equal to the 2N render box-averaged
    (the subrings' per-order intensities within rtol 1e-6), (b) unrefined
    pixels, the class map and the counts byte-equal to the base render's,
    (c) the AA render launches the kernel twice (the frame and its one
    pass) and no twin on CUDA rays, (d) the pass's launch bitwise equal to
    the eager twin on its sub-rays (`aa_pass_parity`).  Then three warm
    renders without AA and three with (the pass timed by CUDA events; the
    first AA render's times are printed apart, as they hold first-call
    costs).  render(size, **kw) renders the path's scene at `size`;
    dispatch = (module, name) of the dispatcher the pass calls."""
    mod, attr = counter

    def counted(sz, **kw):
        setattr(mod, attr, 0)
        res = render(sz, **kw)
        return res, getattr(mod, attr)

    base, base_launches = counted(size)
    rm = EventMetrics()
    with eager_on_cuda() as eager, captured_calls(*dispatch) as calls:
        aa, aa_launches = counted(size, aa_samples=AA_S, metrics=rm)
    hi, hi_launches = counted(AA_S * size)
    mask = aa.aa_mask
    edges = int(mask.sum())
    # the pass's call is the last one and holds the s^2 sub-rays of every
    # refined pixel (the disk and subring dispatchers also trace the frame)
    if not calls or calls[-1][0][0].shape[0] != edges * AA_S ** 2:
        raise AssertionError(f"AA {tag}: no dispatcher call on the "
                             f"{edges * AA_S ** 2} sub-rays")
    twin = aa_pass_parity(tag, kernel, getattr(*dispatch), calls[-1], n)
    del calls
    refined_equal = bool(np.array_equal(aa.image[mask],
                                        box_average(hi.image, size)[mask]))
    gates = {
        "refined_byte_equal_2n_box": refined_equal,
        "refined_pixels_changed": int(
            (aa.image[mask] != base.image[mask]).any(axis=-1).sum()),
        "unrefined_byte_equal_base": bool(np.array_equal(
            aa.image[~mask], base.image[~mask])),
        "cls_equal_base": bool(np.array_equal(aa.cls, base.cls)),
        "counts_equal_base": aa.counts == base.counts,
        "launches": {"base": base_launches, "aa": aa_launches,
                     "2n": hi_launches},
        "eager_twins_on_cuda": eager}
    if subring:
        bi = hi.intensity.astype(np.float64).reshape(
            -1, size, AA_S, size, AA_S).mean(axis=(2, 4))
        got = aa.intensity[:, mask].astype(np.float64)
        rel = np.abs(got - bi[:, mask]) / np.maximum(np.abs(bi[:, mask]),
                                                    1e-30)
        gates.update(
            intensity_max_rel_err=float(rel.max()),
            unrefined_intensity_equal=bool(np.array_equal(
                aa.intensity[:, ~mask], base.intensity[:, ~mask])),
            count_valid_equal=bool(np.array_equal(aa.count, base.count)
                                   and np.array_equal(aa.valid,
                                                      base.valid)),
            total_is_sum=bool(np.allclose(aa.total_intensity,
                                          aa.intensity.sum(axis=0),
                                          rtol=1e-6, atol=0.0)),
            flux_per_order={"base": base.intensity.sum(axis=(1, 2)).tolist(),
                            "aa": aa.intensity.sum(axis=(1, 2)).tolist(),
                            "2n_over_s2": (hi.intensity.sum(axis=(1, 2))
                                           / AA_S ** 2).tolist()})
    # the sub-rays are the 2N frame's rays in the refined pixels' blocks:
    # their longest chain bounds the pass from below
    ns_hi = np.abs(hi.n_steps.astype(np.int64)).reshape(size, AA_S, size,
                                                      AA_S)
    sub_steps = ns_hi.transpose(0, 2, 1, 3).reshape(size, size, -1)[mask]
    longest = int(sub_steps.max()) if edges else 0
    floor = metrics.chain_floor_ms(ops_kernel, longest, 2, SM_CLOCK_HZ) \
        if SM_CLOCK_HZ else None
    base_walls = warm_walls(lambda: render(size))
    aa_walls, integrate_ms, pass_ms = warm_aa_passes(render, size)
    info = {
        "size": size, "edges": edges, "subrays": edges * AA_S ** 2,
        "pass_kernel_wrapper_ms": float(np.median(integrate_ms)),
        "pass_ms": float(np.median(pass_ms)),
        "pass_plain_ms": twin["plain_ms"], "pass_twin_held": twin["held"],
        "warm_pass_kernel_wrapper_ms": integrate_ms,
        "warm_pass_ms": pass_ms,
        "first_aa_render_stages_s": rm.stages,
        "longest_subray_steps": longest,
        "subray_steps_sum": int(sub_steps.sum()),
        "chain_floor_ms": floor,
        "wall_s": {"base_median": float(np.median(base_walls)),
                   "aa_median": float(np.median(aa_walls)),
                   "base": base_walls, "aa": aa_walls},
        "gates": gates}
    phase(n, f"AA {tag} at {size}x{size}, s = {AA_S}, sub-rays through "
             f"{kernel} ({CARD}): {json.dumps(info)}")
    bad = [k for k in ("refined_byte_equal_2n_box",
                       "unrefined_byte_equal_base", "cls_equal_base",
                       "counts_equal_base") if not gates[k]]
    if subring:
        bad += [k for k in ("unrefined_intensity_equal", "count_valid_equal",
                            "total_is_sum") if not gates[k]]
        if not gates["intensity_max_rel_err"] <= 1e-6:
            bad.append("intensity_max_rel_err")
    if bad or not edges or not gates["refined_pixels_changed"]:
        raise AssertionError(f"AA {tag}: gates {bad} failed, or no pixel "
                             f"was refined ({edges} edges)")
    if (base_launches, aa_launches, hi_launches) != (1, 2, 1) or eager:
        raise AssertionError(f"AA {tag}: launches {gates['launches']} (the "
                             f"AA render must launch {kernel} twice: the "
                             f"frame and its pass) or eager twins {eager} "
                             f"on CUDA rays")
    info["aa_render_launches"] = aa_launches
    return info


def aa_phases():
    """Phases 38-42: the AA frames of phases 5, 18, 9, 35, 11 and 14."""
    import grtrace_torch
    from dataclasses import replace
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine import integrate_generic_cuda as tg
    from grtrace_torch.engine import aa as taa
    from grtrace_torch.engine import disk as tdisk
    from grtrace_torch.engine import integrate_ks_cuda as tks
    from grtrace_torch.engine import subring as tsub
    from grtrace_torch.io.textures import starfield
    tex = starfield()

    def at(scene, size):
        return replace(scene, size=size)

    def schw(dtype):
        return lambda sz, **kw: grtrace_torch.render(
            at(headline_scene(dtype), sz), bg_array=tex, device="cuda", **kw)

    def kerr(metric):
        return lambda sz, **kw: grtrace_torch.render(
            replace(at(kerr_scene(), sz), metric=metric), bg_array=tex,
            device="cuda", **kw)

    def disk(sz, **kw):
        return grtrace_torch.render_disk(at(disk_scene(), sz), bg_array=tex,
                                         device="cuda", **kw)

    def subrings(sz, **kw):
        scene, dc = subring_scene()
        return grtrace_torch.render_subrings(at(scene, sz), dc,
                                             n_orders=SUB_ORDERS,
                                             device="cuda", **kw)
    schw_pass = (taa, "integrate_dispatch")
    gen_pass = (taa, "integrate_dispatch_generic")
    return {
        "B1": aa_phase(38, "headline float32", schw("float32"), SIZE, "B1",
                       (tc, "launches"), "fantasy_eqc", schw_pass),
        "B2": aa_phase(38, "headline float64", schw("float64"), SIZE, "B2",
                       (tc, "eq_launches"), "fantasy_eq", schw_pass),
        "B5": aa_phase(39, "Kerr, Kerr-Schild chart", kerr("kerr"),
                       KERR_SIZE, "B5", (tks, "launches"), "fantasy_ks",
                       gen_pass),
        "G1": aa_phase(40, "Kerr, Boyer-Lindquist chart", kerr("kerr-bl"),
                       KERR_SIZE, "G1", (tg, "launches"), "fantasy_gen",
                       gen_pass),
        "B6": aa_phase(41, "disk", disk, DISK_SIZE, "B6",
                       (tks, "disk_launches"), "fantasy_ks",
                       (tdisk, "integrate_dispatch_disk")),
        "B7": aa_phase(42, "subrings", subrings, SUB_SIZE, "B7",
                       (tks, "subring_launches"), "fantasy_ks",
                       (tsub, "integrate_dispatch_subrings"), subring=True)}


def observables_cli_phase():
    """Phase 43: the drivers of this line on the card, in-process, each
    kernel count set to 0 just before and read just after: `cli.main
    --aa 2` at the headline width (B1 twice: the frame and its pass; S1
    once), `cli.subring --spin 0.9 --size 256 --orders 3 --aa 2
    --visibility` (B7 twice), `cli.visibility` with its defaults (256x256
    disk, 20k steps: B6 once) and `cli.hotspot --closure` at 256x256 (B6
    once; one FFT per frame); all with --no-plots.  Each must return and
    write its CSVs."""
    from grtrace_torch.cli import hotspot as hot_cli
    from grtrace_torch.cli import subring as sub_cli
    from grtrace_torch.cli import visibility as vis_cli
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine import integrate_ks_cuda as tks
    runs = {}

    def out_dir(name):
        return os.path.join(AA_OUT, name)

    tc.launches = tc.traj_launches = 0
    t0 = time.perf_counter()
    res, lines = run_cli(CLI_ARGV + ["--aa", str(AA_S), "--out-dir",
                                     out_dir("main")])
    runs["main"] = {
        "argv": "--size 400 --aa 2 (phase 25's flags)",
        "launches": {"B1": tc.launches, "S1": tc.traj_launches},
        "wall_s": time.perf_counter() - t0, "counts": res.counts,
        "aa_edges": int(res.aa_mask.sum()),
        "stages_s": json_line(lines, "stages_s")["stages_s"],
        "csv_rows": {f: csv_rows(os.path.join(out_dir("main"), f))
                     for f in ("photon_data.csv", "sampled_rays.csv")}}

    tks.subring_launches = 0
    t0 = time.perf_counter()
    m, _ = run_quiet(sub_cli.main, [
        "--spin", str(SUB_SPIN), "--size", str(SUB_SIZE), "--orders",
        str(SUB_ORDERS), "--aa", str(AA_S), "--visibility", "--no-plots",
        "--out-dir", out_dir("subring")])
    runs["subring"] = {
        "launches": {"B7": tks.subring_launches},
        "wall_s": time.perf_counter() - t0,
        "aa_edges": int(m["result"].aa_mask.sum()),
        "flux_per_order": m["flux_per_order"], "gamma_hat": m["gamma_hat"],
        "delay_per_order_M": m["delay_per_order_M"],
        "ring_diameter_rad_per_order": m["ring_diameter_rad_per_order"],
        "csv_rows": {f: csv_rows(os.path.join(out_dir("subring"), f))
                     for f in ("subring_visibility.csv",
                               "subring_delay_01.csv")}}

    tks.disk_launches = 0
    t0 = time.perf_counter()
    vm, _ = run_quiet(vis_cli.main, ["--no-plots", "--out-dir",
                                     out_dir("visibility")])
    runs["visibility"] = {
        "launches": {"B6": tks.disk_launches},
        "wall_s": time.perf_counter() - t0, "metrics": vm,
        "csv_rows": {f: csv_rows(os.path.join(out_dir("visibility"), f))
                     for f in ("visibility_radial.csv",
                               "closure_phases.csv")}}

    tks.disk_launches = 0
    t0 = time.perf_counter()
    hot, _ = run_quiet(hot_cli.main, [
        "--size", "256", "--metric", "kerr", "--spin", str(DISK_SPIN),
        "--frames", str(HOT_FRAMES), "--closure", "--no-gif", "--no-plots",
        "--out-dir", out_dir("hotspot")])
    series = hot["closure"]
    runs["hotspot"] = {
        "launches": {"B6": tks.disk_launches},
        "wall_s": time.perf_counter() - t0,
        "closure_swing_deg": np.degrees(np.ptp(series, axis=0)).tolist(),
        "closure_finite": bool(np.isfinite(series).all()),
        "csv_rows": {"closure_vs_time.csv": csv_rows(os.path.join(
            out_dir("hotspot"), "closure_vs_time.csv"))}}
    phase(43, f"the observables' drivers on the card ({CARD}): "
              f"{json.dumps(runs)}")
    want = {"main": {"B1": 2, "S1": 1}, "subring": {"B7": 2},
            "visibility": {"B6": 1}, "hotspot": {"B6": 1}}
    bad = [k for k, v in want.items() if runs[k]["launches"] != v]
    if bad:
        raise AssertionError(f"driver launches differ from {want}: {bad}")
    rows = runs["main"]["csv_rows"]
    if (rows["photon_data.csv"] != SIZE * SIZE
            or rows["sampled_rays.csv"] != N_SAMPLES * TRAJ_POINTS
            or not runs["main"]["aa_edges"]):
        raise AssertionError(f"cli.main --aa: {runs['main']}")
    if (not all(v > 0 for r in runs.values() for v in r["csv_rows"].values())
            or runs["hotspot"]["csv_rows"]["closure_vs_time.csv"]
            != HOT_FRAMES or not runs["hotspot"]["closure_finite"]
            or not runs["subring"]["aa_edges"]):
        raise AssertionError(f"a driver wrote an empty CSV or no result: "
                             f"{runs}")
    return runs

# --- the EinsteinPy-compatible traces and the observables (44-47) -------
OBS_OUT = os.path.join(HERE, "build", "observables_out")
GOLDEN_RAY = os.path.join(HERE, "tests", "golden",
                          "null_geodesic_r10_a60_b60.csv")
# the golden ray of tests/test_compat_einsteinpy.py: r = 10 on the equator,
# 2000 steps, delta 0.05, omega 0.01, float64
GOLD_KW = {"position": [10.0, math.pi / 2, 0.0],
           "momentum": [1.0, math.pi / 2 - math.radians(60),
                        math.pi - math.radians(60)],
           "steps": 2000, "delta": 0.05, "omega": 0.01,
           "suppress_warnings": True}
# the Kerr and Kerr-Newman compat rays of the JAX package's tests
# (tests/test_spacetime_kerr.py, tests/test_kerr_newman.py)
KERR_TRACES = {
    "Kerr a = 0.5": {"metric": "Kerr", "metric_params": (0.5,),
                     "position": (12.0, math.pi / 2, 0.0),
                     "momentum": (-1.0, 0.0, 4.0), "steps": 100,
                     "delta": 0.05},
    "Kerr-Newman (0.5, 0.4)": {"metric": "KerrNewman",
                               "metric_params": (0.5, 0.4),
                               "position": (8.0, math.pi / 2, 0.0),
                               "momentum": (0.0, 0.0, 3.0), "steps": 400,
                               "delta": 0.01, "omega": 1.0}}
# bytes a trace step writes: (q1, p1) in float64
TRACE_BYTES_STEP = 8 * 8
# phase 46: the float64 golden of cli.shadow --spin 0.9 --numeric's
# boundary (the JAX package's XLA branch on the CPU at the CLI's numeric
# settings; tools/gen_shadow_golden.py), and the bound that the boundary
# at order 2 must keep at every azimuth (phase 8's bound for the Kerr
# boundary)
SHADOW_GOLDEN = os.path.join(HERE, "tests", "golden",
                             "shadow_numeric_a09_f64.json")
SHADOW_PX_ERR = 0.05


def event_ms(fn, reps=10):
    """The median of `reps` timed calls of fn after a warm one, by CUDA
    events, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def trace_report(tag, call, twin_fn, kernel, order=2):
    """A trace kernel's captured launch (args, kw, record) against its
    eager twin on the same ray on the card, bit for bit (no value is
    non-finite on these rays), with the kernel+wrapper time (CUDA
    events), the twin's, and the bounds: the single-chain floor and the
    throughput bound over the FP64 rate."""
    from grtrace_torch.engine.validate import _bitwise_equal, timed
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    args, kw, rec = call
    ref, twin_ms = timed(lambda: twin_fn(*args, **kw), args[0].device)
    counters = (tc, "trace_launches") if kernel == "fantasy_trace" \
        else (tgc, "trace_launches")
    before = getattr(*counters)
    fn = {"fantasy_trace": tc.trajectory_unmasked_cuda,
          "fantasy_gen_trace": tgc.trajectory_generic_unmasked_cuda}[kernel]
    ms = event_ms(lambda: fn(*args, **kw))
    setattr(*counters, before)  # timing launches are not the path's
    steps = rec.shape[1]
    rays = rec.shape[0]
    res = {"rays": rays, "steps": steps,
           "finite": bool(torch.isfinite(rec).all()),
           "record_bitwise_equal": _bitwise_equal(rec, ref),
           "max_abs_err": float((rec - ref).abs().max()),
           "kernel_ms": ms, "twin_ms": twin_ms,
           "chain_floor_ms": chain_floor(kernel, steps, order)}
    res["bound_ms"], res["bound_by"] = bound(
        metrics.kernel_ops(kernel, rays * steps, rays, order),
        rays * steps * TRACE_BYTES_STEP, PEAK_FLOPS64)
    if not (res["record_bitwise_equal"] and res["finite"]):
        raise AssertionError(f"{tag}: the trace differs from its twin or "
                             f"is not finite: {json.dumps(res)}")
    return res


def t1_phase():
    """Phase 44: kernel T1 (the trace mode of fantasy_schw16.cu) through
    the EinsteinPy-compatible classes on the card: Nulllike on the golden
    ray against tests/golden/null_geodesic_r10_a60_b60.csv at the JAX
    test's rtol = atol = 1e-10, its launch held bit for bit against
    `trajectory_unmasked` on the card; Timelike's circular orbit at r = 10
    (r within rtol 1e-9 over 2000 steps); the example
    `grtrace_torch.examples.einsteinpy_ray --no-plots` (10,000 steps, its
    r range printed); each one T1 launch and no eager step on CUDA rays;
    T1's time beside its single-chain floor on the golden ray and on the
    example's."""
    from grtrace_torch.compat import Nulllike, Timelike
    from grtrace_torch.engine import integrate as ti
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.examples import einsteinpy_ray
    gold = np.loadtxt(GOLDEN_RAY, delimiter=",", skiprows=1)
    runs = {}
    tc.trace_launches = 0
    with eager_on_cuda() as eager, \
            captured_calls(tc, "trajectory_unmasked_cuda") as calls:
        _, data = Nulllike(**GOLD_KW).trajectory
    err = np.abs(data - gold)
    runs["golden"] = {
        "launches": tc.trace_launches, "eager_twins_on_cuda": eager,
        "max_abs_err_vs_csv": float(err.max()),
        "margin_to_1e-10": float((1e-10 + 1e-10 * np.abs(gold) - err).min()),
        "trace": trace_report("T1 golden ray", calls[0],
                              ti.trajectory_unmasked, "fantasy_trace")}
    r0 = 10.0
    ell = math.sqrt(r0) / math.sqrt(1.0 - 3.0 / r0)
    tc.trace_launches = 0
    with eager_on_cuda() as eager:
        _, circ = Timelike(position=[r0, math.pi / 2, 0.0],
                           momentum=[0.0, 0.0, ell], steps=2000, delta=0.1,
                           omega=0.01, return_cartesian=False).trajectory
    runs["timelike_circular"] = {
        "launches": tc.trace_launches, "eager_twins_on_cuda": eager,
        "r_max_rel_dev": float(np.abs(circ[:, 1] / r0 - 1.0).max())}
    tc.trace_launches = 0
    t0 = time.perf_counter()
    with eager_on_cuda() as eager, \
            captured_calls(tc, "trajectory_unmasked_cuda") as calls:
        table, _ = run_quiet(einsteinpy_ray.main, ["--no-plots"])
    runs["example"] = {
        "argv": "--no-plots", "wall_s": time.perf_counter() - t0,
        "launches": tc.trace_launches, "eager_twins_on_cuda": eager,
        "samples": int(table.shape[0]),
        "r_range": [float(table[:, 8].min()), float(table[:, 8].max())],
        "trace": trace_report("T1 example", calls[0],
                              ti.trajectory_unmasked, "fantasy_trace")}
    runs["build"] = build_report("fantasy_schw16", {
        "fantasy_schw16_kernel<f,2>": "float",
        "fantasy_schw16_kernel<d,2>": "double"})
    phase(44, f"T1 through Nulllike / Timelike / the example ({CARD}): "
              f"{json.dumps(runs)}")
    bad = [k for k in ("golden", "timelike_circular", "example")
           if runs[k]["launches"] != 1 or runs[k]["eager_twins_on_cuda"]]
    if bad:
        raise AssertionError(f"T1: {bad} did not launch T1 exactly once, or "
                             f"ran an eager twin on CUDA rays")
    if runs["golden"]["margin_to_1e-10"] < 0.0:
        raise AssertionError("T1's golden ray is off the CSV by more than "
                             "rtol = atol = 1e-10")
    if runs["timelike_circular"]["r_max_rel_dev"] > 1e-9:
        raise AssertionError("Timelike's circular orbit left r = 10")
    if runs["example"]["samples"] != 10_000:
        raise AssertionError("the example traced the wrong number of steps")
    return runs


def t2_phase():
    """Phase 45: kernel T2 (the Boyer-Lindquist trace mode of
    fantasy_gen.cu) through Nulllike on the card: the Kerr (a = 0.5) and
    Kerr-Newman (0.5, 0.4) rays, each one T2 launch held bit for bit
    against `trajectory_generic_unmasked` on the card, timed beside its
    floor; and Kerr-Newman at Q = 0 equal to Kerr bit for bit."""
    from grtrace_torch.compat import Nulllike
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    runs = {}
    for tag, kw in KERR_TRACES.items():
        tgc.trace_launches = 0
        with eager_on_cuda() as eager, \
                captured_calls(tgc, "trajectory_generic_unmasked_cuda") \
                as calls:
            Nulllike(return_cartesian=False, **kw).trajectory
        runs[tag] = {"launches": tgc.trace_launches,
                     "eager_twins_on_cuda": eager,
                     "trace": trace_report(f"T2 {tag}", calls[0],
                                           tig.trajectory_generic_unmasked,
                                           "fantasy_gen_trace")}
    kn = dict(KERR_TRACES["Kerr-Newman (0.5, 0.4)"], metric_params=(0.5, 0.0))
    _, q0 = Nulllike(**kn).trajectory
    _, kerr = Nulllike(**dict(kn, metric="Kerr",
                              metric_params=(0.5,))).trajectory
    runs["Q = 0 equal to Kerr"] = bool(np.array_equal(
        q0.view(np.int64), kerr.view(np.int64)))
    runs["build"] = build_report("fantasy_gen", {
        "fantasy_gen_kernel<f,0,2>": "float",
        "fantasy_gen_kernel<d,0,2>": "double"})
    phase(45, f"T2 through Nulllike, Kerr and Kerr-Newman ({CARD}): "
              f"{json.dumps(runs)}")
    bad = [t for t in KERR_TRACES if runs[t]["launches"] != 1
           or runs[t]["eager_twins_on_cuda"]]
    if bad or not runs["Q = 0 equal to Kerr"]:
        raise AssertionError(f"T2: {bad} did not launch T2 exactly once (or "
                             f"ran an eager twin on CUDA rays), or Q = 0 "
                             f"differs from Kerr")
    return runs


def held_rounds(calls, twin):
    """Every captured B5 launch of a bisection (args, kw, outputs) against
    the eager twin on all their rays at once, at the launches' full
    budget (the twin's loop lasts as long as the longest ray): the
    comparison, the rays, the longest ray's steps and the twin's ms."""
    from grtrace_torch.engine.validate import compare_outputs, timed
    args, kw, _ = calls[0]
    q = torch.cat([c[0][0] for c in calls])
    p = torch.cat([c[0][1] for c in calls])
    kern = tuple(torch.cat(rows) for rows in zip(*(c[2] for c in calls)))
    ref, twin_ms = timed(lambda: twin(q, p, *args[2:], order=kw["order"]),
                         q.device)
    return dict(compare_outputs(kern, ref), rays=int(q.shape[0]),
                launches=len(calls), steps=int(args[2]),
                n_steps_max=int(kern[3].abs().max()), twin_ms=twin_ms)


def shadow_phase():
    """Phase 46: the shadow and lensing observables on the card.
    `cli.shadow --spin 0.9 --numeric` with its defaults (16 azimuths, three
    bisection rounds of 144 rays, 8,000 steps, order 4, float32: B5 once a
    round, no eager step on CUDA rays), then two float64 witnesses at the
    same settings through B5's 16-row double layout: the boundary at
    order 4, and at order 2.  Every round's launch of the CLI and of the
    order-4 witness is held bit for bit against the eager twin on all its
    rays at full depth.  Gates: the float64 order-4 radii equal the JAX
    package's (SHADOW_GOLDEN) at every azimuth; the CLI's float32 radii
    lie within one final bracket of them (float32 statuses near the
    critical curve may flip one probe ray); the order-2 boundary lies
    within SHADOW_PX_ERR of Bardeen's curve at every azimuth.  (At psi =
    pi the order-4 boundary lies 0.129 px outside the curve in float64,
    in the JAX package as here: ROADMAP Queue C.)  Then `cli.magnify
    --metric kerr --spin 0.9 --no-plots` at its defaults (256x256, 20k
    steps: B5 once), its JSON line and warm wall."""
    from grtrace_torch.cli import magnify as mag_cli
    from grtrace_torch.cli import shadow as shadow_cli
    from grtrace_torch.engine import integrate_ks as tks
    from grtrace_torch.engine import integrate_ks_cuda as tksc
    from grtrace_torch.engine import shadow as tshadow
    with open(SHADOW_GOLDEN) as f:
        golden = json.load(f)
    ana = np.array(golden["rho_analytic_px"])
    runs = {}
    tksc.launches = 0
    t0 = time.perf_counter()
    with eager_on_cuda() as eager, \
            captured_calls(tksc, "integrate_batch_ks_cuda") as calls, \
            captured_calls(tshadow, "numeric_boundary") as bisection:
        m, lines = run_quiet(shadow_cli.main, [
            "--spin", "0.9", "--numeric", "--out-dir",
            os.path.join(OBS_OUT, "shadow")])
    wall = time.perf_counter() - t0
    launches = tksc.launches
    psis, rho32, bracket = bisection[0][2]
    runs["shadow"] = {
        "argv": "--spin 0.9 --numeric", "wall_s": wall,
        "launches": launches, "eager_twins_on_cuda": eager,
        "numeric_px_err_max": m["numeric_px_err_max"],
        "numeric_bracket_px": m["numeric_bracket_px"],
        "mean_diameter_px": m["mean_diameter_px"],
        "circularity_deviation": m["circularity_deviation"],
        "printed": lines[-1],
        "held": held_rounds(calls, tks.integrate_batch_ksc),
        "round_kernel_ms": event_ms(lambda: tksc.integrate_batch_ks_cuda(
            *calls[0][0], **calls[0][1]), reps=3)}
    with captured_calls(tksc, "integrate_batch_ks_cuda") as calls:
        _, rho64, _ = tshadow.numeric_boundary(0.9, dtype=torch.float64)
    runs["float64_order4"] = {"held": held_rounds(calls,
                                                  tks.integrate_batch_ks)}
    _, rho64_2, _ = tshadow.numeric_boundary(0.9, dtype=torch.float64,
                                             order=2)
    tksc.launches = launches  # the timing's and witnesses' are not the CLI's
    runs["px_minus_analytic"] = {
        "float32_order4_cli": (rho32 - ana).round(4).tolist(),
        "float64_order4": (rho64 - ana).round(4).tolist(),
        "float64_order2": (rho64_2 - ana).round(4).tolist()}
    gates = {
        "analytic_equal_golden": bool(np.array_equal(
            tshadow.analytic_boundary(0.9, 0.0, psis.size)[1], ana)),
        "float64_order4_equal_golden": bool(
            np.array_equal(psis, golden["psi_rad"])
            and np.array_equal(rho64, golden["rho_px"])),
        "float32_within_a_bracket_of_float64": bool(
            (np.abs(rho32 - rho64) <= bracket).all()),
        "float64_order2_within_px_err": bool(
            (np.abs(rho64_2 - ana) <= SHADOW_PX_ERR).all())}
    runs["gates"] = gates
    tksc.launches = 0
    t0 = time.perf_counter()
    with eager_on_cuda() as eager:
        mag, lines = run_quiet(mag_cli.main, [
            "--metric", "kerr", "--spin", "0.9", "--no-plots", "--out-dir",
            os.path.join(OBS_OUT, "magnify")])
    runs["magnify"] = {"argv": "--metric kerr --spin 0.9 --no-plots",
                       "first_wall_s": time.perf_counter() - t0,
                       "launches": tksc.launches,
                       "eager_twins_on_cuda": eager, "metrics": mag,
                       "warm_wall_s": warm_walls(lambda: run_quiet(
                           mag_cli.main, ["--metric", "kerr", "--spin",
                                          "0.9", "--no-plots", "--out-dir",
                                          os.path.join(OBS_OUT,
                                                       "magnify")]))}
    phase(46, f"cli.shadow --numeric and cli.magnify through B5 ({CARD}): "
              f"{json.dumps(runs)}")
    gate_parity("B5 vs twin on cli.shadow's rounds", runs["shadow"]["held"])
    gate_parity("B5 vs twin on the float64 witness's rounds",
                runs["float64_order4"]["held"])
    if (runs["shadow"]["launches"] != 3 or runs["magnify"]["launches"] != 1
            or runs["shadow"]["eager_twins_on_cuda"]
            or runs["magnify"]["eager_twins_on_cuda"]):
        raise AssertionError("cli.shadow must launch B5 once a bisection "
                             "round (3) and cli.magnify once, with no eager "
                             "step on CUDA rays")
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        raise AssertionError(f"the numeric Kerr boundary failed {bad}")
    if not mag["valid_pixels"] or not mag["flipped_pixels"]:
        raise AssertionError("cli.magnify found no valid or no "
                             "parity-flipped pixel")
    return runs


def echo_phase():
    """Phase 47: `cli.echo --no-plots` with its defaults (192x192 disk,
    768-ray fan, 30k steps, delta 0.05) at a = 0 and at a = 0.5 with Q =
    0.4 (the charged hole's autodiff ISCO as the disk's inner edge): B6
    twice a run (the fan in float64, the disk in float32) and no eager
    step on CUDA rays; the fan's launch held bit for bit against its
    16-row float64 twin on every ray (the twin stops once every ray has
    left the domain); the driver's wall."""
    from grtrace_torch.cli import echo as echo_cli
    from grtrace_torch.engine import integrate_ks as tks
    from grtrace_torch.engine import integrate_ks_cuda as tksc
    from grtrace_torch.engine.validate import compare_outputs, timed
    runs = {}
    for spin, charge in ((0.0, 0.0), (0.5, 0.4)):
        tag = f"a = {spin}, Q = {charge}"
        tksc.disk_launches = 0
        t0 = time.perf_counter()
        with eager_on_cuda() as eager, \
                captured_calls(tksc, "integrate_batch_disk_cuda") as calls:
            m, _ = run_quiet(echo_cli.main, [
                "--no-plots", "--spin", str(spin), "--charge", str(charge),
                "--out-dir", os.path.join(OBS_OUT, f"echo_{spin}_{charge}")])
        wall = time.perf_counter() - t0
        launches = tksc.disk_launches
        args, kw, kern = next(c for c in calls
                              if c[0][0].dtype == torch.float64)
        ref, twin_ms = timed(lambda: tks.integrate_batch_disk_ks(
            *args, order=kw.get("order", 2)), args[0].device)
        held = compare_outputs(kern, ref)
        fan_ms = event_ms(lambda: tksc.integrate_batch_disk_cuda(*args,
                                                                 **kw),
                          reps=3)
        runs[tag] = {"wall_s": wall, "launches": launches,
                     "eager_twins_on_cuda": eager, "summary": m,
                     "fan": {"rays": int(args[0].shape[0]),
                             "n_steps_max": int(kern[3].abs().max()),
                             "kernel_ms": fan_ms, "twin_ms": twin_ms,
                             "held": held}}
        gate_parity(f"B6 fan vs twin, {tag}", held)
    phase(47, f"cli.echo through B6 ({CARD}): {json.dumps(runs)}")
    bad = [t for t, r in runs.items() if r["launches"] != 2
           or r["eager_twins_on_cuda"] or not r["summary"]["fan_hits"]
           or not r["summary"]["pixels"]]
    if bad:
        raise AssertionError(f"cli.echo {bad}: B6 not launched twice (fan "
                             f"and disk), an eager twin on CUDA rays, or no "
                             f"fan hit or disk pixel")
    return runs


# --- the static beyond-Kerr family and the exact solvers (48-52) ----------
# phase 48's frames: cli.main at its defaults (200x200, 200k steps, delta
# 0.01, float32) with a procedural sky, the three families at one
# sub-critical parameter each and horizonless Bardeen
STATIC_FRAMES = (("bardeen", 0.5), ("hayward", 0.5), ("kottler", 1e-4),
                 ("bardeen", 0.9))
STATIC_SIZE = 200
# each frame's float32 numerical-error pixels on an H100 80GB HBM3
# (700.00 W), as PR 15's final run of this script printed them: horizonless
# Bardeen's rays through the core meet its 1/r^2 and 1/r^3 terms (ROADMAP
# Queue C); phase 48 fails on a rise
STATIC_NUMERICAL = {("bardeen", 0.5): 0, ("hayward", 0.5): 0,
                    ("kottler", 1e-4): 0, ("bardeen", 0.9): 12}
STATIC_ARGV = ["--background", "procedural:starfield", "--no-plots",
               "--print-metrics"]
STATIC_OUT = os.path.join(HERE, "build", "static_cli_out")
# the share of each frame's rays held bitwise at the full budget (the
# twin's time is set by the frame's longest ray, whatever the share)
STATIC_HELD = 16
# phase 50: the disk frame of the Kerr disk line (512x512, 30k steps, delta
# 0.02, the default DiskConfig: camera 12 deg above the tilted disk,
# [ISCO, 14]) around Bardeen g = 0.5
STATIC_DISK = ("bardeen", 0.5)
# phase 51: cli.exact at its default 256x256; the CPU holds every 64th ray
# of the card's float64 crossing table (the CPU at the full frame would
# take minutes)
EXACT_SIZE, EXACT_HELD = 256, 64
# the card's crossing table against the CPU's, |card - cpu| / (1 + |cpu|):
# the card's sin, cos, atan2 and log differ from the CPU's by ulps, which
# the 50- and 60-step bisections and their Newton polish carry to ~1e-8 of
# the coordinate time (measured 1.7e-8 absolute on t ~ 10^2)
EXACT_TOL = 1e-8
EXACT_OUT = os.path.join(HERE, "build", "exact_cli_out")


def static_frame(metric, param):
    """One phase-48 frame: cli.main --metric metric --metric-param param
    in-process (G1s and S2s once each, no twin on CUDA rays); its warm
    render wall; G1s with its wrapper on the whole frame (CUDA events,
    median of 3) beside its bound; G1s bitwise against its twin on every
    STATIC_HELD-th ray at the full budget; the float32 fold's drift off
    theta = pi/2."""
    import grtrace_torch
    from grtrace_torch.cli.args import parse_args, scene_from_args
    from grtrace_torch.engine.integrate_generic_cuda import \
        integrate_batch_generic_cuda
    from grtrace_torch.engine.render import STATIC_NAMES
    from grtrace_torch.engine.validate import gen_kernel_parity, timed
    from grtrace_torch.io.textures import starfield
    family = STATIC_NAMES[metric]
    argv = ["--metric", metric, "--metric-param", str(param)] + STATIC_ARGV
    counters(STATIC_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda(STATIC_TWINS) as eager:
        res, lines = run_cli(argv + ["--out-dir", STATIC_OUT])
    cli_wall = time.perf_counter() - t0
    launches = counters(STATIC_COUNTERS)
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    tag = f"{metric} {param}"
    phase(48, f"cli.main --metric {metric} --metric-param {param} "
              f"{STATIC_SIZE}x{STATIC_SIZE}/{STEPS} steps ({CARD}): counts "
              f"{counts}, launches {launches}, cli wall {cli_wall:.3f} s, "
              f"stages {json.dumps(json_line(lines, 'stages_s'))}, longest "
              f"ray {int(ns.max())}, ray-steps {int(ns.sum())}")
    if launches != {"G1s": 1, "S2s": 1, "T2s": 0, "D1": 0} or eager:
        raise AssertionError(f"{tag}: launches {launches}, eager twins on "
                             f"CUDA rays {eager}")
    if (res.image.shape != (STATIC_SIZE, STATIC_SIZE, 3)
            or not np.isfinite(res.final_q).all() or counts["in_domain"]
            or counts["numerical_error"] > STATIC_NUMERICAL[metric, param]):
        raise AssertionError(f"{tag}: misshapen, non-finite, budget-cut or "
                             f"more numerical-error pixels than "
                             f"{STATIC_NUMERICAL[metric, param]}: {counts}")
    scene = scene_from_args(parse_args(argv))
    tex = starfield()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, seed=0, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"{tag}: a warm render's counts "
                                 f"{r.counts} differ from the CLI's")
    params = (MASS, param, 0.0)
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    full = [timed(lambda: integrate_batch_generic_cuda(
        q0, p0, STEPS, DELTA, params, R_MAX, OMEGA, metric=family),
        q0.device) for _ in range(3)]
    counters(STATIC_COUNTERS, reset=True)  # the timing launches are not the path's
    full_steps = int(full[0][0][3].long().sum())
    fq, fp = full[0][0][0], full[0][0][1]
    drift = {"max_abs_theta_minus_half_pi": float(
                 (fq[:, 2] - math.pi / 2).abs().max()),
             "max_abs_p_theta": float(fp[:, 2].abs().max())}
    g1s = {"ms": float(np.median([ms for _, ms in full])),
           "rays": q0.shape[0], "ray_steps": full_steps,
           "n_steps_max": int(full[0][0][3].max()), "fold_drift": drift}
    g1s["bound_ms"], g1s["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_static", full_steps, q0.shape[0]),
        q0.shape[0] * BYTES_RAY)
    qh = q0[::STATIC_HELD].contiguous()
    ph = p0[::STATIC_HELD].contiguous()
    kern, par = gen_kernel_parity(qh, ph, STEPS, DELTA, params, R_MAX,
                                  OMEGA, metric=family)
    par.update(rays=qh.shape[0], held=f"every {STATIC_HELD}th ray",
               ray_steps=int(kern[3].long().sum()),
               n_steps_max=int(kern[3].max()))
    par["bound_ms"], par["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_static", par["ray_steps"],
                           par["rays"]), par["rays"] * BYTES_RAY)
    counters(STATIC_COUNTERS, reset=True)
    phase(48, f"G1s ({tag}) vs eager twin on every {STATIC_HELD}th ray of "
              f"the frame, {STEPS}-step budget ({CARD}): {json.dumps(par)}")
    gate_parity(f"G1s {tag}", par)
    wall = float(np.median(walls))
    phase(48, f"{tag} render warm wall time (frame and {N_SAMPLES} "
              f"samples): median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}; G1s kernel+wrapper on the "
              f"whole frame {json.dumps(g1s)}")
    return {"res": res, "launches": launches, "wall": wall, "g1s": g1s,
            "held": par, "counts": counts, "cli_wall": cli_wall}


def static_cli_phase():
    """Phase 48: cli.main --metric bardeen | hayward | kottler and
    horizonless Bardeen at the CLI's full width (STATIC_FRAMES)."""
    return {f"{m} {p}": static_frame(m, p) for m, p in STATIC_FRAMES}


def static_traj_phase(frames):
    """Phase 49: S2s on the first frame's 20 sampled rays at the full
    budget, bitwise against its twin (every timed call), beside its
    single-chain floor; T2s on one of that frame's rays through
    trajectory_generic (float64, 2000 steps), bitwise against its twin,
    beside its floor."""
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine.validate import (_bitwise_equal,
                                               gen_traj_parity)
    metric, param = STATIC_FRAMES[0]
    family = metric.capitalize()
    res = frames[f"{metric} {param}"]["res"]
    params = (MASS, param, 0.0)
    idx = torch.as_tensor(res.sampled_indices[:, 0] * STATIC_SIZE
                          + res.sampled_indices[:, 1], device="cuda")
    q0 = res.device("q0").reshape(-1, 4)[idx].contiguous()
    p0 = res.device("p0").reshape(-1, 4)[idx].contiguous()
    _, s2 = gen_traj_parity(q0, p0, STEPS, DELTA, params, R_MAX, OMEGA,
                            metric=family, n_keep=TRAJ_POINTS)
    s2["bound_ms"], s2["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_traj_static", s2["n_steps_sum"],
                           s2["rays"]),
        s2["rays"] * (TRAJ_BYTES_RAY + s2["n_keep"] * 4 * 4))
    s2["chain_floor_ms"] = chain_floor("fantasy_gen_traj_static",
                                       s2["n_steps_max"])
    phase(49, f"S2s ({metric} {param}) vs eager twin on the CLI's "
              f"{s2['rays']} sampled rays ({STEPS}-step budget, "
              f"{TRAJ_POINTS} points, float32; {CARD}): {json.dumps(s2)}")
    if not s2["traj_bitwise_equal"]:
        raise AssertionError(f"S2s differs from its twin (max abs diff "
                             f"{s2['max_abs_err']:.3e})")
    q1, p1 = q0[7].double(), p0[7].double()
    steps = 2000
    counters(STATIC_COUNTERS, reset=True)
    qs, ps = tig.trajectory_generic(q1, p1, steps, DELTA, params, OMEGA,
                                    metric=family)
    launches = counters(STATIC_COUNTERS)["T2s"]
    vec = tig.gen_params(family, DELTA, params, math.inf, OMEGA, 2,
                         torch.float64)
    from grtrace_torch.engine.validate import timed
    ref, twin_ms = timed(lambda: tig.trajectory_generic_unmasked(
        q1.reshape(1, 4), p1.reshape(1, 4), steps, vec, family),
        q1.device)
    rec = torch.cat([qs, ps], -1)[None]
    ms = event_ms(lambda: tgc.trajectory_generic_unmasked_cuda(
        q1.reshape(1, 4).contiguous(), p1.reshape(1, 4).contiguous(),
        steps, vec, family))
    t2 = {"rays": 1, "steps": steps, "launches": launches,
          "finite": bool(torch.isfinite(rec).all()),
          "record_bitwise_equal": _bitwise_equal(rec, ref),
          "max_abs_err": float((rec - ref).abs().max()),
          "kernel_ms": ms, "twin_ms": twin_ms,
          "chain_floor_ms": chain_floor("fantasy_gen_trace_static", steps)}
    t2["bound_ms"], t2["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_trace_static", steps, 1),
        steps * TRACE_BYTES_STEP, PEAK_FLOPS64)
    phase(49, f"T2s ({metric} {param}) through trajectory_generic on one "
              f"of the frame's rays, float64, {steps} steps ({CARD}): "
              f"{json.dumps(t2)}")
    if launches != 1 or not (t2["record_bitwise_equal"] and t2["finite"]):
        raise AssertionError(f"T2s: {json.dumps(t2)}")
    return {"s2": s2, "t2": t2}


def static_disk_phase():
    """Phase 50: render_disk_static at 512x512, 30k steps (D1 once, no
    twin on CUDA rays, disk pixels, numerical_error 0), its warm wall; D1
    bitwise against its twin on every ray of the frame, its time beside
    its bound."""
    import grtrace_torch
    from grtrace_torch import DiskConfig
    from grtrace_torch.engine import disk_static as tds
    from grtrace_torch.engine.integrate_ks import STATUS_DISK
    from grtrace_torch.engine.validate import disk_static_parity
    from grtrace_torch.physics.camera import camera_rays_folded_static
    from grtrace_torch.physics.spacetime import METRICS
    from grtrace_torch.io.textures import starfield
    metric, param = STATIC_DISK
    family = metric.capitalize()
    scene = grtrace_torch.SceneConfig(
        size=DISK_SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        metric=metric, metric_param=param, boundary_radius=R_MAX,
        observer_distance=OBS_X, n_samples=0,
        integrator=grtrace_torch.IntegratorConfig(
            steps=DISK_STEPS, delta=DISK_DELTA, omega=OMEGA, order=2,
            dtype="float32"))
    disk = DiskConfig()
    tex = starfield()
    counters(STATIC_COUNTERS, reset=True)
    with eager_on_cuda(STATIC_TWINS) as eager:
        res = tds.render_disk_static(scene, disk, bg_array=tex,
                                     device="cuda")
    launches = counters(STATIC_COUNTERS)
    counts = res.counts
    phase(50, f"render_disk_static {metric} {param} {DISK_SIZE}x"
              f"{DISK_SIZE}/{DISK_STEPS} steps, delta {DISK_DELTA} "
              f"({CARD}): counts {counts}, launches {launches}")
    if (launches["D1"] != 1 or eager or not counts["disk"]
            or counts["numerical_error"]):
        raise AssertionError(f"static disk: launches {launches}, eager "
                             f"{eager}, counts {counts}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = tds.render_disk_static(scene, disk, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError("a warm static disk render's counts differ")
    r_in, r_out = tds.static_disk_bounds(family, MASS, param, disk.r_in,
                                         disk.r_out, R_MAX)
    dt = torch.float32
    params = torch.tensor([MASS, param, 0.0], dtype=dt, device="cuda")
    q0, p0, _, beta = camera_rays_folded_static(
        torch.tensor([OBS_X, 0.0, 0.0], dtype=dt, device="cuda"),
        torch.tensor(math.radians(FOV_DEG), dtype=dt, device="cuda"),
        DISK_SIZE, DISK_SIZE, params=params, g_inv_fn=METRICS[family],
        dtype=dt, device="cuda")
    if not torch.equal(q0, res.device("q0")) or \
            not torch.equal(p0, res.device("p0")):
        raise AssertionError("the disk phase's camera is not the render's")
    elev = torch.tensor(math.radians(disk.elevation_deg), dtype=dt,
                        device="cuda")
    c1 = torch.sin(elev).expand(beta.shape).reshape(-1).contiguous()
    c2 = (torch.sin(beta) * torch.cos(elev)).reshape(-1).contiguous()
    q0f = q0.reshape(-1, 4).contiguous()
    p0f = p0.reshape(-1, 4).contiguous()
    kern, par = disk_static_parity(q0f, p0f, c1, c2, DISK_STEPS, DISK_DELTA,
                                   (MASS, param, 0.0), R_MAX, OMEGA, r_in,
                                   r_out, family)
    counters(STATIC_COUNTERS, reset=True)
    n = q0f.shape[0]
    par.update(rays=n, held="every ray", ray_steps=int(kern[3].long().sum()),
               n_steps_max=int(kern[3].max()),
               hits=int((kern[2] == STATUS_DISK).sum()))
    par["bound_ms"], par["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_disk_static", par["ray_steps"], n),
        n * DISK_BYTES_RAY)
    phase(50, f"D1 vs eager twin on every ray of the static disk frame "
              f"({CARD}): {json.dumps(par)}")
    gate_parity("D1 disk frame", par)
    wall = float(np.median(walls))
    phase(50, f"static disk render warm wall time: median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}; D1 kernel+wrapper "
              f"{par['kernel_ms']:.3f} ms, bound {par['bound_ms']:.3f} ms "
              f"({par['bound_by']})")
    return {"launches": launches, "wall": wall, "d1": par}


def exact_cli_phase():
    """Phase 51: cli.exact at 256x256 on the card (the closed-form disk:
    every EXACT_HELD-th ray's float64 crossing table against the same
    solver on the CPU, within 1e-9), then --compare through B6 (its mask
    mismatch and delta g, as the JAX driver prints them) and --background
    --compare through B5 in float64."""
    from grtrace_torch.cli import exact as texact
    from grtrace_torch.engine import integrate_ks_cuda as ks
    from grtrace_torch.engine.disk import disk_observer_position
    from grtrace_torch.physics.camera import (cartesian_ics_from_pixels,
                                              pixel_grid_lookat)
    from grtrace_torch.physics.geodesic_exact import crossing_table
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    from grtrace_torch import DiskConfig, SceneConfig
    out = {}
    ks.disk_launches = ks.launches = 0
    t0 = time.perf_counter()
    disk_json, _ = run_quiet(texact.main, ["--spin", "0.9", "--size",
                                           str(EXACT_SIZE), "--compare",
                                           "--out-dir", EXACT_OUT])
    out["disk"] = dict(disk_json, wall_s=time.perf_counter() - t0,
                       b6_launches=ks.disk_launches)
    # the card's float64 crossing table against the CPU's on a share
    scene = SceneConfig(size=EXACT_SIZE, metric="kerr", spin=0.9)
    obs = torch.tensor(disk_observer_position(scene, DiskConfig(
        elevation_deg=25.0)), dtype=torch.float64)
    params = (MASS, 0.9, 0.0)
    pix = pixel_grid_lookat(obs, torch.tensor(math.radians(FOV_DEG),
                                              dtype=torch.float64),
                            EXACT_SIZE, EXACT_SIZE, dtype=torch.float64)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix.reshape(-1, 3),
                                          params=params,
                                          g_inv_fn=kerr_schild_g_inv)
    q0, p0 = q0[::EXACT_HELD].contiguous(), p0[::EXACT_HELD].contiguous()
    t0 = time.perf_counter()
    card = crossing_table(q0.cuda(), p0.cuda(), params)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = crossing_table(q0, p0, params)
    valid_eq = bool(torch.equal(card["valid"].cpu(), cpu["valid"]))
    ok = cpu["valid"]
    errs = {k: float(((card[k].cpu()[ok] - cpu[k][ok]).abs()
                      / (1.0 + cpu[k][ok].abs())).max())
            for k in ("r", "t", "phi", "tau")}
    err = max(errs.values())
    out["cpu_hold"] = {"rays": int(q0.shape[0]),
                       "held": f"every {EXACT_HELD}th ray",
                       "valid_equal": valid_eq, "scaled_err": errs,
                       "max_abs_err": max(float((card[k].cpu()[ok]
                                                 - cpu[k][ok]).abs().max())
                                          for k in errs),
                       "card_s": card_s}
    phase(51, f"cli.exact --spin 0.9 --size {EXACT_SIZE} --compare "
              f"({CARD}): {json.dumps(out['disk'])}; the card's crossing "
              f"table vs the CPU's: {json.dumps(out['cpu_hold'])}")
    if (not valid_eq or not err <= EXACT_TOL
            or out["disk"]["b6_launches"] != 1
            or not out["disk"]["disk_pixels"]):
        raise AssertionError(f"cli.exact on the card: {json.dumps(out)}")
    ks.launches = 0
    t0 = time.perf_counter()
    bg_json, _ = run_quiet(texact.main, ["--spin", "0.9", "--size",
                                         str(EXACT_SIZE), "--background",
                                         "--compare", "--out-dir",
                                         EXACT_OUT])
    out["background"] = dict(bg_json, wall_s=time.perf_counter() - t0,
                             b5_launches=ks.launches)
    phase(51, f"cli.exact --spin 0.9 --size {EXACT_SIZE} --background "
              f"--compare ({CARD}): {json.dumps(out['background'])}")
    if out["background"]["b5_launches"] != 1:
        raise AssertionError("--background --compare did not launch B5")
    return out


def images_cli_phase():
    """Phase 52: cli.images on the card with the JAX driver's example
    (source (95, 166) deg, a = 0.9, windings -1 0 1, 256x256, scan 96):
    every image it reports converged."""
    from grtrace_torch.cli import images as timages
    t0 = time.perf_counter()
    got, _ = run_quiet(timages.main, ["--source-theta", "95",
                                      "--source-phi", "166", "--spin", "0.9",
                                      "--out-dir", EXACT_OUT])
    wall = time.perf_counter() - t0
    phase(52, f"cli.images --source-theta 95 --source-phi 166 --spin 0.9 "
              f"({CARD}): {wall:.3f} s, {json.dumps(got)}")
    if not got["n_found"]:
        raise AssertionError("cli.images found no image on the card")
    return {"wall_s": wall, "n_found": got["n_found"]}



# --- the line-profile fit (8f) and the multi-device drivers (item 10) -----
# phase 53: B6t on the disk camera, each direction at a budget that every
# ray ends inside (phase 10's camera: its longest ray takes 1,472 steps of
# 0.05)
B6T_SIZE, B6T_STEPS, B6T_DELTA = 48, 3000, 0.05
B6T_DIRECTIONS = {"spin": (1.0, 0.0), "elevation": (0.0, 1.0)}
# phase 54: cli.fit_line's demo at its defaults, then on the grid of JAX's
# test of the driver (tests/test_fit_line.py), which contains the truth:
# that test holds the grid's best point at the truth and the fit within
# 0.2 in spin and 10 degrees of it.  The default 6 x 5 grid does not
# contain 40 degrees, and its chi^2 minimum lies off the truth along the
# spin-inclination degeneracy in both packages (ROADMAP Queue C)
FIT_ARGV = ["--synthesize", "0.7", "40", "--gauss-newton", "2", "--fisher",
            "--no-plots"]
FIT_TEST_GRID = ["--spins", "0.3", "0.7", "0.95", "--inclinations", "20",
                 "40", "60"]
FIT_SPIN_TOL, FIT_INCL_TOL = 0.2, 10.0
FIT_OUT = os.path.join(HERE, "build", "fit_line_out")
# phase 55: the orbit's frames a mode (the driver's default is 16)
ORBIT_FRAMES = 4


def tangent_camera(size, dtype):
    """The model's disk camera (engine/sensitivity.disk_camera at the disk
    scene's spin and elevation, float `dtype`) and its forward-mode
    tangents in both directions of theta = [spin, elevation] (the
    B6T_DIRECTIONS, stacked): (q0, p0, dq0 (2, N, 4), dp0, dparams)."""
    import torch.autograd.forward_ad as fwAD
    from grtrace_torch.engine.sensitivity import disk_camera
    theta = torch.tensor([DISK_SPIN, math.radians(12.0)], dtype=dtype,
                         device="cuda")
    dirs = []
    for direction in B6T_DIRECTIONS.values():
        e = torch.tensor(direction, dtype=dtype, device="cuda")
        with fwAD.dual_level():
            q0, p0, params, _ = disk_camera(fwAD.make_dual(theta, e), size,
                                            math.radians(FOV_DEG), MASS)
            (q0, dq0), (p0, dp0), (_, dpar) = (
                fwAD.unpack_dual(t)[:2] for t in (q0, p0, params))
        zero = torch.zeros_like(q0)
        dirs.append((zero if dq0 is None else dq0,
                     zero if dp0 is None else dp0, tuple(dpar.tolist())))
    return (q0.contiguous(), p0.contiguous(),
            torch.stack([d[0] for d in dirs]),
            torch.stack([d[1] for d in dirs]), [d[2] for d in dirs])


def _same(a, b):
    if a.is_floating_point():
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return bool(torch.equal(a.contiguous().view(view),
                                b.contiguous().view(view)))
    return bool(torch.equal(a, b))


def _median_ms(runs):
    return float(np.median([ms for _, ms in runs]))


def hold_tangent_launch(args, kw, twin=True):
    """B6t with both directions (`args`: integrate_batch_disk_tangent_cuda's
    arguments, the tangents (2, N, 4)) against its twin (graphed; skipped
    without `twin`), each direction against a one-direction launch on it
    and its primal outputs against B6's 16-row launch on the same rays,
    all bit for bit; kernel+wrapper times (CUDA events, median of 3) of
    the two-direction launch, of each one-direction launch and of B6
    beside the bounds of both modes.  Returns (the record, the
    two-direction launch's outputs)."""
    from grtrace_torch.engine import integrate_ks as tks
    from grtrace_torch.engine import integrate_ks_cuda as ks
    from grtrace_torch.engine.validate import timed
    q0, p0, dq0, dp0, steps, delta, hole, dparams = args[:8]
    tail = args[8:]
    dev = q0.device
    two = [timed(lambda: ks.integrate_batch_disk_tangent_cuda(*args, **kw),
                 dev) for _ in range(3)]
    out = two[0][0]
    ones = [[timed(lambda: ks.integrate_batch_disk_tangent_cuda(
        q0, p0, dq0[d:d + 1], dp0[d:d + 1], steps, delta, hole,
        dparams[d:d + 1], *tail, **kw), dev) for _ in range(3)]
        for d in range(dq0.shape[0])]
    b6 = [timed(lambda: ks.integrate_batch_disk_cuda(
        q0, p0, steps, delta, hole, *tail, compensated=False, **kw), dev)
        for _ in range(3)]
    f64 = q0.dtype == torch.float64
    res = {"rays": q0.shape[0], "dtype": str(q0.dtype)[6:],
           "ray_steps": int(out[3].long().sum()),
           "n_steps_max": int(out[3].max()),
           "hits": int((out[2] == 3).sum()),
           "max_abs_tangent": float(out[6].abs().max()),
           "b6t2_ms": _median_ms(two),
           "b6t_ms": [_median_ms(r) for r in ones],
           "b6_16row_ms": _median_ms(b6),
           "directions_bitwise_one_direction": all(
               all(_same(a, b) for a, b in zip(out[:6], r[0][0][:6]))
               and _same(out[6][d], r[0][0][6][0])
               and _same(out[7][d], r[0][0][7][0])
               for d, r in enumerate(ones)),
           "primal_vs_b6_16row_bitwise": all(
               _same(a, b) for a, b in zip(out[:6], b6[0][0]))}
    res["parent_cost_ms"] = res["b6_16row_ms"] + sum(res["b6t_ms"])
    if twin:
        ref, res["twin_ms"] = timed(
            lambda: tks.integrate_batch_disk_tangent_ks(*args, **kw), dev)
        res["tangent_rows_bitwise"] = all(_same(a, b)
                                          for a, b in zip(out, ref))
        res["max_abs_err"] = max(float((a.double() - b.double()).abs().max())
                                 for a, b in zip(out[4:], ref[4:]))
    nbytes = res["rays"] * 2 * (BYTES_RAY64 if f64 else BYTES_RAY)
    peak = PEAK_FLOPS64 if f64 else PEAK_FLOPS
    res["bound_ms"], res["bound_by"] = bound(
        metrics.kernel_ops("fantasy_ks_tangent2", res["ray_steps"],
                           res["rays"]), nbytes, peak)
    res["bound_ms_b6t"], _ = bound(
        metrics.kernel_ops("fantasy_ks_tangent", res["ray_steps"],
                           res["rays"]), nbytes, peak)
    counters(DISK_COUNTERS, reset=True)  # the held launches are not a path's
    if not (res.get("tangent_rows_bitwise", True)
            and res["directions_bitwise_one_direction"]
            and res["primal_vs_b6_16row_bitwise"]
            and res["hits"] and res["max_abs_tangent"] > 0):
        raise AssertionError(f"B6t: {res}")
    return res, out


def b6t_phase():
    """Phase 53: kernel B6t (the tangent modes of fantasy_ks.cu) on the
    disk camera at B6T_SIZE^2, float32 and float64, with both directions
    of theta = [spin, elevation] in one launch (`hold_tangent_launch`: its
    twin, the one-direction launches and B6 bit for bit, their times), and
    the one-direction launch on the spin direction against its own twin;
    then the model under forward AD along spin (line_profile_model with a
    dual theta at B6T_SIZE^2, float64: B6 once and B6t with one direction
    once, no twin on CUDA rays), the path of a one-direction jvp."""
    import torch.autograd.forward_ad as fwAD
    from grtrace_torch.engine import integrate_ks as tks
    from grtrace_torch.engine import integrate_ks_cuda as ks
    from grtrace_torch.engine.sensitivity import line_profile_model
    from grtrace_torch.engine.validate import timed
    r_in, r_out = disk_annulus()
    hole = (MASS, DISK_SPIN, 0.0)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        q0, p0, dq0, dp0, dparams = tangent_camera(B6T_SIZE, dtype)
        tail = (R_MAX, OMEGA, r_in, r_out)
        args = (q0, p0, dq0, dp0, B6T_STEPS, B6T_DELTA, hole, dparams) + tail
        res, out = hold_tangent_launch(args, {})
        one = (q0, p0, dq0[:1], dp0[:1], B6T_STEPS, B6T_DELTA, hole,
               dparams[:1]) + tail
        k1, k1_ms = timed(lambda: ks.integrate_batch_disk_tangent_cuda(*one),
                          q0.device)
        twin1, res["twin_b6t_ms"] = timed(
            lambda: tks.integrate_batch_disk_tangent_ks(*one), q0.device)
        res["b6t_vs_twin_bitwise"] = all(_same(a, b)
                                         for a, b in zip(k1, twin1))
        res["max_abs_err_b6t"] = max(
            float((a.double() - b.double()).abs().max())
            for a, b in zip(k1[4:], twin1[4:]))
        res["dparams"] = dparams
        counters(DISK_COUNTERS, reset=True)
        tag = str(dtype)[6:]
        phase(53, f"B6t with both directions vs its twin, vs two launches "
                  f"with one and vs B6 (16 rows) on the disk camera "
                  f"{B6T_SIZE}x{B6T_SIZE}, {B6T_STEPS} steps of {B6T_DELTA}, "
                  f"{tag} ({CARD}): {json.dumps(res)}")
        if not res["b6t_vs_twin_bitwise"]:
            raise AssertionError(f"B6t (one direction) {tag}: {res}")
        runs[tag] = res
    centers = np.linspace(0.35, 1.25, 32)
    theta = torch.tensor([DISK_SPIN, math.radians(12.0)],
                         dtype=torch.float64, device="cuda")
    knobs = dict(size=B6T_SIZE, steps=B6T_STEPS, delta=B6T_DELTA,
                 r_out=r_out, fov=math.radians(FOV_DEG))
    counters(DISK_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda() as eager, fwAD.dual_level():
        dual = line_profile_model(fwAD.make_dual(
            theta, torch.tensor([1.0, 0.0], dtype=torch.float64,
                                device="cuda")), centers, **knobs)
        tangent = fwAD.unpack_dual(dual).tangent
    torch.cuda.synchronize()
    model = {"wall_s": time.perf_counter() - t0,
             "launches": counters(DISK_COUNTERS),
             "max_abs_tangent": float(tangent.abs().max())}
    phase(53, f"line_profile_model under forward AD along spin, "
              f"{B6T_SIZE}x{B6T_SIZE}, float64 ({CARD}): {json.dumps(model)}")
    if (eager or model["launches"] != {"B6": 1, "B6t": 1, "B6t2": 0}
            or not model["max_abs_tangent"] > 0):
        raise AssertionError(f"the model's jvp: {model}, eager {eager}")
    runs["model_jvp"] = model
    return runs


def fit_line_run(argv, tag):
    """One cli.fit_line run in-process: its result, launches and calls,
    checked: B6 once per distinct spin of the grid, once for the
    observation and once per primal pass of the line search; B6t with
    both directions once per linearization and never with one; no twin on
    CUDA rays; the residual norms never rise; a finite Fisher matrix with
    a positive determinant."""
    from grtrace_torch.cli import fit_line
    from grtrace_torch.engine import sensitivity as tsens
    from grtrace_torch.sharding import grid as tgrid
    counters(DISK_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda() as eager, \
            captured_calls(tgrid, "integrate_dispatch_disk") as sweeps, \
            captured_calls(tsens, "integrate_dispatch_disk") as primal, \
            captured_calls(tsens, "integrate_dispatch_disk_tangent") as tan:
        got, _ = run_quiet(fit_line.main, argv + ["--out-dir", FIT_OUT])
    wall = time.perf_counter() - t0
    launches = counters(DISK_COUNTERS)
    spins = fit_line.build_parser().parse_args(argv).spins
    res = {"wall_s": wall, "launches": launches, "sweep_calls": len(sweeps),
           "model_primal_calls": len(primal), "model_tangent_calls": len(tan),
           "tangent_directions": sorted({c[0][2].shape[0] for c in tan}),
           "result": got}
    phase(54, f"cli.fit_line {' '.join(argv)}, {tag} ({CARD}): "
              f"{json.dumps(res)}")
    fisher = np.asarray(got["fisher_matrix"])
    rns = got["gn_residual_norms"]
    linearizations = len(rns) + 1
    if (eager or launches["B6"] != len(sweeps) + len(primal)
            or len(sweeps) != len(set(spins)) + 1
            or launches["B6t2"] != len(tan) or launches["B6t"]
            or len(tan) != linearizations
            or res["tangent_directions"] != [2]
            or len(primal) < linearizations - 1):
        raise AssertionError(f"cli.fit_line {tag}: launches {launches}, "
                             f"calls {len(sweeps)} / {len(primal)} / "
                             f"{len(tan)}, eager twins on CUDA rays {eager}")
    if not (np.isfinite(fisher).all() and np.linalg.det(fisher) > 0
            and all(b <= a for a, b in zip(rns, rns[1:]))):
        raise AssertionError(f"cli.fit_line {tag}: {got}")
    return res, tan


def time_tangent_pass(call, n, tag):
    """B6t on a linearization's own rays and tangents (`call`, a
    `captured_calls` record of integrate_dispatch_disk_tangent with both
    directions), held and timed by `hold_tangent_launch` (the twin
    graphed)."""
    args, kw, _ = call
    res, _ = hold_tangent_launch(args, kw)
    phase(n, f"B6t with both directions, with one, and B6 (16 rows) on "
             f"{tag}'s rays ({CARD}): {json.dumps(res)}")
    return res


def fit_line_phase():
    """Phase 54: cli.fit_line's demo (--synthesize 0.7 40 --gauss-newton 2
    --fisher) at the driver's defaults (128^2, 12k steps, the 6 x 5 grid),
    then at those defaults on the 3 x 3 grid of JAX's test, where the fit
    must recover the truth within that test's tolerance; B6t and B6's
    16-row launch timed on the last run's Fisher pass."""
    out = {}
    out["defaults"], _ = fit_line_run(FIT_ARGV, "at its defaults")
    res, tan = fit_line_run(FIT_ARGV + FIT_TEST_GRID,
                            "on the grid of JAX's test")
    got = res["result"]
    if not (got["spin_grid_best"] == 0.7
            and got["inclination_grid_best"] == 40.0
            and abs(got["spin_fit"] - 0.7) < FIT_SPIN_TOL
            and abs(got["inclination_fit_deg"] - 40.0) < FIT_INCL_TOL
            and 0.0 < got["fisher_spin_err"] < 0.4
            and 0.0 < got["fisher_incl_err_deg"] < 20.0):
        raise AssertionError(f"cli.fit_line on the test's grid: {got}")
    out["test_grid"] = res
    out["fisher_pass"] = time_tangent_pass(tan[-1], 54,
                                           "the last Fisher pass")
    out["launches"] = {k: out["defaults"]["launches"][k]
                       + res["launches"][k] for k in ("B6", "B6t2")}
    return out


def line_grid_orbit_phase():
    """Phase 55: cli.line_grid --fisher 0.01 --bench at its defaults (the
    4 x 4 grid at 256^2, 20k steps: B6 once per spin of the sweep, B6t
    with both directions once per point of the Fisher map) and cli.orbit
    at ORBIT_FRAMES frames in its three modes (B1; --metric kerr, B5;
    --disk, B6: one launch a batch), no twin on CUDA rays."""
    from grtrace_torch.cli import line_grid, orbit
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine import integrate_ks_cuda as ks
    out = {}
    from grtrace_torch.engine import sensitivity as tsens
    counters(DISK_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda() as eager, \
            captured_calls(tsens, "integrate_dispatch_disk_tangent") as tan:
        got, lines = run_quiet(line_grid.main, [
            "--fisher", "0.01", "--bench", "--no-plots", "--out-dir",
            os.path.join(HERE, "build", "line_grid_out")])
    wall = time.perf_counter() - t0
    launches = counters(DISK_COUNTERS)
    defaults = line_grid.build_parser().parse_args([])
    points = len(defaults.spins) * len(defaults.inclinations)
    fish = got["fisher"]
    out["line_grid"] = {"wall_s": wall, "launches": launches,
                        "bench": got["bench"],
                        "sigma_spin": [float(fish[:, 0].min()),
                                       float(fish[:, 0].max())]}
    phase(55, f"cli.line_grid --fisher 0.01 --bench at its defaults "
              f"({CARD}): {json.dumps(out['line_grid'])}")
    # the sweep: once per distinct spin, 4 times (the run and --bench's 3)
    want = {"B6": 4 * len(set(defaults.spins)), "B6t": 0, "B6t2": points}
    if (eager or launches != want or not np.isfinite(fish).all()
            or not (fish[:, :2] > 0).all()):
        raise AssertionError(f"cli.line_grid: launches {launches} (want "
                             f"{want}), eager twins on CUDA rays {eager}, "
                             f"fisher {fish}")
    out["line_grid"]["fisher_pass"] = time_tangent_pass(
        tan[-1], 55, "the Fisher map's last pass")
    modes = {"schwarzschild": [], "kerr": ["--metric", "kerr", "--spin",
                                           "0.9"],
             "disk": ["--disk", "--metric", "kerr", "--spin", "0.9"]}
    for name, mode in modes.items():
        tc.launches = ks.launches = ks.disk_launches = 0
        t0 = time.perf_counter()
        with eager_on_cuda() as eager:
            got, lines = run_quiet(orbit.main, [
                "--frames", str(ORBIT_FRAMES), "--bench", "--out-dir",
                os.path.join(HERE, "build", f"orbit_{name}")] + mode)
        wall = time.perf_counter() - t0
        launches = {"B1": tc.launches, "B5": ks.launches,
                    "B6": ks.disk_launches}
        frames = np.stack([got["images"][k] for k in range(ORBIT_FRAMES)])
        out[f"orbit_{name}"] = {"wall_s": wall, "launches": launches,
                                "bench": got["bench"]}
        phase(55, f"cli.orbit --frames {ORBIT_FRAMES} --bench "
                  f"{' '.join(mode)} at its defaults ({CARD}): "
                  f"{json.dumps(out[f'orbit_{name}'])}")
        kernel = {"schwarzschild": "B1", "kerr": "B5", "disk": "B6"}[name]
        # one launch a batch: the render and --bench's warm-up and timed
        # passes
        if (eager or launches[kernel] != 3 or sum(launches.values()) != 3
                or frames.shape != (ORBIT_FRAMES, 256, 256, 3)
                or not frames.any()):
            raise AssertionError(f"cli.orbit {name}: launches {launches}, "
                                 f"eager twins on CUDA rays {eager}")
    return out


def nccl_phase():
    """Phase 56: the line-profile sweep and the Schwarzschild frames under
    an nccl process group of world size 1 (a file:// store; the
    all_reduce and the all_gather run on the card), bitwise equal to the
    same calls with no process group."""
    import tempfile

    import torch.distributed as dist
    from grtrace_torch.sharding import grid as tgrid
    from grtrace_torch.sharding import mesh as tmesh
    from grtrace_torch.io.textures import starfield

    spins, elevs = np.repeat([0.5, 0.9], 2), np.deg2rad([30.0, 60.0] * 2)
    bg = starfield(128, 128)

    def calls():
        mesh = tmesh.make_mesh(1)
        hist = tgrid.line_profile_grid_sharded(
            mesh, spins, elevs, 30.0, math.radians(80.0), 1.0, 0.0, 31.0,
            20_000, 0.02, 1.0, 14.0, height=128, width=128)
        frames = tmesh.render_frames_sharded(
            mesh, bg, np.full(2, 30.0), math.radians(80.0), 1.0, 31.0,
            50_000, 0.02, 1.0, math.pi / 2, np.array([math.pi, 0.5]),
            math.pi, math.radians(350.0), height=128, width=128)
        return {"hist": hist, **frames}

    alone = calls()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            backend = dist.get_backend()
            grouped = calls()
        finally:
            dist.destroy_process_group()
    res = {"backend": backend, "bitwise": {
        k: _same(grouped[k], alone[k]) for k in alone},
        "hist_sum": float(alone["hist"].sum())}
    phase(56, f"the sharded sweep and frames under an nccl group of one "
              f"({CARD}): {json.dumps(res)}")
    if backend != "nccl" or not all(res["bitwise"].values()):
        raise AssertionError(f"nccl world of one: {res}")
    return res


# --- the rotating regular families: G1r, S2r, T2r, D2 (57-60) -------------
# phase 57's frames: the 1024x1024 rotating-Bardeen frame (a = 0.9, g =
# 0.2, the Kerr frame's width, budget and step, float32), a 256x256
# float64 rotating-Hayward frame (l = 0.2) and the horizonless
# rotating-Bardeen frame (g = 0.5 > critical_parameter(0.9) = 0.2668) at
# 256x256 in float32
ROT_SPIN = 0.9
ROT_FRAME = ("rotating-bardeen", 0.2)
ROT_F64 = ("rotating-hayward", 0.2)
ROT_HORIZONLESS = ("rotating-bardeen", 0.5)
ROT_SMALL = 256
ROT_HELD = 16
# each frame's float32 / float64 numerical-error pixels on an H100 80GB
# HBM3 (700.00 W), as the first run of these phases printed them: none,
# the horizonless frame's included (its rays through the r = 0 disc are
# parked as captures at the 1e-2 M floor; ROADMAP Queue C); phase 57 fails
# on a rise
ROT_NUMERICAL = {ROT_FRAME: 0, ROT_F64: 0, ROT_HORIZONLESS: 0}
# phase 58: the README's rotating-Hayward command at 256x256 (30k steps of
# 0.02, the CLI's 20 samples), and the same with --aa 2
ROT_CLI_ARGV = ["--size", str(ROT_SMALL), "--metric", "rotating-hayward",
                "--spin", str(ROT_SPIN), "--metric-param", "0.3", "--steps",
                "30000", "--delta", "0.02", "--background",
                "procedural:starfield", "--no-plots", "--print-metrics"]
# phase 59: the README's rotating-Bardeen disk command (256x256, 30k steps
# of 0.03), then the disk frame's 512x512 at 0.02
ROT_DISK_ARGV = ["--size", str(ROT_SMALL), "--metric", "rotating-bardeen",
                 "--spin", str(ROT_SPIN), "--metric-param", "0.2", "--disk",
                 "--steps", "30000", "--delta", "0.03", "--background",
                 "procedural:starfield", "--no-plots", "--print-metrics"]
ROT_OUT = os.path.join(HERE, "build", "rot_cli_out")
# the D2 record's extra bytes a ray: hit_q, hit_p and q2 written
ROT_DISK_BYTES_RAY = BYTES_RAY + 12 * 4


def rot_scene(metric, param, size, dtype="float32", steps=KERR_STEPS,
              delta=KERR_DELTA):
    import grtrace_torch
    return grtrace_torch.SceneConfig(
        size=size, fov_deg=FOV_DEG, background="procedural:starfield",
        bh_mass=MASS, metric=metric, spin=ROT_SPIN, metric_param=param,
        boundary_radius=R_MAX, observer_distance=OBS_X, n_samples=0,
        integrator=grtrace_torch.IntegratorConfig(
            steps=steps, delta=delta, omega=OMEGA, order=2, dtype=dtype))


def gen_frame(no, scene, family, params, counts_of, twins, pinned, stride,
              tag, forbid=()):
    """One frame of a fantasy_gen chart through render() (its G1 kernel,
    the first entry of `counts_of`, once and no other kernel, no twin of
    `twins` on CUDA rays, numerical-error pixels at most `pinned`, none of
    the counts in `forbid`); that kernel with its wrapper on the whole
    frame (CUDA events, median of 3) beside its bound; the kernel bitwise
    against its graphed twin on every stride-th ray at the full budget.
    Returns the kernel's numbers under its label in lower case (g1r,
    g1d) and the render's result under "result"."""
    import grtrace_torch
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine.integrate_generic_cuda import (
        chart_of, integrate_batch_generic_cuda)
    from grtrace_torch.engine.validate import gen_kernel_parity, timed
    from grtrace_torch.io.textures import starfield
    label = next(iter(counts_of))
    ops = f"fantasy_gen_{chart_of('gen', family)}"
    dtype = scene.integrator.dtype
    tex = starfield()
    counters(counts_of, reset=True)
    with eager_on_cuda(twins) as eager:
        res = grtrace_torch.render(scene, bg_array=tex, device="cuda")
    launches = counters(counts_of)
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    phase(no, f"render {tag}, {KERR_STEPS} steps of {KERR_DELTA} ({CARD}): "
              f"counts {counts}, launches {launches}, longest ray "
              f"{int(ns.max())}, ray-steps {int(ns.sum())}")
    want = {k: int(k == label) for k in counts_of}
    if (launches != want or eager or any(counts[k] for k in forbid)
            or counts["numerical_error"] > pinned
            or not np.isfinite(res.final_q).all()):
        raise AssertionError(f"{tag}: launches {launches}, eager twins on "
                             f"CUDA rays {eager}, counts {counts} (at most "
                             f"{pinned} numerical-error pixels, no "
                             f"{forbid})")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = grtrace_torch.render(scene, bg_array=tex, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.counts != counts:
            raise AssertionError(f"{tag}: a warm render's counts differ")
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    full = [timed(lambda: integrate_batch_generic_cuda(
        q0, p0, KERR_STEPS, KERR_DELTA, params, R_MAX, OMEGA,
        metric=family), q0.device) for _ in range(3)]
    steps_sum = int(full[0][0][3].long().sum())
    nbytes = BYTES_RAY if dtype == "float32" else BYTES_RAY64
    peak = PEAK_FLOPS if dtype == "float32" else PEAK_FLOPS64
    whole = {"ms": float(np.median([ms for _, ms in full])),
             "rays": q0.shape[0], "ray_steps": steps_sum,
             "n_steps_max": int(full[0][0][3].max())}
    whole["bound_ms"], whole["bound_by"] = bound(
        metrics.kernel_ops(ops, steps_sum, q0.shape[0]),
        q0.shape[0] * nbytes, peak)
    qh, ph = q0[::stride].contiguous(), p0[::stride].contiguous()
    kern, par = gen_kernel_parity(qh, ph, KERR_STEPS, KERR_DELTA, params,
                                  R_MAX, OMEGA, metric=family)
    par.update(rays=qh.shape[0], held=f"every {stride}th ray",
               ray_steps=int(kern[3].long().sum()),
               n_steps_max=int(kern[3].max()),
               parked=int((kern[3] < 0).sum()))
    par["bound_ms"], par["bound_by"] = bound(
        metrics.kernel_ops(ops, par["ray_steps"], par["rays"]),
        par["rays"] * nbytes, peak)
    counters(counts_of, reset=True)
    phase(no, f"{label} ({tag}) vs graphed twin on every {stride}th ray at "
              f"the full budget ({CARD}): {json.dumps(par)}")
    gate_parity(f"{label} {tag}", par)
    wall = float(np.median(walls))
    phase(no, f"{tag} render warm wall time: median {wall:.6f} s of "
              f"{[round(w, 6) for w in walls]}; {label} kernel+wrapper on "
              f"the whole frame {json.dumps(whole)}")
    vec = tig.gen_params(family, KERR_DELTA, params, R_MAX, OMEGA, 2,
                         q0.dtype)
    orders = order_times(no, f"{label} {tag}", res, vec, family, KERR_STEPS)
    return {"launches": launches, "counts": counts, "wall": wall,
            label.lower(): whole, "held": par, "orders": orders,
            "result": res}


def gen_cli_phase(no, argv, out_dir, counts_of, twins, family, params,
                  size, tag, forbid):
    """`cli.main` with `argv` at size x size in-process (the chart's G1
    and S2 kernels, the first two entries of `counts_of`, once each, no
    twin of `twins` on CUDA rays, none of the counts in `forbid`) with
    its stage times, S2 bitwise against its graphed twin on the 20
    samples (every timed call); then the same with --aa 2 (G1 twice, the
    frame and its pass; the pass's launch bitwise against the twin on
    its sub-rays)."""
    from grtrace_torch.engine import aa as taa
    from grtrace_torch.engine.integrate_generic import \
        integrate_dispatch_generic
    from grtrace_torch.engine.integrate_generic_cuda import chart_of
    from grtrace_torch.engine.validate import gen_traj_parity
    g1, s2_label = list(counts_of)[:2]
    out = {}
    for run_tag, extra in (("plain", []), ("aa", ["--aa", str(AA_S)])):
        counters(counts_of, reset=True)
        t0 = time.perf_counter()
        with eager_on_cuda(twins) as eager, \
                captured_calls(taa, "integrate_dispatch_generic") as calls:
            res, lines = run_cli(argv + extra + ["--out-dir", out_dir])
        wall = time.perf_counter() - t0
        launches = counters(counts_of)
        want = {k: 0 for k in counts_of}
        want.update({g1: 2 if extra else 1, s2_label: 1})
        run = {"counts": res.counts, "launches": launches, "cli_wall_s": wall,
               "stages_s": json_line(lines, "stages_s"),
               "aa_pixels": int(res.aa_mask.sum()) if extra else 0}
        phase(no, f"cli.main {' '.join(argv[:12] + extra)} "
                  f"({CARD}): {json.dumps(run)}")
        if launches != want or eager or any(res.counts[k] for k in forbid):
            raise AssertionError(f"{tag} CLI {run_tag}: launches {launches} "
                                 f"(want {want}), eager {eager}, counts "
                                 f"{res.counts}")
        if len(res.sampled_trajectories) != N_SAMPLES:
            raise AssertionError(f"the {tag} CLI sampled no 20 rays")
        if extra:
            run["pass"] = aa_pass_parity(f"{tag} {size}", g1,
                                         integrate_dispatch_generic,
                                         calls[0], no)
        out[run_tag] = run
    idx = torch.as_tensor(res.sampled_indices[:, 0] * size
                          + res.sampled_indices[:, 1], device="cuda")
    q0 = res.device("q0").reshape(-1, 4)[idx].contiguous()
    p0 = res.device("p0").reshape(-1, 4)[idx].contiguous()
    _, s2 = gen_traj_parity(q0, p0, 30_000, 0.02, params, R_MAX, OMEGA,
                            metric=family, n_keep=TRAJ_POINTS)
    counters(counts_of, reset=True)
    ops = f"fantasy_gen_traj_{chart_of('traj', family)}"
    s2["bound_ms"], s2["bound_by"] = bound(
        metrics.kernel_ops(ops, s2["n_steps_sum"], s2["rays"]),
        s2["rays"] * (TRAJ_BYTES_RAY + s2["n_keep"] * 4 * 4))
    s2["chain_floor_ms"] = chain_floor(ops, s2["n_steps_max"])
    phase(no, f"{s2_label} vs graphed twin on the CLI's {s2['rays']} sampled "
              f"rays (30000-step budget, {TRAJ_POINTS} points, float32; "
              f"{CARD}): {json.dumps(s2)}")
    if not s2["traj_bitwise_equal"]:
        raise AssertionError(f"{s2_label} differs from its twin (max abs "
                             f"diff {s2['max_abs_err']:.3e})")
    out["s2"] = s2
    return out


def rot_frame(metric, param, size, dtype, stride):
    """One phase-57 frame of a rotating regular family (`gen_frame`: G1r,
    no in-domain pixel)."""
    from grtrace_torch.engine.render import ROTATING_NAMES
    return gen_frame(57, rot_scene(metric, param, size, dtype),
                     ROTATING_NAMES[metric], (MASS, ROT_SPIN, param),
                     ROT_COUNTERS, ROT_TWINS, ROT_NUMERICAL[metric, param],
                     stride, f"{metric} a={ROT_SPIN} p={param} "
                     f"{size}x{size} {dtype}", forbid=("in_domain",))


def rot_frames_phase(occ):
    """Phase 57: the rotating-Bardeen frame at 1024x1024 (every 16th ray
    held), the float64 rotating-Hayward frame and the horizonless frame
    at 256x256 (every ray held); G1r's, S2r's and D2's registers, spills,
    warps and step loops' SASS and MUFU."""
    out = {"frame": rot_frame(*ROT_FRAME, KERR_SIZE, "float32", ROT_HELD),
           "float64": rot_frame(*ROT_F64, ROT_SMALL, "float64", 1),
           "horizonless": rot_frame(*ROT_HORIZONLESS, ROT_SMALL, "float32",
                                    1)}
    for v in out.values():
        v.pop("result")
    phase(57, f"G1r, S2r, D2: registers, spills, resident warps and SASS "
              f"({CARD}): {json.dumps(gen_resources(occ, 'kKSMass', 3))}")
    return out


def rot_cli_phase():
    """Phase 58: the README's `cli.main --metric rotating-hayward --spin
    0.9 --metric-param 0.3` at 256x256 (`gen_cli_phase`: G1r and S2r, no
    in-domain pixel)."""
    return gen_cli_phase(58, ROT_CLI_ARGV, ROT_OUT, ROT_COUNTERS, ROT_TWINS,
                         "RotatingHayward", (MASS, ROT_SPIN, 0.3), ROT_SMALL,
                         "rotating-hayward", ("in_domain",))


def rot_disk_phase():
    """Phase 59: the README's rotating-Bardeen disk command at 256x256
    in-process (D2 once, nothing else, no twin on CUDA rays, disk pixels,
    numerical_error 0) and D2 bitwise against its graphed twin on every
    ray of that frame; then render_disk at 512x512 (30k steps of 0.02:
    D2 once), D2 bitwise on every ray of it, its time beside its bound."""
    import grtrace_torch
    from grtrace_torch.engine.integrate_ks import STATUS_DISK
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine.validate import disk_rotating_parity
    from grtrace_torch.io.textures import starfield
    from grtrace_torch.physics.rotating_orbits import \
        rotating_disk_inner_edge
    params = (MASS, ROT_SPIN, 0.2)
    r_in = rotating_disk_inner_edge("RotatingBardeen", MASS, ROT_SPIN, 0.2)
    out = {}
    counters(ROT_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda(ROT_TWINS) as eager:
        res, lines = run_cli(ROT_DISK_ARGV + ["--out-dir", ROT_OUT])
    wall = time.perf_counter() - t0
    launches = counters(ROT_COUNTERS)
    phase(59, f"cli.main {' '.join(ROT_DISK_ARGV[:13])} ({CARD}): counts "
              f"{res.counts}, launches {launches}, cli wall {wall:.3f} s, "
              f"stages {json.dumps(json_line(lines, 'stages_s'))}")
    if (launches != {"G1r": 0, "S2r": 0, "T2r": 0, "D2": 1} or eager
            or not res.counts["disk"] or res.counts["numerical_error"]):
        raise AssertionError(f"rotating disk CLI: launches {launches}, "
                             f"eager {eager}, counts {res.counts}")
    frames = {"readme_256": (res, 30_000, 0.03, wall)}
    out["launches"] = {"cli_disk_256": launches["D2"]}
    scene = rot_scene("rotating-bardeen", 0.2, DISK_SIZE,
                      steps=DISK_STEPS, delta=DISK_DELTA)
    counters(ROT_COUNTERS, reset=True)
    with eager_on_cuda(ROT_TWINS) as eager:
        big = grtrace_torch.render_disk(scene, grtrace_torch.DiskConfig(),
                                        bg_array=starfield(), device="cuda")
    launches = counters(ROT_COUNTERS)
    if (launches["D2"] != 1 or eager or not big.counts["disk"]
            or big.counts["numerical_error"]):
        raise AssertionError(f"rotating disk {DISK_SIZE}: launches "
                             f"{launches}, eager {eager}, counts "
                             f"{big.counts}")
    frames["disk_512"] = (big, DISK_STEPS, DISK_DELTA, None)
    out["launches"]["render_disk_512"] = launches["D2"]
    for key, (r, steps, delta, cli_wall) in frames.items():
        q0 = r.device("q0").reshape(-1, 4).contiguous()
        p0 = r.device("p0").reshape(-1, 4).contiguous()
        kern, par = disk_rotating_parity(q0, p0, steps, delta, params, R_MAX,
                                         OMEGA, r_in, 14.0,
                                         "RotatingBardeen")
        n = q0.shape[0]
        par.update(rays=n, held="every ray", counts=r.counts,
                   ray_steps=int(kern[3].long().sum()),
                   n_steps_max=int(kern[3].max()),
                   hits=int((kern[2] == STATUS_DISK).sum()),
                   status_equal_render=bool(torch.equal(
                       kern[2].reshape(r.device("status").shape),
                       r.device("status"))))
        par["bound_ms"], par["bound_by"] = bound(
            metrics.kernel_ops("fantasy_gen_disk_rot", par["ray_steps"], n),
            n * ROT_DISK_BYTES_RAY)
        counters(ROT_COUNTERS, reset=True)
        phase(59, f"D2 vs graphed twin on every ray of the {key} frame "
                  f"({CARD}): {json.dumps(par)}")
        gate_parity(f"D2 {key}", par)
        if not par["status_equal_render"]:
            raise AssertionError(f"D2 {key}: the timed launch's statuses "
                                 f"differ from the render's")
        out[key] = par
        if key == "disk_512":
            vec = tig.disk_spin_params(tig.gen_params(
                "RotatingBardeen", delta, params, R_MAX, OMEGA, 2,
                q0.dtype), r_in, 14.0)
            out["orders"] = order_times(59, f"D2 {key}", r, vec,
                                        "RotatingBardeen", steps, disk=True)
    return out


def rot_shadow_phase():
    """Phase 60: `cli.shadow --metric rotating-bardeen --spin 0.9
    --metric-param 0.26` (the exact curve, no kernel) and with --numeric
    (G1r once a bisection round, each round's launch held bitwise against
    the twin); T2r through trajectory_generic on one float64 ray of 2,000
    steps, bitwise against its twin; the rotating frames of
    render_kerr_sharded (G1r) under an nccl group of one, bitwise equal
    to the calls with no group."""
    import tempfile

    import torch.distributed as dist
    from grtrace_torch.cli import shadow as shadow_cli
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine.validate import _bitwise_equal, timed
    from grtrace_torch.io.textures import starfield
    from grtrace_torch.sharding import mesh as tmesh
    out = {}
    argv = ["--metric", "rotating-bardeen", "--spin", "0.9",
            "--metric-param", "0.26", "--out-dir",
            os.path.join(ROT_OUT, "shadow")]
    counters(ROT_COUNTERS, reset=True)
    m, _ = run_quiet(shadow_cli.main, argv)
    out["analytic"] = {k: m[k] for k in ("mean_diameter_px",
                                         "circularity_deviation",
                                         "centroid_shift_px")}
    out["analytic"]["launches"] = counters(ROT_COUNTERS)
    counters(ROT_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda(ROT_TWINS) as eager, \
            captured_calls(tgc, "integrate_batch_generic_cuda") as calls:
        m, lines = run_quiet(shadow_cli.main, argv + ["--numeric"])
    launches = counters(ROT_COUNTERS)

    def twin(q, p, *args, order):
        return tig.integrate_batch_generic(q, p, *args, order=order,
                                           metric="RotatingBardeen")
    out["numeric"] = {"wall_s": time.perf_counter() - t0,
                      "launches": launches,
                      "numeric_px_err_max": m["numeric_px_err_max"],
                      "numeric_px_err_mean": m["numeric_px_err_mean"],
                      "numeric_bracket_px": m["numeric_bracket_px"],
                      "held": held_rounds(calls, twin)}
    phase(60, f"cli.shadow --metric rotating-bardeen --spin 0.9 "
              f"--metric-param 0.26 [--numeric] ({CARD}): "
              f"{json.dumps(out)}")
    gate_parity("G1r vs twin on cli.shadow's rounds", out["numeric"]["held"])
    if (launches["G1r"] != 3 or eager
            or out["analytic"]["launches"]["G1r"]):
        raise AssertionError(f"cli.shadow (rotating): G1r {launches}, "
                             f"eager {eager}")
    # T2r on one float64 ray of a 16x16 camera, 2000 steps
    from grtrace_torch.physics.camera import camera_rays_cartesian
    from grtrace_torch.physics.spacetime import METRICS
    params = (MASS, ROT_SPIN, 0.2)
    q0, p0, _ = camera_rays_cartesian(
        torch.tensor([OBS_X, 0.0, 0.0], dtype=torch.float64, device="cuda"),
        math.radians(FOV_DEG), 16, 16, params=params,
        g_inv_fn=METRICS["RotatingBardeen"], dtype=torch.float64,
        device="cuda")
    # a corner ray, which escapes: the unmasked trace of a captured one
    # runs through the horizon into non-finite values
    q1, p1 = q0.reshape(-1, 4)[0], p0.reshape(-1, 4)[0]
    steps = 2000
    counters(ROT_COUNTERS, reset=True)
    qs, ps = tig.trajectory_generic(q1, p1, steps, DELTA, params, OMEGA,
                                    metric="RotatingBardeen")
    t_launches = counters(ROT_COUNTERS)["T2r"]
    vec = tig.gen_params("RotatingBardeen", DELTA, params, math.inf, OMEGA,
                         2, torch.float64)
    ref, twin_ms = timed(lambda: tig.trajectory_generic_unmasked(
        q1.reshape(1, 4), p1.reshape(1, 4), steps, vec, "RotatingBardeen"),
        q1.device)
    rec = torch.cat([qs, ps], -1)[None]
    ms = event_ms(lambda: tgc.trajectory_generic_unmasked_cuda(
        q1.reshape(1, 4).contiguous(), p1.reshape(1, 4).contiguous(), steps,
        vec, "RotatingBardeen"))
    counters(ROT_COUNTERS, reset=True)
    t2 = {"rays": 1, "steps": steps, "launches": t_launches,
          "finite": bool(torch.isfinite(rec).all()),
          "record_bitwise_equal": _bitwise_equal(rec, ref),
          "max_abs_err": float((rec - ref).abs().max()),
          "kernel_ms": ms, "twin_ms": twin_ms,
          "chain_floor_ms": chain_floor("fantasy_gen_trace_rot", steps)}
    t2["bound_ms"], t2["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_trace_rot", steps, 1),
        steps * TRACE_BYTES_STEP, PEAK_FLOPS64)
    phase(60, f"T2r through trajectory_generic on one float64 ray, {steps} "
              f"steps ({CARD}): {json.dumps(t2)}")
    if t_launches != 1 or not (t2["record_bitwise_equal"] and t2["finite"]):
        raise AssertionError(f"T2r: {json.dumps(t2)}")
    out["t2"] = t2
    # the sharded rotating frames under an nccl group of one
    bg = starfield(128, 128)

    def frames():
        return tmesh.render_kerr_sharded(
            tmesh.make_mesh(1), bg, np.full(2, OBS_X), math.radians(FOV_DEG),
            MASS, ROT_SPIN, R_MAX, KERR_STEPS, KERR_DELTA, OMEGA,
            math.pi / 2, np.array([math.pi, 0.5]), math.pi,
            math.radians(350.0), height=128, width=128,
            metric="RotatingBardeen", charge=0.2)
    counters(ROT_COUNTERS, reset=True)
    alone = frames()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            backend = dist.get_backend()
            grouped = frames()
        finally:
            dist.destroy_process_group()
    sharded = {"backend": backend, "launches": counters(ROT_COUNTERS),
               "bitwise": {k: _same(grouped[k], alone[k]) for k in alone}}
    phase(60, f"render_kerr_sharded(metric='RotatingBardeen', 128x128, 2 "
              f"frames) under an nccl group of one ({CARD}): "
              f"{json.dumps(sharded)}")
    if (backend != "nccl" or not all(sharded["bitwise"].values())
            or sharded["launches"]["G1r"] != 2):
        raise AssertionError(f"sharded rotating frames: {sharded}")
    out["sharded"] = sharded
    return out


# --- Kerr-de Sitter: G1d, S2d, T2d, D3 and cli.qpo (62-66) ----------------
# phase 62's frames: the README's scene (a = 0.8, Lambda = 1e-3) at the
# Kerr frame's width, budget and step in float32, the same scene at
# 256x256 in float64, and Lambda = 0 at 256x256 beside G1's kerr-bl frame
# of the same spin (the Carter chart reduces to G1's to the bit there)
KDS_SPIN, KDS_LAMBDA = 0.8, 1e-3
KDS_SMALL = 256
KDS_HELD = 16
# each frame's float32 / float64 numerical-error pixels on the card;
# phase 62 fails on a rise
KDS_NUMERICAL = {("float32", KDS_LAMBDA): 0, ("float64", KDS_LAMBDA): 0,
                 ("float32", 0.0): 0}
# phase 63: the README's cli.main --metric kerr-ds at 256x256 (30k steps
# of 0.02, the CLI's 20 samples), and the same with --aa 2
KDS_CLI_ARGV = ["--size", str(KDS_SMALL), "--metric", "kerr-ds", "--spin",
                str(KDS_SPIN), "--metric-param", str(KDS_LAMBDA), "--steps",
                "30000", "--delta", "0.02", "--background",
                "procedural:starfield", "--no-plots", "--print-metrics"]
# phase 64: the Kerr-de Sitter disk at 512x512 (Lambda = 1e-4, 30k steps
# of 0.03)
KDS_DISK_LAMBDA = 1e-4
KDS_DISK_ARGV = ["--size", str(DISK_SIZE), "--metric", "kerr-ds", "--spin",
                 str(KDS_SPIN), "--metric-param", str(KDS_DISK_LAMBDA),
                 "--disk", "--steps", "30000", "--delta", "0.03",
                 "--background", "procedural:starfield", "--no-plots",
                 "--print-metrics"]
KDS_OUT = os.path.join(HERE, "build", "kds_cli_out")
# the D3 record's extra bytes a ray: hit_q, hit_p and q2 written
KDS_DISK_BYTES_RAY = BYTES_RAY + 12 * 4
KDS_TWINS = ("integrate_generic:integrate_generic_twin",
             "integrate_generic:trajectory_generic_twin",
             "integrate_generic:trajectory_generic_unmasked",
             "integrate_generic:integrate_disk_spin_twin")
KDS_COUNTERS = {"G1d": "integrate_generic_cuda:kds_launches",
                "S2d": "integrate_generic_cuda:kds_traj_launches",
                "T2d": "integrate_generic_cuda:kds_trace_launches",
                "D3": "integrate_generic_cuda:kds_disk_launches"}
# phase 66: cli.qpo for every family, on the card and on the host
QPO_RUNS = {
    "kerr": ["--spin", "0.9", "--preset", "grs1915"],
    "hayward": ["--metric", "hayward", "--metric-param", "0.5", "--preset",
                "grs1915"],
    "rotating-bardeen": ["--metric", "rotating-bardeen", "--spin", "0.9",
                         "--metric-param", "0.2", "--preset", "grs1915"],
    "kerr-ds": ["--metric", "kerr-ds", "--spin", "0.8", "--metric-param",
                "1e-4", "--mass-msun", "10"]}
QPO_REL = 1e-10


def kds_scene(lam, size, dtype="float32", steps=KERR_STEPS, delta=KERR_DELTA,
              metric="kerr-ds"):
    import grtrace_torch
    return grtrace_torch.SceneConfig(
        size=size, fov_deg=FOV_DEG, background="procedural:starfield",
        bh_mass=MASS, metric=metric, spin=KDS_SPIN, metric_param=lam,
        boundary_radius=R_MAX, observer_distance=OBS_X, n_samples=0,
        integrator=grtrace_torch.IntegratorConfig(
            steps=steps, delta=delta, omega=OMEGA, order=2, dtype=dtype))


def kds_frame(lam, size, dtype, stride):
    """One phase-62 frame of the README's Kerr-de Sitter scene
    (`gen_frame`: G1d)."""
    return gen_frame(62, kds_scene(lam, size, dtype), "KerrDS",
                     (MASS, KDS_SPIN, lam), KDS_COUNTERS, KDS_TWINS,
                     KDS_NUMERICAL[dtype, lam], stride,
                     f"kerr-ds a={KDS_SPIN} Lambda={lam} {size}x{size} "
                     f"{dtype}")


def kds_zero_lambda(frame0):
    """Phase 62's Lambda = 0 frame against G1.  The gate: G1d and G1 on
    that frame's rays (the same vector: at Lambda = 0 the two charts'
    gen_params agree in float32) give the same q1, p1, q2 and signed step
    counts bit for bit, the Carter chart reducing to G1's; both launches
    timed (CUDA events, the rays in the frame's order).  Reported
    beside it: kerr-bl's own frame at the same spin (G1), whose camera
    solves p_t with kerr_g_inv's association where the Kerr-de Sitter
    frame's uses kerr_de_sitter_g_inv's, so that a few rays start an ulp
    apart and the near-critical ones among them can end elsewhere."""
    import grtrace_torch
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine.validate import _bitwise_equal, timed
    from grtrace_torch.io.textures import starfield
    res = frame0["result"]
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    params = (MASS, KDS_SPIN, 0.0)
    vec_d, vec_b = (tig.gen_params(m, KERR_DELTA, params, R_MAX, OMEGA, 2,
                                   q0.dtype) for m in ("KerrDS", "Kerr"))
    (out_d, ns_d), ms_d = timed(lambda: tgc.launch_fantasy_gen(
        q0, p0, vec_d, KERR_STEPS, "KerrDS"), q0.device)
    (out_b, ns_b), ms_b = timed(lambda: tgc.launch_fantasy_gen(
        q0, p0, vec_b, KERR_STEPS, "Kerr"), q0.device)
    bl = grtrace_torch.render(kds_scene(0.0, KDS_SMALL, metric="kerr-bl"),
                              bg_array=starfield(), device="cuda")
    out = {"vectors_equal": bool(torch.equal(vec_d, vec_b)),
           "g1d_vs_g1_state_bitwise_equal": _bitwise_equal(out_d, out_b),
           "g1d_vs_g1_steps_equal": bool(torch.equal(ns_d, ns_b)),
           "rays": q0.shape[0], "g1d_launch_ms": ms_d, "g1_launch_ms": ms_b,
           "kerr_bl_frame": {
               "counts": bl.counts, "kerr_ds_counts": res.counts,
               "status_differs": int((res.device("status")
                                      != bl.device("status")).sum()),
               "p0_differs": int((res.device("p0")
                                  != bl.device("p0")).any(-1).sum())}}
    phase(62, f"kerr-ds Lambda = 0: G1d vs G1 on the frame's rays, and the "
              f"kerr-bl frame (G1), a = {KDS_SPIN}, {KDS_SMALL}x{KDS_SMALL} "
              f"float32 ({CARD}): {json.dumps(out)}")
    if not (out["vectors_equal"] and out["g1d_vs_g1_state_bitwise_equal"]
            and out["g1d_vs_g1_steps_equal"]):
        raise AssertionError(f"G1d at Lambda = 0 differs from G1: {out}")
    return out


def gen_resources(occ, chart, chart_no):
    """Registers, spills, resident warps and the step loop's SASS and MUFU
    counts of one chart's G1, S2 and disk kernels (float32 and float64),
    from the build's ptxas log, phase 2b's occupancy and cuobjdump;
    `chart_no` is the Chart enum's value that ptxas prints."""
    from grtrace_torch.kernels import build
    lib = build.library_path(build.CSRC_DIR / "fantasy_gen.cu")
    ptx = {k["kernel"]: k for k in build.ptxas_summary(
        lib.with_suffix(".log").read_text())}
    sass = sass_counts(lib) if _cuobjdump() else {}
    out = {}
    # ptxas and cuobjdump name an instantiation by its enum values:
    # Mode::kIntegrate is 0, kRecord 1, kDisk 3
    for mode, m in (("kIntegrate", 0), ("kRecord", 1), ("kDisk", 3)):
        for t in ("float", "double"):
            name = f"fantasy_gen_kernel<{t}, Chart::{chart}, Mode::{mode}>"
            key = f"fantasy_gen_kernel<{t[0]},{chart_no},{m}>"
            rec = {k: occ[name][k] for k in ("registers", "warps_per_sm",
                                             "local_bytes")}
            if key in ptx:
                rec.update(spill_stores=ptx[key]["spill_stores"],
                           spill_loads=ptx[key]["spill_loads"])
            if key in sass:
                rec["loops"] = sass[key]["loops"]
            out[name] = rec
    return out


def dealt(order_idx, threads=128):
    """The launch order that deals the 32-ray warps of `order_idx`, in its
    order, round-robin over the blocks of `threads` rays: block b takes
    warps b, b + B, b + 2 B, ... of the B blocks."""
    n = order_idx.numel()
    blocks = -(-n // threads)
    pos = torch.arange(n, device=order_idx.device)
    warp = pos // 32
    slot = (warp % blocks) * (threads // 32) + warp // blocks
    return order_idx[torch.argsort(slot * 32 + pos % 32)]


def order_times(no, tag, res, vec, family, steps, disk=False):
    """The bare launch of `family`'s G1 (with `disk`, its 20-row disk
    kernel) on the rays of the render `res` in three orders: the wrappers'
    `launch_order` (cost-sorted), frame order, and the sorted warps dealt
    round-robin over the blocks (CUDA events, median of 3 each)."""
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine.validate import timed
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    launch = (tgc.launch_fantasy_gen_disk_spin if disk
              else tgc.launch_fantasy_gen)
    srt = tgc.launch_order(q0, p0, float(vec[0]), family)
    ms = {}
    for name, idx in (("sorted", srt), ("frame", torch.arange(
            q0.shape[0], device=q0.device)), ("dealt", dealt(srt))):
        q, p = q0[idx].contiguous(), p0[idx].contiguous()
        launch(q, p, vec, steps, family)  # warm
        ms[name] = float(np.median([timed(lambda: launch(
            q, p, vec, steps, family), q0.device)[1] for _ in range(3)]))
    rec = {"rays": q0.shape[0], "ms": ms}
    phase(no, f"{tag}: bare launch in three orders ({CARD}): "
              f"{json.dumps(rec)}")
    return rec


def kds_frames_phase(occ):
    """Phase 62: the README's scene at 1024x1024 (every 16th ray held), in
    float64 at 256x256 (every ray held), Lambda = 0 at 256x256 (every ray
    held) with G1 on its rays (`kds_zero_lambda`); G1d's registers,
    spills and warps."""
    out = {"frame": kds_frame(KDS_LAMBDA, KERR_SIZE, "float32", KDS_HELD),
           "float64": kds_frame(KDS_LAMBDA, KDS_SMALL, "float64", 1),
           "zero": kds_frame(0.0, KDS_SMALL, "float32", 1)}
    out["zero_vs_bl"] = kds_zero_lambda(out["zero"])
    out["resources"] = gen_resources(occ, "kKdS", 4)
    phase(62, f"G1d, S2d, D3: registers, spills, resident warps and SASS "
              f"({CARD}): {json.dumps(out['resources'])}")
    for v in out.values():
        if isinstance(v, dict):
            v.pop("result", None)
    return out


def kds_cli_phase():
    """Phase 63: the README's `cli.main --metric kerr-ds --spin 0.8
    --metric-param 1e-3` at 256x256 (`gen_cli_phase`: G1d and S2d, no
    numerical-error pixel)."""
    return gen_cli_phase(63, KDS_CLI_ARGV, KDS_OUT, KDS_COUNTERS, KDS_TWINS,
                         "KerrDS", (MASS, KDS_SPIN, KDS_LAMBDA), KDS_SMALL,
                         "kerr-ds", ("numerical_error",))


def kds_disk_phase():
    """Phase 64: `cli.main --metric kerr-ds --spin 0.8 --metric-param 1e-4
    --disk` at 512x512, 30k steps of 0.03, in-process (D3 once, nothing
    else, no twin on CUDA rays, disk pixels, numerical_error 0), its
    counts and the range of g on the disk; D3 bitwise against its graphed
    twin on every ray of that frame, its time beside its bound."""
    from grtrace_torch.engine.disk import DiskConfig
    from grtrace_torch.engine.disk_kds import kds_disk_bounds
    from grtrace_torch.engine.integrate_ks import STATUS_DISK
    from grtrace_torch.engine.validate import disk_kds_parity
    params = (MASS, KDS_SPIN, KDS_DISK_LAMBDA)
    r_in, r_out = kds_disk_bounds(MASS, KDS_SPIN, KDS_DISK_LAMBDA, None,
                                  DiskConfig().r_out, R_MAX)
    counters(KDS_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda(KDS_TWINS) as eager:
        res, lines = run_cli(KDS_DISK_ARGV + ["--out-dir", KDS_OUT])
    wall = time.perf_counter() - t0
    launches = counters(KDS_COUNTERS)
    g = res.device("redshift")[res.device("status") == STATUS_DISK]
    run = {"counts": res.counts, "launches": launches, "cli_wall_s": wall,
           "stages_s": json_line(lines, "stages_s"),
           "g_min": float(g.min()) if g.numel() else None,
           "g_max": float(g.max()) if g.numel() else None,
           "r_in": r_in, "r_out": r_out}
    phase(64, f"cli.main {' '.join(KDS_DISK_ARGV[:13])} ({CARD}): "
              f"{json.dumps(run)}")
    if (launches != {"G1d": 0, "S2d": 0, "T2d": 0, "D3": 1} or eager
            or not res.counts["disk"] or res.counts["numerical_error"]
            or not bool(torch.isfinite(g).all())):
        raise AssertionError(f"kerr-ds disk CLI: launches {launches}, "
                             f"eager {eager}, counts {res.counts}")
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    kern, par = disk_kds_parity(q0, p0, 30_000, 0.03, params, R_MAX, OMEGA,
                                r_in, r_out)
    n = q0.shape[0]
    par.update(rays=n, held="every ray",
               ray_steps=int(kern[3].long().sum()),
               n_steps_max=int(kern[3].max()),
               hits=int((kern[2] == STATUS_DISK).sum()),
               status_equal_render=bool(torch.equal(
                   kern[2].reshape(res.device("status").shape),
                   res.device("status"))))
    par["bound_ms"], par["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_disk_kds", par["ray_steps"], n),
        n * KDS_DISK_BYTES_RAY)
    counters(KDS_COUNTERS, reset=True)
    phase(64, f"D3 vs graphed twin on every ray of the {DISK_SIZE}x"
              f"{DISK_SIZE} frame ({CARD}): {json.dumps(par)}")
    gate_parity("D3", par)
    if not par["status_equal_render"]:
        raise AssertionError("D3: the timed launch's statuses differ from "
                             "the render's")
    run["d3"] = par
    return run


def kds_shadow_phase():
    """Phase 65: `cli.shadow --metric kerr-ds --spin 0.8 --metric-param
    1e-3` (the exact curve, no kernel) and with --numeric (G1d once a
    bisection round, each round's launch held bitwise against the twin),
    the numeric boundary's gap to the exact curve in pixels; T2d through
    trajectory_generic on one float64 ray of 2,000 steps, bitwise against
    its twin."""
    from grtrace_torch.cli import shadow as shadow_cli
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.engine.validate import _bitwise_equal, timed
    from grtrace_torch.physics.camera import camera_rays_unfolded
    from grtrace_torch.physics.spacetime import METRICS
    out = {}
    argv = ["--metric", "kerr-ds", "--spin", str(KDS_SPIN), "--metric-param",
            str(KDS_LAMBDA), "--out-dir", os.path.join(KDS_OUT, "shadow")]
    counters(KDS_COUNTERS, reset=True)
    m, _ = run_quiet(shadow_cli.main, argv)
    out["analytic"] = {k: m[k] for k in ("mean_diameter_px",
                                         "circularity_deviation",
                                         "centroid_shift_px")}
    out["analytic"]["launches"] = counters(KDS_COUNTERS)
    counters(KDS_COUNTERS, reset=True)
    t0 = time.perf_counter()
    with eager_on_cuda(KDS_TWINS) as eager, \
            captured_calls(tgc, "integrate_batch_generic_cuda") as calls:
        m, _ = run_quiet(shadow_cli.main, argv + ["--numeric"])
    launches = counters(KDS_COUNTERS)

    def twin(q, p, *args, order):
        return tig.integrate_batch_generic(q, p, *args, order=order,
                                           metric="KerrDS")
    out["numeric"] = {"wall_s": time.perf_counter() - t0,
                      "launches": launches,
                      "numeric_px_err_max": m["numeric_px_err_max"],
                      "numeric_px_err_mean": m["numeric_px_err_mean"],
                      "numeric_bracket_px": m["numeric_bracket_px"],
                      "held": held_rounds(calls, twin)}
    phase(65, f"cli.shadow --metric kerr-ds --spin {KDS_SPIN} "
              f"--metric-param {KDS_LAMBDA} [--numeric] ({CARD}): "
              f"{json.dumps(out)}")
    gate_parity("G1d vs twin on cli.shadow's rounds", out["numeric"]["held"])
    if (launches["G1d"] != 3 or eager
            or out["analytic"]["launches"]["G1d"]):
        raise AssertionError(f"cli.shadow (kerr-ds): G1d {launches}, "
                             f"eager {eager}")
    # T2d on one float64 ray of a 16x16 camera, 2000 steps: a corner ray,
    # which escapes (the unmasked trace of a captured one runs through the
    # horizon into non-finite values)
    params = (MASS, KDS_SPIN, KDS_LAMBDA)
    q0, p0, _ = camera_rays_unfolded(
        torch.tensor([OBS_X, 0.0, 0.0], dtype=torch.float64, device="cuda"),
        math.radians(FOV_DEG), 16, 16, params=params,
        g_inv_fn=METRICS["KerrDS"], dtype=torch.float64, device="cuda")
    q1, p1 = q0.reshape(-1, 4)[0], p0.reshape(-1, 4)[0]
    steps = 2000
    counters(KDS_COUNTERS, reset=True)
    qs, ps = tig.trajectory_generic(q1, p1, steps, DELTA, params, OMEGA,
                                    metric="KerrDS")
    t_launches = counters(KDS_COUNTERS)["T2d"]
    vec = tig.gen_params("KerrDS", DELTA, params, math.inf, OMEGA, 2,
                         torch.float64)
    ref, twin_ms = timed(lambda: tig.trajectory_generic_unmasked(
        q1.reshape(1, 4), p1.reshape(1, 4), steps, vec, "KerrDS"),
        q1.device)
    rec = torch.cat([qs, ps], -1)[None]
    ms = event_ms(lambda: tgc.trajectory_generic_unmasked_cuda(
        q1.reshape(1, 4).contiguous(), p1.reshape(1, 4).contiguous(), steps,
        vec, "KerrDS"))
    counters(KDS_COUNTERS, reset=True)
    t2 = {"rays": 1, "steps": steps, "launches": t_launches,
          "finite": bool(torch.isfinite(rec).all()),
          "record_bitwise_equal": _bitwise_equal(rec, ref),
          "max_abs_err": float((rec - ref).abs().max()),
          "kernel_ms": ms, "twin_ms": twin_ms,
          "chain_floor_ms": chain_floor("fantasy_gen_trace_kds", steps)}
    t2["bound_ms"], t2["bound_by"] = bound(
        metrics.kernel_ops("fantasy_gen_trace_kds", steps, 1),
        steps * TRACE_BYTES_STEP, PEAK_FLOPS64)
    phase(65, f"T2d through trajectory_generic on one float64 ray, {steps} "
              f"steps ({CARD}): {json.dumps(t2)}")
    if t_launches != 1 or not (t2["record_bitwise_equal"] and t2["finite"]):
        raise AssertionError(f"T2d: {json.dumps(t2)}")
    out["t2"] = t2
    return out


def qpo_close(card, host):
    """The largest relative difference of two cli.qpo CSV tables (rows of
    r / M and the five frequencies), and whether it is within QPO_REL.
    nu_r is the square root of kappa^2, which vanishes at the ISCO (and at
    Kerr-de Sitter's OSCO), where a last-bit difference in kappa^2 is a
    difference of order one in nu_r: nu_r is held through nu_r^2, within
    QPO_REL of its largest value, and nu_periastron through (nu_phi -
    nu_periastron)^2 = nu_r^2 the same way."""
    a, b = np.asarray(card, np.float64), np.asarray(host, np.float64)
    nan_same = bool(np.array_equal(np.isnan(a), np.isnan(b)))
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
    for col, ar, br in ((2, a[:, 2], b[:, 2]),
                        (4, a[:, 1] - a[:, 4], b[:, 1] - b[:, 4])):
        rel[:, col] = (np.abs(ar ** 2 - br ** 2)
                       / max(float((br ** 2).max()), 1e-300))
    worst = float(rel.max())
    return worst, nan_same and worst <= QPO_REL


def _rel(a, b):
    """|a - b| / |b| of two JSON numbers; 0 where both are None or NaN."""
    if a is None or b is None:
        return 0.0 if a is b else math.inf
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def qpo_phase():
    """Phase 66: cli.qpo on the card for the four families (Kerr, a static
    family, a rotating regular family, Kerr-de Sitter), each CSV and its
    JSON line held within QPO_REL relative of the same run with --device
    cpu (`qpo_close`); no kernel runs."""
    from grtrace_torch.cli import qpo as qpo_cli
    out = {}
    for name, argv in QPO_RUNS.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            d = os.path.join(KDS_OUT, "qpo", f"{name}_{dev}")
            t0 = time.perf_counter()
            m, _ = run_quiet(qpo_cli.main, argv + ["--device", dev,
                                                   "--no-plots",
                                                   "--out-dir", d])
            runs[dev] = (m, time.perf_counter() - t0,
                         np.loadtxt(m["csv"], delimiter=",", skiprows=1))
        worst, ok = qpo_close(runs["cuda"][2], runs["cpu"][2])
        keys = ("r_isco_over_M", "nu_phi_isco", "nu_r_max",
                "r_nu_r_max_over_M", "r_32_resonance_over_M", "nu_32_upper")
        json_rel = max(_rel(runs["cuda"][0][k], runs["cpu"][0][k])
                       for k in keys)
        out[name] = {"rows": int(runs["cuda"][2].shape[0]),
                     "csv_max_rel": worst, "json_max_rel": json_rel,
                     "wall_s": {dev: r[1] for dev, r in runs.items()},
                     "r_isco_over_M": runs["cuda"][0]["r_isco_over_M"],
                     "nu_r_max": runs["cuda"][0]["nu_r_max"],
                     "unit": runs["cuda"][0]["unit"]}
        phase(66, f"cli.qpo {' '.join(argv)} on the card vs --device cpu "
                  f"({CARD}): {json.dumps(out[name])}")
        if not ok or not json_rel <= QPO_REL:
            raise AssertionError(f"cli.qpo {name}: the card's run differs "
                                 f"from the host's: {out[name]}")
    return out


# phase 67: the benchmark driver cli.bench_cli in-process on the card: JAX's
# defaults (the headline frame), float64, Kerr, and the README's two
# measured lines; each run's kernel and its renders (the warm-up and
# --iters)
BENCH_RUNS = {
    "defaults": ([], "B1", 4),
    "float64": (["--dtype", "float64"], "B2", 4),
    "kerr": (["--metric", "kerr", "--spin", "0.9"], "B5", 4),
    "disk_readme": (["--size", "256", "--steps", "20000", "--delta", "0.02",
                     "--metric", "kerr", "--spin", "0.9", "--disk"], "B6",
                    4),
    "4k_readme": (["--size", "3840", "--iters", "2"], "B1", 3)}
BENCH_COUNTERS = {"B1": "integrate_cuda:launches",
                  "B2": "integrate_cuda:eq_launches",
                  "B5": "integrate_ks_cuda:launches",
                  "B6": "integrate_ks_cuda:disk_launches"}
# the keys of grtrace.cli.bench_cli's line, in its order
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "steps_budget",
              "metric_family", "spin", "backend", "dtype", "warmup_s",
              "rays_per_s", "geodesic_steps_per_s", "counts"]
# the JAX package's TPU records of the README's two lines (an older commit):
# printed beside the card's counts, not gated; a Schwarzschild line whose
# counts differ from its record by more than TPU_DIFF_MAX of the rays gets
# phase 5's nearest-critical analysis
TPU_DIFF_MAX = 1e-5
# the 3840x3840 frame: B1's launch on every ray held against its twin on
# every B1_HELD_STRIDE-th ray and the last B1_HELD_TAIL, the highest
# k * n + i offsets into its (24, N) carry
B1_HELD_STRIDE, B1_HELD_TAIL = 4096, 256
TPU_BENCH = {"disk_readme": ("DISK_r03.json", {"captured": 618,
                                               "escaped": 59326,
                                               "disk": 5592}),
             "4k_readme": ("BENCH4K_r03.json", {"captured": 525516,
                                                "escaped": 14220084})}


def bench_cli_phase(counts32):
    """Phase 67: `grtrace_torch.cli.bench_cli.main` in-process on the card
    for each of BENCH_RUNS, the kernel counts set to 0 just before each run
    and read just after (its kernel once a render, the others 0; no eager
    twin on CUDA rays), the line JAX's keys, its counts whole (no
    numerical error, none left in the domain, every escape on the sky,
    size^2 in all).  The defaults' counts must be phase 5's (`counts32`)
    and their `value` at least B1's kernel+wrapper time on the headline
    rays (CUDA events, timed here first): a window that closed before the
    card finished would read less.  The README's two lines are printed
    beside the TPU's records (a Schwarzschild line more than TPU_DIFF_MAX
    of the rays off with its nearest-critical rays), each with the card's
    peak memory; on the 3840x3840 frame, B1's kernel+wrapper time on its
    rays beside the bound, and that launch (`b1_on_frame`) held against
    the render and against the twin."""
    import grtrace_torch
    from grtrace_torch.cli import bench_cli
    from grtrace_torch.engine import integrate_cuda as tc
    q0, p0 = camera(SIZE, "cuda")
    b1_ms = event_ms(lambda: tc.integrate_batch_cuda(
        q0, p0, STEPS, DELTA, 2.0 * MASS, R_MAX, OMEGA), reps=3)
    del q0, p0
    phase(67, f"B1 kernel+wrapper on the {SIZE}x{SIZE} headline rays, "
              f"{STEPS} steps: {b1_ms:.3f} ms (CUDA events, median of 3)")
    out = {}
    for name, (argv, kernel, renders) in BENCH_RUNS.items():
        entry = "render_disk" if "--disk" in argv else "render"
        counters(BENCH_COUNTERS, reset=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eager_on_cuda() as eager, \
                captured_calls(grtrace_torch, entry, keep=1) as calls:
            m, lines = run_quiet(bench_cli.main, argv)
        wall = time.perf_counter() - t0
        launches = counters(BENCH_COUNTERS)
        size = int(argv[argv.index("--size") + 1]) if "--size" in argv \
            else SIZE
        c = m["counts"]
        run = {"launches": launches, "eager": eager, "run_s": wall,
               # the CLI holds one frame while it renders the next
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if name in TPU_BENCH:
            record, tpu = TPU_BENCH[name]
            run[f"tpu_{record}"] = tpu
            run["card_minus_tpu"] = {k: c[k] - v for k, v in tpu.items()}
            run["max_diff_over_rays"] = max(
                abs(d) for d in run["card_minus_tpu"].values()) / size ** 2
            if (run["max_diff_over_rays"] > TPU_DIFF_MAX
                    and m["metric_family"] != "kerr"
                    and "--disk" not in argv):
                run["off_predicate"], run["nearest_critical"] = \
                    nearest_critical(calls[-1][2])
        if name == "4k_readme":
            run.update(b1_on_frame(calls[-1][2], size))
        del calls[:]
        out[name] = dict(run, line=m)
        phase(67, f"cli.bench_cli {' '.join(argv) or '(defaults)'} "
                  f"({CARD}): {json.dumps(run)}")
        print(lines[-1], flush=True)
        want = {k: renders if k == kernel else 0 for k in BENCH_COUNTERS}
        if launches != want or eager:
            raise AssertionError(f"cli.bench_cli {name}: launches "
                                 f"{launches} (want {want}), eager twins "
                                 f"on CUDA rays {eager}")
        if list(m) != BENCH_KEYS or json.loads(lines[-1]) != m:
            raise AssertionError(f"cli.bench_cli {name}: the line's keys "
                                 f"{list(m)} or the printed line differ")
        if (c["numerical_error"] or c["in_domain"]
                or c["escaped"] != c["background"]
                or sum(v for k, v in c.items() if k != "background")
                != size * size):
            raise AssertionError(f"cli.bench_cli {name}: counts {c}")
        if name == "defaults" and (c != counts32
                                   or not m["value"] * 1e3 >= b1_ms):
            raise AssertionError(f"cli.bench_cli defaults: counts {c} (phase "
                                 f"5: {counts32}) or value {m['value']} s "
                                 f"below B1's {b1_ms:.3f} ms")
        if name == "4k_readme":
            if any(run["render_vs_launch"].values()):
                raise AssertionError(f"cli.bench_cli {name}: the render's "
                                     f"rays differ from B1's launch on "
                                     f"them: {run['render_vs_launch']}")
            gate_parity(f"B1 on the {size}x{size} frame", run["b1_held"])
    return out


def b1_on_frame(res, size):
    """B1 with its wrapper on every ray of a Schwarzschild render `res`
    (CUDA events, median of 2 after a warm call), beside its bound; the
    last launch's output against the render's (status, n_steps and
    final_q mismatches on every ray) and against the eager twin on every
    B1_HELD_STRIDE-th ray and the last B1_HELD_TAIL."""
    from grtrace_torch.engine import integrate as ti
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine.validate import compare_outputs
    q0 = res.device("q0").reshape(-1, 4).contiguous()
    p0 = res.device("p0").reshape(-1, 4).contiguous()
    args = (STEPS, DELTA, 2.0 * MASS, R_MAX, OMEGA)
    kept = []

    def launch():
        kept[:] = [tc.integrate_batch_cuda(q0, p0, *args)]
    out = {"b1_ms": event_ms(launch, reps=2)}
    kern = kept.pop()
    ray_steps = int(kern[3].long().sum())
    out["b1_bound_ms"], out["b1_bound_by"] = bound(
        metrics.kernel_ops("fantasy_eqc", ray_steps, size * size),
        size * size * BYTES_RAY)
    fq = res.device("final_q").reshape(-1, 4)
    out["render_vs_launch"] = {
        "status_mismatch": int((res.device("status").reshape(-1)
                                != kern[2]).sum()),
        "n_steps_mismatch": int((res.device("n_steps").reshape(-1)
                                 != kern[3]).sum()),
        "final_q_bits_differ": not torch.equal(fq.view(torch.int32),
                                               kern[0].view(torch.int32))}
    n = q0.shape[0]
    idx = torch.unique(torch.cat([
        torch.arange(0, n, B1_HELD_STRIDE, device=q0.device),
        torch.arange(n - B1_HELD_TAIL, n, device=q0.device)]))
    twin = ti.integrate_dispatch(q0[idx].contiguous(), p0[idx].contiguous(),
                                 *args, backend="torch", equatorial=True)
    held = compare_outputs(tuple(o[idx] for o in kern), twin)
    held.update(rays=int(idx.numel()),
                held=f"every {B1_HELD_STRIDE}th ray and the last "
                     f"{B1_HELD_TAIL}", last_index=int(idx[-1]),
                captured=int((twin[2] == 1).sum()),
                escaped=int((twin[2] == 2).sum()),
                n_steps_max=int(twin[3].max()))
    out["b1_held"] = held
    return out


# phase 61: item 11's examples at their own sizes.  Gates on the polarized
# disk's two inline checks: the face-on Schwarzschild redshift against its
# closed form (8.2e-4 at most on the CPU twin, float32 rays, where the
# crossing's linear interpolation sets the error) and the vertical field's
# pitch weight on the outer disk of the near-edge-on view (median 0.910 on
# the CPU twin; the closed form's limit is 1 for a view in the plane)
EXAMPLES_OUT = os.path.join(HERE, "build", "examples_out")
FACEON_REL_ERR = 2e-3
PITCH_MIN, PITCH_MAX = 0.85, 1.0


def examples_phase():
    """Phase 61: item 11's three examples in-process on the card at their
    own sizes, with --no-plots, each kernel count set to 0 just before
    and read just after: analyze_photon_data renders its default scene
    (64x64, 5,000 steps of 0.05; B1 once) and summarizes it;
    polarized_disk renders the Novikov-Thorne disk with a vertical field
    (96x96, 4,000 steps; B6 once) and the face-on Schwarzschild disk (64x64;
    B6 once), whose inline checks are gated (FACEON_REL_ERR, PITCH_MIN);
    observables_workflow traces its one Kerr disk at its defaults
    (192x192, 12,000 steps of 0.03; B6 once) and derives every observable
    from the transfer map without another launch.  No eager twin runs on
    CUDA rays."""
    from grtrace_torch.examples import analyze_photon_data as ex_analyze
    from grtrace_torch.examples import observables_workflow as ex_workflow
    from grtrace_torch.examples import polarized_disk as ex_polarized
    runs = {}
    for tag, fn, argv, want in (
            ("analyze_photon_data", ex_analyze.main, [], {"B1": 1, "B6": 0}),
            ("polarized_disk", ex_polarized.main,
             [os.path.join(EXAMPLES_OUT, "polarized"), "--no-plots"],
             {"B1": 0, "B6": 2}),
            ("observables_workflow", ex_workflow.main,
             [os.path.join(EXAMPLES_OUT, "workflow"), "--no-plots"],
             {"B1": 0, "B6": 1})):
        counters(EXAMPLE_COUNTERS, reset=True)
        t0 = time.perf_counter()
        with eager_on_cuda() as eager:
            ret, _ = run_quiet(fn, argv)
        runs[tag] = {"launches": counters(EXAMPLE_COUNTERS),
                     "wall_s": time.perf_counter() - t0, "eager": eager}
        if runs[tag]["launches"] != want or eager:
            raise AssertionError(f"example {tag}: {runs[tag]} (want "
                                 f"launches {want}, no eager twin)")
        if tag == "analyze_photon_data":
            runs[tag]["classes"] = ret
            if (sum(ret.values()) != 64 * 64 or not ret.get("bh")
                    or not ret.get("escape_bg") or "error" in ret):
                raise AssertionError(f"analyze_photon_data: classes {ret}")
        elif tag == "polarized_disk":
            runs[tag].update(ret)
            if (ret["counts"]["numerical_error"] or not ret["disk_pixels"]
                    or not ret["faceon_err"] <= FACEON_REL_ERR
                    or not PITCH_MIN <= ret["pitch_outer"] <= PITCH_MAX):
                raise AssertionError(f"polarized_disk: {ret} (face-on "
                                     f"error at most {FACEON_REL_ERR}, "
                                     f"pitch in [{PITCH_MIN}, {PITCH_MAX}])")
        else:
            runs[tag].update({k: v for k, v in ret.items() if k != "out_dir"})
            files = ("scene.transfer.npz", "disk.png", "disk_nt.png",
                     "redshift_map.csv", "line_profile.csv",
                     "shadow_metrics.json", "visibility_profile.csv",
                     os.path.join("hotspot", "lightcurve.csv"))
            missing = [f for f in files
                       if not os.path.exists(os.path.join(ret["out_dir"], f))]
            if (missing or ret["counts"]["numerical_error"]
                    or not ret["counts"]["disk"]
                    or not all(np.isfinite(ret[k]) and ret[k] > 0 for k in (
                        "mean_diameter_px", "first_null", "r_blob",
                        "period"))):
                raise AssertionError(f"observables_workflow: {ret}, "
                                     f"missing {missing}")
    phase(61, f"item 11's examples on the card ({CARD}): {json.dumps(runs)}")
    return runs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import grtrace_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    global CARD, SM_CLOCK_HZ
    CARD = smi
    SM_CLOCK_HZ = metrics.sm_clock_hz()
    phase(1, f"card: {smi}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}; max SM clock {SM_CLOCK_HZ} Hz")
    build_kernels()
    occ = kernel_report()

    # --- kernel B1 and the headline Schwarzschild path --------------------
    q0, p0 = camera(SIZE, device)
    # the headline camera at the full budget: the very call render makes
    a, b1_out = check_parity(f"headline camera {SIZE}x{SIZE}, {STEPS} steps",
                             q0, p0, STEPS, DELTA, 2, "3a")
    q0s, p0s = camera(64, device)
    for order in (2, 4):
        check_parity(f"64x64 camera, order {order}", q0s, p0s, 2000, 0.05,
                     order, "3b")
    sweep = eqc_sweep(q0, p0, *camera(SIZE, device, torch.float64))
    eqc_occ = {k: (v["blocks_per_sm"], v["registers"]) for k, v in occ.items()
               if k.startswith("fantasy_eqc")}
    phase("3c", f"B1 and B2 on a quarter, a half and all of the float32 and "
                f"float64 headline rays ({STEPS}-step budget), B4 on the "
                f"carry opened from them ({JOB_CHUNK} steps), bare launches; "
                f"(resident blocks per SM, registers): {json.dumps(eqc_occ)}: "
                f"{json.dumps(sweep)}")

    golden_probes(device)
    launches, wall, counts32 = main_path(device)

    phase(6, f"integration at phase 3a's shapes ({SIZE * SIZE} rays, "
             f"{STEPS} step budget): kernel {a['kernel_ms']:.3f} ms "
             f"({100 * a['kernel_ms'] / 1e3 / wall:.1f}% of the render's "
             f"warm wall time), eager twin {a['twin_ms']:.3f} ms")
    eqc_bound, eqc_by = bound(
        metrics.kernel_ops("fantasy_eqc", a["n_steps_sum"], a["rays"]),
        a["rays"] * BYTES_RAY)

    # --- kernel B5 and the Kerr path ---------------------------------------
    # order 4 with charge and the 16-row layouts are off the main path and
    # held at small shapes; the main path's order-2 32-row layout is held
    # at the full Kerr frame in phase 9
    check_parity_ks("KS camera 48x48, order 4, charge 0.3, 3000 steps, "
                    "delta 0.05, 32 rows float", 48, 3000, 0.05, 4, 0.3,
                    torch.float32, True, "7a")
    for dtype in (torch.float32, torch.float64):
        check_parity_ks(f"KS camera 48x48, 2000 steps, delta 0.05, 16 rows "
                        f"{str(dtype)[6:]}", 48, 2000, 0.05, 2, 0.0, dtype,
                        False, "7b")
    kerr_boundary()
    kerr = kerr_main_path()
    b5 = "fantasy_ks_kernel<float, true, Mode::kPlain>"
    sweep = ks_sweep(kerr["q0"], kerr["p0"], KERR_STEPS, KERR_DELTA,
                     KERR_SPIN)
    phase("9b", f"B5 (32 rows) on a quarter, a half and all of the Kerr "
                f"frame's rays, {KERR_STEPS}-step budget, bare launches; "
                f"{occ[b5]['blocks_per_sm']} resident blocks per SM at "
                f"{occ[b5]['registers']} registers: {json.dumps(sweep)}")

    # --- kernel B6 and the disk path ---------------------------------------
    # the 16-row layouts are off the main path and held at small shapes; the
    # main path's 32-row layout is held at the full disk frame in phase 12
    for dtype in (torch.float32, torch.float64):
        check_parity_disk(f"disk camera 48x48, 2000 steps, delta 0.05, 16 "
                          f"rows {str(dtype)[6:]}", 48, 2000, 0.05, dtype,
                          False, "10")
    disk = disk_main_path()
    sweep = ks_sweep(disk["q0"], disk["p0"], DISK_STEPS, DISK_DELTA,
                     DISK_SPIN, "disk")
    phase("12b", f"B6 (32 rows) on a quarter, a half and all of the disk "
                 f"frame's rays, bare launches: {json.dumps(sweep)}")

    # --- kernel B7 and the subring path ------------------------------------
    # the 16-row layouts and a single slot are off the main path and held at
    # small shapes; the main path's 32-row, 3-order layout is held at the
    # full subring frame in phase 15
    for dtype in (torch.float32, torch.float64):
        check_parity_subring(f"subring camera 48x48, 2000 steps, delta 0.05, "
                             f"16 rows {str(dtype)[6:]}, 3 orders", 48, 2000,
                             0.05, dtype, False, 3, "13")
    check_parity_subring("subring camera 48x48, 2000 steps, delta 0.05, 32 "
                         "rows float32, 1 order", 48, 2000, 0.05,
                         torch.float32, True, 1, "13")
    sub = subring_main_path()
    sweep = ks_sweep(sub["q0"], sub["p0"], SUB_STEPS, SUB_DELTA, SUB_SPIN,
                     "subring")
    phase("15b", f"B7 (32 rows, {SUB_ORDERS} orders) on a quarter, a half "
                 f"and all of the subring frame's rays, bare launches: "
                 f"{json.dumps(sweep)}")
    photon_shell_anchor()

    # --- kernel B2 and the float64 headline path ---------------------------
    q0d, p0d = camera(64, device, torch.float64)
    for order in (2, 4):
        check_parity(f"64x64 camera, float64, order {order}", q0d, p0d, 2000,
                     0.05, order, "17", kernel="B2")
    q064, p064, eq_launches, wall64, counts64 = f64_main_path(device,
                                                             counts32)
    # the float64 headline camera at the full budget: the call render makes
    b2, _ = check_parity(f"float64 headline frame {SIZE}x{SIZE}, {STEPS} "
                         f"steps", q064, p064, STEPS, DELTA, 2, "19",
                         kernel="B2")
    eq_bound, eq_by = bound(
        metrics.kernel_ops("fantasy_eq", b2["n_steps_sum"], b2["rays"]),
        b2["rays"] * BYTES_RAY64, PEAK_FLOPS64)
    phase(19, f"float64 headline render warm wall time {wall64:.6f} s; B2 "
              f"kernel+wrapper at this shape {b2['kernel_ms']:.3f} ms "
              f"({100 * b2['kernel_ms'] / 1e3 / wall64:.1f}% of the wall), "
              f"eager twin {b2['twin_ms']:.3f} ms, {b2['n_steps_sum']} "
              f"ray-steps, bound {eq_bound:.3f} ms ({eq_by}); B1 at the "
              f"float32 frame {a['kernel_ms']:.3f} ms")
    golden_probes_f64(device)

    # --- kernel B3: SchwarzschildIntegrator and the generic checkpoint ------
    trig_probe(device)
    generic_phase(device)

    # --- kernel B4 and the checkpointed headline ----------------------------
    eqc = checkpoint_eqc(device, q0, p0, b1_out, a["kernel_ms"])
    gen = checkpoint_generic(device, q064, p064, counts64)
    b3 = "fantasy_schw16_kernel<double, Mode::kIntegrate>"
    sweep = schw16_sweep(q064, p064, STEPS, DELTA)
    phase("23b", f"B3 (double) on a quarter, a half and all of the float64 "
                 f"headline rays, {STEPS}-step budget, bare launches; "
                 f"{occ[b3]['blocks_per_sm']} resident blocks per SM at "
                 f"{occ[b3]['registers']} registers: {json.dumps(sweep)}")
    schw_boundary(device)

    # --- the command-line drivers and kernel S1 ----------------------------
    cli_res, cli_launches = cli_phase(device)
    s1 = traj_phase(device, cli_res)
    band_phase(device)
    profile_phase()

    # --- the disk product line through B6 and B7 ---------------------------
    dcli = disk_cli_phase()
    rsh = reshade_phase(dcli)
    mov = moving_camera_phase()
    hot = hotspot_phase()
    psub = polarized_subring_phase()
    # --- the generic engine: G1 and S2 ---------------------------------------
    gen_parity_phase()
    bl = bl_path_phase()
    ks_path = ks_path_phase()
    bl_a0_phase()
    # --- adaptive antialiasing and the observables' drivers ----------------
    aa = aa_phases()
    obs = observables_cli_phase()
    # --- the EinsteinPy-compatible traces (T1, T2) and the observables ----
    t1 = t1_phase()
    t2 = t2_phase()
    shadow = shadow_phase()
    echo = echo_phase()
    # --- the static beyond-Kerr family (G1s, S2s, T2s, D1) and 8e ----------
    static = static_cli_phase()
    static_traj = static_traj_phase(static)
    static_disk = static_disk_phase()
    exact = exact_cli_phase()
    images = images_cli_phase()
    first = static[f"{STATIC_FRAMES[0][0]} {STATIC_FRAMES[0][1]}"]
    phase(52, f"the 8e drivers' walls: cli.exact {exact['disk']['wall_s']:.3f}"
              f" s (with --compare), --background --compare "
              f"{exact['background']['wall_s']:.3f} s, cli.images "
              f"{images['wall_s']:.3f} s")
    # --- the line-profile fit (B6t) and the multi-device drivers ---------
    b6t = b6t_phase()
    fit = fit_line_phase()
    grids = line_grid_orbit_phase()
    nccl_phase()
    # --- the rotating regular families (G1r, S2r, T2r, D2) ----------------
    rot = rot_frames_phase(occ)
    rot_cli = rot_cli_phase()
    rot_disk = rot_disk_phase()
    rot_obs = rot_shadow_phase()
    # --- item 11's examples (B1, B6) ---------------------------------------
    examples = examples_phase()
    # --- Kerr-de Sitter (G1d, S2d, T2d, D3) and cli.qpo --------------------
    kds = kds_frames_phase(occ)
    kds_cli = kds_cli_phase()
    kds_disk = kds_disk_phase()
    kds_obs = kds_shadow_phase()
    qpo_phase()
    # --- the benchmark driver (B1, B2, B5, B6) -----------------------------
    bench = bench_cli_phase(counts32)
    bench_launches = {
        k: {n: r["launches"][k] for n, r in bench.items()
            if r["launches"][k]}
        for k in BENCH_COUNTERS}
    ex_launches = {k: r["launches"] for k, r in examples.items()}
    b6t_fit, b6t_map = fit["fisher_pass"], grids["line_grid"]["fisher_pass"]
    aa_launches = {k: {"aa_render": v["aa_render_launches"]}
                   for k, v in aa.items()}
    aa_launches["B1"]["cli_main_aa"] = obs["main"]["launches"]["B1"]
    aa_launches["B7"]["cli_subring_aa"] = obs["subring"]["launches"]["B7"]
    aa_pass = {k: {f: v[f] for f in ("size", "edges", "subrays",
                                     "pass_kernel_wrapper_ms", "pass_ms",
                                     "pass_plain_ms", "longest_subray_steps",
                                     "chain_floor_ms")}
               for k, v in aa.items()}
    disk_line = {"disk_cli": dcli["launches"], "reshade": rsh["launches"],
                 "camera_keplerian": mov["launches"],
                 "hotspot": hot["render"]["launches"],
                 "hotspot_transfer": hot["transfer"]["launches"],
                 "face_on_toroidal": psub["face_launches"]}

    print(json.dumps({"phase_seconds": {
        k: round(v, 1) for k, v in PHASE_SECONDS.items()},
        "total_s": round(sum(PHASE_SECONDS.values()), 1),
        "twin_graphs": TWIN_GRAPHS}))
    print(json.dumps({"kernels": [
        {"name": "fantasy_eqc",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_eqc.cu",
         "replaces": "grtrace/engine/integrate_pallas.py:77",
         "launches": launches + sum(aa_launches["B1"].values())
         + sum(r["B1"] for r in ex_launches.values())
         + sum(bench_launches["B1"].values()),
         "launches_main": launches,
         "launches_bench_cli": bench_launches["B1"],
         "launches_examples": {k: r["B1"] for k, r in ex_launches.items()
                               if r["B1"]},
         "launches_aa": aa_launches["B1"],
         "aa_pass": aa_pass["B1"],
         "max_abs_err": a["max_abs_err"],
         "ms": a["kernel_ms"],
         "plain_ms": a["twin_ms"],
         "bound_ms": eqc_bound,
         "bound_by": eqc_by,
         "library_ms": None,
         "shapes": f"ms, plain_ms and bound at {SIZE}x{SIZE} headline rays, "
                   f"{STEPS}-step budget (phase 3a)"},
        {"name": "fantasy_ks",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "grtrace/engine/integrate_pallas_ks.py:72",
         "launches": kerr["launches"] + sum(aa_launches["B5"].values())
         + shadow["shadow"]["launches"] + shadow["magnify"]["launches"]
         + sum(bench_launches["B5"].values()),
         "launches_main": kerr["launches"],
         "launches_bench_cli": bench_launches["B5"],
         "launches_aa": aa_launches["B5"],
         "launches_observables": {
             "cli_shadow_numeric": shadow["shadow"]["launches"],
             "cli_magnify": shadow["magnify"]["launches"]},
         "aa_pass": aa_pass["B5"],
         "max_abs_err": kerr["max_abs_err"],
         "ms": kerr["kernel_ms"],
         "plain_ms": kerr["twin_ms"],
         "bound_ms": kerr["bound_ms"],
         "bound_by": kerr["bound_by"],
         "library_ms": None,
         "shapes": f"every number at {KERR_SIZE}x{KERR_SIZE} Kerr rays, "
                   f"{KERR_STEPS}-step budget (phase 9)"},
        {"name": "fantasy_ks_disk",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "grtrace/engine/integrate_pallas_ks.py:72",
         "launches": disk["launches"] + sum(aa_launches["B6"].values())
         + sum(r["launches"] for r in echo.values())
         + sum(r["B6"] for r in ex_launches.values())
         + sum(bench_launches["B6"].values()),
         "launches_bench_cli": bench_launches["B6"],
         "launches_examples": {k: r["B6"] for k, r in ex_launches.items()
                               if r["B6"]},
         "launches_main": disk["launches"],
         "launches_aa": aa_launches["B6"],
         "launches_echo": {t: r["launches"] for t, r in echo.items()},
         "aa_pass": aa_pass["B6"],
         "max_abs_err": disk["max_abs_err"],
         "ms": disk["kernel_ms"],
         "plain_ms": disk["twin_ms"],
         "bound_ms": disk["bound_ms"],
         "bound_by": disk["bound_by"],
         "library_ms": None,
         "launches_disk_line": disk_line,
         "shapes": f"the disk mode (B6); every number at "
                   f"{DISK_SIZE}x{DISK_SIZE} disk-camera rays, "
                   f"{DISK_STEPS}-step budget (phase 12)"},
        {"name": "fantasy_ks_subring",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "grtrace/engine/integrate_pallas_ks.py:72",
         "launches": sub["launches"] + sum(aa_launches["B7"].values()),
         "launches_main": sub["launches"],
         "launches_aa": aa_launches["B7"],
         "aa_pass": aa_pass["B7"],
         "max_abs_err": sub["max_abs_err"],
         "ms": sub["kernel_ms"],
         "plain_ms": sub["twin_ms"],
         "bound_ms": sub["bound_ms"],
         "bound_by": sub["bound_by"],
         "library_ms": None,
         "launches_disk_line": {"polarized_subrings": psub["launches"]},
         "shapes": f"the subring mode (B7); every number at "
                   f"{SUB_SIZE}x{SUB_SIZE} subring-camera rays, "
                   f"{SUB_STEPS}-step budget, {SUB_ORDERS} orders "
                   f"(phase 15)"},
        {"name": "fantasy_eq",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_eqc.cu",
         "replaces": "grtrace/engine/integrate_pallas.py:77",
         "launches": eq_launches + sum(aa_launches["B2"].values())
         + sum(bench_launches["B2"].values()),
         "launches_main": eq_launches,
         "launches_bench_cli": bench_launches["B2"],
         "launches_aa": aa_launches["B2"],
         "aa_pass": aa_pass["B2"],
         "max_abs_err": b2["max_abs_err"],
         "ms": b2["kernel_ms"],
         "plain_ms": b2["twin_ms"],
         "bound_ms": eq_bound,
         "bound_by": eq_by,
         "library_ms": None,
         "shapes": f"B2, the plain 12-row float64 layout; every number at "
                   f"{SIZE}x{SIZE} float64 headline rays, {STEPS}-step "
                   f"budget (phase 19); bound over the FP64 rate"},
        {"name": "fantasy_schw16",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_schw16.cu",
         "replaces": "grtrace/engine/integrate_pallas.py:77",
         "launches": gen["launches"],
         "max_abs_err": gen["max_abs_err"],
         "ms": gen["kernel_ms"],
         "plain_ms": gen["twin_ms"],
         "bound_ms": gen["bound_ms"],
         "bound_by": gen["bound_by"],
         "library_ms": None,
         "shapes": f"B3, the 16-row fused-flow layout; launches: "
                   f"SchwarzschildIntegrator(backend='cuda') and the "
                   f"chunked job on the {SIZE}x{SIZE} float64 headline rays "
                   f"(phase 23); every other number at the integrator's "
                   f"call, one launch on those rays at the {STEPS}-step "
                   f"budget; bound over the FP64 rate"},
        {"name": "fantasy_eqc_chunk",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_eqc.cu",
         "replaces": "grtrace/engine/integrate_pallas.py:77",
         "launches": eqc["launches"],
         "max_abs_err": eqc["max_abs_err"],
         "ms": eqc["kernel_ms"],
         "plain_ms": eqc["twin_ms"],
         "bound_ms": eqc["bound_ms"],
         "bound_by": eqc["bound_by"],
         "library_ms": None,
         "shapes": f"B4, B1's core loop on an opened carry; launches from "
                   f"the checkpointed float32 headline job (phase 22); "
                   f"every other number at that job's call, its first "
                   f"{JOB_CHUNK}-step chunk on the opened {SIZE}x{SIZE} "
                   f"float32 carry"},
        {"name": "fantasy_traj",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_schw16.cu",
         "replaces": "none: a port-side kernel; the JAX package's sampler "
                     "is the XLA loop grtrace/engine/integrate.py:328",
         "launches": cli_launches["S1"],
         "max_abs_err": s1["max_abs_err"],
         "ms": s1["kernel_ms"],
         "plain_ms": s1["twin_ms"],
         "bound_ms": s1["bound_ms"],
         "bound_by": s1["bound_by"],
         "library_ms": None,
         "chain_floor_ms": s1["chain_floor_ms"],
         "shapes": f"S1, the trajectory recorder (the record mode of "
                   f"fantasy_schw16.cu); launches from the CLI's "
                   f"headline run (phase 25); every other number on its "
                   f"{s1['rays']} sampled rays at the {STEPS}-step budget, "
                   f"{TRAJ_POINTS} points, float32 (phase 26; longest ray "
                   f"{s1['n_steps_max']} steps)"},
        {"name": "fantasy_gen",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (G1); the JAX package's "
                     "Boyer-Lindquist engine is the XLA while_loop "
                     "grtrace/engine/integrate_generic.py:209",
         "launches": bl["launches"]["G1"] + sum(aa_launches["G1"].values()),
         "launches_main": bl["launches"]["G1"],
         "launches_aa": aa_launches["G1"],
         "aa_pass": aa_pass["G1"],
         "max_abs_err": bl["g1"]["max_abs_err"],
         "ms": bl["g1"]["kernel_ms"],
         "plain_ms": bl["g1"]["twin_ms"],
         "bound_ms": bl["g1"]["bound_ms"],
         "bound_by": bl["g1"]["bound_by"],
         "library_ms": None,
         "ms_whole_frame": bl["g1_full_ms"],
         "bound_ms_whole_frame": bl["g1_full_bound_ms"],
         "shapes": f"G1, the Boyer-Lindquist integrator; launches from "
                   f"cli.main --metric kerr-bl at {KERR_SIZE}x{KERR_SIZE}, "
                   f"{KERR_STEPS} steps (phase 35); max_abs_err, ms, "
                   f"plain_ms and bound_ms on {bl['g1']['held']} of that "
                   f"frame at the full budget (the twin's time there), "
                   f"float32; *_whole_frame on all its rays"},
        {"name": "fantasy_gen_traj_bl",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (S2, Boyer-Lindquist chart); "
                     "the JAX package's sampler is the XLA scan "
                     "grtrace/engine/integrate_generic.py:312",
         "launches": bl["launches"]["S2"],
         "max_abs_err": bl["s2"]["max_abs_err"],
         "ms": bl["s2"]["kernel_ms"],
         "plain_ms": bl["s2"]["twin_ms"],
         "bound_ms": bl["s2"]["bound_ms"],
         "bound_by": bl["s2"]["bound_by"],
         "library_ms": None,
         "shapes": f"S2 in the Boyer-Lindquist chart; launches from phase "
                   f"35's CLI run; every other number on its {N_SAMPLES} "
                   f"sampled rays at the {KERR_STEPS}-step budget, "
                   f"{TRAJ_POINTS} points, float32 (longest ray "
                   f"{bl['s2']['n_steps_max']} steps)"},
        {"name": "fantasy_gen_traj_ks",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (S2, Kerr-Schild chart); the "
                     "JAX package's sampler is the XLA scan "
                     "grtrace/engine/integrate_generic.py:312",
         "launches": ks_path["launches"]["S2"],
         "max_abs_err": ks_path["s2"]["max_abs_err"],
         "ms": ks_path["s2"]["kernel_ms"],
         "plain_ms": ks_path["s2"]["twin_ms"],
         "bound_ms": ks_path["s2"]["bound_ms"],
         "bound_by": ks_path["s2"]["bound_by"],
         "library_ms": None,
         "shapes": f"S2 in the Kerr-Schild chart; launches from "
                   f"cli.main --metric kerr at {KERR_SIZE}x{KERR_SIZE} "
                   f"(phase 37); every other number on its {N_SAMPLES} "
                   f"sampled rays at the {KERR_STEPS}-step budget, "
                   f"{TRAJ_POINTS} points, float32 (longest ray "
                   f"{ks_path['s2']['n_steps_max']} steps)"},
        {"name": "fantasy_trace",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_schw16.cu",
         "replaces": "none: a port-side kernel (T1); the JAX package's "
                     "EinsteinPy-compatible trace is the XLA scan "
                     "grtrace/compat/einsteinpy.py:40",
         "launches": sum(t1[k]["launches"] for k in
                         ("golden", "timelike_circular", "example")),
         "max_abs_err": t1["golden"]["trace"]["max_abs_err"],
         "ms": t1["golden"]["trace"]["kernel_ms"],
         "plain_ms": t1["golden"]["trace"]["twin_ms"],
         "bound_ms": t1["golden"]["trace"]["bound_ms"],
         "bound_by": t1["golden"]["trace"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": t1["golden"]["trace"]["chain_floor_ms"],
         "ms_example": t1["example"]["trace"]["kernel_ms"],
         "chain_floor_ms_example": t1["example"]["trace"]["chain_floor_ms"],
         "shapes": "T1, the trace mode of fantasy_schw16.cu; launches from "
                   "Nulllike on the golden ray, Timelike's circular orbit "
                   "and the einsteinpy_ray example (phase 44); ms, "
                   "plain_ms and the bounds on the golden ray (1 ray, "
                   "2000 steps, float64), *_example on the example's "
                   "(10,000 steps)"},
        {"name": "fantasy_gen_trace",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (T2); the JAX package's "
                     "trace is the XLA scan "
                     "grtrace/engine/integrate_generic.py:369",
         "launches": sum(t2[t]["launches"] for t in KERR_TRACES),
         "max_abs_err": max(t2[t]["trace"]["max_abs_err"]
                            for t in KERR_TRACES),
         "ms": t2["Kerr-Newman (0.5, 0.4)"]["trace"]["kernel_ms"],
         "plain_ms": t2["Kerr-Newman (0.5, 0.4)"]["trace"]["twin_ms"],
         "bound_ms": t2["Kerr-Newman (0.5, 0.4)"]["trace"]["bound_ms"],
         "bound_by": t2["Kerr-Newman (0.5, 0.4)"]["trace"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms":
             t2["Kerr-Newman (0.5, 0.4)"]["trace"]["chain_floor_ms"],
         "shapes": "T2, the Boyer-Lindquist trace mode of fantasy_gen.cu; "
                   "launches from Nulllike on the Kerr and Kerr-Newman "
                   "rays (phase 45); every other number on the "
                   "Kerr-Newman ray (1 ray, 400 steps, float64)"},
        {"name": "fantasy_gen_static",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (G1s); the JAX package's "
                     "static-family engine is the XLA while_loop "
                     "grtrace/engine/integrate_generic.py:209",
         "launches": sum(f["launches"]["G1s"] for f in static.values()),
         "launches_frames": {k: f["launches"]["G1s"]
                             for k, f in static.items()},
         "max_abs_err": max(f["held"]["max_abs_err"]
                            for f in static.values()),
         "ms": first["g1s"]["ms"],
         "plain_ms": first["held"]["twin_ms"],
         "bound_ms": first["g1s"]["bound_ms"],
         "bound_by": first["g1s"]["bound_by"],
         "library_ms": None,
         "ms_held": first["held"]["kernel_ms"],
         "bound_ms_held": first["held"]["bound_ms"],
         "frames": {k: {"ms": f["g1s"]["ms"], "bound_ms": f["g1s"]["bound_ms"],
                        "wall_s": f["wall"],
                        "fold_drift": f["g1s"]["fold_drift"]}
                    for k, f in static.items()},
         "shapes": f"G1s, the static chart of fantasy_gen.cu; launches from "
                   f"cli.main on the four frames of phase 48 "
                   f"({STATIC_SIZE}x{STATIC_SIZE}, {STEPS} steps, float32); "
                   f"ms and bound_ms on the whole {STATIC_FRAMES[0]} frame; "
                   f"plain_ms, ms_held and max_abs_err on every "
                   f"{STATIC_HELD}th ray of each frame at the full budget"},
        {"name": "fantasy_gen_traj_static",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (S2s); the JAX package's "
                     "sampler is the XLA scan "
                     "grtrace/engine/integrate_generic.py:312",
         "launches": sum(f["launches"]["S2s"] for f in static.values()),
         "max_abs_err": static_traj["s2"]["max_abs_err"],
         "ms": static_traj["s2"]["kernel_ms"],
         "plain_ms": static_traj["s2"]["twin_ms"],
         "bound_ms": static_traj["s2"]["bound_ms"],
         "bound_by": static_traj["s2"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": static_traj["s2"]["chain_floor_ms"],
         "shapes": f"S2s; launches from phase 48's four CLI runs; every "
                   f"other number on the {STATIC_FRAMES[0]} frame's "
                   f"{N_SAMPLES} sampled rays at the {STEPS}-step budget, "
                   f"{TRAJ_POINTS} points, float32 (phase 49)"},
        {"name": "fantasy_gen_trace_static",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (T2s); the JAX package's "
                     "trace is the XLA scan "
                     "grtrace/engine/integrate_generic.py:369",
         "launches": static_traj["t2"]["launches"],
         "max_abs_err": static_traj["t2"]["max_abs_err"],
         "ms": static_traj["t2"]["kernel_ms"],
         "plain_ms": static_traj["t2"]["twin_ms"],
         "bound_ms": static_traj["t2"]["bound_ms"],
         "bound_by": static_traj["t2"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": static_traj["t2"]["chain_floor_ms"],
         "shapes": "T2s; trajectory_generic on one ray of phase 48's first "
                   "frame, 2000 steps, float64 (phase 49)"},
        {"name": "fantasy_gen_disk_static",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (D1); the JAX package's "
                     "static disk is the XLA while_loop "
                     "grtrace/engine/disk_static.py:61",
         "launches": static_disk["launches"]["D1"],
         "max_abs_err": static_disk["d1"]["max_abs_err"],
         "ms": static_disk["d1"]["kernel_ms"],
         "plain_ms": static_disk["d1"]["twin_ms"],
         "bound_ms": static_disk["d1"]["bound_ms"],
         "bound_by": static_disk["d1"]["bound_by"],
         "library_ms": None,
         "shapes": f"D1; every number from render_disk_static "
                   f"{STATIC_DISK} at {DISK_SIZE}x{DISK_SIZE}, "
                   f"{DISK_STEPS} steps, float32, on every ray (phase 50)"},
        {"name": "fantasy_ks_disk_tangent",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "none: a port-side kernel (B6t, one direction); the "
                     "JAX package differentiates the XLA while_loop "
                     "grtrace/engine/disk.py:113 with jax.linearize / "
                     "jax.jacfwd (engine/sensitivity.py:66-138)",
         "launches": b6t["model_jvp"]["launches"]["B6t"],
         "launches_paths": {"line_profile_model_jvp":
                                b6t["model_jvp"]["launches"]["B6t"]},
         "max_abs_err": max(b6t[k]["max_abs_err_b6t"]
                            for k in ("float32", "float64")),
         "ms": b6t["float64"]["b6t_ms"][0],
         "plain_ms": b6t["float64"]["twin_b6t_ms"],
         "bound_ms": b6t["float64"]["bound_ms_b6t"],
         "bound_by": b6t["float64"]["bound_by"],
         "library_ms": None,
         "shapes": f"B6t with one direction (Mode::kDiskTangent), the jvp "
                   f"of line_profile_model under forward AD; launches from "
                   f"that model along spin at {B6T_SIZE}x{B6T_SIZE}, "
                   f"float64 (phase 53); ms, plain_ms and bound_ms on the "
                   f"{B6T_SIZE}x{B6T_SIZE} disk camera's rays, "
                   f"{B6T_STEPS} steps of {B6T_DELTA}, float64, the spin "
                   f"direction (bound: that launch's ray-steps)"},
        {"name": "fantasy_ks_disk_tangent2",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_ks.cu",
         "replaces": "none: a port-side kernel (B6t, both directions); the "
                     "JAX package differentiates the XLA while_loop "
                     "grtrace/engine/disk.py:113 with jax.linearize / "
                     "jax.jacfwd (engine/sensitivity.py:66-138)",
         "launches": fit["launches"]["B6t2"]
         + grids["line_grid"]["launches"]["B6t2"],
         "launches_paths": {"cli_fit_line": fit["launches"]["B6t2"],
                            "cli_line_grid_fisher":
                                grids["line_grid"]["launches"]["B6t2"]},
         "max_abs_err": max([b6t[k]["max_abs_err"]
                             for k in ("float32", "float64")]
                            + [b6t_fit["max_abs_err"],
                               b6t_map["max_abs_err"]]),
         "ms": b6t_fit["b6t2_ms"],
         "plain_ms": b6t_fit["twin_ms"],
         "bound_ms": b6t_fit["bound_ms"],
         "bound_by": b6t_fit["bound_by"],
         "library_ms": None,
         "b6_16row_ms": b6t_fit["b6_16row_ms"],
         "b6t_one_direction_ms": b6t_fit["b6t_ms"],
         "fisher_map_pass": b6t_map,
         "camera_48": {k: {f: b6t[k][f] for f in (
             "b6t2_ms", "b6t_ms", "b6_16row_ms", "twin_ms", "bound_ms")}
                       for k in ("float32", "float64")},
         "shapes": f"B6t with both directions (Mode::kDiskTangent2), one "
                   f"launch a linearization; launches from cli.fit_line and "
                   f"cli.line_grid --fisher at their defaults (phases 54, "
                   f"55); ms, plain_ms, bound_ms, b6_16row_ms and "
                   f"b6t_one_direction_ms on cli.fit_line's last "
                   f"linearization ({b6t_fit['rays']} rays, "
                   f"{b6t_fit['dtype']}; phase 54), fisher_map_pass on "
                   f"cli.line_grid's (phase 55), both held bitwise against "
                   f"the twin, the one-direction launches and B6; "
                   f"camera_48 on the {B6T_SIZE}x{B6T_SIZE} disk camera, "
                   f"{B6T_STEPS} steps of {B6T_DELTA}, each dtype (phase "
                   f"53)"},
        {"name": "fantasy_gen_rot",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (G1r); the JAX package's "
                     "rotating regular families run the XLA while_loop "
                     "grtrace/engine/integrate_generic.py:209",
         "launches": sum(f["launches"]["G1r"] for f in rot.values())
         + sum(r["launches"]["G1r"] for r in (rot_cli["plain"],
                                              rot_cli["aa"]))
         + rot_obs["numeric"]["launches"]["G1r"]
         + rot_obs["sharded"]["launches"]["G1r"],
         "launches_paths": {
             "frames": {k: f["launches"]["G1r"] for k, f in rot.items()},
             "cli_main": rot_cli["plain"]["launches"]["G1r"],
             "cli_main_aa": rot_cli["aa"]["launches"]["G1r"],
             "cli_shadow_numeric": rot_obs["numeric"]["launches"]["G1r"],
             "sharded_nccl": rot_obs["sharded"]["launches"]["G1r"]},
         "max_abs_err": max(f["held"]["max_abs_err"] for f in rot.values()),
         "ms": rot["frame"]["g1r"]["ms"],
         "plain_ms": rot["frame"]["held"]["twin_ms"],
         "bound_ms": rot["frame"]["g1r"]["bound_ms"],
         "bound_by": rot["frame"]["g1r"]["bound_by"],
         "library_ms": None,
         "ms_held": rot["frame"]["held"]["kernel_ms"],
         "bound_ms_held": rot["frame"]["held"]["bound_ms"],
         "frames": {k: {"ms": f["g1r"]["ms"], "bound_ms": f["g1r"]["bound_ms"],
                        "wall_s": f["wall"], "counts": f["counts"]}
                    for k, f in rot.items()},
         "shapes": f"G1r, the mass-function Kerr-Schild chart of "
                   f"fantasy_gen.cu; ms and bound_ms on the whole "
                   f"{ROT_FRAME} a = {ROT_SPIN} frame at "
                   f"{KERR_SIZE}x{KERR_SIZE}, {KERR_STEPS} steps of "
                   f"{KERR_DELTA}, float32 (phase 57); plain_ms and ms_held "
                   f"on every {ROT_HELD}th ray of it; max_abs_err over that "
                   f"and every ray of the {ROT_SMALL}x{ROT_SMALL} float64 "
                   f"{ROT_F64} and horizonless {ROT_HORIZONLESS} frames"},
        {"name": "fantasy_gen_traj_rot",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (S2r); the JAX package's "
                     "sampler is the XLA scan "
                     "grtrace/engine/integrate_generic.py:312",
         "launches": rot_cli["plain"]["launches"]["S2r"]
         + rot_cli["aa"]["launches"]["S2r"],
         "max_abs_err": rot_cli["s2"]["max_abs_err"],
         "ms": rot_cli["s2"]["kernel_ms"],
         "plain_ms": rot_cli["s2"]["twin_ms"],
         "bound_ms": rot_cli["s2"]["bound_ms"],
         "bound_by": rot_cli["s2"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": rot_cli["s2"]["chain_floor_ms"],
         "shapes": f"S2r; launches from phase 58's two CLI runs; every "
                   f"other number on the rotating-Hayward CLI frame's "
                   f"{N_SAMPLES} sampled rays, 30000-step budget, "
                   f"{TRAJ_POINTS} points, float32 (phase 58)"},
        {"name": "fantasy_gen_trace_rot",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (T2r); the JAX package's "
                     "trace is the XLA scan "
                     "grtrace/engine/integrate_generic.py:369",
         "launches": rot_obs["t2"]["launches"],
         "max_abs_err": rot_obs["t2"]["max_abs_err"],
         "ms": rot_obs["t2"]["kernel_ms"],
         "plain_ms": rot_obs["t2"]["twin_ms"],
         "bound_ms": rot_obs["t2"]["bound_ms"],
         "bound_by": rot_obs["t2"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": rot_obs["t2"]["chain_floor_ms"],
         "shapes": "T2r; trajectory_generic on one rotating-Bardeen ray, "
                   "2000 steps, float64 (phase 60)"},
        {"name": "fantasy_gen_disk_rot",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (D2); the JAX package's "
                     "rotating regular disk is the XLA while_loop "
                     "grtrace/engine/disk.py:113",
         "launches": sum(rot_disk["launches"].values()),
         "launches_paths": rot_disk["launches"],
         "max_abs_err": max(rot_disk[k]["max_abs_err"]
                            for k in ("readme_256", "disk_512")),
         "ms": rot_disk["disk_512"]["kernel_ms"],
         "plain_ms": rot_disk["disk_512"]["twin_ms"],
         "bound_ms": rot_disk["disk_512"]["bound_ms"],
         "bound_by": rot_disk["disk_512"]["bound_by"],
         "library_ms": None,
         "readme_256": {k: rot_disk["readme_256"][k] for k in (
             "kernel_ms", "twin_ms", "bound_ms", "hits")},
         "shapes": f"D2; every number on every ray of the {DISK_SIZE}x"
                   f"{DISK_SIZE} rotating-Bardeen (a = {ROT_SPIN}, g = 0.2) "
                   f"disk, {DISK_STEPS} steps of {DISK_DELTA}, float32 "
                   f"(phase 59); readme_256 on the README's 256x256 disk "
                   f"command's frame"},
        {"name": "fantasy_gen_kds",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (G1d); the JAX package's "
                     "Kerr-de Sitter engine is the XLA while_loop "
                     "grtrace/engine/integrate_generic.py:209",
         "launches": sum(kds[k]["launches"]["G1d"]
                         for k in ("frame", "float64", "zero"))
         + sum(r["launches"]["G1d"] for r in (kds_cli["plain"],
                                              kds_cli["aa"]))
         + kds_obs["numeric"]["launches"]["G1d"],
         "launches_paths": {
             "frames": {k: kds[k]["launches"]["G1d"]
                        for k in ("frame", "float64", "zero")},
             "cli_main": kds_cli["plain"]["launches"]["G1d"],
             "cli_main_aa": kds_cli["aa"]["launches"]["G1d"],
             "cli_shadow_numeric": kds_obs["numeric"]["launches"]["G1d"]},
         "max_abs_err": max(kds[k]["held"]["max_abs_err"]
                            for k in ("frame", "float64", "zero")),
         "ms": kds["frame"]["g1d"]["ms"],
         "plain_ms": kds["frame"]["held"]["twin_ms"],
         "bound_ms": kds["frame"]["g1d"]["bound_ms"],
         "bound_by": kds["frame"]["g1d"]["bound_by"],
         "library_ms": None,
         "ms_held": kds["frame"]["held"]["kernel_ms"],
         "bound_ms_held": kds["frame"]["held"]["bound_ms"],
         "frames": {k: {"ms": kds[k]["g1d"]["ms"],
                        "bound_ms": kds[k]["g1d"]["bound_ms"],
                        "wall_s": kds[k]["wall"], "counts": kds[k]["counts"]}
                    for k in ("frame", "float64", "zero")},
         "zero_lambda_vs_kerr_bl": kds["zero_vs_bl"],
         "shapes": f"G1d, the Carter chart of fantasy_gen.cu; ms and "
                   f"bound_ms on the whole a = {KDS_SPIN}, Lambda = "
                   f"{KDS_LAMBDA} frame at {KERR_SIZE}x{KERR_SIZE}, "
                   f"{KERR_STEPS} steps of {KERR_DELTA}, float32 (phase "
                   f"62); plain_ms and ms_held on every {KDS_HELD}th ray "
                   f"of it; max_abs_err over that and every ray of the "
                   f"{KDS_SMALL}x{KDS_SMALL} float64 and Lambda = 0 "
                   f"frames"},
        {"name": "fantasy_gen_traj_kds",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (S2d); the JAX package's "
                     "sampler is the XLA scan "
                     "grtrace/engine/integrate_generic.py:312",
         "launches": kds_cli["plain"]["launches"]["S2d"]
         + kds_cli["aa"]["launches"]["S2d"],
         "max_abs_err": kds_cli["s2"]["max_abs_err"],
         "ms": kds_cli["s2"]["kernel_ms"],
         "plain_ms": kds_cli["s2"]["twin_ms"],
         "bound_ms": kds_cli["s2"]["bound_ms"],
         "bound_by": kds_cli["s2"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": kds_cli["s2"]["chain_floor_ms"],
         "shapes": f"S2d; launches from phase 63's two CLI runs; every "
                   f"other number on the CLI frame's {N_SAMPLES} sampled "
                   f"rays, 30000-step budget, {TRAJ_POINTS} points, "
                   f"float32 (phase 63)"},
        {"name": "fantasy_gen_trace_kds",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (T2d); the JAX package's "
                     "trace is the XLA scan "
                     "grtrace/engine/integrate_generic.py:369",
         "launches": kds_obs["t2"]["launches"],
         "max_abs_err": kds_obs["t2"]["max_abs_err"],
         "ms": kds_obs["t2"]["kernel_ms"],
         "plain_ms": kds_obs["t2"]["twin_ms"],
         "bound_ms": kds_obs["t2"]["bound_ms"],
         "bound_by": kds_obs["t2"]["bound_by"],
         "library_ms": None,
         "chain_floor_ms": kds_obs["t2"]["chain_floor_ms"],
         "shapes": "T2d; trajectory_generic on one Kerr-de Sitter ray, "
                   "2000 steps, float64 (phase 65)"},
        {"name": "fantasy_gen_disk_kds",
         "route": "cuda",
         "source": "grtrace_torch/csrc/fantasy_gen.cu",
         "replaces": "none: a port-side kernel (D3); the JAX package's "
                     "Kerr-de Sitter disk is the XLA while_loop "
                     "grtrace/engine/disk_kds.py:108",
         "launches": kds_disk["launches"]["D3"],
         "max_abs_err": kds_disk["d3"]["max_abs_err"],
         "ms": kds_disk["d3"]["kernel_ms"],
         "plain_ms": kds_disk["d3"]["twin_ms"],
         "bound_ms": kds_disk["d3"]["bound_ms"],
         "bound_by": kds_disk["d3"]["bound_by"],
         "library_ms": None,
         "shapes": f"D3; every number on every ray of the {DISK_SIZE}x"
                   f"{DISK_SIZE} Kerr-de Sitter disk (a = {KDS_SPIN}, "
                   f"Lambda = {KDS_DISK_LAMBDA}), 30000 steps of 0.03, "
                   f"float32 (phase 64)"}
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with graphed_twins():
        sys.exit(main())
