"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from `grtrace_torch/csrc`, holds it against
its eager twin on the card, checks it against the float64 oracle golden,
then drives the port's main path — `grtrace_torch.render` of the headline
Schwarzschild scene (400x400 rays, 200k steps, delta 0.01, float32) — and
checks that the render went through the kernel.  Each phase prints one
line; any failure raises and the script exits non-zero.  The last two
lines are a JSON record of the kernels and a JSON status line.

Imports only torch, numpy and grtrace_torch (never jax or grtrace): the
machine with the card has no jax.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "oracle_escape_headline.npz")

# the headline scene (bench.py's): 400x400, 200k steps, delta 0.01, omega 1
SIZE, STEPS, DELTA, OMEGA = 400, 200_000, 0.01, 1.0
OBS_X, FOV_DEG, MASS, R_MAX = 30.0, 80.0, 1.0, 31.0
# the TPU's counts for the headline scene (BENCH_r05.json)
TPU_COUNTS = {"captured": 5712, "escaped": 154288}


def phase(n, msg):
    print(f"[{n}] {msg}", flush=True)


def camera(size, device, dtype=torch.float32):
    from grtrace_torch.physics.camera import camera_rays
    obs = torch.tensor([OBS_X, 0.0, 0.0], dtype=dtype, device=device)
    q0, p0, *_ = camera_rays(obs, math.radians(FOV_DEG), size, size,
                             mass_bh=MASS, dtype=dtype, device=device)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def timed(fn):
    """(result, milliseconds) of one call, with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(kern, twin):
    """Mismatch counts of kernel vs twin outputs (q, p, status, n_steps)."""
    (qk, pk, sk, nk), (qt, pt, st, nt) = kern, twin
    bits = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in ((qk, qt), (pk, pt))]
    err = max(float((a - b).abs().nan_to_num(float("inf")).max())
              for a, b in ((qk, qt), (pk, pt)))
    return {"status_mismatch": int((sk != st).sum()),
            "n_steps_mismatch": int((nk != nt).sum()),
            "q_bitwise_equal": bits[0], "p_bitwise_equal": bits[1],
            "max_abs_err": err}


def check_parity(tag, q0, p0, steps, delta, order, n, record):
    """The kernel against its eager twin, which `backend='torch'` selects
    on the card."""
    from grtrace_torch.engine.integrate import integrate_dispatch
    from grtrace_torch.engine.integrate_cuda import integrate_batch_cuda
    args = (steps, delta, 2.0 * MASS, R_MAX, OMEGA)
    integrate_batch_cuda(q0, p0, *args, order=order)  # warm-up
    kern, kern_ms = timed(lambda: integrate_batch_cuda(q0, p0, *args,
                                                       order=order))
    twin, twin_ms = timed(lambda: integrate_dispatch(
        q0, p0, *args, backend="torch", equatorial=True, order=order))
    res = compare(kern, twin)
    status = kern[2]
    res.update(rays=q0.shape[0], steps=steps, delta=delta, order=order,
               captured=int((status == 1).sum()),
               escaped=int((status == 2).sum()),
               kernel_ms=kern_ms, twin_ms=twin_ms)
    phase(n, f"kernel vs eager twin, {tag}: {json.dumps(res)}")
    if res["status_mismatch"] or res["n_steps_mismatch"]:
        raise AssertionError(f"{tag}: status/n_steps differ between kernel "
                             f"and twin")
    if not (res["q_bitwise_equal"] and res["p_bitwise_equal"]):
        raise AssertionError(
            f"{tag}: final q/p not bitwise equal (max abs diff "
            f"{res['max_abs_err']:.3e}); the kernel is built with "
            f"-fmad=false to round exactly as the twin's torch ops")
    record.append(res)
    return res


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


def headline_scene():
    from grtrace_torch import IntegratorConfig, PatchConfig, SceneConfig
    return SceneConfig(
        size=SIZE, fov_deg=FOV_DEG, background=None, bh_mass=MASS,
        boundary_radius=R_MAX, observer_distance=OBS_X,
        integrator=IntegratorConfig(steps=STEPS, delta=DELTA, omega=OMEGA,
                                    backend="auto", dtype="float32"),
        patch=PatchConfig(), n_samples=0)


def main_path(device):
    import grtrace_torch
    from grtrace_torch.engine import integrate_cuda
    from grtrace_torch.engine.integrate import schw_true_escape_pred
    from grtrace_torch.engine.metrics import RenderMetrics
    from grtrace_torch.io.textures import starfield

    scene = headline_scene()
    tex = starfield()
    integrate_cuda.launches = 0
    metrics = RenderMetrics()
    res = grtrace_torch.render(scene, bg_array=tex, device="cuda",
                               metrics=metrics)
    launches = integrate_cuda.launches
    counts = res.counts
    ns = res.n_steps.astype(np.int64)
    image = res.image
    fq = res.final_q
    summary = {"launches": launches, "counts": counts,
               "tpu_counts_BENCH_r05": TPU_COUNTS,
               "stages_s": metrics.stages,
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
        # The TPU's per-ray classes are not recorded.  After the rescue a
        # ray's status is the exact launch-state predicate, so the rays
        # that can flip between implementations are those whose launch
        # impact parameter rounds across b_crit: print the nearest.
        q0 = res.device("q0").reshape(-1, 4)
        p0 = res.device("p0").reshape(-1, 4)
        pred = schw_true_escape_pred(q0, p0, 2.0 * MASS).cpu().numpy()
        status = res.status.reshape(-1)
        off_pred = np.flatnonzero((status == 1) & pred
                                  | (status == 2) & ~pred)
        b = (p0[:, 3].abs() / p0[:, 0].abs()).double().cpu().numpy()
        b_rel = np.abs(b - 3.0 * math.sqrt(3.0) * MASS) / (
            3.0 * math.sqrt(3.0) * MASS)
        nearest = np.sort(b_rel)[:10]
        phase(5, f"counts differ from the TPU's by "
                 f"{counts['captured'] - TPU_COUNTS['captured']} captured; "
                 f"{len(off_pred)} rays' status disagrees with the exact "
                 f"predicate; nearest-critical |b - b_crit|/b_crit: "
                 f"{nearest.tolist()}")

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
    return launches, wall


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import grtrace_torch  # noqa: F401  (fails outside a checkout)
    from grtrace_torch.kernels import build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    phase(1, f"card: {smi}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}")

    lib_path, build_s = build.build()
    build.load()
    ptxas = [ln.strip() for ln in
             lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    phase(2, f"built {lib_path.name} in {build_s:.2f} s; {' | '.join(ptxas)}")

    record = []
    q0, p0 = camera(SIZE, device)
    # the headline camera at the full budget: the very call render makes
    a = check_parity(f"headline camera {SIZE}x{SIZE}, {STEPS} steps",
                     q0, p0, STEPS, DELTA, 2, "3a", record)
    q0s, p0s = camera(64, device)
    for order in (2, 4):
        check_parity(f"64x64 camera, order {order}", q0s, p0s, 2000, 0.05,
                     order, "3b", record)

    golden_probes(device)
    launches, wall = main_path(device)

    phase(6, f"integration at phase 3a's shapes ({SIZE * SIZE} rays, "
             f"{STEPS} step budget): kernel {a['kernel_ms']:.3f} ms "
             f"({100 * a['kernel_ms'] / 1e3 / wall:.1f}% of the render's "
             f"warm wall time), eager twin {a['twin_ms']:.3f} ms")
    print(json.dumps({"kernels": [{
        "name": "fantasy_eqc",
        "route": "cuda",
        "source": "grtrace_torch/csrc/fantasy_eqc.cu",
        "replaces": "grtrace/engine/integrate_pallas.py:77",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in record),
        "ms": a["kernel_ms"],
        "plain_ms": a["twin_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
