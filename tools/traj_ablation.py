"""Time the trajectory recorder S1 and kernel B3 (grtrace_torch/csrc/
fantasy_schw16.cu; S1 in grtrace_torch/csrc/fantasy_traj.cu in trees that
still have it) in several copies of the package, in turns, on one NVIDIA
GPU.

    python3 tools/traj_ablation.py ROOT [ROOT ...] [--new-bits ROOT ...]
                                   [--out FILE] [--sass DIR]

Each ROOT is a directory that holds a `grtrace_torch` package and its
`chip_smoke.py` (a checkout, or an unpacked `git archive` of one); naming a
ROOT twice runs it twice, so that a comparison runs parent, change,
change, parent.  Each ROOT runs in a process of its own, which imports
grtrace_torch and the helpers of chip_smoke.py from ROOT, builds ROOT's
kernels and prints one JSON line:

  * ptxas's registers and spilled bytes of every S1 and B3 instantiation,
    and their SASS counts (instructions and MUFU in the function and in
    its two longest loops, the first being the step loop);
  * S1 through `integrate_batch_full_cuda` (kernel+wrapper, CUDA events,
    the median and each of 5 calls after a warm-up) on the four callers'
    rays: the CLI's 20 samples of the 400x400 headline frame (200k steps,
    1000 points, float32; the render with seed 0 picks them, and its
    `sample_trajectories` stage with its parts is reported), the
    single-ray driver's float64 ray (every step kept), order 4 on 16 rays
    of the 64x64 camera (3000 steps, delta 0.05, 100 points) and the band
    sweep's 50 rays (30k steps, 500 points);
  * the longest ray's steps of each and the single-chain floor beside it
    (`metrics.chain_floor_ms` at the card's maximum SM clock, where the
    tree has it);
  * B3 through `integrate_batch_generic_cuda` on the 400x400 float64
    headline rays at 200k steps (the launch of chip_smoke.py's phase 23),
    median of 5, and its bare launch on a quarter, a half and all of them;
  * a digest of each S1 record and of B3's output.

The script fails unless every ROOT's B3 digest equals the first ROOT's and
its S1 digests equal the first ROOT's, except for the ROOTs named with
--new-bits (a change that rounds otherwise, in the twin as in the kernel),
whose S1 digests must equal each other's.  With --out, the records are
also written to FILE as JSON; with --sass, each ROOT's `cuobjdump -sass`
of its S1 and B3 libraries to DIR/<ROOT's last name>.sass.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1_CASES = ("cli", "single_ray", "order4", "band")
REPS = 5


def _smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _median_ms(fn, device):
    import numpy as np
    from grtrace_torch.engine.validate import timed
    out = fn()  # warm-up
    times = [timed(fn, device)[1] for _ in range(REPS)]
    return out, float(np.median(times)), times


def _libs(build):
    """{stem: library} of the sources that hold S1 or B3 in this tree."""
    return {stem: build.library_path(build.CSRC_DIR / f"{stem}.cu")
            for stem in ("fantasy_schw16", "fantasy_traj")
            if (build.CSRC_DIR / f"{stem}.cu").exists()}


def _s1_cases(sm, device):
    """{case: (q0, p0, steps, delta, rs, r_max, omega, n_keep, order)} on
    the card, and the CLI render's sample_trajectories stages."""
    import grtrace_torch
    import numpy as np
    import torch
    from grtrace_torch.cli import band_sweep, single_ray
    from grtrace_torch.cli.args import parse_args, scene_from_args
    from grtrace_torch.engine.metrics import RenderMetrics
    scene = scene_from_args(parse_args(sm.CLI_ARGV + ["--out-dir", "unused"]))
    grtrace_torch.render(scene, seed=0, device=device)  # warm-up
    rm = RenderMetrics()
    res = grtrace_torch.render(scene, seed=0, device=device, metrics=rm)
    flat = res.sampled_indices[:, 0] * sm.SIZE + res.sampled_indices[:, 1]
    if not np.array_equal(np.sort(flat), np.sort(
            np.random.default_rng(0).choice(sm.SIZE ** 2, sm.N_SAMPLES,
                                            replace=False))):
        raise SystemExit("the render sampled other rays than seed 0's")
    idx = torch.as_tensor(flat, device=device)
    cases = {"cli": (res.device("q0").reshape(-1, 4)[idx].contiguous(),
                     res.device("p0").reshape(-1, 4)[idx].contiguous(),
                     sm.STEPS, sm.DELTA, 2.0 * sm.MASS, sm.R_MAX, sm.OMEGA,
                     sm.TRAJ_POINTS, 2)}
    args = single_ray.build_parser().parse_args([])
    q1, p1 = single_ray.initial_state(args, device)
    cases["single_ray"] = (q1, p1, args.steps, args.delta, 2.0 * args.mass,
                           args.r_max, args.omega, None, 2)
    q4, p4 = sm.camera(64, device)
    cases["order4"] = (q4[::256].contiguous(), p4[::256].contiguous(), 3000,
                       0.05, 2.0 * sm.MASS, sm.R_MAX, sm.OMEGA, 100, 4)
    band = band_sweep.build_parser().parse_args([])
    qb, pb = band_sweep.band_rays(band.n_rays, band.seed, torch.float32,
                                  device)
    cases["band"] = (qb, pb, band.steps, band.delta,
                     2.0 * band_sweep.BH_MASS, band_sweep.BOUNDARY, 1.0,
                     band_sweep.N_KEEP, 2)
    stages = {k: v for k, v in rm.stages.items()
              if k.startswith("sample_trajectories")}
    return cases, stages


def one(root, sass_dir=None):
    """The record of the package under `root` (run in a fresh process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import grtrace_torch
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.engine import metrics
    from grtrace_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("traj_ablation: no CUDA device")
    pkg = os.path.dirname(os.path.abspath(grtrace_torch.__file__))
    if not pkg.startswith(root):
        raise SystemExit(f"grtrace_torch came from {pkg}, not from {root}")
    sm = _smoke(root)
    device = torch.device("cuda", 0)
    build.load()
    libs = _libs(build)
    ptxas, sass = {}, {}
    for stem, lib in libs.items():
        for k in build.ptxas_summary(lib.with_suffix(".log").read_text()):
            ptxas[k["kernel"]] = {"registers": k["registers"],
                                  "spill_stores": k["spill_stores"],
                                  "spill_loads": k["spill_loads"]}
        if sm._cuobjdump():
            sass.update({k: v for k, v in sm.sass_counts(lib).items()
                         if "kernel<" in k and "trig" not in k})
    if sass_dir and sm._cuobjdump():
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, f"{os.path.basename(root)}.sass"),
                  "w") as f:
            for lib in libs.values():
                f.write(subprocess.run([sm._cuobjdump(), "-sass", str(lib)],
                                       capture_output=True, text=True,
                                       check=True).stdout)
    clock = metrics.sm_clock_hz() if hasattr(metrics, "sm_clock_hz") else None
    cases, stages = _s1_cases(sm, device)
    s1 = {}
    for name, (q, p, steps, delta, rs, r_max, omega, n_keep,
               order) in cases.items():
        (traj, ns), ms, times = _median_ms(
            lambda: tc.integrate_batch_full_cuda(
                q, p, steps, delta, rs, r_max, omega, n_keep=n_keep,
                order=order, return_steps=True), device)
        longest = int(ns.max())
        floor = None
        if clock and hasattr(metrics, "chain_floor_ms"):
            floor = metrics.chain_floor_ms("fantasy_traj", longest, order,
                                           clock)
        s1[name] = {"ms": ms, "ms_all": times, "rays": q.shape[0],
                    "longest_ray": longest,
                    "ray_steps": int(ns.long().sum()),
                    "chain_floor_ms": floor,
                    "digest": _digest([traj, ns])}
    # B3 on the float64 headline rays (phase 23's launch)
    q64, p64 = sm.camera(sm.SIZE, device, torch.float64)
    b3, b3_ms, b3_all = _median_ms(
        lambda: tc.integrate_batch_generic_cuda(
            q64, p64, sm.STEPS, sm.DELTA, 2.0 * sm.MASS, sm.R_MAX, sm.OMEGA),
        device)
    sweep = sm.schw16_sweep(q64, p64, sm.STEPS, sm.DELTA)
    return {"root": root, "sm_clock_hz": clock, "ptxas": ptxas,
            "sass": sass, "s1": s1, "cli_stages_s": stages,
            "b3": {"ms": b3_ms, "ms_all": b3_all,
                   "bare_ms": {k: v["ms"] for k, v in sweep.items()},
                   "digest": _digest(b3)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--new-bits", nargs="*", default=[])
    ap.add_argument("--out")
    ap.add_argument("--sass")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.roots[0], a.sass)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    records, failed = [], []
    for root in a.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
        if a.sass:
            cmd += ["--sass", a.sass]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            failed.append(root)
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        records.append(rec)
        print(json.dumps({
            "root": root,
            "s1_ms": {c: v["ms"] for c, v in rec["s1"].items()},
            "s1_ms_all": {c: v["ms_all"] for c, v in rec["s1"].items()},
            "s1_longest_floor": {c: (v["longest_ray"], v["chain_floor_ms"])
                                 for c, v in rec["s1"].items()},
            "b3_ms": rec["b3"]["ms"], "b3_ms_all": rec["b3"]["ms_all"],
            "b3_bare_ms": rec["b3"]["bare_ms"],
            "cli_stages_s": rec["cli_stages_s"],
            "digest": {"b3": rec["b3"]["digest"],
                       **{c: v["digest"] for c, v in rec["s1"].items()}}}),
            flush=True)
        print(json.dumps({
            "root": root, "ptxas": rec["ptxas"],
            "sass_loops": {k: [(lp["instructions"], lp["mufu_by_kind"])
                               for lp in v["loops"]]
                           for k, v in rec["sass"].items()}}), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump({"card": smi, "records": records}, f, indent=1)
    new = [r for r in records if r["root"] in map(os.path.abspath,
                                                  a.new_bits)]
    old = [r for r in records if r not in new]

    def s1_digests(r):
        return [r["s1"][c]["digest"] for c in S1_CASES]
    differ = [r["root"] for group in (old, new) for r in group
              if s1_digests(r) != s1_digests(group[0])]
    differ += [r["root"] for r in records
               if r["b3"]["digest"] != records[0]["b3"]["digest"]]
    if failed or differ:
        raise SystemExit(f"traj_ablation: {failed} failed; {differ} compute "
                         f"other bits than the first of their group")
    return 0


if __name__ == "__main__":
    sys.exit(main())
