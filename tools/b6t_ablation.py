"""Time the line-profile linearization (engine/sensitivity.py and kernel
B6t, the tangent modes of grtrace_torch/csrc/fantasy_ks.cu) in several
copies of the package, in turns, on one NVIDIA GPU.

    python3 tools/b6t_ablation.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a directory that holds a `grtrace_torch` package and its
`chip_smoke.py` (a checkout, or an unpacked `git archive` of one); naming a
ROOT twice runs it twice, so that a comparison runs parent, change,
change, parent.  Each ROOT runs in a process of its own, which imports
grtrace_torch and the helpers of chip_smoke.py from ROOT, builds ROOT's
kernels and prints one JSON line:

  * ptxas's registers and spills, the resident blocks and warps per SM
    and the local bytes of every fantasy_ks_kernel tangent instantiation;
  * one linearization (`line_profile_jacobian`) at a grid point of
    `cli.line_grid --fisher` (256x256, 20k steps of 0.02, float64) and of
    `cli.fit_line --fisher` (128x128, 12k steps of 0.03, float64): the
    host wall of the whole call (the card synchronized, median of 3), the
    disk loop's dispatches it made and their launches (B6, B6t with one
    direction, B6t with two), and each dispatch replayed on its own
    arguments and timed with CUDA events (median of 3), summed: the loop's
    kernel+wrapper time per linearization;
  * `cli.line_grid --fisher 0.01` and `cli.fit_line --synthesize 0.7 40
    --gauss-newton 2 --fisher` at their defaults, in-process (`--no-plots`):
    their walls (median of 3) and launches (a run's);
  * a digest of each linearization's profile and Jacobian, of the Fisher
    rows of cli.line_grid and of cli.fit_line's result.

The script fails unless every ROOT's digests equal the first ROOT's: the
redesign of B6t changes no bit of the Jacobian, the Fisher map or the
fit.  With --out, the records are also written to FILE as JSON.
"""
import argparse
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "b6t_ablation")
# one grid point of each driver's Fisher pass: (spin, inclination in
# degrees) and the driver's knobs (cli.line_grid's and cli.fit_line's
# defaults, float64 as the drivers run the Jacobian)
POINTS = {
    "line_grid_256": ((0.7, 45.0), dict(size=256, steps=20_000, delta=0.02,
                                        fov=math.radians(80.0), r_out=14.0),
                      (0.1, 1.6, 96)),
    "fit_line_128": ((0.7, 40.0), dict(size=128, steps=12_000, delta=0.03,
                                       r_out=14.0),
                     (0.1, 1.6, 64)),
}
DRIVERS = {
    "line_grid_fisher": ("line_grid", ["--fisher", "0.01", "--no-plots"]),
    "fit_line": ("fit_line", ["--synthesize", "0.7", "40", "--gauss-newton",
                              "2", "--fisher", "--no-plots"]),
}
COUNTERS = ("disk_launches", "disk_tangent_launches",
            "disk_tangent2_launches")


def _smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(arrays):
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes() if hasattr(a, "tobytes") else json.dumps(
            a, sort_keys=True, default=lambda x: np.asarray(x).tolist())
                 .encode())
    return h.hexdigest()[:16]


def _launches(ks):
    return {c: getattr(ks, c, None) for c in COUNTERS}


def _reset(ks):
    for c in COUNTERS:
        if hasattr(ks, c):
            setattr(ks, c, 0)


def one(root):
    """The record of the package under `root` (run in a fresh process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import grtrace_torch
    from grtrace_torch.engine import integrate_ks_cuda as ks
    from grtrace_torch.engine import sensitivity as tsens
    from grtrace_torch.engine.validate import timed
    from grtrace_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("b6t_ablation: no CUDA device")
    pkg = os.path.dirname(os.path.abspath(grtrace_torch.__file__))
    if not pkg.startswith(root):
        raise SystemExit(f"grtrace_torch came from {pkg}, not from {root}")
    sm = _smoke(root)
    device = torch.device("cuda", 0)
    build.load()
    lib = build.library_path(build.CSRC_DIR / "fantasy_ks.cu")
    ptxas = {k["kernel"]: {f: k[f] for f in ("registers", "spill_stores",
                                             "spill_loads")}
             for k in build.ptxas_summary(lib.with_suffix(".log").read_text())
             if ",3>" in k["kernel"] or ",4>" in k["kernel"]}
    sm.OCC_KERNELS = {"fantasy_ks": [k for k in sm.OCC_KERNELS["fantasy_ks"]
                                     if "Tangent" in k]}
    occ = sm.occupancy()
    rec = {"root": root, "ptxas": ptxas, "occupancy": occ,
           "linearization": {}, "drivers": {}, "digest": {}}
    for name, ((spin, incl), knobs, (g_lo, g_hi, bins)) in POINTS.items():
        theta = np.array([spin, math.radians(90.0 - incl)])
        half = 0.5 * (g_hi - g_lo) / bins
        centers = np.linspace(g_lo + half, g_hi - half, bins)
        calls = []

        def recording(fn):
            def wrapped(*args, **kw):
                calls.append((fn, args, kw))
                return fn(*args, **kw)
            return wrapped
        saved = (tsens.integrate_dispatch_disk,
                 tsens.integrate_dispatch_disk_tangent)
        tsens.integrate_dispatch_disk = recording(saved[0])
        tsens.integrate_dispatch_disk_tangent = recording(saved[1])
        try:
            _reset(ks)
            prof, jac = tsens.line_profile_jacobian(theta, centers,
                                                    device="cuda", **knobs)
            launches = _launches(ks)
        finally:
            tsens.integrate_dispatch_disk, \
                tsens.integrate_dispatch_disk_tangent = saved
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tsens.line_profile_jacobian(theta, centers, device="cuda",
                                        **knobs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        loop_ms = []
        for fn, args, kw in calls:
            fn(*args, **kw)  # warm
            loop_ms.append(float(np.median(
                [timed(lambda: fn(*args, **kw), device)[1]
                 for _ in range(3)])))
        rec["linearization"][name] = {
            "wall_s": float(np.median(walls)), "walls_s": walls,
            "launches": launches,
            "dispatches": [(f.__name__, tuple(getattr(a[2], "shape", ())))
                           for f, a, _ in calls],
            "dispatch_ms": loop_ms, "loop_ms": sum(loop_ms)}
        rec["digest"][name] = _digest([prof, jac])
    for name, (mod, argv) in DRIVERS.items():
        main = importlib.import_module(f"grtrace_torch.cli.{mod}").main
        out_dir = os.path.join(OUT, os.path.basename(root), name)
        walls = []
        for _ in range(3):
            _reset(ks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = sm.run_quiet(main, argv + ["--out-dir", out_dir])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rec["drivers"][name] = {"wall_s": float(np.median(walls)),
                                "walls_s": walls, "launches": _launches(ks)}
        if name == "line_grid_fisher":
            rec["digest"][name] = _digest([np.asarray(got["fisher"])])
        else:
            rec["digest"][name] = _digest([got])
            rec["drivers"][name]["result"] = got
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.roots[0])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    records, failed = [], []
    for root in a.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", os.path.abspath(root)],
                              capture_output=True, text=True, cwd=HERE)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            failed.append(root)
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump({"card": smi, "records": records}, f, indent=1)
    differ = [r["root"] for r in records
              if r["digest"] != records[0]["digest"]]
    if failed or differ:
        raise SystemExit(f"b6t_ablation: {failed} failed; {differ} compute "
                         f"other bits than the first")
    return 0


if __name__ == "__main__":
    sys.exit(main())
