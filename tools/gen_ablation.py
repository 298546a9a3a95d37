"""Time the kernels of grtrace_torch/csrc/fantasy_gen.cu (G1, S2) in several
copies of the package, in turns, on one NVIDIA GPU.

    python3 tools/gen_ablation.py ROOT [ROOT ...] [--new-bits ROOT ...]
                                  [--out FILE] [--sass DIR]

Each ROOT is a directory that holds a `grtrace_torch` package and its
`chip_smoke.py` (a checkout, or an unpacked `git archive` of one); naming a
ROOT twice runs it twice, so that a comparison runs parent, change,
change, parent.  Each ROOT runs in a process of its own, which imports
grtrace_torch and the helpers of chip_smoke.py from ROOT, builds ROOT's
kernels and prints one JSON line:

  * ptxas's registers and spills, the resident blocks and warps per SM
    (blocks of 128 threads) and the local bytes of every fantasy_gen_kernel
    instantiation, and their SASS counts (instructions and MUFU in the
    function and in its two longest loops);
  * G1 on the full-width Boyer-Lindquist frame (chip_smoke.py's path 2:
    a = 0.9, 1024x1024, 30k steps, delta 0.02, float32): kernel+wrapper
    (`integrate_batch_generic_cuda`), median of 5, and the bare launch on
    a quarter, a half and all of the rays, in the order the wrapper
    launches them (chip_smoke.py's ray-count sweep, phase 35b);
  * S2 on the 20 rays that the render samples (numpy's default_rng(0)),
    in both charts, through `trajectory_batch_decimated_cuda`, median of 5;
  * phase 36's a = 0 frames (G1 beside the fast path, float64 and
    float32, with their gates);
  * a digest of G1's and each S2's outputs.

The script fails unless every ROOT's digests equal the first ROOT's,
except for the ROOTs named with --new-bits (a change that rounds
otherwise, in the twins as in the kernels), whose digests must equal each
other's.  Against the first ROOT, each record reports the statuses of
the frame that differ and the largest and median angle between the
escape directions of the rays that escape in both (and how many exceed
1e-6, 1e-3 and 0.1 rad): of its float32 frame against the first ROOT's,
and of both float32 frames against the first ROOT's float64 G1 on the
same rays, the reference that tells whether a change that rounds
otherwise moved the frame toward or away from it.  With --out, the
records are also written to FILE as JSON; with --sass, each ROOT's
`cuobjdump -sass` of fantasy_gen.cu to DIR/<ROOT's last name>.sass.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = os.path.join(HERE, "build", "gen_ablation")
N_SAMPLES = 20


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


def _median_ms(fn, device, reps=5):
    import numpy as np
    from grtrace_torch.engine.validate import timed
    out = fn()  # warm-up
    return out, float(np.median([timed(fn, device)[1] for _ in range(reps)]))


def _ptxas(build, lib):
    return {k["kernel"]: {"registers": k["registers"],
                          "spill_stores": k["spill_stores"],
                          "spill_loads": k["spill_loads"]}
            for k in build.ptxas_summary(lib.with_suffix(".log").read_text())
            if k["kernel"].startswith("fantasy_gen")}


def one(root, arrays, sass_dir=None):
    """The record of the package under `root` (run in a fresh process);
    G1's status and escape direction on the frame go to `arrays`."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import grtrace_torch
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine import integrate_generic_cuda as tgc
    from grtrace_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("gen_ablation: no CUDA device")
    pkg = os.path.dirname(os.path.abspath(grtrace_torch.__file__))
    if not pkg.startswith(root):
        raise SystemExit(f"grtrace_torch came from {pkg}, not from {root}")
    sm = _smoke(root)
    device = torch.device("cuda", 0)
    build.load()
    lib = build.library_path(build.CSRC_DIR / "fantasy_gen.cu")
    sm.OCC_KERNELS = {"fantasy_gen": sm.OCC_KERNELS["fantasy_gen"]}
    occ = sm.occupancy()
    sass = None
    if sm._cuobjdump():
        sass = sm.sass_counts(lib)
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            name = os.path.basename(root)
            with open(os.path.join(sass_dir, f"{name}.sass"), "w") as f:
                f.write(subprocess.run([sm._cuobjdump(), "-sass", str(lib)],
                                       capture_output=True, text=True,
                                       check=True).stdout)
    params = (sm.MASS, sm.KERR_SPIN, 0.0)
    args = (sm.KERR_STEPS, sm.KERR_DELTA, params, sm.R_MAX, sm.OMEGA)
    q0, p0 = sm.gen_camera(sm.KERR_SIZE, params)
    g1, g1_ms = _median_ms(
        lambda: tgc.integrate_batch_generic_cuda(q0, p0, *args), device)
    vec = tig.gen_params("Kerr", sm.KERR_DELTA, params, sm.R_MAX, sm.OMEGA,
                         2, q0.dtype)

    def prepare(q, p):
        if hasattr(tgc, "_sorted_rays"):  # launch in the wrapper's order
            _, q, p = tgc._sorted_rays(q, p, float(vec[0]))
        return lambda: tgc.launch_fantasy_gen(q, p, vec, sm.KERR_STEPS)
    sweep = sm.ray_sweep(prepare, q0, p0)
    final_q, _, status, n_steps = g1
    # the same rays in float64, the reference of both float32 records
    g1_64 = tgc.integrate_batch_generic_cuda(q0.double(), p0.double(), *args)

    def direction(q):
        th, ph = q[:, 2].double(), q[:, 3].double()
        return torch.stack([torch.sin(th) * torch.cos(ph),
                            torch.sin(th) * torch.sin(ph), torch.cos(th)],
                           1).cpu().numpy()
    np.savez(arrays, status=status.cpu().numpy().astype(np.int8),
             direction=direction(final_q),
             status64=g1_64[2].cpu().numpy().astype(np.int8),
             direction64=direction(g1_64[0]))
    # S2 on the render's samples, in both charts
    flat = np.random.default_rng(0).choice(sm.KERR_SIZE ** 2, size=N_SAMPLES,
                                           replace=False)
    idx = torch.as_tensor(flat, device=device)
    kq0, kp0 = sm.ks_camera(sm.KERR_SIZE, params, device)
    s2, s2_ms = {}, {}
    for metric, (q, p) in (("Kerr", (q0, p0)), ("KerrSchild", (kq0, kp0))):
        qs, ps = q[idx].contiguous(), p[idx].contiguous()
        s2[metric], s2_ms[metric] = _median_ms(
            lambda: tgc.trajectory_batch_decimated_cuda(
                qs, ps, *args, metric=metric, n_keep=sm.TRAJ_POINTS,
                return_steps=True), device)
    try:
        a0 = sm.bl_a0_phase()
    except AssertionError as err:
        a0 = {"gate_failed": str(err)}
    return {"root": root, "ptxas": _ptxas(build, lib), "occupancy": occ,
            "sass": sass, "sweep": sweep,
            "wrapper_ms": {"G1": g1_ms, "S2_BL": s2_ms["Kerr"],
                           "S2_KS": s2_ms["KerrSchild"]},
            "frame": {"ray_steps": int(n_steps.long().sum()),
                      "longest_ray": int(n_steps.max()),
                      "status_counts": torch.bincount(
                          status.long(), minlength=4).tolist()},
            "a0": a0,
            "digest": {"G1": _digest(g1), "S2_BL": _digest(s2["Kerr"]),
                       "S2_KS": _digest(s2["KerrSchild"])}}


def _angles(status_a, dir_a, status_b, dir_b):
    """The statuses that differ, and the largest and median angle (rad)
    between the escape directions of the rays that escape (status 2) in
    both, with how many exceed 1e-6, 1e-3 and 0.1."""
    import numpy as np
    both = (status_a == 2) & (status_b == 2)
    cos = np.clip((dir_a[both] * dir_b[both]).sum(1), -1.0, 1.0)
    angle = np.arccos(cos) if both.any() else np.zeros(1)
    return {"status_differs": int((status_a != status_b).sum()),
            "max_escape_angle_rad": float(angle.max()),
            "median_escape_angle_rad": float(np.median(angle)),
            "escape_angle_over": {f"{t:g}": int((angle > t).sum())
                                  for t in (1e-6, 1e-3, 1e-1)}}


def compare(arrays_a, arrays_b):
    """`_angles` of record b's float32 frame against record a's, and of
    each of the two against record a's float64 frame."""
    import numpy as np
    a, b = np.load(arrays_a), np.load(arrays_b)
    ref = (a["status64"], a["direction64"])
    return {"float32": _angles(a["status"], a["direction"], b["status"],
                               b["direction"]),
            "first_vs_float64": _angles(*ref, a["status"], a["direction"]),
            "this_vs_float64": _angles(*ref, b["status"], b["direction"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--new-bits", nargs="*", default=[])
    ap.add_argument("--out")
    ap.add_argument("--sass")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.roots[0], a.one, a.sass)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    os.makedirs(ARRAYS, exist_ok=True)
    records, failed = [], []
    for j, root in enumerate(a.roots):
        arrays = os.path.join(ARRAYS, f"{j}.npz")
        cmd = [sys.executable, os.path.abspath(__file__), "--one", arrays,
               root]
        if a.sass:
            cmd += ["--sass", a.sass]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            failed.append(root)
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["arrays"] = arrays
        if records:
            rec["against_first"] = compare(records[0]["arrays"], arrays)
        records.append(rec)
        print(json.dumps({k: rec.get(k) for k in (
            "root", "wrapper_ms", "digest", "frame", "against_first")}),
            flush=True)
        print(json.dumps({
            "root": root,
            "sweep_ms": {s: v["ms"] for s, v in rec["sweep"].items()},
            "ptxas": rec["ptxas"],
            "warps_per_sm": {k: v["warps_per_sm"]
                             for k, v in rec["occupancy"].items()},
            "local_bytes": {k: v["local_bytes"]
                            for k, v in rec["occupancy"].items()},
            "sass_loops": {k: [(lp["instructions"], lp["mufu_by_kind"])
                               for lp in v["loops"]]
                           for k, v in (rec["sass"] or {}).items()},
            "a0": {dt: ({"G1_only": v["bl_captured_not_fast_path"],
                         "pixels": [p["ij"] for p in v["bl_only_pixels"]]}
                        if isinstance(v, dict) else v)
                   for dt, v in rec["a0"].items()}}), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump({"card": smi, "records": records}, f, indent=1)
    new = [r for r in records if r["root"] in map(os.path.abspath,
                                                  a.new_bits)]
    old = [r for r in records if r not in new]
    differ = [r["root"] for group in (old, new) for r in group
              if r["digest"] != group[0]["digest"]]
    if failed or differ:
        raise SystemExit(f"gen_ablation: {failed} failed; {differ} compute "
                         f"other bits than the first of their group")
    return 0


if __name__ == "__main__":
    sys.exit(main())
