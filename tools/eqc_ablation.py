"""Time the kernels of grtrace_torch/csrc/fantasy_eqc.cu (B1, B2, B4) in
several copies of the package, in turns, on one NVIDIA GPU.

    python3 tools/eqc_ablation.py ROOT [ROOT ...] [--out FILE] [--sass DIR]

Each ROOT is a directory that holds a `grtrace_torch` package (a checkout,
or an unpacked `git archive` of one); naming a ROOT twice runs it twice,
so that a comparison runs parent, change, change, parent.  Each ROOT runs
in a process of its own, which imports grtrace_torch from ROOT and the
helpers of this checkout's chip_smoke.py, builds ROOT's kernels and prints
one JSON line:

  * phase 2b's resident blocks per SM, registers and local bytes of every
    fantasy_eqc_kernel instantiation, and their SASS counts;
  * phase 3c's bare ray-count sweep (B1, B2, B4 on a quarter, a half and
    all of the headline rays);
  * kernel+wrapper times on the full headline rays, median of 5:
    `integrate_batch_cuda` (B1), `integrate_batch_eq_cuda` (B2) and
    `advance_state_eqc_cuda` for JOB_CHUNK steps on the carry that
    `integrate_chunked` opens (B4);
  * a digest of those three calls' outputs.

The script fails unless every ROOT's digests equal the first ROOT's: a
variant must compute bit for bit what the first does (chip_smoke.py holds
a tree's kernels bitwise against their eager twins).  With --out, the
records are also written to FILE as JSON; with --sass, each ROOT's
`cuobjdump -sass` of fantasy_eqc.cu to DIR/<ROOT's last name>.sass.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
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


def one(root, sass_dir=None):
    """The record of the package under `root` (run in a fresh process)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import grtrace_torch
    from grtrace_torch.engine import checkpoint as ck
    from grtrace_torch.engine import integrate_cuda as tc
    from grtrace_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("eqc_ablation: no CUDA device")
    pkg = os.path.dirname(os.path.abspath(grtrace_torch.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise SystemExit(f"grtrace_torch came from {pkg}, not from {root}")
    sm = _smoke()
    device = torch.device("cuda", 0)
    build.load()
    occ = {k: v for k, v in sm.occupancy().items()
           if k.startswith("fantasy_eqc")}
    sass = None
    lib = build.library_path(build.CSRC_DIR / "fantasy_eqc.cu")
    if sm._cuobjdump():
        sass = sm.sass_counts(lib)
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            name = os.path.basename(os.path.abspath(root))
            with open(os.path.join(sass_dir, f"{name}.sass"), "w") as f:
                f.write(subprocess.run([sm._cuobjdump(), "-sass", str(lib)],
                                       capture_output=True, text=True,
                                       check=True).stdout)
    q0, p0 = sm.camera(sm.SIZE, device)
    q0d, p0d = sm.camera(sm.SIZE, device, torch.float64)
    sweep = sm.eqc_sweep(q0, p0, q0d, p0d)
    args = (sm.STEPS, sm.DELTA, 2.0 * sm.MASS, sm.R_MAX, sm.OMEGA)
    b1, b1_ms = _median_ms(lambda: tc.integrate_batch_cuda(q0, p0, *args),
                           device)
    b2, b2_ms = _median_ms(
        lambda: tc.integrate_batch_eq_cuda(q0d, p0d, *args), device)
    opened = ck.start(q0, p0, *args, compensated=True)
    b4, b4_ms = _median_ms(lambda: tc.advance_state_eqc_cuda(
        opened.state, sm.JOB_CHUNK, *args[1:]), device)
    return {"root": root, "occupancy": occ, "sass": sass, "sweep": sweep,
            "wrapper_ms": {"B1": b1_ms, "B2": b2_ms, "B4": b4_ms},
            "digest": {"B1": _digest(b1), "B2": _digest(b2),
                       "B4": _digest(b4)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
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
        print(json.dumps({k: rec[k] for k in ("root", "wrapper_ms",
                                                "digest")}), flush=True)
        print(json.dumps({"root": root, "sweep_ms": {
            b: {s: v["ms"] for s, v in rec["sweep"][b].items()}
            for b in rec["sweep"]}, "occupancy": {
            k: (v["blocks_per_sm"], v["registers"], v["local_bytes"])
            for k, v in rec["occupancy"].items()}}), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump({"card": smi, "records": records}, f, indent=1)
    differ = [r["root"] for r in records
              if r["digest"] != records[0]["digest"]]
    if failed or differ:
        first = records[0]["root"] if records else None
        raise SystemExit(f"eqc_ablation: {failed} failed; {differ} compute "
                         f"other bits than {first}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
