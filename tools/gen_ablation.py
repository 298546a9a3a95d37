"""Time the kernels of grtrace_torch/csrc/fantasy_gen.cu (G1, S2, and the
rotating and Kerr-de Sitter charts' G1r, D2, S2r, G1d) in several copies
of the package, in turns, on one NVIDIA GPU.

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
  * chip_smoke.py phase 57's three rotating frames (G1r: the 1024x1024
    rotating-Bardeen frame, the 256x256 float64 rotating-Hayward one and
    the horizonless 256x256 one), phase 62's three Kerr-de Sitter frames
    (G1d: 1024x1024, 256x256 float64, Lambda = 0 at 256x256), the 512x512
    rotating-Bardeen disk of phase 59 (D2) and its README 256x256 disk at
    the same budget, and phase 48's first static frame (G1s): each through
    its wrapper (kernel+wrapper, median of 5) on the render's rays, and S2r
    on the 20 rays of the rotating frame that the render samples;
  * the launch-order comparison on each of those rotating, Kerr-de Sitter
    and disk frames: the bare launch (median of 3) with the rays in three
    orders: sorted by the wrapper's cost key, in frame order, and the
    sorted warps dealt round-robin over the blocks (block b takes sorted
    warps b, b + B, b + 2 B, b + 3 B of B blocks; chip_smoke.dealt),
    beside the cost key's sort and the rays' gather alone (the rest of
    the wrapper's time is its read-out and rescue);
  * a digest of the outputs of G1, each S2, G1r, G1d, D2, S2r and G1s.

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
    frames, orders, digest = other_charts(sm, tgc, device)
    return {"root": root, "ptxas": _ptxas(build, lib), "occupancy": occ,
            "sass": sass, "sweep": sweep,
            "wrapper_ms": {"G1": g1_ms, "S2_BL": s2_ms["Kerr"],
                           "S2_KS": s2_ms["KerrSchild"]},
            "frame": {"ray_steps": int(n_steps.long().sum()),
                      "longest_ray": int(n_steps.max()),
                      "status_counts": torch.bincount(
                          status.long(), minlength=4).tolist()},
            "a0": a0, "frames": frames, "orders": orders,
            "digest": {"G1": _digest(g1), "S2_BL": _digest(s2["Kerr"]),
                       "S2_KS": _digest(s2["KerrSchild"]), **digest}}


def other_charts(sm, tgc, device):
    """The rotating, Kerr-de Sitter, disk and static frames' wrapper times
    and launch orders ({label: record}, {label: {order: ms}}) and their
    digests."""
    import numpy as np
    import torch
    import grtrace_torch as gt
    from grtrace_torch.cli.args import parse_args, scene_from_args
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.engine.integrate_ks_cuda import _cost_sort_key_ks
    from grtrace_torch.engine.render import ROTATING_NAMES, STATIC_NAMES
    from grtrace_torch.io.textures import starfield
    from grtrace_torch.physics.rotating_orbits import \
        rotating_disk_inner_edge
    from grtrace_torch.physics.rotating_regular import MASS_FN
    tex = starfield()
    frames, orders, digest = {}, {}, {}
    dealt = _smoke(HERE).dealt  # this checkout's, for every ROOT alike

    def rays(res):
        return (res.device("q0").reshape(-1, 4).contiguous(),
                res.device("p0").reshape(-1, 4).contiguous())

    def order_times(label, q0, p0, vec, family, steps, launch):
        key_fn = (_cost_sort_key_ks if family in MASS_FN
                  else tgc._cost_sort_key_bl)

        def sort_and_gather():
            idx = torch.argsort(key_fn(q0, p0, float(vec[0])), stable=True)
            return idx, q0[idx].contiguous(), p0[idx].contiguous()
        (srt, _, _), sort_ms = _median_ms(sort_and_gather, device, reps=3)
        cand = {"sorted": srt, "frame": torch.arange(q0.shape[0],
                                                     device=q0.device),
                "dealt": dealt(srt)}
        out = {}
        for name, idx in cand.items():
            q, p = q0[idx].contiguous(), p0[idx].contiguous()
            _, out[name] = _median_ms(lambda: launch(q, p, vec, steps),
                                      device, reps=3)
        orders[label] = {"rays": q0.shape[0], "ms": out,
                         "sort_and_gather_ms": sort_ms}

    gen = [(f"G1r {m} {p} {n} {d}", sm.rot_scene(m, p, n, d),
            ROTATING_NAMES[m], (sm.MASS, sm.ROT_SPIN, p))
           for m, p, n, d in ((*sm.ROT_FRAME, sm.KERR_SIZE, "float32"),
                              (*sm.ROT_F64, sm.ROT_SMALL, "float64"),
                              (*sm.ROT_HORIZONLESS, sm.ROT_SMALL,
                               "float32"))]
    gen += [(f"G1d {lam} {n} {d}", sm.kds_scene(lam, n, d), "KerrDS",
             (sm.MASS, sm.KDS_SPIN, lam))
            for lam, n, d in ((sm.KDS_LAMBDA, sm.KERR_SIZE, "float32"),
                              (sm.KDS_LAMBDA, sm.KDS_SMALL, "float64"),
                              (0.0, sm.KDS_SMALL, "float32"))]
    for label, scene, family, params in gen:
        q0, p0 = rays(gt.render(scene, bg_array=tex, device="cuda"))
        out, ms = _median_ms(lambda: tgc.integrate_batch_generic_cuda(
            q0, p0, sm.KERR_STEPS, sm.KERR_DELTA, params, sm.R_MAX,
            sm.OMEGA, metric=family), device)
        frames[label] = {"ms": ms, "rays": q0.shape[0],
                         "ray_steps": int(out[3].long().sum()),
                         "longest_ray": int(out[3].max())}
        digest[label] = _digest(out)
        vec = tig.gen_params(family, sm.KERR_DELTA, params, sm.R_MAX,
                             sm.OMEGA, 2, q0.dtype)
        order_times(label, q0, p0, vec, family, sm.KERR_STEPS,
                    lambda q, p, v, n: tgc.launch_fantasy_gen(q, p, v, n,
                                                              family))
        if label.startswith("G1r") and q0.shape[0] == sm.KERR_SIZE ** 2:
            idx = torch.as_tensor(np.random.default_rng(0).choice(
                q0.shape[0], size=N_SAMPLES, replace=False), device=device)
            qs, ps = q0[idx].contiguous(), p0[idx].contiguous()
            s2r, ms = _median_ms(lambda: tgc.trajectory_batch_decimated_cuda(
                qs, ps, sm.KERR_STEPS, sm.KERR_DELTA, params, sm.R_MAX,
                sm.OMEGA, metric=family, n_keep=sm.TRAJ_POINTS,
                return_steps=True), device)
            frames["S2r"] = {"ms": ms, "rays": N_SAMPLES,
                             "longest_ray": int(s2r[1].max())}
            digest["S2r"] = _digest(s2r)
    # D2: the 512x512 rotating-Bardeen disk and the README's 256x256 one
    params = (sm.MASS, sm.ROT_SPIN, 0.2)
    r_in = rotating_disk_inner_edge("RotatingBardeen", sm.MASS, sm.ROT_SPIN,
                                    0.2)
    for size in (sm.DISK_SIZE, sm.ROT_SMALL):
        label = f"D2 {size}"
        q0, p0 = rays(gt.render_disk(
            sm.rot_scene("rotating-bardeen", 0.2, size, steps=sm.DISK_STEPS,
                         delta=sm.DISK_DELTA),
            gt.DiskConfig(), bg_array=tex, device="cuda"))
        out, ms = _median_ms(lambda: tgc.integrate_batch_disk_spin_cuda(
            q0, p0, sm.DISK_STEPS, sm.DISK_DELTA, params, sm.R_MAX, sm.OMEGA,
            r_in, 14.0, metric="RotatingBardeen"), device)
        frames[label] = {"ms": ms, "rays": q0.shape[0],
                         "ray_steps": int(out[3].long().sum()),
                         "hits": int((out[2] == 3).sum())}
        digest[label] = _digest(out)
        vec = tig.disk_spin_params(tig.gen_params(
            "RotatingBardeen", sm.DISK_DELTA, params, sm.R_MAX, sm.OMEGA, 2,
            q0.dtype), r_in, 14.0)
        order_times(label, q0, p0, vec, "RotatingBardeen", sm.DISK_STEPS,
                    lambda q, p, v, n: tgc.launch_fantasy_gen_disk_spin(
                        q, p, v, n, "RotatingBardeen"))
    # G1s: phase 48's first static frame
    metric, param = sm.STATIC_FRAMES[0]
    scene = scene_from_args(parse_args(["--metric", metric, "--metric-param",
                                        str(param)] + sm.STATIC_ARGV))
    q0, p0 = rays(gt.render(scene, bg_array=tex, seed=0, device="cuda"))
    out, ms = _median_ms(lambda: tgc.integrate_batch_generic_cuda(
        q0, p0, sm.STEPS, sm.DELTA, (sm.MASS, param, 0.0), sm.R_MAX,
        sm.OMEGA, metric=STATIC_NAMES[metric]), device)
    frames[f"G1s {metric} {param}"] = {"ms": ms, "rays": q0.shape[0]}
    digest[f"G1s {metric} {param}"] = _digest(out)
    return frames, orders, digest



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
               os.path.abspath(root)]  # the child runs in this checkout
        if a.sass:
            cmd += ["--sass", os.path.abspath(a.sass)]
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
            "root", "wrapper_ms", "digest", "frame", "against_first",
            "frames", "orders")}), flush=True)
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
