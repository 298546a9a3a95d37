"""Throughput benchmark driver — the port's `grtrace.cli.bench_cli`: one
scene rendered `--iters` times after a warm-up, the fastest wall printed
as one JSON line.

    python -m grtrace_torch.cli.bench_cli
    python -m grtrace_torch.cli.bench_cli --size 3840 --iters 2
    python -m grtrace_torch.cli.bench_cli --size 256 --steps 20000 \\
        --delta 0.02 --metric kerr --spin 0.9 --disk
    python -m grtrace_torch.cli.bench_cli --device cpu --size 16 \\
        --steps 4000 --delta 0.05 --iters 1

The scene is the JAX driver's: `SceneConfig(size, background=None,
metric, spin, charge)` with `IntegratorConfig(steps, delta, omega=1.0,
backend, dtype)`, the full-sphere `PatchConfig()`, no sampled
trajectories, and a random sky (`default_rng(0)`, size x size x 3 uint8).
`render` routes it as `grtrace.render` does: Schwarzschild float32 to
kernel B1, float64 to B2, `--metric kerr` (and a charged Schwarzschild
scene) to B5 in the Kerr-Schild chart; `--disk` renders the thin disk
(`render_disk`, the default `DiskConfig()`) through B6 whatever the
metric.  Each timed iteration moves the observer out by (i+1) float32
ulps, as JAX's driver does, so the last iteration's counts are those of
the same scene in both packages.

The timed window is the render call: `render` and `render_disk` fetch
their count vector inside the call, after every launch of the frame on
the stream, and `main` synchronizes the card before it stops the
clock.  `warmup_s` is the first call, which builds the kernels when
`build/` is cold.  The line carries JAX's keys: `value` is the fastest
iteration (s), `vs_baseline` the 1 s a 400x400 frame scaled by the ray
count over `value`, `rays_per_s` and `geodesic_steps_per_s` are the last
iteration's rays and summed steps (int64) over `value`.

The scene runs on --device (the CUDA card by default, exiting with a
message when there is none; --device cpu runs the eager twins).
--backend takes the port's 'auto' | 'cuda' | 'torch' and JAX's 'pallas'
| 'xla' (mapped to 'cuda' | 'torch'); the line names the port's.  `main`
returns the line's dict.
"""
from __future__ import annotations

import argparse
import json
import time


def build_parser():
    p = argparse.ArgumentParser(
        description="grtrace_torch throughput benchmark")
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--delta", type=float, default=0.01)
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "cuda", "torch", "pallas", "xla"],
                   help="auto = the CUDA kernels on the card, the eager "
                        "twins on the CPU; cuda demands the kernels, torch "
                        "the twins (pallas and xla are their JAX names)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="run on the CUDA card (the default; exits with a "
                        "message when there is none) or on the CPU")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--metric", type=str, default="schwarzschild",
                   choices=["schwarzschild", "kerr"])
    p.add_argument("--spin", type=float, default=0.0)
    p.add_argument("--charge", type=float, default=0.0)
    p.add_argument("--disk", action="store_true",
                   help="benchmark the accretion-disk pipeline "
                        "(engine.disk, kernel B6)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the JSON line to this file")
    return p


def _jittered_distance(i):
    """30 moved out by i + 1 float32 ulps (survives the float32 cast)."""
    import numpy as np
    v = np.float32(30.0)
    for _ in range(i + 1):
        v = np.nextafter(v, np.float32(np.inf))
    return float(v)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.iters < 1:
        raise SystemExit("grtrace_torch.cli.bench_cli: --iters must be >= 1")
    from .line_grid import check_device
    check_device(args.device, "bench_cli")

    import numpy as np
    import torch

    from .. import (DiskConfig, IntegratorConfig, PatchConfig, SceneConfig,
                    render, render_disk)
    from ..io.scene import JAX_BACKENDS

    backend = JAX_BACKENDS.get(args.backend, args.backend)
    scene = SceneConfig(
        size=args.size, background=None, metric=args.metric,
        spin=args.spin, charge=args.charge,
        integrator=IntegratorConfig(steps=args.steps, delta=args.delta,
                                    omega=1.0, backend=backend,
                                    dtype=args.dtype),
        patch=PatchConfig(), n_samples=0)
    rng = np.random.default_rng(0)
    tex = rng.integers(0, 255, (args.size, args.size, 3), dtype=np.uint8)
    on_card = args.device == "cuda"

    def run():
        if args.disk:
            res = render_disk(scene, DiskConfig(), bg_array=tex,
                              device=args.device)
        else:
            res = render(scene, bg_array=tex, device=args.device)
        if on_card:
            torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    res = run()
    warm = time.perf_counter() - t0
    times = []
    for i in range(args.iters):
        scene.observer_distance = _jittered_distance(i)
        t0 = time.perf_counter()
        res = run()
        times.append(time.perf_counter() - t0)
    t = min(times)
    total_steps = int(res.device("n_steps").to(torch.int64).sum())
    # vs_baseline scales the 1 s a 400x400 frame by the ray count (the same
    # time a ray), so vs_baseline > 1 means faster at any size
    target_s = (args.size / 400.0) ** 2
    tag = "disk_" if args.disk else ""
    out = {
        "metric": f"render_{tag}{args.size}x{args.size}_wall_s",
        "value": round(t, 4),
        "unit": "s",
        "vs_baseline": round(target_s / t, 2),
        "steps_budget": args.steps,
        "metric_family": args.metric, "spin": args.spin,
        "backend": backend, "dtype": args.dtype,
        "warmup_s": round(warm, 2),
        "rays_per_s": round(args.size * args.size / t),
        "geodesic_steps_per_s": round(total_steps / t),
        "counts": res.counts,
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


def console(argv=None):
    """setuptools console-script entry (returns 0, not the dict, which
    sys.exit would print as an error)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
