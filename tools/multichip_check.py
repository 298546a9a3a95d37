"""The port's multi-device modules (grtrace_torch/sharding) across the cards
of one host, held against the same calls in one process on one card.

    python tools/multichip_check.py --save ref.pt          # one card
    torchrun --nproc_per_node 4 tools/multichip_check.py --against ref.pt

(--device cpu --size 12 --steps 300 --delta 0.2 runs the same on the CPU,
gloo ranks under torchrun, at a size the CPU can take.)

Each run makes three calls at the drivers' defaults: the line-profile
sweep of cli.line_grid (4 x 4 points, 256^2, 20k steps of 0.02, float32,
kernel B6) on a 2 x 2 mesh, its Fisher map (kernel B6t, float64) on a
4 x 1 mesh (a point's camera whole on one rank), and cli.orbit's 16
Schwarzschild frames (256^2, 50k steps, kernel B1) on a 1 x 4 mesh (the
rays split); on one card every mesh is 1 x 1.  A torchrun job initializes
an nccl group from its environment, each rank on cuda:$LOCAL_RANK.  Rank 0
prints one JSON line: each call's wall (host clock, the cards synchronized,
warm: the second of two calls), the card's name and power limit, and with
--against the comparison with the saved one-card results: the frames and
the Fisher rows bit for bit, the histograms within 1e-5 of their largest
bin (the rays' partial sums added in another order).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from grtrace_torch.engine.metrics import card  # noqa: E402
from grtrace_torch.sharding import grid, mesh  # noqa: E402

SPINS = np.repeat([0.0, 0.5, 0.9, 0.998], 4)
ELEVS = np.deg2rad(90.0 - np.tile([15.0, 35.0, 55.0, 75.0], 4))


def calls(world, device, size, steps, delta):
    """{name: call} for a world of `world` ranks."""
    def shape(fs):
        return (fs, world // fs) if world > 1 else (1, 1)

    def sweep():
        return grid.line_profile_grid_sharded(
            mesh.make_mesh(*shape(min(2, world))), SPINS, ELEVS, 30.0,
            math.radians(80.0), 1.0, 0.0, 31.0, steps, delta, 1.0, 14.0,
            height=size, width=size, device=device)

    def fisher():
        return grid.fisher_grid_sharded(
            mesh.make_mesh(*shape(world)), SPINS, ELEVS, 0.01, size=size,
            steps=steps, delta=delta, n_bins=96, fov=math.radians(80.0),
            device=device)

    def orbit():
        from grtrace_torch.io.textures import starfield
        phis = (math.pi - 2 * math.pi * np.arange(16) / 16) % (2 * math.pi)
        return mesh.render_frames_sharded(
            mesh.make_mesh(1, world), starfield(size, size),
            np.full(16, 30.0), math.radians(80.0), 1.0, 31.0, 5 * steps // 2,
            delta, 1.0, math.pi / 2, phis, math.pi, math.radians(350.0),
            height=size, width=size, device=device)
    return {"sweep": sweep, "fisher": fisher, "orbit": orbit}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save", default=None, help="write the results here")
    p.add_argument("--against", default=None,
                   help="compare with the results saved here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=20_000,
                   help="the sweep's and the Fisher map's budget; the "
                        "orbit's is 2.5 times it (50,000 by default)")
    p.add_argument("--delta", type=float, default=0.02)
    args = p.parse_args(argv)
    mesh.init_distributed_from_env()
    rank, world, _ = mesh._world()
    device = mesh.rank_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out, walls = {}, {}
    for name, fn in calls(world, device, args.size, args.steps,
                             args.delta).items():
        fn()                                 # warm-up (kernels, caches)
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        out[name] = ({k: v.cpu() for k, v in res.items()}
                     if isinstance(res, dict) else res.cpu())
    line = {"world": world, "walls_s": walls,
            "card": card() if device.type == "cuda" else "cpu"}
    if args.against:
        ref = torch.load(args.against)
        hist, want = out["sweep"], ref["sweep"]
        line["compare"] = {
            "frames_bitwise": all(torch.equal(out["orbit"][k],
                                              ref["orbit"][k])
                                  for k in ("image", "cls", "n_steps")),
            "fisher_bitwise": bool(torch.equal(out["fisher"],
                                               ref["fisher"])),
            "hist_max_rel": float((hist - want).abs().max()
                                  / want.abs().max())}
    if rank == 0:
        if args.save:
            torch.save(out, args.save)
        print(json.dumps(line), flush=True)
    if args.against and rank == 0:
        c = line["compare"]
        ok = (c["frames_bitwise"] and c["fisher_bitwise"]
              and c["hist_max_rel"] <= 1e-5)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
