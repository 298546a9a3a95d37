"""The eager twins on the card, eager against replayed from CUDA graphs
(`chip_smoke.graphed_twins`): bit equality and seconds.

    python tools/twin_graph_probe.py

Runs each twin once eagerly and twice with `graphed_twins` on, on rays
of the frames `chip_smoke.py` holds (B5's 32-row order-4 twin on a
16-azimuth shadow fan; B1, B2 and B3 on 44x44 headline rays; B6 and B7
on 80x80 disk-camera rays; G1 on 87x87 unfolded Boyer-Lindquist rays;
S1, T1 and S2 on a few of them) and prints one JSON line per twin: the
eager seconds, the two graphed seconds (the first includes the capture)
and whether all three outputs are equal bit for bit.  Needs a CUDA
device; builds no kernel.
"""
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from grtrace_torch.engine import integrate as ti  # noqa: E402
from grtrace_torch.engine import integrate_generic as tg  # noqa: E402
from grtrace_torch.engine import integrate_ks as tks  # noqa: E402
from grtrace_torch.engine.shadow import fan_rays  # noqa: E402
from grtrace_torch.engine.validate import _bitwise_equal  # noqa: E402


def same(a, b):
    fa, _ = tree_flatten(a)
    fb, _ = tree_flatten(b)
    return all(_bitwise_equal(x, y) if isinstance(x, torch.Tensor)
               and x.is_floating_point() else
               (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
               for x, y in zip(fa, fb))


def timed(f):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = f()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    dev = "cuda"
    kerr = (1.0, 0.9, 0.0)
    psis = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    sq, sp = fan_rays(np.linspace(6.0, 40.0, 9)[None, :].repeat(16, 0),
                      psis, kerr, torch.float32, dev)
    hq, hp = cs.camera(44, dev)
    hq64, hp64 = cs.camera(44, dev, torch.float64)
    dq, dp = cs.disk_camera(80, dev)
    gq, gp = cs.gen_camera(87, kerr)
    kq, kp = cs.ks_camera(8, kerr, dev)
    cases = {
        "B5 32-row order 4, 144 rays, 400 steps": lambda:
            tks.integrate_batch_ksc(sq, sp, 400, 0.02, kerr, 50.0, 1.0,
                                    order=4),
        "B1, 1936 rays, 1000 steps": lambda:
            ti.integrate_batch_compensated(hq, hp, 1000, 0.01, 2.0, 31.0,
                                           1.0),
        "B2, 1936 rays, 1000 steps": lambda:
            ti.integrate_batch_eq(hq64, hp64, 1000, 0.01, 2.0, 31.0, 1.0),
        "B3 float64 order 4, 1936 rays, 300 steps": lambda:
            ti.integrate_batch_fused(hq64, hp64, 300, 0.01, 2.0, 31.0, 1.0,
                                     order=4),
        "B6, 6400 rays, 400 steps": lambda:
            tks.integrate_batch_disk_ksc(dq, dp, 400, 0.02, kerr, 31.0, 1.0,
                                         2.32, 14.0),
        "B7, 6400 rays, 400 steps": lambda:
            tks.integrate_batch_subrings_ksc(dq, dp, 400, 0.02, kerr, 31.0,
                                             1.0),
        "G1, 7569 rays, 400 steps": lambda:
            tg.integrate_batch_generic(gq, gp, 400, 0.02, kerr, 31.0, 1.0),
        "S1, 20 rays, 1000 steps": lambda:
            ti.integrate_batch_full(hq[:20], hp[:20], 1000, 0.01, 2.0, 31.0,
                                    1.0, n_keep=100),
        "T1, 1 ray, 1000 steps": lambda:
            ti.trajectory_unmasked(hq64[:1], hp64[:1], 1000, 0.01, 2.0, 1.0),
        "S2 BL, 20 rays, 1000 steps": lambda:
            tg.trajectory_batch_decimated(gq[:20], gp[:20], 1000, 0.02, kerr,
                                          31.0, 1.0, n_keep=100),
        "S2 KS, 20 rays, 1000 steps": lambda:
            tg.trajectory_batch_decimated(kq[:20], kp[:20], 1000, 0.02, kerr,
                                          31.0, 1.0, metric="KerrSchild",
                                          n_keep=100),
    }
    for name, f in cases.items():
        ref, eager_s = timed(f)
        with cs.graphed_twins():
            got, g1 = timed(f)
            got2, g2 = timed(f)
        print(json.dumps({"twin": name, "eager_s": round(eager_s, 3),
                          "graphed_s": [round(g1, 3), round(g2, 3)],
                          "bitwise": same(ref, got) and same(ref, got2)}),
              flush=True)
    print(json.dumps(cs.TWIN_GRAPHS))


if __name__ == "__main__":
    main()
