"""Boyer-Lindquist rays on the wrong side of the critical curve at a = 0,
in the port's generic engine and in the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python tools/bl_critical_gap.py [--dtype float32]
        [--groups inside edge outside polar] [--packages port jax]

Takes the 400x400 unfolded camera at r0 = 30 (fov 80 deg) of a
Schwarzschild hole in the Boyer-Lindquist chart, where a ray is captured
exactly when its impact parameter b is below b_crit = 3 sqrt(3) M, and
integrates through `grtrace_torch.engine.integrate_generic.
integrate_batch_generic(metric='Kerr')` (kernel G1's twin) and
`grtrace.engine.integrate_generic.integrate_batch_generic` at the Kerr
scene's budget (30000 steps, delta 0.02).  The groups of rays:

    inside   well inside the shadow, b < 0.98 b_crit
    edge     near its edge, |b / b_crit - 1| < 0.02
    outside  well outside it, b > 1.02 b_crit (the whole rest of the frame)
    polar    the outside rays of the two middle columns, whose orbits pass
             closest to the chart's pole (sin(theta_min) = |p_phi| / L)

Prints, as one JSON line per package, each group's rays whose verdict
disagrees with b, with a few of their pixels as [row, column, b / b_crit
- 1, status, sin(theta_min)].  JAX runs in the dtype asked for (x64 is
switched on for float64 only).  The port's eager twin on the outside
group's 155,332 rays takes over half an hour on the CPU; `--packages jax`
skips it (G1 on the card covers that frame: `chip_smoke.py` phase 36).

Imports JAX and the JAX package: a CPU-only comparison, not part of the
port.
"""
import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SIZE = 400


def _wrong(status, rel, sin_min, sel, name, n_show=8):
    st = np.asarray(status)
    capt = st == 1
    pred = rel[sel] < 0.0
    wrong = capt != pred
    return {f"{name}_rays": int(len(sel)),
            f"{name}_wrong": int(wrong.sum()),
            f"{name}_captured_beyond_critical": int((capt & ~pred).sum()),
            f"{name}_inside_not_captured": int((pred & ~capt).sum()),
            f"{name}_examples": [
                [int(sel[k]) // SIZE, int(sel[k]) % SIZE, float(rel[sel[k]]),
                 int(st[k]), float(sin_min[sel[k]])]
                for k in np.nonzero(wrong)[0][:n_show]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--groups", nargs="+", default=["inside", "edge"],
                    choices=("inside", "edge", "outside", "polar"))
    ap.add_argument("--packages", nargs="+", default=["port", "jax"],
                    choices=("port", "jax"))
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import jax.numpy as jnp
    import torch

    from grtrace.engine import integrate_generic as jig
    from grtrace_torch.engine import integrate_generic as tig
    from grtrace_torch.physics.camera import camera_rays_unfolded
    from grtrace_torch.physics.spacetime import kerr_g_inv

    dtype = getattr(torch, args.dtype)
    params = (1.0, 0.0, 0.0)
    q0, p0, _ = camera_rays_unfolded(
        torch.tensor([30.0, 0.0, 0.0], dtype=dtype),
        torch.tensor(math.radians(80.0), dtype=dtype), SIZE, SIZE,
        params=params, g_inv_fn=kerr_g_inv, dtype=dtype)
    q0, p0 = q0.reshape(-1, 4), p0.reshape(-1, 4)
    qd, pd = q0.double().numpy(), p0.double().numpy()
    ell = np.sqrt(pd[:, 2] ** 2 + pd[:, 3] ** 2 / np.sin(qd[:, 2]) ** 2)
    rel = ell / np.abs(pd[:, 0]) / (3.0 * math.sqrt(3.0)) - 1.0
    sin_min = np.abs(pd[:, 3]) / ell
    col = np.arange(SIZE * SIZE) % SIZE
    middle = (col == SIZE // 2 - 1) | (col == SIZE // 2)
    masks = {"inside": rel < -0.02, "edge": np.abs(rel) < 0.02,
             "outside": rel > 0.02, "polar": (rel > 0.02) & middle}
    groups = {g: np.nonzero(masks[g])[0] for g in args.groups}
    args_ = (30000, 0.02)
    for package in args.packages:
        out = {"package": package, "dtype": args.dtype}
        for name, sel in groups.items():
            if package == "port":
                st = tig.integrate_batch_generic(
                    q0[sel].contiguous(), p0[sel].contiguous(), *args_,
                    params, 31.0, 1.0)[2].numpy()
            else:
                jdt = jnp.float64 if args.dtype == "float64" else jnp.float32
                st = jig.integrate_batch_generic(
                    jnp.asarray(q0[sel].numpy()), jnp.asarray(p0[sel].numpy()),
                    *args_, jnp.asarray(params, jdt), 31.0, 1.0,
                    metric="Kerr")[2]
            out.update(_wrong(st, rel, sin_min, sel, name))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
