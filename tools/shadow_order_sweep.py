"""The a = 0.9 numeric shadow boundary's offset from Bardeen's curve per
azimuth, across step size, order and dtype, through the port.

    python tools/shadow_order_sweep.py [--device cuda|cpu]
        [--dtypes float64 float32] [--deltas 0.02 0.01 0.005 0.0025]
        [--orders 4 2]

Runs `grtrace_torch.engine.shadow.numeric_boundary` at `cli.shadow
--numeric`'s settings (16 azimuths, three bisection rounds of 9 rays)
with the step budget scaled as 8000 * 0.02 / delta, and prints one JSON
line per run: dtype, delta, order, seconds, and the boundary minus the
analytic radius at each azimuth (256-image pixels).  On the card the
rounds go through kernel B5 (32-row compensated layout for float32,
16-row plain for float64; built at first use); with --device cpu
through B5's eager twins (minutes per run).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from grtrace_torch.engine.shadow import (analytic_boundary,  # noqa: E402
                                         numeric_boundary)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtypes", nargs="+", default=["float64", "float32"])
    p.add_argument("--deltas", nargs="+", type=float,
                   default=[0.02, 0.01, 0.005, 0.0025])
    p.add_argument("--orders", nargs="+", type=int, default=[4, 2])
    args = p.parse_args(argv)
    _, ana = analytic_boundary(0.9, 0.0, 16)
    for name in args.dtypes:
        for delta in args.deltas:
            for order in args.orders:
                t0 = time.perf_counter()
                _, rho, bracket = numeric_boundary(
                    0.9, dtype=getattr(torch, name), device=args.device,
                    delta=delta, steps=int(round(8000 * 0.02 / delta)),
                    order=order)
                print(json.dumps({
                    "dtype": name, "delta": delta, "order": order,
                    "seconds": round(time.perf_counter() - t0, 2),
                    "bracket_px": bracket,
                    "px_minus_analytic": (rho - ana).round(4).tolist()}),
                    flush=True)


if __name__ == "__main__":
    main()
