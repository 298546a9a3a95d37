"""cli.fit_line's chi^2 grid at the driver's defaults, on the card and on the
CPU, held against each other.

    python tools/fit_line_witness.py [--out-dir DIR] [--threads N]

Both runs are `python -m grtrace_torch.cli.fit_line --synthesize 0.7 40
--no-plots` at the defaults (the 6 x 5 grid of spins 0, 0.25, 0.5, 0.7,
0.9, 0.998 and inclinations 15-75 degrees, 128^2, 12k steps of 0.03,
float32, 64 bins): the card's sweep runs kernel B6 (32 rows), the CPU's
the kernel's eager twin (--device cpu), so the CPU run says where the
model's chi^2 minimum lies at the defaults' size without the card.  The
script prints one JSON line: both result lines, both walls (host clock),
where each grid's minimum lies, the largest difference of the two chi^2
grids relative to the grid's largest value, the card's name and power
limit, and the threads of the CPU run.  Each run's fit_chi2.csv lands in
DIR/card and DIR/cpu.  The CPU run takes minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from grtrace_torch.cli import fit_line  # noqa: E402
from grtrace_torch.engine.metrics import card  # noqa: E402

ARGV = ["--synthesize", "0.7", "40", "--no-plots"]


def run(device, out_dir):
    """One fit_line run: (result, chi2 grid (spins, inclinations), wall)."""
    t0 = time.perf_counter()
    res = fit_line.main(ARGV + ["--device", device, "--out-dir", out_dir])
    wall = time.perf_counter() - t0
    csv = np.genfromtxt(os.path.join(out_dir, "fit_chi2.csv"), delimiter=",",
                        names=True)
    args = fit_line.build_parser().parse_args(ARGV)
    chi2 = np.asarray(csv["chi2"]).reshape(len(args.spins),
                                           len(args.inclinations))
    return res, chi2, wall


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default=os.path.join("chiprun_out",
                                                     "fit_line_witness"))
    p.add_argument("--threads", type=int, default=os.cpu_count(),
                   help="torch's CPU threads for the CPU run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fit_line_witness: no CUDA device")
    torch.set_num_threads(args.threads)
    out = {"card": card(), "argv": ARGV, "cpu_threads": args.threads}
    grids = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        res, chi2, wall = run(device, os.path.join(args.out_dir, name))
        grids[name] = chi2
        k = np.unravel_index(int(np.argmin(chi2)), chi2.shape)
        out[name] = {"result": res, "wall_s": wall,
                     "argmin_spin_incl_index": [int(k[0]), int(k[1])],
                     "chi2": chi2.tolist()}
    diff = np.abs(grids["card"] - grids["cpu"]).max()
    out["same_argmin"] = (out["card"]["argmin_spin_incl_index"]
                          == out["cpu"]["argmin_spin_incl_index"])
    out["chi2_max_diff_rel"] = float(diff / np.abs(grids["cpu"]).max())
    print(json.dumps(out))
    return 0 if out["same_argmin"] else 1


if __name__ == "__main__":
    sys.exit(main())
