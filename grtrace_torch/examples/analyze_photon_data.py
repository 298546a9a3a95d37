"""The photon-data analysis example on the port — the counterpart of
`examples/analyze_photon_data.py` (the reference's tests/analysis.ipynb
made executable).

Loads a photon_data.csv (pass a path) or renders the default scene to
produce one (64 x 64, 5,000 steps of 0.05: kernel B1 on the card, its
eager twin with --device cpu), prints the notebook's `df.head()` preview,
the reference's per-class photon summary, the per-class alpha0 and
final-radius statistics, and the shadow edge.

    python -m grtrace_torch.examples.analyze_photon_data [photon_data.csv]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np


def summarize(df) -> dict:
    """The reference's photon summary (main.py:147-155) and the per-class
    distributions of a photon_data.csv DataFrame; returns the class
    counts."""
    counts = df["collision"].value_counts().to_dict()
    total = len(df)
    print(f"\nPhoton summary ({total} rays):")
    for k in ("bh", "escape_bg", "escape_no_patch", "in_domain", "error"):
        if k in counts:
            print(f"  {k:16s} {counts[k]:8d}  "
                  f"({100.0 * counts[k] / total:.2f}%)")
    print("\nPer-class alpha0 (camera angle off optical axis, rad):")
    for k, grp in df.groupby("collision"):
        a = grp["alpha0"]
        print(f"  {k:16s} min {a.min():.4f}  median {a.median():.4f} "
              f" max {a.max():.4f}")
    print("\nPer-class final radius:")
    for k, grp in df.groupby("collision"):
        r = grp["final_r"]
        print(f"  {k:16s} min {r.min():.3f}  median {r.median():.3f} "
              f" max {r.max():.3f}")
    # the shadow edge: largest captured alpha0 against the smallest
    # escaping one
    if "bh" in counts and "escape_bg" in counts:
        cap_max = df[df.collision == "bh"]["alpha0"].max()
        esc_min = df[df.collision == "escape_bg"]["alpha0"].min()
        print(f"\nShadow edge: max captured alpha0 {cap_max:.5f} rad, "
              f"min escaped alpha0 {esc_min:.5f} rad")
    return counts


def render_default(out_dir: str, device="cuda") -> str:
    """photon_data.csv of the default scene (64 x 64, short budget) in
    out_dir; returns its path."""
    from ..engine.render import render
    from ..io.artifacts import save_photon_data
    from ..io.scene import IntegratorConfig, PatchConfig, SceneConfig

    scene = SceneConfig(size=64,
                        integrator=IntegratorConfig(steps=5000, delta=0.05),
                        patch=PatchConfig(), n_samples=0)
    tex = np.full((64, 64, 3), 200, np.uint8)
    res = render(scene, bg_array=tex, device=device)
    path = f"{out_dir}/photon_data.csv"
    save_photon_data(res, path)
    return path


def build_parser():
    p = argparse.ArgumentParser(description="photon_data.csv statistics")
    p.add_argument('csv', nargs='?', default=None,
                   help='a photon_data.csv (default: render one)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='render on the CUDA card (the default; exits with '
                        'a message when there is none) or on the CPU')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import pandas as pd
    import torch

    path = args.csv
    if path is None:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("grtrace_torch.examples.analyze_photon_data: "
                             "no CUDA device (torch.cuda.is_available() is "
                             "False); pass --device cpu to run on the CPU")
        print("no CSV given - rendering the default scene first...")
        path = render_default(tempfile.mkdtemp(prefix="grtrace_analyze_"),
                              device=args.device)
    df = pd.read_csv(path)
    print(f"loaded {path}: {len(df)} rows")
    print(df.head())  # the notebook's preview cell
    return summarize(df)


if __name__ == "__main__":
    main()
