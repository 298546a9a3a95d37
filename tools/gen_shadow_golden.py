"""Generate the float64 golden of `cli.shadow --spin 0.9 --numeric`'s
boundary from the JAX package, on the CPU.

Runs `grtrace.engine.shadow.numeric_boundary` with the CLI's numeric
defaults (16 azimuths, three bisection rounds of 9 rays, 8000 steps,
delta 0.02, order 4) through its XLA branch in float64, and stores the
azimuths, the boundary radii (256-image pixels), the final bracket and
Bardeen's analytic radii at the same azimuths in
tests/golden/shadow_numeric_a09_f64.json.  `chip_smoke.py` phase 46 holds
the port's float64 boundary on the card (kernel B5's 16-row double layout)
to these radii exactly: the bisection's radii are binary fractions on a
fixed grid, so two integrators that classify every probe ray alike give
the same radii bit for bit.

Run from the repo root (forces CPU + float64 itself; about 20 s):
    python tools/gen_shadow_golden.py

Imports JAX and the JAX package: a CPU-only reference, not part of the
port.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from grtrace.engine.shadow import (analytic_boundary,  # noqa: E402
                                   numeric_boundary)

OUT = os.path.join(ROOT, "tests", "golden", "shadow_numeric_a09_f64.json")
# cli.shadow's numeric defaults (grtrace/cli/shadow.py)
SPIN, CHARGE, N_PSI, STEPS, DELTA, ORDER = 0.9, 0.0, 16, 8000, 0.02, 4


def main():
    psis, rho, bracket = numeric_boundary(
        SPIN, CHARGE, n_psi=N_PSI, steps=STEPS, delta=DELTA, order=ORDER,
        backend="xla", dtype=jnp.float64)
    _, ana = analytic_boundary(SPIN, CHARGE, N_PSI)
    golden = {
        "source": "grtrace.engine.shadow.numeric_boundary, backend 'xla', "
                  "float64, on the CPU (tools/gen_shadow_golden.py)",
        "spin": SPIN, "charge": CHARGE, "n_psi": N_PSI, "steps": STEPS,
        "delta": DELTA, "order": ORDER,
        "psi_rad": np.asarray(psis).tolist(),
        "rho_px": np.asarray(rho).tolist(),
        "bracket_px": float(bracket),
        "rho_analytic_px": np.asarray(ana).tolist()}
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
    err = np.asarray(rho) - np.asarray(ana)
    print(f"wrote {OUT}: boundary - analytic per azimuth (px) "
          f"{np.round(err, 4).tolist()}")


if __name__ == "__main__":
    main()
