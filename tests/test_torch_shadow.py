"""The shadow observables of the port (engine/shadow.py, cli/shadow.py)
against the JAX package's, on the CPU (kernel B5's eager twin; the card
runs `cli.shadow --numeric` through B5 in chip_smoke.py phase 46).

Tolerances: `analytic_boundary` and `shadow_metrics` are host float64 on
the same arithmetic (the Bardeen predicate through each package's
Kerr-Schild camera, numpy's polynomial roots) and must be equal exactly;
`numeric_boundary` (4 azimuths, 2000 steps, delta 0.15, order 2; the
CLI's three rounds, the first two of them a two-round fan) must land on
JAX's `backend="xla"` boundary (`integrate_batch_ksc`) bracket by
bracket: the two float32 twins differ by XLA's contracted
multiply-adds (ROADMAP Queue C), which flips no bisection sample here.

At most six tests a file: pytest-xdist's --dist loadfile hands out the
files with the most tests first, so a file this small runs after the
suite's long few-test files instead of ahead of them.
"""
import json
import os

import numpy as np
import pytest
import torch

from grtrace.engine import shadow as js
from grtrace_torch.cli import shadow as shadow_cli
from grtrace_torch.engine import shadow as ts

torch.set_num_threads(1)
# the numeric fan: --numeric-azimuths 4 at 2000 steps, delta 0.15, order 2
NUMERIC = dict(n_psi=4, steps=2000, delta=0.15, order=2, rounds=3)


@pytest.fixture(scope="module")
def numeric(tmp_path_factory):
    """cli.shadow --spin 0.9 --numeric on the CPU (its CSV, JSON and
    return) and JAX's numeric_boundary on the same fan."""
    out = str(tmp_path_factory.mktemp("shadow"))
    m = shadow_cli.main([
        "--spin", "0.9", "--azimuths", "24", "--numeric",
        "--numeric-azimuths", "4", "--steps", "2000", "--delta", "0.15",
        "--order", "2", "--device", "cpu", "--out-dir", out])
    jax_fan = js.numeric_boundary(0.9, backend="xla", **NUMERIC)
    return out, m, jax_fan


def test_analytic_boundary_and_metrics_match_jax():
    """The closed-form critical curve of a = 0.9, Q = 0.3 and its shape
    metrics, equal to JAX's exactly."""
    psis, rho = ts.analytic_boundary(0.9, 0.3, n_psi=8)
    jpsis, jrho = js.analytic_boundary(0.9, 0.3, n_psi=8)
    assert np.array_equal(psis, jpsis) and np.array_equal(rho, jrho)
    assert ts.shadow_metrics(psis, rho) == js.shadow_metrics(jpsis, jrho)
    assert np.array_equal(ts.px_to_alpha_deg(rho), js.px_to_alpha_deg(rho))


def test_numeric_boundary_matches_jax_xla(numeric):
    """The real integrator's boundary through B5's twin (the CLI's
    numeric_boundary, its CSV at 8 significant digits) lands on JAX's XLA
    boundary, every azimuth's bracket the same."""
    out, m, (jpsis, jrho, jbracket) = numeric
    csv = np.genfromtxt(os.path.join(out, "shadow_boundary.csv"),
                        delimiter=",", names=True)
    rows = np.isfinite(csv["rho_numeric_px"])
    assert np.array_equal(csv["psi_rad"][rows],
                          np.array([float(f"{v:.8g}") for v in jpsis]))
    assert np.array_equal(csv["rho_numeric_px"][rows],
                          np.array([float(f"{v:.8g}") for v in jrho]))
    assert m["numeric_bracket_px"] == jbracket


def test_cli_writes_the_boundary_and_metrics(numeric):
    """shadow_boundary.csv (24 analytic rows with the numeric columns) and
    shadow_metrics.json, as tests/test_shadow_cli.py checks the JAX
    driver's."""
    out, m, _ = numeric
    assert m["numeric_px_err_max"] < 0.3
    csv = np.genfromtxt(os.path.join(out, "shadow_boundary.csv"),
                        delimiter=",", names=True)
    assert csv.size == 24 and np.isfinite(csv["rho_px"]).all()
    assert set(csv.dtype.names) == {"psi_rad", "rho_px", "alpha_deg",
                                    "rho_numeric_px", "px_err"}
    with open(os.path.join(out, "shadow_metrics.json")) as f:
        saved = json.load(f)
    assert saved["spin"] == 0.9
    assert saved["mean_diameter_px"] == m["mean_diameter_px"]


def test_unported_metrics_and_missing_matplotlib(monkeypatch, tmp_path):
    """The Kerr-de Sitter curves are ported (held against JAX in
    test_torch_kds_render_jax.py): the exact curve and one numeric
    bisection round at 2 azimuths bracket the same boundary, and
    cli.shadow --metric kerr-ds writes its metrics; a metric with no curve
    raises; --render without matplotlib exits with a message; the card is
    the default."""
    psis, rho = ts.analytic_boundary_kds(0.5, 1e-4, n_psi=2, rounds=3)
    _, nrho, bracket = ts.numeric_boundary(
        0.5, 1e-4, metric="KerrDS", device="cpu", n_psi=2, steps=900,
        delta=0.1, order=2, rounds=1)
    assert np.isfinite(rho).all() and np.isfinite(nrho).all()
    assert np.abs(nrho - rho).max() <= 2.0 * bracket
    m = shadow_cli.main(["--metric", "kerr-ds", "--spin", "0.5",
                         "--metric-param", "1e-4", "--azimuths", "4",
                         "--device", "cpu", "--out-dir", str(tmp_path)])
    assert m["metric"] == "kerr-ds" and m["mean_diameter_px"] > 0
    with pytest.raises(NotImplementedError, match="Kerr-de Sitter's only"):
        ts.numeric_boundary(0.5, metric="Kerr", device="cpu")
    from grtrace_torch.viz import plots
    monkeypatch.setattr(plots, "available", lambda: False)
    with pytest.raises(SystemExit, match="matplotlib"):
        shadow_cli.main(["--render", "--device", "cpu", "--out-dir",
                         str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        shadow_cli.main(["--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.numeric_boundary(0.9)
