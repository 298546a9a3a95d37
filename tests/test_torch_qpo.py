"""cli.qpo on the port (`--device cpu --no-plots --n 32`) against JAX's
`grtrace.cli.qpo.main` with the same arguments, for each of its four
branches: Kerr(-Newman), a static beyond-Kerr family, a rotating regular
family and Kerr-de Sitter.  JAX's four runs (about 50 s of eager autodiff
on the CPU in one process, whatever `--n`) run once, in a module-scoped
fixture, as four processes side by side (float64, on the CPU).

Tolerance: the CSV and the JSON line's numbers within 1e-10 relative.
nu_r is the square root of kappa^2, which vanishes at the ISCO (and at
Kerr-de Sitter's outermost stable orbit, the sweep's last row), where a
last-bit difference in kappa^2 is a difference of order one in nu_r (the
rotating family's ISCO row: 0 here, 3.7e-5 Hz in JAX): nu_r is held
through nu_r^2 within 1e-10 of its largest value, and nu_periastron
through (nu_phi - nu_periastron)^2 = nu_r^2 the same way (ROADMAP Queue
C).  Equal NaNs compare equal (Hayward's ISCO row has nu_r = NaN in
both).  The Kerr-de Sitter run holds the ISCO (the JSON line), the OSCO
(the last row's r) and the epicyclic frequencies (the CSV) against JAX's.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from grtrace_torch.cli import qpo as tqpo

RUNS = {
    "kerr": ["--spin", "0.9", "--preset", "grs1915"],
    "hayward": ["--metric", "hayward", "--metric-param", "0.5", "--preset",
                "grs1915"],
    "rotating-bardeen": ["--metric", "rotating-bardeen", "--spin", "0.9",
                         "--metric-param", "0.2", "--preset", "grs1915"],
    "kerr-ds": ["--metric", "kerr-ds", "--spin", "0.8", "--metric-param",
                "1e-4", "--mass-msun", "10"]}
COMMON = ["--n", "32"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MAIN = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            "from grtrace.cli import qpo; qpo.main(sys.argv[1:])")
KEYS = ("r_32_resonance_over_M", "nu_32_upper", "nu_32_lower",
        "r_isco_over_M", "nu_phi_isco", "nu_r_max", "r_nu_r_max_over_M")


def _rel(a, b):
    if a is None or b is None:
        return 0.0 if a is b else math.inf
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """grtrace.cli.qpo.main for each family: its CSV header and rows and
    its metrics (the JSON line it prints)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", JAX_MAIN, *argv, *COMMON, "--out-dir",
         str(tmp_path_factory.mktemp(f"jax_qpo_{name}"))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, argv in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, (name, stderr[-2000:])
            m = json.loads(stdout.strip().splitlines()[-1])
            with open(m["csv"]) as f:
                header = f.readline().strip()
            out[name] = (header, np.loadtxt(m["csv"], delimiter=",",
                                            skiprows=1), m)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_qpo_matches_jax(name, jax_runs, tmp_path, capsys):
    """The port's CSV (header and every row) and its JSON line (printed
    and returned) against JAX's run with the same arguments."""
    m = tqpo.main(RUNS[name] + COMMON + ["--device", "cpu", "--no-plots",
                                         "--out-dir", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(m))
    header, jtab, jm = jax_runs[name]
    with open(m["csv"]) as f:
        assert f.readline().strip() == header
    tab = np.loadtxt(m["csv"], delimiter=",", skiprows=1)
    assert tab.shape == jtab.shape == (32, 6)
    assert np.array_equal(np.isnan(tab), np.isnan(jtab))
    a, b = np.nan_to_num(tab), np.nan_to_num(jtab)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
    # nu_r through its square; nu_periastron as nu_phi - nu_periastron =
    # nu_r, the same way
    for col, ar, br in ((2, a[:, 2], b[:, 2]),
                        (4, a[:, 1] - a[:, 4], b[:, 1] - b[:, 4])):
        rel[:, col] = np.abs(ar ** 2 - br ** 2) / (br ** 2).max()
    assert rel.max() <= 1e-10, (name, np.unravel_index(rel.argmax(),
                                                       rel.shape))
    for k in KEYS:
        assert _rel(m[k], jm[k]) <= 1e-10, (name, k, m[k], jm[k])
    for k in ("unit", "metric", "metric_param", "spin", "charge",
              "prograde", "mass_msun"):
        assert m[k] == jm[k], k
    assert m["png"] is None


def test_qpo_refusals_and_device(tmp_path):
    """A hole with no QPO band exits as JAX's does, a naked Kerr-Newman
    singularity too; without a card the default --device exits with a
    message."""
    import torch
    with pytest.raises(SystemExit, match="no stable circular orbits"):
        tqpo.main(["--metric", "kerr-ds", "--spin", "0.8", "--metric-param",
                   "0.01", "--device", "cpu", "--no-plots", "--out-dir",
                   str(tmp_path)])
    with pytest.raises(SystemExit, match="naked singularity"):
        tqpo.main(["--spin", "0.9", "--charge", "0.6", "--device", "cpu",
                   "--no-plots", "--out-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            tqpo.main(["--no-plots", "--out-dir", str(tmp_path)])
