"""The port's command-line pipeline against the JAX package's, on the CPU.

`grtrace_torch.cli.main --device cpu` and `grtrace.cli.main` run once each
(one module fixture) with the arguments of tests/test_cli_artifacts.py
(24x24, 3000 steps, delta 0.1, float64, a 32x32 file background, 4
samples) and --no-plots.  Tolerances, with their reasons:
  * photon_data.csv: i, j and collision exact; the launch state (headings,
    p0, alpha0) within 1e-12 (the same camera, last-ulp rounding); the
    final positions within 1e-6 (XLA contracts multiply-adds into FMAs and
    torch does not, ROADMAP Queue C; the gap grows over hundreds of steps);
  * sampled_rays.csv within 1e-9 (the same, on four rays);
  * the images and the summary counts exact.
The drivers' parts (flat renderer, writers, small drivers, flags,
unported options) are held in tests/test_torch_cli_drivers.py.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from grtrace_torch.cli import main as tmain
from grtrace_torch.io import artifacts as tart
from torch_cli_common import CLI_ARGS, background, read_csv  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, background):
    """(jax out dir, jax result, port out dir, port result, port stdout)."""
    from grtrace.cli.main import main as jax_main
    jout = tmp_path_factory.mktemp("jax_cli")
    tout = tmp_path_factory.mktemp("port_cli")
    jres = jax_main(CLI_ARGS + ["--background", background,
                                "--out-dir", str(jout)])
    tart.writes.update(native=0, python=0)
    buf = io.StringIO()
    with redirect_stdout(buf):
        tres = tmain.main(CLI_ARGS + ["--background", background,
                                      "--out-dir", str(tout), "--device",
                                      "cpu", "--print-metrics"])
    return jout, jres, tout, tres, buf.getvalue()


def test_cli_counts_and_summary(cli_runs):
    _, jres, _, tres, stdout = cli_runs
    assert tres.counts == {k: int(v) for k, v in jres.counts.items()}
    assert f"Captured by BH: {tres.counts['captured']}" in stdout
    metrics = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert '"sample_trajectories"' in metrics[0]  # --print-metrics
    assert not any('"roofline"' in ln for ln in metrics)  # no card here


def test_cli_photon_data(cli_runs):
    jout, _, tout, _, _ = cli_runs
    jh, j = read_csv(jout / "photon_data.csv")
    th, t = read_csv(tout / "photon_data.csv")
    assert th == jh == list(tart.PHOTON_COLUMNS) and t.shape == j.shape
    assert len(t) == 24 * 24
    col = {c: k for k, c in enumerate(jh)}
    for c in ("i", "j", "collision"):
        assert np.array_equal(t[:, col[c]], j[:, col[c]]), c
    for c, tol in (("final_r", 1e-6), ("final_th", 1e-6), ("final_ph", 1e-6),
                   ("h_r", 1e-12), ("h_theta", 1e-12), ("h_phi", 1e-12),
                   ("p0_t", 1e-12), ("p0_r", 1e-12), ("p0_th", 1e-12),
                   ("p0_ph", 1e-12), ("alpha0", 1e-12)):
        np.testing.assert_allclose(t[:, col[c]].astype(float),
                                   j[:, col[c]].astype(float), rtol=0,
                                   atol=tol, err_msg=c)


def test_cli_sampled_rays(cli_runs):
    jout, _, tout, tres, _ = cli_runs
    jh, j = read_csv(jout / "sampled_rays.csv")
    th, t = read_csv(tout / "sampled_rays.csv")
    assert th == jh == list(tart.SAMPLED_COLUMNS)
    assert t.shape == j.shape == (4 * 1000, 9)
    np.testing.assert_allclose(t.astype(float), j.astype(float), rtol=0,
                               atol=1e-9)
    # both files came from the native writer (g++ builds it here)
    assert tart.writes == {"native": 2, "python": 0}


@pytest.mark.parametrize("name", ["manual_output.png", "no_gravity.png",
                                  "scene_full.png"])
def test_cli_images(cli_runs, name):
    jout, _, tout, tres, _ = cli_runs
    t = np.array(Image.open(tout / "images" / name))
    assert np.array_equal(t, np.array(Image.open(jout / "images" / name)))
    assert np.array_equal(tart.read_png(str(tout / "images" / name)), t)
    if name == "manual_output.png":
        assert np.array_equal(t, tres.image)
