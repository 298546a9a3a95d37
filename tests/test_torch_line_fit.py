"""The line-profile fit and the multi-device drivers of the port on the
CPU: engine/sensitivity.gauss_newton_fit recovering an injected truth,
cli.fit_line, cli.line_grid and cli.orbit end to end at 16^2 (their
artifacts and result lines), and `sharding.mesh.dryrun_multichip(2)`
(two gloo ranks).

Tolerances: Gauss-Newton from half a coarse-grid cell away against data
the model itself made (JAX's fixed-point data: the same soft binning, so
the truth is an exact zero-residual point) lands within 1e-4 of the truth
in spin and elevation; the drivers are held to JAX's own test of
cli.fit_line (tests/test_fit_line.py: the grid's best point is the truth,
the residual norms never rise, positive Fisher errors and a correlation
inside (-1, 1)); the CSVs hold the results to their 8 printed digits, and
the orbit's frames equal the sharded renderer's at one rank.  cli.fit_line
is also held against JAX's driver on the same flags (its synthesized
observation and chi^2 grid): the chi^2 CSVs within 1e-6 relative (the
float64 profiles agree within 1e-10 of their largest bin, the CSVs print
8 digits), chi2_min within 1e-7 relative, the same best point, and the
parabolic refinement equal on the same losses.  The card runs the
drivers at their defaults (chip_smoke.py phases 54 and 55).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from grtrace_torch.cli import fit_line, line_grid, orbit
from grtrace_torch.engine import sensitivity as ts
from grtrace_torch.sharding import mesh as tm

torch.set_num_threads(1)

CENTERS = np.linspace(0.35, 1.25, 32)
# small budgets (300 steps of 0.2: the 16^2 disk camera's hits land well
# inside them; 78 of its 256 rays are still alive at the end)
KNOBS = dict(size=16, steps=300, delta=0.2, r_out=12.0)
CLI = ["--size", "16", "--steps", "300", "--delta", "0.2", "--device", "cpu",
       "--no-plots"]


def test_gauss_newton_recovers_truth():
    """Half a coarse-grid cell away from the truth, against data the model
    made (soft bins of 0.4 bin widths): Gauss-Newton walks back within
    1e-4, the residual norms never rise."""
    truth = np.array([0.7, 0.6])            # spin, elevation (rad)
    dg = CENTERS[1] - CENTERS[0]
    obs = ts.line_profile_model(truth, CENTERS, binning="soft",
                                sigma=0.4 * dg, normalize=False,
                                device="cpu", **KNOBS).numpy()
    start = truth + np.array([0.08, -0.05])
    theta, hist = ts.gauss_newton_fit(start, obs, CENTERS, n_iter=4,
                                      device="cpu", **KNOBS)
    assert abs(theta[0] - truth[0]) < 1e-4
    assert abs(theta[1] - truth[1]) < 1e-4
    rns = [h[2] for h in hist]
    assert len(rns) >= 3 and all(b <= a for a, b in zip(rns, rns[1:]))


def test_fit_line_cli(tmp_path):
    """cli.fit_line --synthesize on a 2 x 2 grid containing the truth, with
    one Gauss-Newton step and the Fisher errors."""
    out = str(tmp_path)
    m = fit_line.main(CLI + [
        "--synthesize", "0.7", "40", "--noise", "0.02", "--seed", "1",
        "--spins", "0.5", "0.7", "--inclinations", "40", "60",
        "--dtype", "float64", "--bins", "40", "--disk-r-out", "12",
        "--fisher", "--gauss-newton", "1", "--out-dir", out])
    assert m["spin_grid_best"] == 0.7 and m["inclination_grid_best"] == 40.0
    assert abs(m["spin_fit"] - 0.7) < 0.2
    assert abs(m["inclination_fit_deg"] - 40.0) < 10.0
    assert len(m["gn_residual_norms"]) == 1
    assert 0.0 < m["fisher_spin_err"] < 0.4
    assert 0.0 < m["fisher_incl_err_deg"] < 20.0
    assert -1.0 < m["fisher_correlation_spin_incl"] < 1.0
    assert np.linalg.det(np.asarray(m["fisher_matrix"])) > 0.0
    csv = np.genfromtxt(os.path.join(out, "fit_chi2.csv"), delimiter=",",
                        names=True)
    assert csv.size == 4
    k = np.argmin(csv["chi2"])
    assert csv["spin"][k] == 0.7 and csv["inclination_deg"][k] == 40.0
    assert not os.path.exists(os.path.join(out, "fit_map.png"))
    with pytest.raises(SystemExit, match="exactly one"):
        fit_line.main(["--out-dir", out, "--device", "cpu"])
    # JAX's driver on the same flags (its grid, no Gauss-Newton or Fisher
    # pass): the same synthesized observation, chi^2 grid and best point
    from grtrace.cli import fit_line as jax_fit_line
    jout = str(tmp_path / "jax")
    j = jax_fit_line.main(CLI[:6] + [
        "--synthesize", "0.7", "40", "--noise", "0.02", "--seed", "1",
        "--spins", "0.5", "0.7", "--inclinations", "40", "60",
        "--dtype", "float64", "--bins", "40", "--disk-r-out", "12",
        "--out-dir", jout])
    jcsv = np.genfromtxt(os.path.join(jout, "fit_chi2.csv"), delimiter=",",
                         names=True)
    for key in ("spin", "inclination_deg"):
        np.testing.assert_array_equal(csv[key], jcsv[key])
    np.testing.assert_allclose(csv["chi2"], jcsv["chi2"], rtol=1e-6)
    assert m["chi2_min"] == pytest.approx(j["chi2_min"], rel=1e-7)
    for key in ("spin_grid_best", "inclination_grid_best"):
        assert m[key] == j[key]
    # the parabolic refinement: an interior minimum, a flat and a
    # concave triple, an edge
    values = np.array([0.3, 0.5, 0.7])
    for losses, k in (([3.0, 1.0, 2.0], 1), ([1.0, 1.0, 1.0], 1),
                      ([1.0, 2.0, 1.5], 1), ([1.0, 2.0, 3.0], 0)):
        assert fit_line._parabolic_refine(values, losses, k) == \
            jax_fit_line._parabolic_refine(values, losses, k)


def test_line_grid_cli(tmp_path, capsys):
    """cli.line_grid with --fisher and --bench on two points: the CSVs
    (the Fisher columns those of the result), one JSON bench line."""
    out = str(tmp_path)
    res = line_grid.main(CLI + [
        "--spins", "0.5", "0.9", "--inclinations", "30", "--bins", "24",
        "--disk-r-out", "12", "--fisher", "0.01", "--bench", "--out-dir",
        out])
    rows = np.genfromtxt(os.path.join(out, "line_grid.csv"), delimiter=",",
                         names=True)
    assert rows.size == 2 * 24
    assert res["hist"].shape == (2, 1, 24) and res["hist"].max() > 0
    np.testing.assert_allclose(
        rows["relative_flux"].reshape(2, 24),
        res["hist"][:, 0] / res["hist"][:, 0].max(axis=1, keepdims=True),
        rtol=1e-7)
    fisher = np.genfromtxt(os.path.join(out, "fisher_grid.csv"),
                           delimiter=",", names=True)
    assert fisher.size == 2 and (fisher["sigma_spin"] > 0).all()
    np.testing.assert_allclose(fisher["sigma_spin"], res["fisher"][:, 0],
                               rtol=1e-7)
    np.testing.assert_allclose(fisher["correlation_spin_incl"],
                               -res["fisher"][:, 2], rtol=1e-7)
    bench = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert bench[-1]["metric"] == "line_grid_16_points_per_s"
    assert bench[-1]["grid_points"] == 2


def test_orbit_cli(tmp_path):
    """cli.orbit in its three modes (Schwarzschild, --metric kerr, --disk
    with a ZAMO camera): every frame a PNG, the frames of their own; the
    Schwarzschild frames those of the sharded renderer at one rank; a
    rerun resumes with nothing to do."""
    from grtrace_torch.io import textures
    modes = {"schwarzschild": [], "kerr": ["--metric", "kerr", "--spin",
                                           "0.9"],
             "disk": ["--disk", "--metric", "kerr", "--spin", "0.9",
                      "--camera-omega", "zamo"]}
    for name, mode in modes.items():
        out = str(tmp_path / name)
        argv = CLI + ["--frames", "2", "--out-dir", out] + mode
        res = orbit.main(argv)
        pngs = sorted(os.listdir(os.path.join(out, "frames")))
        assert pngs == ["frame_0000.png", "frame_0001.png"], name
        assert not np.array_equal(res["images"][0], res["images"][1]), name
        assert orbit.main(argv)["images"] == {}, name
    phis = (np.pi - 2.0 * np.pi * np.arange(2) / 2) % (2 * np.pi)
    want = tm.render_frames_sharded(
        tm.make_mesh(1, 1), textures.starfield(16, 16), np.full(2, 30.0),
        math.radians(80.0), 1.0, 31.0, 300, 0.2, 1.0, np.pi / 2, phis,
        np.pi, np.deg2rad(350.0), height=16, width=16, device="cpu")
    res = orbit.main(CLI + ["--frames", "2", "--out-dir",
                            str(tmp_path / "again")])
    for k in range(2):
        np.testing.assert_array_equal(res["images"][k],
                                      want["image"][k].numpy())


def test_dryrun_multichip_two_ranks(tmp_path):
    """The multi-frame renders over a 2-rank gloo mesh (2 x 1: two frame
    shards), equal to the one-rank render of the same frames."""
    got = tm.dryrun_multichip(2, workdir=str(tmp_path))
    assert got["image"].shape == (4, 16, 16, 3)
    assert got["cls"].shape == got["kerr_cls"].shape == (4, 16, 16)
    want = tm.render_frames_sharded(
        tm.make_mesh(1, 1), np.zeros((8, 8, 3), np.uint8), np.full(4, 30.0),
        math.radians(80.0), 1.0, 31.0, 64, 0.1, 1.0, math.pi / 2,
        np.pi + np.linspace(0, 1, 4), math.pi, 2 * math.pi, height=16,
        width=16, device="cpu")
    assert torch.equal(got["cls"], want["cls"])
