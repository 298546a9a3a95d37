"""The port's observable drivers against the JAX package, on the CPU:
`cli.subring --aa 2 --visibility --sed` (16x16, a = 0.9, 1500 steps of
0.1) against JAX's render_subrings, save_subring_maps and
subring_visibilities on the same scene (JAX's driver adds only the
photon-shell prediction, held in tests/test_torch_photon_shell.py, and
the figures); `cli.visibility` (its default disk scene at 16x16, 400
steps of 0.2) and `cli.hotspot --closure` (20x20, 6 frames: the closure
fan's longest leg needs a 40-point u-v grid) against JAX's drivers'
CSVs.  And `cli.main --aa 2` end to end on the headline and disk paths
(16x16): the refined pixels, the image it writes and its CSVs.

The drivers render in float32 (none has a --dtype flag), so the two
packages' renders differ in the last float32 bits.  Tolerances, with
their reasons:
  * aa_mask, the crossing counts and the emitting-layer masks: exact;
  * the subring tables (the delay map's rows, the summary's fluxes and
    delays, the per-order |V| profiles): rtol 1e-4 (float32 crossings);
  * cli.visibility: the images differ by at most 1 per channel, so |V|
    by at most 1e-3 and the closure phases by at most 1e-2 rad;
  * cli.hotspot --closure: the frames differ by at most 1 per channel;
    closure phases within 1e-2 rad.
"""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine import disk as jdisk
from grtrace.engine import subring as jsub
from grtrace_torch.cli import hotspot as thot_cli
from grtrace_torch.cli import main as tmain_cli
from grtrace_torch.cli import subring as tsub_cli
from grtrace_torch.cli import visibility as tvis_cli
from torch_cli_common import read_csv

torch.set_num_threads(1)

SUB_ARGS = ["--spin", "0.9", "--size", "16", "--orders", "3", "--steps",
            "1500", "--delta", "0.1", "--aa", "2", "--visibility", "--sed"]
VIS_ARGS = ["--size", "16", "--steps", "400", "--delta", "0.2"]
HOT_ARGS = ["--size", "20", "--steps", "400", "--delta", "0.2", "--metric",
            "kerr", "--spin", "0.9", "--frames", "6", "--closure",
            "--no-gif"]


def _quiet(fn, argv):
    with redirect_stdout(io.StringIO()):
        return fn(argv)


def _table(path):
    header, rows = read_csv(path)
    return header, rows.astype(np.float64)


@pytest.fixture(scope="module")
def subring(tmp_path_factory):
    """The port's driver, and JAX's engine on the driver's scene."""
    jout = tmp_path_factory.mktemp("jax_subring")
    tout = tmp_path_factory.mktemp("port_subring")
    m = _quiet(tsub_cli.main, SUB_ARGS + ["--out-dir", str(tout),
                                          "--device", "cpu", "--no-plots"])
    scene = SceneConfig(size=16, metric="kerr", spin=0.9, n_samples=0,
                        patch=PatchConfig(),
                        integrator=IntegratorConfig(steps=1500, delta=0.1))
    dc = jdisk.DiskConfig(elevation_deg=75.0, show_background=False)
    res = jsub.render_subrings(scene, dc, n_orders=3, aa_samples=2)
    _, summary = jsub.save_subring_maps(res, str(jout))
    vis = jsub.subring_visibilities(res, float(np.deg2rad(80.0)))
    return m, tout, res, summary, vis, jout


def test_cli_subring_matches_jax(subring):
    m, tout, res, summary, vis, jout = subring
    t = m["result"]
    np.testing.assert_array_equal(t.aa_mask, res["aa_mask"])
    assert t.aa_mask.sum() > 8
    for k in ("count", "valid"):
        np.testing.assert_array_equal(t[k], res[k])
    for k in ("flux_per_order", "delay_per_order_M"):
        np.testing.assert_allclose(m[k], summary[k], rtol=1e-4)
    with open(tout / "subring_summary.json") as f:
        own = json.load(f)
    assert own["max_crossings"] == summary["max_crossings"]
    np.testing.assert_allclose(own["flux_per_order"],
                               summary["flux_per_order"], rtol=1e-4)
    th, trows = _table(tout / "subring_delay_01.csv")
    jh, jrows = _table(jout / "subring_delay_01.csv")
    assert th == jh and len(trows) == len(jrows) > 0
    np.testing.assert_array_equal(trows[:, :2], jrows[:, :2])
    np.testing.assert_allclose(trows[:, 2:], jrows[:, 2:], rtol=1e-4)
    assert m["b_null_per_order"] == pytest.approx(
        [v["b_null"] for v in vis], rel=1e-4, nan_ok=True)
    th, trows = _table(tout / "subring_visibility.csv")
    pop = [v for v in vis if v["baselines"] is not None]
    assert th[0].endswith("baseline_per_rad") and len(th) == 1 + len(pop)
    np.testing.assert_allclose(trows[:, 0], pop[0]["baselines"],
                               rtol=1e-12)
    for k, v in enumerate(pop):
        np.testing.assert_allclose(trows[:, 1 + k], v["profile"],
                                   rtol=1e-4, atol=1e-6)
    assert (tout / "subring_sed.csv").exists()
    assert (tout / "subring_composite.png").exists()
    assert not list(tout.glob("*order_*.png"))       # --no-plots
    assert m["theory"]["gamma_min"] > 0


def test_cli_visibility_matches_jax(tmp_path):
    from grtrace.cli.visibility import main as jax_vis
    jm = _quiet(jax_vis, VIS_ARGS + ["--out-dir", str(tmp_path / "j")])
    tm = _quiet(tvis_cli.main, VIS_ARGS + ["--out-dir", str(tmp_path / "t"),
                                           "--device", "cpu", "--no-plots"])
    for k in ("pixel_uas", "fov_uas", "mass_msun", "distance_mpc"):
        assert tm[k] == jm[k], k
    _, t = _table(tmp_path / "t" / "visibility_radial.csv")
    _, j = _table(tmp_path / "j" / "visibility_radial.csv")
    np.testing.assert_allclose(t[:, 0], j[:, 0], rtol=1e-7)
    np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=0, atol=1e-3)
    _, t = _table(tmp_path / "t" / "closure_phases.csv")
    _, j = _table(tmp_path / "j" / "closure_phases.csv")
    np.testing.assert_allclose(t[:, :6], j[:, :6], rtol=1e-7)
    d = np.radians(t[:, 6] - j[:, 6])
    assert np.abs(np.angle(np.exp(1j * d))).max() <= 1e-2
    assert (tmp_path / "t" / "visibility_metrics.json").exists()
    assert not (tmp_path / "t" / "visibility_amp.png").exists()


def test_cli_hotspot_closure_matches_jax(tmp_path):
    from grtrace.cli.hotspot import main as jax_hot
    _quiet(jax_hot, HOT_ARGS + ["--out-dir", str(tmp_path / "j")])
    out = _quiet(thot_cli.main, HOT_ARGS + ["--out-dir", str(tmp_path / "t"),
                                            "--device", "cpu",
                                            "--no-plots"])
    assert out["closure"].shape == (6, 4)
    th, t = _table(tmp_path / "t" / "closure_vs_time.csv")
    jh, j = _table(tmp_path / "j" / "closure_vs_time.csv")
    assert th == jh and t.shape == j.shape == (6, 5)
    np.testing.assert_allclose(t[:, 0], j[:, 0], rtol=1e-7)
    d = np.radians(t[:, 1:] - j[:, 1:])
    assert np.abs(np.angle(np.exp(1j * d))).max() <= 1e-2
    assert not (tmp_path / "t" / "closure_vs_time.png").exists()


@pytest.mark.parametrize("flags,csvs", [
    (["--steps", "1500", "--delta", "0.1", "--n-samples", "2",
      "--background", "procedural:starfield"],
     {"photon_data.csv": 256, "sampled_rays.csv": 2 * 750}),
    (["--disk", "--metric", "kerr", "--spin", "0.9", "--steps", "600",
      "--delta", "0.15"],
     {"photon_data.csv": 256, "redshift_map.csv": "disk",
      "line_profile.csv": 48})], ids=["headline", "disk"])
def test_cli_main_aa_renders(tmp_path, flags, csvs):
    """cli.main --aa 2: the render refines its edge pixels and writes its
    image (the antialiased one) and its CSVs, one photon_data row a pixel
    (the centre samples) and, on the disk path, one redshift_map row a
    disk pixel."""
    res = _quiet(tmain_cli.main, flags + [
        "--size", "16", "--aa", "2", "--device", "cpu", "--no-plots",
        "--out-dir", str(tmp_path)])
    assert res.aa_mask.shape == (16, 16) and res.aa_mask.sum() > 8
    assert res.counts["numerical_error"] == 0
    saved = np.asarray(Image.open(tmp_path / "images" / "manual_output.png"))
    np.testing.assert_array_equal(saved, res.image)
    for name, rows in csvs.items():
        want = res.counts["disk"] if rows == "disk" else rows
        assert len(read_csv(tmp_path / name)[1]) == want > 0, name
