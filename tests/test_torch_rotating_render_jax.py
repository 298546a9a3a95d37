"""The rotating regular families' frames, disk, shadow curve and CLIs on
the port (the eager twins of G1r, S2r and D2 on the CPU) against the JAX
package, in float64.  Each JAX reference runs once, in a module-scoped
fixture.

Tolerances:
  * render (24 x 24, 1500 steps of 0.06; a = 0.9, g = 0.2, and the
    horizonless a = 0.6, g = 0.75): statuses, step counts and counts
    equal to JAX's, the images byte for byte;
  * the zero-deformation frame (g = 0) against the port's Kerr frame (a
    different integrator, B5's staggered twin): at most 1% of the pixels
    differ in status and the captured counts within 5, JAX's own bounds
    for the same comparison (tests/test_rotating_regular.py);
  * render_disk through cli.main --disk (24 x 24, 1500 steps of 0.06;
    Novikov-Thorne): statuses, counts and the disk pixels' redshift within
    1e-10 of JAX's render_disk;
  * analytic_boundary_rotating and cli.shadow's metrics (the port's CLI
    against JAX's cli.shadow on the same flags): the same radii (the
    bisection reads the same booleans) within 1e-12 px, the metrics
    within 1e-12 px.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace
import grtrace_torch
from grtrace.engine import disk as jdisk
from grtrace.engine import shadow as jshadow
from grtrace_torch.cli import main as tmain
from grtrace_torch.cli import shadow as tshadow_cli
from grtrace_torch.engine import shadow as tshadow

BG = np.random.default_rng(5).integers(0, 256, (16, 16, 3), dtype=np.uint8)
FRAMES = {"bardeen": ("rotating-bardeen", 0.9, 0.2),
          "horizonless": ("rotating-bardeen", 0.6, 0.75)}
SHADOW_ARGV = ["--metric", "rotating-bardeen", "--spin", "0.9",
               "--metric-param", "0.26", "--azimuths", "16"]


def _scene(pkg, metric, spin, param, size=24, steps=1500):
    return pkg.SceneConfig(size=size, metric=metric, spin=spin,
                           metric_param=param, n_samples=0,
                           integrator=pkg.IntegratorConfig(
                               steps=steps, delta=0.06, dtype="float64"))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = {}
    for key, (metric, spin, param) in FRAMES.items():
        res = grtrace.render(_scene(grtrace, metric, spin, param),
                             bg_array=BG)
        out[key] = (res.counts, np.asarray(res.device("status")),
                    np.asarray(res.device("n_steps")), np.asarray(res.image))
    res = jdisk.render_disk(_scene(grtrace, "rotating-hayward", 0.9, 0.2),
                            jdisk.DiskConfig(profile="novikov"),
                            bg_array=None)
    out["disk"] = (res.counts, np.asarray(res.device("status")),
                   np.asarray(res.device("redshift")))
    # JAX's bisection evaluates its predicate eagerly, seconds a round
    out["curve"] = jshadow.analytic_boundary_rotating(
        0.9, 0.26, "RotatingBardeen", n_psi=16, rounds=3)
    from grtrace.cli import shadow as jshadow_cli
    d = tmp_path_factory.mktemp("jax_shadow_cli")
    jshadow_cli.main(SHADOW_ARGV + ["--out-dir", str(d)])
    with open(d / "shadow_metrics.json") as f:
        out["cli_shadow"] = json.load(f)
    return out


@pytest.mark.parametrize("key", sorted(FRAMES))
def test_render_matches_jax(jax_ref, key):
    """render(scene.metric='rotating-bardeen') through G1r's twin and the
    rescue against grtrace.render: counts, statuses and step counts equal,
    the image byte for byte; the horizonless frame captures at the 1e-2 M
    floor only (no rescue) and flags no numerical error."""
    metric, spin, param = FRAMES[key]
    res = grtrace_torch.render(_scene(grtrace_torch, metric, spin, param),
                               bg_array=BG, device="cpu")
    counts, status, n_steps, image = jax_ref[key]
    assert res.counts == counts
    assert np.array_equal(res.device("status").numpy(), status)
    assert np.array_equal(res.device("n_steps").numpy(), n_steps)
    assert np.array_equal(res.image, image)
    assert res.counts["numerical_error"] == 0 and res.counts["captured"] > 0


def test_zero_deformation_frame_matches_the_kerr_frame():
    """At g = 0 the mass-function chart is Kerr's to the bit
    (physics/rotating_chart.py); the frame through G1r's twin against the
    port's Kerr frame (B5's staggered twin) at 12 x 12, 1000 steps:
    statuses differ on at most 1% of the pixels, captured counts within 5
    (JAX's bounds);
    the horizon and capture radius are Kerr's, and the sampler (S2r's
    twin) records Cartesian points."""
    rot = grtrace_torch.render(
        grtrace_torch.SceneConfig(
            size=12, metric="rotating-bardeen", spin=0.9, metric_param=0.0,
            n_samples=2, integrator=grtrace_torch.IntegratorConfig(
                steps=1000, delta=0.06, dtype="float64")),
        bg_array=BG, device="cpu")
    kerr = grtrace_torch.render(_scene(grtrace_torch, "kerr", 0.9, 0.0,
                                       size=12, steps=1000),
                                bg_array=BG, device="cpu")
    s_rot = rot.device("status").numpy()
    s_kerr = kerr.device("status").numpy()
    assert (s_rot != s_kerr).mean() <= 0.01
    assert abs(rot.counts["captured"] - kerr.counts["captured"]) <= 5
    assert rot.counts["numerical_error"] == 0
    assert len(rot.sampled_trajectories) == 2
    assert rot.sampled_trajectories[0].shape[1] == 3


def test_shadow_curve_and_cli_match_jax(jax_ref, tmp_path):
    """analytic_boundary_rotating (16 azimuths, 3 rounds) equals JAX's
    within 1e-12 px; cli.shadow --metric rotating-bardeen --azimuths 16
    writes the metrics JAX's cli.shadow writes on the same flags (its
    6-round curve) within 1e-12, and those of the port's own 6-round
    curve; a horizonless point exits with JAX's message, --charge with a
    rotating family too."""
    psis, rho = tshadow.analytic_boundary_rotating(0.9, 0.26,
                                                   "RotatingBardeen",
                                                   n_psi=16, rounds=3)
    jpsis, jrho = jax_ref["curve"]
    assert np.array_equal(psis, jpsis)
    assert np.abs(rho - jrho).max() <= 1e-12
    got = tshadow_cli.main(SHADOW_ARGV + ["--device", "cpu", "--out-dir",
                                          str(tmp_path / "t")])
    want = tshadow.shadow_metrics(*tshadow.analytic_boundary_rotating(
        0.9, 0.26, "RotatingBardeen", n_psi=16))
    jax_cli = jax_ref["cli_shadow"]
    for k in ("mean_radius_px", "mean_diameter_px", "circularity_deviation",
              "axis_ratio", "radius_vs_schwarzschild", "rho_min_px",
              "centroid_shift_px"):
        assert np.abs(np.subtract(got[k], want[k])).max() <= 1e-12, k
        assert np.abs(np.subtract(got[k], jax_cli[k])).max() <= 1e-12, k
    with open(tmp_path / "t" / "shadow_metrics.json") as f:
        assert json.load(f)["metric"] == "rotating-bardeen"
    with pytest.raises(SystemExit, match="horizonless"):
        tshadow_cli.main(["--metric", "rotating-bardeen", "--spin", "0.9",
                          "--metric-param", "0.5", "--device", "cpu",
                          "--out-dir", str(tmp_path / "h")])
    with pytest.raises(SystemExit, match="Kerr-Newman-only"):
        tshadow_cli.main(["--metric", "rotating-hayward", "--charge", "0.2",
                          "--device", "cpu", "--out-dir", str(tmp_path)])


def test_cli_main_rotating_disk_matches_jax(jax_ref, tmp_path):
    """cli.main --metric rotating-hayward --disk --disk-profile novikov at
    24 x 24 (render_disk through D2's twin) against JAX's render_disk:
    counts and statuses equal, the disk pixels' redshift within 1e-10 (the
    inner edge is the family's ISCO); the disk maps are written, one row a
    disk pixel; --save-transfer with a rotating family exits with JAX's
    message, --aa raises JAX's refusal."""
    argv = ["--size", "24", "--metric", "rotating-hayward", "--spin", "0.9",
            "--metric-param", "0.2", "--disk", "--disk-profile", "novikov",
            "--steps", "1500", "--delta", "0.06", "--dtype", "float64",
            "--background", "none", "--no-plots", "--no-flat-trajectories",
            "--device", "cpu", "--out-dir", str(tmp_path)]
    res = tmain.main(argv)
    counts, status, redshift = jax_ref["disk"]
    assert res.counts == counts and counts["disk"] > 0
    assert np.array_equal(res.device("status").numpy(), status)
    disk = status == 3
    assert np.abs(res.device("redshift").numpy()[disk]
                  - redshift[disk]).max() <= 1e-10
    rows = np.loadtxt(tmp_path / "redshift_map.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    assert rows.shape[0] == counts["disk"]
    assert (tmp_path / "photon_data.csv").exists()
    with pytest.raises(SystemExit, match="rotating regular metrics"):
        tmain.main(argv + ["--save-transfer", str(tmp_path / "m.npz")])
    with pytest.raises(NotImplementedError, match="sub-ray chain"):
        tmain.main(argv + ["--aa", "2"])
