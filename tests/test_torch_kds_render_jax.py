"""Kerr-de Sitter's engine, frames, disk and shadow curve on the port (the
eager twins of G1d, T2d and D3 on the CPU) against the JAX package, in
float64.  Each JAX reference runs once, in a module-scoped fixture.

Tolerances:
  * the twins against JAX's integrate_batch_generic(metric='KerrDS') (600
    steps of 0.05 on an 8 x 8 camera): statuses and step counts equal, q
    and p within 1e-8 on 56 of the 64 rays; the rays parked near the
    horizon or left winding in the photon region end up to 2.03e-3 apart
    (ROADMAP Queue C); T2d's twin against JAX's trajectory_generic (one
    ray, 300 steps) within 1e-8;
  * render (24 x 24, 1500 steps of 0.06; a = 0.8, Lambda = 1e-3):
    counts, statuses and step counts equal, the image byte for byte;
  * render_disk_kds (24 x 24, 1500 steps of 0.06; Lambda = 1e-4, r_in =
    3 M): counts and statuses equal, the disk pixels' redshift within
    1e-10;
  * cli.shadow --metric kerr-ds (the port's CLI against JAX's cli.shadow
    on the same flags): the metrics within 1e-12 px;
  * Lambda = 0 against the port's own kerr-bl frame: counts and statuses
    equal (JAX's test_render_matches_kerr_bl_at_zero_lambda).
The adaptive antialiasing pass classifies Kerr-de Sitter's sub-rays at
JAX's surface, the Kerr-Newman horizon with Lambda in the charge slot
(ROADMAP Queue C); `test_cli_paths_and_the_aa_surface` pins it.
"""
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace
import grtrace_torch
from grtrace.engine import disk as jdisk
from grtrace.engine import disk_kds as jdk
from grtrace.engine import integrate_generic as jig
from grtrace_torch.cli import main as tmain
from grtrace_torch.cli import shadow as tshadow_cli
from grtrace_torch.engine import classify as tclassify
from grtrace_torch.engine import disk_kds as tdk
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics.camera import (pixel_grid_lookat,
                                          unfolded_ics_from_pixels)
from grtrace_torch.physics.spacetime import METRICS, horizon_radius

BG = np.random.default_rng(11).integers(0, 256, (16, 16, 3), dtype=np.uint8)
SPIN, LAM, DISK_LAM, DISK_R_IN = 0.8, 1e-3, 1e-4, 3.0
SHADOW_ARGV = ["--metric", "kerr-ds", "--spin", "0.8", "--metric-param",
               "1e-3", "--azimuths", "16"]
F64 = torch.float64
JAX_SHADOW = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
              "jax.config.update('jax_enable_x64', True); "
              "from grtrace.cli import shadow; shadow.main(sys.argv[1:])")


def _scene(pkg, lam, size=24, steps=1500, metric="kerr-ds", delta=0.06):
    return pkg.SceneConfig(size=size, metric=metric, spin=SPIN,
                           metric_param=lam, n_samples=0,
                           integrator=pkg.IntegratorConfig(
                               steps=steps, delta=delta, dtype="float64"))


def _rays():
    """An 8 x 8 unfolded look-at camera at r0 = 15 (fov 60 deg, 3 M above
    the plane), float64: captures, escapes and rays that wind."""
    obs = torch.tensor([15.0, 0.0, 3.0], dtype=F64)
    pix = pixel_grid_lookat(obs, torch.tensor(math.radians(60.0),
                                              dtype=F64), 8, 8, dtype=F64)
    q0, p0, _ = unfolded_ics_from_pixels(obs, pix, params=(1.0, SPIN, LAM),
                                         g_inv_fn=METRICS["KerrDS"])
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    # JAX's cli.shadow (about 15 s of eager work) runs in a process of its
    # own beside the references below
    d = tmp_path_factory.mktemp("jax_shadow_cli")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))))
    shadow = subprocess.Popen(
        [sys.executable, "-c", JAX_SHADOW, *SHADOW_ARGV, "--out-dir",
         str(d)], cwd=root, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        out = _jax_ref()
        _, stderr = shadow.communicate(timeout=600)
    finally:
        if shadow.poll() is None:
            shadow.kill()
            shadow.wait()
    assert shadow.returncode == 0, stderr[-2000:]
    with open(d / "shadow_metrics.json") as f:
        out["cli_shadow"] = json.load(f)
    return out


def _jax_ref():
    out = {}
    q0, p0 = _rays()
    jq, jp = jnp.asarray(q0.numpy()), jnp.asarray(p0.numpy())
    out["twin"] = [np.asarray(x) for x in jig.integrate_batch_generic(
        jq, jp, 600, 0.05, jnp.array([1.0, SPIN, LAM]), 16.0, 1.0,
        metric="KerrDS")]
    out["trace"] = [np.asarray(x) for x in jig.trajectory_generic(
        jq[0], jp[0], 300, 0.05, jnp.array([1.0, SPIN, LAM]), 1.0,
        metric="KerrDS")]
    res = grtrace.render(_scene(grtrace, LAM), bg_array=BG)
    out["render"] = (res.counts, np.asarray(res.device("status")),
                     np.asarray(res.device("n_steps")),
                     np.asarray(res.image))
    # r_in given: JAX's eager ISCO scan costs seconds (the ISCO is held
    # against JAX's through cli.qpo, tests/test_torch_qpo.py)
    res = jdk.render_disk_kds(_scene(grtrace, DISK_LAM),
                              jdisk.DiskConfig(r_in=DISK_R_IN), bg_array=BG)
    out["disk"] = (res.counts, np.asarray(res.device("status")),
                   np.asarray(res.device("redshift")))
    return out


def test_twins_match_jax(jax_ref):
    """integrate_batch_generic(metric='KerrDS') (G1d's twin and the rescue)
    against JAX's on the 8 x 8 camera, 600 steps of 0.05: statuses and
    step counts equal, captures and escapes among them, q and p within
    1e-8 on 56 of the 64 rays; trajectory_generic (T2d's twin) on its
    first ray within 1e-8."""
    q0, p0 = _rays()
    got = tig.integrate_batch_generic(q0, p0, 600, 0.05, (1.0, SPIN, LAM),
                                      16.0, 1.0, metric="KerrDS")
    jq, jpp, js, jn = jax_ref["twin"]
    assert np.array_equal(got[2].numpy(), js)
    assert np.array_equal(got[3].numpy(), jn)
    assert {1, 2} <= set(js.tolist())
    # the Boyer-Lindquist chart's 1/Delta near the horizon and the photon
    # shell's instability amplify the last-bit difference between JAX's
    # autodiff kicks and the closed form: 8 of the 64 rays (6 parked by
    # the guard near the horizon, 2 winding in the photon region for most
    # of the budget) end up to 2.03e-3 apart in q and 4.8e-2 in p, with
    # equal statuses and step counts (ROADMAP Queue C); the rest within
    # 1e-8
    dq = np.abs(got[0].numpy() - jq).max(1)
    dp = np.abs(got[1].numpy() - jpp).max(1)
    held = (dq <= 1e-8) & (dp <= 1e-8)
    assert held.sum() >= 56
    assert dq.max() <= 3e-3 and dp.max() <= 7e-2
    qs, ps = tig.trajectory_generic(q0[0], p0[0], 300, 0.05,
                                    (1.0, SPIN, LAM), 1.0, metric="KerrDS")
    np.testing.assert_allclose(qs.numpy(), jax_ref["trace"][0], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(ps.numpy(), jax_ref["trace"][1], rtol=0,
                               atol=1e-8)


def test_render_matches_jax(jax_ref):
    """render(scene.metric='kerr-ds') through G1d's twin and the rescue
    against grtrace.render at 24 x 24: counts, statuses and step counts
    equal, the image byte for byte."""
    res = grtrace_torch.render(_scene(grtrace_torch, LAM), bg_array=BG,
                               device="cpu")
    counts, status, n_steps, image = jax_ref["render"]
    assert res.counts == counts
    assert np.array_equal(res.status, status)
    assert np.array_equal(res.n_steps, n_steps)
    assert np.array_equal(res.image, image)
    assert counts["captured"] and counts["escaped"]


def test_render_disk_kds_matches_jax(jax_ref):
    """render_disk_kds (D3's twin, the rescue and the Shakura-Sunyaev
    shading) against JAX's at 24 x 24, 1500 steps of 0.06: counts and
    statuses equal, the disk pixels' redshift within 1e-10; the options
    JAX refuses raise."""
    res = tdk.render_disk_kds(_scene(grtrace_torch, DISK_LAM),
                              grtrace_torch.DiskConfig(r_in=DISK_R_IN),
                              bg_array=BG, device="cpu")
    counts, status, g = jax_ref["disk"]
    assert res.counts == counts and counts["disk"] > 0
    assert np.array_equal(res.status, status)
    disk = status == tdk.STATUS_DISK
    got = res.device("redshift").numpy()
    np.testing.assert_allclose(got[disk], g[disk], rtol=1e-10, atol=0)
    assert not got[~disk].any()
    for kw in ({"bfield": "vertical"}, {"camera_omega": "keplerian"},
               {"profile": "novikov"}):
        with pytest.raises(NotImplementedError):
            tdk.render_disk_kds(_scene(grtrace_torch, DISK_LAM, size=4),
                                grtrace_torch.DiskConfig(**kw), device="cpu")


def test_cli_shadow_matches_jax(jax_ref, tmp_path):
    """cli.shadow --metric kerr-ds (the exact curve through the unfolded
    camera) writes JAX's metrics within 1e-12 px; a camera too near the
    cosmological horizon and a point with no black-hole horizon exit as
    JAX's do."""
    m = tshadow_cli.main(SHADOW_ARGV + ["--device", "cpu", "--out-dir",
                                        str(tmp_path)])
    want = jax_ref["cli_shadow"]
    for k in ("mean_radius_px", "mean_diameter_px", "circularity_deviation",
              "axis_ratio", "rho_min_px", "rho_max_px"):
        assert m[k] == pytest.approx(want[k], rel=0, abs=1e-12)
    np.testing.assert_allclose(m["centroid_shift_px"],
                               want["centroid_shift_px"], rtol=0, atol=1e-12)
    with pytest.raises(SystemExit, match="cosmological horizon"):
        tshadow_cli.main(["--metric", "kerr-ds", "--metric-param", "3e-3",
                          "--device", "cpu", "--out-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no black-hole horizon"):
        tshadow_cli.main(["--metric", "kerr-ds", "--spin", "1.2",
                          "--metric-param", "1e-3", "--azimuths", "4",
                          "--device", "cpu", "--out-dir", str(tmp_path)])


def test_zero_lambda_matches_kerr_bl():
    """At Lambda = 0 the kerr-ds frame (G1d's twin, the Kerr-de Sitter
    rescue and camera) equals the port's kerr-bl frame (G1's twin) in
    counts and statuses at 16 x 16, 900 steps of 0.1, float64 (JAX's
    test_render_matches_kerr_bl_at_zero_lambda); the twins' steps on the
    same rays are bitwise equal."""
    kw = {"bg_array": BG, "device": "cpu"}
    zero = grtrace_torch.render(_scene(grtrace_torch, 0.0, size=16,
                                       steps=900, delta=0.1), **kw)
    bl = grtrace_torch.render(_scene(grtrace_torch, 0.0, size=16, steps=900,
                                     delta=0.1, metric="kerr-bl"), **kw)
    assert zero.counts == bl.counts
    assert np.array_equal(zero.status, bl.status)
    q0 = zero.device("q0").reshape(-1, 4)[::7].contiguous()
    p0 = zero.device("p0").reshape(-1, 4)[::7].contiguous()
    vecs = [tig.gen_params(m, 0.06, (1.0, SPIN, 0.0), 31.0, 1.0, 2, F64)
            for m in ("KerrDS", "Kerr")]
    (s_d, n_d), (s_b, n_b) = (tig.integrate_generic_twin(q0, p0, 300, v, m)
                              for v, m in zip(vecs, ("KerrDS", "Kerr")))
    assert torch.equal(n_d, n_b)
    assert all(torch.equal(a.view(torch.int64), b.view(torch.int64))
               for a, b in zip(s_d, s_b))


def test_cli_paths_and_the_aa_surface(tmp_path, monkeypatch):
    """cli.main --metric kerr-ds with and without --disk at 8 x 8 on the
    CPU (the disk maps in the spherical chart; --aa and --save-transfer
    with --disk exit as JAX's CLI does).  The AA pass classifies the
    sub-rays at (1.1 / 1.2) horizon_radius('Kerr', M, a, Lambda), JAX's
    surface (grtrace/engine/aa.py:160-170), not at the render's 1.1 x the
    Kerr-de Sitter r_+: 0.14% lower at a = 0.8, Lambda = 1e-3; on this
    frame's AA pass no sub-ray's class differs between the two surfaces."""
    base = ["--size", "8", "--metric", "kerr-ds", "--spin", "0.8",
            "--metric-param", "1e-3", "--steps", "500", "--delta", "0.12",
            "--device", "cpu", "--no-plots"]
    res = tmain.main(base + ["--n-samples", "2", "--out-dir",
                             str(tmp_path / "plain")])
    assert len(res.sampled_trajectories) == 2
    assert sum(res.counts[k] for k in ("captured", "in_domain", "escaped",
                                       "numerical_error")) == 64
    assert res.counts["escaped"] and not res.counts["numerical_error"]
    disk = tmain.main(base[:7] + ["1e-4"] + base[8:]
                      + ["--disk", "--out-dir", str(tmp_path / "disk")])
    assert disk.counts["disk"] > 0
    rows = np.loadtxt(tmp_path / "disk" / "redshift_map.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    hits = disk.status == tdk.STATUS_DISK
    assert rows.shape[0] == disk.counts["disk"] == int(hits.sum())
    np.testing.assert_allclose(rows[:, 3], disk.device("hit_q").numpy()[
        hits][:, 1], rtol=1e-7)
    for extra, match in ((["--aa", "2"], "--aa with --disk"),
                         (["--save-transfer", str(tmp_path / "m.npz")],
                          "--save-transfer")):
        with pytest.raises(SystemExit, match=match):
            tmain.main(base + ["--disk"] + extra)
    calls = []
    classify = tclassify.classify_rays

    def spy(*args, rs, **kw):
        out = classify(*args, rs=rs, **kw)
        calls.append((args, kw, float(rs), out[0]))
        return out
    monkeypatch.setattr(tclassify, "classify_rays", spy)
    scene = _scene(grtrace_torch, LAM, size=12, steps=500, delta=0.12)
    aa = grtrace_torch.render(scene, bg_array=BG, device="cpu",
                              aa_samples=2)
    assert int(aa.aa_mask.sum()) > 0 and len(calls) == 2
    want = (1.1 / 1.2) * float(horizon_radius(
        "Kerr", torch.tensor(1.0, dtype=F64), SPIN, LAM))
    (_, _, surface, _), (args, kw, rs, sub_cls) = calls
    assert rs == pytest.approx(want, rel=1e-15)
    # surface: the render's, (1.1 / 1.2) x the Kerr-de Sitter r_+
    assert rs / surface == pytest.approx(0.998575, abs=1e-6)
    again = classify(*args, rs=torch.tensor(surface, dtype=F64), **kw)[0]
    assert torch.equal(again, sub_cls)   # no sub-ray's class differs
