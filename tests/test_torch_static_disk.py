"""The static families' thin disk (engine/disk_static.py) against the JAX
package: the eager twin of kernel D1 against JAX's
integrate_batch_disk_static, render_disk_static, static_disk_bounds, and
the CLI's --disk route for a static family.

Tolerances, with their reasons (float64): statuses, hits and step counts
equal; the hit rows within 1e-8 (the crossing lerp of states that agree
to roundoff grown along the rays); the redshift within 1e-9 relative; the
disk edges within 1e-10 relative (a bisection on d(L^2)/dr).  A ray that
never hits keeps zeros in its hit rows (the port's convention, kernel
B6's and D1's); JAX's loop leaves the camera's (q0, p0) there: pinned.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace as g
import grtrace_torch as gt
from grtrace.engine import disk_static as jds
from grtrace.engine.disk import STATUS_DISK
from grtrace.physics import camera as jcam
from grtrace.physics import spacetime as jsp
from grtrace_torch.cli import main as tmain
from grtrace_torch.engine import disk_static as tds
from grtrace_torch.io.textures import checker

torch.set_num_threads(1)


def _folded(metric, param, size):
    q0, p0, _, beta = jcam.camera_rays_folded_static(
        jnp.asarray([30.0, 0.0, 0.0]), jnp.asarray(np.radians(80.0)), size,
        size, params=jnp.asarray([1.0, param, 0.0]),
        g_inv_fn=jsp.METRICS[metric], dtype=jnp.float64)
    return (np.asarray(q0).reshape(-1, 4), np.asarray(p0).reshape(-1, 4),
            np.asarray(beta).reshape(-1))


@pytest.mark.parametrize("metric,param,elev", [("Bardeen", 0.5, 20.0),
                                                ("Kottler", 1e-3, 70.0)])
def test_d1_twin_matches_jax(metric, param, elev):
    """integrate_batch_disk_static's twin on the folded 16x16 camera,
    1500 steps, delta 0.05, disk [5, 14]: statuses, hit flags, step counts
    equal JAX's; hit rows within 1e-8; no-hit rows zero in the port and
    the camera's (q0, p0) in JAX."""
    q0, p0, beta = _folded(metric, param, 16)
    e = math.radians(elev)
    c1 = np.full_like(beta, math.sin(e))
    c2 = np.sin(beta) * math.cos(e)
    args = (1500, 0.05, (1.0, param, 0.0), 31.0, 1.0, 5.0, 14.0)
    jq, jp, js, jn, jhq, jhp = (np.asarray(x) for x in
                                jds.integrate_batch_disk_static(
                                    jnp.asarray(q0), jnp.asarray(p0),
                                    jnp.asarray(c1), jnp.asarray(c2), *args,
                                    metric=metric))
    tq, tp, ts, tn, thq, thp = (x.numpy() for x in
                                tds.integrate_batch_disk_static(
                                    torch.tensor(q0), torch.tensor(p0),
                                    torch.tensor(c1), torch.tensor(c2),
                                    *args, metric=metric))
    assert np.array_equal(ts, js) and np.array_equal(tn, jn)
    hit = js == STATUS_DISK
    assert 0 < hit.sum() < hit.size
    np.testing.assert_allclose(thq[hit], jhq[hit], atol=1e-8, rtol=0)
    np.testing.assert_allclose(thp[hit], jhp[hit], atol=1e-8, rtol=0)
    # the no-hit rows: zeros in the port, the camera's state in JAX
    assert not thq[~hit].any() and not thp[~hit].any()
    np.testing.assert_array_equal(jhq[~hit], q0[~hit])
    np.testing.assert_array_equal(jhp[~hit], p0[~hit])
    np.testing.assert_allclose(tq[:, 1:], jq[:, 1:], atol=1e-6, rtol=0)


def test_render_disk_static_matches_jax():
    """render_disk_static on the 24x24 Bardeen (g = 0.4) scene, camera 15
    deg above the tilted disk, novikov profile, with a background: counts
    (disk included), class map, image and redshift equal JAX's."""
    kw = dict(size=24, metric="bardeen", metric_param=0.4, n_samples=0,
              background=None)
    ts = gt.SceneConfig(integrator=gt.IntegratorConfig(
        steps=1500, delta=0.05, dtype="float64"), **kw)
    js = g.SceneConfig(integrator=g.IntegratorConfig(
        steps=1500, delta=0.05, dtype="float64"), **kw)
    bg = checker(48, 96)
    td = gt.DiskConfig(elevation_deg=15.0, profile="novikov")
    jd = g.DiskConfig(elevation_deg=15.0, profile="novikov")
    tr = tds.render_disk_static(ts, td, bg_array=bg, device="cpu")
    jr = jds.render_disk_static(js, jd, bg_array=bg)
    assert tr.counts == jr.counts and tr.counts["disk"] > 0
    assert np.array_equal(tr.cls, np.asarray(jr.cls))
    assert np.array_equal(tr.image, np.asarray(jr.image))
    np.testing.assert_allclose(tr.device("redshift").numpy(),
                               np.asarray(jr.device("redshift")), rtol=1e-9,
                               atol=0)
    with pytest.raises(NotImplementedError, match="Kerr-Schild disk path"):
        tds.render_disk_static(ts, gt.DiskConfig(bfield="vertical"),
                               device="cpu")


def test_static_disk_bounds_match_jax():
    """The ISCO inner edge of each family, Kottler's OSCO check and the
    edge checks raise as JAX's do."""
    for metric, param in (("Bardeen", 0.5), ("Hayward", 0.6),
                          ("Kottler", 1e-4)):
        t = tds.static_disk_bounds(metric, 1.0, param, None, 14.0, 31.0)
        j = jds.static_disk_bounds(metric, 1.0, param, None, 14.0, 31.0)
        np.testing.assert_allclose(t, j, rtol=1e-10)
    for args in (("Kottler", 1.0, 1e-3, None, 14.0, 31.0),
                 ("Bardeen", 1.0, 0.5, 8.0, 6.0, 31.0),
                 ("Bardeen", 1.0, 0.5, None, 40.0, 31.0)):
        with pytest.raises(ValueError) as jerr:
            jds.static_disk_bounds(*args)
        with pytest.raises(ValueError) as terr:
            tds.static_disk_bounds(*args)
        assert str(terr.value).split()[:3] == str(jerr.value).split()[:3]


def test_cli_static_disk(tmp_path):
    """cli.main --metric hayward --disk on the CPU (16x16): the static disk
    route (render_disk_static, the twin of D1), redshift_map.csv with one
    row per disk pixel whose radius is the crossing's own r; --aa and
    --save-transfer exit as in JAX."""
    argv = ["--metric", "hayward", "--metric-param", "0.6", "--disk",
            "--size", "16", "--steps", "1500", "--delta", "0.05",
            "--dtype", "float64", "--device", "cpu", "--no-plots",
            "--out-dir", str(tmp_path)]
    res = tmain.main(argv)
    assert res.counts["disk"] > 0
    rows = np.loadtxt(tmp_path / "redshift_map.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    assert len(rows) == res.counts["disk"]
    hq = res.device("hit_q").numpy()
    # the CSV's %.8g
    np.testing.assert_allclose(rows[:, 3], hq[rows[:, 0].astype(int),
                                              rows[:, 1].astype(int), 1],
                               rtol=1e-7)
    assert rows[:, 3].min() >= 5.0
    for extra, match in ((["--aa", "2"], "--aa with --disk"),
                         (["--save-transfer", "t.npz"], "--save-transfer")):
        with pytest.raises(SystemExit, match=match):
            tmain.main(argv + extra)
