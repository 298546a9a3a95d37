"""The exact (stepping-free) solvers, renders and drivers of the port against
the JAX package: physics/geodesic_exact.py (crossing_table, escape_state),
physics/static_exact.py, engine/render_exact.py, engine/images.py, and
the CLIs grtrace_torch.cli.exact and grtrace_torch.cli.images, on the CPU.

Everything runs at 16x16 (256 rays), so that JAX compiles each solver once
for the whole file: the solvers' test, the renders and the JAX CLI share
`crossing_table_jit` and `escape_state_jit` at one shape (its own
tests/test_images.py compiles find_images at full size).  For the image
finder the JAX reference is the pixel -> sky map it inverts
(`_one_ray_exit`): the JAX driver would compile find_images (70 s here).

Tolerances, with their reasons (float64): the solvers' records within
1e-8 absolute and 1e-9 relative (fixed-count bisections and 96-node
quadratures in other operations: measured 5.3e-10 on r, 1.0e-8 on a t of
58); class maps, images, orders and the CLIs' counts equal; the renders'
g and exit angles within 1e-9; the static quadrature within 1e-10
relative; the escape map within 1e-9; the found image on the source
within the Newton tolerance, 1e-8 rad.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from grtrace.cli import exact as jexact
from grtrace.engine import images as jim
from grtrace.engine import render_exact as jre
from grtrace.physics import camera as jcam
from grtrace.physics import geodesic_exact as jge
from grtrace.physics import spacetime as jsp
from grtrace.physics import static_exact as jse
from grtrace.physics import static_metrics as jsm
from grtrace_torch.cli import exact as texact
from grtrace_torch.cli import images as timages
from grtrace_torch.engine import images as tim
from grtrace_torch.engine import render_exact as tre
from grtrace_torch.engine.disk import DiskConfig
from grtrace_torch.io.scene import SceneConfig
from grtrace_torch.io.textures import checker
from grtrace_torch.physics import geodesic_exact as tge
from grtrace_torch.physics import static_exact as tse
from grtrace_torch.physics import static_metrics as tsm

torch.set_num_threads(1)
SIZE = 16
PARAMS = [1.0, 0.7, 0.2]
BG = checker(48, 96)
PATCH = (math.pi / 2, math.pi, 2 * math.pi, 2 * math.pi)


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_crossing_table_and_escape_state_match_jax():
    """The first three equatorial crossings and the boundary-sphere escape
    records of the 256 rays of a 16x16 Kerr-Newman (a 0.7, Q 0.2) camera
    at r0 = 30, fov 40 deg, against JAX's."""
    q0, p0, _ = jcam.camera_rays_cartesian(
        jnp.array([30.0, 0, 0]), jnp.deg2rad(40.0), SIZE, SIZE,
        params=jnp.array(PARAMS), g_inv_fn=jsp.METRICS["KerrSchild"],
        dtype=jnp.float64)
    q0, p0 = np.asarray(q0).reshape(-1, 4), np.asarray(p0).reshape(-1, 4)
    jt = jge.crossing_table_jit(jnp.asarray(q0), jnp.asarray(p0),
                                jnp.asarray(PARAMS), n_orders=3)
    tt = tge.crossing_table(torch.tensor(q0), torch.tensor(p0), PARAMS,
                            n_orders=3)
    ok = np.asarray(jt["valid"])
    assert np.array_equal(ok, tt["valid"].numpy()) and ok.any()
    for k in ("tau", "r", "t", "phi"):
        np.testing.assert_allclose(tt[k].numpy()[ok], np.asarray(jt[k])[ok],
                                   atol=1e-8, rtol=1e-9, err_msg=k)
    for k in ("lam", "eta", "e_sign"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   atol=1e-12, rtol=0, err_msg=k)
    assert np.array_equal(tt["captured"].numpy(), np.asarray(jt["captured"]))
    je = jge.escape_state_jit(jnp.asarray(q0), jnp.asarray(p0),
                              jnp.asarray(PARAMS), jnp.float64(31.0))
    te = tge.escape_state(torch.tensor(q0), torch.tensor(p0), PARAMS, 31.0)
    esc = np.asarray(je["escaped"])
    assert np.array_equal(esc, te["escaped"].numpy())
    assert 0 < esc.sum() < SIZE * SIZE
    for k in ("theta", "phi", "t", "tau"):
        np.testing.assert_allclose(te[k].numpy()[esc], np.asarray(je[k])[esc],
                                   atol=1e-8, rtol=1e-9, err_msg=k)


def test_static_exact_matches_jax():
    """deflection_static, u_at_phi_static (both legs, and a plunger) and
    disk_crossing_exact for Bardeen g = 0.5 at r_obs 30, 1e-10
    relative."""
    f_fn = jsm.STATIC_F["Bardeen"]
    jp = jnp.asarray([1.0, 0.5, 0.0])
    bs = [5.0, 6.5, 9.0]
    jd = [float(jse.deflection_static(b, f_fn, jp, 30.0)) for b in bs]
    td = tse.deflection_static(torch.tensor(bs, dtype=torch.float64),
                               tsm.STATIC_F["Bardeen"], [1.0, 0.5, 0.0],
                               30.0)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-10)
    cases = [(1.0, 6.5), (3.5, 6.5), (1.0, 3.0)]
    ju = [float(jse.u_at_phi_static(ph, b, f_fn, jp, 30.0))
          for ph, b in cases]
    tu = tse.u_at_phi_static(torch.tensor([c[0] for c in cases]),
                             torch.tensor([c[1] for c in cases]),
                             tsm.STATIC_F["Bardeen"], [1.0, 0.5, 0.0], 30.0)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-10)
    p0 = np.array([[0.9, -0.5, 0.0, 6.0], [0.9, -0.4, 0.0, -9.0]])
    beta = np.array([0.3, -1.1])
    for k in (0, 1):
        jr = [jse.disk_crossing_exact(jnp.asarray(p0[i]), beta[i],
                                      math.radians(25.0), "Bardeen", jp,
                                      30.0, k=k) for i in range(2)]
        tr, ts = tse.disk_crossing_exact(p0, beta, math.radians(25.0),
                                         "Bardeen", [1.0, 0.5, 0.0], 30.0,
                                         k=k)
        np.testing.assert_allclose(tr.numpy(), [float(r[0]) for r in jr],
                                   rtol=1e-10)
        np.testing.assert_allclose(ts.numpy(), [float(r[1]) for r in jr],
                                   rtol=1e-12)


def test_exact_disk_render_and_cli_match_jax(tmp_path, capsys):
    """render_disk_exact (a 0.7, 3 orders) at 16x16 against JAX's: orders
    and images equal, g within 1e-9; then cli.exact's disk scene (camera
    25 deg) in both packages: the JSON lines' counts equal, g_min and
    g_max within 1e-9, the maps within 1e-9 and the PNGs equal; with
    --compare the traced twin of B6 agrees with the exact render on all
    but a few edge pixels."""
    from grtrace import SceneConfig as JScene
    from grtrace.engine.disk import DiskConfig as JDisk
    kw = dict(size=SIZE, metric="kerr", spin=0.7, n_samples=0)
    j = jre.render_disk_exact(JScene(**kw), JDisk())
    t = tre.render_disk_exact(SceneConfig(**kw), DiskConfig(), device="cpu")
    assert np.array_equal(np.asarray(j["order"]), t["order"].numpy())
    assert (t["order"].numpy() >= 0).any()
    np.testing.assert_allclose(t["g"].numpy(), np.asarray(j["g"]),
                               atol=1e-9, rtol=0)
    assert np.array_equal(t["image_u8"], j["image_u8"])

    argv = ["--spin", "0.7", "--size", str(SIZE), "--steps", "1500",
            "--delta", "0.05"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jexact.main(argv + ["--out-dir", str(jdir), "--platform", "cpu"])
    jl = _last_json(capsys)
    texact.main(argv + ["--out-dir", str(tdir), "--device", "cpu",
                        "--compare"])
    tl = _last_json(capsys)
    for k in ("size", "spin", "charge", "orders", "disk_pixels",
              "pixels_per_order", "files"):
        assert tl[k] == jl[k], k
    assert tl["disk_pixels"] > 0
    np.testing.assert_allclose([tl["g_min"], tl["g_max"]],
                               [jl["g_min"], jl["g_max"]], rtol=1e-9)
    for name in ("exact_g_map.csv", "exact_r_em.csv"):
        np.testing.assert_allclose(np.loadtxt(tdir / name, delimiter=","),
                                   np.loadtxt(jdir / name, delimiter=","),
                                   atol=1e-9, rtol=0)
    assert np.array_equal(_png(tdir / "exact_disk.png"),
                          _png(jdir / "exact_disk.png"))
    assert tl["traced_disk_pixels"] > 0
    assert tl["mask_mismatch_pixels"] <= 0.1 * tl["disk_pixels"]
    assert tl["dg_median"] < 1e-2
    assert {"dg_max", "traced_render_s"} <= set(tl)


def test_exact_background_render_and_cli_match_jax(tmp_path, capsys):
    """render_pixels_background_exact (a 0.7) at 16x16 against JAX's:
    class maps, images and counts equal, the exit angles within 1e-9;
    then cli.exact --background in both packages (the checker sky): the
    counts and the PNG equal; --compare (the float64 Kerr-Schild twin of
    B5) reports the JAX driver's parity keys, with sub-milliradian median
    exit angles."""
    common = (30.0, math.radians(80.0), 1.0)
    j = jre.render_pixels_background_exact(
        jnp.asarray(BG, jnp.uint8), *(jnp.float64(x) for x in common),
        jnp.float64(0.7), jnp.float64(31.0),
        *(jnp.float64(x) for x in PATCH), height=SIZE, width=SIZE)
    t = tre.render_pixels_background_exact(
        torch.as_tensor(BG), *common, 0.7, 31.0, *PATCH, height=SIZE,
        width=SIZE)
    assert np.array_equal(np.asarray(j["cls"]), t["cls"].numpy())
    assert np.array_equal(np.asarray(j["image"]), t["image"].numpy())
    assert np.array_equal(np.asarray(j["count_vec"]), t["count_vec"].numpy())
    np.testing.assert_allclose(t["final_q"].numpy(), np.asarray(j["final_q"]),
                               atol=1e-9, rtol=0)

    argv = ["--spin", "0.7", "--size", str(SIZE), "--background"]
    jexact.main(argv + ["--out-dir", str(tmp_path / "j"), "--platform",
                        "cpu"])
    jl = _last_json(capsys)
    texact.main(argv + ["--out-dir", str(tmp_path / "t"), "--device", "cpu",
                        "--compare", "--steps", "3000", "--delta", "0.05"])
    tl = _last_json(capsys)
    for k in ("captured", "escaped", "background"):
        assert tl[k] == jl[k], k
    assert np.array_equal(_png(tmp_path / "t" / "exact_bg.png"),
                          _png(tmp_path / "j" / "exact_bg.png"))
    assert {"cls_mismatch_pixels", "dtheta_median", "dphi_median",
            "image_pixels_differing", "traced_render_s"} <= set(tl)
    assert tl["dtheta_median"] < 1e-3 and tl["dphi_median"] < 1e-3
    assert tl["cls_mismatch_pixels"] <= 0.1 * SIZE * SIZE


def test_exact_static_background_matches_jax():
    """render_pixels_background_exact_static (Hayward l = 0.6) at 16x16
    against JAX's: class maps, images and counts equal, the exit angles
    within 1e-9."""
    common = (30.0, math.radians(80.0), 1.0)
    j = jre.render_pixels_background_exact_static(
        jnp.asarray(BG, jnp.uint8), *common, 0.6, 31.0, *PATCH,
        height=SIZE, width=SIZE, metric="Hayward")
    t = tre.render_pixels_background_exact_static(
        torch.as_tensor(BG), *common, 0.6, 31.0, *PATCH, height=SIZE,
        width=SIZE, metric="Hayward")
    assert np.array_equal(np.asarray(j["cls"]), t["cls"].numpy())
    assert np.array_equal(np.asarray(j["image"]), t["image"].numpy())
    assert np.array_equal(np.asarray(j["count_vec"]), t["count_vec"].numpy())
    np.testing.assert_allclose(t["final_q"].numpy(), np.asarray(j["final_q"]),
                               atol=1e-9, rtol=0)


def test_find_images_and_cli(tmp_path, capsys):
    """cli.images on the CPU (a 0.9, a 16x16 frame, winding 0, a 12-point
    scan): it reports one converged image; the pixel -> sky map it
    inverts equals JAX's _one_ray_exit at that image and at a seed pixel
    (1e-9), in its batched form (the scan) and its one-ray form (what
    Newton differentiates with `torch.func.jacfwd`), and sends the image
    to the source within 1e-8; --overlay (an 8x8 frame, where the 2-point
    scan seeds no image) writes the exact sky; a naked singularity
    exits."""
    argv = ["--source-theta", "95", "--source-phi", "166", "--spin", "0.9",
            "--size", str(SIZE), "--windings", "0", "--scan", "12",
            "--device", "cpu", "--out-dir", str(tmp_path)]
    timages.main(argv)
    tl = _last_json(capsys)
    assert tl["n_found"] == 1 and tl["images"][0]["converged"]
    im = tl["images"][0]
    params = torch.tensor([1.0, 0.9, 0.0], dtype=torch.float64)
    obs = torch.tensor([30.0, 0.0, 0.0], dtype=torch.float64)
    fov = torch.tensor(math.radians(80.0), dtype=torch.float64)
    jparams, jobs = jnp.asarray([1.0, 0.9, 0.0]), jnp.asarray([30.0, 0, 0])
    jexit = jax.jit(lambda i, j: jim._one_ray_exit(
        i, j, jparams, jobs, jnp.asarray(math.radians(80.0)), SIZE, SIZE,
        31.0))
    for ij in ((7.0, 10.0), (im["i"], im["j"])):
        ij_t = torch.tensor(ij, dtype=torch.float64)
        th, ph, esc, t_arr = tim.exit_map(ij_t[None], params, obs, fov, SIZE,
                                          SIZE, 31.0)
        jth, jph, jesc, jt = jexit(jnp.float64(ij[0]), jnp.float64(ij[1]))
        assert bool(esc[0]) == bool(jesc)
        np.testing.assert_allclose([float(th[0]), float(ph[0]),
                                    float(t_arr[0])],
                                   [float(jth), float(jph), float(jt)],
                                   atol=1e-9, rtol=0)
    one = tim._one_ray_exit(ij_t[0], ij_t[1], params, obs, fov, SIZE, SIZE,
                            31.0, tge._nodes("cpu"))
    np.testing.assert_allclose([float(one[0]), float(one[1])],
                               [float(th[0]), float(ph[0])], atol=1e-12)
    np.testing.assert_allclose([float(th[0]), float(ph[0])],
                               [im["theta"], im["phi"]], atol=1e-12)
    np.testing.assert_allclose([im["theta"], im["phi"]],
                               [math.radians(95.0), math.radians(166.0)],
                               atol=1e-8)
    timages.main(argv[:7] + ["8", "--windings", "0", "--scan", "2",
                             "--overlay", "--device", "cpu", "--out-dir",
                             str(tmp_path)])
    t8 = _last_json(capsys)
    assert t8["n_found"] == 0 and _png(t8["overlay"]).shape == (8, 8, 3)
    with pytest.raises(SystemExit, match="naked singularity"):
        timages.main(["--source-theta", "1", "--source-phi", "1",
                      "--spin", "1.2", "--device", "cpu"])
