"""The port's thin-disk render against the JAX package, on the CPU
(device='cpu': the eager twins of kernel B6).

* The slice as a whole: `grtrace_torch.render_disk` of a 16x16 scene
  around a = 0.9, 1,500 steps at delta 0.05, float64, against JAX's
  `render_disk` on the same scene (on the CPU JAX runs its XLA disk engine,
  `integrate_batch_disk`): equal counts, class maps and statuses pixel for
  pixel; the redshift on disk pixels to 1e-10 relative; the uint8 image
  within one level (measured: equal); hit_q on disk pixels to 1e-9; step
  counts equal except that a captured ray may trip the guard up to 2
  steps apart (the staggered composition against JAX's unstaggered
  engine, as tests/test_torch_render_kerr.py records).  Off-disk hit rows
  are not compared: the port writes zeros there, as the TPU kernel does,
  where JAX's XLA engine carries the launch state (ROADMAP Queue C).
* float32 (the 32-row twin), the shading pieces (blackbody colors, both
  temperature profiles, jnp.interp's arithmetic), the configuration, the
  parts left out, and the kernel-vs-twin parity check of the disk mode,
  held with a stand-in for the kernel to seeing a one-ulp or one-ray
  difference.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace.engine import disk as jdisk
from grtrace.io.scene import IntegratorConfig, SceneConfig
from grtrace_torch.engine import disk as tdisk
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda
from grtrace_torch.engine import validate as tval
from grtrace_torch.engine.metrics import RenderMetrics
from grtrace_torch.io.textures import checker

torch.set_num_threads(1)

TEX = checker(32, 48)
F64 = torch.float64
R_IN = float(tdisk.isco_radius(1.0, 0.9))


def _scene(size=16, dtype="float64", spin=0.9, **kw):
    return SceneConfig(size=size, metric="kerr", spin=spin, n_samples=0,
                       background=None,
                       integrator=IntegratorConfig(steps=1500, delta=0.05,
                                                   dtype=dtype), **kw)


@pytest.mark.parametrize("disk_kw", [{}, {"profile": "novikov",
                                          "show_background": False}])
def test_disk_slice_f64_matches_jax(disk_kw):
    scene = _scene()
    dc = jdisk.DiskConfig(**disk_kw)
    j = jdisk.render_disk(scene, dc, bg_array=TEX)
    t = grtrace_torch.render_disk(grtrace_torch.from_jax_scene(scene),
                                  grtrace_torch.from_jax_disk(dc),
                                  bg_array=TEX, device="cpu")
    assert t.counts == j.counts
    assert t.counts["disk"] >= 15 and t.counts["numerical_error"] == 0
    assert np.array_equal(t.cls, np.asarray(j.cls))
    assert np.array_equal(t.status, np.asarray(j.status))
    dm = t.cls == tdisk.CLS_DISK
    np.testing.assert_allclose(t.device("redshift").numpy()[dm],
                               np.asarray(j.device("redshift"))[dm],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(t.device("hit_q").numpy()[dm],
                               np.asarray(j.device("hit_q"))[dm], rtol=0,
                               atol=1e-9)
    diff = np.abs(t.image.astype(int) - np.asarray(j.image).astype(int))
    assert diff.max() <= 1
    dn = np.abs(t.n_steps.astype(np.int64) - np.asarray(j.n_steps))
    assert (dn[t.status != 1] == 0).all() and dn.max() <= 2
    np.testing.assert_allclose(t.q0, np.asarray(j.q0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.p0, np.asarray(j.p0), rtol=0, atol=1e-12)


def test_disk_slice_f32_takes_the_compensated_twin():
    """float32 runs the 32-row twin; its counts stay within two pixels of
    JAX's float64 render, and every disk hit lies in the annulus."""
    scene = _scene(size=12, dtype="float32")
    j = jdisk.render_disk(_scene(size=12), bg_array=TEX)
    metrics = RenderMetrics()
    t = grtrace_torch.render_disk(grtrace_torch.from_jax_scene(scene),
                                  bg_array=TEX, device="cpu",
                                  metrics=metrics)
    assert t.final_q.dtype == np.float32 and t.image.shape == (12, 12, 3)
    assert t.image.dtype == np.uint8
    assert t.counts["numerical_error"] == 0 and t.counts["disk"] > 0
    for k, v in t.counts.items():
        assert abs(v - j.counts[k]) <= 2, k
    dm = t.cls == tdisk.CLS_DISK
    hq = t.device("hit_q").numpy()[dm].astype(np.float64)
    r = np.asarray(tdisk.ks_radius(*(torch.tensor(hq[:, i])
                                     for i in (1, 2, 3)), 0.9))
    assert (r >= np.float32(R_IN) - 1e-5).all() and (r <= 14.0 + 1e-5).all()
    assert np.isfinite(t.device("redshift").numpy()[dm]).all()
    assert set(metrics.stages) == {"texture_upload", "device_pipeline"}
    assert metrics.geodesic_steps == int(t.n_steps.astype(np.int64).sum())


# --- shading pieces --------------------------------------------------------

def test_blackbody_and_temperature_profiles_match_jax():
    kelvin = np.concatenate([np.linspace(500.0, 45000.0, 301),
                             [1899.0, 6600.0, 6600.1]])
    np.testing.assert_allclose(
        tdisk.blackbody_rgb(torch.tensor(kelvin)).numpy(),
        np.asarray(jdisk.blackbody_rgb(jnp.asarray(kelvin))), rtol=1e-12,
        atol=1e-15)
    r = np.linspace(2.0, 20.0, 257)
    r_in = jnp.asarray(R_IN)
    np.testing.assert_allclose(
        tdisk._temp_profile(torch.tensor(r), torch.tensor(R_IN, dtype=F64)
                            ).numpy(),
        np.asarray(jdisk._temp_profile(jnp.asarray(r), r_in)), rtol=1e-12,
        atol=1e-15)
    params = (1.0, 0.9, 0.0)
    jr, jt = jdisk._nt_temp_table(r_in, jnp.asarray(14.0),
                                  jnp.asarray(params), True, jnp.float64)
    tr, tt = tdisk._nt_temp_table(torch.tensor(R_IN, dtype=F64),
                                  torch.tensor(14.0, dtype=F64),
                                  torch.tensor(params, dtype=F64), True, F64)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-14)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-12)


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(2)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 40))
    xp[7] = xp[6]  # a repeated abscissa takes the dx0 branch
    fp = rng.normal(size=40)
    x = np.concatenate([rng.uniform(xp[0] - 2, xp[-1] + 2, 500), xp])
    np.testing.assert_allclose(
        tdisk._interp(torch.tensor(x), torch.tensor(xp),
                      torch.tensor(fp)).numpy(),
        np.asarray(jnp.interp(x, xp, fp)), rtol=1e-14, atol=1e-15)


def test_run_shading_overwrites_only_disk_pixels():
    rng = np.random.default_rng(4)
    h = w = 3
    status = torch.tensor([[3, 2, 1], [3, 3, 0], [2, 2, 3]], dtype=torch.int32)
    hq = torch.zeros((h, w, 4), dtype=torch.float64)
    ang = torch.tensor(rng.uniform(0, 2 * np.pi, (h, w)))
    rad = torch.tensor(rng.uniform(3.0, 13.0, (h, w)))
    hq[..., 1], hq[..., 2] = rad * torch.cos(ang), rad * torch.sin(ang)
    hp = torch.tensor(rng.normal(size=(h, w, 4)))
    hp[..., 0] = -1.0
    image = torch.tensor(rng.integers(0, 255, (h, w, 3)), dtype=torch.uint8)
    kw = dict(height=h, width=w, profile="shakura", prograde=True,
              params=[1.0, 0.9, 0.0], obs_pos=[29.3, 0.0, 6.2], r_in=R_IN,
              r_out=14.0, t_peak=9000.0, exposure=2.5, camera_omega=0.0,
              dtype=torch.float64)
    out = tdisk.run_shading((hq, hp, status, image), **kw)
    dm = status == 3
    assert int(out["disk_count"]) == int(dm.sum())
    assert torch.equal(out["image"][~dm], image[~dm])
    again = tdisk.run_shading((hq, hp, status, image), **kw)
    assert torch.equal(again["image"], out["image"])
    jout = jdisk.run_shading(
        (hq.numpy(), hp.numpy(), status.numpy(), image.numpy()),
        bfield=None, fov=1.0, **{k: v for k, v in kw.items()
                                 if k != "dtype"}, dtype=jnp.float64)
    np.testing.assert_allclose(out["redshift"].numpy()[dm.numpy()],
                               np.asarray(jout["redshift"])[dm.numpy()],
                               rtol=1e-12)
    assert np.abs(out["image"].numpy().astype(int)
                  - np.asarray(jout["image"]).astype(int)).max() <= 1


# --- configuration and the parts left out ----------------------------------

def test_disk_config_matches_jax():
    with pytest.raises(ValueError):
        tdisk.DiskConfig(profile="page")
    with pytest.raises(ValueError):
        tdisk.DiskConfig(bfield="helical")
    with pytest.raises(ValueError):
        tdisk.DiskConfig(camera_omega="spinning")
    j = jdisk.DiskConfig(r_in=3.0, r_out=20.0, prograde=False, t_peak=7e3,
                         exposure=1.5, show_background=False,
                         profile="novikov", emissivity_index=2.0,
                         elevation_deg=30.0)
    t = tdisk.from_jax_disk(j)
    assert t == tdisk.DiskConfig(**vars(j))
    scene = _scene()
    np.testing.assert_array_equal(
        tdisk.disk_observer_position(grtrace_torch.from_jax_scene(scene), t),
        jdisk.disk_observer_position(scene, j))
    for spin, pro in ((0.9, True), (0.9, False), (0.0, True)):
        assert tdisk.DiskConfig(prograde=pro).inner_edge(1.0, spin) == \
            pytest.approx(jdisk.DiskConfig(prograde=pro).inner_edge(1.0,
                                                                     spin),
                          rel=1e-14)
    assert tdisk.resolve_camera_omega(scene, t) == (False, 0.0)


@pytest.mark.parametrize("change,kw,match", [
    ({"bfield": "vertical"}, {}, "item 6"),
    ({"camera_omega": "zamo"}, {}, "item 6"),
    ({"camera_omega": 0.01}, {}, "item 6"),
    ({}, {"aa_samples": 3}, "item 8"),
    ({}, {"charge": 0.3}, "item 8"),
    ({}, {"metric": "rotating-bardeen"}, "item 9"),
])
def test_disk_paths_not_ported_raise(change, kw, match):
    scene = replace(grtrace_torch.SceneConfig(size=8, metric="kerr",
                                              spin=0.9, n_samples=0),
                    **{k: v for k, v in kw.items() if k != "aa_samples"})
    with pytest.raises(NotImplementedError, match=match):
        grtrace_torch.render_disk(
            scene, grtrace_torch.DiskConfig(**change), device="cpu",
            aa_samples=kw.get("aa_samples"))


def test_charged_disk_with_an_explicit_inner_edge_renders():
    scene = replace(grtrace_torch.from_jax_scene(_scene(size=4)),
                    charge=0.3)
    t = grtrace_torch.render_disk(scene, grtrace_torch.DiskConfig(r_in=3.0),
                                  device="cpu")
    assert sum(t.counts.values()) - t.counts["background"] == 16


def test_render_disk_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = grtrace_torch.SceneConfig(size=8, metric="kerr", spin=0.9,
                                      n_samples=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        grtrace_torch.render_disk(scene)


# --- the kernel-vs-twin parity check of the disk mode ---------------------

PARITY_PARAMS = (1.0, 0.9, 0.0)


def _parity_rays(dtype):
    scene = grtrace_torch.SceneConfig(size=6)
    obs = torch.tensor(tdisk.disk_observer_position(
        scene, tdisk.DiskConfig()), dtype=dtype)
    pix = tdisk.pixel_grid_lookat(obs, torch.tensor(scene.fov, dtype=dtype),
                                  6, 6, dtype=dtype)
    q0, p0, _ = tdisk.cartesian_ics_from_pixels(
        obs, pix, params=PARITY_PARAMS, g_inv_fn=tdisk.kerr_schild_g_inv)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def _fake_disk_kernel(change, calls):
    """Stands in for the B6 wrapper on CPU rays: the twin's outputs, with
    one element of one output changed by the least step, or one ray's hit
    flag flipped."""
    def kernel(q0, p0, steps, delta, params, r_max, omega, r_in, r_out,
               order=2, compensated=True):
        calls.append(compensated)
        twin = (tks.integrate_batch_disk_ksc if compensated
                else tks.integrate_batch_disk_ks)
        out = [t.clone() for t in twin(q0, p0, steps, delta, params, r_max,
                                       omega, r_in, r_out, order=order)]
        hit = (out[2] == tks.STATUS_DISK).nonzero()[0, 0]
        if change in ("hit_q", "hit_p"):
            row = out[4 if change == "hit_q" else 5][hit]
            row[2] = torch.nextafter(row[2], row.new_tensor(float("inf")))
        elif change == "hit":
            out[2][hit] = 2
        return tuple(out)
    return kernel


@pytest.mark.parametrize("compensated,dtype", [
    (True, torch.float32), (False, torch.float32), (False, torch.float64)])
def test_disk_kernel_parity_holds_the_kernel_to_its_twin(monkeypatch,
                                                          compensated, dtype):
    calls = []
    monkeypatch.setattr(integrate_ks_cuda, "integrate_batch_disk_cuda",
                        _fake_disk_kernel(None, calls))
    q0, p0 = _parity_rays(dtype)
    kern, res = tval.ks_kernel_parity(q0, p0, 500, 0.05, PARITY_PARAMS,
                                      compensated=compensated,
                                      disk=(R_IN, 14.0))
    assert calls == [compensated] and len(kern) == 6
    assert (kern[2] == tks.STATUS_DISK).any()
    assert res["status_mismatch"] == res["n_steps_mismatch"] == 0
    assert res["hit_mismatch"] == 0 and res["max_abs_err"] == 0.0
    assert all(res[k] for k in ("q_bitwise_equal", "p_bitwise_equal",
                                "hit_q_bitwise_equal", "hit_p_bitwise_equal"))


@pytest.mark.parametrize("change", ["hit_q", "hit_p", "hit"])
def test_disk_kernel_parity_sees_one_difference(monkeypatch, change):
    monkeypatch.setattr(integrate_ks_cuda, "integrate_batch_disk_cuda",
                        _fake_disk_kernel(change, []))
    q0, p0 = _parity_rays(torch.float32)
    _, res = tval.ks_kernel_parity(q0, p0, 500, 0.05, PARITY_PARAMS,
                                   disk=(R_IN, 14.0))
    assert res["hit_q_bitwise_equal"] == (change != "hit_q")
    assert res["hit_p_bitwise_equal"] == (change != "hit_p")
    assert res["hit_mismatch"] == (change == "hit")
    assert res["status_mismatch"] == (change == "hit")
    assert (res["max_abs_err"] > 0.0) == (change != "hit")
    assert res["q_bitwise_equal"] and res["p_bitwise_equal"]


def test_disk_kernel_parity_needs_cuda_rays():
    """No fallback: on CPU rays the B6 wrapper raises."""
    q0, p0 = _parity_rays(torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tval.ks_kernel_parity(q0, p0, 100, 0.05, PARITY_PARAMS,
                              disk=(R_IN, 14.0))
