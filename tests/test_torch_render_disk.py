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

The comparisons that take seconds are in tests/test_torch_render_disk_jax.py
and tests/test_torch_render_disk_parity.py.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace_torch.physics.epicyclic import isco_from_kappa
from grtrace.engine import disk as jdisk
from grtrace.io.scene import IntegratorConfig, SceneConfig
from grtrace_torch.engine import disk as tdisk
from grtrace_torch.engine import validate as tval

torch.set_num_threads(1)

R_IN = float(tdisk.isco_radius(1.0, 0.9))


def _scene(size=16, dtype="float64", spin=0.9, **kw):
    return SceneConfig(size=size, metric="kerr", spin=spin, n_samples=0,
                       background=None,
                       integrator=IntegratorConfig(steps=1500, delta=0.05,
                                                   dtype=dtype), **kw)


# --- shading pieces --------------------------------------------------------


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
    ({"bfield": "vertical"}, {"aa_samples": 3}, None),
    ({"camera_omega": "zamo"}, {"charge": 0.3}, "item 8"),
    ({"camera_omega": 0.01}, {"metric": "rotating-bardeen"},
     "Kerr-Newman disk path only"),
    ({"camera_omega": "zamo"}, {"aa_samples": 3}, None),
    ({}, {"charge": 0.3}, "item 8"),
    ({}, {"metric": "rotating-bardeen", "aa_samples": 3}, "sub-ray chain"),
    ({"bfield": "vertical"}, {"metric": "rotating-hayward"},
     "Walker-Penrose"),
])
def test_disk_paths_not_ported_raise(change, kw, match):
    """The disk paths the port does not have raise NotImplementedError
    naming their ROADMAP item, and the rotating regular families refuse an
    orbiting camera, aa_samples and bfield with JAX's messages;
    aa_samples (item 8b; match None) refines
    the 8x8 disk frame, polarized or seen from a moving camera, leaving
    the class map, the counts and the science maps alone; a charged hole
    (item 8, its 8d: the autodiff ISCO) renders, its inner edge the root
    of kappa^2."""
    scene = replace(grtrace_torch.SceneConfig(size=8, metric="kerr",
                                              spin=0.9, n_samples=0),
                    **{k: v for k, v in kw.items() if k != "aa_samples"})
    if match == "item 8":
        scene = replace(scene, integrator=grtrace_torch.IntegratorConfig(
            steps=400, delta=0.2))
        dc = grtrace_torch.DiskConfig(**change)
        res = grtrace_torch.render_disk(scene, dc, device="cpu")
        assert sum(res.counts.values()) >= 64 and res.counts["disk"] > 0
        assert dc.inner_edge(1.0, 0.9, 0.3) == pytest.approx(
            float(isco_from_kappa([1.0, 0.9, 0.3])), rel=1e-15)
        return
    if match is None:
        scene = replace(scene, integrator=grtrace_torch.IntegratorConfig(
            steps=400, delta=0.2))
        res, base = (grtrace_torch.render_disk(
            scene, grtrace_torch.DiskConfig(**change), device="cpu",
            aa_samples=aa) for aa in (kw["aa_samples"], None))
        assert res.aa_mask.any() and res.counts == base.counts
        assert np.array_equal(res.cls, base.cls)
        for k in ("redshift", "evpa") if change.get("bfield") else (
                "redshift",):
            assert torch.equal(torch.nan_to_num(res.device(k)),
                               torch.nan_to_num(base.device(k))), k
        return
    with pytest.raises(NotImplementedError, match=match):
        grtrace_torch.render_disk(
            scene, grtrace_torch.DiskConfig(**change), device="cpu",
            aa_samples=kw.get("aa_samples"))


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


def test_disk_kernel_parity_needs_cuda_rays():
    """No fallback: on CPU rays the B6 wrapper raises."""
    q0, p0 = _parity_rays(torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tval.ks_kernel_parity(q0, p0, 100, 0.05, PARITY_PARAMS,
                              disk=(R_IN, 14.0))
