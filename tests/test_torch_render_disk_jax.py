"""The thin-disk render against the JAX package (part of
tests/test_torch_render_disk.py, whose docstring states the tolerances):
the float64 slice as a whole, float32 through the 32-row twin, the
shading pieces (blackbody colors and temperature profiles), and a charged
disk with an explicit inner edge.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace.engine import disk as jdisk
from grtrace_torch.engine import disk as tdisk
from grtrace_torch.engine.metrics import RenderMetrics
from grtrace_torch.io.textures import checker
from test_torch_render_disk import R_IN, _scene

torch.set_num_threads(1)


TEX = checker(32, 48)


F64 = torch.float64


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


def test_charged_disk_with_an_explicit_inner_edge_renders():
    scene = replace(grtrace_torch.from_jax_scene(_scene(size=4)),
                    charge=0.3)
    t = grtrace_torch.render_disk(scene, grtrace_torch.DiskConfig(r_in=3.0),
                                  device="cpu")
    assert sum(t.counts.values()) - t.counts["background"] == 16
