"""The Kerr render against the JAX package (part of
tests/test_torch_render_kerr.py, whose docstring states the tolerances):
the float64 slices (Kerr, Kerr-Newman, charged Schwarzschild), float32
through the 32-row twin, the Bardeen predicate, and the shadow boundary
through the eager twin.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import grtrace_torch
from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine import validate as jval
from grtrace.engine.render_generic import render_pixels_generic
from grtrace_torch.engine import validate as tval
from grtrace_torch.engine.metrics import RenderMetrics
from grtrace_torch.io.textures import checker


TEX = checker(32, 48)


PATCH = PatchConfig(center_theta=1.4, center_phi=2.8, size_theta=1.6,
                    size_phi=3.0)


def _scene(metric="kerr", spin=0.9, charge=0.0, dtype="float64", size=16,
           steps=1200, delta=0.05):
    return SceneConfig(size=size, metric=metric, spin=spin, charge=charge,
                       background=None, patch=PATCH, n_samples=0,
                       integrator=IntegratorConfig(steps=steps, delta=delta,
                                                   backend="xla",
                                                   dtype=dtype))


def _jax_render(scene, spin):
    dt = jnp.float64
    p = scene.patch
    out = render_pixels_generic(
        jnp.asarray(TEX), dt(scene.observer_distance), dt(scene.fov),
        dt(scene.bh_mass), dt(spin), dt(scene.boundary_radius),
        scene.integrator.steps, dt(scene.integrator.delta),
        dt(scene.integrator.omega), dt(p.center_theta), dt(p.center_phi),
        dt(p.size_theta), dt(p.size_phi), height=scene.size,
        width=scene.size, dtype=dt, metric="KerrSchild", backend="xla",
        charge=dt(scene.charge))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("metric,spin,charge", [
    ("kerr", 0.9, 0.0), ("kerr-schild", 0.9, 0.3),
    ("schwarzschild", 0.0, 0.3)])
def test_kerr_slice_f64_matches_jax(metric, spin, charge):
    scene = _scene(metric, spin, charge)
    j = _jax_render(scene, spin)
    t = grtrace_torch.render(grtrace_torch.from_jax_scene(scene),
                             bg_array=TEX, device="cpu")
    counts = [t.counts[k] for k in ("captured", "in_domain", "escaped",
                                    "background", "numerical_error")]
    assert counts == j["count_vec"].tolist()
    assert counts[0] > 0 and counts[3] > 0 and counts[2] > counts[3]
    assert np.array_equal(t.cls, j["cls"])
    assert np.array_equal(t.status, j["status"])
    assert np.array_equal(t.image, j["image"])
    dn = np.abs(t.n_steps.astype(np.int64) - j["n_steps"])
    assert (dn[j["status"] != 1] == 0).all() and dn.max() <= 2
    free = j["status"] == 2
    np.testing.assert_allclose(t.final_q[free], j["final_q"][free],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.q0, j["q0"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.p0, j["p0"], rtol=0, atol=1e-12)
    assert t.heading.shape == (16, 16, 3) and not t.beta.any()


def test_kerr_slice_f32_takes_the_compensated_twin():
    """float32 runs the 32-row twin; its counts stay within a few boundary
    pixels of the float64 JAX render (the f32 shadow edge is sub-pixel,
    tests/test_torch_integrate_ks.py)."""
    scene = _scene(dtype="float32", size=12)
    j = _jax_render(scene, 0.9)
    metrics = RenderMetrics()
    t = grtrace_torch.render(grtrace_torch.from_jax_scene(scene),
                             bg_array=TEX, device="cpu", metrics=metrics)
    assert t.final_q.dtype == np.float32 and t.image.shape == (12, 12, 3)
    assert t.counts["numerical_error"] == 0
    diff = np.abs(np.array(list(t.counts.values()))
                  - j["count_vec"]).max()
    assert diff <= 2
    assert (t.cls != j["cls"]).mean() <= 0.02
    assert set(metrics.stages) == {"texture_upload", "device_pipeline"}
    assert metrics.geodesic_steps == int(t.n_steps.astype(np.int64).sum())


def test_bardeen_escapes_match_jax():
    rhos = np.stack([np.linspace(10.0, 34.0, 13)] * jval.N_PSI)
    for spin, charge in ((0.9, 0.0), (0.6, 0.4)):
        j = jval.bardeen_escapes(rhos, spin, charge)
        t = tval.bardeen_escapes(rhos, spin, charge)
        assert np.array_equal(t, j)
        assert not t[:, 0].any() and t[:, -1].all()
    np.testing.assert_allclose(tval._pixel_positions(rhos, 0.3),
                               jval._pixel_positions(rhos, 0.3), rtol=0,
                               atol=0)


def test_kerr_shadow_errors_cpu():
    """The boundary check through the eager twin: sub-pixel against
    Bardeen, at a short budget that still settles every probe ray."""
    out = tval.kerr_shadow_errors(steps=2000, delta=0.05, order=2,
                                  device="cpu")
    assert out["px_err_max"] < 0.05, out
    assert out["bracket_px"] < 0.05 and len(out["px_err"]) == tval.N_PSI
    ana, _ = jval.bisect_boundary(
        lambda r: jval.bardeen_escapes(r, 0.9), 10.0, 34.0, rounds=4)
    np.testing.assert_allclose(out["rho_bardeen"], ana, atol=1e-3)
