"""The port's Kerr render (the Kerr-Schild chart) against the JAX package,
on the CPU (device='cpu': the eager twins of kernel B5).

* The slice as a whole: `grtrace_torch.render` of a 16x16 Kerr a = 0.9
  scene, 1,200 steps at delta 0.05, float64, against JAX's
  `render_pixels_generic(metric='KerrSchild', backend='xla')` (the generic
  autodiff engine, JAX's CPU path): equal count vectors, class maps,
  statuses and images, pixel for pixel; step counts equal except that a
  captured ray may trip the guard up to 2 steps apart (the staggered
  composition rounds differently at the last ulp and the horizon blow-up
  amplifies it, as tests/test_pallas_ks.py records).  Also Kerr-Newman
  (charge 0.3) and a charged Schwarzschild scene, which JAX routes to the
  Kerr-Schild chart.
* Routing, the parts left out, `from_jax_scene` on a Kerr scene, and the
  Kerr validation checks (Bardeen predicate, shadow boundary).  The
  kernel-vs-twin parity check runs on the card; here it is held, with a
  stand-in for the kernel, to seeing a one-ulp or one-count difference.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine import validate as jval
from grtrace.engine.render_generic import render_pixels_generic
from grtrace_torch.engine import integrate_ks as tik
from grtrace_torch.engine import integrate_ks_cuda
from grtrace_torch.engine import validate as tval
from grtrace_torch.engine.metrics import RenderMetrics
from grtrace_torch.io.textures import checker
from grtrace_torch.physics.camera import camera_rays_cartesian
from grtrace_torch.physics.spacetime import kerr_schild_g_inv

torch.set_num_threads(1)

TEX = checker(32, 48)
PATCH = PatchConfig(center_theta=1.4, center_phi=2.8, size_theta=1.6,
                    size_phi=3.0)
PARITY_PARAMS = (1.0, 0.9, 0.0)


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


@pytest.mark.parametrize("change,kw,match", [
    ({"metric": "kerr-bl"}, {}, "item 5b"),
    ({"metric": "kerr", "spin": 0.9}, {"aa_samples": 3}, "item 8"),
    ({"metric": "kerr", "spin": 0.9}, {"n_samples": 2}, "item 5b"),
    ({"metric": "rotating-hayward"}, {}, "item 9"),
])
def test_kerr_paths_not_ported_raise(change, kw, match):
    scene = replace(grtrace_torch.SceneConfig(size=8, n_samples=0), **change)
    with pytest.raises(NotImplementedError, match=match):
        grtrace_torch.render(scene, device="cpu", **kw)


def test_kerr_render_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = grtrace_torch.SceneConfig(size=8, metric="kerr", spin=0.9,
                                      n_samples=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        grtrace_torch.render(scene)


def test_from_jax_scene_carries_a_kerr_scene():
    j = SceneConfig(size=24, metric="kerr", spin=0.95, charge=0.2,
                    metric_param=0.1, n_samples=0,
                    integrator=IntegratorConfig(steps=30000, delta=0.02,
                                                backend="pallas"))
    t = grtrace_torch.from_jax_scene(j)
    for f in ("size", "metric", "spin", "charge", "metric_param", "fov_deg",
              "bh_mass", "boundary_radius", "observer_distance",
              "n_samples"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("steps", "delta", "omega", "order", "dtype"):
        assert getattr(t.integrator, f) == getattr(j.integrator, f), f
    assert t.integrator.backend == "cuda"


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


def _parity_rays(dtype):
    obs = torch.tensor([tval.R0, 0.0, 0.0], dtype=dtype)
    q0, p0, _ = camera_rays_cartesian(
        obs, torch.tensor(tval.FOV, dtype=dtype), 4, 4,
        params=PARITY_PARAMS, g_inv_fn=kerr_schild_g_inv, dtype=dtype,
        device="cpu")
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def _fake_kernel(change, calls):
    """Stands in for the CUDA wrapper on CPU rays: the twin's outputs, with
    one element of one output changed by the least step."""
    def kernel(q0, p0, steps, delta, params, r_max, omega, order=2,
               compensated=True):
        calls.append(compensated)
        twin = (tik.integrate_batch_ksc if compensated
                else tik.integrate_batch_ks)
        out = [t.clone() for t in twin(q0, p0, steps, delta, params, r_max,
                                       omega, order=order)]
        if change in ("q", "p"):
            flat = out["qp".index(change)].view(-1)
            flat[5] = torch.nextafter(flat[5], flat.new_tensor(float("inf")))
        elif change in ("status", "n_steps"):
            out[2 if change == "status" else 3][0] += 1
        return tuple(out)
    return kernel


@pytest.mark.parametrize("compensated,dtype", [
    (True, torch.float32), (False, torch.float32), (False, torch.float64)])
def test_ks_kernel_parity_holds_the_kernel_to_its_twin(monkeypatch,
                                                        compensated, dtype):
    calls = []
    monkeypatch.setattr(integrate_ks_cuda, "integrate_batch_ks_cuda",
                        _fake_kernel(None, calls))
    q0, p0 = _parity_rays(dtype)
    kern, res = tval.ks_kernel_parity(q0, p0, 200, 0.05, PARITY_PARAMS,
                                      compensated=compensated)
    assert calls == [compensated] and kern[0].dtype == dtype
    assert res["status_mismatch"] == 0 and res["n_steps_mismatch"] == 0
    assert res["q_bitwise_equal"] and res["p_bitwise_equal"]
    assert res["max_abs_err"] == 0.0
    assert res["kernel_ms"] >= 0.0 and res["twin_ms"] >= 0.0


@pytest.mark.parametrize("change", ["q", "p", "status", "n_steps"])
def test_ks_kernel_parity_sees_one_difference(monkeypatch, change):
    monkeypatch.setattr(integrate_ks_cuda, "integrate_batch_ks_cuda",
                        _fake_kernel(change, []))
    q0, p0 = _parity_rays(torch.float32)
    _, res = tval.ks_kernel_parity(q0, p0, 200, 0.05, PARITY_PARAMS)
    assert res["q_bitwise_equal"] == (change != "q")
    assert res["p_bitwise_equal"] == (change != "p")
    assert res["status_mismatch"] == (change == "status")
    assert res["n_steps_mismatch"] == (change == "n_steps")
    assert (res["max_abs_err"] > 0.0) == (change in ("q", "p"))


def test_ks_kernel_parity_needs_cuda_rays():
    """No fallback: on CPU rays the kernel's wrapper raises."""
    q0, p0 = _parity_rays(torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tval.ks_kernel_parity(q0, p0, 200, 0.05, PARITY_PARAMS)
