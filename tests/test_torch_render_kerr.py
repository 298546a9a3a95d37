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

The comparisons that take seconds are in
tests/test_torch_render_kerr_jax.py.
"""
from dataclasses import replace

import pytest
import torch

import grtrace_torch
from grtrace import IntegratorConfig, SceneConfig
from grtrace_torch.engine import integrate_ks as tik
from grtrace_torch.engine import integrate_ks_cuda
from grtrace_torch.engine import validate as tval
from grtrace_torch.physics.camera import camera_rays_cartesian
from grtrace_torch.physics.spacetime import kerr_schild_g_inv

torch.set_num_threads(1)

PARITY_PARAMS = (1.0, 0.9, 0.0)


@pytest.mark.parametrize("change,kw,match", [
    ({"metric": "kerr-bl"}, {"n_samples": 2}, None),
    ({"metric": "kerr", "spin": 0.9, "integrator":
      grtrace_torch.IntegratorConfig(steps=400, delta=0.2)},
     {"aa_samples": 3}, None),
    ({"metric": "kerr", "spin": 0.9}, {"n_samples": 2}, None),
    ({"metric": "kerr-ds", "spin": 0.8, "metric_param": 1e-3},
     {"n_samples": 2}, None),
    ({"metric": "rotating-hayward", "spin": 0.9, "metric_param": 0.2},
     {"n_samples": 2}, None),
])
def test_kerr_paths_not_ported_raise(change, kw, match):
    """The Kerr paths items 5b, 8b and 9 ported (match None: the
    Boyer-Lindquist chart, the Kerr sampler, antialiasing, the rotating
    regular families and Kerr-de Sitter with their samplers) render at
    8x8; a path the port lacks would raise NotImplementedError."""
    scene = replace(grtrace_torch.SceneConfig(
        size=8, n_samples=0, background=None,
        integrator=grtrace_torch.IntegratorConfig(steps=100, delta=0.2)),
        **change)
    if match is None:
        res = grtrace_torch.render(scene, device="cpu", **kw)
        assert sum(res.counts[k] for k in ("captured", "in_domain",
                                           "escaped")) == 64
        assert len(res.sampled_trajectories or []) == kw.get("n_samples", 0)
        assert res.has("aa_mask") == bool(kw.get("aa_samples"))
        if kw.get("aa_samples"):
            assert res.aa_mask.any()
        return
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
