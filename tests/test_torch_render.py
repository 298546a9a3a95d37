"""The port's classification, compositing and end-to-end render against the
JAX package, on the CPU (device='cpu': the kernel's eager twin).

* classify_rays / composite: identical outputs from identical float64
  final states (class codes and images equal; angles to 1e-12).
* the slice: the 64x64 golden scene (tools/gen_golden_image.py) rendered
  through `from_jax_scene`.  float64 reproduces the golden counts, with at
  most 0.1% of pixels differing (it is bit-exact today); float32 keeps
  test_golden_image.py's budget (no numerical errors, |dcaptured| <= 4,
  <= 1% of pixels differing).

The comparisons that take seconds are in tests/test_torch_render_golden.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace.engine import classify as jcls
from grtrace.engine import integrate as ji
from grtrace.physics import camera as jcam
from grtrace_torch.engine import classify as tcls
from grtrace_torch.io.textures import checker

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traced():
    """Float64 camera + final states of a 24x24 frame (JAX integrator)."""
    q0, p0, alpha0, _, beta = jcam.camera_rays(
        np.array([30.0, 0.0, 0.0]), np.radians(80.0), 24, 24,
        dtype=jnp.float64)
    fq, _, _, _ = ji.integrate_batch(q0.reshape(-1, 4), p0.reshape(-1, 4),
                                     3000, 0.05, 2.0, 31.0, 1.0)
    return (np.asarray(fq).reshape(24, 24, 4), np.asarray(alpha0),
            np.asarray(beta))


PATCHES = {
    "full_sphere": (np.pi / 2, np.pi, np.pi, 2 * np.pi),
    "patch": (1.2, 2.5, 1.0, 2.0),
}


@pytest.mark.parametrize("patch", sorted(PATCHES))
@pytest.mark.parametrize("flip_theta,flip_phi,has_bg", [
    (False, False, True), (True, False, True), (False, True, True),
    (False, False, False)])
def test_classify_and_composite_match_jax(traced, patch, flip_theta,
                                          flip_phi, has_bg):
    fq, alpha0, beta = traced
    ct, cp, st, sp = PATCHES[patch]
    kw = dict(flip_theta=flip_theta, flip_phi=flip_phi, has_background=has_bg)
    j = jcls.classify_rays(
        jnp.asarray(fq), jnp.asarray(alpha0), jnp.asarray(beta),
        rs=jnp.asarray(2.0), r_obs_x=jnp.asarray(30.0),
        boundary_radius=jnp.asarray(31.0), patch_center_theta=jnp.asarray(ct),
        patch_center_phi=jnp.asarray(cp), patch_size_theta=jnp.asarray(st),
        patch_size_phi=jnp.asarray(sp), **kw)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    t = tcls.classify_rays(
        torch.tensor(fq), torch.tensor(alpha0), torch.tensor(beta),
        rs=f64(2.0), r_obs_x=f64(30.0), boundary_radius=f64(31.0),
        patch_center_theta=f64(ct), patch_center_phi=f64(cp),
        patch_size_theta=f64(st), patch_size_phi=f64(sp), **kw)
    j = [np.asarray(x) for x in j]
    t = [x.numpy() for x in t]
    assert np.array_equal(t[0], j[0])
    assert len(np.unique(t[0])) >= 2
    for a, b in zip(t[1:], j[1:]):
        ok = np.isfinite(b)
        np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=1e-12)
    tex = checker(32, 48)
    jimg = np.asarray(jcls.composite(jnp.asarray(j[0]), jnp.asarray(j[3]),
                                     jnp.asarray(j[4]), jnp.asarray(tex)))
    timg = tcls.composite(torch.tensor(j[0]), torch.tensor(j[3]),
                          torch.tensor(j[4]), torch.tensor(tex)).numpy()
    assert np.array_equal(timg, jimg)
    jc = {k: int(v) for k, v in jcls.summary_counts(jnp.asarray(j[0])).items()}
    assert tcls.summary_counts(torch.tensor(t[0])) == jc


def test_from_jax_scene_maps_every_field():
    from grtrace import IntegratorConfig, PatchConfig, SceneConfig
    j = SceneConfig(size=33, fov_deg=60.0, bh_mass=1.5, boundary_radius=40.0,
                    observer_distance=35.0, n_samples=2,
                    integrator=IntegratorConfig(steps=1234, delta=0.02,
                                                omega=0.5, order=4,
                                                backend="pallas"),
                    patch=PatchConfig(center_phi=1.0, flip_phi=True))
    t = grtrace_torch.from_jax_scene(j)
    for f in ("size", "fov_deg", "bh_mass", "boundary_radius",
              "observer_distance", "n_samples", "metric", "spin", "charge"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("steps", "delta", "omega", "order", "dtype"):
        assert getattr(t.integrator, f) == getattr(j.integrator, f), f
    assert t.integrator.backend == "cuda"
    assert t.patch.center_phi == 1.0 and t.patch.flip_phi
    assert t.fov == j.fov and t.image_size == j.image_size


@pytest.mark.parametrize("change,kw", [
    ({"metric": "kerr-bl"}, {}), ({"metric": "bardeen"}, {}),
    ({"metric": "kerr-ds", "charge": 0.3}, {}), ({}, {"aa_samples": 4})])
def test_unported_scenes_raise(change, kw):
    """The scenes ROADMAP items 5b, 8b and 9 ported render on the CPU:
    'kerr-bl' at 8x8 through the Boyer-Lindquist chart, 'bardeen' at 8x8
    through the static chart, 'kerr-ds' (its scene.charge ignored, as
    JAX's route ignores it: Lambda is scene.metric_param) at 8x8 through
    the Carter chart, and aa_samples refines the 8x8 headline frame's
    shadow edge (s = 4)."""
    from dataclasses import replace
    scene = replace(grtrace_torch.SceneConfig(size=8), **change)
    if kw.get("aa_samples"):
        scene = replace(scene, n_samples=0, background=None,
                        integrator=grtrace_torch.IntegratorConfig(
                            steps=400, delta=0.2))
        res = grtrace_torch.render(scene, device="cpu", **kw)
        base = grtrace_torch.render(scene, device="cpu")
        assert res.aa_mask.any() and not res.aa_mask.all()
        assert np.array_equal(res.cls, base.cls)
        assert res.counts == base.counts
        return
    if change.get("metric") in ("kerr-bl", "bardeen", "kerr-ds"):
        scene = replace(scene, n_samples=0, background=None,
                        integrator=grtrace_torch.IntegratorConfig(
                            steps=100, delta=0.2))
        res = grtrace_torch.render(scene, device="cpu", **kw)
        assert res.image.shape == (8, 8, 3)
        assert res.counts["numerical_error"] == 0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        grtrace_torch.render(scene, device="cpu", **kw)


def test_render_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        grtrace_torch.render(grtrace_torch.SceneConfig(size=8))


@pytest.mark.parametrize("cls", ["RenderResult", "SubringResult"])
def test_result_has_optional_fields(cls):
    """`has(name)`, as grtrace.engine.render.RenderResult has it: whether
    the render produced an optional per-pixel field."""
    from grtrace_torch.engine.render import RenderResult
    from grtrace_torch.engine.subring import SubringResult
    kind = {"RenderResult": RenderResult, "SubringResult": SubringResult}[cls]
    base = {"image": torch.zeros((2, 2, 3), dtype=torch.uint8),
            "status": torch.zeros((2, 2), dtype=torch.int32)}
    without = kind(dict(base), {"captured": 0})
    with_evpa = kind(dict(base, evpa=torch.zeros((2, 2))), {"captured": 0})
    assert without.has("image") and without.has("status")
    assert not without.has("evpa")
    assert with_evpa.has("evpa") and with_evpa.has("image")
    assert not with_evpa.has("polarization")

