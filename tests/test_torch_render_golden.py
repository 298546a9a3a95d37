"""The 64x64 golden scene rendered in float64 and float32, and the render's
sampled trajectories against JAX's (part of tests/test_torch_render.py,
whose docstring states the tolerances).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace_torch.engine.metrics import RenderMetrics

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_golden_image import scene_and_texture  # noqa: E402


GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "render_64_schwarzschild.npz")


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    return z["image"], z["cls"], z["counts"]


def _render_golden_scene(dtype_str, **kw):
    scene, tex = scene_and_texture()
    scene.integrator.dtype = dtype_str
    return grtrace_torch.render(grtrace_torch.from_jax_scene(scene),
                                bg_array=tex, device="cpu", **kw)


def _counts(res):
    return np.array([res.counts[k] for k in ("captured", "in_domain",
                                             "escaped", "background",
                                             "numerical_error")])


def test_golden_scene_f64(golden):
    img, cls, counts = golden
    res = _render_golden_scene("float64")
    assert np.array_equal(_counts(res), counts)
    frac = (res.image != img).any(axis=-1).mean()
    assert frac <= 0.001, f"{frac:.2%} of f64 pixels differ from the golden"


def test_golden_scene_f32(golden):
    img, cls, counts = golden
    metrics = RenderMetrics()
    res = _render_golden_scene("float32", metrics=metrics)
    assert res.counts["numerical_error"] == 0
    assert abs(res.counts["captured"] - int(counts[0])) <= 4
    frac = (res.image != img).any(axis=-1).mean()
    assert frac <= 0.01, f"{frac:.2%} of f32 pixels differ from the golden"
    # stage timers and counters
    assert set(metrics.stages) == {"texture_upload", "device_pipeline"}
    assert metrics.rays == 64 * 64
    assert metrics.geodesic_steps == int(res.n_steps.astype(np.int64).sum())
    # lazy fetch: device tensors until read, numpy after
    assert isinstance(res.device("cls"), torch.Tensor)
    assert isinstance(res.cls, np.ndarray) and res.cls.shape == (64, 64)
    assert res.final_q.dtype == np.float32
    assert res.image.shape == (64, 64, 3) and res.image.dtype == np.uint8


def test_sampled_trajectories_match_jax():
    """n_samples > 0: same pixels as the JAX render (numpy default_rng),
    and the decimated trajectories agree in float64."""
    from grtrace import IntegratorConfig, PatchConfig, SceneConfig, render
    scene = SceneConfig(size=12, background=None,
                        integrator=IntegratorConfig(steps=300, delta=0.05,
                                                    backend="xla",
                                                    dtype="float64"),
                        patch=PatchConfig(), n_samples=3)
    j = render(scene, n_samples=3, seed=4, dtype=jnp.float64)
    t = grtrace_torch.render(grtrace_torch.from_jax_scene(scene), n_samples=3,
                             seed=4, device="cpu")
    assert np.array_equal(t.sampled_indices, j.sampled_indices)
    assert t.counts == j.counts
    for a, b in zip(t.sampled_trajectories, j.sampled_trajectories):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
