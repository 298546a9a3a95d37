"""The adaptive antialiasing passes of the port on the render paths of the
Schwarzschild and Kerr frames (`engine/aa.py`: refine_edges_schwarzschild,
refine_edges_generic in the Kerr-Schild and Boyer-Lindquist charts), on
the CPU twins, at 20x20 in float64 (tests/test_aa.py's scenes, at fewer
steps).

* The supersampling identity, port only: with s = 2 every sub-ray sits at
  a pixel of the 40x40 frame bit for bit, so a refined pixel equals that
  frame's 2x2 block averaged (float32 mean, + 0.5, clipped) exactly;
  unrefined pixels, the class map and the counts equal the base render's.
* Against the JAX package's AA render of the same scene, on the
  checker(32, 48) sky of test_torch_render_kerr_jax.py: aa_mask, the class
  map and the counts equal.  The Schwarzschild image equals JAX's exactly.
  The Kerr images cannot, in float64, because the packages' final states
  agree at roundoff, not bit for bit (XLA contracts multiply-adds, ROADMAP
  Queue C), and these coarse scenes (delta 0.15) hold rays that amplify
  that roundoff into a different path:
    - Kerr-Schild: 2 refined pixels, (8, 10) and (11, 10), each with one
      sub-ray that grazes the horizon between captured neighbours and
      escapes after 291 steps at theta 0.680 in the port and after 294
      at theta 0.821 in JAX (the 40x40 frame's rays (16, 20) and
      (23, 20)); the base images are equal.
    - Boyer-Lindquist: 2 unrefined pixels, (5, 9) and (14, 9), whose
      centre rays pass near the pole (the chart's sin(theta) -> 0) and
      end after 373 / 320 and 320 / 321 steps (port / JAX), phi apart by
      up to 1150 rad; the path's own parity test
      (test_torch_generic_jax.py) holds its class map, not its image.
  So a Kerr image may differ at those 2 pixels and no more, each refined
  or with a centre ray whose step count differs from JAX's.

Each scene runs once per module: the port's base, AA and 2N renders and
JAX's AA render.  At most six tests a file (pytest-xdist's --dist
loadfile hands out the files with the most tests first).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace
import grtrace_torch
from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine.render_generic import render_generic as jrender_generic
from grtrace_torch.io.textures import checker

torch.set_num_threads(1)

SIZE, S = 20, 2


def box_average(image, size, s=S):
    """The 2N frame's s x s blocks averaged with aa.py's rounding."""
    blocks = np.asarray(image, np.float32).reshape(size, s, size, s, 3)
    return np.clip(blocks.mean(axis=(1, 3)) + 0.5, 0, 255).astype(np.uint8)


TEX = checker(32, 48)


def _scene(n, **kw):
    return SceneConfig(size=n, n_samples=0, patch=PatchConfig(),
                       integrator=IntegratorConfig(steps=500, delta=0.15,
                                                   backend="xla",
                                                   dtype="float64"), **kw)


# kind -> (scene keywords, JAX render of the AA frame)
# the pixels whose image may differ from JAX's (docstring)
MAX_DIFFER = {"schwarzschild": 0, "kerr_schild": 2, "boyer_lindquist": 2}
SCENES = {
    "schwarzschild": ({}, lambda sc, bg: grtrace.render(
        sc, bg_array=bg, dtype=jnp.float64, aa_samples=S)),
    "kerr_schild": ({"metric": "kerr", "spin": 0.8},
                    lambda sc, bg: jrender_generic(
                        sc, metric="KerrSchild", bg_array=bg,
                        dtype=jnp.float64, aa_samples=S)),
    "boyer_lindquist": ({"metric": "kerr-bl", "spin": 0.8},
                        lambda sc, bg: jrender_generic(
                            sc, metric="Kerr", bg_array=bg,
                            dtype=jnp.float64, aa_samples=S)),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(kind):
        if kind not in cache:
            kw, jax_aa = SCENES[kind]
            bg = TEX

            def port(n, **aa):
                return grtrace_torch.render(
                    grtrace_torch.from_jax_scene(_scene(n, **kw)),
                    bg_array=bg, device="cpu", **aa)
            cache[kind] = {"base": port(SIZE),
                           "aa": port(SIZE, aa_samples=S),
                           "hi": port(S * SIZE),
                           "jax": jax_aa(_scene(SIZE, **kw), bg)}
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_refined_pixels_are_the_2n_render_box_averaged(runs, kind):
    r = runs(kind)
    base, aa = r["base"], r["aa"]
    mask = aa.aa_mask
    assert mask.sum() > 8                       # the shadow edge was found
    np.testing.assert_array_equal(aa.image[mask],
                                  box_average(r["hi"].image, SIZE)[mask])
    assert (aa.image[mask] != base.image[mask]).any()
    np.testing.assert_array_equal(aa.image[~mask], base.image[~mask])
    np.testing.assert_array_equal(aa.cls, base.cls)
    assert aa.counts == base.counts
    assert aa.counts["numerical_error"] == 0


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_aa_render_matches_jax(runs, kind):
    r = runs(kind)
    aa, j = r["aa"], r["jax"]
    np.testing.assert_array_equal(aa.aa_mask,
                                  np.asarray(j.device("aa_mask")))
    np.testing.assert_array_equal(aa.cls, np.asarray(j.cls))
    assert aa.counts == j.counts
    differ = (aa.image != np.asarray(j.image)).any(axis=-1)
    assert differ.sum() <= MAX_DIFFER[kind]
    diverged = aa.n_steps[differ] != np.asarray(j.n_steps)[differ]
    assert (aa.aa_mask[differ] | diverged).all()
