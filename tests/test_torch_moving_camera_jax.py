"""The moving disk camera of the port against the JAX package, on the CPU:
`render_disk` with DiskConfig(camera_omega='keplerian' | 'zamo' | 0.0)
(the boosted tetrad of physics/camera.boosted_ics_from_pixels; an explicit
0.0 is a moving camera too) at 16x16, a = 0.9, float64, 400 steps of 0.2.

Tolerances, with their reasons: q0 and p0 within 1e-12 (the same closed
forms; only the summation order of the 4x4 contractions differs); counts
and status exact; the disk pixels' redshift within 1e-10 (the crossings
agree to ~1e-12, ROADMAP Queue C).
"""
import numpy as np
import pytest
import torch

from grtrace import IntegratorConfig, SceneConfig
from grtrace.engine import disk as jdisk
import grtrace_torch

torch.set_num_threads(1)

SCENE = SceneConfig(size=16, metric="kerr", spin=0.9, n_samples=0,
                    background=None,
                    integrator=IntegratorConfig(steps=400, delta=0.2,
                                                dtype="float64"))


@pytest.mark.parametrize("spec", ["keplerian", "zamo", 0.0])
def test_moving_camera_render_matches_jax(spec):
    dc = jdisk.DiskConfig(camera_omega=spec)
    j = jdisk.render_disk(SCENE, dc)
    t = grtrace_torch.render_disk(grtrace_torch.from_jax_scene(SCENE),
                                  grtrace_torch.from_jax_disk(dc),
                                  device="cpu")
    np.testing.assert_allclose(t.q0, np.asarray(j.q0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.p0, np.asarray(j.p0), rtol=0, atol=1e-12)
    assert t.counts == j.counts and t.counts["disk"] > 0
    assert np.array_equal(t.status, np.asarray(j.status))
    dm = t.status == 3
    np.testing.assert_allclose(t.device("redshift").numpy()[dm],
                               np.asarray(j.device("redshift"))[dm],
                               rtol=1e-10, atol=0)
