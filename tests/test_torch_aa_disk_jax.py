"""The adaptive antialiasing passes of the port on the disk and subring
render paths (`engine/aa.py`: refine_edges_disk, refine_subrings), on the
CPU twins, at 20x20 in float64 (tests/test_aa.py's scenes, at fewer
steps; the disk shaded with the Novikov-Thorne profile).  The moving
camera's sub-rays are held at the camera in tests/test_torch_aa.py.

* The supersampling identity, port only: a refined pixel equals the 40x40
  render's 2x2 block averaged exactly (float32 mean, + 0.5, clipped); for
  the subrings the per-order intensities equal the block means within
  rtol 1e-12 and total_intensity their sum; unrefined pixels, the class
  map, the counts and the crossing counts equal the base render's.
* Against the JAX package's AA render of the same scene, at the tolerances
  of the paths' parity tests (tests/test_torch_render_disk_jax.py,
  test_torch_subring_jax.py): aa_mask, the class map and the counts
  equal, image channels at most 1 apart (the last ulp of a colour can
  round either way), per-order intensities within rtol 2e-3.

Each scene runs once per module: the port's base, AA and 2N renders and
JAX's AA render.  At most six tests a file.
"""
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine import disk as jdisk
from grtrace.engine import subring as jsub
from grtrace_torch.engine.disk import CLS_DISK
from test_torch_aa_jax import SIZE, S, box_average

torch.set_num_threads(1)

N_ORDERS = 2


def _scene(n, steps, delta):
    return SceneConfig(size=n, metric="kerr", spin=0.9, n_samples=0,
                       patch=PatchConfig(),
                       integrator=IntegratorConfig(steps=steps, delta=delta,
                                                   backend="xla",
                                                   dtype="float64"))


def _disk_runs():
    bg = np.random.default_rng(6).integers(0, 255, (SIZE, SIZE, 3),
                                           dtype=np.uint8)
    dc = jdisk.DiskConfig(profile="novikov")

    def port(n, **aa):
        return grtrace_torch.render_disk(
            grtrace_torch.from_jax_scene(_scene(n, 500, 0.15)),
            grtrace_torch.from_jax_disk(dc), bg_array=bg, device="cpu", **aa)
    return {"base": port(SIZE), "aa": port(SIZE, aa_samples=S),
            "hi": port(S * SIZE),
            "jax": jdisk.render_disk(_scene(SIZE, 500, 0.15), dc,
                                     bg_array=bg, aa_samples=S)}


def _subring_runs():
    dc = jdisk.DiskConfig(elevation_deg=75.0, show_background=False)

    def port(n, **aa):
        return grtrace_torch.render_subrings(
            grtrace_torch.from_jax_scene(_scene(n, 1500, 0.1)),
            grtrace_torch.from_jax_disk(dc), n_orders=N_ORDERS,
            device="cpu", **aa)
    return {"base": port(SIZE), "aa": port(SIZE, aa_samples=S),
            "hi": port(S * SIZE),
            "jax": jsub.render_subrings(_scene(SIZE, 1500, 0.1), dc,
                                        n_orders=N_ORDERS, aa_samples=S)}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = {"disk": _disk_runs,
                           "subring": _subring_runs}[kind]()
        return cache[kind]
    return get


def test_disk_refined_pixels_are_the_2n_render_box_averaged(runs):
    r = runs("disk")
    base, aa = r["base"], r["aa"]
    mask = aa.aa_mask
    assert mask.sum() > 8                 # disk silhouette + shadow edges
    assert (base.cls[mask] == CLS_DISK).any()
    np.testing.assert_array_equal(aa.image[mask],
                                  box_average(r["hi"].image, SIZE)[mask])
    np.testing.assert_array_equal(aa.image[~mask], base.image[~mask])
    np.testing.assert_array_equal(aa.cls, base.cls)
    assert aa.counts == base.counts and aa.counts["disk"] > 0
    # the science maps keep the centre sample
    np.testing.assert_array_equal(aa.device("redshift").numpy(),
                                  base.device("redshift").numpy())


def test_disk_aa_render_matches_jax(runs):
    r = runs("disk")
    aa, j = r["aa"], r["jax"]
    np.testing.assert_array_equal(aa.aa_mask,
                                  np.asarray(j.device("aa_mask")))
    np.testing.assert_array_equal(aa.cls, np.asarray(j.cls))
    assert aa.counts == j.counts
    diff = np.abs(aa.image.astype(int) - np.asarray(j.image).astype(int))
    assert diff.max() <= 1


def test_subring_refined_pixels_are_the_2n_render_box_averaged(runs):
    r = runs("subring")
    base, aa, hi = r["base"], r["aa"], r["hi"]
    mask = aa.aa_mask
    assert mask.sum() > 8          # ring boundaries + silhouette found
    assert base.intensity[1].sum() > 0.0          # order 1 resolves
    np.testing.assert_array_equal(aa.image[mask],
                                  box_average(hi.image, SIZE)[mask])
    np.testing.assert_array_equal(aa.image[~mask], base.image[~mask])
    bi = hi.intensity.reshape(N_ORDERS, SIZE, S, SIZE, S).mean(axis=(2, 4))
    np.testing.assert_allclose(aa.intensity[:, mask], bi[:, mask],
                               rtol=1e-12)
    np.testing.assert_array_equal(aa.intensity[:, ~mask],
                                  base.intensity[:, ~mask])
    np.testing.assert_allclose(aa.total_intensity, aa.intensity.sum(axis=0),
                               rtol=1e-12)
    for k in ("cls", "count", "valid"):
        np.testing.assert_array_equal(aa[k], base[k])
    assert aa.counts == base.counts
    truth = hi.intensity[1].sum() / S ** 2
    assert (abs(aa.intensity[1].sum() - truth)
            <= abs(base.intensity[1].sum() - truth) + 1e-12)


def test_subring_aa_render_matches_jax(runs):
    r = runs("subring")
    aa, j = r["aa"], r["jax"]
    np.testing.assert_array_equal(aa.aa_mask, j["aa_mask"])
    for k in ("cls", "count", "valid"):
        np.testing.assert_array_equal(aa[k], j[k])
    np.testing.assert_allclose(aa.intensity, j["intensity"], rtol=2e-3,
                               atol=1e-12)
    np.testing.assert_allclose(aa.total_intensity, j["total_intensity"],
                               rtol=2e-3, atol=1e-12)
    assert np.abs(aa.image.astype(int) - j["image"].astype(int)).max() <= 1
