"""The polarized subring render of the port against the JAX package, on
the CPU: `render_subrings` with DiskConfig(bfield='vertical') at 16x16,
a = 0.9, camera 75 deg, 2 orders, float64, 1500 steps of 0.1; then
`polarized_moments` and `subring_summary`'s polarization entries.

Tolerances, with their reasons: counts and valid masks exact; per-order
EVPA by circular distance min(d, pi - d) <= 1e-8 and pol_weight within
1e-10 on valid events (the crossings agree to ~1e-12: XLA contracts
multiply-adds into FMAs and torch does not, ROADMAP Queue C); beta_2
within rtol 1e-8.
"""
import numpy as np
import pytest
import torch

from grtrace import IntegratorConfig, SceneConfig
from grtrace.engine import disk as jdisk
from grtrace.engine import subring as jsub
import grtrace_torch

torch.set_num_threads(1)

SCENE = SceneConfig(size=16, metric="kerr", spin=0.9, n_samples=0,
                    background=None,
                    integrator=IntegratorConfig(steps=1500, delta=0.1,
                                                dtype="float64"))
DISK = jdisk.DiskConfig(elevation_deg=75.0, show_background=False,
                        bfield="vertical")


@pytest.fixture(scope="module")
def renders():
    j = jsub.render_subrings(SCENE, DISK, n_orders=2)
    t = grtrace_torch.render_subrings(grtrace_torch.from_jax_scene(SCENE),
                                      grtrace_torch.from_jax_disk(DISK),
                                      n_orders=2, device="cpu")
    return j, t


def test_per_order_polarization_matches_jax(renders):
    j, t = renders
    assert t.counts == {k: int(v) for k, v in
                        zip(("captured", "in_domain", "escaped",
                             "background", "numerical_error", "disk"),
                            np.asarray(j["count_vec"]))}
    v = t.valid
    assert np.array_equal(v, np.asarray(j["valid"]))
    assert v[0].any() and v[1].any()
    d = np.abs(t.evpa - np.asarray(j["evpa"]))
    assert np.minimum(d, np.pi - d)[v].max() <= 1e-8
    np.testing.assert_allclose(t.pol_weight[v],
                               np.asarray(j["pol_weight"])[v], rtol=0,
                               atol=1e-10)
    assert np.isfinite(t.evpa).all()


def test_polarized_moments_and_summary_match_jax(renders):
    j, t = renders
    jm = jsub.polarized_moments(j)
    tm = grtrace_torch.polarized_moments(t)
    for m in (1, 2):
        np.testing.assert_allclose(tm[m], jm[m], rtol=1e-8)
    js, ts = jsub.subring_summary(j), grtrace_torch.subring_summary(t)
    for k in ("beta2_abs_per_order", "beta2_arg_per_order_rad",
              "evpa_twist_per_order_rad", "flux_per_order"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-8, atol=1e-12)
    assert ts["pixels_per_order"] == js["pixels_per_order"]
