"""The subring twins of kernel B7 against the JAX package, one slot, and
render_subrings with its shading and subring_summary against JAX's (part
of tests/test_torch_subring.py, whose docstring states the tolerances).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace.engine import disk as jdisk
from grtrace.engine import integrate_ks as jks
from grtrace.engine import integrate_pallas_ks as jpks
from grtrace.engine import subring as jsub
from grtrace.io.scene import IntegratorConfig, SceneConfig
from grtrace.physics import camera as jcam
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import subring as tsub
from test_torch_subring import DELTA, OMEGA, PARAMS, R_MAX, SPIN, _rays

torch.set_num_threads(1)


@jax.jit
def _jax_camera():
    """tests/test_subring.py's look-at camera (14x14 rays), compiled once
    (op by op it costs seconds of compiles)."""
    elev, dist = 0.3, 20.0
    obs = jnp.array([dist * np.cos(elev), 0.0, dist * np.sin(elev)])
    pix = jcam.pixel_grid_lookat(obs, jnp.float64(np.deg2rad(80.0)), 14, 14,
                                 dtype=jnp.float64)
    q0, p0, _ = jcam.cartesian_ics_from_pixels(
        obs, pix.reshape(-1, 3), params=jnp.array(PARAMS),
        g_inv_fn=jsp.METRICS["KerrSchild"])
    return q0, p0


def _subring_batch_ics(dtype=np.float64):
    """The JAX camera's (N, 4) launch states as numpy arrays of `dtype`."""
    q0, p0 = _jax_camera()
    return np.asarray(q0).astype(dtype), np.asarray(p0).astype(dtype)


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


def _filled(count, n_orders):
    return count[None, :] > np.arange(n_orders)[:, None]


@pytest.fixture(scope="module")
def f64_pair():
    """(q0, p0, JAX interpret-mode Pallas outputs, port twin outputs)."""
    q0, p0 = _subring_batch_ics()
    j = _np(jpks.integrate_batch_pallas_subrings(
        jnp.asarray(q0), jnp.asarray(p0), 900, DELTA, jnp.asarray(PARAMS),
        R_MAX, OMEGA, n_orders=2, interpret=True, compensated=False))
    t = _np(tks.integrate_batch_subrings_ks(
        torch.tensor(q0), torch.tensor(p0), 900, DELTA, PARAMS, R_MAX, OMEGA,
        n_orders=2))
    return q0, p0, j, t


@pytest.fixture(scope="module")
def f32_pair():
    """(q0, p0 float32 tensors, JAX XLA twin outputs, port 32-row twin
    outputs) at 900 steps."""
    q0, p0 = _subring_batch_ics(dtype=np.float32)
    f32 = np.float32
    j = _np(jks.integrate_batch_subrings_ksc(
        jnp.asarray(q0), jnp.asarray(p0), 900, f32(DELTA),
        jnp.asarray(PARAMS, jnp.float32), f32(R_MAX), f32(OMEGA),
        n_orders=2))
    q0, p0 = torch.tensor(q0), torch.tensor(p0)
    t = tks.integrate_batch_subrings_ksc(q0, p0, 900, DELTA, PARAMS, R_MAX,
                                         OMEGA, n_orders=2)
    return q0, p0, j, t


def test_subring_twin_f64_matches_pallas_interpret(f64_pair):
    _, _, j, t = f64_pair
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert t[6].dtype == np.int32 and np.array_equal(t[6], j[6])
    assert t[6].max() >= 2 and (t[2] == 1).any() and (t[6] == 0).any()
    filled = _filled(t[6], 2)
    for k in (4, 5):  # hits_q, hits_p (n_orders, N, 4)
        assert t[k].shape == (2, 196, 4)
        np.testing.assert_allclose(t[k][filled], j[k][filled], rtol=1e-9,
                                   atol=1e-12)
        assert not t[k][~filled].any() and not j[k][~filled].any()
    np.testing.assert_allclose(t[0], j[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-9, atol=1e-9)


def test_subring_twin_f32_matches_jax_xla_twin(f32_pair):
    _, _, j, t = _np(f32_pair[:2]) + list(f32_pair[2:3]) + [
        _np(f32_pair[3])]
    assert t[4].dtype == np.float32
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert np.array_equal(t[6], j[6]) and t[6].max() >= 2
    filled = _filled(t[6], 2)
    np.testing.assert_allclose(t[4][filled], j[4][filled], rtol=0, atol=5e-5)
    np.testing.assert_allclose(t[5][filled], j[5][filled], rtol=0, atol=1e-5)
    assert not t[4][~filled].any() and not t[5][~filled].any()


def test_one_slot_counts_every_crossing():
    """n_orders = 1: the count still totals every crossing (past 1), slot 0
    and the states are those of the 3-slot run, and the recorder leaves
    the plain-mode states untouched, bit for bit (10x10 rays, 300 steps at
    delta 0.2: counts 0, 1 and 2 occur)."""
    q0, p0 = _rays(10, torch.float32)
    args = (300, 0.2, PARAMS, R_MAX, OMEGA)
    one = tks.integrate_batch_subrings_ksc(q0, p0, *args, n_orders=1)
    three = tks.integrate_batch_subrings_ksc(q0, p0, *args, n_orders=3)
    assert one[4].shape == (1, q0.shape[0], 4)
    assert torch.equal(one[6], three[6]) and int(one[6].max()) >= 2
    assert torch.equal(one[4][0], three[4][0])
    assert torch.equal(one[5][0], three[5][0])
    plain = tks.integrate_batch_ksc(q0, p0, *args)
    for a, b, c in zip(one[:4], three[:4], plain):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.fixture(scope="module")
def renders():
    scene = SceneConfig(size=16, metric="kerr", spin=SPIN, n_samples=0,
                        background=None,
                        integrator=IntegratorConfig(steps=1500, delta=0.1,
                                                    dtype="float64"))
    dc = jdisk.DiskConfig(elevation_deg=75.0, show_background=False)
    j = jsub.render_subrings(scene, dc, n_orders=3)
    t = grtrace_torch.render_subrings(grtrace_torch.from_jax_scene(scene),
                                      grtrace_torch.from_jax_disk(dc),
                                      n_orders=3, device="cpu")
    return j, t


def test_render_subrings_f64_matches_jax(renders):
    j, t = renders
    keys = ("captured", "in_domain", "escaped", "background",
            "numerical_error", "disk")
    assert t.counts == dict(zip(keys, np.asarray(j["count_vec"]).tolist()))
    assert t.counts["numerical_error"] == 0 and t.counts["disk"] >= 20
    for k in ("cls", "count", "valid", "status"):
        assert np.array_equal(t[k], j[k]), k
    assert t.valid[1].any() and t.count.max() >= 2
    np.testing.assert_allclose(t.intensity, j["intensity"], rtol=2e-3,
                               atol=1e-12)
    np.testing.assert_allclose(t.total_intensity, j["total_intensity"],
                               rtol=2e-3, atol=1e-12)
    v = t.valid
    np.testing.assert_allclose(t.hits_q[v], j["hits_q"][v], rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(t.r_em[v], j["r_em"][v], rtol=1e-10)
    np.testing.assert_allclose(t.g[v], j["g"][v], rtol=1e-10)
    assert np.abs(t.image.astype(int) - j["image"].astype(int)).max() <= 1
    dn = np.abs(t.n_steps.astype(np.int64) - j["n_steps"])
    assert (dn[t.status != 1] == 0).all() and dn.max() <= 2
    np.testing.assert_allclose(t.q0, np.asarray(j["q0"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.p0, np.asarray(j["p0"]), rtol=0, atol=1e-12)
    assert t.n_orders == 3 and t.r_in == pytest.approx(j["r_in"], rel=1e-14)
    assert np.array_equal(t.params, j["params"])


def test_shading_masks_and_additivity(renders):
    _, t = renders
    inten, valid = t.intensity, t.valid
    assert inten.shape == valid.shape == (3, 16, 16)
    assert (inten[~valid] == 0.0).all() and (inten[valid] > 0.0).all()
    np.testing.assert_allclose(t.total_intensity, inten.sum(axis=0),
                               rtol=1e-12)
    per_order = valid.sum(axis=(1, 2))
    assert per_order[0] >= per_order[1] >= per_order[2]
    assert (t.cls == tsub.CLS_DISK).sum() == valid.any(axis=0).sum()
    r_em = t.r_em[valid]
    assert (r_em >= t.r_in).all() and (r_em <= t.r_out).all()


def test_subring_summary_matches_jax(renders):
    j, t = renders
    same = tsub.subring_summary(j)
    ref = jsub.subring_summary(j)
    assert set(same) == set(ref)
    for k in ("flux_per_order", "pixels_per_order", "flux_ratio",
              "max_crossings"):
        assert same[k] == ref[k], k
    assert same["gamma_hat"] == ref["gamma_hat"]
    np.testing.assert_allclose(same["delay_per_order_M"],
                               ref["delay_per_order_M"], rtol=1e-13)
    own = grtrace_torch.subring_summary(t)
    np.testing.assert_allclose(own["flux_per_order"], ref["flux_per_order"],
                               rtol=1e-9)
    np.testing.assert_allclose(own["delay_per_order_M"],
                               ref["delay_per_order_M"], rtol=1e-9)
    assert own["max_crossings"] == ref["max_crossings"] >= 2
    assert own["flux_per_order"][0] > own["flux_per_order"][1] > 0.0
