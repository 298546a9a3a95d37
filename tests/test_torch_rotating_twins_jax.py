"""The eager twins of kernels G1r, S2r, T2r and D2 (the mass-function
Kerr-Schild chart of engine/integrate_generic.py) against the JAX
package's integrate_batch_generic, trajectory_batch_decimated and
trajectory_generic with metric='RotatingBardeen' and 'RotatingHayward',
and integrate_batch_disk with metric='RotatingBardeen', at 600 steps of
0.05 in float64 on the rays of a 10 x 10 Cartesian camera at r0 = 15.
Each JAX reference runs once, in a module-scoped fixture.

Tolerances: statuses and step counts equal (no ray of these frames meets
ROADMAP Queue C's Kerr-Schild step-count gap); positions and momenta
within 1e-8 (absolute, |q| <= 16) — the port takes the flows in closed
form where JAX differentiates (physics/rotating_chart.py), 1e-12 an
evaluation, which 600 steps amplify on the rays that graze the photon
shell; the disk's crossings within 1e-8 on the rays both call hits.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import disk as jdisk
from grtrace.engine import integrate_generic as jig
from grtrace.physics.camera import camera_rays_cartesian as jcamera
from grtrace.physics.spacetime import METRICS as JMETRICS
from grtrace_torch.engine import integrate_generic as tig

STEPS, DELTA, R_MAX = 600, 0.05, 16.0
# the horizonless frames run the same twins: the host build
# (test_torch_rotating_host.py) and the 24 x 24 frame against JAX
# (test_torch_rotating_render_jax.py) hold them; rotating Hayward's disk
# is held against JAX's render_disk there too
CASES = {"bardeen": ("RotatingBardeen", (1.0, 0.9, 0.2)),
         "hayward": ("RotatingHayward", (1.0, 0.9, 0.2))}
TOL = 1e-8


def _rays(metric, params, elev_deg=0.0):
    el = math.radians(elev_deg)
    obs = jnp.array([15.0 * math.cos(el), 0.0, 15.0 * math.sin(el)])
    if elev_deg:
        from grtrace.physics.camera import (cartesian_ics_from_pixels,
                                            pixel_grid_lookat)
        pix = pixel_grid_lookat(obs, jnp.radians(60.0), 10, 10,
                                dtype=jnp.float64)
        q0, p0, _ = cartesian_ics_from_pixels(
            obs, pix, params=jnp.asarray(params), g_inv_fn=JMETRICS[metric])
    else:
        q0, p0, _ = jcamera(obs, jnp.radians(60.0), 10, 10,
                            params=jnp.asarray(params),
                            g_inv_fn=JMETRICS[metric], dtype=jnp.float64)
    return np.asarray(q0).reshape(-1, 4), np.asarray(p0).reshape(-1, 4)


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference of the module, once."""
    out = {}
    for key, (metric, params) in CASES.items():
        q0, p0 = _rays(metric, params)
        res = jig.integrate_batch_generic(
            jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA,
            jnp.asarray(params), R_MAX, 1.0, order=2, metric=metric)
        out[key] = (q0, p0) + tuple(np.asarray(x) for x in res)
        pick = [0, 44, 45, 55]
        out["traj_" + key] = (q0[pick], p0[pick], np.asarray(
            jig.trajectory_batch_decimated(
                jnp.asarray(q0[pick]), jnp.asarray(p0[pick]), STEPS, DELTA,
                jnp.asarray(params), R_MAX, 1.0, order=4, metric=metric,
                n_keep=100)))
        # a ray that escapes: the unmasked trace of a captured one crosses
        # the horizon, where rounding grows without bound
        qs, ps = jig.trajectory_generic(
            jnp.asarray(q0[0]), jnp.asarray(p0[0]), STEPS, DELTA,
            jnp.asarray(params), 1.0, order=2, metric=metric)
        out["trace_" + key] = (q0[0], p0[0], np.asarray(qs), np.asarray(ps))
    for key in ("bardeen",):
        metric, params = CASES[key]
        q0, p0 = _rays(metric, params, elev_deg=20.0)
        res = jdisk.integrate_batch_disk(
            jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA,
            jnp.asarray(params), R_MAX, 1.0, 2.0, 12.0, order=2,
            metric=metric)
        out["disk_" + key] = (q0, p0) + tuple(np.asarray(x) for x in res)
    return out


@pytest.mark.parametrize("key", sorted(CASES))
def test_g1r_twin_matches_jax(jax_ref, key):
    """integrate_batch_generic (G1r's twin and the rescue by
    escape_pred_rotating) against JAX's: statuses and step counts equal,
    final q and p within 1e-8; captures and escapes among them."""
    metric, params = CASES[key]
    q0, p0, jq, jp, js, jn = jax_ref[key]
    q, p, s, n = tig.integrate_batch_generic(
        torch.tensor(q0), torch.tensor(p0), STEPS, DELTA, params, R_MAX, 1.0,
        order=2, metric=metric)
    assert np.array_equal(s.numpy(), js)
    assert np.array_equal(n.numpy(), jn)
    assert np.abs(q.numpy() - jq).max() <= TOL
    assert np.abs(p.numpy() - jp).max() <= TOL
    assert len(set(js.tolist())) >= 2


@pytest.mark.parametrize("key", sorted(CASES))
def test_s2r_t2r_twins_match_jax(jax_ref, key):
    """trajectory_batch_decimated (S2r's twin; order 4, 100 points) and
    trajectory_generic (T2r's twin; one escaping ray, every step) against
    JAX's in each family:
    every recorded point within 1e-8, the zero slots past an exit
    equal."""
    metric, params = CASES[key]
    q0, p0, want = jax_ref["traj_" + key]
    got = tig.trajectory_batch_decimated(
        torch.tensor(q0), torch.tensor(p0), STEPS, DELTA, params, R_MAX, 1.0,
        order=4, metric=metric, n_keep=100).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got == 0.0, want == 0.0)
    assert np.abs(got - want).max() <= TOL
    assert (want == 0.0).any() and not (want == 0.0).all()
    q0, p0, qs, ps = jax_ref["trace_" + key]
    tq, tp = tig.trajectory_generic(torch.tensor(q0), torch.tensor(p0), STEPS,
                                    DELTA, params, 1.0, order=2,
                                    metric=metric)
    assert np.abs(tq.numpy() - qs).max() <= TOL
    assert np.abs(tp.numpy() - ps).max() <= TOL


@pytest.mark.parametrize("key", ["bardeen"])
def test_d2_twin_matches_jax(jax_ref, key):
    """integrate_batch_disk_rotating (D2's twin, the rescue, STATUS_DISK)
    against JAX's integrate_batch_disk(metric=...) on the 10 x 10 camera
    20 deg above the plane (disk [2, 12]): statuses and step counts equal,
    final q within 1e-8, the crossings within 1e-8 on the disk rays (the
    port writes zero hit rows elsewhere, as the kernels do)."""
    metric, params = CASES[key]
    q0, p0, jq, _, js, jn, jhq, jhp = jax_ref["disk_" + key]
    q, _, s, n, hq, hp = tig.integrate_dispatch_disk_rotating(
        torch.tensor(q0), torch.tensor(p0), STEPS, DELTA, params, R_MAX,
        1.0, 2.0, 12.0, order=2, metric=metric)
    assert np.array_equal(s.numpy(), js)
    assert np.array_equal(n.numpy(), jn)
    assert np.abs(q.numpy() - jq).max() <= TOL
    disk = js == tig.STATUS_DISK
    assert 0 < disk.sum() < disk.size
    assert np.abs(hq.numpy()[disk] - jhq[disk]).max() <= TOL
    assert np.abs(hp.numpy()[disk] - jhp[disk]).max() <= TOL
    assert not hq.numpy()[~disk].any()
    with pytest.raises(ValueError, match="D2"):
        tig.integrate_dispatch_disk_rotating(
            torch.zeros((1, 4), device="meta"),
            torch.zeros((1, 4), device="meta"), 3, 0.1, params, R_MAX, 1.0,
            2.0, 12.0, metric=metric)
