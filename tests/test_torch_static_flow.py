"""The static chart of the generic engine against the JAX package: the
closed-form flows (physics/static_chart.py) against JAX's autodiff flows,
and the eager twins of kernels G1s, S2s and T2s
(engine/integrate_generic.py) against JAX's integrate_batch_generic,
trajectory_batch_decimated and trajectory_generic on the same rays (JAX's
folded camera, so that only the integrators differ).

Tolerances, with their reasons:
  * the kicks and drifts: 1e-12 relative, 1e-13 absolute for the theta
    kick, which is O(cos theta) ~ 1e-17 at the folded plane (the same
    algebra as `jax.grad`, other operations);
  * the float64 frame, 2000 steps: statuses and step counts equal, the
    final (r, theta, phi) within 1e-8 absolute (measured 1.8e-11: the
    flows' roundoff, grown along the rays); 1e-6 for the horizonless
    frame, whose middle rays cross the core;
  * the float32 frame: statuses and step counts equal, the final (r,
    theta, phi) of the escaped rays within 2e-3 (float32 roundoff grown
    over 2000 steps; measured 3.5e-5 on the samples, 8e-2 on t);
  * the trajectories: 1e-9 (float64).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_generic as jig
from grtrace.physics import camera as jcam
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics import static_chart as tsc
from grtrace_torch.physics.hamiltonian import pack_state

torch.set_num_threads(1)
FAMILIES = {"Kottler": 1e-3, "Bardeen": 0.5, "Hayward": 0.6}


def _camera(metric, param, size, dtype):
    """JAX's folded static camera at r0 = 30, fov 80 deg: (q0, p0) numpy."""
    params = jnp.asarray([1.0, param, 0.0], dtype)
    q0, p0, _, _ = jcam.camera_rays_folded_static(
        jnp.asarray([30.0, 0.0, 0.0], dtype), jnp.asarray(np.radians(80.0),
                                                          dtype),
        size, size, params=params, g_inv_fn=jsp.METRICS[metric],
        dtype=dtype)
    return (np.asarray(q0).reshape(-1, 4), np.asarray(p0).reshape(-1, 4))


@pytest.mark.parametrize("metric", list(FAMILIES))
def test_closed_form_flows_match_jax_autodiff(metric):
    """(k_r, k_th, dH/dp) of static_chart._kick_drift against jax.grad of
    JAX's Hamiltonian at 64 random phase points near the folded plane
    (r in [2.5, 30], theta within 1e-3 of pi/2 and at fl(pi/2))."""
    rng = np.random.default_rng(3)
    n = 64
    q = np.zeros((n, 4))
    q[:, 1] = rng.uniform(2.5, 30.0, n)
    q[:, 2] = 0.5 * np.pi + rng.uniform(-1e-3, 1e-3, n)
    q[:8, 2] = 0.5 * np.pi
    p = rng.normal(size=(n, 4)) * np.array([1.0, 1.0, 0.3, 5.0])
    param = FAMILIES[metric]
    jparams = jnp.asarray([1.0, param, 0.0])
    dq = jax.vmap(jax.grad(jsp.hamiltonian, argnums=0),
                  in_axes=(0, 0, None, None))
    dp = jax.vmap(jax.grad(jsp.hamiltonian, argnums=1),
                  in_axes=(0, 0, None, None))
    want_q = np.asarray(dq(jnp.asarray(q), jnp.asarray(p), jparams,
                           jsp.METRICS[metric]))
    want_p = np.asarray(dp(jnp.asarray(q), jnp.asarray(p), jparams,
                           jsp.METRICS[metric]))
    k, code = tig.static_constants(metric, torch.tensor(1.0, dtype=torch.float64),
                                   torch.tensor(param, dtype=torch.float64))
    t = [torch.tensor(q[:, 1]), torch.tensor(q[:, 2])] + \
        [torch.tensor(p[:, m]) for m in range(4)]
    got = tsc._kick_drift(*t, 1.0, float(k), float(code))
    np.testing.assert_allclose(got[0].numpy(), want_q[:, 1], rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), want_q[:, 2], rtol=1e-12,
                               atol=1e-13)
    for m in range(4):
        np.testing.assert_allclose(got[2 + m].numpy(), want_p[:, m],
                                   rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_g1s_twin_matches_jax(dtype):
    """The twin of G1s (integrate_batch_generic) against JAX's on the
    16x16 folded Bardeen (g = 0.5) frame, 2000 steps, delta 0.05: equal
    statuses and step counts, final states within the module's stated
    tolerances; theta and p_theta leave pi/2 and 0 in both."""
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    q0, p0 = _camera("Bardeen", 0.5, 16, jdt)
    args = (2000, 0.05, (1.0, 0.5, 0.0), 31.0, 1.0)
    jq, jp, js, jn = (np.asarray(x) for x in jig.integrate_batch_generic(
        jnp.asarray(q0), jnp.asarray(p0), *args, metric="Bardeen"))
    tq, tp, ts, tn = (x.numpy() for x in tig.integrate_batch_generic(
        torch.tensor(q0, dtype=tdt), torch.tensor(p0, dtype=tdt), *args,
        metric="Bardeen"))
    assert np.array_equal(ts, js) and np.array_equal(tn, jn)
    assert set(np.unique(ts)) >= {1, 2}
    tol = 1e-8 if dtype == "float64" else 2e-3
    esc = js == 2
    np.testing.assert_allclose(tq[esc][:, 1:], jq[esc][:, 1:], atol=tol,
                               rtol=0)
    # p_theta leaves 0 in both dtypes; theta leaves fl(pi/2) in float32,
    # where cos(fl(pi/2)) is -4.4e-8 (in float64 the drift stays below
    # half an ulp of pi/2)
    assert (jp[:, 2] != 0).any() and (tp[:, 2] != 0).any()
    if dtype == "float32":
        half_pi = np.float32(0.5 * np.pi)
        assert (tq[:, 2] != half_pi).any() and (jq[:, 2] != half_pi).any()


def test_supercritical_bardeen_frame():
    """Horizonless Bardeen (g = 0.9 > sqrt(16/27)): the capture radius is
    the 1e-2 M floor, the middle rays cross the core; statuses, step counts
    and final states equal JAX's, float64, the 16x16 frame and the budget
    of test_g1s_twin_matches_jax (so that JAX compiles its engine once for
    both), the states within
    1e-6 (the rays through the core, down to r ~ 0.1, amplify the flows'
    roundoff: measured 1.4e-8)."""
    q0, p0 = _camera("Bardeen", 0.9, 16, jnp.float64)
    args = (2000, 0.05, (1.0, 0.9, 0.0), 31.0, 1.0)
    jq, _, js, jn = (np.asarray(x) for x in jig.integrate_batch_generic(
        jnp.asarray(q0), jnp.asarray(p0), *args, metric="Bardeen"))
    tq, _, ts, tn = (x.numpy() for x in tig.integrate_batch_generic(
        torch.tensor(q0), torch.tensor(p0), *args, metric="Bardeen"))
    vec = tig.gen_params("Bardeen", 0.05, (1.0, 0.9), 31.0, 1.0, 2,
                         torch.float64)
    assert float(vec[3]) == float(np.float64(1e-2))
    assert np.array_equal(ts, js) and np.array_equal(tn, jn)
    ok = np.isfinite(jq).all(1)
    np.testing.assert_allclose(tq[ok][:, 1:], jq[ok][:, 1:], atol=1e-6,
                               rtol=0)


def test_s2s_and_t2s_twins_match_jax():
    """The twin of S2s (trajectory_batch_decimated, 4 rays of the 16x16
    Hayward frame, 1500 steps, 300 points) and of T2s (trajectory_generic,
    one Kottler ray, 400 steps) against JAX's, 1e-9; the recorder's zero
    rows past each exit equal."""
    q0, p0 = _camera("Hayward", 0.6, 16, jnp.float64)
    idx = [0, 100, 119, 200]
    args = (1500, 0.05, (1.0, 0.6, 0.0), 31.0, 1.0)
    jt = np.asarray(jig.trajectory_batch_decimated(
        jnp.asarray(q0[idx]), jnp.asarray(p0[idx]), *args, metric="Hayward",
        n_keep=300))
    tt = tig.trajectory_batch_decimated(
        torch.tensor(q0[idx]), torch.tensor(p0[idx]), *args,
        metric="Hayward", n_keep=300).numpy()
    assert np.array_equal(tt == 0, jt == 0)
    np.testing.assert_allclose(tt, jt, atol=1e-9, rtol=0)
    q0k, p0k = _camera("Kottler", 1e-3, 16, jnp.float64)
    jq, jp = jig.trajectory_generic(jnp.asarray(q0k[119]),
                                    jnp.asarray(p0k[119]), 400, 0.05,
                                    jnp.asarray([1.0, 1e-3, 0.0]), 1.0,
                                    metric="Kottler")
    tq, tp = tig.trajectory_generic(torch.tensor(q0k[119]),
                                    torch.tensor(p0k[119]), 400, 0.05,
                                    (1.0, 1e-3, 0.0), 1.0, metric="Kottler")
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-9,
                               rtol=0)
    # the pack/unpack of a static state is the generic engine's
    assert len(pack_state(torch.tensor(q0[:1]), torch.tensor(p0[:1]))) == 16
    assert math.isfinite(float(tq[-1, 1]))
