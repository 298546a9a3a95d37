"""The rotating regular families' host modules against the JAX package:
physics/rotating_regular.py, physics/rotating_chart.py and
physics/rotating_orbits.py, all in float64.

Tolerances:
  * the mass-function chart's closed-form kick and drift against JAX's
    autodiff of make_rotating_ks_g_inv: within 1e-12 of the largest
    component of each (JAX differentiates jnp.power(r^2 + g^2, 1.5), the
    port writes m' out: ROADMAP Queue C); at g = l = 0 the chart equals
    kerr_schild._kick_drift at Q = 0 bit for bit;
  * rotating_horizon, rotating_capture_radius, critical_parameter: within
    1e-12 relative (one bisection each; the scan grid's points differ by
    an ulp at most);
  * escape_pred_rotating: the same booleans on a seeded ray set;
  * rotating_orbits (Omega, E, L, ISCO, Page-Thorne, redshift,
    epicyclic): within 1e-10 relative; with m = M - Q^2 / 2r (JAX's
    Kerr-Newman oracle) they equal the port's Kerr-Newman layer
    (physics/orbits.py) within 1e-12.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.physics import rotating_orbits as jro
from grtrace.physics import rotating_regular as jrr
from grtrace.physics.spacetime import METRICS as JMETRICS
from grtrace.physics.spacetime import hamiltonian as jham
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics import kerr_schild as tks
from grtrace_torch.physics import orbits as tor
from grtrace_torch.physics import rotating_chart as trc
from grtrace_torch.physics import rotating_orbits as tro
from grtrace_torch.physics import rotating_regular as trr
from grtrace_torch.physics import spacetime as tsp

F64 = torch.float64
FAMILIES = [("RotatingBardeen", 0.9, 0.2), ("RotatingHayward", 0.9, 0.2),
            ("RotatingBardeen", 0.6, 0.75), ("RotatingHayward", 0.5, 0.0)]


def _phase_points(n=64, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-8.0, 8.0, (n, 4))
    p = rng.uniform(-1.0, 1.0, (n, 4))
    return q, p


@pytest.mark.parametrize("metric,spin,param", FAMILIES)
def test_kick_drift_and_invariant_match_jax_autodiff(metric, spin, param):
    """rotating_chart._kick_drift (dHam/dq spatial, dHam/dp) and
    rotating_chart.hamiltonian against jax.grad and JAX's Hamiltonian of
    make_rotating_ks_g_inv at 64 seeded phase points, within 1e-12 of the
    largest component; the port's g_inv equals JAX's within 1e-12; at
    param 0 the chart is kerr_schild._kick_drift bit for bit."""
    q, p = _phase_points()
    jp = jnp.array([1.0, spin, param])
    g_inv = JMETRICS[metric]

    def h(qq, pp):
        return jham(qq, pp, jp, g_inv)

    dq = np.asarray(jax.vmap(jax.grad(h, 0))(jnp.asarray(q), jnp.asarray(p)))
    dp = np.asarray(jax.vmap(jax.grad(h, 1))(jnp.asarray(q), jnp.asarray(p)))
    want = np.concatenate([dq[:, 1:], dp], axis=1)
    cols = [torch.tensor(q[:, i]) for i in range(1, 4)] + \
        [torch.tensor(p[:, i]) for i in range(4)]
    k = float(trc.family_constant(metric, torch.tensor(1.0, dtype=F64),
                                  torch.tensor(param, dtype=F64)))
    fam = trc.FAMILY_CODE[metric]
    got = torch.stack(trc._kick_drift(*cols, 1.0, spin, k, fam), 1).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    h_j = np.asarray(jax.vmap(h)(jnp.asarray(q), jnp.asarray(p)))
    h_t = trc.hamiltonian(*cols, 1.0, spin, k, fam).numpy()
    assert np.abs(h_t - h_j).max() <= 1e-12 * np.abs(h_j).max()
    g_t = tsp.METRICS[metric](torch.tensor(q), torch.tensor(
        [1.0, spin, param], dtype=F64))
    g_j = np.asarray(jax.vmap(lambda qq: g_inv(qq, jp))(jnp.asarray(q)))
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-12 * np.abs(g_j).max()
    if param == 0.0:
        kerr = tks._kick_drift(*cols, 1.0, spin, 0.0)
        ours = trc._kick_drift(*cols, 1.0, spin, 0.0, fam)
        assert all(torch.equal(a, b) for a, b in zip(ours, kerr))


def test_horizon_capture_and_critical_parameter_match_jax():
    """rotating_horizon (NaN past the critical curve), the capture radius
    (1.05 r_h or the 1e-2 M floor), horizon_radius's registry and
    critical_parameter against JAX's, within 1e-12 relative; the capture
    radius of a float32 vector is JAX's float32 bisection's, rounded."""
    for metric, spin, param in FAMILIES + [("RotatingHayward", 0.9, 0.3)]:
        jp = jnp.array([1.0, spin, param])
        tp = torch.tensor([1.0, spin, param], dtype=F64)
        j = float(jrr.rotating_horizon(metric, jp))
        t = float(trr.rotating_horizon(metric, tp))
        assert (math.isnan(j) and math.isnan(t)) or abs(t - j) <= 1e-12 * j
        j = float(jrr.rotating_capture_radius(metric, jp))
        t = float(trr.rotating_capture_radius(metric, tp))
        assert abs(t - j) <= 1e-12 * j
        t = float(tsp.horizon_radius(metric, tp[0], spin, param))
        assert (math.isnan(t) and math.isnan(float(jrr.rotating_horizon(
            metric, jp)))) or abs(t - float(jrr.rotating_horizon(
                metric, jp))) <= 1e-12 * t
    j32 = float(jrr.rotating_capture_radius(
        "RotatingBardeen", jnp.array([1.0, 0.9, 0.2], jnp.float32)))
    t32 = float(trr.rotating_capture_radius(
        "RotatingBardeen", torch.tensor([1.0, 0.9, 0.2])))
    assert abs(t32 - j32) <= 4e-7 * j32
    for metric, spin in (("RotatingBardeen", 0.9), ("RotatingHayward", 0.5),
                         ("RotatingBardeen", 0.0)):
        j = float(jrr.critical_parameter(metric, spin))
        t = trr.critical_parameter(metric, spin)
        assert abs(t - j) <= 1e-12 * j
    assert abs(trr.critical_parameter("RotatingBardeen", 0.0)
               - math.sqrt(16.0 / 27.0)) < 1e-3


def test_escape_predicate_same_booleans_as_jax():
    """escape_pred_rotating on 400 seeded camera-like rays (positions on a
    30 M sphere's +x cap, momenta aimed near the hole) gives JAX's
    booleans in both families; horizonless parameters give False
    everywhere; a chunk boundary inside the batch changes nothing."""
    rng = np.random.default_rng(11)
    n = 400
    obs = np.array([30.0, 0.0, 0.0])
    aim = np.stack([-np.ones(n), rng.uniform(-0.25, 0.25, n),
                    rng.uniform(-0.25, 0.25, n)], 1)
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    q0 = np.concatenate([np.zeros((n, 1)), np.tile(obs, (n, 1))], 1)
    for metric, spin, param in FAMILIES:
        jp = jnp.array([1.0, spin, param])
        p_t = np.asarray(jax.vmap(lambda qq, ps: _null_pt(qq, ps, jp,
                                                          metric))(
            jnp.asarray(q0), jnp.asarray(aim)))
        p0 = np.concatenate([p_t[:, None], aim], 1)
        want = np.asarray(jax.jit(
            lambda q, p, m=metric, prm=jp: jrr.escape_pred_rotating(
                m, q, p, prm))(jnp.asarray(q0), jnp.asarray(p0)))
        got = trr.escape_pred_rotating(metric, torch.tensor(q0),
                                       torch.tensor(p0),
                                       (1.0, spin, param)).numpy()
        assert np.array_equal(got, want), metric
        if math.isnan(float(jrr.rotating_horizon(metric, jp))):
            assert not got.any()
        else:
            assert 0 < got.sum() < n
    saved = trr._PRED_CHUNK
    try:
        trr._PRED_CHUNK = 37
        again = trr.escape_pred_rotating(metric, torch.tensor(q0),
                                         torch.tensor(p0),
                                         (1.0, spin, param)).numpy()
    finally:
        trr._PRED_CHUNK = saved
    assert np.array_equal(again, got)


def _null_pt(q, p_sp, params, metric):
    from grtrace.physics.spacetime import null_p_t
    return null_p_t(p_sp, q, params, JMETRICS[metric])


def test_rotating_orbits_match_jax_and_the_kerr_newman_oracle():
    """Omega, (E, L), the ISCO, the Page-Thorne flux, the redshift and the
    epicyclic frequencies against JAX's within 1e-10 relative; with JAX's
    Kerr-Newman mass function m = M - Q^2 / 2r the module reproduces the
    port's Kerr-Newman orbits (physics/orbits.py) within 1e-12."""
    metric, spin, param = "RotatingBardeen", 0.9, 0.2
    jm, tm = jrr.MASS_FN[metric], trr.MASS_FN[metric]
    jp, tp = jnp.array([1.0, spin, param]), torch.tensor([1.0, spin, param],
                                                         dtype=F64)
    r = np.linspace(5.0, 12.0, 8)

    def close(a, b, tol=1e-10):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), (a, b)

    # the JAX references jitted: eagerly each costs seconds of tracing
    for pro in (True, False):
        close(jax.jit(jax.vmap(lambda x: jnp.stack(
            (jro.keplerian_omega_rotating(x, jp, jm, pro),)
            + jro.circular_e_l_rotating(x, jp, jm, pro))))(jnp.asarray(r)),
            torch.stack((tro.keplerian_omega_rotating(torch.tensor(r), tp,
                                                      tm, pro),)
                        + tro.circular_e_l_rotating(torch.tensor(r), tp, tm,
                                                    pro), 1))
    isco = tro.rotating_disk_inner_edge(metric, 1.0, spin, param)
    close(jax.jit(lambda p: jro.isco_rotating(p, jm))(jp), isco)
    grid = np.geomspace(isco * 1.00001, 14.0, 40)
    close(jax.jit(lambda g: jro.page_thorne_flux_rotating(g, jp, jm))(
        jnp.asarray(grid)),
          tro.page_thorne_flux_rotating(torch.tensor(grid), tp, tm))
    e, lz, rem = np.array([1.0, 0.95]), np.array([2.5, -3.0]), \
        np.array([4.0, 9.0])
    close(jax.vmap(lambda a, b, c: jro.redshift_factor_rotating(
        a, b, c, 30.0, jp, jm, True, 1.3))(*map(jnp.asarray, (e, lz, rem))),
        tro.redshift_factor_rotating(*map(torch.tensor, (e, lz, rem)),
                                     torch.tensor(30.0, dtype=F64), tp, tm,
                                     True, 1.3))
    close(jax.jit(lambda p: jnp.stack(jro.epicyclic_rotating(6.0, p, jm)))(
        jp), torch.stack(tro.epicyclic_rotating(6.0, tp, tm)))
    with pytest.raises(ValueError, match="no stable circular orbits"):
        tro.rotating_disk_inner_edge("RotatingBardeen", 1.0, 0.99, 0.6)

    def kn_mass(rr, params):
        return params[0] - params[2] * params[2] / (2.0 * rr)

    kn = torch.tensor([1.0, 0.5, 0.4], dtype=F64)
    rr = torch.tensor(r)
    close(tor.keplerian_omega(rr, 1.0, 0.5, 0.4),
          tro.keplerian_omega_rotating(rr, kn, kn_mass), 1e-12)
    close(tor.redshift_factor(torch.tensor(e), torch.tensor(lz),
                              torch.tensor(rem),
                              torch.tensor(30.0, dtype=F64), kn,
                              True, 1.3),
          tro.redshift_factor_rotating(torch.tensor(e), torch.tensor(lz),
                                       torch.tensor(rem),
                                       torch.tensor(30.0, dtype=F64), kn,
                                       kn_mass, True, 1.3), 1e-12)


ITEM_9_CALLS = {
    "METRICS": lambda m: tsp.METRICS[m],
    "COORDS": lambda m: tsp.COORDS[m],
    "horizon_radius": lambda m: tsp.horizon_radius(m, 1.0, 0.5, 1e-4),
    "capture_radius": lambda m: tig._capture_radius(m, (1.0, 0.5, 1e-4)),
    "gen_params": lambda m: tig.gen_params(m, 0.1, (1.0, 0.5, 1e-4), 31.0,
                                           1.0, 2, F64),
    "trajectory_generic": lambda m: tig.trajectory_generic(
        torch.zeros(4), torch.zeros(4), 3, 0.1, (1.0, 0.5, 1e-4), 1.0,
        metric=m),
}


@pytest.mark.parametrize("call", sorted(ITEM_9_CALLS))
@pytest.mark.parametrize("metric", ["KerrDS", "RotatingBardeen",
                                    "RotatingHayward"])
def test_item_9_raises_name_kerr_ds_only(call, metric):
    """Every lookup that raised for ROADMAP item 9 passes for all three
    of its families now that Kerr-de Sitter is ported: its metric, chart,
    horizon (the bisected outer horizon), capture radius (1.1 r_+),
    vector (L = Lambda / 3 in the charge slot) and trace (T2d's twin)."""
    out = ITEM_9_CALLS[call](metric)
    if metric != "KerrDS":
        return
    from grtrace_torch.physics import kerr_de_sitter as tkds
    # the calls pass Python numbers: the default dtype's bisection (and
    # gen_params's float64 one)
    r_h = tkds.kds_outer_horizon(torch.tensor([1.0, 0.5, 1e-4]))
    want = {"METRICS": tkds.kerr_de_sitter_g_inv, "COORDS": "spherical"}
    if call in want:
        assert out is want[call]
    elif call == "horizon_radius":
        assert float(out) == float(r_h)
    elif call == "capture_radius":
        assert float(out) == float(1.1 * r_h)
    elif call == "gen_params":
        r_h = tkds.kds_outer_horizon(torch.tensor([1.0, 0.5, 1e-4], dtype=F64))
        assert float(out[2]) == 1e-4 / 3.0
        assert float(out[3]) == float(1.1 * r_h)
    else:
        assert out[0].shape == out[1].shape == (3, 4)
