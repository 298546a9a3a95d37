"""Kerr-de Sitter's host modules against the JAX package:
physics/kerr_de_sitter.py and physics/kds_chart.py, all in float64 unless
a test says otherwise.

Tolerances:
  * Delta_r, Delta_th, chi, Sigma and g_inv: within 1e-14 relative (JAX's
    association, kept);
  * the outer and cosmological horizons: within 1e-12 relative (one
    bisection each); the reference's scan of [1e-3, 2.5] M is copied, so
    near critical Lambda both packages return 2.5 M (ROADMAP Queue C);
  * the capture radius in float64 (1e-12 relative) and float32 (2 ulps:
    the bisection in the rays' dtype, as JAX's traced one; the last
    bisection's midpoint may land an ulp apart);
  * kds_escape_pred: the same booleans on a seeded camera fan;
  * Omega, u^t, E, L and the disk's redshift: within 1e-10 relative (the
    ISCO, the OSCO and the epicyclic frequencies through cli.qpo in
    tests/test_torch_qpo.py);
  * the Carter chart's closed-form kick and drift against JAX's autodiff
    of kerr_de_sitter_g_inv: within 1e-12 of the largest component of
    each; at Lambda = 0 the chart is kerr_bl._kick_drift at Q = 0 bit for
    bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import disk_kds as jdk
from grtrace.physics import kerr_de_sitter as jkds
from grtrace.physics.camera import unfolded_ics_from_pixels as j_unfolded
from grtrace.physics.spacetime import hamiltonian as jham
from grtrace_torch.engine import disk_kds as tdk
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics import kds_chart as tkc
from grtrace_torch.physics import kerr_bl as tbl
from grtrace_torch.physics import kerr_de_sitter as tkds
from grtrace_torch.physics import spacetime as tsp
from grtrace_torch.physics.camera import (pixel_grid_lookat,
                                          unfolded_ics_from_pixels)

F64 = torch.float64
# (a, Lambda): the README's scene, a weaker tide, a slow hole in a strong
# one, Lambda = 0
CASES = [(0.8, 1e-3), (0.8, 1e-4), (0.3, 2e-3), (0.9, 0.0)]


def _close(a, b, tol):
    """Equal NaNs, the rest within tol of b's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b)), (a, b)
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), (a, b)


def _points(n=64, seed=7):
    rng = np.random.default_rng(seed)
    r = rng.uniform(2.5, 30.0, n)
    th = rng.uniform(0.1, math.pi - 0.1, n)
    p = rng.uniform(-1.0, 1.0, (n, 4))
    return r, th, p


def test_metric_functions_match_jax():
    """kds_functions and kerr_de_sitter_g_inv within 1e-14 relative of
    JAX's at 64 seeded points for every case; the tables name the metric
    and its chart, and horizon_radius('KerrDS', M, a, Lambda) is the outer
    horizon."""
    r, th, _ = _points()
    q = np.stack([np.zeros_like(r), r, th, np.zeros_like(r)], 1)
    for spin, lam in CASES:
        jp = jnp.array([1.0, spin, lam])
        tp = torch.tensor([1.0, spin, lam], dtype=F64)
        want = jkds.kds_functions(jnp.asarray(r), jnp.asarray(th), jp)
        got = tkds.kds_functions(torch.tensor(r), torch.tensor(th), tp)
        for g, w in zip(got, want):
            _close(torch.as_tensor(g).numpy() + 0 * r, np.asarray(w) + 0 * r,
                   1e-14)
        gj = np.asarray(jax.vmap(lambda x: jkds.kerr_de_sitter_g_inv(
            x, jp))(jnp.asarray(q)))
        gt = tsp.METRICS["KerrDS"](torch.tensor(q), tp).numpy()
        for i, j in ((0, 0), (0, 3), (1, 1), (2, 2), (3, 3)):
            _close(gt[:, i, j], gj[:, i, j], 1e-14)
    assert tsp.COORDS["KerrDS"] == "spherical"
    h = tsp.horizon_radius("KerrDS", torch.tensor(1.0, dtype=F64), 0.8, 1e-3)
    assert float(h) == float(tkds.kds_outer_horizon(
        torch.tensor([1.0, 0.8, 1e-3], dtype=F64)))


def test_horizons_capture_radius_and_the_copied_scan_fault():
    """The outer and cosmological horizons within 1e-12 relative of JAX's
    for every case; the capture radius (1.1 r_+) against JAX's
    kds_capture_radius in float64 and in float32, and the gen_params
    vector's slots from it; near critical Lambda (a = 0, Lambda = 0.105),
    where r_+ lies beyond the scan's 2.5 M, both packages return 2.5 M,
    the reference's fault."""
    for spin, lam in CASES:
        jp = jnp.array([1.0, spin, lam])
        tp = torch.tensor([1.0, spin, lam], dtype=F64)
        _close(float(tkds.kds_outer_horizon(tp)),
               float(jax.jit(jkds.kds_outer_horizon)(jp)), 1e-12)
        if lam > 0.0:
            _close(float(tkds.kds_cosmological_horizon(tp)),
                   float(jax.jit(jkds.kds_cosmological_horizon)(jp)), 1e-12)
        else:
            assert math.isnan(float(tkds.kds_cosmological_horizon(tp)))
        for t_dt, j_dt, tol in ((F64, jnp.float64, 1e-12),
                                (torch.float32, jnp.float32, 2.4e-7)):
            want = float(jax.jit(jkds.kds_capture_radius)(
                jnp.asarray([1.0, spin, lam], j_dt)))
            got = tkds.kds_capture_radius(torch.tensor([1.0, spin, lam],
                                                       dtype=t_dt))
            _close(float(got), want, tol)
            assert float(tig._capture_radius("KerrDS", torch.tensor(
                [1.0, spin, lam], dtype=t_dt))) == float(got)
    vec = tig.gen_params("KerrDS", 0.05, (1.0, 0.8, 1e-3), 31.0, 1.0, 2,
                         torch.float32)
    r_cap = float(tkds.kds_capture_radius(torch.tensor([1.0, 0.8, 1e-3],
                                                       dtype=torch.float32)))
    assert float(vec[3]) == r_cap
    assert float(vec[2]) == float(torch.tensor(1e-3, dtype=torch.float32)
                                  / torch.tensor(3.0, dtype=torch.float32))
    assert float(vec[5]) == float(torch.tensor(r_cap, dtype=torch.float32)
                                  / torch.tensor(1.1, dtype=torch.float32))
    near = (1.0, 0.0, 0.105)
    want = float(jax.jit(jkds.kds_outer_horizon)(jnp.array(near)))
    got = float(tkds.kds_outer_horizon(torch.tensor(near, dtype=F64)))
    assert want == pytest.approx(2.5, abs=1e-12)
    assert got == pytest.approx(2.5, abs=1e-12)
    # no black-hole horizon at all (over-spun): NaN and the 1e-2 M floor
    assert math.isnan(float(tkds.kds_outer_horizon(
        torch.tensor([1.0, 1.2, 1e-3], dtype=F64))))
    assert math.isnan(float(jax.jit(jkds.kds_outer_horizon)(
        jnp.array([1.0, 1.2, 1e-3]))))
    assert float(tkds.kds_capture_radius((1.0, 1.2, 1e-3))) == 1e-2


def _fan(spin, lam, n=16):
    """The unfolded look-at camera's rays at r0 = 30 (fov 60 deg), n x n,
    float64, in both packages."""
    obs = np.array([30.0, 0.0, 4.0])
    pix = pixel_grid_lookat(torch.tensor(obs), torch.tensor(
        math.radians(60.0), dtype=F64), n, n, dtype=F64)
    q0, p0, _ = unfolded_ics_from_pixels(torch.tensor(obs), pix,
                                         params=(1.0, spin, lam),
                                         g_inv_fn=tsp.METRICS["KerrDS"])
    jq, jp, _ = j_unfolded(jnp.asarray(obs), jnp.asarray(pix.numpy()),
                           params=jnp.array([1.0, spin, lam]),
                           g_inv_fn=jkds.kerr_de_sitter_g_inv)
    return (q0.reshape(-1, 4), p0.reshape(-1, 4),
            np.asarray(jq).reshape(-1, 4), np.asarray(jp).reshape(-1, 4))


def test_escape_pred_matches_jax():
    """kds_escape_pred's booleans equal JAX's on the 16x16 camera fan of
    each case with a horizon (both true and false among them), whole and
    in chunks of 37 rays; the port's camera rays equal JAX's within
    1e-12."""
    for spin, lam in CASES[:3]:
        q0, p0, jq, jp = _fan(spin, lam)
        np.testing.assert_allclose(q0.numpy(), jq, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(p0.numpy(), jp, rtol=1e-12, atol=1e-12)
        want = np.asarray(jax.jit(jkds.kds_escape_pred)(
            jnp.asarray(q0.numpy()), jnp.asarray(p0.numpy()),
            jnp.array([1.0, spin, lam])))
        got = tkds.kds_escape_pred(q0, p0, (1.0, spin, lam)).numpy()
        assert np.array_equal(got, want)
        assert 0 < got.sum() < got.size
        saved = tkds._PRED_CHUNK
        try:
            tkds._PRED_CHUNK = 37
            again = tkds.kds_escape_pred(q0, p0, (1.0, spin, lam)).numpy()
        finally:
            tkds._PRED_CHUNK = saved
        assert np.array_equal(again, got)


def test_orbits_and_disk_physics_match_jax():
    """Omega, (u^t, E, L) prograde and retrograde, the static observer's
    u^t and the disk's redshift against JAX's within 1e-10 relative; the
    disk bounds take the ISCO as r_in and refuse an r_out beyond the OSCO
    as JAX's do."""
    spin, lam = 0.8, 1e-3
    jp = jnp.array([1.0, spin, lam])
    tp = torch.tensor([1.0, spin, lam], dtype=F64)
    r = np.linspace(4.0, 12.0, 8)
    for pro in (True, False):
        want = jax.jit(jax.vmap(lambda x: jnp.stack(
            (jkds.keplerian_omega_kds(x, jp, pro),)
            + jkds.circular_u_t_kds(x, jp, pro)
            + jkds.circular_e_l_kds(x, jp, pro))))(jnp.asarray(r))
        rt = torch.tensor(r)
        got = torch.stack((tkds.keplerian_omega_kds(rt, tp, pro),)
                          + tkds.circular_u_t_kds(rt, tp, pro)
                          + tkds.circular_e_l_kds(rt, tp, pro), 1)
        _close(got, want, 1e-10)
    # the ISCO, the OSCO and the epicyclic frequencies are held against
    # JAX's through cli.qpo --metric kerr-ds (tests/test_torch_qpo.py)
    assert math.isnan(float(tkds.osco_kds((1.0, 0.8, 0.0))))
    e, lz, rem = np.array([1.0, 0.95]), np.array([2.5, -3.0]), \
        np.array([4.0, 9.0])
    want = jax.jit(jax.vmap(lambda a, b, c: jdk.redshift_factor_kds(
        a, b, c, 30.0, jp, True, 1.3)))(*map(jnp.asarray, (e, lz, rem)))
    got = tdk.redshift_factor_kds(*map(torch.tensor, (e, lz, rem)),
                                  torch.tensor(30.0, dtype=F64), tp, True,
                                  1.3)
    _close(got, want, 1e-10)
    _close(tdk.kds_static_u_t(torch.tensor(30.0, dtype=F64),
                              torch.tensor(1.3, dtype=F64), tp),
           jdk.kds_static_u_t(30.0, 1.3, jp), 1e-14)
    r_in, r_out = tdk.kds_disk_bounds(1.0, 0.8, 1e-4, None, 14.0, 31.0)
    assert r_in == float(tkds.isco_kds((1.0, 0.8, 1e-4))) and r_out == 14.0
    with pytest.raises(ValueError, match="outermost stable"):
        tdk.kds_disk_bounds(1.0, 0.8, 1e-3, None, 14.0, 31.0)


def test_kick_drift_matches_jax_autodiff():
    """kds_chart._kick_drift (dH/dr, dH/dtheta and dH/dp) against jax.grad
    of JAX's Hamiltonian with kerr_de_sitter_g_inv at 64 seeded phase
    points of each case, within 1e-12 of the largest component; at Lambda
    = 0 it is kerr_bl._kick_drift at Q = 0 bit for bit, in float64 and
    float32."""
    r, th, p = _points()
    q = np.stack([np.zeros_like(r), r, th, np.zeros_like(r)], 1)
    cols = [torch.tensor(r), torch.tensor(th)] + \
        [torch.tensor(p[:, i]) for i in range(4)]

    @jax.jit
    def grads(jp):
        def h(qq, pp):
            return jham(qq, pp, jp, jkds.kerr_de_sitter_g_inv)
        dq = jax.vmap(jax.grad(h, 0))(jnp.asarray(q), jnp.asarray(p))
        dp = jax.vmap(jax.grad(h, 1))(jnp.asarray(q), jnp.asarray(p))
        return jnp.concatenate([dq[:, 1:3], dp], axis=1)

    for spin, lam in CASES:
        want = np.asarray(grads(jnp.array([1.0, spin, lam])))
        lam3 = float(torch.tensor(lam, dtype=F64)
                     / torch.tensor(3.0, dtype=F64))
        chi2 = tkc.chi_squared(lam3, spin, F64)
        got = torch.stack(tkc._kick_drift(*cols, 1.0, spin, lam3, chi2),
                          1).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    spin = 0.8
    for dt in (F64, torch.float32):
        c = [x.to(dt) for x in cols]
        a = float(torch.tensor(spin, dtype=dt))
        ints = torch.int64 if dt == F64 else torch.int32
        zero = tkc._kick_drift(*c, 1.0, a, 0.0, tkc.chi_squared(0.0, a, dt))
        bl = tbl._kick_drift(*c, 1.0, a, 0.0)
        assert all(torch.equal(x.view(ints), y.view(ints))
                   for x, y in zip(zero, bl))
