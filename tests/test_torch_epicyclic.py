"""physics/timelike.py and physics/epicyclic.py of the port against the
JAX package's, on the JAX tests' own points (tests/test_timelike.py,
tests/test_epicyclic.py), and the charged disk's inner edge they give.

Tolerances: the closures (p_t, p_r^2, the launch state, the factored
radial potential, the bound-orbit charges) within 1e-12; the periastron
quadrature on the JAX tests' own anchors; `isco_from_kappa` within 1e-10 of
JAX's (the same 65-point scan and 50 bisection rounds; the second
derivatives by torch.autograd twice where JAX nests jax.grad);
`epicyclic_frequencies` within 1e-10.

At most six tests a file: pytest-xdist's --dist loadfile hands out the
files with the most tests first, so a file this small runs after the
suite's long few-test files instead of ahead of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine.disk import DiskConfig as JDiskConfig
from grtrace.physics import epicyclic as je
from grtrace.physics import spacetime as jsp
from grtrace.physics import timelike as jt
from grtrace_torch.engine.disk import DiskConfig
from grtrace_torch.physics import epicyclic as te
from grtrace_torch.physics import spacetime as tsp
from grtrace_torch.physics import timelike as tt
from grtrace_torch.physics.orbits import isco_radius

torch.set_num_threads(1)
KN = (1.0, 0.5, 0.4)


def _f(x):
    return float(np.asarray(x))


@pytest.fixture(scope="module")
def jax_isco():
    """JAX's isco_from_kappa at (a, Q) = (0.5, 0.4) on both branches, each
    compiled whole by jax.jit (the same values as the op-by-op call, in
    less than half its time)."""
    isco = jax.jit(je.isco_from_kappa, static_argnums=1)
    return {pro: _f(isco(jnp.asarray(KN), pro)) for pro in (True, False)}


def test_timelike_closures_match_jax():
    """build_timelike_4momentum (the mass shell, future branch and the
    backward one), pr2_of_r, equatorial_ics and radial_potential_factored
    on the JAX tests' points, within 1e-12."""
    pos = np.array([8.0, 1.1, 0.3])
    p_sph = np.array([0.12, -0.4, 2.0])
    for a, mu in ((0.0, 1.0), (0.9, 1.0), (0.9, 2.5), (-0.7, 1.0)):
        for future in (True, False):
            want = jt.build_timelike_4momentum(
                jnp.asarray(p_sph), jnp.asarray(pos),
                jnp.asarray([1.0, a, 0.0]), jsp.kerr_g_inv, mu=mu,
                future=future)
            got = tt.build_timelike_4momentum(
                torch.tensor(p_sph), torch.tensor(pos), (1.0, a, 0.0),
                tsp.kerr_g_inv, mu=mu, future=future)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)
    params = (1.0, 0.9, 0.3)
    e, lz = 0.95, 3.6
    for r in (6.0, 12.0, 25.0):
        assert float(tt.pr2_of_r(r, e, lz, params)) == pytest.approx(
            _f(jt.pr2_of_r(jnp.float64(r), e, lz, jnp.asarray(params))),
            rel=1e-12, abs=1e-12)
    (q0, p0), (jq0, jp0) = (tt.equatorial_ics(12.0, e, lz, params),
                            jt.equatorial_ics(12.0, e, lz, params))
    np.testing.assert_allclose(q0.numpy(), np.asarray(jq0), rtol=1e-12)
    np.testing.assert_allclose(p0.numpy(), np.asarray(jp0), rtol=1e-12)
    r = np.linspace(8.5, 17.5, 7)
    got = tt.radial_potential_factored(torch.tensor(r), 8.0, 18.0, e, lz,
                                       params)
    want = jt.radial_potential_factored(jnp.asarray(r), 8.0, 18.0, e, lz,
                                        jnp.asarray(params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_bound_orbits_and_precession_match_jax():
    """bound_orbit_e_lz at the JAX tests' a = 0.9 prograde within 1e-12
    (its turning points are roots); the periastron quadrature on the JAX
    tests' anchors (the Mercury limit within 2e-3 and above it; prograde
    < Schwarzschild < retrograde at a = 0.9); the weak field formula
    exactly."""
    for a, pro in ((0.9, True),):
        params = (1.0, a, 0.0)
        e, lz = tt.bound_orbit_e_lz(8.0, 18.0, params, prograde=pro)
        je_, jl = jt.bound_orbit_e_lz(8.0, 18.0, jnp.asarray(params),
                                      prograde=pro)
        assert float(e) == pytest.approx(_f(je_), abs=1e-12)
        assert float(lz) == pytest.approx(_f(jl), abs=1e-12)
        for r in (8.0, 18.0):
            assert abs(float(tt.pr2_of_r(r, e, lz, params))) < 1e-10
    far = float(tt.periapsis_advance_quadrature(2e4, 3e4, (1.0, 0.0, 0.0)))
    leading = tt.weak_field_precession(2e4, 3e4)
    assert leading == _f(jt.weak_field_precession(2e4, 3e4))
    assert far == pytest.approx(leading, rel=2e-3) and far > leading
    pro, ret, schw = (float(tt.periapsis_advance_quadrature(
        15.0, 30.0, (1.0, a, 0.0), p)) for a, p in ((0.9, True),
                                                    (0.9, False),
                                                    (0.0, True)))
    assert pro < schw < ret


def test_isco_from_kappa_matches_jax(jax_isco):
    """The autodiff ISCO at (0.5, 0.4) on both branches within 1e-10 of
    JAX's; the extremal Reissner-Nordstrom ISCO at 4 M; kappa^2 < 0 inside
    and > 0 outside the Bardeen-Press-Teukolsky radius at a = 0.9; and the
    root is transversal."""
    for pro, want in jax_isco.items():
        got = float(te.isco_from_kappa(KN, pro))
        assert got == pytest.approx(want, abs=1e-10), pro
    assert float(te.isco_from_kappa((1.0, 0.0, 1.0))) == pytest.approx(
        4.0, abs=1e-10)
    r_bpt = float(isco_radius(1.0, 0.9))
    k2 = te.radial_stability(torch.tensor([r_bpt - 0.05, r_bpt + 0.05],
                                          dtype=torch.float64), (1.0, 0.9))
    assert float(k2[0]) < 0.0 < float(k2[1])
    r = float(te.isco_from_kappa(KN))
    assert float(te.radial_stability(r - 0.05, KN)) < 0.0
    assert float(te.radial_stability(r + 0.05, KN)) > 0.0


def test_epicyclic_frequencies_match_jax():
    """(Omega_phi, kappa, Omega_theta) on the JAX tests' prograde points
    (a = 0, 0.5 and 0.9 at r = 8 and 12; a retrograde orbit is a = -0.7
    prograde, as tests/test_epicyclic.py pins; and a charged hole, (0.6,
    0.3) at r = 7), within 1e-10, and the QPO frequencies in Hz at r = 8
    within a relative 1e-10.  JAX's function is jitted here (one compile)
    so that its nested jax.grad is not traced afresh at every point."""
    j_freq = jax.jit(je.epicyclic_frequencies, static_argnames="prograde")
    cases = [((1.0, a, 0.0), r, True) for a in (0.0, 0.5, 0.9)
             for r in (8.0, 12.0)]
    cases += [((1.0, -0.7, 0.0), 10.0, True), ((1.0, 0.6, 0.3), 7.0, True)]
    for params, r, pro in cases:
        got = [float(x) for x in te.epicyclic_frequencies(r, params, pro)]
        want = [_f(x) for x in j_freq(jnp.float64(r), jnp.asarray(params),
                                      prograde=pro)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    got = te.qpo_frequencies_hz(8.0, (1.0, 0.9, 0.0), 10.0)
    om, ka, ov = (_f(x) for x in j_freq(
        jnp.float64(8.0), jnp.asarray([1.0, 0.9, 0.0]), prograde=True))
    scale = 1.0 / (2.0 * np.pi * 10.0 * je.T_SUN_S)
    want = {"nu_phi": om * scale, "nu_r": ka * scale, "nu_theta": ov * scale,
            "nu_periastron": om * scale - ka * scale,
            "nu_nodal": om * scale - ov * scale}
    for k in want:
        assert float(got[k]) == pytest.approx(want[k], rel=1e-10)


def test_charged_disk_inner_edge_matches_jax(jax_isco):
    """DiskConfig(r_in=None).inner_edge of a charged hole is the autodiff
    ISCO, JAX's within 1e-10 on both branches (it raised before item 8d
    was ported); without charge it stays the closed form."""
    for pro in (True, False):
        got = DiskConfig(prograde=pro).inner_edge(*KN)
        assert got == pytest.approx(jax_isco[pro], abs=1e-10)
    assert DiskConfig().inner_edge(1.0, 0.5, 0.0) == float(
        isco_radius(1.0, 0.5))
    assert JDiskConfig(r_in=7.0).inner_edge(*KN) == \
        DiskConfig(r_in=7.0).inner_edge(*KN) == 7.0
