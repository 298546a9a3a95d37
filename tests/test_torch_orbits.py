"""The port's circular-orbit algebra (physics/orbits.py) and Boyer-Lindquist
inverse metric against the JAX package, float64 on the same inputs.

The two packages evaluate the same formulas in the same association, so
they agree to float64 rounding: every function is held to 1e-12 relative.
The exceptions are stated where they occur: the cube root (torch has no
cbrt; sign(x) |x|^(1/3) is within 2e-16 relative of jnp.cbrt here, so the
ISCO radii agree to 1e-14), and the Page-Thorne flux, whose trapezoid
cumulative sum XLA may add in another order (held to 1e-12 of the peak
flux and 1e-10 relative where the flux is not near its zero at the ISCO).

The comparisons that take seconds are in tests/test_torch_orbits_jax.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.physics import orbits as jo
from grtrace.physics import spacetime as jsp
from grtrace_torch.physics import orbits as to
from grtrace_torch.physics import spacetime as tsp

torch.set_num_threads(1)

HOLES = [(1.0, 0.9, 0.0), (1.0, 0.5, 0.3), (1.0, 0.0, 0.0)]
RTOL = 1e-12


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def bl_points():
    rng = np.random.default_rng(3)
    n = 200
    return np.stack([rng.uniform(0, 10, n), rng.uniform(2.5, 40.0, n),
                     rng.uniform(0.05, np.pi - 0.05, n),
                     rng.uniform(-np.pi, np.pi, n)], axis=-1)


@pytest.mark.parametrize("params", HOLES)
def test_kerr_g_inv_matches_jax(bl_points, params):
    j = np.asarray(jax.vmap(lambda q: jsp.kerr_g_inv(
        q, jnp.asarray(params)))(jnp.asarray(bl_points)))
    t = tsp.kerr_g_inv(torch.tensor(bl_points), params).numpy()
    assert t.shape == (len(bl_points), 4, 4)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=0)
    # a single point, and the (t, phi)-only coupling
    one = tsp.kerr_g_inv(torch.tensor(bl_points[0]), params).numpy()
    np.testing.assert_array_equal(one, t[0])
    assert (t[:, 0, 1:3] == 0).all() and (t[:, 1, 2:] == 0).all()


def test_cube_root_keeps_sign():
    x = np.random.default_rng(0).uniform(-3.0, 3.0, 1000)
    t = to._cbrt(torch.tensor(x)).numpy()
    np.testing.assert_allclose(t, np.asarray(jnp.cbrt(x)), rtol=1e-15,
                               atol=0)
    assert (np.sign(t) == np.sign(x)).all()


def test_isco_limits():
    """The limits tests/test_disk.py holds JAX's ISCO to."""
    assert float(to.isco_radius(1.0, 0.0)) == pytest.approx(6.0, abs=1e-12)
    assert float(to.isco_radius(1.0, 0.998)) == pytest.approx(1.237,
                                                              abs=2e-3)
    assert float(to.isco_radius(1.0, 1.0, prograde=False)) == pytest.approx(
        9.0, abs=1e-9)
    assert to.isco_radius(1.0, 0.9).dtype == torch.float64


@pytest.mark.parametrize("prograde", [True, False])
@pytest.mark.parametrize("spin", [0.0, 0.3, 0.9, 0.998, -0.6])
def test_isco_matches_jax(spin, prograde):
    j = float(jo.isco_radius(1.0, spin, prograde))
    t = float(to.isco_radius(1.0, spin, prograde))
    assert t == pytest.approx(j, rel=1e-14)


@pytest.mark.parametrize("prograde", [True, False])
@pytest.mark.parametrize("spin,ulps", [(0.0, 0), (0.3, 2), (0.5, 2),
                                       (0.9, 0), (-0.6, 2), (0.998, 10)])
def test_isco_float32_gap(spin, prograde, ulps):
    """The port computes r_in in float64 on the host and rounds it once to
    the ray dtype; a float32 JAX run evaluates the closed form in float32.
    The two float32 inner edges differ by the stated float32 ulps (measured:
    0 at a = 0 and 0.9, up to 2 at |a| <= 0.6, 10 at a = 0.998, where
    (1 - chi^2)^(1/3) amplifies float32 rounding)."""
    j32 = np.float32(jo.isco_radius(jnp.float32(1.0), jnp.float32(spin),
                                    prograde))
    t32 = np.float32(float(to.isco_radius(1.0, spin, prograde)))
    assert abs(float(j32) - float(t32)) <= ulps * float(np.spacing(t32))


def _jax_batch(fn, r, *args):
    return jax.vmap(lambda x: fn(x, *args))(jnp.asarray(r))


@pytest.mark.parametrize("prograde", [True, False])
@pytest.mark.parametrize("params", HOLES)
def test_circular_orbit_quantities_match_jax(params, prograde):
    r = np.linspace(5.0, 40.0, 64)  # outside every photon orbit here
    jp, tr = jnp.asarray(params), torch.tensor(r)
    pairs = [
        (_jax_batch(jo.keplerian_omega, r, *params, prograde),
         to.keplerian_omega(tr, *params, prograde)),
        (_jax_batch(jo.equatorial_g_cov, r, jp),
         to.equatorial_g_cov(tr, params)),
        (_jax_batch(jo.static_u_t, r, jp), to.static_u_t(tr, params)),
        (_jax_batch(jo.rotating_u_t, r, jp, 1.1, 0.02),
         to.rotating_u_t(tr, params, 1.1, 0.02)),
        (_jax_batch(jo._sqrt_g3_equatorial, r, jp),
         to._sqrt_g3_equatorial(tr, params)),
    ]
    for out_j, out_t in (
            (_jax_batch(jo.circular_u_t, r, jp, prograde),
             to.circular_u_t(tr, params, prograde)),
            (_jax_batch(jo.circular_e_lz, r, jp, prograde),
             to.circular_e_lz(tr, params, prograde))):
        pairs += list(zip(out_j, out_t))
    for j, t in pairs:
        np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=1e-15)


def test_invert_bl_metric_inverts(bl_points):
    g_inv = tsp.kerr_g_inv(torch.tensor(bl_points), (1.0, 0.9, 0.2))
    g = to._invert_bl_metric(g_inv)
    eye = torch.eye(4, dtype=torch.float64).expand_as(g)
    np.testing.assert_allclose((g @ g_inv).numpy(), eye.numpy(), atol=1e-12)


def test_page_thorne_flux_newtonian_peak():
    """The structural fact tests/test_disk.py checks on JAX's flux: the
    Schwarzschild Novikov-Thorne peak sits near 9.55 M."""
    r = 6.0 * (1 + 1e-9) * (2e3 / 6.0) ** torch.linspace(
        0.0, 1.0, 2048, dtype=torch.float64)
    flux = to.page_thorne_flux(r, (1.0, 0.0, 0.0)).numpy()
    assert flux[0] == 0.0
    assert 9.0 < float(r[int(np.argmax(flux))]) < 10.0


@pytest.mark.parametrize("params", HOLES)
def test_redshift_factor_matches_jax(params):
    rng = np.random.default_rng(5)
    n = 128
    energy = rng.uniform(0.5, 1.5, n)
    l_z = rng.uniform(-6.0, 6.0, n)
    r_em = rng.uniform(6.5, 14.0, n)
    for theta, omega_obs in ((np.pi / 2, 0.0), (1.36, 0.0), (1.2, 0.01)):
        j = np.asarray(jax.vmap(lambda e, l, r: jo.redshift_factor(
            e, l, r, 29.9, jnp.asarray(params), True, theta, omega_obs))(
                jnp.asarray(energy), jnp.asarray(l_z), jnp.asarray(r_em)))
        t = to.redshift_factor(torch.tensor(energy), torch.tensor(l_z),
                               torch.tensor(r_em),
                               torch.tensor(29.9, dtype=torch.float64),
                               params, True, theta, omega_obs).numpy()
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=0)


def test_redshift_face_on_schwarzschild_closed_form():
    """Polar photons in Schwarzschild: g = sqrt(1 - 3M/r_em) /
    sqrt(1 - 2M/r_obs) (the JAX package's closed-form check)."""
    r_em = torch.tensor([4.0, 6.0, 10.0], dtype=torch.float64)
    g = to.redshift_factor(torch.ones(3, dtype=torch.float64),
                           torch.zeros(3, dtype=torch.float64), r_em,
                           torch.tensor(30.0, dtype=torch.float64),
                           (1.0, 0.0, 0.0), theta_obs=1e-6)
    expect = np.sqrt(1.0 - 3.0 / r_em.numpy()) / np.sqrt(1.0 - 2.0 / 30.0)
    np.testing.assert_allclose(g.numpy(), expect, rtol=1e-10)
