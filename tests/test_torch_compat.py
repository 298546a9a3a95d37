"""The EinsteinPy-compatible classes of the port (grtrace_torch.compat:
`Geodesic`, `Nulllike`, `Timelike`) against the JAX package's and the
golden CSV, on the CPU (the eager twins of kernels T1 and T2; the kernels
themselves are held against the twins by chip_smoke.py phases 44 and 45,
their sources built with g++ by tests/test_torch_schw16_host.py and
tests/test_torch_gen_host.py).

Tolerances:
  * the golden ray (tests/golden/null_geodesic_r10_a60_b60.csv, 2000 steps)
    at the JAX test's own rtol = atol = 1e-10, against the CSV and against
    JAX's Nulllike.  The port steps with B3's fused flows, JAX with the
    unfused ones (ROADMAP Queue C): 2.3e-10 at the worst element, inside
    the bound by 9e-11;
  * the closures: Nulllike null within 1e-12, Timelike's -E within rtol
    1e-12 (also at a = 0.7 against JAX's closure);
  * Timelike's circular orbit: r within rtol 1e-9 of r0 over 2000 steps;
  * Kerr (a = 0.5, 100 steps) and Kerr-Newman (0.5, 0.4; 400 steps)
    against JAX's trajectory_generic within rtol 1e-9 (atol 1e-12 for the
    zero rows): the port's closed-form Boyer-Lindquist flows differ from
    JAX's autodiff ones by at most about 1e-12 relative an evaluation
    (Queue C); on these rays, far from the horizon, the records after 100
    and 400 steps agree within 2.4e-16 and 9.3e-16 relative, so the bound
    leaves room for rays that near the horizon;
  * Kerr-Newman at Q = 0 equal to Kerr bit for bit (JAX allows 1e-13).

At most six tests a file: pytest-xdist's --dist loadfile hands out the
files with the most tests first, so a file this small runs after the
suite's long few-test files instead of ahead of them.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.compat import Nulllike as JNulllike
from grtrace.compat import Timelike as JTimelike
from grtrace.engine.integrate_generic import \
    trajectory_generic as j_trajectory_generic
from grtrace_torch.compat import Geodesic, Nulllike, Timelike
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_generic as tig

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "null_geodesic_r10_a60_b60.csv")
POS = [10.0, np.pi / 2, 0.0]
MOM = [1.0, np.pi / 2 - np.deg2rad(60), np.pi - np.deg2rad(60)]
GOLD_KW = dict(position=POS, momentum=MOM, steps=2000, delta=0.05,
               omega=0.01, suppress_warnings=True)
# (metric, metric_params, position, momentum, steps, delta, omega): the
# JAX package's Kerr and Kerr-Newman compat rays
KERR_RAYS = [("Kerr", (0.5,), (12.0, np.pi / 2, 0.0), (-1.0, 0.0, 4.0), 100,
              0.05, 1.0),
             ("KerrNewman", (0.5, 0.4), (8.0, np.pi / 2, 0.0),
              (0.0, 0.0, 3.0), 400, 0.01, 1.0)]


def _circular(r0, mass=1.0):
    """Schwarzschild circular-orbit (E, L)."""
    e = (1.0 - 2.0 * mass / r0) / np.sqrt(1.0 - 3.0 * mass / r0)
    ell = np.sqrt(mass * r0) / np.sqrt(1.0 - 3.0 * mass / r0)
    return e, ell


@pytest.fixture(scope="module")
def golden():
    """The golden ray: the port's (CPU) geodesic, its data, and JAX's."""
    geod = Nulllike(device="cpu", **GOLD_KW)
    _, data = geod.trajectory
    _, jdata = JNulllike(**GOLD_KW).trajectory
    return geod, data, jdata


def test_golden_ray_matches_csv_and_jax(golden):
    geod, data, jdata = golden
    assert data.shape == (2000, 8) and data.dtype == np.float64
    gold = np.loadtxt(GOLDEN, delimiter=",", skiprows=1)
    np.testing.assert_allclose(data, gold, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(data, jdata, rtol=1e-10, atol=1e-10)
    # the trace's own record: the spherical rows behind the Cartesian ones
    q0 = torch.tensor(geod.position)[None]
    p0 = torch.tensor(geod.momentum)[None]
    rec = ti.trajectory_dispatch(q0, p0, 2000, 0.05, 2.0, 0.01)[0].numpy()
    geod.return_cartesian = False
    idx, sph = geod.trajectory
    assert np.array_equal(idx, np.arange(2000))
    assert np.array_equal(sph, rec)
    r, th, ph = sph[:, 1], sph[:, 2], sph[:, 3]
    np.testing.assert_array_equal(data[:, 1], r * np.sin(th) * np.cos(ph))
    np.testing.assert_array_equal(data[:, 3], r * np.cos(th))
    np.testing.assert_array_equal(data[:, 4:], sph[:, 4:])


def test_closures_match_jax(golden):
    """p_t closes the mass shell on EinsteinPy's `_P()` branch (p_t < 0):
    null within 1e-12 (Schwarzschild), -E within rtol 1e-12 of the exact
    circular-orbit energy (Timelike), and equal to JAX's closures on Kerr
    a = 0.7 (null and timelike) within 1e-12."""
    p = golden[0].momentum
    r, th = POS[0], POS[1]
    f = 1 - 2 / r
    null = (-1 / f) * p[0] ** 2 + f * p[1] ** 2 + p[2] ** 2 / r ** 2 \
        + p[3] ** 2 / (r ** 2 * np.sin(th) ** 2)
    assert p[0] < 0 and abs(null) < 1e-12
    e, ell = _circular(10.0)
    tl = Timelike(position=[10.0, np.pi / 2, 0.0], momentum=[0.0, 0.0, ell],
                  steps=1, device="cpu")
    assert tl.time_like is True
    np.testing.assert_allclose(tl.momentum[0], -e, rtol=1e-12)
    kw = dict(metric="Kerr", metric_params=(0.7,),
              position=(9.0, 1.2, 0.3), momentum=(0.2, -0.5, 3.0), steps=1)
    for cls, jcls in ((Nulllike, JNulllike), (Timelike, JTimelike)):
        np.testing.assert_allclose(cls(device="cpu", **kw).momentum,
                                   jcls(**kw).momentum, rtol=1e-12,
                                   atol=1e-12)


def test_errors(monkeypatch):
    """EinsteinPy's errors, and the card as the default device."""
    with pytest.raises(NotImplementedError):
        Nulllike(metric="FRW", device="cpu")
    with pytest.raises(ValueError):
        Nulllike(metric="Schwarzschild", metric_params=(0.5,), device="cpu")
    with pytest.raises(TypeError):
        Nulllike(time_like=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Geodesic()
    with pytest.raises(ValueError, match="no trace"):
        ti.trajectory_dispatch(torch.zeros((1, 4), device="meta"),
                               torch.zeros((1, 4), device="meta"), 3, 0.1,
                               2.0, 1.0)
    # Kerr-de Sitter is ported (T2d's twin on the CPU): three steps of a
    # ray at r = 15 stay finite, one row a step
    q0 = torch.tensor([0.0, 15.0, 1.2, 0.0], dtype=torch.float64)
    p0 = torch.tensor([-1.0, -1.0, 0.3, 2.0], dtype=torch.float64)
    qs, ps = tig.trajectory_generic(q0, p0, 3, 0.1, (1.0, 0.5, 1e-3), 1.0,
                                    metric="KerrDS")
    assert qs.shape == ps.shape == (3, 4)
    assert bool(torch.isfinite(qs).all()) and float(qs[0, 1]) < 15.0
    with pytest.raises(NotImplementedError, match="'Kerr' only"):
        tig.trajectory_generic(torch.zeros(4), torch.zeros(4), 3, 0.1,
                               (1.0, 0.5), 1.0, metric="KerrSchild")


def test_timelike_circular_orbit_stays_circular():
    """The exact circular orbit at r0 = 10 is a fixed radius of the flow:
    r within rtol 1e-9 over 2000 steps, phi at the rate L / r^2."""
    r0 = 10.0
    _, ell = _circular(r0)
    geod = Timelike(position=[r0, np.pi / 2, 0.0], momentum=[0.0, 0.0, ell],
                    steps=2000, delta=0.1, omega=0.01,
                    return_cartesian=False, device="cpu")
    _, data = geod.trajectory
    np.testing.assert_allclose(data[:, 1], r0, rtol=1e-9)
    np.testing.assert_allclose(data[-1, 3], ell / r0 ** 2 * 200.0, rtol=1e-6)


def test_kerr_and_kerr_newman_match_jax():
    """Nulllike on the Kerr and Kerr-Newman rays of the JAX package's
    tests, spherical rows, against JAX's trajectory_generic on the same
    launch state (rtol 1e-9); the record is finite and spin matters."""
    for metric, mp, pos, mom, steps, delta, omega in KERR_RAYS:
        geod = Nulllike(metric=metric, metric_params=mp, position=pos,
                        momentum=mom, steps=steps, delta=delta, omega=omega,
                        return_cartesian=False, device="cpu")
        _, data = geod.trajectory
        params = jnp.asarray([1.0, mp[0], mp[1] if len(mp) > 1 else 0.0])
        qs, ps = j_trajectory_generic(
            jnp.asarray(geod.position), jnp.asarray(geod.momentum), steps,
            delta, params, omega, order=2, metric="Kerr")
        want = np.concatenate([np.asarray(qs), np.asarray(ps)], axis=-1)
        assert data.shape == (steps, 8) and np.isfinite(data).all()
        np.testing.assert_allclose(data, want, rtol=1e-9, atol=1e-12)
    flat = Nulllike(position=pos, momentum=mom, steps=steps, delta=delta,
                    omega=omega, return_cartesian=False, device="cpu")
    assert np.abs(data - flat.trajectory[1]).max() > 1e-3


def test_kerr_newman_at_zero_charge_is_kerr():
    """metric_params (a, 0) and (a,) integrate the same parameter vector:
    the records are equal bit for bit, and route through trajectory_generic
    (T2's twin on the CPU), whose record is trajectory_generic_unmasked's."""
    kw = dict(metric_params=(0.5,), position=(8.0, np.pi / 2, 0.0),
              momentum=(0.0, 0.0, 3.0), steps=100, delta=0.01, omega=1.0,
              device="cpu")
    _, kerr = Nulllike(metric="Kerr", **kw).trajectory
    kw["metric_params"] = (0.5, 0.0)
    geod = Nulllike(metric="KerrNewman", **kw)
    _, kn = geod.trajectory
    assert np.array_equal(kn.view(np.int64), kerr.view(np.int64))
    vec = tig.gen_params("Kerr", 0.01, (1.0, 0.5, 0.0), float("inf"), 1.0, 2,
                         torch.float64)
    rec = tig.trajectory_generic_unmasked(
        torch.tensor(geod.position)[None], torch.tensor(geod.momentum)[None],
        100, vec)[0].numpy()
    geod.return_cartesian = False
    assert np.array_equal(geod.trajectory[1], rec)
