"""B2's twin `integrate_batch_eq` and B3's twin `integrate_batch_fused`
against `integrate_batch_pallas(interpret=True)` in float64, and B2's
twin against the plain integrator (part of
tests/test_torch_integrate_schw.py, whose docstring states the
tolerances).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_pallas as jp
from grtrace_torch.engine import integrate as ti
from test_torch_integrate_schw import ARGS, _np, rays8

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eq_pair(rays8):
    q0, p0, _ = rays8
    j = _np(jp.integrate_batch_pallas(jnp.asarray(q0), jnp.asarray(p0),
                                      *ARGS, interpret=True,
                                      equatorial=True, compensated=False))
    t = _np(ti.integrate_batch_eq(torch.tensor(q0), torch.tensor(p0), *ARGS))
    return t, j


@pytest.fixture(scope="module")
def generic_pair(rays8):
    q0, _, turned = rays8
    j = _np(jp.integrate_batch_pallas(jnp.asarray(q0), jnp.asarray(turned),
                                      *ARGS, interpret=True,
                                      equatorial=False))
    t = _np(ti.integrate_batch_fused(torch.tensor(q0), torch.tensor(turned),
                                     *ARGS))
    return t, j


def test_eq_twin_status_and_steps_match_pallas(eq_pair):
    t, j = eq_pair
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert (t[2] == ti.STATUS_CAPTURED).any() and (t[2] == 2).any()


def test_eq_twin_positions_match_pallas(eq_pair):
    t, j = eq_pair
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-11)
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-11)
    # the read-out rebuilds the theta slots from the launch state
    assert (t[0][:, 2] == np.pi / 2).all() and (t[1][:, 2] == 0.0).all()


def test_generic_twin_status_and_steps_match_pallas(generic_pair):
    t, j = generic_pair
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])


def test_generic_twin_positions_match_pallas(generic_pair):
    t, j = generic_pair
    dq = np.abs(t[0] - j[0]).max(axis=1)
    dp = np.abs(t[1] - j[1]).max(axis=1)
    esc = t[2] == ti.STATUS_ESCAPED
    assert esc.sum() > 20
    assert dq[esc].max() < 1e-11 and dp[esc].max() < 1e-11
    assert dq[~esc].max() < 1e-6 and dp[~esc].max() < 1e-6
    # the rays left the plane: theta moved
    assert np.abs(t[0][esc, 2] - np.pi / 2).max() > 0.1


def test_eq_twin_matches_plain_integrator_f64(rays8, eq_pair):
    """B2's staggered 12-row twin and the 16-row integrate_batch (the CPU
    path of float64 renders) agree on the folded rays: same statuses and
    steps, escaped rays within 1e-9."""
    q0, p0, _ = map(torch.tensor, rays8)
    a, _ = eq_pair
    b = _np(ti.integrate_batch(q0, p0, *ARGS))
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    esc = a[2] == ti.STATUS_ESCAPED
    assert np.abs(a[0][esc] - b[0][esc]).max() < 1e-9
