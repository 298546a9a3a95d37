"""The Kerr-Schild twins of kernel B5 against the JAX package (part of
tests/test_torch_integrate_ks.py, whose docstring states the tolerances):
integrate_batch_ksc (32 rows, float32) against JAX's XLA twin at orders 2
and 4, charge 0 and 0.3, and integrate_batch_ks (16 rows, float64)
against the Pallas kernel in interpret mode at orders 2 and 4.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_ks as jks
from grtrace.engine import integrate_pallas_ks as jpks
from grtrace_torch.engine import integrate_ks as tks
from test_torch_integrate_ks import DELTA, OMEGA, R_MAX, SPIN, STEPS, _ics, _np

torch.set_num_threads(1)


@pytest.mark.parametrize("order,charge", [(2, 0.0), (2, 0.3), (4, 0.0),
                                          (4, 0.3)])
def test_ksc_twin_matches_jax(order, charge):
    q0, p0 = _ics(dtype=np.float32, charge=charge)
    f32 = jnp.float32
    params = (1.0, SPIN, charge)
    j = _np(jks.integrate_batch_ksc(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, f32(DELTA),
        jnp.asarray(params, f32), f32(R_MAX), f32(OMEGA), order=order))
    t = _np(tks.integrate_batch_ksc(torch.tensor(q0), torch.tensor(p0),
                                    STEPS, DELTA, params, R_MAX, OMEGA,
                                    order=order))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    # captured, escaped and still-running rays all occur
    assert set(np.unique(t[2])) == {0, 1, 2}
    np.testing.assert_allclose(t[0], j[0], rtol=2e-5, atol=5e-5)
    free = j[2] != 1
    np.testing.assert_allclose(t[1][free], j[1][free], rtol=2e-5, atol=5e-5)
    # a captured ray's momentum blueshifts exponentially toward the past
    # horizon, which amplifies the same last-ulp differences
    np.testing.assert_allclose(t[1][~free], j[1][~free], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("order", [2, 4])
def test_ks_twin_matches_pallas_interpret_f64(order):
    q0, p0 = _ics()
    j = _np(jpks.integrate_batch_pallas_ks(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA,
        jnp.asarray([1.0, SPIN]), R_MAX, OMEGA, order=order,
        interpret=True, compensated=False))
    t = _np(tks.integrate_batch_ks(torch.tensor(q0), torch.tensor(p0),
                                   STEPS, DELTA, (1.0, SPIN), R_MAX, OMEGA,
                                   order=order))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert (t[2] == 1).any() and (t[2] == 2).any()
    np.testing.assert_allclose(t[0], j[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-9, atol=1e-9)
