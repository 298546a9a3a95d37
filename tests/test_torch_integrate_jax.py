"""The Schwarzschild integrators against the JAX package (part of
tests/test_torch_integrate.py, whose docstring states the tolerances):
integrate_batch in float64, the compensated twin against JAX's XLA twin
and its Pallas kernel in interpret mode, at orders 4 and 6, and
integrate_batch_full.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate as ji
from grtrace.engine import integrate_pallas as jp
from grtrace_torch.engine import integrate as ti
from test_torch_integrate import ARGS, _ics, _np, golden, probes_f32

torch.set_num_threads(1)


def test_integrate_batch_f64_matches_jax():
    q0, p0 = _ics(16)
    j = _np(ji.integrate_batch(jnp.asarray(q0), jnp.asarray(p0), *ARGS))
    t = _np(ti.integrate_batch(torch.tensor(q0), torch.tensor(p0), *ARGS))
    assert np.array_equal(t[2], j[2])
    assert np.array_equal(t[3], j[3])
    weak = j[0][:, 1] > 3.0
    assert np.abs(t[0] - j[0]).max(axis=1)[weak].max() < 1e-8
    assert np.abs(t[1] - j[1]).max(axis=1)[weak].max() < 1e-8


@pytest.mark.parametrize("reference", ["xla_twin", "pallas_interpret"])
def test_compensated_twin_matches_jax(golden, probes_f32, reference):
    g = golden
    q0, p0 = probes_f32[0][:24], probes_f32[1][:24]
    args = (512, float(g["delta"]), 2.0 * float(g["mass"]), float(g["rmax"]),
            float(g["omega"]))
    if reference == "xla_twin":
        j = ji.integrate_batch_compensated(jnp.asarray(q0), jnp.asarray(p0),
                                           *args)
    else:
        j = jp.integrate_batch_pallas(jnp.asarray(q0), jnp.asarray(p0),
                                      *args, interpret=True, equatorial=True,
                                      compensated=True)
    j = _np(j)
    t = _np(ti.integrate_batch_compensated(torch.tensor(q0),
                                           torch.tensor(p0), *args))
    assert np.array_equal(t[3], j[3])
    assert np.array_equal(t[2], j[2])
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("order", [4, 6])
def test_compensated_twin_higher_order_matches_jax(order):
    q0, p0 = _ics(6, jnp.float32)
    args = (400, 0.05, 2.0, 31.0, 1.0)
    j = _np(ji.integrate_batch_compensated(jnp.asarray(q0), jnp.asarray(p0),
                                           *args, order=order))
    t = _np(ti.integrate_batch_compensated(torch.tensor(q0),
                                           torch.tensor(p0), *args,
                                           order=order))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    weak = j[0][:, 1] > 3.0
    assert np.abs(t[0] - j[0]).max(axis=1)[weak].max() < 1e-5


def test_integrate_batch_full_matches_jax():
    q0, p0 = _ics(4)
    args = (400, 0.05, 2.0, 31.0, 1.0)
    j = np.asarray(ji.integrate_batch_full(jnp.asarray(q0), jnp.asarray(p0),
                                           *args, n_keep=60))
    t = ti.integrate_batch_full(torch.tensor(q0), torch.tensor(p0), *args,
                                n_keep=60).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-9)
