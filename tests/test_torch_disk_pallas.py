"""The disk twins of kernel B6 against JAX's Pallas disk kernel in
interpret mode, float64 and float32 (part of tests/test_torch_disk.py,
whose docstring states the tolerances); the hits lie on the plane inside
the annulus; the recorder is pure observation for rays that never hit.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_pallas_ks as jpks
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_ks as tks
from test_torch_disk import (
    DELTA, DISK, OMEGA, R_IN, R_MAX, R_OUT, SPIN, STEPS, _disk_ics)

torch.set_num_threads(1)


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


@pytest.fixture(scope="module")
def jax_disk_f64():
    q0, p0 = _disk_ics()
    out = jpks.integrate_batch_pallas_disk(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA,
        jnp.asarray([1.0, SPIN, 0.0]), R_MAX, OMEGA, R_IN, R_OUT,
        interpret=True, compensated=False)
    return q0, p0, _np(out)


def test_disk_twin_f64_matches_pallas_interpret(jax_disk_f64):
    q0, p0, j = jax_disk_f64
    t = _np(tks.integrate_batch_disk_ks(
        torch.tensor(q0), torch.tensor(p0), STEPS, DELTA, (1.0, SPIN),
        R_MAX, OMEGA, R_IN, R_OUT))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    hit = t[2] == DISK
    # disk hits, captures and escapes all occur
    assert hit.sum() >= 10 and (t[2] == 1).any() and (t[2] == 2).any()
    for k in (4, 5):  # hit_q, hit_p
        np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=1e-9,
                                   atol=1e-12)
        assert not t[k][~hit].any()  # never-hit rays carry zero rows
    np.testing.assert_allclose(t[0], j[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-9, atol=1e-9)


def test_disk_twin_f32_compensated_matches_pallas_interpret():
    q0, p0 = _disk_ics(dtype=np.float32)
    f32 = np.float32
    j = _np(jpks.integrate_batch_pallas_disk(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, f32(DELTA),
        jnp.asarray([1.0, SPIN, 0.0], jnp.float32), f32(R_MAX), f32(OMEGA),
        f32(R_IN), f32(R_OUT), interpret=True, compensated=True))
    t = _np(tks.integrate_batch_disk_ksc(
        torch.tensor(q0), torch.tensor(p0), STEPS, DELTA, (1.0, SPIN, 0.0),
        R_MAX, OMEGA, R_IN, R_OUT))
    assert t[4].dtype == np.float32
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    hit = t[2] == DISK
    assert hit.sum() >= 10
    np.testing.assert_allclose(t[4][hit], j[4][hit], rtol=0, atol=2e-5)
    np.testing.assert_allclose(t[5][hit], j[5][hit], rtol=0, atol=2e-6)
    np.testing.assert_allclose(t[0], j[0], rtol=2e-5, atol=5e-3)


def test_disk_hits_lie_on_the_plane_inside_the_annulus(jax_disk_f64):
    q0, p0, _ = jax_disk_f64
    _, _, st, _, hq, _ = tks.integrate_batch_disk_ks(
        torch.tensor(q0), torch.tensor(p0), STEPS, DELTA, (1.0, SPIN),
        R_MAX, OMEGA, R_IN, R_OUT)
    hq = hq[st == DISK]
    assert float(hq[:, 3].abs().max()) < 0.2
    r = jsp.ks_radius(*(hq[:, i].numpy() for i in (1, 2, 3)), SPIN)
    assert (np.asarray(r) >= R_IN).all() and (np.asarray(r) <= R_OUT).all()


@pytest.mark.parametrize("compensated", [True, False])
def test_recorder_is_pure_observation_for_missers(compensated):
    """Rays that never hit end exactly as the plain-mode twin ends them,
    bit for bit: the disk mode only adds the recorder and the freeze."""
    dtype = np.float32 if compensated else np.float64
    q0, p0 = map(torch.tensor, _disk_ics(12, dtype))
    args = (600, DELTA, (1.0, SPIN), R_MAX, OMEGA)
    plain = (tks.integrate_batch_ksc if compensated
             else tks.integrate_batch_ks)(q0, p0, *args)
    disk = (tks.integrate_batch_disk_ksc if compensated
            else tks.integrate_batch_disk_ks)(q0, p0, *args, R_IN, R_OUT)
    miss = disk[2] != DISK
    assert miss.any() and (~miss).any()
    for a, b in zip(disk[:4], plain):
        assert torch.equal(a[miss], b[miss])
    # a hit ray stops counting steps on the step that hit
    assert (disk[3][~miss] < plain[3][~miss]).all()
