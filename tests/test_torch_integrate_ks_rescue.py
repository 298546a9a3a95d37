"""The Kerr-Schild twins' host pieces against the JAX package (part of
tests/test_torch_integrate_ks.py): the 32-row float32 twin against the
float64 one, the Bardeen predicate and rescue, the status rule, the
cost-sort key, and the recorder modes' step builder.

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
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda as tkc
from test_torch_integrate_ks import DELTA, OMEGA, R_MAX, SPIN, STEPS, _ics, _np

torch.set_num_threads(1)


def test_compensated_f32_tracks_f64():
    """The point of the 32-row layout: float32 escaped finals stay near
    the float64 16-row result, closer than the plain float32 flows."""
    q0, p0 = _ics()
    args = (STEPS, DELTA, (1.0, SPIN), R_MAX, OMEGA)
    q64, _, s64, _ = tks.integrate_batch_ks(torch.tensor(q0),
                                            torch.tensor(p0), *args)
    q32, p32 = torch.tensor(q0, dtype=torch.float32), torch.tensor(
        p0, dtype=torch.float32)
    qc, _, sc, _ = tks.integrate_batch_ksc(q32, p32, *args)
    qp, _, sp, _ = tks.integrate_batch_ks(q32, p32, *args)
    assert torch.equal(sc, s64)
    esc = s64 == 2
    assert int(esc.sum()) > 20
    err_comp = float((qc.double() - q64)[esc, 1:].abs().max())
    err_plain = float((qp.double() - q64)[esc, 1:].abs().max())
    assert err_comp < 1e-5 and err_comp < err_plain


def _random_launch_states(n=600, seed=7):
    """Camera-like launch states off the equator: unit spatial covectors
    from random points at r ~ 20..30, p_t from the null quadratic."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos *= rng.uniform(20.0, 30.0, (n, 1)) / np.linalg.norm(
        pos, axis=1, keepdims=True)
    aim = -pos + rng.normal(size=(n, 3)) * 6.0
    p_sp = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    q0 = np.concatenate([np.zeros((n, 1)), pos], axis=1)
    params = jnp.asarray([1.0, SPIN, 0.3])
    import jax
    p_t = np.asarray(jax.vmap(lambda p, q: jsp.null_p_t(
        p, q, params, jsp.kerr_schild_g_inv))(jnp.asarray(p_sp),
                                              jnp.asarray(q0)))
    return q0, np.concatenate([p_t[:, None], p_sp], axis=1)


@pytest.mark.parametrize("charge", [0.0, 0.3])
def test_bardeen_escape_pred_matches_jax(charge):
    q0, p0 = _random_launch_states()
    j = np.asarray(jks.bardeen_escape_pred(jnp.asarray(q0), jnp.asarray(p0),
                                           1.0, SPIN, charge))
    t = tks.bardeen_escape_pred(torch.tensor(q0), torch.tensor(p0), 1.0,
                                SPIN, charge).numpy()
    assert 0.05 < j.mean() < 0.95  # both fates occur
    assert np.array_equal(t, j)
    # the 64-point grid of jnp.linspace, exactly
    g = tks._unit_grid(64, torch.float32, "cpu").numpy()
    assert np.array_equal(g, np.asarray(jnp.linspace(0.0, 1.0, 64,
                                                     dtype=jnp.float32)))


def test_apply_bardeen_rescue_and_status_match_jax():
    q0, p0 = _random_launch_states(200, seed=9)
    rng = np.random.default_rng(10)
    n = len(q0)
    fq = np.concatenate([rng.uniform(0, 50, (n, 1)),
                         rng.normal(size=(n, 3)) * 12.0], axis=1)
    fp = rng.normal(size=(n, 4))
    q2 = rng.normal(size=(n, 3)) * 3.0
    ns = rng.integers(1, 900, n).astype(np.int32)
    ns[::3] *= -1  # guard-parked rays
    r_cap = 1.05 * (1.0 + np.sqrt(1.0 - SPIN ** 2))
    j = _np(jks.apply_bardeen_rescue(
        jnp.asarray(fq), jnp.asarray(fp), jnp.asarray(ns), jnp.asarray(q2),
        jnp.asarray(q0), jnp.asarray(p0), 1.0, SPIN, 0.0, r_cap, R_MAX))
    t = _np(tks.apply_bardeen_rescue(
        torch.tensor(fq), torch.tensor(fp), torch.tensor(ns),
        torch.tensor(q2), torch.tensor(q0), torch.tensor(p0), 1.0, SPIN,
        0.0, r_cap, R_MAX))
    np.testing.assert_allclose(t[0], j[0], rtol=1e-14, atol=1e-14)
    assert np.array_equal(t[1], j[1])
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert set(np.unique(t[2])) == {0, 1, 2}
    js = np.asarray(jks.ks_status(jnp.asarray(fq), SPIN, r_cap, R_MAX))
    ts = tks.ks_status(torch.tensor(fq), SPIN, r_cap, R_MAX).numpy()
    assert np.array_equal(ts, js)


def test_cost_sort_key_matches_jax():
    q0, p0 = _ics(8)
    j = np.asarray(jpks._cost_sort_key_ks(jnp.asarray(q0), jnp.asarray(p0),
                                          1.0))
    t = tkc._cost_sort_key_ks(torch.tensor(q0), torch.tensor(p0), 1.0)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=1e-12)


def test_make_ks_step_disk_and_subrings_not_ported():
    """Both recorder modes are ported now: the disk mode (B6) and the
    subring mode (B7) steps carry their recorders (tests/test_torch_disk.py
    and tests/test_torch_subring.py hold them to JAX)."""
    args = (((0.1, 0.0, 0.0, 0.1),), 1.0, SPIN, 0.0, 2.0, 31.0, 3.9)
    q0, p0 = map(torch.tensor, _ics(2))
    _, sub_step, _, _ = tks.make_ks_step(*args, subrings=3,
                                         dtype=torch.float64)
    state = tuple(torch.cat([q0, p0, q0, p0], dim=1).T)
    out = sub_step(state, torch.zeros(4, dtype=torch.int32),
                   torch.zeros(4, dtype=torch.int32),
                   torch.zeros((3, 8, 4), dtype=torch.float64))
    assert len(out) == 4 and len(out[0]) == 16 and (out[1] == 1).all()
    assert out[3].shape == (3, 8, 4)
    _, step, _, _ = tks.make_ks_step(*args, disk=(6.0, 20.0),
                                     dtype=torch.float64)
    state = tuple(torch.cat([q0, p0, q0, p0], dim=1).T)
    ns = torch.zeros(4, dtype=torch.int32)
    hit = torch.zeros(4, dtype=torch.bool)
    zeros = (torch.zeros(4, dtype=torch.float64),) * 4
    out = step(state, ns, hit, zeros, zeros)
    assert len(out) == 5 and len(out[0]) == 16 and (out[1] == 1).all()
