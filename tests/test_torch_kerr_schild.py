"""The port's Kerr-Schild physics against the JAX package on the same inputs.

* Every flow (plain 16-row, compensated 32-row, staggered open/core/close),
  `_kick_drift`, `hamiltonian_ks` and `ks_radius_c` on random phase
  points made with numpy, run through the JAX functions under jax.jit (as
  the JAX package runs them) and through the port.
  - float64: relative 1e-13 of each row's magnitude;
  - float32: 8 ulps of each row's magnitude, because XLA:CPU contracts
    a*b + c into FMAs and torch eager does not (ROADMAP Queue C).
  A deficit row is measured against the magnitude of its state row: an
  ulp's difference in s moves the deficit by that much.
* physics.spacetime (ks_radius, kerr_schild_g_inv, horizon_radius,
  null_p_t) and the Cartesian camera, float64, to 1e-12.

The CUDA kernel that runs these flows is compared with them on the card by
chip_smoke.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.physics import camera as jcam
from grtrace.physics import kerr_schild as jk
from grtrace.physics import spacetime as jsp
from grtrace_torch.physics import camera as tcam
from grtrace_torch.physics import kerr_schild as tk
from grtrace_torch.physics import spacetime as tsp

torch.set_num_threads(1)

M, A, Q = 1.0, 0.9, 0.3
N = 256
ULPS = 8


def _tol(dtype):
    return 1e-13 if dtype == np.float64 else ULPS * np.finfo(np.float32).eps


def _rows(dtype, compensated=False, seed=0):
    """A 16- (or 32-) row state of random phase points: both copies near
    the same position at BL radii 2.5..30, momenta O(1), deficits at the
    float32 rounding scale."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(N, 3))
    pos *= rng.uniform(2.5, 30.0, (N, 1)) / np.linalg.norm(pos, axis=1,
                                                           keepdims=True)
    rows = [rng.normal(size=N) for _ in range(16)]
    for k in range(3):
        rows[1 + k] = pos[:, k]
        rows[9 + k] = pos[:, k] * (1.0 + 1e-3 * rng.normal(size=N))
    if compensated:
        rows += [1e-7 * rng.normal(size=N) for _ in range(16)]
    return [r.astype(dtype) for r in rows]


def _in(x, dtype):
    """A Python float exact in `dtype` (the flows' scalar contract)."""
    return float(np.asarray(x, dtype))


def _assert_rows_close(t_rows, j_rows, dtype):
    t_rows = [t.numpy() for t in t_rows]
    j_rows = [np.asarray(j) for j in j_rows]
    assert len(t_rows) == len(j_rows)
    for i, (t, j) in enumerate(zip(t_rows, j_rows)):
        ref = j_rows[i % 16]  # a deficit row scales with its state row
        scale = max(np.abs(ref).max(), 1e-30)
        err = np.abs(t.astype(np.float64) - j).max() / scale
        assert err <= _tol(dtype), f"row {i}: {err:.3e} of its magnitude"


def _jit(fn, *args):
    return jax.jit(lambda s: fn(s, *args))


FLOWS_16 = {
    "flow_a": (jk._flow_a_ks, tk._flow_a_ks, lambda d: (0.5 * d, M, A, Q)),
    "flow_b": (jk._flow_b_ks, tk._flow_b_ks, lambda d: (0.5 * d, M, A, Q)),
    "open": (jk.open_ks, tk.open_ks, lambda d: (d, M, A, Q)),
    "core": (jk.core_ks, tk.core_ks,
             lambda d: (d, M, A, np.cos(2 * d), np.sin(2 * d), d, Q)),
    "close": (jk.close_ks, tk.close_ks, lambda d: (d, M, A, Q)),
}
FLOWS_32 = {
    "flow_a_ksc": (jk._flow_a_ksc, tk._flow_a_ksc,
                   lambda d: (0.5 * d, M, A, Q)),
    "flow_b_ksc": (jk._flow_b_ksc, tk._flow_b_ksc,
                   lambda d: (0.5 * d, M, A, Q)),
    "mixed_ksc": (jk._flow_mixed_ksc, tk._flow_mixed_ksc,
                  lambda d: (2 * np.sin(d) ** 2, np.sin(2 * d))),
    "open_ksc": (jk.open_ksc, tk.open_ksc, lambda d: (d, M, A, Q)),
    "core_ksc": (jk.core_ksc, tk.core_ksc,
                 lambda d: (d, M, A, 2 * np.sin(d) ** 2, np.sin(2 * d), d,
                            Q)),
    "close_ksc": (jk.close_ksc, tk.close_ksc, lambda d: (d, M, A, Q)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(FLOWS_16) + sorted(FLOWS_32))
def test_flow_matches_jax(name, dtype):
    compensated = name in FLOWS_32
    fj, ft, args = (FLOWS_32 if compensated else FLOWS_16)[name]
    args = tuple(_in(x, dtype) for x in args(0.05))
    rows = _rows(dtype, compensated)
    j = _jit(fj, *args)(tuple(map(jnp.asarray, rows)))
    t = ft(tuple(map(torch.tensor, rows)), *args)
    _assert_rows_close(t, j, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kick_drift_hamiltonian_radius_match_jax(dtype):
    rows = _rows(dtype)
    pt = [rows[i] for i in (1, 2, 3, 12, 13, 14, 15)]
    j = jax.jit(lambda *x: jk._kick_drift(*x, M, A, Q))(*map(jnp.asarray, pt))
    t = tk._kick_drift(*map(torch.tensor, pt), M, A, Q)
    _assert_rows_close(t, j, dtype)
    jh = jax.jit(lambda *x: jk.hamiltonian_ks(*x, M, A, Q))(
        *map(jnp.asarray, pt))
    th = tk.hamiltonian_ks(*map(torch.tensor, pt), M, A, Q)
    _assert_rows_close([th], [jh], dtype)
    jr = jax.jit(lambda *x: jk.ks_radius_c(*x, A))(*map(jnp.asarray, pt[:3]))
    tr = tk.ks_radius_c(*map(torch.tensor, pt[:3]), A)
    _assert_rows_close([tr], [jr], dtype)


def test_pack_unpack_ksc():
    rng = np.random.default_rng(3)
    q0, p0 = rng.normal(size=(7, 4)), rng.normal(size=(7, 4))
    j = jk.pack_state_ksc(jnp.asarray(q0), jnp.asarray(p0))
    t = tk.pack_state_ksc(torch.tensor(q0), torch.tensor(p0))
    assert len(t) == tk.N_STATE_KSC == len(j)
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    rows = _rows(np.float64, compensated=True)
    for a, b in zip(tk.unpack_ksc(tuple(map(torch.tensor, rows))),
                    jk.unpack_ksc(tuple(map(jnp.asarray, rows)))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_spacetime_pieces_match_jax():
    rng = np.random.default_rng(5)
    q = np.zeros((64, 4))
    q[:, 1:] = rng.normal(size=(64, 3)) * 8.0
    params = np.array([M, A, Q])
    jr = np.asarray(jsp.ks_radius(q[:, 1], q[:, 2], q[:, 3], A))
    tr = tsp.ks_radius(*(torch.tensor(q[:, i]) for i in (1, 2, 3)), A)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-13)

    jg = np.asarray(jax.vmap(lambda x: jsp.kerr_schild_g_inv(
        x, jnp.asarray(params)))(jnp.asarray(q)))
    tg = tsp.kerr_schild_g_inv(torch.tensor(q), params)
    assert tg.shape == (64, 4, 4)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-12, atol=1e-14)

    p_sp = rng.normal(size=(64, 3))
    jp = np.asarray(jax.vmap(lambda p, x: jsp.null_p_t(
        p, x, jnp.asarray(params), jsp.kerr_schild_g_inv))(
            jnp.asarray(p_sp), jnp.asarray(q)))
    tp = tsp.null_p_t(torch.tensor(p_sp), torch.tensor(q), params,
                      tsp.kerr_schild_g_inv)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-12, atol=1e-13)

    for a, qc in ((0.9, 0.0), (0.5, 0.3), (0.0, 0.0), (1.2, 0.0)):
        j = float(jsp.horizon_radius("Kerr", 1.0, a, qc))
        t = float(tsp.horizon_radius("KerrSchild",
                                     torch.tensor(1.0, dtype=torch.float64),
                                     a, qc))
        assert abs(t - j) < 1e-15


def test_horizon_radius_other_families_not_ported():
    """Kerr-de Sitter, the static and the rotating regular families (all
    ported) give JAX's bisected outer horizon within 1e-12 relative, NaN
    where there is none."""
    f64 = torch.tensor(1.0, dtype=torch.float64)
    j = float(jsp.horizon_radius("KerrDS", 1.0, 0.3, 1e-3))
    t = float(tsp.horizon_radius("KerrDS", f64, 0.3, 1e-3))
    assert abs(t - j) <= 1e-12 * j
    assert math.isnan(float(tsp.horizon_radius("KerrDS", f64, 1.2, 1e-3)))
    j = float(jsp.horizon_radius("RotatingBardeen", 1.0, 0.9, 0.2))
    t = float(tsp.horizon_radius("RotatingBardeen", f64, 0.9, 0.2))
    assert abs(t - j) <= 1e-12 * j
    assert math.isnan(float(tsp.horizon_radius("RotatingBardeen", f64, 0.9,
                                               0.3)))
    j = float(jsp.horizon_radius("Bardeen", 1.0, 0.3))
    t = float(tsp.horizon_radius("Bardeen", torch.tensor(
        1.0, dtype=torch.float64), 0.3))
    assert abs(t - j) <= 1e-12 * j
    assert math.isnan(float(tsp.horizon_radius(
        "Hayward", torch.tensor(1.0, dtype=torch.float64), 0.9)))


@pytest.mark.parametrize("spin,charge", [(0.9, 0.0), (0.5, 0.3)])
def test_cartesian_camera_matches_jax(spin, charge):
    params = [1.0, spin, charge]
    jq, jp, ja = jcam.camera_rays_cartesian(
        jnp.array([30.0, 0.0, 0.0]), jnp.radians(80.0), 12, 10,
        params=jnp.asarray(params), g_inv_fn=jsp.kerr_schild_g_inv,
        dtype=jnp.float64)
    tq, tp, ta = tcam.camera_rays_cartesian(
        torch.tensor([30.0, 0.0, 0.0], dtype=torch.float64),
        np.radians(80.0), 12, 10, params=params,
        g_inv_fn=tsp.kerr_schild_g_inv, dtype=torch.float64)
    assert tq.shape == (12, 10, 4) and ta.shape == (12, 10)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-12)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-12)
    # null by construction: H = 1/2 g^{ab} p_a p_b = 0 at the camera
    h = tk.hamiltonian_ks(tq[..., 1], tq[..., 2], tq[..., 3], tp[..., 0],
                          tp[..., 1], tp[..., 2], tp[..., 3], 1.0, spin,
                          charge)
    assert float(h.abs().max()) < 1e-12
