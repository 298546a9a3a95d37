"""One step of every FANTASY flow family, port vs JAX, on the same random
states (made with numpy from a seed).

float64: the port keeps the JAX association term by term, so the two agree
to relative 1e-13.  float32: XLA:CPU contracts `a*b + c` into fused
multiply-adds and torch eager does not, so the two round differently at the
last ulp; the bound is 4 ulps of each row's magnitude.  Kahan deficit rows
are rounding residuals, so the compensated family is compared on its best
estimate s - c (and on s itself).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.physics import hamiltonian as jh
from grtrace_torch.physics import hamiltonian as th

torch.set_num_threads(1)

N = 257
DT, RS, COS_W, SIN_W, BRIDGE = 0.00625, 2.0, 0.99875, 0.0499792, 0.0125
OMC_W = 1.0 - COS_W


def _rows(n_rows, dtype, seed=3):
    """A weak-field state of `n_rows` rows (16, 12 or 24), N rays each."""
    rng = np.random.default_rng(seed)
    q1 = [rng.uniform(0, 100, N), rng.uniform(6, 30, N),
          rng.uniform(0.4, 2.7, N), rng.uniform(-3, 3, N)]
    p1 = [rng.uniform(0.5, 1.5, N), rng.uniform(-1, 1, N),
          rng.uniform(-3, 3, N), rng.uniform(-5, 5, N)]
    if n_rows != 16:  # equatorial: drop the theta slots
        q1, p1 = [q1[0], q1[1], q1[3]], [p1[0], p1[1], p1[3]]
    hi = q1 + p1
    hi = hi + [x + rng.normal(0, 1e-3, N) for x in hi]
    rows = [np.asarray(x, dtype) for x in hi]
    if n_rows == 24:
        eps = np.finfo(dtype).eps
        rows += [np.asarray(x * eps * rng.uniform(-0.5, 0.5, N), dtype)
                 for x in rows]
    return rows


def _scal(x, dtype):
    return float(np.asarray(x, dtype))


# (family rows, JAX/port function name, argument kind)
CASES = [
    (16, "_flow_a", "flow"), (16, "_flow_b", "flow"),
    (16, "_flow_mixed", "mixed"), (16, "fantasy_step_ord2", "step2"),
    (12, "_flow_a_eq", "flow"), (12, "_flow_b_eq", "flow"),
    (12, "_flow_mixed_eq", "mixed"), (12, "fantasy_step_ord2_eq", "step2"),
    (12, "staggered_eq.open", "open"), (12, "staggered_eq.core", "core"),
    (12, "staggered_eq.close", "open"),
    (24, "_flow_a_eqc", "flow"), (24, "_flow_b_eqc", "flow"),
    (24, "_flow_mixed_eqc", "mixed_omc"),
    (24, "fantasy_step_ord2_eqc", "step2_omc"),
    (24, "staggered_eqc.open", "open"), (24, "staggered_eqc.core", "core"),
    (24, "staggered_eqc.close", "open"),
]


def _fn(mod, name):
    if "." in name:
        fam, which = name.split(".")
        return getattr(mod, fam)[("open", "core", "close").index(which)]
    return getattr(mod, name)


def _args(kind, dtype):
    s = lambda x: _scal(x, dtype)  # noqa: E731
    return {"flow": (s(DT), s(RS)), "mixed": (s(COS_W), s(SIN_W)),
            "mixed_omc": (s(OMC_W), s(SIN_W)),
            "step2": (s(2 * DT), s(RS), s(COS_W), s(SIN_W)),
            "step2_omc": (s(2 * DT), s(RS), s(OMC_W), s(SIN_W)),
            "open": (s(2 * DT), s(RS)),
            "core": (s(2 * DT), s(RS), s(OMC_W), s(SIN_W), s(BRIDGE))}[kind]


def _run_both(n_rows, name, kind, dtype):
    rows = _rows(n_rows, dtype)
    args = _args(kind, dtype)
    j = _fn(jh, name)(tuple(jnp.asarray(r) for r in rows), *args)
    t = _fn(th, name)(tuple(torch.tensor(r) for r in rows), *args)
    j = [np.asarray(x, np.float64) for x in j]
    t = [x.numpy().astype(np.float64) for x in t]
    assert len(j) == len(t) == n_rows
    if n_rows == 24:  # compare s and the best estimate s - c
        j = j[:12] + [a - c for a, c in zip(j[:12], j[12:])]
        t = t[:12] + [a - c for a, c in zip(t[:12], t[12:])]
    return j, t


@pytest.mark.parametrize("n_rows,name,kind", CASES,
                         ids=[c[1] for c in CASES])
def test_flow_f64(n_rows, name, kind):
    j, t = _run_both(n_rows, name, kind, np.float64)
    for k, (a, b) in enumerate(zip(t, j)):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13 * scale,
                                   err_msg=f"row {k}")


@pytest.mark.parametrize("n_rows,name,kind", CASES,
                         ids=[c[1] for c in CASES])
def test_flow_f32(n_rows, name, kind):
    j, t = _run_both(n_rows, name, kind, np.float32)
    for k, (a, b) in enumerate(zip(t, j)):
        ulp = np.spacing(np.float32(np.abs(b).max()))
        assert np.abs(a - b).max() <= 4 * ulp, f"row {k}"


def test_kahan_add_op_sequence():
    """_kahan_add is the exact four-op sequence: its deficit recovers the
    rounding error of s + inc exactly (s - c is the float64 sum)."""
    rng = np.random.default_rng(5)
    s = torch.tensor(rng.uniform(1, 100, 1000), dtype=torch.float32)
    inc = torch.tensor(rng.uniform(-1e-3, 1e-3, 1000), dtype=torch.float32)
    c = torch.zeros_like(s)
    t, c_new = th._kahan_add(s, c, inc)
    js, jc = jh._kahan_add(jnp.asarray(s.numpy()), jnp.asarray(c.numpy()),
                           jnp.asarray(inc.numpy()))
    assert np.array_equal(t.numpy(), np.asarray(js))
    assert np.array_equal(c_new.numpy(), np.asarray(jc))
    exact = s.double() + inc.double()
    assert torch.equal(t.double() - c_new.double(), exact)


@pytest.mark.parametrize("order", [2, 4, 6, 8])
def test_yoshida_gammas(order):
    assert th.yoshida_gammas(order) == jh.yoshida_gammas(order)


def test_yoshida_gammas_rejects_odd_order():
    with pytest.raises(ValueError):
        th.yoshida_gammas(3)


@pytest.mark.parametrize("order", [2, 4, 6, 8])
@pytest.mark.parametrize("omc", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_substep_schedule(order, omc, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    j = jh.substep_schedule(jnp.asarray(0.01, dtype), jnp.asarray(1.0, dtype),
                            order, omc=omc)
    t = th.substep_schedule(0.01, 1.0, order, omc=omc, dtype=tdt)
    assert len(t) == len(j) == 3 ** ((order - 2) // 2)
    rtol = 2 * np.finfo(dtype).eps  # CPU sin/cos may differ by an ulp
    np.testing.assert_allclose(np.asarray(t), np.asarray(j, np.float64),
                               rtol=rtol, atol=0)
    jb = jh.bridge_sizes([s[0] for s in j])
    tb = th.bridge_sizes([s[0] for s in t], dtype=tdt)
    np.testing.assert_allclose(tb, np.asarray(jb, np.float64), rtol=rtol)


def test_fantasy_step_composed_order4():
    rows = _rows(16, np.float64)
    jsubs = jh.substep_schedule(jnp.asarray(0.05), jnp.asarray(1.0), 4)
    tsubs = th.substep_schedule(0.05, 1.0, 4, dtype=torch.float64)
    j = jh.fantasy_step(tuple(map(jnp.asarray, rows)), jsubs, 2.0)
    t = th.fantasy_step(tuple(map(torch.tensor, rows)), tsubs, 2.0)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("pack", ["pack_state", "pack_state_eq",
                                  "pack_state_eqc"])
def test_pack_helpers(pack):
    rng = np.random.default_rng(9)
    q0, p0 = rng.normal(size=(8, 4)), rng.normal(size=(8, 4))
    j = getattr(jh, pack)(jnp.asarray(q0), jnp.asarray(p0))
    t = getattr(th, pack)(torch.tensor(q0), torch.tensor(p0))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_unpack_helpers():
    rows = _rows(16, np.float64)
    for fn in ("unpack_q1", "unpack_p1"):
        j = getattr(jh, fn)(tuple(map(jnp.asarray, rows)))
        t = getattr(th, fn)(tuple(map(torch.tensor, rows)))
        assert np.array_equal(t.numpy(), np.asarray(j))
    rows = _rows(24, np.float64)
    j = jh.unpack_eqc(tuple(map(jnp.asarray, rows)))
    t = th.unpack_eqc(tuple(map(torch.tensor, rows)))
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_hamiltonian():
    rows = _rows(16, np.float64)
    q, p = np.stack(rows[0:4], -1), np.stack(rows[4:8], -1)
    j = np.asarray(jh.hamiltonian(jnp.asarray(q), jnp.asarray(p), 2.0))
    t = th.hamiltonian(torch.tensor(q), torch.tensor(p), 2.0).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)
