"""The Schwarzschild kernels B2 and B3 on the CPU: their eager twins and
flows against the JAX package on the same inputs, the routes that reach
them, and their wrappers' refusals.

* The fused 16-row flows (B3's step), one step: float64 within relative
  1e-13; float32 within 8 ulps of each row's magnitude (XLA:CPU contracts
  `a*b + c` into FMAs, torch eager does not).
* B2's twin `integrate_batch_eq` against `integrate_batch_pallas(
  equatorial=True, compensated=False, interpret=True)` in float64: equal
  statuses and step counts, q and p within 1e-11.
* B3's twin `integrate_batch_fused` against `integrate_batch_pallas(
  equatorial=False, interpret=True)` on rays turned out of the plane, in
  float64: equal statuses and step counts; escaped rays within 1e-11,
  captured rays within 1e-6 (a plunge into the stiff zone amplifies the
  last-ulp sin/cos differences of the two CPU libraries).
* The escape-predicate fault both packages share (ROADMAP Queue C).

The kernels themselves are held against their twins on the card by
chip_smoke.py (phases 17-21); this machine has neither a GPU nor nvcc.

The comparisons that take seconds are in
tests/test_torch_integrate_schw_jax.py and
tests/test_torch_integrate_schw_pallas.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_pallas as jp
from grtrace.engine import validate as jv
from grtrace.physics import camera as jcam
from grtrace.physics import hamiltonian as jh
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_cuda as tc
from grtrace_torch.engine import validate as tv
from grtrace_torch.kernels import build as tbuild
from grtrace_torch.physics import hamiltonian as th

torch.set_num_threads(1)

ARGS = (2000, 0.05, 2.0, 31.0, 1.0)
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


def _rays(n, dtype=np.float64):
    """(q0, p0 folded into the plane, p0 turned out of it by each ray's own
    fold angle beta: p_theta <- -sin(beta) p_phi, p_phi <- cos(beta)
    p_phi), JAX camera."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    q0, p0, _, _, beta = jcam.camera_rays(np.array([30.0, 0.0, 0.0], dtype),
                                          dtype(np.radians(80.0)), n, n,
                                          dtype=jdt)
    q0 = np.asarray(q0, dtype).reshape(-1, 4)
    p0 = np.asarray(p0, dtype).reshape(-1, 4)
    beta = np.asarray(beta).reshape(-1)
    turned = p0.copy()
    turned[:, 2] = -np.sin(beta) * p0[:, 3]
    turned[:, 3] = np.cos(beta) * p0[:, 3]
    return q0, p0, turned.astype(dtype)


# --- the fused flows -------------------------------------------------------

N = 257
DT, RS, COS_W, SIN_W = 0.00625, 2.0, 0.99875, 0.0499792


def _state16(dtype, seed=3):
    """A weak-field 16-row state off the plane (theta in [0.4, 2.7])."""
    rng = np.random.default_rng(seed)
    q1 = [rng.uniform(0, 100, N), rng.uniform(6, 30, N),
          rng.uniform(0.4, 2.7, N), rng.uniform(-3, 3, N)]
    p1 = [rng.uniform(0.5, 1.5, N), rng.uniform(-1, 1, N),
          rng.uniform(-3, 3, N), rng.uniform(-5, 5, N)]
    hi = q1 + p1
    hi = hi + [x + rng.normal(0, 1e-3, N) for x in hi]
    return [np.asarray(x, dtype) for x in hi]


FUSED = [("_flow_a_fused", "flow"), ("_flow_b_fused", "flow"),
         ("fantasy_step_ord2_fused", "step2")]


def _fused_both(name, kind, dtype):
    s = [float(np.asarray(x, dtype)) for x in (DT, RS, 2 * DT, COS_W, SIN_W)]
    args = (s[0], s[1]) if kind == "flow" else (s[2], s[1], s[3], s[4])
    rows = _state16(dtype)
    j = getattr(jh, name)(tuple(jnp.asarray(r) for r in rows), *args)
    t = getattr(th, name)(tuple(torch.tensor(r) for r in rows), *args)
    assert len(j) == len(t) == 16
    return ([x.numpy().astype(np.float64) for x in t],
            [np.asarray(x, np.float64) for x in j])


@pytest.mark.parametrize("name,kind", FUSED, ids=[c[0] for c in FUSED])
def test_fused_flow_f64(name, kind):
    t, j = _fused_both(name, kind, np.float64)
    for k, (a, b) in enumerate(zip(t, j)):
        np.testing.assert_allclose(a, b, rtol=1e-13,
                                   atol=1e-13 * np.abs(b).max(),
                                   err_msg=f"row {k}")


@pytest.mark.parametrize("name,kind", FUSED, ids=[c[0] for c in FUSED])
def test_fused_flow_f32(name, kind):
    t, j = _fused_both(name, kind, np.float32)
    for k, (a, b) in enumerate(zip(t, j)):
        ulp = np.spacing(np.float32(np.abs(b).max()))
        assert np.abs(a - b).max() <= 8 * ulp, f"row {k}"


def test_fused_step_composed_order4():
    rows = _state16(np.float64)
    jsubs = jh.substep_schedule(jnp.asarray(0.05), jnp.asarray(1.0), 4)
    tsubs = th.substep_schedule(0.05, 1.0, 4, dtype=torch.float64)
    j = jh.fantasy_step(tuple(map(jnp.asarray, rows)), jsubs, 2.0,
                        step2_fn=jh.fantasy_step_ord2_fused)
    t = th.fantasy_step(tuple(map(torch.tensor, rows)), tsubs, 2.0,
                        step2_fn=th.fantasy_step_ord2_fused)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(b)).max())


def test_fused_step_is_not_the_unfused_step():
    """Same algorithm, other rounding: within 1e-12 of the unfused step in
    float64, and not bit-equal to it (why B3 needs its own twin)."""
    rows = tuple(map(torch.tensor, _state16(np.float64)))
    a = th.fantasy_step_ord2_fused(rows, 0.0125, 2.0, COS_W, SIN_W)
    b = th.fantasy_step_ord2(rows, 0.0125, 2.0, COS_W, SIN_W)
    assert any(not torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(y.abs().max()))


# --- B2's and B3's twins against the interpret-mode Pallas kernel ---------

@pytest.fixture(scope="module")
def rays8():
    return _rays(8)


def test_eq_twin_zero_steps_is_noop(rays8):
    q0, p0, _ = map(torch.tensor, rays8)
    fq, fp, st, ns = ti.integrate_batch_eq(q0, p0, 0, *ARGS[1:])
    assert torch.equal(fq, q0) and torch.equal(fp, p0)
    assert (ns == 0).all() and (st == ti.STATUS_ALIVE).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("staggered", [False, True])
def test_plain_substep_params_match_pallas(dtype, order, staggered):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    jpar, n_sub = jp._substep_params(
        jnp.asarray(0.01, dtype), jnp.asarray(2.0, dtype),
        jnp.asarray(31.0, dtype), jnp.asarray(1.0, dtype), order,
        compensated=False, staggered=staggered)
    tpar = ti.substep_params(0.01, 2.0, 31.0, 1.0, order, tdt,
                             compensated=False, staggered=staggered)
    assert tpar.dtype == tdt
    assert tpar.numel() == 3 + (4 if staggered else 3) * n_sub
    np.testing.assert_allclose(tpar.numpy(), np.asarray(jpar),
                               rtol=2 * np.finfo(dtype).eps, atol=0)


def test_compensated_substep_params_unchanged():
    """B1's vector is the default and keeps its layout."""
    a = ti.substep_params(0.01, 2.0, 31.0, 1.0, 4)
    b = ti.substep_params(0.01, 2.0, 31.0, 1.0, 4, torch.float32,
                          compensated=True, staggered=True)
    assert torch.equal(a, b) and a.numel() == 3 + 4 * 3


# --- routing, the integrator class and the wrappers -----------------------

def test_dispatch_routes_b2_and_b3_to_their_wrappers(monkeypatch):
    calls = []
    for name in ("integrate_batch_eq_cuda", "integrate_batch_generic_cuda"):
        monkeypatch.setattr(tc, name, lambda *a, _n=name, **k:
                            calls.append(_n) or _n)
    q0 = torch.zeros((3, 4))
    for path, want in (("kernel_eq", "integrate_batch_eq_cuda"),
                       ("kernel_generic", "integrate_batch_generic_cuda")):
        monkeypatch.setattr(ti, "select_path", lambda *a, _p=path: _p)
        assert ti.integrate_dispatch(q0, q0, 10, 0.01, 2.0, 31.0,
                                     1.0) == want
    assert calls == ["integrate_batch_eq_cuda",
                     "integrate_batch_generic_cuda"]


def test_integrator_cuda_backend_calls_b3(monkeypatch):
    calls = []
    monkeypatch.setattr(tc, "integrate_batch_generic_cuda",
                        lambda *a, **k: calls.append((a, k)) or "B3")
    integ = ti.SchwarzschildIntegrator(steps=10, backend="cuda",
                                       dtype=torch.float64, device="cpu",
                                       order=4)
    rays = np.random.default_rng(0).normal(size=(2, 5, 4))
    assert integ.integrate_batch(rays[0], rays[1]) == "B3"
    (a, k), = calls
    assert a[2:] == (10, 0.2, 2.0, 1e6, 1.0) and k == {"order": 4}
    assert a[0].dtype == torch.float64 and a[0].is_contiguous()


def test_integrator_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        ti.SchwarzschildIntegrator(backend="pallas", device="cpu")


def test_b2_b3_wrappers_raise_for_cpu_tensors():
    before = (tc.launches, tc.eq_launches, tc.generic_launches,
              tc.chunk_launches)
    q64 = torch.zeros((4, 4), dtype=torch.float64)
    q32 = torch.zeros((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tc.integrate_batch_eq_cuda(q64, q64, 10, 0.01, 2.0, 31.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tc.integrate_batch_generic_cuda(q32, q32, 10, 0.01, 2.0, 31.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tc.advance_state_cuda(torch.zeros((16, 4)), 10, 0.01, 2.0, 31.0,
                              1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tc.launch_fantasy_eq(torch.zeros((12, 4), dtype=torch.float64),
                             ti.substep_params(0.01, 2.0, 31.0, 1.0, 2,
                                               torch.float64,
                                               compensated=False), 10)
    with pytest.raises(ValueError, match="CUDA"):
        tc.launch_fantasy_schw16(
            torch.zeros((16, 4)),
            ti.substep_params(0.01, 2.0, 31.0, 1.0, 2, compensated=False,
                              staggered=False), 10)
    assert (tc.launches, tc.eq_launches, tc.generic_launches,
            tc.chunk_launches) == before


@pytest.mark.parametrize("dtype,rows,config", [
    (torch.float32, 12, "eq"), (torch.float64, 24, "eqc"),
    (torch.float64, 24, "eqc_chunk")])
def test_launch_rejects_layouts_without_a_kernel(dtype, rows, config):
    """B2 is float64 only, B1 and B4 float32 only."""
    vec = ti.substep_params(0.01, 2.0, 31.0, 1.0, 2, dtype,
                            compensated=config != "eq")
    with pytest.raises(ValueError, match=f"\\({tc.CONFIGS[config][1]}, N\\)"):
        tc._launch(config, torch.zeros((rows, 4), dtype=dtype), vec, 10)


def test_build_registers_the_b2_b3_b4_entries():
    for stem in ("fantasy_eqc", "fantasy_schw16"):
        src = (tbuild.CSRC_DIR / f"{stem}.cu").read_text()
        for name in tbuild.ENTRIES[stem]:
            assert f'extern "C" int {name}(' in src
    wanted = {e for entries, _, _ in tc.CONFIGS.values()
              for e in entries.values()}
    registered = set(tbuild.ENTRIES["fantasy_eqc"]
                     + tbuild.ENTRIES["fantasy_schw16"])
    assert wanted <= registered
    for name in wanted:
        assert len(tbuild.argtypes(name)) == 8
    # x, the two calls' sin and cos, sincos's sin and cos, n, the stream
    assert len(tbuild.argtypes("grt_fantasy_trig_f32_launch")) == 7
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_118fantasy_eqc_kernelIdLb0ELb1EEEvPKT_PS1_PiS3_"
           "iii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 80 registers\n")
    assert tbuild.ptxas_summary(log) == [{
        "kernel": "fantasy_eqc_kernel<d,0,1>", "registers": 80,
        "spill_stores": 0, "spill_loads": 0}]


# --- the Schwarzschild shadow check ----------------------------------------

def test_schwarzschild_analytic_rho_matches_jax():
    for mass in (1.0, 0.7):
        assert tv.schwarzschild_analytic_rho(mass) == pytest.approx(
            jv.schwarzschild_analytic_rho(mass), rel=1e-15)


def test_shadow_error_bisection_with_a_stubbed_integrator(monkeypatch):
    """With the integrator replaced by the exact launch predicate, the
    bisection must land on the analytic boundary within its bracket, in
    both dtypes, and hand its rays to the equatorial dispatch."""
    seen = []

    def exact(q0, p0, steps, delta, rs, r_max, omega, backend, equatorial):
        seen.append((q0.dtype, equatorial, q0.is_contiguous()))
        esc = ti.schw_true_escape_pred(q0, p0, rs)
        status = torch.where(esc, ti.STATUS_ESCAPED, ti.STATUS_CAPTURED)
        return q0, p0, status.to(torch.int32), None

    monkeypatch.setattr(tv, "integrate_dispatch", exact)
    for dtype in (torch.float32, torch.float64):
        res = tv.schwarzschild_shadow_error(dtype=dtype, device="cpu")
        assert res["px_err"] <= res["bracket_px"]
        assert res["rho_analytic"] == round(tv.schwarzschild_analytic_rho(),
                                            3)
        assert len(res["rho_num"]) == tv.N_PSI
    assert {s[0] for s in seen} == {torch.float32, torch.float64}
    assert all(s[1] and s[2] for s in seen)


