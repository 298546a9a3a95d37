"""The port's integrators against the JAX package on the same launch states.

* integrate_batch (16-row, float64) vs JAX's: equal status and step
  counts, weak-field (r > 3) positions within 1e-8 (near-critical rays
  amplify last-ulp differences chaotically).
* integrate_batch_compensated (float32, the CUDA kernel's eager twin) vs
  JAX's XLA twin and its Pallas kernel in interpret mode at 512 steps:
  equal step counts, q and p within 1e-6 — and at the full 200k-step
  headline budget against the float64 oracle golden.
* The dispatch rules, decided from the tensors' device and dtype, with no
  kernel launched: B1, B2 or B3 on CUDA, the eager paths on the CPU.

The CUDA kernel itself is compared with its twin on the card, by
chip_smoke.py (this machine has neither a GPU nor nvcc).

The comparisons that take seconds are in tests/test_torch_integrate_jax.py
and tests/test_torch_integrate_oracle.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate as ji
from grtrace.engine import integrate_pallas as jp
from grtrace.physics import camera as jcam
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_cuda as tc
from grtrace_torch.kernels import build as tbuild

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "oracle_escape_headline.npz")


ARGS = (2000, 0.05, 2.0, 31.0, 1.0)


def _np(xs):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in xs]


def _ics(n, dtype=jnp.float64):
    q0, p0, *_ = jcam.camera_rays(np.array([30.0, 0.0, 0.0]),
                                  np.radians(80.0), n, n, dtype=dtype)
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64
    return (np.asarray(q0, np_dtype).reshape(-1, 4),
            np.asarray(p0, np_dtype).reshape(-1, 4))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def probes_f32(golden):
    """Float32 camera states of the 186 golden probe pixels (JAX camera)."""
    g = golden
    q0, p0, *_ = jcam.camera_rays(
        np.array([float(g["obs_x"]), 0.0, 0.0], np.float32),
        np.float32(g["fov"]), int(g["size"]), int(g["size"]),
        mass_bh=float(g["mass"]), dtype=jnp.float32)
    idx = g["flat_idx"]
    return (np.asarray(q0).reshape(-1, 4)[idx],
            np.asarray(p0).reshape(-1, 4)[idx])


def test_compensated_zero_steps_is_noop(probes_f32):
    q0, p0 = map(torch.tensor, probes_f32)
    fq, fp, st, ns = ti.integrate_batch_compensated(q0, p0, 0, 0.01, 2.0,
                                                    31.0, 1.0)
    assert torch.equal(fq, q0) and torch.equal(fp[:, [0, 1, 3]],
                                               p0[:, [0, 1, 3]])
    assert (ns == 0).all() and (st == ti.STATUS_ALIVE).all()


@pytest.mark.parametrize("n_rows", [16, 12, 24])
def test_guard_state_matches_jax(n_rows):
    rng = np.random.default_rng(n_rows)
    old = [rng.uniform(3, 30, 64) for _ in range(n_rows)]
    new = [o + rng.normal(0, 0.1, 64) for o in old]
    r_row = 1
    new[r_row][::7] += 50.0        # jumps beyond the cap
    new[r_row][3::11] = np.nan     # non-finite
    j = ji.guard_state(tuple(map(jnp.asarray, old)),
                       tuple(map(jnp.asarray, new)), 2.0, 5.0)
    t = ti.guard_state(tuple(map(torch.tensor, old)),
                       tuple(map(torch.tensor, new)), 2.0, 5.0)
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)


def test_escape_predicate_and_rescue_match_jax():
    rng = np.random.default_rng(1)
    n = 512
    q0 = np.stack([np.zeros(n), rng.uniform(2.5, 30, n),
                   np.full(n, np.pi / 2), np.zeros(n)], -1)
    p0 = np.stack([rng.uniform(0.5, 1.5, n), rng.uniform(-1, 1, n),
                   np.zeros(n), rng.uniform(0, 9, n)], -1)
    jpred = np.asarray(ji.schw_true_escape_pred(jnp.asarray(q0),
                                                jnp.asarray(p0), 2.0))
    tpred = ti.schw_true_escape_pred(torch.tensor(q0), torch.tensor(p0), 2.0)
    assert np.array_equal(tpred.numpy(), jpred)
    assert np.allclose(ti.impact_parameter(torch.tensor(p0)).numpy(),
                       np.asarray(ji.impact_parameter(jnp.asarray(p0))),
                       rtol=1e-15)
    fq = np.stack([np.zeros(n), rng.uniform(1.5, 35, n),
                   np.full(n, np.pi / 2), rng.uniform(0, 6, n)], -1)
    status = rng.integers(0, 3, n).astype(np.int32)
    jq, jst = ji.schw_escape_rescue(jnp.asarray(fq), jnp.asarray(fq),
                                    jnp.asarray(status), jnp.asarray(jpred),
                                    2.0, 31.0)
    tq, tst = ti.schw_escape_rescue(torch.tensor(fq), torch.tensor(fq),
                                    torch.tensor(status), tpred, 2.0, 31.0)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("order", [2, 4])
def test_substep_params_layout_matches_pallas(dtype, order):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    jpar, n_sub = jp._substep_params(
        jnp.asarray(0.01, dtype), jnp.asarray(2.0, dtype),
        jnp.asarray(31.0, dtype), jnp.asarray(1.0, dtype), order,
        compensated=True, staggered=True)
    tpar = ti.substep_params(0.01, 2.0, 31.0, 1.0, order, tdt)
    assert tpar.dtype == tdt and tpar.numel() == 3 + 4 * n_sub
    np.testing.assert_allclose(tpar.numpy(), np.asarray(jpar),
                               rtol=2 * np.finfo(dtype).eps, atol=0)


def test_jump_cap():
    for d in (0.01, 0.05, 0.5, -0.7):
        assert ti.jump_cap(d, torch.float64) == float(
            ji.jump_cap(jnp.asarray(d), jnp.float64))


@pytest.mark.parametrize("rs", [2.0, 1.4])
def test_cost_sort_key_matches_pallas(rs):
    """The port forms the JAX key's b term for term, and centres its key on
    b_crit = 3 sqrt(3) M = 1.5 sqrt(3) rs, where the JAX key centres on
    3 sqrt(3) rs: a deliberate divergence in launch order only."""
    q0, p0 = _ics(16)
    j = np.asarray(jp._cost_sort_key(jnp.asarray(q0), jnp.asarray(p0), rs))
    tq, tp = torch.tensor(q0), torch.tensor(p0)
    b = tc._impact_parameter(tq, tp, rs).numpy()
    # JAX's key is |b - 3 sqrt(3) rs| of its own b: the same b, ray by ray
    np.testing.assert_allclose(np.abs(b - 3.0 * np.sqrt(3.0) * rs), j,
                               rtol=1e-12, atol=1e-12)
    t = tc._cost_sort_key(tq, tp, rs).numpy()
    np.testing.assert_array_equal(t, np.abs(b - 1.5 * np.sqrt(3.0) * rs))
    # a ray launched at b_crit from r0 = 30 has key 0
    r0, b_crit = 30.0, 1.5 * np.sqrt(3.0) * rs
    f = 1.0 - rs / r0
    sin_a = b_crit * np.sqrt(f) / r0
    qc = torch.tensor([[0.0, r0, np.pi / 2, 0.0]], dtype=torch.float64)
    pc = torch.tensor([[-1.0, -np.sqrt(f) * np.sqrt(1.0 - sin_a ** 2), 0.0,
                        0.0]], dtype=torch.float64)
    assert float(tc._cost_sort_key(qc, pc, rs)[0]) < 1e-12
    assert int(np.argmin(t)) == int(np.argmin(np.abs(b - b_crit)))


def test_schwarzschild_integrator_defaults_to_the_card(monkeypatch):
    """Like the JAX class, which runs on the default device (the chip),
    the port's class defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ti.SchwarzschildIntegrator()
    assert ti.SchwarzschildIntegrator(device="cpu").device.type == "cpu"


# --- dispatch rules: pure logic and mocks, nothing is launched -----------

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("backend,device,dtype,equatorial,path", [
    ("auto", CUDA, torch.float32, True, "kernel"),
    ("cuda", CUDA, torch.float32, True, "kernel"),
    ("auto", CUDA, torch.float64, True, "kernel_eq"),
    ("cuda", CUDA, torch.float64, True, "kernel_eq"),
    ("auto", CUDA, torch.float32, False, "kernel_generic"),
    ("auto", CUDA, torch.float64, False, "kernel_generic"),
    ("cuda", CPU, torch.float64, False, "kernel_generic"),
    ("auto", CPU, torch.float32, True, "compensated"),
    ("auto", CPU, torch.float64, True, "plain"),
    ("auto", CPU, torch.float32, False, "plain"),
    ("auto", CPU, torch.float64, False, "plain"),
    ("torch", CUDA, torch.float32, True, "compensated"),
    ("torch", CUDA, torch.float64, True, "plain"),
    ("torch", CUDA, torch.float32, False, "plain"),
    ("torch", CUDA, torch.float64, False, "plain"),
])
def test_select_path(backend, device, dtype, equatorial, path):
    assert ti.select_path(backend, device, dtype, equatorial) == path


@pytest.mark.parametrize("dtype,equatorial,kernel", [
    (torch.float64, True, "B2"), (torch.float32, False, "B3")])
def test_cuda_without_kernel_raises(monkeypatch, dtype, equatorial, kernel):
    """The CUDA routes of B2 and B3 reach their kernel or raise: here the
    wrapper refuses rays it cannot launch on, and no eager twin runs in
    its place, nor does any launch counter move."""
    path = ti.select_path("auto", CUDA, dtype, equatorial)
    assert path == {"B2": "kernel_eq", "B3": "kernel_generic"}[kernel]
    monkeypatch.setattr(ti, "select_path", lambda *a: path)
    twins = []
    for name in ("integrate_batch", "integrate_batch_eq",
                 "integrate_batch_fused", "integrate_batch_compensated"):
        monkeypatch.setattr(ti, name, lambda *a, **k: twins.append(a))
    before = (tc.launches, tc.eq_launches, tc.generic_launches)
    q0 = torch.zeros((4, 4), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        ti.integrate_dispatch(q0, q0, 10, 0.01, 2.0, 31.0, 1.0,
                              equatorial=equatorial)
    assert not twins
    assert (tc.launches, tc.eq_launches, tc.generic_launches) == before


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        ti.select_path("pallas", CPU, torch.float32, True)


def test_dispatch_routes_kernel_path_to_the_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(ti, "select_path", lambda *a: "kernel")
    monkeypatch.setattr(tc, "integrate_batch_cuda",
                        lambda *a, **k: calls.append((a, k)) or "kernel")
    q0 = torch.zeros((3, 4))
    assert ti.integrate_dispatch(q0, q0, 10, 0.01, 2.0, 31.0, 1.0,
                                 equatorial=True) == "kernel"
    assert len(calls) == 1


def test_kernel_wrapper_raises_for_cpu_tensors():
    before = tc.launches
    q0 = torch.zeros((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tc.integrate_batch_cuda(q0, q0, 10, 0.01, 2.0, 31.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tc.launch_fantasy_eqc(torch.zeros((24, 4)),
                              ti.substep_params(0.01, 2.0, 31.0, 1.0, 2),
                              10)
    assert tc.launches == before


def test_build_flags_keep_ieee_rounding():
    flags = " ".join(tbuild.NVCC_FLAGS)
    assert "-fmad=false" in flags and "sm_90a" in flags
    assert "fast_math" not in flags and "prec-div=false" not in flags


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(tbuild, "library_path",
                        lambda src: tmp_path / f"lib{src.stem}.so")
    with pytest.raises(tbuild.KernelBuildError, match="nvcc"):
        tbuild.build()
