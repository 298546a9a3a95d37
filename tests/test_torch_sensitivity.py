"""engine/sensitivity.py and kernel B6t, the forward-mode tangent mode of
B6 (csrc/fantasy_ks.cu), against forward AD and the JAX package.

  * B6t's explicit-tangent twin `integrate_batch_disk_tangent_ks` against
    forward AD (torch.autograd.forward_ad) of the primal disk twin
    `integrate_batch_disk_ks`, float64, on a tangent of the launch state
    and of the scalars mass, a and charge: the hit rows' tangents within
    1e-11 of the largest (the two differ only in the rounding of their op
    orders), the primal rows bit for bit; and the tangent dispatcher's
    routes;
  * B6t's source built for the CPU with g++ (the CUDA include and launch
    functions sit under __CUDACC__; the shim runs one thread at a time,
    -ffp-contract=off as nvcc's -fmad=false, and routes sqrt to torch's,
    which is not always the C library's) against its twin bit for bit,
    with one and with two directions, its primal rows bit for bit those
    of B6's 16-row disk mode built from the same source; the twin with
    two directions bit for bit two runs with one;
  * `_linearize` (one tangent dispatch with both directions) bit for bit
    the two forward-mode passes of the model, each with its own
    one-direction dispatch;
  * `line_profile_jacobian` against JAX's (`jax.linearize` of the XLA
    loop) on JAX's own test inputs (tests/test_sensitivity.py: 16^2, 900
    steps, delta 0.1, r_out 12): the profile within 1e-10 and J within
    1e-9 of its largest entry (XLA contracts multiply-adds into FMAs, and
    JAX's loop is unstaggered where B6 is staggered); J against central
    finite differences of the port's own model at JAX's tolerance
    (5e-4 of the column's scale); `fisher_forecast` in closed form.
The card holds B6t bitwise against this twin (chip_smoke.py phase 53).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from grtrace_torch.engine import integrate_ks as tk
from grtrace_torch.engine import sensitivity as ts
from grtrace_torch.physics.camera import (cartesian_ics_from_pixels,
                                          pixel_grid_lookat)
from grtrace_torch.physics.hamiltonian import pack_state
from grtrace_torch.physics.spacetime import kerr_schild_g_inv

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grtrace_torch", "csrc")
KNOBS = dict(size=16, steps=900, delta=0.1, r_out=12.0)
CENTERS = np.linspace(0.35, 1.25, 32)
THETA = np.array([0.5, 0.3])            # spin, elevation (rad)
# the disk loop's arguments after the tangents: steps, delta, params,
# dparams, r_max, omega, r_in, r_out
HOLE = (1.0, 0.7, 0.2)


def _rays(dtype, n, seed=0, k=1):
    """The n x n look-at camera 40 degrees above the plane of HOLE (a 40
    degree field: every ray hits the annulus [2.5, 20] or falls in within
    about 670 steps at delta 0.1), and k tangents of its launch state,
    (k, n^2, 4), drawn from a seeded numpy generator."""
    params = torch.tensor(HOLE, dtype=dtype)
    el = math.radians(40.0)
    obs = torch.tensor([30 * math.cos(el), 0.0, 30 * math.sin(el)],
                       dtype=dtype)
    pix = pixel_grid_lookat(obs, torch.tensor(math.radians(40.0),
                                              dtype=dtype), n, n, dtype=dtype)
    q0, p0, _ = cartesian_ics_from_pixels(obs, pix.reshape(-1, 3),
                                          params=params,
                                          g_inv_fn=kerr_schild_g_inv)
    rng = np.random.default_rng(seed)
    dq = torch.tensor(1e-2 * rng.standard_normal((k,) + q0.shape),
                      dtype=dtype)
    dp = torch.tensor(1e-2 * rng.standard_normal((k,) + p0.shape),
                      dtype=dtype)
    return q0.contiguous(), p0.contiguous(), dq, dp


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


def test_twin_matches_forward_ad(monkeypatch):
    """B6t's twin against forward AD of B6's 16-row twin on one direction
    that moves the launch state and all three scalars (the scalars made
    dual through `split_params`, the launch state through its dual
    tensors), 200 steps of delta 0.2: equal hits and primal rows, the
    crossing's tangents within 1e-11 of the largest."""
    q0, p0, dq, dp = _rays(torch.float64, 6)
    dparams = (0.25, 0.5, 0.125)
    args = (200, 0.2, HOLE)
    tail = (31.0, 1.0, 2.5, 20.0)
    want = tk.integrate_batch_disk_tangent_ks(q0, p0, dq, dp, *args,
                                              [dparams], *tail)
    dq, dp = dq[0], dp[0]
    split = tk.split_params

    def dual_scalars(vec):
        (m, a, c, r_cap, r_max, zone), subs = split(vec)
        duals = tuple(fwAD.make_dual(torch.tensor(v, dtype=torch.float64),
                                     torch.tensor(d, dtype=torch.float64))
                      for v, d in zip((m, a, c), dparams))
        return duals + (r_cap, r_max, zone), subs
    with fwAD.dual_level():
        monkeypatch.setattr(tk, "split_params", dual_scalars)
        out = tk.integrate_batch_disk_ks(fwAD.make_dual(q0, dq),
                                         fwAD.make_dual(p0, dp), *args,
                                         *tail)
        monkeypatch.undo()
        hq, hp = (fwAD.unpack_dual(t) for t in out[4:6])
    hit = want[2] == tk.STATUS_DISK
    assert int(hit.sum()) >= 10
    assert torch.equal(hq.primal, want[4]) and torch.equal(hp.primal,
                                                           want[5])
    for ad, explicit in ((hq.tangent, want[6][0]), (hp.tangent, want[7][0])):
        scale = float(explicit[hit].abs().max())
        assert scale > 1e-3
        np.testing.assert_allclose(explicit[hit].numpy(),
                                   ad[hit].numpy(), rtol=0,
                                   atol=1e-11 * scale)
        assert not bool(explicit[~hit].any())   # no hit: zero rows


def test_tangent_dispatch_routes():
    """CPU rays take B6t's twin; the CUDA wrapper refuses CPU tensors (no
    fallback) and launches nothing; an unknown backend or device raises;
    B6t's C entries are registered with the build."""
    from grtrace_torch.engine import integrate_ks_cuda as tkc
    from grtrace_torch.engine import metrics
    from grtrace_torch.kernels import build as tbuild
    q0, p0, dq, dp = _rays(torch.float64, 3)
    args = (40, 0.2, HOLE, [(0.0, 1.0, 0.0)], 31.0, 1.0, 2.5, 20.0)
    got = tk.integrate_dispatch_disk_tangent(q0, p0, dq, dp, *args)
    want = tk.integrate_batch_disk_tangent_ks(q0, p0, dq, dp, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    before = tkc.disk_tangent_launches
    with pytest.raises(ValueError, match="CUDA"):
        tkc.integrate_batch_disk_tangent_cuda(q0, p0, dq, dp, *args)
    with pytest.raises(ValueError, match="unknown backend"):
        tk.integrate_dispatch_disk_tangent(q0, p0, dq, dp, *args,
                                           backend="pallas")
    meta = [t.to("meta") for t in (q0, p0, dq, dp)]
    with pytest.raises(ValueError, match="no tangent disk integrator"):
        tk.integrate_dispatch_disk_tangent(*meta, *args)
    assert tkc.disk_tangent_launches == before
    names = set(tbuild.ENTRIES["fantasy_ks"])
    assert set(tkc.TANGENT_ENTRIES.values()) <= names
    for name in tkc.TANGENT_ENTRIES.values():
        assert len(tbuild.argtypes(name)) == 12
    assert metrics.flops_per_ray_step("fantasy_ks_tangent") > \
        2 * metrics.flops_per_ray_step("fantasy_ks_plain")
    # two directions count the rows' and the kick/drift's operations once
    assert (metrics.flops_per_ray_step("fantasy_ks_tangent2")
            < 2 * metrics.flops_per_ray_step("fantasy_ks_tangent"))


SHIM = r"""
#include <cmath>
using std::isfinite;
using std::fabs;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx;
template <typename T> static inline T __ldg(const T* p) { return *p; }

// the square roots of the twins' one-element tensors
static double (*host_sqrt64)(double) = nullptr;
static float (*host_sqrt32)(float) = nullptr;
extern "C" void set_sqrt(double (*s64)(double), float (*s32)(float)) {
  host_sqrt64 = s64;
  host_sqrt32 = s32;
}
static inline double tsqrt(double x) { return host_sqrt64(x); }
static inline float tsqrt(float x) { return host_sqrt32(x); }
#define sqrt(x) tsqrt(x)
#include "fantasy_ks.cu"
#undef sqrt

template <typename T, Mode M>
static void run(const T* in, const T* tin, T* out, int* ns, T* rec,
                T* rec_d, const T* params, const T* dparams, int n,
                int n_sub, int steps) {
  const unsigned threads = kThreadsOf<M>;
  blockDim.x = threads;
  for (unsigned b = 0; b * threads < unsigned(n); ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      threadIdx.x = t;
      fantasy_ks_kernel<T, false, M>(in, tin, out, ns, rec, rec_d, nullptr,
                                     params, dparams, n, n_sub, steps, 0);
    }
  }
}

// B6t with one and two directions: (state_in, tan_in, state_out, ns,
// disk, disk_d, params, dparams, n, n_sub, steps); B6's 16-row disk mode
// the same, tan_in, disk_d and dparams unused
#define ENTRY(NAME, T, M)                                                  \
  extern "C" void NAME(const T* in, const T* tin, T* out, int* ns, T* rec, \
                       T* rec_d, const T* params, const T* dparams, int n, \
                       int n_sub, int steps) {                             \
    run<T, M>(in, tin, out, ns, rec, rec_d, params, dparams, n, n_sub,     \
              steps);                                                      \
  }
ENTRY(host_b6t_f32, float, Mode::kDiskTangent)
ENTRY(host_b6t_f64, double, Mode::kDiskTangent)
ENTRY(host_b6t2_f32, float, Mode::kDiskTangent2)
ENTRY(host_b6t2_f64, double, Mode::kDiskTangent2)
ENTRY(host_b6_f32, float, Mode::kDisk)
ENTRY(host_b6_f64, double, Mode::kDisk)
"""
_SQRT64 = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_double)
_SQRT32 = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


def _torch_sqrt(dtype):
    def sqrt(x):
        return float(torch.sqrt(torch.tensor([x], dtype=dtype)))
    return sqrt


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """fantasy_ks.cu's B6t (one and two directions) and B6 (16 rows)
    built for the CPU: {(name, dtype) -> entry}, or a skip where g++ is
    missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the host emulation")
    d = tmp_path_factory.mktemp("ks_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libks_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {"sqrt": (_SQRT64(_torch_sqrt(torch.float64)),
                    _SQRT32(_torch_sqrt(torch.float32)))}
    so.set_sqrt(*out["sqrt"])
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        for name in ("b6t", "b6t2", "b6"):
            fn = getattr(so, f"host_{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            fn.restype = None
            out[name, dtype] = fn
    return out


# two directions' scalar tangents: one that moves all three scalars, one
# that moves a alone (the spin direction of a linearization)
DPARAMS = [(0.25, 0.5, 0.125), (0.0, 1.0, 0.0)]


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "k2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_b6t_source_bitwise_equal_to_twin(host, dtype, k):
    """B6t's source with k directions, one thread at a time, against its
    twin on an 8x8 camera (hits, guard parks): all eight outputs bit for
    bit, and its primal rows bit for bit B6's 16-row disk mode."""
    q0, p0, dq, dp = _rays(dtype, 8, k=k)
    steps, dparams = 700, DPARAMS[:k]
    want = tk.integrate_batch_disk_tangent_ks(
        q0, p0, dq, dp, steps, 0.1, HOLE, dparams, 31.0, 1.0, 2.5, 20.0)
    vec = tk.ks_params(0.1, HOLE, 31.0, 1.0, 2, False, dtype,
                       disk=(2.5, 20.0))
    dvec = tk.ks_tangent_params(dparams, dtype)
    n, n_sub = q0.shape[0], tk.n_substeps(vec)
    state_in = torch.stack(pack_state(q0, p0)).contiguous()
    tan_in = torch.stack(pack_state(dq, dp), dim=1).reshape(16 * k, n)
    runs, b6t = {}, "b6t" if k == 1 else "b6t2"
    for name in (b6t, "b6"):
        out = torch.empty_like(state_in)
        ns = torch.empty(n, dtype=torch.int32)
        rec = torch.empty((9, n), dtype=dtype)
        rec_d = torch.empty((8 * k, n), dtype=dtype)
        host[name, dtype](state_in.data_ptr(), tan_in.data_ptr(),
                          out.data_ptr(), ns.data_ptr(), rec.data_ptr(),
                          rec_d.data_ptr(), vec.data_ptr(), dvec.data_ptr(),
                          n, n_sub, steps)
        runs[name] = (out, ns, rec, rec_d)
    (out, ns, rec, rec_d), b6 = runs[b6t], runs["b6"]
    assert torch.equal(_bits(out), _bits(b6[0]))
    assert torch.equal(ns, b6[1])
    assert torch.equal(_bits(rec), _bits(b6[2]))
    rec_d = rec_d.reshape(k, 8, n)
    got = tk.finish_disk(tuple(out), ns, rec, q0, p0, vec, False) + (
        rec_d[:, :4].transpose(1, 2), rec_d[:, 4:].transpose(1, 2))
    for g, w in zip(got, want):
        assert torch.equal(_bits(g) if g.is_floating_point() else g,
                           _bits(w) if w.is_floating_point() else w)
    assert int((want[2] == tk.STATUS_DISK).sum()) > 0
    assert int((ns < 0).sum()) > 0        # the guard's park is covered


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_b6t_twin_two_directions_bitwise_one_each(dtype):
    """The twin with two directions against two runs of it with one, on a
    5x5 camera (180 steps of 0.2, hits among them): the six primal outputs
    and each direction's crossing tangents bit for bit."""
    q0, p0, dq, dp = _rays(dtype, 5, seed=1, k=2)
    args = (180, 0.2, HOLE)
    tail = (31.0, 1.0, 2.5, 20.0)
    both = tk.integrate_batch_disk_tangent_ks(q0, p0, dq, dp, *args,
                                              DPARAMS, *tail)
    assert int((both[2] == tk.STATUS_DISK).sum()) > 0
    for d in range(2):
        one = tk.integrate_batch_disk_tangent_ks(
            q0, p0, dq[d:d + 1], dp[d:d + 1], *args, DPARAMS[d:d + 1], *tail)
        for g, w in zip(both[:6], one[:6]):
            assert torch.equal(_bits(g) if g.is_floating_point() else g,
                               _bits(w) if w.is_floating_point() else w)
        for g, w in zip(both[6:], one[6:]):
            assert torch.equal(_bits(g[d]), _bits(w[0]))
        assert bool(both[6][d].any())


def test_linearize_one_dispatch_bitwise_two_passes(monkeypatch):
    """`line_profile_jacobian` (one primal pass, one tangent dispatch with
    both directions) against the model's two forward-mode passes, each
    with its primal dispatch and a one-direction tangent dispatch, on the
    CPU (a 5x5 camera, 220 steps of 0.2): the profile and every column of
    J bit for bit, and one tangent dispatch, with two directions, and no
    primal dispatch in the linearization."""
    knobs = dict(size=5, steps=220, delta=0.2, r_out=12.0)
    calls = []

    def counted(name):
        fn = getattr(ts, name)

        def wrapped(q0, *args, **kw):
            calls.append((name, args[1].shape[0] if "tangent" in name
                          else 0))
            return fn(q0, *args, **kw)
        monkeypatch.setattr(ts, name, wrapped)
    counted("integrate_dispatch_disk")
    counted("integrate_dispatch_disk_tangent")
    prof, jac = ts.line_profile_jacobian(THETA, CENTERS, device="cpu",
                                         **knobs)
    assert calls == [("integrate_dispatch_disk_tangent", 2)]
    theta = torch.as_tensor(THETA)
    for k in range(2):
        e = torch.zeros_like(theta)
        e[k] = 1.0
        with fwAD.dual_level():
            dual = ts.line_profile_model(fwAD.make_dual(theta, e), CENTERS,
                                         device="cpu", **knobs)
            primal, tangent = fwAD.unpack_dual(dual)
        assert np.array_equal(primal.numpy().view(np.int64),
                              prof.view(np.int64))
        assert np.array_equal(tangent.numpy().view(np.int64),
                              jac[:, k].copy().view(np.int64))
    assert calls[1:] == [("integrate_dispatch_disk", 0),
                         ("integrate_dispatch_disk_tangent", 1)] * 2
    assert np.abs(jac).max() > 0.0


@pytest.fixture(scope="module")
def jax_jacobian():
    """JAX's line_profile_jacobian on its own test inputs (once)."""
    from grtrace.engine.sensitivity import line_profile_jacobian
    return line_profile_jacobian(THETA, CENTERS, **KNOBS)


@pytest.fixture(scope="module")
def port_jacobian():
    """The port's line_profile_jacobian on the CPU (the twins; once)."""
    return ts.line_profile_jacobian(THETA, CENTERS, device="cpu", **KNOBS)


def test_jacobian_matches_jax(port_jacobian, jax_jacobian):
    """The port's (profile, J) against JAX's on the same theta; the
    normalized profile sums to one and J's columns to zero."""
    prof, jac = port_jacobian
    prof_j, jac_j = jax_jacobian
    assert prof.shape == (32,) and jac.shape == (32, 2)
    assert prof.dtype == jac.dtype == np.float64
    np.testing.assert_allclose(prof, prof_j, rtol=0, atol=1e-10)
    for k in range(2):
        scale = np.abs(jac_j[:, k]).max()
        assert scale > 0.0
        np.testing.assert_allclose(jac[:, k], jac_j[:, k], rtol=0,
                                   atol=1e-9 * scale)
    assert prof.sum() == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_allclose(jac.sum(axis=0), 0.0, atol=1e-12)


def test_jacobian_matches_finite_differences_and_fisher(port_jacobian):
    """J against central differences of the port's model (JAX's test:
    h = 3e-5, 5e-4 of each column's scale); fisher_forecast in closed form
    and positive definite on the real J."""
    _, jac = port_jacobian
    h = 3e-5
    for k in range(2):
        tp, tm = THETA.copy(), THETA.copy()
        tp[k] += h
        tm[k] -= h
        fd = (ts.line_profile_model(tp, CENTERS, device="cpu", **KNOBS)
              - ts.line_profile_model(tm, CENTERS, device="cpu", **KNOBS)
              ).numpy() / (2 * h)
        scale = np.abs(jac[:, k]).max()
        np.testing.assert_allclose(jac[:, k], fd, atol=5e-4 * scale)
    out = ts.fisher_forecast(np.array([[1.0, 0.0], [0.0, 2.0], [0.0, 0.0]]),
                             noise_sigma=0.5)
    np.testing.assert_allclose(out["fisher"], np.diag([4.0, 16.0]))
    np.testing.assert_allclose(out["errors"], [0.5, 0.25])
    assert out["correlation"] == pytest.approx(0.0)
    real = ts.fisher_forecast(jac, noise_sigma=0.01)
    assert (np.linalg.eigvalsh(real["fisher"]) > 0.0).all()
    assert (real["errors"] > 0.0).all() and -1.0 < real["correlation"] < 1.0
