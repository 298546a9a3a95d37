"""The trajectory sampler: the eager twin `integrate_batch_full` against the
JAX package's, kernel S1's source (the record mode of grtrace_torch/csrc/
fantasy_schw16.cu) built for the CPU against the twin bit for bit, and the
dispatch that sends CUDA rays to S1 and CPU rays to the twin.

Tolerances:
  * twin vs JAX: weak-field records (r > 3) within a relative 1e-10 in
    float64 and 2e-5 in float32 (XLA contracts multiply-adds into FMAs and
    torch does not, and the twin steps with kernel B3's fused flows where
    JAX steps with the unfused ones, ROADMAP Queue C: last-ulp differences
    that grow over hundreds of steps; inside r = 3 a plunging ray
    amplifies them chaotically, so there only the exit step is compared),
    the same rows zero in both (equal exit steps), and every zero row +0.0
    in the port (JAX leaves -0.0 in a dead ray's negative components: a
    deliberate divergence in the sign of zero, Queue C);
  * S1's source vs the twin: bitwise.
S1 itself runs on the card only; chip_smoke.py holds it against the twin
there.

The record's layout and S1's build entries are in
tests/test_torch_traj_layout.py; B3's source (the same file's integrate
mode, through `build_host`) in tests/test_torch_schw16_host.py.
"""
import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate as ji
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_cuda as tc
from grtrace_torch.physics.camera import camera_rays

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grtrace_torch", "csrc")
# steps, delta, rs, r_max, omega: the 3x3 camera's rays exit between
# steps 20 and 300 (one captured), some run to the budget's end
ARGS = (300, 0.2, 2.0, 31.0, 1.0)
TOL = {np.float32: 2e-5, np.float64: 1e-10}

SHIM = r"""
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx;
template <typename T> static inline T __ldg(const T* p) { return *p; }

#include "fantasy_schw16.cu"

template <typename T, Mode M>
static void run(const T* in, const T* p0, T* out, int* ns, const T* params,
                int n, int n_sub, int steps, int stride, int n_keep) {
  const unsigned threads = threads_of(M);
  blockDim.x = threads;
  for (unsigned b = 0; b * threads < unsigned(n); ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      threadIdx.x = t;
      fantasy_schw16_kernel<T, M>(in, p0, out, ns, params, n, n_sub, steps,
                                  stride, n_keep);
    }
  }
}

// S1 (the record mode): (q0, p0, traj, ns, params, n, n_sub, steps, stride,
// n_keep); B3 (the integrate mode): (state_in, state_out, ns, params, n,
// n_sub, steps); T1 (the trace mode): (q0, p0, out, params, n, n_sub,
// steps)
extern "C" {
void host_s1_f32(const float* q0, const float* p0, float* traj, int* ns,
                 const float* params, int n, int n_sub, int steps,
                 int stride, int n_keep) {
  run<float, Mode::kRecord>(q0, p0, traj, ns, params, n, n_sub, steps,
                            stride, n_keep);
}
void host_s1_f64(const double* q0, const double* p0, double* traj, int* ns,
                 const double* params, int n, int n_sub, int steps,
                 int stride, int n_keep) {
  run<double, Mode::kRecord>(q0, p0, traj, ns, params, n, n_sub, steps,
                             stride, n_keep);
}
void host_b3_f32(const float* in, float* out, int* ns, const float* params,
                 int n, int n_sub, int steps) {
  run<float, Mode::kIntegrate>(in, nullptr, out, ns, params, n, n_sub,
                               steps, 1, 0);
}
void host_b3_f64(const double* in, double* out, int* ns,
                 const double* params, int n, int n_sub, int steps) {
  run<double, Mode::kIntegrate>(in, nullptr, out, ns, params, n, n_sub,
                                steps, 1, 0);
}
void host_t1_f32(const float* q0, const float* p0, float* out,
                 const float* params, int n, int n_sub, int steps) {
  run<float, Mode::kTrace>(q0, p0, out, nullptr, params, n, n_sub, steps, 1,
                           0);
}
void host_t1_f64(const double* q0, const double* p0, double* out,
                 const double* params, int n, int n_sub, int steps) {
  run<double, Mode::kTrace>(q0, p0, out, nullptr, params, n, n_sub, steps,
                            1, 0);
}
}
"""


def _rays(np_dtype, n=3):
    """The n x n headline camera's launch states as numpy arrays, fed to
    both packages."""
    dtype = torch.float32 if np_dtype == np.float32 else torch.float64
    obs = torch.tensor([30.0, 0.0, 0.0], dtype=dtype)
    q0, p0, *_ = camera_rays(obs, np.radians(80.0), n, n, dtype=dtype)
    return q0.reshape(-1, 4).numpy(), p0.reshape(-1, 4).numpy()


# (dtype, order, n_keep): the render's sampler (float32, stride > 1), the
# single-ray driver's record (float64, stride 1) and order 4 (each JAX
# compile of an order-4 loop costs seconds)
CASES = [(np.float32, 2, 40), (np.float64, 2, None), (np.float32, 4, 40)]


@pytest.mark.parametrize("np_dtype,order,n_keep", CASES,
                         ids=lambda c: getattr(c, "__name__", str(c)))
def test_twin_matches_jax(np_dtype, order, n_keep):
    q0, p0 = _rays(np_dtype)
    j = np.asarray(ji.integrate_batch_full(jnp.asarray(q0), jnp.asarray(p0),
                                           *ARGS, n_keep=n_keep,
                                           order=order))
    t = ti.integrate_batch_full(torch.tensor(q0), torch.tensor(p0), *ARGS,
                                n_keep=n_keep, order=order).numpy()
    assert t.dtype == j.dtype == np_dtype and t.shape == j.shape
    assert t.shape[1] == ti.traj_layout(ARGS[0], n_keep)[1]
    dead_t, dead_j = (t == 0).all(-1), (j == 0).all(-1)
    assert np.array_equal(dead_t, dead_j) and dead_t.any()
    weak = j[..., 1] > 3.0
    np.testing.assert_allclose(t[weak], j[weak], rtol=TOL[np_dtype],
                               atol=TOL[np_dtype])
    assert not np.signbit(t[dead_t]).any()  # +0.0, where JAX has -0.0


def build_host(tmp_path_factory):
    """fantasy_schw16.cu built for the CPU: {("s1" | "b3" | "t1", dtype)
    -> entry}, or a skip where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the host emulation")
    d = tmp_path_factory.mktemp("schw16_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libschw16_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        s1 = getattr(so, f"host_s1_{suffix}")
        s1.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        b3 = getattr(so, f"host_b3_{suffix}")
        b3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        t1 = getattr(so, f"host_t1_{suffix}")
        t1.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        s1.restype = b3.restype = t1.restype = None
        out["s1", dtype], out["b3", dtype], out["t1", dtype] = s1, b3, t1
    return out


@pytest.fixture(scope="module")
def host_s1(tmp_path_factory):
    """S1's source (the record mode of fantasy_schw16.cu) built for the
    CPU: {float32, float64} -> entry."""
    built = build_host(tmp_path_factory)
    return {dtype: built["s1", dtype]
            for dtype in (torch.float32, torch.float64)}


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


@pytest.mark.parametrize("dtype,order,n_keep", [
    (torch.float32, 2, None), (torch.float64, 4, 60)],
    ids=["f32-ord2-stride1", "f64-ord4-stride7"])
def test_kernel_source_bitwise_equal_to_twin(host_s1, dtype, order,
                                             n_keep):
    """S1's source, one thread at a time, against integrate_batch_full on a
    3x3 headline camera at delta 0.2: every slot bit for bit (+0.0 past
    each exit included); the horizon guard parks the captured ray at
    r == rs in both cases, so its revert runs too."""
    obs = torch.tensor([30.0, 0.0, 0.0], dtype=dtype)
    q0, p0, *_ = camera_rays(obs, np.radians(80.0), 3, 3, dtype=dtype)
    q0, p0 = q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()
    steps, delta = 400, 0.2
    args = (steps, delta, 2.0, 31.0, 1.0)
    want = ti.integrate_batch_full(q0, p0, *args, n_keep=n_keep, order=order)
    stride, n_keep_eff = ti.traj_layout(steps, n_keep)
    params = ti.substep_params(delta, 2.0, 31.0, 1.0, order, dtype,
                               compensated=False, staggered=False)
    traj = torch.zeros((q0.shape[0], n_keep_eff, 4), dtype=dtype)
    ns = torch.zeros(q0.shape[0], dtype=torch.int32)
    host_s1[dtype](q0.data_ptr(), p0.data_ptr(), traj.data_ptr(),
                   ns.data_ptr(), params.data_ptr(), q0.shape[0],
                   (params.numel() - 3) // 3, steps, stride, n_keep_eff)
    assert torch.equal(_bits(traj), _bits(want))
    assert int(ns.max()) < steps  # every ray exited inside the budget
    if n_keep is None:  # the record shows the guard's park
        assert bool((traj[:, :, 1] == 2.0).any())


def test_full_dispatch_routes():
    """CPU rays take the twin; CUDA rays go to S1 (its wrapper, which
    refuses CPU tensors: no fallback); any other device raises."""
    q0, p0 = (torch.from_numpy(a) for a in _rays(np.float64, 2))
    got = ti.integrate_full_dispatch(q0, p0, 50, 0.1, 2.0, 31.0, 1.0,
                                     n_keep=10)
    want = ti.integrate_batch_full(q0, p0, 50, 0.1, 2.0, 31.0, 1.0,
                                   n_keep=10)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        tc.integrate_batch_full_cuda(q0, p0, 50, 0.1, 2.0, 31.0, 1.0)
    with pytest.raises(ValueError, match="no trajectory sampler"):
        ti.integrate_full_dispatch(q0.to("meta"), p0.to("meta"), 50, 0.1,
                                   2.0, 31.0, 1.0)


