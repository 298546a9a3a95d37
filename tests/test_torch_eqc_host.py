"""The kernel source of B1, B2 and B4 (grtrace_torch/csrc/fantasy_eqc.cu),
compiled for the CPU, against its unchanged eager twins, bit for bit.

The source keeps its CUDA runtime include and its launch functions under
`#ifdef __CUDACC__`, so g++ compiles the rest behind a small shim that
spells CUDA's keywords as plain C++ (`__ldg` as a load, `blockIdx` /
`blockDim` / `threadIdx` as statics) and runs each kernel one thread at a
time over 128-thread blocks.  Built with `-ffp-contract=off`, as the
card's `-fmad=false`, every operation rounds once, as the twins' torch ops
do.  On a 20x20 headline camera at delta 0.05 the guard parks rays at
r == rs, so its revert to the pre-step copy runs too, and order 4 runs
the general substep loop beside order 2's.

What this cannot show: occupancy, spills and the card's own rounding.
chip_smoke.py holds the built kernels against the twins on the card.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grtrace_torch.engine import checkpoint as ck
from grtrace_torch.engine import integrate as ti
from grtrace_torch.physics.camera import camera_rays
from grtrace_torch.physics.hamiltonian import pack_state_eq, pack_state_eqc

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grtrace_torch", "csrc")
SIZE, STEPS, DELTA, RS, R_MAX, OMEGA = 20, 2500, 0.05, 2.0, 31.0, 1.0
# B4's first chunk: shorter than most rays need (about 900-1,050 steps)
CHUNK = 1000

SHIM = r"""
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx;
template <typename T> static inline T __ldg(const T* p) { return *p; }

#include "fantasy_eqc.cu"

template <typename T, bool kComp, bool kOpenClose>
static void run(const T* in, T* out, int* ns, const T* params, int n,
                int n_sub, int steps) {
  blockDim.x = kThreads;
  for (unsigned b = 0; b * kThreads < unsigned(n); ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < unsigned(kThreads); ++t) {
      threadIdx.x = t;
      fantasy_eqc_kernel<T, kComp, kOpenClose>(in, out, ns, params, n,
                                               n_sub, steps);
    }
  }
}

extern "C" {
void host_b1(const float* in, float* out, int* ns, const float* params,
             int n, int n_sub, int steps) {
  run<float, true, true>(in, out, ns, params, n, n_sub, steps);
}
void host_b2(const double* in, double* out, int* ns, const double* params,
             int n, int n_sub, int steps) {
  run<double, false, true>(in, out, ns, params, n, n_sub, steps);
}
void host_b4(const float* in, float* out, int* ns, const float* params,
             int n, int n_sub, int steps) {
  run<float, true, false>(in, out, ns, params, n, n_sub, steps);
}
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The kernel source built for the CPU: {'B1', 'B2', 'B4'} -> entry."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the host emulation")
    d = tmp_path_factory.mktemp("eqc_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libeqc_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {}
    for name in ("B1", "B2", "B4"):
        fn = getattr(so, f"host_{name.lower()}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        fn.restype = None
        out[name] = fn
    return out


def _launch(fn, state, params, steps):
    """The emulated kernel on a packed (rows, N) state: (state_out, ns)."""
    state = state.contiguous()
    out = torch.empty_like(state)
    ns = torch.empty(state.shape[1], dtype=torch.int32)
    n_sub = (params.numel() - 3) // 4
    fn(state.data_ptr(), out.data_ptr(), ns.data_ptr(), params.data_ptr(),
       state.shape[1], n_sub, steps)
    return out, ns


def _rays(dtype):
    obs = torch.tensor([30.0, 0.0, 0.0], dtype=dtype)
    q0, p0, *_ = camera_rays(obs, np.radians(80.0), SIZE, SIZE, dtype=dtype)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def _bits(t):
    """A float tensor's bit pattern, so that equality is bitwise (NaN and
    -0.0 included)."""
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g) if g.is_floating_point() else g,
                           _bits(w) if w.is_floating_point() else w)


def _parked(state_out, rs):
    return int((state_out[1] == rs).sum())


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("kernel", ["B1", "B2", "B4"])
def test_kernel_source_bitwise_equal_to_twin(host_kernels, kernel, order):
    """B1 vs integrate_batch_compensated, B2 vs integrate_batch_eq (after
    the wrappers' read-out: final q, final p, status, steps), B4 vs
    checkpoint._advance_eqc over two chunks of an opened carry (all 24
    rows and the steps applied)."""
    fn = host_kernels[kernel]
    dtype = torch.float64 if kernel == "B2" else torch.float32
    q0, p0 = _rays(dtype)
    args = (STEPS, DELTA, RS, R_MAX, OMEGA)
    params = ti.substep_params(DELTA, RS, R_MAX, OMEGA, order, dtype,
                               compensated=kernel != "B2")
    rs = float(params[0])
    if kernel == "B1":
        state, ns = _launch(fn, torch.stack(pack_state_eqc(q0, p0)), params,
                            STEPS)
        _assert_bitwise(
            (*ti.finish_compensated(tuple(state), q0, p0, rs,
                                    float(params[1])), ns),
            ti.integrate_batch_compensated(q0, p0, *args, order=order))
    elif kernel == "B2":
        state, ns = _launch(fn, torch.stack(pack_state_eq(q0, p0)), params,
                            STEPS)
        _assert_bitwise(
            (*ti.finish_eq(tuple(state), q0, p0, rs, float(params[1])), ns),
            ti.integrate_batch_eq(q0, p0, *args, order=order))
    else:
        # two chunks, the first cut short by its budget: the job's resume
        opened = ck.start(q0, p0, *args, order=order, compensated=True,
                          device="cpu")
        state = opened.state
        for chunk in (CHUNK, STEPS - CHUNK):
            want = ck._advance_eqc(state, chunk, DELTA, RS, R_MAX, OMEGA,
                                   order=order)
            state, ns = _launch(fn, state, params, chunk)
            _assert_bitwise((state, ns), want)
            if chunk == CHUNK:  # some rays still run at the budget's end
                assert 0 < int((ns == CHUNK).sum()) < ns.numel()
    # rays parked by the guard, restored from the pre-step copy
    assert _parked(state, rs) > 0
