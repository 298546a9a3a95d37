"""Kernels G1 and S2's source (grtrace_torch/csrc/fantasy_gen.cu) built for
the CPU with g++ and held bit for bit against their eager twins
(`integrate_generic_twin`, `trajectory_generic_twin`).

The source compiles on the CPU as it stands (its CUDA include and launch
functions sit under __CUDACC__); a shim stands in for CUDA's keywords and
runs the kernel one thread at a time, with -ffp-contract=off so that g++
contracts no multiply-add, as nvcc's -fmad=false.  The twins run one ray
at a time in float64, and the shim routes the kernel's sincos and sqrt to
torch's sin, cos and sqrt of a one-element tensor: torch's CPU functions
are not the C library's (they differ by an ulp at a few points in a
thousand), so this way both sides use one set of them, as on the card the
twins and the kernels use the card's correctly rounded sqrt and the sin
and cos that chip_smoke.py's phase 21a holds equal.  The float32 kernels
and the card's own rounding are held on the card (chip_smoke.py phases
34, 35 and 37).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics.camera import (camera_rays_cartesian,
                                          camera_rays_unfolded)
from grtrace_torch.physics.spacetime import kerr_g_inv, kerr_schild_g_inv

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grtrace_torch", "csrc")
PARAMS = (1.0, 0.9, 0.3)

SHIM = r"""
#include <cmath>
using std::isfinite;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx;
template <typename T> static inline T __ldg(const T* p) { return *p; }

// the transcendental functions of the twins' one-element tensors
static void (*host_sincos)(double, double*, double*) = nullptr;
static double (*host_sqrt)(double) = nullptr;
extern "C" void set_math(void (*sc)(double, double*, double*),
                         double (*sq)(double)) {
  host_sincos = sc;
  host_sqrt = sq;
}
#define sincos(x, s, c) host_sincos(x, s, c)
#define sqrt(x) host_sqrt(x)
#include "fantasy_gen.cu"
#undef sincos
#undef sqrt

template <Chart C, Mode M>
static void run(const double* q0, const double* p0, double* out, int* ns,
                const double* params, int n, int n_sub, int steps,
                int stride, int n_keep) {
  const unsigned threads = threads_of(M);
  blockDim.x = threads;
  for (unsigned b = 0; b * threads < unsigned(n); ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      threadIdx.x = t;
      fantasy_gen_kernel<double, C, M>(q0, p0, out, ns, params, n, n_sub,
                                       steps, stride, n_keep);
    }
  }
}

#define ENTRY(NAME, C, M)                                                   \
  extern "C" void NAME(const double* q0, const double* p0, double* out,    \
                       int* ns, const double* params, int n, int n_sub,    \
                       int steps, int stride, int n_keep) {                \
    run<C, M>(q0, p0, out, ns, params, n, n_sub, steps, stride, n_keep);   \
  }
ENTRY(host_g1, Chart::kBL, Mode::kIntegrate)
ENTRY(host_s2_bl, Chart::kBL, Mode::kRecord)
ENTRY(host_s2_ks, Chart::kKS, Mode::kRecord)
ENTRY(host_t2, Chart::kBL, Mode::kTrace)
"""


_SINCOS = ctypes.CFUNCTYPE(None, ctypes.c_double,
                           ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_double))
_SQRT = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_double)


def _torch_sincos(x, s, c):
    t = torch.tensor([x], dtype=torch.float64)
    s[0], c[0] = float(torch.sin(t)), float(torch.cos(t))


def _torch_sqrt(x):
    return float(torch.sqrt(torch.tensor([x], dtype=torch.float64)))


@pytest.fixture(scope="module")
def host_gen(tmp_path_factory):
    """fantasy_gen.cu built for the CPU: {'g1', 's2_bl', 's2_ks', 't2'} ->
    entry (float64)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the host emulation")
    d = tmp_path_factory.mktemp("gen_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libgen_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {"math": (_SINCOS(_torch_sincos), _SQRT(_torch_sqrt))}
    so.set_math(*out["math"])
    for name in ("g1", "s2_bl", "s2_ks", "t2"):
        fn = getattr(so, f"host_{name}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        fn.restype = None
        out[name] = fn
    return out


def _rays(metric, obs, fov_deg, idx):
    """Rays `idx` of the chart's 8x8 camera at r0 = obs, float64."""
    camera = (camera_rays_cartesian if metric == "KerrSchild"
              else camera_rays_unfolded)
    q0, p0, _ = camera(
        torch.tensor([obs, 0.0, 0.0], dtype=torch.float64),
        torch.tensor(np.radians(fov_deg), dtype=torch.float64), 8, 8,
        params=PARAMS, g_inv_fn=kerr_schild_g_inv if metric == "KerrSchild"
        else kerr_g_inv, dtype=torch.float64)
    return (q0.reshape(-1, 4)[idx].contiguous(),
            p0.reshape(-1, 4)[idx].contiguous())


def _bits(t):
    return t.contiguous().view(torch.int64)


def test_g1_source_bitwise_equal_to_twin(host_gen):
    """G1 against `integrate_generic_twin` on rays of the 8x8 unfolded
    camera at r0 = 12 (fov 90 deg, boundary 13, delta 0.1): q1, p1, q2 and
    the signed step count bit for bit, on escaping rays and on captures
    that the guard parks (negative counts, reverted state)."""
    q0, p0 = _rays("Kerr", 12.0, 90.0, [0, 27, 28, 45])
    steps = 600
    vec = tig.gen_params("Kerr", 0.1, PARAMS, 13.0, 1.0, 2, torch.float64)
    out = torch.zeros((12, 4), dtype=torch.float64)
    ns = torch.zeros(4, dtype=torch.int32)
    host_gen["g1"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(),
                   ns.data_ptr(), vec.data_ptr(), 4,
                   (vec.numel() - tig.N_SCAL) // 3, steps, 1, 0)
    for k in range(4):
        state, ns_t = tig.integrate_generic_twin(q0[k:k + 1], p0[k:k + 1],
                                                 steps, vec)
        assert int(ns_t) == int(ns[k])
        assert torch.equal(_bits(out[:, k]), _bits(torch.cat(state[:12])))
    assert int((ns < 0).sum()) == 2  # two captures parked by the guard


def test_bl_order4_source_bitwise_equal_to_twin(host_gen):
    """G1 and S2 in the Boyer-Lindquist chart at order 4 with charge (three
    substeps a step, so flow A's kick/drift is carried across substeps as
    well as across steps) against their twins on the rays above, 200 steps
    (S2 every 4th): q1, p1, q2, the signed step counts and every slot bit
    for bit, a guard-parked capture among them."""
    q0, p0 = _rays("Kerr", 12.0, 90.0, [0, 27, 28, 45])
    steps, (stride, n_keep) = 200, ti.traj_layout(200, 50)
    vec = tig.gen_params("Kerr", 0.1, PARAMS, 13.0, 1.0, 4, torch.float64)
    n_sub = (vec.numel() - tig.N_SCAL) // 3
    assert n_sub == 3
    out = torch.zeros((12, 4), dtype=torch.float64)
    ns = torch.zeros(4, dtype=torch.int32)
    host_gen["g1"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(),
                   ns.data_ptr(), vec.data_ptr(), 4, n_sub, steps, 1, 0)
    traj = torch.zeros((4, n_keep, 4), dtype=torch.float64)
    ns_traj = torch.zeros(4, dtype=torch.int32)
    host_gen["s2_bl"](q0.data_ptr(), p0.data_ptr(), traj.data_ptr(),
                      ns_traj.data_ptr(), vec.data_ptr(), 4, n_sub, steps,
                      stride, n_keep)
    for k in range(4):
        state, ns_t = tig.integrate_generic_twin(q0[k:k + 1], p0[k:k + 1],
                                                 steps, vec)
        assert int(ns_t) == int(ns[k])
        assert torch.equal(_bits(out[:, k]), _bits(torch.cat(state[:12])))
        want, ns_t = tig.trajectory_generic_twin(
            q0[k:k + 1], p0[k:k + 1], steps, vec, "Kerr", stride, n_keep)
        assert int(ns_t) == int(ns_traj[k])
        assert torch.equal(_bits(traj[k]), _bits(want[0]))
    assert int((ns < 0).sum()) == 2 and int(ns_traj.max()) == steps


@pytest.mark.parametrize("metric", ["Kerr", "KerrSchild"])
def test_s2_source_matches_twin(host_gen, metric):
    """S2 against `trajectory_generic_twin` on two rays of the chart's 8x8
    camera at r0 = 30, 400 steps, delta 0.1, n_keep 50 (stride 8): one
    still inside the domain when the budget ends, one that exits before;
    the step counts and the zero slots equal, +0.0 past the exit, every
    slot bit for bit (the Kerr-Schild flows' square roots are torch's, as
    the twin's, through the shim)."""
    q0, p0 = _rays(metric, 30.0, 80.0, [9, 28])
    steps, (stride, n_keep) = 400, ti.traj_layout(400, 50)
    vec = tig.gen_params(metric, 0.1, PARAMS, 31.0, 1.0, 2, torch.float64)
    traj = torch.zeros((2, n_keep, 4), dtype=torch.float64)
    ns = torch.zeros(2, dtype=torch.int32)
    entry = host_gen["s2_bl" if metric == "Kerr" else "s2_ks"]
    entry(q0.data_ptr(), p0.data_ptr(), traj.data_ptr(),
          ns.data_ptr(), vec.data_ptr(), 2, (vec.numel() - tig.N_SCAL) // 3,
          steps, stride, n_keep)
    for k in range(2):
        want, ns_t = tig.trajectory_generic_twin(
            q0[k:k + 1], p0[k:k + 1], steps, vec, metric, stride, n_keep)
        assert int(ns_t) == int(ns[k])
        assert torch.equal(traj[k] == 0, want[0] == 0)
        assert torch.equal(_bits(traj[k]), _bits(want[0]))
    assert int(ns[0]) == steps and int(ns[1]) < steps
    assert not torch.signbit(traj[(traj == 0)]).any()


def test_t2_source_bitwise_equal_to_twin(host_gen):
    """T2 (the Boyer-Lindquist trace mode) against its twin
    `trajectory_generic_unmasked` on rays of the 8x8 unfolded camera at r0
    = 12 (those of the G1 test: two escape, two fall in), 200 steps, delta
    0.1, order 2 (T2 runs G1's `composed`, which the order-4 test above
    holds across substeps): every step's (q1, p1) bit for bit up to each
    ray's first non-finite value (if any), whose step agrees.  Nothing
    stops a ray: the captures run into the horizon, the escapes run on
    past the boundary."""
    q0, p0 = _rays("Kerr", 12.0, 90.0, [0, 27, 28, 45])
    steps = 200
    for order in (2,):
        vec = tig.gen_params("Kerr", 0.1, PARAMS, 13.0, 1.0, order,
                             torch.float64)
        got = torch.full((4, steps, 8), 7.0, dtype=torch.float64)
        host_gen["t2"](q0.data_ptr(), p0.data_ptr(), got.data_ptr(), None,
                       vec.data_ptr(), 4, (vec.numel() - tig.N_SCAL) // 3,
                       steps, 1, 0)
        firsts = []
        for k in range(4):
            want = tig.trajectory_generic_unmasked(q0[k:k + 1], p0[k:k + 1],
                                                   steps, vec)[0]
            bad_w = ~torch.isfinite(want).all(-1)
            bad_g = ~torch.isfinite(got[k]).all(-1)
            n = int(bad_w.int().argmax()) if bool(bad_w.any()) else steps
            assert (int(bad_g.int().argmax()) if bool(bad_g.any())
                    else steps) == n
            assert torch.equal(_bits(got[k, :n]), _bits(want[:n])), k
            firsts.append(n)
        r_plus = float(tig.horizon_radius("Kerr", *PARAMS))
        inside = (got[..., 1].nan_to_num(0.0) < r_plus).any(-1)
        assert bool(inside.any()) and not bool(inside.all())
