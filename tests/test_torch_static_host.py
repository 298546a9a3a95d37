"""The static chart of kernels G1s, S2s, T2s and the disk mode D1
(`Chart::kStatic` and `Mode::kDisk` of grtrace_torch/csrc/fantasy_gen.cu)
built for the CPU with g++ and held bit for bit against their eager twins
in float64 (`integrate_generic_twin`, `trajectory_generic_twin`,
`trajectory_generic_unmasked`, `disk_static.integrate_disk_static_twin`).

The shim is the one of test_torch_gen_host.py with the new entries: CUDA's
keywords stand in, the kernel runs one thread at a time, -ffp-contract=off
keeps g++ from contracting a multiply-add (nvcc's -fmad=false), and the
source's sincos and sqrt go to torch's sin, cos and sqrt of a one-element
tensor, the functions the twins call.  The float32 kernels and the card's
own rounding are held on the card (chip_smoke.py phases 48-50).
"""
import ctypes
import math
import shutil
import subprocess

import pytest
import torch

from grtrace_torch.engine import disk_static as tds
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics.camera import camera_rays_folded_static
from grtrace_torch.physics.spacetime import METRICS

from test_torch_gen_host import CSRC, _SINCOS, _SQRT, _bits, \
    _torch_sincos, _torch_sqrt

torch.set_num_threads(1)

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

template <Mode M>
static void run(const double* q0, const double* p0, double* out, int* ns,
                const double* params, int n, int n_sub, int steps,
                int stride, int n_keep, const double* disk, int* hit) {
  const unsigned threads = threads_of(M);
  blockDim.x = threads;
  for (unsigned b = 0; b * threads < unsigned(n); ++b) {
    blockIdx.x = b;
    for (unsigned t = 0; t < threads; ++t) {
      threadIdx.x = t;
      fantasy_gen_kernel<double, Chart::kStatic, M>(
          q0, p0, out, ns, params, n, n_sub, steps, stride, n_keep, disk,
          hit);
    }
  }
}

#define ENTRY(NAME, M)                                                      \
  extern "C" void NAME(const double* q0, const double* p0, double* out,    \
                       int* ns, const double* params, int n, int n_sub,    \
                       int steps, int stride, int n_keep,                  \
                       const double* disk, int* hit) {                     \
    run<M>(q0, p0, out, ns, params, n, n_sub, steps, stride, n_keep, disk, \
           hit);                                                           \
  }
ENTRY(host_g1s, Mode::kIntegrate)
ENTRY(host_s2s, Mode::kRecord)
ENTRY(host_t2s, Mode::kTrace)
ENTRY(host_d1, Mode::kDisk)
"""

# (family, parameter): sub-critical Bardeen, Kottler, sub-critical Hayward,
# and super-critical (horizonless) Bardeen
CASES = [("Bardeen", 0.5), ("Kottler", 1e-3), ("Hayward", 0.6),
         ("Bardeen", 0.9)]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """fantasy_gen.cu's static chart built for the CPU: {'g1s', 's2s',
    't2s', 'd1'} -> entry (float64)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the host emulation")
    d = tmp_path_factory.mktemp("static_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libstatic_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {"math": (_SINCOS(_torch_sincos), _SQRT(_torch_sqrt))}
    so.set_math(*out["math"])
    for name in ("g1s", "s2s", "t2s", "d1"):
        fn = getattr(so, f"host_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        fn.restype = None
        out[name] = fn
    return out


def _rays(metric, param, idx, obs=15.0, fov_deg=60.0):
    """Rays `idx` of the folded 8x8 camera at r0 = obs, float64, and their
    fold angles."""
    q0, p0, _, beta = camera_rays_folded_static(
        torch.tensor([obs, 0.0, 0.0], dtype=torch.float64),
        torch.tensor(math.radians(fov_deg), dtype=torch.float64), 8, 8,
        params=(1.0, param, 0.0), g_inv_fn=METRICS[metric],
        dtype=torch.float64)
    return (q0.reshape(-1, 4)[idx].contiguous(),
            p0.reshape(-1, 4)[idx].contiguous(), beta.reshape(-1)[idx])


def _n_sub(vec):
    return (vec.numel() - tig.N_SCAL) // 3


@pytest.mark.parametrize("metric,param", CASES)
def test_g1s_source_bitwise_equal_to_twin(host, metric, param):
    """G1s against `integrate_generic_twin(metric=...)` on four rays of
    the folded 8x8 camera at r0 = 15 (fov 60 deg, boundary 16, delta
    0.05, 1200 steps, order 2): q1, p1, q2 and the signed step counts bit
    for bit, p_theta and theta included (they leave 0 and pi/2 by
    rounding); the middle rays fall in (or, horizonless, cross the core),
    the corner rays escape."""
    q0, p0, _ = _rays(metric, param, [0, 27, 28, 63])
    steps = 1200
    vec = tig.gen_params(metric, 0.05, (1.0, param), 16.0, 1.0, 2,
                         torch.float64)
    out = torch.zeros((12, 4), dtype=torch.float64)
    ns = torch.zeros(4, dtype=torch.int32)
    host["g1s"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(), ns.data_ptr(),
                vec.data_ptr(), 4, _n_sub(vec), steps, 1, 0, None, None)
    # the twin's rays are independent (masked elementwise steps), so one
    # batched call gives each ray's values
    state, ns_t = tig.integrate_generic_twin(q0, p0, steps, vec, metric)
    assert torch.equal(ns_t, ns)
    assert torch.equal(_bits(out), _bits(torch.stack(state[:12])))
    # the corner rays escape within the budget
    assert out[1, 0] >= 16.0 and out[1, 3] >= 16.0
    assert bool((out[6] != 0).any())  # p_theta left 0


def test_s2s_t2s_order4_source_bitwise_equal_to_twins(host):
    """S2s (q1 every 8th step, 400 steps, n_keep 50) and T2s (every step's
    (q1, p1), 200 steps) at order 4 in each family against
    `trajectory_generic_twin` and `trajectory_generic_unmasked`: every slot
    and every row bit for bit, the zero slots past an exit included."""
    for metric, param in CASES[:3]:
        q0, p0, _ = _rays(metric, param, [9, 28])
        vec = tig.gen_params(metric, 0.1, (1.0, param), 16.0, 1.0, 4,
                             torch.float64)
        steps, (stride, n_keep) = 400, ti.traj_layout(400, 50)
        traj = torch.zeros((2, n_keep, 4), dtype=torch.float64)
        ns = torch.zeros(2, dtype=torch.int32)
        host["s2s"](q0.data_ptr(), p0.data_ptr(), traj.data_ptr(),
                    ns.data_ptr(), vec.data_ptr(), 2, _n_sub(vec), steps,
                    stride, n_keep, None, None)
        want, ns_t = tig.trajectory_generic_twin(q0, p0, steps, vec, metric,
                                                 stride, n_keep)
        assert torch.equal(ns_t, ns)
        assert torch.equal(_bits(traj), _bits(want))
        got = torch.full((2, 200, 8), 7.0, dtype=torch.float64)
        host["t2s"](q0.data_ptr(), p0.data_ptr(), got.data_ptr(), None,
                    vec.data_ptr(), 2, _n_sub(vec), 200, 1, 0, None, None)
        want = tig.trajectory_generic_unmasked(q0, p0, 200, vec, metric)
        fin = torch.isfinite(want).all(-1)
        assert torch.equal(torch.isfinite(got).all(-1), fin)
        assert torch.equal(_bits(got[fin]), _bits(want[fin]))


@pytest.mark.parametrize("metric,param,elev", [("Bardeen", 0.5, 20.0),
                                                ("Kottler", 1e-3, 60.0)])
def test_d1_source_bitwise_equal_to_twin(host, metric, param, elev):
    """D1 against `integrate_disk_static_twin` on every ray of the folded
    8x8 camera at r0 = 15 (disk [4, 12], elevation `elev`, 1500 steps,
    delta 0.05): q1, p1, the hit rows (zero where no hit), the hit flags
    and the signed step counts bit for bit, with hits, escapes and
    captures among them."""
    q0, p0, beta = _rays(metric, param, list(range(64)))
    el = torch.tensor(math.radians(elev), dtype=torch.float64)
    disk = torch.stack([torch.sin(el).expand(64),
                        torch.sin(beta) * torch.cos(el)], -1).contiguous()
    vec = tig.gen_params(metric, 0.05, (1.0, param), 16.0, 1.0, 2,
                         torch.float64)
    dvec = tds.disk_params(vec, 4.0, 12.0)
    steps = 1500
    out = torch.full((16, 64), 7.0, dtype=torch.float64)
    ns = torch.zeros(64, dtype=torch.int32)
    hit = torch.zeros(64, dtype=torch.int32)
    host["d1"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(), ns.data_ptr(),
               dvec.data_ptr(), 64, _n_sub(vec), steps, 1, 0,
               disk.data_ptr(), hit.data_ptr())
    state, ns_t, hit_t, hq, hp = tds.integrate_disk_static_twin(
        q0, p0, disk, steps, vec, metric, 4.0, 12.0)
    assert torch.equal(ns, ns_t)
    assert torch.equal(hit.bool(), hit_t)
    assert torch.equal(_bits(out[:8].T), _bits(torch.stack(state[:8], -1)))
    assert torch.equal(_bits(out[8:12].T), _bits(hq))
    assert torch.equal(_bits(out[12:16].T), _bits(hp))
    assert not bool(out[8:, ~hit.bool()].any())  # zeros where no hit
    assert 0 < int(hit.sum()) < 64
    assert bool((ns < 0).any()) or metric == "Kottler"
