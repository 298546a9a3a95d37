// Trajectory recorder S1: the 16-row Schwarzschild FANTASY integrator on the
// unfused flows, masked and guarded, recording q1 every `stride` steps; one
// CUDA thread per ray, instantiated for float and double.
//
// A port-side kernel: it replaces no TPU kernel.  The JAX package samples
// trajectories in an XLA fori_loop (grtrace/engine/integrate.py::
// integrate_batch_full), not in Pallas.  Its eager twin, which defines what
// this kernel computes, is grtrace_torch/engine/integrate.py::
// integrate_batch_full, built on hamiltonian.py::fantasy_step with
// fantasy_step_ord2 (the unfused flows _flow_a, _flow_b, _flow_mixed and
// the metric of physics/metric.py).  The render's trajectory sampler, the
// single-ray driver and the band sweep call it through
// integrate.py::integrate_full_dispatch.
//
// Per ray, at step k = 0, 1, ... < steps: the ray is active while
// 1.1 rs < r < r_max; if k % stride == 0 its q1 goes to slot k / stride
// (the step on which the ray is first found inactive included); an
// inactive ray stops; otherwise the step runs, and the horizon guard
// reverts a step whose radius jumps by more than `cap` (or turns
// non-finite) and parks the ray at r = rs.  The host zeroes the output, so
// the slots after a ray's exit stay +0.0.
//
// What bounds it on an H100: latency.  The sampler runs tens of rays (20
// in the CLI's render, 50 in the band sweep, 1 in the single-ray driver),
// one warp or two, so the card's throughput is idle and each ray is one
// dependent chain of about 300 floating-point operations a step (eight
// IEEE divisions among them, and sin and cos of each flow's theta) for as
// many steps as the longest ray takes.  The record is the only memory
// traffic: at most n_keep 16- or 32-byte stores a ray.
//
// What the design does about it: nothing beyond keeping the chain short.
// The 16-row state and the guard's copy live in registers, each flow
// evaluates sin and cos of its theta once (the twin's metric functions
// evaluate the same sin three times, the same value), and the slot index
// advances by a counter, with no division in the loop.  A simple kernel
// first: making it fast is later work.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation below rounds once, in the order written, exactly as the twin's
// torch ops do.  The association follows metric.py and hamiltonian.py term
// by term.  A Python scalar divided by a tensor is torch's reciprocal times
// the scalar (Tensor.__rtruediv__), so rs / x is written (1 / x) * rs and
// -2.0 / x is (1 / x) * -2; a tensor divided by a tensor is one IEEE
// division.  Literals are of the ray type T.  sin and cos are the card's
// sinf/cosf (sin/cos for double), which chip_smoke.py's phase 21a holds
// against torch.sin and torch.cos on the card.
//
// Layout: q0 and p0 are (n, 4) in T, row-major; traj is (n, n_keep, 4) in
// T, row-major and zeroed by the host; ns_out (n,) int32 counts the steps
// each ray took.  params is the vector [rs, r_max, cap, (d, cos, sin) x
// n_sub] in T (cos / sin of the mixing angle 2 omega d) built on the host
// by engine/integrate.py::substep_params(compensated=False,
// staggered=False), the vector the twin reads.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstddef>

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 32;

__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// One unfused flow (_flow_a with Q = 0, P_READ = 12, P_KICK = 4,
// Q_DRIFT = 8; _flow_b with Q = 8, P_READ = 4, P_KICK = 12, Q_DRIFT = 0):
// the metric and its derivatives at the position copy Q, contracted with
// the momenta P_READ, kick the momenta P_KICK and drift the position
// Q_DRIFT by dt.
template <int Q, int P_READ, int P_KICK, int Q_DRIFT, typename T>
__device__ __forceinline__ void flow(T (&s)[kRows], T dt, T rs) {
  const T r = s[Q + 1];
  const T sin_th = sin_t(s[Q + 2]);
  const T cos_th = cos_t(s[Q + 2]);
  const T pt = s[P_READ + 0];
  const T pr = s[P_READ + 1];
  const T pth = s[P_READ + 2];
  const T pph = s[P_READ + 3];

  // metric.py::dcontravariant_dr
  const T denom = r - rs;
  const T d_tt = (T(1) / (denom * denom)) * rs;
  const T rr = r * r;
  const T d_rr = (T(1) / rr) * rs;
  const T r3 = rr * r;
  const T d_thth = (T(1) / r3) * T(-2);
  const T d_phph = (T(1) / ((r3 * sin_th) * sin_th)) * T(-2);
  const T dH_r = T(0.5) * ((((d_tt * pt) * pt + (d_rr * pr) * pr)
                            + (d_thth * pth) * pth) + (d_phph * pph) * pph);
  // metric.py::dcontravariant_dth
  const T d_th = (T(-2) * cos_th) / (((rr * sin_th) * sin_th) * sin_th);
  const T dH_th = ((T(0.5) * d_th) * pph) * pph;

  s[P_KICK + 1] = s[P_KICK + 1] - dt * dH_r;
  s[P_KICK + 2] = s[P_KICK + 2] - dt * dH_th;

  // metric.py::contravariant_diag
  const T inv_fac = T(1) - (T(1) / r) * rs;
  const T g_tt = (T(1) / inv_fac) * T(-1);
  const T g_thth = T(1) / rr;
  const T r_sin = r * sin_th;
  const T g_phph = T(1) / (r_sin * r_sin);

  s[Q_DRIFT + 0] = s[Q_DRIFT + 0] + (dt * g_tt) * pt;
  s[Q_DRIFT + 1] = s[Q_DRIFT + 1] + (dt * inv_fac) * pr;
  s[Q_DRIFT + 2] = s[Q_DRIFT + 2] + (dt * g_thth) * pth;
  s[Q_DRIFT + 3] = s[Q_DRIFT + 3] + (dt * g_phph) * pph;
}

// _flow_mixed: the rotation between the copies, cos/sin form
template <typename T>
__device__ __forceinline__ void flow_mixed(T (&s)[kRows], T cw, T sw) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T q1 = s[a], p1 = s[4 + a], q2 = s[8 + a], p2 = s[12 + a];
    const T q_sum = q1 + q2;
    const T q_dif = q1 - q2;
    const T p_sum = p1 + p2;
    const T p_dif = p1 - p2;
    s[a] = T(0.5) * ((q_sum + q_dif * cw) + p_dif * sw);
    s[4 + a] = T(0.5) * ((p_sum + p_dif * cw) - q_dif * sw);
    s[8 + a] = T(0.5) * ((q_sum - q_dif * cw) - p_dif * sw);
    s[12 + a] = T(0.5) * ((p_sum - p_dif * cw) + q_dif * sw);
  }
}

// fantasy_step_ord2: A(d/2) B(d/2) M(d) B(d/2) A(d/2)
template <typename T>
__device__ __forceinline__ void step_ord2(T (&s)[kRows], T d, T rs, T cw,
                                          T sw) {
  const T half = T(0.5) * d;
  flow<0, 12, 4, 8>(s, half, rs);
  flow<8, 4, 12, 0>(s, half, rs);
  flow_mixed(s, cw, sw);
  flow<8, 4, 12, 0>(s, half, rs);
  flow<0, 12, 4, 8>(s, half, rs);
}

template <typename T>
__device__ __forceinline__ bool active(T r, T r_capture, T r_max) {
  return (r > r_capture) && (r < r_max);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fantasy_traj_kernel(const T* __restrict__ q0, const T* __restrict__ p0,
                    T* __restrict__ traj, int* __restrict__ ns_out,
                    const T* __restrict__ params, int n, int n_sub,
                    int steps, int stride, int n_keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T s[kRows];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    s[a] = q0[4 * static_cast<size_t>(i) + a];
    s[4 + a] = p0[4 * static_cast<size_t>(i) + a];
    s[8 + a] = s[a];
    s[12 + a] = s[4 + a];
  }

  const T rs = __ldg(params + 0);
  const T r_max = __ldg(params + 1);
  const T cap = __ldg(params + 2);
  const T r_capture = T(1.1) * rs;

  T* row = traj + static_cast<size_t>(i) * static_cast<size_t>(n_keep) * 4;
  int next_store = 0;  // the next step whose q1 is recorded
  int ns = 0;
  for (int k = 0; k < steps; ++k) {
    if (k == next_store) {
#pragma unroll
      for (int a = 0; a < 4; ++a) row[a] = s[a];
      row += 4;
      next_store += stride;
    }
    if (!active(s[1], r_capture, r_max)) break;
    T old[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) old[m] = s[m];
    for (int j = 0; j < n_sub; ++j) {
      const T* sub = params + 3 + 3 * j;
      step_ord2(s, __ldg(sub + 0), rs, __ldg(sub + 1), __ldg(sub + 2));
    }
    // blow-up guard on rows 1 and 9; the negated <= also catches NaN, Inf
    if (!(abs_t(s[1] - old[1]) <= cap)) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) s[m] = old[m];
      s[1] = rs;  // q1_r
      s[9] = rs;  // q2_r
    }
    ++ns;
  }
  ns_out[i] = ns;
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <typename T>
int launch(const T* q0, const T* p0, T* traj, int* ns_out, const T* params,
           int n, int n_sub, int steps, int stride, int n_keep,
           void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_traj_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          q0, p0, traj, ns_out, params, n, n_sub, steps, stride, n_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grt_fantasy_traj_f32_launch(const float* q0, const float* p0,
                                           float* traj, int* ns_out,
                                           const float* params, int n,
                                           int n_sub, int steps, int stride,
                                           int n_keep, void* stream) {
  return launch<float>(q0, p0, traj, ns_out, params, n, n_sub, steps, stride,
                       n_keep, stream);
}

extern "C" int grt_fantasy_traj_f64_launch(const double* q0, const double* p0,
                                           double* traj, int* ns_out,
                                           const double* params, int n,
                                           int n_sub, int steps, int stride,
                                           int n_keep, void* stream) {
  return launch<double>(q0, p0, traj, ns_out, params, n, n_sub, steps,
                        stride, n_keep, stream);
}
#endif  // __CUDACC__
