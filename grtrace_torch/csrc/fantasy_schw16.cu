// Generic (any-plane) Schwarzschild FANTASY integrator on the fused flows:
// one CUDA thread per ray, instantiated for float and double.
//
// Replaces the TPU kernel grtrace/engine/integrate_pallas.py::_make_kernel
// in its n_rows=16 configuration (kernel B3: plain, not staggered, the
// step fantasy_step_ord2_fused; entry points integrate_batch_pallas(
// equatorial=False), SchwarzschildIntegrator(backend='pallas') and the
// checkpoint chunk advance_state_pallas).  One C entry serves the
// monolithic call and the chunk: the kernel advances a (16, n) state by at
// most `steps` masked steps and counts the steps each ray took.  Its eager
// twins, which define what this kernel computes, are
// grtrace_torch/engine/integrate.py::integrate_batch_fused (and its loop
// fused_cores, which the chunk twin checkpoint.py::_advance_fused runs),
// built on hamiltonian.py::fantasy_step_ord2_fused.
//
// What bounds it on an H100: FP32 (or FP64) instruction throughput and
// latency.  Each ray is a serial chain of about 280 floating-point
// operations per step, with 12 IEEE divisions and four sin/cos pairs (every
// flow evaluates the metric at its copy's theta), for up to the step
// budget; near-critical rays orbit longest.  No memory traffic inside the
// loop.
//
// What the design does about it: the 16-row state and the guard's copy of
// it live in registers; a finished ray breaks out of its loop (the
// per-thread form of the TPU kernel's masked steps and per-tile early
// exit); the monolithic wrapper sorts rays by |b - b_crit| so a warp's rays
// retire together (the chunk keeps the caller's order).  Making it fast is
// later work.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation below rounds once, in the order written, exactly as the twin's
// torch ops do; the association follows hamiltonian.py's fused flows term
// by term, literals are of the ray type T, and `1 / x` is an IEEE division
// (torch's reciprocal).  sin and cos are the card's sinf/cosf (sin/cos for
// double), each called on its own as torch.sin and torch.cos are;
// fantasy_trig_kernel evaluates exactly these two calls on given points so
// that a caller can hold them against torch's.
//
// Layout: state_in/state_out are SoA (16, n) in T, each row contiguous:
// q1 (t, r, theta, phi), p1, q2, p2.  params is the vector [rs, r_max, cap,
// (d, cos, sin) x n_sub] in T (cos/sin of the mixing angle 2 omega d) built
// on the host by engine/integrate.py::substep_params(compensated=False,
// staggered=False).  ns_out (n,) int32 counts the steps each ray took.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;

__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// The fused flow A (metric at q1, kick p1 r/theta, drift q2) or B (metric
// at q2, kick p2, drift q1): Q = base row of the copy whose metric is read
// (0 or 8), P_READ = the other copy's momenta (12 or 4), P_KICK = the
// momenta kicked (4 or 12), Q_DRIFT = the position drifted (8 or 0).
template <int Q, int P_READ, int P_KICK, int Q_DRIFT, typename T>
__device__ __forceinline__ void flow(T (&s)[kRows], T dt, T rs) {
  const T r = s[Q + 1];
  const T inv_r = T(1) / r;
  const T inv_r2 = inv_r * inv_r;
  const T inv_r3 = inv_r2 * inv_r;
  const T inv_rms = T(1) / (r - rs);
  const T sin_th = sin_t(s[Q + 2]);
  const T cos_th = cos_t(s[Q + 2]);
  const T inv_sin = T(1) / sin_th;
  const T inv_sin2 = inv_sin * inv_sin;

  const T pt = s[P_READ + 0];
  const T pr = s[P_READ + 1];
  const T pth = s[P_READ + 2];
  const T pph = s[P_READ + 3];
  const T pt2 = pt * pt;
  const T pr2 = pr * pr;
  const T pth2 = pth * pth;
  const T pph2_s = pph * pph * inv_sin2;

  const T dH_r = (T(0.5) * rs) * (inv_rms * inv_rms * pt2 + inv_r2 * pr2)
                 - inv_r3 * (pth2 + pph2_s);
  const T dH_th = -cos_th * inv_sin * inv_r2 * pph2_s;

  s[P_KICK + 1] = s[P_KICK + 1] + (-dt) * dH_r;
  s[P_KICK + 2] = s[P_KICK + 2] + (-dt) * dH_th;

  s[Q_DRIFT + 0] = s[Q_DRIFT + 0] + (-((dt * r) * inv_rms)) * pt;
  s[Q_DRIFT + 1] = s[Q_DRIFT + 1] + (dt * (T(1) - rs * inv_r)) * pr;
  s[Q_DRIFT + 2] = s[Q_DRIFT + 2] + (dt * inv_r2) * pth;
  s[Q_DRIFT + 3] = s[Q_DRIFT + 3] + ((dt * inv_r2) * inv_sin2) * pph;
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
    s[a] = T(0.5) * (q_sum + q_dif * cw + p_dif * sw);
    s[4 + a] = T(0.5) * (p_sum + p_dif * cw - q_dif * sw);
    s[8 + a] = T(0.5) * (q_sum - q_dif * cw - p_dif * sw);
    s[12 + a] = T(0.5) * (p_sum - p_dif * cw + q_dif * sw);
  }
}

// fantasy_step_ord2_fused: A(d/2) B(d/2) M(d) B(d/2) A(d/2)
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
__global__ void __launch_bounds__(128)
fantasy_schw16_kernel(const T* __restrict__ state_in,
                      T* __restrict__ state_out, int* __restrict__ ns_out,
                      const T* __restrict__ params, int n, int n_sub,
                      int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T s[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) s[k] = state_in[k * n + i];

  const T rs = __ldg(params + 0);
  const T r_max = __ldg(params + 1);
  const T cap = __ldg(params + 2);
  const T r_capture = T(1.1) * rs;

  int ns = 0;
  for (int k = 0; k < steps; ++k) {
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

#pragma unroll
  for (int k = 0; k < kRows; ++k) state_out[k * n + i] = s[k];
  ns_out[i] = ns;
}

// sin and cos of each point, as the flows call them
template <typename T>
__global__ void __launch_bounds__(256)
fantasy_trig_kernel(const T* __restrict__ x, T* __restrict__ sin_out,
                    T* __restrict__ cos_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T v = x[i];
  sin_out[i] = sin_t(v);
  cos_out[i] = cos_t(v);
}

template <typename T>
int launch(const T* state_in, T* state_out, int* ns_out, const T* params,
           int n, int n_sub, int steps, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_schw16_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          state_in, state_out, ns_out, params, n, n_sub, steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trig(const T* x, T* sin_out, T* cos_out, int n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_trig_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, sin_out, cos_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grt_fantasy_schw16_f32_launch(const float* state_in,
                                             float* state_out, int* ns_out,
                                             const float* params, int n,
                                             int n_sub, int steps,
                                             void* stream) {
  return launch<float>(state_in, state_out, ns_out, params, n, n_sub, steps,
                       stream);
}

extern "C" int grt_fantasy_schw16_f64_launch(const double* state_in,
                                             double* state_out, int* ns_out,
                                             const double* params, int n,
                                             int n_sub, int steps,
                                             void* stream) {
  return launch<double>(state_in, state_out, ns_out, params, n, n_sub, steps,
                        stream);
}

extern "C" int grt_fantasy_trig_f32_launch(const float* x, float* sin_out,
                                           float* cos_out, int n,
                                           void* stream) {
  return launch_trig<float>(x, sin_out, cos_out, n, stream);
}

extern "C" int grt_fantasy_trig_f64_launch(const double* x, double* sin_out,
                                           double* cos_out, int n,
                                           void* stream) {
  return launch_trig<double>(x, sin_out, cos_out, n, stream);
}
