// The Schwarzschild FANTASY integrator on the fused flows, 16 rows, one
// CUDA thread per ray: one template in three modes, instantiated for float
// and double.
//
//   B3 (Mode::kIntegrate): the generic (any-plane) integrator, to each
//      ray's exit or the step budget, state in and out.
//   S1 (Mode::kRecord): the trajectory recorder, q1 stored every `stride`
//      steps.
//   T1 (Mode::kTrace): the EinsteinPy-compatible trace, (q1, p1) stored
//      after every step, every step taken.
//
// B3 replaces the TPU kernel grtrace/engine/integrate_pallas.py::
// _make_kernel in its n_rows=16 configuration (plain, not staggered, the
// step fantasy_step_ord2_fused; entry points integrate_batch_pallas(
// equatorial=False), SchwarzschildIntegrator(backend='pallas') and the
// checkpoint chunk advance_state_pallas).  One C entry serves the
// monolithic call and the chunk: the kernel advances a (16, n) state by at
// most `steps` masked steps and counts the steps each ray took.  Its eager
// twins, which define what it computes, are grtrace_torch/engine/
// integrate.py::integrate_batch_fused (and its loop fused_cores, which the
// chunk twin checkpoint.py::_advance_fused runs), built on
// hamiltonian.py::fantasy_step_ord2_fused.
//
// S1 is a port-side kernel: it replaces no TPU kernel.  The JAX package
// samples trajectories in an XLA fori_loop (grtrace/engine/integrate.py::
// integrate_batch_full), not in Pallas.  Its eager twin is grtrace_torch/
// engine/integrate.py::integrate_batch_full, which steps with B3's fused
// step (the JAX loop steps with the unfused flows: a deliberate divergence
// in rounding).  The render's trajectory sampler, the single-ray driver
// and the band sweep call it through integrate.py::integrate_full_dispatch.
// Per ray, at step k = 0, 1, ... < steps: the ray is active while
// 1.1 rs < r < r_max; if k % stride == 0 its q1 goes to slot k / stride
// (the step on which the ray is first found inactive included); an
// inactive ray stops; otherwise the step runs, and the horizon guard
// reverts a step whose radius jumps by more than `cap` (or turns
// non-finite) and parks the ray at r = rs.  The host zeroes the record, so
// the slots after a ray's exit stay +0.0.
//
// T1 is a port-side kernel too: it replaces the XLA scan of grtrace/compat/
// einsteinpy.py::_trajectory, which the compat classes Geodesic, Nulllike
// and Timelike run.  Its eager twin is grtrace_torch/engine/integrate.py::
// trajectory_unmasked (B3's fused step; JAX's scan steps with the unfused
// flows, a deliberate divergence in rounding, as for S1), and
// integrate.py::trajectory_dispatch sends CUDA rays to it.  Per ray, for
// k = 0, 1, ... < steps: the step runs and its (q1, p1) goes to row k of
// the ray's record.  Nothing stops a ray: no domain test, no horizon guard,
// no park, as JAX's scan has none; a ray that falls through the horizon
// records what the arithmetic gives, NaN included.  Bound: one dependent
// chain of 257 operations a step (S1's floor, metrics.chain_floor_ms); the
// record is 64 bytes a step in double, written once.
//
// What bounds B3 on an H100: FP32 (or FP64) instruction throughput and
// latency.  Each ray is a serial chain of about 260 floating-point
// operations per step, for up to the step budget; near-critical rays orbit
// longest.  No memory traffic inside the loop.  In float64 the IEEE
// divisions and sin/cos, which the card computes in software, are most of
// the instructions.
//
// What bounds S1: one dependent chain.  The sampler runs tens of rays (20
// in the CLI's render, 50 in the band sweep, 1 in the single-ray driver),
// one warp or two, so the card's throughput is idle and the time is the
// longest ray's steps times the latency of one step.  One warp issues at
// most one instruction a cycle and, under -fmad=false, each of the 257
// operations of an order-2 step (engine/metrics.py::KERNEL_OPS) is at
// least one instruction, so the floor is 257 x the longest ray's steps
// over the SM clock (metrics.chain_floor_ms: 0.87 ms for the CLI's
// longest ray, 6,701 steps at 1.98 GHz).  The record is the only memory
// traffic: at most n_keep 16- or 32-byte stores a ray.
//
// What the design does about it: the chain is made short.
//  * The fused flows: 3 IEEE divisions and one sincos an evaluation where
//    the unfused flows take about 8 divisions and separate sin and cos.
//  * Flow A reads the metric at q1 and the momenta p2 and moves neither,
//    so the first flow A of a substep reads the very values that the last
//    flow A before it read: the kernel keeps that flow's metric terms and
//    forces (Metric) and forms only the products with dt again, across
//    substep and step boundaries alike.  At order 2 a step evaluates the
//    metric three times, not four: 9 IEEE divisions and 3 sincos where the
//    fused step as written takes 12 and 4.  The two increments of the
//    back-to-back A flows are still added one after the other.  A launch's
//    first step evaluates it afresh; a ray that the guard reverts is
//    parked inside the capture radius and takes no further step.
//  * B3: the 16-row state and the guard's copy of it live in registers; a
//    finished ray breaks out of its loop (the per-thread form of the TPU
//    kernel's masked steps and per-tile early exit); the monolithic
//    wrapper sorts rays by |b - b_crit| so a warp's rays retire together
//    (the chunk keeps the caller's order); 128 threads a block.
//  * S1: the same loop with the store; blocks of 32 threads in the
//    caller's order, and no block count asked of __launch_bounds__ (tens
//    of rays fill a warp or two, so occupancy does not matter: a
//    min_blocks of 1 and 64-thread blocks measured slower, one ray a block
//    gained 2% on the CLI's 20 rays only, PERF.md section 6); the slot index
//    advances by a counter, with no division in the loop.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation below rounds once, in the order written, exactly as the twin's
// torch ops do; the association follows hamiltonian.py's fused flows term
// by term, literals are of the ray type T, and `1 / x` is an IEEE division
// (torch's reciprocal).  sin and cos of one angle come from one sincosf
// (sincos for double) call, which gives the very values of the card's
// sinf/cosf (sin/cos); fantasy_trig_kernel evaluates both forms on given
// points so that a caller can hold them against torch.sin and torch.cos.
//
// Layout: B3's state_in/state_out are SoA (16, n) in T, each row
// contiguous: q1 (t, r, theta, phi), p1, q2, p2.  S1's and T1's q0 and p0
// are (n, 4) in T, row-major; S1's traj is (n, n_keep, 4) in T, row-major
// and zeroed by the host, T1's out (n, steps, 8) in T, row-major, every
// element written.  params is the vector [rs, r_max, cap, (d, cos, sin)
// x n_sub] in T (cos/sin of the mixing angle 2 omega d) built on the host
// by engine/integrate.py::substep_params(compensated=False,
// staggered=False).  ns_out (n,) int32 counts the steps each ray took.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstddef>

namespace {

constexpr int kRows = 16;

enum class Mode : int { kIntegrate, kRecord, kTrace };

// threads per block: a frame for B3, tens of rays for S1 and T1
constexpr int threads_of(Mode mode) {
  return mode == Mode::kIntegrate ? 128 : 32;
}

__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// What a fused flow computes before it applies dt: the metric terms at the
// position copy it reads and the force on the momenta it reads (inv_r3,
// sin, cos and 1 / sin only feed the force).
template <typename T>
struct Metric {
  T r, inv_r, inv_r2, inv_rms, inv_sin2, dH_r, dH_th;
};

// The metric at the copy whose base row is Q (0 or 8), with the other
// copy's momenta P_READ (12 or 4).
template <int Q, int P_READ, typename T>
__device__ __forceinline__ Metric<T> metric(const T (&s)[kRows], T rs) {
  Metric<T> m;
  m.r = s[Q + 1];
  m.inv_r = T(1) / m.r;
  m.inv_r2 = m.inv_r * m.inv_r;
  const T inv_r3 = m.inv_r2 * m.inv_r;
  m.inv_rms = T(1) / (m.r - rs);
  T sin_th, cos_th;
  sincos_t(s[Q + 2], &sin_th, &cos_th);
  const T inv_sin = T(1) / sin_th;
  m.inv_sin2 = inv_sin * inv_sin;

  const T pt = s[P_READ + 0];
  const T pr = s[P_READ + 1];
  const T pth = s[P_READ + 2];
  const T pph = s[P_READ + 3];
  const T pt2 = pt * pt;
  const T pr2 = pr * pr;
  const T pth2 = pth * pth;
  const T pph2_s = pph * pph * m.inv_sin2;

  m.dH_r = (T(0.5) * rs) * (m.inv_rms * m.inv_rms * pt2 + m.inv_r2 * pr2)
           - inv_r3 * (pth2 + pph2_s);
  m.dH_th = -cos_th * inv_sin * m.inv_r2 * pph2_s;
  return m;
}

// The fused flow's update with the metric m of its own (position, momenta)
// copies: kick the momenta P_KICK, drift the position Q_DRIFT by dt.
template <int P_READ, int P_KICK, int Q_DRIFT, typename T>
__device__ __forceinline__ void apply(T (&s)[kRows], const Metric<T>& m,
                                      T dt, T rs) {
  const T pt = s[P_READ + 0];
  const T pr = s[P_READ + 1];
  const T pth = s[P_READ + 2];
  const T pph = s[P_READ + 3];

  s[P_KICK + 1] = s[P_KICK + 1] + (-dt) * m.dH_r;
  s[P_KICK + 2] = s[P_KICK + 2] + (-dt) * m.dH_th;

  s[Q_DRIFT + 0] = s[Q_DRIFT + 0] + (-((dt * m.r) * m.inv_rms)) * pt;
  s[Q_DRIFT + 1] = s[Q_DRIFT + 1] + (dt * (T(1) - rs * m.inv_r)) * pr;
  s[Q_DRIFT + 2] = s[Q_DRIFT + 2] + (dt * m.inv_r2) * pth;
  s[Q_DRIFT + 3] = s[Q_DRIFT + 3] + ((dt * m.inv_r2) * m.inv_sin2) * pph;
}

// Flow A's metric: at q1 with the momenta p2, the rows that flow A itself
// leaves as they are (it kicks p1 and drifts q2).
template <typename T>
__device__ __forceinline__ Metric<T> metric_a(const T (&s)[kRows], T rs) {
  return metric<0, 12>(s, rs);
}

// flow A on its metric m
template <typename T>
__device__ __forceinline__ void apply_a(T (&s)[kRows], const Metric<T>& m,
                                        T dt, T rs) {
  apply<12, 4, 8>(s, m, dt, rs);
}

// flow B: metric at q2 with the momenta p1; kick p2, drift q1
template <typename T>
__device__ __forceinline__ void flow_b(T (&s)[kRows], T dt, T rs) {
  apply<4, 12, 0>(s, metric<8, 4>(s, rs), dt, rs);
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

// fantasy_step_ord2_fused: A(d/2) B(d/2) M(d) B(d/2) A(d/2).  On entry
// `ma` is flow A's metric at the current (q1, p2); on return it is again,
// for the next substep's first flow A.
template <typename T>
__device__ __forceinline__ void step_ord2(T (&s)[kRows], Metric<T>& ma, T d,
                                          T rs, T cw, T sw) {
  const T half = T(0.5) * d;
  apply_a(s, ma, half, rs);
  flow_b(s, half, rs);
  flow_mixed(s, cw, sw);
  flow_b(s, half, rs);
  ma = metric_a(s, rs);
  apply_a(s, ma, half, rs);
}

// T1's loop on the state s: every step taken from flow A's metric carried
// as in step_ord2, (q1, p1) stored after each to `row` (steps x 8)
template <typename T>
__device__ __forceinline__ void trace(T (&s)[kRows], T* __restrict__ row,
                                      const T* __restrict__ params,
                                      int n_sub, int steps) {
  const T rs = __ldg(params + 0);
  Metric<T> ma = metric_a(s, rs);
  for (int k = 0; k < steps; ++k) {
    for (int j = 0; j < n_sub; ++j) {
      const T* sub = params + 3 + 3 * j;
      step_ord2(s, ma, __ldg(sub + 0), rs, __ldg(sub + 1), __ldg(sub + 2));
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) row[m] = s[m];
    row += 8;
  }
}

template <typename T>
__device__ __forceinline__ bool active(T r, T r_capture, T r_max) {
  return (r > r_capture) && (r < r_max);
}

// B3 (kIntegrate): `in` is state_in (16, n) SoA, `out` state_out (16, n);
// `p0`, `stride` and `n_keep` are unused.  S1 (kRecord): `in` is q0 (n, 4),
// `p0` p0 (n, 4), `out` traj (n, n_keep, 4).  T1 (kTrace): `in` and `p0`
// as S1's, `out` (n, steps, 8); `ns_out`, `stride` and `n_keep` unused.
template <typename T, Mode kMode>
__global__ void __launch_bounds__(threads_of(kMode))
fantasy_schw16_kernel(const T* __restrict__ in, const T* __restrict__ p0,
                      T* __restrict__ out, int* __restrict__ ns_out,
                      const T* __restrict__ params, int n, int n_sub,
                      int steps, int stride, int n_keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T s[kRows];
  if constexpr (kMode == Mode::kIntegrate) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) s[k] = in[k * n + i];
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      s[a] = in[4 * static_cast<size_t>(i) + a];
      s[4 + a] = p0[4 * static_cast<size_t>(i) + a];
      s[8 + a] = s[a];
      s[12 + a] = s[4 + a];
    }
  }
  if constexpr (kMode == Mode::kTrace) {
    trace(s, out + static_cast<size_t>(i) * static_cast<size_t>(steps) * 8,
          params, n_sub, steps);
    return;
  }

  const T rs = __ldg(params + 0);
  const T r_max = __ldg(params + 1);
  const T cap = __ldg(params + 2);
  const T r_capture = T(1.1) * rs;

  T* row = out;
  if constexpr (kMode == Mode::kRecord) {
    row += static_cast<size_t>(i) * static_cast<size_t>(n_keep) * 4;
  }
  int next_store = 0;  // S1: the next step whose q1 is recorded
  // flow A's metric at the current (q1, p2): evaluated afresh for the
  // launch's first step, then carried from step to step
  Metric<T> ma{};
  if (steps > 0 && active(s[1], r_capture, r_max)) ma = metric_a(s, rs);
  int ns = 0;
  for (int k = 0; k < steps; ++k) {
    if constexpr (kMode == Mode::kRecord) {
      if (k == next_store) {
#pragma unroll
        for (int a = 0; a < 4; ++a) row[a] = s[a];
        row += 4;
        next_store += stride;
      }
    }
    if (!active(s[1], r_capture, r_max)) break;
    T old[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) old[m] = s[m];
    for (int j = 0; j < n_sub; ++j) {
      const T* sub = params + 3 + 3 * j;
      step_ord2(s, ma, __ldg(sub + 0), rs, __ldg(sub + 1), __ldg(sub + 2));
    }
    // blow-up guard on rows 1 and 9; the negated <= also catches NaN, Inf
    if (!(abs_t(s[1] - old[1]) <= cap)) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) s[m] = old[m];
      s[1] = rs;  // q1_r
      s[9] = rs;  // q2_r
      // parked inside r_capture: the ray is inactive, so the carried ma is
      // never read again (a later chunk evaluates it afresh)
    }
    ++ns;
  }

  if constexpr (kMode == Mode::kIntegrate) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[k * n + i] = s[k];
  }
  ns_out[i] = ns;
}

// sin and cos of each point, as two calls and as one sincos (the flows'
// form)
template <typename T>
__global__ void __launch_bounds__(256)
fantasy_trig_kernel(const T* __restrict__ x, T* __restrict__ sin_out,
                    T* __restrict__ cos_out, T* __restrict__ sc_sin_out,
                    T* __restrict__ sc_cos_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T v = x[i];
  sin_out[i] = sin_t(v);
  cos_out[i] = cos_t(v);
  T s, c;
  sincos_t(v, &s, &c);
  sc_sin_out[i] = s;
  sc_cos_out[i] = c;
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <typename T, Mode kMode>
int launch(const T* in, const T* p0, T* out, int* ns_out, const T* params,
           int n, int n_sub, int steps, int stride, int n_keep,
           void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = threads_of(kMode);
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_schw16_kernel<T, kMode>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          in, p0, out, ns_out, params, n, n_sub, steps, stride, n_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trig(const T* x, T* sin_out, T* cos_out, T* sc_sin_out,
                T* sc_cos_out, int n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_trig_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, sin_out, cos_out, sc_sin_out, sc_cos_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3: (state_in, state_out, ns_out, params, n, n_sub, steps, stream)
extern "C" int grt_fantasy_schw16_f32_launch(const float* state_in,
                                             float* state_out, int* ns_out,
                                             const float* params, int n,
                                             int n_sub, int steps,
                                             void* stream) {
  return launch<float, Mode::kIntegrate>(state_in, nullptr, state_out,
                                         ns_out, params, n, n_sub, steps, 1,
                                         0, stream);
}

extern "C" int grt_fantasy_schw16_f64_launch(const double* state_in,
                                             double* state_out, int* ns_out,
                                             const double* params, int n,
                                             int n_sub, int steps,
                                             void* stream) {
  return launch<double, Mode::kIntegrate>(state_in, nullptr, state_out,
                                          ns_out, params, n, n_sub, steps, 1,
                                          0, stream);
}

// S1: (q0, p0, traj (n, n_keep, 4), ns_out, params, n, n_sub, steps,
// stride, n_keep, stream)
extern "C" int grt_fantasy_traj_f32_launch(const float* q0, const float* p0,
                                           float* traj, int* ns_out,
                                           const float* params, int n,
                                           int n_sub, int steps, int stride,
                                           int n_keep, void* stream) {
  return launch<float, Mode::kRecord>(q0, p0, traj, ns_out, params, n, n_sub,
                                      steps, stride, n_keep, stream);
}

extern "C" int grt_fantasy_traj_f64_launch(const double* q0, const double* p0,
                                           double* traj, int* ns_out,
                                           const double* params, int n,
                                           int n_sub, int steps, int stride,
                                           int n_keep, void* stream) {
  return launch<double, Mode::kRecord>(q0, p0, traj, ns_out, params, n,
                                       n_sub, steps, stride, n_keep, stream);
}

// T1: (q0, p0, out (n, steps, 8), params, n, n_sub, steps, stream)
extern "C" int grt_fantasy_trace_f32_launch(const float* q0, const float* p0,
                                            float* out, const float* params,
                                            int n, int n_sub, int steps,
                                            void* stream) {
  return launch<float, Mode::kTrace>(q0, p0, out, nullptr, params, n, n_sub,
                                     steps, 1, 0, stream);
}

extern "C" int grt_fantasy_trace_f64_launch(const double* q0,
                                            const double* p0, double* out,
                                            const double* params, int n,
                                            int n_sub, int steps,
                                            void* stream) {
  return launch<double, Mode::kTrace>(q0, p0, out, nullptr, params, n,
                                      n_sub, steps, 1, 0, stream);
}

extern "C" int grt_fantasy_trig_f32_launch(const float* x, float* sin_out,
                                           float* cos_out, float* sc_sin_out,
                                           float* sc_cos_out, int n,
                                           void* stream) {
  return launch_trig<float>(x, sin_out, cos_out, sc_sin_out, sc_cos_out, n,
                          stream);
}

extern "C" int grt_fantasy_trig_f64_launch(const double* x, double* sin_out,
                                           double* cos_out, double* sc_sin_out,
                                           double* sc_cos_out, int n,
                                           void* stream) {
  return launch_trig<double>(x, sin_out, cos_out, sc_sin_out, sc_cos_out, n,
                          stream);
}
#endif  // __CUDACC__
