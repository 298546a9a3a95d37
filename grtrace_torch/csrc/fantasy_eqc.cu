// Staggered, equatorial Schwarzschild FANTASY integrator: one CUDA thread
// per ray, one template over <T, kComp, kOpenClose> for three kernels.
//
// Replaces the TPU kernel grtrace/engine/integrate_pallas.py::_make_kernel
// in three of its configurations:
//   <float,  true,  true>   B1: n_rows=24, Kahan-compensated, open/close
//                           (integrate_batch_pallas(equatorial=True,
//                           compensated=True), the headline render);
//   <double, false, true>   B2: n_rows=12, plain, open/close
//                           (integrate_batch_pallas(equatorial=True) on the
//                           float64 rays of the float64 render);
//   <float,  true,  false>  B4: n_rows=24, the core loop only, on an opened
//                           carry (advance_state_pallas_eqc, the
//                           checkpoint chunk); ns counts this chunk's steps.
// Their eager twins, which define what the kernels compute, are
// grtrace_torch/engine/integrate.py::integrate_batch_compensated (B1),
// ::integrate_batch_eq (B2) and grtrace_torch/engine/checkpoint.py::
// _advance_eqc (B4), built on the flows of
// grtrace_torch/physics/hamiltonian.py (staggered_eqc, staggered_eq).
//
// What bounds it on an H100: the issue rate of its instructions.  Each ray
// is a serial chain of about 220 (compensated) or 160 (plain)
// floating-point operations per step, six of them IEEE reciprocals, for
// up to 2e5 steps, with no memory traffic inside the loop; -fmad=false
// forbids FMA, so every operation issues alone.  With the rays
// cost-sorted, a warp's rays retire together, and on the headline frame
// the bulk of the rays keeps every scheduler issuing at close to one
// instruction a cycle (the float32 layouts at 28 resident warps per SM):
// the time follows the instructions a step issues, not the resident warps.
//
// What the design does about it:
//  * the state (12 equatorial rows, plus their 12 Kahan deficits in the
//    compensated layout) lives in registers, with no global traffic until
//    the ray exits; a finished ray breaks out of its loop (the per-thread
//    form of the TPU kernel's masked steps and per-tile early exit), and
//    the wrapper sorts rays by |b - b_crit|;
//  * at order 2 (n_sub == 1, every scene's) the step's scalars (d / 2, the
//    mixing's two coefficients, the bridge) are read once per ray and stay
//    in registers, so the step loop holds no load, no index arithmetic and
//    no substep loop; orders 4 to 8 keep the general substep loop;
//  * the guard's pre-step copy stays in registers.  Its cost is the moves
//    of the rows a revert restores, at every step; a copy in shared memory
//    (six 16-byte stores a step, and a compiler fence so that the revert
//    reads them) and more resident blocks through __launch_bounds__ cost
//    the float32 layouts more than they saved.

// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation below rounds once, in the order written, exactly as the eager
// twins' torch ops do: the association follows hamiltonian.py term by term
// (e.g. (dt * r) * inv_rms, (-dt) * dH_r) and kahan_add keeps its four ops.
// A plain flow's s - dt k is written s + (-dt) k, which IEEE arithmetic
// makes the same value.  Literals are of the ray type T.  The plain mixing
// flow is the cos/sin form of _flow_mixed_eq, the compensated one the
// one-minus-cos increment form of _flow_mixed_eqc.
//
// Layout: state_in/state_out are SoA (rows, n) in T, each row contiguous, so
// a warp's loads and stores are coalesced: rows q1t q1r q1ph p1t p1r p1ph
// q2t q2r q2ph p2t p2r p2ph, then (compensated) their 12 deficits (true
// value s - c).  params is the vector [rs, r_max, cap, (d, c, sin, bridge)
// x n_sub] in T built on the host by engine/integrate.py::substep_params,
// where c is one_minus_cos of the mixing angle (compensated) or its cos
// (plain).  ns_out (n,) int32 counts the steps each ray took in this launch.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kRows = 12;
constexpr int kThreads = 128;

template <typename T, bool kComp>
struct State {
  T s[kRows];  // q1t q1r q1ph p1t p1r p1ph q2t q2r q2ph p2t p2r p2ph
  T c[kRows];  // Kahan deficits, true value = s - c
};

template <typename T>
struct State<T, false> {
  T s[kRows];
};

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ void kahan_add(T& s, T& c, T inc) {
  // MUST stay exactly this op sequence (hamiltonian._kahan_add)
  const T y = inc - c;
  const T t = s + y;
  c = (t - s) - y;
  s = t;
}

// row I += inc: Kahan-compensated, or one plain add
template <int I, typename T, bool kComp>
__device__ __forceinline__ void add(State<T, kComp>& st, T inc) {
  if constexpr (kComp) {
    kahan_add(st.s[I], st.c[I], inc);
  } else {
    st.s[I] = st.s[I] + inc;
  }
}

// Flow A (metric at q1, kick p1r, drift q2) or flow B (metric at q2, kick
// p2r, drift q1): Q = base row of the copy whose metric is read (0 or 6),
// P_READ = the other copy's momenta (9 or 3), P_KICK = the momenta kicked
// (3 or 9), Q_DRIFT = the position drifted (6 or 0).
template <int Q, int P_READ, int P_KICK, int Q_DRIFT, typename T, bool kComp>
__device__ __forceinline__ void flow(State<T, kComp>& st, T dt, T rs) {
  const T r = st.s[Q + 1];
  const T pt = st.s[P_READ + 0];
  const T pr = st.s[P_READ + 1];
  const T pph = st.s[P_READ + 2];
  const T inv_r = T(1) / r;
  const T inv_r2 = inv_r * inv_r;
  const T inv_rms = T(1) / (r - rs);
  const T dH_r = (T(0.5) * rs) * (inv_rms * inv_rms * pt * pt
                                  + inv_r2 * pr * pr)
                 - inv_r2 * inv_r * (pph * pph);
  add<P_KICK + 1>(st, (-dt) * dH_r);
  add<Q_DRIFT + 0>(st, (-((dt * r) * inv_rms)) * pt);
  add<Q_DRIFT + 1>(st, (dt * (T(1) - rs * inv_r)) * pr);
  add<Q_DRIFT + 2>(st, (dt * inv_r2) * pph);
}

// _flow_a_eqc / _flow_a_eq: metric at q1 (rows 0..2), p2 (rows 9..11),
// kick p1 (3..5), drift q2 (6..8)
template <typename T, bool kComp>
__device__ __forceinline__ void flow_a(State<T, kComp>& st, T dt, T rs) {
  flow<0, 9, 3, 6>(st, dt, rs);
}

// _flow_b_eqc / _flow_b_eq: metric at q2 (rows 6..8), p1 (rows 3..5), kick
// p2 (9..11), drift q1 (0..2)
template <typename T, bool kComp>
__device__ __forceinline__ void flow_b(State<T, kComp>& st, T dt, T rs) {
  flow<6, 3, 9, 0>(st, dt, rs);
}

// The mixing rotation: _flow_mixed_eqc's increment form (cw = 1 - cos) in
// the compensated layout, _flow_mixed_eq's cos/sin form (cw = cos) in the
// plain one.
template <typename T, bool kComp>
__device__ __forceinline__ void flow_mixed(State<T, kComp>& st, T cw, T sw) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if constexpr (kComp) {
      const T q_dif = (st.s[a] - st.s[6 + a]) - (st.c[a] - st.c[6 + a]);
      const T p_dif = (st.s[3 + a] - st.s[9 + a])
                      - (st.c[3 + a] - st.c[9 + a]);
      const T dq1 = T(0.5) * (sw * p_dif - cw * q_dif);
      const T dp1 = T(0.5) * ((-sw) * q_dif - cw * p_dif);
      kahan_add(st.s[a], st.c[a], dq1);
      kahan_add(st.s[3 + a], st.c[3 + a], dp1);
      kahan_add(st.s[6 + a], st.c[6 + a], -dq1);
      kahan_add(st.s[9 + a], st.c[9 + a], -dp1);
    } else {
      const T q1 = st.s[a], p1 = st.s[3 + a];
      const T q2 = st.s[6 + a], p2 = st.s[9 + a];
      const T q_sum = q1 + q2;
      const T q_dif = q1 - q2;
      const T p_sum = p1 + p2;
      const T p_dif = p1 - p2;
      st.s[a] = T(0.5) * (q_sum + q_dif * cw + p_dif * sw);
      st.s[3 + a] = T(0.5) * (p_sum + p_dif * cw - q_dif * sw);
      st.s[6 + a] = T(0.5) * (q_sum - q_dif * cw - p_dif * sw);
      st.s[9 + a] = T(0.5) * (p_sum - p_dif * cw + q_dif * sw);
    }
  }
}

// One staggered (sub)step B(d/2) M B(d/2) A(bridge), half = d / 2
template <typename T, bool kComp>
__device__ __forceinline__ void substep(State<T, kComp>& st, T half, T cw,
                                        T sw, T bridge, T rs) {
  flow_b(st, half, rs);
  flow_mixed(st, cw, sw);
  flow_b(st, half, rs);
  flow_a(st, bridge, rs);
}

template <typename T>
__device__ __forceinline__ bool active(T r, T r_capture, T r_max) {
  return (r > r_capture) && (r < r_max);
}

// At most `steps` guarded core steps of an active ray; `step` applies one
// step's substeps.  Returns the steps taken.
template <typename T, bool kComp, typename Step>
__device__ __forceinline__ int cores(State<T, kComp>& st, int steps, T rs,
                                     T r_capture, T r_max, T cap, Step step) {
  int ns = 0;
  for (; ns < steps; ++ns) {
    if (!active(st.s[1], r_capture, r_max)) break;
    const State<T, kComp> old = st;
    step(st);
    // blow-up guard; the negated <= also catches NaN and Inf
    if (!(abs_t(st.s[1] - old.s[1]) <= cap)) {
      st = old;
      st.s[1] = rs;  // q1_r
      st.s[7] = rs;  // q2_r
      if constexpr (kComp) {
        st.c[1] = T(0);
        st.c[7] = T(0);
      }
    }
  }
  return ns;
}

template <typename T, bool kComp, bool kOpenClose>
__global__ void __launch_bounds__(kThreads)
fantasy_eqc_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                   int* __restrict__ ns_out, const T* __restrict__ params,
                   int n, int n_sub, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  State<T, kComp> st;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    st.s[k] = state_in[k * n + i];
    if constexpr (kComp) st.c[k] = state_in[(kRows + k) * n + i];
  }

  const T rs = __ldg(params + 0);
  const T r_max = __ldg(params + 1);
  const T cap = __ldg(params + 2);
  const T d0 = __ldg(params + 3);
  const T r_capture = T(1.1) * rs;
  // the first substep's d / 2: the open and close flows' size, and the B
  // flows' at order 2
  const T half0 = T(0.5) * d0;

  int ns = 0;
  const bool act0 = active(st.s[1], r_capture, r_max);
  if (act0 && steps > 0) {
    if constexpr (kOpenClose) flow_a(st, half0, rs);  // opening half-A
    if (n_sub == 1) {
      const T cw = __ldg(params + 4);
      const T sw = __ldg(params + 5);
      const T bridge = __ldg(params + 6);
      ns = cores(st, steps, rs, r_capture, r_max, cap,
                 [&](State<T, kComp>& s) {
                   substep(s, half0, cw, sw, bridge, rs);
                 });
    } else {
      ns = cores(st, steps, rs, r_capture, r_max, cap,
                 [&](State<T, kComp>& s) {
                   for (int j = 0; j < n_sub; ++j) {
                     const T* sub = params + 3 + 4 * j;
                     substep(s, T(0.5) * __ldg(sub + 0), __ldg(sub + 1),
                             __ldg(sub + 2), __ldg(sub + 3), rs);
                   }
                 });
    }
    // closing half-A, except for rays the guard parked at exactly r == rs
    if constexpr (kOpenClose) {
      if (st.s[1] != rs) flow_a(st, -half0, rs);
    }
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    state_out[k * n + i] = st.s[k];
    if constexpr (kComp) state_out[(kRows + k) * n + i] = st.c[k];
  }
  ns_out[i] = ns;
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <typename T, bool kComp, bool kOpenClose>
int launch(const T* state_in, T* state_out, int* ns_out, const T* params,
           int n, int n_sub, int steps, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_eqc_kernel<T, kComp, kOpenClose>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          state_in, state_out, ns_out, params, n, n_sub, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1: 24 rows float, compensated, open/close
extern "C" int grt_fantasy_eqc_launch(const float* state_in, float* state_out,
                                      int* ns_out, const float* params, int n,
                                      int n_sub, int steps, void* stream) {
  return launch<float, true, true>(state_in, state_out, ns_out, params, n,
                                   n_sub, steps, stream);
}

// B2: 12 rows double, plain, open/close
extern "C" int grt_fantasy_eq_f64_launch(const double* state_in,
                                         double* state_out, int* ns_out,
                                         const double* params, int n,
                                         int n_sub, int steps, void* stream) {
  return launch<double, false, true>(state_in, state_out, ns_out, params, n,
                                     n_sub, steps, stream);
}

// B4: 24 rows float, compensated, core loop only (an opened carry)
extern "C" int grt_fantasy_eqc_chunk_launch(const float* state_in,
                                            float* state_out, int* ns_out,
                                            const float* params, int n,
                                            int n_sub, int steps,
                                            void* stream) {
  return launch<float, true, false>(state_in, state_out, ns_out, params, n,
                                    n_sub, steps, stream);
}
#endif  // __CUDACC__
