// Kahan-compensated, staggered, equatorial Schwarzschild FANTASY integrator:
// one CUDA thread per ray.
//
// Replaces the TPU kernel grtrace/engine/integrate_pallas.py::_make_kernel
// in its n_rows=24 configuration (staggered, open/close; entry point
// integrate_batch_pallas(equatorial=True, compensated=True)).  Its eager
// twin, which defines what this kernel computes, is
// grtrace_torch/engine/integrate.py::integrate_batch_compensated, built on
// the flows of grtrace_torch/physics/hamiltonian.py (staggered_eqc).
//
// What bounds it on an H100: FP32 issue rate and latency.  Each ray is a
// serial chain of about 250 floating-point operations per step, with six
// IEEE divisions, for up to 2e5 steps; the long tail of near-critical rays
// that orbit the photon sphere runs far longer than the rest.  There is no
// memory traffic inside the loop.
//
// What the design does about it: the 24-value state (12 equatorial rows and
// their 12 Kahan deficits) lives in registers, with no shared memory and no
// global traffic until the ray exits; a finished ray breaks out of its loop
// (the per-thread form of the TPU kernel's masked steps and per-tile early
// exit); the wrapper sorts rays by |b - b_crit| so a warp's rays retire
// together.  Making it fast is later work.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation below rounds once, in the order written, exactly as the eager
// twin's torch ops do: the association follows hamiltonian.py term by term
// (e.g. (dt * r) * inv_rms, (-dt) * dH_r) and kahan_add keeps its four ops.
//
// Layout: state_in/state_out are SoA (24, n) float32, each row contiguous,
// so a warp's loads and stores are coalesced.  params is the float32 vector
// [rs, r_max, cap, (d, one_minus_cos, sin, bridge) x n_sub] built on the host
// by engine/integrate.py::substep_params.  ns_out (n,) int32 counts the
// steps each ray took.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 12;

struct State {
  float s[kRows];  // q1t q1r q1ph p1t p1r p1ph q2t q2r q2ph p2t p2r p2ph
  float c[kRows];  // Kahan deficits, true value = s - c
};

__device__ __forceinline__ void kahan_add(float& s, float& c, float inc) {
  // MUST stay exactly this op sequence (hamiltonian._kahan_add)
  const float y = inc - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Flow A (metric at q1, kick p1r, drift q2) when kick == 0;
// flow B (metric at q2, kick p2r, drift q1) when kick == 1.
// q = base row of the copy whose metric is read (0 or 6), the momenta read
// are the other copy's (9 or 3), and the position drifted is the other
// copy's (6 or 0).
template <int Q, int P_READ, int P_KICK, int Q_DRIFT>
__device__ __forceinline__ void flow(State& st, float dt, float rs) {
  const float r = st.s[Q + 1];
  const float pt = st.s[P_READ + 0];
  const float pr = st.s[P_READ + 1];
  const float pph = st.s[P_READ + 2];
  const float inv_r = 1.0f / r;
  const float inv_r2 = inv_r * inv_r;
  const float inv_rms = 1.0f / (r - rs);
  const float dH_r = (0.5f * rs) * (inv_rms * inv_rms * pt * pt
                                    + inv_r2 * pr * pr)
                     - inv_r2 * inv_r * (pph * pph);
  kahan_add(st.s[P_KICK + 1], st.c[P_KICK + 1], (-dt) * dH_r);
  kahan_add(st.s[Q_DRIFT + 0], st.c[Q_DRIFT + 0], (-((dt * r) * inv_rms)) * pt);
  kahan_add(st.s[Q_DRIFT + 1], st.c[Q_DRIFT + 1], (dt * (1.0f - rs * inv_r)) * pr);
  kahan_add(st.s[Q_DRIFT + 2], st.c[Q_DRIFT + 2], (dt * inv_r2) * pph);
}

// _flow_a_eqc: metric at q1 (rows 0..2), p2 (rows 9..11), kick p1 (3..5),
// drift q2 (6..8)
__device__ __forceinline__ void flow_a(State& st, float dt, float rs) {
  flow<0, 9, 3, 6>(st, dt, rs);
}

// _flow_b_eqc: metric at q2 (rows 6..8), p1 (rows 3..5), kick p2 (9..11),
// drift q1 (0..2)
__device__ __forceinline__ void flow_b(State& st, float dt, float rs) {
  flow<6, 3, 9, 0>(st, dt, rs);
}

// _flow_mixed_eqc: the mixing rotation in increment form
__device__ __forceinline__ void flow_mixed(State& st, float omc_w, float sin_w) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float q_dif = (st.s[a] - st.s[6 + a]) - (st.c[a] - st.c[6 + a]);
    const float p_dif = (st.s[3 + a] - st.s[9 + a]) - (st.c[3 + a] - st.c[9 + a]);
    const float dq1 = 0.5f * (sin_w * p_dif - omc_w * q_dif);
    const float dp1 = 0.5f * ((-sin_w) * q_dif - omc_w * p_dif);
    kahan_add(st.s[a], st.c[a], dq1);
    kahan_add(st.s[3 + a], st.c[3 + a], dp1);
    kahan_add(st.s[6 + a], st.c[6 + a], -dq1);
    kahan_add(st.s[9 + a], st.c[9 + a], -dp1);
  }
}

__device__ __forceinline__ bool active(float r, float r_capture, float r_max) {
  return (r > r_capture) && (r < r_max);
}

__global__ void __launch_bounds__(128)
fantasy_eqc_kernel(const float* __restrict__ state_in,
                   float* __restrict__ state_out,
                   int* __restrict__ ns_out,
                   const float* __restrict__ params,
                   int n, int n_sub, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  State st;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    st.s[k] = state_in[k * n + i];
    st.c[k] = state_in[(kRows + k) * n + i];
  }

  const float rs = __ldg(params + 0);
  const float r_max = __ldg(params + 1);
  const float cap = __ldg(params + 2);
  const float d0 = __ldg(params + 3);
  const float r_capture = 1.1f * rs;

  int ns = 0;
  const bool act0 = active(st.s[1], r_capture, r_max);
  if (act0 && steps > 0) {
    flow_a(st, 0.5f * d0, rs);  // opening half-A
    for (int k = 0; k < steps; ++k) {
      if (!active(st.s[1], r_capture, r_max)) break;
      const State old = st;
      for (int j = 0; j < n_sub; ++j) {
        const float* sub = params + 3 + 4 * j;
        const float d = __ldg(sub + 0);
        const float half = 0.5f * d;
        flow_b(st, half, rs);
        flow_mixed(st, __ldg(sub + 1), __ldg(sub + 2));
        flow_b(st, half, rs);
        flow_a(st, __ldg(sub + 3), rs);
      }
      // blow-up guard; the negated <= also catches NaN and Inf
      if (!(fabsf(st.s[1] - old.s[1]) <= cap)) {
        st = old;
        st.s[1] = rs;  // q1_r
        st.s[7] = rs;  // q2_r
        st.c[1] = 0.0f;
        st.c[7] = 0.0f;
      }
      ++ns;
    }
    // closing half-A, except for rays the guard parked at exactly r == rs
    if (st.s[1] != rs) flow_a(st, -0.5f * d0, rs);
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    state_out[k * n + i] = st.s[k];
    state_out[(kRows + k) * n + i] = st.c[k];
  }
  ns_out[i] = ns;
}

}  // namespace

extern "C" int grt_fantasy_eqc_launch(const float* state_in, float* state_out,
                                      int* ns_out, const float* params, int n,
                                      int n_sub, int steps, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_eqc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state_in, state_out, ns_out, params, n, n_sub, steps);
  return static_cast<int>(cudaGetLastError());
}
