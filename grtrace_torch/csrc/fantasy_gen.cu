// The generic engine's FANTASY integrator for the Kerr-Newman charts, the
// static beyond-Kerr families and the rotating regular families: one CUDA
// thread per ray, one template in four charts and four modes.
//
//   G1 (Chart::kBL, Mode::kIntegrate): the Boyer-Lindquist integrator, to
//      each ray's exit, with the spherical-chart blow-up guard and the park
//      flag in the sign of the step count; float and double.
//   S2 (Mode::kRecord, Chart::kBL or Chart::kKS): the trajectory recorder,
//      q1 stored every `stride` steps, in the Boyer-Lindquist chart or the
//      Kerr-Schild one (the invariant guard); float and double.
//   T2 (Mode::kTrace, Chart::kBL): the EinsteinPy-compatible trace, (q1,
//      p1) stored after every step, every step taken; float and double.
//   G1s, S2s, T2s (Chart::kStatic in kIntegrate, kRecord, kTrace): the
//      same three modes in the static chart of Kottler, Bardeen and
//      Hayward, ds^2 = -f dt^2 + dr^2/f + r^2 dOmega^2 (the flows of
//      physics/static_chart.py), with G1's spherical guard; float, double.
//   D1 (Mode::kDisk, Chart::kStatic): G1s's loop plus the first crossing
//      of the tilted disk plane inside [r_in, r_out], recorded as (hit_q,
//      hit_p); float and double.
//   G1r, S2r, T2r, D2 (Chart::kKSMass in kIntegrate, kRecord, kTrace,
//      kDisk): the mass-function Kerr-Schild chart of rotating Bardeen and
//      rotating Hayward (the flows of physics/rotating_chart.py) with the
//      Kerr-Schild invariant guard; D2's crossing is the equatorial one,
//      z changing sign; float and double.
//   G1d, S2d, T2d, D3 (Chart::kKdS in kIntegrate, kRecord, kTrace, kDisk):
//      Kerr-de Sitter's Boyer-Lindquist-like Carter chart (the flows of
//      physics/kds_chart.py) with G1's spherical guard; D3's crossing is
//      the equatorial one, cos theta changing sign; float and double.
//
// Port-side kernels: they replace no TPU kernel.  The JAX package runs
// this engine as an XLA while_loop / scan over vmapped jax.grad flows
// (grtrace/engine/integrate_generic.py::integrate_batch_generic and
// ::trajectory_batch_decimated, grtrace/engine/disk_static.py::
// integrate_batch_disk_static), not in Pallas; an eager torch loop costs
// milliseconds a step on the card, whatever the ray count.  The eager
// twins, which define what these kernels compute, are grtrace_torch/
// engine/integrate_generic.py::integrate_generic_twin (G1) and
// ::trajectory_generic_twin (S2), built on the closed-form flows of
// physics/kerr_bl.py, physics/kerr_schild.py (_kick_drift, _flow_b_ks,
// hamiltonian_ks), physics/static_chart.py and physics/rotating_chart.py,
// and hamiltonian._flow_mixed; D1's is engine/disk_static.py::
// integrate_disk_static_twin, D2's engine/integrate_generic.py::
// integrate_disk_rotating_twin.
//
// The step: per substep the unstaggered A(d/2) B(d/2) M B(d/2) A(d/2) of
// grtrace.physics.spacetime.make_step, flow A kicking p1 from the metric at
// q1 and momenta p2 and drifting q2, flow B the other way round.
//
// G1, per ray, at step k < steps: the ray is active while r_cap < r <
// r_max; an inactive ray stops.  After the step, the guard
// (integrate_generic.py::make_generic_step, JAX's guard_spherical) flags a
// step that turned q1 or p1 non-finite, moved r by more than jump_cap or
// theta by more than 1.5 ("exploded"), or ended inside r_plus
// ("crossed"); such a ray reverts to its pre-step state with q1's radius
// parked at cap_park (crossed, or exploded while heading inward or inside
// the plunge zone) or err_park, its step count becomes -(n + 1), and it
// stops.  The host applies the exact Boyer-Lindquist rescue to the output
// (integrate_ks.py::apply_bardeen_rescue_bl).
//
// S2, per ray, at step k < steps: if k % stride == 0, q1 goes to slot
// k / stride (the step on which the ray is first found inactive
// included); an inactive ray stops; otherwise the step runs under the
// chart's guard, which parks and reverts as in G1 (a parked ray stops at
// the next step, after that step's slot).  The Kerr-Schild guard (JAX's
// guard_cartesian) tests the null invariant |H| > 3e-2 (|p|^2 + 1) at the
// post-step (q1, p1) (a step that is not finite parks whatever it is),
// and parks on the axis: (0, 0, cap_park) captured, (err_park, 0, 0)
// numerical.  The host zeroes the record, so the slots after a ray's exit
// stay +0.0.
//
// T2, per ray, for k = 0, 1, ... < steps: G1's step runs (flow A's
// kick/drift carried, the launch forming the first) and its (q1, p1) goes
// to row k of the ray's record.  Nothing stops a ray: no domain test, no
// guard, no park, as JAX's trajectory_generic (an XLA scan, grtrace/
// engine/integrate_generic.py:369-391, which the compat classes run for
// Kerr and Kerr-Newman) has none.  Its eager twin is integrate_generic.py::
// trajectory_generic_unmasked; integrate_generic.py::trajectory_generic
// sends CUDA rays here.  Bound: one dependent chain of 534 operations a
// step (metrics.chain_floor_ms); the record is 64 bytes a step in double.
//
// What bounds them on an H100.  G1 on a 1024x1024 frame: the rate at which
// the SMs issue FP32 (or FP64) instructions.  A ray is a serial chain of
// about 530 floating-point operations a step at order 2 (three
// Boyer-Lindquist kick/drift evaluations, each with one sincos and five
// IEEE divisions, four flows applied, the mixing), about 1,060 SASS
// instructions with what the divisions and sincos issue besides, and no
// memory traffic inside the loop; rays exit after very different step
// counts.  Nothing here is a matrix product or a tile that streams through
// memory, so the tensor cores, TMA and shared-memory staging have no work:
// the levers are the instructions a step issues, their latency, and enough
// resident warps to hide it.  S2 runs tens of rays (20 in the render's
// sampler), one warp: it is bound by the latency of its longest ray's
// chain, as S1 is.
//
// What the design does about it:
//  * flow A reads q1 and p2 and writes neither, and nothing runs between
//    one flow A and the next (the guard aside), so each flow A applies the
//    kick/drift that the one before it formed, across substeps and steps:
//    three evaluations a substep, not four.  The launch forms the first;
//    after a park, G1 ends the ray and S2 forms it anew.  Each flow is still
//    applied by itself, with its own dt;
//  * the derivatives multiply by g^thth = 1 / Sigma and by one 1 / sin^2
//    theta where they divided by Sigma, sin^2 theta and sin theta: five
//    divisions an evaluation (the metric's four and 1 / sin^2 theta), 15 a
//    step at order 2 where there were 44 (the twin, kerr_bl.py, changed
//    with the kernel, term by term);
//  * sin and cos of theta come from one sincos;
//  * the wrapper launches the rays sorted by |b - 3 sqrt(3) M|, so that a
//    warp's rays retire together; a finished ray breaks out of its loop;
//  * __launch_bounds__ asks for 7 float blocks of 128 threads per SM (at
//    most 72 registers, no spill; min_blocks below).  The state and its
//    pre-step copy stay in registers: no block size (64, 128, 256) nor
//    fewer resident warps (6 or 5 blocks) measured faster.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation rounds once, in the order written, exactly as the twins' torch
// ops do; the association follows kerr_bl.py and kerr_schild.py term by
// term.  A Python scalar divided by a tensor is torch's reciprocal times the
// scalar, so 1 / x is one IEEE division; no twin divides a tensor by a
// Python scalar.  Literals are of the ray type T (T(3e-2) is the float
// nearest 0.03, as torch rounds the Python scalar).  sin and cos come from
// the card's sincosf (sincos for double), which gives the very values of
// its sinf and cosf and which chip_smoke.py's phase 21a holds against
// torch.sin and torch.cos on the card.
//
// Layout: q0 and p0 are (n, 4) in T, row-major.  params is the vector [M,
// a, Q, r_cap, r_max, r_plus, plunge_zone, jump_cap, cap_park, err_park,
// (d, cos, sin) x n_sub] built on the host by integrate_generic.py::
// gen_params, the vector the twins read.  G1 writes out (12, n) SoA: q1,
// p1, q2 in (t, r, theta, phi) order; S2 writes traj (n, n_keep, 4),
// row-major and zeroed by the host; T2 writes out (n, steps, 8), row-major,
// every element.  ns_out (n,) int32 counts the steps each ray took (negated
// in G1 and D1 if the guard parked it; T2 has none).
//
// The static chart (G1s, S2s, T2s, D1).  Its vector's second and third
// slots hold the family's lapse constant k (Lambda / 3, g^2 or 2 M l^2) and
// its code (0 Kottler, 1 Bardeen, 2 Hayward), a value read once per ray:
// every ray of a launch takes the same branch of lapse_static.  An
// evaluation divides five times (1 / r, 1 / f, 1 / sin^2 theta and the
// family's two), takes one sincos and, for Bardeen, one sqrt; all four
// components are kept, the theta kick included (cos(fl(pi/2)) is not 0, so
// folded rays leave the plane by rounding, as in JAX's autodiff step).
// The guard, the park radii and the signed step count are G1's.
//
// D1, per ray: G1s's loop; after each step that the guard did not park,
// u = c1 cos phi + c2 sin phi (c1, c2 the ray's disk-plane constants, disk
// (n, 2) in T; the product and the sum rounded apart, no FMA) is compared
// with the pre-step u (carried from the step before): where u0 u1 < 0, the
// crossing lerps q1 and p2 at t = u0 / (u0 - u1), and if the lerped r lies
// in [r_in, r_out] (the two scalars after the substeps in params) the ray
// records (hit_q, hit_p), sets hit_out and stops.  out is (16, n): q1, p1,
// hit_q, hit_p, the hit rows zero where the ray never hit.  Bound: G1s's
// step plus one sincos and about a dozen operations; the loop's exit is
// per ray, as JAX's while_loop ends when no ray is active and unhit.
//
// The mass-function chart (G1r, S2r, T2r, D2; grtrace/physics/
// rotating_regular.py in JAX, integrated there by the XLA loops of
// integrate_generic.py and disk.py::integrate_batch_disk).  Kerr-Schild's
// geometry with H = m(r) r / s and H_q = (N' r_q - H s_q) / s, N' = m +
// 3 m k / X (X = r^2 + k for Bardeen, r^3 + k for Hayward): the vector's
// third slot holds k (g^2 or 2 M l^2) and its jump_cap slot, which the
// Kerr-Schild guard never reads, the family code (1 Bardeen, 2 Hayward).
// An evaluation adds two divisions (and a sqrt for Bardeen) to the
// Kerr-Newman chart's.  At k = 0 it is the Kerr chart to the bit (u = r /
// sqrt(r r) = 1).  The guard, the park points and the signed step count
// are the Kerr-Schild ones; the host rescues the parked rays with the
// family's exact predicate (rotating_regular.escape_pred_rotating).  D2,
// per ray: G1r's loop; after each step that the guard did not park, where
// z0 z1 < 0 (pre- and post-step z), q1 and p2 are lerped at t = z0 / (z0 -
// z1), and if the lerped point's Kerr-Schild radius lies in [r_in, r_out]
// the ray records (hit_q, hit_p), sets hit_out and stops; out is D1's (16,
// n) followed by q2's four rows (the rescue's escape direction), disk is
// null.
//
// The Carter chart (G1d, S2d, T2d, D3; grtrace/physics/kerr_de_sitter.py
// in JAX, integrated there by the XLA loops of integrate_generic.py and
// disk_kds.py::integrate_batch_disk_kds).  kerr_bl's evaluation with
// Delta = r^2 - 2 M r + a^2 - L r^2 (r^2 + a^2), Delta_th = 1 + L a^2
// cos^2 theta and chi^2 = (1 + L a^2)^2 inserted (kick_drift_kds): the
// vector's charge slot holds L = Lambda / 3, rounded on the host in the
// working dtype, and the kernel forms chi^2 once per ray.  An evaluation
// divides six times (kick_drift_bl's five and 1 / Delta_th).  At L = 0
// every added term is an exact zero and every added factor an exact one,
// so the chart is G1's at Q = 0 to the bit.  The guard, the park radii and
// the signed step count are G1's; the host rescues the parked rays with
// the exact Kerr-de Sitter predicate (kerr_de_sitter.kds_escape_pred).
// D3, per ray: G1d's loop; after each step that the guard did not park,
// c1 = cos theta of the new q1 is compared with the pre-step c0 (carried):
// where c0 c1 < 0, q1 and p2 are lerped at t = c0 / (c0 - c1), and if the
// lerped r lies in [r_in, r_out] the ray records (hit_q, hit_p), sets
// hit_out and stops; out is D2's (20, n): q1, p1, hit_q, hit_p, q2.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kRows = 16;
constexpr int kScal = 10;

enum class Chart : int { kBL, kKS, kStatic, kKSMass, kKdS };

// the Kerr-Schild charts: Cartesian (t, x, y, z), three kicked rows, the
// invariant guard (a variable, which device code may read)
template <Chart kChart>
constexpr bool kKSLike = kChart == Chart::kKS || kChart == Chart::kKSMass;
enum class Mode : int { kIntegrate, kRecord, kTrace, kDisk };

// threads per block: a full frame for G1 and D1, tens of rays for S2, T2
constexpr int threads_of(Mode mode) {
  return mode == Mode::kIntegrate || mode == Mode::kDisk ? 128 : 32;
}

// the same as a constant, which device code may read
template <Mode kMode>
constexpr int kThreadsOf = threads_of(kMode);

// The resident blocks per SM that __launch_bounds__ asks ptxas to fit in
// G1: 7 of float (at most 72 registers; left to itself ptxas takes 64 and
// spills 52 bytes a thread), 4 of double (the 128 registers it takes
// anyway).  chip_smoke.py fails on any spill here: lower the count then.
// S2 and T2 ask for one; D1, with its disk state beside G1s's, 5 of float
// and 3 of double.  The mass-function chart, whose pre-step copy sits in
// shared memory, asks G1r for 10 of float and 5 of double, D2 for 8 and 4:
// the most that fit without a spill; the Carter chart's longer evaluation
// G1d for 6 and 3, D3 for 5 and 3.
template <typename T, Chart kChart, Mode kMode>
constexpr int min_blocks() {
  if constexpr (kChart == Chart::kKdS) {
    if constexpr (kMode == Mode::kDisk) return sizeof(T) == 8 ? 3 : 5;
    if constexpr (kMode == Mode::kIntegrate) return sizeof(T) == 8 ? 3 : 6;
    return 1;
  }
  if constexpr (kChart == Chart::kKSMass) {
    if constexpr (kMode == Mode::kDisk) return sizeof(T) == 8 ? 4 : 8;
    if constexpr (kMode == Mode::kIntegrate) return sizeof(T) == 8 ? 5 : 10;
    return 1;
  }
  if constexpr (kMode == Mode::kDisk) return sizeof(T) == 8 ? 3 : 5;
  if constexpr (kMode != Mode::kIntegrate) return 1;
  return sizeof(T) == 8 ? 4 : 7;
}

__device__ __forceinline__ void sincos_t(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// In the static chart `a` holds the lapse constant k and `charge` the
// family code, which `family` carries as an int; in the mass-function chart
// `charge` holds k and `jump_cap` the family code; in the Carter chart
// `charge` holds L = Lambda / 3 and chi2 the per-ray (1 + L a^2)^2.
template <typename T>
struct Scalars {
  T mass, a, charge, r_cap, r_max, r_plus, plunge_zone, jump_cap, cap_park,
      err_park;
  int family;
  T chi2;
};

// dH/dq on the kicked rows and dH/dp on all four: kick[0..2] is
// subtracted scaled by dt from rows 1..K of the kicked momenta, drift[0..3]
// added scaled by dt to the drifted position.  The Kerr-Schild-like charts
// keep H and l at the metric point beside them: the guard reads those of
// the step's last flow A, formed at the very q1 it tests (the other charts
// leave them unset and unread).
template <typename T>
struct KickDrift {
  T kick[3];
  T drift[4];
  T H, lx, ly, lz;
};

// kerr_bl._kick_drift: (k_r, k_th) and the drift at (r, theta)
template <typename T>
__device__ __forceinline__ KickDrift<T> kick_drift_bl(T r, T th, T pt, T pr,
                                                      T pth, T pph,
                                                      const Scalars<T>& sc) {
  const T a = sc.a;
  const T mass = sc.mass;
  // kerr_bl._geom
  T sin_th, cos_th;
  sincos_t(th, &sin_th, &cos_th);
  const T sin2 = sin_th * sin_th;
  const T rr = r * r;
  const T sigma = rr + a * a * cos_th * cos_th;
  const T delta = rr - T(2) * mass * r + a * a + sc.charge * sc.charge;
  const T w = rr + a * a;
  const T inv_sd = T(1) / (sigma * delta);
  const T n_tt = w * w - a * a * delta * sin2;
  const T n_tp = w - delta;
  const T n_pp = delta - a * a * sin2;
  const T g_tt = -n_tt * inv_sd;
  const T g_tp = -n_tp * a * inv_sd;
  const T g_rr = delta / sigma;
  const T g_thth = T(1) / sigma;
  const T g_pp = n_pp * inv_sd / sin2;

  const T two_r = T(2) * r;
  const T sc2 = T(2) * sin_th * cos_th;
  const T sig_th = -a * a * sc2;
  const T del_r = two_r - T(2) * mass;
  const T q_r = (two_r * delta + sigma * del_r) * inv_sd;
  const T q_th = sig_th * delta * inv_sd;

  const T tt_r =
      -(T(2) * w * two_r - a * a * del_r * sin2 - n_tt * q_r) * inv_sd;
  const T tt_th = -(-a * a * delta * sc2 - n_tt * q_th) * inv_sd;
  const T tp_r = -(T(2) * mass - n_tp * q_r) * a * inv_sd;
  const T tp_th = n_tp * q_th * a * inv_sd;
  const T inv_sin2 = T(1) / sin2;
  const T rr_r = (del_r - g_rr * two_r) * g_thth;
  const T rr_th = -(g_rr * sig_th) * g_thth;
  const T hh_r = -(g_thth * two_r) * g_thth;
  const T hh_th = -(g_thth * sig_th) * g_thth;
  const T pp_r = (del_r - n_pp * q_r) * inv_sd * inv_sin2;
  const T pp_th = (sig_th - n_pp * q_th) * inv_sd * inv_sin2
                  - T(2) * g_pp * cos_th * sin_th * inv_sin2;

  const T ptpt = pt * pt;
  const T ptpp = pt * pph;
  const T prpr = pr * pr;
  const T phph = pth * pth;
  const T pppp = pph * pph;
  KickDrift<T> k;
  k.kick[0] = T(0.5) * (tt_r * ptpt + T(2) * tp_r * ptpp + rr_r * prpr
                        + hh_r * phph + pp_r * pppp);
  k.kick[1] = T(0.5) * (tt_th * ptpt + T(2) * tp_th * ptpp + rr_th * prpr
                        + hh_th * phph + pp_th * pppp);
  k.kick[2] = T(0);  // unused: the chart has no third kicked row
  k.drift[0] = g_tt * pt + g_tp * pph;
  k.drift[1] = g_rr * pr;
  k.drift[2] = g_thth * pth;
  k.drift[3] = g_tp * pt + g_pp * pph;
  return k;
}

// kds_chart._kick_drift: (k_r, k_th) and the drift at (r, theta), kerr_bl's
// association with Delta_th (dth), chi^2 / Delta_th (kf) and Lambda / 3
// (L) inserted
template <typename T>
__device__ __forceinline__ KickDrift<T> kick_drift_kds(T r, T th, T pt, T pr,
                                                       T pth, T pph,
                                                       const Scalars<T>& sc) {
  const T a = sc.a;
  const T mass = sc.mass;
  const T lam3 = sc.charge;
  T sin_th, cos_th;
  sincos_t(th, &sin_th, &cos_th);
  const T sin2 = sin_th * sin_th;
  const T rr = r * r;
  const T ac2 = a * a * cos_th * cos_th;
  const T sigma = rr + ac2;
  const T w = rr + a * a;
  const T delta = rr - T(2) * mass * r + a * a - lam3 * rr * w;
  const T dth = T(1) + lam3 * ac2;
  const T inv_dth = T(1) / dth;
  const T kf = sc.chi2 * inv_dth;
  const T inv_sig = T(1) / sigma;
  const T inv_sd = T(1) / (sigma * delta);
  const T n_tt = w * w * dth - a * a * delta * sin2;
  const T n_tp = w * dth - delta;
  const T n_pp = delta - a * a * sin2 * dth;
  const T g_tt = -n_tt * inv_sd * kf;
  const T g_tp = -n_tp * a * inv_sd * kf;
  const T g_rr = delta / sigma;
  const T g_thth = dth * inv_sig;
  const T g_pp = n_pp * inv_sd * kf / sin2;

  const T two_r = T(2) * r;
  const T lam_x = lam3 * two_r;
  const T sc2 = T(2) * sin_th * cos_th;
  const T sig_th = -a * a * sc2;
  const T e_th = lam3 * sig_th;
  const T del_r = two_r - T(2) * mass - lam_x * (w + rr);
  const T q_r = (two_r * delta + sigma * del_r) * inv_sd;
  const T q_th = sig_th * delta * inv_sd;
  const T q_thk = q_th + e_th * inv_dth;

  const T tt_r = -(T(2) * w * two_r * dth - a * a * del_r * sin2
                   - n_tt * q_r) * inv_sd * kf;
  const T tt_th = -(-a * a * delta * sc2 + w * w * e_th - n_tt * q_thk)
                  * inv_sd * kf;
  const T ntp_r = T(2) * mass + lam_x * (ac2 + w + rr);
  const T tp_r = -(ntp_r - n_tp * q_r) * a * inv_sd * kf;
  const T tp_th = (n_tp * q_thk - w * e_th) * a * inv_sd * kf;
  const T inv_sin2 = T(1) / sin2;
  const T rr_r = (del_r - g_rr * two_r) * inv_sig;
  const T rr_th = -(g_rr * sig_th) * inv_sig;
  const T hh_r = -(g_thth * two_r) * inv_sig;
  const T hh_th = (e_th - g_thth * sig_th) * inv_sig;
  const T pp_r = (del_r - n_pp * q_r) * inv_sd * kf * inv_sin2;
  const T pp_th = (sig_th * dth - a * a * sin2 * e_th - n_pp * q_thk)
                      * inv_sd * kf * inv_sin2
                  - T(2) * g_pp * cos_th * sin_th * inv_sin2;

  const T ptpt = pt * pt;
  const T ptpp = pt * pph;
  const T prpr = pr * pr;
  const T phph = pth * pth;
  const T pppp = pph * pph;
  KickDrift<T> k;
  k.kick[0] = T(0.5) * (tt_r * ptpt + T(2) * tp_r * ptpp + rr_r * prpr
                        + hh_r * phph + pp_r * pppp);
  k.kick[1] = T(0.5) * (tt_th * ptpt + T(2) * tp_th * ptpp + rr_th * prpr
                        + hh_th * phph + pp_th * pppp);
  k.kick[2] = T(0);  // unused: the chart has no third kicked row
  k.drift[0] = g_tt * pt + g_tp * pph;
  k.drift[1] = g_rr * pr;
  k.drift[2] = g_thth * pth;
  k.drift[3] = g_tp * pt + g_pp * pph;
  return k;
}

// static_chart.lapse: f and f' at r, and 1 / r
template <typename T>
__device__ __forceinline__ void lapse_static(T r, const Scalars<T>& sc, T& f,
                                             T& fp, T& inv_r) {
  const T m2 = T(2) * sc.mass;
  const T k = sc.a;
  inv_r = T(1) / r;
  const T rr = r * r;
  if (sc.family == 0) {  // Kottler
    f = T(1) - m2 * inv_r - k * rr;
    fp = m2 * inv_r * inv_r - T(2) * k * r;
  } else if (sc.family == 1) {  // Bardeen
    const T x = rr + k;
    const T x15 = x * sqrt_t(x);
    f = T(1) - m2 * rr / x15;
    fp = m2 * r * (rr - T(2) * k) / (x15 * x);
  } else {  // Hayward
    const T r3 = rr * r;
    const T d = r3 + k;
    f = T(1) - m2 * rr / d;
    fp = m2 * r * (r3 - T(2) * k) / (d * d);
  }
}

// static_chart._kick_drift: (k_r, k_th) and the drift at (r, theta)
template <typename T>
__device__ __forceinline__ KickDrift<T> kick_drift_static(T r, T th, T pt,
                                                          T pr, T pth, T pph,
                                                          const Scalars<T>& sc) {
  T f, fp, inv_r;
  lapse_static(r, sc, f, fp, inv_r);
  T sin_th, cos_th;
  sincos_t(th, &sin_th, &cos_th);
  const T sin2 = sin_th * sin_th;
  const T inv_f = T(1) / f;
  const T inv_sin2 = T(1) / sin2;
  const T g_hh = inv_r * inv_r;
  const T g_pp = g_hh * inv_sin2;

  const T tt_r = fp * inv_f * inv_f;
  const T hh_r = T(-2) * g_hh * inv_r;
  const T pp_r = hh_r * inv_sin2;
  const T pp_th = T(-2) * g_pp * cos_th * sin_th * inv_sin2;

  const T pppp = pph * pph;
  KickDrift<T> k;
  k.kick[0] = T(0.5) * (tt_r * (pt * pt) + fp * (pr * pr)
                        + hh_r * (pth * pth) + pp_r * pppp);
  k.kick[1] = T(0.5) * (pp_th * pppp);
  k.kick[2] = T(0);  // unused: the chart has no third kicked row
  k.drift[0] = -inv_f * pt;
  k.drift[1] = f * pr;
  k.drift[2] = g_hh * pth;
  k.drift[3] = g_pp * pph;
  return k;
}

// Kerr-Schild geometry at one spatial point (kerr_schild._geom; with the
// mass function's H and N' = d(m r)/dr in the mass-function chart,
// rotating_chart._geom)
template <typename T>
struct Geom {
  T r, inv_r, inv_D, b, w, inv_w, H, lx, ly, lz, dn;
};

// rotating_chart.mass_function: m(r), and N' = m + 3 m k / X
template <typename T>
__device__ __forceinline__ void mass_fn(T r, const Scalars<T>& sc, T& m,
                                        T& dn) {
  const T k = sc.charge;
  const T rr = r * r;
  T x;
  if (sc.family == 1) {  // rotating Bardeen, k = g^2
    x = rr + k;
    const T u = r / sqrt_t(x);
    m = sc.mass * (u * u * u);
  } else {  // rotating Hayward, k = 2 M l^2
    const T r3 = rr * r;
    x = r3 + k;
    m = sc.mass * (r3 / x);
  }
  dn = m + T(3) * m * k / x;
}

template <Chart kChart, typename T>
__device__ __forceinline__ Geom<T> geom_ks(T x, T y, T z,
                                           const Scalars<T>& sc) {
  Geom<T> g;
  const T a = sc.a;
  const T rho2 = x * x + y * y + z * z;
  g.b = rho2 - a * a;
  const T az = a * z;
  const T s = sqrt_t(g.b * g.b + T(4) * az * az);
  const T r2 = T(0.5) * (g.b + s);
  g.r = sqrt_t(r2);
  g.inv_r = T(1) / g.r;
  g.inv_D = T(1) / s;
  g.w = r2 + a * a;
  g.inv_w = T(1) / g.w;
  if constexpr (kChart == Chart::kKSMass) {
    T m;
    mass_fn(g.r, sc, m, g.dn);
    g.H = m * g.r * g.inv_D;
  } else {
    g.H = (sc.mass * g.r - T(0.5) * sc.charge * sc.charge) * g.inv_D;
    g.dn = sc.mass;
  }
  g.lx = (g.r * x + a * y) * g.inv_w;
  g.ly = (g.r * y - a * x) * g.inv_w;
  g.lz = z * g.inv_r;
  return g;
}

// kerr_schild._kick_drift (rotating_chart._kick_drift in the mass-function
// chart, N' in the place of M): (kx, ky, kz) and the drift at (x, y, z)
template <Chart kChart, typename T>
__device__ __forceinline__ KickDrift<T> kick_drift_ks(T x, T y, T z, T pt,
                                                      T px, T py, T pz,
                                                      const Scalars<T>& sc) {
  const Geom<T> g = geom_ks<kChart>(x, y, z, sc);
  const T a = sc.a;
  const T S = -pt + g.lx * px + g.ly * py + g.lz * pz;
  const T HS2 = T(2) * g.H * S;
  KickDrift<T> k;
  k.drift[0] = -pt + HS2;
  k.drift[1] = px - HS2 * g.lx;
  k.drift[2] = py - HS2 * g.ly;
  k.drift[3] = pz - HS2 * g.lz;

  const T r_x = x * g.r * g.inv_D;
  const T r_y = y * g.r * g.inv_D;
  const T r_z = z * g.w * g.inv_r * g.inv_D;
  const T D_x = T(2) * x * g.b * g.inv_D;
  const T D_y = T(2) * y * g.b * g.inv_D;
  const T D_z = T(2) * z * (g.b + T(2) * a * a) * g.inv_D;

  const T H_x = (g.dn * r_x - g.H * D_x) * g.inv_D;
  const T H_y = (g.dn * r_y - g.H * D_y) * g.inv_D;
  const T H_z = (g.dn * r_z - g.H * D_z) * g.inv_D;

  const T inv_r2 = g.inv_r * g.inv_r;
  const T G = (x * px + y * py - T(2) * g.r * (g.lx * px + g.ly * py))
                  * g.inv_w
              - z * pz * inv_r2;
  const T S_x = r_x * G + (g.r * px - a * py) * g.inv_w;
  const T S_y = r_y * G + (a * px + g.r * py) * g.inv_w;
  const T S_z = r_z * G + pz * g.inv_r;

  const T S2 = S * S;
  k.kick[0] = -H_x * S2 - HS2 * S_x;
  k.kick[1] = -H_y * S2 - HS2 * S_y;
  k.kick[2] = -H_z * S2 - HS2 * S_z;
  k.H = g.H;
  k.lx = g.lx;
  k.ly = g.ly;
  k.lz = g.lz;
  return k;
}

// kerr_schild.ks_radius_c
template <typename T>
__device__ __forceinline__ T ks_radius(T x, T y, T z, T a) {
  const T rho2 = x * x + y * y + z * z;
  const T b = rho2 - a * a;
  return sqrt_t(T(0.5) * (b + sqrt_t(b * b + T(4) * a * a * z * z)));
}

// A flow's kick/drift: the metric at the position copy Q with the momenta
// P_READ (flow A: Q = 0, P_READ = 12; flow B: Q = 8, P_READ = 4)
template <Chart kChart, int Q, int P_READ, typename T>
__device__ __forceinline__ KickDrift<T> kick_drift(const T (&s)[kRows],
                                                   const Scalars<T>& sc) {
  if constexpr (kChart == Chart::kBL) {
    return kick_drift_bl(s[Q + 1], s[Q + 2], s[P_READ + 0], s[P_READ + 1],
                         s[P_READ + 2], s[P_READ + 3], sc);
  } else if constexpr (kChart == Chart::kKdS) {
    return kick_drift_kds(s[Q + 1], s[Q + 2], s[P_READ + 0], s[P_READ + 1],
                          s[P_READ + 2], s[P_READ + 3], sc);
  } else if constexpr (kChart == Chart::kStatic) {
    return kick_drift_static(s[Q + 1], s[Q + 2], s[P_READ + 0],
                             s[P_READ + 1], s[P_READ + 2], s[P_READ + 3], sc);
  } else {
    return kick_drift_ks<kChart>(s[Q + 1], s[Q + 2], s[Q + 3],
                                 s[P_READ + 0], s[P_READ + 1], s[P_READ + 2],
                                 s[P_READ + 3], sc);
  }
}

// A flow applied with its kick/drift k: kick the momenta P_KICK and drift
// the position Q_DRIFT by dt (flow A: P_KICK = 4, Q_DRIFT = 8; flow B:
// P_KICK = 12, Q_DRIFT = 0).  Boyer-Lindquist kicks rows r and theta,
// the Kerr-Schild charts x, y and z; p_t (and p_phi in BL and the static
// chart) stay exact invariants.
template <Chart kChart, int P_KICK, int Q_DRIFT, typename T>
__device__ __forceinline__ void apply(T (&s)[kRows], const KickDrift<T>& k,
                                      T dt) {
  constexpr int kKicked = kKSLike<kChart> ? 3 : 2;
#pragma unroll
  for (int m = 0; m < kKicked; ++m) {
    s[P_KICK + 1 + m] = s[P_KICK + 1 + m] - dt * k.kick[m];
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    s[Q_DRIFT + m] = s[Q_DRIFT + m] + dt * k.drift[m];
  }
}

// Flow A's kick/drift, at q1 with the momenta p2
template <Chart kChart, typename T>
__device__ __forceinline__ KickDrift<T> kick_drift_a(const T (&s)[kRows],
                                                     const Scalars<T>& sc) {
  return kick_drift<kChart, 0, 12>(s, sc);
}

// Flow B (the metric at q2 with the momenta p1; kick p2, drift q1)
template <Chart kChart, typename T>
__device__ __forceinline__ void flow_b(T (&s)[kRows], T dt,
                                       const Scalars<T>& sc) {
  apply<kChart, 12, 0>(s, kick_drift<kChart, 8, 4>(s, sc), dt);
}

// hamiltonian._flow_mixed: the rotation between the copies, cos/sin form
template <typename T>
__device__ __forceinline__ void flow_mixed(T (&s)[kRows], T cw, T sw) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const T q1 = s[m], p1 = s[4 + m], q2 = s[8 + m], p2 = s[12 + m];
    const T q_sum = q1 + q2;
    const T q_dif = q1 - q2;
    const T p_sum = p1 + p2;
    const T p_dif = p1 - p2;
    s[m] = T(0.5) * (q_sum + q_dif * cw + p_dif * sw);
    s[4 + m] = T(0.5) * (p_sum + p_dif * cw - q_dif * sw);
    s[8 + m] = T(0.5) * (q_sum - q_dif * cw - p_dif * sw);
    s[12 + m] = T(0.5) * (p_sum - p_dif * cw + q_dif * sw);
  }
}

// One composed step: per substep A(d/2) B(d/2) M B(d/2) A(d/2).  Flow A
// reads q1 and p2 and writes neither, and nothing else runs between one
// flow A and the next, so each flow A takes the kick/drift `ka` that the
// one before it formed (the launch's, on the first step) and each
// substep's last flow A forms the next one's.  Every flow is still applied
// by itself, with its own dt.
template <Chart kChart, typename T>
__device__ __forceinline__ void composed(T (&s)[kRows], KickDrift<T>& ka,
                                         const T* subs, int n_sub,
                                         const Scalars<T>& sc) {
  for (int j = 0; j < n_sub; ++j) {
    const T half = T(0.5) * __ldg(subs + 3 * j);
    const T cw = __ldg(subs + 3 * j + 1);
    const T sw = __ldg(subs + 3 * j + 2);
    apply<kChart, 4, 8>(s, ka, half);
    flow_b<kChart>(s, half, sc);
    flow_mixed(s, cw, sw);
    flow_b<kChart>(s, half, sc);
    ka = kick_drift_a<kChart>(s, sc);
    apply<kChart, 4, 8>(s, ka, half);
  }
}

template <typename T>
__device__ __forceinline__ bool finite_q1p1(const T (&s)[kRows]) {
  bool finite = true;
#pragma unroll
  for (int m = 0; m < 8; ++m) finite = finite && isfinite(s[m]);
  return finite;
}

// The pre-step domain test; r_b is the chart radius the guard reads: q1's
// r in the spherical charts, and in the Kerr-Schild-like ones q1's
// ks_radius, which the caller carries in r_b from the guard of the step
// before (from the launch on the first step)
template <Chart kChart, typename T>
__device__ __forceinline__ bool active(const T (&s)[kRows],
                                       const Scalars<T>& sc, T& r_b) {
  if constexpr (!kKSLike<kChart>) {
    r_b = s[1];
    return (s[1] > sc.r_cap) && (s[1] < sc.r_max);
  } else {
    const T rho = sqrt_t(s[1] * s[1] + s[2] * s[2] + s[3] * s[3]);
    return (r_b > sc.r_cap) && (rho < sc.r_max);
  }
}

// A thread's column of the pre-step copy in shared memory (the
// Kerr-Schild-like charts): row m at col[m * threads], so a warp's
// accesses to one row are 32 consecutive words
template <typename T, Chart kChart, Mode kMode>
struct SharedRows {
  T* col;

  __device__ __forceinline__ SharedRows() : col(column()) {}

  __device__ __forceinline__ static T* column() {
    __shared__ T saved[kRows][kThreadsOf<kMode>];
    return &saved[0][threadIdx.x];
  }

  __device__ __forceinline__ T& operator[](int m) const {
    return col[m * kThreadsOf<kMode>];
  }
};

// The pre-step copy: in registers in the spherical charts, in shared
// memory in the Kerr-Schild-like ones, whose heavier step needs the
// registers (fantasy_ks.cu's layout)
template <typename T, Chart kChart, Mode kMode>
using PreStep = std::conditional_t<kKSLike<kChart>,
                                   SharedRows<T, kChart, kMode>, T[kRows]>;

// The blow-up guard after a step from `old` (chart radius r_b) to s, whose
// last flow A formed ka: true if it reverted s to old and parked q1.  In
// the Kerr-Schild-like charts it leaves the post-step q1's ks_radius in r_b
// where it passes the step
template <Chart kChart, typename T, typename Old>
__device__ __forceinline__ bool guard(T (&s)[kRows], const Old& old,
                                      T& r_b, const KickDrift<T>& ka,
                                      const Scalars<T>& sc) {
  const bool finite = finite_q1p1(s);
  bool exploded;
  bool crossed;
  bool inward;
  T r_new = T(0);
  if constexpr (!kKSLike<kChart>) {
    exploded = !finite || abs_t(s[1] - r_b) > sc.jump_cap
               || abs_t(s[2] - old[2]) > T(1.5);
    crossed = finite && s[1] < sc.r_plus && !exploded;
    inward = old[5] < T(0);
  } else {
    // the null invariant at the post-step (q1, p1) (kerr_schild.
    // hamiltonian_ks), from the H and l that the step's last flow A formed
    // at that q1 (flow A moves only p1 and q2); a step that is not finite
    // parks whatever h is
    const T pt = s[4];
    const T px = s[5];
    const T py = s[6];
    const T pz = s[7];
    const T S = -pt + ka.lx * px + ka.ly * py + ka.lz * pz;
    const T h = T(0.5) * (-pt * pt + px * px + py * py + pz * pz)
                - ka.H * S * S;
    const T p2 = px * px + py * py + pz * pz + T(1);
    exploded = !finite || abs_t(h) > T(3e-2) * p2;
    r_new = ks_radius(s[1], s[2], s[3], sc.a);
    crossed = finite && r_new < sc.r_plus && !exploded;
    inward = (old[1] * old[5] + old[2] * old[6] + old[3] * old[7]) < T(0);
  }
  const bool capture =
      crossed || (exploded && (inward || r_b < sc.plunge_zone));
  if (!(exploded || crossed)) {
    if constexpr (kKSLike<kChart>) r_b = r_new;
    return false;
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) s[m] = old[m];
  if constexpr (!kKSLike<kChart>) {
    s[1] = capture ? sc.cap_park : sc.err_park;
  } else {
    s[1] = capture ? T(0) : sc.err_park;
    s[2] = T(0);
    s[3] = capture ? sc.cap_park : T(0);
  }
  return true;
}

// D1's u = c1 cos phi + c2 sin phi of the disk-plane linear form
template <typename T>
__device__ __forceinline__ T disk_form(T phi, T c1, T c2) {
  T sin_ph, cos_ph;
  sincos_t(phi, &sin_ph, &cos_ph);
  return c1 * cos_ph + c2 * sin_ph;
}

// disk (n, 2) is D1's, hit_out (n,) D1's and D2's, unused (null) in the
// other modes
template <typename T, Chart kChart, Mode kMode>
__global__ void __launch_bounds__(threads_of(kMode),
                                  (min_blocks<T, kChart, kMode>()))
fantasy_gen_kernel(const T* __restrict__ q0, const T* __restrict__ p0,
                   T* __restrict__ out, int* __restrict__ ns_out,
                   const T* __restrict__ params, int n, int n_sub, int steps,
                   int stride, int n_keep,
                   const T* __restrict__ disk = nullptr,
                   int* __restrict__ hit_out = nullptr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T s[kRows];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    s[m] = q0[4 * static_cast<size_t>(i) + m];
    s[4 + m] = p0[4 * static_cast<size_t>(i) + m];
    s[8 + m] = s[m];
    s[12 + m] = s[4 + m];
  }
  Scalars<T> sc;
  sc.mass = __ldg(params + 0);
  sc.a = __ldg(params + 1);
  sc.charge = __ldg(params + 2);
  sc.r_cap = __ldg(params + 3);
  sc.r_max = __ldg(params + 4);
  sc.r_plus = __ldg(params + 5);
  sc.plunge_zone = __ldg(params + 6);
  sc.jump_cap = __ldg(params + 7);
  sc.cap_park = __ldg(params + 8);
  sc.err_park = __ldg(params + 9);
  sc.family = static_cast<int>(kChart == Chart::kKSMass ? sc.jump_cap
                                                        : sc.charge);
  if constexpr (kChart == Chart::kKdS) {
    const T chi = T(1) + sc.charge * sc.a * sc.a;
    sc.chi2 = chi * chi;
  }
  const T* subs = params + kScal;

  if constexpr (kMode == Mode::kTrace) {
    // T2: every step taken, (q1, p1) stored after each
    T* rec = out + static_cast<size_t>(i) * static_cast<size_t>(steps) * 8;
    KickDrift<T> ka = kick_drift_a<kChart>(s, sc);  // flow A's, carried
    for (int k = 0; k < steps; ++k) {
      composed<kChart>(s, ka, subs, n_sub, sc);
#pragma unroll
      for (int m = 0; m < 8; ++m) rec[m] = s[m];
      rec += 8;
    }
    return;
  }

  T* row = out;
  if constexpr (kMode == Mode::kRecord) {
    row += static_cast<size_t>(i) * static_cast<size_t>(n_keep) * 4;
  }
  int next_store = 0;  // S2: the next step whose q1 is recorded
  int ns = 0;
  // D1: the ray's plane constants, the annulus, the carried pre-step u
  // (D3: the carried pre-step cos theta) and the crossing record
  T c1 = T(0), c2 = T(0), r_in = T(0), r_out = T(0), u0 = T(0);
  T hit[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  int was_hit = 0;
  if constexpr (kMode == Mode::kDisk) {
    r_in = __ldg(subs + 3 * n_sub);
    r_out = __ldg(subs + 3 * n_sub + 1);
    if constexpr (kChart == Chart::kStatic) {
      c1 = disk[2 * static_cast<size_t>(i)];
      c2 = disk[2 * static_cast<size_t>(i) + 1];
      u0 = disk_form(s[3], c1, c2);
    }
    if constexpr (kChart == Chart::kKdS) {
      T sin_th;
      sincos_t(s[2], &sin_th, &u0);
    }
  }
  KickDrift<T> ka = kick_drift_a<kChart>(s, sc);  // flow A's, carried
  // the Kerr-Schild-like charts carry q1's radius from each guard to the
  // next step's domain test (the launch's to the first)
  T r_b = T(0);
  if constexpr (kKSLike<kChart>) r_b = ks_radius(s[1], s[2], s[3], sc.a);
  for (int k = 0; k < steps; ++k) {
    if constexpr (kMode == Mode::kRecord) {
      if (k == next_store) {
#pragma unroll
        for (int m = 0; m < 4; ++m) row[m] = s[m];
        row += 4;
        next_store += stride;
      }
    }
    if (!active<kChart>(s, sc, r_b)) break;
    PreStep<T, kChart, kMode> old;
#pragma unroll
    for (int m = 0; m < kRows; ++m) old[m] = s[m];
    composed<kChart>(s, ka, subs, n_sub, sc);
    const bool parked = guard<kChart>(s, old, r_b, ka, sc);
    ++ns;
    if constexpr (kMode == Mode::kDisk && kChart == Chart::kStatic) {
      if (!parked) {
        const T u1 = disk_form(s[3], c1, c2);
        if (u0 * u1 < T(0)) {
          const T t = u0 / (u0 - u1);
          const T r_hit = old[1] + t * (s[1] - old[1]);
          if (r_hit >= r_in && r_hit <= r_out) {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              hit[m] = old[m] + t * (s[m] - old[m]);
              hit[4 + m] = old[12 + m] + t * (s[12 + m] - old[12 + m]);
            }
            was_hit = 1;
            break;
          }
        }
        u0 = u1;
      }
    }
    if constexpr (kMode == Mode::kDisk && kChart == Chart::kKSMass) {
      // D2: the equatorial crossing, z changing sign within the step
      if (!parked && old[3] * s[3] < T(0)) {
        const T t = old[3] / (old[3] - s[3]);
        T cq[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) cq[m] = old[m] + t * (s[m] - old[m]);
        const T r_hit = ks_radius(cq[1], cq[2], cq[3], sc.a);
        if (r_hit >= r_in && r_hit <= r_out) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            hit[m] = cq[m];
            hit[4 + m] = old[12 + m] + t * (s[12 + m] - old[12 + m]);
          }
          was_hit = 1;
          break;
        }
      }
    }
    if constexpr (kMode == Mode::kDisk && kChart == Chart::kKdS) {
      // D3: the equatorial crossing, cos theta changing sign within the step
      if (!parked) {
        T sin_th, u1;
        sincos_t(s[2], &sin_th, &u1);
        if (u0 * u1 < T(0)) {
          const T t = u0 / (u0 - u1);
          T cq[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) cq[m] = old[m] + t * (s[m] - old[m]);
          if (cq[1] >= r_in && cq[1] <= r_out) {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              hit[m] = cq[m];
              hit[4 + m] = old[12 + m] + t * (s[12 + m] - old[12 + m]);
            }
            was_hit = 1;
            break;
          }
        }
        u0 = u1;
      }
    }
    if (parked) {
      if constexpr (kMode == Mode::kRecord) {
        // every park point lies outside the domain (cap_park inside r_cap,
        // err_park beyond r_max), so the next step's domain test would stop
        // the ray: what is left is its record of the park point
        if (k + 1 < steps && k + 1 == next_store) {
#pragma unroll
          for (int m = 0; m < 4; ++m) row[m] = s[m];
        }
      } else {
        ns = -ns;  // the park flag rides in the sign
      }
      break;
    }
  }
  ns_out[i] = ns;
  if constexpr (kMode == Mode::kIntegrate) {
    const size_t stride_n = static_cast<size_t>(n);
#pragma unroll
    for (int m = 0; m < 12; ++m) out[m * stride_n + i] = s[m];
  }
  if constexpr (kMode == Mode::kDisk) {
    const size_t stride_n = static_cast<size_t>(n);
#pragma unroll
    for (int m = 0; m < 8; ++m) out[m * stride_n + i] = s[m];
#pragma unroll
    for (int m = 0; m < 8; ++m) out[(8 + m) * stride_n + i] = hit[m];
    if constexpr (kChart == Chart::kKSMass || kChart == Chart::kKdS) {
      // D2, D3: q2, whose rows the host's rescue reads
#pragma unroll
      for (int m = 0; m < 4; ++m) out[(16 + m) * stride_n + i] = s[8 + m];
    }
    hit_out[i] = was_hit;
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <typename T, Chart kChart, Mode kMode>
int launch(const T* q0, const T* p0, T* out, int* ns_out, const T* params,
           int n, int n_sub, int steps, int stride, int n_keep,
           void* stream, const T* disk = nullptr, int* hit_out = nullptr) {
  if (n <= 0) return 0;
  constexpr int kThreads = threads_of(kMode);
  const int blocks = (n + kThreads - 1) / kThreads;
  fantasy_gen_kernel<T, kChart, kMode>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          q0, p0, out, ns_out, params, n, n_sub, steps, stride, n_keep, disk,
          hit_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G1: (q0, p0, out (12, n), ns_out, params, n, n_sub, steps, stream)
extern "C" int grt_fantasy_gen_bl_f32_launch(const float* q0, const float* p0,
                                             float* out, int* ns_out,
                                             const float* params, int n,
                                             int n_sub, int steps,
                                             void* stream) {
  return launch<float, Chart::kBL, Mode::kIntegrate>(
      q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream);
}

extern "C" int grt_fantasy_gen_bl_f64_launch(const double* q0,
                                             const double* p0, double* out,
                                             int* ns_out,
                                             const double* params, int n,
                                             int n_sub, int steps,
                                             void* stream) {
  return launch<double, Chart::kBL, Mode::kIntegrate>(
      q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream);
}

// G1s: G1's signature, the static chart's vector
#define GRT_G1S_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* q0, const T* p0, T* out, int* ns_out,        \
                      const T* params, int n, int n_sub, int steps,         \
                      void* stream) {                                       \
    return launch<T, Chart::kStatic, Mode::kIntegrate>(                     \
        q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream);        \
  }

GRT_G1S_ENTRY(grt_fantasy_gen_static_f32_launch, float)
GRT_G1S_ENTRY(grt_fantasy_gen_static_f64_launch, double)
#undef GRT_G1S_ENTRY

// G1r: G1's signature, the mass-function chart's vector
#define GRT_G1R_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* q0, const T* p0, T* out, int* ns_out,        \
                      const T* params, int n, int n_sub, int steps,         \
                      void* stream) {                                       \
    return launch<T, Chart::kKSMass, Mode::kIntegrate>(                     \
        q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream);        \
  }

GRT_G1R_ENTRY(grt_fantasy_gen_rot_f32_launch, float)
GRT_G1R_ENTRY(grt_fantasy_gen_rot_f64_launch, double)
#undef GRT_G1R_ENTRY

// G1d: G1's signature, the Carter chart's vector
#define GRT_G1D_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* q0, const T* p0, T* out, int* ns_out,        \
                      const T* params, int n, int n_sub, int steps,         \
                      void* stream) {                                       \
    return launch<T, Chart::kKdS, Mode::kIntegrate>(                        \
        q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream);        \
  }

GRT_G1D_ENTRY(grt_fantasy_gen_kds_f32_launch, float)
GRT_G1D_ENTRY(grt_fantasy_gen_kds_f64_launch, double)
#undef GRT_G1D_ENTRY

// D1: (q0, p0, disk (n, 2), out (16, n), ns_out, hit_out, params, n, n_sub,
// steps, stream); params ends with r_in, r_out after the substeps
#define GRT_D1_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* q0, const T* p0, const T* disk, T* out,      \
                      int* ns_out, int* hit_out, const T* params, int n,    \
                      int n_sub, int steps, void* stream) {                 \
    return launch<T, Chart::kStatic, Mode::kDisk>(                          \
        q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream, disk,   \
        hit_out);                                                           \
  }

GRT_D1_ENTRY(grt_fantasy_gen_disk_static_f32_launch, float)
GRT_D1_ENTRY(grt_fantasy_gen_disk_static_f64_launch, double)
#undef GRT_D1_ENTRY

// D2: D1's signature, the disk argument unused (null); params ends with
// r_in, r_out after the substeps
#define GRT_D2_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* q0, const T* p0, const T* disk, T* out,      \
                      int* ns_out, int* hit_out, const T* params, int n,    \
                      int n_sub, int steps, void* stream) {                 \
    (void)disk;                                                             \
    return launch<T, Chart::kKSMass, Mode::kDisk>(                          \
        q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream,         \
        nullptr, hit_out);                                                  \
  }

GRT_D2_ENTRY(grt_fantasy_gen_disk_rot_f32_launch, float)
GRT_D2_ENTRY(grt_fantasy_gen_disk_rot_f64_launch, double)
#undef GRT_D2_ENTRY

// D3: D2's signature in the Carter chart
#define GRT_D3_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* q0, const T* p0, const T* disk, T* out,      \
                      int* ns_out, int* hit_out, const T* params, int n,    \
                      int n_sub, int steps, void* stream) {                 \
    (void)disk;                                                             \
    return launch<T, Chart::kKdS, Mode::kDisk>(                             \
        q0, p0, out, ns_out, params, n, n_sub, steps, 1, 0, stream,         \
        nullptr, hit_out);                                                  \
  }

GRT_D3_ENTRY(grt_fantasy_gen_disk_kds_f32_launch, float)
GRT_D3_ENTRY(grt_fantasy_gen_disk_kds_f64_launch, double)
#undef GRT_D3_ENTRY

// S2: (q0, p0, traj (n, n_keep, 4), ns_out, params, n, n_sub, steps,
// stride, n_keep, stream)
#define GRT_S2_ENTRY(NAME, T, CHART)                                         \
  extern "C" int NAME(const T* q0, const T* p0, T* traj, int* ns_out,       \
                      const T* params, int n, int n_sub, int steps,         \
                      int stride, int n_keep, void* stream) {               \
    return launch<T, CHART, Mode::kRecord>(q0, p0, traj, ns_out, params, n, \
                                           n_sub, steps, stride, n_keep,    \
                                           stream);                         \
  }

GRT_S2_ENTRY(grt_fantasy_gen_traj_bl_f32_launch, float, Chart::kBL)
GRT_S2_ENTRY(grt_fantasy_gen_traj_bl_f64_launch, double, Chart::kBL)
GRT_S2_ENTRY(grt_fantasy_gen_traj_ks_f32_launch, float, Chart::kKS)
GRT_S2_ENTRY(grt_fantasy_gen_traj_ks_f64_launch, double, Chart::kKS)
GRT_S2_ENTRY(grt_fantasy_gen_traj_static_f32_launch, float, Chart::kStatic)
GRT_S2_ENTRY(grt_fantasy_gen_traj_static_f64_launch, double, Chart::kStatic)
GRT_S2_ENTRY(grt_fantasy_gen_traj_rot_f32_launch, float, Chart::kKSMass)
GRT_S2_ENTRY(grt_fantasy_gen_traj_rot_f64_launch, double, Chart::kKSMass)
GRT_S2_ENTRY(grt_fantasy_gen_traj_kds_f32_launch, float, Chart::kKdS)
GRT_S2_ENTRY(grt_fantasy_gen_traj_kds_f64_launch, double, Chart::kKdS)
#undef GRT_S2_ENTRY

// T2: (q0, p0, out (n, steps, 8), params, n, n_sub, steps, stream)
#define GRT_T2_ENTRY(NAME, T, CHART)                                         \
  extern "C" int NAME(const T* q0, const T* p0, T* out, const T* params,    \
                      int n, int n_sub, int steps, void* stream) {          \
    return launch<T, CHART, Mode::kTrace>(q0, p0, out, nullptr, params, n,  \
                                          n_sub, steps, 1, 0, stream);      \
  }

GRT_T2_ENTRY(grt_fantasy_gen_trace_bl_f32_launch, float, Chart::kBL)
GRT_T2_ENTRY(grt_fantasy_gen_trace_bl_f64_launch, double, Chart::kBL)
GRT_T2_ENTRY(grt_fantasy_gen_trace_static_f32_launch, float, Chart::kStatic)
GRT_T2_ENTRY(grt_fantasy_gen_trace_static_f64_launch, double, Chart::kStatic)
GRT_T2_ENTRY(grt_fantasy_gen_trace_rot_f32_launch, float, Chart::kKSMass)
GRT_T2_ENTRY(grt_fantasy_gen_trace_rot_f64_launch, double, Chart::kKSMass)
GRT_T2_ENTRY(grt_fantasy_gen_trace_kds_f32_launch, float, Chart::kKdS)
GRT_T2_ENTRY(grt_fantasy_gen_trace_kds_f64_launch, double, Chart::kKdS)
#undef GRT_T2_ENTRY
#endif  // __CUDACC__
