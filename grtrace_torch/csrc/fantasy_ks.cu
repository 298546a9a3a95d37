// Kerr / Kerr-Newman FANTASY integrator in Cartesian Kerr-Schild
// coordinates: one CUDA thread per ray.
//
// Replaces the TPU kernel grtrace/engine/integrate_pallas_ks.py::
// _make_kernel_ks in plain mode (kernel B5; entry point
// integrate_batch_pallas_ks), in disk mode (kernel B6; entry point
// integrate_batch_pallas_disk) and in subring mode (kernel B7; entry point
// integrate_batch_pallas_subrings), in both of its layouts: 32 rows
// Kahan-compensated (the float32 production layout) and 16 rows plain (the
// float64 layout).  Its eager twins, which define what this kernel
// computes, are grtrace_torch/engine/integrate_ks.py::integrate_batch_ksc
// (32 rows) and ::integrate_batch_ks (16 rows), in disk mode
// ::integrate_batch_disk_ksc and ::integrate_batch_disk_ks, and in subring
// mode ::integrate_batch_subrings_ksc and ::integrate_batch_subrings_ks,
// built on the flows of grtrace_torch/physics/kerr_schild.py and the guard
// and crossing recorders of make_ks_step.  Its tangent modes (kernel B6t)
// carry one or two forward-mode tangents beside the 16-row disk mode; they
// replace no TPU kernel: the JAX package differentiates its XLA disk loop
// (grtrace/engine/disk.py::integrate_batch_disk) with jax.linearize.  Its
// twin is ::integrate_batch_disk_tangent_ks, on the flows' tangents of
// kerr_schild.py (_kick_drift_tan, open_ks_tan, core_ks_tan).
//
// What bounds it on an H100: FP32 (or FP64) issue rate and latency.  Each
// ray is a serial chain of about 700 floating-point operations per step at
// order 2 (three Kerr-Schild kick/drift evaluations, each with two square
// roots and three IEEE divisions, plus the guard), with no memory traffic
// inside the loop but the pre-step copy; rays exit after very different
// step counts (plungers early, escapers after ~4k steps, photon-shell
// winders when the guard parks them, disk hits at the plane).
//
// What the design does about it:
//  * one geometry per flow, one radius per step: the guard's invariant h is
//    formed from the H and S that the step's last flow A computed at the
//    very (q1, p2) the guard reads (flow A changes neither), and the radius
//    at the end of a step is carried as the next step's r_old (recomputed
//    only after a park); at order 2 a step takes 6 + 2 square roots and
//    9 divisions, where a fourth geometry and a second radius took 12 and 12;
//  * the pre-step copy that a revert and the crossing lerps need lives in
//    shared memory (one column per thread, conflict-free), not in
//    registers, so that more blocks fit on an SM: __launch_bounds__ asks
//    for the most that each instantiation's registers allow without a
//    spill (min_blocks below);
//  * a finished ray breaks out of its loop (the per-thread form of the
//    TPU kernel's masked steps and per-tile early exit), and the wrapper
//    sorts rays by their flat impact parameter's distance to the critical
//    ring (the TPU's _cost_sort_key_ks), so a warp's rays retire together.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// operation below rounds once, in the order written, exactly as the twins'
// torch ops do.  The association follows kerr_schild.py term by term
// ((2 a) a, 4 (a z)(a z) in geom against 4 a a z z in ks_radius, inv_r inv_r,
// ...); literals are of the ray type T (T(3e-2) is the float nearest 0.03,
// as torch rounds the Python scalar), since a double literal would promote
// a float expression and round it differently.  A plain step's p - dt k is
// written p + (-dt) k, which IEEE arithmetic makes the same value.
//
// Layout: state_in/state_out are SoA (n_rows, n), each row contiguous, so a
// warp's loads and stores are coalesced; rows 0..15 are q1, p1, q2, p2 in
// (t, x, y, z) order and rows 16..31 their deficits (true value s - c).
// params is the vector [M, a, Q, r_cap, r_max, plunge_zone, (d, cw, sw,
// bridge) x n_sub] built on the host by engine/integrate_ks.py::ks_params
// (cw is 1 - cos of the mixing angle in the compensated layout, cos in the
// plain one), followed in disk mode by [r_in, r_out].  ns_out (n,) int32
// counts the steps each ray took, negated if the guard parked it.
//
// Disk mode (Mode::kDisk): after a step that the guard accepts, the
// crossing of the equatorial plane is tested on the folded pre-step and new
// q1 z rows (z0 * z1 < 0, a product as in the twin); the crossing is lerped
// within the step on the (q1, p2) rows, b_old + t (b_new - b_old) with
// t = z0 / (z0 - z1), and a crossing at a Boyer-Lindquist radius inside
// [r_in, r_out] is recorded and ends the ray's loop (the per-thread form of
// the TPU kernel's frozen hit rays and its active & ~hit tile exit).  The
// closing half-A still runs.  rec_out is SoA (9, n): the hit flag as
// 1 / 0 in the ray type, hit_q (t, x, y, z), hit_p (t, x, y, z), stored at
// the hit; rays that never hit write zeros, as the TPU kernel's zero carry
// does.
//
// Subring mode (Mode::kSubring): the thin disk is transparent, so no ray
// freezes and the loop exits on the plain active test alone.  Every
// accepted step tests the same product z0 * z1 < 0; a crossing while fewer
// than n_orders have been recorded is lerped as in disk mode (t and the
// eight (q1, p2) rows) and stored at once to global memory, in slot cnt of
// rec_out (SoA
// (8 n_orders, n): slot s holds q (t, x, y, z) in rows 8 s .. 8 s + 3 and
// p in rows 8 s + 4 .. 8 s + 7); then cnt grows by one, on every crossing,
// so it counts the total winding.  n_orders is a runtime argument: the
// TPU kernel keeps every slot as a live tile, where a thread would need
// 8 n_orders registers at a runtime index (a local-memory array); a ray
// crosses the plane a handful of times, so the direct stores cost nothing
// next to the ~700 operations of a step.  The wrapper zero-fills rec_out
// (the TPU kernel's zero carry: unfilled slots are +0.0); cnt_out (n,)
// int32 is written once, at exit.
//
// Tangent modes (Mode::kDiskTangent, Mode::kDiskTangent2; 16 rows only):
// the disk mode carrying one or two forward-mode directions.  Each thread
// carries its ray's 16 rows and, per direction, their 16 tangent rows
// (tan_in, SoA (16 K, n), direction d in rows 16 d .. 16 d + 15).  Every
// flow evaluates its kick/drift once and applies its tangent expressions
// (kick_drift_tan, in the twin's order) to each direction in turn, while
// the rows' operations stay the disk mode's: the rows are bitwise B6's, and
// each direction's tangent rows bitwise those of a launch on that direction
// alone.  Only mass, a and charge carry a tangent (dparams, [d mass, d a,
// d charge] per direction).  A park reverts the tangent rows with the rows
// and zeroes its parked coordinates' tangents.  A hit differentiates the
// crossing: the lerp fraction, t_d = (z0_d - t (z0_d - z1_d)) / (z0 - z1),
// and each lerp; rec_d_out (8 K, n) gets per direction d hit_q (t, x, y,
// z), d hit_p (t, x, y, z), zeros where no ray hit.  The tangent leaves at
// the crossing, so the closing half-A runs on the rows alone.  The tangent
// rows and their pre-step copies live in shared memory, one column per
// thread (32 or 64 rows beside the rows' 16), in blocks of 64 threads, so
// that the registers hold the rows and one kick/drift with its tangent:
// the linearization of two parameters (engine/sensitivity.py) evaluates
// the geometry of a step once, where one launch per direction evaluated
// it twice and a separate primal launch a third time.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kRows = 16;
constexpr int kScal = 6;

// what the loop records besides the state: nothing (B5), the first
// equatorial crossing inside the annulus (B6), every crossing (B7), the
// first crossing and its forward-mode tangent in one or two directions
// (B6t)
enum class Mode : int { kPlain, kDisk, kSubring, kDiskTangent, kDiskTangent2 };

// the forward-mode directions a mode carries (constants, which device code
// may read)
template <Mode kMode>
constexpr int kDirsOf = kMode == Mode::kDiskTangent2 ? 2
                        : kMode == Mode::kDiskTangent ? 1 : 0;

// threads per block: 64 in the tangent modes, whose tangent rows take a
// block's shared memory, 128 in the others
template <Mode kMode>
constexpr int kThreadsOf = kDirsOf<kMode> ? 64 : 128;

// The resident blocks per SM that __launch_bounds__ asks ptxas to fit: the
// most each instantiation's registers allow without spilling.  ptxas spills
// rather than fail when an edit outgrows them, so chip_smoke.py fails on
// any spill or local memory here: lower the count then.
template <typename T, bool kComp, Mode kMode>
constexpr int min_blocks() {
  constexpr bool kPlain = kMode == Mode::kPlain;
  if constexpr (kDirsOf<kMode> == 2) {
    return sizeof(T) == 8 ? 4 : 8;  // blocks of 64 threads
  } else if constexpr (kDirsOf<kMode> == 1) {
    return sizeof(T) == 8 ? 6 : 10;  // blocks of 64 threads
  } else if constexpr (sizeof(T) == 8) {
    return 5;
  } else if constexpr (kComp) {
    return kPlain ? 7 : 6;
  } else {
    return kPlain ? 9 : 8;
  }
}

template <typename T, bool kComp>
struct KsState {
  T s[kRows];               // q1 p1 q2 p2, each (t, x, y, z)
  T c[kComp ? kRows : 1];   // Kahan deficits (compensated layout only)
};

// the best estimate of row I: s - c in the compensated layout (the twin's
// `best`), the row itself in the plain one
template <int I, typename T, bool kComp>
__device__ __forceinline__ T best(const KsState<T, kComp>& st) {
  if constexpr (kComp) {
    return st.s[I] - st.c[I];
  } else {
    return st.s[I];
  }
}

// A thread's rows in shared memory: row m at col[m * kStride] (kStride the
// block's threads), so a warp's accesses to one row are 32 consecutive
// words
template <typename T, int kStride>
struct Column {
  T* col;

  __device__ __forceinline__ T& operator[](int m) const {
    return col[m * kStride];
  }
};

// A thread's pre-step copy of its state, in shared memory, one column per
// thread.  Written every step, read only on a revert and for the crossing
// lerps.
template <typename T, bool kComp, int kStride>
struct Saved {
  T* col;

  __device__ __forceinline__ void store(const KsState<T, kComp>& st) const {
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      col[m * kStride] = st.s[m];
      if constexpr (kComp) col[(kRows + m) * kStride] = st.c[m];
    }
  }

  __device__ __forceinline__ KsState<T, kComp> load() const {
    KsState<T, kComp> st;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      st.s[m] = col[m * kStride];
      if constexpr (kComp) st.c[m] = col[(kRows + m) * kStride];
    }
    return st;
  }

  __device__ __forceinline__ T s(int m) const { return col[m * kStride]; }

  template <int I>
  __device__ __forceinline__ T best() const {
    if constexpr (kComp) {
      return col[I * kStride] - col[(kRows + I) * kStride];
    } else {
      return col[I * kStride];
    }
  }
};

// b_old + t (b_new - b_old) on row I, the crossing lerp
template <int I, typename T, bool kComp, int kStride>
__device__ __forceinline__ T lerp_row(const Saved<T, kComp, kStride>& old,
                                      const KsState<T, kComp>& now, T t) {
  const T b_old = old.template best<I>();
  return b_old + t * (best<I>(now) - b_old);
}

template <typename T>
struct Scalars {
  T mass, a, charge, r_cap, r_max, plunge_zone;
};

template <typename T>
__device__ __forceinline__ void kahan_add(T& s, T& c, T inc) {
  // MUST stay exactly this op sequence (hamiltonian._kahan_add)
  const T y = inc - c;
  const T t = s + y;
  c = (t - s) - y;
  s = t;
}

// row += inc: compensated in the 32-row layout, plain in the 16-row one
template <int I, typename T, bool kComp>
__device__ __forceinline__ void accumulate(KsState<T, kComp>& st, T inc) {
  if constexpr (kComp) {
    kahan_add(st.s[I], st.c[I], inc);
  } else {
    st.s[I] = st.s[I] + inc;
  }
}

template <typename T>
__device__ __forceinline__ T ks_radius(T x, T y, T z, T a) {
  // kerr_schild.ks_radius_c
  const T rho2 = x * x + y * y + z * z;
  const T b = rho2 - a * a;
  return sqrt(T(0.5) * (b + sqrt(b * b + T(4) * a * a * z * z)));
}

// H and S = -pt + l.p at the (q, p) of one kick/drift: all that the null
// invariant needs of the geometry there
template <typename T>
struct HS {
  T H, S;
};

template <typename T>
struct Kick {
  T kx, ky, kz, dt, dx, dy, dz;
  HS<T> hs;
};

// The tangent modes' direction: the tangents of mass, a and charge (the
// substep scalars and the thresholds carry none), and of a kick/drift's
// seven outputs
template <typename T>
struct Tangents {
  T mass, a, charge;
};

template <typename T>
struct Kick7 {
  T kx, ky, kz, dt, dx, dy, dz;
};

// The intermediates of one kick/drift that its tangent reads
template <typename T>
struct KickGeom {
  T x, y, z, px, py, pz, b, az, r, inv_r, inv_D, w, inv_w, hn, H, lxn, lx,
      lyn, ly, lz, S, HS2, xr, r_x, yr, r_y, zw, zwr, r_z, xb, D_x, yb, D_y,
      bz, zb, D_z, hx, H_x, hy, H_y, hz, H_z, inv_r2, lp, gn, zp, G, sxn, S_x,
      syn, S_y, S_z, S2;
};

// kerr_schild._kick_drift at (x, y, z) with the momenta (pt, px, py, pz);
// g receives the intermediates that its tangent (kick_drift_tan) reads,
// which the primal modes leave dead
template <typename T>
__device__ __forceinline__ Kick<T> kick_drift(T x, T y, T z, T pt, T px,
                                              T py, T pz,
                                              const Scalars<T>& sc,
                                              KickGeom<T>& g) {
  const T a = sc.a;
  // kerr_schild._geom
  const T rho2 = x * x + y * y + z * z;
  const T b = rho2 - a * a;
  const T az = a * z;
  const T s = sqrt(b * b + T(4) * az * az);
  const T r2 = T(0.5) * (b + s);
  const T r = sqrt(r2);
  const T inv_r = T(1) / r;
  const T inv_D = T(1) / s;
  const T w = r2 + a * a;
  const T inv_w = T(1) / w;
  const T hn = sc.mass * r - T(0.5) * sc.charge * sc.charge;
  const T H = hn * inv_D;
  const T lxn = r * x + a * y;
  const T lx = lxn * inv_w;
  const T lyn = r * y - a * x;
  const T ly = lyn * inv_w;
  const T lz = z * inv_r;

  const T S = -pt + lx * px + ly * py + lz * pz;
  const T HS2 = T(2) * H * S;
  Kick<T> k;
  k.hs = {H, S};
  k.dt = -pt + HS2;
  k.dx = px - HS2 * lx;
  k.dy = py - HS2 * ly;
  k.dz = pz - HS2 * lz;

  const T xr = x * r;
  const T r_x = xr * inv_D;
  const T yr = y * r;
  const T r_y = yr * inv_D;
  const T zw = z * w;
  const T zwr = zw * inv_r;
  const T r_z = zwr * inv_D;
  const T xb = T(2) * x * b;
  const T D_x = xb * inv_D;
  const T yb = T(2) * y * b;
  const T D_y = yb * inv_D;
  const T bz = b + T(2) * a * a;
  const T zb = T(2) * z * bz;
  const T D_z = zb * inv_D;

  const T hx = sc.mass * r_x - H * D_x;
  const T H_x = hx * inv_D;
  const T hy = sc.mass * r_y - H * D_y;
  const T H_y = hy * inv_D;
  const T hz = sc.mass * r_z - H * D_z;
  const T H_z = hz * inv_D;

  const T inv_r2 = inv_r * inv_r;
  const T lp = lx * px + ly * py;
  const T rlp = T(2) * r * lp;
  const T gn = x * px + y * py - rlp;
  const T zp = z * pz;
  const T zpr = zp * inv_r2;
  const T G = gn * inv_w - zpr;
  const T sxn = r * px - a * py;
  const T S_x = r_x * G + sxn * inv_w;
  const T syn = a * px + r * py;
  const T S_y = r_y * G + syn * inv_w;
  const T S_z = r_z * G + pz * inv_r;

  const T S2 = S * S;
  k.kx = -H_x * S2 - HS2 * S_x;
  k.ky = -H_y * S2 - HS2 * S_y;
  k.kz = -H_z * S2 - HS2 * S_z;
  g = {x,  y,   z,   px,  py,  pz,  b,   az,  r,  inv_r, inv_D, w,  inv_w,
       hn, H,   lxn, lx,  lyn, ly,  lz,  S,   HS2, xr,  r_x,  yr,  r_y,
       zw, zwr, r_z, xb,  D_x, yb,  D_y, bz,  zb,  D_z, hx,   H_x, hy,
       H_y, hz, H_z, inv_r2, lp, gn, zp, G, sxn, S_x, syn, S_y, S_z, S2};
  return k;
}

// The tangent of the kick/drift g (kerr_schild._kick_drift_tan) along
// (x_d, ..., pz_d) and sd: the tangent of each intermediate X is X_d,
// formed in the twin's order; a quotient's tangent reuses the primal
// reciprocal, (1/u)_d = -(u_d (1/u)) (1/u)
template <typename T>
__device__ __forceinline__ Kick7<T> kick_drift_tan(
    const KickGeom<T>& g, T x_d, T y_d, T z_d, T pt_d, T px_d, T py_d,
    T pz_d, const Scalars<T>& sc, const Tangents<T>& sd) {
  const T a = sc.a;
  const T a_d = sd.a;
  const T rho2_d = T(2) * (g.x * x_d + g.y * y_d + g.z * z_d);
  const T b_d = rho2_d - T(2) * a * a_d;
  const T az_d = a_d * g.z + a * z_d;
  const T s_d = (g.b * b_d + T(4) * g.az * az_d) * g.inv_D;
  const T r2_d = T(0.5) * (b_d + s_d);
  const T r_d = T(0.5) * r2_d * g.inv_r;
  const T inv_r_d = -(r_d * g.inv_r * g.inv_r);
  const T inv_D_d = -(s_d * g.inv_D * g.inv_D);
  const T w_d = r2_d + T(2) * a * a_d;
  const T inv_w_d = -(w_d * g.inv_w * g.inv_w);
  const T hn_d = (sd.mass * g.r + sc.mass * r_d) - sc.charge * sd.charge;
  const T H_d = hn_d * g.inv_D + g.hn * inv_D_d;
  const T lxn_d = (r_d * g.x + g.r * x_d) + (a_d * g.y + a * y_d);
  const T lx_d = lxn_d * g.inv_w + g.lxn * inv_w_d;
  const T lyn_d = (r_d * g.y + g.r * y_d) - (a_d * g.x + a * x_d);
  const T ly_d = lyn_d * g.inv_w + g.lyn * inv_w_d;
  const T lz_d = z_d * g.inv_r + g.z * inv_r_d;

  const T S_d = -pt_d + (lx_d * g.px + g.lx * px_d)
                + (ly_d * g.py + g.ly * py_d) + (lz_d * g.pz + g.lz * pz_d);
  const T HS2_d = T(2) * (H_d * g.S + g.H * S_d);
  Kick7<T> kd;
  kd.dt = -pt_d + HS2_d;
  kd.dx = px_d - (HS2_d * g.lx + g.HS2 * lx_d);
  kd.dy = py_d - (HS2_d * g.ly + g.HS2 * ly_d);
  kd.dz = pz_d - (HS2_d * g.lz + g.HS2 * lz_d);

  const T r_x_d = (x_d * g.r + g.x * r_d) * g.inv_D + g.xr * inv_D_d;
  const T r_y_d = (y_d * g.r + g.y * r_d) * g.inv_D + g.yr * inv_D_d;
  const T zw_d = z_d * g.w + g.z * w_d;
  const T zwr_d = zw_d * g.inv_r + g.zw * inv_r_d;
  const T r_z_d = zwr_d * g.inv_D + g.zwr * inv_D_d;
  const T xb_d = T(2) * (x_d * g.b + g.x * b_d);
  const T D_x_d = xb_d * g.inv_D + g.xb * inv_D_d;
  const T yb_d = T(2) * (y_d * g.b + g.y * b_d);
  const T D_y_d = yb_d * g.inv_D + g.yb * inv_D_d;
  const T bz_d = b_d + T(4) * a * a_d;
  const T zb_d = T(2) * (z_d * g.bz + g.z * bz_d);
  const T D_z_d = zb_d * g.inv_D + g.zb * inv_D_d;

  const T hx_d = (sd.mass * g.r_x + sc.mass * r_x_d)
                 - (H_d * g.D_x + g.H * D_x_d);
  const T H_x_d = hx_d * g.inv_D + g.hx * inv_D_d;
  const T hy_d = (sd.mass * g.r_y + sc.mass * r_y_d)
                 - (H_d * g.D_y + g.H * D_y_d);
  const T H_y_d = hy_d * g.inv_D + g.hy * inv_D_d;
  const T hz_d = (sd.mass * g.r_z + sc.mass * r_z_d)
                 - (H_d * g.D_z + g.H * D_z_d);
  const T H_z_d = hz_d * g.inv_D + g.hz * inv_D_d;

  const T inv_r2_d = T(2) * (g.inv_r * inv_r_d);
  const T lp_d = (lx_d * g.px + g.lx * px_d) + (ly_d * g.py + g.ly * py_d);
  const T rlp_d = T(2) * (r_d * g.lp + g.r * lp_d);
  const T gn_d = (x_d * g.px + g.x * px_d) + (y_d * g.py + g.y * py_d)
                 - rlp_d;
  const T zp_d = z_d * g.pz + g.z * pz_d;
  const T zpr_d = zp_d * g.inv_r2 + g.zp * inv_r2_d;
  const T G_d = (gn_d * g.inv_w + g.gn * inv_w_d) - zpr_d;
  const T sxn_d = (r_d * g.px + g.r * px_d) - (a_d * g.py + a * py_d);
  const T S_x_d = (r_x_d * g.G + g.r_x * G_d)
                  + (sxn_d * g.inv_w + g.sxn * inv_w_d);
  const T syn_d = (a_d * g.px + a * px_d) + (r_d * g.py + g.r * py_d);
  const T S_y_d = (r_y_d * g.G + g.r_y * G_d)
                  + (syn_d * g.inv_w + g.syn * inv_w_d);
  const T S_z_d = (r_z_d * g.G + g.r_z * G_d)
                  + (pz_d * g.inv_r + g.pz * inv_r_d);

  const T S2_d = T(2) * (g.S * S_d);
  kd.kx = -(H_x_d * g.S2 + g.H_x * S2_d) - (HS2_d * g.S_x + g.HS2 * S_x_d);
  kd.ky = -(H_y_d * g.S2 + g.H_y * S2_d) - (HS2_d * g.S_y + g.HS2 * S_y_d);
  kd.kz = -(H_z_d * g.S2 + g.H_z * S2_d) - (HS2_d * g.S_z + g.HS2 * S_z_d);
  return kd;
}

// kerr_schild.hamiltonian_ks, from the H and S that a kick/drift computed
// at the same (q, p): the operations its own geometry would repeat, on the
// same values
template <typename T>
__device__ __forceinline__ T hamiltonian(T pt, T px, T py, T pz, HS<T> hs) {
  return T(0.5) * (-pt * pt + px * px + py * py + pz * pz)
         - hs.H * hs.S * hs.S;
}

// Flow A (kFlowA: metric at q1 (rows 1..3), momenta p2 (12..15); kick p1
// (5..7), drift q2 (8..11)) or flow B (metric at q2 (9..11), momenta p1
// (4..7); kick p2 (13..15), drift q1 (0..3)); then, for each of kDirs
// directions d, its tangent rows td[d] take the flow's tangent
// (kerr_schild._flow_tan) from the same evaluation.  Returns H and S at
// the metric point, which the flow leaves as they were.
template <bool kFlowA, int kDirs, typename T, bool kComp, int kStride>
__device__ __forceinline__ HS<T> flow(KsState<T, kComp>& st,
                                      const Column<T, kStride>* td, T dt,
                                      const Scalars<T>& sc,
                                      const Tangents<T>* sd) {
  constexpr int kPos = kFlowA ? 1 : 9;
  constexpr int kMom = kFlowA ? 12 : 4;
  constexpr int kKick = kFlowA ? 5 : 13;
  constexpr int kDrift = kFlowA ? 8 : 0;
  KickGeom<T> g;
  const Kick<T> k = kick_drift(st.s[kPos], st.s[kPos + 1], st.s[kPos + 2],
                               st.s[kMom], st.s[kMom + 1], st.s[kMom + 2],
                               st.s[kMom + 3], sc, g);
  accumulate<kKick>(st, (-dt) * k.kx);
  accumulate<kKick + 1>(st, (-dt) * k.ky);
  accumulate<kKick + 2>(st, (-dt) * k.kz);
  accumulate<kDrift>(st, dt * k.dt);
  accumulate<kDrift + 1>(st, dt * k.dx);
  accumulate<kDrift + 2>(st, dt * k.dy);
  accumulate<kDrift + 3>(st, dt * k.dz);
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    const Column<T, kStride>& ts = td[d];
    const Kick7<T> kd = kick_drift_tan(
        g, ts[kPos], ts[kPos + 1], ts[kPos + 2], ts[kMom], ts[kMom + 1],
        ts[kMom + 2], ts[kMom + 3], sc, sd[d]);
    ts[kKick] = ts[kKick] + (-dt) * kd.kx;
    ts[kKick + 1] = ts[kKick + 1] + (-dt) * kd.ky;
    ts[kKick + 2] = ts[kKick + 2] + (-dt) * kd.kz;
    ts[kDrift] = ts[kDrift] + dt * kd.dt;
    ts[kDrift + 1] = ts[kDrift + 1] + dt * kd.dx;
    ts[kDrift + 2] = ts[kDrift + 2] + dt * kd.dy;
    ts[kDrift + 3] = ts[kDrift + 3] + dt * kd.dz;
  }
  return k.hs;
}

// kerr_schild._flow_mixed_ksc: the mixing rotation in increment form,
// omc_w = 1 - cos(2 omega delta), copy differences folding the deficits
template <typename T>
__device__ __forceinline__ void flow_mixed(KsState<T, true>& st, T omc_w,
                                           T sin_w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T q_dif = (st.s[i] - st.s[8 + i]) - (st.c[i] - st.c[8 + i]);
    const T p_dif = (st.s[4 + i] - st.s[12 + i])
                    - (st.c[4 + i] - st.c[12 + i]);
    const T dq1 = T(0.5) * (sin_w * p_dif - omc_w * q_dif);
    const T dp1 = T(0.5) * ((-sin_w) * q_dif - omc_w * p_dif);
    kahan_add(st.s[i], st.c[i], dq1);
    kahan_add(st.s[4 + i], st.c[4 + i], dp1);
    kahan_add(st.s[8 + i], st.c[8 + i], -dq1);
    kahan_add(st.s[12 + i], st.c[12 + i], -dp1);
  }
}

// hamiltonian._flow_mixed: the plain mixing rotation, cos_w = cos(2 omega
// d), on 16 rows r (a thread's registers, or its column of tangent rows)
template <typename T, typename Rows>
__device__ __forceinline__ void mix_rows(Rows&& r, T cos_w, T sin_w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T q1 = r[i], p1 = r[4 + i];
    const T q2 = r[8 + i], p2 = r[12 + i];
    const T q_sum = q1 + q2;
    const T q_dif = q1 - q2;
    const T p_sum = p1 + p2;
    const T p_dif = p1 - p2;
    r[i] = T(0.5) * (q_sum + q_dif * cos_w + p_dif * sin_w);
    r[4 + i] = T(0.5) * (p_sum + p_dif * cos_w - q_dif * sin_w);
    r[8 + i] = T(0.5) * (q_sum - q_dif * cos_w - p_dif * sin_w);
    r[12 + i] = T(0.5) * (p_sum - p_dif * cos_w + q_dif * sin_w);
  }
}

template <typename T>
__device__ __forceinline__ void flow_mixed(KsState<T, false>& st, T cos_w,
                                           T sin_w) {
  mix_rows(st.s, cos_w, sin_w);
}

// the lerp's tangent on row I (tangent modes): b_old_d + (t_d (b_new -
// b_old) + t (b_new_d - b_old_d))
template <int I, typename T, int kStride>
__device__ __forceinline__ T lerp_tan(const Saved<T, false, kStride>& old,
                                      const KsState<T, false>& now,
                                      const Column<T, kStride>& old_d,
                                      const Column<T, kStride>& now_d, T t,
                                      T t_d) {
  const T b_old = old.s(I);
  const T b_old_d = old_d[I];
  return b_old_d + (t_d * (now.s[I] - b_old) + t * (now_d[I] - b_old_d));
}

template <typename T, bool kComp, Mode kMode>
__global__ void __launch_bounds__(kThreadsOf<kMode>,
                                  (min_blocks<T, kComp, kMode>()))
fantasy_ks_kernel(const T* __restrict__ state_in,
                  const T* __restrict__ tan_in, T* __restrict__ state_out,
                  int* __restrict__ ns_out, T* __restrict__ rec_out,
                  T* __restrict__ rec_d_out, int* __restrict__ cnt_out,
                  const T* __restrict__ params,
                  const T* __restrict__ dparams, int n, int n_sub, int steps,
                  int n_orders) {
  constexpr int kDirs = kDirsOf<kMode>;
  constexpr int kTh = kThreadsOf<kMode>;
  constexpr bool kDisk = kMode == Mode::kDisk || kDirs > 0;
  constexpr bool kSub = kMode == Mode::kSubring;
  static_assert(!(kDirs && kComp), "the tangent modes have the 16-row layout");
  // the pre-step rows (and deficits); in the tangent modes then, per
  // direction, the pre-step tangent rows and the tangent rows
  __shared__ T saved[((kComp ? 2 : 1) + 2 * kDirs) * kRows][kTh];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Saved<T, kComp, kTh> old{&saved[0][threadIdx.x]};
  constexpr int kD = kDirs ? kDirs : 1;  // arrays of the primal modes: unused
  Column<T, kTh> old_d[kD];
  Column<T, kTh> td[kD];
  Tangents<T> sd[kD];
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    old_d[d].col = &saved[(1 + 2 * d) * kRows][threadIdx.x];
    td[d].col = &saved[(2 + 2 * d) * kRows][threadIdx.x];
    sd[d] = {__ldg(dparams + 3 * d), __ldg(dparams + 3 * d + 1),
             __ldg(dparams + 3 * d + 2)};
  }
  const size_t stride = static_cast<size_t>(n);

  KsState<T, kComp> st;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    st.s[k] = state_in[k * stride + i];
    if constexpr (kComp) st.c[k] = state_in[(kRows + k) * stride + i];
#pragma unroll
    for (int d = 0; d < kDirs; ++d) {
      td[d][k] = tan_in[(d * kRows + k) * stride + i];
    }
  }

  Scalars<T> sc;
  sc.mass = __ldg(params + 0);
  sc.a = __ldg(params + 1);
  sc.charge = __ldg(params + 2);
  sc.r_cap = __ldg(params + 3);
  sc.r_max = __ldg(params + 4);
  sc.plunge_zone = __ldg(params + 5);
  const T d0 = __ldg(params + kScal);
  const T r_plus = sc.r_cap / T(1.05);
  const T r_max2 = sc.r_max * sc.r_max;
  // the disk annulus rides after the substeps (unused in the other modes)
  const T r_in = kDisk ? __ldg(params + kScal + 4 * n_sub) : T(0);
  const T r_out = kDisk ? __ldg(params + kScal + 4 * n_sub + 1) : T(0);
  bool hit = false;
  int cnt = 0;  // subring mode: plane crossings so far

  int ns = 0;
  // ks_radius of q1 at the top of the next step; flow A leaves q1 as it
  // is, so the launch radius is also the first step's
  T r_old = ks_radius(st.s[1], st.s[2], st.s[3], sc.a);
  const bool act0 =
      r_old > sc.r_cap
      && st.s[1] * st.s[1] + st.s[2] * st.s[2] + st.s[3] * st.s[3] < r_max2;
  if (act0 && steps > 0) {
    // H and S of the last flow A, at today's (q1, p2)
    HS<T> hs = flow<true, kDirs>(st, td, T(0.5) * d0, sc, sd);  // opening A
    for (int k = 0; k < steps; ++k) {
      const T rho2 = st.s[1] * st.s[1] + st.s[2] * st.s[2]
                     + st.s[3] * st.s[3];
      if (!(r_old > sc.r_cap && rho2 < r_max2)) break;
      old.store(st);
#pragma unroll
      for (int d = 0; d < kDirs; ++d) {
#pragma unroll
        for (int m = 0; m < kRows; ++m) old_d[d][m] = td[d][m];
      }
      T z0 = T(0);
      if constexpr (kDisk || kSub) z0 = best<3>(st);
      for (int j = 0; j < n_sub; ++j) {
        const T* sub = params + kScal + 4 * j;
        const T half = T(0.5) * __ldg(sub + 0);
        flow<false, kDirs>(st, td, half, sc, sd);
        // the mixing's scalars are read here, not across the flow above:
        // two more live doubles there spill the double disk and subring
        // modes at their min_blocks
        const T cw = __ldg(sub + 1);
        const T sw = __ldg(sub + 2);
        flow_mixed(st, cw, sw);
#pragma unroll
        for (int d = 0; d < kDirs; ++d) {
          mix_rows(td[d], cw, sw);  // linear: the same rotation
        }
        flow<false, kDirs>(st, td, half, sc, sd);
        hs = flow<true, kDirs>(st, td, __ldg(sub + 3), sc, sd);
      }

      // null-invariant blow-up guard (make_ks_step), on the (q1, p2) rows
      T agg = st.s[0];
#pragma unroll
      for (int m = 1; m < kRows; ++m) agg = agg + st.s[m];
      const bool finite = isfinite(agg);
      const T h = hamiltonian(st.s[12], st.s[13], st.s[14], st.s[15], hs);
      const T p2n = st.s[13] * st.s[13] + st.s[14] * st.s[14]
                    + st.s[15] * st.s[15] + T(1);
      // negated <= so that a NaN invariant trips it
      const bool exploded = !(finite && fabs(h) <= T(3e-2) * p2n);
      const T r_new = ks_radius(st.s[1], st.s[2], st.s[3], sc.a);
      const bool crossed = finite && r_new < r_plus && !exploded;
      ++ns;
      if (exploded || crossed) {
        const bool inward = old.s(1) * old.s(5) + old.s(2) * old.s(6)
                            + old.s(3) * old.s(7) < T(0);
        const bool capture =
            crossed || (exploded && (inward || r_old < sc.plunge_zone));
        // revert and park: captured on-axis at (0, 0, 0.5 r_cap), else the
        // numerical sentinel (150, 0, 0); the park flag is the sign of ns
        st = old.load();
        st.s[1] = capture ? T(0) : T(150);
        st.s[2] = T(0);
        st.s[3] = capture ? T(0.5) * sc.r_cap : T(0);
        if constexpr (kComp) {
          st.c[1] = T(0);
          st.c[2] = T(0);
          st.c[3] = T(0);
        }
        // the tangent rows revert with their rows; the parked coordinates
        // are constants
#pragma unroll
        for (int d = 0; d < kDirs; ++d) {
#pragma unroll
          for (int m = 0; m < kRows; ++m) td[d][m] = old_d[d][m];
          td[d][1] = T(0);
          td[d][2] = T(0);
          td[d][3] = T(0);
        }
        ns = -ns;
        r_old = ks_radius(st.s[1], st.s[2], st.s[3], sc.a);
        continue;
      }
      r_old = r_new;
      const T z1 = best<3>(st);
      if constexpr (kDisk) {
        // first equatorial crossing inside the annulus, from the folded
        // pre-step and new states, in the twin's order
        if (z0 * z1 < T(0)) {
          const T t = z0 / (z0 - z1);
          const T cx = lerp_row<1>(old, st, t);
          const T cy = lerp_row<2>(old, st, t);
          const T cz = lerp_row<3>(old, st, t);
          const T r_hit = ks_radius(cx, cy, cz, sc.a);
          if (r_hit >= r_in && r_hit <= r_out) {
            hit = true;
            rec_out[1 * stride + i] = lerp_row<0>(old, st, t);
            rec_out[2 * stride + i] = cx;
            rec_out[3 * stride + i] = cy;
            rec_out[4 * stride + i] = cz;
            rec_out[5 * stride + i] = lerp_row<12>(old, st, t);
            rec_out[6 * stride + i] = lerp_row<13>(old, st, t);
            rec_out[7 * stride + i] = lerp_row<14>(old, st, t);
            rec_out[8 * stride + i] = lerp_row<15>(old, st, t);
            if constexpr (kDirs > 0) {
#pragma unroll
              for (int d = 0; d < kDirs; ++d) {
                // the lerp fraction differentiated, t_d = (z0_d - t (z0_d -
                // z1_d)) / (z0 - z1); the guard, the capture and the
                // annulus tests are discrete and carry no tangent
                const Column<T, kTh>& od = old_d[d];
                const Column<T, kTh>& nd = td[d];
                const T z0_d = od[3];
                const T t_d = (z0_d - t * (z0_d - nd[3])) / (z0 - z1);
                T* hd = rec_d_out + 8 * d * stride + i;
                hd[0 * stride] = lerp_tan<0>(old, st, od, nd, t, t_d);
                hd[1 * stride] = lerp_tan<1>(old, st, od, nd, t, t_d);
                hd[2 * stride] = lerp_tan<2>(old, st, od, nd, t, t_d);
                hd[3 * stride] = lerp_tan<3>(old, st, od, nd, t, t_d);
                hd[4 * stride] = lerp_tan<12>(old, st, od, nd, t, t_d);
                hd[5 * stride] = lerp_tan<13>(old, st, od, nd, t, t_d);
                hd[6 * stride] = lerp_tan<14>(old, st, od, nd, t, t_d);
                hd[7 * stride] = lerp_tan<15>(old, st, od, nd, t, t_d);
              }
            }
            break;  // the hit ray is frozen
          }
        }
      } else if constexpr (kSub) {
        // every equatorial crossing, at any radius; the first n_orders
        // are lerped in the twin's order and stored in slot cnt
        if (z0 * z1 < T(0)) {
          if (cnt < n_orders) {
            const T t = z0 / (z0 - z1);
            T* slot = rec_out + static_cast<size_t>(8 * cnt) * stride + i;
            slot[0 * stride] = lerp_row<0>(old, st, t);
            slot[1 * stride] = lerp_row<1>(old, st, t);
            slot[2 * stride] = lerp_row<2>(old, st, t);
            slot[3 * stride] = lerp_row<3>(old, st, t);
            slot[4 * stride] = lerp_row<12>(old, st, t);
            slot[5 * stride] = lerp_row<13>(old, st, t);
            slot[6 * stride] = lerp_row<14>(old, st, t);
            slot[7 * stride] = lerp_row<15>(old, st, t);
          }
          ++cnt;
        }
      }
    }
    // closing half-A for every opened ray (parked ones too: the park points
    // are regular chart points and flow A cannot move q1); the tangents
    // have left at the crossing, so it runs on the rows alone
    flow<true, 0>(st, td, T(-0.5) * d0, sc, sd);
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    state_out[k * stride + i] = st.s[k];
    if constexpr (kComp) state_out[(kRows + k) * stride + i] = st.c[k];
  }
  ns_out[i] = ns;
  if constexpr (kDisk) {
    // a hit stored its rows at the crossing; the other rays write zeros
    rec_out[i] = hit ? T(1) : T(0);
    if (!hit) {
#pragma unroll
      for (int m = 1; m < 9; ++m) rec_out[m * stride + i] = T(0);
#pragma unroll
      for (int m = 0; m < 8 * kDirs; ++m) rec_d_out[m * stride + i] = T(0);
    }
  }
  if constexpr (kSub) cnt_out[i] = cnt;
}

#ifdef __CUDACC__

template <typename T, bool kComp, Mode kMode>
int launch(const T* state_in, const T* tan_in, T* state_out, int* ns_out,
           T* rec_out, T* rec_d_out, int* cnt_out, const T* params,
           const T* dparams, int n, int n_sub, int steps, int n_orders,
           void* stream) {
  if (n <= 0) return 0;
  constexpr int kTh = kThreadsOf<kMode>;
  const int blocks = (n + kTh - 1) / kTh;
  fantasy_ks_kernel<T, kComp, kMode>
      <<<blocks, kTh, 0, static_cast<cudaStream_t>(stream)>>>(
          state_in, tan_in, state_out, ns_out, rec_out, rec_d_out, cnt_out,
          params, dparams, n, n_sub, steps, n_orders);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// 32 rows, float, Kahan-compensated: the production float32 layout
extern "C" int grt_fantasy_ks32_f32_launch(const float* state_in,
                                           float* state_out, int* ns_out,
                                           const float* params, int n,
                                           int n_sub, int steps,
                                           void* stream) {
  return launch<float, true, Mode::kPlain>(
      state_in, nullptr, state_out, ns_out, nullptr, nullptr, nullptr, params,
      nullptr, n, n_sub, steps, 0, stream);
}

// 16 rows, float, plain
extern "C" int grt_fantasy_ks16_f32_launch(const float* state_in,
                                           float* state_out, int* ns_out,
                                           const float* params, int n,
                                           int n_sub, int steps,
                                           void* stream) {
  return launch<float, false, Mode::kPlain>(
      state_in, nullptr, state_out, ns_out, nullptr, nullptr, nullptr, params,
      nullptr, n, n_sub, steps, 0, stream);
}

// 16 rows, double, plain: the float64 layout
extern "C" int grt_fantasy_ks16_f64_launch(const double* state_in,
                                           double* state_out, int* ns_out,
                                           const double* params, int n,
                                           int n_sub, int steps,
                                           void* stream) {
  return launch<double, false, Mode::kPlain>(
      state_in, nullptr, state_out, ns_out, nullptr, nullptr, nullptr, params,
      nullptr, n, n_sub, steps, 0, stream);
}

// Disk mode (kernel B6): the same three layouts, plus the (9, n) recorder
// rows disk_out; params ends with [r_in, r_out].

extern "C" int grt_fantasy_ks32_f32_disk_launch(const float* state_in,
                                                float* state_out, int* ns_out,
                                                float* disk_out,
                                                const float* params, int n,
                                                int n_sub, int steps,
                                                void* stream) {
  return launch<float, true, Mode::kDisk>(
      state_in, nullptr, state_out, ns_out, disk_out, nullptr, nullptr,
      params, nullptr, n, n_sub, steps, 0, stream);
}

extern "C" int grt_fantasy_ks16_f32_disk_launch(const float* state_in,
                                                float* state_out, int* ns_out,
                                                float* disk_out,
                                                const float* params, int n,
                                                int n_sub, int steps,
                                                void* stream) {
  return launch<float, false, Mode::kDisk>(
      state_in, nullptr, state_out, ns_out, disk_out, nullptr, nullptr,
      params, nullptr, n, n_sub, steps, 0, stream);
}

extern "C" int grt_fantasy_ks16_f64_disk_launch(const double* state_in,
                                                double* state_out,
                                                int* ns_out, double* disk_out,
                                                const double* params, int n,
                                                int n_sub, int steps,
                                                void* stream) {
  return launch<double, false, Mode::kDisk>(
      state_in, nullptr, state_out, ns_out, disk_out, nullptr, nullptr,
      params, nullptr, n, n_sub, steps, 0, stream);
}

// Subring mode (kernel B7): the same three layouts, plus cnt_out (n,)
// int32, the plane crossings of each ray, and slot_out (8 n_orders, n),
// the first n_orders crossings (zero-filled by the caller); params is the
// plain-mode vector.

extern "C" int grt_fantasy_ks32_f32_sub_launch(const float* state_in,
                                               float* state_out, int* ns_out,
                                               int* cnt_out, float* slot_out,
                                               const float* params, int n,
                                               int n_sub, int steps,
                                               int n_orders, void* stream) {
  return launch<float, true, Mode::kSubring>(
      state_in, nullptr, state_out, ns_out, slot_out, nullptr, cnt_out,
      params, nullptr, n, n_sub, steps, n_orders, stream);
}

extern "C" int grt_fantasy_ks16_f32_sub_launch(const float* state_in,
                                               float* state_out, int* ns_out,
                                               int* cnt_out, float* slot_out,
                                               const float* params, int n,
                                               int n_sub, int steps,
                                               int n_orders, void* stream) {
  return launch<float, false, Mode::kSubring>(
      state_in, nullptr, state_out, ns_out, slot_out, nullptr, cnt_out,
      params, nullptr, n, n_sub, steps, n_orders, stream);
}

extern "C" int grt_fantasy_ks16_f64_sub_launch(const double* state_in,
                                               double* state_out, int* ns_out,
                                               int* cnt_out, double* slot_out,
                                               const double* params, int n,
                                               int n_sub, int steps,
                                               int n_orders, void* stream) {
  return launch<double, false, Mode::kSubring>(
      state_in, nullptr, state_out, ns_out, slot_out, nullptr, cnt_out,
      params, nullptr, n, n_sub, steps, n_orders, stream);
}

// Tangent modes (kernel B6t): 16 rows, float and double, one direction
// (*_disk_tangent_*) or two (*_disk_tangent2_*), plus the (16 K, n)
// tangent rows tan_in, the (8 K, n) crossing tangents disk_d_out and the
// scalar tangents dparams [d mass, d a, d charge] x K; params is the
// disk-mode vector.
extern "C" int grt_fantasy_ks16_f32_disk_tangent_launch(
    const float* state_in, const float* tan_in, float* state_out,
    int* ns_out, float* disk_out, float* disk_d_out, const float* params,
    const float* dparams, int n, int n_sub, int steps, void* stream) {
  return launch<float, false, Mode::kDiskTangent>(
      state_in, tan_in, state_out, ns_out, disk_out, disk_d_out, nullptr,
      params, dparams, n, n_sub, steps, 0, stream);
}

extern "C" int grt_fantasy_ks16_f64_disk_tangent_launch(
    const double* state_in, const double* tan_in, double* state_out,
    int* ns_out, double* disk_out, double* disk_d_out, const double* params,
    const double* dparams, int n, int n_sub, int steps, void* stream) {
  return launch<double, false, Mode::kDiskTangent>(
      state_in, tan_in, state_out, ns_out, disk_out, disk_d_out, nullptr,
      params, dparams, n, n_sub, steps, 0, stream);
}

extern "C" int grt_fantasy_ks16_f32_disk_tangent2_launch(
    const float* state_in, const float* tan_in, float* state_out,
    int* ns_out, float* disk_out, float* disk_d_out, const float* params,
    const float* dparams, int n, int n_sub, int steps, void* stream) {
  return launch<float, false, Mode::kDiskTangent2>(
      state_in, tan_in, state_out, ns_out, disk_out, disk_d_out, nullptr,
      params, dparams, n, n_sub, steps, 0, stream);
}

extern "C" int grt_fantasy_ks16_f64_disk_tangent2_launch(
    const double* state_in, const double* tan_in, double* state_out,
    int* ns_out, double* disk_out, double* disk_d_out, const double* params,
    const double* dparams, int n, int n_sub, int steps, void* stream) {
  return launch<double, false, Mode::kDiskTangent2>(
      state_in, tan_in, state_out, ns_out, disk_out, disk_d_out, nullptr,
      params, dparams, n, n_sub, steps, 0, stream);
}

#endif  // __CUDACC__
