// The tracer's half of the forward-mode Jacobian: the rays of
// trace_rays.cu, bit for bit, and the forward-mode tangents of the fields
// the RT pass reads (p, t, q, k, u and ds at every step, and tsurf) in n
// directions of the state -- the counterpart of the tracer's half of the
// JAX package's compiled forward-mode Jacobian (``jax.jit(jax.jacfwd(fwd))``,
// jurassic_tpu/retrieval.py:281, through ``_trace_single``,
// jurassic_tpu/geometry.py:283), in the order of the plain version
// ``geometry.trace_rays_jvp_ref``.  Two kernels:
//
//   record kernel  the tracer kernel's warp-per-ray step chain, once a
//                  ray, writing each step's record (the primal values the
//                  tangent rules read, ``jrec`` in trace_common.cuh) and
//                  the ray's (its ds correction, whether it is traced),
//                  and the LOS as the tracer kernel writes it; plain
//                  statement ``geometry.trace_step_records_ref``;
//   tangent kernel a thread per (ray, tangent), no step chain: each
//                  thread applies the tangent rules to the records in step
//                  order, with the trapezoid rule and the column densities
//                  folded into the step loop; plain statement
//                  ``geometry.trace_tangents_from_records_ref``.
//
// The profiles' tangents come at the atm points, [N, 2 + G + W, n] (p, t,
// q[G], k[W]), with the window indices gi [R, L] that map a ray's levels
// onto them: rays that share a profile share its tangents, and no per-ray
// copy is made.  z is never a state element: zmin, zmax and the entry
// point carry no tangent, and without refraction neither does the
// geometry.  With REFRAC 1 the refractivity bends the ray, so positions,
// directions, altitudes and step lengths carry tangents; interval indices
// are piecewise constant, so tangents flow through the interpolation
// weights and through d(value)/dz dz.  The escape clip's
// xh = geo2cart(cart2geo(px)) is px, so its tangent is px's.
//
// What bounds it: the store of the tangents, 12 x NLOS x n values a ray
// (5.47 GB in float64 at the flagship, 1.63 ms at the HBM rate).  The
// design before this one ran the primal chain in every warp of a ray's
// block, ceil(n / 32) times a ray, its state and the tangents' in one
// thread (128 registers and spills in float64), the chain's partials
// passed by shuffle, and the LOS tangents written, read back and written
// again: 22.77 ms in float64, 13.20 ms in float32 at the flagship, 14-16x
// the bound (PERF.md, the H100).  Here:
//   * the record kernel runs the chain once a ray (the tracer kernel's
//     latency, under 1 ms), its captures written into a record in shared
//     memory where the chain computes them, then copied out coalesced; a
//     stopped ray whose state is the last computed step's input repeats
//     that step's record without running the step, as the tracer kernel
//     repeats its result (291 MB of records in float64 at the flagship);
//   * the tangent kernel holds only the tangent state (a dozen values);
//     the records of CH steps at a time, and the LOS values the column
//     densities read, stream through a two-slot ring in shared memory
//     (cp.async), so every thread reads a step's primal values by
//     broadcast; what the rules compute from primal values alone (the
//     interpolation weight, the q and k slopes, u's factor) is computed
//     once a block per step beside the ring, not once a thread; the
//     profiles' tangents load from global memory, coalesced over the
//     tangents and served by L1, once a step where refraction's points
//     share z's interval (without these loads the kernel took half its
//     time: tools/trace_jvp_split.py, PERF.md);
//   * every divisor of the tangent rules is a step's primal value, the
//     same in every thread: its reciprocal is computed once a block, and
//     each thread divides by two of Markstein's corrections of a r, the
//     division's bits wherever the operands keep clear of overflow and
//     subnormals, the division itself elsewhere (quo; without divisions
//     the kernel took under half its time);
//   * each output value is written once: the trapezoid rule's ds and the
//     column densities u are finished in the step loop from the last
//     step's raw ds tangent, held in a register; only the step before the
//     ray's ds correction waits for the step that computes the
//     correction's tangent, which then finishes it.
// Every step of every ray gets its tangents, stopped or not, as in the
// plain version.  The tangent kernel applies the rules in the order the
// kernel before it did, so its tangents are bit for bit that kernel's.
//
// The kernels allocate nothing and launch on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "trace_common.cuh"

namespace {

using namespace jt_trace;
using namespace jt_cp;

// Split variants (built by jurassic_torch/tools/trace_jvp_split.py):
// JT_TAN_BLOCKS sets the tangent kernel's launch bound in blocks an SM
// for both dtypes; JT_SPLIT_NOLOAD reads no profile tangent from global
// memory and JT_SPLIT_NODIV multiplies by the reciprocal where a tangent
// rule divides, both wrong by design, to see what the loads and the
// divisions cost.
constexpr int CH = 8;                // steps a ring slot holds
constexpr int TAN_THREADS = 256;     // most tangents of a block

// Tangent blocks an SM at least: four in float32 (62 registers, none
// spilled), two in float64, where three or four spill and run slower
// (tools/trace_jvp_split.py, PERF.md)
template <typename T>
constexpr int tan_blocks() {
#ifdef JT_TAN_BLOCKS
  return JT_TAN_BLOCKS;
#else
  return sizeof(T) == 8 ? 2 : 4;
#endif
}

// ---------------------------------------------------------------------------
// Record kernel

// Shared memory of a record block: the ray's (ray_bytes, a multiple of
// 16), then the step's record
template <typename T>
__host__ __device__ size_t rec_block_bytes(int L, int G, int W, int nlos) {
  return ray_bytes<T>(L, G, W, nlos) + jrec::LEN * sizeof(T);
}

// The step's record zeroed (every lane), its input state put, the sink
template <typename T>
__device__ __forceinline__ RecLin<T> begin_record(T* sr, const Ray<T>& s,
                                                  int lane) {
  for (int j = lane; j < jrec::LEN; j += 32) sr[j] = T(0);
  __syncwarp();
  RecLin<T> cap{sr, lane, 0u};
  cap.put3(jrec::X0, s.x);
  cap.put3(jrec::EX0, s.ex);
  return cap;
}

// The tracer kernel's loop (trace_rays.cu), with a RecLin: step ip's
// record into recs [R, NLOS, LEN], the ray's into rays [R, R_LEN]
template <typename T, bool REFRAC>
__global__ void __launch_bounds__(32) trace_jvp_record_kernel(
    const T* __restrict__ pz_, const T* __restrict__ pp_,
    const T* __restrict__ pt_, const T* __restrict__ pq_,
    const T* __restrict__ pk_, const int* __restrict__ nlev_,
    const T* __restrict__ zmin_, const T* __restrict__ zmax_,
    const T* __restrict__ geo, T* out_z, T* out_lon, T* out_lat, T* out_p,
    T* out_t, T* out_q, T* out_k, T* out_ds, T* out_u, uint8_t* out_valid,
    int* out_np, T* out_tsurf, T* out_tpz, T* out_tplon, T* out_tplat,
    int* out_flag, T* __restrict__ recs, T* __restrict__ rays, int R, int L,
    int G, int W, int nlos, T rayds, T raydz, bool use_raydz,
    int entry_iters, Consts<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, r = blockIdx.x;
  const RaySmem<T> m = carve<T>(smem, L, G, W, nlos);
  T* sr = reinterpret_cast<T*>(smem + ray_bytes<T>(L, G, W, nlos));
  stage(m, r, L, G, W, pz_, pp_, pt_, pq_, pk_, lane, 32);
  __syncwarp();
  const Prof<T> pr{m.z, m.p, m.t, m.q, m.k, L, nlev_[r]};
  const RayStart<T> st =
      ray_start(geo, r, R, zmin_[r], zmax_[r], c, entry_iters);
  const T zmin = st.zmin, zmax = st.zmax;
  T* out = recs + (size_t)r * nlos * jrec::LEN;

  Ray<T> s = st.s;
  Ray<T> last = s;  // the input of the last step computed
  Rec<T> rec;
  for (int ip = 0; ip < nlos; ++ip) {
    // a repeat of the last computed step (trace_rays.cu) repeats its
    // record too: the record is a function of the same inputs
    const bool repeat = ip >= 2 && s.stopped && last.stopped &&
                        same_bits(s.x, last.x) && same_bits(s.px, last.px) &&
                        same_bits(s.ex, last.ex) && same_bits(s.pz, last.pz);
    if (!repeat) {
      last = s;
      Ray<T> n = s;
      RecLin<T> cap = begin_record(sr, s, lane);
      if (!__all_sync(FULL, step<Ops<T, false>, REFRAC>(
              n, rec, ip, pr, c, zmin, zmax, rayds, raydz, use_raydz, st.ok,
              lane, cap))) {
        n = s;  // a fast path out of range: the step with the operations,
        __syncwarp();  // and its record
        cap = begin_record(sr, s, lane);
        step<Exact<T>, REFRAC>(n, rec, ip, pr, c, zmin, zmax, rayds, raydz,
                               use_raydz, st.ok, lane, cap);
      }
      s = n;
      __syncwarp();
    }
    for (int j = lane; j < jrec::LEN; j += 32)
      out[(size_t)ip * jrec::LEN + j] = sr[j];
    __syncwarp();
    if (lane == 0) record(m, ip, rec);
  }
  if (lane == 0) {
    T* ray = rays + (size_t)r * jrec::R_LEN;
    ray[jrec::R_CORR_IDX] = T(s.corr_idx);
    ray[jrec::R_CORR_VAL] = s.corr_val;
    ray[jrec::R_OK] = st.ok ? T(1) : T(0);
    ray[jrec::R_OK + 1] = T(0);
  }
  __syncwarp();
  ray_finish(m, pr, s, st, out_z, out_lon, out_lat, out_p, out_t, out_q,
             out_k, out_ds, out_u, out_valid, out_np, out_tsurf, out_tpz,
             out_tplon, out_tplat, out_flag, r, G, W, nlos, c, lane);
}

// ---------------------------------------------------------------------------
// Tangent kernel

// A thread's tangent of the ray's state between steps: position,
// direction, the last step's point and its altitude; tsurf's and the ds
// correction's
template <typename T>
struct TanRay {
  V3<T> dx, dex, dpx;
  T dpz, dtsurf, dcorr;
};

// The profiles' tangents of one thread: field f at level l of the ray
// (0 below a one-level window's only level, as lo_of reads)
template <typename T>
struct ProfTan {
  const T* __restrict__ d;  // [N, F, n] at the atm points
  const int* gis;           // [L] the ray's level -> atm point (shared)
  int F, n, k;
  __device__ __forceinline__ T at(int l, int f) const {
#ifdef JT_SPLIT_NOLOAD
    return l < 0 ? T(0) : T(gis[l] * F + f) * T(1e-6);
#else
    return l < 0 ? T(0) : __ldg(d + ((size_t)gis[l] * F + f) * n + k);
#endif
  }
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// |x| in [2^-100, 2^101) (float) or [2^-900, 2^901) (double): clear of
// overflow and of subnormals by far more than a quotient's steps need
__device__ __forceinline__ bool clear(float x) {
  return ((__float_as_uint(x) >> 23) & 0xffu) - 27u <= 200u;
}
__device__ __forceinline__ bool clear(double x) {
  return (unsigned)((__double_as_longlong(x) >> 52) & 0x7ff) - 123u <=
         1800u;
}

// 1 / b correctly rounded where b is clear(), else NaN: what quo_fast
// takes, once a block where b is the same for every thread
template <typename T>
__device__ __forceinline__ T recip(T b) {
  return clear(b) ? T(1) / b : T(__builtin_nan(""));
}

// a / b from r = recip(b): q = a r, then two of Markstein's corrections
// q + (a - b q) r, each remainder exact by fma.  Wherever a and the
// quotient are clear(), and b is (else r is NaN and so is the quotient),
// the result is the correctly rounded quotient, the division's bits
// (Markstein's theorem: r within half an ulp of 1 / b, the corrected q
// within an ulp of a / b); a zero a (most of the state's tangents leave
// the geometry unmoved) gives a r, the signed zero, where r is a number.
// True there, with the quotient in q.  ``jt_trace_quo_check`` holds it
// to the division on random pairs.
template <typename T>
__device__ __forceinline__ bool quo_fast(T a, T b, T r, T& q) {
  const T q0 = a * r;
  const T q1 = fma_rn(fma_rn(-b, q0, a), r, q0);
  const T q2 = fma_rn(fma_rn(-b, q1, a), r, q1);
  const bool zero = a == T(0);
  q = zero ? q0 : q2;
  return zero ? r == r : clear(a) && clear(q2);
}

// a / b in a tangent rule, r = recip(b): quo_fast's quotient, else the
// division itself
template <typename T>
__device__ __forceinline__ T quo(T a, T b, T r) {
#ifdef JT_SPLIT_NODIV
  return a * r;
#else
  T q;
  return quo_fast(a, b, r, q) ? q : a / b;
#endif
}

template <typename T>
__device__ __forceinline__ V3<T> rec3(const T* rc, int f) {
  return {rc[f], rc[f + 1], rc[f + 2]};
}

// What every thread of a block reads of a step besides its record: the
// LOS values the column densities read (p, the trapezoid ds, q[G]), and
// the values computed from primal values alone, once a block: the
// interpolation weight at z and 1 minus it, kb t, the reciprocals of the
// rules' divisors (RC_*), q's and k's slopes [G + W] and u's factor
// 10 q p / (kb t) [G]
template <typename T>
struct StepShared {
  T w, omw, b, p, ds;
  const T *rcp, *slope, *q, *cq;
};
// rcp[]: 1 / |x|, the clip's den and |xe|, kb t, refraction's |v| [4] and
// t [5] at its altitudes, |ex1|
enum : int { RC_RADIUS, RC_DEN, RC_RXE, RC_B, RC_RV, RC_T = 8, RC_EN = 13,
             RC_LEN };

// The tangent of one step in this thread from its record rc: updates d
// and writes the step's tangents of p, t, q[G], k[W] and, unless ``defer``
// (the step before the ray's ds correction), its trapezoid ds and u[G]
// from the raw ds tangent of the step before, dds_prev (the correction's
// own tangent where the step records it, ``fix``), to out[f n] (the
// thread's column of the step's [F, n] block).  Returns the step's raw ds
// tangent; dp and dt its p and t tangents.
template <bool REFRAC, typename T>
__device__ __forceinline__ T tangent_step(const T* __restrict__ rc,
                                          TanRay<T>& d, const ProfTan<T>& pt,
                                          const StepShared<T>& su,
                                          T* __restrict__ out, int G, int W,
                                          int n, T kb, bool write, bool defer,
                                          bool fix, T dds_prev, T& dp_out,
                                          T& dt_out) {
  using namespace jrec;
  const unsigned fl = (unsigned)rc[FLAGS];
  const V3<T> x0 = rec3(rc, X0), ex0 = rec3(rc, EX0);
  const T* rr = su.rcp;
  // step length: ds = raydz / |ex . x / |x||, clamped (jr_common.h:625-635)
  const T dr = quo(dot3(x0, d.dx), rc[RADIUS], rr[RC_RADIUS]);
  T dds = T(0);
  if (fl & F_DS_VAR) {
    const T norm_x = rc[NORM_X];
    const T dnorm = -(norm_x * norm_x) * dr;
    const T dc = (dot3(d.dex, x0) + dot3(ex0, d.dx)) * norm_x +
                 rc[EXX] * dnorm;
    dds = rc[DDS_DC] * dc;
  }
  T dz = dr;
  V3<T> dx = d.dx;
  T dds_corr = T(0);
  if (fl & F_ESCAPED) {  // the clip to the boundary
    const T frac = rc[FRAC];
    const V3<T> xh = rec3(rc, XH);
    const T dden = (fl & F_SAME) ? T(0) : dz - d.dpz;
    const T dfrac = quo(-d.dpz - frac * dden, rc[DEN], rr[RC_DEN]);
    dx = {d.dpx.x + dfrac * (x0.x - xh.x) + frac * (dx.x - d.dpx.x),
          d.dpx.y + dfrac * (x0.y - xh.y) + frac * (dx.y - d.dpx.y),
          d.dpx.z + dfrac * (x0.z - xh.z) + frac * (dx.z - d.dpx.z)};
    dds_corr = dds * frac + rc[DS_PRE] * dfrac;
    dz = quo(dot3(rec3(rc, XE), dx), rc[RXE], rr[RC_RXE]);
    dds = T(0);
  }

  // p and t at z (altitude 0's partials), then q and k there; the
  // trapezoid rule and the column densities (jr_common.h:438-453)
  const int i0 = (int)rc[IQ];
  const T* o0 = rc + OWN;
  // the p and t tangents at the levels of each altitude (z's, then
  // refraction's), loaded once where altitudes share an interval
  T lp[5], hp[5], lt[5], ht[5];
  lp[0] = pt.at(i0, 0);
  hp[0] = pt.at(i0 + 1, 0);
  lt[0] = pt.at(i0, 1);
  ht[0] = pt.at(i0 + 1, 1);
  const T dp = o0[O_PA] * lp[0] + o0[O_PB] * hp[0] + o0[O_PZ] * dz;
  const T dt = o0[O_TA] * lt[0] + o0[O_TB] * ht[0] + o0[O_TZ] * dz;
  if (write) {
    out[0] = dp;
    out[n] = dt;
    const T dds_trap = T(0.5) * ((fix ? dds_corr : dds_prev) + dds);
    if (!defer) out[(size_t)(2 + 2 * G + W) * n] = dds_trap;
    for (int f = 2; f < 2 + G + W; ++f) {
      const T dv = su.omw * pt.at(i0, f) + su.w * pt.at(i0 + 1, f) +
                   su.slope[f - 2] * dz;
      out[(size_t)f * n] = dv;
      if (f < 2 + G && !defer) {
        const T qv = su.q[f - 2], cq = su.cq[f - 2];
        const T dcq = quo(T(10) * (dv * su.p + qv * dp) - cq * (kb * dt),
                          su.b, rr[RC_B]);
        out[(size_t)(f + G + W) * n] = dcq * su.ds + cq * dds_trap;
      }
    }
  }
  if ((fl & F_STOPPING) && (fl & F_BELOW)) d.dtsurf = dt;
  if (fl & F_CORR) d.dcorr = dds_corr;
  dp_out = dp;
  dt_out = dt;

  // the direction: refraction's p and t at z and at the midpoint and its
  // three offset points, normalised
  V3<T> dex1 = d.dex;
  if constexpr (REFRAC) {
    const T h = T(0.02), hds = T(0.5) * rc[DS], dhds = T(0.5) * dds;
    const V3<T> dxh2{dx.x + dhds * ex0.x + hds * d.dex.x,
                     dx.y + dhds * ex0.y + hds * d.dex.y,
                     dx.z + dhds * ex0.z + hds * d.dex.z};
    const T xd = dot3(rec3(rc, XH2), dxh2);
    int iq[5];
    iq[0] = i0;
    T dn[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      T dzm = dz;
      if (m > 0) {
        const T off = m == 2 ? dxh2.x : m == 3 ? dxh2.y : m == 4 ? dxh2.z
                                                              : T(0);
        dzm = quo(xd + h * off, rc[RV + m - 1], rr[RC_RV + m - 1]);
        // refraction's offset points lie 20 m from the midpoint, and
        // mostly in z's interval
        iq[m] = (int)rc[IQ + m];
        if (iq[m] == i0) {
          lp[m] = lp[0];
          hp[m] = hp[0];
          lt[m] = lt[0];
          ht[m] = ht[0];
        } else if (m > 1 && iq[m] == iq[1]) {
          lp[m] = lp[1];
          hp[m] = hp[1];
          lt[m] = lt[1];
          ht[m] = ht[1];
        } else {
          lp[m] = pt.at(iq[m], 0);
          hp[m] = pt.at(iq[m] + 1, 0);
          lt[m] = pt.at(iq[m], 1);
          ht[m] = pt.at(iq[m] + 1, 1);
        }
      }
      const T* om = rc + OWN + m * O_LEN;
      const T dpm = om[O_PA] * lp[m] + om[O_PB] * hp[m] + om[O_PZ] * dzm;
      const T dtm = om[O_TA] * lt[m] + om[O_TB] * ht[m] + om[O_TZ] * dzm;
      dn[m] = quo(T(7.753e-05) * dpm - om[O_R] * dtm, om[O_T],
                  rr[RC_T + m]);
    }
    const bool use = fl & F_USE;
    const T dnf = use ? dn[0] : T(0);
    const T rh = recip(h);
    const V3<T> dg = use ? V3<T>{quo(dn[2] - dn[1], h, rh),
                                 quo(dn[3] - dn[1], h, rh),
                                 quo(dn[4] - dn[1], h, rh)}
                         : V3<T>{T(0), T(0), T(0)};
    const T nfac = rc[NFAC], ds = rc[DS];
    const V3<T> ng = rec3(rc, NG);
    dex1 = {d.dex.x * nfac + ex0.x * dnf + dds * ng.x + ds * dg.x,
            d.dex.y * nfac + ex0.y * dnf + dds * ng.y + ds * dg.y,
            d.dex.z * nfac + ex0.z * dnf + dds * ng.z + ds * dg.z};
  }
  const V3<T> ex1 = rec3(rc, EX1);
  const T en = rc[EN];
  const T proj = dot3(ex1, dex1);
  const V3<T> dex1n{quo(dex1.x - ex1.x * proj, en, rr[RC_EN]),
                    quo(dex1.y - ex1.y * proj, en, rr[RC_EN]),
                    quo(dex1.z - ex1.z * proj, en, rr[RC_EN])};
  d.dpx = dx;
  d.dpz = dz;
  if (fl & F_ADVANCE) {
    const T hds = T(0.5) * rc[DS], dhds = T(0.5) * dds;
    d.dx = {dx.x + dhds * (ex0.x + ex1.x) + hds * (d.dex.x + dex1n.x),
            dx.y + dhds * (ex0.y + ex1.y) + hds * (d.dex.y + dex1n.y),
            dx.z + dhds * (ex0.z + ex1.z) + hds * (d.dex.z + dex1n.z)};
    d.dex = dex1n;
  } else {
    d.dx = dx;
  }
  return dds;
}

// Values of one ring slot: CH steps' records, then their LOS p, t, ds
// [CH] each and q [CH, G]
__host__ __device__ inline size_t slot_len(int G) {
  return (size_t)CH * (jrec::LEN + 3 + G);
}

// Values a step shares with every thread of a block beyond its record
// and LOS values (StepShared): w, 1 - w, kb t, the reciprocals [RC_LEN],
// slopes [G + W], cq [G]
__host__ __device__ inline int shared_len(int G, int W) {
  return 3 + RC_LEN + 2 * G + W;
}

// Shared memory of a tangent block: the ray's z [L], q [G][L], k [W][L]
// and window indices [L] (rounded up to 16 bytes), then the ring's two
// slots and the current slot's StepShared values [CH][shared_len]
template <typename T>
__host__ __device__ size_t tan_prof_bytes(int L, int G, int W) {
  return ((size_t)(1 + G + W) * L * sizeof(T) + (size_t)L * 4 + 15) / 16 *
         16;
}
template <typename T>
__host__ __device__ size_t tan_block_bytes(int L, int G, int W) {
  return tan_prof_bytes<T>(L, G, W) +
         (2 * slot_len(G) + (size_t)CH * shared_len(G, W)) * sizeof(T);
}

template <typename T>
__device__ __forceinline__ void cp_value(T* dst, const T* src) {
  const unsigned da = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 8)
    cp8(da, src);
  else
    cp4(da, src);
}

// Steps ip0 .. ip0 + CH - 1 of ray r (fewer at the ray's end) into slot:
// the records in 16-byte pieces (a record is a multiple of 16 bytes), the
// LOS values one at a time; thread tid of nthr, one cp.async group
template <typename T>
__device__ __forceinline__ void load_slot(
    T* slot, const T* __restrict__ recs, const T* __restrict__ lp,
    const T* __restrict__ lt, const T* __restrict__ lds,
    const T* __restrict__ lq, int r, int nlos, int G, int ip0, int tid,
    int nthr) {
  const int steps = nlos - ip0 < CH ? nlos - ip0 : CH;
  const size_t row = (size_t)r * nlos + ip0;
  const unsigned da = (unsigned)__cvta_generic_to_shared(slot);
  const char* sa = reinterpret_cast<const char*>(recs + row * jrec::LEN);
  const int n16 = steps * jrec::LEN * (int)sizeof(T) / 16;
  for (int i = tid; i < n16; i += nthr) cp16(da + 16 * i, sa + 16 * i);
  T* los = slot + CH * jrec::LEN;
  for (int i = tid; i < steps; i += nthr) {
    cp_value(los + i, lp + row + i);
    cp_value(los + CH + i, lt + row + i);
    cp_value(los + 2 * CH + i, lds + row + i);
  }
  for (int i = tid; i < steps * G; i += nthr)
    cp_value(los + 3 * CH + i, lq + row * G + i);
  cp_commit();
}

// Block (r, y): ray r's tangents y blockDim.x + threadIdx.x, one a thread
template <typename T, bool REFRAC>
__global__ void __launch_bounds__(TAN_THREADS, tan_blocks<T>())
    trace_jvp_tangent_kernel(
        const T* __restrict__ pz_, const T* __restrict__ pq_,
        const T* __restrict__ pk_, const T* __restrict__ dA,
        const int* __restrict__ gi, const T* __restrict__ recs,
        const T* __restrict__ rays, const T* __restrict__ lp,
        const T* __restrict__ lt, const T* __restrict__ lds,
        const T* __restrict__ lq, T* __restrict__ seg,
        T* __restrict__ dtsurf, int L, int G, int W, int nlos, int n, T kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x, r = blockIdx.x;
  const int k = blockIdx.y * nthr + tid;
  const bool kv = k < n;
  T* z = reinterpret_cast<T*>(smem);
  T* q = z + L;
  T* kk = q + (size_t)G * L;
  int* gis = reinterpret_cast<int*>(kk + (size_t)W * L);
  T* ring = reinterpret_cast<T*>(smem + tan_prof_bytes<T>(L, G, W));
  const size_t slot = slot_len(G);
  const int nch = (nlos + CH - 1) / CH;
  load_slot(ring, recs, lp, lt, lds, lq, r, nlos, G, 0, tid, nthr);
  for (int j = tid; j < L; j += nthr) {
    z[j] = pz_[(size_t)r * L + j];
    gis[j] = gi[(size_t)r * L + j];
  }
  for (int j = tid; j < G * L; j += nthr) q[j] = pq_[(size_t)r * G * L + j];
  for (int j = tid; j < W * L; j += nthr) kk[j] = pk_[(size_t)r * W * L + j];
  T* U = ring + 2 * slot;
  const int nu = shared_len(G, W);
  const ProfTan<T> ptan{dA, gis, 2 + G + W, n, kv ? k : n - 1};
  const int F = 3 + 2 * G + W, fds = 2 + 2 * G + W, fu = 2 + G + W;
  const int corr_idx = (int)rays[(size_t)r * jrec::R_LEN + jrec::R_CORR_IDX];
  const bool traced = rays[(size_t)r * jrec::R_LEN + jrec::R_OK] != T(0);
  T* o_ray = seg + (size_t)r * nlos * F * n + ptan.k;

  TanRay<T> d;
  d.dx = d.dex = d.dpx = V3<T>{T(0), T(0), T(0)};
  d.dpz = d.dtsurf = d.dcorr = T(0);
  T dds_prev = T(0), dds_pc = T(0), dp_c = T(0), dt_c = T(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load_slot(ring + ((ch + 1) & 1) * slot, recs, lp, lt, lds, lq, r, nlos,
                G, (ch + 1) * CH, tid, nthr);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* sl = ring + (ch & 1) * slot;
    const T* sl_los = sl + CH * jrec::LEN;
    const int steps = nlos - ch * CH < CH ? nlos - ch * CH : CH;
    // the slot's StepShared values, each computed once a block
    for (int e = tid; e < steps * nu; e += nthr) {
      const int j = e / nu, item = e - j * nu;
      const T* rc = sl + j * jrec::LEN;
      const int i0 = (int)rc[jrec::IQ];
      const T za = lo_of(z, i0), inv = T(1) / (z[i0 + 1] - za);
      const T w = (rc[jrec::Z] - za) * inv, b = kb * sl_los[CH + j];
      T v;
      if (item < 2) {
        v = item == 0 ? w : T(1) - w;
      } else if (item == 2) {
        v = b;
      } else if (item < 3 + RC_LEN) {
        const int c = item - 3;
        const T den = c == RC_RADIUS ? rc[jrec::RADIUS]
                      : c == RC_DEN  ? rc[jrec::DEN]
                      : c == RC_RXE  ? rc[jrec::RXE]
                      : c == RC_B    ? b
                      : c < RC_T     ? rc[jrec::RV + c - RC_RV]
                      : c < RC_EN    ? rc[jrec::OWN + (c - RC_T) * jrec::O_LEN
                                          + jrec::O_T]
                                     : rc[jrec::EN];
        v = recip(den);
      } else if (item < 3 + RC_LEN + G + W) {
        const int f = item - 3 - RC_LEN;
        const T* row = f < G ? q + (size_t)f * L : kk + (size_t)(f - G) * L;
        v = (row[i0 + 1] - lo_of(row, i0)) * inv;
      } else {
        v = T(10) * sl_los[3 * CH + j * G + item - 3 - RC_LEN - G - W] *
            sl_los[j] / b;
      }
      U[e] = v;
    }
    __syncthreads();
    for (int j = 0; j < steps; ++j) {
      const int ip = ch * CH + j;
      const bool defer = ip == corr_idx - 1;
      const bool fix = ip == corr_idx && corr_idx >= 1;
      const T* u = U + j * nu;
      const StepShared<T> su{u[0],
                             u[1],
                             u[2],
                             sl_los[j],
                             sl_los[2 * CH + j],
                             u + 3,
                             u + 3 + RC_LEN,
                             sl_los + 3 * CH + j * G,
                             u + 3 + RC_LEN + G + W};
      T* out = o_ray + (size_t)ip * F * n;
      T dp, dt;
      const T dds = tangent_step<REFRAC>(sl + j * jrec::LEN, d, ptan, su,
                                         out, G, W, n, kb, kv, defer, fix,
                                         dds_prev, dp, dt);
      if (defer) {  // finished by the step of the correction
        dds_pc = dds_prev;
        dp_c = dp;
        dt_c = dt;
      } else if (fix && kv) {
        // the step before, its raw ds the correction (jr_common.h:646)
        const size_t row = (size_t)r * nlos + ip - 1;
        const T p = __ldg(lp + row), t = __ldg(lt + row);
        const T ds = __ldg(lds + row);
        const T dds_trap = T(0.5) * (dds_pc + d.dcorr);
        T* o1 = out - (size_t)F * n;
        o1[(size_t)fds * n] = dds_trap;
        const T b = kb * t;
        for (int g = 0; g < G; ++g) {
          const T qv = __ldg(lq + row * G + g);
          const T cq = T(10) * qv * p / b;
          const T dcq =
              (T(10) * (o1[(size_t)(2 + g) * n] * p + qv * dp_c) -
               cq * (kb * dt_c)) / b;
          o1[(size_t)(fu + g) * n] = dcq * ds + cq * dds_trap;
        }
      }
      dds_prev = dds;
    }
    __syncthreads();
  }
  if (kv) dtsurf[(size_t)r * n + k] = traced ? d.dtsurf : T(0);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  // beyond the default a block opts in (the card refuses beyond 227 KB)
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
const void* record_kernel(int refrac) {
  return refrac ? (const void*)trace_jvp_record_kernel<T, true>
                : (const void*)trace_jvp_record_kernel<T, false>;
}

template <typename T>
const void* tangent_kernel(int refrac) {
  return refrac ? (const void*)trace_jvp_tangent_kernel<T, true>
                : (const void*)trace_jvp_tangent_kernel<T, false>;
}

template <typename T>
int launch_records(const void* const* in, void* const* out, int R, int L,
                   int G, int W, int nlos, double rayds, double raydz,
                   int refrac, int entry_iters, double re, double deg2rad,
                   double rad2deg, double kb, double z_refrac,
                   cudaStream_t stream) {
  const size_t smem = rec_block_bytes<T>(L, G, W, nlos);
  auto kernel = refrac ? trace_jvp_record_kernel<T, true>
                       : trace_jvp_record_kernel<T, false>;
  const cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const Consts<T> c{T(re),       T(deg2rad),           T(rad2deg),
                    T(kb),       T(z_refrac),          T(__builtin_nan("")),
                    T(__builtin_huge_val())};
  kernel<<<R, 32, smem, stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const int*)in[5], (const T*)in[6], (const T*)in[7],
      (const T*)in[8], (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3],
      (T*)out[4], (T*)out[5], (T*)out[6], (T*)out[7], (T*)out[8],
      (uint8_t*)out[9], (int*)out[10], (T*)out[11], (T*)out[12], (T*)out[13],
      (T*)out[14], (int*)out[15], (T*)out[16], (T*)out[17], R, L, G, W, nlos,
      T(rayds), T(raydz), raydz > 0.0, entry_iters, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tangents(const void* const* in, void* seg, void* dtsurf, int R,
                    int L, int G, int W, int nlos, int n, int refrac,
                    double kb, cudaStream_t stream) {
  const size_t smem = tan_block_bytes<T>(L, G, W);
  auto kernel = refrac ? trace_jvp_tangent_kernel<T, true>
                       : trace_jvp_tangent_kernel<T, false>;
  const cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int warps = (n + 31) / 32;
  const int threads = warps * 32 < TAN_THREADS ? warps * 32 : TAN_THREADS;
  const dim3 grid(R, (n + threads - 1) / threads);
  kernel<<<grid, threads, smem, stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const int*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const T*)in[8], (const T*)in[9], (const T*)in[10], (T*)seg,
      (T*)dtsurf, L, G, W, nlos, n, T(kb));
  return (int)cudaGetLastError();
}

// quo_fast against the division on random pairs, n in float and n in
// double: exponents uniform over clear()'s range and ten binades beyond
// it on both sides, mantissas random (one in 8 all ones, for b one in 8
// zero), signs random, one a in 16 a signed zero; counts[4] += {float
// pairs on the fast path, those whose quotient differs from a / b in any
// bit, the same in double}
__global__ void quo_check_kernel(unsigned long long* counts, long long n,
                                 unsigned long long seed) {
  unsigned long long c[4] = {0, 0, 0, 0};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long h = splitmix64(seed ^ (unsigned long long)i);
    const unsigned long long g = splitmix64(h), k = splitmix64(g);
    const bool ones_a = (k & 7) == 0, ones_b = ((k >> 3) & 7) == 0;
    const bool zero_b = ((k >> 6) & 7) == 1, zero_a = ((k >> 9) & 15) == 0;
    {
      const unsigned ea = 17u + (unsigned)(h & 0xffff) % 221u;
      const unsigned eb = 17u + (unsigned)((h >> 16) & 0xffff) % 221u;
      const unsigned ma = ones_a ? 0x7fffffu : (unsigned)g & 0x7fffffu;
      const unsigned mb = ones_b   ? 0x7fffffu
                          : zero_b ? 0u
                                   : (unsigned)(g >> 23) & 0x7fffffu;
      unsigned ua = (unsigned)((k >> 13) & 1) << 31 | ea << 23 | ma;
      const unsigned ub = (unsigned)((k >> 14) & 1) << 31 | eb << 23 | mb;
      if (zero_a) ua &= 0x80000000u;
      const float a = __uint_as_float(ua), b = __uint_as_float(ub);
      float q;
      if (quo_fast(a, b, recip(b), q)) {
        c[0] += 1;
        c[1] += __float_as_uint(q) != __float_as_uint(a / b);
      }
    }
    {
      const unsigned long long ea = 113u + (h >> 32 & 0xffff) % 1821u;
      const unsigned long long eb = 113u + (h >> 48) % 1821u;
      const unsigned long long full = 0xfffffffffffffull;
      const unsigned long long ma = ones_a ? full : g & full;
      const unsigned long long mb = ones_b ? full : zero_b ? 0ull : k & full;
      unsigned long long ua = ((k >> 15) & 1) << 63 | ea << 52 | ma;
      const unsigned long long ub = ((k >> 16) & 1) << 63 | eb << 52 | mb;
      if (zero_a) ua &= 1ull << 63;
      const double a = __longlong_as_double((long long)ua);
      const double b = __longlong_as_double((long long)ub);
      double q;
      if (quo_fast(a, b, recip(b), q)) {
        c[2] += 1;
        c[3] += __double_as_longlong(q) != __double_as_longlong(a / b);
      }
    }
  }
  for (int j = 0; j < 4; ++j) {
    unsigned long long v = c[j];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(counts + j, v);
  }
}

}  // namespace

// The check of the tangent kernel's division (quo_check_kernel): counts
// [4] uint64, accumulated; n random pairs in each dtype from seed.
extern "C" int jt_trace_quo_check(void* counts, long long n, long long seed,
                                  void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  quo_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)counts, n, (unsigned long long)seed);
  return (int)cudaGetLastError();
}

// Kernel 1, the records.  Pointers: the profiles z, p, t [R, L], q
// [R, G, L], k [R, W, L], nlev [R] int32, zmin, zmax [R], the observation
// geometry [6, R] (in[0..8], as jt_trace_rays), then the LosData outputs
// of jt_trace_rays, the bisection flag [R] int32, the step records
// [R, NLOS, step_len] and the ray records [R, ray_len] of
// jt_trace_jvp_record_len (out[0..17]).  A block of one warp for each
// ray.
extern "C" int jt_trace_jvp_records(
    const void* z, const void* p, const void* t, const void* q,
    const void* k, const void* nlev, const void* zmin, const void* zmax,
    const void* geo, void* oz, void* olon, void* olat, void* op, void* ot,
    void* oq, void* ok, void* ods, void* ou, void* ovalid, void* onp,
    void* otsurf, void* otpz, void* otplon, void* otplat, void* oflag,
    void* orec, void* oray, int R, int L, int G, int W, int nlos,
    double rayds, double raydz, int refrac, int entry_iters, double re,
    double deg2rad, double rad2deg, double kb, double z_refrac,
    int is_double, void* stream) {
  if (R < 1 || L < 1 || G < 0 || W < 0 || nlos < 3 || entry_iters < 0)
    return (int)cudaErrorInvalidValue;
  const void* in[9] = {z, p, t, q, k, nlev, zmin, zmax, geo};
  void* out[18] = {oz,     olon,  olat,   op,     ot,     oq,
                   ok,     ods,   ou,     ovalid, onp,    otsurf,
                   otpz,   otplon, otplat, oflag, orec,  oray};
  cudaStream_t st = (cudaStream_t)stream;
  return is_double
             ? launch_records<double>(in, out, R, L, G, W, nlos, rayds,
                                      raydz, refrac, entry_iters, re,
                                      deg2rad, rad2deg, kb, z_refrac, st)
             : launch_records<float>(in, out, R, L, G, W, nlos, rayds, raydz,
                                     refrac, entry_iters, re, deg2rad,
                                     rad2deg, kb, z_refrac, st);
}

// Kernel 2, the tangents.  Pointers: the profiles z [R, L], q [R, G, L],
// k [R, W, L], the profile tangents [N, 2 + G + W, n] at the atm points,
// the window indices gi [R, L] int32, the step and ray records of
// jt_trace_jvp_records and its LOS p, t, ds [R, NLOS] and q [R, NLOS, G];
// out: the LOS tangents [R, NLOS, 3 + 2 G + W, n] (p, t, q[G], k[W],
// u[G], ds) and tsurf's [R, n].  Blocks of min(32 ceil(n / 32), 256)
// threads, ceil(n / 256) a ray.
extern "C" int jt_trace_jvp_tangents(
    const void* z, const void* q, const void* k, const void* dA,
    const void* gi, const void* rec, const void* ray, const void* lp,
    const void* lt, const void* lds, const void* lq, void* oseg,
    void* odtsurf, int R, int L, int G, int W, int nlos, int n, int refrac,
    double kb, int is_double, void* stream) {
  if (R < 1 || L < 1 || G < 0 || W < 0 || nlos < 3 || n < 1)
    return (int)cudaErrorInvalidValue;
  const void* in[11] = {z, q, k, dA, gi, rec, ray, lp, lt, lds, lq};
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch_tangents<double>(in, oseg, odtsurf, R, L, G, W,
                                             nlos, n, refrac, kb, st)
                   : launch_tangents<float>(in, oseg, odtsurf, R, L, G, W,
                                            nlos, n, refrac, kb, st);
}

// The record layout: values of a step's record into *step, of a ray's
// into *ray (int each); the wrapper allocates by them.
extern "C" int jt_trace_jvp_record_len(void* step, void* ray) {
  *(int*)step = jrec::LEN;
  *(int*)ray = jrec::R_LEN;
  return 0;
}

// The bytes of shared memory the larger of the two kernels' blocks takes
// at these sizes, into *bytes (long long).
extern "C" int jt_trace_jvp_smem_bytes(int L, int G, int W, int nlos,
                                       int is_double, void* bytes) {
  if (L < 1 || G < 0 || W < 0 || nlos < 0) return (int)cudaErrorInvalidValue;
  const size_t a = is_double ? rec_block_bytes<double>(L, G, W, nlos)
                             : rec_block_bytes<float>(L, G, W, nlos);
  const size_t b = is_double ? tan_block_bytes<double>(L, G, W)
                             : tan_block_bytes<float>(L, G, W);
  *(long long*)bytes = (long long)(a > b ? a : b);
  return 0;
}

// Registers and local memory (stack frame, spills included) of the
// instantiations a launch in that dtype and REFRAC takes: out int [4] =
// {record kernel registers, its local bytes, tangent kernel registers,
// its local bytes}.
extern "C" int jt_trace_jvp_registers(int is_double, int refrac, void* out) {
  const void* fr = is_double ? record_kernel<double>(refrac)
                             : record_kernel<float>(refrac);
  const void* ft = is_double ? tangent_kernel<double>(refrac)
                             : tangent_kernel<float>(refrac);
  cudaFuncAttributes ar, at;
  cudaError_t e = cudaFuncGetAttributes(&ar, fr);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, ft);
  if (e != cudaSuccess) return (int)e;
  int* o = (int*)out;
  o[0] = ar.numRegs;
  o[1] = (int)ar.localSizeBytes;
  o[2] = at.numRegs;
  o[3] = (int)at.localSizeBytes;
  return 0;
}
