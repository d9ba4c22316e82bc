// Tangent pass of the eager RT pass: the RT half of the JAX package's
// compiled forward-mode Jacobian (``jax.jit(jax.jacfwd(fwd))``,
// jurassic_tpu/retrieval.py:281, through the ``lax.scan`` of
// ``rt_integrate``, jurassic_tpu/forward.py:99-213, on the fast tables of
// ``ega_eps_fast``, jurassic_tpu/ops/ega.py:171, or on the exact tables of
// ``ega_eps_exact``, :82).  For every (ray, channel) the radiance of
// ``forward.rt_integrate`` (surface and brightness epilogue included) and
// its tangent drad [R, D, n] in the
// directions of the LOS tangents [R, S, F = 3 + 2 G + W, n] (p, t, q[G],
// k[W], u[G], ds) and tsurf's [R, n] of the tracer tangent kernel.  Its
// plain version is ``forward.rt_integrate_jvp_ref``; ``ops.ega_jvp.
// rt_jvp_adjoint_ref`` states the algebra below in plain PyTorch.
//
// The tangent map is linear in the LOS tangents, and every coefficient of
// it is a local partial of one (segment, channel).  So the pass is one
// adjoint and one product, two kernels:
//   * ega_rec_kernel: the primal recursion and each valid (segment,
//     channel)'s local partials (ops.ega.ega_eps_fast_partials, or
//     ega_eps_exact_partials in the exact instantiation: the corner
//     searches, their slopes behind the clamps, the bilinear (t, p)
//     weights, the factor's guards; ops.continua.beta_ds_partials; the
//     Planck slope), one record of rec_len(G, W) values, channels
//     innermost; then, the same thread, a sweep back over its records
//     carrying the adjoints of rad, tau and tau_path[G] from the surface
//     and brightness epilogue, which turns each record in place into
//     A[segment, F, channel], the radiance's sensitivity to the segment's
//     F LOS fields, and writes a_surf [R, D], its sensitivity to tsurf.
//   * ega_contract_*: per ray drad = A_r [D x F S_r] . dLOS_r [F S_r x n]
//     + a_surf (x) dtsurf over the ray's valid segments only (the records
//     are compacted; the LOS tangents are read through each record's
//     segment index), a block per (ray, tangent tile) holding all the
//     ray's channels, so each LOS tangent is read once for all of them.
//     Float64 on the tensor cores (mma.sync m8n8k4, DMMA), float32 on the
//     FMA units (not TF32), one tile shape each (partial tiles checked);
//     the K chunks (a few segments) pass through a ring of three
//     shared-memory stages filled by cp.async while the last chunk is
//     multiplied.
//
// What bounds it, and what the design does (PERF.md, the H100).  The
// record kernel: per (valid segment, channel) about 510 operations of
// primal and partials and the records' bytes, written, read back and
// overwritten (18 GB in float64 at the flagship).  What held its first
// form (a thread per (ray, channel), 40 ms in float32) was latency: per
// segment and gas a count over the channel's own p and T axis rows (about
// 100 uncoalesced loads) and per corner an 8-step halving of dependent
// table loads.  Here a block owns NR adjacent rays x all channels (their
// corners share L1 lines, as in the fused kernels).  Where the tables'
// axes are bitwise the same in every channel (``FastDeviceTables.
// uniform``) the block brackets each (segment, gas) once, a chunk of
// segments ahead, into shared memory, with channel 0's count searches, so
// the indices are ``_count_index``'s; otherwise (a second instantiation)
// every lane brackets on a channel-innermost copy of the axes, whose
// loads coalesce over a warp.  Where the eps rows are monotone
// (``FastDeviceTables.monotone``) a corner first checks the last
// segment's forward index h: on a monotone row the halving's answer is
// the one i in [0, max(nk - 2, 0)] with (i = 0 or row[i] <= target) and
// (i = max(nk - 2, 0) or row[i + 1] > target), so i in {h - 1, h, h + 1}
// that passes is it, from four independent loads
// (``ops.ega_jvp.hinted_halving``); otherwise it halves.  The contraction:
// 2 D n F per valid segment, 8.5e10 flops at the flagship, 1.3 ms at 67
// TFLOP/s, or the bytes of A and the LOS tangents (6 GB in float64).
// At the flagship Jacobian (n = 130) on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md): the record kernel 14.70 / 23.34 ms in float32
// / float64 (bounds 0.53 / 0.99 ms; the first form's record kernel
// 40.38 ms in float32), the contraction 4.04 / 6.67 ms (bounds 1.28 /
// 1.84 ms).  In float64 the contraction is slower than one torch.bmm of
// the dense product (5.6 ms): without its loads it takes 3.8 ms, without
// its DMMA 3.6 ms, each about twice its bound, and the two barely overlap
// (tools/jvp_split.py).
//
// The step's device code (brackets, the fast and the exact corners, a
// gas's factor and partials, continua, source, epilogue) is
// ega_rt_common.cuh's, which the primal RT kernel (ega_rt.cu) shares, and
// so is the launch (rt_shape): a block a group of adjacent rays.  On the
// exact tables the corners' first trips are in flight together, from
// windows of the channel-innermost rows, at two blocks an SM (MinBlocks);
// on the fast tables three.
//
// Numbers: the primal repeats the plain version's operations in its order
// (-fmad=false, libdevice's transcendentals; ega_rt_common.cuh states the
// continua as PyTorch's CUDA operators compute them, which took the last
// lanes rad and tau were an ulp off), so the searches' decisions, rad
// and tau are the plain pass's.  drad sums in another order (the
// adjoint, then the product in tiles, with FMA) than the plain forward
// recursion: it is held to the plain version within a tolerance (1e-10
// of max|drad| in float64, 1e-3 in float32), no longer bit for bit.
//
// The kernels allocate nothing and launch on the caller's stream; the
// caller gives the records' buffer, each ray's first record and the
// records' segment indices.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "ega_rt_common.cuh"

namespace {

using namespace jt_cp;
using namespace jt_rt;

// The contraction's ring; tools/jvp_split.py builds variants with
// -DJT_CT_STAGES, -DJT_CT_SMEM (bytes) and -DJT_CT_KS_MAX
#ifndef JT_CT_STAGES
#define JT_CT_STAGES 3
#endif
#ifndef JT_CT_SMEM
#define JT_CT_SMEM (110 * 1024)
#endif
#ifndef JT_CT_KS_MAX
#define JT_CT_KS_MAX 8
#endif
constexpr int CT_THREADS = 256;   // threads of a contraction block
constexpr int CT_STAGES = JT_CT_STAGES;  // shared-memory stages of its K ring
constexpr int CT_SMEM = JT_CT_SMEM;  // budget of the ring (two blocks an SM)
constexpr int CT_SMEM_MAX = 227 * 1024;
constexpr int KS_MAX = JT_CT_KS_MAX;  // segments of a K chunk

// A record of a valid (segment, channel): per gas its factor, the
// factor's partials in tau_path, t, p and u, and tau_path before the
// segment; the extinction's partials (ops.continua.BDS_INPUTS); exp(-bds),
// the source, its slope in t and tau before the segment.  tau_gas and
// whether the segment updates rad and tau are recomputed from the factors
// in the primal's order.  The adjoint sweep overwrites the first F values
// with A, so a record holds at least F.
constexpr int REC_GAS = 6, REC_TAIL = 11;
__host__ __device__ __forceinline__ int rec_len(int G, int W) {
  const int a = REC_GAS * G + REC_TAIL, f = 3 + 2 * G + W;
  return a > f ? a : f;
}

// the resident blocks an SM that the record kernel asks (ega_rt_common.cuh)
template <class TB>
using RecBlocks = MinBlocks<TB, true>;

template <typename T, bool UNI, class TB>
__global__ void __launch_bounds__(RT_THREADS, RecBlocks<TB>::value)
    ega_rec_kernel(
    TB tb, const T* __restrict__ cc, const int* __restrict__ window,
    const T* __restrict__ sr, const T* __restrict__ st,
    const T* __restrict__ nu_ch, const T* __restrict__ lp,
    const T* __restrict__ lt, const T* __restrict__ lds,
    const T* __restrict__ lq, const T* __restrict__ lk,
    const T* __restrict__ lu, const uint8_t* __restrict__ lvalid,
    const T* __restrict__ ltsurf, const long long* __restrict__ first,
    T* __restrict__ rec, int* __restrict__ sidx, T* __restrict__ asurf,
    T* __restrict__ rad_out, T* __restrict__ tau_out, int R, int S, int G,
    int W, int n_src, int flags, int ig_co2, int ig_h2o, int bbt, int hint,
    int NR, int CH, Consts cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = tb.ax.D, C = rec_len(G, W);
  const int bd = blockDim.x, tid = threadIdx.x;
  const int ray0 = blockIdx.x * NR, L = NR * D;
  // shared: the chunk's brackets [CH][NR][G] (UNI), per thread tau_path
  // (then its tangent's adjoint), two [G] scratch rows of the sweep, the
  // corners' hints [G][4], and each ray's segment bound
  Bracket* s_br = reinterpret_cast<Bracket*>(smem);
  T* s_tp = reinterpret_cast<T*>(s_br + (UNI ? CH * NR * G : 0)) + tid;
  T* s_x = s_tp + G * bd;
  T* s_y = s_x + G * bd;
  int* s_hint = reinterpret_cast<int*>(s_tp - tid + 3 * G * bd) + tid;
  int* s_nb = s_hint - tid + 4 * G * bd;
  for (int i = tid; i < NR; i += bd) s_nb[i] = 0;
  __syncthreads();
  // each ray's segments end after its last valid one
  for (int i = tid; i < NR * S; i += bd) {
    const int rr = i / S, s = i - rr * S;
    if (ray0 + rr < R && lvalid[(size_t)(ray0 + rr) * S + s])
      atomicMax(s_nb + rr, s + 1);
  }
  __syncthreads();
  int smax = 0;
  for (int i = 0; i < NR; ++i) smax = smax > s_nb[i] ? smax : s_nb[i];

  for (int i0 = 0; i0 < L; i0 += bd) {
    const int i = i0 + tid;
    const int rl = i < L ? i / D : 0;
    const int d = i < L ? i - rl * D : 0;
    const int r = ray0 + rl;
    const bool live = i < L && r < R;
    for (int g = 0; g < G; ++g) {
      s_tp[g * bd] = T(1);
#pragma unroll
      for (int c = 0; c < 4; ++c) s_hint[(g * 4 + c) * bd] = 0;
    }
    const int wd = W > 0 ? window[d] : 0;
    T rad = T(0), tau = T(1);
    long long k = live ? first[r] : 0;
    for (int s0 = 0; s0 < smax; s0 += CH) {
      const int ns = CH < smax - s0 ? CH : smax - s0;
      if (UNI) {
        // bracket the chunk once for all channels: a task per (segment,
        // ray, gas), task = (sl NR + ray) G + gas, on channel 0's axes
        __syncthreads();  // the last chunk's readers are done
        for (int task = tid; task < ns * NR * G; task += bd) {
          const int g = task % G, rr = (task / G) % NR;
          const int s = s0 + task / (G * NR);
          Bracket b{};
          if (ray0 + rr < R && s < s_nb[rr]) {
            const size_t rs = (size_t)(ray0 + rr) * S + s;
            if (lvalid[rs])
              b = bracket(tb.ax, g, 0, (double)lp[rs], (double)lt[rs]);
          }
          s_br[task] = b;
        }
#ifdef JT_SPLIT_NOBAR
        __syncthreads();  // tools/rt_split.py: the brackets, no more
#endif
      }
      for (int sl = 0; sl < ns; ++sl) {
        // one barrier per segment: the warps of the block's rays stay at
        // the same segment, where neighbouring rays read the same cells
#ifndef JT_SPLIT_NOBAR
        __syncthreads();
#endif
        const int s = s0 + sl;
        if (!live || s >= s_nb[rl]) continue;
        const size_t rs = (size_t)r * S + s;
        if (!lvalid[rs]) continue;
        const T p = lp[rs], t = lt[rs], ds = lds[rs];
        if (d == 0) sidx[k] = s;
        T* o = rec + (size_t)k * C * D + d;  // field c at o[c D]
        ++k;
        T tau_gas = T(1);
        for (int g = 0; g < G; ++g) {
          const T tpg = s_tp[g * bd], ug = lu[rs * G + g];
          const Bracket b = UNI ? s_br[(sl * NR + rl) * G + g]
                                : bracket(tb.ax, g, d, (double)p, (double)t);
          T cw[12];
          const bool ok_all =
              gas_corners(tb, cs, g, d, b, T(1) - tpg, ug, hint != 0,
                          s_hint + g * 4 * bd, bd, cw);
          T f[5];
          gas_factor<T, typename Bil<TB, T>::type>(cs, b, cw, ok_all, p, t,
                                                   tpg, f);
#pragma unroll
          for (int j = 0; j < 5; ++j) o[(size_t)(REC_GAS * g + j) * D] = f[j];
          o[(size_t)(REC_GAS * g + 5) * D] = tpg;
          tau_gas = g == 0 ? f[0] : tau_gas * f[0];
          s_tp[g * bd] = tpg * f[0];
        }
        T bp[7];
        const T qh = ig_h2o >= 0 ? lq[rs * G + ig_h2o] : T(0);
        const T uh = ig_h2o >= 0 ? lu[rs * G + ig_h2o] : T(0);
        const T uc = ig_co2 >= 0 ? lu[rs * G + ig_co2] : T(0);
        const T bds = continua(cc, D, d, flags, cs,
                               W > 0 ? lk[rs * W + wd] : T(0), ds, p, t, qh,
                               uc, uh, bp);
        T slope;
        const T srcv = source(sr, st, n_src, D, d, t, slope);
        const T ex = m_exp(-bds);
        const T eps = T(1) - tau_gas * ex;
        T* ot = o + (size_t)REC_GAS * G * D;
#pragma unroll
        for (int j = 0; j < 7; ++j) ot[(size_t)j * D] = bp[j];
        ot[(size_t)7 * D] = ex;
        ot[(size_t)8 * D] = srcv;
        ot[(size_t)9 * D] = slope;
        ot[(size_t)10 * D] = tau;
        if (tau_gas > T(cs.tau_cutoff)) {
          rad = rad + srcv * eps * tau;
          tau = tau * (T(1) - eps);
        }
      }
    }
    if (!live) continue;
    // surface emission and the brightness conversion (_surface_and_bbt)
    const T ts = ltsurf[r];
    const bool hit = ts > T(0);
    T coef, ss, sl_s;
    const T r_out = epilogue(sr, st, n_src, D, d, rad, tau, ts, nu_ch, bbt,
                             cs, coef, ss, sl_s);
    rad_out[(size_t)r * D + d] = r_out;
    tau_out[(size_t)r * D + d] = tau;

    // the adjoint sweep: the output's sensitivity drad = coef (drad_N +
    // [hit] (sl dts tau_N + ss dtau_N)) back through the records
    const T a_rad = coef;
    T a_tau = hit ? coef * ss : T(0);
    asurf[(size_t)r * D + d] = hit ? coef * sl_s * tau : T(0);
    for (int g = 0; g < G; ++g) s_tp[g * bd] = T(0);  // adjoint of dtp[g]
    const long long kf = first[r];
    const int tb0 = REC_GAS * G;
    for (long long kk = k - 1; kk >= kf; --kk) {
      T* o = rec + (size_t)kk * C * D + d;
      T bp[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) bp[j] = o[(size_t)(tb0 + j) * D];
      const T ex = o[(size_t)(tb0 + 7) * D], srcv = o[(size_t)(tb0 + 8) * D];
      const T slope = o[(size_t)(tb0 + 9) * D];
      const T tau_b = o[(size_t)(tb0 + 10) * D];
      // tau_gas in the primal's order, and the prefix products
      T tg = T(1);
      for (int g = 0; g < G; ++g) {
        const T f = o[(size_t)(REC_GAS * g) * D];
        s_x[g * bd] = tg;
        tg = g == 0 ? f : tg * f;
      }
      const bool upd = tg > T(cs.tau_cutoff);
      const T eps = T(1) - tg * ex;
      T At = T(0), Ap = T(0), a_deps = T(0);
      if (upd) {  // drad += (slope dt eps + src deps) tau + src eps dtau;
                  // dtau = dtau (1 - eps) - tau deps
        a_deps = (a_rad * srcv - a_tau) * tau_b;
        At = a_rad * slope * eps * tau_b;
        a_tau = a_rad * srcv * eps + a_tau * (T(1) - eps);
      }
      const T a_dbds = a_deps * tg * ex;  // deps = tau_gas ex dbds - dtg ex
      T a_dtg = -(a_deps * ex);
      for (int g = G - 1; g >= 0; --g) {
        // dtg = dtg_(g-1) f_g + prod_(g-1) df_g; dtp_g = dtp_g f_g +
        // tp_g df_g; df_g = f_tp dtp_g + f_t dt + f_p dp + f_u du_g
        const T* q = o + (size_t)(REC_GAS * g) * D;
        const T f = q[0], f_tp = q[D], f_t = q[2 * D], f_p = q[3 * D];
        const T f_u = q[4 * D], tpo = q[5 * D];
        T& atp = s_tp[g * bd];
        const T a_df = atp * tpo + a_dtg * s_x[g * bd];
        a_dtg = a_dtg * f;
        atp = atp * f + a_df * f_tp;
        At = At + a_df * f_t;
        Ap = Ap + a_df * f_p;
        s_y[g * bd] = a_df * f_u;
      }
      // dbds = b0 dk + b1 dds + b2 dp + b3 dt + b4 dq_h2o + b5 du_co2 +
      // b6 du_h2o
      Ap = Ap + a_dbds * bp[2];
      At = At + a_dbds * bp[3];
      // A over the record: p, t, q[G], k[W], u[G] (CO2's and H2O's with
      // the continua's share), ds
      o[0] = Ap;
      o[(size_t)D] = At;
      for (int g = 0; g < G; ++g)
        o[(size_t)(2 + g) * D] = g == ig_h2o ? a_dbds * bp[4] : T(0);
      for (int w = 0; w < W; ++w)
        o[(size_t)(2 + G + w) * D] = w == wd ? a_dbds * bp[0] : T(0);
      for (int g = 0; g < G; ++g) {
        T au = s_y[g * bd];
        if (g == ig_co2) au = au + a_dbds * bp[5];
        if (g == ig_h2o) au = au + a_dbds * bp[6];
        o[(size_t)(2 + G + W + g) * D] = au;
      }
      o[(size_t)(2 + 2 * G + W) * D] = a_dbds * bp[1];
    }
  }
}

// One warp copies len values from global src to shared dst: 16-byte
// pieces where both ends allow, else 8 or the value's size
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int len,
                                         int lane) {
  const unsigned da = (unsigned)__cvta_generic_to_shared(dst);
  const char* sa = reinterpret_cast<const char*>(src);
  const unsigned mis = (unsigned)((uintptr_t)sa | da);
  const int bytes = len * (int)sizeof(T);
  int done = 0;
  if ((mis & 15) == 0) {
    const int n16 = bytes >> 4;
    for (int i = lane; i < n16; i += 32) cp16(da + 16 * i, sa + 16 * i);
    done = n16 << 4;
  } else if ((mis & 7) == 0) {
    const int n8 = bytes >> 3;
    for (int i = lane; i < n8; i += 32) cp8(da + 8 * i, sa + 8 * i);
    done = n8 << 3;
  }
  for (int b = done + lane * (int)sizeof(T); b < bytes;
       b += 32 * (int)sizeof(T)) {
    if (sizeof(T) == 8)
      cp8(da + b, sa + b);
    else
      cp4(da + b, sa + b);
  }
}

template <typename T>
struct Contract {
  const T* rec;             // [records, C, D]: A in the first F fields
  const int* sidx;          // [records] each record's segment
  const long long* first;   // [R + 1] each ray's first record
  const T* seg;             // [R, S, F, n] LOS tangents
  const T* dts;             // [R, n] tsurf's
  const T* asurf;           // [R, D]
  T* drad;                  // [R, D, n]
  int S, F, F4, C, D, n, KS;
};

// Stage the K chunk of ns records from k0 of ray r (their segments in
// segs): A rows (record, f) [m0, m0 + BM) and LOS tangent rows [j0, j0 +
// BN), row q F4 + f, a warp a row
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_chunk(const Contract<T>& a, T* As,
                                           T* Bs, const int* segs, int r,
                                           long long k0, int ns, int m0,
                                           int j0) {
  constexpr int AP = BM + 4, BP = BN + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int lenA = a.D - m0 < BM ? a.D - m0 : BM;
  const int lenB = a.n - j0 < BN ? a.n - j0 : BN;
  const int rows = ns * a.F;
  for (int t = warp; t < 2 * rows; t += nw) {
    const int u = t < rows ? t : t - rows;
    const int q = u / a.F, f = u - q * a.F;
    const long long k = k0 + q;
    if (t < rows)
      copy_row(As + (q * a.F4 + f) * AP,
               a.rec + ((size_t)k * a.C + f) * a.D + m0, lenA, lane);
    else
      copy_row(Bs + (q * a.F4 + f) * BP,
               a.seg + (((size_t)r * a.S + segs[q]) * a.F + f) * a.n + j0,
               lenB, lane);
  }
}

// The ring over a ray's records: compute(A, B, rows) on each chunk while
// the next CT_STAGES - 1 load; the records' segment indices staged once
// after the ring.  -DJT_SPLIT_NOLOAD / -DJT_SPLIT_NOMMA
// (tools/jvp_split.py only): the chunks are not loaded / not multiplied,
// so the variant's time is the ring without its loads / its arithmetic
// (wrong results by design)
template <typename T, int BM, int BN, class Fn>
__device__ __forceinline__ void ring(const Contract<T>& a, T* buf, int r,
                                     int m0, int j0, Fn compute) {
  constexpr int AP = BM + 4, BP = BN + 4;
  const int stage = a.KS * a.F4 * (AP + BP);
  const long long k0 = a.first[r], nk = a.first[r + 1] - k0;
  const int nchunk = (int)((nk + a.KS - 1) / a.KS);
  auto A = [&](int c) { return buf + (size_t)(c % CT_STAGES) * stage; };
  auto B = [&](int c) { return A(c) + a.KS * a.F4 * AP; };
  auto ns = [&](int c) {
    const long long left = nk - (long long)c * a.KS;
    return (int)(left < a.KS ? left : a.KS);
  };
  int* segs = reinterpret_cast<int*>(buf + (size_t)CT_STAGES * stage);
  for (int i = threadIdx.x; i < nk; i += blockDim.x)
    segs[i] = a.sidx[k0 + i];
  // rows [F, F4) of every record slot stay zero: no copy writes them
  if (a.F4 > a.F) {
    const int pad = a.F4 - a.F;
    for (int i = threadIdx.x; i < CT_STAGES * a.KS * pad * (AP + BP);
         i += blockDim.x) {
      const int per = AP + BP, row = i / per, col = i - row * per;
      const int st = row / (a.KS * pad), rest = row - st * a.KS * pad;
      const int q = rest / pad, f = a.F + rest - q * pad;
      T* base = buf + (size_t)st * stage;
      if (col < AP)
        base[(q * a.F4 + f) * AP + col] = T(0);
      else
        base[a.KS * a.F4 * AP + (q * a.F4 + f) * BP + col - AP] = T(0);
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CT_STAGES - 1; ++c) {
#ifndef JT_SPLIT_NOLOAD
    if (c < nchunk)
      load_chunk<T, BM, BN>(a, A(c), B(c), segs + c * a.KS, r,
                            k0 + (long long)c * a.KS, ns(c), m0, j0);
#endif
    cp_commit();
  }
  for (int c = 0; c < nchunk; ++c) {
    cp_wait<CT_STAGES - 2>();
    __syncthreads();  // chunk c landed for all; chunk c - 1 is consumed
    const int cn = c + CT_STAGES - 1;
#ifndef JT_SPLIT_NOLOAD
    if (cn < nchunk)
      load_chunk<T, BM, BN>(a, A(cn), B(cn), segs + cn * a.KS, r,
                            k0 + (long long)cn * a.KS, ns(cn), m0, j0);
#endif
    cp_commit();
#ifndef JT_SPLIT_NOMMA
    compute(A(c), B(c), ns(c) * a.F4);
#endif
  }
  cp_wait<0>();
}

// Float64: warps 4 (channels) x 2 (tangents), each MW x NW tiles of 8 x 8,
// DMMA m8n8k4 on K steps of 4 rows
template <int MW, int NW>
__global__ void __launch_bounds__(CT_THREADS) ega_jvp_contract_f64(
    Contract<double> a) {
  constexpr int BM = 32 * MW, BN = 16 * NW, AP = BM + 4, BP = BN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  double* buf = reinterpret_cast<double*>(smem);
  // block x: ray x / ceil(n / BN), its tangent tile x mod that
  const int nbn = (a.n + BN - 1) / BN, r = blockIdx.x / nbn;
  const int j0 = (blockIdx.x - r * nbn) * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, q = lane & 3;
  double acc[MW][NW][2];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  ring<double, BM, BN>(a, buf, r, m0, j0,
                       [&](const double* A, const double* B, int rows) {
    for (int kr = 0; kr < rows; kr += 4) {
      double av[MW], bv[NW];
#pragma unroll
      for (int i = 0; i < MW; ++i)
        av[i] = A[(kr + q) * AP + (wm * MW + i) * 8 + g];
#pragma unroll
      for (int j = 0; j < NW; ++j)
        bv[j] = B[(kr + q) * BP + (wn * NW + j) * 8 + g];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
          asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
              "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
              : "+d"(acc[i][j][0]), "+d"(acc[i][j][1])
              : "d"(av[i]), "d"(bv[j]));
    }
  });
  // C fragment: row g, columns 2 q and 2 q + 1 of each tile
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int m = m0 + (wm * MW + i) * 8 + g;
    if (m >= a.D) continue;
    const double as = a.asurf[(size_t)r * a.D + m];
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + (wn * NW + j) * 8 + 2 * q + e;
        if (col < a.n)
          a.drad[((size_t)r * a.D + m) * a.n + col] =
              acc[i][j][e] + as * a.dts[(size_t)r * a.n + col];
      }
  }
}

// Float32: 16 x 16 threads, each TM x TN outputs (rows tm + 16 i, columns
// tn + 16 j), FMA on every K row
template <int TM, int TN>
__global__ void __launch_bounds__(CT_THREADS) ega_jvp_contract_f32(
    Contract<float> a) {
  constexpr int BM = 16 * TM, BN = 16 * TN, AP = BM + 4, BP = BN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  // block x: ray x / ceil(n / BN), its tangent tile x mod that
  const int nbn = (a.n + BN - 1) / BN, r = blockIdx.x / nbn;
  const int j0 = (blockIdx.x - r * nbn) * BN, m0 = blockIdx.y * BM;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  ring<float, BM, BN>(a, buf, r, m0, j0,
                      [&](const float* A, const float* B, int rows) {
    for (int kr = 0; kr < rows; ++kr) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = A[kr * AP + tm + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = B[kr * BP + tn + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  });
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + 16 * i;
    if (m >= a.D) continue;
    const float as = a.asurf[(size_t)r * a.D + m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tn + 16 * j;
      if (col < a.n)
        a.drad[((size_t)r * a.D + m) * a.n + col] =
            acc[i][j] + as * a.dts[(size_t)r * a.n + col];
    }
  }
}

// K chunk (segments) and shared memory of a contraction block of BM x BN
// outputs (the ring, then S segment indices); 0 where one segment does
// not fit
template <typename T>
int contract_smem(int F4, int BM, int BN, int S, int& KS) {
  const int seg = F4 * (BM + 4 + BN + 4) * (int)sizeof(T);
  KS = CT_SMEM / (CT_STAGES * seg);
  KS = KS < 1 ? 1 : (KS > KS_MAX ? KS_MAX : KS);
  const int smem = CT_STAGES * KS * seg + 4 * S;
  return smem > CT_SMEM_MAX ? 0 : smem;
}

// The contraction's instantiation for a dtype: one tile shape (all of a
// ray's channels up to 128 in float64, 112 in float32, in one block; the
// tangents in tiles of 48, 144), partial tiles bounds-checked, so it
// serves every D and n; the smallest tile where a segment of that one
// does not fit the shared memory.  The one place the choice is made:
// jt_ega_jvp_registers reads the same kernel's registers.
struct CtKernel {
  const void* fn;
  int BM, BN;
};
template <typename T>
int f4(int F) {
  return sizeof(T) == 8 ? (F + 3) & ~3 : F;  // DMMA takes K in steps of 4
}
template <typename T>
CtKernel contract_kernel(int F, int S) {
  int ks;
  if (sizeof(T) == 8)
    return contract_smem<double>(f4<T>(F), 128, 48, S, ks)
               ? CtKernel{(const void*)ega_jvp_contract_f64<4, 3>, 128, 48}
               : CtKernel{(const void*)ega_jvp_contract_f64<1, 1>, 32, 16};
  return contract_smem<float>(f4<T>(F), 112, 144, S, ks)
             ? CtKernel{(const void*)ega_jvp_contract_f32<7, 9>, 112, 144}
             : CtKernel{(const void*)ega_jvp_contract_f32<1, 1>, 16, 16};
}

template <typename T>
int launch_contract(Contract<T> a, int R, cudaStream_t stream) {
  const CtKernel k = contract_kernel<T>(a.F, a.S);
  const int smem = contract_smem<T>(a.F4, k.BM, k.BN, a.S, a.KS);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.n + k.BN - 1) / k.BN) * R,
                  (a.D + k.BM - 1) / k.BM);
  void* args[] = {&a};
  e = cudaLaunchKernel(k.fn, grid, dim3(CT_THREADS), args, smem, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Shared memory of a record block of bd threads (brackets of CH
// segments of NR rays when UNI)
template <typename T>
size_t rec_smem(int bd, int NR, int CH, int G, bool uni) {
  return (uni ? sizeof(Bracket) * (size_t)CH * NR * G : 0) +
         sizeof(T) * 3 * (size_t)G * bd +
         sizeof(int) * (4 * (size_t)G * bd + NR);
}

// The record kernel's instantiation: shared brackets where the axes are
// the same in every channel
template <typename T, class TB>
auto rec_kernel(bool uni) {
  return uni ? ega_rec_kernel<T, true, TB> : ega_rec_kernel<T, false, TB>;
}

template <typename T>
auto rec_smem_of(int G, bool uni) {
  return [=](int bd, int NR, int CH) {
    return rec_smem<T>(bd, NR, CH, G, uni);
  };
}

template <typename T, class TB>
int launch_rec(const TB& tb, const void* const* p, int R, int S, int G,
               int W, int n_src, int flags, int ig_co2, int ig_h2o, int bbt,
               int uniform, int hint, const Consts& cs, cudaStream_t stream) {
  const bool uni = uniform != 0;
  auto kernel = rec_kernel<T, TB>(uni);
  RtShape sh;
  if (const int e = rt_shape(kernel, rec_smem_of<T>(G, uni), R, tb.ax.D, G,
                             sh))
    return e;
  kernel<<<sh.groups, sh.bd, sh.smem, stream>>>(
      tb, (const T*)p[0], (const int*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const uint8_t*)p[11],
      (const T*)p[12], (const long long*)p[13], (T*)p[14], (int*)p[15],
      (T*)p[16], (T*)p[17], (T*)p[18], R, S, G, W, n_src, flags, ig_co2,
      ig_h2o, bbt, hint, sh.NR, sh.CH, cs);
  return (int)cudaGetLastError();
}

}  // namespace

// The record kernel's launch shape (jt_ega_rt_shape with ``record``)
int jt_rt::rec_shape_out(int R, int D, int G, bool uni, bool exact,
                         bool dbl, int* out) {
  auto shape = [&](auto kernel, auto smem) {
    return rt_shape_out(kernel, smem, R, D, G, out);
  };
  return dbl ? (exact ? shape(rec_kernel<double, ExactTab>(uni),
                              rec_smem_of<double>(G, uni))
                      : shape(rec_kernel<double, FastTab>(uni),
                              rec_smem_of<double>(G, uni)))
             : (exact ? shape(rec_kernel<float, ExactTab>(uni),
                              rec_smem_of<float>(G, uni))
                      : shape(rec_kernel<float, FastTab>(uni),
                              rec_smem_of<float>(G, uni)));
}

// The record kernel.  Pointers: the tables (tp[0..7]), the fast ones eps
// [G, P, T, K, D] f32, log2_u0 [G, P, T, D] f64, the p axis [G, P, D] f64
// and the t axis [G, P, T, D] f64 (channels innermost), nu [G, P, T, D],
// nt [G, P, D], np [G, D] int32 and valid [G, P, T, D] bytes, or with
// ``exact`` the exact ones u and eps [G, P, T, U, D] f32 (K = U), the
// axes and counts the same, and row_monotone [G, P, T, D] bytes
// (EgaDeviceTables.row_monotone) in valid's place; then the continua rows
// [16, D] (ContinuaCoeffs' order), the window map [D] int32, the source
// table sr [n_src, D] and axis st [n_src], the channels' wavenumbers [D],
// the LOS p, t, ds [R, S], q, k, u [R, S, G|W|G], valid [R, S] bytes and
// tsurf [R]; each ray's first record [R + 1] int64 (the valid segments
// before it); the records [valid segments, rec_len(G, W), D], their
// segment indices [valid segments] int32, a_surf [R, D], rad and tau [R,
// D] (outputs; p[0..18]), all floats but the tables' in the working type.
// flags: bits co2, h2o, n2, o2; uniform: the tables' axes the same in
// every channel; hint: monotone eps rows (FastDeviceTables.monotone; the
// exact tables decide per row); constants: NA 1000 P0, P0, C1, C2,
// TAU_OPAQUE, TAU_CUTOFF, LOG2_RATIO_U and 2 ** LOG2_RATIO_U.
extern "C" int jt_ega_jvp_record(
    const void* tp0, const void* tp1, const void* p_ax, const void* t_ax,
    const void* nu, const void* nt, const void* np_, const void* tp7,
    const void* cc, const void* window, const void* sr, const void* st,
    const void* nu_ch, const void* lp, const void* lt, const void* lds,
    const void* lq, const void* lk, const void* lu, const void* lvalid,
    const void* ltsurf, const void* first, void* rec, void* sidx,
    void* asurf, void* rad, void* tau, int R, int S, int G, int W, int D,
    int P, int NT, int K, int n_src, int flags, int ig_co2, int ig_h2o,
    int bbt, int uniform, int hint, int exact, double k0, double p0,
    double c1, double c2, double tau_opaque, double tau_cutoff,
    double log2_ratio_u, double ratio_u, int is_double, void* stream) {
  if (R < 1 || S < 1 || G < 1 || W < 0 || D < 1 || P < 1 || NT < 1 ||
      K < 1 || n_src < 2)
    return (int)cudaErrorInvalidValue;
  const void* t[8] = {tp0, tp1, p_ax, t_ax, nu, nt, np_, tp7};
  const void* p[19] = {cc,  window, sr, st,    nu_ch, lp,   lt,
                       lds, lq,     lk, lu,    lvalid, ltsurf, first,
                       rec, sidx,   asurf, rad, tau};
  const Consts cs{k0,         p0,         c1,           c2,
                  tau_opaque, tau_cutoff, log2_ratio_u, ratio_u};
  cudaStream_t s = (cudaStream_t)stream;
  const int a[] = {R, S, G, W, n_src, flags, ig_co2, ig_h2o, bbt, uniform,
                   hint};
  auto go = [&](auto tb) {
    return is_double ? launch_rec<double>(tb, p, a[0], a[1], a[2], a[3],
                                          a[4], a[5], a[6], a[7], a[8], a[9],
                                          a[10], cs, s)
                     : launch_rec<float>(tb, p, a[0], a[1], a[2], a[3], a[4],
                                         a[5], a[6], a[7], a[8], a[9], a[10],
                                         cs, s);
  };
  return exact ? go(make_exact(t, P, NT, D, K)) : go(make_fast(t, P, NT, D, K));
}

// The contraction: drad [R, D, n] = per ray the records' A times the LOS
// tangents [R, S, 3 + 2 G + W, n] of their segments plus a_surf [R, D]
// times tsurf's tangents [R, n]; the records, their segment indices and
// each ray's first record as jt_ega_jvp_record wrote them.
extern "C" int jt_ega_jvp_contract(const void* rec, const void* sidx,
                                   const void* first, const void* seg,
                                   const void* dts, const void* asurf,
                                   void* drad, int R, int S, int G, int W,
                                   int D, int n, int is_double,
                                   void* stream) {
  if (R < 1 || S < 1 || G < 1 || W < 0 || D < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int F = 3 + 2 * G + W, C = rec_len(G, W);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch_contract(
        Contract<double>{(const double*)rec, (const int*)sidx,
                         (const long long*)first, (const double*)seg,
                         (const double*)dts, (const double*)asurf,
                         (double*)drad, S, F, f4<double>(F), C, D, n, 1},
        R, s);
  return launch_contract(
      Contract<float>{(const float*)rec, (const int*)sidx,
                      (const long long*)first, (const float*)seg,
                      (const float*)dts, (const float*)asurf, (float*)drad,
                      S, F, f4<float>(F), C, D, n, 1},
      R, s);
}

// Registers of the two kernels a call at G gases, W windows and S
// segments launches (the record kernel's instantiation by uniform and the
// table kind, the contraction's by the tile it takes) into *rec and
// *contract (int each)
extern "C" int jt_ega_jvp_registers(int G, int W, int S, int uniform,
                                    int exact, int is_double, void* rec,
                                    void* contract) {
  if (G < 1 || W < 0 || S < 1) return (int)cudaErrorInvalidValue;
  const int F = 3 + 2 * G + W;
  const bool u = uniform != 0;
  const void* fr =
      is_double ? (exact ? (const void*)rec_kernel<double, ExactTab>(u)
                         : (const void*)rec_kernel<double, FastTab>(u))
                : (exact ? (const void*)rec_kernel<float, ExactTab>(u)
                         : (const void*)rec_kernel<float, FastTab>(u));
  const void* fc = is_double ? contract_kernel<double>(F, S).fn
                             : contract_kernel<float>(F, S).fn;
  cudaFuncAttributes ar, ac;
  cudaError_t e = cudaFuncGetAttributes(&ar, fr);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&ac, fc);
  if (e != cudaSuccess) return (int)e;
  *(int*)rec = ar.numRegs;
  *(int*)contract = ac.numRegs;
  return 0;
}

// The scratch layout at G gases and W windows: the values of one record
// (per valid segment and channel) into *rec and of the epilogue (per ray
// and channel: a_surf) into *epi (int each); the wrapper allocates by
// them.
extern "C" int jt_ega_jvp_scratch(int G, int W, void* rec, void* epi) {
  if (G < 1 || W < 0) return (int)cudaErrorInvalidValue;
  *(int*)rec = rec_len(G, W);
  *(int*)epi = 1;
  return 0;
}
