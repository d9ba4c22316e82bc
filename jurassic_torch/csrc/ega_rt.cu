// The RT pass on the card: the counterpart of the JAX package's jitted
// ``rt_integrate`` (jurassic_tpu/forward.py:99-176, one ``lax.scan`` over
// the LOS) on the exact tables (``ega_eps_exact``,
// jurassic_tpu/ops/ega.py:82) or the fast ones (``ega_eps_fast``, :171).
// For every (ray, channel) the rad and tau of ``forward.rt_integrate``
// (KERNEL = exact|jax|fast, and auto where the tables' axes are not
// channel-uniform), surface and brightness epilogue included.  Its plain
// version is that eager loop, which ``ForwardModel.integrate_eager`` keeps
// running.
//
// Two kernels, one a table kind.  The exact tables' (ega_rt_kernel_exact)
// has the tangent pass's record kernel's layout (ega_jvp_fast.cu) without
// its records and its sweep: a block owns NR adjacent rays x all
// channels, a thread a (ray, channel) lane carrying rad, tau and
// tau_path[G] (in shared memory, G is a run-time count) over the ray's
// segments, which end after its last valid one (an invalid segment
// changes nothing in the plain version either); on axes bitwise the same
// in every channel the block brackets each (segment, gas) once, a chunk
// of segments ahead, into shared memory.  Its corners issue the first
// trips of a gas's four corners together from windows of the
// channel-innermost rows around each corner's hint, then check the hint
// in them (a halving where a check fails, a count on a row that
// decreases).  The fast tables' (ega_rt_kernel_fast, below) runs a thread
// a (ray, channel, gas).
//
// What bounds them (PERF.md, the H100): per valid (segment, channel) 4 G
// corners of searches and a few dozen operations each, the continua and
// the recursion, 2.4e10 operations at the flagship (0.71 ms in float64 at
// the published rate); the bytes are the LOS, the outputs and the tables
// (0.9 GB with the exact tables' u and eps rows), read once 0.27 ms.
// What held the first forms (tools/rt_split.py on an NVIDIA H100 80GB
// HBM3 at 700 W): the chain of one lane, not a rate.  On the exact tables
// the busiest ray alone took 12.45 ms of the 22.34 ms float64 launch, its
// segment 16 corners of five dependent trips of loads that did not
// coalesce; the windows cut that chain, and their registers cap the
// blocks an SM at two (MinBlocks).  On the fast tables a lane's thread ran
// its G gases one after another, each corner three dependent trips: up to
// 48 trips a segment, the busiest ray alone 6.12 of 9.36 ms (float32),
// 13.5 of 17.4 ms on per-channel axes, where every lane also counted its
// brackets inline; windows there only cost registers.  The thread-per-gas
// kernel puts a segment's G gas chains side by side in one block, takes
// what does not depend on tau_path (brackets, hinted per channel where
// the axes do not decrease; continua; source) off the chain, and leaves
// it one trip of loads a segment: the corners' cells and eps windows
// together, the forward pair in the window (a hint fails on 0.007 % of
// corners).  6.49 / 11.55 / 9.70 ms against 9.31 / 14.91 / 17.46 (float32
// / float64 / per-channel), the busiest ray alone 2.10 ms against 6.12
// (float32).  It is then bound by the instructions its resident warps
// issue, most of them address, clamp and select arithmetic, not by one
// lane (PERF.md, PR 14).
//
// Numbers: the step repeats the plain version's operations in its order
// (-fmad=false, libdevice's transcendentals; ega_rt_common.cuh says where
// PyTorch's operators differ from the Python text), so rad and tau are
// the eager loop's bit for bit: on every flagship lane in every eager
// mode, dtype and axes kind on the H100 (chip_smoke.py).
//
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ega_rt_common.cuh"

namespace {

using namespace jt_rt;

// The kernel's arguments after the tables
#define JT_RT_PARAMS                                                      \
  const T *__restrict__ cc, const int *__restrict__ window,              \
      const T *__restrict__ sr, const T *__restrict__ st,                \
      const T *__restrict__ nu_ch, const T *__restrict__ lp,             \
      const T *__restrict__ lt, const T *__restrict__ lds,               \
      const T *__restrict__ lq, const T *__restrict__ lk,                \
      const T *__restrict__ lu, const uint8_t *__restrict__ lvalid,      \
      const T *__restrict__ ltsurf, T *__restrict__ rad_out,             \
      T *__restrict__ tau_out, int R, int S, int G, int W, int n_src,    \
      int flags, int ig_co2, int ig_h2o, int bbt, int hint, int NR,      \
      int CH, Consts cs
#define JT_RT_ARGS                                                        \
  cc, window, sr, st, nu_ch, lp, lt, lds, lq, lk, lu, lvalid, ltsurf,    \
      rad_out, tau_out, R, S, G, W, n_src, flags, ig_co2, ig_h2o, bbt,   \
      hint, NR, CH, cs

// A block's work: its group of rays x all channels
template <typename T, bool UNI, class TB>
__device__ __forceinline__ void rt_block(TB tb, JT_RT_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = tb.ax.D;
  const int bd = blockDim.x, tid = threadIdx.x;
  const int ray0 = blockIdx.x * NR, L = NR * D;
  // shared: the chunk's brackets [CH][NR][G] (UNI), per thread tau_path
  // [G] and the corners' hints [G][4], and each ray's segment bound
  Bracket* s_br = reinterpret_cast<Bracket*>(smem);
  T* s_tp = reinterpret_cast<T*>(s_br + (UNI ? CH * NR * G : 0)) + tid;
  int* s_hint = reinterpret_cast<int*>(s_tp - tid + G * bd) + tid;
  int* s_nb = s_hint - tid + 4 * G * bd;
  for (int i = tid; i < NR; i += bd) s_nb[i] = 0;
  __syncthreads();
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
    for (int s0 = 0; s0 < smax; s0 += CH) {
      const int ns = CH < smax - s0 ? CH : smax - s0;
      if (UNI) {
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
        // one barrier per segment: the block's rays stay at one segment
#ifndef JT_SPLIT_NOBAR
        __syncthreads();
#endif
        const int s = s0 + sl;
        if (!live || s >= s_nb[rl]) continue;
        const size_t rs = (size_t)r * S + s;
        if (!lvalid[rs]) continue;
        const T p = lp[rs], t = lt[rs], ds = lds[rs];
        T tau_gas = T(1);
        for (int g = 0; g < G; ++g) {
          const T tpg = s_tp[g * bd], ug = lu[rs * G + g];
          const Bracket b = UNI ? s_br[(sl * NR + rl) * G + g]
                                : bracket(tb.ax, g, d, (double)p, (double)t);
          T cw[12];
          const bool ok_all =
              gas_corners(tb, cs, g, d, b, T(1) - tpg, ug, (hint & 1) != 0,
                          s_hint + g * 4 * bd, bd, cw);
          T f[5];
          gas_factor<T, typename Bil<TB, T>::type>(cs, b, cw, ok_all, p, t,
                                                   tpg, f);
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
        const T eps = T(1) - tau_gas * m_exp(-bds);
        if (tau_gas > T(cs.tau_cutoff)) {
          rad = rad + srcv * eps * tau;
          tau = tau * (T(1) - eps);
        }
      }
    }
    if (!live) continue;
    T coef, ss, sl_s;
    rad_out[(size_t)r * D + d] = epilogue(sr, st, n_src, D, d, rad, tau,
                                          ltsurf[r], nu_ch, bbt, cs, coef, ss,
                                          sl_s);
    tau_out[(size_t)r * D + d] = tau;
  }
}

// The exact tables' kernel at two blocks an SM (MinBlocks, 128 registers)
constexpr int RT_EXACT_BLOCKS = MinBlocks<ExactTab, false>::value;
template <typename T, bool UNI>
__global__ void __launch_bounds__(RT_THREADS, RT_EXACT_BLOCKS)
    ega_rt_kernel_exact(ExactTab tb, JT_RT_PARAMS) {
  rt_block<T, UNI>(tb, JT_RT_ARGS);
}

// ---------------------------------------------------------------------------
// The fast tables' kernel: a thread a (ray, channel, gas).
//
// A block owns NR adjacent rays (a group), as above, but its threads are
// laid out gas-major: thread g Lp + l carries gas g of the pass's lane l,
// so that a warp holds adjacent channels of one gas (the table rows are
// channel-innermost) and the G chains of a segment run side by side.  A
// lane's gases all sit in one pass; where NR D G threads exceed
// RTF_THREADS the block takes its lanes in passes of Lp.  Each gas thread
// carries its tau_path and its four corners' hints in registers.  A chunk
// of CH segments ahead, the block writes to shared memory what does not
// depend on tau_path: each (segment, gas) bracket's indices (per channel
// where the axes differ), and each lane's exp(-beta ds) and source.  Per
// segment a gas thread then issues its four corners' first trips
// together (the cell's l2u0, count and validity, and the eps row at h - 1
// .. h + 3, which holds the hinted check's window and, where the forward
// index lands beside the hint, the forward pair), finishes the corners
// and its factor, and writes the factor to shared memory; after the
// segment's barrier the lane's gas-0 thread multiplies the factors in gas
// order and runs the recursion.
constexpr int RTF_THREADS = 448;      // most threads a block
constexpr int RTF_SMEM = 48 * 1024;   // shared memory a block asks at most
constexpr int RTF_CH_MAX = 32;        // segments ahead per chunk
constexpr int RTF_BATCH = 8;          // axis entries loaded together
// the eps row entries a corner's first trip loads: the hinted check's
// v[c - 1 .. c + 2], which holds the forward pair where the forward index
// is c - 1, c or c + 1 (tools/rt_split.py's hints variant counts the
// others); tools/rt_split.py builds variants with -DJT_RTF_WIN=5
#ifndef JT_RTF_WIN
#define JT_RTF_WIN 4
#endif
constexpr int RTF_WIN = JT_RTF_WIN;
// Resident blocks an SM that the launch bounds ask: two (72 registers at
// 448 threads) took the flagship 10-20 % below one (122-128 registers)
// and 15-24 % below three (40) in every fast configuration
// (tools/rt_split.py, which builds variants with -DJT_RT_BLOCKS, on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
#if JT_RT_BLOCKS > 0
constexpr int RTF_BLOCKS = JT_RT_BLOCKS;
#else
constexpr int RTF_BLOCKS = 2;
#endif

// tools/rt_split.py's hint count (-DJT_SPLIT_HINTS): per (gas, corner),
// the corners checked against a hint, the checks that failed, the
// windows loaded again (the hint beyond the cell's count) and the forward
// pairs outside the window
#ifdef JT_SPLIT_HINTS
constexpr int SPLIT_G = 64;
__device__ unsigned long long jt_split_hints[4][SPLIT_G][4];
__device__ __forceinline__ void split_hint(int k, int g, int c, bool pred) {
  const unsigned m = __activemask();
  const unsigned peers = __match_any_sync(m, g);
  const unsigned hits = __ballot_sync(m, pred) & peers;
  if (hits && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&jt_split_hints[k][g < SPLIT_G ? g : SPLIT_G - 1][c],
              (unsigned long long)__popc(hits));
}
#define JT_HINT_COUNT(k, g, c, pred) split_hint(k, g, c, pred)
#else
#define JT_HINT_COUNT(k, g, c, pred) \
  do {                               \
  } while (0)
#endif

// tools/rt_split.py's -DJT_SPLIT_NOAHEAD: the chunk's brackets, continua
// and source not computed (their time)
#ifdef JT_SPLIT_NOAHEAD
#define JT_AHEAD false
#else
#define JT_AHEAD true
#endif
// ... and -DJT_SPLIT_NOCONT: no continua or source (their time)
#ifdef JT_SPLIT_NOCONT
#define JT_CONTINUA false
#else
#define JT_CONTINUA true
#endif

// ops.ega._count_index over v[i stride], i < len, within count, at x, as
// count_index states it, the row's entries loaded RTF_BATCH at a time
__device__ __forceinline__ int count_batched(const double* __restrict__ v,
                                             int stride, int len, int count,
                                             double x) {
  const int m = len < count ? len : count;
  int below = 0;
  for (int i0 = 0; i0 < len; i0 += RTF_BATCH) {
    double w[RTF_BATCH];
#pragma unroll
    for (int j = 0; j < RTF_BATCH; ++j)
      w[j] = i0 + j < len ? __ldg(v + (size_t)(i0 + j) * stride) : 0.0;
#pragma unroll
    for (int j = 0; j < RTF_BATCH; ++j)
      below += i0 + j < m && w[j] <= x ? 1 : 0;
  }
  const int idx = below - 1 < 0 ? 0 : below - 1;
  const int hi = count - 2 < 0 ? 0 : count - 2;
  return idx < hi ? idx : hi;
}

// A bracket's indices packed (the fast kernel's chunk ahead): x the
// pressure level with no_table in bit 31, y the temperature rows' indices
// it0 | it1 << 16
__device__ __forceinline__ int2 pack_bracket(int ipr, int it0, int it1,
                                             bool no_table) {
  return make_int2(ipr | (no_table ? (int)0x80000000 : 0),
                   (it0 & 0xffff) | (it1 << 16));
}

// count_batched on a row that does not decrease within its count
// (FastDeviceTables.axes_monotone): the hint h (the last segment's index)
// checked against the index's defining property in v[h - 1 .. h + 2]
// (hint_check; where h lies beyond this row's count, at the count), the
// count where the check fails
__device__ __forceinline__ int axis_index(const double* __restrict__ v,
                                          int stride, int len, int count,
                                          int h, double x) {
  const int lmax = count - 2 < 0 ? 0 : count - 2;
  int c = h < 0 ? 0 : h;
  auto ld = [&](int i) {
    return __ldg(v + (size_t)(i < 0 ? 0 : (i > len - 1 ? len - 1 : i)) *
                         stride);
  };
  double w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = ld(c - 1 + j);
  if (c > lmax) {  // a row with fewer points than the last one
    c = lmax;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = ld(c - 1 + j);
  }
  auto at = [&](int i) {
    const int o = i - c + 1;
    return o == 0 ? w[0] : (o == 1 ? w[1] : (o == 2 ? w[2] : w[3]));
  };
  double a, b;
  const int i = hint_check<double>(at, c, lmax, x, a, b);
  return i >= 0 ? i : count_batched(v, stride, len, count, x);
}

// bracket()'s indices of gas g, channel d at (p, t), packed.  With
// ``hinted`` (axes that do not decrease) each search first checks its
// hint in bh (the last segment's ipr, it0, it1 of this gas and channel);
// bh is set to this bracket's.
__device__ __forceinline__ int2 bracket_index(const Axes& ax, int g, int d,
                                              double p, double t,
                                              bool hinted, int (&bh)[3]) {
  const int P = ax.P, NT = ax.NT, D = ax.D;
  auto search = [&](const double* v, int len, int count, int& h, double x) {
    h = hinted ? axis_index(v, D, len, count, h, x)
               : count_batched(v, D, len, count, x);
    return h;
  };
  const int npg = __ldg(ax.np_ + g * D + d);
  const int ipr = search(ax.p_ax + (size_t)g * P * D + d, P, npg, bh[0], p);
  const int ipr1 = ipr + 1 < P ? ipr + 1 : P - 1;
  const int nt_lo = __ldg(ax.nt + ((size_t)g * P + ipr) * D + d);
  const int nt_hi = __ldg(ax.nt + ((size_t)g * P + ipr1) * D + d);
  const int it0 = search(ax.t_ax + ((size_t)g * P + ipr) * NT * D + d, NT,
                         nt_lo, bh[1], t);
  const int it1 = search(ax.t_ax + ((size_t)g * P + ipr1) * NT * D + d, NT,
                         nt_hi, bh[2], t);
  return pack_bracket(ipr, it0, it1, npg < 2 || nt_lo < 2 || nt_hi < 2);
}

// The axis values the bilinear step of a bracket reads (ops.ega.
// _brackets: t00, t01, t10, t11, p0, p1 of gas g, channel d at the packed
// indices bi), in the working type (the fast step's, ops.ega._ega_fast
// casts the axes)
template <typename T>
__device__ __forceinline__ void bracket_axes(const Axes& ax, int g, int d,
                                             int2 bi, T (&v)[6]) {
  const int P = ax.P, NT = ax.NT, D = ax.D;
  const int ipr = bi.x & 0x7fffffff, it0 = bi.y & 0xffff;
  const int it1 = (int)((unsigned)bi.y >> 16);
  const int ipr1 = ipr + 1 < P ? ipr + 1 : P - 1;
  const double* pax = ax.p_ax + (size_t)g * P * D + d;
  const double* tlo = ax.t_ax + ((size_t)g * P + ipr) * NT * D + d;
  const double* thi = ax.t_ax + ((size_t)g * P + ipr1) * NT * D + d;
  auto at = [&](const double* r, int j) {
    return (T)__ldg(r + (j < 0 ? 0 : (j > NT - 1 ? NT - 1 : j)) * D);
  };
  v[0] = at(tlo, it0);
  v[1] = at(tlo, it0 + 1);
  v[2] = at(thi, it1);
  v[3] = at(thi, it1 + 1);
  v[4] = (T)__ldg(pax + ipr * D);
  v[5] = (T)__ldg(pax + ipr1 * D);
}

// A gas thread's rows of the fast tables: gas g, channel d (entry i of a
// cell's row at i D), and the per-segment constants of corner_fast.  The
// offsets are 32-bit (launch_rt_fast refuses tables where they would not
// be).
template <typename T>
struct FastRows {
  const float* __restrict__ eps;     // [P T K] x D of gas g, from channel d
  const double* __restrict__ l2u0;   // the tables' [G P T] x D, whole
  const int* __restrict__ nu;
  const uint8_t* __restrict__ ok;
  int cd;                            // gas g, channel d's entry in them
  int D, K, PT;
  T l2r, inv_l2r, ratio;  // LOG2_RATIO_U, its reciprocal, 2 ** it
};

// corner_fast's gather: entry i of the eps row of cell ipt, the flat
// (cell, k) index ipt K + i clipped into the gas's [0, P T K)
template <typename T>
__device__ __forceinline__ float fast_entry(const FastRows<T>& fr, int ipt,
                                            int i) {
  const int top = fr.PT * fr.K - 1;
  int f = ipt * fr.K + i;
  f = f < 0 ? 0 : (f > top ? top : f);
  return __ldg(fr.eps + f * fr.D);
}

// The first trip of a fast corner (corner_fast's loads before its
// search): the cell's l2u0, count and validity and, with a hint, the eps
// row at h - 1 .. h + RTF_WIN - 2 (w[j] = gather(h - 1 + j))
template <typename T>
struct FastLoad {
  T l2u0;
  int nk;
  bool ok;
  float w[RTF_WIN];
};

// the window at wb .. wb + RTF_WIN - 1: one base address where no entry
// is clipped
template <typename T>
__device__ __forceinline__ void fast_window(const FastRows<T>& fr, int ipt,
                                            int wb, float (&w)[RTF_WIN]) {
  const int f0 = ipt * fr.K + wb;
  if (f0 >= 0 && f0 + RTF_WIN - 1 <= fr.PT * fr.K - 1) {
    const float* __restrict__ p = fr.eps + f0 * fr.D;
#pragma unroll
    for (int j = 0; j < RTF_WIN; ++j) w[j] = __ldg(p + j * fr.D);
  } else {
#pragma unroll
    for (int j = 0; j < RTF_WIN; ++j) w[j] = fast_entry(fr, ipt, wb + j);
  }
}

template <typename T>
__device__ __forceinline__ void fast_load(const FastRows<T>& fr, int ipt,
                                          int h, bool hint, FastLoad<T>& k) {
#ifdef JT_SPLIT_CELL0
  ipt = 0;  // tools/rt_split.py: every corner reads its gas's cell 0
#endif
  const int cell = ipt < 0 ? 0 : (ipt > fr.PT - 1 ? fr.PT - 1 : ipt);
  const int gc = fr.cd + cell * fr.D;
  k.l2u0 = (T)__ldg(fr.l2u0 + gc);
  k.nk = __ldg(fr.nu + gc);
  k.ok = __ldg(fr.ok + gc) != 0;
  if (hint) fast_window(fr, ipt, h - 1, k.w);
}

// corner_fast's fixed count of halvings, out of line (where a hinted
// check fails, or without hints): the index and the row's entries there
template <typename T>
struct Halved {
  int lo;
  T e_lo, e_hi;
};
template <typename T>
__device__ __noinline__ Halved<T> fast_halving(const FastRows<T> fr, int ipt,
                                               int nk, T target) {
  const int K = fr.K;
  int l = 0, hi = nk - 1 < 1 ? 1 : nk - 1;
  int steps = 1;
  while ((1 << steps) < (K < 2 ? 2 : K)) ++steps;
  for (int s = 0; s < steps; ++s) {
    const bool active = hi > l + 1;
    const int mid = (hi + l) >> 1;
    const bool pred = (T)fast_entry(fr, ipt, mid) > target;
    if (active && pred) hi = mid;
    if (active && !pred) l = mid;
  }
  return {l, (T)fast_entry(fr, ipt, l), (T)fast_entry(fr, ipt, l + 1)};
}

// corner_fast's emissivity after the segment (eps_c; the slopes are the
// record kernel's) from its first trip k: the same operations in the
// same order, the row's entries from the window where they lie in it.
// h: the (gas, corner) lane's hint, set to the forward index.
template <typename T>
__device__ __forceinline__ T fast_finish(const FastRows<T>& fr, int g, int c,
                                         int ipt, FastLoad<T>& k, T target,
                                         T u_seg, bool hint, int& h) {
#ifdef JT_SPLIT_CELL0
  ipt = 0;
#endif
  (void)g;
  (void)c;
  const T l2u0 = k.l2u0, l2r = fr.l2r, ratio = fr.ratio;
  const int nk = k.nk;
  const int lmax = nk - 2 < 0 ? 0 : nk - 2;
  // invert: u at the target emissivity
  int lo = -1, wb = 0;  // wb: the row index of k.w[0]
  T e_lo = T(0), e_hi = T(0);
  if (hint) {
    const int ch = h < 0 ? 0 : (h > lmax ? lmax : h);
    JT_HINT_COUNT(0, g, c, true);
    JT_HINT_COUNT(2, g, c, ch != h);
    // the hint beyond this cell's count: its own window
    if (ch != h) fast_window(fr, ipt, ch - 1, k.w);
    wb = ch - 1;
    auto at = [&](int i) -> T { return (T)pick(k.w, i - wb); };
#ifdef JT_SPLIT_INDEX
    lo = ch;  // tools/rt_split.py: the hint, unchecked
    e_lo = at(ch);
    e_hi = at(ch + 1);
#else
    lo = hint_check<T>(at, ch, lmax, target, e_lo, e_hi);
#endif
    JT_HINT_COUNT(1, g, c, lo < 0);
  }
  if (lo < 0) {
    const Halved<T> r = fast_halving<T>(fr, ipt, nk, target);
    lo = r.lo;
    e_lo = r.e_lo;
    e_hi = r.e_hi;
  }
  const T u0 = m_exp2(l2u0 + (T)lo * l2r);
  const T u_c = lip(e_lo, u0, e_hi, u0 * ratio, target);
  // forward: eps at u_c + u_seg, the index never below the inversion's
  const T u_new = u_c + u_seg;
  const T uc = u_new < T(1e-300) ? T(1e-300) : u_new;  // torch.clamp(min=)
  const T kf = (m_log2(uc) - l2u0) * fr.inv_l2r;
  int ki = trunc_int(kf);
  ki = ki < 0 ? 0 : ki;
  const int kmax = nk - 2 < 0 ? 0 : nk - 2;
  ki = ki < kmax ? ki : kmax;
  ki = ki > lo ? ki : lo;
  h = ki;
  const T u_lo = m_exp2(l2u0 + (T)ki * l2r);
  const int o = ki - wb;
  const bool inside = hint && o >= 0 && o <= RTF_WIN - 2;
  if (hint) JT_HINT_COUNT(3, g, c, !inside);
  const T e0 = inside ? (T)pick(k.w, o) : (T)fast_entry(fr, ipt, ki);
  const T e1 = inside ? (T)pick(k.w, o + 1) : (T)fast_entry(fr, ipt, ki + 1);
  const T raw = lip(u_lo, e0, u_lo * ratio, e1, u_new);
  return c01(raw);
}

// The argument Lp: the lanes a pass
template <typename T, bool UNI>
__global__ void __launch_bounds__(RTF_THREADS, RTF_BLOCKS)
    ega_rt_kernel_fast(FastTab tb, JT_RT_PARAMS, int Lp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = tb.ax.D, P = tb.ax.P, NT = tb.ax.NT;
  const int bd = blockDim.x, tid = threadIdx.x;
  const int ray0 = blockIdx.x * NR, L = NR * D, GLp = G * Lp;
  // shared: the chunk's bracket indices ([CH][NR][G] on uniform axes,
  // else [CH][G][Lp]) and on uniform axes their bilinear axis values
  // [CH][NR][G][6], the segment's factors [2][G][Lp], the chunk's
  // exp(-beta ds) and source [CH][Lp] each, each ray's segment bound
  int2* s_idx = reinterpret_cast<int2*>(smem);
  T* s_ax = reinterpret_cast<T*>(s_idx + (UNI ? CH * NR * G : CH * GLp));
  T* s_f = s_ax + (UNI ? 6 * CH * NR * G : 0);
  T* s_eb = s_f + 2 * GLp;
  T* s_src = s_eb + CH * Lp;
  int* s_nb = reinterpret_cast<int*>(s_src + CH * Lp);
  for (int i = tid; i < NR; i += bd) s_nb[i] = 0;
  __syncthreads();
  for (int i = tid; i < NR * S; i += bd) {
    const int rr = i / S, s = i - rr * S;
    if (ray0 + rr < R && lvalid[(size_t)(ray0 + rr) * S + s])
      atomicMax(s_nb + rr, s + 1);
  }
  __syncthreads();
  int smax = 0;
  for (int i = 0; i < NR; ++i) smax = smax > s_nb[i] ? smax : s_nb[i];

  const int g = tid / Lp, l = tid - g * Lp;  // g >= G: no gas of a lane
  const int gs = g < G ? g : G - 1, PT = P * NT;
  // hint bit 0: monotone eps rows; bit 1: axes that do not decrease
  const bool ehint = (hint & 1) != 0, ahint = (hint & 2) != 0;
  // corner_fast's (log2(u) - l2u0) / LOG2_RATIO_U: a product with the
  // reciprocal
  const T l2r = T(cs.log2_ratio_u);
  for (int q0 = 0; q0 < L; q0 += Lp) {
    const int i = q0 + l;
    const int rl = i < L ? i / D : 0;
    const int d = i < L ? i - rl * D : 0;
    const int r = ray0 + rl;
    const bool live = g < G && i < L && r < R;
    const FastRows<T> fr{tb.eps + (size_t)gs * PT * tb.K * D + d,
                         tb.l2u0,
                         tb.nu,
                         tb.ok,
                         gs * PT * D + d,
                         D,
                         tb.K,
                         PT,
                         l2r,
                         T(1) / l2r,
                         T(cs.ratio_u)};
    const int nb = live ? s_nb[rl] : 0;
    // per-channel axes: the last segment's bracket indices, the next's
    // hints
    int bh[3] = {0, 0, 0};
    int h[4] = {0, 0, 0, 0};
    T tp = T(1), rad = T(0), tau = T(1);
    int buf = 0;
    for (int s0 = 0; s0 < smax; s0 += CH) {
      const int ns = CH < smax - s0 ? CH : smax - s0;
      __syncthreads();  // the last chunk's readers are done
      if (UNI) {  // channel 0's brackets serve every channel
        for (int task = tid; task < ns * NR * G; task += bd) {
          const int gg = task % G, rr = (task / G) % NR;
          const int s = s0 + task / (G * NR);
          int2 b = make_int2(0, 0);
          T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
          if (ray0 + rr < R && s < s_nb[rr]) {
            const size_t rs = (size_t)(ray0 + rr) * S + s;
            if (JT_AHEAD && lvalid[rs]) {
              int none[3] = {0, 0, 0};
              b = bracket_index(tb.ax, gg, 0, (double)lp[rs], (double)lt[rs],
                                false, none);
              bracket_axes(tb.ax, gg, 0, b, v);
            }
          }
          s_idx[task] = b;
#pragma unroll
          for (int j = 0; j < 6; ++j) s_ax[task * 6 + j] = v[j];
        }
      } else if (tid < GLp) {  // each gas thread its lane's brackets
        for (int sl = 0; sl < ns; ++sl) {
          const size_t rs = (size_t)r * S + s0 + sl;
          int2 b = make_int2(0, 0);
          if (JT_AHEAD && live && s0 + sl < nb && lvalid[rs])
            b = bracket_index(tb.ax, g, d, (double)lp[rs], (double)lt[rs],
                              ahint, bh);
          s_idx[sl * GLp + tid] = b;
        }
      }
      for (int task = tid; task < ns * Lp; task += bd) {  // the lanes'
        const int sl = task / Lp, ii = q0 + task - sl * Lp;
        T eb = T(0), sv = T(0);
        if (JT_AHEAD && JT_CONTINUA && ii < L) {
          const int rr = ii / D, dd = ii - rr * D;
          if (ray0 + rr < R && s0 + sl < s_nb[rr]) {
            const size_t rs = (size_t)(ray0 + rr) * S + s0 + sl;
            if (lvalid[rs]) {
              T bp[7], slope;
              const T p = lp[rs], t = lt[rs];
              const T qh = ig_h2o >= 0 ? lq[rs * G + ig_h2o] : T(0);
              const T uh = ig_h2o >= 0 ? lu[rs * G + ig_h2o] : T(0);
              const T uc = ig_co2 >= 0 ? lu[rs * G + ig_co2] : T(0);
              const T bds = continua(
                  cc, D, dd, flags, cs,
                  W > 0 ? lk[rs * W + window[dd]] : T(0), lds[rs], p, t, qh,
                  uc, uh, bp);
              eb = m_exp(-bds);
              sv = source(sr, st, n_src, D, dd, t, slope);
            }
          }
        }
        s_eb[task] = eb;
        s_src[task] = sv;
      }
      __syncthreads();
      for (int sl = 0; sl < ns; ++sl) {
        const int s = s0 + sl;
        const size_t rs = (size_t)r * S + s;
        const bool on = live && s < nb && lvalid[rs];
        if (on) {  // this gas's factor
          const T p = lp[rs], t = lt[rs], ug = lu[rs * G + g];
          const int2 bi = UNI ? s_idx[(sl * NR + rl) * G + g]
                              : s_idx[sl * GLp + tid];
          Bracket b;
          b.ipr = bi.x & 0x7fffffff;
          b.it0 = bi.y & 0xffff;
          b.it1 = (int)((unsigned)bi.y >> 16);
          b.no_table = bi.x < 0;
          T v[6];  // channel d's; on uniform axes channel 0's, the same bits
          if (UNI) {
#pragma unroll
            for (int j = 0; j < 6; ++j)
              v[j] = s_ax[((sl * NR + rl) * G + g) * 6 + j];
          } else {
            bracket_axes(tb.ax, g, d, bi, v);
          }
          FastLoad<T> k[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ipt = c < 2 ? b.ipr * NT + b.it0 + c
                                  : (b.ipr + 1) * NT + b.it1 + (c - 2);
            fast_load<T>(fr, ipt, h[c], ehint, k[c]);
          }
          const T target = T(1) - tp;
          T cw[12];
          bool ok_all = true;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ipt = c < 2 ? b.ipr * NT + b.it0 + c
                                  : (b.ipr + 1) * NT + b.it1 + (c - 2);
            cw[c * 3] = fast_finish<T>(fr, g, c, ipt, k[c], target, ug,
                                       ehint, h[c]);
            cw[c * 3 + 1] = cw[c * 3 + 2] = T(0);
            ok_all = ok_all && k[c].ok;
          }
          b.t00 = v[0];
          b.t01 = v[1];
          b.t10 = v[2];
          b.t11 = v[3];
          b.p0 = v[4];
          b.p1 = v[5];
          T f[5];
          gas_factor<T, T>(cs, b, cw, ok_all, p, t, tp, f);
          tp = tp * f[0];
          s_f[buf * GLp + tid] = f[0];
        }
        // one barrier per segment: the lane's factors are in
#ifndef JT_SPLIT_NOBAR
        __syncthreads();
#endif
        if (on && g == 0) {  // the factors in gas order, the recursion
          const T* fs = s_f + buf * GLp + l;
          T tau_gas = fs[0];
          for (int gg = 1; gg < G; ++gg) tau_gas = tau_gas * fs[gg * Lp];
          const T eps = T(1) - tau_gas * s_eb[sl * Lp + l];
          if (tau_gas > T(cs.tau_cutoff)) {
            rad = rad + s_src[sl * Lp + l] * eps * tau;
            tau = tau * (T(1) - eps);
          }
        }
        buf ^= 1;
      }
    }
    if (!live || g != 0) continue;
    T coef, ss, sl_s;
    rad_out[(size_t)r * D + d] = epilogue(sr, st, n_src, D, d, rad, tau,
                                          ltsurf[r], nu_ch, bbt, cs, coef, ss,
                                          sl_s);
    tau_out[(size_t)r * D + d] = tau;
  }
}

// Shared memory of a block of bd threads (brackets of CH segments of NR
// rays when UNI)
template <typename T>
size_t rt_smem(int bd, int NR, int CH, int G, bool uni) {
  return (uni ? sizeof(Bracket) * (size_t)CH * NR * G : 0) +
         sizeof(T) * (size_t)G * bd + sizeof(int) * (4 * (size_t)G * bd + NR);
}

template <typename T>
auto rt_kernel_of(const ExactTab*, bool uni) {
  return uni ? ega_rt_kernel_exact<T, true> : ega_rt_kernel_exact<T, false>;
}
template <typename T>
auto rt_kernel_of(const FastTab*, bool uni) {
  return uni ? ega_rt_kernel_fast<T, true> : ega_rt_kernel_fast<T, false>;
}
// The kernel of a call: by table kind, then shared brackets where the
// axes are the same in every channel
template <typename T, class TB>
auto rt_kernel(bool uni) {
  return rt_kernel_of<T>((const TB*)nullptr, uni);
}

template <typename T>
auto rt_smem_of(int G, bool uni) {
  return [=](int bd, int NR, int CH) {
    return rt_smem<T>(bd, NR, CH, G, uni);
  };
}

template <typename T, class TB>
int launch_rt(const TB& tb, const void* const* p, const int* a,
              const Consts& cs, cudaStream_t stream) {
  const int R = a[0], S = a[1], G = a[2], W = a[3], n_src = a[4];
  const int flags = a[5], ig_co2 = a[6], ig_h2o = a[7], bbt = a[8];
  const bool uni = a[9] != 0;
  const int hint = a[10];
  auto kernel = rt_kernel<T, TB>(uni);
  RtShape sh;
  if (const int e = rt_shape(kernel, rt_smem_of<T>(G, uni), R, tb.ax.D, G,
                             sh))
    return e;
  kernel<<<sh.groups, sh.bd, sh.smem, stream>>>(
      tb, (const T*)p[0], (const int*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const uint8_t*)p[11],
      (const T*)p[12], (T*)p[13], (T*)p[14], R, S, G, W, n_src, flags,
      ig_co2, ig_h2o, bbt, hint, sh.NR, sh.CH, cs);
  return (int)cudaGetLastError();
}

// The fast kernel's launch: NR rays a group (as many whole rays as
// RTF_THREADS threads of G gases hold, as few as lets every
// multiprocessor take a group), Lp lanes a pass (the group's lanes in as
// few even passes as RTF_THREADS allows), CH segments ahead within
// RTF_SMEM; the multiprocessors and the groups (one block each)
struct RtfShape {
  int NR, Lp, passes, bd, CH, n_sm, groups;
  size_t smem;
};

// Shared memory of a fast block: CH segments' bracket indices (and on
// uniform axes their axis values), the factors' two buffers, CH segments'
// exp(-beta ds) and source, the rays' segment bounds
template <typename T>
size_t rtf_smem(bool uni, int NR, int G, int Lp, int CH) {
  return sizeof(int2) * (size_t)CH * (uni ? NR * G : G * Lp) +
         sizeof(T) * ((uni ? 6 * (size_t)CH * NR * G : 0) +
                      2 * (size_t)G * Lp + 2 * (size_t)CH * Lp) +
         sizeof(int) * (size_t)NR;
}

template <typename T, class K>
int rtf_shape(K kernel, bool uni, int R, int D, int G, RtfShape& sh) {
  int dev = 0;
  sh.n_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sh.n_sm, cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return (int)cudaGetLastError();
  if (G > RTF_THREADS) return (int)cudaErrorInvalidValue;
  const int n_sm = sh.n_sm > 0 ? sh.n_sm : 1;
  int NR = RTF_THREADS / G / D;
  NR = NR < R / n_sm ? NR : R / n_sm;
  NR = NR < 1 ? 1 : (NR > NR_MAX ? NR_MAX : NR);
  const int L = NR * D, lp_max = RTF_THREADS / G;
  sh.NR = NR;
  sh.passes = (L + lp_max - 1) / lp_max;
  sh.Lp = (L + sh.passes - 1) / sh.passes;
  sh.bd = ((G * sh.Lp + 31) / 32) * 32;
  const size_t fixed = rtf_smem<T>(uni, NR, G, sh.Lp, 0);
  const size_t per = rtf_smem<T>(uni, NR, G, sh.Lp, 1) - fixed;
  const int CH = fixed + per < (size_t)RTF_SMEM
                     ? (int)(((size_t)RTF_SMEM - fixed) / per)
                     : 1;
  sh.CH = CH < RTF_CH_MAX ? CH : RTF_CH_MAX;
  sh.groups = (R + NR - 1) / NR;
  sh.smem = rtf_smem<T>(uni, NR, G, sh.Lp, sh.CH);
  if (sh.smem > RT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
}

template <typename T>
int launch_rt_fast(const FastTab& tb, const void* const* p, const int* a,
                   const Consts& cs, cudaStream_t stream) {
  const int R = a[0], S = a[1], G = a[2], W = a[3], n_src = a[4];
  const int flags = a[5], ig_co2 = a[6], ig_h2o = a[7], bbt = a[8];
  const bool uni = a[9] != 0;
  const int hint = a[10];
  // it1 < 2^16 packed; 32-bit offsets within a gas's eps rows and within
  // the [G, P, T, D] cell arrays
  const long long cells = (long long)tb.ax.P * tb.ax.NT * tb.ax.D;
  if (tb.ax.NT > 65536 || cells * tb.K >= (1LL << 31) ||
      cells * G >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  auto kernel = rt_kernel<T, FastTab>(uni);
  RtfShape sh;
  if (const int e = rtf_shape<T>(kernel, uni, R, tb.ax.D, G, sh)) return e;
  kernel<<<sh.groups, sh.bd, sh.smem, stream>>>(
      tb, (const T*)p[0], (const int*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const uint8_t*)p[11],
      (const T*)p[12], (T*)p[13], (T*)p[14], R, S, G, W, n_src, flags,
      ig_co2, ig_h2o, bbt, hint, sh.NR, sh.CH, cs, sh.Lp);
  return (int)cudaGetLastError();
}

// rt_shape_out's fields for the fast kernel: its gas threads a lane
// (G), lanes a pass and passes
template <typename T>
int rtf_shape_out(bool uni, int R, int D, int G, int* out) {
  auto kernel = rt_kernel<T, FastTab>(uni);
  RtfShape sh;
  if (const int e = rtf_shape<T>(kernel, uni, R, D, G, sh)) return e;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, sh.bd, sh.smem);
  if (e != cudaSuccess) return (int)e;
  const int v[RT_SHAPE_LEN] = {per_sm,    sh.bd, sh.NR, sh.n_sm,
                               sh.groups, G,     sh.Lp, sh.passes};
  for (int i = 0; i < RT_SHAPE_LEN; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// The RT pass.  Pointers: the tables (tp[0..7]) as jt_ega_jvp_record
// takes them, fast (eps, log2_u0, p axis, t axis, nu, nt, np, valid; K the
// eps rows' length) or, with ``exact``, exact (u, eps, p axis, t axis, nu,
// nt, np, row_monotone; K = U); then the continua rows [16, D], the window
// map [D] int32, the source table sr [n_src, D] and axis st [n_src], the
// channels' wavenumbers [D], the LOS p, t, ds [R, S], q, k, u [R, S,
// G|W|G], valid [R, S] bytes and tsurf [R]; rad and tau [R, D] (outputs;
// p[0..14]), all floats but the tables' in the working type.  flags: bits
// co2, h2o, n2, o2; bbt: the brightness conversion; uniform: the tables'
// axes the same in every channel; hint: bit 0 monotone fast eps rows (the
// exact tables decide per row), bit 1 fast tables' axes that do not
// decrease within their counts (FastDeviceTables.axes_monotone: the
// per-channel brackets check a hint); constants as jt_ega_jvp_record's.
extern "C" int jt_ega_rt(
    const void* tp0, const void* tp1, const void* p_ax, const void* t_ax,
    const void* nu, const void* nt, const void* np_, const void* tp7,
    const void* cc, const void* window, const void* sr, const void* st,
    const void* nu_ch, const void* lp, const void* lt, const void* lds,
    const void* lq, const void* lk, const void* lu, const void* lvalid,
    const void* ltsurf, void* rad, void* tau, int R, int S, int G, int W,
    int D, int P, int NT, int K, int n_src, int flags, int ig_co2,
    int ig_h2o, int bbt, int uniform, int hint, int exact, double k0,
    double p0, double c1, double c2, double tau_opaque, double tau_cutoff,
    double log2_ratio_u, double ratio_u, int is_double, void* stream) {
  if (R < 1 || S < 1 || G < 1 || W < 0 || D < 1 || P < 1 || NT < 1 ||
      K < 1 || n_src < 2)
    return (int)cudaErrorInvalidValue;
  const void* t[8] = {tp0, tp1, p_ax, t_ax, nu, nt, np_, tp7};
  const void* p[15] = {cc, window, sr, st,     nu_ch,  lp,  lt, lds,
                       lq, lk,     lu, lvalid, ltsurf, rad, tau};
  const int a[11] = {R,   S,      G,      W,   n_src,  flags,
                     ig_co2, ig_h2o, bbt, uniform, hint};
  const Consts cs{k0,         p0,         c1,           c2,
                  tau_opaque, tau_cutoff, log2_ratio_u, ratio_u};
  cudaStream_t s = (cudaStream_t)stream;
  if (exact) {
    const ExactTab tb = make_exact(t, P, NT, D, K);
    return is_double ? launch_rt<double>(tb, p, a, cs, s)
                     : launch_rt<float>(tb, p, a, cs, s);
  }
  const FastTab tb = make_fast(t, P, NT, D, K);
  return is_double ? launch_rt_fast<double>(tb, p, a, cs, s)
                   : launch_rt_fast<float>(tb, p, a, cs, s);
}

// Registers of the instantiation a call launches (by uniform, the table
// kind and the dtype) into *out (int)
extern "C" int jt_ega_rt_registers(int uniform, int exact, int is_double,
                                   void* out) {
  const bool u = uniform != 0;
  const void* f =
      is_double ? (exact ? (const void*)rt_kernel<double, ExactTab>(u)
                         : (const void*)rt_kernel<double, FastTab>(u))
                : (exact ? (const void*)rt_kernel<float, ExactTab>(u)
                         : (const void*)rt_kernel<float, FastTab>(u));
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, f);
  if (e != cudaSuccess) return (int)e;
  *(int*)out = at.numRegs;
  return 0;
}

// The launch shape of a call of the RT kernel, or with ``record`` the
// record kernel (ega_jvp_fast.cu), at R rays, D channels and G gases
// (uniform, exact, is_double as jt_ega_rt's): into out (int[RT_SHAPE_LEN])
// the resident blocks a multiprocessor
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the threads a block,
// the rays a group, the multiprocessors, the groups (one block each), the
// threads a (ray, channel) lane (G for the fast RT kernel, a thread a
// gas; 1 for the others), the lanes a pass and the passes
extern "C" int jt_ega_rt_shape(int record, int R, int D, int G, int uniform,
                               int exact, int is_double, void* out) {
  if (R < 1 || D < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const bool u = uniform != 0;
  int* o = (int*)out;
  if (record) return rec_shape_out(R, D, G, u, exact != 0, is_double != 0, o);
  if (!exact)
    return is_double ? rtf_shape_out<double>(u, R, D, G, o)
                     : rtf_shape_out<float>(u, R, D, G, o);
  return is_double ? rt_shape_out(rt_kernel<double, ExactTab>(u),
                                  rt_smem_of<double>(G, u), R, D, G, o)
                   : rt_shape_out(rt_kernel<float, ExactTab>(u),
                                  rt_smem_of<float>(G, u), R, D, G, o);
}

// tools/rt_split.py's hint count of the fast RT kernel, per (gas,
// corner): into out (uint64 [4][64][4]: the corners checked against a
// hint, the failed checks, the windows loaded again, the forward pairs
// outside the window; gases from 63 on in 63) the counts since the last
// call, then zeroed.  cudaErrorNotSupported unless the library was built
// with -DJT_SPLIT_HINTS.
extern "C" int jt_ega_rt_hint_counts(void* out) {
#ifdef JT_SPLIT_HINTS
  cudaError_t e = cudaMemcpyFromSymbol(out, jt_split_hints,
                                       sizeof(jt_split_hints));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[4][SPLIT_G][4] = {};
  return (int)cudaMemcpyToSymbol(jt_split_hints, zero, sizeof(zero));
#else
  (void)out;
  return (int)cudaErrorNotSupported;
#endif
}
