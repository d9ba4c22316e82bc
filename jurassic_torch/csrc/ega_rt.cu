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
// The layout is the tangent pass's record kernel's (ega_jvp_fast.cu)
// without its records and its sweep: a block owns NR adjacent rays x all
// channels, a thread a (ray, channel) lane carrying rad, tau and
// tau_path[G] (in shared memory, G is a run-time count) over the ray's
// segments, which end after its last valid one (an invalid segment
// changes nothing in the plain version either).  On tables whose (p, T) axes are
// bitwise the same in every channel the block brackets each (segment,
// gas) once, a chunk of segments ahead, into shared memory, with channel
// 0's count searches; otherwise every lane brackets on a
// channel-innermost copy of the axes.  The segment's step is
// ega_rt_common.cuh's, the record kernel's: the fast corners (a hinted
// halving of the eps row, u from log2 arithmetic) or the exact corners
// (the first trips of a gas's four corners issued together from windows
// of the channel-innermost rows around each corner's hint, then a hinted
// check in them; a halving where a check fails, a count on a row that
// decreases), a gas's factor, the continua, the source.
//
// What bounds it (PERF.md, the H100): per valid (segment, channel) 4 G
// corners of searches and a few dozen operations each, the continua and
// the recursion, 2.4e10 operations at the flagship (0.71 ms in float64 at
// the published rate); the bytes are the LOS, the outputs and the tables
// (0.9 GB with the exact tables' u and eps rows), read once 0.27 ms.
// What held the first form (tools/rt_split.py on an NVIDIA H100
// 80GB HBM3 at 700 W): the chain of one lane, not a rate -- the busiest
// ray alone took 12.45 ms of the 22.34 ms exact float64 launch, its
// segment 16 corners of five dependent trips of loads that did not
// coalesce.  The windows cut that chain and the channel-innermost rows
// let a warp share the lines; the registers they ask cap the blocks an
// SM at two on the exact tables (MinBlocks).  The fast corners, three
// coalesced trips, and the fast instantiations stay as they were:
// windows only cost them registers.
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
              gas_corners(tb, cs, g, d, b, T(1) - tpg, ug, hint != 0,
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

// The kernels, one a table kind for their launch bounds: the exact one
// at two blocks an SM (MinBlocks, 128 registers), the fast one asking no
// number of blocks, so that the compiler picks its registers (80 / 120 in
// float32 / float64) as before the exact corners' redesign: a bound of
// one block took 108-128 registers and lost up to a fifth of its time on
// per-channel axes (tools/rt_split.py, which builds variants with
// -DJT_RT_BLOCKS)
constexpr int RT_EXACT_BLOCKS = MinBlocks<ExactTab, false>::value;
template <typename T, bool UNI>
__global__ void __launch_bounds__(RT_THREADS, RT_EXACT_BLOCKS)
    ega_rt_kernel_exact(ExactTab tb, JT_RT_PARAMS) {
  rt_block<T, UNI>(tb, JT_RT_ARGS);
}
template <typename T, bool UNI>
#if JT_RT_BLOCKS > 0
__global__ void __launch_bounds__(RT_THREADS, JT_RT_BLOCKS)
#else
__global__ void __launch_bounds__(RT_THREADS)
#endif
    ega_rt_kernel_fast(FastTab tb, JT_RT_PARAMS) {
  rt_block<T, UNI>(tb, JT_RT_ARGS);
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
// axes the same in every channel; hint: monotone fast eps rows (the exact
// tables decide per row); constants as jt_ega_jvp_record's.
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
  auto go = [&](auto tb) {
    return is_double ? launch_rt<double>(tb, p, a, cs, s)
                     : launch_rt<float>(tb, p, a, cs, s);
  };
  return exact ? go(make_exact(t, P, NT, D, K))
               : go(make_fast(t, P, NT, D, K));
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
// (uniform, exact, is_double as jt_ega_rt's): into out (int[5]) the
// resident blocks a multiprocessor
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the threads a block,
// the rays a group, the multiprocessors and the groups, one block each
extern "C" int jt_ega_rt_shape(int record, int R, int D, int G, int uniform,
                               int exact, int is_double, void* out) {
  if (R < 1 || D < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const bool u = uniform != 0;
  int* o = (int*)out;
  if (record) return rec_shape_out(R, D, G, u, exact != 0, is_double != 0, o);
  auto shape = [&](auto kernel, auto smem) {
    return rt_shape_out(kernel, smem, R, D, G, o);
  };
  return is_double
             ? (exact ? shape(rt_kernel<double, ExactTab>(u),
                              rt_smem_of<double>(G, u))
                      : shape(rt_kernel<double, FastTab>(u),
                              rt_smem_of<double>(G, u)))
             : (exact ? shape(rt_kernel<float, ExactTab>(u),
                              rt_smem_of<float>(G, u))
                      : shape(rt_kernel<float, FastTab>(u),
                              rt_smem_of<float>(G, u)));
}
