// Fused EGA radiative-transfer pass on Chebyshev-compressed ("turbo")
// tables, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels jurassic_tpu/ops/pallas/ega_fused.py
// ::_make_pool_kernel (the production dispatch) and ::_make_kernel in
// turbo mode (its group form).  Both compute the same per-(ray, channel)
// recursion over the line of sight; they differ only in how table rows
// reach VMEM (8-ray sublane groups, 128-lane padding, slot pools, DMA
// double buffers), machinery that exists because the TPU has no
// per-lane dynamic gather.  This kernel has one: every thread reads its
// corners' rows straight from global memory.  The recursion, the launch
// geometry and the continua are the shared code of ega_common.cuh; this
// file is the turbo corner routine: two Clenshaw recurrences per corner,
// the Chebyshev degrees as template parameters (compiled for 8/8, the
// degree build_turbo_tables fits).
//
// Hybrid taint (the pool kernel's `hit`, ega_fused.py:1375-1379): with a
// taint output the kernel marks a (ray, channel) lane when an active, not
// yet opaque segment read a corner whose validity row is 2 (a row whose
// Chebyshev fit failed the per-row gate); the forward model re-evaluates such
// lanes through the table kernel.  Without bad rows the pointer is null.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W, flagship:
// 1084 rays, 274,003 active segments, 4 gases, 100 channels; PERF.md has
// the runs, tools/ega_split.py makes them).  The roofline is far away:
// 99 MB of compulsory traffic (0.03 ms) and 55 GFLOP (0.82 ms at 67
// TFLOP/s).  What the card really has to do is execute this code: about
// 5300 SASS instructions per (warp, segment), a third of them the precise
// exp/log/division sequences that -fmad=false arithmetic in the plain
// version's order needs.  The first kernel (one block per ray, 36 4-byte
// loads per corner, 80 registers) took 12.0 ms, and as long with every
// load hitting the L1 cache: its loads alone took 10.5 ms (63 GB through
// the L2 cache) and its arithmetic alone as much, overlapped.  What this
// design does about it:
//   * rows packed four to a float4: 10 16-byte loads per corner instead
//     of 36 4-byte ones (273 instead of 666 load instructions in the
//     4-gas body), 32-bit offsets;
//   * six adjacent rays per block, in lockstep over the segment index
//     (ega_common.cuh): neighbours bracket the same cells, so five of six
//     fetches stop at the L1 cache, and 600 of 608 threads are live;
//   * the corners bracketed a chunk ahead by all threads.
// It now takes 6.6 ms, and 6.9-7.2 ms when every load hits the L1 cache:
// the load path is off the critical path, and what is left is the scheduler
// and latency floor of this arithmetic at 19 warps per multiprocessor
// (96 registers; about 4.4 ms of pure scheduler slots).  Tried and slower:
// two or four rays walked by one thread with the rows shared in registers
// (10.8 and 21.7 ms: half or a quarter of the threads, 128-234 registers),
// 700 or 800 threads per block (80 or 72 registers, spills: 8.0, 9.4 ms).
//
// Precision: see ega_common.cuh; every expression follows the operation
// order of the JAX kernel (ega_fused.py:725-856, 1262-1387) and of the
// plain PyTorch version rt_fused_turbo_ref.
//
// -DJT_SPLIT_LOADS (tools/ega_split.py only): a corner sums its rows and
// skips the arithmetic; the result is wrong.
//
// C interface (loaded with ctypes): jt_ega_fused_turbo(...) launches on
// the given stream and returns cudaGetLastError().

#include "ega_common.cuh"

namespace {

using jt::c01;
using jt::clipf;

constexpr int N_TURBO_AUX = 21;  // aux rows after the Chebyshev rows

// Clenshaw evaluation of the J coefficients c[0..J-1] (registers)
template <int J>
__device__ __forceinline__ float cheb(const float* c, float x) {
  const float x2 = 2.f * x;
  float b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int j = J - 1; j > 0; --j) {
    const float t = x2 * b1 - b2 + c[j];
    b2 = b1;
    b1 = t;
  }
  return x * b1 - b2 + c[0];
}

// curve-of-growth transform of the inversion target (_eta_of): the plain
// log forms with the JAX clips, not log1p
__device__ __forceinline__ float eta_of(float target) {
  const float tc = clipf(target, F32(1e-12), F32(1.0 - 1e-7));
  return logf(fmaxf(-logf(fmaxf(1.f - tc, F32(1e-37))), F32(1e-37)));
}

// One (p, T) corner (_turbo_corner): eps->u inversion and eps(u + u_seg)
// through the eta-space Chebyshev pair; c holds the rows of the corner's
// cell for this thread's channel.
template <int JF, int JI>
__device__ __forceinline__ float turbo_corner(const float* c, float target,
                                              float eta_t, float u_seg) {
  constexpr int A = JF + JI;
  const float R6 = F32(1.0 / 6.0);                  // LOG2_RATIO_U
  const float INV_RATIO = F32(0.8908987181403393);  // 2^(-1/6)
  const float l2u0 = c[A + 0], k_hi = c[A + 1], e0 = c[A + 2];
  const float e2nd = c[A + 4], emax = c[A + 5], ends = c[A + 6];
  const float u0 = c[A + 12], u_n1 = c[A + 13];
  const float xi_a = c[A + 14], xi_b = c[A + 15];
  const float s_lo_inv = c[A + 16], s_hi_inv = c[A + 17];
  const float s_lo_fwd = c[A + 18], s_hi_fwd = c[A + 19];
  const float ky = c[A + 20];
#ifdef JT_SPLIT_LOADS
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < A + N_TURBO_AUX; ++j) acc += c[j];
  return acc * target + eta_t * u_seg;
#endif
  const float u_n2 = u_n1 * INV_RATIO;
  // inversion: eta(target) -> normalized xi -> k
  const float xi = clipf(eta_t * xi_a + xi_b, -1.f, 1.f);
  const float k_c = fminf(fmaxf(cheb<JI>(c + JF, xi), 0.f), k_hi);
  float u_c = exp2f(l2u0 + k_c * R6);
  // below range: linear through the first u interval
  if (target < e0) u_c = u0 + (target - e0) * s_lo_inv;
  // beyond range of a row that truly ends: through the last interval
  const float hi_u = u_n2 + (target - e2nd) * s_hi_inv;
  if (target > emax && ends > 0.f) u_c = hi_u;
  // forward: eps(u_c + u_seg)
  const float u_new = u_c + u_seg;
  const float k_new = (log2f(fmaxf(u_new, F32(1e-37))) - l2u0) / R6;
  const float k_cl = fminf(fmaxf(k_new, 0.f), k_hi);
  const float y = clipf(k_cl * ky - 1.f, -1.f, 1.f);
  float eps = 1.f - expf(-expf(cheb<JF>(c, y)));
  // linear extensions outside the active range
  if (k_new < 0.f) eps = e0 + (u_new - u0) * s_lo_fwd;
  if (k_new > k_hi) eps = emax + (u_new - u_n1) * s_hi_fwd;
  // flat rows freeze the value
  if (!(fabsf(emax - e0) > F32(1e-10))) eps = e0;
  return c01(eps);
}

template <int JF, int JI>
struct TurboCorner {
  static constexpr int A = JF + JI;
  static constexpr int Q4 = (A + N_TURBO_AUX + 3) / 4;   // float4 per cell
  static constexpr bool kTaint = true;   // validity 2 marks a bad-fit row
  // Six rays of 100 channels in one block of 608 threads, one block per
  // multiprocessor at 96 registers (header note)
  static constexpr int kLanes = 600;
  static constexpr int kMaxThreads = 608;
  static constexpr int min_blocks(int, bool) { return 1; }
  struct State {
    __device__ __forceinline__ void reset() {}
  };
  __device__ __forceinline__ constexpr int q4() const { return Q4; }
  __device__ __forceinline__ float prep(float target) const {
    return eta_of(target);
  }

  // The four corners of one gas: cells offa, offa + cstep (one p row) and
  // offb, offb + cstep (the next), in float4 units at this thread's
  // channel.  A corner's rows come in Q4 16-byte loads.
  __device__ __forceinline__ void quad(
      const float4* __restrict__ tbl, int D, unsigned offa, unsigned offb,
      unsigned cstep, float target, float eta_t, float u_seg, State&,
      float (&e)[4], float (&tc)[4], float (&pc)[2], float (&vc)[4]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4* p = tbl + (k < 2 ? offa : offb) + (k & 1) * cstep;
      float c[4 * Q4];
#pragma unroll
      for (int a = 0; a < Q4; ++a) {
        const float4 v = __ldg(p + a * D);
        c[4 * a + 0] = v.x;
        c[4 * a + 1] = v.y;
        c[4 * a + 2] = v.z;
        c[4 * a + 3] = v.w;
      }
      e[k] = turbo_corner<JF, JI>(c, target, eta_t, u_seg);
      tc[k] = c[A + 9];
      vc[k] = c[A + 11];
      if ((k & 1) == 0) pc[k >> 1] = c[A + 10];
    }
  }
};

}  // namespace

extern "C" int jt_ega_fused_turbo(JT_EGA_C_PARAMS, int Q, int deg_f,
                                  int deg_i, void* stream) {
  if (deg_f != 8 || deg_i != 8 || Q != 18 + N_TURBO_AUX)
    return (int)cudaErrorInvalidValue;
  return jt::launch_ega(JT_EGA_ARGS, TurboCorner<9, 9>{}, stream);
}
