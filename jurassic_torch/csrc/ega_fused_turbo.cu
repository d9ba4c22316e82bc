// Fused EGA radiative-transfer pass on Chebyshev-compressed ("turbo")
// tables, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels jurassic_tpu/ops/pallas/ega_fused.py
// ::_make_pool_kernel (the production dispatch) and ::_make_kernel in
// turbo mode (its group form).  Both compute the same per-(ray, channel)
// recursion over the line of sight; they differ only in how table rows
// reach VMEM (8-ray sublane groups, 128-lane padding, slot pools, DMA
// double buffers), machinery that exists because the TPU has no
// per-lane dynamic gather.  This kernel has one, so it is laid out like
// the reference's fusion_kernel_GPU (jr_fusion_kernel.mv4g.cu): one block
// per ray, one thread per channel, every thread reading its corners'
// coefficient rows straight from global memory (coef is [G, P*T, Q, D]
// with the channel minor, so every row read is coalesced).  The
// recursion, the launch geometry and the continua are the shared code of
// ega_common.cuh; this file is the turbo corner routine: two Clenshaw
// recurrences per corner, the Chebyshev degrees as template parameters
// (compiled for 8/8, the degree build_turbo_tables fits).
//
// Hybrid taint (the pool kernel's `hit`, ega_fused.py:1375-1379): with a
// taint output the kernel marks a (ray, channel) lane when an active, not
// yet opaque segment read a corner whose validity row is 2 (a row whose
// Chebyshev fit failed the per-row gate); the forward model re-evaluates such
// lanes through the table kernel.  Without bad rows the pointer is null.
//
// What bounds it on the H100: per (segment, gas) each thread reads about
// 35 coefficient rows at each of 4 corners (~140 coalesced 4-byte loads,
// most of them L1/L2 hits because consecutive segments bracket the same
// cells) and spends ~4 x 100 FP32 operations, ~20 of them transcendentals
// (exp2f, log2f, expf, logf, powf, tanhf) on them.  At the flagship (1084
// rays, 274,003 active segments, 4 gases, 100 channels) the compulsory
// HBM traffic is 99 MB (0.03 ms at 3.35 TB/s) and the arithmetic 55 GFLOP
// (0.82 ms at 67 TFLOP/s); the kernel takes 11.7-12.2 ms on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py), so its time is load-path and
// latency time, not a roofline.  What the design does about it: coalesced
// channel-minor rows, bracketing once per (block, segment, gas) instead
// of per thread, static gas and degree loops so the Clenshaw recurrences
// and tau_path stay in registers.  Reusing a corner's rows across the
// consecutive segments that bracket the same cell (in shared memory or
// registers), TMA and wgmma are left to later work; this kernel is the
// simple correct one.
//
// Precision: see ega_common.cuh; every expression follows the operation
// order of the JAX kernel (ega_fused.py:725-856, 1262-1387) and of the
// plain PyTorch version rt_fused_turbo_ref.
//
// C interface (loaded with ctypes): jt_ega_fused_turbo(...) launches on
// the given stream and returns cudaGetLastError().

#include "ega_common.cuh"

namespace {

using jt::c01;
using jt::clipf;

constexpr int N_TURBO_AUX = 21;  // aux rows after the Chebyshev rows

// Clenshaw evaluation of J coefficient rows c[j * D], j = 0..J-1
template <int J>
__device__ __forceinline__ float cheb(const float* __restrict__ c, int D,
                                      float x) {
  const float x2 = 2.f * x;
  float b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int j = J - 1; j > 0; --j) {
    const float t = x2 * b1 - b2 + __ldg(c + j * D);
    b2 = b1;
    b1 = t;
  }
  return x * b1 - b2 + __ldg(c);
}

// curve-of-growth transform of the inversion target (_eta_of): the plain
// log forms with the JAX clips, not log1p
__device__ __forceinline__ float eta_of(float target) {
  const float tc = clipf(target, F32(1e-12), F32(1.0 - 1e-7));
  return logf(fmaxf(-logf(fmaxf(1.f - tc, F32(1e-37))), F32(1e-37)));
}

// One (p, T) corner (_turbo_corner): eps->u inversion and eps(u + u_seg)
// through the eta-space Chebyshev pair; row points at coefficient row 0
// of the corner's cell for this thread's channel (stride D per row).
template <int JF, int JI>
__device__ __forceinline__ float turbo_corner(const float* __restrict__ row,
                                              int D, float target,
                                              float eta_t, float u_seg) {
  constexpr int A = JF + JI;
  const float R6 = F32(1.0 / 6.0);                  // LOG2_RATIO_U
  const float INV_RATIO = F32(0.8908987181403393);  // 2^(-1/6)
  auto ld = [&](int off) { return __ldg(row + off * D); };
  const float l2u0 = ld(A + 0), k_hi = ld(A + 1), e0 = ld(A + 2);
  const float e2nd = ld(A + 4), emax = ld(A + 5), ends = ld(A + 6);
  const float u0 = ld(A + 12), u_n1 = ld(A + 13);
  const float xi_a = ld(A + 14), xi_b = ld(A + 15);
  const float s_lo_inv = ld(A + 16), s_hi_inv = ld(A + 17);
  const float s_lo_fwd = ld(A + 18), s_hi_fwd = ld(A + 19);
  const float ky = ld(A + 20);
  const float u_n2 = u_n1 * INV_RATIO;
  // inversion: eta(target) -> normalized xi -> k
  const float xi = clipf(eta_t * xi_a + xi_b, -1.f, 1.f);
  const float k_c = fminf(fmaxf(cheb<JI>(row + JF * D, D, xi), 0.f), k_hi);
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
  float eps = 1.f - expf(-expf(cheb<JF>(row, D, y)));
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
  static constexpr bool kTaint = true;   // validity 2 marks a bad-fit row
  // No hint for the plain form (80 registers at 2..4 gases by itself).
  // The taint form would take 128 at 4 gases (16.3 instead of 12.7 ms at
  // the flagship, chip_smoke.py): hold it to three blocks of 256.
  static constexpr int min_blocks(int GT, bool TAINT) {
    return (TAINT && GT >= 1 && GT <= 4) ? 3 : 0;
  }
  __device__ __forceinline__ constexpr int q() const {
    return A + N_TURBO_AUX;
  }
  __device__ __forceinline__ constexpr int row_t() const { return A + 9; }
  __device__ __forceinline__ constexpr int row_p() const { return A + 10; }
  __device__ __forceinline__ constexpr int row_valid() const {
    return A + 11;
  }
  __device__ __forceinline__ float prep(float target) const {
    return eta_of(target);
  }
  __device__ __forceinline__ float eval(const float* __restrict__ row, int D,
                                        float target, float eta_t,
                                        float u_seg) const {
    return turbo_corner<JF, JI>(row, D, target, eta_t, u_seg);
  }
};

}  // namespace

extern "C" int jt_ega_fused_turbo(JT_EGA_C_PARAMS, int Q, int deg_f,
                                  int deg_i, void* stream) {
  if (deg_f != 8 || deg_i != 8 || Q != 18 + N_TURBO_AUX)
    return (int)cudaErrorInvalidValue;
  return jt::launch_ega(JT_EGA_ARGS, TurboCorner<9, 9>{}, stream);
}
