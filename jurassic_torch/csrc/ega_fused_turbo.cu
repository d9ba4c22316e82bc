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
// the reference's fusion_kernel_GPU (jr_fusion_kernel.mv4g.cu):
//
//   * one block per ray, one thread per channel; a channel-strided loop
//     covers any channel count D (blockDim = min(256, D rounded up to 32));
//   * the block walks its own ray's np segments;
//   * per segment, threads 0..G-1 bracket the (p, T) table corners of
//     their gas from the channel-uniform axes p_ax/t_ax
//     (_corner_indices semantics: count of axis values <= x within the
//     count, minus 1, clipped to [0, count-2]) into shared memory;
//   * every thread then reads the four corner coefficient rows of each
//     gas straight from global memory: coef is [G, P*T, Q, D] with the
//     channel minor, so neighbouring threads read neighbouring words and
//     every row read is coalesced;
//   * tau_path[G] lives in registers: the gas count is a template
//     parameter (instantiated for G = 1..8, so the gas loop unrolls);
//     larger gas counts (up to 32) use a generic instantiation whose
//     tau_path is a bounded local array;
//   * the Chebyshev degrees are template parameters (compiled for 8/8,
//     the degree build_turbo_tables fits); the four continuum flags are
//     a runtime bit mask (block-uniform branches), so there are 9
//     instantiations instead of the reference's 16-way multiversioning.
//
// What bounds it on the H100: per (segment, gas) each thread reads about
// 35 coefficient rows at each of 4 corners (~140 coalesced 4-byte loads,
// most of them L1/L2 hits because consecutive segments bracket the same
// cells) and spends ~4 x 70 FP32 operations plus ~20 transcendentals
// (exp2f, log2f, expf, logf, powf, tanhf) on them.  At the flagship
// (1084 rays, 274k segments, 4 gases, 100 channels) it runs in ~12 ms on
// an H100 SXM at 700 W: counted from those shapes that is ~5 TB/s of
// L1/L2 row reads but only ~2.6 TFLOP/s (4% of the FP32 peak), so the
// load path, not FP32/SFU issue, is the likely bound.  What the design
// does about it: coalesced channel-minor rows, bracketing once per
// (block, segment, gas) instead of per thread, static gas and degree
// loops so the Clenshaw recurrences and tau_path stay in registers.
// Reusing a corner's rows across the consecutive segments that bracket
// the same cell (in shared memory or registers), TMA and wgmma are left
// to later work; this kernel is the simple correct one.
//
// Precision: float32 with the precise expf/logf/exp2f/log2f/powf/tanhf
// (no --use_fast_math), built with -fmad=false (ops/_build.py).  Every
// expression follows the operation order of the JAX kernel
// (ega_fused.py:725-856, 1262-1387) and of the plain PyTorch version
// rt_fused_turbo_ref in jurassic_torch/ops/ega_fused.py, which runs one
// CUDA kernel per operation with the same libdevice functions; without
// FMA contraction each operation rounds the same way in both.
//
// C interface (loaded with ctypes): jt_ega_fused_turbo(...) launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int N_SEG = 8;         // fixed per-segment stream fields
constexpr int N_CC = 12;         // packed continuum coefficient rows
constexpr int N_TURBO_AUX = 21;  // aux rows after the Chebyshev rows
constexpr int G_CAP = 32;        // largest gas count of the generic case
constexpr int MAX_THREADS = 256;

#define F32(x) ((float)(x))      // a double literal rounded once to f32,
                                 // as NumPy/JAX round Python floats

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float c01(float x) { return clipf(x, 0.f, 1.f); }

// lip with guarded denominator (jr_common.h:48-50)
__device__ __forceinline__ float lipg(float x0, float y0, float x1, float y1,
                                      float x) {
  float d = x1 - x0;
  d = (d == 0.f) ? 1.f : d;
  return y0 + (x - x0) * (y1 - y0) / d;
}

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

// _count_leq: #{v[i] <= x, i < count} - 1 clipped to [0, max(count-2, 0)]
__device__ __forceinline__ int count_leq(const float* __restrict__ v, int n,
                                         int count, float x) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += (i < count && __ldg(v + i) <= x);
  return min(max(c - 1, 0), max(count - 2, 0));
}

template <int GT, int JF, int JI>
__global__ void __launch_bounds__(MAX_THREADS)
ega_fused_turbo_kernel(const float* __restrict__ seg,     // [R, S, F]
                       const int* __restrict__ np_los,    // [R]
                       const float* __restrict__ coef,    // [G, PT, Q, D]
                       const float* __restrict__ sr,      // [n_src, D]
                       const float* __restrict__ cmask,   // [G, D]
                       const float* __restrict__ cc,      // [N_CC + W, D]
                       const float* __restrict__ p_ax,    // [G, P]
                       const float* __restrict__ t_ax,    // [G, P, T]
                       const int* __restrict__ np_u,      // [G]
                       const int* __restrict__ nt_u,      // [G, P]
                       float* __restrict__ rad_out,       // [R, D]
                       float* __restrict__ tau_out,       // [R, D]
                       int S, int F, int W, int G_rt, int P, int T, int D,
                       int n_src, int flags) {
  constexpr int GC = GT > 0 ? GT : G_CAP;
  constexpr int Q = JF + JI + N_TURBO_AUX;
  constexpr int A = JF + JI;
  constexpr int ROW_T = A + 9, ROW_P = A + 10, ROW_VALID = A + 11;
  const int G = GT > 0 ? GT : G_rt;
  const int PT = P * T;
  const size_t cell = (size_t)Q * D;      // floats per (gas, cell)
  const int r = blockIdx.x;
  const float* segr = seg + (size_t)r * S * F;
  const int nb = min(max(np_los[r], 0), S);
  const bool f_co2 = flags & 1, f_h2o = flags & 2;
  const bool f_n2 = flags & 4, f_o2 = flags & 8;

  __shared__ int s_pair[2 * G_CAP];       // (ipt00, ipt10) per gas

  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + threadIdx.x;
    const bool live = d < D;
    float rad = 0.f, tau = 1.f;
    float tau_path[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) tau_path[g] = 1.f;

    for (int s = 0; s < nb; ++s) {
      const float* f = segr + (size_t)s * F;
      __syncthreads();                    // last segment's readers done
      if (threadIdx.x < G) {
        const int g = threadIdx.x;
        const float p = __ldg(f + 1), t = __ldg(f + 2);
        const int ipr = count_leq(p_ax + g * P, P, __ldg(np_u + g), p);
        const int r0 = g * P + ipr;
        const int it0 = count_leq(t_ax + (size_t)r0 * T, T,
                                  __ldg(nt_u + r0), t);
        const int it1 = count_leq(t_ax + (size_t)(r0 + 1) * T, T,
                                  __ldg(nt_u + r0 + 1), t);
        s_pair[2 * g] = ipr * T + it0;
        s_pair[2 * g + 1] = (ipr + 1) * T + it1;
      }
      __syncthreads();
      if (!live) continue;

      const bool valid = __ldg(f + 0) > 0.f;
      const float p_s = __ldg(f + 1), t_s = __ldg(f + 2);
      const float ds_s = __ldg(f + 3), q_h2o = __ldg(f + 4);
      const float u_co2 = __ldg(f + 5), u_h2o = __ldg(f + 6);

      // continua (continua_core, jr_common.h:397-409)
      float kw = 0.f;
      for (int w = 0; w < W; ++w)
        kw = kw + __ldg(f + N_SEG + w) * __ldg(cc + (N_CC + w) * D + d);
      float bds = kw * ds_s;
      if (f_co2) {
        const float dt230 = t_s - 230.f, dt260 = t_s - 260.f;
        const float dt296 = t_s - 296.f;
        const float ctw =
            dt260 * F32(5.050505e-4) * dt296 * __ldg(cc + 2 * D + d) -
            dt230 * F32(9.259259e-4) * dt296 * __ldg(cc + 1 * D + d) +
            dt230 * F32(4.208754e-4) * dt260 * __ldg(cc + 0 * D + d);
        bds = bds + u_co2 * p_s * ctw /
                        F32(6.02214199e23 * 1000.0 * 1013.25);
      }
      if (f_h2o) {
        const float cw296 = __ldg(cc + 3 * D + d);
        const float cw260 = __ldg(cc + 4 * D + d);
        const float base =
            cw296 > 0.f ? cw260 / (cw296 > 0.f ? cw296 : 1.f) : 1.f;
        const float ctwslf = __ldg(cc + 6 * D + d) * cw296 *
                             powf(base, (296.f - t_s) / 36.f);
        const float nu = __ldg(cc + 7 * D + d);
        const float a1 = nu * u_h2o * tanhf(F32(0.7193876) / t_s * nu);
        const float a3 = p_s / F32(1013.25) *
                         (q_h2o * ctwslf +
                          (1.f - q_h2o) * __ldg(cc + 5 * D + d)) *
                         F32(1e-20);
        bds = bds + a1 * (296.f / t_s) * a3;
      }
      if (f_n2 || f_o2) {
        const float pr = p_s / F32(1013.25), tr = 273.f / t_s;
        const float pp2 = (pr * pr) * (tr * tr);
        const float tfac = F32(1.0 / 296.0) - 1.f / t_s;
        if (f_n2) {
          const float mix =
              F32(0.79) + F32(0.21) * (F32(1.294) - F32(0.4545) * t_s / 296.f);
          bds = bds + ds_s * (F32(0.1) * pp2 *
                              expf(__ldg(cc + 9 * D + d) * tfac) * F32(0.79) *
                              __ldg(cc + 8 * D + d) * mix);
        }
        if (f_o2) {
          bds = bds + ds_s * (F32(0.1) * pp2 *
                              expf(__ldg(cc + 11 * D + d) * tfac) *
                              F32(0.21) * __ldg(cc + 10 * D + d));
        }
      }

      // EGA per gas (apply_ega_core, jr_common.h:271-290)
      float tau_gas = 1.f;
#pragma unroll(GT > 0 ? GT : 1)
      for (int g = 0; g < G; ++g) {
        const float tp = tau_path[g];
        const float target = 1.f - tp;
        const float u_seg = __ldg(f + N_SEG + W + g);
        const float eta_t = eta_of(target);
        const float* gbase = coef + (size_t)g * PT * cell + d;
        const float* c0 = gbase + (size_t)s_pair[2 * g] * cell;
        const float* c1 = c0 + cell;
        const float* c2 = gbase + (size_t)s_pair[2 * g + 1] * cell;
        const float* c3 = c2 + cell;
        const float e0 = turbo_corner<JF, JI>(c0, D, target, eta_t, u_seg);
        const float e1 = turbo_corner<JF, JI>(c1, D, target, eta_t, u_seg);
        const float e2 = turbo_corner<JF, JI>(c2, D, target, eta_t, u_seg);
        const float e3 = turbo_corner<JF, JI>(c3, D, target, eta_t, u_seg);
        const float okl = __ldg(cmask + g * D + d) *
                          __ldg(c0 + ROW_VALID * D) * __ldg(c1 + ROW_VALID * D) *
                          __ldg(c2 + ROW_VALID * D) * __ldg(c3 + ROW_VALID * D);
        // bilinear: T within each p row, then p (jr_common.h:259-265)
        const float eps_p0 = c01(lipg(__ldg(c0 + ROW_T * D), e0,
                                      __ldg(c1 + ROW_T * D), e1, t_s));
        const float eps_p1 = c01(lipg(__ldg(c2 + ROW_T * D), e2,
                                      __ldg(c3 + ROW_T * D), e3, t_s));
        const float eps_t = c01(lipg(__ldg(c0 + ROW_P * D), eps_p0,
                                     __ldg(c2 + ROW_P * D), eps_p1, p_s));
        // opacity cut at TAU_OPAQUE and the no-table guard
        const bool opaque = tp < F32(1e-9);
        float factor = (1.f - eps_t) / (opaque ? 1.f : tp);
        factor = okl > 0.f ? factor : 1.f;
        factor = opaque ? 0.f : factor;
        tau_gas = tau_gas * factor;
        if (valid) tau_path[g] = tp * factor;
      }

      // source (src_planck_core on the 0.25 K table, _source_rows)
      const int it =
          min(max(__float2int_rz(4.f * t_s) - 400, 0), n_src - 2);
      const float st0 = 100.f + 0.25f * (float)it;
      const float sr0 = __ldg(sr + (size_t)it * D + d);
      const float src =
          sr0 + (t_s - st0) * (__ldg(sr + (size_t)(it + 1) * D + d) - sr0) *
                    4.f;
      // integration (new_obs_core, jr_common.h:294-300)
      const float eps_tot = 1.f - tau_gas * expf(-bds);
      if (valid && tau_gas > 0.f) {
        rad = rad + src * eps_tot * tau;
        tau = tau * (1.f - eps_tot);
      }
    }
    if (live) {
      rad_out[(size_t)r * D + d] = rad;
      tau_out[(size_t)r * D + d] = tau;
    }
  }
}

template <int GT>
void launch(dim3 grid, dim3 block, cudaStream_t st, const float* seg,
            const int* np_los, const float* coef, const float* sr,
            const float* cmask, const float* cc, const float* p_ax,
            const float* t_ax, const int* np_u, const int* nt_u, float* rad,
            float* tau, int S, int F, int W, int G, int P, int T, int D,
            int n_src, int flags) {
  ega_fused_turbo_kernel<GT, 9, 9><<<grid, block, 0, st>>>(
      seg, np_los, coef, sr, cmask, cc, p_ax, t_ax, np_u, nt_u, rad, tau, S,
      F, W, G, P, T, D, n_src, flags);
}

}  // namespace

extern "C" int jt_ega_fused_turbo(
    const void* seg, const void* np_los, const void* coef, const void* sr,
    const void* cmask, const void* cc, const void* p_ax, const void* t_ax,
    const void* np_u, const void* nt_u, void* rad, void* tau, int R, int S,
    int F, int W, int G, int P, int T, int Q, int D, int n_src, int deg_f,
    int deg_i, int flags, void* stream) {
  if (deg_f != 8 || deg_i != 8 || Q != 18 + N_TURBO_AUX || G < 1 ||
      G > G_CAP || P < 2 || T < 2 || W < 0 || F != N_SEG + W + G ||
      n_src < 2 || R < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = min(MAX_THREADS, ((D + 31) / 32) * 32);
  const dim3 grid(R), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
#define JT_ARGS                                                              \
  grid, block, st, (const float*)seg, (const int*)np_los, (const float*)coef, \
      (const float*)sr, (const float*)cmask, (const float*)cc,               \
      (const float*)p_ax, (const float*)t_ax, (const int*)np_u,             \
      (const int*)nt_u, (float*)rad, (float*)tau, S, F, W, G, P, T, D,      \
      n_src, flags
  switch (G) {
    case 1: launch<1>(JT_ARGS); break;
    case 2: launch<2>(JT_ARGS); break;
    case 3: launch<3>(JT_ARGS); break;
    case 4: launch<4>(JT_ARGS); break;
    case 5: launch<5>(JT_ARGS); break;
    case 6: launch<6>(JT_ARGS); break;
    case 7: launch<7>(JT_ARGS); break;
    case 8: launch<8>(JT_ARGS); break;
    default: launch<0>(JT_ARGS); break;
  }
#undef JT_ARGS
  return (int)cudaGetLastError();
}
