// Shared device code of the fused EGA radiative-transfer kernels
// (ega_fused_turbo.cu, ega_fused_table.cu), for NVIDIA Hopper (sm_90a).
//
// Both kernels compute the same per-(ray, channel) recursion over the line
// of sight (jurassic_tpu/ops/pallas/ega_fused.py::_make_kernel body,
// :1004-1079): continuum optical depth, per-gas EGA transmittance update
// at the four bracketing (p, T) table corners, bilinear interpolation,
// Planck source, rad/tau recursion.  They differ only in how one corner
// turns (target emissivity, segment column density) into the new
// emissivity.  That part is the `Corner` policy:
//
//   struct Corner {
//     static constexpr bool kTaint;  // tables can mark bad-fit rows
//     static constexpr int min_blocks(int GT, bool TAINT);  // occupancy
//                             // hint of an instantiation, 0 = none
//     int q() const;          // table rows per (gas, cell)
//     int row_t() const;      // row holding the cell's temperature
//     int row_p() const;      // ... its pressure
//     int row_valid() const;  // ... its validity (0 none, 1 ok, 2 bad fit)
//     float prep(float target) const;   // once per (gas, segment)
//     float eval(const float* row, int D, float target, float prep,
//                float u_seg) const;    // one corner; row = the cell's
//   };                                  // row 0 at this thread's channel
//
// Launch geometry (ega_fused_kernel): one block per ray, one thread per
// channel with a channel-strided loop for any channel count D
// (blockDim = min(256, D rounded up to 32)); the block walks its own ray's
// np segments; per segment threads 0..G-1 bracket the (p, T) corners of
// their gas from the channel-uniform axes into shared memory
// (_corner_indices semantics); every thread then reads its corners' rows
// straight from global memory, where the channel is the minor axis, so
// neighbouring threads read neighbouring words.  tau_path[G] lives in
// registers: the gas count is a template parameter (G = 1..8 unrolled, a
// generic instantiation up to 32).  The four continuum flags are a runtime
// bit mask (block-uniform branches).  The taint output is a template flag
// too, and the kernel takes its tensors as separate __restrict__
// parameters, not as one struct.  Register counts decide these kernels'
// times: on an NVIDIA H100 80GB HBM3 at 700 W at the flagship (4 gases;
// chip_smoke.py), with a struct parameter and a run-time taint test ptxas
// took 128 registers per thread and the turbo kernel 16.3 ms, as it is
// now 80 registers and 12.0 ms.  A minimum-blocks hint of 1 in
// __launch_bounds__ took the turbo kernel back to 128 registers (12.7 ms)
// and the table kernel to 124 (24.3 ms), no hint leaves the table kernel
// at 110 (24.1 ms), so each corner says which instantiations get a hint.
//
// Precision: float32 with the precise expf/logf/exp2f/log2f/powf/tanhf,
// built with -fmad=false (ops/_build.py): every expression follows the
// operation order of the JAX kernel and of the plain PyTorch versions in
// jurassic_torch/ops/ega_fused.py, and each operation rounds on its own.
#pragma once

#include <cuda_runtime.h>

namespace jt {

constexpr int N_SEG = 8;         // fixed per-segment stream fields
constexpr int N_CC = 12;         // packed continuum coefficient rows
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

// _count_leq: #{v[i] <= x, i < count} - 1 clipped to [0, max(count-2, 0)]
__device__ __forceinline__ int count_leq(const float* __restrict__ v, int n,
                                         int count, float x) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += (i < count && __ldg(v + i) <= x);
  return min(max(c - 1, 0), max(count - 2, 0));
}

// Continuum optical depth of one segment for channel d (continua_core,
// jr_common.h:397-409; _continua_bds): gray extinction plus the enabled
// continua.  f points at the segment's stream fields, cc at the packed
// coefficient rows [N_CC + W, D].
__device__ __forceinline__ float continua_bds(const float* __restrict__ f,
                                              const float* __restrict__ cc,
                                              int W, int D, int d,
                                              int flags) {
  const float p_s = __ldg(f + 1), t_s = __ldg(f + 2);
  const float ds_s = __ldg(f + 3), q_h2o = __ldg(f + 4);
  const float u_co2 = __ldg(f + 5), u_h2o = __ldg(f + 6);
  const bool f_co2 = flags & 1, f_h2o = flags & 2;
  const bool f_n2 = flags & 4, f_o2 = flags & 8;
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
    bds = bds + u_co2 * p_s * ctw / F32(6.02214199e23 * 1000.0 * 1013.25);
  }
  if (f_h2o) {
    const float cw296 = __ldg(cc + 3 * D + d);
    const float cw260 = __ldg(cc + 4 * D + d);
    const float base =
        cw296 > 0.f ? cw260 / (cw296 > 0.f ? cw296 : 1.f) : 1.f;
    const float ctwslf =
        __ldg(cc + 6 * D + d) * cw296 * powf(base, (296.f - t_s) / 36.f);
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
                          expf(__ldg(cc + 11 * D + d) * tfac) * F32(0.21) *
                          __ldg(cc + 10 * D + d));
    }
  }
  return bds;
}

// Source radiance of channel d at temperature t_s from the 0.25 K table
// (src_planck_core with the locate_st index, _source_rows)
__device__ __forceinline__ float source_at(const float* __restrict__ sr,
                                           int n_src, int D, int d,
                                           float t_s) {
  const int it = min(max(__float2int_rz(4.f * t_s) - 400, 0), n_src - 2);
  const float st0 = 100.f + 0.25f * (float)it;
  const float sr0 = __ldg(sr + (size_t)it * D + d);
  return sr0 +
         (t_s - st0) * (__ldg(sr + (size_t)(it + 1) * D + d) - sr0) * 4.f;
}

// The tensors and sizes both kernels take (host side; the kernel gets
// them as separate parameters).
struct EgaArgs {
  const float* seg;     // [R, S, F] segment stream (pack_segments)
  const int* np_los;    // [R] segments per ray
  const float* tbl;     // [G, P*T, q, D] table rows, channel minor
  const float* sr;      // [n_src, D]
  const float* cmask;   // [G, D]
  const float* cc;      // [N_CC + W, D]
  const float* p_ax;    // [G, P]
  const float* t_ax;    // [G, P, T]
  const int* np_u;      // [G]
  const int* nt_u;      // [G, P]
  float* rad;           // [R, D]
  float* tau;           // [R, D]
  float* taint;         // [R, D] or null: 1 where an active, not yet
                        // opaque segment read a corner marked 2 (bad fit)
  int R, S, F, W, G, P, T, D, n_src, flags;
};

// The C entry points take the tensors in this order, then the sizes.
#define JT_EGA_C_PARAMS                                                     \
  const void *seg, const void *np_los, const void *tbl, const void *sr,    \
      const void *cmask, const void *cc, const void *p_ax,                 \
      const void *t_ax, const void *np_u, const void *nt_u, void *rad,     \
      void *tau, void *taint, int R, int S, int F, int W, int G, int P,    \
      int T, int D, int n_src, int flags
#define JT_EGA_ARGS                                                         \
  jt::EgaArgs {                                                             \
    (const float*)seg, (const int*)np_los, (const float*)tbl,              \
        (const float*)sr, (const float*)cmask, (const float*)cc,           \
        (const float*)p_ax, (const float*)t_ax, (const int*)np_u,          \
        (const int*)nt_u, (float*)rad, (float*)tau, (float*)taint, R, S,   \
        F, W, G, P, T, D, n_src, flags                                      \
  }

template <int GT, bool TAINT, class Corner>
__global__ void __launch_bounds__(MAX_THREADS, Corner::min_blocks(GT, TAINT))
ega_fused_kernel(const float* __restrict__ seg,
                 const int* __restrict__ np_los,
                 const float* __restrict__ tbl,
                 const float* __restrict__ sr,
                 const float* __restrict__ cmask,
                 const float* __restrict__ cc,
                 const float* __restrict__ p_ax,
                 const float* __restrict__ t_ax,
                 const int* __restrict__ np_u,
                 const int* __restrict__ nt_u, float* __restrict__ rad_out,
                 float* __restrict__ tau_out, float* __restrict__ taint_out,
                 int S, int F, int W, int G_rt, int P, int T, int D,
                 int n_src, int flags, const Corner corner) {
  constexpr int GC = GT > 0 ? GT : G_CAP;
  const int G = GT > 0 ? GT : G_rt;
  const int PT = P * T;
  const int row_t = corner.row_t(), row_p = corner.row_p();
  const int row_valid = corner.row_valid();
  const size_t cell = (size_t)corner.q() * D;   // floats per (gas, cell)
  const int r = blockIdx.x;
  const float* segr = seg + (size_t)r * S * F;
  const int nb = min(max(np_los[r], 0), S);

  __shared__ int s_pair[2 * G_CAP];       // (ipt00, ipt10) per gas

  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + threadIdx.x;
    const bool live = d < D;
    float rad = 0.f, tau = 1.f, taint = 0.f;
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
      const float bds = continua_bds(f, cc, W, D, d, flags);

      // EGA per gas (apply_ega_core, jr_common.h:271-290)
      float tau_gas = 1.f;
#pragma unroll(GT > 0 ? GT : 1)
      for (int g = 0; g < G; ++g) {
        const float tp = tau_path[g];
        const float target = 1.f - tp;
        const float u_seg = __ldg(f + N_SEG + W + g);
        const float prep = corner.prep(target);
        const float* gbase = tbl + (size_t)g * PT * cell + d;
        const float* c0 = gbase + (size_t)s_pair[2 * g] * cell;
        const float* c1 = c0 + cell;
        const float* c2 = gbase + (size_t)s_pair[2 * g + 1] * cell;
        const float* c3 = c2 + cell;
        const float e0 = corner.eval(c0, D, target, prep, u_seg);
        const float e1 = corner.eval(c1, D, target, prep, u_seg);
        const float e2 = corner.eval(c2, D, target, prep, u_seg);
        const float e3 = corner.eval(c3, D, target, prep, u_seg);
        const float v0 = __ldg(c0 + row_valid * D);
        const float v1 = __ldg(c1 + row_valid * D);
        const float v2 = __ldg(c2 + row_valid * D);
        const float v3 = __ldg(c3 + row_valid * D);
        const float okl = __ldg(cmask + g * D + d) * v0 * v1 * v2 * v3;
        // bilinear: T within each p row, then p (jr_common.h:259-265)
        const float eps_p0 = c01(lipg(__ldg(c0 + row_t * D), e0,
                                      __ldg(c1 + row_t * D), e1, t_s));
        const float eps_p1 = c01(lipg(__ldg(c2 + row_t * D), e2,
                                      __ldg(c3 + row_t * D), e3, t_s));
        const float eps_t = c01(lipg(__ldg(c0 + row_p * D), eps_p0,
                                     __ldg(c2 + row_p * D), eps_p1, p_s));
        // opacity cut at TAU_OPAQUE and the no-table guard, by selects:
        // whatever a dead corner produced never reaches tau_path
        const bool opaque = tp < F32(1e-9);
        float factor = (1.f - eps_t) / (opaque ? 1.f : tp);
        factor = okl > 0.f ? factor : 1.f;
        factor = opaque ? 0.f : factor;
        tau_gas = tau_gas * factor;
        if (valid) tau_path[g] = tp * factor;
        if (TAINT) {
          const float badv = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
          if (valid && !opaque && badv > 1.5f) taint = 1.f;
        }
      }

      // integration (new_obs_core, jr_common.h:294-300)
      const float src = source_at(sr, n_src, D, d, t_s);
      const float eps_tot = 1.f - tau_gas * expf(-bds);
      if (valid && tau_gas > 0.f) {
        rad = rad + src * eps_tot * tau;
        tau = tau * (1.f - eps_tot);
      }
    }
    if (live) {
      rad_out[(size_t)r * D + d] = rad;
      tau_out[(size_t)r * D + d] = tau;
      if (TAINT) taint_out[(size_t)r * D + d] = taint;
    }
  }
}

// Checks the shared arguments, picks the instantiation (gas count; taint
// output where the corner's tables can mark rows and a buffer is given),
// launches on `stream`; returns the cudaError (0 = launched).
template <class Corner>
int launch_ega(const EgaArgs& a, const Corner& corner, void* stream) {
  if (a.G < 1 || a.G > G_CAP || a.P < 2 || a.T < 2 || a.W < 0 ||
      a.F != N_SEG + a.W + a.G || a.n_src < 2 || a.R < 1 || a.D < 1 ||
      a.S < 0 || (a.taint != nullptr && !Corner::kTaint))
    return (int)cudaErrorInvalidValue;
  const int threads = min(MAX_THREADS, ((a.D + 31) / 32) * 32);
  const dim3 grid(a.R), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
#define JT_LAUNCH_T(GT, TAINT)                                           \
  ega_fused_kernel<GT, TAINT, Corner><<<grid, block, 0, st>>>(           \
      a.seg, a.np_los, a.tbl, a.sr, a.cmask, a.cc, a.p_ax, a.t_ax,       \
      a.np_u, a.nt_u, a.rad, a.tau, a.taint, a.S, a.F, a.W, a.G, a.P,    \
      a.T, a.D, a.n_src, a.flags, corner)
#define JT_LAUNCH(GT)                                                    \
  if (Corner::kTaint && a.taint != nullptr)                              \
    JT_LAUNCH_T(GT, Corner::kTaint);                                     \
  else                                                                   \
    JT_LAUNCH_T(GT, false)
  switch (a.G) {
    case 1: JT_LAUNCH(1); break;
    case 2: JT_LAUNCH(2); break;
    case 3: JT_LAUNCH(3); break;
    case 4: JT_LAUNCH(4); break;
    case 5: JT_LAUNCH(5); break;
    case 6: JT_LAUNCH(6); break;
    case 7: JT_LAUNCH(7); break;
    case 8: JT_LAUNCH(8); break;
    default: JT_LAUNCH(0); break;
  }
#undef JT_LAUNCH
#undef JT_LAUNCH_T
  return (int)cudaGetLastError();
}

}  // namespace jt
