// Fused EGA radiative-transfer pass on the exact log-uniform emissivity
// tables ("table mode"), for NVIDIA Hopper (sm_90a).
//
// Replaces the table-mode body of the Pallas TPU kernel
// jurassic_tpu/ops/pallas/ega_fused.py::_make_kernel (mode = "table",
// row_lookup at :980-1002): KERNEL = pallas, the exact backing of the
// turbo hybrid, and what KERNEL = auto demotes to when the Chebyshev fit
// is rejected.  The recursion, the launch geometry and the continua are
// the shared code of ega_common.cuh; this file is the corner routine.
//
// Per corner the TPU kernel counts the rows of the K-row emissivity curve
// that are <= the target, extracts the bracketing pair by a masked max/min
// over K, inverts to a column density on the log-uniform u grid
// u_k = u0 2^(k/6), adds the segment's column, finds the new row index by
// log2 arithmetic and brackets again.  The masked reductions over K (and
// the slabs, double buffers and group schedule that feed them) exist
// because Mosaic has no per-lane gather.  Here every thread indexes the
// column of its own channel directly: eps_aug is [G, P*T, K + 5, D] with
// the channel minor (rows 0..K-1 the curve padded with BIG = 1e30 beyond
// the cell's count, then log2_u0, T, p, valid, nk2 = max(count - 2, 0)),
// so row k of a cell is at stride D and the threads of a warp read one
// coalesced line per probe.
//
//   * monotone rows (what build_fast_tables produces; checked on the host
//     by build_table_tables): a binary search for the last eps <= target
//     (about log2 K probes), two direct loads for the bracket, exp2f and
//     log2f, two more loads for the forward lookup;
//   * otherwise (injected tables with a non-monotone live row): the
//     literal count and masked max/min scans over all K rows, which equal
//     the search only on monotone rows.
//
// What bounds it on the H100: the table is large (flagship 4 x 1200 x 229
// x 100 x 4 B = 440 MB) and read by data-dependent probes.  Compulsory
// traffic is 464 MB (0.14 ms at 3.35 TB/s) and the arithmetic 25 GFLOP
// (0.38 ms at 67 TFLOP/s); the kernel takes 17.3 ms on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py) at 80 registers and 24 ms at 110, so its
// time is dependent-load latency hidden by occupancy, not FP32 throughput.
// What the design does about it: coalesced channel-minor rows, a
// logarithmic search and an occupancy hint (min_blocks), nothing more.
// Staging a corner's column in shared memory across the consecutive
// segments that bracket the same cell, cp.async/TMA and remembering the
// last index are left to later work; this kernel is the simple correct
// one.
//
// C interface (loaded with ctypes): jt_ega_fused_table(...) launches on
// the given stream and returns cudaGetLastError().

#include "ega_common.cuh"

namespace {

using jt::c01;
using jt::lipg;

constexpr float BIG = 1.0e30f;   // eps-row padding sentinel

struct TableCorner {
  static constexpr bool kTaint = false;  // exact rows: nothing to mark
  // Latency-bound: three blocks of 256 per SM (80 registers) run the
  // flagship in 17 ms, the 110 registers ptxas takes unasked in 24 ms
  // (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).
  static constexpr int min_blocks(int, bool) { return 3; }
  int K;          // eps rows per cell
  bool monotone;  // every live row is non-decreasing: search, else scan
  __device__ __forceinline__ int q() const { return K + 5; }
  __device__ __forceinline__ int row_t() const { return K + 1; }
  __device__ __forceinline__ int row_p() const { return K + 2; }
  __device__ __forceinline__ int row_valid() const { return K + 3; }
  __device__ __forceinline__ float prep(float) const { return 0.f; }

  // #{k : row[k] <= x}
  __device__ __forceinline__ int count(const float* __restrict__ row, int D,
                                       float x) const {
    if (monotone) {
      int lo = 0, hi = K;        // first k with row[k] > x (upper bound)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(row + (size_t)mid * D) <= x) lo = mid + 1; else hi = mid;
      }
      return lo;
    }
    int c = 0;
    for (int k = 0; k < K; ++k) c += (__ldg(row + (size_t)k * D) <= x);
    return c;
  }

  // (max of row[0..i], min of row[i+1..K-1]): row[i], row[i+1] on
  // monotone rows (bracket, ega_fused.py:970-978)
  __device__ __forceinline__ void bracket(const float* __restrict__ row,
                                          int D, int i, float& lo,
                                          float& hi) const {
    if (monotone) {
      lo = __ldg(row + (size_t)i * D);
      hi = i + 1 < K ? __ldg(row + (size_t)(i + 1) * D) : BIG;
      return;
    }
    lo = -BIG;
    hi = BIG;
    for (int k = 0; k < K; ++k) {
      const float v = __ldg(row + (size_t)k * D);
      if (k <= i) lo = fmaxf(lo, v); else hi = fminf(hi, v);
    }
  }

  // One (p, T) corner (row_lookup): eps -> u inversion and eps(u + u_seg)
  // on the log-uniform grid (get_u/get_eps, jr_common.h:157-185).
  __device__ __forceinline__ float eval(const float* __restrict__ row, int D,
                                        float target, float, float u_seg)
      const {
    const float R6 = F32(1.0 / 6.0);               // LOG2_RATIO_U
    const float RATIO = F32(1.122462048309373);    // 2^(1/6)
    const float l2u0 = __ldg(row + (size_t)K * D);
    const int nk2 = __float2int_rz(__ldg(row + (size_t)(K + 4) * D));
    // invert: index of the last eps <= target (locate_tbl_id)
    const int i = min(max(count(row, D, target) - 1, 0), nk2);
    float e0, e1;
    bracket(row, D, i, e0, e1);
    const float u0 = exp2f(l2u0 + (float)i * R6);
    const float u_c = lipg(e0, u0, e1, u0 * RATIO, target);
    // forward: index from log2 arithmetic, clipped before the cast
    const float u_new = u_c + u_seg;
    float kf = (log2f(fmaxf(u_new, F32(1e-37))) - l2u0) / R6;
    kf = fminf(fmaxf(kf, 0.f), (float)K);
    const int ki = min(__float2int_rz(kf), nk2);
    float e_lo, e_hi;
    bracket(row, D, ki, e_lo, e_hi);
    const float u_lo = exp2f(l2u0 + (float)ki * R6);
    return c01(lipg(u_lo, e_lo, u_lo * RATIO, e_hi, u_new));
  }
};

}  // namespace

extern "C" int jt_ega_fused_table(JT_EGA_C_PARAMS, int K, int monotone,
                                  void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  return jt::launch_ega(JT_EGA_ARGS, TableCorner{K, monotone != 0}, stream);
}
