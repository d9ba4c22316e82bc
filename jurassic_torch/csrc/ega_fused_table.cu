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
// column of its own channel directly.  The table is [G, P*T, Q4, D]
// float4 with four consecutive rows of a channel in one float4
// (turbo_fit.pack_rows): logical rows 0..K-1 the curve padded with BIG =
// 1e30 beyond the cell's count, then log2_u0, T, p, valid, nk2 =
// max(count - 2, 0).
//
//   * monotone rows (what build_fast_tables produces; checked on the host
//     by build_table_tables): a search for the last eps <= target that
//     starts at the group of four rows the last segment's forward lookup
//     of this corner ended in, gallops outwards and bisects
//     (table_pack.hinted_count is its NumPy statement; whatever the hint,
//     it returns what a cold search returns), the bracket from the group
//     already in registers, exp2f and log2f, and the forward bracket, again
//     mostly from that group;
//   * otherwise (injected tables with a non-monotone live row): the
//     literal count and masked max/min scans over all K rows, which equal
//     the search only on monotone rows.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W, flagship;
// PERF.md has the runs, tools/ega_split.py makes them).  The table is
// large (4 x 1200 x 229 x 100 x 4 B = 440 MB) and read by data-dependent
// probes; the roofline is far away (464 MB = 0.14 ms, 25 GFLOP = 0.38 ms).
// The first kernel (cold 8-probe binary search, 4-byte loads, one block
// per ray) took 17.3 ms: 8 ms of it the search, 6 ms misses of the L1
// cache, 7 ms the rest.  With the hint a corner needs one 16-byte load of
// the curve instead of twelve 4-byte ones in a chain; the search now costs
// 1.8 ms and the misses 1.1 ms of 10.7 ms.  The remaining 8.1 ms are the
// scheduler and latency floor of this arithmetic (per corner three precise
// divisions, two exp2f, a log2f) at 80 registers, which is where three
// blocks of 224 threads fit a multiprocessor: at 128 registers (no
// spills) it takes 14.4 ms, at 64 registers 12.0 ms.  Staging the loads
// of all four corners at once cost registers and won nothing (11.1 ms),
// two by two is kept (10.7 ms); six rays per block as in the turbo kernel
// gave 10.4-10.8 ms, no better: this kernel's rays share little beyond
// the aux rows.
//
// -DJT_SPLIT_INDEX (tools/ega_split.py only): the search is replaced by
// an index computed from the target; the result is wrong.
//
// C interface (loaded with ctypes): jt_ega_fused_table(...) launches on
// the given stream and returns cudaGetLastError().

#include "ega_common.cuh"

namespace {

using jt::c01;
using jt::lipg;

constexpr float BIG = 1.0e30f;   // eps-row padding sentinel

// component i (0..3) of a float4
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct TableCorner {
  static constexpr bool kTaint = false;  // exact rows: nothing to mark
  // Two rays of 100 channels in one block of 224 threads, three blocks
  // per multiprocessor at 80 registers (header note)
  static constexpr int kLanes = 200;
  static constexpr int kMaxThreads = 224;
  static constexpr int min_blocks(int, bool) { return 3; }
  int K;          // eps rows per cell
  bool monotone;  // every live row is non-decreasing: search, else scan

  // the group of four rows (one float4) in which the last segment's
  // search of each corner ended
  struct State {
    int h[4];
    __device__ __forceinline__ void reset() { h[0] = h[1] = h[2] = h[3] = 0; }
  };
  __device__ __forceinline__ int q4() const { return (K + 5 + 3) >> 2; }
  __device__ __forceinline__ float prep(float) const { return 0.f; }

  // row k of the column whose group 0 is at col (any k < 4 * q4)
  __device__ __forceinline__ float row_at(const float4* __restrict__ col,
                                          int D, int k) const {
    return __ldg(reinterpret_cast<const float*>(col + (k >> 2) * D) +
                 (k & 3));
  }

  // rows of group a (rows 4a .. 4a+3 below K) that are <= x
  __device__ __forceinline__ int in_group(const float4& v, int a,
                                          float x) const {
    const int n = K - 4 * a;
    return (int)(v.x <= x) + (int)(n > 1 && v.y <= x) +
           (int)(n > 2 && v.z <= x) + (int)(n > 3 && v.w <= x);
  }

  // groups lo < hi with first(lo) <= x (or lo == 0) and first(hi) > x (or
  // hi past the last group): the last group whose first row is <= x; v
  // follows lo
  __device__ __forceinline__ int bisect(const float4* __restrict__ col,
                                        int D, float x, int lo, int hi,
                                        float4& v) const {
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      const float4 w = __ldg(col + mid * D);
      if (w.x <= x) {
        lo = mid;
        v = w;
      } else {
        hi = mid;
      }
    }
    return lo;
  }

  // #{k : row[k] <= x} on a non-decreasing column, from the hinted group
  // a whose rows are in v (ops/table_pack.py::hinted_count states it in
  // NumPy): if the group's first row is above x gallop left, if all its
  // rows are <= x gallop right, stop as soon as a group holds a row above
  // x, else bisect; on return a is the group found and v its rows.
  __device__ __forceinline__ int count_from(const float4* __restrict__ col,
                                            int D, float x, int& a,
                                            float4& v) const {
    const int NG = (K + 3) >> 2;
    int cnt = in_group(v, a, x);
    if (a > 0 && !(v.x <= x)) {
      int hi = a, step = 1, lo;
      for (;;) {
        lo = max(hi - step, 0);
        v = __ldg(col + lo * D);
        if (lo == 0 || v.x <= x) break;
        hi = lo;
        step <<= 1;
      }
      cnt = in_group(v, lo, x);
      if (cnt == min(4, K - 4 * lo) && hi - lo > 1) {
        lo = bisect(col, D, x, lo, hi, v);
        cnt = in_group(v, lo, x);
      }
      a = lo;
    } else if (cnt == min(4, K - 4 * a) && a + 1 < NG) {
      int lo = a, step = 1, hi;
      for (;;) {
        hi = min(lo + step, NG);
        if (hi == NG) break;
        const float4 w = __ldg(col + hi * D);
        if (!(w.x <= x)) break;
        lo = hi;
        v = w;
        step <<= 1;
        cnt = in_group(v, lo, x);
        if (cnt < min(4, K - 4 * lo)) {    // the answer is in this group
          hi = lo + 1;
          break;
        }
      }
      if (hi - lo > 1) {
        lo = bisect(col, D, x, lo, hi, v);
        cnt = in_group(v, lo, x);
      }
      a = lo;
    }
    return 4 * a + cnt;
  }

  // row[i], row[i+1] (BIG past the last row) of a non-decreasing column;
  // group a of the column is in v: if row i lies in another group, that
  // one is loaded and takes its place
  __device__ __forceinline__ void pair_at(const float4* __restrict__ col,
                                          int D, int i, int& a, float4& v,
                                          float& lo, float& hi) const {
    const int gi = i >> 2, ci = i & 3;
    if (gi != a) {
      v = __ldg(col + gi * D);
      a = gi;
    }
    lo = comp(v, ci);
    if (ci < 3)
      hi = ci == 0 ? v.y : ci == 1 ? v.z : v.w;
    else
      hi = i + 1 < K ? row_at(col, D, i + 1) : BIG;
    if (i + 1 >= K) hi = BIG;
  }

  // the literal forms for tables with a non-monotone live row: the count,
  // and (max of row[0..i], min of row[i+1..K-1]) (bracket,
  // ega_fused.py:970-978)
  __device__ __forceinline__ int count_scan(const float4* __restrict__ col,
                                            int D, float x) const {
    int c = 0;
    for (int k = 0; k < K; ++k) c += (row_at(col, D, k) <= x);
    return c;
  }
  __device__ __forceinline__ void bracket_scan(
      const float4* __restrict__ col, int D, int i, float& lo,
      float& hi) const {
    lo = -BIG;
    hi = BIG;
    for (int k = 0; k < K; ++k) {
      const float v = row_at(col, D, k);
      if (k <= i) lo = fmaxf(lo, v); else hi = fminf(hi, v);
    }
  }

  // The four corners of one gas (row_lookup: eps -> u inversion and
  // eps(u + u_seg) on the log-uniform grid, get_u/get_eps,
  // jr_common.h:157-185): cells offa, offa + cstep (one p row) and offb,
  // offb + cstep (the next), in float4 units at this thread's channel.
  // The loads that depend on nothing but the cell (the aux rows and the
  // hinted group) are started for the two corners of a p row together; a
  // corner whose hint holds then needs no further load unless a bracket
  // straddles two groups.  The hint a corner leaves is the group of its
  // forward index: the next segment's target is the interpolated new
  // emissivity, so its inversion lands where this forward lookup did.
  __device__ __forceinline__ void quad(
      const float4* __restrict__ tbl, int D, unsigned offa, unsigned offb,
      unsigned cstep, float target, float, float u_seg, State& st,
      float (&e)[4], float (&tc)[4], float (&pc)[2], float (&vc)[4]) const {
    const float R6 = F32(1.0 / 6.0);               // LOG2_RATIO_U
    const float RATIO = F32(1.122462048309373);    // 2^(1/6)
    const int ga = K >> 2, k0 = K & 3;             // aux rows: group, lane
    const float4* col[4];
    float4 x0[4], v[4];
    float nk2f[4];
    int a[4];
#pragma unroll
    for (int k00 = 0; k00 < 4; k00 += 2) {
#pragma unroll
      for (int k = k00; k < k00 + 2; ++k) {
        col[k] = tbl + (k < 2 ? offa : offb) + (k & 1) * cstep;
        a[k] = st.h[k];
        x0[k] = __ldg(col[k] + ga * D);
        nk2f[k] = row_at(col[k], D, K + 4);
        v[k] = __ldg(col[k] + a[k] * D);
      }
#pragma unroll
      for (int k = k00; k < k00 + 2; ++k) {
        // aux rows K .. K+3: log2_u0, T, p, valid
        float l2u0;
        if (k0 == 0) {
          l2u0 = x0[k].x;
          tc[k] = x0[k].y;
          if ((k & 1) == 0) pc[k >> 1] = x0[k].z;
          vc[k] = x0[k].w;
        } else {
          auto aux = [&](int r) {
            return k0 + r < 4 ? comp(x0[k], k0 + r)
                              : row_at(col[k], D, K + r);
          };
          l2u0 = aux(0);
          tc[k] = aux(1);
          if ((k & 1) == 0) pc[k >> 1] = aux(2);
          vc[k] = aux(3);
        }
        const int nk2 = __float2int_rz(nk2f[k]);
        // invert: index of the last eps <= target (locate_tbl_id)
        float e0, e1;
        int i;
        if (monotone) {
#ifdef JT_SPLIT_INDEX
          const int cnt = min(max(__float2int_rz(target * (float)K), 0), K);
#else
          const int cnt = count_from(col[k], D, target, a[k], v[k]);
#endif
          i = min(max(cnt - 1, 0), nk2);
          pair_at(col[k], D, i, a[k], v[k], e0, e1);
        } else {
          i = min(max(count_scan(col[k], D, target) - 1, 0), nk2);
          bracket_scan(col[k], D, i, e0, e1);
        }
        const float u0 = exp2f(l2u0 + (float)i * R6);
        const float u_c = lipg(e0, u0, e1, u0 * RATIO, target);
        // forward: index from log2 arithmetic, clipped before the cast
        const float u_new = u_c + u_seg;
        float kf = (log2f(fmaxf(u_new, F32(1e-37))) - l2u0) / R6;
        kf = fminf(fmaxf(kf, 0.f), (float)K);
        const int ki = min(__float2int_rz(kf), nk2);
        float e_lo, e_hi;
        if (monotone) {
          pair_at(col[k], D, ki, a[k], v[k], e_lo, e_hi);
          st.h[k] = a[k];
        } else {
          bracket_scan(col[k], D, ki, e_lo, e_hi);
        }
        const float u_lo = exp2f(l2u0 + (float)ki * R6);
        e[k] = c01(lipg(u_lo, e_lo, u_lo * RATIO, e_hi, u_new));
      }
    }
  }
};

}  // namespace

extern "C" int jt_ega_fused_table(JT_EGA_C_PARAMS, int K, int monotone,
                                  void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  return jt::launch_ega(JT_EGA_ARGS, TableCorner{K, monotone != 0}, stream);
}
