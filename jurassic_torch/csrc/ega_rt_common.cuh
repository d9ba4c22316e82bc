// Device code that the RT pass's kernels share: the primal kernel
// (ega_rt.cu, the counterpart of the JAX package's jitted ``rt_integrate``
// scan, jurassic_tpu/forward.py:99-176) and the tangent pass's record
// kernel (ega_jvp_fast.cu).  One statement of a segment's step serves
// both: the tables' brackets, the four corners of a gas on the fast tables
// (ops.ega._ega_fast) or on the exact tables (ops.ega._ega_exact), a gas's
// factor and its partials, the continua (ops.continua.beta_ds) and the
// Planck source (forward.src_planck).
//
// Numbers: every operation repeats the plain version's, in its order
// (the library builds with -fmad=false, libdevice's transcendentals).
// Where PyTorch's CUDA operators do other arithmetic than the Python text
// reads, the code here states what they do, with the Python beside it:
// ``x / s`` by a Python scalar is ``x * (1 / s)`` (div_true_kernel_cuda
// multiplies by the scalar's reciprocal), ``s / x`` is ``x.reciprocal() *
// s`` (Tensor.__rtruediv__), ``x ** 2`` is ``x * x`` and a constant such as
// ``1 - 0.79`` is the Python float, not 0.21.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jt_rt {

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double m_exp2(double x) { return exp2(x); }
__device__ __forceinline__ float m_log2(float x) { return log2f(x); }
__device__ __forceinline__ double m_log2(double x) { return log2(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float m_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double m_tanh(double x) { return tanh(x); }
__device__ __forceinline__ int trunc_int(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int trunc_int(double x) {
  return __double2int_rz(x);
}

// torch.clamp(x, 0, 1) (NaN stays NaN) and where it passes a tangent
template <typename T>
__device__ __forceinline__ T c01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}
template <typename T>
__device__ __forceinline__ bool in01(T x) {
  return x >= T(0) && x <= T(1);
}
template <typename T>
__device__ __forceinline__ T guard(T d) {
  return d == T(0) ? T(1) : d;
}
// ops.ega._lip: a guarded linear interpolation that extrapolates; the
// x's in B, the y's in Y (their difference taken in Y, as torch's type
// promotion does where float64 axes meet float32 values)
template <typename B, typename Y>
__device__ __forceinline__ B lip(B x0, Y y0, B x1, Y y1, B x) {
  const Y dy = y1 - y0;
  return B(y0) + (x - x0) * B(dy) / guard(x1 - x0);
}

// ops.ega._count_index over a float64 axis row v[i stride], i < len,
// within count, at x: #{v <= x} - 1 clipped to [0, max(count - 2, 0)]
__device__ __forceinline__ int count_index(const double* __restrict__ v,
                                           int stride, int len, int count,
                                           double x) {
  const int m = len < count ? len : count;
  int below = 0;
  for (int i = 0; i < m; ++i)
    below += __ldg(v + (size_t)i * stride) <= x ? 1 : 0;
  int idx = below - 1 < 0 ? 0 : below - 1;
  const int hi = count - 2 < 0 ? 0 : count - 2;
  return idx < hi ? idx : hi;
}

// The (p, T) axes of either table kind (integers as int32), channels
// innermost so that a warp's per-channel loads coalesce
struct Axes {
  const double* __restrict__ p_ax;   // [G, P, D]
  const double* __restrict__ t_ax;   // [G, P, T, D]
  const int* __restrict__ nt;        // [G, P, D]
  const int* __restrict__ np_;       // [G, D]
  int P, NT, D;
};

// The fast tables (ops.ega.FastDeviceTables; valid as bytes)
struct FastTab {
  Axes ax;
  const float* __restrict__ eps;     // [G, P, T, K, D]
  const double* __restrict__ l2u0;   // [G, P, T, D]
  const int* __restrict__ nu;        // [G, P, T, D]
  const uint8_t* __restrict__ ok;    // [G, P, T, D]
  int K;
};

// The exact tables (ops.ega.EgaDeviceTables): the u and eps rows
// channel-innermost, so that a warp's channels at one row entry read
// adjacent values (entry k of a channel's row at k D)
struct ExactTab {
  Axes ax;
  const float* __restrict__ u;       // [G, P, T, U, D]
  const float* __restrict__ eps;     // [G, P, T, U, D]
  const int* __restrict__ nu;        // [G, P, T, D]
  const uint8_t* __restrict__ mono;  // [G, P, T, D] bit 0 eps, bit 1 u row
  int U;
};

// Constants from the host (jurassic_torch/constants.py, tables.py)
struct Consts {
  double k0, p0, c1, c2, tau_opaque, tau_cutoff, log2_ratio_u, ratio_u;
};

// One gas's bracket of a channel at (p, t) (ops.ega._brackets): pressure
// level, temperature rows of the two levels, the axis values the bilinear
// weights read, and whether the gas has no table there
struct Bracket {
  double t00, t01, t10, t11, p0, p1;
  int ipr, it0, it1, no_table;
};

__device__ __forceinline__ Bracket bracket(const Axes& ax, int g, int d,
                                           double p, double t) {
  const int P = ax.P, NT = ax.NT, D = ax.D;
  const int npg = __ldg(ax.np_ + g * D + d);
  const double* pax = ax.p_ax + (size_t)g * P * D + d;
  Bracket b;
  b.ipr = count_index(pax, D, P, npg, p);
  const int ipr1 = b.ipr + 1 < P ? b.ipr + 1 : P - 1;
  const int nt_lo = __ldg(ax.nt + ((size_t)g * P + b.ipr) * D + d);
  const int nt_hi = __ldg(ax.nt + ((size_t)g * P + ipr1) * D + d);
  const double* tlo = ax.t_ax + ((size_t)g * P + b.ipr) * NT * D + d;
  const double* thi = ax.t_ax + ((size_t)g * P + ipr1) * NT * D + d;
  b.it0 = count_index(tlo, D, NT, nt_lo, t);
  b.it1 = count_index(thi, D, NT, nt_hi, t);
  auto at = [&](const double* v, int i) {
    return __ldg(v + (size_t)(i < 0 ? 0 : (i > NT - 1 ? NT - 1 : i)) * D);
  };
  b.t00 = at(tlo, b.it0);
  b.t01 = at(tlo, b.it0 + 1);
  b.t10 = at(thi, b.it1);
  b.t11 = at(thi, b.it1 + 1);
  b.p0 = __ldg(pax + (size_t)b.ipr * D);
  b.p1 = __ldg(pax + (size_t)ipr1 * D);
  b.no_table = npg < 2 || nt_lo < 2 || nt_hi < 2;
  return b;
}

// Whether i is the index of a row that does not decrease within its n
// entries at x (i in [0, lmax], lmax = max(n - 2, 0)): (i = 0 or v[i] <=
// x) and (i = lmax or v[i + 1] > x), tried at c, c + 1 and c - 1 from
// four loads v[c - 1 .. c + 2] (ops.ega_jvp.hinted_halving); -1 where
// none passes.  ``at(k)`` loads entry k.
template <typename T, class At>
__device__ __forceinline__ int hint_check(At at, int c, int lmax, T x,
                                          T& e_lo, T& e_hi) {
  const T v0 = at(c - 1), v1 = at(c), v2 = at(c + 1), v3 = at(c + 2);
  if ((c == 0 || v1 <= x) && (c == lmax || v2 > x)) {
    e_lo = v1;
    e_hi = v2;
    return c;
  }
  if (c + 1 <= lmax && v2 <= x && (c + 1 == lmax || v3 > x)) {
    e_lo = v2;
    e_hi = v3;
    return c + 1;
  }
  if (c >= 1 && (c == 1 || v0 <= x) && v1 > x) {
    e_lo = v0;
    e_hi = v1;
    return c - 1;
  }
  return -1;
}

// Corner ipt of gas g on the fast tables (ops.ega._ega_fast): the
// emissivity after the segment and its slopes in the target emissivity
// and in the segment's u; ``ok`` the corner's table validity.  ``h``
// carries the last segment's forward index of this (gas, corner) lane:
// with ``hint`` (monotone rows) the inversion first checks h - 1, h and h
// + 1 against the halving's defining property, and halves only where none
// passes.
template <typename T>
__device__ __forceinline__ void corner_fast(const FastTab& tb,
                                            const Consts& cs, int g, int d,
                                            int ipt, T target, T u_seg,
                                            bool hint, int& h, T& eps_c,
                                            T& c_T, T& c_u, bool& ok) {
  const int P = tb.ax.P, NT = tb.ax.NT, K = tb.K, D = tb.ax.D;
  const int PT = P * NT;
#ifdef JT_SPLIT_CELL0
  ipt = 0;  // tools/rt_split.py: every corner reads its gas's cell 0
#endif
  const int cell = ipt < 0 ? 0 : (ipt > PT - 1 ? PT - 1 : ipt);
  const size_t gc = ((size_t)g * PT + cell) * D + d;
  const T l2u0 = (T)__ldg(tb.l2u0 + gc);
  const int nk = __ldg(tb.nu + gc);
  ok = __ldg(tb.ok + gc) != 0;
  // the eps row as ops.ega._ega_fast reads it: the flat (cell, k) index
  // ipt K + i clipped into the gas's [0, P T K), channels innermost (a
  // warp's channels at one k share sectors)
  const long long base = (long long)ipt * K, top = (long long)PT * K - 1;
  const float* __restrict__ row = tb.eps + (size_t)g * PT * K * D + d;
  auto gather = [&](int i) -> T {
    long long f = base + i;
    f = f < 0 ? 0 : (f > top ? top : f);
    return (T)__ldg(row + (size_t)f * D);
  };
  // (log2(u) - l2u0) / LOG2_RATIO_U: a product with the reciprocal
  const T l2r = T(cs.log2_ratio_u), inv_l2r = T(1) / l2r;
  const T ratio = T(cs.ratio_u);
  const int lmax = nk - 2 < 0 ? 0 : nk - 2;
  // invert: u at the target emissivity
  int lo = -1;
  T e_lo = T(0), e_hi = T(0);
  if (hint) {
    const int c = h < 0 ? 0 : (h > lmax ? lmax : h);
#ifdef JT_SPLIT_INDEX
    lo = c;  // tools/rt_split.py: the hint, unchecked
    e_lo = gather(c);
    e_hi = gather(c + 1);
#else
    lo = hint_check<T>(gather, c, lmax, target, e_lo, e_hi);
#endif
  }
  if (lo < 0) {  // the fixed count of halvings
    int l = 0, hi = nk - 1 < 1 ? 1 : nk - 1;
    int steps = 1;
    while ((1 << steps) < (K < 2 ? 2 : K)) ++steps;
    for (int s = 0; s < steps; ++s) {
      const bool active = hi > l + 1;
      const int mid = (hi + l) >> 1;
      const bool pred = gather(mid) > target;
      if (active && pred) hi = mid;
      if (active && !pred) l = mid;
    }
    lo = l;
    e_lo = gather(lo);
    e_hi = gather(lo + 1);
  }
  const T u0 = m_exp2(l2u0 + (T)lo * l2r);
  const T u_c = lip(e_lo, u0, e_hi, u0 * ratio, target);
  // forward: eps at u_c + u_seg, the index never below the inversion's
  const T u_new = u_c + u_seg;
  const T uc = u_new < T(1e-300) ? T(1e-300) : u_new;  // torch.clamp(min=)
  const T kf = (m_log2(uc) - l2u0) * inv_l2r;
  int ki = trunc_int(kf);
  ki = ki < 0 ? 0 : ki;
  const int kmax = nk - 2 < 0 ? 0 : nk - 2;
  ki = ki < kmax ? ki : kmax;
  ki = ki > lo ? ki : lo;
  h = ki;
  const T u_lo = m_exp2(l2u0 + (T)ki * l2r);
  const T e0 = gather(ki), e1 = gather(ki + 1);
  const T raw = lip(u_lo, e0, u_lo * ratio, e1, u_new);
  eps_c = c01(raw);
  const T s_inv = (u0 * ratio - u0) / guard(e_hi - e_lo);
  const T s_fwd = in01(raw) ? (e1 - e0) / guard(u_lo * ratio - u_lo) : T(0);
  c_T = s_fwd * s_inv;
  c_u = s_fwd;
}

// ops.ega._count_index over an exact u or eps row (U entries at a stride
// of D, the first n counted) at x, as ops.ega_jvp.exact_row_index states
// it: on a row that does not decrease within its count (``mono``, which
// the host decided with n <= U) the hint's neighbourhood, else a halving
// for #{v <= x}; otherwise a count over the n entries
template <typename T>
__device__ __forceinline__ int row_index(const float* __restrict__ row,
                                         int U, int D, int n, T x,
                                         bool mono, int hint) {
  if (n < 2) return 0;
  const int lmax = n - 2;
#ifdef JT_SPLIT_INDEX
  return hint < 0 ? 0 : (hint > lmax ? lmax : hint);  // tools/rt_split.py
#endif
  if (mono) {
    auto at = [&](int k) -> T {
      return k < 0 || k >= n ? T(0) : (T)__ldg(row + (size_t)k * D);
    };
    const int c = hint < 0 ? 0 : (hint > lmax ? lmax : hint);
    T a, b;
    const int i = hint_check<T>(at, c, lmax, x, a, b);
    if (i >= 0) return i;
    int lo = 0, hi = n;  // the first entry above x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((T)__ldg(row + (size_t)mid * D) <= x)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int idx = lo - 1 < 0 ? 0 : lo - 1;
    return idx < lmax ? idx : lmax;
  }
  const int m = U < n ? U : n;
  int below = 0;
  for (int k = 0; k < m; ++k)
    below += (T)__ldg(row + (size_t)k * D) <= x ? 1 : 0;
  const int idx = below - 1 < 0 ? 0 : below - 1;
  return idx < lmax ? idx : lmax;
}

// Corner (pressure level pc, temperature row ic; both clamped) of gas g on
// the exact tables (ops.ega._ega_exact's corner): get_u at the target by
// a search of the eps row, then get_eps at u_c + u_seg by a search of the u
// row; the slopes as ops.ega.ega_eps_exact_partials takes them.  ``h``
// carries the last segment's u-row index of this (gas, corner) lane, the
// hint of the eps-row search; the u-row search is hinted by the eps row's
// index.
template <typename T>
__device__ __forceinline__ void corner_exact(const ExactTab& tb, int g,
                                             int d, int pc, int ic,
                                             T target, T u_seg, int& h,
                                             T& eps_c, T& c_T, T& c_u,
                                             bool& ok) {
  const int P = tb.ax.P, NT = tb.ax.NT, D = tb.ax.D, U = tb.U;
  pc = pc < 0 ? 0 : (pc > P - 1 ? P - 1 : pc);
  ic = ic < 0 ? 0 : (ic > NT - 1 ? NT - 1 : ic);
#ifdef JT_SPLIT_CELL0
  pc = ic = 0;  // tools/rt_split.py: every corner reads its gas's cell 0
#endif
  const size_t pt = ((size_t)g * P + pc) * NT + ic;
  const int n = __ldg(tb.nu + pt * D + d);
  const int mono = __ldg(tb.mono + pt * D + d);
  ok = n >= 2;
  const float* __restrict__ er = tb.eps + pt * U * D + d;
  const float* __restrict__ ur = tb.u + pt * U * D + d;
  // ops.ega._last: the index clipped into the row
  auto ld = [&](const float* r, int k) -> T {
    return (T)__ldg(r + (size_t)(k < 0 ? 0 : (k > U - 1 ? U - 1 : k)) * D);
  };
  const int i = row_index<T>(er, U, D, n, target, (mono & 1) != 0, h);
  const T e0 = ld(er, i), e1 = ld(er, i + 1);
  const T v0 = ld(ur, i), v1 = ld(ur, i + 1);
  const T u_c = lip(e0, v0, e1, v1, target);
  const T u_new = u_c + u_seg;
  const int j = row_index<T>(ur, U, D, n, u_new, (mono & 2) != 0, i);
  h = j;
  const T w0 = ld(ur, j), w1 = ld(ur, j + 1);
  const T f0 = ld(er, j), f1 = ld(er, j + 1);
  const T raw = lip(w0, f0, w1, f1, u_new);
  eps_c = c01(raw);
  const T s_inv = (v1 - v0) / guard(e1 - e0);
  const T s_fwd = in01(raw) ? (f1 - f0) / guard(w1 - w0) : T(0);
  c_T = s_fwd * s_inv;
  c_u = s_fwd;
}

// An exact segment's corners in flight.  corner_exact above searches as
// it loads: a chain of five dependent trips to memory (the row count, the
// eps row around the hint, the u row at the eps index, the u row around
// it, the entries at the u index), and a gas's four corners ran one after
// another.  Yet the first trip depends only on the bracket and on the
// last segment's index h of the (gas, corner) lane.  So gas_corners
// issues the first trip of JT_RT_CORNERS corners together (exact_load:
// the cell's count and row flags and its eps row around h), then finishes
// each corner (exact_finish: the hinted eps check in the window, one trip
// for the u row around the eps index, the hinted u check in it, the lips
// and the slopes).  An index the windows miss is searched in the row
// itself, as corner_exact would (a halving; row_index_rows, out of line);
// a row that is not monotone, or shorter than 2, takes corner_exact
// whole.  Each path gives corner_exact's indices and values, so its bits.
// The record kernel's fast corners keep corner_fast: their eps rows are
// channel-innermost and a corner three trips, and windows there cost more
// registers than they saved in a thread that carries every gas
// (tools/rt_split.py, PERF.md); the fast RT kernel, a thread a gas, has
// its own statement of the same operations (ega_rt.cu, fast_load and
// fast_finish).  tools/rt_split.py builds variants with
// -DJT_RT_CORNERS=1 or 2.
#ifndef JT_RT_CORNERS
#define JT_RT_CORNERS 4
#endif

// entry o of a window, by selects (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&w)[N], int o) {
  float r = w[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = o == j ? w[j] : r;
  return r;
}

// The exact tables' first trip of a corner: the cell's count and row
// flags and its eps row at h - 1 .. h + 2 (indices clamped into the row)
struct ExactCorner {
  size_t row;  // the cell's entry 0 of channel d (entry j at row + j D)
  int n, mono, h, pc, ic;
  float ew[4];
};

__device__ __forceinline__ void exact_load(const ExactTab& tb, int g, int d,
                                           int pc, int ic, int h,
                                           ExactCorner& k) {
  const int P = tb.ax.P, NT = tb.ax.NT, D = tb.ax.D, U = tb.U;
  k.pc = pc;
  k.ic = ic;
  pc = pc < 0 ? 0 : (pc > P - 1 ? P - 1 : pc);
  ic = ic < 0 ? 0 : (ic > NT - 1 ? NT - 1 : ic);
#ifdef JT_SPLIT_CELL0
  pc = ic = 0;
#endif
  const size_t pt = ((size_t)g * P + pc) * NT + ic;
  k.n = __ldg(tb.nu + pt * D + d);
  k.mono = __ldg(tb.mono + pt * D + d);
  k.h = h;
  k.row = pt * U * D + d;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int i = h - 1 + j;
    i = i < 0 ? 0 : (i > U - 1 ? U - 1 : i);
    k.ew[j] = __ldg(tb.eps + k.row + (size_t)i * D);
  }
}

// row_index out of line: the halving where a hinted check fails
template <typename T>
__device__ __noinline__ int row_index_rows(const float* __restrict__ row,
                                           int U, int D, int n, T x,
                                           int hint) {
  return row_index<T>(row, U, D, n, x, true, hint);
}

// corner_exact on a cell whose rows are both monotone, from the eps
// window and one trip to the u row around the eps index; false (nothing
// written) on any other cell
template <typename T>
__device__ __forceinline__ bool exact_finish(const ExactTab& tb,
                                             const ExactCorner& k, T target,
                                             T u_seg, int& h, T& eps_c,
                                             T& c_T, T& c_u, bool& ok) {
  const int n = k.n, lmax = n - 2, U = tb.U, D = tb.ax.D;
  if (n < 2 || k.mono != 3) return false;
  const float* __restrict__ er = tb.eps + k.row;
  const float* __restrict__ ur = tb.u + k.row;
  // ops.ega._count_index's entries: 0 beyond the row's count
  auto at_e = [&](int i) -> T {
    return i < 0 || i >= n ? T(0) : (T)pick(k.ew, i - k.h + 1);
  };
  T a, b;
#ifdef JT_SPLIT_INDEX
  const int i = k.h < lmax ? k.h : lmax;
#else
  int i = k.h <= lmax ? hint_check<T>(at_e, k.h, lmax, target, a, b) : -1;
  if (i < 0) i = row_index_rows<T>(er, U, D, n, target, k.h);
#endif
  // the row's entries i and i + 1 (i <= n - 2 <= U - 2)
  T e0, e1;
  if (i >= k.h - 1 && i <= k.h + 1) {
    e0 = at_e(i);
    e1 = at_e(i + 1);
  } else {
    e0 = (T)__ldg(er + (size_t)i * D);
    e1 = (T)__ldg(er + (size_t)(i + 1) * D);
  }
  // the u row at i - 1 .. i + 2: the lip's entries and the u check's
  float uw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int x = i - 1 + j;
    x = x < 0 ? 0 : (x > U - 1 ? U - 1 : x);
    uw[j] = __ldg(ur + (size_t)x * D);
  }
  auto at_u = [&](int x) -> T {
    return x < 0 || x >= n ? T(0) : (T)pick(uw, x - i + 1);
  };
  const T v0 = at_u(i), v1 = at_u(i + 1);
  const T u_c = lip(e0, v0, e1, v1, target);
  const T u_new = u_c + u_seg;
#ifdef JT_SPLIT_INDEX
  const int j = i;
#else
  int j = hint_check<T>(at_u, i, lmax, u_new, a, b);
  if (j < 0) j = row_index_rows<T>(ur, U, D, n, u_new, i);
#endif
  h = j;
  T w0, w1, f0, f1;
  if (j >= i - 1 && j <= i + 1) {
    w0 = at_u(j);
    w1 = at_u(j + 1);
  } else {
    w0 = (T)__ldg(ur + (size_t)j * D);
    w1 = (T)__ldg(ur + (size_t)(j + 1) * D);
  }
  if (j >= k.h - 1 && j <= k.h + 1) {
    f0 = at_e(j);
    f1 = at_e(j + 1);
  } else {
    f0 = (T)__ldg(er + (size_t)j * D);
    f1 = (T)__ldg(er + (size_t)(j + 1) * D);
  }
  const T raw = lip(w0, f0, w1, f1, u_new);
  eps_c = c01(raw);
  const T s_inv = (v1 - v0) / guard(e1 - e0);
  const T s_fwd = in01(raw) ? (f1 - f0) / guard(w1 - w0) : T(0);
  c_T = s_fwd * s_inv;
  c_u = s_fwd;
  ok = true;
  return true;
}

// corner_exact out of line, its results by value (so that the caller's
// corner values stay in registers): the cells exact_finish declines
template <typename T>
struct CornerOut {
  T eps, c_T, c_u;
  int h;
  bool ok;
};
template <typename T>
__device__ __noinline__ CornerOut<T> corner_exact_rows(
    const ExactTab tb, int g, int d, int pc, int ic, T target, T u_seg,
    int h) {
  CornerOut<T> o;
  o.h = h;
  corner_exact(tb, g, d, pc, ic, target, u_seg, o.h, o.eps, o.c_T, o.c_u,
               o.ok);
  return o;
}

// The four corners of gas g at bracket b, corner c in cw[3 c .. 3 c + 2]
// (eps, c_T, c_u), hints[c hs] each corner's; whether all four have a
// table
template <typename T>
__device__ __forceinline__ bool gas_corners(const FastTab& tb,
                                            const Consts& cs, int g, int d,
                                            const Bracket& b, T target,
                                            T u_seg, bool hint, int* hints,
                                            int hs, T* cw) {
  bool ok_all = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int ipt = c < 2 ? b.ipr * tb.ax.NT + b.it0 + c
                          : (b.ipr + 1) * tb.ax.NT + b.it1 + (c - 2);
    bool ok;
    corner_fast(tb, cs, g, d, ipt, target, u_seg, hint, hints[c * hs],
                cw[c * 3], cw[c * 3 + 1], cw[c * 3 + 2], ok);
    ok_all = ok_all && ok;
  }
  return ok_all;
}
// ... the exact corners with the first trips of JT_RT_CORNERS corners
// issued before any of them is finished
template <typename T>
__device__ __forceinline__ bool gas_corners(const ExactTab& tb,
                                            const Consts& cs, int g, int d,
                                            const Bracket& b, T target,
                                            T u_seg, bool hint, int* hints,
                                            int hs, T* cw) {
  (void)cs;
  (void)hint;
  constexpr int NC = JT_RT_CORNERS;
  bool ok_all = true;
#pragma unroll
  for (int c0 = 0; c0 < 4; c0 += NC) {
    ExactCorner k[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int cc = c0 + c;
      exact_load(tb, g, d, b.ipr + (cc >> 1),
                 (cc < 2 ? b.it0 : b.it1) + (cc & 1), hints[cc * hs], k[c]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int cc = c0 + c;
      bool ok;
      int& h = hints[cc * hs];
      T* o = cw + cc * 3;
      if (!exact_finish<T>(tb, k[c], target, u_seg, h, o[0], o[1], o[2],
                           ok)) {
        const CornerOut<T> r = corner_exact_rows<T>(
            tb, g, d, k[c].pc, k[c].ic, target, u_seg, h);
        h = r.h;
        o[0] = r.eps;
        o[1] = r.c_T;
        o[2] = r.c_u;
        ok = r.ok;
      }
      ok_all = ok_all && ok;
    }
  }
  return ok_all;
}

// The type of the bilinear (t, p) step: the working type on the fast
// tables (ops.ega._ega_fast casts the axes), float64 on the exact tables
// (ops.ega._ega_exact reads the float64 axes, and torch promotes)
template <class TB, typename T>
struct Bil {
  using type = T;
};
template <typename T>
struct Bil<ExactTab, T> {
  using type = double;
};
#ifdef JT_SPLIT_BIL32
template <>
struct Bil<ExactTab, float> {  // tools/rt_split.py: the step in float32
  using type = float;
};
#endif

// A gas's factor and its partials: (factor, d/d tau_path, d/dt, d/dp,
// d/du) from its bracket and four corners (eps, c_T, c_u in cw[c 3 +
// 0..2]), the bilinear step in B
template <typename T, typename B>
__device__ __forceinline__ void gas_factor(const Consts& cs, const Bracket& b,
                                           const T* cw, bool ok_all, T p, T t,
                                           T tp, T* out) {
  const B t00 = (B)b.t00, t01 = (B)b.t01, t10 = (B)b.t10, t11 = (B)b.t11;
  const B p0 = (B)b.p0, p1 = (B)b.p1, pb = (B)p, tb = (B)t;
  // t within each pressure row, then p, with the slopes behind each clamp
  B r[2][4];  // per row: value, d/d target, d/du, d/dt
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const B ta = row ? t10 : t00, tb_ = row ? t11 : t01;
    const T* c0 = cw + row * 6;
    const T* c1 = c0 + 3;
    const B raw = lip(ta, c0[0], tb_, c1[0], tb);
    const B dd = guard(tb_ - ta);
    const B w = (tb - ta) / dd;
    const bool m = in01(raw);
    r[row][0] = c01(raw);
    r[row][1] = m ? (B(1) - w) * B(c0[1]) + w * B(c1[1]) : B(0);
    r[row][2] = m ? (B(1) - w) * B(c0[2]) + w * B(c1[2]) : B(0);
    r[row][3] = m ? B(c1[0] - c0[0]) / dd : B(0);
  }
  const B raw = lip(p0, r[0][0], p1, r[1][0], pb);
  const B eps_t = c01(raw);
  const B dd = guard(p1 - p0);
  const B w = (pb - p0) / dd;
  const bool m = in01(raw);
  const B e_T = m ? (B(1) - w) * r[0][1] + w * r[1][1] : B(0);
  const B e_u = m ? (B(1) - w) * r[0][2] + w * r[1][2] : B(0);
  const B e_t = m ? (B(1) - w) * r[0][3] + w * r[1][3] : B(0);
  const B e_p = m ? (r[1][0] - r[0][0]) / dd : B(0);
  // _factor's guards (jr_common.h:239-246), the comparison in T
  const bool opaque = tp < T(cs.tau_opaque);
  const bool no_table = b.no_table || !ok_all;
  const B tau_safe = opaque ? B(1) : B(tp);
  B f = (B(1) - eps_t) / tau_safe;
  f = no_table ? B(1) : f;
  f = opaque ? B(0) : f;
  const bool keep = !opaque && !no_table;
  const B tpk = keep ? B(tp) : B(1);
  const B f_raw = (B(1) - eps_t) / tpk;
  out[0] = T(f);
  out[1] = keep ? T((e_T - f_raw) / tpk) : T(0);
  out[2] = keep ? T(-e_t / tpk) : T(0);
  out[3] = keep ? T(-e_p / tpk) : T(0);
  out[4] = keep ? T(-e_u / tpk) : T(0);
}

// The continua of channel d (ops.continua.beta_ds) and their partials in
// (window_k, ds, p, t, q_h2o, u_co2, u_h2o); cc rows in ContinuaCoeffs'
// field order, masks as 0 / 1.  The extinction repeats beta_ds's
// operations as PyTorch's CUDA operators do them (see the top of this
// file): jurassic_torch/tools/ulp_probe.py found that the kernels' former
// real divisions by P0, 36, 296 and NA 1000 P0, 273 / t, the constant 0.21
// for 1 - 0.79 and another product order in the N2 / O2 term changed the
// extinction's last bit, and with it rad's, on a few lanes.
template <typename T>
__device__ __forceinline__ T continua(const T* __restrict__ cc, int D, int d,
                                      int flags, const Consts& cs, T kw, T ds,
                                      T p, T t, T q, T u_co2, T u_h2o,
                                      T (&b)[7]) {
  auto C = [&](int row) { return __ldg(cc + (size_t)row * D + d); };
  const T P0 = T(cs.p0), inv_p0 = T(1) / P0;  // p / P0
  T total = kw * ds;
  b[0] = ds;
  b[1] = kw;
  b[2] = b[3] = b[4] = b[5] = b[6] = T(0);
  if (flags & 1) {  // CO2 (continua_co2)
    const T dt230 = t - T(230.0), dt260 = t - T(260.0), dt296 = t - T(296.0);
    const T c1 = T(5.050505e-4), c2 = T(9.259259e-4), c3 = T(4.208754e-4);
    const T ctw = dt260 * c1 * dt296 * C(3) - dt230 * c2 * dt296 * C(2) +
                  dt230 * c3 * dt260 * C(1);
    const T dctw = c1 * C(3) * (dt296 + dt260) - c2 * C(2) * (dt296 + dt230) +
                   c3 * C(1) * (dt260 + dt230);
    const T k0 = T(cs.k0), inv_k0 = T(1) / k0;
    total = total + u_co2 * p * ctw * inv_k0;  // u_co2 p ctw / (NA 1e3 P0)
    b[5] = b[5] + p * ctw * inv_k0;
    b[2] = b[2] + u_co2 * ctw * inv_k0;
    b[3] = b[3] + u_co2 * p * dctw * inv_k0;
  }
  if ((flags & 2) && C(4) != T(0)) {  // H2O (continua_h2o)
    const T cw296 = C(5), cw260 = C(6), ctwfrn = C(7), sfac = C(8), nu = C(9);
    const T base = cw296 > T(0) ? cw260 / (cw296 > T(0) ? cw296 : T(1)) : T(1);
    // (296 - t) / (296 - 260)
    const T pw = m_pow(base, (T(296.0) - t) * (T(1) / T(36.0)));
    const T ctwslf = sfac * cw296 * pw;
    const T dslf = sfac * cw296 * (base == T(0) ? T(0) : pw * m_log(base)) *
                   T(-1.0 / 36.0);
    const T th = m_tanh(T(1) / t * T(0.7193876) * nu);  // 0.7193876 / t nu
    const T a1 = nu * u_h2o * th;
    const T a1_t = nu * u_h2o * (T(1) - th * th) *
                   (T(1) / (t * t) * T(-0.7193876) * nu);
    const T a2 = T(1) / t * T(296.0);  // 296 / t
    const T a2_t = T(1) / (t * t) * T(-296.0);
    const T mixv = q * ctwslf + (T(1) - q) * ctwfrn;
    const T a3 = p * inv_p0 * mixv * T(1e-20);
    total = total + a1 * a2 * a3;
    b[6] = b[6] + nu * th * a2 * a3;
    b[2] = b[2] + a1 * a2 * (mixv * T(1e-20) * inv_p0);
    b[4] = b[4] + a1 * a2 * (p * inv_p0 * (ctwslf - ctwfrn) * T(1e-20));
    b[3] = b[3] + (a1_t * a2 * a3 + a1 * a2_t * a3 +
                   a1 * a2 * (p * inv_p0 * q * dslf * T(1e-20)));
  }
#pragma unroll
  for (int gas = 0; gas < 2; ++gas) {  // N2, O2 (continua_n2/o2) times ds
    const int on = gas ? (flags & 8) : (flags & 4);
    const int r0 = gas ? 13 : 10;
    if (!on || C(r0) == T(0)) continue;
    const T qgas = gas ? T(0.21) : T(0.79);
    // q_n2 + (1 - q_n2) (1.294 - 0.4545 t / 296.0)
    const T mix = gas ? T(1) : T(0.79) + T(1.0 - 0.79) *
                                             (T(1.294) - T(0.4545) * t *
                                                             (T(1) / T(296.0)));
    const T mix_t = gas ? T(0) : T(-(1.0 - 0.79) * 0.4545 / 296.0);
    // (p / P0) ** 2 and (273 / t) ** 2
    const T pr = p * inv_p0, tr = T(1) / t * T(273.0);
    const T e = m_exp(C(r0 + 2) * (T(1.0 / 296.0) - T(1) / t));
    // 0.1 pr ** 2 tr ** 2 exp(.) qgas b mix
    const T val = T(0.1) * (pr * pr) * (tr * tr) * e * qgas * C(r0 + 1) * mix;
    const T cb = T(gas ? 0.1 * 0.21 : 0.1 * 0.79) * C(r0 + 1);
    const T v_ds = cb * (pr * pr) * (tr * tr) * e * mix;
    const T v_p = cb * T(2) * pr * inv_p0 * (tr * tr) * e * mix;
    const T v_t = cb * (pr * pr) *
                  (T(2) * tr * (T(1) / (t * t) * T(-273.0)) * e * mix +
                   (tr * tr) * e * C(r0 + 2) / (t * t) * mix +
                   (tr * tr) * e * mix_t);
    total = total + val * ds;
    b[1] = b[1] + v_ds;
    b[2] = b[2] + v_p * ds;
    b[3] = b[3] + v_t * ds;
  }
  return total;
}

// src_planck at t and its slope: the 0.25 K source table row (int)(4 t)
// - 400, clamped
template <typename T>
__device__ __forceinline__ T source(const T* __restrict__ sr,
                                    const T* __restrict__ st, int n_src,
                                    int D, int d, T t, T& slope) {
  int it = trunc_int(T(4.0) * t) - 400;
  it = it < 0 ? 0 : (it > n_src - 2 ? n_src - 2 : it);
  const T s0 = __ldg(sr + (size_t)it * D + d);
  const T s1 = __ldg(sr + (size_t)(it + 1) * D + d);
  const T t0 = __ldg(st + it), t1 = __ldg(st + it + 1);
  slope = (s1 - s0) / (t1 - t0);
  return s0 + (t - t0) * (s1 - s0) / (t1 - t0);
}

// The surface emission and the brightness conversion of one (ray,
// channel) (forward._surface_and_bbt): rad_out, and with ``coef`` the
// output's slope in rad and ``ss`` / ``sl_s`` the surface source and its
// slope in tsurf
template <typename T>
__device__ __forceinline__ T epilogue(const T* __restrict__ sr,
                                      const T* __restrict__ st, int n_src,
                                      int D, int d, T rad, T tau, T ts,
                                      const T* __restrict__ nu_ch, int bbt,
                                      const Consts& cs, T& coef, T& ss,
                                      T& sl_s) {
  const bool hit = ts > T(0);
  sl_s = ss = T(0);
  coef = T(1);
  if (hit) ss = source(sr, st, n_src, D, d, ts, sl_s);
  T r_out = hit ? rad + ss * tau : rad;
  if (bbt) {  // C2 nu / log1p(C1 nu ** 3 / rad)
    const T nu = nu_ch[d];
    const T a = T(cs.c1) * (nu * nu * nu) / r_out;
    const T lg = m_log1p(a);
    coef = T(cs.c2) * nu * a / (r_out * (T(1) + a) * lg * lg);
    r_out = T(cs.c2) * nu / lg;
  }
  return r_out;
}

// The launch of the exact RT kernel (ega_rt.cu) and of the record kernel
// (ega_jvp_fast.cu): a block takes a group of NR adjacent rays x all
// channels, a thread a (ray, channel) lane; NR so that every
// multiprocessor gets a group; CH segments bracketed ahead into shared
// memory.  The fast RT kernel, a thread a (ray, channel, gas), has its own
// (ega_rt.cu, rtf_shape).
constexpr int RT_THREADS = 256;  // most (ray, channel) lanes of a block
constexpr int NR_MAX = 8;        // most rays of a group
constexpr int CH_MAX = 64;       // segments bracketed ahead per chunk
constexpr int BR_BYTES = 16384;  // shared memory of a chunk's brackets
constexpr int RT_SMEM_MAX = 200 * 1024;

// The resident blocks an SM that a kernel's launch bounds ask (REC: the
// record kernel), which caps its registers: two on the exact tables (128
// registers; the corners' windows ask more), three for the record kernel
// on the fast ones (80); the fast RT kernel's own bound is RTF_BLOCKS
// (ega_rt.cu).  tools/rt_split.py builds variants with -DJT_RT_BLOCKS
// (both RT kernels) / -DJT_REC_BLOCKS.
#ifndef JT_RT_BLOCKS
#define JT_RT_BLOCKS 0
#endif
#ifndef JT_REC_BLOCKS
#define JT_REC_BLOCKS 0
#endif
template <class TB>
struct IsExact {
  static constexpr bool value = false;
};
template <>
struct IsExact<ExactTab> {
  static constexpr bool value = true;
};
template <class TB, bool REC>
struct MinBlocks {
  static constexpr int split = REC ? JT_REC_BLOCKS : JT_RT_BLOCKS;
  static constexpr int value =
      split > 0 ? split : (IsExact<TB>::value ? 2 : 3);
};

// A launch's shape: NR rays a group and a block, bd threads a block, CH
// segments bracketed ahead, its shared memory, the multiprocessors and
// the groups (the blocks)
struct RtShape {
  int NR, bd, CH, n_sm, groups;
  size_t smem;
};

// The shape of a launch of ``kernel`` at R rays, D channels and G gases,
// ``smem(bd, NR, CH)`` its shared memory; sets the kernel's dynamic
// shared memory
template <class K, class Smem>
int rt_shape(K kernel, Smem smem, int R, int D, int G, RtShape& sh) {
  int dev = 0;
  sh.n_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sh.n_sm, cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const int n_sm = sh.n_sm > 0 ? sh.n_sm : 1;
  int NR = RT_THREADS / D;
  NR = NR < R / n_sm ? NR : R / n_sm;
  NR = NR < 1 ? 1 : (NR > NR_MAX ? NR_MAX : NR);
  int bd = ((NR * D + 31) / 32) * 32;
  bd = bd < RT_THREADS ? bd : RT_THREADS;
  int CH = BR_BYTES / (int)(sizeof(Bracket) * NR * G);
  CH = CH < 1 ? 1 : (CH > CH_MAX ? CH_MAX : CH);
  while (bd > 32 && smem(bd, NR, CH) > RT_SMEM_MAX) bd -= 32;
  sh.NR = NR;
  sh.bd = bd;
  sh.CH = CH;
  sh.groups = (R + NR - 1) / NR;
  sh.smem = smem(bd, NR, CH);
  if (sh.smem > RT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
}

// The shape into out (int[RT_SHAPE_LEN]): the resident blocks a
// multiprocessor (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the
// threads a block, the rays a group, the multiprocessors, the groups, the
// threads a (ray, channel) lane (1: a thread carries all its gases), the
// lanes a pass (a thread each) and the passes over the group's lanes
constexpr int RT_SHAPE_LEN = 8;
template <class K, class Smem>
int rt_shape_out(K kernel, Smem smem, int R, int D, int G, int* out) {
  RtShape sh;
  if (const int e = rt_shape(kernel, smem, R, D, G, sh)) return e;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, sh.bd, sh.smem);
  if (e != cudaSuccess) return (int)e;
  const int v[RT_SHAPE_LEN] = {
      per_sm, sh.bd, sh.NR, sh.n_sm, sh.groups, 1, sh.bd,
      (sh.NR * D + sh.bd - 1) / sh.bd};
  for (int i = 0; i < RT_SHAPE_LEN; ++i) out[i] = v[i];
  return 0;
}

// The record kernel's rt_shape_out by instantiation (ega_jvp_fast.cu)
int rec_shape_out(int R, int D, int G, bool uni, bool exact, bool dbl,
                  int* out);

// The table pointers and sizes of either kind from the C entry points'
// arguments: fast (eps, log2_u0, p, t, nu, nt, np, valid; K) or exact (u,
// eps, p, t, nu, nt, np, row_monotone; U)
inline Axes make_axes(const void* p_ax, const void* t_ax, const void* nt,
                      const void* np_, int P, int NT, int D) {
  return Axes{(const double*)p_ax, (const double*)t_ax, (const int*)nt,
              (const int*)np_, P, NT, D};
}
inline FastTab make_fast(const void* const* t, int P, int NT, int D, int K) {
  return FastTab{make_axes(t[2], t[3], t[5], t[6], P, NT, D),
                 (const float*)t[0], (const double*)t[1], (const int*)t[4],
                 (const uint8_t*)t[7], K};
}
inline ExactTab make_exact(const void* const* t, int P, int NT, int D,
                           int U) {
  return ExactTab{make_axes(t[2], t[3], t[5], t[6], P, NT, D),
                  (const float*)t[0], (const float*)t[1], (const int*)t[4],
                  (const uint8_t*)t[7], U};
}

}  // namespace jt_rt
