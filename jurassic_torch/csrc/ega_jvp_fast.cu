// Tangent kernel of the eager fast-table RT pass: the RT half of the JAX
// package's compiled forward-mode Jacobian (``jax.jit(jax.jacfwd(fwd))``,
// jurassic_tpu/retrieval.py:281, through the ``lax.scan`` of
// ``rt_integrate``, jurassic_tpu/forward.py:99-213, on the fast tables of
// ``ega_eps_fast``, jurassic_tpu/ops/ega.py:171).  For every (ray, channel)
// it runs the recursion of ``forward.rt_integrate(..., use_fast=True)``
// over the valid segments, with the surface and brightness epilogue, and
// carries the tangents of (rad, tau, tau_path[G]) in n directions of the
// state; the LOS tangents [R, S, 3 + 2 G + W, n] (p, t, q[G], k[W], u[G],
// ds) and tsurf's [R, n] are the tracer tangent kernel's.  Its plain
// version is ``forward.rt_integrate_jvp_ref``, in whose order it computes.
//
// Design: two kernels, one launch of the entry point.
//   * ega_rec_kernel, a thread per (ray, channel), as the fused kernels
//     lay the forward pass out: the primal recursion, and per valid
//     segment its local partials (``ops.ega.ega_eps_fast_partials``: the
//     corner searches, their slopes behind the clamps, the bilinear (t, p)
//     weights, the factor's guards; ``ops.continua.beta_ds_partials``; the
//     Planck slope), written as one record of REC_GAS G + REC_BDS +
//     REC_TAIL values, channels innermost.  Many (ray, channel) chains in
//     flight hide the searches' dependent table loads; no tangent is held
//     here.
//   * ega_tan_kernel, a block per ray and up to CPB_MAX channels, a warp
//     per channel, each lane the tangents 32 c + lane (c < NCH, a template
//     parameter) of a group of 32 NCH tangents (blockIdx.z): per segment
//     the block stages the segment's LOS tangents [F, 32 NCH] and its
//     channels' records in shared memory (the next segment's already in
//     registers), and every lane applies the linear tangent update, a few
//     operations per gas, rad and tau in registers, tau_path[G] in the
//     warp's shared memory (G is a runtime size).
// Both repeat the plain version's operations in its order (-fmad false),
// so the searches' decisions, and with them the slopes, are its; the
// transcendentals are libdevice's, as in PyTorch's CUDA kernels.  (A
// first form, a warp per (ray, channel) computing primal and tangents
// together, held 16 chains a multiprocessor and took 327.6 ms at the
// flagship in float64 on the H100; this one 105.8 ms: PERF.md.)
//
// What bounds it: per (valid segment, channel) about 510 operations of
// primal and partials, per (segment, channel, tangent) about 86 with FMA
// off (4 gases), 3.4e11 at the flagship (9.9 ms in float64 at 34
// TFLOP/s); the bytes: the LOS tangents, read once per block (5.4 GB per
// flagship package in float64), the records, written and read once (8.1
// GB), and drad.  What it takes: the record kernel the latency of each
// chain's dependent table loads (more blocks a multiprocessor did not
// shorten it), the tangent kernel its staged reads (PERF.md).
//
// The kernels allocate nothing and launch on the caller's stream; the
// caller gives the records' buffer and each ray's first record.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPB_MAX = 16;     // channels (warps) of a tangent block
constexpr int LIN_THREADS = 128;  // (ray, channel) lanes of a record block

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
// ops.ega._lip: a guarded linear interpolation that extrapolates
template <typename T>
__device__ __forceinline__ T lip(T x0, T y0, T x1, T y1, T x) {
  return y0 + (x - x0) * (y1 - y0) / guard(x1 - x0);
}

// ops.ega._count_index over a float64 axis row v[0..len) within
// count, at x: #{v <= x} - 1 clipped to [0, max(count - 2, 0)]
__device__ __forceinline__ int count_index(const double* __restrict__ v,
                                           int len, int count,
                                           double x) {
  int below = 0;
  for (int i = 0; i < len; ++i)
    below += (i < count && __ldg(v + i) <= x) ? 1 : 0;
  int idx = below - 1 < 0 ? 0 : below - 1;
  const int hi = count - 2 < 0 ? 0 : count - 2;
  return idx < hi ? idx : hi;
}

// The fast tables (ops.ega.FastDeviceTables, integers as int32, valid as
// bytes)
template <typename T>
struct Tables {
  const float* __restrict__ eps;     // [G, P, T, K, D]
  const double* __restrict__ l2u0;   // [G, P, T, D]
  const double* __restrict__ p_ax;   // [G, D, P]
  const double* __restrict__ t_ax;   // [G, P, D, T]
  const int* __restrict__ nu;        // [G, P, T, D]
  const int* __restrict__ nt;        // [G, P, D]
  const int* __restrict__ np_;       // [G, D]
  const uint8_t* __restrict__ ok;    // [G, P, T, D]
  int P, NT, K, D;
};

// Constants from the host (jurassic_torch/constants.py, tables.py)
struct Consts {
  double k0, p0, c1, c2, tau_opaque, tau_cutoff, log2_ratio_u, ratio_u;
};

// One gas's bracket of channel d at (p, t): pressure level, temperature
// rows of the two levels
struct Bracket {
  int ipr, it0, it1;
  bool no_table;
};

template <typename T>
__device__ __forceinline__ Bracket bracket(const Tables<T>& tb, int g, int d,
                                           T p, T t) {
  const int P = tb.P, NT = tb.NT, D = tb.D;
  const int npg = tb.np_[g * D + d];
  Bracket b;
  b.ipr = count_index(tb.p_ax + ((size_t)g * D + d) * P, P, npg, (double)p);
  const int nt_lo = tb.nt[((size_t)g * P + b.ipr) * D + d];
  const int ipr1 = b.ipr + 1 < P ? b.ipr + 1 : P - 1;
  const int nt_hi = tb.nt[((size_t)g * P + ipr1) * D + d];
  b.it0 = count_index(tb.t_ax + (((size_t)g * P + b.ipr) * D + d) * NT, NT,
                      nt_lo, (double)t);
  b.it1 = count_index(tb.t_ax + (((size_t)g * P + ipr1) * D + d) * NT, NT,
                      nt_hi, (double)t);
  b.no_table = npg < 2 || nt_lo < 2 || nt_hi < 2;
  return b;
}

// Corner c of gas g (ops.ega._ega_fast): the emissivity after the segment
// and its slopes in the target emissivity and in the segment's u; ``ok``
// the corner's table validity
template <typename T>
__device__ __forceinline__ void corner(const Tables<T>& tb, const Consts& cs,
                                       int g, int d, const Bracket& b, int c,
                                       T target, T u_seg, T& eps_c, T& c_T,
                                       T& c_u, bool& ok) {
  const int P = tb.P, NT = tb.NT, K = tb.K, D = tb.D;
  const int ipt = c < 2 ? b.ipr * NT + b.it0 + c
                        : (b.ipr + 1) * NT + b.it1 + (c - 2);
  const int PT = P * NT;
  const int cell = ipt < 0 ? 0 : (ipt > PT - 1 ? PT - 1 : ipt);
  const size_t gc = ((size_t)g * PT + cell) * D + d;
  const T l2u0 = (T)tb.l2u0[gc];
  const int nk = tb.nu[gc];
  ok = tb.ok[gc] != 0;
  const long long base = (long long)ipt * K, top = (long long)PT * K - 1;
  const float* __restrict__ row = tb.eps + (size_t)g * PT * K * D + d;
  auto gather = [&](int i) -> T {
    long long f = base + i;
    f = f < 0 ? 0 : (f > top ? top : f);
    return (T)__ldg(row + (size_t)f * D);
  };
  // a division by a Python float is a product with its reciprocal on
  // PyTorch's CUDA tensors (div_true_kernel_cuda)
  const T l2r = T(cs.log2_ratio_u), inv_l2r = T(1) / l2r;
  const T ratio = T(cs.ratio_u);
  // invert: u at the target emissivity (a fixed count of halvings)
  int lo = 0, hi = nk - 1 < 1 ? 1 : nk - 1;
  int steps = 1;
  while ((1 << steps) < (K < 2 ? 2 : K)) ++steps;
  for (int s = 0; s < steps; ++s) {
    const bool active = hi > lo + 1;
    const int mid = (hi + lo) >> 1;
    const bool pred = gather(mid) > target;
    if (active && pred) hi = mid;
    if (active && !pred) lo = mid;
  }
  const T u0 = m_exp2(l2u0 + (T)lo * l2r);
  const T e_lo = gather(lo), e_hi = gather(lo + 1);
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
  const T u_lo = m_exp2(l2u0 + (T)ki * l2r);
  const T e0 = gather(ki), e1 = gather(ki + 1);
  const T raw = lip(u_lo, e0, u_lo * ratio, e1, u_new);
  eps_c = c01(raw);
  const T s_inv = (u0 * ratio - u0) / guard(e_hi - e_lo);
  const T s_fwd = in01(raw) ? (e1 - e0) / guard(u_lo * ratio - u_lo) : T(0);
  c_T = s_fwd * s_inv;
  c_u = s_fwd;
}

// A gas's factor and its partials: (factor, d/d tau_path, d/dt, d/dp,
// d/du) from its four corners (eps, c_T, c_u in cw[c * 3 + 0..2])
template <typename T>
__device__ __forceinline__ void gas_factor(const Tables<T>& tb,
                                           const Consts& cs, int g, int d,
                                           const Bracket& b, const T* cw,
                                           bool ok_all, T p, T t, T tp,
                                           T* out) {
  const int P = tb.P, NT = tb.NT, D = tb.D;
  const int ipr1 = b.ipr + 1 < P ? b.ipr + 1 : P - 1;
  const double* tlo = tb.t_ax + (((size_t)g * P + b.ipr) * D + d) * NT;
  const double* thi = tb.t_ax + (((size_t)g * P + ipr1) * D + d) * NT;
  auto at = [&](const double* v, int i) -> T {
    return (T)v[i < 0 ? 0 : (i > NT - 1 ? NT - 1 : i)];
  };
  const T t00 = at(tlo, b.it0), t01 = at(tlo, b.it0 + 1);
  const T t10 = at(thi, b.it1), t11 = at(thi, b.it1 + 1);
  const double* pax = tb.p_ax + ((size_t)g * D + d) * P;
  const T p0 = (T)pax[b.ipr], p1 = (T)pax[ipr1];
  // t within each pressure row, then p (ops.ega._ega_fast), with the
  // slopes behind each clamp
  T r[2][4];  // per row: value, d/d target, d/du, d/dt
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const T ta = row ? t10 : t00, tb_ = row ? t11 : t01;
    const T* c0 = cw + row * 6;
    const T* c1 = c0 + 3;
    const T raw = lip(ta, c0[0], tb_, c1[0], t);
    const T dd = guard(tb_ - ta);
    const T w = (t - ta) / dd;
    const bool m = in01(raw);
    r[row][0] = c01(raw);
    r[row][1] = m ? (T(1) - w) * c0[1] + w * c1[1] : T(0);
    r[row][2] = m ? (T(1) - w) * c0[2] + w * c1[2] : T(0);
    r[row][3] = m ? (c1[0] - c0[0]) / dd : T(0);
  }
  const T raw = lip(p0, r[0][0], p1, r[1][0], p);
  const T eps_t = c01(raw);
  const T dd = guard(p1 - p0);
  const T w = (p - p0) / dd;
  const bool m = in01(raw);
  const T e_T = m ? (T(1) - w) * r[0][1] + w * r[1][1] : T(0);
  const T e_u = m ? (T(1) - w) * r[0][2] + w * r[1][2] : T(0);
  const T e_t = m ? (T(1) - w) * r[0][3] + w * r[1][3] : T(0);
  const T e_p = m ? (r[1][0] - r[0][0]) / dd : T(0);
  // _factor's guards (jr_common.h:239-246)
  const bool opaque = tp < T(cs.tau_opaque);
  const bool no_table = b.no_table || !ok_all;
  const T tau_safe = opaque ? T(1) : tp;
  T f = (T(1) - eps_t) / tau_safe;
  f = no_table ? T(1) : f;
  f = opaque ? T(0) : f;
  const bool keep = !opaque && !no_table;
  const T f_raw = (T(1) - eps_t) / (keep ? tp : T(1));
  out[0] = f;
  out[1] = keep ? (e_T - f_raw) / tp : T(0);
  out[2] = keep ? -e_t / tp : T(0);
  out[3] = keep ? -e_p / tp : T(0);
  out[4] = keep ? -e_u / tp : T(0);
}

// The continua of channel d (ops.continua.beta_ds) and their partials in
// (window_k, ds, p, t, q_h2o, u_co2, u_h2o); cc rows in ContinuaCoeffs'
// field order, masks as 0 / 1
template <typename T>
__device__ __forceinline__ T continua(const T* __restrict__ cc, int D, int d,
                                      int flags, const Consts& cs, T kw, T ds,
                                      T p, T t, T q, T u_co2, T u_h2o,
                                      T (&b)[7]) {
  auto C = [&](int row) { return cc[(size_t)row * D + d]; };
  const T P0 = T(cs.p0);
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
    const T k0 = T(cs.k0);
    total = total + u_co2 * p * ctw / k0;
    b[5] = b[5] + p * ctw / k0;
    b[2] = b[2] + u_co2 * ctw / k0;
    b[3] = b[3] + u_co2 * p * dctw / k0;
  }
  if ((flags & 2) && C(4) != T(0)) {  // H2O (continua_h2o)
    const T cw296 = C(5), cw260 = C(6), ctwfrn = C(7), sfac = C(8), nu = C(9);
    const T base = cw296 > T(0) ? cw260 / (cw296 > T(0) ? cw296 : T(1)) : T(1);
    const T pw = m_pow(base, (T(296.0) - t) / T(36.0));
    const T ctwslf = sfac * cw296 * pw;
    const T dslf = sfac * cw296 * (base == T(0) ? T(0) : pw * m_log(base)) *
                   (T(-1.0) / T(36.0));
    const T th = m_tanh(T(1) / t * T(0.7193876) * nu);
    const T a1 = nu * u_h2o * th;
    const T a1_t =
        nu * u_h2o * (T(1) - th * th) * (-T(0.7193876) / (t * t) * nu);
    const T a2 = T(1) / t * T(296.0);
    const T a2_t = -T(296.0) / (t * t);
    const T mixv = q * ctwslf + (T(1) - q) * ctwfrn;
    const T a3 = p / P0 * mixv * T(1e-20);
    total = total + a1 * a2 * a3;
    b[6] = b[6] + nu * th * a2 * a3;
    b[2] = b[2] + a1 * a2 * (mixv * T(1e-20) / P0);
    b[4] = b[4] + a1 * a2 * (p / P0 * (ctwslf - ctwfrn) * T(1e-20));
    b[3] = b[3] + (a1_t * a2 * a3 + a1 * a2_t * a3 +
                   a1 * a2 * (p / P0 * q * dslf * T(1e-20)));
  }
#pragma unroll
  for (int gas = 0; gas < 2; ++gas) {  // N2, O2 (continua_n2/o2) times ds
    const int on = gas ? (flags & 8) : (flags & 4);
    const int r0 = gas ? 13 : 10;
    if (!on || C(r0) == T(0)) continue;
    const T qgas = gas ? T(0.21) : T(0.79);
    const T mix = gas ? T(1) : T(0.79) + T(0.21) * (T(1.294) -
                                                    T(0.4545) * t / T(296.0));
    const T mix_t = gas ? T(0) : -(T(0.21) * T(0.4545) / T(296.0));
    const T pr = p / P0, tr = T(273.0) / t;
    const T e = m_exp(C(r0 + 2) * (T(1.0 / 296.0) - T(1) / t));
    const T cb = T(0.1) * qgas * C(r0 + 1);
    const T val = cb * (pr * pr) * (tr * tr) * e * mix;
    const T v_p = cb * T(2) * pr / P0 * (tr * tr) * e * mix;
    const T v_t = cb * (pr * pr) *
                  (T(2) * tr * (-T(273.0) / (t * t)) * e * mix +
                   (tr * tr) * e * C(r0 + 2) / (t * t) * mix +
                   (tr * tr) * e * mix_t);
    total = total + val * ds;
    b[1] = b[1] + val;
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
  const T s0 = sr[(size_t)it * D + d], s1 = sr[(size_t)(it + 1) * D + d];
  const T t0 = st[it], t1 = st[it + 1];
  slope = (s1 - s0) / (t1 - t0);
  return s0 + (t - t0) * (s1 - s0) / (t1 - t0);
}

// A record of a valid (segment, channel): per gas its factor, the
// factor's partials in tau_path, t, p and u, and tau_path before the
// segment; the extinction's partials (ops.continua.BDS_INPUTS); then
// exp(-bds), the source, its slope in t, tau before the segment, tau_gas,
// and 1 where the segment updates rad and tau (else 0)
constexpr int REC_GAS = 6, REC_BDS = 7, REC_TAIL = 6;
__host__ __device__ __forceinline__ int rec_len(int G) {
  return REC_GAS * G + REC_BDS + REC_TAIL;
}
// After the last segment: whether the ray hits the surface, the surface
// source's slope and value, tau, and the brightness conversion's slope
constexpr int N_EPI = 5;

template <typename T>
__global__ void __launch_bounds__(LIN_THREADS) ega_rec_kernel(
    Tables<T> tb, const T* __restrict__ cc, const int* __restrict__ window,
    const T* __restrict__ sr, const T* __restrict__ st,
    const T* __restrict__ nu_ch, const T* __restrict__ lp,
    const T* __restrict__ lt, const T* __restrict__ lds,
    const T* __restrict__ lq, const T* __restrict__ lk,
    const T* __restrict__ lu, const uint8_t* __restrict__ lvalid,
    const T* __restrict__ ltsurf, const long long* __restrict__ first,
    T* __restrict__ rec, T* __restrict__ epi, T* __restrict__ rad_out,
    T* __restrict__ tau_out, int R, int S, int G, int W, int n_src,
    int flags, int ig_co2, int ig_h2o, int bbt, Consts cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = tb.D, C = rec_len(G);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)R * D) return;
  const int r = (int)(lane / D), d = (int)(lane - (long long)r * D);
  T* tp = reinterpret_cast<T*>(smem) + threadIdx.x;  // tau_path[g] at g bd
  const int bd = blockDim.x;
  for (int g = 0; g < G; ++g) tp[g * bd] = T(1);
  const int wd = W > 0 ? window[d] : 0;
  T rad = T(0), tau = T(1);
  long long k = first[r];
  for (int s = 0; s < S; ++s) {
    const size_t rs = (size_t)r * S + s;
    if (!lvalid[rs]) continue;
    const T p = lp[rs], t = lt[rs], ds = lds[rs];
    T* o = rec + (size_t)k * C * D + d;  // field c at o[c D]
    ++k;
    T tau_gas = T(1);
    for (int g = 0; g < G; ++g) {
      const T tpg = tp[g * bd], ug = lu[rs * G + g];
      const Bracket b = bracket(tb, g, d, p, t);
      T cw[12];
      bool ok_all = true;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bool ok;
        corner(tb, cs, g, d, b, c, T(1) - tpg, ug, cw[c * 3], cw[c * 3 + 1],
               cw[c * 3 + 2], ok);
        ok_all = ok_all && ok;
      }
      T f[5];
      gas_factor(tb, cs, g, d, b, cw, ok_all, p, t, tpg, f);
#pragma unroll
      for (int i = 0; i < 5; ++i) o[(size_t)(REC_GAS * g + i) * D] = f[i];
      o[(size_t)(REC_GAS * g + 5) * D] = tpg;
      tau_gas = g == 0 ? f[0] : tau_gas * f[0];
      tp[g * bd] = tpg * f[0];
    }
    T bp[7];
    const T qh = ig_h2o >= 0 ? lq[rs * G + ig_h2o] : T(0);
    const T uh = ig_h2o >= 0 ? lu[rs * G + ig_h2o] : T(0);
    const T uc = ig_co2 >= 0 ? lu[rs * G + ig_co2] : T(0);
    const T bds = continua(cc, D, d, flags, cs, W > 0 ? lk[rs * W + wd] : T(0),
                           ds, p, t, qh, uc, uh, bp);
    T slope;
    const T srcv = source(sr, st, n_src, D, d, t, slope);
    const T ex = m_exp(-bds);
    const T eps = T(1) - tau_gas * ex;
    const bool upd = tau_gas > T(cs.tau_cutoff);
    T* ot = o + (size_t)REC_GAS * G * D;
#pragma unroll
    for (int i = 0; i < 7; ++i) ot[(size_t)i * D] = bp[i];
    ot[(size_t)7 * D] = ex;
    ot[(size_t)8 * D] = srcv;
    ot[(size_t)9 * D] = slope;
    ot[(size_t)10 * D] = tau;
    ot[(size_t)11 * D] = tau_gas;
    ot[(size_t)12 * D] = upd ? T(1) : T(0);
    if (upd) {
      rad = rad + srcv * eps * tau;
      tau = tau * (T(1) - eps);
    }
  }
  // surface emission and the brightness conversion (_surface_and_bbt)
  const T ts = ltsurf[r];
  const bool hit = ts > T(0);
  T sl = T(0), ss = T(0), coef = T(1);
  if (hit) ss = source(sr, st, n_src, D, d, ts, sl);
  T r_out = hit ? rad + ss * tau : rad;
  if (bbt) {
    const T nu = nu_ch[d];
    const T a = T(cs.c1) * (nu * nu * nu) / r_out;
    const T lg = m_log1p(a);
    coef = T(cs.c2) * nu * a / (r_out * (T(1) + a) * lg * lg);
    r_out = T(cs.c2) * nu / lg;
  }
  T* e = epi + (size_t)r * N_EPI * D + d;
  e[0] = hit ? T(1) : T(0);
  e[(size_t)D] = sl;
  e[(size_t)2 * D] = ss;
  e[(size_t)3 * D] = tau;
  e[(size_t)4 * D] = coef;
  rad_out[(size_t)r * D + d] = r_out;
  tau_out[(size_t)r * D + d] = tau;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(32 * CPB_MAX) ega_tan_kernel(
    const T* __restrict__ seg, const T* __restrict__ dts,
    const uint8_t* __restrict__ lvalid, const long long* __restrict__ first,
    const T* __restrict__ rec, const T* __restrict__ epi,
    const int* __restrict__ window, T* __restrict__ drad_out, int S, int G,
    int W, int D, int n, int ig_co2, int ig_h2o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = 3 + 2 * G + W, NP = 32 * NCH, C = rec_len(G);
  const int cpb = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x, d0 = blockIdx.y * cpb, d = d0 + warp;
  const int j0 = blockIdx.z * NP;  // the block's first tangent
  const bool live = d < D;
  const int dd = live ? d : D - 1;
  T* tg = reinterpret_cast<T*>(smem);  // [F][NP] the segment's tangents
  T* rc = tg + (size_t)F * NP;         // [C][cpb] its channels' records
  T* dtp = rc + (size_t)C * cpb + (size_t)warp * G * NCH * 32;  // [G][NCH][32]
  for (int i = lane; i < G * NCH * 32; i += 32) dtp[i] = T(0);
  T drad[NCH], dtau[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) drad[c] = dtau[c] = T(0);
  const int wd = W > 0 ? window[dd] : 0;
  const int fk = 2 + G + wd, fu = 2 + G + W, fds = 2 + 2 * G + W;
  // the next valid segment's tangents and records, a few a thread, loaded
  // ahead into registers while the block works on this one
  constexpr int AHEAD = 8;
  const int n_tg = F * NP, n_rc = C * cpb, nt = blockDim.x;
  T nxt[AHEAD];
  auto load = [&](int s, long long k) {
    const T* src = seg + ((size_t)r * S + s) * F * n;
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      const int i = threadIdx.x + a * nt;
      T v = T(0);
      if (i < n_tg) {
        const int f = i / NP, j = j0 + i - f * NP;
        if (j < n) v = src[(size_t)f * n + j];
      } else if (i < n_tg + n_rc) {
        const int c = (i - n_tg) / cpb, w = i - n_tg - c * cpb;
        if (d0 + w < D) v = rec[((size_t)k * C + c) * D + d0 + w];
      }
      nxt[a] = v;
    }
  };
  auto next_valid = [&](int s) {
    while (s < S && !lvalid[(size_t)r * S + s]) ++s;
    return s;
  };
  long long k = first[r];
  int s = next_valid(0);
  if (s < S) load(s, k);
  while (s < S) {
    __syncthreads();  // the last segment's reads are done
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      const int i = threadIdx.x + a * nt;
      if (i < n_tg + n_rc) tg[i] = nxt[a];
    }
    for (int i = threadIdx.x + AHEAD * nt; i < n_tg + n_rc; i += nt) {
      // a block too small to hold the segment in AHEAD loads a thread
      if (i < n_tg) {
        const int f = i / NP, j = j0 + i - f * NP;
        tg[i] = j < n ? seg[(((size_t)r * S + s) * F + f) * n + j] : T(0);
      } else {
        const int c = (i - n_tg) / cpb, w = i - n_tg - c * cpb;
        tg[i] = d0 + w < D ? rec[((size_t)k * C + c) * D + d0 + w] : T(0);
      }
    }
    __syncthreads();
    const int s_next = next_valid(s + 1);
    if (s_next < S) load(s_next, k + 1);
    s = s_next;
    ++k;

    const T* q = rc + warp;  // field c of this channel's record at q[c cpb]
    auto R_ = [&](int c) { return q[(size_t)c * cpb]; };
    const int tb0 = REC_GAS * G;
    const T ex = R_(tb0 + 7), srcv = R_(tb0 + 8), slope = R_(tb0 + 9);
    const T tau = R_(tb0 + 10), tau_gas = R_(tb0 + 11);
    const bool upd = R_(tb0 + 12) != T(0);
    const T eps = T(1) - tau_gas * ex;
    // per tangent: the extinction's tangent, then gas by gas the
    // factor's and the running product's (each record value read once
    // for all NCH chunks), then the emissivity, rad and tau
    T dp[NCH], dt[NCH], dbds[NCH], dtg[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int j = c * 32 + lane;
      dp[c] = tg[j];
      dt[c] = tg[NP + j];
      T v = R_(tb0) * (W > 0 ? tg[(size_t)fk * NP + j] : T(0)) +
            R_(tb0 + 1) * tg[(size_t)fds * NP + j] + R_(tb0 + 2) * dp[c] +
            R_(tb0 + 3) * dt[c];
      if (ig_h2o >= 0)
        v = v + R_(tb0 + 4) * tg[(size_t)(2 + ig_h2o) * NP + j] +
            R_(tb0 + 6) * tg[(size_t)(fu + ig_h2o) * NP + j];
      if (ig_co2 >= 0) v = v + R_(tb0 + 5) * tg[(size_t)(fu + ig_co2) * NP + j];
      dbds[c] = v;
      dtg[c] = T(0);
    }
    T prod = T(1);
    for (int g = 0; g < G; ++g) {
      const int o = REC_GAS * g;
      const T f = R_(o), f_tp = R_(o + 1), f_t = R_(o + 2), f_p = R_(o + 3);
      const T f_u = R_(o + 4), tpo = R_(o + 5);
      T* dtpg = dtp + (size_t)g * NCH * 32 + lane;
      const T* du = tg + (size_t)(fu + g) * NP + lane;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const T d0 = dtpg[c * 32];
        const T df = f_tp * d0 + f_t * dt[c] + f_p * dp[c] + f_u * du[c * 32];
        dtg[c] = g == 0 ? df : dtg[c] * f + prod * df;
        dtpg[c * 32] = d0 * f + tpo * df;
      }
      prod = g == 0 ? f : prod * f;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const T deps = tau_gas * ex * dbds[c] - dtg[c] * ex;
      if (upd) {
        drad[c] = drad[c] + (slope * dt[c] * eps + srcv * deps) * tau +
                  srcv * eps * dtau[c];
        dtau[c] = dtau[c] * (T(1) - eps) - tau * deps;
      }
    }
  }

  // surface emission and the brightness conversion (_surface_and_bbt)
  if (!live) return;
  const T* e = epi + (size_t)r * N_EPI * D + d;
  const bool hit = e[0] != T(0);
  const T sl = e[(size_t)D], ss = e[(size_t)2 * D], tau = e[(size_t)3 * D];
  const T coef = e[(size_t)4 * D];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int j = j0 + c * 32 + lane;
    if (j >= n) continue;
    T dr = drad[c];
    if (hit) dr = dr + sl * dts[(size_t)r * n + j] * tau + ss * dtau[c];
    drad_out[((size_t)r * D + d) * n + j] = dr * coef;
  }
}

template <typename T, int NCH>
int launch_tan(const T* seg, const T* dts, const uint8_t* lvalid,
               const long long* first, const T* rec, const T* epi,
               const int* window, T* drad, int R, int S, int G, int W, int D,
               int n, int ig_co2, int ig_h2o, cudaStream_t stream) {
  const int cpb = D < CPB_MAX ? D : CPB_MAX;
  const size_t smem =
      sizeof(T) * ((size_t)(3 + 2 * G + W) * 32 * NCH +
                   (size_t)rec_len(G) * cpb + (size_t)cpb * G * NCH * 32);
  auto kernel = ega_tan_kernel<T, NCH>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(R, (D + cpb - 1) / cpb, (n + 32 * NCH - 1) / (32 * NCH));
  kernel<<<grid, 32 * cpb, smem, stream>>>(seg, dts, lvalid, first, rec, epi,
                                           window, drad, S, G, W, D, n,
                                           ig_co2, ig_h2o);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* tp, const void* const* p, int R, int S, int G,
           int W, int D, int P, int NT, int K, int n_src, int n, int flags,
           int ig_co2, int ig_h2o, int bbt, const Consts& cs,
           cudaStream_t stream) {
  const Tables<T> tb{(const float*)tp[0], (const double*)tp[1],
                     (const double*)tp[2], (const double*)tp[3],
                     (const int*)tp[4],   (const int*)tp[5],
                     (const int*)tp[6],   (const uint8_t*)tp[7],
                     P, NT, K, D};
  const long long lanes = (long long)R * D;
  const size_t smem = sizeof(T) * (size_t)G * LIN_THREADS;
  ega_rec_kernel<T><<<(unsigned)((lanes + LIN_THREADS - 1) / LIN_THREADS),
                      LIN_THREADS, smem, stream>>>(
      tb, (const T*)p[0], (const int*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const uint8_t*)p[11],
      (const T*)p[12], (const long long*)p[18], (T*)p[19], (T*)p[20],
      (T*)p[15], (T*)p[16], R, S, G, W, n_src, flags, ig_co2, ig_h2o, bbt, cs);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int chunks = (n + 31) / 32;
  switch (chunks < 8 ? chunks : 8) {
#define JT_NCH(c)                                                            \
  case c:                                                                    \
    return launch_tan<T, c>((const T*)p[13], (const T*)p[14],                \
                            (const uint8_t*)p[11], (const long long*)p[18],  \
                            (const T*)p[19], (const T*)p[20], (const int*)p[1], \
                            (T*)p[17], R, S, G, W, D, n, ig_co2, ig_h2o,     \
                            stream);
    JT_NCH(1) JT_NCH(2) JT_NCH(3) JT_NCH(4) JT_NCH(5) JT_NCH(6) JT_NCH(7)
    JT_NCH(8)
#undef JT_NCH
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Pointers: the fast tables eps [G, P, T, K, D] f32, log2_u0 [G, P, T, D]
// f64, the p axis [G, D, P] f64, the t axis [G, P, D, T] f64, nu
// [G, P, T, D], nt [G, P, D], np [G, D] int32 and valid [G, P, T, D] bytes
// (tp[0..7]); then the continua rows [16, D] (ContinuaCoeffs' order), the
// window map [D] int32, the source table sr [n_src, D] and axis st
// [n_src], the channels' wavenumbers [D], the LOS p, t, ds [R, S], q, k, u
// [R, S, G|W|G], valid [R, S] bytes and tsurf [R], the LOS tangents
// [R, S, 3 + 2 G + W, n] and tsurf's [R, n]; the outputs rad, tau [R, D]
// and drad [R, D, n]; each ray's first record [R] int64 (the valid
// segments before it), the records [valid segments, rec_len(G), D] and
// the epilogue's [R, N_EPI, D] (scratch, jt_ega_jvp_scratch) (p[0..20]),
// all floats but the tables' in the working type.  flags: bits co2, h2o,
// n2, o2; constants: NA 1000 P0, P0, C1, C2, TAU_OPAQUE, TAU_CUTOFF,
// LOG2_RATIO_U and 2 ** LOG2_RATIO_U.
extern "C" int jt_ega_jvp_fast(
    const void* eps, const void* l2u0, const void* p_ax, const void* t_ax,
    const void* nu, const void* nt, const void* np_, const void* ok,
    const void* cc, const void* window, const void* sr, const void* st,
    const void* nu_ch, const void* lp, const void* lt, const void* lds,
    const void* lq, const void* lk, const void* lu, const void* lvalid,
    const void* ltsurf, const void* seg, const void* dts, void* rad,
    void* tau, void* drad, void* first, void* rec, void* epi, int R, int S,
    int G, int W, int D, int P, int NT, int K, int n_src, int n, int flags,
    int ig_co2, int ig_h2o, int bbt, double k0, double p0, double c1,
    double c2, double tau_opaque, double tau_cutoff, double log2_ratio_u,
    double ratio_u, int is_double, void* stream) {
  if (R < 1 || S < 1 || G < 1 || W < 0 || D < 1 || P < 1 || NT < 1 ||
      K < 1 || n_src < 2 || n < 1)
    return (int)cudaErrorInvalidValue;
  const void* tp[8] = {eps, l2u0, p_ax, t_ax, nu, nt, np_, ok};
  const void* p[21] = {cc,  window, sr,  st,     nu_ch,  lp,  lt,
                       lds, lq,     lk,  lu,     lvalid, ltsurf, seg,
                       dts, rad,    tau, drad,   first,  rec, epi};
  const Consts cs{k0,         p0,         c1,           c2,
                  tau_opaque, tau_cutoff, log2_ratio_u, ratio_u};
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch<double>(tp, p, R, S, G, W, D, P, NT, K, n_src, n,
                                    flags, ig_co2, ig_h2o, bbt, cs, s)
                   : launch<float>(tp, p, R, S, G, W, D, P, NT, K, n_src, n,
                                   flags, ig_co2, ig_h2o, bbt, cs, s);
}

// The scratch layout at G gases: the values of one record (per valid
// segment and channel) into *rec and of the epilogue (per ray and
// channel) into *epi (int each); the wrapper allocates by them.
extern "C" int jt_ega_jvp_scratch(int G, void* rec, void* epi) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  *(int*)rec = rec_len(G);
  *(int*)epi = N_EPI;
  return 0;
}
