// Tangent kernel of the ray tracer: the rays of trace_rays.cu, bit for bit,
// and the forward-mode tangents of the fields the RT pass reads (p, t, q,
// k, u and ds at every step, and tsurf) in n directions of the state: the
// tracer's half of the JAX package's compiled forward-mode Jacobian
// (``jax.jit(jax.jacfwd(fwd))``, jurassic_tpu/retrieval.py:281, through
// ``_trace_single``, jurassic_tpu/geometry.py:283), in the order of the
// plain version ``geometry.trace_rays_jvp_ref``.
//
// The profiles' tangents come at the atm points, [N, 2 + G + W, n] (p, t,
// q[G], k[W]), with the window indices gi [R, L] that map a ray's levels
// onto them: rays that share a profile share its tangents, and no per-ray
// copy is made.  z is never a state element: zmin, zmax and the entry
// point carry no tangent, and without refraction neither does the
// geometry.  With REFRAC 1 the refractivity bends the ray, so positions,
// directions, altitudes and step lengths carry tangents; interval indices
// are piecewise constant, so tangents flow through the interpolation
// weights and through d(value)/dz dz.  The escape clip's
// xh = geo2cart(cart2geo(px)) is px, so its tangent is px's.
//
// Design.  A block takes one ray and up to WARPS_MAX warps, warp w of
// block y the tangents 32 (y WARPS_MAX + w) + lane, one a lane.  Every
// warp runs the tracer's primal chain of trace_common.cuh (a warp per ray,
// the chain's bits in every lane, votes and shuffles), with a StepLin
// capturing the primal values the tangent rules read; each lane then
// updates its tangent of the ray's state (position, direction, last point
// and its altitude: a dozen values) from them.  The votes, the escape
// test and the stopping logic read primal values only, so they stay
// uniform.  Refraction's five interpolations are lane m's altitude m in
// the chain; their partials reach every lane by shuffle, and each lane
// loops over the five for its own tangent.  A step where a fast float
// operation leaves its range runs again with the operations themselves,
// and its StepLin is the re-run's.  Unlike the tracer kernel no stopped
// ray repeats a step: every step runs, as in the plain version, so a
// stopped ray's tangents follow its own step's rules (its primal is the
// same either way).  The step loop writes each step's tangents of p, t, q,
// k and the raw ds; after it, each lane applies the ds correction, the
// trapezoid rule and the column densities to its own tangent.
//
// What bounds it: the store of the tangents, 12 x NLOS x n values a ray
// (5.4 GB in float64 at the flagship, 1.6 ms at the HBM rate), is the
// bound; what it takes is the primal chain (the tracer kernel's, under
// 0.5 ms at the flagship alone), run once per warp, so ceil(n / 32) times
// a ray, plus, per step and lane, about 30 loads of profile tangents
// (L1/L2: a profile's tangents are 335 KB in float64 at the flagship) and
// about 270 float operations: 22.77 ms in float64, 13.20 ms in float32
// at the flagship (PERF.md, the H100).
//
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using namespace jt_trace;

constexpr int WARPS_MAX = 8;  // warps (tangent chunks of 32) of one block

// A lane's tangent of the ray's state between steps: position, direction,
// the last step's point and its altitude; tsurf's and the ds correction's
template <typename T>
struct TanRay {
  V3<T> dx, dex, dpx;
  T dpz, dtsurf, dcorr;
};

// The profiles' tangents of one lane: field f at level l of the ray
// (0 below a one-level window's only level, as lo_of reads)
template <typename T>
struct ProfTan {
  const T* __restrict__ d;  // [N, F, n] at the atm points
  const int* gis;           // [L] the ray's level -> atm point (shared)
  int F, n, k;
  __device__ __forceinline__ T at(int l, int f) const {
    return l < 0 ? T(0) : __ldg(d + ((size_t)gis[l] * F + f) * n + k);
  }
};

// The tangent of step ip in this lane from the step's StepLin and its input
// state s0: updates d, writes the step's tangents of p, t, q[G], k[W] and
// the raw ds to out[f n] (the lane's column of the step's [F, n] block)
template <bool REFRAC, typename T>
__device__ __forceinline__ void tangent_step(const StepLin<T>& L,
                                             const Ray<T>& s0, TanRay<T>& d,
                                             const Prof<T>& pr,
                                             const ProfTan<T>& pt,
                                             T* __restrict__ out, int G,
                                             int W, int n, bool write) {
  // step length: ds = raydz / |ex . x / |x||, clamped (jr_common.h:625-635)
  const T dr = dot3(s0.x, d.dx) / L.radius;
  T dds = T(0);
  if (L.ds_var) {
    const T dnorm = -(L.norm_x * L.norm_x) * dr;
    const T dc = (dot3(d.dex, s0.x) + dot3(s0.ex, d.dx)) * L.norm_x +
                 L.exx * dnorm;
    dds = L.dds_dc * dc;
  }
  T dz = dr;
  V3<T> dx = d.dx;
  T dds_corr = T(0);
  if (L.escaped) {  // the clip to the boundary
    const T dden = L.same ? T(0) : dz - d.dpz;
    const T dfrac = (-d.dpz - L.frac * dden) / L.den;
    dx = {d.dpx.x + dfrac * (s0.x.x - L.xh.x) + L.frac * (dx.x - d.dpx.x),
          d.dpx.y + dfrac * (s0.x.y - L.xh.y) + L.frac * (dx.y - d.dpx.y),
          d.dpx.z + dfrac * (s0.x.z - L.xh.z) + L.frac * (dx.z - d.dpx.z)};
    dds_corr = dds * L.frac + L.ds_pre * dfrac;
    dz = dot3(L.xe, dx) / L.rxe;
    dds = T(0);
  }

  // p and t at z (lane 0's partials), then q and k there
  const int i0 = L.iq[0];
  const T dp = __shfl_sync(FULL, L.own_pa, 0) * pt.at(i0, 0) +
               __shfl_sync(FULL, L.own_pb, 0) * pt.at(i0 + 1, 0) +
               __shfl_sync(FULL, L.own_pz, 0) * dz;
  const T dt = __shfl_sync(FULL, L.own_ta, 0) * pt.at(i0, 1) +
               __shfl_sync(FULL, L.own_tb, 0) * pt.at(i0 + 1, 1) +
               __shfl_sync(FULL, L.own_tz, 0) * dz;
  const T za = lo_of(pr.z, i0), inv = T(1) / (pr.z[i0 + 1] - za);
  const T w = (L.z - za) * inv;
  if (write) {
    out[0] = dp;
    out[n] = dt;
    for (int f = 2; f < 2 + G + W; ++f) {
      const T* row = f < 2 + G ? pr.q + (size_t)(f - 2) * pr.L
                               : pr.k + (size_t)(f - 2 - G) * pr.L;
      const T slope = (row[i0 + 1] - lo_of(row, i0)) * inv;
      out[(size_t)f * n] = (T(1) - w) * pt.at(i0, f) +
                           w * pt.at(i0 + 1, f) + slope * dz;
    }
    out[(size_t)(2 + 2 * G + W) * n] = dds;
  }
  if (L.stopping && L.below) d.dtsurf = dt;
  if (L.corr) d.dcorr = dds_corr;

  // the direction: refraction's p and t at z and at the midpoint and its
  // three offset points (lane m's altitude m), normalised
  V3<T> dex1 = d.dex;
  if constexpr (REFRAC) {
    const T h = T(0.02), hds = T(0.5) * L.ds, dhds = T(0.5) * dds;
    const V3<T> dxh2{dx.x + dhds * s0.ex.x + hds * d.dex.x,
                     dx.y + dhds * s0.ex.y + hds * d.dex.y,
                     dx.z + dhds * s0.ex.z + hds * d.dex.z};
    const T xd = dot3(L.xh2, dxh2);
    T dn[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      T dzm = dz;
      if (m > 0) {
        const T off = m == 2 ? dxh2.x : m == 3 ? dxh2.y : m == 4 ? dxh2.z
                                                              : T(0);
        dzm = (xd + h * off) / L.rv[m - 1];
      }
      const int im = L.iq[m];
      const T dpm = __shfl_sync(FULL, L.own_pa, m) * pt.at(im, 0) +
                    __shfl_sync(FULL, L.own_pb, m) * pt.at(im + 1, 0) +
                    __shfl_sync(FULL, L.own_pz, m) * dzm;
      const T dtm = __shfl_sync(FULL, L.own_ta, m) * pt.at(im, 1) +
                    __shfl_sync(FULL, L.own_tb, m) * pt.at(im + 1, 1) +
                    __shfl_sync(FULL, L.own_tz, m) * dzm;
      dn[m] = (T(7.753e-05) * dpm - __shfl_sync(FULL, L.own_r, m) * dtm) /
              __shfl_sync(FULL, L.own_t, m);
    }
    const T dnf = L.use ? dn[0] : T(0);
    const V3<T> dg = L.use ? V3<T>{(dn[2] - dn[1]) / h, (dn[3] - dn[1]) / h,
                                   (dn[4] - dn[1]) / h}
                           : V3<T>{T(0), T(0), T(0)};
    dex1 = {d.dex.x * L.nfac + s0.ex.x * dnf + dds * L.ng.x + L.ds * dg.x,
            d.dex.y * L.nfac + s0.ex.y * dnf + dds * L.ng.y + L.ds * dg.y,
            d.dex.z * L.nfac + s0.ex.z * dnf + dds * L.ng.z + L.ds * dg.z};
  }
  const T proj = dot3(L.ex1, dex1);
  const V3<T> dex1n{(dex1.x - L.ex1.x * proj) / L.en,
                    (dex1.y - L.ex1.y * proj) / L.en,
                    (dex1.z - L.ex1.z * proj) / L.en};
  d.dpx = dx;
  d.dpz = dz;
  if (L.advance) {
    const T hds = T(0.5) * L.ds, dhds = T(0.5) * dds;
    d.dx = {dx.x + dhds * (s0.ex.x + L.ex1.x) + hds * (d.dex.x + dex1n.x),
            dx.y + dhds * (s0.ex.y + L.ex1.y) + hds * (d.dex.y + dex1n.y),
            dx.z + dhds * (s0.ex.z + L.ex1.z) + hds * (d.dex.z + dex1n.z)};
    d.dex = dex1n;
  } else {
    d.dx = dx;
  }
}

// Shared memory of a block: the ray's (ray_bytes), then its window indices
template <typename T>
__host__ __device__ size_t jvp_ray_bytes(int L, int G, int W, int nlos) {
  return ray_bytes<T>(L, G, W, nlos) + ((size_t)L * 4 + 15) / 16 * 16;
}

// Two blocks a multiprocessor at least: in float64 ptxas then keeps 128
// registers, not 210, and spills a few hundred bytes; 43.55 -> 22.77 ms
// at the flagship, float32 13.34 -> 13.20 ms (PERF.md, the H100)
template <typename T, bool REFRAC>
__global__ void __launch_bounds__(32 * WARPS_MAX, 2) trace_rays_jvp_kernel(
    const T* __restrict__ pz_, const T* __restrict__ pp_,
    const T* __restrict__ pt_, const T* __restrict__ pq_,
    const T* __restrict__ pk_, const int* __restrict__ nlev_,
    const T* __restrict__ zmin_, const T* __restrict__ zmax_,
    const T* __restrict__ geo, const T* __restrict__ dA,
    const int* __restrict__ gi, T* out_z, T* out_lon, T* out_lat, T* out_p,
    T* out_t, T* out_q, T* out_k, T* out_ds, T* out_u, uint8_t* out_valid,
    int* out_np, T* out_tsurf, T* out_tpz, T* out_tplon, T* out_tplat,
    int* out_flag, T* __restrict__ seg, T* __restrict__ dtsurf, int R, int L,
    int G, int W, int nlos, int n, T rayds, T raydz, bool use_raydz,
    int entry_iters, Consts<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x;
  const int k = (blockIdx.y * (blockDim.x >> 5) + warp) * 32 + lane;
  const bool kv = k < n;
  const RaySmem<T> m = carve<T>(smem, L, G, W, nlos);
  int* gis = reinterpret_cast<int*>(smem + ray_bytes<T>(L, G, W, nlos));
  stage(m, r, L, G, W, pz_, pp_, pt_, pq_, pk_, threadIdx.x, blockDim.x);
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    gis[j] = gi[(size_t)r * L + j];
  __syncthreads();
  const Prof<T> pr{m.z, m.p, m.t, m.q, m.k, L, nlev_[r]};
  const RayStart<T> st =
      ray_start(geo, r, R, zmin_[r], zmax_[r], c, entry_iters);
  const ProfTan<T> ptan{dA, gis, 2 + G + W, n, kv ? k : n - 1};
  const int F = 3 + 2 * G + W;

  Ray<T> s = st.s;
  TanRay<T> d;
  d.dx = d.dex = d.dpx = V3<T>{T(0), T(0), T(0)};
  d.dpz = d.dtsurf = d.dcorr = T(0);
  Rec<T> rec;
  for (int ip = 0; ip < nlos; ++ip) {
    StepLin<T> cap;
    Ray<T> nx = s;
    if (!__all_sync(FULL, step<Ops<T, false>, REFRAC>(
            nx, rec, ip, pr, c, st.zmin, st.zmax, rayds, raydz, use_raydz,
            st.ok, lane, cap))) {
      nx = s;  // a fast path out of range: the step with the operations
      step<Exact<T>, REFRAC>(nx, rec, ip, pr, c, st.zmin, st.zmax, rayds,
                             raydz, use_raydz, st.ok, lane, cap);
    }
    tangent_step<REFRAC>(cap, s, d, pr, ptan,
                         seg + ((size_t)r * nlos + ip) * F * n + ptan.k, G,
                         W, n, kv);
    s = nx;
    if (threadIdx.x == 0) record(m, ip, rec);
  }
  __syncthreads();

  // each lane's tangent: the ds correction of the point before the
  // boundary point, the trapezoid rule and the column densities
  // (jr_common.h:438-453), the primal values from the records
  const int fds = 2 + 2 * G + W, fu = 2 + G + W;
  T ds_prev = T(0), dds_prev = T(0);
  for (int ip = 0; ip < nlos && kv; ++ip) {
    T* o = seg + ((size_t)r * nlos + ip) * F * n + k;
    T ds_raw = m.rds[ip], dds_raw = o[(size_t)fds * n];
    if (ip == s.corr_idx - 1) {
      ds_raw = s.corr_val;
      dds_raw = d.dcorr;
    }
    const T ds_trap = T(0.5) * (ds_prev + ds_raw);
    const T dds_trap = T(0.5) * (dds_prev + dds_raw);
    ds_prev = ds_raw;
    dds_prev = dds_raw;
    o[(size_t)fds * n] = dds_trap;
    const int i = m.ridx[ip];
    const T z =
        m_sqrt(dot3(V3<T>{m.rz[ip], m.rlon[ip], m.rlat[ip]},
                    V3<T>{m.rz[ip], m.rlon[ip], m.rlat[ip]})) -
        c.re;
    const T za = lo_of(pr.z, i), zb = pr.z[i + 1];
    const T p = m.rp[ip], t = m.rt[ip], dp = o[0], dt = o[n];
    const T b = c.kb * t;
    for (int g = 0; g < G; ++g) {
      const T* q = pr.q + (size_t)g * L;
      bool exact = true;
      const T qv = lin<Exact<T>>(za, lo_of(q, i), zb, q[i + 1], z, exact);
      const T cq = T(10) * qv * p / b;
      const T dcq =
          (T(10) * (o[(size_t)(2 + g) * n] * p + qv * dp) - cq * (c.kb * dt)) /
          b;
      o[(size_t)(fu + g) * n] = dcq * ds_trap + cq * dds_trap;
    }
  }
  if (kv) dtsurf[(size_t)r * n + k] = st.ok ? d.dtsurf : T(0);
  __syncthreads();
  if (blockIdx.y == 0 && warp == 0)
    ray_finish(m, pr, s, st, out_z, out_lon, out_lat, out_p, out_t, out_q,
               out_k, out_ds, out_u, out_valid, out_np, out_tsurf, out_tpz,
               out_tplon, out_tplat, out_flag, r, G, W, nlos, c, lane);
}

template <typename T>
int launch(const void* const* in, void* const* out, int R, int L, int G,
           int W, int nlos, int n, double rayds, double raydz, int refrac,
           int entry_iters, double re, double deg2rad, double rad2deg,
           double kb, double z_refrac, cudaStream_t stream) {
  const size_t smem = jvp_ray_bytes<T>(L, G, W, nlos);
  auto kernel = refrac ? trace_rays_jvp_kernel<T, true>
                       : trace_rays_jvp_kernel<T, false>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Consts<T> c{T(re),       T(deg2rad),           T(rad2deg),
                    T(kb),       T(z_refrac),          T(__builtin_nan("")),
                    T(__builtin_huge_val())};
  const int chunks = (n + 31) / 32;
  const int nw = chunks < WARPS_MAX ? chunks : WARPS_MAX;
  const dim3 grid(R, (chunks + nw - 1) / nw);
  kernel<<<grid, 32 * nw, smem, stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const int*)in[5], (const T*)in[6], (const T*)in[7],
      (const T*)in[8], (const T*)in[9], (const int*)in[10], (T*)out[0],
      (T*)out[1], (T*)out[2], (T*)out[3], (T*)out[4], (T*)out[5], (T*)out[6],
      (T*)out[7], (T*)out[8], (uint8_t*)out[9], (int*)out[10], (T*)out[11],
      (T*)out[12], (T*)out[13], (T*)out[14], (int*)out[15], (T*)out[16],
      (T*)out[17], R, L, G, W, nlos, n, T(rayds), T(raydz), raydz > 0.0,
      entry_iters, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: the profiles z, p, t [R, L], q [R, G, L], k [R, W, L], nlev
// [R] int32, zmin, zmax [R], the observation geometry [6, R], the profile
// tangents [N, 2 + G + W, n] at the atm points and the window indices gi
// [R, L] int32 (in[0..10]); then the LosData outputs of jt_trace_rays, the
// bisection flag [R] int32, the LOS tangents [R, NLOS, 3 + 2 G + W, n]
// (p, t, q[G], k[W], u[G], ds) and tsurf's [R, n] (out[0..17]).  Blocks of
// up to 8 warps, one ray each, jt_trace_jvp_smem_bytes of shared memory.
extern "C" int jt_trace_rays_jvp(
    const void* z, const void* p, const void* t, const void* q,
    const void* k, const void* nlev, const void* zmin, const void* zmax,
    const void* geo, const void* dA, const void* gi, void* oz, void* olon,
    void* olat, void* op, void* ot, void* oq, void* ok, void* ods, void* ou,
    void* ovalid, void* onp, void* otsurf, void* otpz, void* otplon,
    void* otplat, void* oflag, void* oseg, void* odtsurf, int R, int L, int G,
    int W, int nlos, int n, double rayds, double raydz, int refrac,
    int entry_iters, double re, double deg2rad, double rad2deg, double kb,
    double z_refrac, int is_double, void* stream) {
  if (R < 1 || L < 1 || G < 0 || W < 0 || nlos < 3 || n < 1 ||
      entry_iters < 0)
    return (int)cudaErrorInvalidValue;
  const void* in[11] = {z, p, t, q, k, nlev, zmin, zmax, geo, dA, gi};
  void* out[18] = {oz,     olon, olat,   op,     ot,     oq,
                   ok,     ods,  ou,     ovalid, onp,    otsurf,
                   otpz,   otplon, otplat, oflag, oseg, odtsurf};
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch<double>(in, out, R, L, G, W, nlos, n, rayds,
                                    raydz, refrac, entry_iters, re, deg2rad,
                                    rad2deg, kb, z_refrac, st)
                   : launch<float>(in, out, R, L, G, W, nlos, n, rayds, raydz,
                                   refrac, entry_iters, re, deg2rad, rad2deg,
                                   kb, z_refrac, st);
}

// The bytes of shared memory the kernel gives one ray (and so its block)
// at these sizes, into *bytes (long long).
extern "C" int jt_trace_jvp_smem_bytes(int L, int G, int W, int nlos,
                                       int is_double, void* bytes) {
  if (L < 1 || G < 0 || W < 0 || nlos < 0) return (int)cudaErrorInvalidValue;
  *(long long*)bytes =
      (long long)(is_double ? jvp_ray_bytes<double>(L, G, W, nlos)
                            : jvp_ray_bytes<float>(L, G, W, nlos));
  return 0;
}
