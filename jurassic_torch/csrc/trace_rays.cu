// Ray tracer: one thread traces one ray through the spherical-shell
// atmosphere, the whole of the JAX package's per-ray ``_trace_single``
// (jurassic_tpu/geometry.py:283-483, a jitted vmap there) in the order of
// operations of the port's plain version ``geometry.trace_rays_ref``:
//
//   the entry-point bisection (a per-ray loop of at most ``entry_iters``
//   halvings; a ray still bracketing after them raises its flag), then
//   NLOS steps of step length, cart2geo, the escape clip, the profile
//   interpolation (one interval search over the ray's levels), the lowest
//   point and surface temperature, refraction (the midpoint and three
//   offset points) and the direction update; then the ds correction of
//   the point before the boundary, the tangent point, the trapezoid rule
//   and the column densities.
//
// Every step runs for every ray, stopped or not, so that every output
// field holds the plain version's values, the inactive steps' included.
// The library builds with -fmad=false: each operation below rounds on its
// own, as each eager PyTorch operation does.  Constants arrive as doubles
// and are cast to T where the eager version casts a Python float; a
// division of a Python float by a tensor is reciprocal then multiply,
// as ``Tensor.__rtruediv__`` computes it.  The transcendentals are
// libdevice's, which PyTorch's CUDA kernels also call.
//
// What bounds it: latency.  Each thread runs its ray's steps one after
// the other (five linear interval searches over the levels and about a
// dozen transcendentals per step), and the flagship's 1084 rays are 34
// warps, under one per SM: 5.2 ms on the H100 against 8.4 us for its
// compulsory bytes (PERF.md).  The design keeps it simple and right: the
// reference's thread per ray (raytrace_rays_GPU), row-major writes;
// spreading a ray over a warp is later work.
//
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_asin(float x) { return asinf(x); }
__device__ __forceinline__ double m_asin(double x) { return asin(x); }
__device__ __forceinline__ float m_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double m_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_fabs(double x) { return fabs(x); }
__device__ __forceinline__ bool m_isnan(float x) { return isnan(x); }
__device__ __forceinline__ bool m_isnan(double x) { return isnan(x); }

// torch.clamp(min=) / clamp(max=) keep a NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return x > hi ? hi : x;
}

template <typename T>
struct Consts {
  T re, deg2rad, rad2deg, kb, z_refrac, nan, inf;
};

template <typename T>
struct V3 {
  T x, y, z;
};

// _dot3: sum over (x, y, z) in a fixed order
template <typename T>
__device__ __forceinline__ T dot3(const V3<T>& a, const V3<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ V3<T> geo2cart(T alt, T lon, T lat,
                                          const Consts<T>& c) {
  T radius = alt + c.re;
  T clat = m_cos(lat * c.deg2rad);
  T rc = radius * clat;
  return {rc * m_cos(lon * c.deg2rad), rc * m_sin(lon * c.deg2rad),
          radius * m_sin(lat * c.deg2rad)};
}

template <typename T>
__device__ __forceinline__ void cart2geo(const V3<T>& x, const Consts<T>& c,
                                         T& z, T& lon, T& lat) {
  T radius = m_sqrt(dot3(x, x));
  lat = m_asin(x.z / radius) * c.rad2deg;
  lon = m_atan2(x.y, x.x) * c.rad2deg;
  z = radius - c.re;
}

// _lin and _eip of the plain version
template <typename T>
__device__ __forceinline__ T lin(T x0, T y0, T x1, T y1, T x) {
  return y0 + (x - x0) * (y1 - y0) / (x1 - x0);
}
template <typename T>
__device__ __forceinline__ T eip(T x0, T y0, T x1, T y1, T x) {
  if (y0 > T(0) && y1 > T(0))
    return y0 * m_exp(m_log(y1 / y0) / (x1 - x0) * (x - x0));
  return lin(x0, y0, x1, y1, x);
}

// One ray's profiles: z, p, t [L] and q [G][L], k [W][L] rows.
template <typename T>
struct Prof {
  const T *z, *p, *t, *q, *k;
  int L, nlev;
};

// _interval_index: #{l : z[l] <= z0} - 1 over all L levels (the padding
// included), clamped to [0, nlev - 2]; -1 for a one-level window
template <typename T>
__device__ __forceinline__ int interval_index(const Prof<T>& pr, T z0) {
  int below = 0;
  for (int l = 0; l < pr.L; ++l) below += pr.z[l] <= z0 ? 1 : 0;
  int i = below - 1 < 0 ? 0 : below - 1;
  return i < pr.nlev - 2 ? i : pr.nlev - 2;
}

// _take_lo: the lower level, 0 below a one-level window's only level
template <typename T>
__device__ __forceinline__ T lo_of(const T* row, int i) {
  return i >= 0 ? row[i] : T(0);
}

// interp_pt at altitude z0
template <typename T>
__device__ __forceinline__ void interp_pt(const Prof<T>& pr, T z0, T& p,
                                          T& t) {
  int i = interval_index(pr, z0);
  T za = lo_of(pr.z, i), zb = pr.z[i + 1];
  p = eip(za, lo_of(pr.p, i), zb, pr.p[i + 1], z0);
  t = lin(za, lo_of(pr.t, i), zb, pr.t[i + 1], z0);
}

template <typename T>
__device__ __forceinline__ T refractivity(T p, T t) {
  return T(7.753e-05) * p / t;
}

template <typename T>
__global__ void __launch_bounds__(128)
    trace_rays_kernel(const T* __restrict__ pz_, const T* __restrict__ pp_,
                      const T* __restrict__ pt_, const T* __restrict__ pq_,
                      const T* __restrict__ pk_,
                      const int* __restrict__ nlev_,
                      const T* __restrict__ zmin_,
                      const T* __restrict__ zmax_,
                      const T* __restrict__ geo, T* out_z, T* out_lon,
                      T* out_lat, T* out_p, T* out_t, T* out_q, T* out_k,
                      T* out_ds, T* out_u, uint8_t* out_valid, int* out_np,
                      T* out_tsurf, T* out_tpz, T* out_tplon, T* out_tplat,
                      int* out_flag, int R, int L, int G, int W, int nlos,
                      T rayds, T raydz, bool use_raydz, bool refrac,
                      int entry_iters, Consts<T> c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Prof<T> pr{pz_ + (size_t)r * L, pp_ + (size_t)r * L,
                   pt_ + (size_t)r * L, pq_ + (size_t)r * G * L,
                   pk_ + (size_t)r * W * L, L, nlev_[r]};
  const T zmin = zmin_[r], zmax = zmax_[r];
  const T obsz = geo[r], obslon = geo[R + r], obslat = geo[2 * R + r];
  const T vpz = geo[3 * R + r], vplon = geo[4 * R + r],
          vplat = geo[5 * R + r];
  const size_t row = (size_t)r * nlos;

  const V3<T> xobs = geo2cart(obsz, obslon, obslat, c);
  const V3<T> xvp = geo2cart(vpz, vplon, vplat, c);
  V3<T> ex0{xvp.x - xobs.x, xvp.y - xobs.y, xvp.z - xobs.z};
  const T norm = m_sqrt(dot3(ex0, ex0));
  ex0 = {ex0.x / norm, ex0.y / norm, ex0.z / norm};

  // traced only when the observer is above zmin and the view point below
  // zmax - 0.001 (jr_common.h:598-599)
  const bool ok = (obsz >= zmin) && (vpz <= zmax - T(0.001));

  // entry-point bisection (jr_common.h:610-621), run for every ray as the
  // batched plain version runs it; used where the observer is above zmax
  T dmin = T(0), dmax = norm;
  V3<T> xe0 = xobs;
  bool found = false, act = false;
  for (int it = 0; it < entry_iters; ++it) {
    act = (m_fabs(dmin - dmax) > T(0.001)) && !found;
    if (!act) break;
    T d = T(0.5) * (dmax + dmin);
    V3<T> xn{xobs.x + d * ex0.x, xobs.y + d * ex0.y, xobs.z + d * ex0.z};
    T z = m_sqrt(dot3(xn, xn)) - c.re;
    bool f = (z <= zmax) && (z > zmax - T(0.001));
    bool low = z < zmax - T(0.0005);
    if (!f && low) dmax = d;
    if (!f && !low) dmin = d;
    xe0 = xn;
    found = f;
  }
  out_flag[r] = ((m_fabs(dmin - dmax) > T(0.001)) && !found) ? 1 : 0;

  V3<T> x = obsz > zmax ? xe0 : xobs;
  V3<T> ex = ex0;
  bool stopped = !ok;
  T tsurf = T(-999.0);
  T z_low = c.inf;
  int z_low_idx = -1;
  T pz = T(0), plon = T(0), plat = T(0);
  int np = 0, corr_idx = -1;
  T corr_val = T(0);

  for (int ip = 0; ip < nlos; ++ip) {
    // step length (jr_common.h:625-635)
    T ds = rayds;
    if (use_raydz) {
      T norm_x = T(1) / m_sqrt(dot3(x, x));
      T cosa = m_fabs(dot3(ex, x) * norm_x);
      if (cosa != T(0)) ds = clamp_max((T(1) / cosa) * raydz, rayds);
    }
    T z, lon, lat;
    cart2geo(x, c, z, lon, lat);

    // escape clipping (jr_common.h:637-648)
    const bool below = z < zmin;
    const bool escaped = below || (z > zmax);
    T ds_corr = c.nan;
    if (escaped) {
      V3<T> xh = geo2cart(pz, plon, plat, c);
      T zfrac = below ? zmin : zmax;
      T frac = (zfrac - pz) / (z == pz ? T(1) : z - pz);
      x = {xh.x + frac * (x.x - xh.x), xh.y + frac * (x.y - xh.y),
           xh.z + frac * (x.z - xh.z)};
      ds_corr = ds * frac;
      cart2geo(x, c, z, lon, lat);
      ds = T(0);
    }

    // interp_all: one interval search for p, t, q, k
    const int i = interval_index(pr, z);
    const T za = lo_of(pr.z, i), zb = pr.z[i + 1];
    const T p = eip(za, lo_of(pr.p, i), zb, pr.p[i + 1], z);
    const T t = lin(za, lo_of(pr.t, i), zb, pr.t[i + 1], z);
    const size_t o = row + ip;
    for (int g = 0; g < G; ++g) {
      const T* q = pr.q + (size_t)g * L;
      out_q[o * G + g] = lin(za, lo_of(q, i), zb, q[i + 1], z);
    }
    for (int w = 0; w < W; ++w) {
      const T* k = pr.k + (size_t)w * L;
      out_k[o * W + w] = lin(za, lo_of(k, i), zb, k[i + 1], z);
    }

    const bool active = ok && !stopped;
    if (active && z < z_low) {
      z_low = z;
      z_low_idx = ip;
    }
    const bool stopping = active && escaped;
    if (stopping && below) tsurf = t;
    // the first recorded correction (at most one per ray)
    if (stopping && corr_idx < 0 && !m_isnan(ds_corr)) {
      corr_idx = ip;
      corr_val = ds_corr;
    }
    out_z[o] = z;
    out_lon[o] = lon;
    out_lat[o] = lat;
    out_p[o] = p;
    out_t[o] = t;
    out_ds[o] = ds;
    out_valid[o] = active ? 1 : 0;
    np += active ? 1 : 0;

    // direction update with optional refraction (jr_common.h:664-690)
    V3<T> ex1 = ex;
    if (refrac) {
      const T nn = T(1) + refractivity(p, t);
      const T hds = T(0.5) * ds;
      const V3<T> xh2{x.x + hds * ex.x, x.y + hds * ex.y, x.z + hds * ex.z};
      const T h = T(0.02);
      T nq[4];
      for (int m = 0; m < 4; ++m) {
        V3<T> v = xh2;
        if (m == 1) v.x = xh2.x + h;
        if (m == 2) v.y = xh2.y + h;
        if (m == 3) v.z = xh2.z + h;
        T pq, tq;
        interp_pt(pr, m_sqrt(dot3(v, v)) - c.re, pq, tq);
        nq[m] = refractivity(pq, tq);
      }
      const bool use = z <= c.z_refrac;
      const T n = use ? nn : T(1);
      const T g0 = use ? (nq[1] - nq[0]) / h : T(0);
      const T g1 = use ? (nq[2] - nq[0]) / h : T(0);
      const T g2 = use ? (nq[3] - nq[0]) / h : T(0);
      ex1 = {ex.x * n + ds * g0, ex.y * n + ds * g1, ex.z * n + ds * g2};
    }
    const T en = m_sqrt(dot3(ex1, ex1));
    ex1 = {ex1.x / en, ex1.y / en, ex1.z / en};
    if (active && !stopping) {
      const T hds = T(0.5) * ds;
      x = {x.x + hds * (ex.x + ex1.x), x.y + hds * (ex.y + ex1.y),
           x.z + hds * (ex.z + ex1.z)};
      ex = ex1;
    }
    stopped = stopped || stopping || !ok;
    pz = z;
    plon = lon;
    plat = lat;
  }
  out_np[r] = np;

  // escape segment-length correction of the point before the boundary
  // point (los[np-1].ds = ds*frac, jr_common.h:646)
  if (corr_idx >= 1) out_ds[row + corr_idx - 1] = corr_val;

  // tangent point from the pre-trapezoid segment lengths
  // (geometry.tangent_point, with its dx12 = 0 guard)
  {
    const int ipl = z_low_idx;
    int ips = ipl < 1 ? 1 : ipl;
    ips = ips > nlos - 2 ? nlos - 2 : ips;
    const T* zr = out_z + row;
    const T* lonr = out_lon + row;
    const T* latr = out_lat + row;
    const T* dsr = out_ds + row;
    const T yy0 = zr[ips - 1], yy1 = zr[ips], yy2 = zr[ips + 1];
    const T ds0 = dsr[ips], ds1 = dsr[ips + 1];
    const T dyy10 = yy1 - yy0, dyy21 = yy2 - yy1;
    const T x1 = m_sqrt(clamp_min(ds0 * ds0 - dyy10 * dyy10, T(0)));
    const T x2 = x1 + m_sqrt(clamp_min(ds1 * ds1 - dyy21 * dyy21, T(0)));
    const T dx12 = x1 - x2;
    const bool limb = (ipl > 0) && (ipl < np - 1) && (dx12 != T(0));
    T tpz, tplon, tplat;
    if (limb) {
      const T a = (dyy10 * x2 + (yy0 - yy2) * x1) / (x1 * x2 * dx12);
      const T b = dyy10 / x1 - a * x1;
      const T xt = -b / (T(2) * (a == T(0) ? T(1) : a));
      tpz = (a * xt + b) * xt + yy0;
      const V3<T> v0 = geo2cart(yy0, lonr[ips - 1], latr[ips - 1], c);
      const V3<T> v2 = geo2cart(yy2, lonr[ips + 1], latr[ips + 1], c);
      const T s = xt / (x2 == T(0) ? T(1) : x2);
      const V3<T> v{v0.x + (v2.x - v0.x) * s, v0.y + (v2.y - v0.y) * s,
                    v0.z + (v2.z - v0.z) * s};
      T vz;
      cart2geo(v, c, vz, tplon, tplat);
    } else {
      int last = np - 1 < 0 ? 0 : np - 1;
      last = last > nlos - 1 ? nlos - 1 : last;
      tpz = zr[last];
      tplon = lonr[last];
      tplat = latr[last];
    }
    // rays that never traced keep the view point (jr_common.h:592-594)
    out_tpz[r] = ok ? tpz : vpz;
    out_tplon[r] = ok ? tplon : vplon;
    out_tplat[r] = ok ? tplat : vplat;
    out_tsurf[r] = ok ? tsurf : T(-999.0);
  }

  // trapezoid rule (jr_common.h:438-443) and column densities
  // (jr_common.h:446-453)
  T ds_prev = T(0);
  for (int ip = 0; ip < nlos; ++ip) {
    const size_t o = row + ip;
    const T ds = out_ds[o];
    const T ds_trap = T(0.5) * (ds_prev + ds);
    ds_prev = ds;
    out_ds[o] = ds_trap;
    const T p = out_p[o];
    const T kbt = c.kb * out_t[o];
    for (int g = 0; g < G; ++g)
      out_u[o * G + g] = T(10) * out_q[o * G + g] * p / kbt * ds_trap;
  }
}

template <typename T>
int launch(const void* z, const void* p, const void* t, const void* q,
           const void* k, const void* nlev, const void* zmin,
           const void* zmax, const void* geo, void* oz, void* olon,
           void* olat, void* op, void* ot, void* oq, void* ok, void* ods,
           void* ou, void* ovalid, void* onp, void* otsurf, void* otpz,
           void* otplon, void* otplat, void* oflag, int R, int L, int G,
           int W, int nlos, double rayds, double raydz, int refrac,
           int entry_iters, double re, double deg2rad, double rad2deg,
           double kb, double z_refrac, cudaStream_t stream) {
  const Consts<T> c{T(re),       T(deg2rad),           T(rad2deg),
                    T(kb),       T(z_refrac),          T(__builtin_nan("")),
                    T(__builtin_huge_val())};
  const int threads = 128;
  trace_rays_kernel<T><<<(R + threads - 1) / threads, threads, 0, stream>>>(
      (const T*)z, (const T*)p, (const T*)t, (const T*)q, (const T*)k,
      (const int*)nlev, (const T*)zmin, (const T*)zmax, (const T*)geo,
      (T*)oz, (T*)olon, (T*)olat, (T*)op, (T*)ot, (T*)oq, (T*)ok, (T*)ods,
      (T*)ou, (uint8_t*)ovalid, (int*)onp, (T*)otsurf, (T*)otpz,
      (T*)otplon, (T*)otplat, (int*)oflag, R, L, G, W, nlos, T(rayds),
      T(raydz), raydz > 0.0, refrac != 0, entry_iters, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: the profiles z, p, t [R, L], q [R, G, L], k [R, W, L], nlev
// [R] int32, zmin, zmax [R], the observation geometry [6, R] (obsz,
// obslon, obslat, vpz, vplon, vplat), then the outputs z, lon, lat, p, t
// [R, NLOS], q [R, NLOS, G], k [R, NLOS, W], ds, u ([R, NLOS], [R, NLOS,
// G]), valid [R, NLOS] bytes, np [R] int32, tsurf, tpz, tplon, tplat [R]
// and the bisection flag [R] int32.  is_double selects float64.
extern "C" int jt_trace_rays(
    const void* z, const void* p, const void* t, const void* q,
    const void* k, const void* nlev, const void* zmin, const void* zmax,
    const void* geo, void* oz, void* olon, void* olat, void* op, void* ot,
    void* oq, void* ok, void* ods, void* ou, void* ovalid, void* onp,
    void* otsurf, void* otpz, void* otplon, void* otplat, void* oflag, int R,
    int L, int G, int W, int nlos, double rayds, double raydz, int refrac,
    int entry_iters, double re, double deg2rad, double rad2deg, double kb,
    double z_refrac, int is_double, void* stream) {
  if (R < 1 || L < 1 || G < 0 || W < 0 || nlos < 3 || entry_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return launch<double>(z, p, t, q, k, nlev, zmin, zmax, geo, oz, olon,
                          olat, op, ot, oq, ok, ods, ou, ovalid, onp, otsurf,
                          otpz, otplon, otplat, oflag, R, L, G, W, nlos,
                          rayds, raydz, refrac, entry_iters, re, deg2rad,
                          rad2deg, kb, z_refrac, st);
  return launch<float>(z, p, t, q, k, nlev, zmin, zmax, geo, oz, olon, olat,
                       op, ot, oq, ok, ods, ou, ovalid, onp, otsurf, otpz,
                       otplon, otplat, oflag, R, L, G, W, nlos, rayds, raydz,
                       refrac, entry_iters, re, deg2rad, rad2deg, kb,
                       z_refrac, st);
}
