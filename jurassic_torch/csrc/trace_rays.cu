// Ray tracer: one warp traces one ray through the spherical-shell
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
// What bounds it: the latency of one ray's chain of NLOS dependent steps
// (a step's position is the last step's).  The flagship's compulsory
// bytes take 8.4 us; a thread per ray, this kernel's first form, took
// 5.1-5.2 ms with its wrapper (allocation, geometry copy, launch), its
// five 46-level interval searches a step loading the levels one after
// the other from global memory, 1084 rays on 34 warps.  Now the wrapper
// takes under 0.8 ms, the kernel alone under 0.5 ms and on the busiest
// ray alone about 0.4 ms (PERF.md, the H100): the chain of about 1,900
// cycles a step, and 8 to 9 warps sharing each SM's schedulers.  The
// design shortens the chain and moves everything else off it:
//   * a warp per ray, its 32 lanes computing the chain redundantly, so
//     every lane holds the chain's bits and no shuffle carries them;
//   * the ray's profiles staged once in shared memory, coalesced;
//   * each interval search a count by warp vote, one chunk of 32 levels
//     a vote, the padding included: the linear loop's count, so the same
//     index on any grid (padding, ties, a non-monotone one); one vote a
//     chunk for the step's altitude and refraction's four;
//   * lane m interpolates altitude m (eip, lin, refractivity once, not
//     five times in every lane), a shuffle hands the refractivities on;
//   * float sqrt, reciprocal and division without nvcc's slow-path branch
//     (Ops below), so that independent ones overlap; a step where one is
//     out of its range runs again with the operations themselves;
//   * a stopped ray whose state is the last step's input repeats that
//     step's record (stopped rays sit at a fixed point of the escape clip;
//     most of the flagship's 159,594 inactive steps are such repeats);
//   * lane 0 records what the chain produces (the point, p, t, ds, the
//     interval index, valid) in shared memory; after the loop the lanes go
//     over the ray's points with coalesced stores: cart2geo's longitude
//     and latitude, the q and k interpolations at the recorded index, the
//     ds correction, the trapezoid rule and the column densities.  The
//     tangent point is lane 0's.
// A block traces one ray.  It needs (3 + G + W) L + 6 NLOS values and
// 5 NLOS bytes of shared memory (``ray_bytes``, which the launch and
// ``jt_trace_smem_bytes`` share; ``ops/trace.py`` refuses a ray over one
// block's 227 KB).
//
// The kernel allocates nothing and launches on the caller's stream.
#include "trace_common.cuh"

namespace {

using namespace jt_trace;

template <typename T, bool REFRAC>
__global__ void __launch_bounds__(32)
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
                      T rayds, T raydz, bool use_raydz, int entry_iters,
                      Consts<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, r = blockIdx.x;
  const RaySmem<T> m = carve<T>(smem, L, G, W, nlos);
  stage(m, r, L, G, W, pz_, pp_, pt_, pq_, pk_, lane, 32);
  __syncwarp();
  const Prof<T> pr{m.z, m.p, m.t, m.q, m.k, L, nlev_[r]};
  const RayStart<T> st =
      ray_start(geo, r, R, zmin_[r], zmax_[r], c, entry_iters);
  const T zmin = st.zmin, zmax = st.zmax;

  Ray<T> s = st.s;
  Ray<T> last = s;  // the input of the last step computed
  Rec<T> rec;
  NoLin nl;
  for (int ip = 0; ip < nlos; ++ip) {
    // A stopped ray whose state is bit for bit the last computed step's
    // input repeats that step: no input of a step that does not advance
    // the ray differs (ip only as ip > 0), so neither does its result.
    // Stopped rays reach such a fixed point at once.
    const bool repeat = ip >= 2 && s.stopped && last.stopped &&
                        same_bits(s.x, last.x) && same_bits(s.px, last.px) &&
                        same_bits(s.ex, last.ex) && same_bits(s.pz, last.pz);
    if (!repeat) {
      last = s;
      Ray<T> n = s;
      if (!__all_sync(FULL, step<Ops<T, false>, REFRAC>(
              n, rec, ip, pr, c, zmin, zmax, rayds, raydz, use_raydz, st.ok,
              lane, nl))) {
        n = s;  // a fast path out of range: the step with the operations
        step<Exact<T>, REFRAC>(n, rec, ip, pr, c, zmin, zmax, rayds, raydz,
                               use_raydz, st.ok, lane, nl);
      }
      s = n;
    }
    if (lane == 0) record(m, ip, rec);
  }
  __syncwarp();
  ray_finish(m, pr, s, st, out_z, out_lon, out_lat, out_p, out_t, out_q,
             out_k, out_ds, out_u, out_valid, out_np, out_tsurf, out_tpz,
             out_tplon, out_tplat, out_flag, r, G, W, nlos, c, lane);
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
  const size_t smem = ray_bytes<T>(L, G, W, nlos);
  auto kernel = refrac ? trace_rays_kernel<T, true>
                       : trace_rays_kernel<T, false>;
  // beyond the default a block opts in (the card refuses beyond its
  // 227 KB)
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Consts<T> c{T(re),       T(deg2rad),           T(rad2deg),
                    T(kb),       T(z_refrac),          T(__builtin_nan("")),
                    T(__builtin_huge_val())};
  kernel<<<R, 32, smem, stream>>>(
      (const T*)z, (const T*)p, (const T*)t, (const T*)q, (const T*)k,
      (const int*)nlev, (const T*)zmin, (const T*)zmax, (const T*)geo,
      (T*)oz, (T*)olon, (T*)olat, (T*)op, (T*)ot, (T*)oq, (T*)ok, (T*)ods,
      (T*)ou, (uint8_t*)ovalid, (int*)onp, (T*)otsurf, (T*)otpz,
      (T*)otplon, (T*)otplat, (int*)oflag, R, L, G, W, nlos, T(rayds),
      T(raydz), raydz > 0.0, entry_iters, c);
  return (int)cudaGetLastError();
}


// Ops<float, false> against the operations themselves: over every float x
// for sqrt and the reciprocal, over n_div pairs (a, b) for division (half
// with exponents uniform over all 256 fields, half within 2^-67..2^68,
// both sides of the range; signs and mantissas random; one a in 16 a
// signed zero): counts[6] += {sqrt in range, sqrt differing from sqrtf,
// rcp in range, rcp differing from 1.0f / x, div in range, div differing
// from a / b}, a difference meaning any bit.
__global__ void fast_ops_check_kernel(unsigned long long* counts,
                                      long long n_div,
                                      unsigned long long seed) {
  unsigned long long n[6] = {0, 0, 0, 0, 0, 0};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < (1ll << 32); i += stride) {
    const float x = __uint_as_float((unsigned)i);
    bool ok = true;
    const float y = Ops<float, false>::sqrt(x, ok);
    if (ok) {
      n[0] += 1;
      n[1] += __float_as_uint(y) != __float_as_uint(sqrtf(x));
    }
    ok = true;
    const float r = Ops<float, false>::rcp(x, ok);
    if (ok) {
      n[2] += 1;
      n[3] += __float_as_uint(r) != __float_as_uint(1.0f / x);
    }
  }
  for (long long i = first; i < n_div; i += stride) {
    const unsigned long long h = splitmix64(seed ^ (unsigned long long)i);
    const unsigned long long g = splitmix64(h);
    const bool wide = h & 1;
    const unsigned ga = g & 0xff, gb = (g >> 8) & 0xff;
    const unsigned ea = wide ? ga : 60 + ga % 135;
    const unsigned eb = wide ? gb : 60 + gb % 135;
    unsigned ua = ((unsigned)(h >> 1) & 0x807fffffu) | (ea << 23);
    const unsigned ub = ((unsigned)(h >> 33) & 0x807fffffu) | (eb << 23);
    if (((g >> 16) & 15) == 0) ua &= 0x80000000u;
    const float a = __uint_as_float(ua), b = __uint_as_float(ub);
    bool ok = true;
    const float q = Ops<float, false>::div(a, b, ok);
    if (ok) {
      n[4] += 1;
      n[5] += __float_as_uint(q) != __float_as_uint(a / b);
    }
  }
  for (int k = 0; k < 6; ++k) {
    unsigned long long v = n[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(counts + k, v);
  }
}

}  // namespace

// Pointers: the profiles z, p, t [R, L], q [R, G, L], k [R, W, L], nlev
// [R] int32, zmin, zmax [R], the observation geometry [6, R] (obsz,
// obslon, obslat, vpz, vplon, vplat), then the outputs z, lon, lat, p, t
// [R, NLOS], q [R, NLOS, G], k [R, NLOS, W], ds, u ([R, NLOS], [R, NLOS,
// G]), valid [R, NLOS] bytes, np [R] int32, tsurf, tpz, tplon, tplat [R]
// and the bisection flag [R] int32.  A block of one warp for each ray,
// with jt_trace_smem_bytes of shared memory.  is_double selects float64.
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

// The bytes of shared memory the kernel gives one ray (and so its block)
// at these sizes, into *bytes (long long).
extern "C" int jt_trace_smem_bytes(int L, int G, int W, int nlos,
                                   int is_double, void* bytes) {
  if (L < 1 || G < 0 || W < 0 || nlos < 0)
    return (int)cudaErrorInvalidValue;
  *(long long*)bytes = (long long)(is_double
                                       ? ray_bytes<double>(L, G, W, nlos)
                                       : ray_bytes<float>(L, G, W, nlos));
  return 0;
}

// The check of the branch-free float operations (fast_ops_check_kernel):
// counts [6] uint64, accumulated; n_div random pairs from seed.
extern "C" int jt_trace_fast_ops_check(void* counts, long long n_div,
                                       long long seed, void* stream) {
  if (n_div < 0) return (int)cudaErrorInvalidValue;
  fast_ops_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)counts, n_div, (unsigned long long)seed);
  return (int)cudaGetLastError();
}

// Registers and local memory (stack frame, spills included) of the
// instantiation a launch in that dtype and REFRAC takes: out int [2].
extern "C" int jt_trace_registers(int is_double, int refrac, void* out) {
  const void* f =
      is_double ? (refrac ? (const void*)trace_rays_kernel<double, true>
                          : (const void*)trace_rays_kernel<double, false>)
                : (refrac ? (const void*)trace_rays_kernel<float, true>
                          : (const void*)trace_rays_kernel<float, false>);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  ((int*)out)[0] = a.numRegs;
  ((int*)out)[1] = (int)a.localSizeBytes;
  return 0;
}
