// Peak-rate probes for NVIDIA Hopper (sm_90a): what the card can execute
// and move, measured, as the yardstick for the EGA kernels' bounds.
//
// Replaces the Pallas TPU probes tools/vpu_peak.py::_fma_kernel and
// ::_exp_kernel (NACC independent chains on [8, 256] vector registers
// inside a fori_loop, zero memory traffic).  The same idea per thread:
//
//   * fma probe: NACC independent float32 chains acc = fma(acc, x, c) per
//     thread, INNER steps of every chain per loop iteration, fully
//     unrolled, so the FP32 pipes always have an independent instruction
//     to run.  The explicit __fmaf_rn intrinsic, because the library is
//     built with -fmad=false (ops/_build.py) and a * b + c would not fuse;
//   * sfu probe: the same harness on the special-function unit, one of
//     acc = __expf(-acc) (the recurrence of _exp_kernel),
//     acc = ex2.approx(-acc), acc = lg2.approx(acc + 1.5) (ex2.approx and
//     lg2.approx are what the exp2f/log2f/expf/logf of the EGA kernels
//     execute).  These maps contract to a fixed point (by 0.57, 0.44 and
//     0.46 per step), so only SFU_INNER = 8 steps are unrolled per loop
//     iteration: after one or two iterations the chains are still far
//     enough from the fixed point that a wrong step count shows against
//     the plain version.  The special-function unit issues a quarter of
//     the FP32 rate, so the shorter body costs it nothing;
//   * copy probe: a grid-stride float4 copy of a buffer far larger than
//     the 50 MB L2, each byte read once and written once.
//
// Every chain starts from a caller-given value and writes its accumulator
// out, so each probe is a function of its inputs that the plain PyTorch
// version (jurassic_torch/tools/peak.py) repeats at a small loop count.
// The rates come from timing two loop counts and dividing the extra work
// by the extra time (tools/vpu_peak.py:96-103), which cancels launch and
// tail effects.  Bound: by construction the fma and sfu probes are bound
// by instruction throughput and the copy probe by HBM bytes.
//
// C interface (loaded with ctypes): each function launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NACC = 8;      // independent chains per thread
constexpr int INNER = 32;    // fma steps of every chain per loop iteration
constexpr int SFU_INNER = 8; // sfu steps of every chain per loop iteration
constexpr int THREADS = 256;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[t, j] <- fma(acc[t, j], x, c), loops * INNER times
__global__ void __launch_bounds__(THREADS)
fma_probe(const float* __restrict__ init, float* __restrict__ out, float x,
          float c, int loops) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = init[t * NACC + j];
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < INNER; ++k) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = __fmaf_rn(acc[j], x, c);
    }
  }
#pragma unroll
  for (int j = 0; j < NACC; ++j) out[t * NACC + j] = acc[j];
}

// OP 0: acc <- __expf(-acc); 1: acc <- ex2.approx(-acc);
// 2: acc <- lg2.approx(acc + 1.5); loops * SFU_INNER times
template <int OP>
__global__ void __launch_bounds__(THREADS)
sfu_probe(const float* __restrict__ init, float* __restrict__ out,
          int loops) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = init[t * NACC + j];
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < SFU_INNER; ++k) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        if (OP == 0) acc[j] = __expf(-acc[j]);
        if (OP == 1) acc[j] = ex2_approx(-acc[j]);
        if (OP == 2) acc[j] = lg2_approx(acc[j] + 1.5f);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NACC; ++j) out[t * NACC + j] = acc[j];
}

// dst[i] <- src[i], i < n4 float4 words
__global__ void __launch_bounds__(THREADS)
copy_probe(const float4* __restrict__ src, float4* __restrict__ dst,
           size_t n4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride)
    dst[i] = src[i];
}

}  // namespace

// init, out: [blocks * 256 * 8] float32
extern "C" int jt_peak_fma(const void* init, void* out, float x, float c,
                           int loops, int blocks, void* stream) {
  if (blocks < 1 || loops < 0) return (int)cudaErrorInvalidValue;
  fma_probe<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)init, (float*)out, x, c, loops);
  return (int)cudaGetLastError();
}

extern "C" int jt_peak_sfu(const void* init, void* out, int op, int loops,
                           int blocks, void* stream) {
  if (blocks < 1 || loops < 0 || op < 0 || op > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* i = (const float*)init;
  float* o = (float*)out;
  if (op == 0) sfu_probe<0><<<blocks, THREADS, 0, st>>>(i, o, loops);
  if (op == 1) sfu_probe<1><<<blocks, THREADS, 0, st>>>(i, o, loops);
  if (op == 2) sfu_probe<2><<<blocks, THREADS, 0, st>>>(i, o, loops);
  return (int)cudaGetLastError();
}

// src, dst: 16-byte aligned, n4 float4 words each
extern "C" int jt_peak_copy(const void* src, void* dst, long long n4,
                            int blocks, void* stream) {
  if (blocks < 1 || n4 < 0) return (int)cudaErrorInvalidValue;
  copy_probe<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)src, (float4*)dst, (size_t)n4);
  return (int)cudaGetLastError();
}
