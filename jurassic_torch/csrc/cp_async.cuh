// cp.async of 16, 8 or 4 bytes from global to shared memory, and its
// groups (sm_80 and newer): the copies of the tangent kernels' rings
// (ega_jvp_fast.cu, trace_rays_jvp.cu).  dst is a shared-memory address
// (__cvta_generic_to_shared).
#pragma once

#include <cuda_runtime.h>

namespace jt_cp {

__device__ __forceinline__ void cp16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp8(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace jt_cp
