// 16-byte asynchronous copies from global to shared memory (cp.async.cg:
// through L2, never L1, so a block reads what another SM wrote before the
// last grid barrier), shared by flat_interior.cu and strip_cg.cu.

#pragma once

#include <cuda_runtime.h>

namespace tpufem {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block can use on sm_90

// Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Waits for every copy this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tpufem
