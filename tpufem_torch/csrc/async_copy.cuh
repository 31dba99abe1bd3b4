// Asynchronous copies from global to shared memory, shared by the
// kernels: 16 bytes at a time (cp.async.cg: through L2, never L1, so a
// block reads what another SM wrote before the last grid barrier), or one
// 4- or 8-byte value where the source is not 16-byte aligned (or zeros in
// its place).

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

// One float or double, naturally aligned (cp.async.ca: 4 or 8 bytes).
template <typename T>
__device__ __forceinline__ void cp_async_value(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "float or double");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
}

// The same, or zeros where !ok (a source size of 0: gmem is not read, but
// must still be a valid address).
template <typename T>
__device__ __forceinline__ void cp_async_value_or_zero(T* smem, const T* gmem,
                                                       bool ok) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "float or double");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned bytes = ok ? sizeof(T) : 0u;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes)
                 : "memory");
  }
}

// Waits for every copy this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tpufem
