// Dense matrix-vector product of a bfloat16 SA-AMG level, for Hopper
// (sm_90a).
//
//   y[r] = sum_{c < n} M[r, c] * bf16(x[c])     (y, x float32)
//
// M is bfloat16 [n, ld] row-major, ld = n rounded up to 8 (zero padding),
// so that every row starts on a 16-byte boundary.  x is rounded to
// bfloat16, each product is taken in float32 (exact: two 8-bit mantissas)
// and the sum is float32, and y stays float32.  This is tpufem's f32-solve
// DenseMat.matvec (tpufem/la/amg.py:417-423: jnp.matmul of the bf16 level
// with bf16 x, preferred_element_type=f32), which XLA runs: tpufem has no
// Pallas kernel for it.  torch.matmul of two bfloat16 operands returns
// bfloat16, which would round y once more than tpufem does: a different
// preconditioner.  The plain PyTorch version is
// tpufem_torch/fem/dense_gemv.py:dense_gemv_bf16_plain.
//
// What bounds it on an H100: bytes.  M is read once, 2 n^2 bytes: the
// 1.5 GiB cap of tpufem's densify guard is n = 27.7 k, 1.5 GB or 0.46 ms
// at 3.35 TB/s, against 2 n^2 flops (1.5 GFLOP, 0.02 ms at 67 TFLOP/s).
//
// The design, simple first: a warp per row, each lane loading 8 values
// (16 bytes) of the row at a time, so that a warp reads 512 contiguous
// bytes per step, and the matching 8 values of x (two 16-byte loads, from
// L1 / L2: x is at most 111 KB); a lane sums its products in order, then
// a fixed butterfly of shuffles sums the warp.  Every y[r] is summed in the
// same order on every launch.  What a launch needs beside x, y and the
// stream is a DenseLaunch packed once per level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;

// Everything a launch needs beside x, y and the stream, filled once per
// level (mirrored by tpufem_torch/_build.py:DenseLaunch).
struct DenseLaunch {
  const void* M;  // [n, ld] bfloat16
  int device, n, ld;
};

__global__ void __launch_bounds__(kThreads)
dense_gemv_bf16_kernel(const __nv_bfloat16* __restrict__ M,
                       const float* __restrict__ x, float* __restrict__ y,
                       int n, int ld) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  const uint4* mrow = reinterpret_cast<const uint4*>(M + row * ld);
  const int chunks = ld / 8;
  float acc = 0.0f;
  for (int k = lane; k < chunks; k += 32) {
    const uint4 raw = __ldg(mrow + k);
    const __nv_bfloat16* m = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const int c0 = 8 * k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      const float xv =
          c < n ? __bfloat162float(__float2bfloat16_rn(__ldg(x + c))) : 0.0f;
      acc = fmaf(__bfloat162float(m[j]), xv, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" {

int tpufem_dense_gemv_bf16(const void* prepared, const void* x, void* y,
                           void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DenseLaunch& L = *static_cast<const DenseLaunch*>(prepared);
  if (L.M == nullptr || L.n < 1 || L.ld < L.n || L.ld % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const unsigned blocks = static_cast<unsigned>((L.n + kWarps - 1) / kWarps);
  dense_gemv_bf16_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(L.M), static_cast<const float*>(x),
      static_cast<float*>(y), L.n, L.ld);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
