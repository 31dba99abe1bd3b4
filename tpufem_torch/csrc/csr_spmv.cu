// CSR sparse matrix-vector product y = A x, for Hopper (sm_90a).
//
//   y[r] = sum_{e in [indptr[r], indptr[r + 1])} vals[e] * x[indices[e]]
//
// A is n x ncols with int32 indptr [n + 1] and int32 indices [nnz].  Value
// types: float32 and float64 (x and y in the same type), and bfloat16
// values with float32 x and y: x is rounded to bfloat16, each product is
// taken in float32 (exact: two 8-bit mantissas) and summed in float32, as
// tpufem's bf16 window twin does with preferred_element_type=f32
// (tpufem/fem/window_op.py:110-117).
//
// Replaces no Pallas kernel: tpufem's sparse operators of the unstructured
// path and of its SA-AMG are XLA programs (ELLMatrix.matvec,
// tpufem/fem/assemble.py:117, with its COO spill tail; the block-windowed
// WindowedMatrix.matvec, tpufem/fem/window_op.py:101), both layouts built
// around the TPU's gathers.  On the card every sparse operator of SA-AMG
// is CSR: the spoke mesh's fine operator, the assembled P and P^T, the
// sparse coarse levels and the factored P0 / P0^T of the cube.  The plain
// PyTorch version is tpufem_torch/fem/csr_spmv.py:csr_spmv_plain.
//
// What bounds it on an H100: bytes.  vals, indices and indptr are read
// once, x at least once and y written once: the spoke 500k fine matrix
// (7,004,731 entries, f32) moves 62 MB, 18.5 us at 3.35 TB/s, against
// 2 nnz flops.  The x gathers are random, but x (2 MB at 500k) lives in
// the 50 MB L2.
//
// The design, simple first: a group of G lanes per row (G a power of two
// from 2 to 32, at or above an eighth of the matrix's mean row length:
// tpufem_torch/fem/csr_spmv.py:lanes_for), lane l of a group summing
// entries l, l + G, ... of its row in order, then a fixed butterfly of
// shuffles over the group.  Few lanes a row let a warp walk many
// neighbouring rows, whose entries lie side by side: at 14 entries a row
// G = 2 ran twice as fast as G = 16 (scripts/csr_lanes.py).  Every y[r]
// is summed in the same order on every launch: the result is
// deterministic, with no atomics.  What a launch needs beside x, y and the
// stream is a CsrLaunch packed once per matrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;

// Everything a launch needs beside x, y and the stream, filled once per
// matrix (mirrored by tpufem_torch/_build.py:CsrLaunch).
struct CsrLaunch {
  const int* indptr;   // [n + 1]
  const int* indices;  // [nnz]
  const void* vals;    // [nnz] float, double or __nv_bfloat16
  int device, n, ncols, G;
};

__device__ __forceinline__ float load_val(const float* v, int e) {
  return __ldg(v + e);
}
__device__ __forceinline__ double load_val(const double* v, int e) {
  return __ldg(v + e);
}
__device__ __forceinline__ float load_val(const __nv_bfloat16* v, int e) {
  return __bfloat162float(v[e]);
}

// x as the product sees it: as given, or rounded to bfloat16 when the
// values are bfloat16
template <typename V, typename T>
__device__ __forceinline__ T load_x(const T* x, int c) {
  return __ldg(x + c);
}
template <>
__device__ __forceinline__ float load_x<__nv_bfloat16, float>(const float* x,
                                                              int c) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(x + c)));
}

// V: value type; T: the type of x, y and the sum
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ indptr,
                const int* __restrict__ indices, const V* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int n) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long row = t / G;
  const int lane = static_cast<int>(t % G);
  // every lane of a group reaches the shuffles: rows past the end sum 0
  T acc = T(0);
  if (row < n) {
    const int e1 = __ldg(indptr + row + 1);
    for (int e = __ldg(indptr + row) + lane; e < e1; e += G)
      acc = fma(static_cast<T>(load_val(vals, e)),
                load_x<V, T>(x, __ldg(indices + e)), acc);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
  if (row < n && lane == 0) y[row] = acc;
}

template <typename V, typename T, int G>
cudaError_t launch_g(const CsrLaunch& L, const void* x, void* y,
                     cudaStream_t stream) {
  const long long threads = static_cast<long long>(L.n) * G;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  csr_spmv_kernel<V, T, G><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      L.indptr, L.indices, static_cast<const V*>(L.vals),
      static_cast<const T*>(x), static_cast<T*>(y), L.n);
  return cudaGetLastError();
}

template <typename V, typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const CsrLaunch& L = *static_cast<const CsrLaunch*>(prepared);
  if (L.indptr == nullptr || L.n < 1 || L.ncols < 1 ||
      (L.vals == nullptr) != (L.indices == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (L.G) {
    case 1: err = launch_g<V, T, 1>(L, x, y, s); break;
    case 2: err = launch_g<V, T, 2>(L, x, y, s); break;
    case 4: err = launch_g<V, T, 4>(L, x, y, s); break;
    case 8: err = launch_g<V, T, 8>(L, x, y, s); break;
    case 16: err = launch_g<V, T, 16>(L, x, y, s); break;
    case 32: err = launch_g<V, T, 32>(L, x, y, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int tpufem_csr_spmv_f32(const void* prepared, const void* x, void* y,
                        void* stream) {
  return launch<float, float>(prepared, x, y, stream);
}

int tpufem_csr_spmv_f64(const void* prepared, const void* x, void* y,
                        void* stream) {
  return launch<double, double>(prepared, x, y, stream);
}

int tpufem_csr_spmv_bf16(const void* prepared, const void* x, void* y,
                         void* stream) {
  return launch<__nv_bfloat16, float>(prepared, x, y, stream);
}

}  // extern "C"
