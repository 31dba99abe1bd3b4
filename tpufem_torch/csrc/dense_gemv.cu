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
// What bounds it on an H100: bytes.  M is read once, 2 n^2 bytes: 181 MB
// (0.054 ms at 3.35 TB/s) on the spoke 500k level (9,512 rows), 710 MB
// (0.212 ms) on elasticity P1's level 1 (18,840 rows), against 2 n^2
// flops (0.005 / 0.011 ms at 67 TFLOP/s).  Nothing else may cost more
// than streaming M.
//
// The design:
// - x, rounded to bfloat16, lives in shared memory (2 ld bytes: 19 KB at
//   9,512 rows, 37.7 KB at 18,840, 57 KB at the densify guard's cap of
//   28,377 rows; above 48 KB by the opt-in).  Every block rounds it from
//   float32 once, before it reads M; a 16-byte load of M (8 columns)
//   meets one 16-byte shared load of x, widened pairwise (bf16x2 ->
//   float2).
// - The grid is persistent: as many blocks as the SMs hold at once
//   (tpufem_dense_gemv_grid), kWarps warps each.  The 16-byte chunks of M,
//   numbered row-major, are cut into one contiguous run a warp, equal to
//   within one chunk: no tail wave, whatever n.  A warp walks its run row
//   piece by row piece, each lane taking every 32nd chunk with kUnroll
//   independent 16-byte loads in flight (streaming loads: M is read once).
// - No atomics.  A lane sums its chunks in order, a fixed butterfly of
//   shuffles sums the warp.  A row wholly inside one warp's run is written
//   to y; a row cut by a run boundary leaves a partial sum per piece in
//   `partials`, and a second small kernel adds them in warp order.  Every
//   y[r] is summed in the same order on every launch (of one grid size),
//   so two launches give the same bits.
// What a launch needs beside x, y and the stream is a DenseLaunch packed
// once per level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "strip_common.cuh"

namespace {

constexpr int kWarps = 8;  // tpufem_torch/fem/dense_gemv.py:_WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // 16-byte loads of M in flight a lane

// Everything a launch needs beside x, y and the stream, filled once per
// level (mirrored by tpufem_torch/_build.py:DenseLaunch).
struct DenseLaunch {
  const void* M;    // [n, ld] bfloat16
  void* partials;   // [2 * warps] float32: the head and tail piece sums
  int device, n, ld, blocks;
};

// The run of warp w of W over `total` chunks: [total w / W, total (w+1) / W)
// (tpufem_torch/fem/dense_gemv.py:dense_pieces).
__device__ __forceinline__ long long run_start(long long total, int w,
                                               int W) {
  return total * w / W;
}

__device__ __forceinline__ float dot8(const uint4 m, const uint4 xv,
                                      float acc) {
  const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(&m);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 mf = __bfloat1622float2(m2[j]);
    const float2 xf = __bfloat1622float2(x2[j]);
    acc = fmaf(mf.x, xf.x, acc);
    acc = fmaf(mf.y, xf.y, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
dense_gemv_bf16_kernel(const uint4* __restrict__ M,
                       const float* __restrict__ x, float* __restrict__ y,
                       float* __restrict__ partials, int n, int ld) {
  extern __shared__ uint4 xs4[];  // [ld / 8]: bf16(x), zero past n
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xs4);
  for (int c = threadIdx.x; c < ld; c += kThreads)
    xs[c] = __float2bfloat16_rn(c < n ? __ldg(x + c) : 0.0f);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarps;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long cpr = ld / 8;  // chunks a row
  const long long total = static_cast<long long>(n) * cpr;
  const long long c0 = run_start(total, w, W);
  const long long c1 = run_start(total, w + 1, W);
  if (c0 >= c1) return;  // more warps than chunks: nothing to do
  const long long rlast = (c1 - 1) / cpr;
  for (long long r = c0 / cpr; r <= rlast; ++r) {
    const long long rs = r * cpr;
    const int a = static_cast<int>((c0 > rs ? c0 : rs) - rs);
    const int b = static_cast<int>((c1 < rs + cpr ? c1 : rs + cpr) - rs);
    const uint4* row = M + rs;
    float acc = 0.0f;
    int k = a + lane;
    for (; k + 32 * (kUnroll - 1) < b; k += 32 * kUnroll) {
      uint4 m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m[u] = __ldcs(row + k + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        acc = dot8(m[u], xs4[k + 32 * u], acc);
    }
    for (; k < b; k += 32) acc = dot8(__ldcs(row + k), xs4[k], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane != 0) continue;
    if (a == 0 && b == cpr)
      y[r] = acc;                // the whole row
    else if (a > 0)
      partials[2 * w] = acc;     // head: a later piece of the run's first row
    else
      partials[2 * w + 1] = acc; // tail: the first piece of the last row
  }
}

// The second step: a warp whose run ends inside a row that it began sums
// that row's pieces in warp order (its tail, then the heads of the warps
// after it) into y.
__global__ void dense_gemv_bf16_combine(const float* __restrict__ partials,
                                        float* __restrict__ y, int n, int ld,
                                        int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const long long cpr = ld / 8;
  const long long total = static_cast<long long>(n) * cpr;
  const long long c0 = run_start(total, w, W);
  const long long c1 = run_start(total, w + 1, W);
  if (c0 >= c1) return;
  const long long r = (c1 - 1) / cpr;
  const long long rend = (r + 1) * cpr;
  if (c1 == rend || c0 > r * cpr) return;  // no tail piece
  float acc = partials[2 * w + 1];
  for (int v = w + 1; v < W; ++v) {
    const long long v1 = run_start(total, v + 1, W);
    if (run_start(total, v, W) >= v1) continue;  // an empty run
    acc += partials[2 * v];
    if (v1 >= rend) break;
  }
  y[r] = acc;
}

}  // namespace

extern "C" {

// Blocks of the persistent grid on `device` for rows of `ld` columns:
// the SMs times the blocks an SM holds with 2 ld bytes of shared memory
// each (or minus a CUDA error).  Raises the kernel's shared memory limit
// to the card's 227 KB once.
int tpufem_dense_gemv_grid(int device, int ld) {
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -static_cast<int>(scope.error());
  const size_t smem = 2 * static_cast<size_t>(ld);
  if (ld < 8 || ld % 8 != 0 || smem > tpufem::kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      dense_gemv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tpufem::kMaxSmem));
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_gemv_bf16_kernel, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

int tpufem_dense_gemv_bf16(const void* prepared, const void* x, void* y,
                           void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DenseLaunch& L = *static_cast<const DenseLaunch*>(prepared);
  if (L.M == nullptr || L.partials == nullptr || L.n < 1 || L.ld < L.n ||
      L.ld % 8 != 0 || L.blocks < 1 ||
      2 * static_cast<size_t>(L.ld) > tpufem::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = L.blocks * kWarps;
  dense_gemv_bf16_kernel<<<L.blocks, kThreads, 2 * L.ld, s>>>(
      static_cast<const uint4*>(L.M), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<float*>(L.partials), L.n, L.ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_gemv_bf16_combine<<<(W + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(L.partials), static_cast<float*>(y), L.n,
      L.ld, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
