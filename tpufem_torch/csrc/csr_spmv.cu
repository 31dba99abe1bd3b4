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
// the 50 MB L2.  On the transfers (P0: 510,705 rows of one entry, 8 MB)
// the bound is a few microseconds, and the launch and the round trips to
// memory that each block waits on are most of the time.
//
// The design: the entries, not the rows, are cut into tiles of kTile; a
// block takes a tile.
// - Work is even whatever the rows: a tile costs the same on P0 (one
//   entry a row), the fine matrix (14) or P^T (155, uneven).
// - A sub-run is kSub consecutive entries, one 16-byte load of indices
//   beside the load of their values; lane l of warp w takes the tile's
//   sub-runs w 32 S + 32 q + l, q < S, so that a warp's load reads 32
//   neighbouring sub-runs.  A block is 256 threads of 4 entries for
//   4- and 2-byte values, 128 of 8 for 8-byte ones (float64).  Every
//   gather from x of a thread is issued before its first product, and no
//   branch stands between a load and its product.
// - Rows: the plan (tpufem_torch/fem/csr_spmv.py:csr_plan, built once per
//   matrix on the host) holds each tile's first row and a bit for every
//   entry that begins a row.  The bits come with the tile's entries, so a
//   sub-run's running sums (restarted at each row start) need no indptr;
//   the tile's slice of indptr, staged in shared memory meanwhile, then
//   gives each row the sub-runs it spans, and the row's sum is their
//   tails in order.  Tile t writes the rows that begin in it, empty ones
//   too.
// - A row that runs on past its tile (P^T's long rows, and at tile edges
//   the others) is finished by its own tile: the entries just past the
//   tile (one a thread) are loaded and gathered with the tile's own, so
//   the block waits on two round trips to memory, as for any row; a
//   longer remainder is read in a loop.  Every y[r] is summed in the
//   same order on every launch: the same bits, with no atomics and no
//   second launch.
// What a launch needs beside x, y and the stream is a CsrLaunch packed
// once per matrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "strip_common.cuh"

namespace {

constexpr int kTile = 1024;  // entries a tile: fem/csr_spmv.py:TILE
constexpr int kSub = 4;      // entries a sub-run

// Everything a launch needs beside x, y and the stream, filled once per
// matrix (mirrored by tpufem_torch/_build.py:CsrLaunch).
struct CsrLaunch {
  const int* indptr;           // [n + 1]
  const int* indices;          // [nnz]
  const void* vals;            // [nnz] float, double or __nv_bfloat16
  const unsigned int* starts;  // bit e: a row begins at entry e
  const int* tile_row;         // [tiles + 1]: tile t's first row; [tiles] = n
  int device, n, ncols, nnz, tiles;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// N elements of E from `p` (aligned to N * sizeof(E) bytes, up to 16) in
// vector loads of at most 16 bytes
template <typename E, int N>
__device__ __forceinline__ void load_run(const E* __restrict__ p, E (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(E));
  static_assert(kBytes % 8 == 0, "a run is whole 8-byte words");
  if constexpr (kBytes % 16 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(out)[i] = __ldg(q + i);
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      reinterpret_cast<uint2*>(out)[i] = __ldg(q + i);
  }
}

// threads a block: 128 for 8-byte values, else 256
template <typename V>
__host__ __device__ constexpr int threads_for() {
  return sizeof(V) == 8 ? 128 : 256;
}

// V: value type; T: the type of x, y and the sum
template <typename V, typename T>
__global__ void __launch_bounds__(threads_for<V>())
csr_spmv_kernel(const CsrLaunch L, const T* __restrict__ x,
                T* __restrict__ y) {
  constexpr int NT = threads_for<V>();
  constexpr int S = kTile / (NT * kSub);  // sub-runs a thread
  constexpr int kWarps = NT / 32;
  __shared__ __align__(16) T sums[kTile];  // the sub-runs' running sums
  __shared__ int ip[kTile + 1];            // indptr[r_lo ...]
  __shared__ T after[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = t * kTile;
  const int len = min(kTile, L.nnz - s);  // entries of this tile
  // the rows that begin in the tile (and the empty rows among them)
  const int r_lo = __ldg(L.tile_row + t), r_hi = __ldg(L.tile_row + t + 1);
  const V* __restrict__ vals = static_cast<const V*>(L.vals);

  // the sub-runs: vals, indices and row-start bits, then every gather
  // from x; and the entry kTile + tid past the tile's start, for a row
  // that runs on past the tile
  alignas(16) V v[S][kSub];
  alignas(16) int c[S][kSub];
  unsigned int bits[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int a = (warp * 32 * S + 32 * q + lane) * kSub;
    if (len == kTile) {
      load_run<V, kSub>(vals + s + a, v[q]);
      load_run<int, kSub>(L.indices + s + a, c[q]);
    } else {
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const bool in = a + k < len;
        v[q][k] = in ? vals[s + a + k] : V{};
        c[q][k] = in ? __ldg(L.indices + s + a + k) : 0;
      }
    }
    bits[q] = (__ldg(L.starts + (s + a) / 32) >> ((s + a) % 32)) &
              ((1u << kSub) - 1);
  }
  const int e_win = s + kTile + tid;
  const bool in_win = e_win < L.nnz;
  const V wv = in_win ? vals[e_win] : V{};
  const int wc = in_win ? __ldg(L.indices + e_win) : 0;
  T xv[S][kSub];
#pragma unroll
  for (int q = 0; q < S; ++q)
#pragma unroll
    for (int k = 0; k < kSub; ++k) xv[q][k] = load_x<V, T>(x, c[q][k]);
  const T wx = load_x<V, T>(x, wc);
  // the tile's slice of indptr
  const int owned = r_hi - r_lo;
  const int staged = min(owned + 1, kTile + 1);
  for (int i = tid; i < staged; i += NT) ip[i] = __ldg(L.indptr + r_lo + i);
  const int e_next = __ldg(L.indptr + r_hi);  // the last row's end

  // each sub-run's running sums, restarted at each row start
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int a = (warp * 32 * S + 32 * q + lane) * kSub;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      acc = fma(static_cast<T>(widen(v[q][k])), xv[q][k],
                (bits[q] >> k) & 1u ? T(0) : acc);
      sums[a + k] = acc;
    }
  }
  // the last row's entries past the tile: a thread sums every NT-th in
  // order, then the warps' sums
  if (owned > 0 && e_next > s + len) {
    T w = e_win < e_next ? fma(static_cast<T>(widen(wv)), wx, T(0)) : T(0);
    for (int e = e_win + NT; e < e_next; e += NT)
      w = fma(static_cast<T>(widen(vals[e])),
              load_x<V, T>(x, __ldg(L.indices + e)), w);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w += __shfl_xor_sync(0xffffffffu, w, off);
    if (lane == 0) after[warp] = w;
  }
  __syncthreads();

  // the rows [r_lo, r_hi): the tails of the sub-runs each spans, in order
  for (int i = tid; i < owned; i += NT) {
    const int e0 = i < staged ? ip[i] : __ldg(L.indptr + r_lo + i);
    const int e1 = i + 1 < staged ? ip[i + 1] : __ldg(L.indptr + r_lo + i + 1);
    T sum = T(0);
    if (e1 > e0) {
      const int lo = e0 - s, hi = min(e1 - s, len);
      const int j1 = (hi - 1) / kSub;
      int j = lo / kSub;
      if (j < j1) {
        sum = sums[j * kSub + kSub - 1];
        for (++j; j < j1; ++j) sum += sums[j * kSub + kSub - 1];
        sum += sums[hi - 1];
      } else {
        sum = sums[hi - 1];
      }
      if (e1 > s + len) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += after[w];
      }
    }
    y[r_lo + i] = sum;
  }
}

template <typename V, typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const CsrLaunch& L = *static_cast<const CsrLaunch*>(prepared);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  const long long tiles = L.nnz > 0 ? (L.nnz + kTile - 1LL) / kTile : 1;
  if (L.indptr == nullptr || L.starts == nullptr || L.tile_row == nullptr ||
      L.n < 1 || L.ncols < 1 || L.nnz < 0 || L.nnz > INT_MAX - 2 * kTile ||
      L.tiles != tiles ||
      (L.nnz > 0 && (L.vals == nullptr || L.indices == nullptr ||
                     misaligned(L.vals) || misaligned(L.indices))))
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  csr_spmv_kernel<V, T>
      <<<L.tiles, threads_for<V>(), 0, static_cast<cudaStream_t>(stream)>>>(
          L, static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
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
