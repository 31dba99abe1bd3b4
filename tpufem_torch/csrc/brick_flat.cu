// Flat stencil apply of a brick-AMG coarse level, for Hopper (sm_90a).
//
//   y[z, y, x'] = sum_{k < nf} F[k, z, y, x'] * x[z + dz_k, y + dy_k, x' + s_k]
//   (x read as 0 outside the [az, ay, W] grid, W = ax * m)
//
// A brick-AMG level (tpufem_torch/la/bramg.py) is a 27-point block stencil
// with m x m blocks on its aggregate lattice, flattened to scalar
// shift-diagonals on the [az, ay, ax * m] grid: the flat minor shift
// s = dx * m + j - i reaches component j of node x + dx from component i
// of node x, and the (dx, i, j) of equal s merge into one weight field on
// disjoint lanes.  m = 1 (Poisson) gives 27 fields, m = 6 (elasticity's
// rigid-body modes) up to 207.  The plan (dz, dy, s) of the nf fields is
// an int32 [nf, 3] table on the card.
//
// Replaces tpufem's flat_apply (tpufem/la/bramg.py:163-175), which XLA
// runs: tpufem has no Pallas kernel for it.  The plain PyTorch version is
// tpufem_torch/la/brick_flat.py:brick_flat_apply_plain.
//
// What bounds it on an H100: bytes.  Every field is read once, x and y
// once each: at the m = 6 level of the 468,195-dof elasticity hierarchy
// ([22, 17, 102], 207 fields) 31.9 MB, 9.5 us at 3.35 TB/s, against one
// multiply-add per field and point (7.9 MFLOP); at the m = 1 levels 1-2
// MB.  A level's fields fit the 50 MB L2, so applies that follow one
// another may run under the HBM bound.
//
// The design, simple first: one thread per output point, threads along x'
// (the fields' and x's minor axis, so every field read is coalesced), a
// block stages the plan once in shared memory as (dz, dy, s, flat offset)
// and every thread walks it in plan order.  A term is rounded as the
// plain version rounds it: the product, then the sum (no fused
// multiply-add), so the kernel gives the plain version's bits.  What a
// launch needs beside x, y and the stream is a BrickFlatLaunch packed once
// per level.

#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 4096;  // tpufem_torch/la/brick_flat.py:MAX_FIELDS

// Everything a launch needs beside x, y and the stream, filled once per
// level (mirrored by tpufem_torch/_build.py:BrickFlatLaunch).
struct BrickFlatLaunch {
  const void* F;     // [nf, az, ay, W] weight fields
  const int* plan;   // [nf, 3] (dz, dy, s)
  int device, az, ay, W, nf;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
brick_flat_kernel(const T* __restrict__ x, const T* __restrict__ F,
                  const int* __restrict__ plan, T* __restrict__ y, int az,
                  int ay, int W, int nf) {
  extern __shared__ int4 ent[];  // [nf] (dz, dy, s, flat offset)
  for (int k = threadIdx.x; k < nf; k += kThreads) {
    const int dz = plan[3 * k], dy = plan[3 * k + 1], s = plan[3 * k + 2];
    ent[k] = make_int4(dz, dy, s, (dz * ay + dy) * W + s);
  }
  __syncthreads();
  const long long n = static_cast<long long>(az) * ay * W;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const int ix = static_cast<int>(i % W);
  const long long zy = i / W;
  const int iy = static_cast<int>(zy % ay);
  const int iz = static_cast<int>(zy / ay);
  T acc = T(0);
  for (int k = 0; k < nf; ++k) {
    const int4 e = ent[k];
    const bool in = static_cast<unsigned>(iz + e.x) < static_cast<unsigned>(az) &&
                    static_cast<unsigned>(iy + e.y) < static_cast<unsigned>(ay) &&
                    static_cast<unsigned>(ix + e.z) < static_cast<unsigned>(W);
    const T v = in ? __ldg(x + (i + e.w)) : T(0);
    const T t = mul_rn(__ldg(F + k * n + i), v);
    acc = k == 0 ? t : add_rn(acc, t);
  }
  y[i] = acc;
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const BrickFlatLaunch& L = *static_cast<const BrickFlatLaunch*>(prepared);
  if (L.F == nullptr || L.plan == nullptr || L.az < 1 || L.ay < 1 ||
      L.W < 1 || L.nf < 1 || L.nf > kMaxFields)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(L.az) * L.ay * L.W;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const size_t smem = static_cast<size_t>(L.nf) * sizeof(int4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        brick_flat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  brick_flat_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.F), L.plan,
      static_cast<T*>(y), L.az, L.ay, L.W, L.nf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_brick_flat_f32(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_brick_flat_f64(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
