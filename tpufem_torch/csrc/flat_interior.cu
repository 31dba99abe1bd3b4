// Channel-plane P2/P3 interior product for Hopper (sm_90a).
//
// Replaces the TPU kernel K5, tpufem/fem/flat_op.py:308
// FlatOperator._interior_pallas (pallas_call at :367).  On a plane buffer
// x, y [Zp, CP, LW] (plane bp, channel c, lane l), for every buffer plane
// 1 <= bp <= Zc and every lane l = G + t, t < TILE:
//
//   y[bp, co, l] = sum_j sum_ci WT_bp[co, j * CP + ci]
//                             * x[clip(bp + dz_j, 0, Zp - 1), ci, l + off_j]
//
// with WT_bp = W0 + AZT[slot_of[bp - 1]] where that slot is >= 0 (the 7
// z-boundary planes) and W0 elsewhere; every other plane and the guard
// lanes are written as zeros (the caller allocates y with torch.empty,
// and a NaN left there would survive the fmask product).  The plain
// PyTorch version is tpufem_torch/fem/flat_op.py:FlatOperator.
// interior_plain.
//
// What bounds it on an H100: operations.  The TPU kernel's product is
// 2 CP K TILE flops per valid plane, twice on the delta planes: at the
// 500k-dof P3 operator (CP = 32, K = 480, TILE = 768, Zc = 33) 0.944
// GFLOP, ~14 us at 67 TFLOP/s of FP32, against ~9.9 MB of x, y and
// weights (~3 us at 3.35 TB/s).  tpufem runs the product at
// Precision.HIGHEST, so this kernel uses FP32 (FP64) FMA only: TF32 would
// keep ~3 digits and break the float32 parity.
//
// The design, simple first: one block per (buffer plane, 128 lanes), a
// thread per lane and group of 8 output channels (blockDim (128, CP / 8)),
// 8 accumulators in registers.  The block sums its plane's WT_bp once into
// shared memory, transposed to [K][CP] so a thread reads its 8 weights of
// one k as 16-byte broadcast loads (61 KB at P3 in f32, 123 KB in f64:
// dynamic shared memory above the 48 KB default).  Source reads
// x[zi, ci, l + off_j] coalesce along lanes and come from L1/L2 (x is
// 1-4 MB).  Tensor-core products (3xTF32 or wgmma) and reuse of a source
// plane across the planes that read it are later work.

#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kGroup = 8;         // output channels per thread
constexpr int kMaxCP = 32;        // blockDim.y = CP / 8 <= 4
constexpr int kMaxShifts = 32;
constexpr int kMaxDevices = 64;

struct FlatShape {
  int CP, K, D, Zc, ZB, Zp, LW, TILE, G, NZP;
  int dz[kMaxShifts];
  int off[kMaxShifts];
};

// 8 consecutive shared-memory weights as 16-byte loads (8-aligned offset).
template <typename T>
__device__ __forceinline__ void load8(const T* p, T (&w)[kGroup]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
    const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double2 a = q[i];
      w[2 * i] = a.x;
      w[2 * i + 1] = a.y;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxCP / kGroup)
flat_interior_kernel(const T* __restrict__ x, const T* __restrict__ W0,
                     const T* __restrict__ AZT,
                     const int* __restrict__ slot_of, FlatShape S,
                     T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wt = reinterpret_cast<T*>(smem_raw);  // [K][CP]
  const int bp = blockIdx.y;
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const int co0 = kGroup * threadIdx.y;
  T* out = y + (static_cast<size_t>(bp) * S.CP + co0) * S.LW + lane;
  // G and TILE are multiples of 128, so a block is all body or all guard
  const bool body = bp >= 1 && bp <= S.Zc && blockIdx.x * kLanes >= S.G &&
                    blockIdx.x * kLanes < S.G + S.TILE;
  if (!body) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) out[static_cast<size_t>(q) * S.LW] = T(0);
    return;
  }
  const int slot = __ldg(slot_of + bp - 1);
  const T* dlt = slot >= 0 ? AZT + static_cast<size_t>(slot) * S.CP * S.K
                           : nullptr;
  const int nthr = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < S.CP * S.K;
       i += nthr) {
    const int co = i / S.K;
    const int k = i - co * S.K;
    T w = __ldg(W0 + i);
    if (dlt != nullptr) w += __ldg(dlt + i);
    wt[k * S.CP + co] = w;
  }
  __syncthreads();

  T acc[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) acc[q] = T(0);
  for (int j = 0; j < S.D; ++j) {
    const int zi = min(max(bp + S.dz[j], 0), S.Zp - 1);
    const T* src = x + static_cast<size_t>(zi) * S.CP * S.LW + lane + S.off[j];
    const T* wj = wt + static_cast<size_t>(j) * S.CP * S.CP + co0;
#pragma unroll 4
    for (int ci = 0; ci < S.CP; ++ci) {
      const T v = __ldg(src + static_cast<size_t>(ci) * S.LW);
      T w[kGroup];
      load8(wj + ci * S.CP, w);
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc[q] = fma(w[q], v, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kGroup; ++q) out[static_cast<size_t>(q) * S.LW] = acc[q];
}

// Raises the kernel's dynamic shared-memory limit on the current device
// once to at least `smem` bytes (the attribute call costs host time).
template <typename T>
cudaError_t allow_smem(int device, size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flat_interior_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

template <typename T>
int launch(int device, const void* x, const void* W0, const void* AZT,
           const int* slot_of, void* y, int CP, int K, int D, const int* dz,
           const int* off, int Zc, int ZB, int Zp, int LW, int TILE, int G,
           int NZP, void* stream) {
  if (CP <= 0 || CP % kGroup != 0 || CP > kMaxCP || D <= 0 ||
      D > kMaxShifts || K != D * CP || Zc <= 0 || ZB < Zc || Zp < Zc + 2 ||
      NZP <= 0 || G <= 0 || G % kLanes != 0 || TILE <= 0 ||
      TILE % kLanes != 0 || LW % kLanes != 0 || LW < G + TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  FlatShape S{CP, K, D, Zc, ZB, Zp, LW, TILE, G, NZP, {}, {}};
  for (int j = 0; j < D; ++j) {
    if (dz[j] < -1 || dz[j] > 1 || G + off[j] < 0 || G + off[j] + TILE > LW)
      return static_cast<int>(cudaErrorInvalidValue);
    S.dz[j] = dz[j];
    S.off[j] = off[j];
  }
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const size_t smem = static_cast<size_t>(K) * CP * sizeof(T);
  const cudaError_t err = allow_smem<T>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(LW / kLanes, Zp);
  const dim3 block(kLanes, CP / kGroup);
  flat_interior_kernel<T><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(W0),
      static_cast<const T*>(AZT), slot_of, S, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_flat_interior_f32(int device, const void* x, const void* W0,
                             const void* AZT, const int* slot_of, void* y,
                             int CP, int K, int D, const int* dz,
                             const int* off, int Zc, int ZB, int Zp, int LW,
                             int TILE, int G, int NZP, void* stream) {
  return launch<float>(device, x, W0, AZT, slot_of, y, CP, K, D, dz, off, Zc,
                       ZB, Zp, LW, TILE, G, NZP, stream);
}

int tpufem_flat_interior_f64(int device, const void* x, const void* W0,
                             const void* AZT, const int* slot_of, void* y,
                             int CP, int K, int D, const int* dz,
                             const int* off, int Zc, int ZB, int Zp, int LW,
                             int TILE, int G, int NZP, void* stream) {
  return launch<double>(device, x, W0, AZT, slot_of, y, CP, K, D, dz, off, Zc,
                        ZB, Zp, LW, TILE, G, NZP, stream);
}

}  // extern "C"
