// Channel-strip P2/P3 stencil apply y = A x for Hopper (sm_90a).
//
// Replaces the TPU kernel K3, tpufem/fem/strip_op.py:300
// StripOperator._apply_pallas (pallas_call at :349): per output channel
// co, the mid strips times the source strips shifted by (dz planes,
// dy * Xp + dx lanes) over the channel's whole z range, plus the sparse
// z-boundary delta rows; pad, guard and out-of-extent planes written as
// zeros.  The plan arrives as int32 CSR tables (strip_common.cuh), built
// once per operator; the plain PyTorch version is
// tpufem_torch/fem/strip_op.py:StripOperator.apply_strips_plain.
//
// What bounds it on an H100: bytes.  One apply must read x once, the
// weight packs once and write y once: at the 500k-dof P3 operator (C=27
// channels, [27, 35, 1024] f32 buffers, 1311 mid + 732 delta strips of
// 768) that is 3.87 + 6.28 + 3.87 MB ~ 14 MB, ~4.2 us at 3.35 TB/s,
// against ~66 MFLOP (~1 us at 67 TFLOP/s of f32).
//
// The design, simple first: one thread per element of y, a block per
// 128 lanes of one (channel, plane) row, so every thread of a block walks
// the same plan entries (uniform loop, broadcast table loads) and the
// loads of each shifted source row and of each weight strip coalesce.
// The ~48 source rows an output row reads come from L1/L2, not from
// device memory; x (~4 MB) and the packs (~6 MB) stay in the 50 MB L2.
// Register tiling across z planes, shared-memory staging of the source
// planes and a smaller padding are later work.

#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

using tpufem::StripPlan;

constexpr int kLanes = 128;

template <typename T>
__global__ void __launch_bounds__(kLanes)
strip_apply_kernel(const T* __restrict__ x, const T* __restrict__ mid,
                   const T* __restrict__ dlt, StripPlan P, T* __restrict__ y) {
  const int row = blockIdx.y;  // co * Zp + plane
  const int co = row / P.Zp;
  const int z = row - co * P.Zp - 1;
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const int t = lane - P.G;
  T v = T(0);
  if (z >= 0 && z < __ldg(P.zk + co) && t >= 0 && t < P.TILE) {
    v = tpufem::mid_terms<T, false>(x, mid, P, co, z, t);
    v = tpufem::delta_terms<T, false>(v, x, dlt, P, co, z, t);
  }
  y[static_cast<size_t>(row) * P.LW + lane] = v;
}

template <typename T>
int launch(int device, const void* x, const void* mid, const void* dlt,
           const int* mid_ptr, const int* mid_ent, const int* dlt_ptr,
           const int* dlt_ent, const int* zk, void* y, int C, int Zc, int Zp,
           int LW, int TILE, int G, void* stream) {
  const StripPlan P{mid_ptr, reinterpret_cast<const int4*>(mid_ent),
                    dlt_ptr, reinterpret_cast<const int4*>(dlt_ent), zk,
                    C, Zc, Zp, LW, TILE, G};
  if (!tpufem::plan_ok(P) || static_cast<long long>(C) * Zp > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const dim3 grid(LW / kLanes, C * Zp);
  strip_apply_kernel<T><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(mid),
      static_cast<const T*>(dlt), P, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_strip_apply_f32(int device, const void* x, const void* mid,
                           const void* dlt, const int* mid_ptr,
                           const int* mid_ent, const int* dlt_ptr,
                           const int* dlt_ent, const int* zk, void* y, int C,
                           int Zc, int Zp, int LW, int TILE, int G,
                           void* stream) {
  return launch<float>(device, x, mid, dlt, mid_ptr, mid_ent, dlt_ptr,
                       dlt_ent, zk, y, C, Zc, Zp, LW, TILE, G, stream);
}

int tpufem_strip_apply_f64(int device, const void* x, const void* mid,
                           const void* dlt, const int* mid_ptr,
                           const int* mid_ent, const int* dlt_ptr,
                           const int* dlt_ent, const int* zk, void* y, int C,
                           int Zc, int Zp, int LW, int TILE, int G,
                           void* stream) {
  return launch<double>(device, x, mid, dlt, mid_ptr, mid_ent, dlt_ptr,
                        dlt_ent, zk, y, C, Zc, Zp, LW, TILE, G, stream);
}

}  // extern "C"
