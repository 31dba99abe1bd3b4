// Shared pieces of the channel-strip kernels (strip_apply.cu, strip_cg.cu).
//
// A strip buffer is [C, Zp, LW]: channel c, plane p (1 + z for the
// channel's z in [0, zk[c]); planes 0 and > zk[c] are zero), lane l
// (G + t for t in [0, TILE); the guard lanes l < G and l >= G + TILE are
// zero).  The operator's plan, as int32 CSR tables built by
// tpufem_torch/fem/strip_op.py:_tables:
//
//   mid_ptr[C + 1],      mid_ent[e] = (mi, ci, dz, off)   per output channel
//   dlt_ptr[C * Zc + 1], dlt_ent[e] = (di, ci, dz, off)   per (channel, z)
//
//   (A x)[co, z, t] = sum_mid mid[mi, t] * x[ci, 1 + z + dz, G + off + t]
//                   + sum_dlt dlt[di, t] * x[ci, 1 + z + dz, G + off + t]

#pragma once

#include <cuda_runtime.h>

namespace tpufem {

// Launches on `device` and leaves the caller's current device as it was.
class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~DeviceScope() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int prev_ = -1;
  cudaError_t err_;
};

struct StripPlan {
  const int* mid_ptr;
  const int4* mid_ent;
  const int* dlt_ptr;
  const int4* dlt_ent;
  const int* zk;
  int C, Zc, Zp, LW, TILE, G;
};

inline bool plan_ok(const StripPlan& P) {
  return P.C > 0 && P.Zc > 0 && P.Zp == P.Zc + 2 && P.TILE > 0 && P.G > 0 &&
         P.LW >= P.G + P.TILE && P.LW % 128 == 0;
}

// Loads of a buffer the kernel itself writes go through L2 only
// (ld.global.cg), so no SM reads a stale L1 line after a grid barrier;
// read-only data takes the read-only path.
template <typename T, bool kWritten>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kWritten) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// Sum of the mid terms at body element (co, z, t), in plan order.
template <typename T, bool kWritten>
__device__ __forceinline__ T mid_terms(const T* x, const T* __restrict__ mid,
                                       const StripPlan& P, int co, int z,
                                       int t) {
  T acc = T(0);
  const int e1 = __ldg(P.mid_ptr + co + 1);
  for (int e = __ldg(P.mid_ptr + co); e < e1; ++e) {
    const int4 m = __ldg(P.mid_ent + e);
    const T w = __ldg(mid + static_cast<size_t>(m.x) * P.TILE + t);
    const T v = load<T, kWritten>(
        x + (static_cast<size_t>(m.y) * P.Zp + 1 + z + m.z) * P.LW + P.G +
        m.w + t);
    acc += w * v;
  }
  return acc;
}

// acc plus the delta rows of (co, z), in plan order.
template <typename T, bool kWritten>
__device__ __forceinline__ T delta_terms(T acc, const T* x,
                                         const T* __restrict__ dlt,
                                         const StripPlan& P, int co, int z,
                                         int t) {
  const int row = co * P.Zc + z;
  const int e1 = __ldg(P.dlt_ptr + row + 1);
  for (int e = __ldg(P.dlt_ptr + row); e < e1; ++e) {
    const int4 d = __ldg(P.dlt_ent + e);
    const T w = __ldg(dlt + static_cast<size_t>(d.x) * P.TILE + t);
    const T v = load<T, kWritten>(
        x + (static_cast<size_t>(d.y) * P.Zp + 1 + z + d.z) * P.LW + P.G +
        d.w + t);
    acc += w * v;
  }
  return acc;
}

}  // namespace tpufem
