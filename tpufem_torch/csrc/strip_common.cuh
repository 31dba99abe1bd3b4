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

}  // namespace tpufem
