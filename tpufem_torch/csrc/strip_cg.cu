// The whole unpreconditioned Chronopoulos-Gear CG on the channel-strip
// operator, as one cooperative kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel K4, tpufem/fem/strip_op.py:434
// StripOperator.cg_pallas (pallas_call at :522), which keeps b, x, p, s,
// r and the weight packs in VMEM for the whole solve.  The recurrence is
// the same (strip_op.py:487-520):
//
//   live  = rr > rtol^2 rr0            (the step is frozen once false)
//   beta  = k == 0 ? 0 : rr / rr_prev
//   s     = beta s + A r               (in place; the s_old.r partial first)
//   w.r   = s_new.r - beta s_old.r
//   alpha = rr / (w.r - beta rr / alpha_prev)
//   p = r + beta p,  x += alpha p,  r -= alpha s,  rr = r.r
//
// Once frozen, no later step changes x, r, rr or the count, so the
// kernel leaves the loop there; every block reads the same rr, so all
// leave at the same step.  The plain PyTorch version is
// tpufem_torch/fem/strip_op.py:StripOperator.cg_resident_plain.
//
// On Hopper the per-iteration barrier across the whole state is a grid
// barrier: the kernel is launched with cudaLaunchCooperativeKernel, with
// no more blocks than can be resident at once (the occupancy query
// below), walks the buffers with a grid-stride loop and meets at
// cooperative_groups::this_grid().sync() twice per iteration: after the
// apply pass (which reduces s_old.r and s_new.r) and after the update
// pass (which reduces r.r).  The state (5 buffers, 11 MB in f32 at the
// 146k-dof P3 operator) stays in the 50 MB L2: the card's counterpart of
// VMEM residency.  Determinism across blocks: each block writes its
// partial sums to its own slot, and every block then sums all slots in
// one fixed order (no atomics), so all blocks derive bitwise-identical
// alpha, beta and rr, and agree on when to stop.  The s-partials and the
// r-partials live in separate arrays, so no block overwrites a sum that
// another block is still reading: each array is written only after the
// barrier that follows its last read.
//
// What bounds it on an H100: per iteration the apply's bytes (r read
// once, s read and written, the packs read once) and four vector passes,
// ~7 x 5.9 MB of state at 146k dofs if each pass went to device memory;
// resident in L2 the floor is the two grid barriers and the ~48-term
// apply per element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace cg = cooperative_groups;

namespace {

using tpufem::StripPlan;

constexpr int kThreads = 256;  // tpufem_torch/_build.py:CG_THREADS

template <typename T>
struct CgArgs {
  const T* b;
  const T* mid;
  const T* dlt;
  StripPlan P;
  T* x;
  T* p;
  T* s;
  T* r;
  T* part_sr;  // [2 * gridDim.x]: s_old.r, s_new.r per block
  T* part_rr;  // [gridDim.x]: r.r per block
  int* it_out;
  T* rel_out;
  T rtol2;
  int maxit;
};

// Block-wide sum by a fixed tree; every thread gets the result.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  const T out = red[0];
  __syncthreads();
  return out;
}

// Sum of the per-block partials part[i * stride], i < nblk, in the same
// order in every block.
template <typename T>
__device__ __forceinline__ T grid_total(const T* part, int stride, T* red) {
  T v = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    v += __ldcg(part + static_cast<size_t>(i) * stride);
  return block_sum(v, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) strip_cg_kernel(CgArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kThreads];
  const StripPlan& P = a.P;
  const long long row_len = P.LW;
  const long long n = static_cast<long long>(P.C) * P.Zp * row_len;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;

  // x = p = s = 0, r = b, rr0 = b.b
  T acc = T(0);
  for (long long i = i0; i < n; i += stride) {
    const T bv = __ldg(a.b + i);
    a.x[i] = T(0);
    a.p[i] = T(0);
    a.s[i] = T(0);
    a.r[i] = bv;
    acc += bv * bv;
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) a.part_rr[blockIdx.x] = acc;
  grid.sync();
  const T rr0 = grid_total(a.part_rr, 1, red);
  const T thresh = a.rtol2 * rr0;
  T rr = rr0, rr_prev = T(1), alpha_prev = T(1);
  int cnt = 0;

  for (int k = 0; k < a.maxit; ++k) {
    if (!(rr > thresh)) break;  // frozen from here on (uniform)
    const T beta = k == 0 ? T(0) : rr / rr_prev;

    // apply pass: s <- beta s + A r, with the s_old.r and s_new.r partials
    T sr_old = T(0), sr_new = T(0);
    for (long long i = i0; i < n; i += stride) {
      const long long crow = i / row_len;  // co * Zp + plane
      const int co = static_cast<int>(crow / P.Zp);
      const int z = static_cast<int>(crow - static_cast<long long>(co) * P.Zp) - 1;
      const int t = static_cast<int>(i - crow * row_len) - P.G;
      const T rv = __ldcg(a.r + i);
      const T s_old = __ldcg(a.s + i);
      T s_new = beta * s_old;
      if (z >= 0 && z < __ldg(P.zk + co) && t >= 0 && t < P.TILE) {
        s_new += tpufem::mid_terms<T, true>(a.r, a.mid, P, co, z, t);
        s_new = tpufem::delta_terms<T, true>(s_new, a.r, a.dlt, P, co, z, t);
      }
      a.s[i] = s_new;
      sr_old += s_old * rv;
      sr_new += s_new * rv;
    }
    sr_old = block_sum(sr_old, red);
    sr_new = block_sum(sr_new, red);
    if (threadIdx.x == 0) {
      a.part_sr[2 * blockIdx.x] = sr_old;
      a.part_sr[2 * blockIdx.x + 1] = sr_new;
    }
    grid.sync();
    const T wr = grid_total(a.part_sr + 1, 2, red) -
                 beta * grid_total(a.part_sr, 2, red);
    const T alpha = rr / (wr - beta * rr / alpha_prev);

    // update pass: p, x, r, with the r.r partial
    T rn = T(0);
    for (long long i = i0; i < n; i += stride) {
      const T rv = __ldcg(a.r + i);
      const T pv = rv + beta * __ldcg(a.p + i);
      a.p[i] = pv;
      a.x[i] = __ldcg(a.x + i) + alpha * pv;
      const T r_new = rv - alpha * __ldcg(a.s + i);
      a.r[i] = r_new;
      rn += r_new * r_new;
    }
    rn = block_sum(rn, red);
    if (threadIdx.x == 0) a.part_rr[blockIdx.x] = rn;
    grid.sync();
    rr_prev = rr;
    rr = grid_total(a.part_rr, 1, red);
    alpha_prev = alpha;
    ++cnt;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.it_out = cnt;
    *a.rel_out = sqrt(rr / rr0);
  }
}

template <typename T>
int max_blocks(int device) {
  tpufem::DeviceScope scope(device);
  cudaError_t err = scope.error();
  int coop = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, strip_cg_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

template <typename T>
int launch(int device, const void* b, const void* mid, const void* dlt,
           const int* mid_ptr, const int* mid_ent, const int* dlt_ptr,
           const int* dlt_ent, const int* zk, void* x, void* work,
           void* partials, void* it, void* rel, int C, int Zc, int Zp, int LW,
           int TILE, int G, double rtol2, int maxit, int nblk, void* stream) {
  const StripPlan P{mid_ptr, reinterpret_cast<const int4*>(mid_ent),
                    dlt_ptr, reinterpret_cast<const int4*>(dlt_ent), zk,
                    C, Zc, Zp, LW, TILE, G};
  if (!tpufem::plan_ok(P) || nblk < 1 || maxit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const size_t n = static_cast<size_t>(C) * Zp * LW;
  T* w = static_cast<T*>(work);
  T* part = static_cast<T*>(partials);
  CgArgs<T> a{static_cast<const T*>(b), static_cast<const T*>(mid),
              static_cast<const T*>(dlt), P, static_cast<T*>(x), w, w + n,
              w + 2 * n, part, part + 2 * static_cast<size_t>(nblk),
              static_cast<int*>(it), static_cast<T*>(rel),
              static_cast<T>(rtol2), maxit};
  void* args[] = {&a};
  // a grid larger than the co-resident capacity is refused here
  // (cudaErrorCooperativeLaunchTooLarge), never run
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(strip_cg_kernel<T>), dim3(nblk),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  // read (and so clear) the launch's error state: a refused launch must
  // not surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

int tpufem_strip_cg_blocks_f32(int device) { return max_blocks<float>(device); }

int tpufem_strip_cg_blocks_f64(int device) { return max_blocks<double>(device); }

int tpufem_strip_cg_f32(int device, const void* b, const void* mid,
                        const void* dlt, const int* mid_ptr,
                        const int* mid_ent, const int* dlt_ptr,
                        const int* dlt_ent, const int* zk, void* x,
                        void* work, void* partials, void* it, void* rel,
                        int C, int Zc, int Zp, int LW, int TILE, int G,
                        double rtol2, int maxit, int nblk, void* stream) {
  return launch<float>(device, b, mid, dlt, mid_ptr, mid_ent, dlt_ptr,
                       dlt_ent, zk, x, work, partials, it, rel, C, Zc, Zp, LW,
                       TILE, G, rtol2, maxit, nblk, stream);
}

int tpufem_strip_cg_f64(int device, const void* b, const void* mid,
                        const void* dlt, const int* mid_ptr,
                        const int* mid_ent, const int* dlt_ptr,
                        const int* dlt_ent, const int* zk, void* x,
                        void* work, void* partials, void* it, void* rel,
                        int C, int Zc, int Zp, int LW, int TILE, int G,
                        double rtol2, int maxit, int nblk, void* stream) {
  return launch<double>(device, b, mid, dlt, mid_ptr, mid_ent, dlt_ptr,
                        dlt_ent, zk, x, work, partials, it, rel, C, Zc, Zp,
                        LW, TILE, G, rtol2, maxit, nblk, stream);
}

}  // extern "C"
