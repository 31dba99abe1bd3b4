// The P1 h-transfers of the geometric multigrid, with their Dirichlet
// masks, for Hopper (sm_90a): one launch a transfer.
//
// A batch of B vertex grids: coarse [B, Z, Y, X], fine [B, 2Z-1, 2Y-1,
// 2X-1] (the leading batch: 1 for scalar Poisson, the 3 components of
// planar elasticity, the L slabs of a sharded level).  With fm / cm the
// fine / coarse Dirichlet masks (a mask left out zeroes nothing) and
// f~ = f with its fine-masked entries 0, c~ likewise:
//
//   restriction  c[i] = cm[i] ? 0 : f~[2i]
//                 + sum_{o in {0,1}^3 \ 0} (0.5 f~[2i + o] + 0.5 f~[2i - o])
//   prolongation f[F] = fm[F] ? 0 : (o == 0 ? c~[i] : 0.5 (c~[i] + c~[i + o]))
//                       with i = F >> 1, o = F & 1 per axis
//
// f~ read as 0 outside the fine grid.  These are
// tpufem_torch/la/gmg.py:restrict_h_plain / prolong_h_plain (the
// shifted-slice form of tpufem/la/gmg.py:restrict_h / prolong_h, :74-116,
// XLA in tpufem: it has no Pallas kernel for them) between the
// masked_fills of GMG.vcycle, and give their bits:
//
// - The restriction sums in restrict_h_plain's order: the centre, then for
//   (oz, oy, ox) = (0,0,1), (0,1,0), ..., (1,1,1) the term at 2i + o (its
//   F.pad(., (0, o))) before the term at 2i - o (F.pad(., (o, 0))).  A
//   term outside the grid or under the fine mask adds +0.0, as the padded
//   or filled zero does there, so a -0.0 sum turns +0.0 where the slices
//   turn it.  Each product and sum is rounded on its own (__fmul_rn,
//   __fadd_rn: never contracted), as the slices' separate kernels round
//   them, subnormals included.
// - The prolongation rounds lo + hi, then the product by 0.5, as
//   0.5 * (lo + hi) does.
//
// What bounds it on an H100: bytes.  At the 10M strong-scaling row's
// finest level (fine 225 x 209 x 209 vertices, float32) a restriction
// reads the fine grid (39.3 MB) and its mask (9.8 MB) and writes the
// coarse grid (4.9 MB) after reading its mask (1.2 MB): 55 MB, 0.0165 ms
// at 3.35 TB/s; a prolongation moves the same bytes the other way.  The
// slice form took 56 (restriction) and 30 (prolongation) launches for it,
// 0.295 / 0.344 ms of device time and about 1 / 0.8 ms of the host's.
//
// The design: a thread per coarse point (restriction), or per coarse
// (z, y) point of a fine x (prolongation: the four fine points 2 iz + oz,
// 2 iy + oy, which share their lower coarse value), the points of a flat
// plane consecutive in a block of kThreads (only the plane's last block
// has idle lanes, whatever the row's width), a grid row per coarse plane
// and a grid layer per batch entry.  A warp's threads sit on neighbouring
// x of one row, so each read is a run of neighbouring addresses, through
// the read-only cache, where the neighbours' overlapping reads (a fine
// value is read by up to 8 coarse points, 15/8 times on average) find
// their lines; the fine planes shared by two coarse planes are met again
// in L2.  A thread issues every load (value and mask byte together, a
// point outside the grid read at the thread's own point and dropped)
// before its first sum, at 32-bit offsets from its own point with the
// grid's edges tested once.  Measured at the finest level above (float32,
// both masks; chip_smoke.py phase 20, an H100 at 700 W): a thread per
// output point that tested the mask before loading the value, with 64-bit
// indices and six bounds tests a term, took 0.0360 / 0.0706 ms
// (restriction / prolongation); its loads issued together 0.0342 /
// 0.0381 (a thread per two fine planes); this form 0.0258 / 0.0250, 64% /
// 66% of the bound.  What a launch needs beside its input, output and
// stream is a TransferLaunch packed once per level.

#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;

// What a transfer needs beside its input, output and stream, packed once
// per level by tpufem_torch/la/gmg.py (_build.TransferLaunch): the masks
// (torch.bool, one byte an entry, [B, fine grid] and [B, coarse grid];
// null: none), the device, the batch and the coarse vertex extents.
struct TransferLaunch {
  const void* fine_mask;
  const void* coarse_mask;
  int device, B, Z, Y, X;
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float half_of(float a) {
  return __fmul_rn(0.5f, a);
}
__device__ __forceinline__ double half_of(double a) {
  return __dmul_rn(0.5, a);
}

// v[i], or 0 where mask[i] is set or `in` is false (a point outside the
// grid; i is then 0, the thread's own point): the value and its mask byte
// are loaded together, neither waiting on the other.
template <typename T>
__device__ __forceinline__ T masked(const T* __restrict__ v,
                                    const unsigned char* __restrict__ mask,
                                    int i, bool in) {
  const T x = __ldg(v + i);
  const bool m = mask != nullptr && __ldg(mask + i);
  return in && !m ? x : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmg_restrict_kernel(const T* __restrict__ f, T* __restrict__ c,
                        const unsigned char* __restrict__ fmask,
                        const unsigned char* __restrict__ cmask, int Z, int Y,
                        int X) {
  const int PS = Y * X;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= PS) return;
  const int iz = blockIdx.y, b = blockIdx.z;
  const int iy = p / X, ix = p - iy * X;
  const int FY = 2 * Y - 1, FX = 2 * X - 1;
  const int sz = FY * FX;  // the fine grid's strides: sz, FX, 1
  const size_t centre = (static_cast<size_t>(b) * (2 * Z - 1) + 2 * iz) * sz +
                        static_cast<size_t>(2 * iy) * FX + 2 * ix;
  const T* fc = f + centre;
  const unsigned char* mc = fmask != nullptr ? fmask + centre : nullptr;
  // which neighbours of the centre lie inside the fine grid, each way
  const bool zl = iz > 0, zh = iz + 1 < Z, yl = iy > 0, yh = iy + 1 < Y,
             xl = ix > 0, xh = ix + 1 < X;
  // every load of the thread (15 values and their mask bytes) is issued
  // before the first sum
  T plus[8], minus[8];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const int oz = k >> 2, oy = (k >> 1) & 1, ox = k & 1;
    const int off = oz * sz + oy * FX + ox;
    const bool up = (!oz || zh) && (!oy || yh) && (!ox || xh);
    const bool down = (!oz || zl) && (!oy || yl) && (!ox || xl);
    plus[k] = masked(fc, mc, up ? off : 0, up);
    minus[k] = masked(fc, mc, down ? -off : 0, down);
  }
  T acc = masked(fc, mc, 0, true);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    acc = add_rn(acc, half_of(plus[k]));
    acc = add_rn(acc, half_of(minus[k]));
  }
  const size_t o = (static_cast<size_t>(b) * Z + iz) * PS + p;
  const bool cm = cmask != nullptr && __ldg(cmask + o);
  c[o] = cm ? T(0) : acc;
}

// A thread per coarse point (iz, iy) of a fine x: the fine points (2 iz +
// oz, 2 iy + oy, x) for oz, oy in {0, 1} (those inside the grid), which
// share their lower coarse value.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmg_prolong_kernel(const T* __restrict__ c, T* __restrict__ f,
                       const unsigned char* __restrict__ cmask,
                       const unsigned char* __restrict__ fmask, int Z, int Y,
                       int X) {
  const int FX = 2 * X - 1;
  const int RS = Y * FX;  // points of a thread plane: coarse y x fine x
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= RS) return;
  const int iz = blockIdx.y, b = blockIdx.z;
  const int iy = p / FX, fx = p - iy * FX;
  const int ox = fx & 1, ix = fx >> 1;
  const bool zh = iz + 1 < Z, yh = iy + 1 < Y;  // the odd fine plane / row
  const int sz = Y * X;
  const size_t lo = (static_cast<size_t>(b) * Z + iz) * sz +
                    static_cast<size_t>(iy) * X + ix;
  const T* cl = c + lo;
  const unsigned char* ml = cmask != nullptr ? cmask + lo : nullptr;
  // c~ at lo and at lo + (oz, oy, ox), each (oz, oy) inside the grid
  const T v = masked(cl, ml, 0, true);
  const T h00 = masked(cl, ml, ox, true);
  const T h01 = masked(cl, ml, yh ? X + ox : 0, true);
  const T h10 = masked(cl, ml, zh ? sz + ox : 0, true);
  const T h11 = masked(cl, ml, zh && yh ? sz + X + ox : 0, true);
  const int FY = 2 * Y - 1, fps = FY * FX;
  const size_t o = (static_cast<size_t>(b) * (2 * Z - 1) + 2 * iz) * fps +
                   static_cast<size_t>(2 * iy) * FX + fx;
  T* fo = f + o;
  const unsigned char* mo = fmask != nullptr ? fmask + o : nullptr;
  const bool m00 = mo != nullptr && __ldg(mo);
  const bool m01 = yh && mo != nullptr && __ldg(mo + FX);
  const bool m10 = zh && mo != nullptr && __ldg(mo + fps);
  const bool m11 = zh && yh && mo != nullptr && __ldg(mo + fps + FX);
  fo[0] = m00 ? T(0) : (ox ? half_of(add_rn(v, h00)) : v);
  if (yh) fo[FX] = m01 ? T(0) : half_of(add_rn(v, h01));
  if (zh) fo[fps] = m10 ? T(0) : half_of(add_rn(v, h10));
  if (zh && yh) fo[fps + FX] = m11 ? T(0) : half_of(add_rn(v, h11));
}

// The grid's rows and layers, and a fine plane with a row and a block
// beyond it in 32-bit offsets.
bool launch_ok(const TransferLaunch& L) {
  return L.B >= 1 && L.B <= 65535 && L.Z >= 1 && L.Z <= 65535 && L.Y >= 1 &&
         L.X >= 1 &&
         (2LL * L.Y - 1) * (2LL * L.X - 1) + 2LL * L.X + kThreads <=
             0x7fffffffLL;
}

// kind 0: restriction (in: fine, out: coarse); 1: prolongation.
template <typename T>
int launch(const void* prepared, const void* in, void* out, void* stream,
           int kind) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const TransferLaunch& L = *static_cast<const TransferLaunch*>(prepared);
  if (!launch_ok(L)) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const auto* fm = static_cast<const unsigned char*>(L.fine_mask);
  const auto* cm = static_cast<const unsigned char*>(L.coarse_mask);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    const int PS = L.Y * L.X;
    gmg_restrict_kernel<T>
        <<<dim3((PS + kThreads - 1) / kThreads, L.Z, L.B), kThreads, 0, s>>>(
            static_cast<const T*>(in), static_cast<T*>(out), fm, cm, L.Z, L.Y,
            L.X);
  } else {
    const int RS = L.Y * (2 * L.X - 1);
    gmg_prolong_kernel<T><<<dim3((RS + kThreads - 1) / kThreads, L.Z, L.B),
                            kThreads, 0, s>>>(static_cast<const T*>(in),
                                              static_cast<T*>(out), cm, fm,
                                              L.Z, L.Y, L.X);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_gmg_restrict_f32(const void* prepared, const void* fine,
                            void* coarse, void* stream) {
  return launch<float>(prepared, fine, coarse, stream, 0);
}

int tpufem_gmg_restrict_f64(const void* prepared, const void* fine,
                            void* coarse, void* stream) {
  return launch<double>(prepared, fine, coarse, stream, 0);
}

int tpufem_gmg_prolong_f32(const void* prepared, const void* coarse,
                           void* fine, void* stream) {
  return launch<float>(prepared, coarse, fine, stream, 1);
}

int tpufem_gmg_prolong_f64(const void* prepared, const void* coarse,
                           void* fine, void* stream) {
  return launch<double>(prepared, coarse, fine, stream, 1);
}

}  // extern "C"
