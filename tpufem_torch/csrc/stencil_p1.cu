// P1 stencil apply on the zero-padded vertex grid, for Hopper (sm_90a).
//
//   y[z,y,x] = sum_{d<D} F[d, row(z), y, x] * x[z+dz_d, y+dy_d, x+dx_d]
//   (x read as 0 outside the grid)
//
//   row(z) = z                                        when R == Z
//   row(z) = z (z < 3), 3 (3 <= z < Z-3), 4+z-(Z-3)   when R == 7
//
// F is the zone-field stack of tpufem_torch/fem/dia_op.py (per diagonal
// the z-lo[3,Y,X], z-mid[1,Y,X] and z-hi[3,Y,X] weight fields, or the
// full [Z,Y,X] field for short grids and dense-mode operators).  The
// fields carry the interior constant, the grid truncation and the baked
// Dirichlet rows and columns, so one pass gives the exact BC-eliminated
// operator: no correction pass.
//
// Replaces the TPU kernels
//   K1 tpufem/fem/pallas_stencil.py:72 stencil_apply_pallas_scalar
//      (with the thin-slab apply_corrections of :146): F filled with the
//      per-diagonal constants is exactly that kernel;
//   K2 tpufem/fem/pallas_stencil.py:185 stencil_apply_pallas: R == Z
//      with the dia_weights_dense arrays is exactly that kernel.
//
// What bounds it on an H100: bytes, by the roofline: x read and y written
// once and the weight fields read once, 6.3 MB (~1.9 us at 3.35 TB/s) in
// zone form at the 97x81x65 grid of the 500k-dof main path, 34.7 MB with
// full fields.  In practice, at half a million points and fewer, what a
// thread waits for: a thread per point reads its 15 zone weights again on
// every plane (30 MB through L2, though the mid row is the same for 91 of
// 97 planes) and 15 bounds-checked neighbours that the planes above and
// below share; blocks of 32 x 8 threads leave a third of the lanes idle on
// a 65-wide row, and half on the 17- and 9-wide rows of the coarse
// multigrid levels.
//
// The design:
//
// - The (y, x) plane is indexed flat, p = y * X + x: a block owns kTile
//   consecutive points of the plane for a run of z planes that share
//   their field row, so only the plane's last block has idle lanes: each
//   of the three z-lo and three z-hi planes is a run of its own, the mid
//   zone is cut into equal runs of at most kRun planes (21 tiles x 18
//   runs at the 97x81x65 grid, all resident at once), and every plane of
//   full fields (R == Z) is a run.
// - The source planes of the run and one either side, the block's points
//   and a halo of X + 1 points either side (the reach of a diagonal in
//   the flat plane), are copied to shared memory once with cp.async, and
//   zeros where the grid ends in z or the plane ends; the 15 neighbour
//   reads of a point hit shared memory at offsets dz * SW + dy * X + dx
//   kept in registers.  A neighbour beyond the row's or the plane's end
//   is left out by a per-thread mask made once per run, not by six
//   compares per term.
// - A thread keeps its point and marches along z with its weights in
//   registers, loaded once per run while the planes are on their way: a
//   run that loaded new weights plane after plane (z-lo, z-hi, R == Z)
//   waited for device memory on each.
// - The sum runs over the diagonals in ascending d into one accumulator,
//   as a thread per point would, so the result does not depend on the
//   tiling.
// - What a launch needs beside x, y and the stream (the fields, the
//   dims, the packed offsets, the run: the wrapper cuts it shorter where
//   the staged planes of a very wide grid would not fit 227 KB) is a
//   StencilLaunch packed once per operator.
//
// The three-component form (tpufem_stencil_p1_bs3_*): the planar bs = 3
// elasticity operator of tpufem/fem/dia_op.py (DiaOperator with
// planar=True, its _apply_zones :462-546), for which tpufem has no Pallas
// kernel (XLA runs it).  x and y are three component grids one after the
// other, [3, Z, Y, X], and for each output component r
//
//   y_r[z,y,x] = sum_{d<D} sum_{s<3} F[r, d, s, row(z), y, x]
//                                    * x_s[z+dz_d, y+dy_d, x+dx_d]
//
// summed in that order (shift d ascending, then source component s), as
// tpufem sums the 9 D zone terms of its zone plan; a (d, r, s) term the
// zone plan lacks is a zero field.  Bytes bound it as they bound the
// scalar form: at the 65x49x49 grid of the 500k-dof elasticity path x and
// y are 1.87 MB each and the 135 zone fields 9.08 MB, 3.8 us at 3.35 TB/s.
//
// Its kernel (stencil_p1_bs3_kernel) is its own.  An earlier form was this
// file's scalar kernel with a block per output component:
// each of the three blocks of a (tile, run) staged all three source
// components, with two integer divisions a staged value, and waited for
// its whole stage before its first product.  Measured at 65x49x49 float32
// (scripts/zones_bs3_times.py --split, on an H100): 0.0223 ms whole,
// 0.0128 staging alone, 0.0184 products alone; 76 registers, 3 blocks an
// SM.  Now:
//
// - A block is kTile3 points of the flat plane x a z run x the three
//   output components (3 kTile3 threads, a third each, whole warps): the
//   run's source planes are staged once for all three, walking the stage
//   by rows without a division (staging alone: 0.0054 ms).
// - A thread loads the 3 D weights of its component on the run's field
//   row while the stage is on its way, and applies them to the run's
//   planes with no branch among the products: a neighbour past its row's
//   or the plane's end gets a zero weight (x is finite, so the product
//   adds a zero as the padded grid's zero would), and a plane past a short
//   run reads the run's last one and is not stored.  A form that branched
//   on the run's length between a plane's load and its product waited for
//   each value before the next.
// - Runs of at most kRun3 = 4 mid planes: twice the threads of 8-plane
//   runs (0.0153-0.0161 ms against 0.0157-0.0168 at 65x49x49 float32).
// - The sum order is the first form's: shift d ascending, then source
//   component s, with fused multiply-adds.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "strip_common.cuh"

namespace {

using tpufem::kMaxSmem;

constexpr int kMaxDiagonals = 27;
constexpr int kP1Diagonals = 15;  // the Kuhn lattice's: the other static bound
constexpr int kZoneRows = 7;
constexpr int kZoneHalo = 3;
// The shape of a block, fixed from measurements on an H100
// (scripts/kernel_shapes.py rebuilds with other values through these
// macros; tpufem_torch/fem/stencil.py mirrors them).
#ifndef TPUFEM_STENCIL_TILE
#define TPUFEM_STENCIL_TILE 256
#endif
#ifndef TPUFEM_STENCIL_RUN
#define TPUFEM_STENCIL_RUN 8
#endif
constexpr int kTile = TPUFEM_STENCIL_TILE;  // points of the plane a block owns
constexpr int kRun = TPUFEM_STENCIL_RUN;    // most planes of a mid-zone run
// The three-component kernel's: points of the plane and most planes of a
// mid run a block owns (scripts/zones_bs3_times.py rebuilds with other
// values; tpufem_torch/fem/stencil.py mirrors them).
#ifndef TPUFEM_BS3_TILE
#define TPUFEM_BS3_TILE 128
#endif
#ifndef TPUFEM_BS3_RUN
#define TPUFEM_BS3_RUN 4
#endif
#ifndef TPUFEM_BS3_PHASE
#define TPUFEM_BS3_PHASE 0
#endif
constexpr int kTile3 = TPUFEM_BS3_TILE;
constexpr int kRun3 = TPUFEM_BS3_RUN;
constexpr int kThreads3 = 3 * kTile3;
constexpr int kMaxDevices = 64;

struct Offsets {
  int8_t dx[kMaxDiagonals];
  int8_t dy[kMaxDiagonals];
  int8_t dz[kMaxDiagonals];
};

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:StencilLaunch).
struct StencilLaunch {
  const void* F;  // [D, R, Y, X] weight fields
  int device, Z, Y, X, R, D;
  int run;  // planes of a mid-zone run (1 when R == Z)
  Offsets off;
};

__device__ __forceinline__ int field_row(int z, int Z, int R) {
  if (R == Z || z < kZoneHalo) return z;
  if (z < Z - kZoneHalo) return kZoneHalo;
  return kZoneHalo + 1 + (z - (Z - kZoneHalo));
}

// The D weights of point p on field row `row`.  Unrolled to the static
// bound MD so that w[d] stays in a register.
template <typename T, int MD>
__device__ __forceinline__ void load_weights(T (&w)[MD],
                                             const T* __restrict__ F, int D,
                                             size_t fstride, size_t at) {
#pragma unroll
  for (int d = 0; d < MD; ++d) {
    if (d >= D) break;
    w[d] = __ldg(F + d * fstride + at);
  }
}

// MD: the static bound of D (15 keeps a P1 operator's thread within 64
// registers or so; 27 takes any stencil of the 3x3x3 cube).
template <typename T, int MD>
__global__ void __launch_bounds__(kTile)
stencil_p1_kernel(const T* __restrict__ x, const T* __restrict__ F,
                  T* __restrict__ y, int Z, int Y, int X, int R, int D,
                  int run, Offsets off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [run + 2][SW]
  const int PS = Y * X;
  const int H = X + 1;
  const int SW = kTile + 2 * H;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTile;
  // the block's run [z0, z0 + nz): one field row
  int z0 = blockIdx.y, nz = 1;
  if (R != Z && z0 >= kZoneHalo) {
    const int mid_runs = (Z - 2 * kZoneHalo + run - 1) / run;
    if (z0 < kZoneHalo + mid_runs) {
      z0 = kZoneHalo + (z0 - kZoneHalo) * run;
      nz = min(run, Z - kZoneHalo - z0);
    } else {
      z0 += Z - 2 * kZoneHalo - mid_runs;
    }
  }

  // planes z0 - 1 .. z0 + nz, points [p0 - H, p0 + kTile + H); zeros
  // beyond the grid
  const int CS = (nz + 2) * SW;
  for (int i = tid; i < CS; i += kTile) {
    const int pl = i / SW;
    const int zz = z0 - 1 + pl;
    const int q = p0 - H + (i - pl * SW);
    if (zz >= 0 && zz < Z && q >= 0 && q < PS) {
      tpufem::cp_async_value(s + i, x + static_cast<size_t>(zz) * PS + q);
    } else {
      s[i] = T(0);
    }
  }

  const int p = p0 + tid;
  const bool active = p < PS;
  const int iy = p / X;
  const int ix = p - iy * X;
  // unrolled to the static bound so that every off.*[d] is a constant
  // index into the parameter bank, and o3[d] a register
  unsigned inside = 0;
  int o3[MD];
#pragma unroll
  for (int d = 0; d < MD; ++d) {
    if (d >= D) break;
    const int yy = iy + off.dy[d];
    const int xx = ix + off.dx[d];
    if (yy >= 0 && yy < Y && xx >= 0 && xx < X) inside |= 1u << d;
    o3[d] = off.dz[d] * SW + off.dy[d] * X + off.dx[d];
  }
  const size_t fstride = static_cast<size_t>(R) * PS;
  T w[MD];
  if (active)
    load_weights(w, F, D, fstride,
                 static_cast<size_t>(field_row(z0, Z, R)) * PS + p);
  tpufem::cp_async_wait_all();
  __syncthreads();
  if (!active) return;

  for (int zl = 0; zl < nz; ++zl) {
    const T* sp = s + (1 + zl) * SW + H + tid;
    T acc = T(0);
#pragma unroll
    for (int d = 0; d < MD; ++d) {
      if (d >= D) break;
      const bool in = (inside >> d) & 1u;
      const T v = sp[o3[d]];
      acc += w[d] * (in ? v : T(0));
    }
    y[static_cast<size_t>(z0 + zl) * PS + p] = acc;
  }
}

// The three-component kernel: a block is kTile3 points of the flat plane
// x the run of blockIdx.y x the three output components (threadIdx.x /
// kTile3; the z runs are the scalar kernel's).  TPUFEM_BS3_PHASE 1 keeps
// the staging alone, 2 the products alone, 3 the products without their
// weights' loads (scripts/zones_bs3_times.py --split).
// Two blocks an SM in float32 (80 registers: the 45 weights in 45);
// float64 weights take twice the registers, and one block an SM keeps
// them out of local memory.
template <typename T>
__global__ void __launch_bounds__(kThreads3, sizeof(T) == 4 ? 2 : 1)
stencil_p1_bs3_kernel(const T* __restrict__ x, const T* __restrict__ F,
                      T* __restrict__ y, int Z, int Y, int X, int R, int D,
                      int run, Offsets off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [3][run + 2][SW]
  const int PS = Y * X;
  const size_t N = static_cast<size_t>(Z) * PS;  // one component's grid
  const int H = X + 1;
  const int SW = kTile3 + 2 * H;
  const int tid = threadIdx.x;
  const int r = tid / kTile3;  // the output component
  const int t = tid - r * kTile3;
  const int p0 = blockIdx.x * kTile3;
  int z0 = blockIdx.y, nz = 1;
  if (R != Z && z0 >= kZoneHalo) {
    const int mid_runs = (Z - 2 * kZoneHalo + run - 1) / run;
    if (z0 < kZoneHalo + mid_runs) {
      z0 = kZoneHalo + (z0 - kZoneHalo) * run;
      nz = min(run, Z - kZoneHalo - z0);
    } else {
      z0 += Z - 2 * kZoneHalo - mid_runs;
    }
  }

  // planes z0 - 1 .. z0 + nz of each source component, points
  // [p0 - H, p0 + kTile3 + H); zeros beyond the grid.  A thread walks
  // the stage's rows (component, plane) and its columns without dividing.
  const int CS = (nz + 2) * SW;  // one component's staged planes
  {
    int j = tid % SW;
    int pl = tid / SW;
    int c = pl / (nz + 2);
    pl -= c * (nz + 2);
    for (int i = tid; i < 3 * CS; i += kThreads3) {
      const int zz = z0 - 1 + pl;
      const int q = p0 - H + j;
      if (zz >= 0 && zz < Z && q >= 0 && q < PS) {
        if (TPUFEM_BS3_PHASE < 2)
          tpufem::cp_async_value(
              s + i, x + c * N + static_cast<size_t>(zz) * PS + q);
      } else {
        s[i] = T(0);
      }
      j += kThreads3;
      while (j >= SW) {
        j -= SW;
        if (++pl == nz + 2) {
          pl = 0;
          ++c;
        }
      }
    }
  }
  const int p = p0 + t;
  const bool active = p < PS;
  const int iy = p / X;
  const int ix = p - iy * X;
  // the fields of output r on the run's row: [D, 3] of them, (d, s), all
  // loaded while the stage is on its way
  const size_t fstride = static_cast<size_t>(R) * PS;
  const T* Fr = F + static_cast<size_t>(r) * D * 3 * fstride +
                static_cast<size_t>(field_row(z0, Z, R)) * PS + p;
  T w[kP1Diagonals][3];
#pragma unroll
  for (int d = 0; d < kP1Diagonals; ++d) {
    if (d >= D || !active) break;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      w[d][c] = TPUFEM_BS3_PHASE == 3 ? T(1)
                                      : __ldg(Fr + (d * 3 + c) * fstride);
  }
  tpufem::cp_async_wait_all();
  __syncthreads();
  if (!active || TPUFEM_BS3_PHASE == 1) return;

  // the run's planes in the stage (a plane past the run reads the last,
  // and its sum is not stored): no branch in the products
  int zoff[kRun3];
#pragma unroll
  for (int zl = 0; zl < kRun3; ++zl) zoff[zl] = (zl < nz ? zl : nz - 1) * SW;
  T acc[kRun3];
#pragma unroll
  for (int zl = 0; zl < kRun3; ++zl) acc[zl] = T(0);
#pragma unroll
  for (int d = 0; d < kP1Diagonals; ++d) {
    if (d >= D) break;
    // a neighbour past its row's or the plane's end: a zero weight (with
    // x finite, the product adds a zero, as the zero value of the padded
    // grid would)
    const bool in = static_cast<unsigned>(iy + off.dy[d]) <
                        static_cast<unsigned>(Y) &&
                    static_cast<unsigned>(ix + off.dx[d]) <
                        static_cast<unsigned>(X);
    const T* sp = s + SW + H + t + off.dz[d] * SW + off.dy[d] * X +
                  off.dx[d];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T wc = in ? w[d][c] : T(0);
#pragma unroll
      for (int zl = 0; zl < kRun3; ++zl)
        acc[zl] += wc * sp[c * CS + zoff[zl]];
    }
  }
#pragma unroll
  for (int zl = 0; zl < kRun3; ++zl) {
    if (zl >= nz) break;
    y[r * N + static_cast<size_t>(z0 + zl) * PS + p] = acc[zl];
  }
}

// Raises `kernel`'s dynamic shared-memory limit on the current device once
// to at least `smem` bytes; `allowed` is that kernel's record.
cudaError_t allow_smem(const void* kernel, size_t (&allowed)[kMaxDevices],
                       int device, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

// The blocks of a z run: three z-lo, the mid runs, three z-hi (R == Z: a
// run per plane).
int z_runs(const StencilLaunch& L, int run) {
  return L.R == L.Z ? L.Z
                    : 2 * kZoneHalo + (L.Z - 2 * kZoneHalo + run - 1) / run;
}

template <typename T, int MD>
int launch_bound(const StencilLaunch& L, const void* x, void* y, int run,
                 size_t smem, void* stream) {
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(stencil_p1_kernel<T, MD>), allowed,
      L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L.Y * L.X + kTile - 1) / kTile;
  stencil_p1_kernel<T, MD><<<dim3(tiles, z_runs(L, run)), kTile, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.F), static_cast<T*>(y),
      L.Z, L.Y, L.X, L.R, L.D, L.run, L.off);
  return static_cast<int>(cudaGetLastError());
}

bool launch_ok(const StencilLaunch& L, int max_d, int max_run) {
  return L.D >= 1 && L.D <= max_d && L.Z >= 1 && L.Y >= 1 && L.X >= 1 &&
         static_cast<long long>(L.Y) * L.X <= 0x3fffffffLL &&
         (L.R == L.Z || (L.R == kZoneRows && L.Z >= kZoneRows)) &&
         L.run >= 1 && L.run <= max_run && L.Z <= 65535 &&
         !(L.R == L.Z && L.run != 1);
}

// The scalar form: F is [D, R, Y, X].
template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const StencilLaunch& L = *static_cast<const StencilLaunch*>(prepared);
  if (!launch_ok(L, kMaxDiagonals, kRun))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (L.run + 2) * (kTile + 2 * (static_cast<size_t>(L.X) + 1)) * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (L.D <= kP1Diagonals)
    return launch_bound<T, kP1Diagonals>(L, x, y, L.run, smem, stream);
  return launch_bound<T, kMaxDiagonals>(L, x, y, L.run, smem, stream);
}

size_t bs3_smem(int run, int X, size_t item) {
  return static_cast<size_t>(run + 2) * 3 *
         (kTile3 + 2 * (static_cast<size_t>(X) + 1)) * item;
}

// The three-component form: F is [3, D, 3, R, Y, X], at most the 15
// diagonals of P1.
template <typename T>
int launch_bs3(const void* prepared, const void* x, void* y, void* stream) {
  static size_t allowed[kMaxDevices] = {};
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const StencilLaunch& L = *static_cast<const StencilLaunch*>(prepared);
  if (!launch_ok(L, kP1Diagonals, kRun3))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bs3_smem(L.run, L.X, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(stencil_p1_bs3_kernel<T>), allowed,
      L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L.Y * L.X + kTile3 - 1) / kTile3;
  stencil_p1_bs3_kernel<T><<<dim3(tiles, z_runs(L, L.run)), kThreads3, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.F), static_cast<T*>(y),
      L.Z, L.Y, L.X, L.R, L.D, L.run, L.off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_stencil_p1_f32(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_stencil_p1_f64(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<double>(prepared, x, y, stream);
}

int tpufem_stencil_p1_bs3_f32(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch_bs3<float>(prepared, x, y, stream);
}

int tpufem_stencil_p1_bs3_f64(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch_bs3<double>(prepared, x, y, stream);
}

// Blocks of the float32 three-component kernel resident on an SM with
// `smem` bytes of shared memory a block, or -(cuda error).
int tpufem_stencil_p1_bs3_blocks(int smem) {
  static size_t allowed[kMaxDevices] = {};
  int device = 0, n = 0;
  cudaError_t err = cudaGetDevice(&device);
  const void* kernel = reinterpret_cast<const void*>(
      stencil_p1_bs3_kernel<float>);
  if (err == cudaSuccess)
    err = allow_smem(kernel, allowed, device, static_cast<size_t>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, stencil_p1_bs3_kernel<float>, kThreads3, static_cast<size_t>(smem));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
