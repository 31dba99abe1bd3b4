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
// zone plan lacks is a zero field.  A block is (256 points, z run, output
// component r): it stages the run's planes of all three source
// components (3 x 14 KB in float32 at the 65x49x49 grid of the 500k-dof
// elasticity path), and a thread keeps the 3 D <= 45 weights of its
// point for r in registers.  Bytes bound it as they bound the scalar
// form: at that grid x and y are 1.87 MB each and the 135 zone fields
// 9.08 MB, 3.8 us at 3.35 TB/s.

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
// registers or so; 27 takes any stencil of the 3x3x3 cube).  NC: the
// number of components (1, or 3 for the planar elasticity form, whose
// output component is blockIdx.z).
template <typename T, int MD, int NC>
__global__ void __launch_bounds__(kTile)
stencil_p1_kernel(const T* __restrict__ x, const T* __restrict__ F,
                  T* __restrict__ y, int Z, int Y, int X, int R, int D,
                  int run, Offsets off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [NC][run + 2][SW]
  const int PS = Y * X;
  const size_t N = static_cast<size_t>(Z) * PS;  // one component's grid
  const int H = X + 1;
  const int SW = kTile + 2 * H;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTile;
  const int r = NC == 1 ? 0 : static_cast<int>(blockIdx.z);
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

  // planes z0 - 1 .. z0 + nz of each component, points
  // [p0 - H, p0 + kTile + H); zeros beyond the grid
  const int CS = (nz + 2) * SW;  // one component's staged planes
  for (int i = tid; i < NC * CS; i += kTile) {
    const int c = NC == 1 ? 0 : i / CS;
    const int j = i - c * CS;
    const int pl = j / SW;
    const int zz = z0 - 1 + pl;
    const int q = p0 - H + (j - pl * SW);
    if (zz >= 0 && zz < Z && q >= 0 && q < PS) {
      tpufem::cp_async_value(s + i,
                             x + c * N + static_cast<size_t>(zz) * PS + q);
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
  // the fields of output r: [D, NC] of them, (d, s) in order
  T w[MD * NC];
  if (active)
    load_weights(w, F + static_cast<size_t>(r) * D * NC * fstride, D * NC,
                 fstride, static_cast<size_t>(field_row(z0, Z, R)) * PS + p);
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
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const T v = sp[c * CS + o3[d]];
        acc += w[d * NC + c] * (in ? v : T(0));
      }
    }
    y[r * N + static_cast<size_t>(z0 + zl) * PS + p] = acc;
  }
}

// Raises the kernel's dynamic shared-memory limit on the current device
// once to at least `smem` bytes.
template <typename T, int MD, int NC>
cudaError_t allow_smem(int device, size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      stencil_p1_kernel<T, MD, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

template <typename T, int MD, int NC>
int launch_bound(const StencilLaunch& L, const void* x, void* y, int run,
                 size_t smem, void* stream) {
  const cudaError_t err = allow_smem<T, MD, NC>(L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L.Y * L.X + kTile - 1) / kTile;
  const int runs = L.R == L.Z ? L.Z
                              : 2 * kZoneHalo +
                                    (L.Z - 2 * kZoneHalo + run - 1) / run;
  stencil_p1_kernel<T, MD, NC><<<dim3(tiles, runs, NC), kTile, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.F), static_cast<T*>(y),
      L.Z, L.Y, L.X, L.R, L.D, run, L.off);
  return static_cast<int>(cudaGetLastError());
}

// NC components: F is [NC, D, NC, R, Y, X] (scalar: [D, R, Y, X]); the
// three-component form takes at most the 15 diagonals of P1.
template <typename T, int NC>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const StencilLaunch& L = *static_cast<const StencilLaunch*>(prepared);
  const int max_d = NC == 1 ? kMaxDiagonals : kP1Diagonals;
  if (L.D < 1 || L.D > max_d || L.Z < 1 || L.Y < 1 || L.X < 1 ||
      static_cast<long long>(L.Y) * L.X > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(L.R == L.Z || (L.R == kZoneRows && L.Z >= kZoneRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.run < 1 || L.run > kRun) return static_cast<int>(cudaErrorInvalidValue);
  const int run = L.run;
  const size_t smem = (run + 2) * NC *
                      (kTile + 2 * (static_cast<size_t>(L.X) + 1)) * sizeof(T);
  if (smem > kMaxSmem || L.Z > 65535 || (L.R == L.Z && run != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (L.D <= kP1Diagonals)
    return launch_bound<T, kP1Diagonals, NC>(L, x, y, run, smem, stream);
  if constexpr (NC == 1)
    return launch_bound<T, kMaxDiagonals, 1>(L, x, y, run, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int tpufem_stencil_p1_f32(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<float, 1>(prepared, x, y, stream);
}

int tpufem_stencil_p1_f64(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<double, 1>(prepared, x, y, stream);
}

int tpufem_stencil_p1_bs3_f32(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch<float, 3>(prepared, x, y, stream);
}

int tpufem_stencil_p1_bs3_f64(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch<double, 3>(prepared, x, y, stream);
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
