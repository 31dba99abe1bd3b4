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
// The three-component form (tpufem_stencil_p1_bs3_table_*): the planar
// bs = 3 elasticity operator of tpufem/fem/dia_op.py (DiaOperator with
// planar=True, its _apply_zones :462-546), for which tpufem has no Pallas
// kernel (XLA runs it).  x and y are three component grids one after the
// other, [3, Z, Y, X], and for each output component r
//
//   y_r[z,y,x] = sum_{d<D} sum_{s<3} W[r, d, s](z, y, x)
//                                    * x_s[z+dz_d, y+dy_d, x+dx_d]
//
// summed in that order (shift d ascending, then source component s), as
// tpufem sums the 9 D zone terms of its zone plan; a (d, r, s) term the
// zone plan lacks is a zero weight.  The weights W are the operator's 135
// zone fields F[r, d, s, row(z), y, x] rewritten exactly, once per
// operator, by the wrapper (fem/stencil.py: compress_bs3) as a table (a
// Bs3TableLaunch): the distinct
// 135-weight columns of the fields, table[C][3][D][3], bit for bit, and a
// byte a point, cls[P][Y][X], naming the column of each point under each
// of the P distinct row patterns; the planes of one pattern make a
// segment.  A constant-coefficient P1 elasticity operator (every
// three-component operator the port builds) has 28 distinct columns in
// all, 10 a row, and rows 1 to 5 share one pattern: three segments (z = 0,
// 1 .. Z-2, Z-1).
//
// What bounds it on an H100: bytes.  At 161x161x129 (the 10M-dof
// elasticity cell's grid) x and y are 40.1 MB each, the table 15 KB and
// the class bytes 62 KB: 0.0240 ms at 3.35 TB/s.
//
// An earlier kernel read the zone fields themselves, 3 D weights a thread
// on its run's field row, reloaded for every z run (runs of at most kRun3
// mid planes and one for each of the three z-lo and z-hi planes).  At
// 161x161x129 it took 0.2556 ms: its weight loads were about 507 MB an
// apply through L2 (the mid row's 11.2 MB 39 times, the six edge rows' 67
// MB from HBM), 6.3 times x and y; and its products, 45 shared-memory
// loads an output value, took 0.16-0.21 ms without the stage (--split:
// staging alone 0.0958 ms, products alone 0.2134, 2 blocks an SM of 80
// registers).  The same kernel reading its weights from the table took
// 0.2041 ms, its products alone 0.1573: the loads of the products were
// what was left.
//
// Two kernels read the table, chosen by the grid (fem/stencil.py:
// stencil_bs3_plan).  While the blocks of a thread an output fit one wave
// of the card, two an SM, stencil_p1_bs3_kernel: each block's latency is
// then the time, and a thread with a third of a point's work finishes
// first.
//
// - A block is kTile3 points of the flat plane x a z run x the three
//   output components (3 kTile3 threads, a third each, whole warps): the
//   run's source planes are staged once for all three, walking the stage
//   by rows without a division.  An earlier form, a block per output
//   component that staged all three source components with two integer
//   divisions a value, took 0.0223 ms at 65x49x49 float32 (staging alone
//   0.0128) where this stage alone takes 0.0054.
// - A thread loads the 3 D weights of its component while the stage is
//   on its way, and applies them to the run's planes with no branch among
//   the products: a neighbour past its row's or the plane's end gets a
//   zero weight (x is finite, so the product adds a zero as the padded
//   grid's zero would), and a plane past a short run reads the run's last
//   one and is not stored.  A form that branched on the run's length
//   between a plane's load and its product waited for each value before
//   the next.
//
// On larger grids stencil_p1_bs3_table_kernel:
//
// - A thread is a point and computes all three output components, so the
//   45 neighbour values of a plane are loaded once for the three (a thread
//   an output: once for each), and the 15 shifts are the Kuhn stencil's,
//   known when it compiles: the stage keeps RUN + 2 planes of each
//   component whatever the run's length (a template argument, the longest
//   that fits), every neighbour is a compile-time plane of one of the 7
//   (dx, dy) columns, and the compiler loads a value that two shifts of a
//   column share once: 36 loads a component for 4 planes where a thread
//   an output makes 60.
// - Its weights are its class's column of the table (15 KB for P1
//   elasticity, asked into L1 by the block as it starts, a line a thread:
//   a warp of one class reads each as a broadcast), loaded three at a time
//   (r = 0, 1, 2) as the products go.  The table is not copied to shared
//   memory: a block would copy all of it (some 26 MB an apply over the
//   161x161x129 grid's 1,722 blocks).
// - A block is kTileT = 512 points, so the flat halo of X + 1 points
//   either side adds half the tile's points to the stage where 128 points
//   add twice them; its runs are its segments' (z = 0, 1 .. Z-2, Z-1) cut
//   into runs of at most kRun3 planes: at 161x161x129, 42 runs over 41
//   tiles stage 23.3M values where the field-reading kernel's 45 runs over
//   163 tiles staged 47.6M.
//
// Both keep the field-reading kernel's sum order: for each output, shift
// d ascending, then source component s, with fused multiply-adds, and the
// table's weights are the fields' bits, so y is that kernel's to the bit
// (checked on the card against it while it was in the tree, and since
// then the two kernels against each other: tests/test_torch_cuda.py).
//
// Measured (scripts/zones_bs3_times.py on an H100, device ms after an L2
// flush, the field-reading kernel beside it in the same run): at
// 161x161x129 float32 0.0939-0.0942 against 0.2587-0.2589 (float64
// 0.1498-0.1501 against 0.4473-0.4492), 26% of its bound, 64 registers, 2
// blocks of 55,584 B an SM; its staging alone 0.0510, its products alone
// 0.0725, without their weight loads 0.0521; blocks of 128 / 256 / 512
// points 0.1319 / 0.1074 / 0.0929-0.0942.  81x81x65 0.0152-0.0153 against
// 0.0352-0.0354, 65x49x49 0.0091 against 0.0159-0.0161; the grids whose
// blocks fit one wave (a thread an output) 0.0049-0.0060 against
// 0.0052-0.0086.

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
// The table form's block: points (and threads) of the flat plane
// (scripts/zones_bs3_times.py rebuilds with other values;
// tpufem_torch/fem/stencil.py mirrors it).
#ifndef TPUFEM_BS3T_TILE
#define TPUFEM_BS3T_TILE 512
#endif
constexpr int kTileT = TPUFEM_BS3T_TILE;
constexpr int kMaxDevices = 64;
// the three-component table form: its most distinct weight columns (a
// byte a point names one) and segments of planes of one class pattern
constexpr int kMaxClasses = 256;
constexpr int kMaxSegments = 8;

struct Offsets {
  int8_t dx[kMaxDiagonals];
  int8_t dy[kMaxDiagonals];
  int8_t dz[kMaxDiagonals];
};

// The Kuhn lattice's 15 P1 shifts in ascending (dx, dy, dz) order, each
// component + 1 in two bits a shift (fem/stencil.py: P1_OFFSETS): the
// table form's kernel is built for them.
constexpr unsigned kP1Dx = 0x2a955500u;
constexpr unsigned kP1Dy = 0x29695050u;
constexpr unsigned kP1Dz = 0x26664444u;

__host__ __device__ constexpr int p1_shift(unsigned bits, int d) {
  return static_cast<int>((bits >> (2 * d)) & 3u) - 1;
}

// The table form's z runs: segment k holds planes [z[k], z[k + 1]) of
// class pattern pattern[k], cut into runs of `run` planes, blockIdx.y
// first_run[k] .. first_run[k + 1] - 1.
struct Segments {
  int n;
  int z[kMaxSegments + 1];
  int first_run[kMaxSegments + 1];
  int pattern[kMaxSegments];
};

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:StencilLaunch).
struct StencilLaunch {
  const void* F;  // [D, R, Y, X] weight fields
  int device, Z, Y, X, R, D;
  int run;  // planes of a mid-zone run (1 when R == Z)
  Offsets off;
};

// What a launch of the three-component table form needs beside x, y and
// the stream, filled once per operator (mirrored by
// tpufem_torch/_build.py:Bs3TableLaunch).
struct Bs3TableLaunch {
  const void* table;          // [C, 3, D, 3] distinct weight columns
  const unsigned char* cls;   // [P, Y, X] a point's column, per pattern
  int device, Z, Y, X, D, C, P;
  int run;                    // most planes of a run
  int per_point;              // 1: a thread a point (else an output)
  Segments seg;
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

// The segment of run b of the table form: its first and end planes, its
// first run and its class pattern (unrolled: constant indices into seg).
struct SegmentOf {
  int zs, ze, r0, pattern;
};

__device__ __forceinline__ SegmentOf segment_of(const Segments& seg, int b) {
  SegmentOf g{seg.z[0], seg.z[1], 0, seg.pattern[0]};
#pragma unroll
  for (int k = 1; k < kMaxSegments; ++k) {
    if (k < seg.n && b >= seg.first_run[k])
      g = SegmentOf{seg.z[k], seg.z[k + 1], seg.first_run[k], seg.pattern[k]};
  }
  return g;
}

// Asks the whole table form's table, C columns of 135 weights, into L1,
// a 128-byte line a thread of the block, while the class bytes and the
// stage are on their way: the weights' loads then hit L1, where each line
// of a class's column would otherwise wait for device memory after the
// class byte did.
template <typename T>
__device__ __forceinline__ void prefetch_table(const T* table, int C,
                                               int tid, int threads) {
  const int lines = (C * 3 * kP1Diagonals * 3 * static_cast<int>(sizeof(T))
                     + 127) / 128;
  for (int i = tid; i < lines; i += threads)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        reinterpret_cast<const char*>(table) + 128 * i));
}

// The three-component kernel with a thread an output: a block is kTile3
// points of the flat plane x the run of blockIdx.y x the three output
// components (threadIdx.x / kTile3); the weights are the table's column
// of each point's class, the runs the segments'.  TPUFEM_BS3_PHASE 1
// keeps the staging alone, 2 the products alone, 3 the products without
// their weights' loads (scripts/zones_bs3_times.py --split).
// Two blocks an SM in float32 (the 45 weights of a thread in registers);
// float64 weights take twice the registers, and one block an SM keeps
// them out of local memory.
template <typename T>
__global__ void __launch_bounds__(kThreads3, sizeof(T) == 4 ? 2 : 1)
stencil_p1_bs3_kernel(const T* __restrict__ x, const T* __restrict__ table,
                      const unsigned char* __restrict__ cls,
                      T* __restrict__ y, int Z, int Y, int X, int D, int C,
                      int run, Offsets off, Segments seg) {
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
  const int p = p0 + t;
  const bool active = p < PS;
  const SegmentOf g = segment_of(seg, blockIdx.y);
  const int z0 = g.zs + (blockIdx.y - g.r0) * run;
  const int nz = min(run, g.ze - z0);
  // the point's class, asked for before the stage is started; the
  // weights of output r are [D, 3] of them, (d, s), at Wr + d * 3 + s
  const int cl =
      active ? __ldg(cls + static_cast<size_t>(g.pattern) * PS + p) : 0;
  prefetch_table(table, C, tid, kThreads3);
  const T* Wr = table + static_cast<size_t>(cl * 3 + r) * D * 3;

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
  const int iy = p / X;
  const int ix = p - iy * X;
  // the weights of output r, all loaded while the stage is on its way
  T w[kP1Diagonals][3];
#pragma unroll
  for (int d = 0; d < kP1Diagonals; ++d) {
    if (d >= D || !active) break;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      w[d][c] = TPUFEM_BS3_PHASE == 3 ? T(1) : __ldg(Wr + d * 3 + c);
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

// The table form's kernel: a block is kTileT points of the flat plane x
// a run of RUN planes (its last run of a segment may be shorter) x the
// three output components, a thread a point and all three components, the
// 15 shifts those of the Kuhn stencil (kP1Dx / kP1Dy / kP1Dz).  The stage
// holds RUN + 2 planes of each source component whatever the run's
// length, so every shift's address is a compile-time plane of a column
// base: a value two shifts of one (dx, dy) column share is loaded once.
// For each shift d and source component s, a thread loads its class's
// three weights (r = 0, 1, 2) from the table and adds their products with
// each plane's value to its 3 RUN sums.  TPUFEM_BS3_PHASE as above.
template <typename T, int RUN>
__global__ void __launch_bounds__(kTileT)
stencil_p1_bs3_table_kernel(const T* __restrict__ x,
                            const T* __restrict__ table,
                            const unsigned char* __restrict__ cls,
                            T* __restrict__ y, int Z, int Y, int X, int C,
                            Segments seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [3][RUN + 2][SW]
  const int PS = Y * X;
  const size_t N = static_cast<size_t>(Z) * PS;  // one component's grid
  const int H = X + 1;
  const int SW = kTileT + 2 * H;
  const int CS = (RUN + 2) * SW;  // a component's planes in the stage
  const int t = threadIdx.x;
  const int p = blockIdx.x * kTileT + t;
  const bool active = p < PS;
  const SegmentOf g = segment_of(seg, blockIdx.y);
  const int z0 = g.zs + (blockIdx.y - g.r0) * RUN;
  const int nz = min(RUN, g.ze - z0);
  // the point's class, asked for before the stage is started: its weights
  // are W[(r * 15 + d) * 3 + s]
  const int cl =
      active ? __ldg(cls + static_cast<size_t>(g.pattern) * PS + p) : 0;
  const T* W = table + static_cast<size_t>(cl) * 3 * kP1Diagonals * 3;
  prefetch_table(table, C, t, kTileT);

  // planes z0 - 1 .. z0 + nz of each source component into the stage's
  // first nz + 2 planes, points [p0 - H, p0 + kTileT + H); zeros beyond
  // the grid.  A thread walks (component, plane, column) without dividing.
  {
    const int q0 = p - t - H;
    int j = t, pl = 0, c = 0;
    for (int i = t; i < 3 * (nz + 2) * SW; i += kTileT) {
      while (j >= SW) {
        j -= SW;
        if (++pl == nz + 2) {
          pl = 0;
          ++c;
        }
      }
      const int zz = z0 - 1 + pl;
      const int q = q0 + j;
      T* dst = s + c * CS + pl * SW + j;
      if (zz >= 0 && zz < Z && q >= 0 && q < PS) {
        if (TPUFEM_BS3_PHASE < 2)
          tpufem::cp_async_value(
              dst, x + c * N + static_cast<size_t>(zz) * PS + q);
      } else {
        *dst = T(0);
      }
      j += kTileT;
    }
  }
  const int iy = p / X;
  const int ix = p - iy * X;
  tpufem::cp_async_wait_all();
  __syncthreads();
  if (!active || TPUFEM_BS3_PHASE == 1) return;

  T acc[3][RUN];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int zl = 0; zl < RUN; ++zl) acc[r][zl] = T(0);
  const T* sp0 = s + SW + H + t;  // the thread's point on the run's plane 0
#pragma unroll
  for (int d = 0; d < kP1Diagonals; ++d) {
    const int dx = p1_shift(kP1Dx, d), dy = p1_shift(kP1Dy, d);
    const int dz = p1_shift(kP1Dz, d);
    // a neighbour past its row's or the plane's end: a zero weight (with
    // x finite, the product adds a zero, as the zero value of the padded
    // grid would)
    const bool in =
        static_cast<unsigned>(iy + dy) < static_cast<unsigned>(Y) &&
        static_cast<unsigned>(ix + dx) < static_cast<unsigned>(X);
    const T* col = sp0 + dy * X + dx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T w[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T v = TPUFEM_BS3_PHASE == 3
                        ? T(1) : __ldg(W + (r * kP1Diagonals + d) * 3 + c);
        w[r] = in ? v : T(0);
      }
#pragma unroll
      for (int zl = 0; zl < RUN; ++zl) {
        const T v = col[c * CS + (zl + dz) * SW];
#pragma unroll
        for (int r = 0; r < 3; ++r) acc[r][zl] += w[r] * v;
      }
    }
  }
#pragma unroll
  for (int zl = 0; zl < RUN; ++zl) {
    if (zl >= nz) break;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      y[r * N + static_cast<size_t>(z0 + zl) * PS + p] = acc[r][zl];
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

size_t bs3_table_smem(int run, int X, size_t item) {
  return static_cast<size_t>(run + 2) * 3 *
         (kTileT + 2 * (static_cast<size_t>(X) + 1)) * item;
}

// The table form's segments: 1 to kMaxSegments of them, covering planes
// 0 .. Z - 1 in order, each cut into runs of L.run planes, patterns that
// name one of cls's P.
bool segments_ok(const Bs3TableLaunch& L) {
  const Segments& g = L.seg;
  if (g.n < 1 || g.n > kMaxSegments || g.z[0] != 0 || g.z[g.n] != L.Z ||
      g.first_run[0] != 0)
    return false;
  for (int k = 0; k < g.n; ++k) {
    const int planes = g.z[k + 1] - g.z[k];
    if (planes < 1 || g.pattern[k] < 0 || g.pattern[k] >= L.P ||
        g.first_run[k + 1] - g.first_run[k] != (planes + L.run - 1) / L.run)
      return false;
  }
  return g.first_run[g.n] <= 65535;
}

template <typename T, int RUN>
int launch_table_run(const Bs3TableLaunch& L, const void* x, void* y,
                     size_t smem, void* stream) {
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(stencil_p1_bs3_table_kernel<T, RUN>),
      allowed, L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L.Y * L.X + kTileT - 1) / kTileT;
  stencil_p1_bs3_table_kernel<T, RUN>
      <<<dim3(tiles, L.seg.first_run[L.seg.n]), kTileT, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(L.table), L.cls,
          static_cast<T*>(y), L.Z, L.Y, L.X, L.C, L.seg);
  return static_cast<int>(cudaGetLastError());
}

// The three-component table form: table is [C, 3, 15, 3], cls [P, Y, X],
// the shifts the Kuhn stencil's.
template <typename T>
int launch_bs3_table(const void* prepared, const void* x, void* y,
                     void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Bs3TableLaunch& L = *static_cast<const Bs3TableLaunch*>(prepared);
  bool ok = L.D == kP1Diagonals && L.Z >= 1 && L.Y >= 1 && L.X >= 1 &&
            (L.per_point == 0 || L.per_point == 1) &&
            static_cast<long long>(L.Y) * L.X <= 0x3fffffffLL && L.C >= 1 &&
            L.C <= kMaxClasses && L.run >= 1 && L.run <= kRun3 &&
            segments_ok(L) && L.table != nullptr && L.cls != nullptr;
  for (int d = 0; ok && d < kP1Diagonals; ++d)
    ok = L.off.dx[d] == p1_shift(kP1Dx, d) &&
         L.off.dy[d] == p1_shift(kP1Dy, d) &&
         L.off.dz[d] == p1_shift(kP1Dz, d);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = L.per_point ? bs3_table_smem(L.run, L.X, sizeof(T))
                                  : bs3_smem(L.run, L.X, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (!L.per_point) {
    static size_t allowed[kMaxDevices] = {};
    const cudaError_t err = allow_smem(
        reinterpret_cast<const void*>(stencil_p1_bs3_kernel<T>),
        allowed, L.device, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (L.Y * L.X + kTile3 - 1) / kTile3;
    stencil_p1_bs3_kernel<T>
        <<<dim3(tiles, L.seg.first_run[L.seg.n]), kThreads3, smem,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(L.table), L.cls,
            static_cast<T*>(y), L.Z, L.Y, L.X, L.D, L.C, L.run, L.off,
            L.seg);
    return static_cast<int>(cudaGetLastError());
  }
  switch (L.run) {
    case 1: return launch_table_run<T, 1>(L, x, y, smem, stream);
    case 2: return launch_table_run<T, 2>(L, x, y, smem, stream);
    case 3: return launch_table_run<T, 3>(L, x, y, smem, stream);
    default: return launch_table_run<T, kRun3>(L, x, y, smem, stream);
  }
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

int tpufem_stencil_p1_bs3_table_f32(const void* prepared, const void* x,
                                    void* y, void* stream) {
  return launch_bs3_table<float>(prepared, x, y, stream);
}

int tpufem_stencil_p1_bs3_table_f64(const void* prepared, const void* x,
                                    void* y, void* stream) {
  return launch_bs3_table<double>(prepared, x, y, stream);
}

// Blocks of the float32 three-component table form's kernel (runs of
// kRun3 planes) resident on an SM with `smem` bytes of shared memory a
// block, or -(cuda error).
int tpufem_stencil_p1_bs3_blocks(int smem) {
  static size_t allowed[kMaxDevices] = {};
  int device = 0, n = 0;
  cudaError_t err = cudaGetDevice(&device);
  const void* kernel = reinterpret_cast<const void*>(
      stencil_p1_bs3_table_kernel<float, kRun3>);
  if (err == cudaSuccess)
    err = allow_smem(kernel, allowed, device, static_cast<size_t>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, stencil_p1_bs3_table_kernel<float, kRun3>, kTileT,
        static_cast<size_t>(smem));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
