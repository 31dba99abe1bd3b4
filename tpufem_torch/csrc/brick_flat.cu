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
// multiply and one add per field and point (7.9 MFLOP); at the m = 1
// levels 1-2 MB, where a launch and a round trip to HBM are the floor.
//
// The first design ran one thread a point in 256-thread blocks: 150
// blocks at m = 6 (about one an SM), 77 at m = 1, and each thread walked
// its nf terms with three compares and a select around every x load, so
// each load waited for the one before (0.0326-0.0343 ms at m = 6, 0.0068
// at m = 1, counted after an L2 flush; NVIDIA H100 80GB HBM3, 700.00 W).
// This design:
//
// - A block owns a tile: `rows` rows x `lanes` lanes of one z plane (the
//   whole row where W <= 128, and then as many rows as leave two blocks
//   an SM; a strip of a row where W is wider), chosen once per level by
//   brick_flat.py:brick_flat_tiling.  The tile's points are one run of
//   F's and y's flat order.
// - x for the tile and its halo (the planes either side, a row either
//   side, `reach` = 2m - 1 lanes either side) is staged once in shared
//   memory with zeros outside the grid (cp.async with a zero source
//   size), so a term reads x at one offset from the point's own, with no
//   bounds test and no select.
// - The fields stream through a ring of two register stages of kChunk
//   terms: all of chunk c + 1's loads go out before chunk c's
//   products, so a thread keeps kChunk to 2 kChunk loads in flight and no
//   branch stands between a load and its product.  A thread owns one
//   point.
// - Each point's sum runs over the terms in plan order from -0.0 (so the
//   first product stands as it is), the product and the sum rounded apart
//   (no fused multiply-add), so the kernel gives the plain version's bits.
//   A thread past the tile's last point inside the grid computes that
//   point again and stores nothing.
// - A plan shift outside the box (|dz| or |dy| > 1, |s| > reach: a packed
//   launch whose reach is below the plan's shifts) makes every block
//   store NaN and read nothing outside the box; prepare_brick_flat refuses
//   such a plan before it packs a launch.
//
// Measured (scripts/brick_flat_times.py; device time after an L2 flush,
// NVIDIA H100 80GB HBM3, 700.00 W): m = 6 f32 0.0151-0.0152 ms against
// the first design's 0.0334 in the same run (f64 0.0246-0.0251 against
// 0.0375), m = 1 0.0042-0.0048 against 0.0067-0.0070.  Its field loads
// alone take 0.0141 ms (2.3 TB/s).  Measured slower at m = 6 f32:
// shared-memory rings of 16-byte cp.async stages (0.0217-0.0245 ms
// whatever their depth) and of 1-D bulk copies (TMA) on an mbarrier
// (0.0163-0.0187; f64 0.0316), two adjacent points a thread with one
// vector load a term (0.0246-0.0254), and a whole chunk with no test on
// its length (0.0155, but f64 0.0295 at 198 registers).
//
// What a launch needs beside x, y and the stream is a BrickFlatLaunch
// packed once per level (the fields, the plan, the dims and the tiling).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "strip_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxFields = 4096;  // tpufem_torch/la/brick_flat.py:MAX_FIELDS
constexpr int kChunk = 32;        // terms a register stage (two a thread)

// Everything a launch needs beside x, y and the stream, filled once per
// level (mirrored by tpufem_torch/_build.py:BrickFlatLaunch).
struct BrickFlatLaunch {
  const void* F;     // [nf, az, ay, W] weight fields
  const int* plan;   // [nf, 3] (dz, dy, s)
  int device, az, ay, W, nf;
  int rows, lanes;   // a tile: rows x lanes of one plane (rows > 1: lanes = W)
  int reach;         // halo lanes either side of the tile (max |s|)
  int threads;       // a block's threads, a multiple of 32
};

// What the kernel derives from a launch: the tiles along y and x', the
// staged box's row length.
struct Shape {
  int ytiles, xtiles, bx;
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
__global__ void __launch_bounds__(kMaxThreads)
brick_flat_kernel(const T* __restrict__ x, const T* __restrict__ F,
                  const int* __restrict__ plan, T* __restrict__ y,
                  BrickFlatLaunch L, Shape sh) {
  constexpr int C = kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bx = sh.bx;
  int* xoff = reinterpret_cast<int*>(smem_raw);  // [nf]
  T* box = reinterpret_cast<T*>(smem_raw) +
           (L.nf * sizeof(int) + sizeof(T) - 1) / sizeof(T);  // [3][rows+2][bx]

  const int az = L.az, ay = L.ay, W = L.W, nf = L.nf;
  const int rows = L.rows, lanes = L.lanes, R = L.reach;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  int b = blockIdx.x;
  const int tx = b % sh.xtiles;
  b /= sh.xtiles;
  const int ty = b % sh.ytiles, z = b / sh.ytiles;
  const int y0 = ty * rows, x0 = tx * lanes;
  const int vrows = min(rows, ay - y0), vlanes = min(lanes, W - x0);
  const long long n = static_cast<long long>(az) * ay * W;
  // the tile's points inside the grid, in F's and y's flat order:
  // [p0, p0 + run)
  const long long p0 = (static_cast<long long>(z) * ay + y0) * W + x0;
  const int run = (vrows - 1) * lanes + vlanes;

  // the box: x of the tile's rows and one either side, on the planes
  // z - 1, z, z + 1, with `reach` lanes either side; zeros outside
  const int brow = rows + 2;
  for (int r = warp; r < 3 * brow; r += nwarps) {
    const int gz = z + r / brow - 1, gy = y0 + r % brow - 1;
    const bool rok = gz >= 0 && gz < az && gy >= 0 && gy < ay;
    const T* xrow =
        x + (static_cast<long long>(rok ? gz : 0) * ay + (rok ? gy : 0)) * W;
    for (int c = lane; c < bx; c += 32) {
      const int gx = x0 + c - R;
      const bool ok = rok && gx >= 0 && gx < W;
      tpufem::cp_async_value_or_zero(box + r * bx + c, ok ? xrow + gx : x,
                                     ok);
    }
  }
  // a term's x offset in the box from its point's own; a shift the box
  // does not hold marks the plan bad
  int bad = 0;
  for (int k = tid; k < nf; k += nthr) {
    const int dz = plan[3 * k], dy = plan[3 * k + 1], s = plan[3 * k + 2];
    bad |= dz < -1 || dz > 1 || dy < -1 || dy > 1 || s < -R || s > R;
    xoff[k] = ((1 + dz) * brow + 1 + dy) * bx + R + s;
  }

  // this thread's point (past the run: the run's last, not stored)
  const int l = min(tid, run - 1);
  const int xb = (l / lanes) * bx + l % lanes;
  const T* f0 = F + p0 + l;
  // a register stage: chunk c's field values (terms past nf read the
  // last field again and are not summed)
  auto load = [&](int c, T (&r)[C]) {
#pragma unroll
    for (int kk = 0; kk < C; ++kk) {
      const long long k = min(c * C + kk, nf - 1);
      r[kk] = __ldg(f0 + k * n);
    }
  };
  const int nch = (nf + C - 1) / C;
  T acc = T(-0.0), cur[C], nxt[C];
  load(0, cur);
  tpufem::cp_async_wait_all();
  // a bad plan (a packed launch whose reach is below its shifts) reads
  // nothing outside the box: the tile's points are NaN
  const bool store =
      tid < rows * lanes && tid / lanes < vrows && tid % lanes < vlanes;
  if (__syncthreads_or(bad)) {
    if (store) y[p0 + tid] = static_cast<T>(CUDART_NAN);
    return;
  }

  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load(c + 1, nxt);
    const int k0 = c * C, cnt = min(C, nf - k0);
#pragma unroll
    for (int kk = 0; kk < C; ++kk) {
      if (kk < cnt)
        acc = add_rn(acc, mul_rn(cur[kk], box[xb + xoff[k0 + kk]]));
    }
#pragma unroll
    for (int kk = 0; kk < C; ++kk) cur[kk] = nxt[kk];
  }

  if (store) y[p0 + tid] = acc;
}

template <typename T>
size_t smem_bytes(const BrickFlatLaunch& L, const Shape& sh) {
  const size_t table = (static_cast<size_t>(L.nf) * sizeof(int) +
                        sizeof(T) - 1) / sizeof(T) * sizeof(T);
  return table + sizeof(T) * 3 * static_cast<size_t>(L.rows + 2) * sh.bx;
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const BrickFlatLaunch& L = *static_cast<const BrickFlatLaunch*>(prepared);
  if (L.F == nullptr || L.plan == nullptr ||
      reinterpret_cast<size_t>(L.F) % sizeof(T) != 0 || L.az < 1 || L.ay < 1 ||
      L.W < 1 || L.nf < 1 || L.nf > kMaxFields || L.rows < 1 ||
      L.rows > L.ay || L.lanes < 1 || L.lanes > L.W ||
      (L.rows > 1 && L.lanes != L.W) || L.reach < 0 || L.threads < 32 ||
      L.threads > kMaxThreads || L.threads % 32 != 0 ||
      L.threads < L.rows * L.lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.ytiles = (L.ay + L.rows - 1) / L.rows;
  sh.xtiles = (L.W + L.lanes - 1) / L.lanes;
  sh.bx = L.lanes + 2 * L.reach;
  const long long blocks =
      static_cast<long long>(L.az) * sh.ytiles * sh.xtiles;
  const size_t smem = smem_bytes<T>(L, sh);
  if (blocks > 0x7fffffffLL || smem > tpufem::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        brick_flat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  brick_flat_kernel<T><<<static_cast<unsigned>(blocks), L.threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.F), L.plan,
      static_cast<T*>(y), L, sh);
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
