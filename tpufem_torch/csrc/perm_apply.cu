// Apply of the blocked (bs = 3) per-perm element-matrix operator of P2/P3
// elasticity, for Hopper (sm_90a), on component-planar vectors
// (component a of scalar dof i at a * ns + i):
//
//   y = where(bc, x, A(where(bc, 0, x)))
//   (A u)[a, ko, q, so] = sum_{entries e = (p, lo) of output (ko, so)}
//       [cube c = q - off_lo inside the lattice]  Y[p, 3 lo + a, c]
//   Y[p, r, c] = sum_{li < n, b < 3} Ap[p][r][3 li + b] * u[b, src(p, li, c)]
//
// Every cube of the Kuhn lattice holds six tetrahedra (perms p) with one
// constant [3n, 3n] element matrix each (n = 10 at P2, 20 at P3); the
// local dof lo of perm p sits on the typed dof grid ko (the vertex grid,
// 7 edge types with k - 1 slots, 12 face types at P3) at the cube offset
// off_lo and slot so.  A (kind, slot) pair is a channel: 8 at P2, 27 at
// P3.  The tables, built by tpufem_torch/fem/perm_apply.py:pack_perm:
//
//   W       [6, 3n, 3n]   W[p, k, r] = Ap[p][r][k]: a column of Ap a row
//   entries [E]           p << 8 | lo << 3 | off_lo (x | y << 1 | z << 2)
//   outputs [O, 4]        (ko, so, first entry, count), heaviest first
//   sources [6 n]         3 (ch * kTileVol + tile offset of off_li): where
//                         source (p, li) of a cube sits in a brick's tile
//   chans   [C, 5]        (base + slot, X, Y, Z, slots) of channel ch
//   kinds   [K, 5]        (base, X, Y, Z, slots)
//   mask    [3 ns] bytes  the Dirichlet mask, planar
//
// Replaces tpufem's StructuredOperator.apply at bs = 3
// (tpufem/fem/structured_op.py:263-323), which XLA runs as an einsum per
// perm over stacked shifted slices: tpufem has no Pallas kernel for it.
// The plain PyTorch version is
// tpufem_torch/fem/perm_apply.py:perm_apply_plain.
//
// What bounds it on an H100: at P2 500k (24x24x32 cubes, 468,195 dofs)
// bytes, 4.24 MB of x, y and mask (0.0013 ms at 3.35 TB/s), beside 2 nnz
// = 72.3 MFLOP of the assembled matrix (0.0011 ms at 67 TFLOP/s); at P3
// 500k (16x16x24, 525,819 dofs) operations, 143.8 MFLOP (0.0021 ms).  The
// per-perm form does 6 cubes (3n)^2 multiply-adds, 99.5 M (P2) / 132.7 M
// (P3).  The first design gathered a mask byte and an x value from global
// memory for every one of them (a thread per output point and slice of
// its entries), and its time followed those gathers.
//
// The design: two kernels, no atomics.
// 1. perm_apply_cube_kernel: a block owns a brick of 8 x 2 x 2 cubes and
//    stages, once, the masked source values of the brick's cubes, 9 x 3 x
//    3 positions x C channels x 3 components ([ch][z][y][x][b], zero where
//    the mask is set or the position lies outside the channel's grid; the
//    halo is one position on the high side, as a cube's sources lie at
//    c + off, off in {0, 1}; the mask is read only in the bricks that
//    hold a Dirichlet dof, `bc`), and the element matrices of its perms.
//    It then computes, as a small matrix product a perm, Y[p, :, c] =
//    Ap[p] u(p, c) for its 32 cubes: a thread holds 6 rows x 4
//    neighbouring cubes (24 sums in registers), so each k step reads 6
//    weights and 4 values from shared memory for 24 fused multiply-adds;
//    each sum runs over k = 3 li + b in order.  Y goes to a scratch [6,
//    3n, cubes] in global memory (8.8 MB f32 at P3 500k: it stays in L2).
// 2. perm_apply_sum_kernel: a thread per output point (blockIdx.y the
//    output) adds the Y of its entries in plan order where the entry's cube
//    lies in the lattice (output-centric, in a fixed order), 8 entries'
//    loads in flight at a time; a masked output row writes x.
// The gathers of x fall from one a multiply-add to 3n a cube and perm,
// staged once; kernel 2 reads one Y value an entry and component.
//
// The brick, by arithmetic: 8 x 2 x 2 cubes (rows of 9 positions along
// x, the contiguous axis, against 5 for 4 x 4 x 2) make 192 bricks at P3
// 500k (16 x 16 x 24) and 576 at P2 (24 x 24 x 32); a thread tile of 6
// rows x 4 cubes gives 3n / 6 x 8 threads a perm (80 at P3, 40 at P2), so
// a block of 256 threads takes 3 perms at P3 (two blocks a brick: 384) or
// all 6 at P2.  Shared memory: the tile, 81 C 3 values (26.2 KB f32 /
// 52.5 KB f64 at P3), and the matrices of the block's perms, 3 x 3600
// (43.2 / 86.4 KB) at P3 or 6 x 900 at P2: within the 227 KB, and 3
// float32 blocks an SM (at most 85 registers a thread).  The tile is 2.5x
// the brick's cubes.  Measured on an H100 (PERF.md): the staging
// alone takes half the first kernel's time, latency-bound, and the
// second kernel a quarter of the whole.  What a launch needs beside x, y
// and the stream is a PermApplyLaunch packed once per operator, with the
// scratch Y.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "strip_common.cuh"

namespace {

constexpr int kCX = 8, kCY = 2, kCZ = 2;  // perm_apply.py:_BRICK, cubes
constexpr int kCubes = kCX * kCY * kCZ;
constexpr int kTX = kCX + 1, kTY = kCY + 1, kTZ = kCZ + 1;  // positions
constexpr int kTileVol = kTX * kTY * kTZ;  // perm_apply.py:_TILE_VOL
constexpr int kStage = 8;  // tile values a thread gathers at once
constexpr int kSumThreads = 256;
constexpr int kSumBatch = 8;  // entries whose Y a sum thread loads at once

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:PermApplyLaunch).
struct PermApplyLaunch {
  const void* W;                // [6, 3n, 3n]
  void* Y;                      // [6, 3n, cubes] scratch
  const int* entries;           // [E]
  const int* outputs;           // [nout, 4]
  const int* sources;           // [6 n]
  const int* kinds;             // [K, 5]
  const int* chans;             // [nchan, 5]
  const unsigned char* mask;    // [3 ns]
  const unsigned char* bc;      // [bricks]: 1 where the tile holds a
                                // Dirichlet dof
  int device, n, ns, nout, nchan, Nx, Ny, Nz, bx, by, bz, max_points;
};

// A block's threads on its brick: a thread computes kRows rows of Y (kRows
// / 3 local dofs x 3 components) for kCols neighbouring cubes, for one of
// the block's kPerms perms (blockIdx.y: which; perm_apply.py:_PERMS).
template <int NL>
struct Tiling {
  static constexpr int K = 3 * NL;                   // rows of Ap
  static constexpr int kRows = 6;
  static constexpr int kCols = 4;
  static constexpr int kThreads = 256;
  static constexpr int kPerPerm = (K / kRows) * (kCubes / kCols);
  // perms a block: as many as kThreads holds (6 at P2, 3 at P3)
  static constexpr int kPerms = kThreads / kPerPerm >= 6
                                    ? 6 : kThreads / kPerPerm;
  static_assert(K % kRows == 0 && kCX % kCols == 0 && 6 % kPerms == 0,
                "the tiles divide");
};

// Bytes of shared memory before the matrices: the source table and the
// tile, rounded up to 16 bytes for the matrices' 16-byte copies.
template <typename T, int NL>
__host__ __device__ inline int matrices_at(int nchan) {
  return (6 * NL * 4 + nchan * 3 * kTileVol * static_cast<int>(sizeof(T)) +
          15) / 16 * 16;
}

// R consecutive values of a column of Ap from shared memory, by 16-byte
// (or, for 6 floats, 8-byte) loads.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(p)[q];
      a[2 * q] = v.x;
      a[2 * q + 1] = v.y;
    }
  }
}

template <int R>
__device__ __forceinline__ void load_rows(const double* p, double (&a)[R]) {
#pragma unroll
  for (int q = 0; q < R / 2; ++q) {
    const double2 v = reinterpret_cast<const double2*>(p)[q];
    a[2 * q] = v.x;
    a[2 * q + 1] = v.y;
  }
}

// C consecutive cubes of a row of Y, by 16-byte stores.
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int C>
__device__ __forceinline__ void store_cols(double* p, const double (&v)[C]) {
#pragma unroll
  for (int q = 0; q < C / 2; ++q)
    reinterpret_cast<double2*>(p)[q] = make_double2(v[2 * q], v[2 * q + 1]);
}

// float32: at most 85 registers, so that 3 blocks share an SM
template <typename T, int NL>
__global__ void __launch_bounds__(Tiling<NL>::kThreads, sizeof(T) == 4 ? 3 : 2)
perm_apply_cube_kernel(const T* __restrict__ x, const T* __restrict__ W,
                       const int* __restrict__ sources,
                       const int* __restrict__ chans,
                       const unsigned char* __restrict__ mask,
                       const unsigned char* __restrict__ bc_bricks, int ns,
                       int nchan, int bx, int by, T* __restrict__ Yout,
                       long long ncubes) {
  using Tl = Tiling<NL>;
  constexpr int K = Tl::K, kRows = Tl::kRows, kCols = Tl::kCols;
  constexpr int kThreads = Tl::kThreads, kPerPerm = Tl::kPerPerm;
  constexpr int PA = Tl::kPerms;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src = reinterpret_cast<int*>(smem);                        // [6 NL]
  T* tile = reinterpret_cast<T*>(smem + 6 * NL * sizeof(int));    // [C,75,3]
  T* wa = reinterpret_cast<T*>(smem + matrices_at<T, NL>(nchan));  // [PA,K,K]
  const int brick = blockIdx.x;
  const int bxi = brick % bx, byi = (brick / bx) % by, bzi = brick / (bx * by);
  const int x0 = bxi * kCX, y0 = byi * kCY, z0 = bzi * kCZ;
  const bool bc = __ldg(bc_bricks + brick) != 0;  // else no mask to read
  for (int k = threadIdx.x; k < 6 * NL; k += kThreads) src[k] = sources[k];
  {  // the block's element matrices, transposed, in flight meanwhile
    constexpr int kChunks = PA * K * K * static_cast<int>(sizeof(T)) / 16;
    const char* w0 =
        reinterpret_cast<const char*>(W + PA * blockIdx.y * K * K);
    for (int k = threadIdx.x; k < kChunks; k += kThreads)
      tpufem::cp_async16(reinterpret_cast<char*>(wa) + 16 * k, w0 + 16 * k);
  }
  // the tile: neighbouring threads take neighbouring x of one row of a
  // channel, kStage values a thread at a time, each value and its mask
  // byte loaded together (a cp.async would have to wait for the mask
  // byte: one more round trip), the mask read only in a brick that holds
  // a Dirichlet dof
  const int nel = nchan * 3 * kTileVol;
  for (int k0 = threadIdx.x; k0 < nel; k0 += kThreads * kStage) {
    int to[kStage];
    T val[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * kThreads;
      const int kk = k < nel ? k : 0;
      const int tx = kk % kTX;
      int t = kk / kTX;
      const int ty = t % kTY;
      t /= kTY;
      const int tz = t % kTZ;
      t /= kTZ;
      const int b = t % 3;
      const int ch = t / 3;
      const int* c = chans + 5 * ch;
      const int X = __ldg(c + 1), Y = __ldg(c + 2), Z = __ldg(c + 3);
      const int gx = x0 + tx, gy = y0 + ty, gz = z0 + tz;
      const bool in =
          k < nel && static_cast<unsigned>(gx) < static_cast<unsigned>(X) &&
          static_cast<unsigned>(gy) < static_cast<unsigned>(Y) &&
          static_cast<unsigned>(gz) < static_cast<unsigned>(Z);
      const int from =
          b * ns + __ldg(c) + ((gz * Y + gy) * X + gx) * __ldg(c + 4);
      to[u] = k < nel ? 3 * ((ch * kTZ + tz) * kTY * kTX + ty * kTX + tx) + b
                      : -1;
      const T v = in ? __ldg(x + from) : T(0);
      val[u] = in && bc && __ldg(mask + from) ? T(0) : v;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (to[u] >= 0) tile[to[u]] = val[u];
  }
  // this thread's place: a perm slot, 6 rows from r0, 4 cubes of a row
  const int pslot = threadIdx.x / kPerPerm;
  const int local = threadIdx.x % kPerPerm;
  const int r0 = kRows * (local / (kCubes / kCols));
  const int cb = local % (kCubes / kCols);  // (kCols cubes along x, cy, cz)
  const int cx = kCols * (cb % (kCX / kCols));
  const int cy = (cb / (kCX / kCols)) % kCY, cz = cb / (kCX / kCols * kCY);
  const int tbase = 3 * ((cz * kTY + cy) * kTX + cx);  // its first cube
  const long long col = (static_cast<long long>(z0 + cz) * (by * kCY) +
                         (y0 + cy)) * (bx * kCX) + x0 + cx;  // its Y column
  {
    tpufem::cp_async_wait_all();
    __syncthreads();
    if (pslot >= PA) return;
    const int p = PA * blockIdx.y + pslot;
    const T* ap = wa + pslot * K * K + r0;  // ap[k K + i]: Ap[p][r0 + i][k]
    const int* s = src + p * NL;
    T acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = T(0);
#pragma unroll 2
    for (int li = 0; li < NL; ++li) {
      const T* u = tile + tbase + s[li];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T* ak = ap + (3 * li + b) * K;
        T a[kRows], v[kCols];
        load_rows<kRows>(ak, a);
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[j] = u[3 * j + b];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fma(a[i], v[j], acc[i][j]);
      }
    }
    T* out = Yout + (static_cast<long long>(p) * K + r0) * ncubes + col;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      store_cols<kCols>(out + i * ncubes, acc[i]);
  }
}

// Output-centric sums: the thread of (output blockIdx.y, point q) adds the
// Y of the output's entries in plan order where the cube lies in the
// lattice.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
perm_apply_sum_kernel(const T* __restrict__ x, const T* __restrict__ Y,
                      const int* __restrict__ entries,
                      const int* __restrict__ outputs,
                      const int* __restrict__ kinds,
                      const unsigned char* __restrict__ mask, int ns, int K,
                      int Nx, int Ny, int Nz, int NxP, int NyP,
                      long long ncubes, T* __restrict__ y) {
  const int* out = outputs + 4 * blockIdx.y;
  const int ko = __ldg(out), so = __ldg(out + 1), first = __ldg(out + 2);
  const int count = __ldg(out + 3);
  const int* kd = kinds + 5 * ko;
  const int Xo = __ldg(kd + 1), Yo = __ldg(kd + 2), Zo = __ldg(kd + 3);
  const int q = blockIdx.x * kSumThreads + threadIdx.x;
  if (q >= Xo * Yo * Zo) return;
  const int qx = q % Xo, qy = (q / Xo) % Yo, qz = q / (Xo * Yo);
  // kSumBatch entries at a time: all their Y values in flight, then added
  // in entry order (an entry whose cube lies outside adds 0: exact)
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  for (int e0 = 0; e0 < count; e0 += kSumBatch) {
    T v[kSumBatch][3];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int e = e0 + u;
      const int code = __ldg(entries + first + (e < count ? e : 0));
      const int cx = qx - (code & 1), cy = qy - ((code >> 1) & 1);
      const int cz = qz - ((code >> 2) & 1);
      const bool in = e < count &&
                      static_cast<unsigned>(cx) < static_cast<unsigned>(Nx) &&
                      static_cast<unsigned>(cy) < static_cast<unsigned>(Ny) &&
                      static_cast<unsigned>(cz) < static_cast<unsigned>(Nz);
      const int p = code >> 8, lo = (code >> 3) & 31;
      const T* yp = Y + (static_cast<long long>(p) * K + 3 * lo) * ncubes +
                    (static_cast<long long>(cz) * NyP + cy) * NxP + cx;
#pragma unroll
      for (int a = 0; a < 3; ++a) v[u][a] = in ? __ldg(yp + a * ncubes) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      acc0 += v[u][0];
      acc1 += v[u][1];
      acc2 += v[u][2];
    }
  }
  const int at = __ldg(kd) + q * __ldg(kd + 4) + so;
  const T acc[3] = {acc0, acc1, acc2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ja = at + a * ns;
    y[ja] = __ldg(mask + ja) ? __ldg(x + ja) : acc[a];
  }
}

template <typename T, int NL>
cudaError_t launch_nl(const PermApplyLaunch& L, const void* x, void* y,
                      cudaStream_t stream) {
  constexpr int K = 3 * NL;
  const size_t smem =
      matrices_at<T, NL>(L.nchan) +
      static_cast<size_t>(Tiling<NL>::kPerms) * K * K * sizeof(T);
  if (smem > tpufem::kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        perm_apply_cube_kernel<T, NL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int NxP = L.bx * kCX, NyP = L.by * kCY;
  const long long ncubes = static_cast<long long>(NxP) * NyP * L.bz * kCZ;
  const dim3 grid_c(static_cast<unsigned>(L.bx * L.by * L.bz),
                    static_cast<unsigned>(6 / Tiling<NL>::kPerms));
  perm_apply_cube_kernel<T, NL><<<grid_c, Tiling<NL>::kThreads, smem,
                                  stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(L.W), L.sources,
          L.chans, L.mask, L.bc, L.ns, L.nchan, L.bx, L.by,
          static_cast<T*>(L.Y), ncubes);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((L.max_points + kSumThreads - 1) /
                                        kSumThreads),
                  static_cast<unsigned>(L.nout));
  perm_apply_sum_kernel<T><<<grid, kSumThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.Y), L.entries,
      L.outputs, L.kinds, L.mask, L.ns, K, L.Nx, L.Ny, L.Nz, NxP, NyP, ncubes,
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PermApplyLaunch& L = *static_cast<const PermApplyLaunch*>(prepared);
  if (L.W == nullptr || L.Y == nullptr || L.entries == nullptr ||
      L.outputs == nullptr || L.sources == nullptr || L.kinds == nullptr ||
      L.chans == nullptr || L.mask == nullptr || L.bc == nullptr ||
      L.nout < 1 ||
      L.nout > 65535 || L.ns < 1 || 3LL * L.ns > 0x7fffffffLL || L.Nx < 1 ||
      L.Ny < 1 || L.Nz < 1 || L.nchan < 1 || L.bx < 1 || L.by < 1 ||
      L.bz < 1 || static_cast<long long>(L.bx) * L.by * L.bz > 0x7fffffffLL ||
      L.max_points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L.n) {
    case 10:
      return static_cast<int>(launch_nl<T, 10>(L, x, y, s));
    case 20:
      return static_cast<int>(launch_nl<T, 20>(L, x, y, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int tpufem_perm_apply_f32(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_perm_apply_f64(const void* prepared, const void* x, void* y,
                          void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
