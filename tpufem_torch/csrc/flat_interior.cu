// Channel-plane P2/P3 interior product for Hopper (sm_90a).
//
// Replaces the TPU kernel K5, tpufem/fem/flat_op.py:308
// FlatOperator._interior_pallas (pallas_call at :367).  On a plane buffer
// x, y [Zp, CP, LW] (plane bp, channel c, lane l), for every buffer plane
// 1 <= bp <= Zc and every lane l = G + t, t < TILE:
//
//   y[bp, co, l] = sum_j sum_ci WT_bp[co, j * CP + ci]
//                             * x[bp + dz_j, ci, l + off_j]
//
// with WT_bp = W0 + AZT[slot_of[bp - 1]] where that slot is >= 0 (the 7
// z-boundary planes) and W0 elsewhere; every other plane and the guard
// lanes are written as zeros (the caller allocates y with torch.empty,
// and a NaN left there would survive the fmask product).  The plain
// PyTorch version is tpufem_torch/fem/flat_op.py:FlatOperator.
// interior_plain.
//
// What bounds it on an H100: bytes, by the roofline (x and y once, ~9.9
// MB at the 500k-dof P3 operator, ~3 us at 3.35 TB/s, against 0.066
// GFLOP of needed FP32 FMA, ~1 us); in practice the shared-memory load
// rate, one 4-byte load per multiply-add.  The TPU kernel runs a dense
// [CP, K] x [K, TILE] product per plane on its matrix unit, but WT_bp is
// 8.5% nonzero at P3 and 24% at P2, and tpufem runs the product at
// Precision.HIGHEST, which rules out TF32 here: the FP32 pipes would
// spend 12x the needed work on zeros.
//
// The design: the work follows the nonzeros.  The wrapper builds, once
// per operator, the union of the nonzero positions of W0 and every AZT
// slot as CSR by output channel, in ascending k = j * CP + ci (the order
// of a dense k loop, so skipping a zero weight changes no bit of a finite
// sum), and the weights of every plane variant [1 + NZP, nnz].  A block
// owns one buffer plane and 32 R lanes (R = 4, or 2 where two blocks of
// 128 lanes do not fit an SM's shared memory): it copies the three
// source planes bp - 1, bp, bp + 1 of all CP channels over its lanes and
// a halo of max |off_j| lanes each side into shared memory with 16-byte
// cp.async (every source value leaves L2 once per block), and its plane's
// entries as (shared-memory offset, weight) pairs.  A warp then takes one
// output channel at a time: per entry one broadcast load of the pair, and
// per lane one shared load and one fused multiply-add (R lanes a thread,
// 32 apart, so every load is conflict-free).  Blocks of halo planes and
// guard lanes write zeros.  A ring over consecutive planes (2 of 3 staged
// planes reused) and register tiling over dx are later work.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "strip_common.cuh"

namespace {

using tpufem::cp_async16;
using tpufem::cp_async_wait_all;
using tpufem::kMaxSmem;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// Everything a launch needs beside x, y and the stream, filled once per
// operator and dtype (mirrored by tpufem_torch/_build.py:FlatLaunch).
struct FlatLaunch {
  const int* ptr;      // [CP + 1] entry range of each output channel
  const int* ent;      // [nnz, 2] (source row (dz + 1) * CP + ci, lane offset)
  const void* val;     // [nvar, nnz] weights: row 0 W0, row 1 + s W0 + AZT[s]
  const int* slot_of;  // [>= Zc] body plane -> AZT slot or -1
  int device, CP, Zc, Zp, LW, TILE, G, halo, nnz, nvar;
  int lanes;  // lanes a thread: 2, 4, or 0 for the launch to choose
};

// (offset into the staged planes, weight): one broadcast shared load.
template <typename T>
struct Entry;
template <>
struct __align__(8) Entry<float> {
  int off;
  float w;
};
template <>
struct __align__(16) Entry<double> {
  int off;
  int pad;
  double w;
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
flat_interior_kernel(const T* __restrict__ x, FlatLaunch L, int H,
                     T* __restrict__ y) {
  constexpr int TL = 32 * R;               // lanes of a block
  constexpr int V = 16 / sizeof(T);        // values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SW = TL + 2 * H;               // staged lanes of a row
  const int rows = 3 * L.CP;               // (plane bp - 1 + pz, channel)
  T* sx = reinterpret_cast<T*>(smem_raw);  // [rows][SW]
  Entry<T>* ents = reinterpret_cast<Entry<T>*>(sx + rows * SW);
  int* sptr = reinterpret_cast<int*>(ents + L.nnz);
  const int tid = threadIdx.x;
  const int bp = blockIdx.y;
  const int l0 = blockIdx.x * TL;
  // G and TILE are multiples of 128, so a block is all body or all guard
  const bool body = bp >= 1 && bp <= L.Zc && l0 >= L.G && l0 < L.G + L.TILE;
  if (!body) {
    T* out = y + static_cast<size_t>(bp) * L.CP * L.LW + l0;
    for (int i = tid; i < L.CP * (TL / V); i += kThreads) {
      const int c = i / (TL / V);
      const int v = i - c * (TL / V);
      reinterpret_cast<float4*>(out + static_cast<size_t>(c) * L.LW)[v] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // the three source planes: buffer rows (bp - 1) * CP + [0, 3 CP) are
  // contiguous, each copied over lanes [l0 - H, l0 + TL + H)
  const T* src = x + static_cast<size_t>(bp - 1) * L.CP * L.LW + l0 - H;
  const int vpr = SW / V;
  for (int i = tid; i < rows * vpr; i += kThreads) {
    const int row = i / vpr;
    const int v = (i - row * vpr) * V;
    cp_async16(sx + row * SW + v, src + static_cast<size_t>(row) * L.LW + v);
  }
  const int slot = __ldg(L.slot_of + bp - 1);
  const T* val = static_cast<const T*>(L.val) +
                 static_cast<size_t>(slot >= 0 ? 1 + slot : 0) * L.nnz;
  const int2* ent = reinterpret_cast<const int2*>(L.ent);
  for (int i = tid; i < L.nnz; i += kThreads) {
    const int2 e = __ldg(ent + i);
    Entry<T> o{};
    o.off = e.x * SW + H + e.y;
    o.w = __ldg(val + i);
    ents[i] = o;
  }
  for (int i = tid; i <= L.CP; i += kThreads) sptr[i] = __ldg(L.ptr + i);
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31;
  for (int co = tid >> 5; co < L.CP; co += kWarps) {
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
    const int e1 = sptr[co + 1];
#pragma unroll 4
    for (int e = sptr[co]; e < e1; ++e) {
      const Entry<T> en = ents[e];
      const T* s = sx + en.off + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fma(en.w, s[32 * r], acc[r]);
    }
    T* out = y + (static_cast<size_t>(bp) * L.CP + co) * L.LW + l0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) out[32 * r] = acc[r];
  }
}

// Raises the kernel's dynamic shared-memory limit on the current device
// once to at least `smem` bytes (the attribute call costs host time).
template <typename T, int R>
cudaError_t allow_smem(int device, size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flat_interior_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

// Dynamic shared memory of a block of 32 R lanes.
template <typename T>
size_t smem_bytes(const FlatLaunch& L, int R) {
  const int H = (L.halo + 3) & ~3;  // 16-byte copies in either type
  return static_cast<size_t>(3) * L.CP * (32 * R + 2 * H) * sizeof(T) +
         static_cast<size_t>(L.nnz) * sizeof(Entry<T>) +
         (L.CP + 1) * sizeof(int);
}

template <typename T, int R>
int launch_lanes(const FlatLaunch& L, const void* x, void* y, void* stream) {
  const size_t smem = smem_bytes<T>(L, R);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaError_t err = allow_smem<T, R>(L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L.LW / (32 * R), L.Zp);
  flat_interior_kernel<T, R><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), L, (L.halo + 3) & ~3, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const FlatLaunch& L = *static_cast<const FlatLaunch*>(prepared);
  if (L.CP <= 0 || L.CP % 8 != 0 || L.Zc <= 0 || L.Zp < L.Zc + 2 ||
      L.G <= 0 || L.G % 128 != 0 || L.TILE <= 0 || L.TILE % 128 != 0 ||
      L.LW % 128 != 0 || L.halo < 0 || L.halo > L.G ||
      L.LW < L.G + L.TILE + ((L.halo + 3) & ~3) || L.nnz < 0 || L.nvar < 1 ||
      reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // lanes a thread: 4 where two blocks of 128 lanes fit an SM's shared
  // memory (they overlap one's copies with the other's sums), else 2
  int lanes = L.lanes;
  if (lanes == 0) lanes = 2 * (smem_bytes<T>(L, 4) + 1024) <= kMaxSmem ? 4 : 2;
  if (lanes == 4) return launch_lanes<T, 4>(L, x, y, stream);
  if (lanes == 2) return launch_lanes<T, 2>(L, x, y, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int tpufem_flat_interior_f32(const void* prepared, const void* x, void* y,
                             void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_flat_interior_f64(const void* prepared, const void* x, void* y,
                             void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
