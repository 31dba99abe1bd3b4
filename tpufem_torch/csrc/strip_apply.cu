// Channel-strip P2/P3 stencil apply y = A x for Hopper (sm_90a).
//
// Replaces the TPU kernel K3, tpufem/fem/strip_op.py:300
// StripOperator._apply_pallas (pallas_call at :349): per output channel
// co, the mid strips times the source strips shifted by (dz planes,
// dy * Xp + dx lanes) over the channel's whole z range, plus the sparse
// z-boundary delta rows; pad, guard and out-of-extent planes written as
// zeros.  The plan arrives as int32 CSR tables (strip_common.cuh), built
// once per operator; the plain PyTorch version is
// tpufem_torch/fem/strip_op.py:StripOperator.apply_strips_plain.
//
// What bounds it on an H100: bytes, by the roofline.  One apply must read
// x once, the weight packs once and write y once: at the 500k-dof P3
// operator (C = 27 channels, [27, 35, 1024] f32 buffers, 1311 mid + 732
// delta strips of 768) that is 3.87 + 6.28 + 3.87 MB ~ 14 MB, ~4.2 us at
// 3.35 TB/s, against ~66 MFLOP (~1 us at 67 TFLOP/s of f32).  In practice
// the rate at which an SM takes memory instructions: every multiply-add
// needs its own shifted source value, so the 33 M multiply-adds of that
// operator are 1.0 M warp-wide 4-byte loads, and an SM was measured to
// take one such load in about two cycles (with the weights' and the
// entries' loads, ~1,500 cycles for a round of 16 warps x 8 terms x 4
// planes); then what comes out of L2, at ~2.7 TB/s in all.  A mid weight
// is a function of the lane only; a kernel that reads it again for every
// z plane moves 4 MB of weights 33 times through L2 and L1, and a term at
// a time (entry -> weight -> source) is a chain of dependent loads.
//
// The design:
//
// - A block owns 32 lanes of every channel for a run of z planes (at most
//   kRun; the z range is cut into equal runs, so that 24 lane columns of
//   the 500k-dof P3 operator give 120 blocks for 132 SMs).  Blocks of the
//   guard columns only write zeros.  A block has 512 threads, or 256 where
//   four blocks' shared memory fits an SM (the 8 channels of P2).
// - The source planes of the run and one either side, all channels, the
//   block's lanes and a halo of max |off| lanes, are copied to shared
//   memory once with 16-byte cp.async: each source value leaves L2 once
//   per block, and the ~48 reads per output hit shared memory.
// - The work of a block is cut into units (output channel, kGroup planes)
//   that its warps draw from a counter, heaviest channels first (the
//   vertex channel of P3 has 175 mid entries, an interior one 30).  A
//   thread keeps its lane: a mid weight goes from global memory straight
//   into a register and serves the unit's kGroup planes, so a weight
//   leaves L2 once per kGroup planes; nothing else in the block needs it,
//   so it is not staged.
// - The plan's mid entries are turned once into (weight offset, offset
//   into the staged planes) pairs in shared memory; the terms run in
//   batches, every load of a batch before its sums, the next batch's
//   entries and weights loaded before this batch's sums (with 16 warps on
//   the SM the others' batches cover the load's way from L2; weights sent
//   four batches ahead through a ring in shared memory cost more loads
//   than they saved waiting), with clamped indices and only the sum
//   guarded.
// - Whatever a block reads from global memory it asks for in as few
//   dependent steps as there are: the planes, the mid entries and the
//   tables of the plan's rows at once, then the run's delta entries, then
//   their weights.
// - The delta rows of the run's planes (the three planes at either z end
//   of a channel, every plane of a channel under 7 planes), entries and
//   weights of the block's lanes, are copied to shared memory with the
//   planes, and added after the mid terms.  Where the delta weights of a
//   run do not fit beside its planes (a halo of 124 lanes), only the
//   entries are staged and the weights come from global memory as the mid
//   weights do.
// - The sum order is the plan's: mid terms, then delta terms, one
//   accumulator per output, so the result does not depend on the run or
//   the unit an output falls into.
//
// The wrapper chooses the run, and whether the delta weights are staged,
// from the bytes a block needs (227 KB at most), and passes them with
// everything else that does not change between calls in a StripLaunch,
// packed once per operator.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "strip_common.cuh"

namespace {

using tpufem::cp_async16;
using tpufem::cp_async_wait_all;
using tpufem::kMaxSmem;
using tpufem::StripPlan;

// The shape of a block, fixed from measurements on an H100
// (scripts/kernel_shapes.py rebuilds with other values through these
// macros; tpufem_torch/fem/strip_op.py mirrors kRun).
#ifndef TPUFEM_STRIP_THREADS
#define TPUFEM_STRIP_THREADS 512
#endif
#ifndef TPUFEM_STRIP_SMALL_THREADS
#define TPUFEM_STRIP_SMALL_THREADS 256
#endif
#ifndef TPUFEM_STRIP_RUN
#define TPUFEM_STRIP_RUN 8
#endif
// threads of a block: kThreads where a block's shared memory leaves room
// for no second block on the SM (its 16 warps are then all the SM has to
// cover each other's loads), kSmallThreads where four blocks fit (few
// channels: more and smaller blocks fill the card and overlap one's
// copies with another's sums)
constexpr int kThreads = TPUFEM_STRIP_THREADS;
constexpr int kSmallThreads = TPUFEM_STRIP_SMALL_THREADS;
constexpr int kLanes = 32;   // lanes of a block: one warp wide
constexpr int kRun = TPUFEM_STRIP_RUN;  // most planes of a block's z run
constexpr int kGroup = 4;    // planes of a unit: a weight serves them all
constexpr int kMaxDevices = 64;

// Everything a launch needs beside x, y and the stream, filled once per
// operator and dtype (mirrored by tpufem_torch/_build.py:StripLaunch).
struct StripLaunch {
  const void* mid;      // [NT, TILE] mid strips
  const void* dlt;      // [ND, TILE] delta rows
  const int* mid_ptr;   // the plan's tables (strip_common.cuh)
  const int* mid_ent;
  const int* dlt_ptr;
  const int* dlt_ent;
  const int* zk;
  const int* order;     // [C] output channels, most mid entries first
  int device, C, Zc, Zp, LW, TILE, G;
  int halo;   // max |lane offset| of the plan
  int nmid;   // mid entries of all channels
  int run;    // planes of a block's z run
  int dcap;   // most delta entries of one run
  int stage_delta_weights;  // the run's delta weights fit shared memory
};

template <typename T>
struct Args {
  const T* x;
  const T* mid;
  const T* dlt;
  StripPlan P;
  const int* order;
  int H;     // staged halo lanes each side (a multiple of 4)
  int nmid;
  int run;
  int dcap;
  int dwcap;  // delta weight rows in shared memory: dcap or 0
  T* y;
};

// acc[pz] += sum over the entries [e0, e1) of ents of weight * source for
// NP planes pz, in the entries' order: the weight of entry e is
// wts[ents[e].x] (global memory), its source on plane pz is
// sxl[ents[e].y + poff[pz]] (shared memory).  Batches of B entries; the
// next batch's entries and weights are loaded before this batch's sums.
// A short last batch loads its last entry again (no branch around a
// load) and leaves it out of the sums.
template <typename T, int NP>
__device__ __forceinline__ void global_terms(T (&acc)[NP], const int2* ents,
                                             int e0, int e1,
                                             const T* __restrict__ wts,
                                             const T* sxl,
                                             const int (&poff)[NP]) {
  constexpr int B = 32 / sizeof(T);
  if (e0 >= e1) return;
  int so[B];
  T w[B];
#pragma unroll
  for (int j = 0; j < B; ++j) {
    const int2 m = ents[min(e0 + j, e1 - 1)];
    so[j] = m.y;
    w[j] = __ldg(wts + m.x);
  }
  for (int e = e0; e < e1; e += B) {
    T wc[B];
    T v[B][NP];
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int pz = 0; pz < NP; ++pz) v[j][pz] = sxl[so[j] + poff[pz]];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      wc[j] = w[j];
      const int2 m = ents[min(e + B + j, e1 - 1)];
      so[j] = m.y;
      w[j] = __ldg(wts + m.x);
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int pz = 0; pz < NP; ++pz)
        if (e + j < e1) acc[pz] += wc[j] * v[j][pz];
  }
}

// acc plus the staged delta entries [e0, e1) of one (channel, plane) row,
// weights too from shared memory: weight dwl[e * kLanes], source
// sxl[dents[e].y].
template <typename T>
__device__ __forceinline__ T staged_terms(T acc, const int2* dents, int e0,
                                          int e1, const T* dwl, const T* sxl) {
  constexpr int B = 32 / sizeof(T);
  for (int e = e0; e < e1; e += B) {
    T w[B], v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int k = min(e + j, e1 - 1);
      w[j] = dwl[k * kLanes];
      v[j] = sxl[dents[k].y];
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (e + j < e1) acc += w[j] * v[j];
  }
  return acc;
}

// Zeros over the block's lanes of buffer planes [pa, pb) of every channel.
template <typename T>
__device__ __forceinline__ void zero_planes(T* y, const StripPlan& P, int l0,
                                            int pa, int pb) {
  const int per = (pb - pa) * kLanes;
  for (int i = threadIdx.x; i < P.C * per; i += blockDim.x) {
    const int c = i / per;
    const int rem = i - c * per;
    y[(static_cast<size_t>(c) * P.Zp + pa + rem / kLanes) * P.LW + l0 +
      rem % kLanes] = T(0);
  }
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS) strip_apply_kernel(Args<T> a) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StripPlan& P = a.P;
  const int SW = kLanes + 2 * a.H;  // staged lanes of a row
  const int RP = a.run + 2;         // staged planes of a channel
  const int RW = a.run + 1;         // row starts of a channel
  T* sx = reinterpret_cast<T*>(smem_raw);                // [C][RP][SW]
  T* dw = sx + P.C * RP * SW;                            // [dwcap][kLanes]
  int2* ments = reinterpret_cast<int2*>(dw + a.dwcap * kLanes);  // [nmid]
  int2* dents = ments + a.nmid;                          // [dcap]
  int* grow = reinterpret_cast<int*>(dents + a.dcap);  // [C][RW] the plan's
  int* drow = grow + P.C * RW;     // [C][RW] the block's: first entry of a row
  int* smid = drow + P.C * RW;     // [C + 1] mid_ptr
  int* szk = smid + P.C + 1;       // [C]
  int* sorder = szk + P.C;         // [C]
  int* next = sorder + P.C;        // the unit counter
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int l0 = blockIdx.x * kLanes;
  const int z0 = blockIdx.y * a.run;
  const int nz = min(a.run, P.Zc - z0);
  const bool first = blockIdx.y == 0;
  const bool last = blockIdx.y == gridDim.y - 1;

  // G and TILE are multiples of 128, so a block is all body or all guard
  if (l0 < P.G || l0 >= P.G + P.TILE) {
    zero_planes(a.y, P, l0, first ? 0 : 1 + z0, last ? P.Zp : 1 + z0 + nz);
    return;
  }

  // first step: buffer planes z0 .. z0 + nz + 1 of every channel, lanes
  // [l0 - H, l0 + 32 + H); the mid entries; the tables
  const int planes = nz + 2;
  const int vpr = SW / V;
  for (int i = tid; i < P.C * planes * vpr; i += THREADS) {
    const int row = i / vpr;
    const int v = (i - row * vpr) * V;
    const int ci = row / planes;
    const int pz = row - ci * planes;
    cp_async16(sx + (ci * RP + pz) * SW + v,
               a.x + (static_cast<size_t>(ci) * P.Zp + z0 + pz) * P.LW + l0 -
                   a.H + v);
  }
  for (int e = tid; e < a.nmid; e += THREADS) {
    const int4 m = __ldg(P.mid_ent + e);
    ments[e] = make_int2(m.x * P.TILE, (m.y * RP + 1 + m.z) * SW + a.H + m.w);
  }
  for (int i = tid; i < P.C * (nz + 1); i += THREADS) {
    const int co = i / (nz + 1);
    const int pz = i - co * (nz + 1);
    grow[co * RW + pz] = __ldg(P.dlt_ptr + co * P.Zc + z0 + pz);
  }
  for (int c = tid; c <= P.C; c += THREADS) {
    smid[c] = __ldg(P.mid_ptr + c);
    if (c < P.C) {
      szk[c] = __ldg(P.zk + c);
      sorder[c] = __ldg(a.order + c);
    }
  }
  if (tid == 0) *next = 0;
  if (first) zero_planes(a.y, P, l0, 0, 1);
  if (last) zero_planes(a.y, P, l0, P.Zc + 1, P.Zp);
  __syncthreads();
  // channel co's delta rows z0 .. z0 + nz - 1 are one run of the plan's
  // table: they go to the block's entries in the plan's order, channel by
  // channel
  for (int i = tid; i < P.C * (nz + 1); i += THREADS) {
    const int co = i / (nz + 1);
    const int pz = i - co * (nz + 1);
    int start = grow[co * RW + pz] - grow[co * RW];
    for (int c = 0; c < co; ++c) start += grow[c * RW + nz] - grow[c * RW];
    drow[co * RW + pz] = start;
  }
  __syncthreads();
  // second step: the run's delta entries; third: their weights
  const int t0 = l0 - P.G;
  const int total = drow[(P.C - 1) * RW + nz];
  for (int k = tid; k < total; k += THREADS) {
    int co = 0;
    while (co + 1 < P.C && drow[(co + 1) * RW] <= k) ++co;
    int pz = 0;
    while (pz + 1 < nz && drow[co * RW + pz + 1] <= k) ++pz;
    const int4 d =
        __ldg(P.dlt_ent + grow[co * RW + pz] + k - drow[co * RW + pz]);
    dents[k] = make_int2(d.x * P.TILE,
                         (d.y * RP + 1 + pz + d.z) * SW + a.H + d.w);
    if (a.dwcap > 0) {
      const T* src = a.dlt + static_cast<size_t>(d.x) * P.TILE + t0;
#pragma unroll
      for (int v = 0; v < kLanes; v += V) cp_async16(dw + k * kLanes + v, src + v);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int groups = (nz + kGroup - 1) / kGroup;
  const int units = P.C * groups;
  const T* sxl = sx + lane;
  const T* dwl = dw + lane;
  const int none[1] = {0};
  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(next, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    if (u >= units) break;
    const int co = sorder[u / groups];
    const int p0 = (u % groups) * kGroup;
    T acc[kGroup];
    int poff[kGroup];  // a unit of fewer planes repeats its last one
#pragma unroll
    for (int pz = 0; pz < kGroup; ++pz) {
      acc[pz] = T(0);
      poff[pz] = min(pz, nz - p0 - 1) * SW;
    }
    global_terms<T, kGroup>(acc, ments, smid[co], smid[co + 1],
                            a.mid + t0 + lane, sxl + p0 * SW, poff);
    const int zk = szk[co];
#pragma unroll
    for (int pz = 0; pz < kGroup; ++pz) {
      if (p0 + pz >= nz) continue;
      const int z = z0 + p0 + pz;
      T out[1] = {T(0)};
      if (z < zk) {
        const int* row = drow + co * RW + p0 + pz;
        if (a.dwcap > 0) {
          out[0] = staged_terms<T>(acc[pz], dents, row[0], row[1], dwl, sxl);
        } else {
          out[0] = acc[pz];
          global_terms<T, 1>(out, dents, row[0], row[1], a.dlt + t0 + lane,
                             sxl, none);
        }
      }
      a.y[(static_cast<size_t>(co) * P.Zp + 1 + z) * P.LW + l0 + lane] = out[0];
    }
  }
}

// Dynamic shared memory of a block, as tpufem_torch/fem/strip_op.py:
// StripOperator.apply_smem_bytes counts it.
template <typename T>
size_t smem_bytes(const StripLaunch& L) {
  const int H = (L.halo + 3) & ~3;
  const size_t dwcap = L.stage_delta_weights ? L.dcap : 0;
  return (static_cast<size_t>(L.C) * (L.run + 2) * (kLanes + 2 * H) +
          dwcap * kLanes) * sizeof(T) +
         (static_cast<size_t>(L.nmid) + L.dcap) * sizeof(int2) +
         (static_cast<size_t>(L.C) * (2 * L.run + 5) + 2) * sizeof(int);
}

// Raises the kernel's dynamic shared-memory limit on the current device
// once to at least `smem` bytes (the attribute call costs host time).
template <typename T, int THREADS>
cudaError_t allow_smem(int device, size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      strip_apply_kernel<T, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

template <typename T, int THREADS>
int launch_threads(const StripLaunch& L, const Args<T>& a, size_t smem,
                   void* stream) {
  const cudaError_t err = allow_smem<T, THREADS>(L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L.LW / kLanes, (L.Zc + L.run - 1) / L.run);
  strip_apply_kernel<T, THREADS><<<grid, THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const StripLaunch& L = *static_cast<const StripLaunch*>(prepared);
  const StripPlan P{L.mid_ptr, reinterpret_cast<const int4*>(L.mid_ent),
                    L.dlt_ptr, reinterpret_cast<const int4*>(L.dlt_ent), L.zk,
                    L.C, L.Zc, L.Zp, L.LW, L.TILE, L.G};
  const int H = (L.halo + 3) & ~3;
  if (!tpufem::plan_ok(P) || L.G % 128 != 0 || L.TILE % 128 != 0 ||
      L.halo < 0 || H > L.G || L.LW < L.G + L.TILE + H || L.nmid < 0 ||
      L.dcap < 0 || L.run < 1 || L.run > kRun ||
      static_cast<long long>(L.nmid + 1) * L.TILE > 0x7fffffffLL ||
      reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(L.dlt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(L);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(L.mid),
                  static_cast<const T*>(L.dlt), P, L.order, H, L.nmid, L.run,
                  L.dcap, L.stage_delta_weights ? L.dcap : 0,
                  static_cast<T*>(y)};
  if (4 * (smem + 1024) <= kMaxSmem)
    return launch_threads<T, kSmallThreads>(L, a, smem, stream);
  return launch_threads<T, kThreads>(L, a, smem, stream);
}

}  // namespace

extern "C" {

int tpufem_strip_apply_f32(const void* prepared, const void* x, void* y,
                           void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_strip_apply_f64(const void* prepared, const void* x, void* y,
                           void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
