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
// leave at the same step.  The right-hand side's pad, guard and halo
// slots must be zero, as to_strips leaves them (they stay zero in every
// vector of the recurrence, so the dots run over the body only).  The
// plain PyTorch version is tpufem_torch/fem/strip_op.py:StripOperator.
// cg_resident_plain.
//
// What bounds it on an H100: not the roofline (2.7 GFLOP and 6 MB for 100
// steps at the 146k-dof P3 operator, ~0.04 ms) but latency and the
// shared-memory load rate: two grid barriers per step, and in the apply
// ~48 terms per element whose source values another SM wrote in the step
// before, so they cannot come from L1.  Read one by one from L2
// (ld.global.cg, a few elements per thread to overlap them with) those
// reads and the weights' were nearly all of a step.
//
// The design: one cooperative launch of no more blocks than are
// co-resident (the occupancy query below), meeting at this_grid().sync()
// twice per step: after the apply pass (which reduces s_old.r and
// s_new.r) and after the update pass (which reduces r.r).
//
// - Bricks.  The body of the buffer is cut into bricks (a table built by
//   the wrapper: first plane, 1 or 2 planes, first lane; all channels,
//   32 lanes), and a block owns the same bricks in every pass
//   (brick = blockIdx.x + k gridDim.x); inside a brick a thread keeps its
//   lane and takes the channels warp, warp + 16, ...  So x, p and s
//   are private to one thread for the whole solve; only r crosses
//   threads.  Where no block owns more than one brick (the 146k-dof P3
//   operator: 132 bricks on 132 SMs) they stay in registers from the
//   first step to the last; otherwise they are read and written with
//   plain loads and stores.
// - The apply reads r from shared memory.  After the barrier a block
//   copies its brick's sources (the brick's planes and one either side,
//   all channels, the brick's lanes and a halo of max |off| lanes) with
//   16-byte cp.async.cg, which reads L2 and never L1: one round trip for
//   the whole brick instead of one per term.  The plan's entries, mid and
//   delta, are turned into (weight row start, shared-memory offset) pairs
//   in shared memory (the mid ones once, the brick's delta ones with the
//   brick), and a thread runs them in batches of 8 (4 in float64), every
//   load of a batch before its sums: one entry at a time is a chain of
//   dependent loads (entry, weight, source) that nothing overlaps.
// - A mid weight is a function of the lane only, so with 2 planes in a
//   brick each weight loaded serves both planes.  Where a block owns one
//   brick and they fit beside the staged planes (168 KB at the 146k-dof
//   P3 operator in float32, 212 KB in all), the mid weights of the
//   brick's lanes are copied to shared memory once, before the first
//   step; otherwise they come from global memory through L1 and L2.
// - Determinism across blocks: each block writes its partial sums to its
//   own slot, and every block then sums all slots in one fixed order (no
//   atomics), so all blocks derive bitwise-identical alpha, beta and rr,
//   and agree on when to stop.  The s-partials and the r-partials live in
//   separate arrays, each written only after the barrier that follows
//   its last read.
//
// tpufem_strip_cg_sync_floor runs the same grid through the barriers
// alone: the floor no arithmetic can go below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "strip_common.cuh"

// Built with -DTPUFEM_CG_PHASES (scripts/strip_cg_phases.py does), thread
// 0 of every block sums the SM cycles it spends in each phase of a step
// and prints them per step at the end: staging, apply, block sum, first
// barrier, first grid total, update with its block sum, second barrier,
// second grid total.
#ifdef TPUFEM_CG_PHASES
#include <cstdio>
#define TPUFEM_CG_PHASES_BEGIN \
  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long tc = clock64();
#define TICK(i)                   \
  {                               \
    const long long now = clock64(); \
    ph[i] += now - tc;            \
    tc = now;                     \
  }
#define TPUFEM_CG_PHASES_END                                                  \
  if (tid == 0 && cnt > 0)                                                    \
    printf("strip_cg block %d z0 %d nz %d: stage %lld apply %lld sum1 %lld "  \
           "sync1 %lld total1 %lld update %lld sync2 %lld total2 %lld "       \
           "cycles per step, %d steps\n",                                     \
           blockIdx.x, a.bricks[3 * blockIdx.x], a.bricks[3 * blockIdx.x + 1], \
           ph[0] / cnt, ph[1] / cnt, ph[2] / cnt, ph[3] / cnt, ph[4] / cnt,   \
           ph[5] / cnt, ph[6] / cnt, ph[7] / cnt, cnt);
#else
#define TPUFEM_CG_PHASES_BEGIN
#define TICK(i)
#define TPUFEM_CG_PHASES_END
#endif

namespace cg = cooperative_groups;

namespace {

using tpufem::cp_async16;
using tpufem::cp_async_wait_all;
using tpufem::kMaxSmem;
using tpufem::StripPlan;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBrickLanes = 32;              // lanes of a brick: one warp
constexpr int kBrickPlanes = 2;              // most planes of a brick
constexpr int kStaged = kBrickPlanes + 2;    // staged planes of a brick
constexpr int kSlots = 4;   // most channels of a brick a thread takes
constexpr int kMaxDevices = 64;

template <typename T>
struct CgArgs {
  const T* b;
  const T* mid;
  const T* dlt;
  StripPlan P;
  const int* bricks;  // [nbricks, 3]: first plane z0, planes nz, first lane
  int nbricks;
  int H;              // staged halo lanes each side (a multiple of 4)
  int nmid;           // mid entries of all channels
  int dcap;           // most delta entries of one brick
  int wsm;            // the brick's mid weights live in shared memory
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of a and b in one fixed order; every thread gets both.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = T(0);
  b = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
  __syncthreads();
}

// Sums over all blocks of the per-block partials pa[i * stride] and
// pb[i * stride], in the same order in every block.
template <typename T>
__device__ __forceinline__ void grid_total2(const T* pa, const T* pb,
                                            int stride, T& a, T& b, T* red) {
  a = T(0);
  b = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    a += __ldcg(pa + static_cast<size_t>(i) * stride);
    b += __ldcg(pb + static_cast<size_t>(i) * stride);
  }
  block_sum2(a, b, red);
}

// Index of element (channel co, buffer plane pl, lane) of a strip buffer.
__device__ __forceinline__ long long at(const StripPlan& P, int co, int pl,
                                        int lane) {
  return (static_cast<long long>(co) * P.Zp + pl) * P.LW + lane;
}

// The delta entries of brick (z0, nz) as (weight row start, offset into
// the staged planes) pairs: channel co's rows z0 .. z0 + nz - 1 are one
// run of the plan's table, copied to dents[dstart[co] ...) in the plan's
// order.  The caller synchronises the block before reading them.
__device__ __forceinline__ void stage_deltas(const StripPlan& P, int z0,
                                             int nz, int SW, int H,
                                             int2* dents, int* dstart) {
  for (int co = threadIdx.x; co <= P.C; co += kThreads) {
    int start = 0;
    for (int c = 0; c < co; ++c)
      start += __ldg(P.dlt_ptr + c * P.Zc + z0 + nz) -
               __ldg(P.dlt_ptr + c * P.Zc + z0);
    dstart[co] = start;
  }
  for (int co = threadIdx.x / 32; co < P.C; co += kWarps) {
    int start = 0;
    for (int c = 0; c < co; ++c)
      start += __ldg(P.dlt_ptr + c * P.Zc + z0 + nz) -
               __ldg(P.dlt_ptr + c * P.Zc + z0);
    for (int pz = 0; pz < nz; ++pz) {
      const int row = co * P.Zc + z0 + pz;
      const int d1 = __ldg(P.dlt_ptr + row + 1);
      for (int e = __ldg(P.dlt_ptr + row) + (threadIdx.x & 31); e < d1;
           e += 32) {
        const int4 d = __ldg(P.dlt_ent + e);
        dents[start + e - __ldg(P.dlt_ptr + co * P.Zc + z0)] = make_int2(
            d.x * P.TILE, (d.y * kStaged + 1 + pz + d.z) * SW + H + d.w);
      }
    }
  }
}

// acc[pz] += sum over entries [e0, e1) of ents of weight * staged[ent.y +
// pz * SW] for every plane pz < nz of the brick (NP = 1: the entry's own
// plane only), in the entries' order.  The weight of entry e is
// weights[e * stride + t] where kByEntry (the brick's weights by entry in
// shared memory) and weights[ent.x + t] otherwise (global memory, through
// L1 and L2).  Entries go in batches of kBatch, all loads of a batch
// before its sums, so their latencies overlap; a short last batch loads
// its last entry again (no branch around a load) and leaves it out of the
// sums, which keep the entries' order.
template <typename T, int NP, bool kByEntry>
__device__ __forceinline__ void add_terms(T (&acc)[NP], const int2* ents,
                                          int e0, int e1, const T* weights,
                                          int stride, int t, const T* staged,
                                          int SW, int nz) {
  constexpr int kBatch = 32 / sizeof(T);
  for (int e = e0; e < e1; e += kBatch) {
    int2 m[kBatch];
    T w[kBatch];
    T v[kBatch][NP];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) m[j] = ents[min(e + j, e1 - 1)];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      w[j] = weights[(kByEntry ? min(e + j, e1 - 1) * stride : m[j].x) + t];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int pz = 0; pz < NP; ++pz) v[j][pz] = staged[m[j].y + pz * SW];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int pz = 0; pz < NP; ++pz)
        if (e + j < e1 && pz < nz) acc[pz] += w[j] * v[j][pz];
  }
}

// kReg: no block owns more than one brick, so a thread's x, p and s live
// in registers for the whole solve (x is stored once, at the end) and the
// update pass reads its own r from the brick still staged in shared
// memory; otherwise they live in the buffers x and work, private to the
// thread all the same.
template <typename T, bool kReg>
__global__ void __launch_bounds__(kThreads, 1) strip_cg_kernel(CgArgs<T> a) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte copy
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StripPlan& P = a.P;
  const int SW = kBrickLanes + 2 * a.H;           // staged lanes of a row
  T* sr = reinterpret_cast<T*>(smem_raw);  // [C][kStaged][SW]
  T* red = sr + P.C * kStaged * SW;        // [2 * kWarps]
  T* wts = red + 2 * kWarps;               // [nmid][32] when a.wsm
  int2* ments = reinterpret_cast<int2*>(wts + (a.wsm ? a.nmid * kBrickLanes : 0));
  int2* dents = ments + a.nmid;                             // [dcap]
  int* dstart = reinterpret_cast<int*>(dents + a.dcap);     // [C + 1]
  const int tid = threadIdx.x;
  const int lane = tid % kBrickLanes;
  const int group = tid / kBrickLanes;
  constexpr int groups = kThreads / kBrickLanes;
  const long long n = static_cast<long long>(P.C) * P.Zp * P.LW;
  T xs[kSlots][kBrickPlanes], ps[kSlots][kBrickPlanes],
      ss[kSlots][kBrickPlanes];

  // mid entries as (weight row start, offset into the staged planes); with
  // a.wsm the weights of the one brick's lanes, by entry, in shared memory
  for (int e = tid; e < a.nmid; e += kThreads) {
    const int4 m = __ldg(P.mid_ent + e);
    ments[e] = make_int2(a.wsm ? e * kBrickLanes : m.x * P.TILE,
                         (m.y * kStaged + 1 + m.z) * SW + a.H + m.w);
  }
  if (a.wsm) {
    const int t0 = __ldg(a.bricks + 3 * blockIdx.x + 2) - P.G;
    for (int i = tid; i < a.nmid * kBrickLanes; i += kThreads) {
      const int e = i / kBrickLanes;
      wts[i] = __ldg(a.mid + static_cast<size_t>(__ldg(P.mid_ent + e).x) *
                                 P.TILE + t0 + (i - e * kBrickLanes));
    }
  }

  // r = b everywhere, x = 0 outside the body; then per brick x = p = s = 0
  // by their owner, and rr0 = b.b
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int l = static_cast<int>(i % P.LW);
    const int pl = static_cast<int>((i / P.LW) % P.Zp);
    a.r[i] = __ldg(a.b + i);
    if (pl < 1 || pl > P.Zc || l < P.G || l >= P.G + P.TILE) a.x[i] = T(0);
  }
  T acc0 = T(0), none = T(0);
  for (int br = blockIdx.x; br < a.nbricks; br += gridDim.x) {
    const int z0 = __ldg(a.bricks + 3 * br);
    const int nz = __ldg(a.bricks + 3 * br + 1);
    const int l0 = __ldg(a.bricks + 3 * br + 2);
    // the one brick's delta entries, once (the block sums below synchronise)
    if constexpr (kReg) stage_deltas(P, z0, nz, SW, a.H, dents, dstart);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int co = group + q * groups;
      if (co >= P.C) continue;
#pragma unroll
      for (int pz = 0; pz < kBrickPlanes; ++pz) {
        if (pz >= nz) continue;
        const long long i = at(P, co, 1 + z0 + pz, l0 + lane);
        const T bv = __ldg(a.b + i);
        if constexpr (kReg) {
          xs[q][pz] = ps[q][pz] = ss[q][pz] = T(0);
        } else {
          a.x[i] = T(0);
          a.p[i] = T(0);
          a.s[i] = T(0);
        }
        acc0 += bv * bv;
      }
    }
  }
  block_sum2(acc0, none, red);
  if (tid == 0) a.part_rr[blockIdx.x] = acc0;
  grid.sync();
  T rr0, unused;
  grid_total2(a.part_rr, a.part_rr, 1, rr0, unused, red);
  const T thresh = a.rtol2 * rr0;
  T rr = rr0, rr_prev = T(1), alpha_prev = T(1);
  int cnt = 0;

  TPUFEM_CG_PHASES_BEGIN
  for (int k = 0; k < a.maxit; ++k) {
    if (!(rr > thresh)) break;  // frozen from here on (uniform)
    const T beta = k == 0 ? T(0) : rr / rr_prev;
    TICK(7)

    // apply pass: s <- beta s + A r, with the s_old.r and s_new.r partials
    T sr_old = T(0), sr_new = T(0);
    for (int br = blockIdx.x; br < a.nbricks; br += gridDim.x) {
      const int z0 = __ldg(a.bricks + 3 * br);
      const int nz = __ldg(a.bricks + 3 * br + 1);
      const int l0 = __ldg(a.bricks + 3 * br + 2);
      if constexpr (!kReg) {
        __syncthreads();  // the last brick's readers are done
        stage_deltas(P, z0, nz, SW, a.H, dents, dstart);
      }
      // buffer planes z0 .. z0 + nz + 1 of every channel, lanes
      // [l0 - H, l0 + 32 + H), from L2
      const int planes = nz + 2;
      for (int row = tid >> 5; row < P.C * planes; row += kWarps) {
        const int ci = row / planes;
        const int pz = row - ci * planes;
        T* dst = sr + (ci * kStaged + pz) * SW;
        const T* src = a.r + at(P, ci, z0 + pz, l0 - a.H);
        for (int v = (tid & 31) * V; v < SW; v += 32 * V)
          cp_async16(dst + v, src + v);
      }
      cp_async_wait_all();
      __syncthreads();
      TICK(0)
      const int t = l0 - P.G + lane;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int co = group + q * groups;
        if (co >= P.C) continue;
        T acc[kBrickPlanes];
#pragma unroll
        for (int pz = 0; pz < kBrickPlanes; ++pz) acc[pz] = T(0);
        const int m0 = __ldg(P.mid_ptr + co), m1 = __ldg(P.mid_ptr + co + 1);
        if (a.wsm) {
          add_terms<T, kBrickPlanes, true>(acc, ments, m0, m1, wts, kBrickLanes,
                                           lane, sr + lane, SW, nz);
        } else {
          add_terms<T, kBrickPlanes, false>(acc, ments, m0, m1, a.mid, 0, t,
                                            sr + lane, SW, nz);
        }
        const int zk = __ldg(P.zk + co);
#pragma unroll
        for (int pz = 0; pz < kBrickPlanes; ++pz) {
          if (pz >= nz) continue;
          const int z = z0 + pz;
          T ar[1] = {T(0)};
          if (z < zk) {
            ar[0] = acc[pz];
            const int d0 = dstart[co] + __ldg(P.dlt_ptr + co * P.Zc + z) -
                           __ldg(P.dlt_ptr + co * P.Zc + z0);
            add_terms<T, 1, false>(ar, dents, d0,
                                   d0 + __ldg(P.dlt_ptr + co * P.Zc + z + 1) -
                                       __ldg(P.dlt_ptr + co * P.Zc + z),
                                   a.dlt, 0, t, sr + lane, SW, 1);
          }
          const long long i = at(P, co, 1 + z, l0 + lane);
          const T rv = sr[(co * kStaged + 1 + pz) * SW + a.H + lane];
          T s_old;
          if constexpr (kReg) {
            s_old = ss[q][pz];
          } else {
            s_old = a.s[i];
          }
          const T s_new = beta * s_old + ar[0];
          if constexpr (kReg) {
            ss[q][pz] = s_new;
          } else {
            a.s[i] = s_new;
          }
          sr_old += s_old * rv;
          sr_new += s_new * rv;
        }
      }
    }
    TICK(1)
    block_sum2(sr_old, sr_new, red);
    if (tid == 0) {
      a.part_sr[2 * blockIdx.x] = sr_old;
      a.part_sr[2 * blockIdx.x + 1] = sr_new;
    }
    TICK(2)
    grid.sync();
    TICK(3)
    T tot_old, tot_new;
    grid_total2(a.part_sr, a.part_sr + 1, 2, tot_old, tot_new, red);
    TICK(4)
    const T wr = tot_new - beta * tot_old;
    const T alpha = rr / (wr - beta * rr / alpha_prev);

    // update pass: p, x, r of the block's own elements, with the r.r partial
    T rn = T(0);
    for (int br = blockIdx.x; br < a.nbricks; br += gridDim.x) {
      const int z0 = __ldg(a.bricks + 3 * br);
      const int nz = __ldg(a.bricks + 3 * br + 1);
      const int l0 = __ldg(a.bricks + 3 * br + 2);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int co = group + q * groups;
        if (co >= P.C) continue;
#pragma unroll
        for (int pz = 0; pz < kBrickPlanes; ++pz) {
          if (pz >= nz) continue;
          const long long i = at(P, co, 1 + z0 + pz, l0 + lane);
          T r_new;
          if constexpr (kReg) {
            const T rv = sr[(co * kStaged + 1 + pz) * SW + a.H + lane];
            const T pv = rv + beta * ps[q][pz];
            ps[q][pz] = pv;
            xs[q][pz] += alpha * pv;
            r_new = rv - alpha * ss[q][pz];
          } else {
            const T rv = __ldcg(a.r + i);
            const T pv = rv + beta * a.p[i];
            a.p[i] = pv;
            a.x[i] += alpha * pv;
            r_new = rv - alpha * a.s[i];
          }
          a.r[i] = r_new;
          rn += r_new * r_new;
        }
      }
    }
    block_sum2(rn, none, red);
    if (tid == 0) a.part_rr[blockIdx.x] = rn;
    TICK(5)
    grid.sync();
    TICK(6)
    rr_prev = rr;
    grid_total2(a.part_rr, a.part_rr, 1, rr, unused, red);
    alpha_prev = alpha;
    ++cnt;
  }
  TPUFEM_CG_PHASES_END
  if constexpr (kReg) {
    const int br = blockIdx.x;
    if (br < a.nbricks) {
      const int z0 = __ldg(a.bricks + 3 * br);
      const int nz = __ldg(a.bricks + 3 * br + 1);
      const int l0 = __ldg(a.bricks + 3 * br + 2);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int co = group + q * groups;
        if (co >= P.C) continue;
#pragma unroll
        for (int pz = 0; pz < kBrickPlanes; ++pz)
          if (pz < nz) a.x[at(P, co, 1 + z0 + pz, l0 + lane)] = xs[q][pz];
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    *a.it_out = cnt;
    *a.rel_out = sqrt(rr / rr0);
  }
}

// The same grid through `nsync` grid barriers and nothing else.
__global__ void __launch_bounds__(kThreads) grid_sync_floor_kernel(int nsync) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsync; ++i) grid.sync();
}

// Dynamic shared memory of a launch, or 0 when the shape is not taken.
template <typename T>
size_t smem_bytes(int C, int H, int nmid, int dcap, bool wsm) {
  constexpr int BL = kBrickLanes;
  if (C <= 0 || C > kSlots * (kThreads / BL) || H < 0 || H % 4 != 0 ||
      nmid < 0 || dcap < 0)
    return 0;
  const size_t smem =
      (static_cast<size_t>(C) * kStaged * (BL + 2 * H) + 2 * kWarps +
       (wsm ? static_cast<size_t>(nmid) * BL : 0)) *
          sizeof(T) +
      (static_cast<size_t>(nmid) + dcap) * sizeof(int2) +
      (C + 1) * sizeof(int);
  return smem <= kMaxSmem ? smem : 0;
}

// Raises the dynamic shared-memory limit of both forms of the kernel on
// the current device once to at least `smem` bytes.
template <typename T>
cudaError_t allow_smem(int device, size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= allowed[device]) return cudaSuccess;
  const void* forms[] = {
      reinterpret_cast<const void*>(strip_cg_kernel<T, false>),
      reinterpret_cast<const void*>(strip_cg_kernel<T, true>)};
  for (const void* f : forms) {
    const cudaError_t err = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  allowed[device] = smem;
  return cudaSuccess;
}

// Blocks of `smem` bytes that are co-resident on the current device
// (the fewer of the kernel's two forms), or minus the cuda error.
template <typename T>
int resident_blocks(int device, size_t smem) {
  int coop = 0, sms = 0, per_sm = 0, per_sm_reg = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = allow_smem<T>(device, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, strip_cg_kernel<T, false>, kThreads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_reg, strip_cg_kernel<T, true>, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * (per_sm < per_sm_reg ? per_sm : per_sm_reg);
}

template <typename T>
int max_blocks(int device, int C, int H, int nmid, int dcap) {
  const size_t smem = smem_bytes<T>(C, H, nmid, dcap, false);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -static_cast<int>(scope.error());
  return resident_blocks<T>(device, smem);
}

// Launches cooperatively: a grid larger than the co-resident capacity is
// refused (cudaErrorCooperativeLaunchTooLarge), never run.  Reads (and so
// clears) the launch's error state: a refused launch must not surface
// again at the next launch's check.
int launch_cooperative(const void* kernel, int nblk, void** args, size_t smem,
                       void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(nblk), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T>
int launch(int device, const void* b, const void* mid, const void* dlt,
           const int* mid_ptr, const int* mid_ent, const int* dlt_ptr,
           const int* dlt_ent, const int* zk, const int* bricks, void* x,
           void* work, void* partials, void* it, void* rel, int C, int Zc,
           int Zp, int LW, int TILE, int G, int nbricks, int H, int nmid,
           int dcap, double rtol2, int maxit, int nblk, void* stream) {
  const StripPlan P{mid_ptr, reinterpret_cast<const int4*>(mid_ent),
                    dlt_ptr, reinterpret_cast<const int4*>(dlt_ent), zk,
                    C, Zc, Zp, LW, TILE, G};
  size_t smem = smem_bytes<T>(C, H, nmid, dcap, false);
  if (!tpufem::plan_ok(P) || nblk < 1 || nblk > nbricks || maxit < 0 ||
      smem == 0 || H > G || LW < G + TILE + H || TILE % kBrickLanes != 0 ||
      reinterpret_cast<size_t>(work) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  // one brick a block (never more blocks than bricks, refused above): x, p,
  // s in registers, and the brick's mid weights in shared memory too where
  // they fit beside the staged planes
  const bool one_brick = nbricks == nblk;
  const size_t with_weights = smem_bytes<T>(C, H, nmid, dcap, true);
  const bool wsm = one_brick && with_weights != 0 &&
                   nblk <= resident_blocks<T>(device, with_weights);
  if (wsm) smem = with_weights;
  const cudaError_t err = allow_smem<T>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(C) * Zp * LW;
  T* w = static_cast<T*>(work);
  T* part = static_cast<T*>(partials);
  CgArgs<T> a{static_cast<const T*>(b), static_cast<const T*>(mid),
              static_cast<const T*>(dlt), P, bricks, nbricks, H, nmid, dcap,
              wsm ? 1 : 0, static_cast<T*>(x), w, w + n, w + 2 * n, part,
              part + 2 * static_cast<size_t>(nblk), static_cast<int*>(it),
              static_cast<T*>(rel), static_cast<T>(rtol2), maxit};
  void* args[] = {&a};
  const void* kernel =
      one_brick ? reinterpret_cast<const void*>(strip_cg_kernel<T, true>)
                : reinterpret_cast<const void*>(strip_cg_kernel<T, false>);
  return launch_cooperative(kernel, nblk, args, smem, stream);
}

}  // namespace

extern "C" {

int tpufem_strip_cg_blocks_f32(int device, int C, int H, int nmid, int dcap) {
  return max_blocks<float>(device, C, H, nmid, dcap);
}

int tpufem_strip_cg_blocks_f64(int device, int C, int H, int nmid, int dcap) {
  return max_blocks<double>(device, C, H, nmid, dcap);
}

int tpufem_strip_cg_sync_floor(int device, int nblk, int nsync, void* stream) {
  if (nblk < 1 || nsync < 0) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  void* args[] = {&nsync};
  return launch_cooperative(
      reinterpret_cast<const void*>(grid_sync_floor_kernel), nblk, args, 0,
      stream);
}

int tpufem_strip_cg_f32(int device, const void* b, const void* mid,
                        const void* dlt, const int* mid_ptr,
                        const int* mid_ent, const int* dlt_ptr,
                        const int* dlt_ent, const int* zk, const int* bricks,
                        void* x, void* work, void* partials, void* it,
                        void* rel, int C, int Zc, int Zp, int LW, int TILE,
                        int G, int nbricks, int H, int nmid, int dcap,
                        double rtol2, int maxit, int nblk, void* stream) {
  return launch<float>(device, b, mid, dlt, mid_ptr, mid_ent, dlt_ptr,
                       dlt_ent, zk, bricks, x, work, partials, it, rel, C, Zc,
                       Zp, LW, TILE, G, nbricks, H, nmid, dcap, rtol2, maxit,
                       nblk, stream);
}

int tpufem_strip_cg_f64(int device, const void* b, const void* mid,
                        const void* dlt, const int* mid_ptr,
                        const int* mid_ent, const int* dlt_ptr,
                        const int* dlt_ent, const int* zk, const int* bricks,
                        void* x, void* work, void* partials, void* it,
                        void* rel, int C, int Zc, int Zp, int LW, int TILE,
                        int G, int nbricks, int H, int nmid, int dcap,
                        double rtol2, int maxit, int nblk, void* stream) {
  return launch<double>(device, b, mid, dlt, mid_ptr, mid_ent, dlt_ptr,
                        dlt_ent, zk, bricks, x, work, partials, it, rel, C,
                        Zc, Zp, LW, TILE, G, nbricks, H, nmid, dcap, rtol2,
                        maxit, nblk, stream);
}

}  // extern "C"
