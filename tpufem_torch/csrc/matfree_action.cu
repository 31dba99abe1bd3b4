// The matrix-free Poisson action on an unstructured tetrahedral mesh,
// y = A x with the Dirichlet rows set to 0, for Hopper (sm_90a).
//
//   y_d = sum over the slots (c, i) of dof d of (A_c u_c)_i,  u_c = x[cd[c]],
//   A_c u = sum_ab G_ab K^ab u,  K^ab_ij = sum_q w_q d_a phi_i(q) d_b phi_j(q)
//
// Replaces no Pallas kernel: tpufem's matrix-free operator of the spoke
// mesh (MatFreePoissonOp.apply, tpufem/problems/cgpoisson.py:59-66) is
// an XLA program, a gather x[cd], poisson_action_from_metric
// (tpufem/fem/kernels.py:149-166: u D, the metric contraction, D^T) and
// the sorted segment sum of DofScatter (tpufem/fem/assemble.py:254-258).
// The plain PyTorch version is
// tpufem_torch/fem/matfree_op.py:matfree_apply_plain.
//
// Form: not tpufem's D G D^T pipeline but, per cell, six symmetric n x n
// reference tables, K^aa and K^ab + K^ba for a < b (the same quadrature),
// weighted by the cell's six distinct metric entries: for each pair i <=
// j, a = sum_s G_s S_s[i][j], then y_i += a u_j and y_j += a u_i.  The
// same function in exact arithmetic, and 4 n^2 + 3 n multiply-adds a
// cell against D G D^T's 6 n q + 9 q (P3: 1,660 against 3,483), of which
// the zero table entries drop some (P3: 1,417 left).  The
// tables (matfree_tables.cuh, generated from tpufem_torch/fem/
// matfree_op.py:kernel_tables) are compile-time constants: the loops
// unroll for each n (4, 10, 20), every nonzero table value becomes an
// immediate operand of its multiply-add (float32; float64 through the
// constant bank) and a zero one no instruction (P3: 243 of the 1,260
// upper-triangle values are 0, set so from the quadrature's ~1e-15
// residues by kernel_tables), so the product issues no load and no
// uniform-register move for the tables.
//
// What bounds it on an H100: bytes at P1 and P2 (the metric, six values
// a cell, the cells' dofs, x and y: the spoke 500k P1 operator, 2,644,284
// cells, needs 110 MB in float32) and at P3 about as much as the
// multiply-adds (745,612 cells x 1,417 at 150k: 2.11 GFLOP against
// 106 MB).
//
// Design: cell clusters summed in shared memory (the host plan is
// tpufem_torch/fem/assemble.py:cluster_plan).  The cells are ordered for
// locality (reverse Cuthill-McKee of the vertex graph, then by lowest
// vertex) and cut into clusters of B cells; a block takes a cluster.
// - It copies the cluster's summing order and run ends to shared memory
//   (cp.async) while it stages x at the cluster's distinct dofs (its
//   locals), four loads a thread in flight, then computes each cell's n
//   values (a thread a cell, the cell's dofs as 16-bit locals) into
//   shared memory, never to device memory.
// - It sums every local's cell values in the plan's stored order, from
//   0: a dof in this cluster alone goes to y, a Dirichlet dof gets 0, a
//   dof that other clusters have too (the halo) goes to a partial sum at
//   the local's place in `partials`.
// - A second launch, a thread a halo dof, sums its partials in cluster
//   order and writes y; it also writes 0 to the dofs in no cell.
// No atomics: two launches give the same bits.  The plan's bytes beside
// y = A x's own: the locals' dofs and run ends (6 bytes each), the slots'
// locals and the summing order (2 bytes a slot each), the partials and
// the halo lists.
// What a launch needs beside x, y and the stream is a MatfreeLaunch
// packed once per operator; `partials` is the operator's scratch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "async_copy.cuh"
#include "matfree_tables.cuh"
#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <int N>
struct Tables;
template <>
struct Tables<4> {
  static constexpr const auto& v = tpufem::kMatfreeTables4;
};
template <>
struct Tables<10> {
  static constexpr const auto& v = tpufem::kMatfreeTables10;
};
template <>
struct Tables<20> {
  static constexpr const auto& v = tpufem::kMatfreeTables20;
};

// S_s[i][j] of the n = N tables: device code reads a host constexpr
// array's elements through a constexpr function called as a constant
// expression
template <int N>
__host__ __device__ constexpr double table(int s, int i, int j) {
  return Tables<N>::v[s][i][j];
}

// whether pair (i, j) has a nonzero table entry (else it adds nothing)
template <int N>
__host__ __device__ constexpr bool pair_used(int i, int j) {
  for (int s = 0; s < 6; ++s)
    if (table<N>(s, i, j) != 0.0) return true;
  return false;
}

// f(std::integral_constant<int, I>) for I = 0 .. sizeof...(Is) - 1, in order
template <typename F, int... Is>
__device__ __forceinline__ void static_for(std::integer_sequence<int, Is...>,
                                           F&& f) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:MatfreeLaunch).
struct MatfreeLaunch {
  const void* G6;                // [6, C] float or double, cluster order
  const int4* clusters;          // [K]: first local, ends of the 3 runs
  const int* gid;                // [P]: the dof of each local
  const unsigned int* ld;        // [K, n / 2, B]: slot locals, 2 a word
  const unsigned short* sum_idx; // [K, W]: cell values, summing order
  const unsigned short* sum_end; // [P]: each local's end in sum_idx
  const int* halo_dof;           // [H]
  const int* halo_off;           // [H + 1]
  const int* halo_src;           // the locals whose partials a halo dof sums
  void* partials;                // [P] scratch, float or double
  int device, C, n, B, K, H, max_locals;
};

// y_c = sum_s G_s S_s u_c over the pairs i <= j of the symmetric tables
// that have a nonzero entry; a = fma(G_s, S_s[i][j], a) from 0 over the
// nonzero S_s[i][j] in s order
template <typename T, int N>
__device__ __forceinline__ void cell_values(const T (&g)[6], const T (&u)[N],
                                            T (&y)[N]) {
  constexpr auto idx = std::make_integer_sequence<int, N>{};
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = T(0);
  static_for(idx, [&](auto I) {
    static_for(idx, [&](auto J) {
      constexpr int i = decltype(I)::value, j = decltype(J)::value;
      if constexpr (j >= i && pair_used<N>(i, j)) {
        T a = T(0);
        static_for(std::make_integer_sequence<int, 6>{}, [&](auto S) {
          constexpr double t = table<N>(decltype(S)::value, i, j);
          if constexpr (t != 0.0) a = fma(g[decltype(S)::value], T(t), a);
        });
        y[i] = fma(a, u[j], y[i]);
        if constexpr (j != i) y[j] = fma(a, u[i], y[j]);
      }
    });
  });
}

// blocks an SM keeps resident: the registers of a thread's cell (x at its
// dofs, its values, the metric) are 64 in float32, twice that in float64
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// A block's shared memory, each array from a 16-byte boundary: the cell
// values [n B], x at the locals, the locals' dofs and run ends
// [max_locals], the summing order [W].  The launch takes this size; the
// host plan refuses a cluster over the limit by the same layout
// (tpufem_torch/fem/assemble.py:ClusterPlan.smem_bytes), and a launch
// over kMaxSmem is refused here.
template <typename T>
struct Smem {
  int xs, dofs, ends, sidx, bytes;
  __host__ __device__ Smem(int n, int B, int max_locals, int W)
      : xs(round16(n * B * static_cast<int>(sizeof(T)))),
        dofs(xs + round16(max_locals * static_cast<int>(sizeof(T)))),
        ends(dofs + round16(max_locals * 4)),
        sidx(ends + round16(max_locals * 2)),
        bytes(sidx + 2 * W) {}
};

__host__ __device__ constexpr int sum_idx_width(int n, int B) {
  return (n * B + 7) & ~7;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
matfree_action_clusters_kernel(const MatfreeLaunch L,
                               const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B = L.B;
  const int W = sum_idx_width(N, B);
  const Smem<T> at(N, B, L.max_locals, W);
  T* vals = reinterpret_cast<T*>(smem_raw);  // [N B]: value (c, i) at i B + c
  T* xs = reinterpret_cast<T*>(smem_raw + at.xs);
  int* dofs = reinterpret_cast<int*>(smem_raw + at.dofs);
  unsigned short* ends = reinterpret_cast<unsigned short*>(smem_raw + at.ends);
  unsigned short* sidx = reinterpret_cast<unsigned short*>(smem_raw + at.sidx);
  const int4 cl = __ldg(L.clusters + blockIdx.x);
  const int base = cl.x, nfree = cl.y, nzero = cl.z, nloc = cl.w;
  // the locals' run ends and the summing order, copied to shared memory
  // while x is read (16-byte copies: the plan pads a cluster's locals to
  // 8 and its order to a multiple of 8)
  for (int k = threadIdx.x; k < (nloc + 7) / 8; k += kThreads)
    tpufem::cp_async16(ends + 8 * k, L.sum_end + base + 8 * k);
  const unsigned short* order = L.sum_idx + static_cast<size_t>(blockIdx.x) * W;
  for (int k = threadIdx.x; k < W / 8; k += kThreads)
    tpufem::cp_async16(sidx + 8 * k, order + 8 * k);
  // x at each local, four locals a thread in flight
  for (int l0 = threadIdx.x; l0 < nloc; l0 += 4 * kThreads) {
    int d[4];
    T v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + q * kThreads;
      d[q] = l < nloc ? __ldg(L.gid + base + l) : -1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = d[q] >= 0 ? __ldg(x + d[q]) : T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + q * kThreads;
      if (l < nloc) {
        dofs[l] = d[q];
        xs[l] = v[q];
      }
    }
  }
  tpufem::cp_async_wait_all();
  __syncthreads();
  const int c0 = blockIdx.x * B;
  const int ncell = min(B, L.C - c0);
  const unsigned int* ld =
      L.ld + static_cast<size_t>(blockIdx.x) * (N / 2) * B;
  const T* G6 = static_cast<const T*>(L.G6) + c0;
  for (int c = threadIdx.x; c < ncell; c += kThreads) {
    T u[N];
#pragma unroll
    for (int m = 0; m < N / 2; ++m) {
      const unsigned int w = __ldg(ld + m * B + c);
      u[2 * m] = xs[w & 0xffffu];
      u[2 * m + 1] = xs[w >> 16];
    }
    // G00, G11, G22, G01, G02, G12: the tables' order
    T gs[6];
#pragma unroll
    for (int s = 0; s < 6; ++s)
      gs[s] = __ldg(G6 + static_cast<size_t>(s) * L.C + c);
    T v[N];
    cell_values<T, N>(gs, u, v);
#pragma unroll
    for (int i = 0; i < N; ++i) vals[i * B + c] = v[i];
  }
  __syncthreads();
  T* part = static_cast<T*>(L.partials) + base;
  for (int l = threadIdx.x; l < nloc; l += kThreads) {
    if (l >= nfree && l < nzero) {  // a Dirichlet row
      y[dofs[l]] = T(0);
      continue;
    }
    const int b = l == 0 ? 0 : ends[l - 1];
    const int e = ends[l];
    T s = T(0);
    for (int j = b; j < e; ++j) s += vals[sidx[j]];
    if (l < nfree)
      y[dofs[l]] = s;
    else
      part[l] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matfree_action_halo_kernel(const MatfreeLaunch L, T* __restrict__ y) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= L.H) return;
  const int k0 = __ldg(L.halo_off + h), k1 = __ldg(L.halo_off + h + 1);
  const T* part = static_cast<const T*>(L.partials);
  T s = T(0);
#pragma unroll 4
  for (int k = k0; k < k1; ++k) s += part[__ldg(L.halo_src + k)];
  y[__ldg(L.halo_dof + h)] = s;
}

// lets the cluster kernel take `smem` bytes of dynamic shared memory on
// `device` (above 48 KB only by this opt-in)
template <typename T, int N>
cudaError_t allow_smem(int device, int smem) {
  static int allowed[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      matfree_action_clusters_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

template <typename T, int N>
int launch_n(const MatfreeLaunch& L, int smem, const T* x, T* y,
             cudaStream_t stream) {
  cudaError_t err = allow_smem<T, N>(L.device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matfree_action_clusters_kernel<T, N>
      <<<L.K, kThreads, smem, stream>>>(L, x, y);
  err = cudaGetLastError();
  if (err != cudaSuccess || L.H == 0) return static_cast<int>(err);
  matfree_action_halo_kernel<T>
      <<<(L.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(L, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr || x == nullptr || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const MatfreeLaunch& L = *static_cast<const MatfreeLaunch*>(prepared);
  const long long need =
      L.B < 1 || L.n < 1 || static_cast<long long>(L.n) * L.B > 65535
          ? LLONG_MAX
          : Smem<T>(L.n, L.B, L.max_locals, sum_idx_width(L.n, L.B)).bytes;
  if (L.G6 == nullptr || L.clusters == nullptr || L.gid == nullptr ||
      L.ld == nullptr || L.sum_idx == nullptr || L.sum_end == nullptr ||
      L.partials == nullptr || L.C < 1 || L.K < 1 || L.B < 1 ||
      L.H < 0 || (L.H > 0 && (L.halo_dof == nullptr ||
                               L.halo_off == nullptr)) ||
      static_cast<long long>(L.K) * L.B < L.C || L.max_locals % 8 != 0 ||
      need > static_cast<long long>(tpufem::kMaxSmem) ||
      reinterpret_cast<std::uintptr_t>(L.clusters) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(L.sum_end) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(L.sum_idx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(need);
  switch (L.n) {
    case 4:
      return launch_n<T, 4>(L, smem, xt, yt, s);
    case 10:
      return launch_n<T, 10>(L, smem, xt, yt, s);
    case 20:
      return launch_n<T, 20>(L, smem, xt, yt, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int tpufem_matfree_action_f32(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_matfree_action_f64(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
