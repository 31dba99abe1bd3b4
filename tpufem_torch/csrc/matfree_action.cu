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
// weighted by the cell's metric G (symmetric, so only its upper triangle
// is read): for each pair i <= j, a = sum_s G_s S_s[i][j], then y_i += a
// u_j and y_j += a u_i.  The same function in exact arithmetic, and 4 n^2
// + 3 n multiply-adds a cell against D G D^T's 6 n q + 9 q (P3: 1,660
// against 3,483).  The tables of P1-P3 (3,096 values) sit in constant
// memory, filled once per device by tpufem_matfree_tables; the loops are
// unrolled for each n (4, 10, 20), so every table value is an immediate
// constant operand of its multiply-add, read by no load.
//
// What bounds it on an H100: bytes at P1 and P2 (G, cd, x, y and the
// plan: the spoke 500k P1 operator, 2,644,284 cells, moves about 190 MB
// in float32), the multiply-adds at P3 (745,612 cells x 1,660 at 150k).
//
// Design, the simple deterministic one: two launches, no atomics.
// - Launch 1, one thread a cell: the cell's dofs in 8- or 16-byte
//   loads, the gather from x, the six metric entries, the products, and
//   the n cell values stored slot-major (yc[i C + c]) so that a warp's
//   stores are contiguous.
// - Launch 2, one thread a dof: the dof's slots from the plan (the
//   stable argsort of cd, offsets [N + 1] and the slot list s = c n + i),
//   their cell values summed in plan order from 0, the plain version's
//   order; 0 on a Dirichlet row.  Two launches give the same bits.
// Launch 2's gathers are most of the time at P1 and P2: the spoke's dof
// numbering has little locality.  The other way round (launch 1 storing
// each cell value at its slot's place in the plan, launch 2 reading its
// run contiguously) measured 2x slower on the spoke's operators, the
// scattered 4-byte stores costing far more than the gathers
// (scripts/matfree_times.py; PERF.md).
// What a launch needs beside x, y and the stream is a MatfreeLaunch
// packed once per operator; yc is the operator's scratch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;
// the tables of P1, P2, P3: 6 n^2 each, n = 4, 10, 20
constexpr int kTableCount = 6 * (16 + 100 + 400);
__constant__ float kTab32[kTableCount];
__constant__ double kTab64[kTableCount];

template <int N>
__host__ __device__ constexpr int table_offset() {
  return N == 4 ? 0 : (N == 10 ? 6 * 16 : 6 * (16 + 100));
}

template <typename T>
__device__ __forceinline__ T tab(int k);
template <>
__device__ __forceinline__ float tab<float>(int k) {
  return kTab32[k];
}
template <>
__device__ __forceinline__ double tab<double>(int k) {
  return kTab64[k];
}

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:MatfreeLaunch).
struct MatfreeLaunch {
  const void* G;             // [C, 3, 3] float or double
  const int* cd;             // [C, n]
  const int* offsets;        // [ndofs + 1]
  const int* slots;          // [C n]: slot c n + i, by dof, in plan order
  const unsigned char* bc;   // [ndofs], 1 on a Dirichlet row; or null
  void* yc;                  // [n, C] scratch: the cell values, slot-major
  int device, C, n, ndofs;
};

// a cell's N dofs in the widest loads its row's alignment allows
template <int N>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         int (&d)[N]) {
  if constexpr (N % 4 == 0) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const int4 v = __ldg(q + k);
      d[4 * k] = v.x;
      d[4 * k + 1] = v.y;
      d[4 * k + 2] = v.z;
      d[4 * k + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "a cell has an even number of dofs");
    const int2* q = reinterpret_cast<const int2*>(p);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const int2 v = __ldg(q + k);
      d[2 * k] = v.x;
      d[2 * k + 1] = v.y;
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
matfree_action_cells_kernel(const MatfreeLaunch L, const T* __restrict__ x) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= L.C) return;
  int d[N];
  load_row<N>(L.cd + static_cast<size_t>(c) * N, d);
  T u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = __ldg(x + d[i]);
  const T* __restrict__ g =
      static_cast<const T*>(L.G) + static_cast<size_t>(c) * 9;
  // G00, G11, G22, G01, G02, G12: the tables' order
  const T gs[6] = {__ldg(g), __ldg(g + 4), __ldg(g + 8),
                   __ldg(g + 1), __ldg(g + 2), __ldg(g + 5)};
  constexpr int off = table_offset<N>();
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < i) continue;
      T a = gs[0] * tab<T>(off + i * N + j);
#pragma unroll
      for (int s = 1; s < 6; ++s)
        a = fma(gs[s], tab<T>(off + s * N * N + i * N + j), a);
      y[i] = fma(a, u[j], y[i]);
      if (j != i) y[j] = fma(a, u[i], y[j]);
    }
  }
  T* __restrict__ yc = static_cast<T*>(L.yc);
#pragma unroll
  for (int i = 0; i < N; ++i) yc[static_cast<size_t>(i) * L.C + c] = y[i];
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
matfree_action_dofs_kernel(const MatfreeLaunch L, T* __restrict__ y) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= L.ndofs) return;
  if (L.bc != nullptr && L.bc[d]) {
    y[d] = T(0);
    return;
  }
  const int k0 = __ldg(L.offsets + d), k1 = __ldg(L.offsets + d + 1);
  const T* yc = static_cast<const T*>(L.yc);
  T s = T(0);
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int slot = __ldg(L.slots + k);
    const int c = slot / N, i = slot - c * N;
    s += yc[static_cast<size_t>(i) * L.C + c];
  }
  y[d] = s;
}

template <typename T, int N>
int launch_n(const MatfreeLaunch& L, const T* x, T* y, cudaStream_t stream) {
  const int cell_blocks = (L.C + kThreads - 1) / kThreads;
  const int dof_blocks = (L.ndofs + kThreads - 1) / kThreads;
  matfree_action_cells_kernel<T, N>
      <<<cell_blocks, kThreads, 0, stream>>>(L, x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  matfree_action_dofs_kernel<T, N>
      <<<dof_blocks, kThreads, 0, stream>>>(L, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr || x == nullptr || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const MatfreeLaunch& L = *static_cast<const MatfreeLaunch*>(prepared);
  if (L.G == nullptr || L.cd == nullptr || L.offsets == nullptr ||
      L.slots == nullptr || L.yc == nullptr || L.C < 1 || L.ndofs < 1 ||
      static_cast<long long>(L.C) * L.n > INT_MAX ||
      reinterpret_cast<std::uintptr_t>(L.cd) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L.n) {
    case 4:
      return launch_n<T, 4>(L, xt, yt, s);
    case 10:
      return launch_n<T, 10>(L, xt, yt, s);
    case 20:
      return launch_n<T, 20>(L, xt, yt, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Fills `device`'s constant tables from `count` float64 values (P1, P2,
// P3 in turn: tpufem_torch/fem/matfree_op.py:all_kernel_tables); the
// float32 tables are those values rounded.
int tpufem_matfree_tables(int device, const double* tables, int count) {
  if (tables == nullptr || count != kTableCount)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  float t32[kTableCount];
  for (int k = 0; k < kTableCount; ++k) t32[k] = static_cast<float>(tables[k]);
  cudaError_t err = cudaMemcpyToSymbol(kTab64, tables, sizeof(kTab64));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(kTab32, t32, sizeof(kTab32));
  return static_cast<int>(err);
}

int tpufem_matfree_action_f32(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_matfree_action_f64(const void* prepared, const void* x, void* y,
                              void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
