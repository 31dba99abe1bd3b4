// Apply of the blocked (bs = 3) per-perm element-matrix operator of P2/P3
// elasticity, for Hopper (sm_90a), on component-planar vectors
// (component a of scalar dof i at a * ns + i):
//
//   y = where(bc, x, A(where(bc, 0, x)))
//   (A u)[a, ko, q, so] = sum_{entries e = (p, lo) of output (ko, so)}
//       [cube c = q - off_lo inside the lattice]
//       sum_{li < n, b < 3} Ap[p][3 lo + a][3 li + b] * u[b, src(p, li, c)]
//
// Every cube of the Kuhn lattice holds six tetrahedra (perms p) with one
// constant [3n, 3n] element matrix each (n = 10 at P2, 20 at P3); the
// local dof lo of perm p sits on the typed dof grid ko (the vertex grid,
// 7 edge types with k - 1 slots, 12 face types at P3) at the cube offset
// off_lo and slot so.  The tables, built by
// tpufem_torch/fem/perm_apply.py:pack_perm:
//
//   W       [E, n, 3, 3]  W[e, li, b, a] = Ap[p][3 lo + a][3 li + b]
//   entries [E]           p << 3 | off_lo (x | y << 1 | z << 2)
//   outputs [O, 5]        (ko, so, first entry, count, lanes G),
//                         heaviest first
//   sources [6 n] int4    src(p, li, c) = s.x + cz s.y + cy s.z + cx s.w
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
// 500k (16x16x24, 525,819 dofs) operations, 143.8 MFLOP (0.0021 ms), beside
// 4.82 MB.  The per-perm form does more, 6 cubes (3n)^2 multiply-adds:
// 99.5 M (P2) / 132.7 M (P3), and each product needs one source value:
// some 33 M / 44 M reads of x and of the mask, from L1 / L2, which is
// what the kernel's time follows.
//
// The design: a block is 256 threads on one output (kind, slot) grid
// (blockIdx.y, heaviest output first), so all its threads walk the same
// entries with the same weights, which the block stages once in shared
// memory (the output's rows of Ap, at most 24 entries x 9n values: 34.6
// KB in float64 at P3) beside the 6n source descriptors.  G consecutive
// lanes share one output point (G = 4 on the vertex output's 24 entries,
// 1 on the edge and face outputs' 2-6: pack_perm's _lanes), lane g
// taking entries g, g + G, ...: so a thread of any output sums about 6
// entries and no block is a long pole (one point a thread leaves the
// vertex output's blocks 4x the work of the others, and the apply waits
// on them: 2.5x slower at P3 500k, scripts/perm_apply_lanes.py).  Per
// entry a lane finds the cube, skips the entry where the cube lies
// outside the lattice (the per-perm slices cover the lattice's cubes
// only), and sums the entry's 3n products into three partial sums by
// fused multiply-adds, which it adds to its totals in entry order; the G
// lanes' totals are then summed by shuffles in a fixed order
// (deterministic).  Sources read 0 where the mask is set; a masked
// output row writes x.  What a launch needs beside x, y and the stream is
// a PermApplyLaunch packed once per operator.

#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;        // tpufem_torch/fem/perm_apply.py:_THREADS
constexpr int kSmemLimit = 48 * 1024;

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:PermApplyLaunch).
struct PermApplyLaunch {
  const void* W;                // [E, n, 3, 3]
  const int* entries;           // [E]
  const int* outputs;           // [nout, 5]
  const int4* sources;          // [6 n]
  const int* kinds;             // [K, 5]
  const unsigned char* mask;    // [3 ns]
  int device, n, ns, nout, Nx, Ny, Nz, max_entries, max_blocks;
};

template <typename T, int NL>
__global__ void __launch_bounds__(kThreads)
perm_apply_kernel(const T* __restrict__ x, const T* __restrict__ W,
                  const int* __restrict__ entries,
                  const int* __restrict__ outputs,
                  const int4* __restrict__ sources,
                  const int* __restrict__ kinds,
                  const unsigned char* __restrict__ mask, int ns, int Nx,
                  int Ny, int Nz, T* __restrict__ y) {
  constexpr int kRow = 9 * NL;  // an entry's weights
  extern __shared__ int4 smem[];
  int4* src = smem;                                    // [6 NL]
  T* w = reinterpret_cast<T*>(smem + 6 * NL);          // [count, kRow]
  const int* out = outputs + 5 * blockIdx.y;
  const int ko = out[0], so = out[1], first = out[2], count = out[3];
  const int lanes = out[4];  // a power of two up to 8
  int* ent = reinterpret_cast<int*>(w + count * kRow);  // [count]
  const int obase = kinds[5 * ko], Xo = kinds[5 * ko + 1];
  const int Yo = kinds[5 * ko + 2], Zo = kinds[5 * ko + 3];
  const int oslots = kinds[5 * ko + 4];
  const int npts = Xo * Yo * Zo;
  const int p0 = blockIdx.x * (kThreads / lanes);
  if (p0 >= npts) return;  // the whole block: this output is smaller
  for (int k = threadIdx.x; k < 6 * NL; k += kThreads) src[k] = sources[k];
  const T* Wo = W + static_cast<long long>(first) * kRow;
  for (int k = threadIdx.x; k < count * kRow; k += kThreads) w[k] = Wo[k];
  for (int k = threadIdx.x; k < count; k += kThreads)
    ent[k] = entries[first + k];
  __syncthreads();
  const int g = static_cast<int>(threadIdx.x) & (lanes - 1);
  const int q = p0 + static_cast<int>(threadIdx.x) / lanes;
  const bool active = q < npts;  // the same for the G lanes of a point
  const int qx = q % Xo;
  const int zy = q / Xo;
  const int qy = zy % Yo;
  const int qz = zy / Yo;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  for (int e = g; active && e < count; e += lanes) {
    const int code = ent[e];
    const int cx = qx - (code & 1);
    const int cy = qy - ((code >> 1) & 1);
    const int cz = qz - ((code >> 2) & 1);
    if (static_cast<unsigned>(cx) >= static_cast<unsigned>(Nx) ||
        static_cast<unsigned>(cy) >= static_cast<unsigned>(Ny) ||
        static_cast<unsigned>(cz) >= static_cast<unsigned>(Nz))
      continue;
    const int4* s = src + (code >> 3) * NL;
    const T* we = w + e * kRow;
    T t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll 2
    for (int li = 0; li < NL; ++li) {
      const int4 d = s[li];
      const int j = d.x + cz * d.y + cy * d.z + cx * d.w;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int jb = j + b * ns;
        const T v = __ldg(mask + jb) ? T(0) : __ldg(x + jb);
        const T* wb = we + 9 * li + 3 * b;
        t0 = fma(wb[0], v, t0);
        t1 = fma(wb[1], v, t1);
        t2 = fma(wb[2], v, t2);
      }
    }
    acc0 += t0;
    acc1 += t1;
    acc2 += t2;
  }
  // the G lanes of a point are consecutive lanes of one warp: a fixed
  // shuffle tree sums their totals into lane g = 0
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    acc0 += __shfl_down_sync(0xffffffffu, acc0, off, lanes);
    acc1 += __shfl_down_sync(0xffffffffu, acc1, off, lanes);
    acc2 += __shfl_down_sync(0xffffffffu, acc2, off, lanes);
  }
  if (!active || g != 0) return;
  const int at = obase + q * oslots + so;
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
  const size_t smem = 6 * NL * sizeof(int4) +
                      static_cast<size_t>(L.max_entries) *
                          (9 * NL * sizeof(T) + sizeof(int));
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(L.max_blocks),
                  static_cast<unsigned>(L.nout));
  perm_apply_kernel<T, NL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.W), L.entries,
      L.outputs, L.sources, L.kinds, L.mask, L.ns, L.Nx, L.Ny, L.Nz,
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PermApplyLaunch& L = *static_cast<const PermApplyLaunch*>(prepared);
  if (L.W == nullptr || L.entries == nullptr || L.outputs == nullptr ||
      L.sources == nullptr || L.kinds == nullptr || L.mask == nullptr ||
      L.nout < 1 || L.nout > 65535 || L.ns < 1 ||
      3LL * L.ns > 0x7fffffffLL || L.Nx < 1 || L.Ny < 1 || L.Nz < 1 ||
      L.max_entries < 1 || L.max_blocks < 1)
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
