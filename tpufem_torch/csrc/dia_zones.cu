// Apply of the multi-kind (P2/P3) DIA operator, for Hopper (sm_90a).
//
//   y[ko, so][z, y, x] = sum_{terms t of (ko, so)}
//       field_t[zone(z), y, x] * x[ki_t, si_t][z + dz_t, y + dy_t, x + dx_t]
//   (a source outside its grid read as 0)
//
// A P2/P3 DiaOperator (tpufem_torch/fem/dia_op.py) couples the typed dof
// grids of the layout: kind g is the flat segment [base, base + X Y Z
// slots) shaped [Z, Y, X, slots] (the vertex grid, 7 edge types with k - 1
// slots, 12 face types at P3), and the grids of different kinds differ by
// one on some axes.  Each term has a shift of up to +-2 per axis and a
// weight field over its output grid: zone form [7, Y, X] (rows 0-2 the
// z-lo planes, 3 the z-mid plane broadcast along z, 4-6 the z-hi planes;
// the zone is that of the OUTPUT plane z), or one full [Z, Y, X] field on
// a grid shorter than 7 planes.  P2 has 230 terms over 8 outputs (19-65
// each), P3 1311 over 27 (30-175 each).  The tables, built by
// tpufem_torch/fem/dia_zones.py:pack_terms:
//
//   terms   [T, 8]  (ki, si, dx, dy, dz, field offset, zoned, 0), plan order
//   outputs [O, 4]  (ko, so, first term, count), heaviest output first
//   kinds   [K, 5]  (base, X, Y, Z, slots)
//
// Replaces tpufem's DiaOperator._apply_zones for multi-kind operators
// (tpufem/fem/dia_op.py:462), which XLA runs: tpufem has no Pallas kernel
// for it.  The plain PyTorch version is
// tpufem_torch/fem/dia_zones.py:dia_zones_apply_plain.
//
// What bounds it on an H100: bytes.  The fields are read once, x and y
// once each: at P2 500k (32x40x48 cubes, 510,705 dofs) 8.52 MB of fields
// + 4.09 MB, 0.0038 ms at 3.35 TB/s; at P3 500k (24x24x32, 516,913 dofs)
// 21.93 + 4.14 MB, 0.0078 ms; one multiply-add per term and point.  The
// fields fit the 50 MB L2, so applies that follow one another may run
// under the HBM bound.
//
// The design, simple first: a block is 256 consecutive points of one
// output (kind, slot) grid (blockIdx.y, heaviest output first; blockIdx.x
// the points), so all its threads walk the same term list, which the
// block stages once in shared memory (32 bytes a term: the source grid's
// offset, slots and dims, the shifts, the field offset and zone flag).
// Fields and sources are read from global memory (L2), the mid-zone
// fields of neighbouring z planes from the same [Y, X] plane.  A term is
// rounded as the plain version rounds it: the product, then the sum (no
// fused multiply-add), in plan order, so the kernel gives the plain
// version's bits.  What a launch needs beside x, y and the stream is a
// DiaZonesLaunch packed once per operator.
//
// Why one point a thread still: designs that gave a thread several z
// planes of a point, to decode a term once for them, ran slower at P2 / P3
// 500k on an H100 (scripts/zones_bs3_times.py, PERF.md): a thread
// with k planes leaves k times fewer threads to hide the loads' latency,
// and a branch on a run's length between a value's load and its product
// made each load wait for the one before.

#include <cuda_runtime.h>

#include "strip_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 1536;  // tpufem_torch/fem/dia_zones.py:MAX_TERMS
constexpr int kZoneRows = 7;
constexpr int kHalo = 3;

// Everything a launch needs beside x, y and the stream, filled once per
// operator (mirrored by tpufem_torch/_build.py:DiaZonesLaunch).
struct DiaZonesLaunch {
  const void* F;       // the zone fields of every term, flat
  const int* terms;    // [nterms, 8]
  const int* outputs;  // [nout, 4]
  const int* kinds;    // [nkinds, 5]
  int device, nterms, nout, nkinds, max_terms, max_points;
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
__global__ void __launch_bounds__(kThreads)
dia_zones_kernel(const T* __restrict__ x, const T* __restrict__ F,
                 const int* __restrict__ terms,
                 const int* __restrict__ outputs,
                 const int* __restrict__ kinds, T* __restrict__ y) {
  // per term: (source offset base + si, source slots, Xi, Yi) and
  // (Zi, shifts packed as bytes dx + 8 | dy + 8 << 8 | dz + 8 << 16,
  // field offset, zoned)
  extern __shared__ int4 ent[];
  const int o = blockIdx.y;
  const int ko = outputs[4 * o], so = outputs[4 * o + 1];
  const int start = outputs[4 * o + 2], count = outputs[4 * o + 3];
  const int obase = kinds[5 * ko], Xo = kinds[5 * ko + 1];
  const int Yo = kinds[5 * ko + 2], Zo = kinds[5 * ko + 3];
  const int oslots = kinds[5 * ko + 4];
  const int npts = Xo * Yo * Zo;
  const int p0 = blockIdx.x * kThreads;
  if (p0 >= npts) return;  // the whole block: this output is smaller
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int* e = terms + 8 * (start + k);
    const int* g = kinds + 5 * e[0];
    ent[2 * k] = make_int4(g[0] + e[1], g[4], g[1], g[2]);
    ent[2 * k + 1] = make_int4(
        g[3], (e[2] + 8) | ((e[3] + 8) << 8) | ((e[4] + 8) << 16), e[5],
        e[6]);
  }
  __syncthreads();
  const int p = p0 + static_cast<int>(threadIdx.x);
  if (p >= npts) return;
  const int ix = p % Xo;
  const int zy = p / Xo;
  const int iy = zy % Yo;
  const int iz = zy / Yo;
  // the zone of the output plane: z-lo rows 0-2, z-mid row 3, z-hi 4-6
  const int row = iz < kHalo ? iz
                             : (iz >= Zo - kHalo ? kZoneRows - (Zo - iz)
                                                 : kHalo);
  const int zoned_at = (row * Yo + iy) * Xo + ix;
  T acc = T(0);
  for (int k = 0; k < count; ++k) {
    const int4 a = ent[2 * k];
    const int4 b = ent[2 * k + 1];
    const int xs = ix + (b.y & 0xff) - 8;
    const int ys = iy + ((b.y >> 8) & 0xff) - 8;
    const int zs = iz + ((b.y >> 16) & 0xff) - 8;
    const bool in = static_cast<unsigned>(xs) < static_cast<unsigned>(a.z) &&
                    static_cast<unsigned>(ys) < static_cast<unsigned>(a.w) &&
                    static_cast<unsigned>(zs) < static_cast<unsigned>(b.x);
    const long long at =
        a.x + static_cast<long long>((zs * a.w + ys) * a.z + xs) * a.y;
    const T v = in ? __ldg(x + at) : T(0);
    const T w = __ldg(F + b.z + (b.w ? zoned_at : p));
    const T t = mul_rn(w, v);
    acc = k == 0 ? t : add_rn(acc, t);
  }
  y[obase + static_cast<long long>(p) * oslots + so] = acc;
}

template <typename T>
int launch(const void* prepared, const void* x, void* y, void* stream) {
  if (prepared == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DiaZonesLaunch& L = *static_cast<const DiaZonesLaunch*>(prepared);
  if (L.terms == nullptr || L.outputs == nullptr || L.kinds == nullptr ||
      (L.F == nullptr && L.nterms > 0) || L.nterms < 0 || L.nout < 1 ||
      L.nout > 65535 || L.nkinds < 1 || L.max_terms < 0 ||
      L.max_terms > kMaxTerms || L.max_points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(L.max_points) + kThreads -
                            1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tpufem::DeviceScope scope(L.device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const size_t smem = static_cast<size_t>(L.max_terms) * 2 * sizeof(int4);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(L.nout));
  dia_zones_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(L.F), L.terms,
      L.outputs, L.kinds, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpufem_dia_zones_f32(const void* prepared, const void* x, void* y,
                         void* stream) {
  return launch<float>(prepared, x, y, stream);
}

int tpufem_dia_zones_f64(const void* prepared, const void* x, void* y,
                         void* stream) {
  return launch<double>(prepared, x, y, stream);
}

}  // extern "C"
