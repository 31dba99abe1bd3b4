// Host-side setup accelerators (C++17, built via tpufem.native at import).
//
// The reference delegates its heavy host-side setup (mesh topology
// derivation, matrix sparsity construction, graph partitioning) to native
// C/C++ libraries (DOLFINx, PT-SCOTCH, PETSc).  tpufem's equivalents are
// sort/unique passes over 64-bit entity keys; this module provides those
// primitives natively because the deployment host exposes a single vCPU
// and numpy's comparison sorts dominate unstructured-path setup.
//
// Exposed (extern "C", ctypes-friendly):
//   radix_argsort_u64(keys, n, perm_out)     -- LSD radix argsort
//   unique_inverse_u64(keys, n, uniq_out, inv_out) -> n_unique
//       (uniq_out sized n, inv_out sized n; keys need not be sorted)
//   aggregate_vmb(indptr, indices, vals, n, order, agg_out) -> n_agg
//       greedy Vanek-Mandel-Brezina aggregation over a CSR strength
//       graph (the serial equivalent of PyAMG standard_aggregation /
//       PETSc GAMG's MIS aggregation; reference solver: GAMG,
//       /root/reference/README.md:63-82)

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// coarse phase timers, enabled by TPUFEM_NATIVE_PROF=1 (perf work only)
namespace prof {
inline bool on() {
  static const bool v = [] {
    const char* e = std::getenv("TPUFEM_NATIVE_PROF");
    return e && e[0] == '1';
  }();
  return v;
}
inline double now() {
  return std::chrono::duration<double>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline void mark(const char* name, double t0) {
  if (on()) std::fprintf(stderr, "[native] %s %.3fs\n", name, now() - t0);
}
}  // namespace prof

extern "C" {

void radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* perm) {
  std::vector<int64_t> tmp(static_cast<size_t>(n));
  int64_t* src = perm;
  int64_t* dst = tmp.data();
  for (int64_t i = 0; i < n; ++i) src[i] = i;

  // find highest nonzero byte to skip empty passes
  uint64_t all = 0;
  for (int64_t i = 0; i < n; ++i) all |= keys[i];
  int max_byte = 0;
  while ((all >> (8 * max_byte)) > 0xFFu && max_byte < 7) ++max_byte;

  size_t count[256];
  for (int b = 0; b <= max_byte; ++b) {
    std::memset(count, 0, sizeof(count));
    const int shift = 8 * b;
    for (int64_t i = 0; i < n; ++i)
      ++count[(keys[src[i]] >> shift) & 0xFFu];
    size_t pos = 0;
    size_t start[256];
    for (int v = 0; v < 256; ++v) { start[v] = pos; pos += count[v]; }
    for (int64_t i = 0; i < n; ++i)
      dst[start[(keys[src[i]] >> shift) & 0xFFu]++] = src[i];
    std::swap(src, dst);
  }
  if (src != perm) std::memcpy(perm, src, sizeof(int64_t) * n);
}

int64_t unique_inverse_u64(const uint64_t* keys, int64_t n,
                           uint64_t* uniq, int64_t* inv) {
  if (n == 0) return 0;
  std::vector<int64_t> perm(static_cast<size_t>(n));
  radix_argsort_u64(keys, n, perm.data());
  int64_t nu = 0;
  uint64_t prev = keys[perm[0]];
  uniq[0] = prev;
  inv[perm[0]] = 0;
  for (int64_t i = 1; i < n; ++i) {
    const uint64_t k = keys[perm[i]];
    if (k != prev) {
      prev = k;
      uniq[++nu] = k;
    }
    inv[perm[i]] = nu;
  }
  return nu + 1;
}

// Tet-mesh edge derivation in one native pass (the hot Topology stage
// of the unstructured spoke cascade: 8 topology builds per mesh;
// numpy's gather/min/max/key passes cost ~1.7 s/call at 150k dofs
// where this is ~0.3 s).  cells [nc, 4] -> unique undirected edges:
//   edge_verts [ne, 2] (lo, hi), cell_edges [nc, 6] (edge gid per
//   LOCAL_EDGES slot), flipped [nc, 6] (local pair ordered hi->lo).
// Requires nv < 2^32 (keys pack (lo << 32) | hi).  Returns ne, or -1
// on overflow.  Local edge table matches tpufem.mesh.structured
// LOCAL_EDGES.
int64_t tet_edges_c(const int64_t* cells, int64_t nc, int64_t nv,
                    int64_t* edge_verts, int64_t* cell_edges,
                    uint8_t* flipped) {
  static const int LEt[6][2] = {{2, 3}, {1, 3}, {1, 2},
                                {0, 3}, {0, 2}, {0, 1}};
  if (nv >= (int64_t(1) << 32)) return -1;
  const int64_t n = nc * 6;
  std::vector<uint64_t> keys(static_cast<size_t>(n));
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t* t = &cells[4 * c];
    for (int e = 0; e < 6; ++e) {
      const int64_t a = t[LEt[e][0]], b = t[LEt[e][1]];
      const uint64_t lo = static_cast<uint64_t>(a < b ? a : b);
      const uint64_t hi = static_cast<uint64_t>(a < b ? b : a);
      keys[6 * c + e] = (lo << 32) | hi;
      flipped[6 * c + e] = a > b;
    }
  }
  std::vector<int64_t> perm(static_cast<size_t>(n));
  radix_argsort_u64(keys.data(), n, perm.data());
  int64_t ne = 0;
  uint64_t prev = ~uint64_t(0);
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = keys[perm[i]];
    if (k != prev) {
      prev = k;
      edge_verts[2 * ne] = static_cast<int64_t>(k >> 32);
      edge_verts[2 * ne + 1] = static_cast<int64_t>(k & 0xFFFFFFFFu);
      ++ne;
    }
    cell_edges[perm[i]] = ne - 1;
  }
  return ne;
}

// Positive-Jacobian cell orientation, in place: swap local vertices
// 2,3 when det([b-a, c-a, d-a]) < 0.  One streaming pass, no
// temporaries (the numpy gather route materialized ~10 page-faulting
// [nc, 3] arrays per topology build).  Returns the flip count.
int64_t orient_cells_c(const double* verts, int64_t* cells, int64_t nc) {
  int64_t flips = 0;
  for (int64_t c = 0; c < nc; ++c) {
    int64_t* t = &cells[4 * c];
    const double* a = &verts[3 * t[0]];
    const double* b = &verts[3 * t[1]];
    const double* p = &verts[3 * t[2]];
    const double* q = &verts[3 * t[3]];
    const double b0 = b[0] - a[0], b1 = b[1] - a[1], b2 = b[2] - a[2];
    const double c0 = p[0] - a[0], c1 = p[1] - a[1], c2 = p[2] - a[2];
    const double d0 = q[0] - a[0], d1 = q[1] - a[1], d2 = q[2] - a[2];
    const double det = b0 * (c1 * d2 - c2 * d1) - b1 * (c0 * d2 - c2 * d0)
                       + b2 * (c0 * d1 - c1 * d0);
    if (det < 0) {
      std::swap(t[2], t[3]);
      ++flips;
    }
  }
  return flips;
}

// Tet-mesh face derivation in one native pass (numpy sort/unique/
// argsort route measured ~8 s at 866k cells on the 1-vCPU host).
// cells [nc, 4] -> unique faces: face_verts [nf, 3] (sorted triple),
// cell_faces [nc, 4] (per LOCAL_FACES slot), face_cells [nf, 2]
// (-1-padded, first-seen order like the numpy stable argsort),
// bnd [nf] flags (count == 1).  Requires nv < 2^21 (21-bit packing).
// Returns nf, or -1 on overflow.
int64_t tet_faces_c(const int64_t* cells, int64_t nc, int64_t nv,
                    int64_t* face_verts, int64_t* cell_faces,
                    int64_t* face_cells, uint8_t* bnd) {
  // Basix local faces (tpufem.mesh.structured.LOCAL_FACES)
  static const int LF[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
  if (nv >= (int64_t(1) << 21)) return -1;
  const int64_t n = nc * 4;
  std::vector<uint64_t> keys(static_cast<size_t>(n));
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t* t = &cells[4 * c];
    for (int f = 0; f < 4; ++f) {
      int64_t a = t[LF[f][0]], b = t[LF[f][1]], d = t[LF[f][2]];
      if (a > b) std::swap(a, b);
      if (b > d) std::swap(b, d);
      if (a > b) std::swap(a, b);
      keys[4 * c + f] = (static_cast<uint64_t>(a) << 42) |
                        (static_cast<uint64_t>(b) << 21) |
                        static_cast<uint64_t>(d);
    }
  }
  std::vector<int64_t> perm(static_cast<size_t>(n));
  radix_argsort_u64(keys.data(), n, perm.data());
  int64_t nf = 0;
  uint64_t prev = ~uint64_t(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t src = perm[i];
    const uint64_t k = keys[src];
    if (k != prev) {
      prev = k;
      face_verts[3 * nf] = static_cast<int64_t>(k >> 42);
      face_verts[3 * nf + 1] = static_cast<int64_t>((k >> 21) & 0x1FFFFFu);
      face_verts[3 * nf + 2] = static_cast<int64_t>(k & 0x1FFFFFu);
      face_cells[2 * nf] = src / 4;
      face_cells[2 * nf + 1] = -1;
      bnd[nf] = 1;
      ++nf;
    } else {
      face_cells[2 * (nf - 1) + 1] = src / 4;
      bnd[nf - 1] = 0;
    }
    cell_faces[src] = nf - 1;
  }
  return nf;
}

// Element tensors + cell dofmap -> deduplicated CSR in ONE native pass
// (scalar block size).  Replaces the numpy repeat/tile/concatenate
// triplet materialization in fem.assemble.assemble_operator (~300 MB
// of page-faulting temporaries on this VM).  A is [ncells, n, n] f64,
// cd is [ncells, n] i64.  Outputs as coo_to_csr_dedup.
int64_t cells_to_csr_dedup(const int64_t* cd, const double* A,
                           int64_t ncells, int64_t n, int64_t N,
                           int64_t* indptr, int32_t* out_cols,
                           double* out_vals) {
  const int64_t nnz = ncells * n * n;
  // ROW-ONLY counting sort (12-bit digits) over 16-byte (row, col, val)
  // records, then per-row std::sort + dedup of ~n*n-entry runs that fit
  // in L1.  A row key needs only ceil(log2 N) bits where the full
  // (row*N + col) key of the previous form needed twice that: 2 digit
  // passes instead of 5 byte passes at spoke-500k -> ~half the memory
  // traffic, which is what bounds this kernel on the deployment host.
  struct Rec {
    int32_t row, col;
    double val;
  };
  std::vector<Rec> r0(static_cast<size_t>(nnz)), r1(static_cast<size_t>(nnz));
  for (int64_t c = 0; c < ncells; ++c) {
    const int64_t* d = &cd[n * c];
    const double* a = &A[n * n * c];
    Rec* rc = &r0[n * n * c];
    for (int64_t i = 0; i < n; ++i) {
      const int32_t ri = static_cast<int32_t>(d[i]);
      for (int64_t j = 0; j < n; ++j) {
        rc[i * n + j].row = ri;
        rc[i * n + j].col = static_cast<int32_t>(d[j]);
        rc[i * n + j].val = a[i * n + j];
      }
    }
  }
  constexpr int kDig = 12;
  constexpr int64_t kBuckets = int64_t(1) << kDig;
  int row_bits = 1;
  while ((int64_t(1) << row_bits) < N) ++row_bits;
  const int npass = (row_bits + kDig - 1) / kDig;
  std::vector<int64_t> count(kBuckets);
  Rec* src = r0.data();
  Rec* dst = r1.data();
  for (int p = 0; p < npass; ++p) {
    const int sh = kDig * p;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < nnz; ++i)
      ++count[(static_cast<uint32_t>(src[i].row) >> sh) & (kBuckets - 1)];
    int64_t pos = 0;
    for (int64_t v = 0; v < kBuckets; ++v) {
      const int64_t c = count[v];
      count[v] = pos;
      pos += c;
    }
    for (int64_t i = 0; i < nnz; ++i)
      dst[count[(static_cast<uint32_t>(src[i].row) >> sh) & (kBuckets - 1)]++] =
          src[i];
    std::swap(src, dst);
  }
  for (int64_t r = 0; r <= N; ++r) indptr[r] = 0;
  int64_t out = 0;
  int64_t i = 0;
  while (i < nnz) {
    const int32_t row = src[i].row;
    int64_t j = i + 1;
    while (j < nnz && src[j].row == row) ++j;
    std::sort(src + i, src + j,
              [](const Rec& a, const Rec& b) { return a.col < b.col; });
    while (i < j) {
      const int32_t col = src[i].col;
      double acc = src[i].val;
      ++i;
      while (i < j && src[i].col == col) acc += src[i++].val;
      if (acc != 0.0) {
        out_cols[out] = col;
        out_vals[out] = acc;
        ++indptr[row + 1];
        ++out;
      }
    }
  }
  for (int64_t r = 0; r < N; ++r) indptr[r + 1] += indptr[r];
  return out;
}

// COO triplets -> deduplicated CSR in one native pass: radix argsort by
// key = row * n + col, then a single sweep summing duplicates, dropping
// exact zeros (scipy sum_duplicates + eliminate_zeros semantics) and
// filling indptr.  Returns the number of stored entries.  out_cols /
// out_vals must be sized nnz; indptr sized n + 1.
int64_t coo_to_csr_dedup(const int64_t* rows, const int64_t* cols,
                         const double* vals, int64_t nnz, int64_t n,
                         int64_t* indptr, int32_t* out_cols,
                         double* out_vals) {
  std::vector<uint64_t> key(static_cast<size_t>(nnz));
  const uint64_t un = static_cast<uint64_t>(n);
  for (int64_t i = 0; i < nnz; ++i)
    key[i] = static_cast<uint64_t>(rows[i]) * un +
             static_cast<uint64_t>(cols[i]);
  std::vector<int64_t> perm(static_cast<size_t>(nnz));
  radix_argsort_u64(key.data(), nnz, perm.data());

  for (int64_t r = 0; r <= n; ++r) indptr[r] = 0;
  int64_t out = 0;
  int64_t i = 0;
  while (i < nnz) {
    const uint64_t k = key[perm[i]];
    double acc = vals[perm[i]];
    ++i;
    while (i < nnz && key[perm[i]] == k) acc += vals[perm[i++]];
    if (acc != 0.0) {
      out_cols[out] = static_cast<int32_t>(k % un);
      out_vals[out] = acc;
      ++indptr[(k / un) + 1];
      ++out;
    }
  }
  for (int64_t r = 0; r < n; ++r) indptr[r + 1] += indptr[r];
  return out;
}

// Conforming marked-edge refinement, Plaza-style (the serial
// replacement for the numpy rounds in tpufem.mesh.refine — reference
// analogue: DOLFINx's C++ Plaza refinement, src/mesh.cpp:414-417).
//
// Phase 1 (closure): propagate the marked-edge set to its fixed point
// under "every cell touching a marked edge has its longest edge
// marked" — longest by (length, key) lexicographic order, a total
// order neighbors agree on.  Phase 2 (subdivision): bisect each
// touched cell by its longest MARKED edge; children inherit remaining
// marked parent edges and re-enter, so each marked edge splits and the
// per-cell growth is bounded by 2^(marked edges).  Conformity: a
// shared face's marked edges are bisected in the same (length, key)
// order on both sides, so the face triangulations agree.  (The
// previous formulation bisected by the longest edge outright and
// re-marked until the marked edge became longest — an iterated-LEB
// cascade that grew a 23.7k-edge marking into 850k bisections on the
// anisotropic spoke geometry.)
//
// Cell ordering per round is survivors ++ child1-block ++ child2-block
// and midpoint ids are assigned in sorted-bisection-key order —
// matching the numpy fallback bit-for-bit (pinned by tests).
//
// Returns 0 on success, 1 if out capacities are insufficient (caller
// retries with *out_nv / *out_nc, which are always set to the required
// sizes on return).
namespace {
// Basix local edge numbering (tpufem.mesh.structured.LOCAL_EDGES).
static const int LE[6][2] = {{2, 3}, {1, 3}, {1, 2}, {0, 3}, {0, 2}, {0, 1}};

inline uint64_t ekey(int64_t a, int64_t b) {
  const uint64_t lo = static_cast<uint64_t>(a < b ? a : b);
  const uint64_t hi = static_cast<uint64_t>(a < b ? b : a);
  return (lo << 32) | hi;
}

// Open-addressing u64 hash set/map (power-of-2 capacity, linear
// probing).  std::unordered_{set,map} dominated the refinement passes
// (~2.7 s/call at 150k dofs: per-edge node allocations + pointer
// chasing across ~15M operations); these flat tables cut that ~3x.
// Key 0 is the empty sentinel — edge keys are (lo << 32) | hi with
// lo < hi, so hi >= 1 and no real key is 0.
inline size_t mix64(uint64_t k) {
  k *= 0x9E3779B97F4A7C15ull;
  return static_cast<size_t>(k >> 29);
}

struct U64Set {
  std::vector<uint64_t> tab;
  size_t mask = 0, n = 0;
  explicit U64Set(size_t cap = 16) { init(cap); }
  void init(size_t cap) {
    size_t m = 16;
    while (m < cap * 2) m <<= 1;
    tab.assign(m, 0);
    mask = m - 1;
    n = 0;
  }
  void grow() {
    std::vector<uint64_t> old;
    old.swap(tab);
    tab.assign((mask + 1) * 2, 0);
    mask = tab.size() - 1;
    n = 0;
    for (uint64_t v : old)
      if (v) insert(v);
  }
  bool insert(uint64_t k) {
    if ((n + 1) * 2 > tab.size()) grow();
    size_t i = mix64(k) & mask;
    for (;; i = (i + 1) & mask) {
      if (tab[i] == k) return false;
      if (tab[i] == 0) {
        tab[i] = k;
        ++n;
        return true;
      }
    }
  }
  bool contains(uint64_t k) const {
    size_t i = mix64(k) & mask;
    for (;; i = (i + 1) & mask) {
      if (tab[i] == k) return true;
      if (tab[i] == 0) return false;
    }
  }
};

struct U64Map {  // u64 -> int64 (insert-or-find)
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  size_t mask = 0, n = 0;
  explicit U64Map(size_t cap = 16) { init(cap); }
  void init(size_t cap) {
    size_t m = 16;
    while (m < cap * 2) m <<= 1;
    keys.assign(m, 0);
    vals.assign(m, 0);
    mask = m - 1;
    n = 0;
  }
  void grow() {
    std::vector<uint64_t> ok;
    std::vector<int64_t> ov;
    ok.swap(keys);
    ov.swap(vals);
    keys.assign((mask + 1) * 2, 0);
    vals.assign(keys.size(), 0);
    mask = keys.size() - 1;
    n = 0;
    for (size_t i = 0; i < ok.size(); ++i)
      if (ok[i]) put(ok[i], ov[i]);
  }
  void put(uint64_t k, int64_t v) {
    if ((n + 1) * 2 > keys.size()) grow();
    size_t i = mix64(k) & mask;
    for (;; i = (i + 1) & mask) {
      if (keys[i] == k) {
        vals[i] = v;
        return;
      }
      if (keys[i] == 0) {
        keys[i] = k;
        vals[i] = v;
        ++n;
        return;
      }
    }
  }
  int64_t get(uint64_t k, int64_t missing) const {
    size_t i = mix64(k) & mask;
    for (;; i = (i + 1) & mask) {
      if (keys[i] == k) return vals[i];
      if (keys[i] == 0) return missing;
    }
  }
};

// Shared phase-1 closure: build the initial-mesh edge->cell incidence
// (one radix argsort; per-key binary search) and propagate the marked
// set S to its fixed point under "every cell touching a marked edge
// has its longest edge marked" ((length, key) lexicographic max — a
// total order neighbors agree on).  On return S holds EXACTLY the set
// of edges phase 2 will bisect: marked edges persist in some child
// until chosen (a bisection by a different edge keeps every other
// parent edge in a child), no new keys are ever marked after closure,
// and each bisected key gets one globally-memoized midpoint — so the
// refined mesh has nv + S.n vertices (relied on by
// refine_closure_count_c; pinned against full refinement by
// tests/test_refine_spoke.py).
void build_closure(const double* vx, const int64_t* cl, int64_t nc,
                   const int64_t* marked, int64_t nm, U64Set& S,
                   std::vector<uint64_t>& base_sorted,
                   std::vector<int64_t>& base_order) {
  std::vector<uint64_t> base_keys(static_cast<size_t>(nc) * 6);
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t* t = &cl[4 * c];
    for (int e = 0; e < 6; ++e)
      base_keys[6 * c + e] = ekey(t[LE[e][0]], t[LE[e][1]]);
  }
  base_order.resize(base_keys.size());
  radix_argsort_u64(base_keys.data(),
                    static_cast<int64_t>(base_keys.size()),
                    base_order.data());
  base_sorted.resize(base_keys.size());
  for (size_t i = 0; i < base_keys.size(); ++i)
    base_sorted[i] = base_keys[base_order[i]];

  auto for_cells_with = [&](uint64_t k, auto&& fn) {
    auto lo = std::lower_bound(base_sorted.begin(), base_sorted.end(), k);
    for (; lo != base_sorted.end() && *lo == k; ++lo)
      fn(base_order[lo - base_sorted.begin()] / 6);
  };

  S.init(static_cast<size_t>(nm) * 4 + 64);
  for (int64_t i = 0; i < nm; ++i)
    S.insert(ekey(marked[2 * i], marked[2 * i + 1]));

  // longest edge of a cell: max length, ties by largest key — matches
  // the numpy (length, key) lexicographic selection bit-for-bit (same
  // double arithmetic: sqrt((dx*dx + dy*dy) + dz*dz))
  auto longest_of = [&](int64_t c, int* la, int* lb) -> uint64_t {
    const int64_t* t = &cl[4 * c];
    double best_len = -1.0;
    uint64_t best_key = 0;
    int be = 0;
    for (int e = 0; e < 6; ++e) {
      const int64_t a = t[LE[e][0]], b = t[LE[e][1]];
      const double dx = vx[3 * a] - vx[3 * b];
      const double dy = vx[3 * a + 1] - vx[3 * b + 1];
      const double dz = vx[3 * a + 2] - vx[3 * b + 2];
      const double len = std::sqrt((dx * dx + dy * dy) + dz * dz);
      const uint64_t k = ekey(a, b);
      if (len > best_len || (len == best_len && k > best_key)) {
        best_len = len;
        best_key = k;
        be = e;
      }
    }
    *la = LE[be][0];
    *lb = LE[be][1];
    return best_key;
  };

  std::vector<uint8_t> seen_cell(static_cast<size_t>(nc), 0);
  std::vector<uint64_t> frontier;
  frontier.reserve(S.n);
  for (uint64_t v : S.tab)
    if (v) frontier.push_back(v);
  while (!frontier.empty()) {
    std::vector<uint64_t> next;
    for (uint64_t k : frontier) {
      for_cells_with(k, [&](int64_t c) {
        if (seen_cell[c]) return;
        seen_cell[c] = 1;
        int la, lb;
        const uint64_t lk = longest_of(c, &la, &lb);
        if (S.insert(lk)) next.push_back(lk);
      });
    }
    frontier.swap(next);
  }
}
}  // namespace

// Refined vertex count WITHOUT refining: phase-1 closure only (the
// bisection-search rounds in tpufem.mesh.spoke need just the vertex
// count, which equals nv + |closure set| — see build_closure).  ~6x
// cheaper than a full refine_marked_edges_c call at spoke-500k sizes
// (no child-cell materialization, no output copies).
extern "C" int64_t refine_closure_count_c(
    const double* verts, const int64_t* cells, int64_t nc,
    const int64_t* marked, int64_t nm) {
  U64Set S;
  std::vector<uint64_t> base_sorted;
  std::vector<int64_t> base_order;
  build_closure(verts, cells, nc, marked, nm, S, base_sorted, base_order);
  return static_cast<int64_t>(S.n);
}

extern "C" int64_t refine_marked_edges_c(
    const double* verts, int64_t nv, const int64_t* cells, int64_t nc,
    const int64_t* marked, int64_t nm, int64_t max_passes,
    double* out_verts, int64_t cap_v, int64_t* out_cells, int64_t cap_c,
    int64_t* out_nv, int64_t* out_nc) {
  const double t_all = prof::now();
  std::vector<double> vx(verts, verts + 3 * nv);
  vx.reserve(3 * (static_cast<size_t>(nv) + 2 * nm + 64));
  // append-only cell store + alive flag + logical order (reserved to
  // the closure-growth ballpark: doubling reallocs copied ~100 MB of
  // cell data per full-size round before)
  const size_t cap_cells = static_cast<size_t>(nc) + 8 * nm + 64;
  std::vector<int64_t> cl(cells, cells + 4 * nc);
  cl.reserve(4 * cap_cells);
  std::vector<uint8_t> alive(static_cast<size_t>(nc), 1);
  alive.reserve(cap_cells);
  std::vector<int64_t> order(static_cast<size_t>(nc));
  for (int64_t i = 0; i < nc; ++i) order[i] = i;

  // Edge -> cells incidence.  The INITIAL mesh's incidence is a flat
  // radix-sorted array (one sort; per-key binary search) — hashing the
  // ~6*nc initial edges cost ~1.5-2 s per call at 366k cells where the
  // sort is ~0.1 s.  Only CHILD cells append to the hash map.
  std::vector<uint64_t> base_keys(static_cast<size_t>(nc) * 6);
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t* t = &cl[4 * c];
    for (int e = 0; e < 6; ++e)
      base_keys[6 * c + e] = ekey(t[LE[e][0]], t[LE[e][1]]);
  }
  std::vector<int64_t> base_order(base_keys.size());
  radix_argsort_u64(base_keys.data(),
                    static_cast<int64_t>(base_keys.size()),
                    base_order.data());
  std::vector<uint64_t> base_sorted(base_keys.size());
  for (size_t i = 0; i < base_keys.size(); ++i)
    base_sorted[i] = base_keys[base_order[i]];

  prof::mark("refine: base sort", t_all);
  // No child-edge incidence is maintained: marked keys are fixed after
  // closure, children inherit marked parent edges directly, and a
  // survivor (cell not bisected in a pass) by construction carries no
  // marked edge — so the next pass's needy set is exactly the CHILDREN
  // whose own six keys intersect S, discoverable by direct probes at
  // child-creation time.  The previous (cell, next) hash-chain
  // incidence cost ~2.4 s of rehash cascades per full-size round
  // (2.2M children x 6 puts at 365k cells, marking fraction 0.89).

  // invoke fn(cell_id) for every INITIAL cell containing k (closure
  // phase + pass-0 needy seeding; children never consult this)
  auto for_cells_with = [&](uint64_t k, auto&& fn) {
    auto lo = std::lower_bound(base_sorted.begin(), base_sorted.end(), k);
    for (; lo != base_sorted.end() && *lo == k; ++lo)
      fn(base_order[lo - base_sorted.begin()] / 6);
  };

  U64Set S(static_cast<size_t>(nm) * 4 + 64);
  for (int64_t i = 0; i < nm; ++i)
    S.insert(ekey(marked[2 * i], marked[2 * i + 1]));

  // longest edge of a cell: max length, ties by largest key — matches
  // the numpy (length, key) lexicographic selection bit-for-bit (same
  // double arithmetic: sqrt((dx*dx + dy*dy) + dz*dz))
  auto longest_of = [&](int64_t c, int* la, int* lb) -> uint64_t {
    const int64_t* t = &cl[4 * c];
    double best_len = -1.0;
    uint64_t best_key = 0;
    int be = 0;
    for (int e = 0; e < 6; ++e) {
      const int64_t a = t[LE[e][0]], b = t[LE[e][1]];
      const double dx = vx[3 * a] - vx[3 * b];
      const double dy = vx[3 * a + 1] - vx[3 * b + 1];
      const double dz = vx[3 * a + 2] - vx[3 * b + 2];
      const double len = std::sqrt((dx * dx + dy * dy) + dz * dz);
      const uint64_t k = ekey(a, b);
      if (len > best_len || (len == best_len && k > best_key)) {
        best_len = len;
        best_key = k;
        be = e;
      }
    }
    *la = LE[be][0];
    *lb = LE[be][1];
    return best_key;
  };

  // longest MARKED edge (phase-2 subdivision rule): (length, key) max
  // among edges in S; returns 0 if the cell has no marked edge
  auto longest_marked_of = [&](int64_t c, int* la, int* lb) -> uint64_t {
    const int64_t* t = &cl[4 * c];
    double best_len = -1.0;
    uint64_t best_key = 0;
    int be = -1;
    for (int e = 0; e < 6; ++e) {
      const int64_t a = t[LE[e][0]], b = t[LE[e][1]];
      const uint64_t k = ekey(a, b);
      if (!S.contains(k)) continue;
      const double dx = vx[3 * a] - vx[3 * b];
      const double dy = vx[3 * a + 1] - vx[3 * b + 1];
      const double dz = vx[3 * a + 2] - vx[3 * b + 2];
      const double len = std::sqrt((dx * dx + dy * dy) + dz * dz);
      if (len > best_len || (len == best_len && k > best_key)) {
        best_len = len;
        best_key = k;
        be = e;
      }
    }
    if (be < 0) return 0;
    *la = LE[be][0];
    *lb = LE[be][1];
    return best_key;
  };

  // phase 1: closure BFS over the initial mesh — every cell touching a
  // marked edge gets its longest edge marked, to fixed point
  {
    std::vector<uint8_t> seen_cell(static_cast<size_t>(nc), 0);
    std::vector<uint64_t> frontier;
    frontier.reserve(S.n);
    for (uint64_t v : S.tab)
      if (v) frontier.push_back(v);
    while (!frontier.empty()) {
      std::vector<uint64_t> next;
      for (uint64_t k : frontier) {
        for_cells_with(k, [&](int64_t c) {
          if (seen_cell[c]) return;
          seen_cell[c] = 1;
          int la, lb;
          const uint64_t lk = longest_of(c, &la, &lb);
          if (S.insert(lk)) next.push_back(lk);
        });
      }
      frontier.swap(next);
    }
  }

  prof::mark("refine: closure BFS", t_all);
  // phase 2: subdivision rounds.  Pass 0's needy set comes from the
  // closed set via the base incidence; afterwards only CHILDREN can
  // still contain marked edges (every cell containing one was
  // bisected), and each child self-reports at creation time by probing
  // its six keys against S — no incidence maintenance.
  std::vector<int64_t> needy_next;  // children carrying marked keys
  std::vector<uint8_t> needy;  // indexed by cell id (grows)
  // GLOBAL midpoint memo: neighbors may bisect the same edge in
  // different rounds; both must connect to ONE midpoint vertex (a
  // per-round memo created duplicate coincident vertices -> hanging
  // faces)
  U64Map mid_of(static_cast<size_t>(nm) * 4 + 64);
  for (int64_t pass = 0; pass < max_passes; ++pass) {
    needy.assign(cl.size() / 4, 0);
    if (pass == 0) {
      for (uint64_t k : S.tab) {
        if (!k) continue;
        for_cells_with(k, [&](int64_t c) {
          if (alive[c]) needy[c] = 1;
        });
      }
    } else {
      for (int64_t c : needy_next) needy[c] = 1;
    }

    // bisect in logical order: midpoints numbered in sorted-key order,
    // new logical order = survivors ++ child1-block ++ child2-block
    std::vector<int64_t> bis;
    std::vector<int64_t> survivors;
    for (int64_t c : order)
      (needy[c] ? bis : survivors).push_back(c);
    if (bis.empty()) break;

    std::vector<uint64_t> ukeys;
    ukeys.reserve(bis.size());
    std::vector<int> la_of(bis.size()), lb_of(bis.size());
    std::vector<uint64_t> key_of_bis(bis.size());
    for (size_t i = 0; i < bis.size(); ++i) {
      const uint64_t k = longest_marked_of(bis[i], &la_of[i], &lb_of[i]);
      key_of_bis[i] = k;
      ukeys.push_back(k);
    }
    std::sort(ukeys.begin(), ukeys.end());
    ukeys.erase(std::unique(ukeys.begin(), ukeys.end()), ukeys.end());
    for (size_t i = 0; i < ukeys.size(); ++i) {
      if (mid_of.get(ukeys[i], -1) >= 0) continue;  // split earlier
      const int64_t a = static_cast<int64_t>(ukeys[i] >> 32);
      const int64_t b = static_cast<int64_t>(ukeys[i] & 0xFFFFFFFFull);
      const int64_t id = static_cast<int64_t>(vx.size() / 3);
      vx.push_back(0.5 * (vx[3 * a] + vx[3 * b]));
      vx.push_back(0.5 * (vx[3 * a + 1] + vx[3 * b + 1]));
      vx.push_back(0.5 * (vx[3 * a + 2] + vx[3 * b + 2]));
      mid_of.put(ukeys[i], id);
    }

    std::vector<int64_t> ch1_ids, ch2_ids;
    ch1_ids.reserve(bis.size());
    ch2_ids.reserve(bis.size());
    needy_next.clear();
    for (int pass_child = 0; pass_child < 2; ++pass_child) {
      for (size_t i = 0; i < bis.size(); ++i) {
        const int64_t c = bis[i];
        const int64_t mid = mid_of.get(key_of_bis[i], -1);
        const int64_t id = static_cast<int64_t>(cl.size() / 4);
        for (int j = 0; j < 4; ++j) cl.push_back(cl[4 * c + j]);
        cl[4 * id + (pass_child == 0 ? la_of[i] : lb_of[i])] = mid;
        alive.push_back(1);
        (pass_child == 0 ? ch1_ids : ch2_ids).push_back(id);
        const int64_t* t = &cl[4 * id];
        for (int e = 0; e < 6; ++e) {
          if (S.contains(ekey(t[LE[e][0]], t[LE[e][1]]))) {
            needy_next.push_back(id);
            break;
          }
        }
      }
    }
    for (int64_t c : bis) alive[c] = 0;
    order.clear();
    order.insert(order.end(), survivors.begin(), survivors.end());
    order.insert(order.end(), ch1_ids.begin(), ch1_ids.end());
    order.insert(order.end(), ch2_ids.begin(), ch2_ids.end());

    if (needy_next.empty()) break;
  }

  prof::mark("refine: passes", t_all);
  *out_nv = static_cast<int64_t>(vx.size() / 3);
  *out_nc = static_cast<int64_t>(order.size());
  if (*out_nv > cap_v || *out_nc > cap_c) return 1;
  std::memcpy(out_verts, vx.data(), sizeof(double) * vx.size());
  for (size_t i = 0; i < order.size(); ++i)
    for (int j = 0; j < 4; ++j)
      out_cells[4 * i + j] = cl[4 * order[i] + j];
  prof::mark("refine: total", t_all);
  return 0;
}

// CSR -> padded ELL fill (scalar values), with a capped width K and a
// COO overflow tail for longer rows.  out_cols/out_vals sized n*K
// (zero-filled here); ov_* sized (nnz) worst case.  Values are written
// f64; the Python wrapper casts views as needed.  Returns the overflow
// count.
int64_t csr_fill_ell(const int64_t* indptr, const int32_t* indices,
                     const double* data, int64_t n, int64_t K,
                     int32_t* out_cols, double* out_vals,
                     int32_t* ov_rows, int32_t* ov_cols, double* ov_vals) {
  std::memset(out_cols, 0, sizeof(int32_t) * n * K);
  std::memset(out_vals, 0, sizeof(double) * n * K);
  int64_t m = 0;
  for (int64_t r = 0; r < n; ++r) {
    int64_t w = 0;
    for (int64_t e = indptr[r]; e < indptr[r + 1]; ++e) {
      if (w < K) {
        out_cols[r * K + w] = indices[e];
        out_vals[r * K + w] = data[e];
        ++w;
      } else {
        ov_rows[m] = static_cast<int32_t>(r);
        ov_cols[m] = indices[e];
        ov_vals[m] = data[e];
        ++m;
      }
    }
  }
  return m;
}

// Window planning for fem.window_op (block-windowed SpMV).  For each
// row block of R rows, the distinct column-blocks (width C) its entries
// touch are ranked ascending; w_of[e] is the rank of nonzero e's column
// block within its row block's list.  Exploits that CSR rows are
// column-sorted: each block needs only a small local sort (~R * row_nnz
// entries), where the numpy formulation pays a global argsort + unique
// over all nnz (~7 s at 7M nnz on this 1-vCPU host vs ~0.15 s here).
// Outputs: w_of [nnz] int32, widths [nb] int32, hist [hist_cap] int64
// (hist[w] = number of nonzeros at rank w; the cost model's overflow
// count for width Wc is sum(hist[Wc:])).  Returns wmax+1 (the needed
// hist length), or -1 if that exceeds hist_cap.
int64_t plan_windows_c(const int64_t* indptr, const int64_t* indices,
                       int64_t n, int64_t R, int64_t C,
                       int32_t* w_of, int32_t* widths, int64_t* hist,
                       int64_t hist_cap) {
  const int64_t nb = (n + R - 1) / R;
  std::memset(hist, 0, sizeof(int64_t) * hist_cap);
  std::vector<int64_t> cbs;
  cbs.reserve(1024);
  int64_t wmax = 0;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t r0 = b * R;
    const int64_t r1 = std::min(n, r0 + R);
    const int64_t e0 = indptr[r0], e1 = indptr[r1];
    cbs.clear();
    for (int64_t e = e0; e < e1; ++e) cbs.push_back(indices[e] / C);
    std::sort(cbs.begin(), cbs.end());
    cbs.erase(std::unique(cbs.begin(), cbs.end()), cbs.end());
    const int64_t w = static_cast<int64_t>(cbs.size());
    widths[b] = static_cast<int32_t>(w);
    if (w > wmax) wmax = w;
    if (w > hist_cap) return -1;
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t cb = indices[e] / C;
      const int64_t rank =
          std::lower_bound(cbs.begin(), cbs.end(), cb) - cbs.begin();
      w_of[e] = static_cast<int32_t>(rank);
      ++hist[rank];
    }
  }
  return wmax;
}

// Symmetric permutation of a CSR matrix: out = M[perm][:, perm] with
// each output row column-sorted (the RCM reorder in fem.window_op;
// scipy's fancy-indexing route costs ~2 s at 7M nnz where this is
// ~0.3 s).  iperm[old] = new is derived internally.  indices int64,
// data double.  out_* sized like the inputs.
void csr_permute_sym(const int64_t* indptr, const int64_t* indices,
                     const double* data, int64_t n, const int64_t* perm,
                     int64_t* out_indptr, int64_t* out_indices,
                     double* out_data) {
  std::vector<int64_t> iperm(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) iperm[perm[i]] = i;
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i)
    out_indptr[i + 1] =
        out_indptr[i] + (indptr[perm[i] + 1] - indptr[perm[i]]);
  std::vector<std::pair<int64_t, double>> row;
  row.reserve(256);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t o = perm[i];
    row.clear();
    for (int64_t e = indptr[o]; e < indptr[o + 1]; ++e)
      row.emplace_back(iperm[indices[e]], data[e]);
    std::sort(row.begin(), row.end());
    int64_t out = out_indptr[i];
    for (const auto& p : row) {
      out_indices[out] = p.first;
      out_data[out] = p.second;
      ++out;
    }
  }
}

// Greedy VMB aggregation over the CSR strength graph (no self loops).
//
// Phase 1 (roots): visiting nodes in `order`, a node whose strong
// neighborhood is entirely unaggregated becomes a root and absorbs it.
// Phase 2 (attach): each leftover joins the phase-1 aggregate of its
// strongest aggregated neighbor (decisions read the phase-1 state only,
// so attachment does not cascade).  Phase 3 (sweep): remaining nodes
// root new aggregates from whatever unaggregated neighbors are left.
// `vals` may be null (first aggregated neighbor wins in phase 2).
// Returns the number of aggregates; agg[i] in [0, n_agg).
int64_t aggregate_vmb(const int64_t* indptr, const int64_t* indices,
                      const double* vals, int64_t n,
                      const int64_t* order, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t nagg = 0;

  // phase 1
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order ? order[k] : k;
    if (agg[i] != -1) continue;
    bool free_nb = true;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e)
      if (agg[indices[e]] != -1) { free_nb = false; break; }
    if (!free_nb) continue;
    agg[i] = nagg;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e)
      agg[indices[e]] = nagg;
    ++nagg;
  }

  // phase 2: against the phase-1 state (mark joiners with ~a so later
  // rows see them as still-unaggregated)
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    int64_t best = -1;
    double best_v = -1.0;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e) {
      const int64_t a = agg[indices[e]];
      if (a < 0) continue;  // unaggregated or phase-2 joiner
      const double v = vals ? vals[e] : 1.0;
      if (v > best_v) { best_v = v; best = a; }
    }
    // ~(best+1) <= -2: invisible this phase, distinct from the -1
    // unaggregated marker even for best == 0
    if (best != -1) agg[i] = ~(best + 1);
  }
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] < -1) agg[i] = ~agg[i] - 1;

  // phase 3
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order ? order[k] : k;
    if (agg[i] != -1) continue;
    agg[i] = nagg;
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e)
      if (agg[indices[e]] == -1) agg[indices[e]] = nagg;
    ++nagg;
  }
  return nagg;
}

}  // extern "C"
