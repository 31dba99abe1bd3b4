"""Native (C++) host-side setup helpers with ctypes bindings (the port's
copy of tpufem/native: ``fastsetup.cpp`` is tpufem's source byte for
byte, pinned by tests/test_torch_vendored.py; the bindings below are
tpufem's).

The library is built with g++ at first use into
``tpufem_torch/_build/native/<hash>/``, keyed by a hash of the source and
the flags, so an unchanged checkout builds once and a changed source
never loads a stale library.  Concurrent processes (pytest-xdist
workers) serialise the build on an ``fcntl`` lock, and each compiles to
a name of its own before an atomic ``os.replace``.  Where the build
fails, every helper returns None (or numpy's answer) and its caller
takes the numpy fallback, as in tpufem (``HAVE_NATIVE`` there).
SA-AMG's aggregation depends on the route: the native pass and the
numpy rounds give equivalent, not identical, aggregates
(tpufem/la/amg.py:98-110).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("tpufem_torch")

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "fastsetup.cpp"
_BUILD = _DIR.parent / "_build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / h.hexdigest()[:16] / "_fastsetup.so"


def _compile(so: pathlib.Path) -> None:
    """Build ``so`` unless another process has: under an exclusive lock,
    into a per-process temporary name, then renamed into place."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, so)
            finally:
                if tmp.exists():
                    tmp.unlink()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _declare(lib: ctypes.CDLL) -> None:
    lib.radix_argsort_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.radix_argsort_u64.restype = None
    lib.unique_inverse_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
    lib.unique_inverse_u64.restype = ctypes.c_int64
    lib.aggregate_vmb.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.aggregate_vmb.restype = ctypes.c_int64
    lib.coo_to_csr_dedup.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double)]
    lib.coo_to_csr_dedup.restype = ctypes.c_int64
    lib.refine_marked_edges_c.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.refine_marked_edges_c.restype = ctypes.c_int64
    lib.refine_closure_count_c.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.refine_closure_count_c.restype = ctypes.c_int64
    lib.tet_edges_c.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.tet_edges_c.restype = ctypes.c_int64
    lib.orient_cells_c.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64]
    lib.orient_cells_c.restype = ctypes.c_int64
    lib.tet_faces_c.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
    lib.tet_faces_c.restype = ctypes.c_int64
    lib.cells_to_csr_dedup.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double)]
    lib.cells_to_csr_dedup.restype = ctypes.c_int64
    lib.plan_windows_c.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.plan_windows_c.restype = ctypes.c_int64
    lib.csr_permute_sym.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    lib.csr_permute_sym.restype = None


def _build() -> Optional[ctypes.CDLL]:
    try:
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        return lib
    except Exception as e:  # toolchain-dependent
        logger.warning("native fastsetup unavailable (%s); numpy fallback", e)
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        _lib = _build() or False  # type: ignore[assignment]
    return _lib or None


def have_native() -> bool:
    return _get() is not None


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Radix argsort for uint64/int64 keys (stable)."""
    k = np.ascontiguousarray(keys).view(np.uint64)
    lib = _get()
    if lib is None:
        return np.argsort(k, kind="stable")
    perm = np.empty(k.shape[0], dtype=np.int64)
    lib.radix_argsort_u64(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(k.shape[0]),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return perm


def unique_inverse_u64(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique sorted keys, inverse) for uint64/int64 keys — the
    np.unique(..., return_inverse=True) replacement used in topology and
    sparsity construction."""
    k = np.ascontiguousarray(keys).view(np.uint64)
    lib = _get()
    if lib is None:
        u, inv = np.unique(k, return_inverse=True)
        return u.view(keys.dtype), inv
    uniq = np.empty(k.shape[0], dtype=np.uint64)
    inv = np.empty(k.shape[0], dtype=np.int64)
    nu = lib.unique_inverse_u64(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(k.shape[0]),
        uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return uniq[:nu].view(keys.dtype).copy(), inv


def aggregate_vmb(indptr: np.ndarray, indices: np.ndarray,
                  vals: Optional[np.ndarray],
                  order: np.ndarray) -> Optional[Tuple[np.ndarray, int]]:
    """Greedy Vanek-Mandel-Brezina aggregation over a CSR strength
    graph: (agg [n] int64, n_agg), or None when the native library is
    unavailable (callers fall back to the vectorized numpy Luby pass in
    tpufem_torch.la.amg)."""
    lib = _get()
    if lib is None:
        return None
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int64)
    od = np.ascontiguousarray(order, dtype=np.int64)
    n = ip.shape[0] - 1
    agg = np.empty(n, dtype=np.int64)
    # keep the contiguous copy alive past the call (ctypes holds a raw
    # pointer, not a reference)
    vv = (np.ascontiguousarray(vals, dtype=np.float64)
          if vals is not None else None)
    vp = (vv.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
          if vv is not None else ctypes.POINTER(ctypes.c_double)())
    nagg = lib.aggregate_vmb(
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vp, ctypes.c_int64(n),
        od.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        agg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return agg, int(nagg)


def refine_marked_edges(verts: np.ndarray, cells: np.ndarray,
                        marked: np.ndarray, max_passes: int = 200):
    """Conforming iterated longest-edge bisection (bit-identical to the
    numpy rounds in tpufem_torch.mesh.refine, pinned by tests): returns
    (verts [V,3] f64, cells [C,4] i64), or None when the native library
    is unavailable."""
    lib = _get()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, dtype=np.float64)
    c = np.ascontiguousarray(cells, dtype=np.int64)
    m = np.ascontiguousarray(marked, dtype=np.int64)
    # capacity heuristics sized to observed closure growth (the spoke
    # 500k shape: 423k marks on 365k cells -> 2.59M cells, 491k verts);
    # a miss is cheap — the C++ reports exact sizes and the loop
    # retries.  The previous 4*nc + 16*nm heuristic first-touched
    # ~340 MB of empty pages per call on this 16-80 MB/s-fault host.
    cap_v = v.shape[0] + 4 * max(m.shape[0], 1) + 64
    cap_c = c.shape[0] + 8 * max(m.shape[0], 1) + 64
    for _ in range(8):
        out_v = np.empty((cap_v, 3), dtype=np.float64)
        out_c = np.empty((cap_c, 4), dtype=np.int64)
        nv_out = ctypes.c_int64()
        nc_out = ctypes.c_int64()
        rc = lib.refine_marked_edges_c(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(v.shape[0]),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(c.shape[0]),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(m.shape[0]), ctypes.c_int64(max_passes),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(cap_v),
            out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(cap_c),
            ctypes.byref(nv_out), ctypes.byref(nc_out))
        if rc == 0:
            # views, not copies: the caps above are tight enough that
            # the slack is small, and the copies cost ~1.3 s/call at
            # 2.6M cells on the deployment host's page-fault wall
            return (out_v[:nv_out.value], out_c[:nc_out.value])
        cap_v = max(cap_v + cap_v // 4, nv_out.value)
        cap_c = max(cap_c + cap_c // 4, nc_out.value)
    return None  # pragma: no cover - capacity loop exhausted


def tet_edges(cells: np.ndarray, nv: int):
    """Unique undirected edges of a tet mesh in one native pass:
    (edge_verts [ne, 2], cell_edges [nc, 6], flipped [nc, 6] bool) per
    tpufem_torch.mesh.structured.LOCAL_EDGES, or None when the native library
    is unavailable or nv >= 2^32 (key packing)."""
    lib = _get()
    if lib is None or nv >= (1 << 32):
        return None
    c = np.ascontiguousarray(cells, dtype=np.int64)
    nc = c.shape[0]
    edge_verts = np.empty((6 * max(nc, 1), 2), dtype=np.int64)
    cell_edges = np.empty((nc, 6), dtype=np.int64)
    flipped = np.empty((nc, 6), dtype=np.uint8)
    ne = lib.tet_edges_c(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(nc), ctypes.c_int64(nv),
        edge_verts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cell_edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flipped.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if ne < 0:
        return None
    return edge_verts[:ne].copy(), cell_edges, flipped.astype(bool)


def orient_cells(verts: np.ndarray, cells: np.ndarray) -> bool:
    """Flip cells IN PLACE to positive Jacobian (one native streaming
    pass).  Returns True when handled natively; False -> caller uses
    the numpy fallback.  ``cells`` must be contiguous int64."""
    lib = _get()
    if lib is None:
        return False
    v = np.ascontiguousarray(verts, dtype=np.float64)
    assert cells.dtype == np.int64 and cells.flags.c_contiguous
    lib.orient_cells_c(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(cells.shape[0]))
    return True


def tet_faces(cells: np.ndarray, nv: int):
    """Unique faces of a tet mesh in one native pass: (face_verts
    [nf, 3] sorted triples, cell_faces [nc, 4], face_cells [nf, 2]
    (-1-padded), boundary_faces [nb]) per
    tpufem_torch.mesh.structured.LOCAL_FACES, or None when unavailable or
    nv >= 2^21 (21-bit key packing)."""
    lib = _get()
    if lib is None or nv >= (1 << 21):
        return None
    c = np.ascontiguousarray(cells, dtype=np.int64)
    nc = c.shape[0]
    face_verts = np.empty((4 * max(nc, 1), 3), dtype=np.int64)
    cell_faces = np.empty((nc, 4), dtype=np.int64)
    face_cells = np.empty((4 * max(nc, 1), 2), dtype=np.int64)
    bnd = np.empty(4 * max(nc, 1), dtype=np.uint8)
    nf = lib.tet_faces_c(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(nc), ctypes.c_int64(nv),
        face_verts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cell_faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        face_cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bnd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if nf < 0:
        return None
    return (face_verts[:nf].copy(), cell_faces, face_cells[:nf].copy(),
            np.nonzero(bnd[:nf])[0])


def cells_to_csr(cell_dofs: np.ndarray, A: np.ndarray, N: int):
    """Element tensors + dofmap -> deduplicated scalar CSR in one
    native pass (indptr, indices i32, data f64), or None when the
    native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    cd = np.ascontiguousarray(cell_dofs, dtype=np.int64)
    Av = np.ascontiguousarray(A, dtype=np.float64)
    ncells, n = cd.shape
    nnz = ncells * n * n
    indptr = np.empty(N + 1, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    m = lib.cells_to_csr_dedup(
        cd.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        Av.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(ncells), ctypes.c_int64(n), ctypes.c_int64(N),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if m < 0:
        return None
    return indptr, cols[:m].copy(), vals[:m].copy()


def plan_windows(indptr: np.ndarray, indices: np.ndarray, R: int, C: int):
    """Per-nonzero window ranks for tpufem_torch.fem.window_op: (w_of [nnz] int32,
    widths [nb] int32, hist [wmax+1] int64) where hist[w] counts the
    nonzeros at rank w, or None when the native library is unavailable.
    Requires column-sorted CSR rows (assemble + csr_permute_sym both
    guarantee this)."""
    lib = _get()
    if lib is None:
        return None
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int64)
    n = ip.shape[0] - 1
    nb = (n + R - 1) // R
    nnz = ix.shape[0]
    w_of = np.empty(nnz, dtype=np.int32)
    widths = np.empty(max(nb, 1), dtype=np.int32)
    hist_cap = (n + C - 1) // C + 1  # a row block can touch every column block
    hist = np.empty(hist_cap, dtype=np.int64)
    wmax = lib.plan_windows_c(
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int64(R), ctypes.c_int64(C),
        w_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(hist_cap))
    if wmax < 0:
        return None
    return w_of, widths[:nb], hist[:wmax + 1].copy()


def csr_permute_sym(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, perm: np.ndarray):
    """Symmetric CSR permutation M[perm][:, perm] with column-sorted
    output rows (the scipy fancy-indexing replacement in
    tpufem_torch.fem.window_op.rcm_csr): (indptr, indices int64, data float64), or
    None when the native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int64)
    dv = np.ascontiguousarray(data, dtype=np.float64)
    pm = np.ascontiguousarray(perm, dtype=np.int64)
    n = ip.shape[0] - 1
    out_ip = np.empty(n + 1, dtype=np.int64)
    out_ix = np.empty(ix.shape[0], dtype=np.int64)
    out_dv = np.empty(dv.shape[0], dtype=np.float64)
    lib.csr_permute_sym(
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        pm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_dv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out_ip, out_ix, out_dv


def coo_to_csr_dedup(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     n: int):
    """Duplicate-summing, zero-eliminating COO -> CSR
    (scipy ``tocsr + sum_duplicates + eliminate_zeros`` equivalent):
    (indptr int64 [n+1], indices int32, data float64), or None when the
    native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    r = np.ascontiguousarray(rows, dtype=np.int64)
    c = np.ascontiguousarray(cols, dtype=np.int64)
    v = np.ascontiguousarray(vals, dtype=np.float64)
    nnz = r.shape[0]
    indptr = np.empty(n + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float64)
    kept = lib.coo_to_csr_dedup(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(nnz), ctypes.c_int64(n),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return indptr, out_cols[:kept].copy(), out_vals[:kept].copy()
