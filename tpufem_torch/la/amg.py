"""Smoothed-aggregation algebraic multigrid (counterpart of
tpufem/la/amg.py; its module docstring, :1-19, has the design).

Setup on the host in float64 (numpy / scipy), copied from tpufem and
pinned bit for bit by the tests: the strength graph, VMB aggregation
(the port's native pass, or tpufem's numpy rounds where the library does
not load), the pairwise aggressive merge, the per-aggregate QR of the
near-nullspace (tentative P0), the Jacobi-smoothed P with its top-k row
filter, the Galerkin product, power-iteration lmax per level, the densify
guard, and the eigen-cutoff pseudo-inverse of the coarsest level.

The V-cycle on the device (``vcycle``, tpufem/la/amg.py:772-815):
Chebyshev smoothing on every level; every sparse operator is a
``CsrMatrix`` product, the kernel of csrc/csr_spmv.cu (the fine operator
where the level stores one, the assembled P and P^T, the sparse coarse
levels, and in the factored form P0 and P0^T); a dense level is a
``DenseMat`` (bfloat16 for float32 solves, the kernel of
csrc/dense_gemv.cu; float64 through ``torch.matmul``); the coarse solve
is ``torch.matmul``.  In the factored form tpufem applies P0^T as a
scatter-add (``.at[fcols].add``, :806-807); the port applies a
precomputed P0^T CSR, a deterministic sum without atomics.

``planar`` (elasticity on the cube): tpufem builds the hierarchy on the
interleaved CSR (tpufem/problems/elasticity.py:155-165) and the port
builds the same host hierarchy, then permutes the fine level's rows (P0,
dinv, omega dinv) to the component-planar layout its operator runs in:
the same V-cycle.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from tpufem_torch import native
from tpufem_torch.fem.csr_spmv import CsrMatrix
from tpufem_torch.fem.dense_gemv import DenseMat
from tpufem_torch.la.chebyshev import (chebyshev_smoother,
                                       chebyshev_smoother_zero,
                                       power_iteration_lmax)

logger = logging.getLogger("tpufem_torch")

DENSE_BYTES_CAP = 1536 * 1024 * 1024  # tpufem's densify guard (1.5 GiB)


# ---------------------------------------------------------------------------
# Strength of connection + aggregation (tpufem's code)
# ---------------------------------------------------------------------------


def node_strength_graph(A: sp.csr_matrix, bs: int, theta: float) -> sp.csr_matrix:
    """Node-level symmetric strength graph (no self loops): scalar, strong
    if |a_ij| > theta sqrt(a_ii a_jj); blocked, blocks condensed by
    max-abs first (tpufem/la/amg.py:46-85)."""
    if bs > 1:
        coo = A.tocoo()
        rows = (coo.row // bs).astype(np.int64)
        cols = (coo.col // bs).astype(np.int64)
        vals = np.abs(coo.data)
        n = A.shape[0] // bs
        key = rows * n + cols
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        starts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
        mx = np.maximum.reduceat(vals[order], starts)
        uk = key_s[starts]
        S = sp.coo_matrix((mx, (uk // n, uk % n)), shape=(n, n)).tocsr()
    else:
        # copies: setdiag / eliminate_zeros below work in place
        S = sp.csr_matrix((np.abs(A.data), A.indices.copy(), A.indptr.copy()),
                          shape=A.shape)
    d = S.diagonal()
    d = np.where(d > 0, d, 1.0)
    if theta > 0.0:
        coo = S.tocoo()
        keep = np.abs(coo.data) > theta * np.sqrt(d[coo.row] * d[coo.col])
        S = sp.coo_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                          shape=S.shape).tocsr()
    S.setdiag(0.0)
    S.eliminate_zeros()
    return S


def _segment_max(vals: np.ndarray, indptr: np.ndarray, default: float) -> np.ndarray:
    n = indptr.shape[0] - 1
    out = np.full(n, default)
    nnz = np.diff(indptr)
    ne = np.flatnonzero(nnz > 0)
    if ne.size:
        out[ne] = np.maximum.reduceat(vals, indptr[ne])
    return out


def aggregate_nodes(S: sp.csr_matrix, seed: int = 0,
                    max_rounds: int = 64) -> Tuple[np.ndarray, int]:
    """Vanek-Mandel-Brezina aggregation, randomized by ``seed``
    (tpufem/la/amg.py:98-202): the native greedy pass where the library
    loads, else the vectorized Luby-style rounds (equivalent aggregates,
    not identical ones).  Returns (agg [n] int64, num_aggregates)."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)

    got = native.aggregate_vmb(indptr, indices, S.data, perm)
    if got is not None:
        return got

    prio = perm.astype(np.float64)
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    nnz = np.diff(indptr)
    rows_of_nnz = np.repeat(np.arange(n), nnz)
    prio_nnz = prio[indices]
    ne = np.flatnonzero(nnz > 0)
    starts = indptr[ne]

    def seg_max(vals: np.ndarray, default: float) -> np.ndarray:
        out = np.full(n, default)
        if ne.size:
            out[ne] = np.maximum.reduceat(vals, starts)
        return out

    for _ in range(max_rounds):
        cand = agg < 0
        if not cand.any():
            break
        # VMB phase-1 eligibility: the whole strong neighbourhood is still
        # unaggregated
        agg_nb = agg[indices] >= 0
        has_agg_nb = np.zeros(n, dtype=bool)
        if ne.size:
            has_agg_nb[ne] = np.maximum.reduceat(
                agg_nb.view(np.uint8), starts) > 0
        elig = cand & ~has_agg_nb
        if not elig.any():
            break
        nb_p = np.where(elig[indices], prio_nnz, -1.0)
        nmax = seg_max(nb_p, -1.0)
        roots = elig & (prio > nmax)
        nroots = int(roots.sum())
        if nroots == 0:
            break
        root_ids = np.flatnonzero(roots)
        agg[root_ids] = nagg + np.arange(nroots)
        nagg += nroots
        # unaggregated nodes with a root neighbour join the max-priority root
        cand = agg < 0
        rp = np.where(roots[indices], prio_nnz, -1.0)
        rmax = seg_max(rp, -1.0)
        join = cand & (rmax >= 0.0)
        if join.any():
            rows = rows_of_nnz
            hit = (rp == rmax[rows]) & roots[indices] & join[rows]
            first = np.zeros(n, dtype=np.int64)
            idx = np.flatnonzero(hit)
            first[rows[idx[::-1]]] = indices[idx[::-1]]
            agg[np.flatnonzero(join)] = agg[first[np.flatnonzero(join)]]

    # phase 2: attach stragglers to any aggregated neighbour
    for _ in range(4):
        agg_nnz = agg[indices]
        cand = agg < 0
        if not cand.any():
            break
        ap = np.where(agg_nnz >= 0, prio_nnz, -1.0)
        amax = seg_max(ap, -1.0)
        join = cand & (amax >= 0.0)
        if not join.any():
            break
        rows = rows_of_nnz
        hit = (ap == amax[rows]) & (agg_nnz >= 0) & join[rows]
        first = np.zeros(n, dtype=np.int64)
        idx = np.flatnonzero(hit)
        first[rows[idx[::-1]]] = indices[idx[::-1]]
        agg[np.flatnonzero(join)] = agg[first[np.flatnonzero(join)]]

    # phase 3: isolated leftovers become singletons
    left = np.flatnonzero(agg < 0)
    if left.size:
        agg[left] = nagg + np.arange(left.size)
        nagg += left.size
    return agg, nagg


def match_pairs(S2: sp.csr_matrix, rounds: int = 8) -> np.ndarray:
    """Mutual-heaviest-edge matching on a weighted graph: a dense
    relabelling where matched nodes share a label
    (tpufem/la/amg.py:205-241)."""
    n = S2.shape[0]
    indptr, indices, data = S2.indptr, S2.indices, S2.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    mate = np.full(n, -1, dtype=np.int64)
    for _ in range(rounds):
        un = mate < 0
        if not un.any():
            break
        w = np.where(un[indices] & un[rows], data, -np.inf)
        mx = _segment_max(w, indptr, -np.inf)
        prop = np.full(n, -1, dtype=np.int64)
        hit = np.isfinite(w) & (w == mx[rows])
        idx = np.flatnonzero(hit)
        # reverse so the lowest column index wins ties
        prop[rows[idx[::-1]]] = indices[idx[::-1]]
        valid = prop >= 0
        p = np.where(valid, prop, 0)
        mutual = valid & (prop[p] == np.arange(n))
        i = np.flatnonzero(mutual & (np.arange(n) < prop))
        if i.size == 0:
            break
        mate[i] = prop[i]
        mate[prop[i]] = i
    root = np.where(mate >= 0, np.minimum(np.arange(n), mate),
                    np.arange(n))
    _, pair = np.unique(root, return_inverse=True)
    return pair.astype(np.int64)


# ---------------------------------------------------------------------------
# Tentative + smoothed prolongator (tpufem's code)
# ---------------------------------------------------------------------------


def tentative_prolongator(agg: np.ndarray, nagg: int, B: np.ndarray,
                          bs: int) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Per-aggregate QR fit of the near-nullspace B [ndofs, m]: (P0
    [ndofs, ncoarse] CSR, Bc [ncoarse, m]); fully dead aggregates are
    dropped, dependent columns zeroed (tpufem/la/amg.py:249-305)."""
    ndofs, m = B.shape
    nnode = ndofs // bs
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=nagg)
    maxn = int(counts.max())
    pad_nodes = np.zeros((nagg, maxn), dtype=np.int64)
    rowmask = np.zeros((nagg, maxn), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(nnode) - starts[agg[order]]
    pad_nodes[agg[order], pos] = order
    rowmask[agg[order], pos] = True
    dofs = (pad_nodes[..., None] * bs + np.arange(bs)).reshape(nagg, maxn * bs)
    rmask = np.repeat(rowmask, bs, axis=1)
    blocks = B[dofs] * rmask[..., None]  # [nagg, rows, m]
    Q, R = np.linalg.qr(blocks)
    Q = Q * rmask[..., None]
    rdiag = np.abs(np.diagonal(R, axis1=1, axis2=2))  # [nagg, m]
    scale = np.maximum(rdiag.max(axis=1, keepdims=True), 1e-300)
    bad = (rdiag < 1e-8 * scale) | (rdiag < 1e-12)
    if bad.any():
        Q = np.where(bad[:, None, :], 0.0, Q)
        R = np.where(bad[:, :, None], 0.0, R)
    keep_agg = ~bad.all(axis=1)
    keep = np.repeat(keep_agg, m)
    ncoarse = int(keep.sum())
    colmap = np.cumsum(keep) - 1

    rows = dofs.reshape(-1)
    cols = ((np.arange(nagg)[:, None, None] * m + np.arange(m)[None, None, :])
            * np.ones((1, maxn * bs, 1), dtype=np.int64))
    vals = Q
    mask = np.repeat(rmask.reshape(-1), m) & keep[cols.reshape(-1)]
    rows = np.repeat(rows, m)[mask]
    cols = colmap[cols.reshape(-1)[mask]]
    data = vals.reshape(-1)[mask]
    P0 = sp.coo_matrix((data, (rows, cols)), shape=(ndofs, ncoarse)).tocsr()
    Bc = R.reshape(nagg * m, m)[keep]
    return P0, Bc


def smooth_prolongator(A: sp.csr_matrix, P0: sp.csr_matrix,
                       damping: float, lmax: float,
                       filter_k: int = 0) -> sp.csr_matrix:
    """P = (I - omega D^-1 A) P0, omega = damping / lmax, then the top-k
    row filter with row-sum lumping for ``filter_k > 0``
    (tpufem/la/amg.py:308-338)."""
    d = A.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    omega = damping / lmax
    DinvA = sp.diags(dinv) @ A
    P = (P0 - omega * (DinvA @ P0)).tocsr()
    if filter_k <= 0:
        return P
    return _filter_rows_topk(P, filter_k)


def _filter_rows_topk(P: sp.csr_matrix, k: int) -> sp.csr_matrix:
    """Keep the k largest-|.| entries per row, rescaling survivors to the
    original row sum (tpufem/la/amg.py:341-369)."""
    nnz = np.diff(P.indptr)
    maxk = int(nnz.max()) if nnz.size else 0
    if maxk <= k:
        return P
    n = P.shape[0]
    cols = np.zeros((n, maxk), dtype=np.int64)
    vals = np.zeros((n, maxk))
    rows = np.repeat(np.arange(n), nnz)
    pos = np.arange(P.indices.size) - np.repeat(P.indptr[:-1], nnz)
    cols[rows, pos] = P.indices
    vals[rows, pos] = P.data
    order = np.argsort(-np.abs(vals), axis=1)[:, :k]
    vk = np.take_along_axis(vals, order, axis=1)
    ck = np.take_along_axis(cols, order, axis=1)
    tot = vals.sum(axis=1)
    sk = vk.sum(axis=1)
    safe = np.abs(sk) > 0.1 * np.abs(tot)
    scale = np.where(safe, tot / np.where(sk == 0.0, 1.0, sk), 1.0)
    vk = vk * scale[:, None]
    keep = vk != 0.0
    out_rows = np.repeat(np.arange(n), k)[keep.reshape(-1)]
    return sp.coo_matrix((vk.reshape(-1)[keep.reshape(-1)],
                          (out_rows, ck.reshape(-1)[keep.reshape(-1)])),
                         shape=P.shape).tocsr()


def _csr_rows_padded(P0: sp.csr_matrix, m: int):
    """Tentative-prolongator rows as padded [n, m] (cols, vals) arrays
    (tpufem/la/amg.py:372-386)."""
    n = P0.shape[0]
    nnz = np.diff(P0.indptr)
    if nnz.size and nnz.max() > m:
        raise ValueError("tentative prolongator row exceeds m entries")
    cols = np.zeros((n, m), dtype=np.int32)
    vals = np.zeros((n, m))
    rows = np.repeat(np.arange(n), nnz)
    pos = np.arange(P0.indices.size) - np.repeat(P0.indptr[:-1], nnz)
    cols[rows, pos] = P0.indices
    vals[rows, pos] = P0.data
    return cols, vals


def factored_transfers(fcols: np.ndarray, fw: np.ndarray, nc: int,
                       dtype: torch.dtype, device: torch.device
                       ) -> Tuple[CsrMatrix, CsrMatrix]:
    """(P0, P0^T) as CSR matrices from the padded rows of
    ``_csr_rows_padded`` (padding entries, weight 0, dropped): the
    tentative gather and the scatter-add of tpufem's factored V-cycle
    (tpufem/la/amg.py:806-809), the latter as a precomputed transpose."""
    n, m = fcols.shape
    P0 = sp.csr_matrix((np.array(fw, dtype=np.float64).reshape(-1),
                        fcols.reshape(-1).astype(np.int64),
                        np.arange(0, n * m + 1, m)), shape=(n, nc))
    P0.eliminate_zeros()
    P0T = P0.T.tocsr()
    P0T.sort_indices()
    return (CsrMatrix.from_scipy(P0, dtype, device),
            CsrMatrix.from_scipy(P0T, dtype, device))


def interleaved_to_planar(n: int, bs: int = 3) -> np.ndarray:
    """``perm`` with v_planar = v_interleaved[perm] (c * nnodes + node <-
    bs * node + c)."""
    return np.arange(n).reshape(-1, bs).T.reshape(-1)


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------

Operator = Union[CsrMatrix, DenseMat]


@dataclasses.dataclass
class SALevel:
    """One level above the coarsest: its operator ``A`` (None where the
    caller passes the fine action), assembled transfers ``P`` / ``PT`` or,
    in the factored form, ``P0`` / ``P0T`` with ``omega_dinv``; ``dinv``
    and the static ``lmax`` of its Chebyshev smoother."""

    A: Optional[Operator]
    P: Optional[CsrMatrix]
    PT: Optional[CsrMatrix]
    dinv: torch.Tensor
    lmax: float
    P0: Optional[CsrMatrix] = None
    P0T: Optional[CsrMatrix] = None
    omega_dinv: Optional[torch.Tensor] = None

    @property
    def factored(self) -> bool:
        return self.P0 is not None


@dataclasses.dataclass
class SAAMG:
    levels: List[SALevel]
    coarse_inv: torch.Tensor
    smoother_degree: int
    level_sizes: List[int]
    last_phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    _smooth_cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def setup(cls, csr_tuple, bs: int, options, device: torch.device,
              dtype: torch.dtype = torch.float32,
              near_nullspace: Optional[np.ndarray] = None,
              bc_mask: Optional[np.ndarray] = None,
              fine_factored: bool = False,
              fine_store_a: bool = True,
              fine_transfer_window: bool = False,
              planar: bool = False) -> "SAAMG":
        """tpufem's ``SAAMG.setup`` (tpufem/la/amg.py:496-769), the same
        host hierarchy: ``fine_factored`` keeps the fine level's smoothed
        transfers as P0 and an extra fine action (the cube, whose fine
        action is the stencil); ``fine_store_a=False`` stores no fine
        operator (the caller passes the fine action); and
        ``fine_transfer_window`` renumbers the fine level's aggregates by
        first appearance along the (RCM) fine order, as tpufem does
        before it builds window transfers (here the transfers stay CSR).
        ``planar``: the caller's fine level is the component-planar
        layout of this interleaved bs = 3 CSR (factored form only)."""
        if planar and not (fine_factored and bs == 3):
            raise ValueError("planar takes a factored bs = 3 fine level")
        indptr, indices, data = csr_tuple
        if data.ndim == 3:  # block CSR -> scalar CSR
            nb = indptr.shape[0] - 1
            A = sp.bsr_matrix((data, indices, indptr),
                              shape=(nb * bs, nb * bs)).tocsr()
        else:
            A = sp.csr_matrix((data, indices, indptr))
        n = A.shape[0]
        npdtype = np.float32 if dtype == torch.float32 else np.float64

        theta = float(options.get("amg_strength_threshold"))
        coarse_limit = int(options.get("amg_coarse_eq_limit"))
        max_levels = int(options.get("amg_max_levels"))
        damping = float(options.get("amg_prolongator_damping"))
        degree = int(options.get("amg_smoother_degree"))
        dense_limit = int(options.get("amg_dense_level_limit", 32768))
        filter_k = int(options.get("amg_filter_k", 4))
        agg_levels = int(options.get("amg_aggressive_levels", 1))
        if near_nullspace is not None and near_nullspace.shape[0] > 1 \
                and filter_k > 0:
            # top-k lumping keeps constants only: it would break rotation
            # interpolation for a multi-column nullspace
            logger.info("SA-AMG: prolongator top-k filter disabled "
                        "(near-nullspace has %d columns)",
                        near_nullspace.shape[0])
            filter_k = 0

        if near_nullspace is None:
            B = np.ones((n, 1))
        else:
            B = np.ascontiguousarray(near_nullspace.T)  # [ndofs, m]
        if bc_mask is not None:
            flat = np.repeat(bc_mask, bs) if bc_mask.shape[0] * bs == n else bc_mask
            B = B * (~flat)[:, None]

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        levels: List[SALevel] = []
        sizes = [n]
        lvl_bs = bs
        Al = A
        ph = {"eig": 0.0, "strength": 0.0, "aggregate": 0.0,
              "tentative": 0.0, "smoothP": 0.0, "galerkin": 0.0,
              "device": 0.0}
        t_total = time.perf_counter()

        def _tick(key, t0):
            ph[key] += time.perf_counter() - t0
            return time.perf_counter()

        while Al.shape[0] > coarse_limit and len(levels) < max_levels - 1:
            t0 = time.perf_counter()
            d = Al.diagonal()
            dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
            lmax = power_iteration_lmax(lambda v: Al @ v, dinv, Al.shape[0])
            t0 = _tick("eig", t0)
            S = node_strength_graph(Al, lvl_bs, theta)
            t0 = _tick("strength", t0)
            agg, nagg = aggregate_nodes(S, seed=len(levels))
            if len(levels) < agg_levels and nagg > 4 * coarse_limit:
                # aggressive coarsening: a pairwise merge of the aggregates
                nnode = S.shape[0]
                Agg = sp.csr_matrix(
                    (np.ones(nnode), (np.arange(nnode), agg)),
                    shape=(nnode, nagg))
                S2 = ((Agg.T @ S @ Agg).tocsr())
                S2.setdiag(0.0)
                S2.eliminate_zeros()
                pair = match_pairs(S2)
                agg, nagg = pair[agg], int(pair.max()) + 1
            if fine_transfer_window and len(levels) == 0:
                # renumber aggregates by first fine-node appearance: a
                # coarse permutation, the algebra unchanged
                first = np.full(nagg, np.iinfo(np.int64).max)
                np.minimum.at(first, agg, np.arange(agg.shape[0]))
                order = np.argsort(first, kind="stable")
                remap = np.empty(nagg, dtype=agg.dtype)
                remap[order] = np.arange(nagg, dtype=agg.dtype)
                agg = remap[agg]
            t0 = _tick("aggregate", t0)
            P0, Bc = tentative_prolongator(agg, nagg, B, lvl_bs)
            if P0.shape[1] == 0 or P0.shape[1] >= Al.shape[0]:
                break  # no useful coarsening possible
            t0 = _tick("tentative", t0)
            factored = fine_factored and len(levels) == 0
            P = smooth_prolongator(Al, P0, damping, lmax,
                                   filter_k=0 if factored else filter_k)
            t0 = _tick("smoothP", t0)
            Ac = (P.T @ Al @ P).tocsr()
            Ac.sum_duplicates()
            # inert coarse dofs (rank-deficient aggregates): unit diagonal
            dc = Ac.diagonal()
            dead = np.flatnonzero(dc == 0.0)
            if dead.size:
                Ac = Ac + sp.coo_matrix(
                    (np.ones(dead.size), (dead, dead)), shape=Ac.shape)
                Ac = Ac.tocsr()
            PT = P.T.tocsr()
            t0 = _tick("galerkin", t0)
            # densification guard: rows and bytes (f32 solves store bf16)
            nrows = Al.shape[0]
            store_item = 2 if dtype == torch.float32 else 8
            dense_bytes = nrows * nrows * store_item
            use_dense = nrows <= dense_limit and dense_bytes <= DENSE_BYTES_CAP
            if use_dense:
                logger.info("AMG level %d (%d rows) densified (%.1f MiB "
                            "device)", len(levels) + 1, nrows,
                            dense_bytes / 2**20)
            ddt = torch.bfloat16 if dtype == torch.float32 else dtype
            if factored or (len(levels) == 0 and not fine_store_a):
                A_dev = None  # the caller passes the fine action
            elif use_dense:
                A_dev = DenseMat.from_csr(Al.indptr, Al.indices, Al.data,
                                          nrows, ddt, device)
            else:
                A_dev = CsrMatrix.from_scipy(Al, dtype, device)
            if factored:
                fc, fv = _csr_rows_padded(P0, B.shape[1])
                od = (damping / lmax) * dinv
                if planar:
                    perm = interleaved_to_planar(nrows)
                    fc, fv, dinv, od = fc[perm], fv[perm], dinv[perm], od[perm]
                P0_dev, P0T_dev = factored_transfers(fc, fv, P0.shape[1],
                                                     dtype, device)
                levels.append(SALevel(
                    A=A_dev, P=None, PT=None,
                    dinv=dev(dinv.astype(npdtype)), lmax=lmax,
                    P0=P0_dev, P0T=P0T_dev,
                    omega_dinv=dev(od.astype(npdtype))))
            else:
                levels.append(SALevel(
                    A=A_dev, P=CsrMatrix.from_scipy(P, dtype, device),
                    PT=CsrMatrix.from_scipy(PT, dtype, device),
                    dinv=dev(dinv.astype(npdtype)), lmax=lmax))
            _tick("device", t0)
            Al = Ac
            B = Bc
            lvl_bs = B.shape[1]  # coarse levels carry m dofs per aggregate
            sizes.append(Al.shape[0])

        # the coarse solve: an eigen-cutoff pseudo-inverse (a singular
        # pure-Neumann operator coarsens to a ~1e-15-relative nullspace
        # eigenvalue; zeroing 1/lambda below the cutoff leaves the V-cycle
        # inert on it, and equals the inverse for nonsingular systems)
        Ad = Al.toarray()
        Ad = 0.5 * (Ad + Ad.T)
        evals, evecs = np.linalg.eigh(Ad)
        tau = 1e-9 * max(float(np.abs(evals).max()), 1e-300)
        inv_evals = np.where(np.abs(evals) > tau, 1.0 / evals, 0.0)
        coarse_inv = dev(((evecs * inv_evals) @ evecs.T).astype(npdtype))
        phases = dict(ph, total=time.perf_counter() - t_total)
        logger.info(
            "SA-AMG setup %.2fs: levels %s | %s", phases["total"], sizes,
            " ".join(f"{k} {v:.2f}s" for k, v in ph.items() if v > 0.005))
        return cls(levels=levels, coarse_inv=coarse_inv,
                   smoother_degree=degree, level_sizes=sizes,
                   last_phase_s=phases)

    # -- device V-cycle -------------------------------------------------------
    def _smoothers(self, i: int, mv: Callable) -> Tuple[Callable, Callable]:
        """(smooth_zero, smooth) of level i with matvec ``mv``, built once
        per (level, matvec)."""
        cached = self._smooth_cache.get(i)
        if cached is None or cached[0] is not mv:
            lv = self.levels[i]
            d = self.smoother_degree
            cached = (mv,
                      chebyshev_smoother_zero(mv, lv.dinv, lv.lmax, degree=d),
                      chebyshev_smoother(mv, lv.dinv, lv.lmax, degree=d))
            self._smooth_cache[i] = cached
        return cached[1], cached[2]

    def vcycle(self, r: torch.Tensor, i: int = 0,
               fine_matvec: Optional[Callable] = None) -> torch.Tensor:
        """One V(1,1) cycle (tpufem/la/amg.py:772-815); ``fine_matvec``
        replaces the finest level's own operator."""
        if i == len(self.levels):
            return torch.matmul(self.coarse_inv, r)
        lv = self.levels[i]
        if i == 0 and fine_matvec is not None:
            mv = fine_matvec
        else:
            if lv.A is None:
                raise ValueError(
                    "fine level stores no assembled operator; pass "
                    "fine_matvec to vcycle (setup ran with "
                    "fine_factored=True or fine_store_a=False)")
            mv = lv.A.matvec
        smooth0, smooth = self._smoothers(i, mv)
        x, rr = smooth0(r)
        if lv.factored:
            # PT r = P0^T (r - omega A dinv r), P xc = y - omega dinv A y
            # with y = P0 xc
            v = rr - mv(lv.omega_dinv * rr)
            xc = self.vcycle(lv.P0T.matvec(v), i + 1)
            y = lv.P0.matvec(xc)
            x = x + y - lv.omega_dinv * mv(y)
        else:
            xc = self.vcycle(lv.PT.matvec(rr), i + 1)
            x = x + lv.P.matvec(xc)
        return smooth(x, r)

    def as_preconditioner(self, fine_matvec: Optional[Callable] = None
                          ) -> Callable:
        return lambda r: self.vcycle(r, fine_matvec=fine_matvec)
