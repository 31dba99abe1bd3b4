"""The parts of tpufem's block-windowed operator (tpufem/fem/window_op.py)
that decide the algebra of the unstructured SA-AMG: the reverse
Cuthill-McKee permutation and the window-footprint gate.

tpufem stores the spoke mesh's fine operator as dense 16-row x 128-lane
windows, because a TPU runs scalar gathers ~50x below its memory rate.
The card gathers from L2 at full speed, so the port keeps every sparse
operator in CSR (fem.csr_spmv) and does not build windows.  What stays
is what changes the numbers: tpufem's solver takes the RCM route
(``_try_window``, tpufem/problems/poisson.py:207-238) only where the
window form fits its byte budget, and on that route it builds the
hierarchy on the RCM-permuted matrix with aggregates renumbered along
it (tpufem/la/amg.py:618-628).  Aggregation is order-dependent, so the
iterations of a solve follow the route.  ``rcm_csr`` and
``_plan_windows`` are tpufem's; ``window_gate`` is ``_try_window``'s
decision together with the None cases of ``WindowedMatrix.from_csr``
(tpufem/fem/window_op.py:146-169).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpufem_torch import native

# tpufem's cost-model constants (tpufem/fem/window_op.py:62-64): they pick
# the window width, and with it whether the form fits the budget
_STREAM_BYTES_PER_S = 600e9
_GATHER_ROW_S = 15e-9
_OVERFLOW_ELEM_S = 14e-9
R_ROWS, C_LANES = 16, 128  # tpufem's row block and column block


def _plan_windows(indptr: np.ndarray, indices: np.ndarray, R: int, C: int,
                  itemsize: int, w_cap=None, ncols=None):
    """Per-nonzero window coordinates + cost-model window width
    (tpufem/fem/window_op.py:239-294): (est_bytes, W, nb, nc, b_of, r_of,
    w_of, c_of)."""
    n = indptr.shape[0] - 1
    nnz_row = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_row)
    cols = indices.astype(np.int64)
    nb = (n + R - 1) // R
    nc = ((n if ncols is None else ncols) + C - 1) // C
    b_of = rows // R

    got = native.plan_windows(indptr, indices, R, C)
    if got is not None:
        w_of, widths, hist = got
        ov_of = lambda Wc: int(hist[Wc:].sum())
    else:
        cb = cols // C
        key = b_of * nc + cb
        order = np.argsort(key, kind="stable")
        uq, inv_sorted, counts_u = np.unique(key[order], return_inverse=True,
                                             return_counts=True)
        uid = np.empty(key.shape[0], dtype=np.int64)
        uid[order] = inv_sorted
        ub = uq // nc
        block_first = np.searchsorted(ub, np.arange(nb), side="left")
        w_of_u = np.arange(uq.shape[0]) - block_first[ub]
        w_of = w_of_u[uid]
        widths = np.searchsorted(ub, np.arange(nb), side="right") - block_first
        ov_of = lambda Wc: int(counts_u[w_of_u >= Wc].sum())

    wmax = int(widths.max()) if nb else 1
    if w_cap is not None:
        W = max(1, min(int(w_cap), wmax))
    else:
        cands = np.unique(widths[widths > 0]).astype(np.int64)
        if cands.size == 0:
            cands = np.array([1])
        ov_nnz = np.array([ov_of(int(Wc)) for Wc in cands])
        cost = (nb * R * cands * C * itemsize / _STREAM_BYTES_PER_S
                + nb * cands * _GATHER_ROW_S
                + ov_nnz * _OVERFLOW_ELEM_S)
        W = int(cands[int(np.argmin(cost))])
    est = nb * R * W * C * itemsize
    return est, W, nb, nc, b_of, (rows % R), w_of, (cols % C)


def window_fits(indptr: np.ndarray, indices: np.ndarray, itemsize: int,
                budget_bytes: Optional[int]) -> bool:
    """Whether tpufem's ``WindowedMatrix.from_csr`` builds a window form of
    this (square, RCM-ordered) CSR rather than returning None
    (tpufem/fem/window_op.py:140-169): it gives up on an empty matrix, on
    a budget that a width-1 window exceeds, on a clamped form whose COO
    tail would hold over half the entries, and on a flat index space
    beyond int32."""
    R, C = R_ROWS, C_LANES
    n = indptr.shape[0] - 1
    if n == 0:
        return False
    (_, W, nb, nc, b_of, r_of, w_of, c_of) = _plan_windows(
        indptr, indices, R, C, itemsize)
    if budget_bytes is not None and nb * R * W * C * itemsize > budget_bytes:
        w_fit = int(budget_bytes // (nb * R * C * itemsize))
        if w_fit < 1:
            return False
        (_, W, nb, nc, b_of, r_of, w_of, c_of) = _plan_windows(
            indptr, indices, R, C, itemsize, w_cap=w_fit)
        if float((w_of >= W).mean()) > 0.5:
            return False
    return nb * R * W * C - 1 <= np.iinfo(np.int32).max


def window_gate(csr, mode: str, budget_mb: int, itemsize: int
                ) -> Optional[Tuple[np.ndarray, Tuple]]:
    """tpufem's ``_try_window`` decision (tpufem/problems/poisson.py:
    207-238): (perm, the RCM-permuted CSR) where tpufem takes the RCM
    route, None where it keeps the plain one: ``-amg_fine_window off``,
    a block CSR, or (``auto``) a window form over ``budget_mb``."""
    if mode == "off":
        return None
    if np.asarray(csr[2]).ndim != 1:
        return None
    budget = None if mode == "on" else int(budget_mb) * 2 ** 20
    n = len(csr[0]) - 1
    if budget is not None:
        # tpufem's pre-gate: even a width-1 window costs this much
        min_bytes = ((n + R_ROWS - 1) // R_ROWS) * R_ROWS * C_LANES * itemsize
        if min_bytes > budget:
            return None
    perm, csr_w = rcm_csr(*csr)
    if not window_fits(csr_w[0], csr_w[1], itemsize, budget):
        return None
    return perm, csr_w


def rcm_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray
            ) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Reverse-Cuthill-McKee symmetric permutation of a CSR matrix
    (tpufem/fem/window_op.py:297-317): (perm, permuted CSR with sorted
    rows)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = indptr.shape[0] - 1
    M = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(M, symmetric_mode=True),
                      dtype=np.int64)
    got = native.csr_permute_sym(indptr, indices, data, perm)
    if got is not None:
        return perm, got
    Mp = M[perm][:, perm].tocsr()
    Mp.sort_indices()
    return perm, (Mp.indptr, Mp.indices, Mp.data)
