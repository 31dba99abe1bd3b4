"""The CSR kernel's host plan (tpufem_torch/fem/csr_spmv.py:csr_plan) on
the CPU: its tiles' first rows (np.searchsorted) and its row-start bits;
the tiles hold every entry once, every row (empty ones too) is written
by exactly one tile, and the plan walked in plain numpy as the kernel
walks it (csrc/csr_spmv.cu: plan_walk) equals csr_spmv_plain within
csr_spmv_bound."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpufem_torch.fem.csr_spmv import (TILE, CsrMatrix, csr_plan,
                                       csr_spmv_bound, csr_spmv_plain)


def csr_of_lengths(lengths, ncols: int, seed: int) -> sp.csr_matrix:
    """A CSR matrix whose row r holds lengths[r] entries at distinct
    random columns, with random values."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate(
        [np.sort(rng.choice(ncols, size=k, replace=False)) for k in lengths]
        or [np.zeros(0, dtype=np.int64)])
    data = rng.standard_normal(int(indptr[-1]))
    return sp.csr_matrix((data, indices, indptr), shape=(len(lengths), ncols))


def plan_cases(tile: int):
    """name -> the row lengths and columns of the cases the kernel must
    cut right, for tiles of ``tile`` entries."""
    rng = np.random.default_rng(7)
    ragged = rng.integers(5, 9, size=(7 * tile) // 6 // 3 * 3 + 1)
    p0 = (rng.random(6 * tile) > 0.15).astype(np.int64)  # one entry or none
    return {
        # P^T-like: every row longer than a tile
        "long_rows": (rng.integers(tile + 1, 3 * tile, size=6), 8 * tile),
        # a row that starts in tile 0, covers tile 1 and ends in tile 2
        "three_tiles": ([tile // 2, 2 * tile, tile // 3, 5], 4 * tile),
        # P0-like: one entry a row, some rows empty
        "one_entry": (p0, 300),
        # runs of empty rows at the start, in the middle and at the end
        "empty_runs": (np.concatenate([
            np.zeros(tile // 3, np.int64), rng.integers(1, 30, size=tile // 8),
            np.zeros(2 * tile, np.int64), rng.integers(1, 30, size=tile // 8),
            np.zeros(tile // 5, np.int64)]), 700),
        # n and nnz no multiple of the tile
        "ragged": (ragged, ragged.size),
        # the spoke mesh's hub row: one row of every column
        "hub": (np.concatenate([[3 * tile + 17], rng.integers(2, 5,
                                                             size=tile)]),
                3 * tile + 17),
    }


def plan_walk(M: sp.csr_matrix, x: np.ndarray, tile: int, sub: int = 4):
    """y = M x as the kernel computes it, tiles of ``tile`` entries,
    sub-runs of ``sub``, in float64; and how many times each entry was
    read in its own tile and each row written.  A sub-run's running sums
    restart where the plan's bits mark a row start; tile t writes the
    rows that begin in it (tile_row), each the sum of the tails of the
    sub-runs it spans, and the last of them, where it runs on past the
    tile, also its entries past the tile, read again."""
    indptr, n, nnz = M.indptr.astype(np.int64), M.shape[0], M.nnz
    P = csr_plan(indptr, tile)
    tiles = P.tile_row.shape[0] - 1
    bits = np.unpackbits(P.starts.view(np.uint8), bitorder="little")
    y = np.full(n, np.nan)
    reads = np.zeros(nnz, dtype=np.int64)
    writes = np.zeros(n, dtype=np.int64)
    for t in range(tiles):
        s = t * tile
        ln = min(tile, nnz - s)
        reads[s:s + ln] += 1
        prod = np.zeros(tile)
        prod[:ln] = M.data[s:s + ln] * x[M.indices[s:s + ln]]
        sums = np.empty(tile)
        acc = 0.0
        for p in range(tile):
            acc = (0.0 if bits[s + p] or p % sub == 0 else acc) + prod[p]
            sums[p] = acc
        for r in range(P.tile_row[t], P.tile_row[t + 1]):
            e0, e1 = indptr[r], indptr[r + 1]
            total = 0.0
            if e1 > e0:
                lo, hi = e0 - s, min(e1 - s, ln)
                tails = [sums[j * sub + sub - 1]
                         for j in range(lo // sub, (hi - 1) // sub)]
                total = sum(tails) + sums[hi - 1]
                if e1 > s + ln:  # its entries past the tile, again
                    e = s + ln
                    total = total + (M.data[e:e1] * x[M.indices[e:e1]]).sum()
            y[r] = total
            writes[r] += 1
    return y, reads, writes


@pytest.mark.parametrize("name", ["long_rows", "three_tiles", "one_entry",
                                  "empty_runs", "ragged", "hub"])
@pytest.mark.parametrize("tile", [TILE, 32], ids=["kernel_tile", "tiny_tile"])
def test_plan_walk_matches_plain(name, tile):
    """Every entry in exactly one tile, every row written by exactly one
    tile, and the walk within csr_spmv_bound of the plain version."""
    lengths, ncols = plan_cases(tile)[name]
    M = csr_of_lengths(lengths, ncols, 11)
    x = np.random.default_rng(12).standard_normal(ncols)
    y, reads, writes = plan_walk(M, x, tile)
    assert np.all(reads == 1) and np.all(writes == 1)
    A = CsrMatrix.from_scipy(M, torch.float64, torch.device("cpu"))
    xt = torch.from_numpy(x)
    yp = csr_spmv_plain(A, xt).numpy()
    assert np.all(np.abs(y - yp) <= csr_spmv_bound(A, xt).numpy())


@pytest.mark.parametrize("name", ["long_rows", "three_tiles", "one_entry",
                                  "empty_runs", "ragged", "hub"])
def test_plan_rows_and_bits(name):
    """The plan on the device as csr_plan builds it: tile t's first row
    is the first that begins at or after entry t TILE (np.searchsorted;
    0 for tile 0, n at the end), so every row, empty ones too, lies in
    one tile's range; a bit at every non-empty row's first entry and
    nowhere else, whole tiles of them."""
    lengths, ncols = plan_cases(TILE)[name]
    M = csr_of_lengths(lengths, ncols, 11)
    indptr = M.indptr.astype(np.int64)
    A = CsrMatrix.from_scipy(M, torch.float32, torch.device("cpu"))
    tile_row = A.tile_row.numpy()
    tiles = max(1, -(-M.nnz // TILE))
    assert tile_row.dtype == np.int32 and tile_row.shape == (tiles + 1,)
    assert A.tiles == tiles and tile_row[0] == 0
    assert tile_row[-1] == M.shape[0] and np.all(np.diff(tile_row) >= 0)
    for t in range(1, tiles):
        r = int(tile_row[t])
        assert r == np.searchsorted(indptr[:-1], t * TILE)
        assert indptr[r - 1] < t * TILE <= indptr[r]
    on = np.unpackbits(A.starts.numpy().view(np.uint8), bitorder="little")
    assert on.size == tiles * TILE
    assert np.array_equal(np.flatnonzero(on),
                          indptr[:-1][np.diff(indptr) > 0])


def test_plan_of_a_matrix_without_entries():
    """No entries: one tile writes every row, 0."""
    M = sp.csr_matrix((5, 3))
    P = csr_plan(M.indptr, TILE)
    assert P.tile_row.tolist() == [0, 5] and not P.starts.any()
    y, _, writes = plan_walk(M, np.ones(3), TILE)
    assert np.all(y == 0) and np.all(writes == 1)
