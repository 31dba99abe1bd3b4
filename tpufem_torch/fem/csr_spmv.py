"""CSR sparse matrices on the device and their product y = A x: the CUDA
kernel's wrapper, its host plan and its plain PyTorch version.

Every sparse operator of the port's SA-AMG is a ``CsrMatrix``: the spoke
mesh's assembled fine operator (and its bf16-valued twin for the
V-cycle, ``-amg_window_bf16 on``), the assembled P and P^T, the sparse
coarse levels and the cube's factored P0 / P0^T.  tpufem keeps these as
a padded ELL with a COO spill tail (tpufem/fem/assemble.py:84-160) or as
block windows (tpufem/fem/window_op.py), layouts built around the TPU's
gathers; on the card CSR serves them all.

The kernel (csrc/csr_spmv.cu) cuts the entries, not the rows, into tiles
of TILE, a block a tile, so that its work is even whatever the rows: P0
with one entry a row, the fine matrix with 14, P^T with ~155.  Bytes bound
it (values, indices, indptr, x and y once: 62 MB for the spoke 500k fine
matrix); on the small transfers the launch and the two round trips to
memory a block waits on are most of its time.  ``csr_plan`` builds, once
per matrix, what the kernel needs beside the CSR arrays: each tile's
first row, and a bit for every entry that begins a row (so that a
tile's rows are known as soon as its entries arrive).  Tile t writes
the rows that begin in it, empty rows too; a row running on past its
tile is finished there from the entries just past the tile.  Every y[r]
is summed in one order: two launches give the same bits.

``csr_spmv`` takes the plain version only for a matrix that lies on the
CPU; on a CUDA matrix it launches the kernel (one launch a product,
counted in ``csr_spmv.launches``) or raises.  A matrix prepares its
launch once (``CsrMatrix.matvec``).  Value types: float32 and float64
with x and y of the same type; bfloat16 values with float32 x and y, x
rounded to bfloat16 and the products summed in float32.  The kernel and
the plain version sum in different orders; they agree within
``csr_spmv_bound``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

_VALUE_TYPES = (torch.float32, torch.float64, torch.bfloat16)


# Entries a tile of the kernel (csrc/csr_spmv.cu:kTile), measured against
# 512 and 2,048 (PERF.md)
TILE = 1024


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """The kernel's plan of a CSR pattern, tiles of ``tile`` entries
    (tile t: entries [t tile, (t + 1) tile)), built once on the host:
    ``tile_row`` int32 [tiles + 1], tile t's first row: the first row
    that begins at or after the tile's first entry (0 for tile 0; n at
    the end), so that tile t writes y for the rows [tile_row[t],
    tile_row[t + 1]), the rows that begin in it, empty ones too; and
    ``starts``, int32 words of bits, bit e set where a row begins at
    entry e, whole tiles of them."""

    tile_row: np.ndarray
    starts: np.ndarray


def csr_plan(indptr: np.ndarray, tile: int = TILE) -> CsrPlan:
    """The kernel's plan of the pattern ``indptr`` for tiles of ``tile``
    entries (a multiple of 32; the kernel's is TILE); a matrix with no
    entries has one tile."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    tiles = max(1, -(-nnz // tile))
    tile_row = np.empty(tiles + 1, dtype=np.int64)
    tile_row[:-1] = np.searchsorted(indptr[:-1],
                                    np.arange(tiles, dtype=np.int64) * tile)
    tile_row[0], tile_row[-1] = 0, n
    bits = np.zeros(tiles * tile, dtype=bool)
    bits[indptr[:-1][np.diff(indptr) > 0]] = True
    starts = np.packbits(bits, bitorder="little").view("<u4").view(np.int32)
    return CsrPlan(tile_row=tile_row.astype(np.int32), starts=starts)


@dataclasses.dataclass
class CsrMatrix:
    """An n x ncols CSR matrix on one device: int32 ``indptr`` [n + 1] and
    ``indices`` [nnz], ``vals`` [nnz] (float32, float64 or bfloat16), the
    kernel's plan (``csr_plan``: ``tile_row``, ``starts``, on the
    matrix's device), and on the CPU the row of every entry (``rows``,
    the plain version's scatter index)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    vals: torch.Tensor
    n: int
    ncols: int
    tile_row: torch.Tensor
    starts: torch.Tensor
    rows: Optional[torch.Tensor] = None
    _launch: Optional[Callable] = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 data: np.ndarray, dtype: torch.dtype, device: torch.device,
                 ncols: Optional[int] = None) -> "CsrMatrix":
        """From host CSR arrays; ``data`` is rounded to ``dtype`` (bfloat16
        through float32, as tpufem casts its bf16 twins)."""
        if dtype not in _VALUE_TYPES:
            raise TypeError(f"CSR values of {dtype}: float32, float64 or "
                            "bfloat16")
        indptr = np.asarray(indptr)
        n = indptr.shape[0] - 1
        ncols = n if ncols is None else int(ncols)
        if int(indptr[-1]) >= 2 ** 31 or max(n, ncols) >= 2 ** 31:
            raise ValueError("CSR of more than 2^31 - 1 entries, rows or "
                             "columns: the kernel indexes in int32")
        ip = torch.from_numpy(indptr.astype(np.int32)).to(device)
        ix = torch.from_numpy(np.asarray(indices).astype(np.int32)).to(device)
        data = np.asarray(data)
        if dtype == torch.bfloat16:
            v = torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
        else:
            v = torch.from_numpy(data.astype(
                np.float32 if dtype == torch.float32 else np.float64))
        rows = None
        if torch.device(device).type == "cpu":
            rows = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64),
                                              np.diff(indptr)))
        P = csr_plan(indptr)
        return cls(ip, ix, v.to(device), n, ncols,
                   torch.from_numpy(P.tile_row).to(device),
                   torch.from_numpy(P.starts).to(device), rows)

    @classmethod
    def from_scipy(cls, M, dtype: torch.dtype,
                   device: torch.device) -> "CsrMatrix":
        M = M.tocsr()
        return cls.from_csr(M.indptr, M.indices, M.data, dtype, device,
                            ncols=M.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def tiles(self) -> int:
        return int(self.tile_row.shape[0]) - 1

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.float32 if self.vals.dtype == torch.bfloat16 \
            else self.vals.dtype

    def astype(self, dtype: torch.dtype) -> "CsrMatrix":
        """The same pattern with values rounded to ``dtype``."""
        return dataclasses.replace(self, vals=self.vals.to(dtype),
                                   _launch=None)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(
            (self.vals.double().cpu().numpy(), self.indices.cpu().numpy(),
             self.indptr.cpu().numpy()), shape=(self.n, self.ncols))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (the plain version on the CPU, the kernel on a card)."""
        if self.vals.device.type == "cpu":
            _check(self, x)
            return csr_spmv_plain(self, x)
        if self._launch is None:
            self._launch = prepare_csr_spmv(self)
        return self._launch(x)


def _check(A: CsrMatrix, x: torch.Tensor) -> None:
    if A.vals.dtype not in _VALUE_TYPES:
        raise TypeError(f"CSR values of {A.vals.dtype}")
    if x.dtype != A.out_dtype:
        raise TypeError(f"x of {x.dtype} for {A.vals.dtype} values "
                        f"(expected {A.out_dtype})")
    if x.device != A.vals.device:
        raise ValueError(f"x on {x.device}, the matrix on {A.vals.device}")
    if x.shape != (A.ncols,) or not x.is_contiguous():
        raise ValueError(f"x of shape {tuple(x.shape)} for a {A.n}x{A.ncols} "
                         "matrix (contiguous, flat)")


def csr_spmv_plain(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the products in the working type (bf16
    values: x rounded to bf16, products in float32), summed into y by
    ``index_add_``."""
    rows = A.rows
    if rows is None:
        rows = torch.repeat_interleave(
            torch.arange(A.n, device=A.device),
            (A.indptr[1:] - A.indptr[:-1]).long())
    if A.vals.dtype == torch.bfloat16:
        xg = torch.index_select(x.to(torch.bfloat16).float(), 0, A.indices)
        prod = A.vals.float() * xg
    else:
        prod = A.vals * torch.index_select(x, 0, A.indices)
    return torch.zeros(A.n, dtype=A.out_dtype,
                       device=A.device).index_add_(0, rows, prod)


def csr_spmv_bound(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Per row, how far two summation orders may differ:
    2 (row nnz) eps sum_j |a_ij x_j| in the type of the sum."""
    dt = A.out_dtype
    absA = dataclasses.replace(A, vals=A.vals.abs(), _launch=None)
    nnz = (A.indptr[1:] - A.indptr[:-1]).to(dt)
    return 2.0 * nnz * torch.finfo(dt).eps * csr_spmv_plain(absA, x.abs())


def prepare_csr_spmv(A: CsrMatrix) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on the CUDA matrix ``A``, with
    its pointers, dims, plan and the entry point fixed once; a call
    checks x and passes x, y and the stream.  Counts its launches in
    ``csr_spmv.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    fn = {torch.float32: lib.tpufem_csr_spmv_f32,
          torch.float64: lib.tpufem_csr_spmv_f64,
          torch.bfloat16: lib.tpufem_csr_spmv_bf16}[A.vals.dtype]
    what = (f"csr_spmv of a {A.n}x{A.ncols} {A.vals.dtype} matrix, "
            f"{A.nnz} entries")
    if A.nnz and (A.vals.data_ptr() % 16 or A.indices.data_ptr() % 16):
        raise ValueError(f"{what}: vals and indices must start on 16-byte "
                         "boundaries")
    args = _build.CsrLaunch(
        indptr=A.indptr.data_ptr(), indices=A.indices.data_ptr(),
        vals=A.vals.data_ptr(), starts=A.starts.data_ptr(),
        tile_row=A.tile_row.data_ptr(), device=A.device.index, n=A.n,
        ncols=A.ncols, nnz=A.nnz, tiles=A.tiles)
    addr = ctypes.addressof(args)
    raw_stream = _build.raw_stream_getter()
    dtype, device, index, n = A.out_dtype, A.device, A.device.index, A.n

    def launch(x: torch.Tensor) -> torch.Tensor:
        if (x.dtype != dtype or x.device != device or x.shape != (A.ncols,)
                or not x.is_contiguous()):
            raise ValueError(f"{what}: x is {tuple(x.shape)} {x.dtype}@"
                             f"{x.device}, expected a contiguous "
                             f"({A.ncols},) {dtype}@{device}")
        y = torch.empty(n, dtype=dtype, device=device)
        rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
        if rc != 0:
            _build.raise_on(lib, rc, what)
        csr_spmv.launches += 1
        return y

    # what ``addr`` points into
    launch.keep = (args, A.indptr, A.indices, A.vals, A.starts, A.tile_row)
    return launch


def csr_spmv(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x.  CPU matrices take the plain version; CUDA matrices launch
    the kernel (and count the launch in ``csr_spmv.launches``).  Anything
    else raises."""
    _check(A, x)
    if A.device.type == "cpu":
        return csr_spmv_plain(A, x)
    if A.device.type != "cuda":
        raise RuntimeError(f"no CSR kernel for device {A.device}")
    return A.matvec(x)


csr_spmv.launches = 0
