"""Dense SA-AMG levels (tpufem's ``DenseMat``, tpufem/la/amg.py:396-423)
and their bfloat16 product: the CUDA kernel's wrapper and its plain
PyTorch version.

A coarse level small enough for tpufem's densify guard is a dense matrix.
A float32 solve stores it in bfloat16 and multiplies it with x rounded to
bfloat16, summing in float32 with a float32 y (tpufem's ``jnp.matmul(M,
x.astype(bf16), preferred_element_type=f32)``); a float64 solve stores it
in float64 and ``torch.matmul`` serves it, as XLA does in tpufem.
``torch.matmul`` of two bfloat16 operands returns bfloat16, one rounding
more than tpufem's, so the bfloat16 product is the kernel of
csrc/dense_gemv.cu.

``dense_gemv_bf16`` takes the plain version only for a level that lies on
the CPU; on a CUDA level it launches the kernel (one launch a product,
counted in ``dense_gemv_bf16.launches``) or raises.  The kernel and the
plain version sum in different orders; they agree within
``dense_gemv_bound``.  The bfloat16 storage is [n, ld] with ld = n
rounded up to 8, so every row starts on a 16-byte boundary.

The kernel's launch plan is arithmetic, mirrored here: ``dense_pieces``
cuts the 16-byte chunks of M (8 columns each, row-major) into one run
per warp of the persistent grid and says which row pieces go straight to
y and which to the partial sums that the second step adds in warp order;
``dense_gemv_walk`` walks that plan in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


_WARPS = 8                  # csrc/dense_gemv.cu:kWarps, warps a block
SMEM_LIMIT = 232448         # shared memory a block may take on sm_90


def _ld(n: int) -> int:
    return -(-n // 8) * 8


def dense_smem_bytes(n: int) -> int:
    """Shared memory a block of the kernel takes: bf16(x), ld values."""
    return 2 * _ld(n)


def dense_pieces(n: int, warps: int) -> List[List[Tuple[int, int, int,
                                                        str]]]:
    """The kernel's plan (csrc/dense_gemv.cu): per warp of ``warps``, its
    row pieces (row, first chunk, end chunk, where) in the order it sums
    them; chunks are 16-byte runs of 8 columns, counted within the row,
    and ``where`` is "y" (the whole row), "head" (a later piece of the
    run's first row) or "tail" (the first piece of the run's last row,
    finished by the heads after it)."""
    cpr = _ld(n) // 8
    total = n * cpr
    out = []
    for w in range(warps):
        c0, c1 = total * w // warps, total * (w + 1) // warps
        pieces = []
        for r in range(c0 // cpr, (c1 - 1) // cpr + 1 if c1 > c0 else 0):
            a, b = max(c0, r * cpr) - r * cpr, min(c1, (r + 1) * cpr) - r * cpr
            where = ("y" if (a, b) == (0, cpr) else "head" if a > 0
                     else "tail")
            pieces.append((r, a, b, where))
        out.append(pieces)
    return out


def dense_gemv_walk(D: "DenseMat", x: torch.Tensor,
                    warps: int) -> torch.Tensor:
    """The kernel's plan walked in plain PyTorch (float32, its orders of
    summation aside): each piece summed, the whole rows to y, every split
    row's tail and heads added in warp order."""
    xb = torch.zeros(D.M.shape[1])
    xb[:D.n] = x.to(torch.bfloat16).float()
    y = torch.full((D.n,), float("nan"))
    heads, tails = {}, {}
    for w, pieces in enumerate(dense_pieces(D.n, warps)):
        for r, a, b, where in pieces:
            s = (D.M[r, 8 * a: 8 * b].float() * xb[8 * a: 8 * b]).sum()
            if where == "y":
                y[r] = s
            elif where == "head":
                heads.setdefault(r, []).append((w, s))
            else:
                tails[r] = s
    for r, s in tails.items():
        y[r] = s + sum(v for _, v in sorted(heads.pop(r, [])))
    return y


@dataclasses.dataclass
class DenseMat:
    """A dense [n, n] level: ``M`` bfloat16 [n, ld] (float32 solves) or
    float64 / float32 [n, n]."""

    M: torch.Tensor
    n: int
    _launch: Optional[Callable] = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 data: np.ndarray, n: int, dtype: torch.dtype,
                 device: torch.device) -> "DenseMat":
        """Scatter the CSR triplets into a zeroed matrix on ``device``
        (no host ``toarray``), as tpufem's ``_densify_csr``
        (tpufem/la/amg.py:425-451): bfloat16 levels are scattered in
        float32 and rounded once."""
        rows = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64),
                                          np.diff(indptr))).to(device)
        cols = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(device)
        vdt = torch.float32 if dtype == torch.bfloat16 else dtype
        vals = torch.from_numpy(np.asarray(data).astype(
            np.float32 if vdt == torch.float32 else np.float64)).to(device)
        ld = _ld(n) if dtype == torch.bfloat16 else n
        M = torch.zeros(n, ld, dtype=vdt, device=device)
        M.index_put_((rows, cols), vals, accumulate=True)
        return cls(M.to(dtype), n)

    @property
    def nbytes(self) -> int:
        return self.M.numel() * self.M.element_size()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.M.dtype != torch.bfloat16:
            return torch.matmul(self.M, x)
        if self.M.device.type == "cpu":
            _check(self, x)
            return dense_gemv_bf16_plain(self, x)
        if self._launch is None:
            self._launch = prepare_dense_gemv(self)
        return self._launch(x)


def _check(D: DenseMat, x: torch.Tensor) -> None:
    if D.M.dtype != torch.bfloat16 or D.M.dim() != 2 \
            or D.M.shape != (D.n, _ld(D.n)) or not D.M.is_contiguous():
        raise ValueError(f"a bfloat16 [{D.n}, {_ld(D.n)}] level, got "
                         f"{D.M.dtype} {tuple(D.M.shape)}")
    if (x.dtype != torch.float32 or x.device != D.M.device
            or x.shape != (D.n,) or not x.is_contiguous()):
        raise ValueError(f"x of {tuple(x.shape)} {x.dtype}@{x.device} for a "
                         f"{D.n}-row bfloat16 level on {D.M.device}")


def dense_gemv_bf16_plain(D: DenseMat, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: M and bf16(x) widened to float32, one
    float32 product."""
    return D.M[:, :D.n].float() @ x.to(torch.bfloat16).float()


def dense_gemv_bound(D: DenseMat, x: torch.Tensor) -> torch.Tensor:
    """Per row, how far two float32 summation orders of exact products
    may differ: 2 n eps sum_j |m_ij bf16(x_j)|."""
    mag = D.M[:, :D.n].float().abs() @ x.to(torch.bfloat16).float().abs()
    return 2.0 * D.n * torch.finfo(torch.float32).eps * mag


def prepare_dense_gemv(D: DenseMat) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on the CUDA bfloat16 level ``D``,
    its pointer, dims, persistent grid and partial-sum scratch fixed once.
    Counts its launches in ``dense_gemv_bf16.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    n, device, ld = D.n, D.M.device, D.M.shape[1]
    what = f"dense_gemv_bf16 of a {n}-row level"
    if dense_smem_bytes(n) > SMEM_LIMIT:
        raise ValueError(f"{what}: bf16(x) takes {dense_smem_bytes(n)} bytes "
                         f"of shared memory, past {SMEM_LIMIT}")
    blocks = lib.tpufem_dense_gemv_grid(device.index, ld)
    if blocks < 1:
        _build.raise_on(lib, -blocks, what)
    partials = torch.empty(2 * blocks * _WARPS, dtype=torch.float32,
                           device=device)
    args = _build.DenseLaunch(M=D.M.data_ptr(), partials=partials.data_ptr(),
                              device=device.index, n=n, ld=ld, blocks=blocks)
    addr = ctypes.addressof(args)
    raw_stream = _build.raw_stream_getter()
    fn, index = lib.tpufem_dense_gemv_bf16, device.index

    def launch(x: torch.Tensor) -> torch.Tensor:
        if (x.dtype != torch.float32 or x.device != device
                or x.shape != (n,) or not x.is_contiguous()):
            raise ValueError(f"{what}: x is {tuple(x.shape)} {x.dtype}@"
                             f"{x.device}, expected a contiguous ({n},) "
                             f"float32@{device}")
        y = torch.empty(n, dtype=torch.float32, device=device)
        rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
        if rc != 0:
            _build.raise_on(lib, rc, what)
        dense_gemv_bf16.launches += 1
        return y

    launch.keep = (args, D.M, partials)  # what ``addr`` points into
    launch.warps = blocks * _WARPS
    return launch


def dense_gemv_bf16(D: DenseMat, x: torch.Tensor) -> torch.Tensor:
    """y = M bf16(x) in float32.  CPU levels take the plain version; CUDA
    levels launch the kernel (and count the launch in
    ``dense_gemv_bf16.launches``).  Anything else raises."""
    _check(D, x)
    if D.M.device.type == "cpu":
        return dense_gemv_bf16_plain(D, x)
    if D.M.device.type != "cuda":
        raise RuntimeError(f"no dense kernel for device {D.M.device}")
    return prepare_dense_gemv(D)(x)


dense_gemv_bf16.launches = 0
