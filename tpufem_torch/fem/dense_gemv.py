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
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def _ld(n: int) -> int:
    return -(-n // 8) * 8


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
    its pointer and dims fixed once.  Counts its launches in
    ``dense_gemv_bf16.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    n, device = D.n, D.M.device
    args = _build.DenseLaunch(M=D.M.data_ptr(), device=device.index, n=n,
                              ld=D.M.shape[1])
    addr = ctypes.addressof(args)
    what = f"dense_gemv_bf16 of a {n}-row level"
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

    launch.keep = (args, D.M)  # what ``addr`` points into
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
