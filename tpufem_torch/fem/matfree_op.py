"""The matrix-free Poisson operator of an unstructured mesh: the CUDA
kernel's wrapper, its plain PyTorch version and a plain numpy walk of
the kernel's two launches (counterpart of ``MatFreePoissonOp`` and
``make_action``, tpufem/problems/cgpoisson.py:40-77, with
``poisson_action_from_metric``, tpufem/fem/kernels.py:130-166, and the
sorted segment sum of ``DofScatter``, tpufem/fem/assemble.py:228-270).

The operator keeps what tpufem's keeps, on one device: the per-cell
metric G = |det J| J^-1 J^-T [C, 3, 3] (computed on the host in float64,
stored in the solve's dtype), the cell dofs ``cd`` [C, n] int32, the
Dirichlet dofs ``bc_flat`` and the scatter plan (fem.assemble.
scatter_plan: the dof -> cell-slot CSR of tpufem's perm / segments).
``apply`` is y = A x with the Dirichlet rows set to 0, the reference's
``bc->set(y, 0)`` (cgpoisson_problem.cpp:207).

Two forms of one function:

- the plain version, ``matfree_apply_plain``, is tpufem's pipeline:
  gather u = x[cd], reference gradients u D at the q quadrature points,
  the metric contraction, the transpose product with D, then the scatter
  in the plan's sorted order (an ``index_add_`` of the slots in plan
  order);
- the kernel (csrc/matfree_action.cu) computes, per cell, y_c = sum_ab
  G_ab K^ab u_c with six symmetric n x n reference tables (``K^aa`` and
  ``K^ab + K^ba``, a < b, from ``ReferenceTet.stiffness_tensors``, the
  same quadrature), equal to D G D^T in exact arithmetic and fewer
  operations at P3, in a first launch of one thread per cell, and sums
  each dof's slots in plan order in a second launch of one thread per
  dof.  No atomics: two launches give the same bits.

``matfree_action`` takes the plain version only for an operator that
lies on the CPU; on a CUDA operator it launches the kernel (one count in
``matfree_action.launches`` per apply, which is two launches: the cells
and the dofs) or raises.  The kernel and the plain version sum in
different orders; they agree within ``matfree_action_bound``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.assemble import ScatterPlan, metric_np, scatter_plan
from tpufem_torch.fem.reference import ReferenceTet

_DTYPES = (torch.float32, torch.float64)
# (a, b) of the kernel's six tables, in its order
TABLE_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
ORDERS = (1, 2, 3)


@functools.lru_cache(maxsize=None)
def action_tables(order: int):
    """(D [n, 3q], wts [q], n, q), float64: tpufem's ``_action_tables``
    (tpufem/fem/kernels.py:130-137), the reference gradients at the
    2(k-1)-exact rule."""
    el = ReferenceTet(order)
    _, wts, _, dphi = el.quad_data
    n, q = el.ndofs, wts.shape[0]
    D = np.ascontiguousarray(dphi.transpose(1, 0, 2).reshape(n, q * 3))
    return D, wts, n, q


@functools.lru_cache(maxsize=None)
def kernel_tables(order: int) -> np.ndarray:
    """[6, n, n] float64, the kernel's symmetric tables in TABLE_PAIRS
    order: K^aa, and K^ab + K^ba for a < b, with K^ab_ij = sum_q w_q
    d_a phi_i(q) d_b phi_j(q); the upper triangle (the kernel reads no
    other) mirrored, so that each is symmetric to the bit."""
    K = ReferenceTet(order).stiffness_tensors  # [3, 3, n, n]
    S = np.stack([K[a, a] if a == b else K[a, b] + K[b, a]
                  for a, b in TABLE_PAIRS])
    upper = np.triu(np.ones(S.shape[1:], dtype=bool))
    return np.where(upper, S, S.transpose(0, 2, 1))


def all_kernel_tables() -> np.ndarray:
    """Every order's tables, flat, in the kernel's constant-memory layout
    (csrc/matfree_action.cu:table_offset): P1, then P2, then P3."""
    return np.concatenate([kernel_tables(k).reshape(-1) for k in ORDERS])


@functools.lru_cache(maxsize=None)
def _plain_tables(order: int, dtype: torch.dtype, device: str):
    D, wts, n, q = action_tables(order)
    return (torch.from_numpy(D).to(device=device, dtype=dtype),
            torch.from_numpy(wts).to(device=device, dtype=dtype), n, q)


@dataclasses.dataclass
class MatFreePoissonOp:
    """The matrix-free Poisson operator on one device: ``G`` [C, 3, 3]
    (float32 or float64: the solve's dtype), ``cd`` [C, n] int32,
    ``bc_flat`` [nbc] int64 and ``bc_mask`` (bool [N], None where there is
    no Dirichlet dof), the scatter plan's ``perm`` and ``offsets``
    (int32), the ``order`` and ``ndofs``."""

    G: torch.Tensor
    cd: torch.Tensor
    bc_flat: torch.Tensor
    bc_mask: Optional[torch.Tensor]
    perm: torch.Tensor
    offsets: torch.Tensor
    order: int
    ndofs: int
    _launch: Optional[Callable] = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_arrays(cls, G: np.ndarray, cd: np.ndarray, bc_flat: np.ndarray,
                    ndofs: int, order: int, dtype: torch.dtype,
                    device: torch.device,
                    plan: Optional[ScatterPlan] = None) -> "MatFreePoissonOp":
        """From host arrays: ``G`` is rounded to ``dtype``; ``plan`` is
        built from ``cd`` where it is not given."""
        if dtype not in _DTYPES:
            raise TypeError(f"a matrix-free operator of {dtype}: float32 or "
                            "float64")
        cd = np.asarray(cd)
        n = ReferenceTet(order).ndofs
        if cd.ndim != 2 or cd.shape[1] != n:
            raise ValueError(f"cell dofs of shape {cd.shape} for order "
                             f"{order} ({n} dofs a cell)")
        if cd.size and (cd.min() < 0 or cd.max() >= ndofs):
            raise ValueError("a cell dof outside [0, ndofs)")
        if cd.size >= 2 ** 31:
            raise ValueError("2^31 or more cell slots: the kernel indexes "
                             "in int32")
        if plan is None:
            plan = scatter_plan(cd, ndofs)
        bc = np.asarray(bc_flat, dtype=np.int64)
        mask = None
        if bc.size:
            m = np.zeros(ndofs, dtype=bool)
            m[bc] = True
            mask = torch.from_numpy(m).to(device)
        npdt = np.float32 if dtype == torch.float32 else np.float64

        def dev(a, t):
            return torch.from_numpy(np.require(a, t, ("C", "W"))).to(device)

        return cls(G=dev(np.asarray(G).reshape(-1, 3, 3), npdt),
                   cd=dev(cd, np.int32), bc_flat=dev(bc, np.int64),
                   bc_mask=mask, perm=dev(plan.perm, np.int32),
                   offsets=dev(plan.offsets, np.int32), order=int(order),
                   ndofs=int(ndofs))

    @classmethod
    def build(cls, space, bc, dtype: torch.dtype,
              device: torch.device) -> "MatFreePoissonOp":
        """tpufem's ``make_action``: the metric on the host in float64,
        shipped in the solve's dtype, with the space's cell dofs, the
        Dirichlet dofs and the scatter plan."""
        return cls.from_arrays(metric_np(space.mesh.cell_coords()),
                               space.cell_dofs, bc.flat_dofs(),
                               space.ndofs_scalar, space.order, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.G.device

    @property
    def dtype(self) -> torch.dtype:
        return self.G.dtype

    @property
    def ncells(self) -> int:
        return int(self.cd.shape[0])

    @property
    def n(self) -> int:
        return int(self.cd.shape[1])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with the Dirichlet rows set to 0 (the plain version on
        the CPU, the kernel on a card)."""
        return matfree_action(self, x)


def _check(op: MatFreePoissonOp, x: torch.Tensor) -> None:
    if op.dtype not in _DTYPES:
        raise TypeError(f"a matrix-free operator of {op.dtype}")
    if x.dtype != op.dtype:
        raise TypeError(f"x of {x.dtype} for a {op.dtype} operator")
    if x.device != op.device:
        raise ValueError(f"x on {x.device}, the operator on {op.device}")
    if x.shape != (op.ndofs,) or not x.is_contiguous():
        raise ValueError(f"x of shape {tuple(x.shape)} for {op.ndofs} dofs "
                         "(contiguous, flat)")


def _cell_action(op: MatFreePoissonOp, x: torch.Tensor, G: torch.Tensor,
                 absolute: bool = False) -> torch.Tensor:
    """[C, n] cell contributions by tpufem's pipeline (with |D| for
    ``absolute``)."""
    D, w, n, q = _plain_tables(op.order, op.dtype, str(op.device))
    if absolute:
        D = D.abs()
    u = torch.index_select(x, 0, op.cd.reshape(-1)).reshape(op.cd.shape)
    r = (u @ D).reshape(-1, q, 3)                         # [C, q, a]
    t = torch.einsum("cqa,cab->cqb", r, G) * w[None, :, None]
    return t.reshape(-1, q * 3) @ D.T                     # [C, n]


def plan_segments(op: MatFreePoissonOp) -> torch.Tensor:
    """tpufem's ``segments`` from the plan: the dof of each listed slot."""
    return torch.repeat_interleave(
        torch.arange(op.ndofs, dtype=torch.int32, device=op.device),
        (op.offsets[1:] - op.offsets[:-1]).long(),
        output_size=int(op.perm.numel()))


def _scatter(op: MatFreePoissonOp, yc: torch.Tensor) -> torch.Tensor:
    """The cell contributions summed into dofs in the plan's order."""
    data = torch.index_select(yc.reshape(-1), 0, op.perm)
    return torch.zeros(op.ndofs, dtype=yc.dtype, device=yc.device
                       ).index_add_(0, plan_segments(op), data)


def matfree_apply_plain(op: MatFreePoissonOp, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: tpufem's gather, u D, metric contraction,
    D^T product and sorted segment sum, then the Dirichlet rows set to 0."""
    y = _scatter(op, _cell_action(op, x, op.G))
    return y.index_fill_(0, op.bc_flat, 0.0) if op.bc_flat.numel() else y


def matfree_action_bound(op: MatFreePoissonOp,
                         x: torch.Tensor) -> torch.Tensor:
    """Per dof, how far the kernel and the plain version may differ: the
    terms of both forms (cell: n + 3q + 5 in the plain, n + 8 in the
    kernel's; the slots of the dof in each scatter) times eps, twice,
    times the dof's magnitude (the plain version on |G|, |D| and |x|)."""
    n, q = action_tables(op.order)[2:]
    mag = _scatter(op, _cell_action(op, x.abs(), op.G.abs(), absolute=True))
    slots = (op.offsets[1:] - op.offsets[:-1]).to(op.dtype)
    terms = 2 * n + 3 * q + 13 + 2 * slots
    return 2.0 * terms * torch.finfo(op.dtype).eps * mag


def matfree_action_walk(op: MatFreePoissonOp, x: np.ndarray) -> np.ndarray:
    """The kernel's two launches walked in plain numpy, in its dtype and
    its order of operations: per cell the tables' form into slot-major
    cell values yc[i C + c], then per dof its slots summed in plan order
    (slot s = c n + i read at yc[i C + c]); the Dirichlet rows 0."""
    npdt = np.float32 if op.dtype == torch.float32 else np.float64
    S = kernel_tables(op.order).astype(npdt)               # [6, n, n]
    G = op.G.cpu().numpy().reshape(-1, 9)
    Gs = np.stack([G[:, 3 * a + b] for a, b in TABLE_PAIRS], axis=1)
    cd = op.cd.cpu().numpy()
    C, n = cd.shape
    u = np.asarray(x, dtype=npdt)[cd]                      # [C, n]
    y = np.zeros((C, n), dtype=npdt)
    for i in range(n):
        for j in range(i, n):
            a = Gs[:, 0] * S[0, i, j]
            for s in range(1, 6):
                a = a + Gs[:, s] * S[s, i, j]
            y[:, i] = y[:, i] + a * u[:, j]
            if j != i:
                y[:, j] = y[:, j] + a * u[:, i]
    yc = np.ascontiguousarray(y.T).reshape(-1)             # slot-major
    perm = op.perm.cpu().numpy().astype(np.int64)
    offsets = op.offsets.cpu().numpy()
    src = (perm % n) * C + perm // n
    out = np.zeros(op.ndofs, dtype=npdt)
    vals = yc[src]
    for k in range(int(np.diff(offsets).max(initial=0))):
        rows = np.flatnonzero(offsets[1:] - offsets[:-1] > k)
        out[rows] = out[rows] + vals[offsets[rows] + k]
    if op.bc_mask is not None:
        out[op.bc_mask.cpu().numpy()] = 0.0
    return out


# devices whose constant tables are filled: the tables live in the
# device's constant memory, one copy for the whole process
_TABLES_SET = set()


def prepare_matfree_action(op: MatFreePoissonOp
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on the CUDA operator ``op``,
    with its pointers, dims, the slot-major scratch of the cell values
    and the entry point fixed once (the device's constant tables filled
    at its first operator); a call checks x and passes x, y and the
    stream.  Counts its applies in ``matfree_action.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    fn = {torch.float32: lib.tpufem_matfree_action_f32,
          torch.float64: lib.tpufem_matfree_action_f64}[op.dtype]
    what = (f"matfree_action of a P{op.order} {op.dtype} operator, "
            f"{op.ncells} cells, {op.ndofs} dofs")
    if op.order not in ORDERS:
        raise ValueError(f"{what}: the kernel has tables for orders 1-3")
    for name in ("G", "cd", "perm", "offsets"):
        t = getattr(op, name)
        if t.device != op.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not a contiguous tensor on "
                             f"{op.device}")
    if op.cd.data_ptr() % 16:
        raise ValueError(f"{what}: cd must start on a 16-byte boundary")
    index = op.device.index
    if index not in _TABLES_SET:
        tables = np.ascontiguousarray(all_kernel_tables(), dtype=np.float64)
        rc = lib.tpufem_matfree_tables(index, tables.ctypes.data,
                                       int(tables.size))
        if rc != 0:
            _build.raise_on(lib, rc, f"{what}: filling the tables")
        _TABLES_SET.add(index)
    scratch = torch.empty(op.ncells * op.n, dtype=op.dtype, device=op.device)
    mask = op.bc_mask.to(torch.uint8) if op.bc_mask is not None else None
    args = _build.MatfreeLaunch(
        G=op.G.data_ptr(), cd=op.cd.data_ptr(), offsets=op.offsets.data_ptr(),
        slots=op.perm.data_ptr(),
        bc=0 if mask is None else mask.data_ptr(), yc=scratch.data_ptr(),
        device=index, C=op.ncells, n=op.n, ndofs=op.ndofs)
    addr = ctypes.addressof(args)
    raw_stream = _build.raw_stream_getter()
    dtype, device, N = op.dtype, op.device, op.ndofs

    def launch(x: torch.Tensor) -> torch.Tensor:
        if (x.dtype != dtype or x.device != device or x.shape != (N,)
                or not x.is_contiguous()):
            raise ValueError(f"{what}: x is {tuple(x.shape)} {x.dtype}@"
                             f"{x.device}, expected a contiguous ({N},) "
                             f"{dtype}@{device}")
        y = torch.empty(N, dtype=dtype, device=device)
        rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
        if rc != 0:
            _build.raise_on(lib, rc, what)
        matfree_action.launches += 1
        return y

    # what ``addr`` points into
    launch.keep = (args, op.G, op.cd, op.offsets, op.perm, mask, scratch)
    return launch


def matfree_action(op: MatFreePoissonOp, x: torch.Tensor) -> torch.Tensor:
    """y = A x with the Dirichlet rows 0.  A CPU operator takes the plain
    version; a CUDA operator launches the kernel (counted in
    ``matfree_action.launches``, one a call).  Anything else raises."""
    _check(op, x)
    if op.device.type == "cpu":
        return matfree_apply_plain(op, x)
    if op.device.type != "cuda":
        raise RuntimeError(f"no matrix-free kernel for device {op.device}")
    if op._launch is None:
        op._launch = prepare_matfree_action(op)
    return op._launch(x)


matfree_action.launches = 0
