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
scatter_plan: the dof -> cell-slot CSR of tpufem's perm / segments);
beside them the kernel's host plan, ``cplan`` (fem.assemble.
cluster_plan: the cells in clusters of B, each cluster's dofs, the
order its sums take), built with a CUDA operator and, for a CPU one,
only where something reads it (the walk; the plain version does not).
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
  same quadrature) weighted by the six distinct metric entries, equal to
  D G D^T in exact arithmetic and fewer operations at P3.  A block takes
  a cluster: it computes its cells' values into shared memory and sums
  each of the cluster's dofs there, in the plan's order, writing y where
  no other cluster has the dof and a partial sum where one does; a
  second launch sums each such dof's partials in cluster order.  No
  atomics: two launches give the same bits.

``matfree_action`` takes the plain version only for an operator that
lies on the CPU; on a CUDA operator it launches the kernel (one count in
``matfree_action.launches`` per apply, which is two launches: the
clusters and the halo) or raises.  The kernel and the plain version sum
in different orders; they agree within ``matfree_action_bound``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.assemble import (ClusterPlan, ScatterPlan,
                                       cluster_plan, metric_np, scatter_plan)
from tpufem_torch.fem.reference import ReferenceTet

_DTYPES = (torch.float32, torch.float64)
# (a, b) of the kernel's six tables, in its order
TABLE_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
# their places in a row-major [3, 3] metric
METRIC6 = tuple(3 * a + b for a, b in TABLE_PAIRS)
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


# below this share of the tables' largest entry, an entry is the
# quadrature's rounding of an exact 0 (at P3 such entries reach 1.9e-15
# of it, and the smallest other entry is 6.9e-4 of it)
TABLE_ZERO = 1e-12


@functools.lru_cache(maxsize=None)
def kernel_tables(order: int) -> np.ndarray:
    """[6, n, n] float64, the kernel's symmetric tables in TABLE_PAIRS
    order: K^aa, and K^ab + K^ba for a < b, with K^ab_ij = sum_q w_q
    d_a phi_i(q) d_b phi_j(q); entries under TABLE_ZERO of the tables'
    largest set to 0 (the kernel does no multiply-add for them: 243 of
    the 1,260 in the upper triangles at P3, 153 of 330 at P2, 39 of 60 at
    P1); the upper triangle (the kernel reads no other) mirrored, so that
    each is symmetric to the bit."""
    K = ReferenceTet(order).stiffness_tensors  # [3, 3, n, n]
    S = np.stack([K[a, a] if a == b else K[a, b] + K[b, a]
                  for a, b in TABLE_PAIRS])
    S = np.where(np.abs(S) < TABLE_ZERO * np.abs(S).max(), 0.0, S)
    upper = np.triu(np.ones(S.shape[1:], dtype=bool))
    return np.where(upper, S, S.transpose(0, 2, 1))


def kernel_multiply_adds(order: int) -> int:
    """Multiply-adds a cell of the tables' form: one a nonzero upper
    table entry (the pair's weight a = sum_s G_s S_s[i][j]), then y_i +=
    a u_j and, off the diagonal, y_j += a u_i for each pair with a
    nonzero entry (P1 37, P2 277, P3 1,417)."""
    S = kernel_tables(order)
    upper = np.triu(np.ones(S.shape[1:], dtype=bool))
    used = (S != 0).any(axis=0) & upper
    return int((S[:, upper] != 0).sum() + 2 * used.sum()
               - np.trace(used))


TABLES_HEADER = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "matfree_tables.cuh"


def tables_header() -> str:
    """The kernel's tables as C++ (csrc/matfree_tables.cuh): the upper
    triangles (i <= j, the entries the kernel reads; 0 below) of every
    order's kernel_tables, as exact float64 hex literals, so that each
    table value is a compile-time operand of its multiply-add and a zero
    entry none."""
    out = ["// Generated by tpufem_torch/fem/matfree_op.py:tables_header; "
           "do not edit.",
           "// The six symmetric reference tables of the matrix-free "
           "kernel (kernel_tables),",
           "// K^aa and K^ab + K^ba in (0,0) (1,1) (2,2) (0,1) (0,2) (1,2) "
           "order, their upper",
           "// triangles (i <= j, what the kernel reads; 0 below) as exact "
           "float64 literals.",
           "", "#pragma once", "", "namespace tpufem {", ""]
    for k in ORDERS:
        S = kernel_tables(k)
        n = S.shape[1]
        out.append(f"constexpr double kMatfreeTables{n}[6][{n}][{n}] = {{")
        for s in range(6):
            out.append("    {")
            for i in range(n):
                vals = [S[s, i, j].hex() if j >= i else "0"
                        for j in range(n)]
                out.append("        {" + ", ".join(vals) + "},")
            out.append("    },")
        out.append("};")
        out.append("")
    out.append("}  // namespace tpufem")
    return "\n".join(out) + "\n"


def write_tables_header() -> None:
    """Writes tables_header() to csrc/matfree_tables.cuh."""
    TABLES_HEADER.write_text(tables_header())


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
    (int32), the ``order`` and ``ndofs``; on the host, the kernel's
    cluster plan ``cplan``, built at the first read where it was not
    given."""

    G: torch.Tensor
    cd: torch.Tensor
    bc_flat: torch.Tensor
    bc_mask: Optional[torch.Tensor]
    perm: torch.Tensor
    offsets: torch.Tensor
    order: int
    ndofs: int
    _cplan: Optional[ClusterPlan] = dataclasses.field(default=None,
                                                      repr=False)
    _launch: Optional[Callable] = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_arrays(cls, G: np.ndarray, cd: np.ndarray, bc_flat: np.ndarray,
                    ndofs: int, order: int, dtype: torch.dtype,
                    device: torch.device,
                    plan: Optional[ScatterPlan] = None) -> "MatFreePoissonOp":
        """From host arrays: ``G`` is rounded to ``dtype``; ``plan`` is
        built from ``cd`` where it is not given; on a CUDA device the
        cluster plan from ``cd`` and ``bc_flat`` too (the kernel's; a CPU
        operator builds it only where it is read)."""
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
                   ndofs=int(ndofs),
                   _cplan=(cluster_plan(cd, ndofs, bc)
                           if torch.device(device).type == "cuda" else None))

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
    def cplan(self) -> ClusterPlan:
        """The kernel's cluster plan (fem.assemble.cluster_plan of the
        cell dofs and the Dirichlet dofs), built at the first read where
        the operator was not given one."""
        if self._cplan is None:
            self._cplan = cluster_plan(self.cd.cpu().numpy(), self.ndofs,
                                       self.bc_flat.cpu().numpy())
        return self._cplan

    @cplan.setter
    def cplan(self, plan: ClusterPlan) -> None:
        self._cplan, self._launch = plan, None

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
    times the dof's magnitude (the plain version on |G|, |D| and |x|).
    The kernel's scatter sums a dof's s slots in two levels, s_k of them
    in each of its m clusters and then the m partials: a term passes at
    most s_k - 1 + m - 1 <= s - 1 additions, as in one sum of s terms, so
    the bound counts s."""
    n, q = action_tables(op.order)[2:]
    mag = _scatter(op, _cell_action(op, x.abs(), op.G.abs(), absolute=True))
    slots = (op.offsets[1:] - op.offsets[:-1]).to(op.dtype)
    terms = 2 * n + 3 * q + 13 + 2 * slots
    return 2.0 * terms * torch.finfo(op.dtype).eps * mag


def _run_sums(vals: np.ndarray, src: np.ndarray, start: np.ndarray,
              end: np.ndarray) -> np.ndarray:
    """For each run r, vals[src[start[r]:end[r]]] summed in order from 0
    (the kernel's sequential sums), all runs at once."""
    out = np.zeros(start.size, dtype=vals.dtype)
    length = end - start
    for k in range(int(length.max(initial=0))):
        rows = np.flatnonzero(length > k)
        out[rows] = out[rows] + vals[src[start[rows] + k]]
    return out


def matfree_action_walk(op: MatFreePoissonOp, x: np.ndarray) -> np.ndarray:
    """The kernel's two launches walked in plain numpy, in its dtype and
    its order of operations: per cell (in cluster order) the tables'
    form over x at its locals into the cluster's values v[i B + c]; per
    local its values summed in the plan's order from 0, written to y (a
    dof in no other cluster), 0 (a Dirichlet dof) or a partial sum (the
    halo); per halo dof its partials summed in cluster order; 0 for a
    dof in no cell."""
    npdt = np.float32 if op.dtype == torch.float32 else np.float64
    p = op.cplan
    S = kernel_tables(op.order).astype(npdt)               # [6, n, n]
    Gs = op.G.cpu().numpy().reshape(-1, 9)[p.order][:, list(METRIC6)]
    K, n, B = p.ld.shape
    C = p.order.size
    cl = np.arange(C) // B
    loc = p.ld[cl, :, np.arange(C) - cl * B].astype(np.int64)  # [C, n]
    first = p.clusters[:, 0].astype(np.int64)
    u = np.asarray(x, dtype=npdt)[p.gid[first[cl][:, None] + loc]]
    y = np.zeros((C, n), dtype=npdt)
    for i in range(n):
        for j in range(i, n):
            a = Gs[:, 0] * S[0, i, j]
            for s in range(1, 6):
                a = a + Gs[:, s] * S[s, i, j]
            y[:, i] = y[:, i] + a * u[:, j]
            if j != i:
                y[:, j] = y[:, j] + a * u[:, i]
    vals = np.zeros((K * B, n), dtype=npdt)
    vals[:C] = y
    vals = vals.reshape(K, B, n).transpose(0, 2, 1).reshape(K, n * B)
    lcl, idx, start, end = p.runs()
    W = p.sum_idx.shape[1]
    src = (p.sum_idx.astype(np.int64)
           + (np.arange(K) * n * B)[:, None]).reshape(-1)
    sums = _run_sums(vals.reshape(-1), src, start + lcl * W, end + lcl * W)
    l_in = idx - first[lcl]
    out = np.zeros(op.ndofs, dtype=npdt)
    free = l_in < p.clusters[lcl, 1]
    zero = ~free & (l_in < p.clusters[lcl, 2])
    out[p.gid[idx[free]]] = sums[free]
    out[p.gid[idx[zero]]] = 0.0
    partials = np.zeros(p.gid.size, dtype=npdt)
    partials[idx] = sums
    off = p.halo_off.astype(np.int64)
    out[p.halo_dof] = _run_sums(partials, p.halo_src.astype(np.int64),
                                off[:-1], off[1:])
    return out


def matfree_launches(op: MatFreePoissonOp) -> int:
    """Kernel launches an apply makes: the clusters, then the halo where
    the plan has one."""
    return 1 + (op.cplan.halo_dof.size > 0)


def pack_matfree_launch(op: MatFreePoissonOp):
    """(the kernel's MatfreeLaunch for the CUDA operator ``op``, the
    tensors its pointers point into): the cluster plan and the metric's
    six distinct entries in cluster order ([6, C]) shipped to the card,
    and the partial sums' scratch."""
    from tpufem_torch import _build
    p = op.cplan

    def dev(a, t):
        return torch.from_numpy(
            np.ascontiguousarray(a).view(t)).to(op.device)

    order = torch.from_numpy(p.order).to(op.device)
    G6 = op.G.reshape(-1, 9)[order][:, list(METRIC6)].t().contiguous()
    ld32 = (p.ld[:, 0::2, :].astype(np.uint32)
            | (p.ld[:, 1::2, :].astype(np.uint32) << 16))
    arrays = dict(clusters=dev(p.clusters, np.int32), gid=dev(p.gid, np.int32),
                  ld=dev(ld32, np.int32), sum_idx=dev(p.sum_idx, np.int16),
                  sum_end=dev(p.sum_end, np.int16),
                  halo_dof=dev(p.halo_dof, np.int32),
                  halo_off=dev(p.halo_off, np.int32),
                  halo_src=dev(p.halo_src, np.int32))
    partials = torch.empty(max(p.gid.size, 1), dtype=op.dtype,
                           device=op.device)
    args = _build.MatfreeLaunch(
        G6=G6.data_ptr(), partials=partials.data_ptr(),
        **{k: v.data_ptr() for k, v in arrays.items()},
        device=op.device.index, C=op.ncells, n=p.n, B=p.cells,
        K=int(p.clusters.shape[0]), H=int(p.halo_dof.size),
        max_locals=p.max_locals)
    return args, (G6, partials, arrays)


def prepare_matfree_action(op: MatFreePoissonOp
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on the CUDA operator ``op``,
    with its MatfreeLaunch (pack_matfree_launch) and the entry point
    fixed once; a call checks x and passes x, y and the stream.  Counts
    its applies in ``matfree_action.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    fn = {torch.float32: lib.tpufem_matfree_action_f32,
          torch.float64: lib.tpufem_matfree_action_f64}[op.dtype]
    what = (f"matfree_action of a P{op.order} {op.dtype} operator, "
            f"{op.ncells} cells, {op.ndofs} dofs")
    if op.order not in ORDERS:
        raise ValueError(f"{what}: the kernel has tables for orders 1-3")
    if not op.G.is_contiguous() or op.G.device != op.device:
        raise ValueError(f"{what}: G is not a contiguous tensor on "
                         f"{op.device}")
    args, keep = pack_matfree_launch(op)
    addr = ctypes.addressof(args)
    raw_stream = _build.raw_stream_getter()
    dtype, device, N, index = op.dtype, op.device, op.ndofs, op.device.index

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
    launch.keep = (args, keep)
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
