"""Dof-grid layout, constant per-perm element matrices and the per-perm
matrix-free operator of the Kuhn lattice (counterpart of
tpufem/fem/structured_op.py).

Every cube of the Kuhn mesh holds the same six tetrahedron shapes, so
each shape's element matrix is one constant matrix, and every local dof
of a cell sits at a constant lattice offset from the cube corner, on one
of the typed dof grids (vertices, 7 edge types with k-1 slots each, 12
face types for P3).  The stencil operators (fem.dia_op, fem.strip_op)
are built from these two facts; ``StructuredOperator`` applies the
element matrices directly (shifted slices, one [n, n] @ [n, Q] product
per perm), which serves the P2/P3 RHS and lattices too small for the
const stencil form.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.assemble import (_elasticity_stiffness_np,
                                       _poisson_stiffness_np)
from tpufem_torch.fem.reference import ReferenceTet
from tpufem_torch.mesh.structured import (CELL_VERTEX_OFFSETS, LOCAL_EDGES,
                                          LOCAL_FACES, _EDGE_TYPE_OF,
                                          _FACE_TYPE_OF, BoxTetMesh)


_NP_DTYPE = {torch.float32: np.dtype(np.float32),
             torch.float64: np.dtype(np.float64)}


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy twin of a floating torch dtype."""
    if dtype not in _NP_DTYPE:
        raise TypeError(f"operators are float32 or float64, not {dtype}")
    return _NP_DTYPE[dtype]


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """Where each typed dof grid lives inside the flat dof vector.

    kinds: tuple of (base offset, dims (X, Y, Z), slots); grid g reshapes
    the flat segment [base : base + X*Y*Z*slots] to [Z, Y, X, slots].
    """

    order: int
    Nx: int
    Ny: int
    Nz: int
    kinds: Tuple

    @property
    def ndofs(self) -> int:
        b, dims, s = self.kinds[-1]
        return b + int(np.prod(dims)) * s

    def split(self, x) -> List:
        """Flat [ndofs(, c)] tensor or array -> list of [Z, Y, X, slots(, c)]
        grid views."""
        comp = tuple(x.shape[1:])
        return [x[base: base + X * Y * Z * s].reshape((Z, Y, X, s) + comp)
                for base, (X, Y, Z), s in self.kinds]

    def join(self, grids: List[torch.Tensor]) -> torch.Tensor:
        comp = tuple(grids[0].shape[4:])
        return torch.cat([g.reshape((-1,) + comp) for g in grids], dim=0)


def grid_layout(mesh: BoxTetMesh, order: int) -> GridLayout:
    """Dof numbering of fem.space as typed grids: vertices first, then
    the 7 edge-type blocks ((k-1) slots each), then 12 face types."""
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    kinds = [(0, (Nx + 1, Ny + 1, Nz + 1), 1)]
    base = (Nx + 1) * (Ny + 1) * (Nz + 1)
    k = order
    if k >= 2:
        dims = mesh._edge_dims()
        for t in range(7):
            X, Y, Z = int(dims[t][0]), int(dims[t][1]), int(dims[t][2])
            kinds.append((base, (X, Y, Z), k - 1))
            base += X * Y * Z * (k - 1)
    if k >= 3:
        dims = mesh._face_dims()
        for t in range(12):
            X, Y, Z = int(dims[t][0]), int(dims[t][1]), int(dims[t][2])
            kinds.append((base, (X, Y, Z), 1))
            base += X * Y * Z
    return GridLayout(order=k, Nx=Nx, Ny=Ny, Nz=Nz, kinds=tuple(kinds))


@functools.lru_cache(maxsize=None)
def dof_slice_plan(order: int):
    """plan[p][l] = (kind index, (dx, dy, dz) cube offset, slot).

    kind index: 0 = vertices, 1..7 = edge types, 8..19 = face types.
    Slot accounts for edge-dof orientation: the local edge's direction vs
    the anchored (min -> max) global direction is constant per (p, le).
    """
    k = order
    plans = []
    for p in range(6):
        offs = CELL_VERTEX_OFFSETS[p]  # [4, 3]
        entries = []
        for l in range(4):  # vertex dofs
            entries.append((0, tuple(int(v) for v in offs[l]), 0))
        if k >= 2:
            for le, (a, b) in enumerate(LOCAL_EDGES):
                va, vb = offs[a], offs[b]
                anchor = np.minimum(va, vb)
                d = tuple(np.abs(vb - va))
                etype = _EDGE_TYPE_OF[d]
                flipped = bool(np.any(va > vb))
                for s in range(k - 1):
                    slot = (k - 2 - s) if flipped else s
                    entries.append((1 + etype,
                                    tuple(int(v) for v in anchor), slot))
        if k >= 3:
            for lf, (a, b, c) in enumerate(LOCAL_FACES):
                tri = np.stack([offs[a], offs[b], offs[c]])
                anchor = tri.min(axis=0)
                top = tri.max(axis=0)
                mid = tri.sum(axis=0) - anchor - top
                ftype = _FACE_TYPE_OF[(tuple(mid - anchor),
                                       tuple(top - anchor))]
                entries.append((8 + ftype, tuple(int(v) for v in anchor), 0))
        plans.append(tuple(entries))
    return tuple(plans)


def perm_element_matrices(mesh: BoxTetMesh, order: int,
                          problem: str = "poisson",
                          h_override=None) -> np.ndarray:
    """[6, n, n] (scalar) or [6, 3n, 3n] (elasticity, dofs interleaved)
    constant element matrices of the six tet shapes ("poisson" or
    "elasticity" stiffness, or "mass").  ``h_override`` supplies the
    physical cube size for a surrogate lattice."""
    if h_override is not None:
        h = np.asarray(h_override, dtype=np.float64)
    else:
        h = np.array([1.0 / mesh.Nx, 1.0 / mesh.Ny, 1.0 / mesh.Nz])
    coords = CELL_VERTEX_OFFSETS.astype(np.float64) * h[None, None, :]
    if problem == "poisson":
        return _poisson_stiffness_np(coords, order)
    if problem == "elasticity":
        return _elasticity_stiffness_np(coords, order)
    if problem == "mass":
        el = ReferenceTet(order)
        adet = float(np.prod(h))  # |detJ| identical for all 6 perms
        return np.repeat((adet * el.mass_tensor)[None], 6, axis=0)
    raise ValueError(problem)


def dof_gids_for_cells(mesh: BoxTetMesh, order: int, cubes: np.ndarray,
                       perms: np.ndarray) -> np.ndarray:
    """[n_cells, n] scalar dof gids for (cube lattice corner, perm) pairs,
    computed O(1) per cell from the slice plan."""
    lay = grid_layout(mesh, order)
    plan = dof_slice_plan(order)
    n = len(plan[0])
    out = np.empty((cubes.shape[0], n), dtype=np.int64)
    for p in range(6):
        sel = np.flatnonzero(perms == p)
        if sel.size == 0:
            continue
        c = cubes[sel]
        for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
            base, (X, Y, Z), slots = lay.kinds[kind]
            lex = ((c[:, 2] + dz) * Y + (c[:, 1] + dy)) * X + (c[:, 0] + dx)
            out[sel, l] = base + lex * slots + slot
    return out


@dataclasses.dataclass
class StructuredOperator:
    """Constant-stencil matrix-free scalar operator on a BoxTetMesh
    (tpufem/fem/structured_op.py:214-400; bs = 1 only, the blocked
    elasticity form is ROADMAP M12 P2).

    ``Ap`` [6, n, n] holds the per-perm element matrices in the working
    dtype (numpy); ``A_dev`` the same on the operator's device;
    ``bc_mask`` the flat Dirichlet mask (a bool tensor on the device, or
    numpy for a host-only operator).  ``apply`` is the BC-eliminated
    operator y = where(bc, x, A(where(bc, 0, x))), ``apply_bc_rows_zero``
    the cgpoisson convention (reference cgpoisson_problem.cpp:207).
    """

    Ap: np.ndarray
    bc_mask: object
    layout: GridLayout
    A_dev: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, mesh: BoxTetMesh, order: int, problem: str = "poisson",
              bc_dofs: Optional[np.ndarray] = None,
              dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None,
              h_override=None) -> "StructuredOperator":
        """``device=None`` keeps the operator on the host (numpy twins)."""
        if problem == "elasticity":
            raise NotImplementedError(
                "the blocked (bs = 3) StructuredOperator of P2/P3 elasticity: "
                "ROADMAP M12 P2")
        layout = grid_layout(mesh, order)
        Ap = perm_element_matrices(mesh, order, problem,
                                   h_override=h_override)
        mask = np.zeros(layout.ndofs, dtype=bool)
        if bc_dofs is not None:
            mask[bc_dofs] = True
        Ap_cast = np.ascontiguousarray(Ap.astype(np_dtype(dtype)))
        if device is None:
            return cls(Ap_cast, mask, layout)
        return cls(Ap_cast, torch.from_numpy(mask).to(device), layout,
                   torch.from_numpy(Ap_cast).to(device))

    # -- device action -----------------------------------------------------------
    def apply_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A_unconstrained @ x: per perm, the n shifted dof-grid slices
        are stacked to [n, Q], multiplied by the constant [n, n] element
        matrix (``torch.matmul``; float32 at full precision, tpufem keeps
        this product outside its Pallas kernels too), and added back at
        the n shifted slices."""
        if self.A_dev is None:
            raise RuntimeError("host-only operator: build it with a device")
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        grids = lay.split(x.reshape(-1, 1))  # [Z, Y, X, slots, 1]
        out = [torch.zeros_like(g) for g in grids]
        for p in range(6):
            cols = torch.stack([
                grids[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot, 0]
                for (kind, (dx, dy, dz), slot) in plan[p]])
            y = torch.matmul(self.A_dev[p], cols.reshape(cols.shape[0], -1))
            y = y.reshape(cols.shape)
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                out[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot, 0] += y[l]
        return lay.join(out).reshape(-1)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """BC-eliminated operator (zeroed rows/cols, unit diagonal)."""
        y = self.apply_raw(torch.where(self.bc_mask, 0.0, x))
        return torch.where(self.bc_mask, x, y)

    def apply_bc_rows_zero(self, x: torch.Tensor) -> torch.Tensor:
        """cgpoisson convention: zero BC rows only
        (reference cgpoisson_problem.cpp:207)."""
        return torch.where(self.bc_mask, 0.0, self.apply_raw(x))

    def diagonal(self) -> torch.Tensor:
        """The operator diagonal on its device, in the working dtype (BC
        rows get 1), for Jacobi/Chebyshev: each perm's element-matrix
        diagonal added at the n shifted slices, tpufem's order
        (tpufem/fem/structured_op.py:382-400)."""
        if self.A_dev is None:
            raise RuntimeError("host-only operator: build it with a device")
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        grids = [torch.zeros((k[1][2], k[1][1], k[1][0], k[2]),
                             dtype=self.A_dev.dtype, device=self.A_dev.device)
                 for k in lay.kinds]
        for p in range(6):
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                grids[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += \
                    self.A_dev[p, l, l]
        flat = torch.cat([g.reshape(-1) for g in grids])
        return torch.where(self.bc_mask, 1.0, flat)

    # -- host (numpy float64) twins ---------------------------------------------
    def apply_raw_np(self, x: np.ndarray) -> np.ndarray:
        """Pure-numpy float64 apply, tpufem's arithmetic (host RHS)."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        Ap = np.asarray(self.Ap, dtype=np.float64)
        grids = lay.split(x.reshape(-1, 1))
        outs = [np.zeros_like(g) for g in grids]
        n = len(plan[0])
        for p in range(6):
            cols = [grids[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot]
                    for (kind, (dx, dy, dz), slot) in plan[p]]
            u = np.stack(cols, axis=-2).reshape(-1, n)
            y = (u @ Ap[p].T).reshape(Nz, Ny, Nx, n, 1)
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                outs[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += \
                    y[..., l, :]
        return np.concatenate([o.reshape(-1) for o in outs])

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """Host float64 twin of ``apply`` (BC-eliminated)."""
        bc = np.asarray(self.bc_mask_np)
        return np.where(bc, x, self.apply_raw_np(np.where(bc, 0.0, x)))

    def diagonal_np(self) -> np.ndarray:
        """Host float64 operator diagonal (BC rows get 1), from the element
        matrices in the working dtype, tpufem's arithmetic
        (tpufem/fem/structured_op.py:363-380)."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        Ap = np.asarray(self.Ap, dtype=np.float64)
        outs = [np.zeros((k[1][2], k[1][1], k[1][0], k[2])) for k in lay.kinds]
        for p in range(6):
            dA = np.diagonal(Ap[p])
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                outs[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += dA[l]
        flat = np.concatenate([o.reshape(-1) for o in outs])
        return np.where(np.asarray(self.bc_mask_np), 1.0, flat)

    @property
    def bc_mask_np(self) -> np.ndarray:
        """The Dirichlet mask on the host."""
        m = self.bc_mask
        return m.cpu().numpy() if isinstance(m, torch.Tensor) else m
