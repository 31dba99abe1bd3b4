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
const stencil form, and, blocked (bs = 3), is the P2/P3 elasticity
operator (one launch of the perm_apply kernel an apply).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.assemble import (_elasticity_stiffness_np,
                                       _poisson_stiffness_np)
from tpufem_torch.fem.perm_apply import (PermPack, pack_perm, per_perm_apply,
                                         perm_apply, prepare_perm_apply)
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


def to_planar(v: np.ndarray, bs: int) -> np.ndarray:
    """Node-interleaved [n * bs] -> component-planar [bs * n]."""
    return np.ascontiguousarray(v.reshape(-1, bs).T).reshape(-1)


def to_interleaved(v: np.ndarray, bs: int) -> np.ndarray:
    """Component-planar [bs * n] -> node-interleaved [n * bs]."""
    return np.ascontiguousarray(v.reshape(bs, -1).T).reshape(-1)


@dataclasses.dataclass
class StructuredOperator:
    """Constant-stencil matrix-free operator on a BoxTetMesh
    (tpufem/fem/structured_op.py:214-400): scalar (bs = 1), or the blocked
    P2/P3 elasticity operator (bs = 3).

    ``Ap`` [6, n bs, n bs] holds the per-perm element matrices in the
    working dtype (numpy; bs = 3 dofs interleaved); ``bc_mask`` the flat
    Dirichlet mask (a bool tensor on the device, or numpy for a host-only
    operator) in the operator's layout.  ``apply`` is the BC-eliminated
    operator y = where(bc, x, A(where(bc, 0, x))), ``apply_bc_rows_zero``
    the cgpoisson convention (reference cgpoisson_problem.cpp:207).

    bs = 1 keeps ``A_dev``, the matrices on the device, and applies them
    with ``torch.matmul``.  bs = 3 on a device runs in the component-planar
    layout (``planar``, vector index ``c * ns + i``): ``pack`` holds the
    operator as the perm_apply kernel takes it, and ``apply`` is ONE
    launch of it (fem.perm_apply; its plain version on the CPU).  A
    host-only bs = 3 operator is interleaved unless built ``planar``; its
    numpy twins (``apply_np``, ``diagonal_np``) run tpufem's interleaved
    arithmetic in either layout.
    """

    Ap: np.ndarray
    bc_mask: object
    layout: GridLayout
    A_dev: Optional[torch.Tensor] = None
    bs: int = 1
    planar: bool = False
    pack: Optional[PermPack] = None

    @classmethod
    def build(cls, mesh: BoxTetMesh, order: int, problem: str = "poisson",
              bc_dofs: Optional[np.ndarray] = None,
              dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None,
              h_override=None, planar: bool = False) -> "StructuredOperator":
        """``device=None`` keeps the operator on the host (numpy twins).
        ``problem="elasticity"`` builds the blocked operator, which takes a
        device only ``planar``; ``bc_dofs`` are interleaved dofs."""
        bs = 3 if problem == "elasticity" else 1
        planar = planar and bs > 1
        layout = grid_layout(mesh, order)
        Ap = perm_element_matrices(mesh, order, problem,
                                   h_override=h_override)
        mask = np.zeros(layout.ndofs * bs, dtype=bool)
        if bc_dofs is not None:
            mask[bc_dofs] = True
        if planar:
            mask = to_planar(mask, bs)
        Ap = np.ascontiguousarray(Ap.astype(np_dtype(dtype)))
        return cls.from_arrays(Ap, mask, layout, device, bs=bs, planar=planar)

    @classmethod
    def from_arrays(cls, Ap: np.ndarray, mask: np.ndarray,
                    layout: GridLayout, device: Optional[torch.device],
                    bs: int = 1, planar: bool = False
                    ) -> "StructuredOperator":
        """The operator of the element matrices ``Ap`` (in the working
        dtype) and the Dirichlet ``mask`` (in the operator's layout) on
        ``device`` (None: host-only)."""
        if device is None:
            return cls(Ap, mask, layout, bs=bs, planar=planar)
        if bs == 1:
            return cls(Ap, torch.from_numpy(mask).to(device), layout,
                       torch.from_numpy(Ap).to(device))
        if not planar:
            raise NotImplementedError(
                "an interleaved bs = 3 operator on a device: the port runs "
                "elasticity planar (the interleaved form is host-only)")
        dtype = torch.float32 if Ap.dtype == np.float32 else torch.float64
        pack = pack_perm(Ap, dof_slice_plan(layout.order), layout.kinds,
                         (layout.Nx, layout.Ny, layout.Nz), mask, dtype,
                         device)
        return cls(Ap, pack.mask, layout, bs=bs, planar=True, pack=pack)

    # -- device action -----------------------------------------------------------
    def apply_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A_unconstrained @ x of a scalar operator on its device
        (fem.perm_apply.per_perm_apply: a ``torch.matmul`` with each
        perm's [n, n] element matrix; tpufem keeps this product outside
        its Pallas kernels too)."""
        if self.A_dev is None:
            raise RuntimeError("a host-only or blocked operator: apply_raw "
                               "is the scalar device action")
        lay = self.layout
        return per_perm_apply(x, self.A_dev, dof_slice_plan(lay.order),
                              [(b, X, Y, Z, s) for b, (X, Y, Z), s
                               in lay.kinds], (lay.Nx, lay.Ny, lay.Nz))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """BC-eliminated operator (zeroed rows/cols, unit diagonal); bs = 3:
        one perm_apply launch on a planar x."""
        if self.pack is not None:
            if self.pack.weights.device.type == "cuda":
                return self._perm_apply(x)
            return perm_apply(x, self.pack)
        y = self.apply_raw(torch.where(self.bc_mask, 0.0, x))
        return torch.where(self.bc_mask, x, y)

    @functools.cached_property
    def _perm_apply(self):
        """The operator's prepared perm_apply launch (pack on a card)."""
        return prepare_perm_apply(self.pack)

    def apply_bc_rows_zero(self, x: torch.Tensor) -> torch.Tensor:
        """cgpoisson convention: zero BC rows only
        (reference cgpoisson_problem.cpp:207)."""
        return torch.where(self.bc_mask, 0.0, self.apply_raw(x))

    def diagonal(self) -> torch.Tensor:
        """The operator diagonal on its device, in the working dtype and the
        operator's layout (BC rows get 1), for Jacobi/Chebyshev: each perm's
        element-matrix diagonal added at the n shifted slices, tpufem's
        order (tpufem/fem/structured_op.py:382-400)."""
        A = self.A_dev if self.pack is None else self.pack.Ap
        if A is None:
            raise RuntimeError("host-only operator: build it with a device")
        lay, bs = self.layout, self.bs
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        grids = [torch.zeros((bs, k[1][2], k[1][1], k[1][0], k[2]),
                             dtype=A.dtype, device=A.device)
                 for k in lay.kinds]
        for p in range(6):
            d = torch.diagonal(A[p]).reshape(-1, bs, 1, 1, 1)
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                grids[kind][:, dz: dz + Nz, dy: dy + Ny, dx: dx + Nx,
                            slot] += d[l]
        flat = torch.cat([g.reshape(bs, -1) for g in grids], dim=1)
        if not self.planar:
            flat = flat.T
        return torch.where(self.bc_mask, 1.0, flat.reshape(-1))

    # -- host (numpy float64) twins, tpufem's interleaved arithmetic --------
    def apply_raw_np(self, x: np.ndarray) -> np.ndarray:
        """Pure-numpy float64 apply on an interleaved x (host RHS, lmax,
        certification), tpufem's arithmetic."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        bs = self.bs
        Ap = np.asarray(self.Ap, dtype=np.float64)
        grids = lay.split(x.reshape(-1, bs))  # [Z, Y, X, slots, bs]
        outs = [np.zeros_like(g) for g in grids]
        n = len(plan[0])
        for p in range(6):
            cols = [grids[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot]
                    for (kind, (dx, dy, dz), slot) in plan[p]]
            u = np.stack(cols, axis=-2).reshape(-1, n * bs)
            y = (u @ Ap[p].T).reshape(Nz, Ny, Nx, n, bs)
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                outs[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += \
                    y[..., l, :]
        return np.concatenate([o.reshape(-1) for o in outs])

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """Host float64 twin of ``apply`` (BC-eliminated), in the
        operator's layout (planar through the interleaved twin)."""
        if self.planar:
            return to_planar(self._apply_interleaved_np(
                to_interleaved(x, self.bs)), self.bs)
        return self._apply_interleaved_np(x)

    def _apply_interleaved_np(self, x: np.ndarray) -> np.ndarray:
        bc = self.bc_mask_np
        if self.planar:
            bc = to_interleaved(bc, self.bs)
        return np.where(bc, x, self.apply_raw_np(np.where(bc, 0.0, x)))

    def diagonal_np(self) -> np.ndarray:
        """Host float64 operator diagonal (BC rows get 1) in the operator's
        layout, from the element matrices in the working dtype, tpufem's
        arithmetic (tpufem/fem/structured_op.py:363-380)."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        bs = self.bs
        Ap = np.asarray(self.Ap, dtype=np.float64)
        outs = [np.zeros((k[1][2], k[1][1], k[1][0], k[2], bs))
                for k in lay.kinds]
        for p in range(6):
            dA = np.diagonal(Ap[p])
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                outs[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += \
                    dA[l * bs: (l + 1) * bs]
        flat = np.concatenate([o.reshape(-1) for o in outs])
        if self.planar:
            flat = to_planar(flat, bs)
        return np.where(self.bc_mask_np, 1.0, flat)

    @property
    def bc_mask_np(self) -> np.ndarray:
        """The Dirichlet mask on the host, in the operator's layout."""
        m = self.bc_mask
        return m.cpu().numpy() if isinstance(m, torch.Tensor) else m
