"""Function space and dofmap construction (the port's copy of
tpufem/fem/space.py: pure numpy, the same dof numbering).

Replaces ``fem::create_functionspace`` + ``DofMap`` (reference call sites:
src/poisson_problem.cpp:43-44, src/elasticity_problem.cpp:108-111 — the
blocked bs=3 case).  Dof numbering is entity-based and global:

  scalar dof id =  vertex_gid                                (vertex dofs)
                |  nv + (k-1) * edge_gid + slot              (edge dofs)
                |  nv + (k-1) * ne + face_gid                (face dofs, P3)

Edge dof slots are ordered along the *global* edge direction
(anchor -> max vertex); cells seeing the edge reversed flip their slots,
which keeps P2/P3 dofs consistent across cells (the GLL-warped node sets
are symmetric, so a flip is a pure permutation).

Vector-valued (bs=3) spaces interleave components: dof = bs * scalar + c,
matching the blocked insert of the reference (elasticity_problem.cpp:203).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from tpufem_torch.fem.reference import ReferenceTet, _edge_interior_params


class FunctionSpace:
    """P_k Lagrange space (scalar or bs-blocked) over a tet mesh."""

    def __init__(self, mesh, order: int, bs: int = 1,
                 variant: str = "gll_warped") -> None:
        self.mesh = mesh
        self.order = order
        self.bs = bs
        self.element = ReferenceTet(order, variant)
        k = order
        nv = mesh.num_vertices_global
        # only count the entity kinds that actually carry dofs: deriving
        # the edge table of a 2.6M-cell unstructured mesh costs ~4 s on
        # the deployment host and P1 never touches it
        ne = mesh.num_edges_global if k >= 2 else 0
        nf = mesh.num_faces_global if k >= 3 else 0
        self._nv, self._ne, self._nf = nv, ne, nf
        self.ndofs_scalar = nv + (k - 1) * ne + (1 if k >= 3 else 0) * nf
        self.ndofs = self.ndofs_scalar * bs
        self._cell_dofs: Optional[np.ndarray] = None

    # -- dofmap ---------------------------------------------------------------
    @property
    def cell_dofs(self) -> np.ndarray:
        """[nc_local, ndofs_per_cell] scalar dof gids (int64)."""
        if self._cell_dofs is None:
            self._cell_dofs = self._build_cell_dofs()
        return self._cell_dofs

    def _build_cell_dofs(self) -> np.ndarray:
        k = self.order
        mesh = self.mesh
        parts = [mesh.cells().astype(np.int64)]
        if k >= 2:
            egids, flipped = mesh.cell_edges()  # [C, 6], [C, 6]
            nslots = k - 1
            slots = np.arange(nslots, dtype=np.int64)  # [s]
            fwd = slots[None, None, :]
            rev = (nslots - 1 - slots)[None, None, :]
            slot = np.where(flipped[..., None], rev, fwd)  # [C, 6, s]
            edofs = self._nv + nslots * egids[..., None] + slot
            parts.append(edofs.reshape(edofs.shape[0], -1))
        if k >= 3:
            fgids = mesh.cell_faces()  # [C, 4]
            parts.append(self._nv + (k - 1) * self._ne + fgids)
        return np.concatenate(parts, axis=1)

    @property
    def ndofs_per_cell(self) -> int:
        return self.element.ndofs

    # -- dof coordinates ------------------------------------------------------
    def scalar_dof_coords(self) -> np.ndarray:
        """[ndofs_scalar, 3] coordinates of every scalar dof.

        Lagrange spaces interpolate by point evaluation at these
        (reference: Function::interpolate at src/poisson_problem.cpp:85-106).
        """
        k = self.order
        mesh = self.mesh
        out = np.empty((self.ndofs_scalar, 3), dtype=np.float64)
        out[: self._nv] = mesh.vertex_coords(np.arange(self._nv, dtype=np.int64))
        if k >= 2:
            ev = mesh.edge_vertices(np.arange(self._ne, dtype=np.int64))
            va = mesh.vertex_coords(ev[:, 0])
            vb = mesh.vertex_coords(ev[:, 1])
            t = _edge_interior_params(k, self.element.variant)  # [k-1]
            pts = va[:, None, :] + t[None, :, None] * (vb - va)[:, None, :]
            out[self._nv: self._nv + (k - 1) * self._ne] = pts.reshape(-1, 3)
        if k >= 3:
            out[self._nv + (k - 1) * self._ne:] = mesh.face_centroids(
                np.arange(self._nf, dtype=np.int64))
        return out

    # -- boundary dofs ----------------------------------------------------------
    def locate_dofs_topological(self, facets: np.ndarray) -> np.ndarray:
        """Scalar dofs in the closure of the given facets.

        Equivalent of ``fem::locate_dofs_topological`` (reference:
        src/poisson_problem.cpp:74-75): vertex dofs of the facet, edge dofs
        of its three edges, and the facet's interior dof (P3).
        """
        k = self.order
        mesh = self.mesh
        facets = np.asarray(facets, dtype=np.int64)
        dofs = [mesh.face_vertices(facets).reshape(-1)]
        if k >= 2:
            fe = mesh.face_edges(facets).reshape(-1)  # [n*3]
            base = self._nv + (k - 1) * fe[:, None] + np.arange(k - 1)[None, :]
            dofs.append(base.reshape(-1))
        if k >= 3:
            dofs.append(self._nv + (k - 1) * self._ne + facets)
        return np.unique(np.concatenate(dofs))

    def blocked_dofs(self, scalar_dofs: np.ndarray) -> np.ndarray:
        """Expand scalar dofs to all bs components (interleaved layout)."""
        if self.bs == 1:
            return scalar_dofs
        return (self.bs * scalar_dofs[:, None]
                + np.arange(self.bs)[None, :]).reshape(-1)

    # -- interpolation ----------------------------------------------------------
    def interpolate(self, fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Interpolate ``fn`` into the space by point evaluation.

        ``fn`` maps [n, 3] coords to [n] (scalar space) or [n, bs] values.
        Returns the flat dof vector [ndofs].
        """
        x = self.scalar_dof_coords()
        vals = np.asarray(fn(x))
        if self.bs == 1:
            if vals.shape != (x.shape[0],):
                raise ValueError("scalar interpolant must return [n]")
            return vals
        if vals.shape != (x.shape[0], self.bs):
            raise ValueError(f"interpolant must return [n, {self.bs}]")
        return vals.reshape(-1)
