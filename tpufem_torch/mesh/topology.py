"""Generic tetrahedral topology from explicit (vertices, cells) arrays (the
port's copy of tpufem/mesh/topology.py, pinned equal by the tests).

Equivalent of ``dolfinx::mesh::Topology::create_entities`` /
``create_connectivity`` (reference call sites: src/main.cpp:147-148,
src/mesh.cpp:198,370): entities are derived by sorted-unique over
per-cell entity keys.  Used for the unstructured "spoke" mesh path
(reference: src/mesh.cpp:209-453); the structured box path uses the
closed-form numbering in tpufem_torch.mesh.structured instead.

Shares the duck-typed mesh interface consumed by tpufem_torch.fem.space:
  num_{vertices,edges,faces,cells}_global, cells(), cell_coords(),
  cell_edges(), cell_faces(), face_vertices(), face_edges(),
  edge_midpoints(), face_centroids(), locate_boundary_facets().
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from tpufem_torch.mesh.structured import LOCAL_EDGES, LOCAL_FACES


class TetTopology:
    """Unstructured conforming tetrahedral mesh (single-shard, host-side)."""

    def __init__(self, vertices: np.ndarray, cells: np.ndarray) -> None:
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self._cells = np.ascontiguousarray(cells, dtype=np.int64)
        if self._cells.ndim != 2 or self._cells.shape[1] != 4:
            raise ValueError("cells must be [nc, 4]")
        self._orient_cells()
        # edges AND faces are built LAZILY: P1 assembly touches neither
        # (vertices + faces-for-BCs only, and faces only on the final
        # mesh), the refinement cascade needs edges only on the mesh it
        # marks, and a derived entity table for 2.6M cells costs ~6.6 s
        # of native radix work + page faults on the 1-vCPU deployment
        # host.  Eager edges alone were ~25% of the spoke-500k wall.
        self._edges_built = False
        self._faces_built = False

    # -- construction --------------------------------------------------------
    def _orient_cells(self) -> None:
        """Flip vertex order so every cell has positive Jacobian.

        det([b-a, c-a, d-a]) via the explicit triple product —
        np.linalg.det's batched LU measured ~7 s over the 150k-dof spoke
        cascade where this form is ~0.3 s.  The native pass flips in
        place with zero temporaries (the numpy route gathers ~10
        page-faulting [nc, 3] arrays)."""
        from tpufem_torch.native import orient_cells
        if orient_cells(self.vertices, self._cells):
            return
        v = self.vertices
        c = self._cells
        a = v[c[:, 0]]
        b = v[c[:, 1]] - a
        cc = v[c[:, 2]] - a
        d = v[c[:, 3]] - a
        det = (b[:, 0] * (cc[:, 1] * d[:, 2] - cc[:, 2] * d[:, 1])
               - b[:, 1] * (cc[:, 0] * d[:, 2] - cc[:, 2] * d[:, 0])
               + b[:, 2] * (cc[:, 0] * d[:, 1] - cc[:, 1] * d[:, 0]))
        neg = det < 0
        if neg.any():
            c = self._cells.copy()
            c[neg, 2], c[neg, 3] = self._cells[neg, 3], self._cells[neg, 2]
            self._cells = c

    def _ensure_faces(self) -> None:
        if not self._faces_built:
            self._build_faces()
            self._faces_built = True

    def _ensure_edges(self) -> None:
        if not self._edges_built:
            self._build_edges()
            self._edges_built = True

    def _build_edges(self) -> None:
        from tpufem_torch.native import tet_edges
        got = tet_edges(self._cells, self.vertices.shape[0])
        if got is not None:
            # one native pass: key build + radix sort + unique sweep
            # (the numpy route below costs ~1.7 s/call at 150k dofs
            # across the 8 topology builds of the spoke cascade)
            self._edge_verts, self._cell_edges, \
                self._cell_edge_flipped = got
            return
        pairs = self._cells[:, LOCAL_EDGES]  # [C, 6, 2]
        lo = pairs.min(axis=-1)
        hi = pairs.max(axis=-1)
        key = lo.astype(np.int64) * self.vertices.shape[0] + hi
        from tpufem_torch.native import unique_inverse_u64
        uniq, inv = unique_inverse_u64(key.ravel())
        self._edge_verts = np.stack([uniq // self.vertices.shape[0],
                                     uniq % self.vertices.shape[0]], axis=-1)
        self._cell_edges = inv.reshape(-1, 6)
        self._cell_edge_flipped = pairs[..., 0] > pairs[..., 1]

    def _build_faces(self) -> None:
        from tpufem_torch.native import tet_faces
        got = tet_faces(self._cells, self.vertices.shape[0])
        if got is not None:
            # one native radix pass (same sorted-key order and stable
            # first-cell as the numpy route; ~8 s -> ~1 s at 866k cells)
            (self._face_verts, self._cell_faces, self._face_cells,
             self._boundary_faces) = got
            return
        tris = np.sort(self._cells[:, LOCAL_FACES], axis=-1)  # [C, 4, 3]
        flat = tris.reshape(-1, 3)
        nv = self.vertices.shape[0]
        if nv < (1 << 21):  # 3-key packing fits u64
            from tpufem_torch.native import unique_inverse_u64
            keys = (flat[:, 0] * nv + flat[:, 1]) * nv + flat[:, 2]
            ukeys, inv = unique_inverse_u64(keys)
            counts = np.bincount(inv)
            uniq = np.stack([ukeys // (nv * nv),
                             (ukeys // nv) % nv,
                             ukeys % nv], axis=-1)
        else:
            uniq, inv, counts = np.unique(flat, axis=0, return_inverse=True,
                                          return_counts=True)
        self._face_verts = uniq
        self._cell_faces = inv.reshape(-1, 4)
        # facet -> cell connectivity (each face touches 1 or 2 cells)
        order = np.argsort(inv, kind="stable")
        cell_of = order // 4
        starts = np.concatenate([[0], np.cumsum(counts)])
        f2c = np.full((uniq.shape[0], 2), -1, dtype=np.int64)
        f2c[:, 0] = cell_of[starts[:-1]]
        two = counts == 2
        f2c[two, 1] = cell_of[starts[:-1][two] + 1]
        self._face_cells = f2c
        self._boundary_faces = np.nonzero(counts == 1)[0]

    # -- interface ------------------------------------------------------------
    @property
    def num_vertices_global(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_edges_global(self) -> int:
        self._ensure_edges()
        return self._edge_verts.shape[0]

    @property
    def num_faces_global(self) -> int:
        self._ensure_faces()
        return self._face_verts.shape[0]

    @property
    def num_cells_global(self) -> int:
        return self._cells.shape[0]

    @property
    def num_cells_local(self) -> int:
        return self._cells.shape[0]

    def cell_offset(self) -> int:
        return 0

    def cells(self) -> np.ndarray:
        return self._cells

    def cell_coords(self) -> np.ndarray:
        # memoized: the [C, 4, 3] gather costs ~0.6 s at 2.6M cells and
        # matrix + RHS assembly each want it (geometry is immutable)
        cc = getattr(self, "_cell_coords_cache", None)
        if cc is None:
            cc = self.vertices[self._cells]
            self._cell_coords_cache = cc
        return cc

    def cell_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_edges()
        return self._cell_edges, self._cell_edge_flipped

    def cell_faces(self) -> np.ndarray:
        self._ensure_faces()
        return self._cell_faces

    def face_vertices(self, gids: np.ndarray) -> np.ndarray:
        self._ensure_faces()
        return self._face_verts[np.asarray(gids, dtype=np.int64)]

    def edge_vertices(self, gids: np.ndarray) -> np.ndarray:
        self._ensure_edges()
        return self._edge_verts[np.asarray(gids, dtype=np.int64)]

    def face_edges(self, gids: np.ndarray) -> np.ndarray:
        """[n, 3] edge gids of faces (pairs (0,1), (0,2), (1,2) of the
        sorted face-vertex triple)."""
        self._ensure_edges()
        fv = self.face_vertices(gids)
        nv = self.vertices.shape[0]
        keys = np.stack([
            fv[:, 0] * nv + fv[:, 1],
            fv[:, 0] * nv + fv[:, 2],
            fv[:, 1] * nv + fv[:, 2],
        ], axis=-1)
        ekeys = self._edge_verts[:, 0] * nv + self._edge_verts[:, 1]
        order = np.argsort(ekeys)
        pos = np.searchsorted(ekeys[order], keys)
        return order[pos]

    def face_cells(self, gids: np.ndarray) -> np.ndarray:
        self._ensure_faces()
        return self._face_cells[np.asarray(gids, dtype=np.int64)]

    def vertex_coords(self, gids: np.ndarray) -> np.ndarray:
        return self.vertices[np.asarray(gids, dtype=np.int64)]

    def edge_midpoints(self, gids: np.ndarray) -> np.ndarray:
        ev = self.edge_vertices(gids)
        return 0.5 * (self.vertices[ev[:, 0]] + self.vertices[ev[:, 1]])

    def face_centroids(self, gids: np.ndarray) -> np.ndarray:
        fv = self.face_vertices(gids)
        return self.vertices[fv].mean(axis=1)

    def boundary_faces(self) -> np.ndarray:
        self._ensure_faces()
        return self._boundary_faces

    def locate_boundary_facets(self, marker: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Boundary facets whose every vertex satisfies ``marker``
        (reference: mesh::locate_entities, src/poisson_problem.cpp:58-71)."""
        self._ensure_faces()
        faces = self._boundary_faces
        verts = self.face_vertices(faces)
        ok = marker(self.vertices[verts.reshape(-1)]).reshape(-1, 3).all(axis=1)
        return faces[ok]
