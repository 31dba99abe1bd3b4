"""Structured tetrahedral box mesh as closed-form index arithmetic (the
port's copy of tpufem/mesh/structured.py: pure numpy, with the same
arithmetic, so the dof numbering and the DIA tables built on it stay
bitwise equal to tpufem's; the unstructured sizing ``compute_box_size``
is left out).

The reference builds its cube mesh through the full unstructured DOLFINx
pipeline: ``mesh::create_box`` + PT-SCOTCH/ParMETIS partitioning + uniform
refinement with repartitioning (reference: src/mesh.cpp:78-207).  On TPU the
idiomatic design is radically simpler: the box mesh is a *closed-form index
space*.  Every entity (vertex, edge, face, cell) of the Kuhn (6-tetrahedra)
subdivision of an Nx x Ny x Nz lattice has a type + anchor coordinate, so

- generation is O(1) metadata (arrays are materialized lazily per shard),
- "partitioning" is a block split of the lattice (no graph partitioner),
- "uniform refinement" of level r is *regeneration* at (2^r Nx, ...) —
  the dyadic-refinement entity counts in the reference's sizing model
  (src/mesh.cpp:44-54 shifts i,j,k by nrefine) are exact for this mesh.

Kuhn subdivision: each unit cube [c, c+1]^3 splits into 6 tetrahedra, one
per permutation pi of the axes, with vertices along the monotone lattice
path  c -> c+e_{pi0} -> c+e_{pi0}+e_{pi1} -> c+(1,1,1).  All 6 share the
main diagonal; faces between neighboring cubes match up, giving a
conforming mesh whose entity counts reproduce the reference's closed-form
model (validated in tests against src/mesh.cpp:44-74).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Entity counting model (behavioral parity with reference src/mesh.cpp:44-74)
# ---------------------------------------------------------------------------


def num_entities(i: int, j: int, k: int, nrefine: int = 0) -> Tuple[int, int, int, int]:
    """(vertices, edges, faces, cells) of the Kuhn-subdivided i x j x k box,
    dyadically refined ``nrefine`` times (reference: src/mesh.cpp:44-54)."""
    i, j, k = i << nrefine, j << nrefine, k << nrefine
    vertices = (i + 1) * (j + 1) * (k + 1)
    edges = 7 * i * j * k + 3 * (i * j + i * k + j * k) + (i + j + k)
    faces = 12 * i * j * k + 2 * (i * j + i * k + j * k)
    cells = 6 * i * j * k
    return vertices, edges, faces, cells


def num_pdofs(i: int, j: int, k: int, nrefine: int, order: int) -> int:
    """Scalar Lagrange dof count for P1..P4 (reference: src/mesh.cpp:56-74)."""
    nv, ne, nf, nc = num_entities(i, j, k, nrefine)
    if order == 1:
        return nv
    if order == 2:
        return nv + ne
    if order == 3:
        return nv + 2 * ne + nf
    if order == 4:
        return nv + 3 * ne + 3 * nf + nc
    raise RuntimeError("Order not supported")


def compute_box_size_structured(target_dofs: int, strong_scaling: bool,
                                dofs_per_node: int, order: int,
                                num_shards: int,
                                levels: int = 4) -> Tuple[int, int, int, int]:
    """GMG-friendly sizing: dims divisible by 2^levels so the geometric
    multigrid hierarchy (la.gmg) can coarsen ``levels`` times.

    Same dof-targeting contract as the reference's sizing; the dyadic factor
    plays the role of the reference's refinement parameter r
    (src/mesh.cpp:100-126) — here it additionally fixes the multigrid
    depth.  Returns (Nx, Ny, Nz, levels_used).
    """
    N = target_dofs // dofs_per_node
    if not strong_scaling:
        N = target_dofs * num_shards // dofs_per_node

    # cubic lattice size that reaches N
    s = 1
    while num_pdofs(s, s, s, 0, order) < N:
        s += 1

    def z_ok(c, m):
        """Slab-shardable z extent: Nz splits into num_shards equal
        slabs with an even cube count per slab (so the distributed
        multigrid can coarsen at least once before gathering)."""
        if num_shards <= 1:
            return True
        nz = c * m
        return nz % num_shards == 0 and (nz // num_shards) % 2 == 0

    while levels > 0:
        m = 1 << levels
        a0 = max(2, round(s / m))
        if a0 >= 3 or levels == 1:
            best = None
            # near-cubic candidates only (max/min dim ratio bounded):
            # strong anisotropy degrades the multigrid smoother
            for a in range(max(a0 - 2, 2), a0 + 3):
                for b in range(a, a + 3):
                    for c in range(b, min(b + 3, a + 3)):
                        if not z_ok(c, m):
                            continue
                        diff = abs(num_pdofs(a * m, b * m, c * m, 0, order) - N)
                        if best is None or diff < best[0]:
                            best = (diff, a, b, c)
            if best is None:
                # shard count incompatible with the near-cubic window:
                # grow c to the nearest shardable multiple (z is the
                # largest dim, so slab counts beyond the window only
                # stretch the box moderately)
                a = b = max(a0, 2)
                c = b
                while not z_ok(c, m):
                    c += 1
                best = (0, a, b, c)
            _, a, b, c = best
            return a * m, b * m, c * m, levels
        levels -= 1
    raise RuntimeError("unreachable")


# ---------------------------------------------------------------------------
# Closed-form entity numbering
# ---------------------------------------------------------------------------

# Axis permutations defining the 6 Kuhn tetrahedra of a cube.  Tet vertices
# (lattice offsets from the cube corner):
#   p0 = 0, p1 = e_{pi0}, p2 = e_{pi0}+e_{pi1}, p3 = (1,1,1).
# For odd permutations the monotone path gives a negatively oriented tet; we
# swap p1 <-> p2 so every cell has det(J) > 0.
_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _perm_sign(p: Tuple[int, int, int]) -> int:
    inv = sum(1 for a in range(3) for b in range(a + 1, 3) if p[a] > p[b])
    return 1 if inv % 2 == 0 else -1


def _cell_vertex_offsets() -> np.ndarray:
    """[6, 4, 3] lattice offsets of the 4 vertices of each of the 6 tets."""
    out = np.zeros((6, 4, 3), dtype=np.int64)
    eye = np.eye(3, dtype=np.int64)
    for t, perm in enumerate(_PERMS):
        p0 = np.zeros(3, dtype=np.int64)
        p1 = eye[perm[0]]
        p2 = eye[perm[0]] + eye[perm[1]]
        p3 = np.ones(3, dtype=np.int64)
        if _perm_sign(perm) < 0:
            p1, p2 = p2, p1
        out[t] = np.stack([p0, p1, p2, p3])
    return out


CELL_VERTEX_OFFSETS = _cell_vertex_offsets()

# Edge types: direction vectors d; an edge is (anchor v, v + d).
EDGE_TYPES = np.array(
    [
        [1, 0, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 1, 0],
        [1, 0, 1],
        [0, 1, 1],
        [1, 1, 1],
    ],
    dtype=np.int64,
)

# Local edge numbering of the reference tetrahedron (Basix convention):
# pairs of local vertices.
LOCAL_EDGES = np.array([(2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)], dtype=np.int64)
# Local faces (Basix convention): triples of local vertices.
LOCAL_FACES = np.array([(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)], dtype=np.int64)

# Face types: (second-vertex offset, third-vertex offset) relative to the
# anchor (first vertex = componentwise min).  6 cube-interior types (third
# vertex = (1,1,1)) + 6 plane types (2 per axis-normal plane).
FACE_TYPES = np.array(
    [
        # interior: {c, c+d, c+111}
        [[1, 0, 0], [1, 1, 1]],
        [[0, 1, 0], [1, 1, 1]],
        [[0, 0, 1], [1, 1, 1]],
        [[0, 1, 1], [1, 1, 1]],
        [[1, 0, 1], [1, 1, 1]],
        [[1, 1, 0], [1, 1, 1]],
        # z-normal planes: {v, v+ex, v+ex+ey}, {v, v+ey, v+ex+ey}
        [[1, 0, 0], [1, 1, 0]],
        [[0, 1, 0], [1, 1, 0]],
        # y-normal planes
        [[1, 0, 0], [1, 0, 1]],
        [[0, 0, 1], [1, 0, 1]],
        # x-normal planes
        [[0, 1, 0], [0, 1, 1]],
        [[0, 0, 1], [0, 1, 1]],
    ],
    dtype=np.int64,
)


def _edge_type_index() -> Dict[Tuple[int, int, int], int]:
    return {tuple(d): t for t, d in enumerate(EDGE_TYPES)}


def _face_type_index() -> Dict[Tuple[Tuple[int, ...], Tuple[int, ...]], int]:
    return {(tuple(a), tuple(b)): t for t, (a, b) in enumerate(FACE_TYPES)}


_EDGE_TYPE_OF = _edge_type_index()
_FACE_TYPE_OF = _face_type_index()


def _bits(v: np.ndarray) -> np.ndarray:
    """Encode a {0,1}^3 offset as x + 2y + 4z."""
    return v[..., 0] + 2 * v[..., 1] + 4 * v[..., 2]


def _edge_type_lut() -> np.ndarray:
    lut = np.full(8, -1, dtype=np.int64)
    for key, t in _EDGE_TYPE_OF.items():
        lut[_bits(np.array(key))] = t
    return lut


def _face_type_lut() -> np.ndarray:
    lut = np.full(64, -1, dtype=np.int64)
    for (k1, k2), t in _FACE_TYPE_OF.items():
        lut[_bits(np.array(k1)) + 8 * _bits(np.array(k2))] = t
    return lut


_EDGE_LUT = _edge_type_lut()
_FACE_LUT = _face_type_lut()


@functools.lru_cache(maxsize=None)
def _cube_face_table():
    """table[face_type] = [(perm, local_face, anchor offset rel cube)]:
    which tets of the unit Kuhn cube carry a face of each type."""
    table = [[] for _ in range(12)]
    for p in range(6):
        offs = CELL_VERTEX_OFFSETS[p]
        for f, (a, b, c) in enumerate(LOCAL_FACES):
            tri = np.stack([offs[a], offs[b], offs[c]])
            anchor = tri.min(axis=0)
            top = tri.max(axis=0)
            mid = tri.sum(axis=0) - anchor - top
            t = _FACE_TYPE_OF[(tuple(mid - anchor), tuple(top - anchor))]
            table[t].append((p, f, tuple(int(v) for v in anchor)))
    return table


@dataclasses.dataclass(frozen=True)
class BoxTetMesh:
    """Kuhn-subdivided tetrahedral mesh of the unit cube.

    ``Nx, Ny, Nz`` are the *final* lattice dimensions (the reference's
    refinement level r is already folded in: N *= 2**r).  ``z_lo/z_hi``
    select a slab of cube layers for shard-local materialization; global
    numbering is slab-independent.
    """

    Nx: int
    Ny: int
    Nz: int
    z_lo: int = 0
    z_hi: int = -1  # -1 => Nz

    def __post_init__(self) -> None:
        if self.z_hi == -1:
            object.__setattr__(self, "z_hi", self.Nz)

    # -- global sizes -------------------------------------------------------
    @property
    def num_vertices_global(self) -> int:
        return (self.Nx + 1) * (self.Ny + 1) * (self.Nz + 1)

    @property
    def num_edges_global(self) -> int:
        return int(sum(np.prod(d) for d in self._edge_dims()))

    @property
    def num_faces_global(self) -> int:
        return int(sum(np.prod(d) for d in self._face_dims()))

    @property
    def num_cells_global(self) -> int:
        return 6 * self.Nx * self.Ny * self.Nz

    @property
    def num_cells_local(self) -> int:
        return 6 * self.Nx * self.Ny * (self.z_hi - self.z_lo)

    # -- type grids ---------------------------------------------------------
    def _edge_dims(self) -> np.ndarray:
        """Anchor-lattice dims [7, 3] for each edge type."""
        N = np.array([self.Nx, self.Ny, self.Nz], dtype=np.int64)
        # anchor coordinate range: N[a] if d[a] == 1 else N[a] + 1
        return np.where(EDGE_TYPES == 1, N[None, :], N[None, :] + 1)

    def _face_dims(self) -> np.ndarray:
        """Anchor-lattice dims [12, 3] for each face type."""
        N = np.array([self.Nx, self.Ny, self.Nz], dtype=np.int64)
        span = FACE_TYPES.max(axis=1)  # [12, 3] 1 where the face extends
        return np.where(span == 1, N[None, :], N[None, :] + 1)

    def _type_offsets(self, dims: np.ndarray) -> np.ndarray:
        sizes = np.prod(dims, axis=1)
        return np.concatenate([[0], np.cumsum(sizes)])

    # -- gid functions (vectorized over [..., 3] int anchors) ---------------
    def vertex_gid(self, xyz: np.ndarray) -> np.ndarray:
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        return (z * (self.Ny + 1) + y) * (self.Nx + 1) + x

    def _lex(self, anchor: np.ndarray, dims: np.ndarray) -> np.ndarray:
        """Lex index of anchor within grid dims (z slowest, x fastest)."""
        return (anchor[..., 2] * dims[..., 1] + anchor[..., 1]) * dims[..., 0] + anchor[..., 0]

    def edge_gid(self, anchor: np.ndarray, etype: np.ndarray) -> np.ndarray:
        dims = self._edge_dims()
        offs = self._type_offsets(dims)
        return offs[etype] + self._lex(anchor, dims[etype])

    def face_gid(self, anchor: np.ndarray, ftype: np.ndarray) -> np.ndarray:
        dims = self._face_dims()
        offs = self._type_offsets(dims)
        return offs[ftype] + self._lex(anchor, dims[ftype])

    # -- cell arrays (local slab) -------------------------------------------
    def _cube_corners(self) -> np.ndarray:
        """[n_local_cubes, 3] lattice corners of the slab's cubes (z slowest)."""
        zs = np.arange(self.z_lo, self.z_hi, dtype=np.int64)
        cz, cy, cx = np.meshgrid(zs, np.arange(self.Ny, dtype=np.int64),
                                 np.arange(self.Nx, dtype=np.int64), indexing="ij")
        return np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=-1)

    def cell_vertex_lattice(self) -> np.ndarray:
        """[nc_local, 4, 3] lattice coordinates of cell vertices.

        Cell ordering: cube-major (z slowest) x 6 tets per cube, so cell
        gid = 6 * cube_lex + tet and the slab's cells are contiguous.
        """
        corners = self._cube_corners()  # [Q, 3]
        v = corners[:, None, None, :] + CELL_VERTEX_OFFSETS[None, :, :, :]  # [Q,6,4,3]
        return v.reshape(-1, 4, 3)

    def cell_offset(self) -> int:
        """Global cell id of the first local cell."""
        return 6 * self.Nx * self.Ny * self.z_lo

    def cells(self) -> np.ndarray:
        """[nc_local, 4] global vertex ids."""
        return self.vertex_gid(self.cell_vertex_lattice())

    def cell_coords(self) -> np.ndarray:
        """[nc_local, 4, 3] float64 vertex coordinates in the unit cube."""
        lat = self.cell_vertex_lattice().astype(np.float64)
        return lat / np.array([self.Nx, self.Ny, self.Nz], dtype=np.float64)

    def vertex_coords(self, gids: np.ndarray) -> np.ndarray:
        """[n, 3] coordinates of vertices by gid."""
        g = np.asarray(gids, dtype=np.int64)
        x = g % (self.Nx + 1)
        y = (g // (self.Nx + 1)) % (self.Ny + 1)
        z = g // ((self.Nx + 1) * (self.Ny + 1))
        return np.stack([x / self.Nx, y / self.Ny, z / self.Nz], axis=-1)

    def cell_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """([nc_local, 6] global edge ids, [nc_local, 6] bool flipped).

        Local edge ordering follows LOCAL_EDGES.  ``flipped`` is True when
        the local edge direction (first -> second local vertex) opposes the
        global direction (anchor -> anchor+d); used to orient edge dofs
        consistently across cells (P2/P3 dofmaps).
        """
        lat = self.cell_vertex_lattice()  # [C, 4, 3]
        a = lat[:, LOCAL_EDGES[:, 0], :]  # [C, 6, 3]
        b = lat[:, LOCAL_EDGES[:, 1], :]
        anchor = np.minimum(a, b)
        etype = _EDGE_LUT[_bits(np.abs(b - a))]
        gids = self.edge_gid(anchor, etype)
        flipped = np.any(a > b, axis=-1)
        return gids, flipped

    def cell_faces(self) -> np.ndarray:
        """[nc_local, 4] global face ids (local ordering LOCAL_FACES)."""
        lat = self.cell_vertex_lattice()  # [C, 4, 3]
        tri = lat[:, LOCAL_FACES, :]  # [C, 4, 3verts, 3]
        anchor = tri.min(axis=2)  # [C, 4, 3]
        top = tri.max(axis=2)
        # middle vertex = the one that is neither min nor max
        mid = tri.sum(axis=2) - anchor - top
        ftype = _FACE_LUT[_bits(mid - anchor) + 8 * _bits(top - anchor)]
        if (ftype < 0).any():
            raise RuntimeError("unclassifiable face in Kuhn mesh")
        return self.face_gid(anchor, ftype)

    # -- entity -> vertex maps (for predicates / BC closure) ----------------
    def edge_anchor_type(self, gids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse of edge_gid: [n] -> ([n,3] anchor, [n] type)."""
        dims = self._edge_dims()
        offs = self._type_offsets(dims)
        g = np.asarray(gids, dtype=np.int64)
        t = np.searchsorted(offs, g, side="right") - 1
        rel = g - offs[t]
        dt = dims[t]
        x = rel % dt[..., 0]
        y = (rel // dt[..., 0]) % dt[..., 1]
        z = rel // (dt[..., 0] * dt[..., 1])
        return np.stack([x, y, z], axis=-1), t

    def face_anchor_type(self, gids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        dims = self._face_dims()
        offs = self._type_offsets(dims)
        g = np.asarray(gids, dtype=np.int64)
        t = np.searchsorted(offs, g, side="right") - 1
        rel = g - offs[t]
        dt = dims[t]
        x = rel % dt[..., 0]
        y = (rel // dt[..., 0]) % dt[..., 1]
        z = rel // (dt[..., 0] * dt[..., 1])
        return np.stack([x, y, z], axis=-1), t

    def edge_vertices(self, gids: np.ndarray) -> np.ndarray:
        """[n, 2] global vertex ids of edges."""
        anchor, t = self.edge_anchor_type(gids)
        v0 = self.vertex_gid(anchor)
        v1 = self.vertex_gid(anchor + EDGE_TYPES[t])
        return np.stack([v0, v1], axis=-1)

    def face_vertices(self, gids: np.ndarray) -> np.ndarray:
        """[n, 3] global vertex ids of faces."""
        anchor, t = self.face_anchor_type(gids)
        v0 = self.vertex_gid(anchor)
        v1 = self.vertex_gid(anchor + FACE_TYPES[t, 0])
        v2 = self.vertex_gid(anchor + FACE_TYPES[t, 1])
        return np.stack([v0, v1, v2], axis=-1)

    def edge_midpoints(self, gids: np.ndarray) -> np.ndarray:
        anchor, t = self.edge_anchor_type(gids)
        N = np.array([self.Nx, self.Ny, self.Nz], dtype=np.float64)
        return (anchor + 0.5 * EDGE_TYPES[t]) / N

    def face_centroids(self, gids: np.ndarray) -> np.ndarray:
        anchor, t = self.face_anchor_type(gids)
        N = np.array([self.Nx, self.Ny, self.Nz], dtype=np.float64)
        mid = (FACE_TYPES[t, 0] + FACE_TYPES[t, 1]) / 3.0
        return (anchor + mid) / N

    def face_edges(self, gids: np.ndarray) -> np.ndarray:
        """[n, 3] global edge ids of faces (vertex pairs (0,1),(0,2),(1,2)
        of the anchored triple)."""
        anchor, t = self.face_anchor_type(gids)
        o1 = FACE_TYPES[t, 0]
        o2 = FACE_TYPES[t, 1]
        zero = np.zeros_like(o1)
        out = []
        for oa, ob in ((zero, o1), (zero, o2), (o1, o2)):
            ea = anchor + np.minimum(oa, ob)
            et = _EDGE_LUT[_bits(np.abs(ob - oa))]
            out.append(self.edge_gid(ea, et))
        return np.stack(out, axis=-1)

    # -- boundary facets ------------------------------------------------------
    def boundary_faces(self) -> np.ndarray:
        """Global face ids of the mesh's exterior boundary (all 6 box sides).

        Memoized on the (immutable) mesh — the DOLFINx model, where
        facet connectivity is created once per mesh in its own timed
        stage (reference src/main.cpp:148) and every later consumer
        reads the cached topology."""
        cached = self.__dict__.get("_bfaces_cache")
        if cached is not None:
            return cached
        dims = self._face_dims()
        offs = self._type_offsets(dims)
        out: List[np.ndarray] = []
        # plane types 6..11; boundary = anchor at extreme of the normal axis
        normal_axis = {6: 2, 7: 2, 8: 1, 9: 1, 10: 0, 11: 0}
        Nn = {0: self.Nx, 1: self.Ny, 2: self.Nz}
        for t, ax in normal_axis.items():
            dt = dims[t]
            grid = [np.arange(dt[0]), np.arange(dt[1]), np.arange(dt[2])]
            for extreme in (0, Nn[ax]):
                g = [gg for gg in grid]
                g[ax] = np.array([extreme], dtype=np.int64)
                zz, yy, xx = np.meshgrid(g[2], g[1], g[0], indexing="ij")
                anchor = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)
                out.append(offs[t] + self._lex(anchor, dt[None, :]))
        res = np.unique(np.concatenate(out))
        object.__setattr__(self, "_bfaces_cache", res)
        return res

    def boundary_facet_cells(self, facets: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Closed-form facet -> (cube lattice corner, perm, local face).

        The facet->cell connectivity of the reference (src/main.cpp:148)
        restricted to the boundary, computed O(1) per facet from the
        24-entry (perm, local face) -> (face type, anchor offset) table of
        the unit Kuhn cube — no O(cells) scan.  Memoized for the full
        boundary set (the common call, via ``boundary_faces()``).
        """
        cached = self.__dict__.get("_bfc_cache")
        if cached is not None and cached[0] is facets:
            return cached[1]
        anchor, ftype = self.face_anchor_type(np.asarray(facets, dtype=np.int64))
        table = _cube_face_table()  # [12 types] -> list of (perm, lf, offset)
        N = np.array([self.Nx, self.Ny, self.Nz], dtype=np.int64)
        cube = np.full((facets.shape[0], 3), -1, dtype=np.int64)
        perm = np.full(facets.shape[0], -1, dtype=np.int64)
        lf = np.full(facets.shape[0], -1, dtype=np.int64)
        for t in range(12):
            sel = ftype == t
            if not sel.any():
                continue
            for (p, f, off) in table[t]:
                c = anchor[sel] - np.asarray(off)
                ok = np.all((c >= 0) & (c < N), axis=1)
                todo = sel.copy()
                todo[sel] = ok & (perm[sel] < 0)
                cube[todo] = (anchor[todo] - np.asarray(off))
                perm[todo] = p
                lf[todo] = f
        if (perm < 0).any():
            raise ValueError("facet without adjacent cell")
        if facets is self.__dict__.get("_bfaces_cache"):
            object.__setattr__(self, "_bfc_cache", (facets, (cube, perm, lf)))
        return cube, perm, lf

    def locate_boundary_facets(self, marker: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Boundary facets whose *every vertex* satisfies ``marker``.

        Equivalent of ``mesh::locate_entities`` restricted to the boundary
        (reference: src/poisson_problem.cpp:58-71 marks facets where all
        vertices have |x|<eps or |x-1|<eps).  ``marker`` maps [n,3] coords
        to [n] bool.
        """
        faces = self.boundary_faces()
        verts = self.face_vertices(faces)  # [n, 3]
        coords = self.vertex_coords(verts.reshape(-1)).reshape(-1, 3, 3)
        ok = marker(coords.reshape(-1, 3)).reshape(-1, 3).all(axis=1)
        return faces[ok]
