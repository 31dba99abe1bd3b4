"""Tetrahedral mesh refinement (host-side, for the unstructured path; the
port's copy of tpufem/mesh/refine.py, pinned equal by the tests).

Equivalent of ``dolfinx::refinement::refine`` (reference call sites:
src/mesh.cpp:196-204 uniform, src/mesh.cpp:414-417 marked-edge Plaza).
The structured cube path never calls this — dyadic refinement there is
closed-form regeneration (tpufem_torch.mesh.structured).  The spoke mesh uses:

- ``uniform_refine``: 1:8 red refinement via edge midpoints, central
  octahedron split along its shortest diagonal;
- ``refine_marked_edges``: conforming local refinement by iterated
  longest-marked-edge bisection with closure (Plaza-style behavior:
  marked edges are split, plus whatever closure demands).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpufem_torch.mesh.structured import LOCAL_EDGES


def _edge_keys(cells: np.ndarray, nv: int) -> np.ndarray:
    """[C, 6] canonical int keys of each cell's edges."""
    pairs = cells[:, LOCAL_EDGES]
    lo = pairs.min(axis=-1).astype(np.int64)
    hi = pairs.max(axis=-1).astype(np.int64)
    return lo * nv + hi


def uniform_refine(vertices: np.ndarray,
                   cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One level of red (1:8) refinement."""
    nv = vertices.shape[0]
    keys = _edge_keys(cells, nv)  # [C, 6]
    from tpufem_torch.native import unique_inverse_u64
    uniq, inv = unique_inverse_u64(keys.ravel())
    mid_ids = nv + inv.reshape(-1, 6)  # [C, 6] new vertex id per local edge
    mids = 0.5 * (vertices[(uniq // nv)] + vertices[(uniq % nv)])
    new_verts = np.concatenate([vertices, mids], axis=0)

    # local edge index between local vertices (a, b)
    eidx = np.full((4, 4), -1, dtype=np.int64)
    for e, (a, b) in enumerate(LOCAL_EDGES):
        eidx[a, b] = eidx[b, a] = e

    v = cells  # [C, 4]
    m = lambda a, b: mid_ids[:, eidx[a, b]]
    # 4 corner tets
    children = [
        np.stack([v[:, 0], m(0, 1), m(0, 2), m(0, 3)], axis=1),
        np.stack([v[:, 1], m(0, 1), m(1, 2), m(1, 3)], axis=1),
        np.stack([v[:, 2], m(0, 2), m(1, 2), m(2, 3)], axis=1),
        np.stack([v[:, 3], m(0, 3), m(1, 3), m(2, 3)], axis=1),
    ]
    # central octahedron: shortest of the 3 diagonals per cell
    d_pairs = [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))]
    dlen = np.stack([
        np.linalg.norm(new_verts[m(*p)] - new_verts[m(*q)], axis=1)
        for p, q in d_pairs], axis=1)  # [C, 3]
    choice = np.argmin(dlen, axis=1)  # [C]
    # equator cycles for each diagonal choice (pairs adjacent in octa)
    octa_tets = []
    for (p, q), cyc in (
            (((0, 1), (2, 3)), [(0, 2), (0, 3), (1, 3), (1, 2)]),
            (((0, 2), (1, 3)), [(0, 1), (0, 3), (2, 3), (1, 2)]),
            (((0, 3), (1, 2)), [(0, 1), (0, 2), (2, 3), (1, 3)])):
        A, B = m(*p), m(*q)
        e = [m(*ab) for ab in cyc]
        octa_tets.append(np.stack([
            np.stack([A, B, e[0], e[1]], axis=1),
            np.stack([A, B, e[1], e[2]], axis=1),
            np.stack([A, B, e[2], e[3]], axis=1),
            np.stack([A, B, e[3], e[0]], axis=1),
        ], axis=1))  # [C, 4tets, 4]
    octa = np.stack(octa_tets, axis=1)  # [C, 3choice, 4, 4]
    octa = octa[np.arange(cells.shape[0]), choice]  # [C, 4, 4]
    children.append(octa[:, 0])
    children.append(octa[:, 1])
    children.append(octa[:, 2])
    children.append(octa[:, 3])
    new_cells = np.concatenate([c[:, None, :] for c in children], axis=1)
    return new_verts, new_cells.reshape(-1, 4)


def refine_marked_edges(vertices: np.ndarray, cells: np.ndarray,
                        marked_edge_verts: np.ndarray,
                        max_passes: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Conforming local refinement: split the given edges (as [n, 2]
    vertex pairs), Plaza-style (reference: DOLFINx Plaza refinement,
    src/mesh.cpp:414-417).

    Phase 1 closes the marking under "every cell touching a marked
    edge has its longest edge marked" (longest by (length, key)
    lexicographic order — a total order neighbors agree on).  Phase 2
    bisects each touched cell by its longest MARKED edge; children
    inherit remaining marked parent edges and re-enter, so all marked
    edges split, growth is bounded by 2^(marked edges per cell), and a
    shared face's marked edges bisect in the same order on both sides
    (conformity; pinned by tests/test_refine_spoke.py).
    """
    from tpufem_torch import native
    got = native.refine_marked_edges(vertices, cells,
                                     np.asarray(marked_edge_verts),
                                     max_passes)
    if got is not None:
        # C++ incremental-incidence implementation (O(touched) per
        # round; bit-identical output, pinned by tests)
        return got

    verts = vertices
    cells = cells.copy()

    def key_of(a, b):
        lo = np.minimum(a, b).astype(np.int64)
        hi = np.maximum(a, b).astype(np.int64)
        return lo * (1 << 32) + hi

    mk = np.asarray(marked_edge_verts, dtype=np.int64)
    split_keys = np.unique(key_of(mk[:, 0], mk[:, 1]))

    # phase 1: closure to fixed point (marking only; no bisection) —
    # every cell touching a marked edge contributes its longest edge
    for _ in range(max_passes):
        pairs = cells[:, LOCAL_EDGES]  # [C, 6, 2]
        keys = key_of(pairs[..., 0], pairs[..., 1])
        marked = np.isin(keys, split_keys)
        need = marked.any(axis=1)
        if not need.any():
            return verts, cells
        elen = np.linalg.norm(verts[pairs[..., 0]] - verts[pairs[..., 1]],
                              axis=-1)
        maxlen = elen.max(axis=1, keepdims=True)
        keysel = np.where(elen == maxlen, keys, -1)
        longest = np.argmax(keysel, axis=1)
        new = np.setdiff1d(np.unique(keys[need, longest[need]]), split_keys)
        if new.size == 0:
            break
        split_keys = np.union1d(split_keys, new)

    # phase 2: rounds bisecting each touched cell by its longest MARKED
    # edge; children inherit remaining marked parent edges and re-enter.
    # Midpoints are memoized GLOBALLY across rounds: neighbors may
    # bisect the same edge in different rounds and must share one
    # midpoint vertex (a per-round memo created duplicate coincident
    # vertices -> hanging faces).
    mid_memo: dict = {}
    for _ in range(max_passes):
        pairs = cells[:, LOCAL_EDGES]
        keys = key_of(pairs[..., 0], pairs[..., 1])
        marked = np.isin(keys, split_keys)
        need = marked.any(axis=1)
        if not need.any():
            break
        elen = np.linalg.norm(verts[pairs[..., 0]] - verts[pairs[..., 1]],
                              axis=-1)
        elen_m = np.where(marked, elen, -np.inf)
        maxlen = elen_m.max(axis=1, keepdims=True)
        keysel = np.where(marked & (elen_m == maxlen), keys, -1)
        longest = np.argmax(keysel, axis=1)

        bis = np.flatnonzero(need)
        lidx = longest[bis]
        la = LOCAL_EDGES[lidx, 0]
        lb = LOCAL_EDGES[lidx, 1]
        va = cells[bis, la]
        vb = cells[bis, lb]
        bkeys = key_of(va, vb)
        ukeys, inv = np.unique(bkeys, return_inverse=True)
        new_mask = np.array([k not in mid_memo for k in ukeys.tolist()])
        nk = ukeys[new_mask]
        base = verts.shape[0]
        a = nk >> 32
        b = nk & ((1 << 32) - 1)
        verts = np.concatenate([verts, 0.5 * (verts[a] + verts[b])])
        for j, k in enumerate(nk.tolist()):
            mid_memo[k] = base + j
        mid_ids = np.array([mid_memo[k] for k in ukeys.tolist()],
                           dtype=np.int64)
        mid = mid_ids[inv]

        ch1 = cells[bis].copy()
        ch1[np.arange(bis.size), la] = mid
        ch2 = cells[bis].copy()
        ch2[np.arange(bis.size), lb] = mid
        cells = np.concatenate([cells[~need], ch1, ch2], axis=0)

    return verts, cells
