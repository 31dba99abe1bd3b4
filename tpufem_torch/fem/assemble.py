"""Host float64 cell geometry, the Poisson metric and the Poisson and
elasticity element stiffness (numpy; counterpart of
tpufem/fem/assemble.py:280-347 and tpufem/fem/kernels.py:73-77, 180-200),
the cell -> dof scatter plan of the matrix-free action
(tpufem/fem/assemble.py:228-270) and the cluster plan its kernel walks
(csrc/matfree_action.cu), and the assembled operator of the
unstructured path (tpufem/fem/assemble.py:38-75, 350-426).

The structured path needs the element matrices of the six Kuhn tet
shapes only, so its assembly is this closed-form geometry on the host.
The unstructured path assembles tpufem's BC-eliminated CSR on the host
(the native pass where the library loads) and ships it to the device as
a ``CsrMatrix`` (fem.csr_spmv), where tpufem builds a padded ELL.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from tpufem_torch import native
from tpufem_torch.fem.reference import ReferenceTet


# Lame parameters of the reference's generated forms (src/Elasticity.py:12-15)
ELASTICITY_E = 1.0e6
ELASTICITY_NU = 0.3
ELASTICITY_MU = ELASTICITY_E / (2.0 * (1.0 + ELASTICITY_NU))
ELASTICITY_LMBDA = (ELASTICITY_E * ELASTICITY_NU
                    / ((1.0 + ELASTICITY_NU) * (1.0 - 2.0 * ELASTICITY_NU)))


@functools.lru_cache(maxsize=None)
def _poisson_ref_tables(order: int):
    el = ReferenceTet(order)
    K = el.stiffness_tensors  # [3, 3, n, n]
    n = el.ndofs
    return np.ascontiguousarray(K.reshape(9, n * n)), el.mass_tensor, n


def _cell_jacobians(coords: np.ndarray):
    """Per-cell Jacobian J [C,3,3] plus the first cofactor row and det."""
    E = coords[:, 1:4, :] - coords[:, 0:1, :]
    J = np.swapaxes(E, 1, 2)  # [C, a, l]
    c00 = J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1]
    c01 = J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2]
    c02 = J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]
    det = J[:, 0, 0] * c00 + J[:, 0, 1] * c01 + J[:, 0, 2] * c02
    return J, c00, c01, c02, det


def _geometry_np(coords: np.ndarray):
    """(Jinv [C,3,3], |detJ| [C]) by the closed-form adjugate."""
    J, c00, c01, c02, det = _cell_jacobians(coords)
    adj = np.empty_like(J)
    adj[:, 0, 0] = c00
    adj[:, 0, 1] = J[:, 0, 2] * J[:, 2, 1] - J[:, 0, 1] * J[:, 2, 2]
    adj[:, 0, 2] = J[:, 0, 1] * J[:, 1, 2] - J[:, 0, 2] * J[:, 1, 1]
    adj[:, 1, 0] = c01
    adj[:, 1, 1] = J[:, 0, 0] * J[:, 2, 2] - J[:, 0, 2] * J[:, 2, 0]
    adj[:, 1, 2] = J[:, 0, 2] * J[:, 1, 0] - J[:, 0, 0] * J[:, 1, 2]
    adj[:, 2, 0] = c02
    adj[:, 2, 1] = J[:, 0, 1] * J[:, 2, 0] - J[:, 0, 0] * J[:, 2, 1]
    adj[:, 2, 2] = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    Jinv = adj / det[:, None, None]
    return Jinv, np.abs(det)


def metric_np(coords: np.ndarray) -> np.ndarray:
    """[C, 3, 3] per-cell metric |det J| J^-1 J^-T in float64, the only
    geometry the Poisson operator needs (tpufem/fem/assemble.py:318)."""
    Jinv, adet = _geometry_np(coords)
    return np.einsum("cal,cbl->cab", Jinv, Jinv) * adet[:, None, None]


def _poisson_stiffness_np(coords: np.ndarray, order: int) -> np.ndarray:
    """[C, n, n] stiffness of a = inner(grad u, grad v) dx per cell."""
    Kflat, _, n = _poisson_ref_tables(order)
    return (metric_np(coords).reshape(-1, 9) @ Kflat).reshape(-1, n, n)


@functools.lru_cache(maxsize=None)
def _elasticity_ref_table(order: int):
    """TT[(alpha,beta,r,s) = 81, (3n)^2] with
    A_c[(i,r),(j,s)] = sum_{ab rs} C_c[a,b,r,s] K[a,b,i,j]."""
    el = ReferenceTet(order)
    K = el.stiffness_tensors  # [3, 3, n, n]
    n = el.ndofs
    TT = np.zeros((3, 3, 3, 3, 3 * n, 3 * n))
    for r in range(3):
        for s in range(3):
            # rows 3i+r, cols 3j+s get K[a,b,i,j] for channel (a,b,r,s)
            TT[:, :, r, s, r::3, s::3] = K
    return np.ascontiguousarray(TT.reshape(81, 9 * n * n)), el.mass_tensor, n


def _elasticity_stiffness_np(coords: np.ndarray, order: int) -> np.ndarray:
    """[C, 3n, 3n] stiffness of a = inner(sigma(u), eps(v)) dx per cell,
    sigma = 2 mu eps + lambda tr(eps) I (src/Elasticity.py:30-39); dofs
    interleaved, (i, r) -> 3i + r."""
    TT, _, n = _elasticity_ref_table(order)
    mu, lam = ELASTICITY_MU, ELASTICITY_LMBDA
    Jinv, adet = _geometry_np(coords)
    JJ = np.einsum("cal,cbl->cab", Jinv, Jinv)
    eye = np.eye(3)
    C = (mu * JJ[:, :, :, None, None] * eye[None, None, None, :, :]
         + mu * np.einsum("cas,cbr->cabrs", Jinv, Jinv)
         + lam * np.einsum("car,cbs->cabrs", Jinv, Jinv))
    C = C * adet[:, None, None, None, None]
    return (C.reshape(-1, 81) @ TT).reshape(-1, 3 * n, 3 * n)


def detJ_np(coords: np.ndarray) -> np.ndarray:
    """Host float64 |detJ| [C] alone (the RHS volume term's measure)."""
    return np.abs(_cell_jacobians(coords)[4])


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """The sorted cell -> dof scatter of tpufem's ``DofScatter``
    (tpufem/fem/assemble.py:228-270) as a dof -> cell-slot CSR: ``perm``
    int32 [C n], the stable argsort of ``cell_dofs.ravel()`` (the slot
    list: slot s = c n + i is local dof i of cell c), and ``offsets``
    int32 [N + 1]: dof d's slots are perm[offsets[d]:offsets[d + 1]], in
    ascending order (tpufem's ``segments``, the dof of each listed slot,
    is d repeated offsets[d + 1] - offsets[d] times)."""

    perm: np.ndarray
    offsets: np.ndarray


def scatter_plan(cell_dofs: np.ndarray, ndofs: int) -> ScatterPlan:
    """The scatter plan of ``cell_dofs`` [C, n] over ``ndofs`` dofs."""
    flat = np.asarray(cell_dofs).reshape(-1)
    if flat.size >= 2 ** 31 or ndofs >= 2 ** 31:
        raise ValueError("a scatter plan of 2^31 or more slots or dofs: "
                         "the plan is int32")
    perm = np.argsort(flat, kind="stable")
    offsets = np.zeros(ndofs + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=ndofs), out=offsets[1:])
    return ScatterPlan(perm=perm.astype(np.int32),
                       offsets=offsets.astype(np.int32))


# cells a cluster holds, by the dofs a cell has (orders 1-3)
CLUSTER_CELLS = {4: 1024, 10: 512, 20: 256}
# the shared memory a block may have on an H100 (227 KB)
SMEM_BYTES = 232448


def _round8(v):
    return (v + 7) // 8 * 8


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The cells of ``cell_dofs`` [C, n] in clusters of ``cells`` (B)
    cells, each cluster summing the dofs of its cells in shared memory
    (the matrix-free kernel's plan, csrc/matfree_action.cu).

    - ``order`` int64 [C]: the cells in cluster order (cluster k holds
      order[k B:(k + 1) B]).
    - A cluster's distinct dofs are its *locals*, in three runs: the dofs
      in no other cluster and not Dirichlet (written to y by the
      cluster), the Dirichlet dofs (written 0 by every cluster that has
      them), the dofs in other clusters too (the *halo*: a partial sum a
      cluster).  ``clusters`` int32 [K, 4]: each cluster's first local
      in the per-local arrays, and the ends of its three runs (counts).
      A cluster's locals start at a multiple of 8 (16-byte copies); the
      places past its last local are padding.
    - ``gid`` int32 [P]: the dof of each local.
    - ``ld`` uint16 [K, n, B]: the local of slot (c, i), local dof i of
      the cluster's cell c, for the gather of the cell's x.
    - ``sum_idx`` uint16 [K, W] (W: n B rounded up to 8) and ``sum_end``
      uint16 [P]: each local's cell values, as i B + c, in the order they
      are summed (ascending c, then i), from ``sum_end`` of the local
      before (0 for a cluster's first) to its own.
    - ``halo_dof`` int32 [H]: the halo dofs, then the dofs in no cell
      (their sums 0), ascending within each; ``halo_off`` int32 [H + 1]
      and ``halo_src`` int32: each one's partial sums, by the local that
      wrote them, in cluster order.
    - ``max_locals``: the most locals a cluster has, rounded up to 8.
    """

    order: np.ndarray
    cells: int
    clusters: np.ndarray
    gid: np.ndarray
    ld: np.ndarray
    sum_idx: np.ndarray
    sum_end: np.ndarray
    halo_dof: np.ndarray
    halo_off: np.ndarray
    halo_src: np.ndarray
    max_locals: int

    @property
    def n(self) -> int:
        """Dofs a cell."""
        return self.ld.shape[1]

    @property
    def halo_share(self) -> float:
        """Partial sums written and read, a share of the cell slots."""
        return self.halo_src.size / max(self.order.size * self.n, 1)

    def smem_bytes(self, itemsize: int) -> int:
        """Shared memory of a block (csrc/matfree_action.cu:Smem): the
        cell values, x at the locals, the locals' dofs and run ends and
        the summing order, each from a 16-byte boundary."""
        def r16(v):
            return (v + 15) // 16 * 16
        L = self.max_locals
        return (r16(self.cells * self.n * itemsize) + r16(L * itemsize)
                + r16(L * 4) + r16(L * 2) + 2 * self.sum_idx.shape[1])

    def runs(self):
        """(cluster, index in the per-local arrays, start, end in its
        cluster's ``sum_idx``) of every local, int64 each."""
        first = self.clusters[:, 0].astype(np.int64)
        nloc = self.clusters[:, 3].astype(np.int64)
        lcl = np.repeat(np.arange(first.size), nloc)
        idx = np.repeat(first, nloc) + (np.arange(nloc.sum())
                                        - np.repeat(np.cumsum(nloc) - nloc,
                                                    nloc))
        end = self.sum_end[idx].astype(np.int64)
        start = np.where(idx == first[lcl], 0,
                         self.sum_end[np.maximum(idx - 1, 0)].astype(
                             np.int64))
        return lcl, idx, start, end


def cell_order(cell_dofs: np.ndarray) -> np.ndarray:
    """The cells in an order of locality: reverse Cuthill-McKee of the
    graph of the cells' first four dofs (the vertices of a Lagrange
    space's cell), then the cells by their lowest renumbered vertex
    (stable)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    cd = np.asarray(cell_dofs)
    if cd.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    verts = cd[:, :4].astype(np.int64)
    present = np.zeros(int(verts.max()) + 1, dtype=bool)
    present[verts.reshape(-1)] = True
    local = (np.cumsum(present) - 1)[verts]        # rank among the vertices
    V = int(present.sum())
    # the graph's edges once each (and the diagonal), both ways
    lo = np.minimum(local[:, [0, 0, 0, 1, 1, 2]], local[:, [1, 2, 3, 2, 3, 3]])
    hi = np.maximum(local[:, [0, 0, 0, 1, 1, 2]], local[:, [1, 2, 3, 2, 3, 3]])
    edges = np.unique(lo.reshape(-1) * V + hi.reshape(-1))
    lo, hi = edges // V, edges % V
    diag = np.arange(V)
    graph = sp.csr_matrix(
        (np.ones(2 * edges.size + V, dtype=np.int8),
         (np.concatenate([lo, hi, diag]), np.concatenate([hi, lo, diag]))),
        shape=(V, V))
    rank = np.empty(V, dtype=np.int64)
    rank[reverse_cuthill_mckee(graph, symmetric_mode=True)] = np.arange(V)
    return np.argsort(rank[local].min(axis=1), kind="stable")


def cluster_plan(cell_dofs: np.ndarray, ndofs: int,
                 dirichlet: np.ndarray | None = None,
                 cells: int | None = None) -> ClusterPlan:
    """The cluster plan of ``cell_dofs`` [C, n] over ``ndofs`` dofs, with
    the Dirichlet dofs ``dirichlet`` (indices), ``cells`` a cluster
    (CLUSTER_CELLS by n where not given).  Raises ValueError, naming the
    cluster, where a cluster's block would need more than SMEM_BYTES of
    shared memory in float64."""
    cd = np.asarray(cell_dofs).astype(np.int64)
    C, n = cd.shape
    B = int(cells if cells is not None else CLUSTER_CELLS.get(n, 256))
    if B * n > 65535:
        raise ValueError(f"clusters of {B} cells of {n} dofs: the plan "
                         "indexes a cluster's cell values in 16 bits")
    order = cell_order(cd)
    K = -(-C // B)
    cdo = cd[order]                                     # [C, n]
    cl = np.arange(C, dtype=np.int64) // B
    key = (cl[:, None] * ndofs + cdo).reshape(-1)        # slot order
    # the slots by (cluster, dof), each pair's slots in slot order
    by_pair = np.argsort(key, kind="stable")
    sorted_key = key[by_pair]
    starts = np.ones(key.size, dtype=bool)
    starts[1:] = sorted_key[1:] != sorted_key[:-1]
    pair_of_sorted = np.cumsum(starts) - 1
    pairs = sorted_key[starts]
    pair_of_slot = np.empty_like(pair_of_sorted)
    pair_of_slot[by_pair] = pair_of_sorted
    pair_cl = pairs // ndofs
    pair_dof = pairs - pair_cl * ndofs
    npairs = np.bincount(pair_cl, minlength=K)
    first = np.zeros(K + 1, dtype=np.int64)
    np.cumsum(npairs, out=first[1:])
    pfirst = np.zeros(K + 1, dtype=np.int64)          # padded to 8s
    np.cumsum(_round8(npairs), out=pfirst[1:])
    halo = np.bincount(pair_dof, minlength=ndofs) > 1
    bcmask = np.zeros(ndofs, dtype=bool)
    if dirichlet is not None and np.size(dirichlet):
        bcmask[np.asarray(dirichlet, dtype=np.int64)] = True
    # the locals of a cluster: free interior, Dirichlet, free halo
    group = np.where(bcmask[pair_dof], 1, np.where(halo[pair_dof], 2, 0))
    by = np.lexsort((pair_dof, group, pair_cl))         # new local order
    local_of_pair = np.empty_like(by)
    local_of_pair[by] = np.arange(by.size)
    # a local's place in the padded per-local arrays
    at = np.arange(by.size) + (pfirst - first)[pair_cl[by]]
    gid = np.zeros(pfirst[-1], dtype=np.int32)
    gid[at] = pair_dof[by]
    counts = np.zeros((K, 3), dtype=np.int64)
    np.add.at(counts, (pair_cl, group), 1)
    ends = np.cumsum(counts, axis=1)
    clusters = np.stack([pfirst[:-1], ends[:, 0], ends[:, 1], ends[:, 2]],
                        axis=1)
    max_locals = int(_round8(npairs).max(initial=0))
    # each slot's local, within its cluster
    slot_local = (local_of_pair[pair_of_slot].reshape(C, n)
                  - first[cl][:, None])
    ld = np.zeros((K, n, B), dtype=np.uint16)
    ld[cl, :, np.arange(C) - cl * B] = slot_local
    # the summation order: slots by local, then ascending slot (c, i):
    # the pairs' runs of by_pair placed in local order
    runs = np.bincount(pair_of_sorted, minlength=pairs.size)
    local_start = np.cumsum(runs[by]) - runs[by]         # by local
    srt = np.empty_like(by_pair)
    srt[local_start[local_of_pair[pair_of_sorted]]
        + np.arange(key.size)
        - np.flatnonzero(starts)[pair_of_sorted]] = by_pair
    slot_cl = np.repeat(cl, n)
    within = np.arange(C * n, dtype=np.int64) - slot_cl * (B * n)
    c_loc, i_loc = within // n, within % n
    sum_idx = np.zeros((K, _round8(B * n)), dtype=np.uint16)
    pos = np.arange(C * n, dtype=np.int64) - slot_cl[srt] * (B * n)
    sum_idx[slot_cl[srt], pos] = (i_loc * B + c_loc)[srt]
    runs = runs[by]                                     # by local
    cum = np.cumsum(runs)
    sum_end = np.zeros(pfirst[-1], dtype=np.uint16)
    sum_end[at] = cum - np.repeat(cum[first[:-1]] - runs[first[:-1]],
                                  npairs)
    # the halo: each halo dof's partials by local (cluster order), then
    # the dofs in no cell
    h_loc = np.flatnonzero(group[by] == 2)
    h_srt = h_loc[np.argsort(pair_dof[by][h_loc], kind="stable")]
    h_dofs, h_cnt = np.unique(pair_dof[by][h_srt], return_counts=True)
    unused = np.flatnonzero(np.bincount(cd.reshape(-1), minlength=ndofs)
                            == 0)
    halo_dof = np.concatenate([h_dofs, unused])
    halo_off = np.zeros(halo_dof.size + 1, dtype=np.int64)
    np.cumsum(np.concatenate([h_cnt, np.zeros(unused.size, np.int64)]),
              out=halo_off[1:])
    plan = ClusterPlan(order=order, cells=B,
                       clusters=clusters.astype(np.int32), gid=gid, ld=ld,
                       sum_idx=sum_idx, sum_end=sum_end,
                       halo_dof=halo_dof.astype(np.int32),
                       halo_off=halo_off.astype(np.int32),
                       halo_src=at[h_srt].astype(np.int32),
                       max_locals=max_locals)
    need = plan.smem_bytes(8)
    if need > SMEM_BYTES:
        k = int(np.argmax(npairs))
        raise ValueError(
            f"cluster {k} of {B} cells has {int(npairs[k])} dofs: its "
            f"block needs {need} bytes of shared memory in float64, over "
            f"the {SMEM_BYTES} a block can have")
    return plan


# ---------------------------------------------------------------------------
# Assembled operators (the unstructured path): tpufem's host CSR build,
# then a device CsrMatrix in place of its padded ELL
# ---------------------------------------------------------------------------


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedupe-summed CSR from COO triplets, ``vals`` [nnz] or
    [nnz, bs, bs]: (indptr, indices, data) (tpufem/fem/assemble.py:38-75).
    Scalar entries take the native pass or a numpy fallback of the same
    semantics (exact-zero sums dropped, float64 data); block entries
    keep every block."""
    scalar = vals.ndim == 1
    if scalar:
        got = native.coo_to_csr_dedup(rows, cols, vals, n)
        if got is not None:
            indptr, ucols, data = got
            return indptr, ucols.astype(np.int64), data
        vals = vals.astype(np.float64)
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    order = native.argsort_u64(key)
    key = key[order]
    vals = vals[order]
    boundaries = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1])
    ukey = key[boundaries]
    data = np.add.reduceat(vals, boundaries, axis=0)
    urows = (ukey // n).astype(np.int64)
    ucols = (ukey % n).astype(np.int64)
    if scalar:  # as the native route: drop exact-zero sums
        keep = data != 0.0
        data, urows, ucols = data[keep], urows[keep], ucols[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, urows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, ucols, data


def assemble_csr_np(space, bc, problem: str, chunk: int = 1 << 18
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The stiffness operator as host CSR triplets (indptr, indices int64,
    data float64; block CSR [nnz, bs, bs] for bs > 1), BC rows and columns
    zeroed and a unit diagonal on BC dofs (tpufem/fem/assemble.py:350-426,
    the same arrays)."""
    coords_all = space.mesh.cell_coords()
    cell_dofs = space.cell_dofs
    C = coords_all.shape[0]
    n = space.ndofs_per_cell
    bs = space.bs

    if problem == "poisson":
        kern = lambda c: _poisson_stiffness_np(c, space.order)
    elif problem == "elasticity":
        kern = lambda c: _elasticity_stiffness_np(c, space.order)
    else:
        raise ValueError(problem)

    N = space.ndofs_scalar
    indptr = indices = data = None
    if bs == 1 and native.have_native():
        # element tensors in one array, triplets and dedup in one native pass
        A_all = np.empty((C, n, n), dtype=np.float64)
        for start in range(0, C, chunk):
            end = min(start + chunk, C)
            A_all[start:end] = kern(coords_all[start:end])
        got = native.cells_to_csr(cell_dofs, A_all, N)
        if got is not None:
            indptr, icols, data = got
            indices = icols.astype(np.int64)
        del A_all
    if indptr is None:
        rows_parts, cols_parts, vals_parts = [], [], []
        for start in range(0, C, chunk):
            end = min(start + chunk, C)
            A = kern(coords_all[start:end])  # [c, bn, bn]
            cd = cell_dofs[start:end]
            r = np.repeat(cd, n, axis=1)            # [c, n*n] block rows
            cidx = np.tile(cd, (1, n))              # [c, n*n] block cols
            if bs == 1:
                v = A.reshape(end - start, n * n)
            else:
                # A is [(3i+r),(3j+s)] interleaved; regroup to [i,j,r,s]
                v = A.reshape(end - start, n, bs, n,
                              bs).transpose(0, 1, 3, 2, 4)
                v = v.reshape(end - start, n * n, bs, bs)
            rows_parts.append(r.reshape(-1))
            cols_parts.append(cidx.reshape(-1))
            vals_parts.append(v.reshape((-1,) + v.shape[2:]))
        indptr, indices, data = coo_to_csr(np.concatenate(rows_parts),
                                           np.concatenate(cols_parts),
                                           np.concatenate(vals_parts), N)

    if bc is not None and bc.flat_dofs().size > 0:
        mask = bc.mask()
        rows_of = np.repeat(np.arange(N), np.diff(indptr))
        onrow = mask[rows_of]
        oncol = mask[indices]
        diag = rows_of == indices
        if bs == 1:
            data = np.where(onrow | oncol, 0.0, data)
            data = np.where(diag & mask[rows_of], 1.0, data)
        else:
            data[onrow | oncol] = 0.0
            data[diag & onrow] = np.eye(bs)
    return indptr, indices, data


def assemble_operator(space, bc, problem: str, dtype: torch.dtype,
                      device: torch.device):
    """(device CsrMatrix, host CSR triplets) of the BC-eliminated stiffness
    operator: tpufem's ``assemble_operator`` (tpufem/fem/assemble.py:350),
    with a CSR matrix on ``device`` where tpufem builds a capped ELL.  A
    block CSR (bs > 1) goes to the device in its scalar expansion."""
    from tpufem_torch.fem.csr_spmv import CsrMatrix
    csr = assemble_csr_np(space, bc, problem)
    indptr, indices, data = csr
    if data.ndim == 3:
        import scipy.sparse as sp
        nb = indptr.shape[0] - 1
        bs = data.shape[1]
        M = sp.bsr_matrix((data, indices, indptr),
                          shape=(nb * bs, nb * bs)).tocsr()
        return CsrMatrix.from_scipy(M, dtype, device), csr
    return CsrMatrix.from_csr(indptr, indices, data, dtype, device), csr
