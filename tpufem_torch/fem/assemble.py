"""Host float64 cell geometry, the Poisson metric and the Poisson and
elasticity element stiffness (numpy; counterpart of
tpufem/fem/assemble.py:280-347 and tpufem/fem/kernels.py:73-77, 180-200),
the cell -> dof scatter plan of the matrix-free action
(tpufem/fem/assemble.py:228-270), and the assembled operator of the
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
