"""Carry tpufem's operator and multigrid state into the port.

Every function takes tpufem's state as numpy arrays (never jax objects):
a tpufem ``DiaOperator`` built with ``device=False`` (scalar, or planar
bs = 3), a ``StructuredOperator``'s element matrices and mask (scalar,
or blocked bs = 3), a ``GMG``'s, a ``BrickAMG``'s or an ``SAAMG``'s
per-level arrays, a ``FlatOperator``'s tables and a ``MatFreePoissonOp``'s
state read back with ``np.asarray``.  The tests use them to
run both packages on identical weights; on a card the port builds the
same arrays itself (no jax there), and the tests check that its builders
agree with tpufem's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpufem_torch.fem.assemble import ScatterPlan
from tpufem_torch.fem.csr_spmv import CsrMatrix
from tpufem_torch.fem.dense_gemv import DenseMat
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.flat_op import FlatGeom, FlatOperator
from tpufem_torch.fem.matfree_op import MatFreePoissonOp
from tpufem_torch.fem.structured_op import (GridLayout, StructuredOperator,
                                            dof_slice_plan, grid_layout,
                                            to_planar)
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.la.amg import SAAMG
from tpufem_torch.la.bramg import BrickAMG, _BLevel
from tpufem_torch.la.gmg import GLevel, GMG


def dia_from_numpy(plan: Tuple, weights: Sequence[np.ndarray],
                   bc_mask: np.ndarray, dims: Tuple[int, int, int],
                   device: torch.device,
                   zone_plan: Optional[Tuple] = None,
                   zones: Optional[Tuple] = None,
                   surr_dims: Optional[Tuple[int, int, int]] = None,
                   bs: int = 1, planar: bool = False, order: int = 1,
                   kinds: Optional[Sequence] = None) -> DiaOperator:
    """A port DiaOperator on ``device`` from a tpufem operator's ``plan``,
    ``weights`` (surrogate tables or dense dst-slice arrays), ``bc_mask``
    (in the operator's layout), lattice ``dims`` (Nx, Ny, Nz), in const
    mode its ``zone_plan``, ``zones`` and ``surr_dims``, and its ``bs``
    and ``planar`` (a planar bs = 3 elasticity operator); a P2/P3
    (multi-kind) operator also takes its ``order`` and its layout's
    ``kinds`` ((base, (X, Y, Z), slots) per typed dof grid)."""
    Nx, Ny, Nz = dims
    kinds = (((0, (Nx + 1, Ny + 1, Nz + 1), 1),) if kinds is None else
             tuple((int(b), tuple(int(v) for v in d), int(s))
                   for b, d, s in kinds))
    layout = GridLayout(order=order, Nx=Nx, Ny=Ny, Nz=Nz, kinds=kinds)
    op = DiaOperator(
        weights=[np.asarray(w) for w in weights],
        bc_mask_np=np.array(bc_mask, dtype=bool),
        plan=tuple(plan), layout=layout, surr_dims=surr_dims,
        zone_plan=None if zone_plan is None else tuple(zone_plan),
        zones=None if zones is None else tuple(
            tuple(np.asarray(f) for f in z) for z in zones),
        bs=bs, planar=planar)
    return op._finalize(device)


def structured_from_numpy(Ap: np.ndarray, bc_mask: np.ndarray,
                          dims: Tuple[int, int, int], order: int,
                          device: torch.device,
                          planar: bool = False) -> StructuredOperator:
    """A port StructuredOperator on ``device`` from a tpufem
    StructuredOperator's element matrices ``Ap`` [6, n bs, n bs] (in its
    working dtype; bs = 3 when blocked) and Dirichlet ``bc_mask`` (in
    tpufem's layout, interleaved for bs = 3) on the lattice ``dims`` (Nx,
    Ny, Nz) at ``order``; ``planar`` carries a blocked operator into the
    component-planar layout the port's device bs = 3 operators run in."""
    layout = grid_layout(BoxTetMesh(*dims), order)
    bs = Ap.shape[1] // len(dof_slice_plan(order)[0])
    mask = np.array(bc_mask, dtype=bool)
    planar = planar and bs > 1
    if planar:
        mask = to_planar(mask, bs)
    return StructuredOperator.from_arrays(np.ascontiguousarray(Ap), mask,
                                          layout, device, bs=bs,
                                          planar=planar)


def gmg_from_numpy(ops: Sequence[DiaOperator], dinv: Sequence[np.ndarray],
                   lmax: Sequence[float], coarse_inv: np.ndarray,
                   coarse_bc_mask: np.ndarray, dims: Tuple,
                   device: torch.device, smoother_degree: int = 2,
                   bs: int = 1, planar: bool = False, order: int = 1) -> GMG:
    """A port GMG on ``device`` from the level operators (port objects,
    e.g. from ``dia_from_numpy`` or ``structured_from_numpy``; planar for
    bs = 3) and tpufem's per-level ``dinv`` and
    ``lmax``, ``coarse_inv``, ``coarse_bc_mask``, per-level ``dims`` and
    its ``bs``, ``planar`` and fine ``order`` (order k > 1: level 0 is
    the order-k operator, with its own dinv and lmax, above the P1
    level on the same lattice)."""
    levels = [GLevel(op=op, dinv=torch.from_numpy(np.array(d)).to(device),
                     lmax=float(lm))
              for op, d, lm in zip(ops, dinv, lmax)]
    return GMG(levels=levels,
               coarse_inv=torch.from_numpy(np.array(coarse_inv)).to(device),
               coarse_bc_mask=torch.from_numpy(
                   np.array(coarse_bc_mask, dtype=bool)).to(device),
               dims=tuple(tuple(d) for d in dims),
               smoother_degree=smoother_degree, bs=bs, planar=planar,
               order=order)


def bramg_from_numpy(levels: Sequence[Dict], coarse_inv: np.ndarray,
                     smoother_degree: int, level_sizes: Sequence[int],
                     device: torch.device) -> BrickAMG:
    """A port BrickAMG on ``device`` from a tpufem hierarchy: per level a
    dict of its ``_BLevel``'s ``fields`` (a sequence of [az, ay, ax * m]
    arrays, None at level 0), ``plan``, ``dinv``, ``fw``, ``omega_dinv``,
    ``lmax``, ``gdims``, ``adims``, ``c``, ``m`` and ``planar``; the
    ``coarse_inv``, ``smoother_degree`` and ``level_sizes``.  The fine
    matvec is the caller's, as in tpufem's ``vcycle``."""
    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = []
    for lv in levels:
        fields = lv["fields"]
        out.append(_BLevel(
            fields=None if fields is None else dev(np.stack(
                [np.asarray(f) for f in fields])),
            dinv=dev(lv["dinv"]), fw=dev(lv["fw"]),
            omega_dinv=dev(lv["omega_dinv"]), lmax=float(lv["lmax"]),
            plan=tuple(tuple(int(v) for v in e) for e in lv["plan"]),
            gdims=tuple(int(v) for v in lv["gdims"]),
            adims=tuple(int(v) for v in lv["adims"]), c=int(lv["c"]),
            m=int(lv["m"]), planar=bool(lv["planar"])))
    return BrickAMG(levels=out, coarse_inv=dev(coarse_inv),
                    smoother_degree=int(smoother_degree),
                    level_sizes=[int(v) for v in level_sizes])


def flat_from_numpy(W0, AZT, slot_of, TY, TX, BYZ, BZX, BYX, CC, fmask,
                    meta: Tuple, device: torch.device) -> FlatOperator:
    """A port FlatOperator on ``device`` from a tpufem ``FlatOperator``'s
    ten tables and its ``meta`` (geometry tuple, channels, layout, ...)."""
    geom, channels, lay = meta[0], meta[1], meta[2]
    layout = GridLayout(order=lay.order, Nx=lay.Nx, Ny=lay.Ny, Nz=lay.Nz,
                        kinds=tuple((int(b), tuple(int(v) for v in dims),
                                     int(s)) for b, dims, s in lay.kinds))
    tables = dict(W0=W0, AZT=AZT, slot_of=slot_of, TY=TY, TX=TX, BYZ=BYZ,
                  BZX=BZX, BYX=BYX, CC=CC, fmask=fmask)
    return FlatOperator(
        **{k: torch.from_numpy(np.array(v)).to(device)
           for k, v in tables.items()},
        geom=FlatGeom(*geom), channels=tuple(tuple(c) for c in channels),
        layout=layout)


def ell_to_csr(cols: np.ndarray, vals: np.ndarray, ncols: int,
               ov_rows: Optional[np.ndarray] = None,
               ov_cols: Optional[np.ndarray] = None,
               ov_vals: Optional[np.ndarray] = None):
    """A tpufem ``ELLMatrix`` (scalar: padded [n, K] ``cols`` / ``vals``
    and the COO spill tail) as a scipy CSR matrix; the padding entries
    (value 0) are dropped."""
    import scipy.sparse as sp
    n, K = cols.shape
    rows = np.repeat(np.arange(n), K)
    c, v = cols.reshape(-1).astype(np.int64), vals.reshape(-1)
    if ov_rows is not None:
        rows = np.concatenate([rows, ov_rows.astype(np.int64)])
        c = np.concatenate([c, ov_cols.astype(np.int64)])
        v = np.concatenate([v, ov_vals])
    keep = v != 0
    M = sp.coo_matrix((v[keep], (rows[keep], c[keep])),
                      shape=(n, ncols)).tocsr()
    M.sort_indices()
    return M


def saamg_from_numpy(levels: Sequence[dict], coarse_inv: np.ndarray,
                     smoother_degree: int, level_sizes: Sequence[int],
                     device: torch.device) -> SAAMG:
    """A port SA-AMG hierarchy from a tpufem ``SAAMG``'s arrays.  Each
    level is a dict of ``dinv``, ``lmax`` and either ``fw`` / ``fcols`` /
    ``omega_dinv`` (the factored fine level) or ``P`` / ``PT``, each an
    ELL tuple (cols, vals, ov_rows, ov_cols, ov_vals); its ``A`` is None,
    an ELL tuple or ``("dense", M)`` (tpufem's ``DenseMat``: bfloat16
    values for float32 solves, read back as float32)."""
    from tpufem_torch.la.amg import SALevel, factored_transfers
    dtype = torch.float32 if coarse_inv.dtype == np.float32 else torch.float64

    def csr(t, ncols):
        return CsrMatrix.from_scipy(ell_to_csr(*t[:2], ncols, *t[2:]),
                                    dtype, device)

    out = []
    for i, lv in enumerate(levels):
        n, nc = int(level_sizes[i]), int(level_sizes[i + 1])
        A = lv.get("A")
        if A is not None and isinstance(A[0], str):
            M = np.array(A[1])
            if dtype == torch.float32:  # tpufem stores the level bf16
                Mp = torch.zeros(n, -(-n // 8) * 8, dtype=torch.bfloat16)
                Mp[:, :n] = torch.from_numpy(M.astype(np.float32)).to(
                    torch.bfloat16)
                A = DenseMat(Mp.to(device), n)
            else:
                A = DenseMat(torch.from_numpy(M).to(device), n)
        elif A is not None:
            A = csr(A, n)
        dinv = torch.from_numpy(np.array(lv["dinv"])).to(device)
        if lv.get("fw") is not None:
            P0, P0T = factored_transfers(np.asarray(lv["fcols"]),
                                         np.asarray(lv["fw"]), nc, dtype,
                                         device)
            out.append(SALevel(A=A, P=None, PT=None, dinv=dinv,
                               lmax=float(lv["lmax"]), P0=P0, P0T=P0T,
                               omega_dinv=torch.from_numpy(np.array(
                                   lv["omega_dinv"])).to(device)))
        else:
            out.append(SALevel(A=A, P=csr(lv["P"], nc), PT=csr(lv["PT"], n),
                               dinv=dinv, lmax=float(lv["lmax"])))
    return SAAMG(levels=out, coarse_inv=torch.from_numpy(
        np.array(coarse_inv)).to(device), smoother_degree=smoother_degree,
        level_sizes=list(level_sizes))


def matfree_from_tpufem(G: np.ndarray, cd: np.ndarray, bc_flat: np.ndarray,
                        perm: np.ndarray, segments: np.ndarray, order: int,
                        dtype: torch.dtype,
                        device: torch.device) -> MatFreePoissonOp:
    """A port MatFreePoissonOp on ``device`` from a tpufem
    ``MatFreePoissonOp``'s state: its metric ``G``, cell dofs ``cd``,
    Dirichlet dofs ``bc_flat``, its ``DofScatter``'s ``perm`` and
    ``segments`` and its ``order``.  The dofs are counted from
    ``segments``, the largest plus one: every dof of a function space
    lies in a cell, so a dof below that in no cell is refused."""
    segments = np.asarray(segments).astype(np.int64)
    n = int(segments[-1]) + 1 if segments.size else 0
    offsets = np.searchsorted(segments, np.arange(n + 1))
    if np.any(offsets[1:] == offsets[:-1]):
        raise ValueError("a dof in no cell: not a function space's scatter")
    plan = ScatterPlan(perm=np.asarray(perm).astype(np.int32),
                       offsets=offsets.astype(np.int32))
    return MatFreePoissonOp.from_arrays(G, cd, bc_flat, n, order, dtype,
                                        device, plan=plan)
