"""Row-sharded assembled-operator solver (counterpart of
tpufem/parallel/rowshard.py): the distributed path of unstructured
meshes, and of cubes too small for slabs.

tpufem's design, kept: dofs partitioned by a Morton curve over their
coordinates (parallel.gmap.partition_cells_sfc, bs components together);
owner-computes-rows, each shard holding the full rows of its owned dofs
with columns remapped to local [owned | ghost] slots, so a product is a
local product and a forward ghost refresh (no reverse scatter); SA-AMG
(la.amg, the global CSR's hierarchy) with the fine level distributed
(sharded Chebyshev, restriction of the owned rows, prolongation to every
local slot) and, where level 1 is stored sparse, level 1 distributed too
(coarse dofs owned where their heaviest fine row lives, its own exchange
rounds, the only sum over shards at the second coarse size); a dense
level 1 is replicated behind ONE sum over shards at the first coarse
size; owned-masked dots.

Where tpufem keeps each shard's rows as a padded ELL, the port keeps
CSR on the csr_spmv kernel (the port replaced ELLMatrix by CSR): the
local shards' rows are one block-diagonal CsrMatrix over the flattened
stacked [L, nlocal] tensor, so a product of every local shard is one
launch, and so are the transfers (P, its owned-row transpose, and
level 1's).  The coarse levels run as the single-device SA-AMG, once a
process.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from tpufem_torch.fem.csr_spmv import CsrMatrix
from tpufem_torch.fem.dia_op import np_dtype
from tpufem_torch.la.cg import cg_solve
from tpufem_torch.la.chebyshev import (chebyshev_smoother,
                                       chebyshev_smoother_zero)
from tpufem_torch.parallel.comm import ShardComm
from tpufem_torch.parallel.gmap import (GeneralIndexMaps, build_general_maps,
                                        partition_cells_sfc)


def _localize_rows(A: sp.csr_matrix, gmap: GeneralIndexMaps,
                   shard: int) -> sp.csr_matrix:
    """Owned rows of A with LOCAL column slots, as an [nlocal, nlocal]
    CSR (rows past the owned count empty)."""
    no = int(gmap.owned_counts[shard])
    rows = gmap.local_gids[shard, :no]
    sub = A[rows]
    loc = gmap.local_of_global(shard, sub.indices.astype(np.int64))
    indptr = np.zeros(gmap.nlocal + 1, dtype=np.int64)
    indptr[1: no + 1] = sub.indptr[1:]
    indptr[no + 1:] = sub.indptr[-1]
    return sp.csr_matrix((sub.data, loc, indptr),
                         shape=(gmap.nlocal, gmap.nlocal))


def _slots(gmap: GeneralIndexMaps, s: int) -> Tuple[np.ndarray, np.ndarray]:
    """(global dofs, local slots) of shard s's owned and ghost slots."""
    no, ng = int(gmap.owned_counts[s]), int(gmap.ghost_counts[s])
    gids = np.concatenate([gmap.local_gids[s, :no],
                           gmap.local_gids[s, gmap.max_owned:
                                           gmap.max_owned + ng]])
    dst = np.concatenate([np.arange(no), gmap.max_owned + np.arange(ng)])
    return gids, dst


def _rows_at(M: sp.csr_matrix, gids: np.ndarray, dst: np.ndarray,
             n: int) -> sp.csr_matrix:
    """[n, ncols]: row dst[i] is M's row gids[i], the others empty."""
    R = sp.csr_matrix((np.ones(gids.shape[0]), (dst, gids)),
                      shape=(n, M.shape[0]))
    out = (R @ M).tocsr()
    out.sort_indices()
    return out


@dataclasses.dataclass
class ShardedEllSolver:
    """Distributed CG over row-sharded CSR, SA-AMG preconditioned."""

    gmap: GeneralIndexMaps
    data: Dict                 # this process's device state
    suffix: object             # SAAMG over levels[1:] / [2:] (or None)
    ndofs: int
    S: int
    comm: ShardComm
    rtol: float
    maxit: int
    smoother_degree: int
    lmax0: float
    has_fine_level: bool
    nc0: int = 0               # first-coarse size
    dist_l1: bool = False      # level 1 distributed (stored sparse)
    lmax1: float = 1.0
    nc1: int = 0               # second-coarse size
    gmap_c: Optional[GeneralIndexMaps] = None   # level-1 maps
    deflate: bool = False      # project out the constant nullspace
    acc_dtype: Optional[torch.dtype] = None
    _cache: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, space, bc, csr_tuple, b_global: np.ndarray, nshards: int,
              options, dtype: torch.dtype = torch.float32,
              near_nullspace: Optional[np.ndarray] = None,
              rtol: float = 1e-8, maxit: int = 100,
              precond: bool = True, deflate: bool = False, *,
              device: torch.device,
              acc_dtype: Optional[torch.dtype] = None,
              comm: Optional[ShardComm] = None) -> "ShardedEllSolver":
        """``precond=False`` runs plain distributed CG (the cgpoisson
        convention).  The host setup runs in every process alike; each
        keeps the rows of its own shards
        (tpufem/parallel/rowshard.py:97-353)."""
        from tpufem_torch.la.amg import SAAMG

        indptr, indices, data = csr_tuple
        bs = bc.bs
        if data.ndim == 3:
            nb = indptr.shape[0] - 1
            A = sp.bsr_matrix((data, indices, indptr),
                              shape=(nb * bs, nb * bs)).tocsr()
        else:
            A = sp.csr_matrix((data, indices, indptr))
        N = A.shape[0]
        S = nshards
        npdtype = np_dtype(dtype)
        comm = comm or ShardComm(S, device)
        rows = comm.local

        # dof partition: SFC over dof coordinates (bs components stay
        # together: partition scalar nodes, repeat for components)
        node_shard = partition_cells_sfc(space.scalar_dof_coords(), S)
        owner_of = np.repeat(node_shard, bs) if bs > 1 else node_shard

        # local dof sets: owned + all columns of owned rows
        local_sets = []
        for s in range(S):
            own = np.flatnonzero(owner_of == s)
            cols = A[own].indices
            local_sets.append(np.unique(np.concatenate([own, cols])))
        gmap = build_general_maps(local_sets, owner_of)
        n = gmap.nlocal

        def dev_csr(M: sp.csr_matrix) -> CsrMatrix:
            return CsrMatrix.from_scipy(M, dtype, device)

        def stack(mats, diag: bool):
            return (sp.block_diag(mats, format="csr") if diag
                    else sp.vstack(mats, format="csr"))

        d: Dict = {}
        d["A"] = dev_csr(stack([_localize_rows(A, gmap, s) for s in rows],
                               True))
        suffix = None
        lmax0 = lmax1 = 1.0
        dist_l1 = False
        gmap_c = None
        degree = 2
        has_fine = False
        nc0 = nc1 = 0
        dinv_loc = np.zeros((S, n))
        if precond:
            amg = SAAMG.setup(csr_tuple, bs, options, device, dtype=dtype,
                              near_nullspace=near_nullspace,
                              bc_mask=bc.mask())
            degree = amg.smoother_degree
            has_fine = len(amg.levels) > 0
            if not has_fine:
                suffix = amg  # levels empty -> vcycle = dense coarse solve
        if has_fine:
            lv0 = amg.levels[0]
            lmax0 = lv0.lmax
            nc0 = int(amg.level_sizes[1])
            dglob = np.zeros(N)
            dv = lv0.dinv.double().cpu().numpy()
            dglob[:dv.shape[0]] = dv
            for s in range(S):
                dinv_loc[s] = dglob[gmap.local_gids[s]]
            P = lv0.P.to_scipy()
            # P rows for ALL local slots (owned + ghost): the prolongated
            # error is consistent without any exchange (the coarse
            # correction is replicated), and the restriction P^T r sums
            # the rows of the owned slots only (each fine row owned by
            # exactly one shard)
            p_rows = [_rows_at(P, *_slots(gmap, s), n) for s in rows]
            p_own = [_rows_at(P, gmap.local_gids[s, :gmap.owned_counts[s]],
                              np.arange(gmap.owned_counts[s]), n)
                     for s in rows]
            # distribute level 1 whenever it is stored sparse (above the
            # dense limit); a dense level stays replicated
            dist_l1 = (len(amg.levels) >= 2
                       and isinstance(amg.levels[1].A, CsrMatrix))
            if not dist_l1:
                d["P"] = dev_csr(stack(p_rows, False))
                d["PT"] = dev_csr(stack(p_own, False).T.tocsr())
                suffix = SAAMG(levels=amg.levels[1:],
                               coarse_inv=amg.coarse_inv,
                               smoother_degree=amg.smoother_degree,
                               level_sizes=amg.level_sizes[1:])
            else:
                lv1 = amg.levels[1]
                lmax1 = lv1.lmax
                nc1 = int(amg.level_sizes[2])
                gmap_c, lvl1 = _level1(P, lv1, gmap, owner_of, nc0, S)
                # fine P columns remapped to LOCAL coarse slots
                d["Ploc"] = dev_csr(stack(
                    [_local_cols(pr, gmap_c, s) for pr, s in zip(p_rows,
                                                                 rows)],
                    True))
                d["PTloc"] = dev_csr(stack(
                    [_local_cols(po, gmap_c, s) for po, s in zip(p_own,
                                                                 rows)],
                    True).T.tocsr())
                d["C"] = dev_csr(stack([lvl1["A"][s] for s in rows], True))
                d["P1"] = dev_csr(stack([lvl1["P1"][s] for s in rows],
                                        False))
                d["P1T"] = dev_csr(stack([lvl1["P1own"][s] for s in rows],
                                         False).T.tocsr())
                d["c_dinv"] = torch.from_numpy(
                    lvl1["dinv"][rows].astype(npdtype)).to(device)
                d["c_owned"] = torch.from_numpy(
                    gmap_c.owned_mask[rows]).to(device)
                suffix = SAAMG(levels=amg.levels[2:],
                               coarse_inv=amg.coarse_inv,
                               smoother_degree=amg.smoother_degree,
                               level_sizes=amg.level_sizes[2:])

        d["dinv"] = torch.from_numpy(dinv_loc[rows].astype(npdtype)).to(device)
        d["owned"] = torch.from_numpy(gmap.owned_mask[rows]).to(device)
        d["b"] = torch.from_numpy(gmap.distribute(
            b_global.astype(np.float64))[rows].astype(npdtype)).to(device)
        # the global dof of every local slot, the dense-coarse gather's
        d["gids"] = torch.from_numpy(gmap.local_gids).to(device)
        d["owned_all"] = torch.from_numpy(gmap.owned_mask).to(device)
        return cls(gmap=gmap, data=d, suffix=suffix, ndofs=N, S=S,
                   comm=comm, rtol=rtol, maxit=maxit, smoother_degree=degree,
                   lmax0=lmax0, has_fine_level=has_fine, nc0=nc0,
                   dist_l1=dist_l1, lmax1=lmax1, nc1=nc1, gmap_c=gmap_c,
                   deflate=deflate, acc_dtype=acc_dtype)

    # -- the solve --------------------------------------------------------------
    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        y = self.data["A"].matvec(x.reshape(-1)).reshape(x.shape)
        return self.gmap.fwd(y, self.comm)

    def _spmv1(self, x: torch.Tensor) -> torch.Tensor:
        y = self.data["C"].matvec(x.reshape(-1)).reshape(x.shape)
        return self.gmap_c.fwd(y, self.comm)

    def _smoothers(self):
        got = self._cache.get("smooth")
        if got is None:
            d, deg = self.data, self.smoother_degree
            got = (chebyshev_smoother(self._spmv, d["dinv"], self.lmax0,
                                      degree=deg),
                   chebyshev_smoother_zero(self._spmv, d["dinv"], self.lmax0,
                                           degree=deg))
            if self.dist_l1:
                got += (chebyshev_smoother(self._spmv1, d["c_dinv"],
                                           self.lmax1, degree=deg),
                        chebyshev_smoother_zero(self._spmv1, d["c_dinv"],
                                                self.lmax1, degree=deg))
            self._cache["smooth"] = got
        return got

    def _gather_global(self, y: torch.Tensor) -> torch.Tensor:
        """The global vector of the owned slots of every shard."""
        N, d = self.ndofs, self.data
        ag = self.comm.all_gather(y)                    # [S, nlocal]
        lg = torch.where(d["owned_all"], d["gids"], N)
        out = torch.zeros(N + 1, dtype=y.dtype, device=y.device)
        out[lg.reshape(-1)] = ag.reshape(-1)
        return out[:N]

    def _precond(self, r: torch.Tensor) -> torch.Tensor:
        d, L, comm = self.data, r.shape[0], self.comm
        if not self.has_fine_level:
            eg = self.suffix.vcycle(self._gather_global(r))
            gids = d["gids"][torch.from_numpy(comm.local).to(r.device)]
            return eg[gids.clamp(0, self.ndofs - 1)]
        sm = self._smoothers()
        smooth, smooth0 = sm[0], sm[1]
        # residual-tracking pre-smoothing from zero
        x, rr = smooth0(r)
        rro = torch.where(d["owned"], rr, 0.0).reshape(-1)
        if not self.dist_l1:
            # replicated level 1: the restriction of every shard's owned
            # rows, ONE sum over shards at the first-coarse size
            rc = comm.psum(d["PT"].matvec(rro)[None])
            ec = self.suffix.vcycle(rc)
            e = d["P"].matvec(ec).reshape(r.shape)
            return smooth(x + e, r)
        smooth1, smooth01 = sm[2], sm[3]
        gc = self.gmap_c
        # distributed level 1: the restriction lands in LOCAL coarse
        # slots; boundary-aggregate partials go to their owners (a
        # reverse exchange at ghost size), ghosts refreshed forward
        rc = d["PTloc"].matvec(rro).reshape(L, -1)
        rc = gc.rev_add(rc, comm)
        rc = gc.fwd(torch.cat([rc[:, :gc.max_owned],
                               torch.zeros_like(rc[:, gc.max_owned:])], 1),
                    comm)
        x1, rr1 = smooth01(rc)
        # level 1 -> 2: the owned coarse rows, the V-cycle's only sum over
        # shards (second-coarse size)
        rr1o = torch.where(d["c_owned"], rr1, 0.0).reshape(-1)
        rc2 = comm.psum(d["P1T"].matvec(rr1o)[None])
        e2 = self.suffix.vcycle(rc2)
        # e2 is replicated and P1 has rows for every local coarse slot,
        # so e1 is ghost-consistent without an exchange
        e1 = x1 + d["P1"].matvec(e2).reshape(L, -1)
        e1 = smooth1(e1, rc)
        e = d["Ploc"].matvec(e1.reshape(-1)).reshape(r.shape)
        return smooth(x + e, r)

    def _dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        t = self.acc_dtype or u.dtype
        local = torch.where(self.data["owned"], u.to(t) * v.to(t), 0.0)
        return self.comm.psum(local.sum(dim=1))

    def _demean(self, v: torch.Tensor) -> torch.Tensor:
        """Owned-masked global mean subtracted (one sum over shards);
        subtracting a constant keeps the ghost slots consistent."""
        s = self.comm.psum(torch.where(self.data["owned"], v, 0.0).sum(1))
        return v - s / self.ndofs

    @property
    def b_local(self) -> torch.Tensor:
        return self.data["b"]

    def _run(self, b: torch.Tensor):
        """One solve of the stacked RHS ``b`` [L, nlocal]: (x_loc,
        iterations, ||r|| / ||r0||)."""
        M = self._precond if self.suffix is not None else None
        if self.deflate:
            b = self._demean(b)
            M = ((lambda r, _M=M: self._demean(_M(r)))
                 if M is not None else self._demean)
        x, it, rel = cg_solve(self._spmv, b, precond=M, rtol=self.rtol,
                              maxit=self.maxit, dot_fn=self._dot)
        if self.deflate:
            x = self._demean(x)
        return x, it, rel

    def norm(self, x_loc: torch.Tensor) -> float:
        """The owned-masked global 2-norm (float64 sums)."""
        sq = torch.where(self.data["owned"], x_loc.to(torch.float64) ** 2,
                         0.0)
        return float(torch.sqrt(self.comm.psum(sq.sum(dim=1))))

    def solve(self) -> Tuple[np.ndarray, int, float]:
        x_loc, it, rel = self._run(self.b_local)
        return self.collect(x_loc), int(it), float(rel)

    def run_timed(self, reps: int = 3):
        """(x_loc, iterations, rel, seconds a solve): one solve, then
        ``reps`` perturbed-RHS solves timed together (0: the first one's
        time)."""
        t0 = time.perf_counter()
        x_loc, it, rel = self._run(self.b_local)
        self._sync()
        dt = time.perf_counter() - t0
        if reps:
            t0 = time.perf_counter()
            for i in range(reps):
                self._run(self.b_local * (1.0 + 1e-6 * (i + 1)))
            self._sync()
            dt = (time.perf_counter() - t0) / reps
        return x_loc, int(it), float(rel), dt

    def _sync(self) -> None:
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)

    def collect(self, x_loc) -> np.ndarray:
        """The global vector of the owned slots; this process must hold
        every shard."""
        if self.comm.nlocal != self.S:
            raise ValueError("collect needs every shard in this process; "
                             "use norm() across processes")
        if isinstance(x_loc, torch.Tensor):
            x_loc = x_loc.cpu().numpy()
        return self.gmap.collect(x_loc, self.ndofs)


def _local_cols(M: sp.csr_matrix, gmap_c: GeneralIndexMaps,
                s: int) -> sp.csr_matrix:
    """M's columns (global coarse dofs) remapped to shard s's local
    coarse slots."""
    M = M.tocsr()
    loc = gmap_c.local_of_global(s, M.indices.astype(np.int64))
    return sp.csr_matrix((M.data, loc, M.indptr),
                         shape=(M.shape[0], gmap_c.nlocal))


def _level1(P, lv1, gmap: GeneralIndexMaps, owner_of: np.ndarray,
            nc0: int, S: int):
    """The distributed level 1 (tpufem/parallel/rowshard.py:207-295):
    coarse ownership (a coarse dof lives on the shard that owns its
    heaviest-|P| fine row; P-less coarse dofs on shard 0), the coarse
    maps, and per shard its localized rows of A1, its P1 rows for every
    local coarse slot and for the owned ones, and its dinv."""
    A1 = lv1.A.to_scipy()
    P1 = lv1.P.to_scipy()
    Pc = P.tocoo()
    mnz = np.abs(Pc.data) > 0.0
    colsf = Pc.col[mnz].astype(np.int64)
    rowsf = Pc.row[mnz].astype(np.int64)
    valsf = np.abs(Pc.data[mnz])
    ordc = np.lexsort((-valsf, colsf))
    cc, rrows = colsf[ordc], rowsf[ordc]
    firstpos = np.flatnonzero(np.r_[True, cc[1:] != cc[:-1]])
    owner_c = np.zeros(nc0, dtype=np.int64)
    owner_c[cc[firstpos]] = owner_of[rrows[firstpos]]
    # local coarse sets: owned rows + their A1 columns + the P columns of
    # every local fine slot (+ dof 0, tpufem's ELL padding target)
    csets = []
    for s in range(S):
        gids, _ = _slots(gmap, s)
        own_rows = np.flatnonzero(owner_c == s)
        csets.append(np.unique(np.concatenate(
            [own_rows, P[gids].indices.astype(np.int64),
             A1[own_rows].indices.astype(np.int64),
             np.zeros(1, dtype=np.int64)])))
    gmap_c = build_general_maps(csets, owner_c)
    nc = gmap_c.nlocal
    d1 = lv1.dinv.double().cpu().numpy()
    out = {"A": {}, "P1": {}, "P1own": {}, "dinv": np.zeros((S, nc))}
    for s in range(S):
        out["A"][s] = _localize_rows(A1, gmap_c, s)
        cg, cdst = _slots(gmap_c, s)
        out["dinv"][s, cdst] = d1[cg]
        # P1 rows for ALL local coarse slots: the level-2 correction is
        # replicated, so e1 = x1 + P1 e2 is consistent on ghosts
        out["P1"][s] = _rows_at(P1, cg, cdst, nc)
        noc = int(gmap_c.owned_counts[s])
        out["P1own"][s] = _rows_at(P1, gmap_c.local_gids[s, :noc],
                                   np.arange(noc), nc)
    return gmap_c, out
