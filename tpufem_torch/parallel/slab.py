"""Slab-sharded solver of the structured cube (counterpart of
tpufem/parallel/slab.py), the distributed path behind ``--num_shards``.

tpufem runs it as one SPMD ``shard_map`` program; here a process holds
its shards as one stacked [L, nloc] tensor (parallel.comm), and the same
decomposition and arithmetic run eagerly:

- **decomposition**: z-slabs of vertex planes.  Shard s holds planes
  [s nzl, (s + 1) nzl]; its bottom interface plane is a ghost owned by
  shard s - 1.  The host arrays (local dofs ``slab_global_ids``,
  interface plan ``iface_plan``, ``dinv``, Dirichlet and owned masks,
  RHS slabs) are tpufem's layout and bits.
- **operator apply**: each shard's slab operator (partial rows at the
  interface planes), then the reverse halo (row s's bottom interface
  slices added into row s - 1's top ones: one shifted add of the
  concatenated slices), Dirichlet rows zeroed, then the forward halo
  (row s - 1's top slices copied into row s's ghosts).  The slab
  operators are the port's: K1 (P1 Poisson), its three-component form
  (P1 elasticity), ``dia_zones`` (P2 and P3 Poisson; P3 slabs of under
  6 planes: the per-perm product), ``perm_apply`` (P2 / P3 elasticity);
  one launch a shard.
- **distributed geometric multigrid**: restriction of the owned dofs
  (ghost interface slices zeroed), the cross-interface part carried by
  the coarse level's reverse halo; halo-free prolongation.  The first
  level at or below ``gather_limit`` dofs is gathered (the top coarse
  plane completed from the shard above, ``all_gather``) and the rest of
  the hierarchy runs as the single-device GMG (``suffix``), once a
  process; each shard then takes its planes of the correction.
- **reductions**: owned-masked dots summed a shard, then across shards.

Elasticity keeps tpufem's interleaved host arrays; on the device a slab
vector is component-planar (``c * n + i``, the port's bs = 3 layout), and
the solve converts in and out once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.dia_op import DiaOperator, build_operator, np_dtype
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import StructuredOperator, grid_layout
from tpufem_torch.la.cg import cg_solve
from tpufem_torch.la.chebyshev import (chebyshev_smoother,
                                       chebyshev_smoother_zero)
from tpufem_torch.la.gmg import (GMG, prepare_h_transfers, prolong_p,
                                 restrict_p, surrogate_lmax)
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.parallel.comm import ShardComm
from tpufem_torch.problems import common
from tpufem_torch.timing import span


def _level_chain(mesh: BoxTetMesh, bs: int, coarse_limit: int,
                 max_levels: int) -> List[Tuple[int, int, int]]:
    """Dyadic level dims, finest first — the SAME walk as GMG.setup
    (gmg.py) so the sharded and single-device hierarchies coincide."""
    chain = [(mesh.Nx, mesh.Ny, mesh.Nz)]
    while True:
        nx, ny, nz = chain[-1]
        ndofs_here = (nx + 1) * (ny + 1) * (nz + 1) * bs
        if (ndofs_here <= coarse_limit or len(chain) >= max_levels
                or nx % 2 or ny % 2 or nz % 2 or min(nx, ny, nz) < 4):
            break
        chain.append((nx // 2, ny // 2, nz // 2))
    return chain


def slab_gmg_viable(mesh: BoxTetMesh, nshards: int, bs: int = 1,
                    coarse_limit: int = 1000,
                    max_levels: int = 12, precond: bool = True) -> bool:
    """True when ShardedCubeSolver.build can shard this mesh: Nz must
    split into equal slabs, and — when a multigrid preconditioner is
    wanted — the finest level's slabs must be EVEN and at least one
    coarser level must exist (the same conditions build() raises on).
    The CLI uses this to route small/indivisible cube configs to the
    rowshard fallback instead of erroring; callers must pass the
    solver's own amg_max_levels/pc_type so the predicate matches what
    build() will actually be asked to do."""
    if mesh.Nz % nshards != 0:
        return False
    if not precond:
        return True  # unpreconditioned CG shards without a chain
    chain = _level_chain(mesh, bs, coarse_limit, max_levels)
    return len(chain) >= 2 and (mesh.Nz // nshards) % 2 == 0


def slab_global_ids(mesh: BoxTetMesh, order: int, nzl: int, S: int,
                    bs: int = 1):
    """[S, nloc] global flat dof indices of each slab's local dofs.

    Kind-by-kind z-slices of the typed dof grids: kinds whose lattice
    direction has dz = 0 span nzl+1 planes and overlap neighbours by the
    interface plane; dz = 1 kinds partition exactly.  Works for every
    order (P1's single vertex kind reduces to the plane-major slab)."""
    lay_g = grid_layout(mesh, order)
    lay_s = grid_layout(BoxTetMesh(mesh.Nx, mesh.Ny, nzl), order)
    ids = np.empty((S, lay_s.ndofs), dtype=np.int64)
    for (bg, (Xg, Yg, Zg), sg), (bl, (Xl, Yl, Zl), sl) in zip(
            lay_g.kinds, lay_s.kinds):
        mrow = Xg * Yg * sg
        loc = bl + np.arange(Zl * mrow)
        for s in range(S):
            ids[s, loc] = bg + (s * nzl) * mrow + np.arange(Zl * mrow)
    if bs > 1:
        ids = (ids[:, :, None] * bs + np.arange(bs)).reshape(S, -1)
    return ids, lay_s


def iface_plan(lay_s, nzl: int, bs: int = 1) -> Tuple:
    """Static flat slices of the slab-interface dofs.

    Only dof kinds whose grid spans nzl+1 z-planes (lattice direction
    dz = 0) have entries ON the plane shared between adjacent slabs —
    dz = 1 kinds live strictly between planes of one slab.  Each entry
    is (bottom_ghost_start, top_owned_start, length); both slices are
    contiguous in the kind-major flat layout, so the halo exchange is a
    concat of static slices + ONE ppermute (no gathers)."""
    plan = []
    for base, (X, Y, Z), s in lay_s.kinds:
        if Z == nzl + 1:
            m = X * Y * s * bs
            plan.append((base * bs, base * bs + nzl * m, m))
    return tuple(plan)


def _plan_slots(plan, n: int, bs: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bottom ghost slots, top owned slots) of an interleaved interface
    plan, concatenated, in the device layout of a slab vector of n dofs:
    itself for bs = 1, component-planar (c * n / bs + i) for bs = 3."""
    bot = np.concatenate([np.arange(b0, b0 + m) for b0, _t, m in plan])
    top = np.concatenate([np.arange(t, t + m) for _b, t, m in plan])
    if bs > 1:
        ns = n // bs
        to_p = lambda i: (i % bs) * ns + i // bs  # noqa: E731
        bot, top = to_p(bot), to_p(top)
    return bot, top


@dataclasses.dataclass
class _Level:
    """Host-side build product for one sharded level (rows of this
    process's shards, tpufem's interleaved layout)."""

    op: object             # slab operator on the device (no BC)
    dinv: np.ndarray       # [L, nloc] global-diagonal inverse slabs
    bc: np.ndarray         # [L, nloc] bool
    dims: Tuple[int, int, int]   # global (Nx, Ny, Nz) of this level
    nzl: int               # cube layers per shard
    lmax: float
    order: int             # polynomial order of this level
    iface: Tuple           # interface slice plan (see iface_plan)


def _slab_operator(slab: BoxTetMesh, kord: int, problem: str,
                   dtype: torch.dtype, device: torch.device, h_over):
    """A slab's operator on the device, without Dirichlet rows: tpufem's
    choice (tpufem/parallel/slab.py:231-249) in the port's forms, but for
    two.  Blocked P2 elasticity is the StructuredOperator (the port's
    blocked order-k operator) where tpufem takes its dense blocked DIA.
    Scalar P3 is the const DIA (``dia_zones``) where the slab has the
    planes for it (6 or more), as on one device: tpufem keeps the
    per-perm form there only to spare XLA the compile of the zone
    expansion, and the port's per-perm form is plain ``torch.matmul``."""
    bs = 3 if problem == "elasticity" else 1
    if kord == 1:
        return DiaOperator.build(slab, 1, problem, dtype=dtype, device=device,
                                 bake_bc=False, h_override=h_over,
                                 planar=bs > 1)
    if bs == 1:
        op = DiaOperator.try_const(slab, kord, problem, dtype=dtype,
                                   bake_bc=False, device=device,
                                   h_override=h_over)
        if op is not None:
            return op
        if kord == 2:
            return DiaOperator.build(slab, kord, problem, dtype=dtype,
                                     device=device, bake_bc=False,
                                     h_override=h_over, mode="dense")
    return StructuredOperator.build(slab, kord, problem, dtype=dtype,
                                    device=device, h_override=h_over,
                                    planar=bs > 1)


def _interleaved_diagonal(op) -> np.ndarray:
    """An operator's host diagonal in tpufem's interleaved layout."""
    d = op.diagonal_np()
    if getattr(op, "planar", False):
        return d.reshape(op.bs, -1).T.reshape(-1)
    return d


def _prefix(chain, S: int, bs: int, gather_limit: int) -> int:
    """K, the sharded levels: those whose z extent splits into equal even
    slabs, the first at or below ``gather_limit`` dofs going to the
    replicated suffix (the finest level always shards)."""
    K = 0
    while (K + 1 < len(chain)
           and chain[K][2] % S == 0 and (chain[K][2] // S) % 2 == 0
           and (K == 0
                or (chain[K][0] + 1) * (chain[K][1] + 1)
                * (chain[K][2] + 1) * bs > gather_limit)):
        K += 1
    return K


@dataclasses.dataclass
class ShardedCubeSolver:
    """Distributed CG (optionally GMG-preconditioned) on BoxTetMesh for
    problem in {"poisson", "elasticity"}, orders 1-3."""

    levels: List[_Level]
    suffix: Optional[GMG]         # replicated coarse hierarchy (None when
    #                               unpreconditioned)
    b_local: torch.Tensor         # [L, nloc] interleaved
    owned: torch.Tensor           # [L, nloc] bool
    bs: int
    S: int
    comm: ShardComm
    rtol: float
    maxit: int
    smoother_degree: int
    acc_dtype: Optional[torch.dtype] = None
    _cache: dict = dataclasses.field(default_factory=dict)

    # -- construction ---------------------------------------------------------
    @staticmethod
    def _specs(mesh, S, bs, problem, marker, order, dtype, precond,
               coarse_limit, max_levels, gather_limit):
        chain = _level_chain(mesh, bs, coarse_limit, max_levels)
        if precond:
            K = _prefix(chain, S, bs, gather_limit)
            if K == 0:
                raise ValueError(
                    f"cannot shard {mesh.Nx}x{mesh.Ny}x{mesh.Nz} over {S} "
                    f"slabs with multigrid (Nz/S={mesh.Nz // S} must be "
                    "even); increase the mesh or lower the shard count")
            lmax_of = {k: surrogate_lmax(mesh, k, problem, marker, dtype)
                       for k in sorted({1, order})}
            specs = ([(chain[0], order)] if order > 1 else []) \
                + [(chain[i], 1) for i in range(K)]
        else:
            K = 1
            lmax_of = {order: 1.0}
            specs = [(chain[0], order)]
        return chain, K, lmax_of, specs

    @classmethod
    def build(cls, mesh: BoxTetMesh, nshards: int, problem: str = "poisson",
              order: int = 1, dtype: torch.dtype = torch.float32,
              rtol: float = 1e-8, maxit: int = 100, precond: bool = True,
              coarse_limit: int = 1000, smoother_degree: int = 2,
              max_levels: int = 12, gather_limit: int = 100_000, *,
              device: torch.device,
              b_global: Optional[np.ndarray] = None,
              acc_dtype: Optional[torch.dtype] = None,
              comm: Optional[ShardComm] = None) -> "ShardedCubeSolver":
        """Orders >= 2 add a p-coarsening level on top of the P1 h-chain
        (the GMG.setup walk): the order-k fine level shards over the SAME
        z-slabs, restrict_p/prolong_p act slab-locally, and
        interface-plane contributions ride the same halo
        (tpufem/parallel/slab.py:170-299).  The host arrays are built
        globally and this process keeps its shards' rows."""
        bs = 3 if problem == "elasticity" else 1
        marker = (common.elasticity_bc_marker if problem == "elasticity"
                  else common.poisson_bc_marker)
        S = nshards
        if mesh.Nz % S:
            raise ValueError(
                f"Nz={mesh.Nz} not divisible by {S} shards "
                "(compute_box_size_structured(num_shards=...) guarantees "
                "this for CLI meshes)")
        comm = comm or ShardComm(S, device)
        rows = comm.local
        chain, K, lmax_of, specs = cls._specs(
            mesh, S, bs, problem, marker, order, dtype, precond,
            coarse_limit, max_levels, gather_limit)

        levels: List[_Level] = []
        ids0 = fine_bc = None
        for dims, kord in specs:
            nx, ny, nz = dims
            nzl = nz // S
            slab = BoxTetMesh(nx, ny, nzl)
            h_over = (1.0 / nx, 1.0 / ny, 1.0 / nz)
            op = _slab_operator(slab, kord, problem, dtype, device, h_over)
            gmesh = BoxTetMesh(nx, ny, nz)
            ids, lay_s = slab_global_ids(gmesh, kord, nzl, S, bs)
            gop = build_operator(gmesh, kord, problem, bc_dofs=None,
                                 dtype=torch.float64, bake_bc=False)
            dinv_g = 1.0 / gop.diagonal_np()
            gspace = FunctionSpace(gmesh, kord, bs=bs)
            gbc = DirichletBC.from_space(
                gspace, gmesh.locate_boundary_facets(marker))
            gmask = np.zeros(gspace.ndofs, dtype=bool)
            gmask[gbc.flat_dofs()] = True
            if not levels:
                fine_bc, ids0 = gbc, ids
            levels.append(_Level(
                op=op, dinv=dinv_g[ids][rows].astype(np_dtype(dtype)),
                bc=gmask[ids][rows], dims=dims, nzl=nzl, lmax=lmax_of[kord],
                order=kord, iface=iface_plan(lay_s, nzl, bs)))

        suffix = None
        if precond:
            suffix = GMG.setup(BoxTetMesh(*chain[K]), 1, problem, marker,
                               device, dtype=dtype, coarse_limit=coarse_limit,
                               smoother_degree=smoother_degree,
                               max_levels=max_levels - K, planar=bs > 1)

        # RHS + owned masks on the finest level
        if b_global is None:
            b_global = _default_rhs(mesh, problem, bs, order)
        bg = np.asarray(b_global, dtype=np.float64).copy()
        bg[fine_bc.flat_dofs()] = 0.0
        b_local = bg[ids0]
        owned = np.ones(ids0.shape, dtype=bool)
        for (b0, _t, m) in levels[0].iface:
            owned[1:, b0: b0 + m] = False
        sol = cls(levels=levels, suffix=suffix,
                  b_local=torch.from_numpy(
                      b_local[rows].astype(np_dtype(dtype))).to(device),
                  owned=torch.from_numpy(owned[rows]).to(device), bs=bs, S=S,
                  comm=comm, rtol=rtol, maxit=maxit,
                  smoother_degree=smoother_degree, acc_dtype=acc_dtype)
        sol._ids0 = ids0
        sol._ndofs_global = FunctionSpace(mesh, order, bs=bs).ndofs
        return sol

    @classmethod
    def build_per_host(cls, mesh: BoxTetMesh, nshards: int,
                       problem: str = "poisson", order: int = 1,
                       dtype: torch.dtype = torch.float32,
                       rtol: float = 1e-8, maxit: int = 100,
                       precond: bool = True, coarse_limit: int = 1000,
                       smoother_degree: int = 2, max_levels: int = 12,
                       gather_limit: int = 100_000, *,
                       device: torch.device,
                       acc_dtype: Optional[torch.dtype] = None,
                       comm: Optional[ShardComm] = None
                       ) -> "ShardedCubeSolver":
        """Multi-process construction, all orders
        (tpufem/parallel/slab.py:302-466): the same solver as
        :meth:`build`, but every [L, nloc] array is built through
        ``multihost.make_sharded_rows`` ONLY for this process's shards,
        each from slab-local constructions (translation-invariant
        diagonal, z-independent Dirichlet markers, partial RHS plus one
        interface halo); no process holds a global array.  The
        replicated coarse suffix is built once a process."""
        from tpufem_torch.parallel.multihost import make_sharded_rows

        bs = 3 if problem == "elasticity" else 1
        marker = (common.elasticity_bc_marker if problem == "elasticity"
                  else common.poisson_bc_marker)
        S = nshards
        if mesh.Nz % S:
            raise ValueError(f"Nz={mesh.Nz} not divisible by {S} shards")
        comm = comm or ShardComm(S, device)
        chain, K, lmax_of, specs = cls._specs(
            mesh, S, bs, problem, marker, order, dtype, precond,
            coarse_limit, max_levels, gather_limit)

        dt = np_dtype(dtype)
        levels: List[_Level] = []
        for dims, kord in specs:
            nx, ny, nz = dims
            nzl = nz // S
            slab = BoxTetMesh(nx, ny, nzl)
            h_over = (1.0 / nx, 1.0 / ny, 1.0 / nz)
            op = _slab_operator(slab, kord, problem, dtype, device, h_over)
            lay_s = grid_layout(slab, kord)
            d_slab = _interleaved_diagonal(op)
            lspace = FunctionSpace(slab, kord, bs=bs)
            lbc = DirichletBC.from_space(
                lspace, slab.locate_boundary_facets(marker))
            lmask = np.zeros(lspace.ndofs, dtype=bool)
            lmask[lbc.flat_dofs()] = True
            nloc = lspace.ndofs

            def dinv_row(s, ds=d_slab, lay=lay_s, z=nzl):
                return _slab_dinv_row_k(ds, lay, z, bs, s, S).astype(dt)

            levels.append(_Level(
                op=op, dinv=make_sharded_rows(comm, (nloc,), dt, dinv_row),
                bc=make_sharded_rows(comm, (nloc,), np.bool_,
                                     lambda s, mm=lmask: mm),
                dims=dims, nzl=nzl, lmax=lmax_of[kord], order=kord,
                iface=iface_plan(lay_s, nzl, bs)))

        suffix = None
        if precond:
            suffix = GMG.setup(BoxTetMesh(*chain[K]), 1, problem, marker,
                               device, dtype=dtype, coarse_limit=coarse_limit,
                               smoother_degree=smoother_degree,
                               max_levels=max_levels - K, planar=bs > 1)

        nzl0 = chain[0][2] // S
        nloc0 = levels[0].dinv.shape[1]
        b_arr = make_sharded_rows(
            comm, (nloc0,), dt,
            lambda s: _slab_partial_rhs(mesh, problem, s, S, nzl0,
                                        order=order).astype(dt))

        def owned_row(s):
            o = np.ones(nloc0, dtype=bool)
            if s > 0:
                for (b0, _t, mm) in levels[0].iface:
                    o[b0: b0 + mm] = False
            return o

        owned = make_sharded_rows(comm, (nloc0,), np.bool_, owned_row)
        sol = cls(levels=levels, suffix=suffix,
                  b_local=torch.from_numpy(b_arr).to(device),
                  owned=torch.from_numpy(owned).to(device), bs=bs, S=S,
                  comm=comm, rtol=rtol, maxit=maxit,
                  smoother_degree=smoother_degree, acc_dtype=acc_dtype)
        # accumulate the interface partials onto their owners, zero the
        # Dirichlet rows, refresh the ghosts (tpufem's fix_b, :428-458);
        # interleaved slots: the plan is tpufem's own
        bot, top = (torch.from_numpy(v).to(device)
                    for v in _plan_slots(levels[0].iface, nloc0, 1))
        first = comm.local_mask([0])
        b = sol._halo_rev(sol.b_local, bot, top)
        b = b.masked_fill(torch.from_numpy(levels[0].bc).to(device), 0.0)
        sol.b_local = sol._halo_fwd(b, bot, top, first)
        sol._ids0, _ = slab_global_ids(mesh, order, nzl0, S, bs)
        sol._ndofs_global = FunctionSpace(mesh, order, bs=bs).ndofs
        return sol

    # -- the exchanges --------------------------------------------------------
    def _halo_rev(self, y: torch.Tensor, bot: torch.Tensor,
                  top: torch.Tensor) -> torch.Tensor:
        """Interface partial sums -> the owner below, accumulated: ONE
        exchange of the concatenated interface slices (row s's bottom
        slices added into row s - 1's top ones)."""
        down = [(s, s - 1) for s in range(1, self.S)]
        recv = self.comm.ppermute(y.index_select(1, bot), down)
        return y.index_add(1, top, recv)

    def _halo_fwd(self, y: torch.Tensor, bot: torch.Tensor,
                  top: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
        """Owner's interface values -> the ghosts above (row s - 1's top
        slices copied into row s's bottom ones; shard 0 keeps its own)."""
        up = [(s, s + 1) for s in range(self.S - 1)]
        recv = self.comm.ppermute(y.index_select(1, top), up)
        keep = torch.where(first[:, None], y.index_select(1, bot), recv)
        return y.index_copy(1, bot, keep)

    # -- the solve --------------------------------------------------------------
    def _device_levels(self):
        """Per level, the device state of the solve (planar for bs = 3):
        (op, dinv, bc, ghost mask, bottom / top interface slots,
        smoothers, and a P1 level's prepared h-transfers)."""
        got = self._cache.get("levels")
        if got is not None:
            return got
        dev, bs = self.comm.device, self.bs
        out = []
        for lv in self.levels:
            n = lv.dinv.shape[1]
            bot, top = _plan_slots(lv.iface, n, bs)
            # the ghost interface slices of every shard but the first
            ghost = np.zeros(lv.dinv.shape, dtype=bool)
            ghost[np.ix_(self.comm.local > 0, bot)] = True
            dinv = self._to_planar(torch.from_numpy(lv.dinv)).to(dev)
            bc = self._to_planar(torch.from_numpy(lv.bc)).to(dev)
            out.append(dict(op=lv.op, dinv=dinv, bc=bc,
                            ghost=torch.from_numpy(ghost).to(dev),
                            bot=torch.from_numpy(bot).to(dev),
                            top=torch.from_numpy(top).to(dev)))
            if lv.order == 1:
                # the h-transfers of the L slabs' bs grids, prepared once
                # (the slabs apply their own bc and ghost masks around them)
                (nx, ny, _nz), nzl = lv.dims, lv.nzl
                out[-1]["transfers"] = prepare_h_transfers(
                    dinv.shape[0] * bs, (nzl // 2 + 1, ny // 2 + 1,
                                         nx // 2 + 1), dinv.dtype, dev)
        first = self.comm.local_mask([0])
        for i, d in enumerate(out):
            d["action"] = self._make_action(d, first)
            mv, deg, lmax = d["action"], self.smoother_degree, \
                self.levels[i].lmax
            d["smooth"] = chebyshev_smoother(mv, d["dinv"], lmax, degree=deg)
            d["smooth0"] = chebyshev_smoother_zero(mv, d["dinv"], lmax,
                                                   degree=deg)
        self._cache["levels"] = (out, first)
        return out, first

    def _to_planar(self, v: torch.Tensor) -> torch.Tensor:
        if self.bs == 1:
            return v
        L = v.shape[0]
        return v.reshape(L, -1, self.bs).transpose(1, 2).reshape(L, -1)

    def _to_interleaved(self, v: torch.Tensor) -> torch.Tensor:
        if self.bs == 1:
            return v
        L = v.shape[0]
        return v.reshape(L, self.bs, -1).transpose(1, 2).reshape(L, -1)

    def _make_action(self, d, first):
        op, bc, bot, top = d["op"], d["bc"], d["bot"], d["top"]

        def action(x: torch.Tensor) -> torch.Tensor:
            y = torch.stack([op.apply(x[j]) for j in range(x.shape[0])])
            y = self._halo_rev(y, bot, top)
            y = y.masked_fill(bc, 0.0)
            return self._halo_fwd(y, bot, top, first)

        return action

    def _grid(self, i: int, v: torch.Tensor):
        lv = self.levels[i]
        (nx, ny, _nz), nzl = lv.dims, lv.nzl
        shape = (nzl + 1, ny + 1, nx + 1)
        lead = (v.shape[0],) + ((self.bs,) if self.bs > 1 else ())
        return v.reshape(lead + shape)

    def _vcycle(self, i: int, r: torch.Tensor) -> torch.Tensor:
        dls, first = self._device_levels()
        d = dls[i]
        lv = self.levels[i]
        L, bs = r.shape[0], self.bs
        K = len(self.levels)
        # residual-tracking pre-smoothing from zero (la.gmg.GMG.vcycle)
        x, rr = d["smooth0"](r)
        rr = rr.masked_fill(d["bc"], 0.0)
        # restrict OWNED dofs only (ghost interface slices zeroed); the
        # cross-interface contributions ride the coarse level's reverse
        # halo
        rr = rr.masked_fill(d["ghost"], 0.0)
        p_transfer = lv.order > 1
        lay = d["op"].layout
        if p_transfer:
            rin = rr.reshape(L, bs, -1) if bs > 1 else rr
            rc = restrict_p(rin, lay).reshape(L, -1)
        else:
            rc = d["transfers"][0](rr).reshape(L, -1)
        if i + 1 < K:
            dn = dls[i + 1]
            rc = self._halo_rev(rc, dn["bot"], dn["top"])
            rc = rc.masked_fill(dn["bc"], 0.0)
            rc = self._halo_fwd(rc, dn["bot"], dn["top"], first)
            ec = self._vcycle(i + 1, rc)
        else:
            ec = self._coarse(i, rc)
        if p_transfer:
            e = prolong_p(self._grid(i + 1, ec), lay).reshape(L, -1)
        else:
            e = d["transfers"][1](ec).reshape(L, -1)
        e = e.masked_fill(d["bc"], 0.0)
        return d["smooth"](x + e, r)

    def _coarse(self, i: int, rc: torch.Tensor) -> torch.Tensor:
        """Gather the coarse slabs, run the replicated suffix (once a
        process), and give each shard its planes of the correction."""
        lv = self.levels[i]
        (nx, ny, _nz), nzl = lv.dims, lv.nzl
        L, bs = rc.shape[0], self.bs
        cm = (nx // 2 + 1) * (ny // 2 + 1)
        planes = nzl // 2 + 1
        g = rc.reshape(L, bs, planes, cm)
        down = [(s, s - 1) for s in range(1, self.S)]
        top = g[:, :, -1] + self.comm.ppermute(g[:, :, 0].contiguous(), down)
        g = torch.cat([g[:, :, :-1], top[:, :, None]], dim=2)
        ag = self.comm.all_gather(g)                    # [S, bs, planes, cm]
        glob = torch.cat([ag[0], ag[1:, :, 1:].transpose(0, 1).reshape(
            bs, -1, cm)], dim=1).reshape(-1)
        bc0 = self.suffix._bc_mask_of(0)
        eg = self.suffix.vcycle(glob.masked_fill(bc0, 0.0))
        eg = eg.masked_fill(bc0, 0.0).reshape(bs, -1, cm)
        start = [int(s) * (nzl // 2) for s in self.comm.local]
        return torch.stack([eg[:, s0: s0 + planes] for s0 in start]
                           ).reshape(L, -1)

    def _dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Owned-masked dot: summed a shard, then across shards."""
        owned = self._cache.get("owned_p")
        if owned is None:
            owned = self._cache["owned_p"] = self._to_planar(self.owned)
        t = self.acc_dtype or u.dtype
        local = torch.where(owned, u.to(t) * v.to(t), 0.0).sum(dim=1)
        return self.comm.psum(local)

    def _run(self, b: torch.Tensor):
        """One solve of the stacked interleaved RHS ``b`` [L, nloc], a
        ``solve`` span: (x_loc [L, nloc] interleaved, iterations,
        ||r|| / ||r0||)."""
        dls, _ = self._device_levels()
        M = ((lambda r: self._vcycle(0, r)) if self.suffix is not None
             else None)
        with span("solve"):
            x, it, rel = cg_solve(dls[0]["action"], self._to_planar(b),
                                  precond=M, rtol=self.rtol,
                                  maxit=self.maxit, dot_fn=self._dot)
            return self._to_interleaved(x), it, rel

    def norm(self, x_loc: torch.Tensor) -> float:
        """The owned-masked global 2-norm of a solution (the reference's
        la::norm allreduce), float64 sums."""
        sq = torch.where(self.owned, x_loc.to(torch.float64) ** 2, 0.0)
        return float(torch.sqrt(self.comm.psum(sq.sum(dim=1))))

    # -- public API -------------------------------------------------------------
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
        """Global dof vector from the per-shard slabs (ghost interface
        copies overwrite with identical owner values — fwd invariant);
        this process must hold every shard."""
        if self.comm.nlocal != self.S:
            raise ValueError("collect needs every shard in this process; "
                             "use norm() across processes")
        if isinstance(x_loc, torch.Tensor):
            x_loc = x_loc.cpu().numpy()
        out = np.empty(self._ndofs_global, dtype=x_loc.dtype)
        for s in range(self.S):
            out[self._ids0[s]] = x_loc[s]
        return out


def _default_rhs(mesh: BoxTetMesh, problem: str, bs: int,
                 order: int = 1) -> np.ndarray:
    """Host f64 RHS for the benchmark problems (one-time setup)."""
    space = FunctionSpace(mesh, order, bs=bs)
    if problem == "elasticity":
        from tpufem_torch.problems.elasticity import \
            assemble_elasticity_rhs_np
        return assemble_elasticity_rhs_np(space)
    from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
    return assemble_poisson_rhs_np(space)


# ---------------------------------------------------------------------------
# Per-host (multi-process) builders.  Every quantity below is computed
# from SLAB-LOCAL data only (no global arrays), so each process builds
# nothing beyond the shards it holds (tpufem/parallel/slab.py:677-778).
# ---------------------------------------------------------------------------


def _slab_dinv_row(d_slab: np.ndarray, s: int, S: int, nzl: int) -> np.ndarray:
    """Shard s's [nzl+1, m] inverse-diagonal slab from ONE slab
    operator's raw diagonal: the stencil diagonal is z-translation-
    invariant, so interior planes repeat, global z-end planes keep the
    truncated value, and interface planes sum both halves."""
    g = d_slab.copy()
    if s > 0:
        g[0] = d_slab[0] + d_slab[nzl]
    if s < S - 1:
        g[nzl] = d_slab[0] + d_slab[nzl]
    return 1.0 / g


def _slab_dinv_row_k(d_flat: np.ndarray, lay_s, nzl: int, bs: int,
                     s: int, S: int) -> np.ndarray:
    """Order-general version of :func:`_slab_dinv_row`: the interface
    fix applies per dof KIND, to the kinds whose typed grid spans
    nzl+1 z-planes (dz = 0 kinds — only those have dofs ON the shared
    plane; dz = 1 kinds' dofs take contributions from their own layer's
    cells only, so the slab diagonal is already exact)."""
    g = d_flat.copy()
    for base, (X, Y, Z), sl in lay_s.kinds:
        if Z != nzl + 1:
            continue
        m = X * Y * sl * bs
        b0 = base * bs
        seg = g[b0: b0 + Z * m].reshape(Z, m)
        dsl = d_flat[b0: b0 + Z * m].reshape(Z, m)
        if s > 0:
            seg[0] = dsl[0] + dsl[nzl]
        if s < S - 1:
            seg[nzl] = dsl[0] + dsl[nzl]
    return 1.0 / g


def _slab_partial_rhs(mesh: BoxTetMesh, problem: str, s: int, S: int,
                      nzl: int, order: int = 1) -> np.ndarray:
    """Shard s's PARTIAL order-k RHS (volume term over the slab's own
    cells + surface term over the slab faces that lie on the GLOBAL
    boundary; interface-plane contributions stay partial and are
    accumulated by one reverse/forward halo at build)."""
    from tpufem_torch.fem.structured_op import dof_gids_for_cells
    from tpufem_torch.mesh.structured import CELL_VERTEX_OFFSETS, LOCAL_FACES
    from tpufem_torch.problems.poisson import _facet_rhs_np
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    slab = BoxTetMesh(Nx, Ny, nzl)
    space = FunctionSpace(slab, order)
    # dof coords in GLOBAL space: slab-normalized z -> (s*nzl + k)/Nz
    coords = space.scalar_dof_coords().copy()
    coords[:, 2] = (coords[:, 2] * nzl + s * nzl) / Nz
    # anisotropy: physical cube size is the GLOBAL h, not the slab's
    mass = StructuredOperator.build(slab, order, "mass",
                                    dtype=torch.float64,
                                    h_override=(1.0 / Nx, 1.0 / Ny,
                                                1.0 / Nz))
    if problem == "elasticity":
        comps = common.elasticity_f_components(coords[:, 0], coords[:, 1],
                                               coords[:, 2])
        return np.stack(
            [mass.apply_raw_np(np.ascontiguousarray(
                np.broadcast_to(c, coords.shape[:1]), dtype=np.float64))
             for c in comps], axis=-1).reshape(-1)
    b = mass.apply_raw_np(common.poisson_f(coords))
    # Poisson surface term g = sin(5 x0) over global-boundary faces of
    # the slab (x/y faces always; z faces only at the global ends)
    facets = slab.boundary_faces()
    cubes, perms, lf = slab.boundary_facet_cells(facets)
    cd_cells = dof_gids_for_cells(slab, order, cubes, perms)
    h = np.array([1.0 / Nx, 1.0 / Ny, 1.0 / Nz])
    verts = (cubes[:, None, :] + CELL_VERTEX_OFFSETS[perms]).astype(
        np.float64)
    verts[:, :, 2] += s * nzl
    verts = verts * h
    tri = np.take_along_axis(verts, LOCAL_FACES[lf][:, :, None], axis=1)
    # keep only faces on the GLOBAL boundary: z-interface planes of the
    # slab are interior to the global cube (their facet integral belongs
    # to no one)
    lo = s * nzl / Nz
    hi = (s + 1) * nzl / Nz
    keep = np.ones(len(lf), dtype=bool)
    if s > 0:
        keep &= ~(np.abs(tri[:, :, 2] - lo) < 1e-12).all(axis=1)
    if s < S - 1:
        keep &= ~(np.abs(tri[:, :, 2] - hi) < 1e-12).all(axis=1)
    gdof = common.poisson_g(coords)
    b += _facet_rhs_np(space.element, gdof[cd_cells[keep]], cd_cells[keep],
                       tri[keep], lf[keep], space.ndofs_scalar)
    return b
