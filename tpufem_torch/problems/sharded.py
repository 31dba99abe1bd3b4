"""Sharded problem constructors (counterpart of
tpufem/problems/sharded.py): what the CLI runs for ``--num_shards`` > 1.

- ``problem``: the cube on z-slabs (parallel.slab): poisson / elasticity
  as CG + distributed geometric multigrid to ksp_rtol, cgpoisson as
  unpreconditioned CG, kmax = 100 and rtol = 1e-6, with the Gdof/s
  metric;
- ``problem_rowshard``: the row-sharded assembled path
  (parallel.rowshard): unstructured meshes, and cubes too small for a
  sharded multigrid chain; CG + SA-AMG (cgpoisson unpreconditioned).

Under several processes (parallel.multihost) every process builds only
its shards (the slab path's per-host build) and the solve reports the
owned-masked norm through the collective instead of collecting x
(``solution_norm``).  The sharded paths certify nothing, as tpufem's.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from tpufem_torch.config import Config
from tpufem_torch.fem.dia_op import DiaOperator, np_dtype
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import StructuredOperator
from tpufem_torch.parallel.comm import ShardComm
from tpufem_torch.problems import common
from tpufem_torch.timing import Timer

logger = logging.getLogger("tpufem_torch")

# perturbed-RHS solves timed after the first (tpufem's solve_timed(reps=3))
TIMING_REPS = 3


class ShardedSolve:
    """``(u0, rhs) -> (x, iterations)`` of a sharded solver ``sh`` (the
    RHS is the solver's own, built with it): the first solve, then
    ``TIMING_REPS`` timed ones.  Keeps ``iterations``, ``rel``,
    ``solve_s``, ``gdofs`` (cgpoisson) and, across processes,
    ``solution_norm``."""

    def __init__(self, sh, ndofs: int, acc_dtype: torch.dtype,
                 matfree: bool) -> None:
        self.sh, self.ndofs, self.acc_dtype = sh, ndofs, acc_dtype
        self.matfree = matfree
        self.rel: Optional[float] = None
        self.solve_s: Optional[float] = None
        self.gdofs: Optional[float] = None
        self.solution_norm: Optional[float] = None

    def __call__(self, u0, rhs) -> Tuple[torch.Tensor, int]:
        sh = self.sh
        x_loc, it, rel, dt = sh.run_timed(TIMING_REPS)
        if sh.comm.nlocal != sh.S:
            # across processes x stays sharded: the owned-masked norm
            # through the collective (the reference's la::norm allreduce)
            self.solution_norm = sh.norm(x_loc)
            x = x_loc
        else:
            x = torch.from_numpy(sh.collect(x_loc)).to(sh.comm.device)
        self.rel, self.solve_s = rel, dt
        if self.matfree:
            self.gdofs = it * self.ndofs / dt / 1e9
            print(f"CG matrix-free action processed: {self.gdofs} Gdof/s",
                  flush=True)
        return x, it


def _global_rhs(space: FunctionSpace, bc, problem_name: str,
                dtype: torch.dtype, device: torch.device) -> np.ndarray:
    """Global RHS as a host vector: assembled on the device for float32
    (the mass-operator applies, read back), on the host in float64
    otherwise (tpufem/problems/sharded.py:33-49)."""
    if dtype == torch.float32:
        mesh, order = space.mesh, space.order
        mass = (DiaOperator.build(mesh, 1, "mass", dtype=dtype, device=device)
                if order == 1 else
                StructuredOperator.build(mesh, order, "mass", dtype=dtype,
                                         device=device))
        if problem_name == "elasticity":
            from tpufem_torch.problems.elasticity import (
                assemble_elasticity_rhs_pk_dev,
                assemble_elasticity_rhs_structured_dev)
            rhs = (assemble_elasticity_rhs_structured_dev if order == 1
                   else assemble_elasticity_rhs_pk_dev)
        else:
            from tpufem_torch.problems.poisson import \
                assemble_poisson_rhs_structured_dev as rhs
        return rhs(space, bc, mass).cpu().numpy()
    if problem_name == "elasticity":
        from tpufem_torch.problems.elasticity import \
            assemble_elasticity_rhs_np
        return assemble_elasticity_rhs_np(space)
    from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
    return assemble_poisson_rhs_np(space)


def _resolve_sharded_precond(solver, forced_name: str) -> bool:
    """Honor ``-pc_type none`` on the sharded paths; any other explicit
    choice is overridden by the path's multigrid and logged (the serial
    path honors jacobi etc. — the distributed programs implement only
    their multigrid and unpreconditioned CG)
    (tpufem/problems/sharded.py:175-188).  The cube's ``amg`` runs the
    slabs' geometric multigrid, as tpufem's does; the port says so."""
    pc_type = solver.get("pc_type")
    if pc_type == "none":
        return False
    if pc_type == "amg" and forced_name == "geometric multigrid":
        logger.info("sharded cube path: '-pc_type amg' runs the slabs' "
                    "geometric multigrid (as tpufem's sharded path does)")
    elif pc_type not in ("auto", "amg", "gmg"):
        logger.warning(
            "sharded path ignores '-pc_type %s' and uses %s "
            "(only 'none' is honored here)", pc_type, forced_name)
    return True


def _solver_args(cfg: Config, matfree: bool, forced: str):
    """(rtol, maxit, precond) of the sharded solve."""
    solver = cfg.solver
    if matfree:
        solver._consumed.update(("cg_rtol", "cg_kmax"))
        return (float(solver.extra.get("cg_rtol", 1e-6)),
                int(solver.extra.get("cg_kmax", 100)), False)
    return (float(solver.get("ksp_rtol")), int(solver.get("ksp_max_it")),
            _resolve_sharded_precond(solver, forced))


def problem_rowshard(mesh, order: int, cfg: Config, problem_name: str,
                     num_shards: int, device: torch.device
                     ) -> common.Problem:
    """Row-sharded assembled path (unstructured meshes; cubes too small
    for slabs): distributed CG + SA-AMG with a sharded fine level
    (tpufem/problems/sharded.py:51-173).  ``cgpoisson`` runs the same
    operator unpreconditioned to cg_rtol / cg_kmax with the Gdof/s
    metric: on the BC-zero subspace the eliminated operator's Krylov
    trajectory equals the rows-zero matrix-free action's."""
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.parallel.rowshard import ShardedEllSolver

    dtype, acc_dtype = common.resolve_dtype(cfg)
    matfree = problem_name == "cgpoisson"
    base = "poisson" if matfree else problem_name
    bs = 3 if problem_name == "elasticity" else 1
    marker = (common.elasticity_bc_marker if problem_name == "elasticity"
              else common.poisson_bc_marker)

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order, bs=bs)
        _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(marker)
        bc = DirichletBC.from_space(space, facets)

    with Timer("ZZZ Assemble matrix"):
        if isinstance(mesh, BoxTetMesh):
            # the stencil's CSR export skips the O(cells) host element
            # assembly (equal matrices: tests/test_dia_op.py)
            M = DiaOperator.build(mesh, order, base, bc_dofs=bc.flat_dofs(),
                                  dtype=torch.float64).to_scipy()
            csr = (M.indptr, M.indices, M.data)
        else:
            csr = assemble_csr_np(space, bc, base)

    with Timer("ZZZ Assemble vector"):
        if problem_name == "elasticity":
            from tpufem_torch.problems.elasticity import \
                assemble_elasticity_rhs_np
            b_np = assemble_elasticity_rhs_np(space)
        else:
            from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
            b_np = assemble_poisson_rhs_np(space)
        b_np[bc.flat_dofs()] = 0.0 if matfree else bc.value

    # pure-Neumann deflation (the spoke mesh has no Dirichlet facets)
    deflate = (problem_name == "poisson"
               and np.asarray(bc.flat_dofs()).size == 0)
    if deflate:
        b_np = b_np - b_np.mean()

    nns = None
    if problem_name == "elasticity":
        from tpufem_torch.la.nullspace import build_near_nullspace
        with Timer("ZZZ Create near-nullspace"):
            nns = build_near_nullspace(space.scalar_dof_coords())

    rtol, maxit, precond = _solver_args(cfg, matfree, "SA-AMG")
    with Timer("ZZZ Solver setup", device):
        sh = ShardedEllSolver.build(
            space, bc, csr, b_np, num_shards, cfg.solver, dtype=dtype,
            near_nullspace=nns, rtol=rtol, maxit=maxit, precond=precond,
            deflate=deflate, device=device, acc_dtype=acc_dtype,
            comm=ShardComm(num_shards, device))

    solve = ShardedSolve(sh, space.ndofs, acc_dtype, matfree)
    if sh.comm.nlocal != num_shards:
        return common.Problem(b=None, u=None, solver_function=solve,
                              space=space, bc=bc, near_nullspace=nns)
    return common.Problem(
        b=torch.from_numpy(b_np.astype(np_dtype(dtype))).to(device),
        u=torch.zeros(space.ndofs, dtype=dtype, device=device),
        solver_function=solve, space=space, bc=bc, near_nullspace=nns)


def problem(mesh, order: int, cfg: Config, problem_name: str,
            num_shards: int, device: torch.device) -> common.Problem:
    """The cube on z-slabs (tpufem/problems/sharded.py:191-296)."""
    from tpufem_torch.parallel.slab import ShardedCubeSolver

    dtype, acc_dtype = common.resolve_dtype(cfg)
    bs = 3 if problem_name == "elasticity" else 1
    matfree = problem_name == "cgpoisson"
    base = "poisson" if matfree else problem_name
    marker = (common.elasticity_bc_marker if problem_name == "elasticity"
              else common.poisson_bc_marker)
    solver = cfg.solver
    comm = ShardComm(num_shards, device)
    multiproc = comm.nlocal != num_shards

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order, bs=bs)

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(marker)
        bc = DirichletBC.from_space(space, facets)

    with Timer("ZZZ Assemble vector", device):
        # across processes each builds its slabs' partial RHS inside
        # build_per_host (no process holds a global vector)
        b_global = None if multiproc else _global_rhs(space, bc, base,
                                                      dtype, device)

    rtol, maxit, precond = _solver_args(cfg, matfree, "geometric multigrid")
    kw = dict(problem=base, order=order, dtype=dtype, rtol=rtol,
              maxit=maxit, precond=precond,
              coarse_limit=int(solver.get("amg_coarse_eq_limit")),
              smoother_degree=int(solver.get("amg_smoother_degree")),
              max_levels=int(solver.get("amg_max_levels")),
              device=device, acc_dtype=acc_dtype, comm=comm)
    with Timer("ZZZ Assemble matrix", device):
        if multiproc:
            sh = ShardedCubeSolver.build_per_host(mesh, num_shards, **kw)
        else:
            sh = ShardedCubeSolver.build(mesh, num_shards, b_global=b_global,
                                         **kw)

    solve = ShardedSolve(sh, space.ndofs, acc_dtype, matfree)
    if multiproc:
        return common.Problem(b=None, u=None, solver_function=solve,
                              space=space, bc=bc)
    bg = b_global.copy()
    bg[bc.flat_dofs()] = 0.0 if matfree else bc.value
    return common.Problem(b=torch.from_numpy(bg.astype(np_dtype(dtype))
                                             ).to(device),
                          u=torch.zeros(space.ndofs, dtype=dtype,
                                        device=device),
                          solver_function=solve, space=space, bc=bc)
