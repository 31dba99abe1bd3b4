"""Assembled-matrix Poisson problem (counterpart of
tpufem/problems/poisson.py): the structured cube mesh (:517-581) and the
unstructured spoke mesh at P1 (:320-386, :562-575).

P1-P3 GLL-warped Lagrange space; Dirichlet u = 0 on x0 in {0, 1}; RHS
f = Gaussian bump (volume) + g = sin(5 x0) (surface).  On the cube the
operator is the BC-eliminated structured operator of ``build_operator``
(the P1 DIA stencil, the P2/P3 multi-kind DIA, or the per-perm
StructuredOperator on lattices too small for it); on an unstructured
mesh it is the assembled CSR (fem.assemble, a ``CsrMatrix`` on the
device).  The solver is CG preconditioned by geometric multigrid (at
order k > 1 with a p-transfer to P1 below the fine level), lattice-brick
AMG (``-pc_type amg`` at P1), tpufem's generic SA-AMG (la.amg: the cube
under ``-amg_brick off``, at order k > 1 and where GMG cannot coarsen
the lattice, with the structured operator as its fine action; every
unstructured mesh, on assembled CSR transfers), Jacobi or nothing, and a
float32 solve is certified against a float64 host twin of the system
with iterative refinement.

The spoke mesh has no Dirichlet plane (pure Neumann): the RHS is made
compatible and the constant nullspace deflated (tpufem/problems/
poisson.py:262-276, 420-422).  Where tpufem's window form of the fine
operator fits its byte budget (fem.window_op), the solve runs in the
reverse Cuthill-McKee order of the matrix, as tpufem's does.

On the cube the float32 RHS is assembled on the device: the volume term
is ONE mass-operator apply (P1: of the closed-form f), plus the
O(surface) host facet term.  Float64 runs and unstructured meshes
assemble the RHS on the host.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.config import Config
from tpufem_torch.fem.assemble import assemble_operator, detJ_np
from tpufem_torch.fem.dia_op import DiaOperator, build_operator, np_dtype
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import (StructuredOperator,
                                            dof_gids_for_cells)
from tpufem_torch.la.cg import cg_solve
from tpufem_torch.la.refine import Certifier
from tpufem_torch.mesh.structured import CELL_VERTEX_OFFSETS, LOCAL_FACES
from tpufem_torch.mesh.topology import TetTopology
from tpufem_torch.problems import common
from tpufem_torch.timing import Timer, span

logger = logging.getLogger("tpufem_torch")


def _facet_rhs_structured_np(space: FunctionSpace) -> np.ndarray:
    """Host O(surface) boundary term of L on a BoxTetMesh, from the
    closed-form facet -> cell table."""
    mesh = space.mesh
    facets = mesh.boundary_faces()
    cubes, perms, lf = mesh.boundary_facet_cells(facets)
    cd_cells = dof_gids_for_cells(mesh, space.order, cubes, perms)
    h = np.array([1.0 / mesh.Nx, 1.0 / mesh.Ny, 1.0 / mesh.Nz])
    verts = (cubes[:, None, :] + CELL_VERTEX_OFFSETS[perms]) * h
    tri = np.take_along_axis(verts, LOCAL_FACES[lf][:, :, None], axis=1)
    area2 = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                    tri[:, 2] - tri[:, 0]), axis=-1)
    W = space.element.facet_mass_tensors[lf] * area2[:, None, None]
    if space.order == 1:
        # g only at the facet vertices (their gids decode to coords)
        g_cells = common.poisson_g(
            mesh.vertex_coords(cd_cells.reshape(-1))).reshape(cd_cells.shape)
    else:
        g_cells = space.interpolate(common.poisson_g)[cd_cells]
    contrib = np.einsum("fij,fj->fi", W, g_cells)
    return np.bincount(cd_cells.reshape(-1), weights=contrib.reshape(-1),
                       minlength=space.ndofs_scalar)


def assemble_poisson_rhs_structured_dev(space: FunctionSpace,
                                        bc: DirichletBC, mass) -> torch.Tensor:
    """Device RHS: one apply of the device mass operator ``mass`` (no
    BC), the host facet term, and the BC values set.  P1 (``mass`` a
    DiaOperator): f evaluated on the device from coordinates (it varies
    only in (x, y)), the facet term added at its nonzero dofs.  P2/P3
    (``mass`` a StructuredOperator): f interpolated on the host, as
    tpufem/problems/poisson.py:145-159 does."""
    mesh = space.mesh
    b_facet = _facet_rhs_structured_np(space)
    if space.order != 1:
        dtype, device = mass.A_dev.dtype, mass.A_dev.device
        nd = np_dtype(dtype)
        f = torch.from_numpy(
            space.interpolate(common.poisson_f).astype(nd)).to(device)
        b = mass.apply_raw(f) + torch.from_numpy(b_facet.astype(nd)).to(device)
        return b.index_fill(0, torch.from_numpy(bc.flat_dofs()).to(device),
                            bc.value)
    dtype, device = mass.fields.dtype, mass.fields.device
    fnz = np.flatnonzero(b_facet != 0.0)
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    x = torch.arange(Nx + 1, dtype=dtype, device=device) / Nx
    y = torch.arange(Ny + 1, dtype=dtype, device=device) / Ny
    f2d = common.poisson_f_xy(x[None, :], y[:, None], torch)
    fd = f2d.expand(Nz + 1, Ny + 1, Nx + 1).reshape(-1)
    b = mass.apply(fd)
    b = b.index_add(0, torch.from_numpy(fnz).to(device),
                    torch.from_numpy(b_facet[fnz].astype(np_dtype(dtype))).to(device))
    return b.index_fill(0, torch.from_numpy(bc.flat_dofs()).to(device),
                        bc.value)


def _facet_rhs_np(el, g_cells: np.ndarray, cd_cells: np.ndarray,
                  tri: np.ndarray, lf: np.ndarray, ndofs: int) -> np.ndarray:
    """Boundary term of L: sum over facets of 2 area S_lf @ g_cell
    (tpufem/problems/poisson.py:162-172)."""
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    S = el.facet_mass_tensors[lf]  # [F, n, n]
    contrib = np.einsum("fij,fj->fi", S, g_cells) * area2[:, None]
    return np.bincount(cd_cells.reshape(-1), weights=contrib.reshape(-1),
                       minlength=ndofs)


def assemble_poisson_rhs_np(space: FunctionSpace) -> np.ndarray:
    """Host float64 RHS: mass apply of the interpolated f plus the facet
    term (no BC values).  Cube: the P1 mass stencil, or for P2/P3
    tpufem's per-perm host apply; an unstructured mesh: the cell mass
    tensors and the facet term over its boundary faces
    (tpufem/problems/poisson.py:175-205)."""
    f = space.interpolate(common.poisson_f)
    mesh = space.mesh
    if isinstance(mesh, TetTopology):
        el = space.element
        g = space.interpolate(common.poisson_g)
        cd = space.cell_dofs
        coords = mesh.cell_coords()
        adet = detJ_np(coords)
        b_cells = (f[cd] @ el.mass_tensor.T) * adet[:, None]
        b = np.bincount(cd.reshape(-1), weights=b_cells.reshape(-1),
                        minlength=space.ndofs_scalar)
        cells, lf = common.facet_to_cell(mesh.cell_faces(),
                                         mesh.boundary_faces())
        tri = np.take_along_axis(coords[cells], LOCAL_FACES[lf][:, :, None],
                                 axis=1)
        return b + _facet_rhs_np(el, g[cd[cells]], cd[cells], tri, lf,
                                 space.ndofs_scalar)
    if space.order == 1:
        mass = DiaOperator.build(space.mesh, 1, "mass", dtype=torch.float64)
        vol = mass.apply_np(f)
    else:
        mass = StructuredOperator.build(space.mesh, space.order, "mass",
                                        dtype=torch.float64)
        vol = mass.apply_raw_np(f)
    return vol + _facet_rhs_structured_np(space)


class Solver:
    """The CG solve of one assembled system, ``(u0, rhs) -> (x, its)``,
    of Poisson or elasticity (``problem``, with its Dirichlet marker
    ``bc_marker`` for the multigrid levels; the AMG setups take the
    ``near_nullspace`` and the interleaved Dirichlet ``bc_mask``).

    ``planar``: A runs in the component-planar bs = 3 layout while u0,
    rhs and x keep the reference's interleaved one; a solve converts in
    and out once (tpufem/problems/poisson.py:408-413, 433-434).  On an
    unstructured mesh A is the assembled ``CsrMatrix`` and ``csr`` its
    host triplets, which SA-AMG coarsens; ``deflate`` projects out the
    constant nullspace of a pure-Neumann system
    (tpufem/problems/poisson.py:262-276, 420-422).  The preconditioner
    is built inside the first call (PETSc's PCSetUp-in-KSPSolve, timed as
    "ZZZ PC setup").  With ``fidelity``, a lazy ``() -> (apply64, b64)``
    float64 host twin of the system, every solve of the canonical RHS is
    certified: the true relative residual is measured in f64, and
    float32 solves are refined until it meets ksp_rtol.  The last
    solve's certification is kept in ``true_rel``, ``refine_passes``,
    ``refine_iterations`` and ``certify_s``."""

    def __init__(self, A, mesh, order: int,
                 cfg: Config, dtype: torch.dtype, acc_dtype: torch.dtype,
                 device: torch.device,
                 fidelity: Optional[Callable[[], Tuple]] = None,
                 problem: str = "poisson",
                 bc_marker: Callable = common.poisson_bc_marker,
                 planar: bool = False,
                 near_nullspace: Optional[np.ndarray] = None,
                 bc_mask: Optional[np.ndarray] = None,
                 csr: Optional[Tuple] = None,
                 deflate: bool = False) -> None:
        self.A, self.mesh, self.order = A, mesh, order
        self.problem, self.bc_marker, self.planar = problem, bc_marker, planar
        self.near_nullspace, self.bc_mask = near_nullspace, bc_mask
        self.csr, self.deflate = csr, deflate
        # the cube unless an unstructured TetTopology (tests pass tpufem's
        # own BoxTetMesh, which the port cannot import)
        self.structured = not isinstance(mesh, TetTopology)
        self.solver = cfg.solver
        self.dtype, self.acc_dtype, self.device = dtype, acc_dtype, device
        self.fidelity = fidelity
        self.rtol = float(self.solver.get("ksp_rtol"))
        self.maxit = int(self.solver.get("ksp_max_it"))
        self.nonzero_guess = bool(self.solver.get("ksp_initial_guess_nonzero",
                                                  False))
        pc_type = self.solver.get("pc_type")
        # what serves after the first solve: "gmg", "brick-amg", "amg"
        # (SA-AMG), "jacobi", or any other name, which runs CG
        # unpreconditioned (tpufem's make_solver,
        # tpufem/problems/poisson.py:282-395)
        if pc_type == "auto":
            pc_type = "gmg" if self.structured else "amg"
        self.pc_type = pc_type
        # CG's operator: A, or on tpufem's RCM route A permuted (``perm``:
        # permuted <- original)
        self.op = A
        self.perm: Optional[torch.Tensor] = None
        self.iperm: Optional[torch.Tensor] = None
        self.route: Optional[str] = None  # SA-AMG: "factored", "rcm", "plain"
        self.precond = None
        self.pc = None
        self._ready = False
        self.certifier: Optional[Certifier] = None
        self.pc_setup_s: Optional[float] = None
        self.true_rel: Optional[float] = None
        self.refine_passes = 0
        self.refine_iterations = 0
        self.certify_s: Optional[float] = None

    def _matvec(self, op) -> Callable:
        return op.apply if self.structured else op.matvec

    def _setup(self) -> None:
        with Timer("ZZZ PC setup", self.device) as t:
            if self.pc_type == "gmg":
                if not self.structured:
                    raise ValueError("gmg requires a structured cube mesh")
                from tpufem_torch.la.gmg import GMG
                try:
                    self.pc = GMG.setup(
                        self.mesh, self.order, self.problem, self.bc_marker,
                        self.device, dtype=self.dtype,
                        coarse_limit=int(self.solver.get("amg_coarse_eq_limit")),
                        smoother_degree=int(self.solver.get("amg_smoother_degree")),
                        planar=self.planar)
                    self.precond = self.pc.vcycle
                except ValueError:
                    # lattice dims not 2^L-divisible: geometric coarsening
                    # is impossible, and tpufem goes to algebraic multigrid
                    self.pc_type = "amg"
            if self.pc_type == "amg" and self.structured:
                from tpufem_torch.la.bramg import BrickAMG, brick_viable
                if brick_viable(self.mesh, self.order, self.solver):
                    self.pc = BrickAMG.setup(
                        self.A, self.mesh, self.A.bs, self.solver,
                        dtype=self.dtype, near_nullspace=self.near_nullspace,
                        bc_mask=self.bc_mask)
                    self.precond = self.pc.as_preconditioner(self.A.apply)
                    self.pc_type = "brick-amg"
            if self.pc_type == "amg":
                self._setup_saamg()
            elif self.pc_type == "jacobi":
                npdt = np_dtype(self.dtype)
                if self.structured:
                    dinv = torch.from_numpy(
                        (1.0 / self.A.diagonal_np()).astype(npdt))
                else:
                    import scipy.sparse as sp
                    d = sp.csr_matrix((self.csr[2], self.csr[1],
                                       self.csr[0])).diagonal()
                    dinv = 1.0 / torch.from_numpy(d.astype(npdt))
                self.pc = dinv.to(self.device)
                self.precond = lambda r: self.pc * r
        self.pc_setup_s = t.elapsed
        self._ready = True

    def _setup_saamg(self) -> None:
        """tpufem's generic SA-AMG (tpufem/problems/poisson.py:323-386).
        The cube: the hierarchy of the structured operator's CSR export
        with factored fine transfers, the operator itself as the fine
        action.  An unstructured mesh: assembled transfers, on tpufem's
        RCM route (the window gate) or its plain route."""
        from tpufem_torch.fem.csr_spmv import CsrMatrix
        from tpufem_torch.fem.window_op import window_gate
        from tpufem_torch.la.amg import SAAMG
        bs = 3 if self.problem == "elasticity" else 1
        if self.structured:
            if not hasattr(self.A, "to_scipy"):
                # tpufem fails here too: its make_solver exports the CSR
                # with A.to_scipy(), which StructuredOperator lacks
                # (tpufem/problems/poisson.py:329)
                raise NotImplementedError(
                    f"-pc_type amg on the order-{self.order} "
                    f"{type(self.A).__name__}: tpufem has no such path "
                    "(its SA-AMG exports the CSR by to_scipy(), which "
                    "its StructuredOperator lacks: AttributeError at "
                    "tpufem/problems/poisson.py:329)")
            M = self.A.to_scipy()
            self.pc = SAAMG.setup(
                (M.indptr, M.indices, M.data), bs, self.solver, self.device,
                dtype=self.dtype, near_nullspace=self.near_nullspace,
                bc_mask=self.bc_mask, fine_factored=True, planar=self.planar)
            self.precond = self.pc.as_preconditioner(self.A.apply)
            self.route = "factored"
            return
        gate = window_gate(self.csr, str(self.solver.get("amg_fine_window")),
                           int(self.solver.get("amg_window_budget_mb")),
                           torch.finfo(self.dtype).bits // 8)
        if gate is None:
            self.pc = SAAMG.setup(
                self.csr, bs, self.solver, self.device, dtype=self.dtype,
                near_nullspace=self.near_nullspace, bc_mask=self.bc_mask)
            self.precond = self.pc.as_preconditioner()
            self.route = "plain"
            return
        # tpufem's RCM route: CG and the hierarchy run on the permuted
        # matrix, the V-cycle's fine applies on a bf16-valued twin under
        # -amg_window_bf16 on (float32 solves), CG's own product exact
        perm, csr_w = gate
        nns = self.near_nullspace
        self.pc = SAAMG.setup(
            csr_w, bs, self.solver, self.device, dtype=self.dtype,
            near_nullspace=nns[:, perm] if nns is not None else None,
            bc_mask=self.bc_mask[perm] if self.bc_mask is not None else None,
            fine_factored=False, fine_store_a=False,
            fine_transfer_window=True)
        self.op = CsrMatrix.from_csr(*csr_w, self.dtype, self.device)
        fine = self.op
        if (self.dtype == torch.float32
                and str(self.solver.get("amg_window_bf16")) == "on"):
            fine = self.op.astype(torch.bfloat16)
        self.precond = self.pc.as_preconditioner(fine.matvec)
        ip = np.empty_like(perm)
        ip[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
        self.perm = torch.from_numpy(perm).to(self.device)
        self.iperm = torch.from_numpy(ip).to(self.device)
        self.route = "rcm"

    def run(self, x0: torch.Tensor, rhs: torch.Tensor):
        """The uncertified solve, a ``solve`` span: (x, iterations,
        recurrence rel)."""
        with span("solve"):
            if not self._ready:
                self._setup()
            if self.planar:
                with span("solve.layout"):
                    x0, rhs = (v.reshape(-1, 3).T.contiguous().reshape(-1)
                               for v in (x0, rhs))
            if self.perm is not None:
                x0, rhs = x0[self.perm], rhs[self.perm]
            precond = self.precond
            if self.deflate:
                demean = lambda v: v - v.mean()
                rhs = demean(rhs)
                precond = ((lambda r, _M=precond: demean(_M(r)))
                           if precond is not None else demean)
            x, it, rel = cg_solve(self._matvec(self.op), rhs,
                                  x0=x0 if self.nonzero_guess else None,
                                  precond=precond, rtol=self.rtol,
                                  maxit=self.maxit, acc_dtype=self.acc_dtype)
            if self.deflate:
                x = x - x.mean()
            if self.perm is not None:
                x = x[self.iperm]
            if self.planar:
                with span("solve.layout"):
                    x = x.reshape(3, -1).T.contiguous().reshape(-1)
            return x, it, rel

    def __call__(self, u0: torch.Tensor,
                 rhs: torch.Tensor) -> Tuple[torch.Tensor, int]:
        x, it, rel = self.run(u0, rhs)
        if (self.fidelity is not None
                and str(self.solver.get("ksp_true_residual")) != "off"):
            x = self._certify(x, rhs, rel)
        return x, it

    def _certify(self, x: torch.Tensor, rhs: torch.Tensor,
                 rel: float) -> torch.Tensor:
        """True-residual check + mixed-precision refinement against the
        f64 host twin; returns the (possibly refined) solution."""
        if self.certifier is None:
            with Timer("ZZZ True residual setup"):
                apply64, b64 = self.fidelity()
                self.certifier = Certifier(apply64, b64, self.rtol)
        cert = self.certifier
        # the twin is the problem's canonical RHS; a caller-perturbed rhs
        # is not certified
        rhs64 = rhs.cpu().numpy().astype(np.float64)
        bn = cert.bnorm if cert.bnorm > 0.0 else 1.0
        if abs(float(np.linalg.norm(rhs64)) - cert.bnorm) > 1e-4 * bn:
            self.true_rel = None
            return x
        converged = rel <= self.rtol
        # refinement also engages after solid progress short of rtol
        progressed = rel <= 1e-3
        is_f32 = self.dtype == torch.float32
        max_passes = (int(self.solver.get("ksp_refine_max"))
                      if (is_f32 and (converged or progressed)) else 0)
        zeros = torch.zeros_like(rhs)
        npdtype = np_dtype(self.dtype)

        def corr(r64):
            # unit-normalise the correction RHS: by the 2nd-3rd pass ||r||
            # can reach ~1e-17 ||b||, and the f32 recurrence squares it to
            # an underflow (beta = 0/0 = NaN); the solve is linear, so
            # scale out and back
            s = float(np.linalg.norm(r64))
            if not np.isfinite(s) or s == 0.0:
                return np.zeros_like(r64), 0
            r_dev = torch.from_numpy((r64 / s).astype(npdtype)).to(self.device)
            d, it_, _ = self.run(zeros, r_dev)
            return d.cpu().numpy().astype(np.float64) * s, it_

        res = cert.certify(x.cpu().numpy(), corr if max_passes else None,
                           max_passes=max_passes)
        if res.passes:
            x = torch.from_numpy(res.x64.astype(npdtype)).to(self.device)
        self.true_rel = res.true_rel
        self.refine_passes = res.passes
        self.refine_iterations = res.extra_iterations
        self.certify_s = res.seconds
        return x


def problem(mesh, order: int, cfg: Config,
            device: torch.device) -> common.Problem:
    dtype, acc_dtype = common.resolve_dtype(cfg)
    structured = not isinstance(mesh, TetTopology)

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order)
        if not structured:
            _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(common.poisson_bc_marker)
        bc = DirichletBC.from_space(space, facets)

    if not structured:
        return _problem_unstructured(mesh, order, cfg, device, space, bc,
                                     dtype, acc_dtype)

    with Timer("ZZZ Assemble matrix", device):
        # the DIA stencil IS the BC-eliminated assembled matrix
        A = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                           dtype=dtype, device=device)

    mass = None
    with Timer("ZZZ Assemble vector", device):
        if dtype == torch.float32:
            if order == 1:
                mass = DiaOperator.build(mesh, 1, "mass", dtype=dtype,
                                         device=device)
            else:
                mass = StructuredOperator.build(mesh, order, "mass",
                                                dtype=dtype, device=device)
            b = assemble_poisson_rhs_structured_dev(space, bc, mass)
        else:
            b_np = assemble_poisson_rhs_np(space)
            b_np[bc.flat_dofs()] = bc.value  # apply_lifting is zero (u0 = 0)
            b = torch.from_numpy(b_np.astype(np_dtype(dtype))).to(device)

    def fidelity():
        """float64 host twin of the assembled system (la.refine)."""
        A64 = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                             dtype=torch.float64)
        b64 = assemble_poisson_rhs_np(space)
        b64[bc.flat_dofs()] = bc.value
        return A64.apply_np, b64

    u = torch.zeros(space.ndofs, dtype=dtype, device=device)
    solver = Solver(A, mesh, order, cfg, dtype, acc_dtype, device,
                    fidelity=fidelity, bc_mask=bc.mask())
    return common.Problem(b=b, u=u, solver_function=solver, space=space, bc=bc,
                          rhs_op=mass)


def _problem_unstructured(mesh, order: int, cfg: Config,
                          device: torch.device, space: FunctionSpace,
                          bc: DirichletBC, dtype: torch.dtype,
                          acc_dtype: torch.dtype) -> common.Problem:
    """The assembled CSR system of an unstructured mesh, its host float64
    RHS and the CSR certification twin (tpufem/problems/poisson.py:
    531-575)."""
    with Timer("ZZZ Assemble matrix", device):
        A, csr = assemble_operator(space, bc, "poisson", dtype, device)

    pure_neumann = bc.flat_dofs().size == 0
    if pure_neumann:
        logger.info("no Dirichlet dofs (pure-Neumann): deflating the "
                    "constant nullspace (mean-zero solution)")

    def rhs64() -> np.ndarray:
        b64 = assemble_poisson_rhs_np(space)
        b64[bc.flat_dofs()] = bc.value  # apply_lifting is zero (u0 = 0)
        if pure_neumann:
            # the compatible RHS of the singular Neumann system
            b64 = b64 - b64.mean()
        return b64

    with Timer("ZZZ Assemble vector", device):
        b = torch.from_numpy(rhs64().astype(np_dtype(dtype))).to(device)

    def fidelity():
        """float64 host twin: the assembled CSR itself (la.refine)."""
        import scipy.sparse as sp
        n = space.ndofs
        M64 = sp.csr_matrix((csr[2], csr[1], csr[0]), shape=(n, n))
        return (lambda v: M64 @ v), rhs64()

    u = torch.zeros(space.ndofs, dtype=dtype, device=device)
    solver = Solver(A, mesh, order, cfg, dtype, acc_dtype, device,
                    fidelity=fidelity, bc_mask=bc.mask(), csr=csr,
                    deflate=pure_neumann)
    return common.Problem(b=b, u=u, solver_function=solver, space=space,
                          bc=bc)
