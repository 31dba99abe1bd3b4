"""Vector-valued (bs = 3) linear elasticity on the structured cube mesh
and on an unstructured mesh (counterpart of
tpufem/problems/elasticity.py:43-218).

P1-P3 vector Lagrange space; the clamped y = 0 face; the rotational body
force; the BC-eliminated blocked stiffness (P1: a bs = 3 DIA stencil;
P2/P3: the blocked per-perm StructuredOperator); the rigid-body
near-nullspace; CG preconditioned by geometric multigrid (at order k > 1
with the p-transfer to P1), lattice-brick AMG with the near-nullspace
(``-pc_type amg`` at P1, and where GMG cannot coarsen the lattice),
tpufem's generic SA-AMG (``-amg_brick off``), Jacobi or nothing,
certified against a float64 host twin as Poisson's solve is.

The solve runs in tpufem's component-planar layout (vector index
``c * n + i``), in which the operator is ONE launch of the
three-component stencil kernel (P1) or of the perm_apply kernel (P2/P3);
b, u and x keep the reference's node-interleaved layout (``3 * i + c``)
and the solver converts once per solve.  The float32 RHS is three scalar
mass applies of the body force (P1: the mass stencil, the force
evaluated on the device from coordinates; P2/P3: the per-perm mass
operator on the host-interpolated force); float64 runs assemble it on
the host.

Every preconditioner the port runs takes the planar layout.  tpufem
keeps it planar at P1 but for its GMG fallback and its SA-AMG, which run
on the interleaved layout, and runs order-k GMG interleaved; the V-cycle
computes the same values in either layout, so the port runs them all
planar (SA-AMG: the hierarchy of the interleaved CSR export, its fine
level permuted to planar).  ``-pc_type amg`` at order k fails in tpufem
(its SA-AMG exports no CSR of the blocked StructuredOperator), and the
port raises there too.

On an unstructured mesh (the spoke mesh; tpufem/problems/elasticity.py:
136-218) the operator is the assembled block CSR (fem.assemble: its
scalar expansion a ``CsrMatrix`` on the device), the RHS the host cell
mass tensors with a ``bincount`` per component, and the solve CG with
tpufem's SA-AMG on the interleaved layout with ``bs = 3`` and the
rigid-body near-nullspace, on tpufem's plain route (its window gate
refuses a block CSR), certified against the float64 BSR matrix.  The
spoke mesh has no y = 0 facet, so its system is pure traction: singular,
with the rigid-body modes in its kernel, and inconsistent (the body
force is not in equilibrium).  tpufem deflates nothing there and CG
grows without bound until its cap; the port does the same.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.config import Config
from tpufem_torch.fem.assemble import assemble_operator, detJ_np
from tpufem_torch.fem.dia_op import DiaOperator, build_operator, np_dtype
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import StructuredOperator
from tpufem_torch.la.nullspace import build_near_nullspace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.mesh.topology import TetTopology
from tpufem_torch.problems import common
from tpufem_torch.problems.poisson import Solver
from tpufem_torch.timing import Timer


def assemble_elasticity_rhs_structured_dev(space: FunctionSpace,
                                           bc: DirichletBC,
                                           mass: DiaOperator) -> torch.Tensor:
    """Device RHS (interleaved): three applies of the scalar P1 device
    mass operator ``mass``, one per component of the body force evaluated
    on the device from coordinates, and the BC values set
    (tpufem/problems/elasticity.py:43-88)."""
    mesh = space.mesh
    dtype, device = mass.fields.dtype, mass.fields.device
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    x = (torch.arange(Nx + 1, dtype=dtype, device=device) / Nx)[None, None, :]
    y = (torch.arange(Ny + 1, dtype=dtype, device=device) / Ny)[None, :, None]
    z = (torch.arange(Nz + 1, dtype=dtype, device=device) / Nz)[:, None, None]
    shape = (Nz + 1, Ny + 1, Nx + 1)
    cols = [mass.apply(c.expand(shape).reshape(-1))
            for c in common.elasticity_f_components(x, y, z, torch)]
    b = torch.stack(cols, dim=-1).reshape(-1)
    return b.index_fill(0, torch.from_numpy(bc.flat_dofs()).to(device),
                        bc.value)


def assemble_elasticity_rhs_pk_dev(space: FunctionSpace, bc: DirichletBC,
                                   mass: StructuredOperator) -> torch.Tensor:
    """Device RHS at order k > 1 (interleaved): three applies of the scalar
    P_k mass operator ``mass``, one per component of the body force
    interpolated on the host, and the BC values set
    (tpufem/problems/elasticity.py:90-107)."""
    dtype, device = mass.A_dev.dtype, mass.A_dev.device
    f = space.interpolate(common.elasticity_f).reshape(-1, 3)
    fd = torch.from_numpy(f.astype(np_dtype(dtype))).to(device)
    cols = [mass.apply_raw(fd[:, r].contiguous()) for r in range(3)]
    b = torch.stack(cols, dim=-1).reshape(-1)
    return b.index_fill(0, torch.from_numpy(bc.flat_dofs()).to(device),
                        bc.value)


def assemble_elasticity_rhs_np(space: FunctionSpace) -> np.ndarray:
    """Host float64 RHS (interleaved, no BC values): on the cube the
    per-perm mass apply of each interpolated component; on an
    unstructured mesh the cell mass tensors and a ``bincount`` per
    component (tpufem/problems/elasticity.py:110-133)."""
    f = space.interpolate(common.elasticity_f).reshape(-1, 3)
    if isinstance(space.mesh, TetTopology):
        cd = space.cell_dofs
        adet = detJ_np(space.mesh.cell_coords())
        M = space.element.mass_tensor
        b_cells = np.einsum("ij,cjr->cir", M, f[cd]) * adet[:, None, None]
        b = np.zeros((space.ndofs_scalar, 3))
        for r in range(3):
            b[:, r] = np.bincount(cd.reshape(-1),
                                  weights=b_cells[:, :, r].reshape(-1),
                                  minlength=space.ndofs_scalar)
        return b.reshape(-1)
    mass = StructuredOperator.build(space.mesh, space.order, "mass",
                                    dtype=torch.float64)
    return np.stack([mass.apply_raw_np(f[:, r]) for r in range(3)],
                    axis=-1).reshape(-1)


def problem(mesh, order: int, cfg: Config,
            device: torch.device) -> common.Problem:
    dtype, acc_dtype = common.resolve_dtype(cfg)
    structured = not isinstance(mesh, TetTopology)

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order, bs=3)
        if not structured:
            _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(common.elasticity_bc_marker)
        bc = DirichletBC.from_space(space, facets)

    if not structured:
        return _problem_unstructured(mesh, order, cfg, device, space, bc,
                                     dtype, acc_dtype)

    with Timer("ZZZ Assemble matrix", device):
        A = build_operator(mesh, order, "elasticity", bc_dofs=bc.flat_dofs(),
                           dtype=dtype, device=device, planar=True)

    mass = None
    with Timer("ZZZ Assemble vector", device):
        if dtype == torch.float32 and order == 1:
            mass = DiaOperator.build(mesh, 1, "mass", dtype=dtype,
                                     device=device)
            b = assemble_elasticity_rhs_structured_dev(space, bc, mass)
        elif dtype == torch.float32:
            mass = StructuredOperator.build(mesh, order, "mass", dtype=dtype,
                                            device=device)
            b = assemble_elasticity_rhs_pk_dev(space, bc, mass)
        else:
            b_np = assemble_elasticity_rhs_np(space)
            b_np[bc.flat_dofs()] = bc.value
            b = torch.from_numpy(b_np.astype(np_dtype(dtype))).to(device)

    with Timer("ZZZ Create near-nullspace"):
        nns = build_near_nullspace(space.scalar_dof_coords())

    def fidelity():
        """float64 host twin of the assembled system (la.refine), in the
        interleaved layout of the solver's contract."""
        A64 = build_operator(mesh, order, "elasticity",
                             bc_dofs=bc.flat_dofs(), dtype=torch.float64)
        b64 = assemble_elasticity_rhs_np(space)
        b64[bc.flat_dofs()] = bc.value
        return A64.apply_np, b64

    u = torch.zeros(space.ndofs, dtype=dtype, device=device)
    solver_function = Solver(A, mesh, order, cfg, dtype, acc_dtype, device,
                             fidelity=fidelity, problem="elasticity",
                             bc_marker=common.elasticity_bc_marker,
                             planar=True, near_nullspace=nns,
                             bc_mask=bc.mask())
    return common.Problem(b=b, u=u, solver_function=solver_function,
                          space=space, bc=bc, rhs_op=mass,
                          near_nullspace=nns)


def _problem_unstructured(mesh, order: int, cfg: Config,
                          device: torch.device, space: FunctionSpace,
                          bc: DirichletBC, dtype: torch.dtype,
                          acc_dtype: torch.dtype) -> common.Problem:
    """The assembled block CSR system of an unstructured mesh, its host
    float64 RHS, the near-nullspace and the BSR certification twin
    (tpufem/problems/elasticity.py:171-218)."""
    with Timer("ZZZ Assemble matrix", device):
        A, csr = assemble_operator(space, bc, "elasticity", dtype, device)

    def rhs64() -> np.ndarray:
        b64 = assemble_elasticity_rhs_np(space)
        b64[bc.flat_dofs()] = bc.value
        return b64

    with Timer("ZZZ Assemble vector", device):
        b = torch.from_numpy(rhs64().astype(np_dtype(dtype))).to(device)

    with Timer("ZZZ Create near-nullspace"):
        nns = build_near_nullspace(space.scalar_dof_coords())

    def fidelity():
        """float64 host twin: the assembled BSR matrix (la.refine)."""
        import scipy.sparse as sp
        n = space.ndofs
        M64 = sp.bsr_matrix((csr[2], csr[1], csr[0]), shape=(n, n))
        return (lambda v: M64 @ v), rhs64()

    u = torch.zeros(space.ndofs, dtype=dtype, device=device)
    solver_function = Solver(A, mesh, order, cfg, dtype, acc_dtype, device,
                             fidelity=fidelity, problem="elasticity",
                             bc_marker=common.elasticity_bc_marker,
                             near_nullspace=nns, bc_mask=bc.mask(), csr=csr)
    return common.Problem(b=b, u=u, solver_function=solver_function,
                          space=space, bc=bc, near_nullspace=nns)
