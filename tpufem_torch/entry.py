"""One matrix-free Poisson apply, the hot step of the cgpoisson path: the
port's twin of the repository's ``__graft_entry__.entry()``; and the twin
of its ``dryrun_multichip``, the sharded paths against one shard.

``entry()`` builds P2 on an 8^3 ``BoxTetMesh`` with the Poisson
Dirichlet planes, tpufem's matrix-free operator (fem.matfree_op: the
metric, the cell dofs and the scatter plan, float32) and x from
``numpy.random.default_rng(0)``, and returns ``(fn, (op, x))`` with
``fn(op, x) = op.apply(x)``: on the card one launch of the matrix-free
kernel, on the CPU its plain version.

    python -c "from tpufem_torch.entry import entry; fn, a = entry(); \\
        print(fn(*a).norm())"
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.matfree_op import MatFreePoissonOp
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common


def entry(device: Optional[torch.device] = None
          ) -> Tuple[Callable, Tuple[MatFreePoissonOp, torch.Tensor]]:
    """``(fn, (op, x))`` on ``device`` (default: the current CUDA
    device; there is no fallback to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry(): no CUDA device (pass device='cpu' "
                               "for the plain version)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    box = BoxTetMesh(8, 8, 8)
    space = FunctionSpace(box, 2)
    bc = DirichletBC.from_space(
        space, box.locate_boundary_facets(common.poisson_bc_marker))
    op = MatFreePoissonOp.build(space, bc, torch.float32, device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        space.ndofs_scalar).astype(np.float32)).to(device)

    def fn(op: MatFreePoissonOp, x: torch.Tensor) -> torch.Tensor:
        return op.apply(x)

    return fn, (op, x)


def dryrun_multichip(n_shards: int,
                     device: Optional[torch.device] = None) -> None:
    """The twin of ``__graft_entry__.dryrun_multichip``: the four sharded
    paths the CLI runs under ``--num_shards`` on tiny shapes, each at
    ``n_shards`` shards and at one, float32; each must converge (rel <
    1e-5) and match the one-shard solve (iterations within 1, solutions
    within a tolerance of their largest entry).  The shards live on one
    ``device`` as the port holds them (parallel.comm; default the current
    CUDA device, with no fallback to the CPU): the CG + GMG slabs for
    Poisson, elasticity and Poisson P2, and the row-sharded CG + SA-AMG
    on P2."""
    from tpufem_torch.config import SolverOptions
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.parallel.rowshard import ShardedEllSolver
    from tpufem_torch.parallel.slab import ShardedCubeSolver
    from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(): no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    box = BoxTetMesh(8, 8, 2 * n_shards)
    rtol, f32 = 1e-5, torch.float32

    def check(name, make, ndofs, x_tol=2e-4):
        x_n, it_n, rel_n = make(n_shards).solve()
        x_1, it_1, _ = make(1).solve()
        assert rel_n < rtol, (f"{name}: sharded solve did not converge "
                              f"(rel={rel_n:.3e})")
        assert abs(int(it_n) - int(it_1)) <= 1, \
            f"{name}: iteration mismatch {it_n} vs single-shard {it_1}"
        err = float(np.abs(x_n - x_1).max() / np.abs(x_1).max())
        assert err < x_tol, (f"{name}: sharded/single solutions differ "
                             f"by {err:.3e}")
        print(f"dryrun_multichip[{name}]: {n_shards} shards, {ndofs} dofs, "
              f"{it_n} CG iterations, rel={rel_n:.3e}, vs single-shard "
              f"diff={err:.1e}")

    nverts = (box.Nx + 1) * (box.Ny + 1) * (box.Nz + 1)
    check("poisson cg+gmg", lambda S: ShardedCubeSolver.build(
        box, S, problem="poisson", dtype=f32, rtol=rtol, maxit=60,
        gather_limit=300, device=device), nverts)
    check("elasticity cg+gmg", lambda S: ShardedCubeSolver.build(
        box, S, problem="elasticity", dtype=f32, rtol=rtol, maxit=80,
        gather_limit=900, device=device), nverts * 3, x_tol=5e-3)
    space2 = FunctionSpace(box, 2)
    check("poisson P2 cg+gmg", lambda S: ShardedCubeSolver.build(
        box, S, problem="poisson", order=2, dtype=f32, rtol=rtol, maxit=60,
        gather_limit=300, device=device), space2.ndofs)
    bc = DirichletBC.from_space(
        space2, box.locate_boundary_facets(common.poisson_bc_marker))
    csr = assemble_csr_np(space2, bc, "poisson")
    b = assemble_poisson_rhs_np(space2)
    b[bc.flat_dofs()] = 0.0
    check("rowshard amg", lambda S: ShardedEllSolver.build(
        space2, bc, csr, b, S, SolverOptions(), dtype=f32, rtol=rtol,
        maxit=60, device=device), space2.ndofs)
