"""The port's P2/P3 elasticity slice end to end on the CPU: tpufem's
float64 P2 (6x6x10, 10,647 dofs) and P3 (4x4x6, 9,633 dofs) CLI runs
(iterations exactly, norms to rel 1e-10), the RHS against tpufem's,
float32 certification, the other preconditioners at order k, the
near-nullspace, and ``-pc_type amg`` at order k raising (tpufem's
SA-AMG, ROADMAP M14).

tpufem's values come from its own CLI runs on the CPU, each in a fresh
process (tpufem's order-k float32 solve fails with jax's x64 mode on,
which these tests need):

    python scripts/poisson_pk_reference.py --problem_type elasticity \\
        --order 2|3 --ndofs 10000 --scaling_type weak --dtype float64
"""

import jax
import numpy as np
import pytest
import torch

from tpufem.config import Config as TpuConfig
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.la.nullspace import build_near_nullspace as tpu_nullspace
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import elasticity as tpu_elasticity

from tpufem_torch import cli
from tpufem_torch.fem.structured_op import StructuredOperator
from tpufem_torch.la.gmg import GMG
from tpufem_torch.problems import elasticity

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
ELAST = ["--problem_type", "elasticity", "--device", "cpu"]
# (order, lattice, ndofs, iterations, norm): tpufem's float64 runs
GOLDEN = [(2, (6, 6, 10), 10647, 19, 2.2017755354284647e-05),
          (3, (4, 4, 6), 9633, 33, 2.098447872071006e-05)]


@pytest.mark.parametrize("order,dims,ndofs,its,norm", GOLDEN,
                         ids=["P2", "P3"])
def test_cli_matches_tpufem_run(order, dims, ndofs, its, norm):
    res = cli.main(ELAST + ["--order", str(order), "--ndofs", "10000",
                            "--dtype", "float64"])
    prob, solver = res.problem, res.problem.solver_function
    mesh = prob.space.mesh
    assert (mesh.Nx, mesh.Ny, mesh.Nz) == dims and prob.space.ndofs == ndofs
    assert isinstance(solver.A, StructuredOperator) and solver.A.planar
    assert isinstance(solver.pc, GMG) and solver.pc.order == order
    assert res.iterations == its
    assert abs(res.norm - norm) <= 1e-10 * norm
    assert res.true_rel <= 1e-8 and res.refine_passes == 0


def test_p2_rhs_and_hierarchy_match_tpufem():
    """The float64 RHS (interleaved, BC values set) against tpufem's
    ``elasticity.problem``, and the GMG levels of the P2 10k run: P2,
    P1 on the same 6x6x10 lattice, the 3x3x5 coarse inverse."""
    res = cli.main(ELAST + ["--order", "2", "--ndofs", "10000",
                            "--dtype", "float64", "-ksp_max_it", "1"])
    ref = tpu_elasticity.problem(TpuMesh(6, 6, 10), 2,
                                 TpuConfig(problem_type="elasticity",
                                           dtype="float64"))
    b_ref = np.asarray(ref.b)
    assert (np.linalg.norm(res.problem.b.numpy() - b_ref)
            <= 1e-13 * np.linalg.norm(b_ref))
    pc = res.problem.solver_function.pc
    assert pc.dims == ((6, 6, 10), (6, 6, 10), (3, 3, 5))
    assert [3 * lv.op.layout.ndofs for lv in pc.levels] == [10647, 1617]
    assert pc.coarse_inv.shape == (288, 288)


def test_float32_p2_is_certified():
    """The float32 path: the device RHS through three applies of the
    scalar P2 mass operator, the f32 solve, refinement against the f64
    twin."""
    res = cli.main(ELAST + ["--order", "2", "--ndofs", "3000",
                            "--dtype", "float32"])
    prob = res.problem
    assert prob.b.dtype == torch.float32
    assert isinstance(prob.rhs_op, StructuredOperator) and prob.rhs_op.bs == 1
    assert 0 < res.iterations < 100
    assert res.true_rel is not None and res.true_rel <= 1e-8
    b64 = elasticity.assemble_elasticity_rhs_np(prob.space)
    b64[prob.bc.flat_dofs()] = prob.bc.value
    assert (np.linalg.norm(prob.b.numpy() - b64)
            <= 1e-6 * np.linalg.norm(b64))


@pytest.mark.parametrize("pc", ["jacobi", "none"])
def test_other_preconditioners_run_at_order_k(pc):
    res = cli.main(ELAST + ["--order", "2", "--ndofs", "3000",
                            "--dtype", "float64", "-pc_type", pc,
                            "-ksp_max_it", "600"])
    assert 0 < res.iterations < 600
    assert res.true_rel <= 1e-8


def test_amg_at_order_k_raises_naming_m14():
    """brick-AMG is P1 (tpufem/la/bramg.py:739-745); tpufem's order-k
    elasticity -pc_type amg fails in tpufem itself (its SA-AMG calls
    to_scipy() on the blocked StructuredOperator, which lacks it,
    tpufem/problems/poisson.py:329), so the port raises there too."""
    with pytest.raises(NotImplementedError,
                       match="order-3 StructuredOperator: tpufem has no such"):
        cli.main(ELAST + ["--order", "3", "--ndofs", "3000",
                          "-pc_type", "amg"])


def test_near_nullspace_at_order_k_matches_tpufem():
    res = cli.main(ELAST + ["--order", "3", "--ndofs", "3000",
                            "--dtype", "float64", "-ksp_max_it", "1"])
    mesh = res.problem.space.mesh
    want = tpu_nullspace(TpuSpace(TpuMesh(mesh.Nx, mesh.Ny, mesh.Nz), 3,
                                  bs=3).scalar_dof_coords())
    assert np.array_equal(res.problem.near_nullspace, want)
