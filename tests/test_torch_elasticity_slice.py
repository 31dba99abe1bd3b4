"""The port's elasticity slice end to end on the CPU: the whole float64
problem and solve against tpufem's ``elasticity.problem`` (RHS to rel
1e-13, the same iteration count, the solution norm to rel 1e-10), the
goldens of tests/test_golden.py and tpufem's 10k run through the CLI,
the float32 certified contract, the brick-AMG fallback where GMG cannot
coarsen the lattice, tpufem's generic SA-AMG (-amg_brick off), the spoke
mesh's singular run, and the refusals (-pc_type amg at order 2, no CUDA
fallback)."""

import numpy as np
import pytest
import torch

import jax

from tpufem.config import Config as TpuConfig
from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import elasticity as tpu_elasticity

from tpufem_torch import cli
from tpufem_torch.config import Config, SolverOptions
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import elasticity
from tpufem_torch.timing import REGISTRY

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("pc_type", ["gmg", "jacobi"])
def test_slice_matches_tpufem(pc_type):
    """8x8x16 float64: GMG (one smoothed level + the 4x4x8 coarse solve)
    or Jacobi, both in the planar layout."""
    dims = (8, 8, 16)
    opts = dict(ksp_rtol=1e-8, pc_type=pc_type)
    ref = tpu_elasticity.problem(
        TpuMesh(*dims), 1, TpuConfig(problem_type="elasticity",
                                     dtype="float64",
                                     solver=TpuSolverOptions(**opts)))
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    prob = elasticity.problem(
        BoxTetMesh(*dims), 1, Config(problem_type="elasticity",
                                     dtype="float64",
                                     solver=SolverOptions(**opts)), CPU)
    x, it = prob.solver_function(prob.u, prob.b)
    b_ref = np.asarray(ref.b)
    assert (np.linalg.norm(prob.b.numpy() - b_ref)
            <= 1e-13 * np.linalg.norm(b_ref))
    assert it == it_ref
    n, n_ref = np.linalg.norm(x.numpy()), np.linalg.norm(np.asarray(x_ref))
    assert abs(n - n_ref) <= 1e-10 * n_ref
    assert prob.solver_function.true_rel <= 1e-8
    assert prob.solver_function.A.planar
    assert prob.near_nullspace.shape == (6, prob.space.ndofs)


@pytest.mark.parametrize("ndofs,gold_it,gold_norm", [
    ("10000", 18, 2.1810549458466715e-05),
    ("100000", 18, 6.784162962970475e-05),
], ids=["elasticity10k", "elasticity100k"])
def test_golden(ndofs, gold_it, gold_norm):
    """tpufem's 10k weak float64 run (12x12x20: levels 12x12x20 and
    6x6x10, a 3x3x5 coarse lattice; true_rel 8.412e-09 without
    refinement) and the elasticity100k golden."""
    REGISTRY.reset()
    res = cli.main(["--problem_type", "elasticity", "--ndofs", ndofs,
                    "--scaling_type", "weak", "--num_shards", "1",
                    "--dtype", "float64", "-ksp_rtol", "1e-8",
                    "--device", "cpu"])
    assert res.iterations == gold_it
    assert abs(res.norm - gold_norm) <= 1e-9 * gold_norm
    assert res.true_rel is not None and res.true_rel <= 1e-8
    assert res.refine_passes == 0
    assert res.problem.rhs_op is None  # float64 assembles b on the host
    # tpufem's stages, in its order
    stages = [name for name, _, _ in REGISTRY.rows()]
    want = ["ZZZ FunctionSpace", "ZZZ Create boundary conditions",
            "ZZZ Assemble matrix", "ZZZ Assemble vector",
            "ZZZ Create near-nullspace"]
    assert [s for s in stages if s in want] == want
    if ndofs == "10000":
        pc = res.problem.solver_function.pc
        assert pc.dims == ((12, 12, 20), (6, 6, 10), (3, 3, 5))


def test_float32_certified_contract():
    res = cli.main(["--problem_type", "elasticity", "--ndofs", "10000",
                    "--dtype", "float32", "-ksp_rtol", "1e-8",
                    "--device", "cpu"])
    assert res.true_rel is not None and res.true_rel <= 1e-8
    assert res.problem.b.dtype == torch.float32
    assert 0 < res.iterations < 30
    assert abs(res.norm - 2.1810549458466715e-05) <= 1e-5 * 2.1810549458466715e-05
    # the device RHS's mass operator is the scalar one, on the vertex grid
    mass, A = res.problem.rhs_op, res.problem.solver_function.A
    assert mass.bs == 1 and mass.fields.dtype == torch.float32
    assert mass.grid_dims == A.grid_dims and A.bs == 3


@pytest.mark.parametrize("argv,raises", [
    # order-k -pc_type amg fails in tpufem too
    (["--order", "2", "-pc_type", "amg"], "tpufem has no such path"),
    # ported since: tpufem's SA-AMG, planar
    (["-pc_type", "amg", "-amg_brick", "off"], None),
    # ported since: the spoke mesh, singular (no clamped face), where CG
    # runs to its cap without converging, as tpufem's does
    (["--mesh_type", "unstructured", "-ksp_max_it", "8"], "singular"),
], ids=["order2", "amg", "unstructured"])
def test_unported_options_raise(argv, raises):
    """Order-k -pc_type amg raises saying tpufem has no such path;
    -amg_brick off (SA-AMG) runs a small certified solve; the unstructured
    elasticity runs to its cap on its singular system."""
    argv = ["--problem_type", "elasticity", "--ndofs", "3000",
            "--device", "cpu"] + argv
    if raises == "singular":
        res = cli.main(argv + ["--dtype", "float64"])
        assert res.iterations == 8 and res.true_rel > 1.0
        return
    if raises is not None:
        with pytest.raises(NotImplementedError, match=raises):
            cli.main(argv)
        return
    res = cli.main(argv + ["--dtype", "float64"])
    assert 0 < res.iterations < 100 and res.true_rel <= 1e-8


def test_gmg_not_viable_raises_naming_amg():
    """A lattice GMG cannot coarsen enough (15^3: 12,288 dofs on the
    coarsest level): tpufem goes to algebraic multigrid there, and so
    does the port now, to brick-AMG in the planar layout (levels 12,288
    and 1,296), float32 and certified."""
    from tpufem_torch.la.bramg import BrickAMG
    prob = elasticity.problem(BoxTetMesh(15, 15, 15), 1,
                              Config(problem_type="elasticity"), CPU)
    x, it = prob.solver_function(prob.u, prob.b)
    solver = prob.solver_function
    assert isinstance(solver.pc, BrickAMG) and solver.pc_type == "brick-amg"
    assert solver.pc.level_sizes == [12288, 1296]
    assert solver.pc.levels[0].planar and solver.A.planar
    assert 0 < it < 40 and solver.true_rel <= 1e-8
    assert bool(torch.isfinite(x).all())


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--problem_type", "elasticity", "--ndofs", "3000",
                  "--device", "cuda"])
