"""The brick-AMG slice end to end on the CPU, float64: ``-pc_type amg``
and tpufem's fallback where GMG cannot coarsen the lattice, for Poisson
(against tpufem called directly) and elasticity (against tpufem's
recorded runs: its elasticity brick-AMG compiles for half a minute on
the CPU), with the same iteration counts and the norms to 1e-10; the
float32 certified contract; and an unknown ``-pc_type``."""

import numpy as np
import pytest
import torch

import jax

from tpufem import cli as tpu_cli
from tpufem.config import Config as TpuConfig
from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli
from tpufem_torch.config import Config, SolverOptions
from tpufem_torch.la.bramg import BrickAMG
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import elasticity, poisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
# one shard: the tests' 8 virtual JAX devices would send tpufem's CLI to
# its sharded path, which runs GMG for -pc_type amg
P15K = ["--problem_type", "poisson", "--ndofs", "15000", "--scaling_type",
        "weak", "--num_shards", "1", "--dtype", "float64", "-ksp_rtol",
        "1e-8", "-pc_type", "amg"]


@pytest.mark.parametrize("extra,gold_it,gold_norm,sizes", [
    ([], 11, 26.53502029905387, [15625, 729]),
    (["-amg_coarse_eq_limit", "50"], 12, 26.535020303199435,
     [15625, 729, 27]),
], ids=["default", "coarse_limit_50"])
def test_poisson_cli_matches_tpufem(extra, gold_it, gold_norm, sizes):
    """The 15k run, and with a flat m = 1 level (coarse limit 50)."""
    it_ref, norm_ref = tpu_cli.solve(tpu_cli.parse_args(P15K + extra))
    res = cli.main(P15K + extra + ["--device", "cpu"])
    pc = res.problem.solver_function.pc
    assert isinstance(pc, BrickAMG) and pc.level_sizes == sizes
    assert res.problem.solver_function.pc_type == "brick-amg"
    assert res.iterations == it_ref == gold_it
    assert abs(res.norm - norm_ref) <= 1e-10 * norm_ref
    assert abs(res.norm - gold_norm) <= 1e-10 * gold_norm
    assert res.true_rel <= 1e-8


def test_poisson_gmg_fallback_matches_tpufem():
    """7x7x7 cannot be halved: GMG.setup raises, and the solver goes to
    brick-AMG as tpufem's does (8 iterations, 4.606048276659855)."""
    opts = dict(ksp_rtol=1e-8, amg_coarse_eq_limit=10)
    ref = tpu_poisson.problem(TpuMesh(7, 7, 7), 1, TpuConfig(
        dtype="float64", solver=TpuSolverOptions(**opts)))
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    prob = poisson.problem(BoxTetMesh(7, 7, 7), 1, Config(
        dtype="float64", solver=SolverOptions(**opts)), CPU)
    x, it = prob.solver_function(prob.u, prob.b)
    assert isinstance(prob.solver_function.pc, BrickAMG)
    assert it == it_ref == 8
    n, n_ref = np.linalg.norm(x.numpy()), np.linalg.norm(np.asarray(x_ref))
    assert abs(n - n_ref) <= 1e-10 * n_ref
    assert abs(n - 4.606048276659855) <= 1e-10 * n


@pytest.mark.parametrize("argv,gold_it,gold_norm,sizes", [
    (["--ndofs", "10000", "-pc_type", "amg", "-amg_coarse_eq_limit", "50"],
     18, 2.1810549459911644e-05, [10647, 1050, 72]),
    (["--ndofs", "3000", "-amg_coarse_eq_limit", "10"],
     17, 1.1781546750132966e-05, [3159, 270, 12]),
], ids=["amg_10k", "gmg_fallback_3000"])
def test_elasticity_cli_matches_tpufem_runs(argv, gold_it, gold_norm, sizes):
    """tpufem's recorded runs (JAX, CPU, float64): the 10k run with a
    flat m = 6 level, and the 3000-dof lattice where GMG is not viable
    (tpufem runs that fallback on its interleaved layout, the port
    planar: the same V-cycle)."""
    res = cli.main(["--problem_type", "elasticity", "--scaling_type", "weak",
                    "--dtype", "float64", "--device", "cpu"] + argv)
    solver = res.problem.solver_function
    assert isinstance(solver.pc, BrickAMG) and solver.pc.level_sizes == sizes
    assert solver.A.planar and solver.pc.levels[0].planar
    assert res.iterations == gold_it
    assert abs(res.norm - gold_norm) <= 1e-10 * gold_norm
    assert res.true_rel <= 1e-8


def test_float32_certified_contract():
    """float32 probes and V-cycle: certified to rtol with refinement."""
    res = cli.main(["--ndofs", "15000", "--dtype", "float32", "-pc_type",
                    "amg", "--device", "cpu"])
    assert res.true_rel is not None and res.true_rel <= 1e-8
    assert res.problem.solver_function.pc.coarse_inv.dtype == torch.float32
    assert 0 < res.iterations < 20
    assert abs(res.norm - 26.53502029905387) <= 1e-5 * 26.53502029905387


def test_unknown_pc_type_runs_unpreconditioned():
    """tpufem's make_solver runs CG without a preconditioner for a
    -pc_type it does not know (tpufem/problems/poisson.py:393-395)."""
    base = ["--ndofs", "3000", "--dtype", "float64", "--device", "cpu"]
    none = cli.main(base + ["-pc_type", "none"])
    bogus = cli.main(base + ["-pc_type", "bogus"])
    assert bogus.problem.solver_function.precond is None
    assert bogus.iterations == none.iterations > 20
    assert bogus.norm == none.norm
