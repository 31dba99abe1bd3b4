"""The SA-AMG slice on the cube end to end on the CPU: ``-amg_brick off``,
``-pc_type amg`` at order 2 and tpufem's fallback where GMG cannot
coarsen the lattice, for Poisson and elasticity, against tpufem's runs
(float64, pinned: ``python -m tpufem ... --num_shards 1``, iterations
exact, norms to rel 1e-9; the small Poisson fallback against tpufem
called directly); the float32 certified contract; and the order-k
elasticity ``-pc_type amg`` that tpufem itself cannot run."""

import jax
import numpy as np
import pytest
import torch

from tpufem import native as tpu_native
from tpufem.config import Config as TpuConfig
from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli, native
from tpufem_torch.config import Config, SolverOptions
from tpufem_torch.fem.csr_spmv import CsrMatrix
from tpufem_torch.fem.dense_gemv import DenseMat
from tpufem_torch.la.amg import SAAMG
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import poisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")

# tpufem's f64 CLI runs: argv -> (iterations, norm, SA level sizes)
TPU_RUNS = {
    "poisson_brick_off": (
        ["--ndofs", "15000", "-pc_type", "amg", "-amg_brick", "off"],
        13, 26.53502030570293, [15625, 632]),
    "poisson_p2_amg": (
        ["--order", "2", "--ndofs", "15000", "-pc_type", "amg"],
        21, 26.65797245999097, [15625, 231]),
    "elasticity_brick_off": (
        ["--problem_type", "elasticity", "--ndofs", "10000", "-pc_type",
         "amg", "-amg_brick", "off"],
        17, 2.181054945892062e-05, [10647, 852]),
    "elasticity_gmg_fallback": (
        ["--problem_type", "elasticity", "--ndofs", "3000", "-amg_brick",
         "off", "-amg_coarse_eq_limit", "10"],
        21, 1.178154675059274e-05, [3159, 156, 12, 6]),
}


@pytest.mark.parametrize("name", list(TPU_RUNS))
def test_cli_matches_tpufem_runs(name):
    argv, its, norm, sizes = TPU_RUNS[name]
    res = cli.main(argv + ["--scaling_type", "weak", "--dtype", "float64",
                           "--device", "cpu"])
    solver = res.problem.solver_function
    assert isinstance(solver.pc, SAAMG) and solver.pc_type == "amg"
    assert solver.route == "factored" and solver.pc.level_sizes == sizes
    lv0 = solver.pc.levels[0]
    assert lv0.A is None and isinstance(lv0.P0, CsrMatrix)
    assert isinstance(lv0.P0T, CsrMatrix)
    assert solver.A.planar == name.startswith("elasticity")
    assert res.iterations == its
    assert abs(res.norm - norm) <= 1e-9 * norm
    assert res.true_rel <= 1e-8


def test_poisson_gmg_fallback_matches_tpufem(monkeypatch):
    """7x7x7 cannot be halved and -amg_brick off bars brick-AMG: both
    packages go to SA-AMG (11 iterations, 4.6060482769816415), tpufem's
    aggregation on the port's library of the same pinned source, so both
    take one route whichever test process built tpufem's own first."""
    monkeypatch.setattr(tpu_native, "_get", native._get)
    opts = dict(ksp_rtol=1e-8, amg_coarse_eq_limit=10, amg_brick="off")
    ref = tpu_poisson.problem(TpuMesh(7, 7, 7), 1, TpuConfig(
        dtype="float64", solver=TpuSolverOptions(**opts)))
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    prob = poisson.problem(BoxTetMesh(7, 7, 7), 1, Config(
        dtype="float64", solver=SolverOptions(**opts)), CPU)
    x, it = prob.solver_function(prob.u, prob.b)
    assert isinstance(prob.solver_function.pc, SAAMG)
    assert it == it_ref == 11
    n, n_ref = np.linalg.norm(x.numpy()), np.linalg.norm(np.asarray(x_ref))
    assert abs(n - n_ref) <= 1e-10 * n_ref
    assert abs(n - 4.6060482769816415) <= 1e-10 * n


@pytest.mark.parametrize("argv,norm", [
    (["-pc_type", "amg", "-amg_brick", "off"], 26.53502030570293),
    (["--order", "2", "-pc_type", "amg"], 26.65797245999097),
], ids=["p1", "p2"])
def test_float32_certified_contract(argv, norm):
    """float32 SA-AMG: the coarse level dense in bfloat16 (the dense
    kernel's plain version), certified to rtol with refinement."""
    res = cli.main(["--ndofs", "15000", "--device", "cpu"] + argv)
    pc = res.problem.solver_function.pc
    assert res.true_rel is not None and res.true_rel <= 1e-8
    assert pc.coarse_inv.dtype == torch.float32
    assert all(lv.dinv.dtype == torch.float32 for lv in pc.levels)
    assert 0 < res.iterations < 30
    assert abs(res.norm - norm) <= 1e-5 * norm


def test_dense_levels_store_bf16_for_float32():
    """A level under the densify guard is a bfloat16 DenseMat in a float32
    solve (tpufem's DenseMat), a float64 one in a float64 solve."""
    base = ["--ndofs", "3000", "-pc_type", "amg", "-amg_brick", "off",
            "-amg_coarse_eq_limit", "20", "-ksp_max_it", "2", "--device",
            "cpu", "-ksp_true_residual", "off"]
    for dtype, want in (("float32", torch.bfloat16),
                        ("float64", torch.float64)):
        pc = cli.main(base + ["--dtype", dtype]).problem.solver_function.pc
        dense = [lv.A for lv in pc.levels[1:] if isinstance(lv.A, DenseMat)]
        assert dense and all(d.M.dtype == want for d in dense)


def test_elasticity_amg_at_order_k_raises_as_tpufem():
    """tpufem's order-k elasticity -pc_type amg fails (its SA-AMG exports
    the CSR by to_scipy(), which its StructuredOperator lacks); the port
    raises in the same place."""
    with pytest.raises(NotImplementedError, match="tpufem has no such path"):
        cli.main(["--problem_type", "elasticity", "--order", "2", "--ndofs",
                  "3000", "-pc_type", "amg", "--device", "cpu"])
