"""The port's P2/P3 slices end to end on the CPU: Poisson P2 (CG + GMG
with the p-transfer) against tpufem's solver, the order3 golden of
tests/test_golden.py, float32 certification at order 2, the other
preconditioners at order k, and ``cgpoisson -use_strip 0`` (the
multi-kind DIA operator) against tpufem's DIA form."""

import jax
import numpy as np
import pytest
import torch

from tpufem.config import Config, SolverOptions
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import cgpoisson as tpu_cgpoisson
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.flat_op import FlatOperator
from tpufem_torch.la.gmg import GMG
from tpufem_torch.problems import cgpoisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
POISSON = ["--problem_type", "poisson", "--device", "cpu"]
# tpufem's -use_strip 0 run of P3 at 9,025 dofs (the 6x6x8 lattice),
# float64: python scripts/poisson_pk_reference.py --problem_type cgpoisson
#   --order 3 --ndofs 10000 --scaling_type weak --dtype float64
P3_DIA_REF = (100, 20.20326073744622)


@pytest.fixture
def one_timed_solve(monkeypatch):
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


def test_order2_cli_matches_tpufem():
    """P2 on the 12^3 lattice (15,625 dofs): the P2 level, the P1 level
    on the same lattice and the 6^3 coarse inverse; the same RHS,
    iterations and solution as tpufem's solver, float64."""
    res = cli.main(POISSON + ["--order", "2", "--ndofs", "15000",
                              "--dtype", "float64"])
    mesh = res.problem.space.mesh
    assert (mesh.Nx, mesh.Ny, mesh.Nz) == (12, 12, 12)
    solver = res.problem.solver_function
    assert isinstance(solver.A, DiaOperator) and solver.A.multi_kind
    assert isinstance(solver.pc, GMG) and solver.pc.order == 2
    ref = tpu_poisson.problem(TpuMesh(12, 12, 12), 2, Config(
        dtype="float64", solver=SolverOptions(ksp_rtol=1e-8)))
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    b_ref = np.asarray(ref.b)
    assert (np.linalg.norm(res.problem.b.numpy() - b_ref)
            <= 1e-13 * np.linalg.norm(b_ref))
    assert res.iterations == it_ref == 10
    n_ref = float(np.linalg.norm(np.asarray(x_ref)))
    assert abs(res.norm - n_ref) <= 1e-10 * n_ref
    assert res.true_rel <= 1e-8


def test_order3_golden():
    """tests/test_golden.py's order3 (the reference's CI job 3)."""
    res = cli.main(POISSON + ["--order", "3", "--ndofs", "15000",
                              "--num_shards", "1", "--dtype", "float64",
                              "-ksp_rtol", "1e-8"])
    assert res.iterations == 19
    assert abs(res.norm - 25.64720150160304) < 1e-9 * 25.64720150160304
    assert res.problem.solver_function.pc.order == 3


def test_order2_float32_is_certified():
    """The float32 path: the device RHS through the per-perm mass
    operator, the f32 solve, refinement against the f64 twin."""
    res = cli.main(POISSON + ["--order", "2", "--ndofs", "3000",
                              "--dtype", "float32"])
    assert res.problem.b.dtype == torch.float32
    assert 0 < res.iterations < 100
    assert res.true_rel is not None and res.true_rel <= 1e-8


@pytest.mark.parametrize("pc", ["jacobi", "none"])
def test_other_preconditioners_run_at_order_k(pc):
    res = cli.main(POISSON + ["--order", "3", "--ndofs", "3000",
                              "--dtype", "float64", "-pc_type", pc,
                              "-ksp_max_it", "400"])
    assert 0 < res.iterations < 400
    assert res.true_rel <= 1e-8


def test_amg_at_order_k_raises_naming_m14():
    """brick-AMG is P1 (tpufem/la/bramg.py:739-745); tpufem's order-k
    -pc_type amg is its SA-AMG, ported since (ROADMAP M14): it runs, on
    the factored fine level of the P2 operator."""
    res = cli.main(POISSON + ["--order", "2", "--ndofs", "3000",
                              "--dtype", "float64", "-pc_type", "amg"])
    solver = res.problem.solver_function
    assert solver.pc_type == "amg" and solver.route == "factored"
    assert 0 < res.iterations < 60 and res.true_rel <= 1e-8


def test_use_strip0_p2_matches_tpufem_dia(one_timed_solve):
    """-use_strip 0 keeps the multi-kind DIA operator, as in tpufem
    (tpufem/problems/cgpoisson.py:170-183): the same iterations and
    solution as tpufem's own -use_strip 0 run, float64."""
    argv = ["--problem_type", "cgpoisson", "--order", "2", "--ndofs", "3000",
            "--dtype", "float64", "--device", "cpu", "-use_strip", "0"]
    res = cli.main(argv)
    op = res.problem.solver_function.op
    assert isinstance(op, DiaOperator) and op.multi_kind
    opts = SolverOptions()
    opts.extra["use_strip"] = 0
    ref = tpu_cgpoisson.problem(TpuMesh(6, 6, 8), 2, Config(
        problem_type="cgpoisson", dtype="float64", solver=opts))
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    n_ref = float(np.linalg.norm(np.asarray(x_ref)))
    assert res.iterations == it_ref
    assert abs(res.norm - n_ref) <= 1e-9 * n_ref


def test_use_strip0_p3_matches_tpufem_dia(one_timed_solve):
    res = cli.main(["--problem_type", "cgpoisson", "--order", "3",
                    "--ndofs", "10000", "--dtype", "float64", "--device",
                    "cpu", "-use_strip", "0"])
    assert isinstance(res.problem.solver_function.op, DiaOperator)
    assert res.problem.space.ndofs == 9025
    its, norm = P3_DIA_REF
    assert res.iterations == its
    assert abs(res.norm - norm) <= 1e-9 * norm


def test_use_flat_falls_through_to_the_dia_form(one_timed_solve, caplog):
    """-use_flat 1 on a lattice too small for the flat layout warns and
    takes the strip choice, where -use_strip 0 keeps the DIA operator."""
    caplog.set_level("INFO", logger="tpufem_torch")
    res = cli.main(["--problem_type", "cgpoisson", "--order", "2",
                    "--ndofs", "3000", "--dtype", "float64", "--device",
                    "cpu", "-use_flat", "1", "-use_strip", "0"])
    op = res.problem.solver_function.op
    assert isinstance(op, DiaOperator) and not isinstance(op, FlatOperator)
    assert "use_flat ignored" in caplog.text
    assert res.iterations > 0
