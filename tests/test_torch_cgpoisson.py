"""The port's matrix-free cgpoisson slice end to end on the CPU: the
cgpoisson15k golden of tests/test_golden.py, P2/P3 float64 CLI runs
against tpufem's ``cgpoisson.problem`` on the same mesh (same iteration
count, norm to rel 1e-9), the P2/P3 right-hand sides, the K4 engagement
gate, and which options are read.

The timing scheme of the solve (3 passes of 10 perturbed-RHS solves
after the returned one) is cut to one pass of one solve in the P2/P3
comparisons: it adds no check on the CPU.  The golden keeps it whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.config import Config as TpuConfig
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.mesh.structured import BoxTetMesh as TpuMesh
from tpufem.problems import cgpoisson as tpu_cgpoisson
from tpufem.problems import common as tpu_common
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli
from tpufem_torch.fem.conv_op import ConvStencilOp
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.strip_op import StripOperator
from tpufem_torch.fem.structured_op import StructuredOperator
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import cgpoisson, common, poisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def one_timed_solve(monkeypatch):
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


def test_cgpoisson15k_golden():
    res = cli.main(["--problem_type", "cgpoisson", "--ndofs", "15000",
                    "--num_shards", "1", "--dtype", "float64",
                    "--device", "cpu"])
    assert res.iterations == 100
    assert abs(res.norm - 26.535020300527723) < 1e-9 * 26.535020300527723
    solver = res.problem.solver_function
    assert solver.gdofs > 0.0 and solver.solve_s > 0.0
    assert solver.cg_kernel_engaged is False


@pytest.mark.parametrize("order,ndofs,dims", [(2, "3000", (6, 6, 8)),
                                              (3, "10000", (6, 6, 8))],
                         ids=["P2", "P3"])
def test_p2_p3_cli_matches_tpufem(one_timed_solve, order, ndofs, dims):
    res = cli.main(["--problem_type", "cgpoisson", "--ndofs", ndofs,
                    "--order", str(order), "--dtype", "float64",
                    "--device", "cpu"])
    mesh = res.problem.space.mesh
    assert (mesh.Nx, mesh.Ny, mesh.Nz) == dims
    assert isinstance(res.problem.solver_function.op, StripOperator)
    ref = tpu_cgpoisson.problem(TpuMesh(*dims), order,
                                TpuConfig(problem_type="cgpoisson",
                                          dtype="float64"))
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    n_ref = float(np.linalg.norm(np.asarray(x_ref)))
    assert res.iterations == it_ref
    assert abs(res.norm - n_ref) <= 1e-9 * n_ref
    assert np.linalg.norm(res.problem.b.numpy() - np.asarray(ref.b)) <= \
        1e-13 * np.linalg.norm(np.asarray(ref.b))


@pytest.mark.parametrize("order", [2, 3])
def test_p2_p3_rhs_match_tpufem(order):
    """The float32 device RHS (StructuredOperator mass apply + host facet
    term) and the float64 host RHS against tpufem's."""
    dims = (4, 5, 6)
    tmesh = TpuMesh(*dims)
    tspace = TpuSpace(tmesh, order)
    tbc = TpuBC.from_space(
        tspace, tmesh.locate_boundary_facets(tpu_common.poisson_bc_marker))
    space = FunctionSpace(BoxTetMesh(*dims), order)
    bc = DirichletBC.from_space(space, space.mesh.locate_boundary_facets(
        common.poisson_bc_marker))
    assert np.array_equal(bc.flat_dofs(), tbc.flat_dofs())
    b64 = poisson.assemble_poisson_rhs_np(space)
    b64_ref = tpu_poisson.assemble_poisson_rhs_np(tspace)
    assert np.array_equal(b64, b64_ref)
    mass = StructuredOperator.build(space.mesh, order, "mass",
                                    dtype=torch.float32, device=CPU)
    b32 = poisson.assemble_poisson_rhs_structured_dev(space, bc, mass)
    b32_ref = np.asarray(tpu_poisson.assemble_poisson_rhs_structured_dev(
        tspace, tbc, jnp.float32))
    assert b32.dtype == torch.float32
    # f32 sums of 10-20 terms in another order: a few ulps of the largest
    np.testing.assert_allclose(b32.numpy(), b32_ref, rtol=0,
                               atol=1e-6 * np.abs(b32_ref).max())


def test_cg_kernel_gate_and_split_form_agree(one_timed_solve):
    """-cg_kernel on engages the whole-CG form (its plain version on the
    CPU) when the resident state fits tpufem's 14 MiB gate; the two
    forms give the same solve."""
    argv = ["--problem_type", "cgpoisson", "--ndofs", "3000", "--order", "2",
            "--dtype", "float64", "--device", "cpu"]
    off = cli.main(argv)
    on = cli.main(argv + ["-cg_kernel", "on"])
    s_off, s_on = off.problem.solver_function, on.problem.solver_function
    assert s_off.cg_kernel_engaged is False and s_on.cg_kernel_engaged is True
    assert s_on.op.cg_resident_bytes() <= 14 * 2**20
    assert abs(on.iterations - off.iterations) <= 1
    assert abs(on.norm - off.norm) <= 1e-9 * off.norm


@pytest.mark.parametrize("dims,ndofs,engages,shape,packs", [
    ((16, 16, 20), 146461, True, (27, 23, 640), None),
    ((24, 24, 32), 516913, False, (27, 35, 1024), (1311, 732)),
], ids=["P3-150k", "P3-500k"])
def test_cg_kernel_gate_at_bench_sizes(dims, ndofs, engages, shape, packs):
    """tpufem's 14 MiB gate on the resident state: in float32 it passes
    at the bench's P3 150k lattice (11.1 MB) and fails at P3 500k
    (25.6 MB), where the split form runs, as in tpufem."""
    from tpufem_torch.fem.dia_op import DiaOperator
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, 3)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(
        common.poisson_bc_marker))
    dia = DiaOperator.try_const(mesh, 3, "poisson", bc_dofs=bc.flat_dofs(),
                                dtype=torch.float32)
    op = StripOperator.from_dia(dia, dtype=torch.float32)
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    assert space.ndofs == ndofs and (C, Zp, LW) == shape
    assert op.cg_kernel_ok is engages
    if packs is not None:
        assert (op.mid_pack.shape[0], op.dlt_pack.shape[0]) == packs


@pytest.mark.parametrize("order,left", [(1, True), (2, False)],
                         ids=["P1_stencil", "P2_strip"])
def test_cg_kernel_is_read_only_for_a_strip_operator(one_timed_solve, caplog,
                                                     order, left):
    """As tpufem (tpufem/problems/cgpoisson.py:232-234): -cg_kernel is
    read where the operator is a StripOperator, and left over (warned)
    on the P1 stencil path."""
    caplog.set_level("INFO", logger="tpufem_torch")
    res = cli.main(["--problem_type", "cgpoisson", "--order", str(order),
                    "--ndofs", "3000", "--dtype", "float64", "--device",
                    "cpu", "-cg_kernel", "on"])
    assert isinstance(res.problem.solver_function.op, StripOperator) == (
        order == 2)
    warned = ("Option left: unused solver option 'cg_kernel'"
              in caplog.text)
    assert warned == left


def test_logged_no_op_options_are_consumed(one_timed_solve, caplog):
    """-use_pallas is accepted and logged, -use_conv builds the conv
    operator (P2: the strip operator is not built), -cg_rtol and -cg_kmax
    are read; only an unknown option is left over."""
    caplog.set_level("INFO", logger="tpufem_torch")
    res = cli.main(["--problem_type", "cgpoisson", "--order", "2",
                    "--ndofs", "3000", "--dtype", "float64", "--device",
                    "cpu", "-use_pallas", "1", "-use_conv", "1", "-cg_rtol",
                    "1e-30", "-cg_kmax", "7", "-totally_bogus", "42"])
    assert res.iterations == 7
    assert "use_pallas ignored" in caplog.text
    op = res.problem.solver_function.op
    assert isinstance(op, ConvStencilOp) and not isinstance(op, StripOperator)
    left = [r.getMessage() for r in caplog.records
            if "Option left" in r.getMessage()]
    assert left == ["Option left: unused solver option 'totally_bogus'"]


def test_use_conv_0_keeps_the_strip_operator(one_timed_solve, caplog):
    """-use_conv 0 is read and leaves the default P2 operator, the strip
    form."""
    caplog.set_level("INFO", logger="tpufem_torch")
    res = cli.main(["--problem_type", "cgpoisson", "--order", "2",
                    "--ndofs", "3000", "--dtype", "float64", "--device",
                    "cpu", "-use_conv", "0", "-cg_kmax", "7"])
    assert isinstance(res.problem.solver_function.op, StripOperator)
    assert not res.problem.solver_function.channels
    assert "Option left" not in caplog.text
