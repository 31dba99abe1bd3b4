"""The spoke mesh's remaining problems in the port against tpufem on the
CPU: Poisson P2/P3 (assembled CSR at order k, SA-AMG, the constant
nullspace deflated), elasticity (block CSR, SA-AMG with bs = 3 and the
rigid-body modes, no deflation) and the matrix-free cgpoisson P1-P3.
tpufem's CLI runs are pinned as constants (``python -m tpufem
--mesh_type unstructured ... --num_shards 1 --dtype float64``, weak
scaling); the pieces are compared live.

The spoke mesh has no Dirichlet facet.  cgpoisson and elasticity are
then singular and inconsistent systems on which CG does not converge:
their trajectories amplify rounding, so the norms of the longer runs
are held to measured tolerances (TPU_CG_RUNS)."""

import subprocess
import sys
import os

import jax
import numpy as np
import pytest
import torch

from tpufem import native as tpu_native
from tpufem.fem.assemble import assemble_operator as tpu_assemble_operator
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.mesh.topology import TetTopology as TpuTopology
from tpufem.problems import common as tpu_common
from tpufem.problems import elasticity as tpu_elasticity
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli, native
from tpufem_torch.fem.assemble import assemble_csr_np
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.matfree_op import MatFreePoissonOp
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.la.amg import SAAMG
from tpufem_torch.mesh.spoke import create_spoke_mesh
from tpufem_torch.problems import cgpoisson, common, elasticity, poisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPOKE = ["--mesh_type", "unstructured", "--ndofs", "3000", "--dtype",
         "float64", "--device", "cpu"]

# tpufem's CLI, f64, --ndofs 3000: options -> (iterations, norm, true_rel)
TPU_POISSON_RUNS = {
    2: (101, 728.1316879075519, 8.617e-09),
    3: (184, 1276.4638392089626, 9.273e-09),
}
# cgpoisson (100 steps unless -cg_kmax): (order, kmax) -> (iterations,
# norm, tolerance on the norm).  tpufem's own 100-step runs move by up to
# 4.0e-14 (P1), 2.1e-7 (P2) and 9.9e-4 (P3) in norm when every entry of
# its RHS moves by one ulp (its float64 loop on this mesh, ten
# perturbations: ``scripts/cgpoisson_reference.py --mesh_type
# unstructured --ndofs 3000 --scaling_type weak --dtype float64
# --ulp_seed S``), so P2 and P3 at 100 steps are held at about 5x and 10x
# that; 30 steps move by up to 2.5e-13 and are held at 1e-9.
TPU_CG_RUNS = {
    (1, 100): (100, 251.62201939995953, 1e-9),
    (2, 100): (100, 394.3962889459107, 1e-6),
    (3, 100): (100, 441.479374154072, 1e-2),
    (2, 30): (30, 154.78174093206965, 1e-9),
    (3, 30): (30, 131.05255459697148, 1e-9),
}
# elasticity (-ksp_max_it k): k -> (norm, true_rel, norm tolerance)
TPU_ELASTICITY_RUNS = {
    8: (0.0003120250060742934, 3.632e+00, 1e-9),
}


def _same_native(monkeypatch):
    """tpufem's loader on the port's library of the same pinned source:
    both packages take one route whichever test process built tpufem's
    own library first."""
    monkeypatch.setattr(tpu_native, "_get", native._get)


def _no_native(monkeypatch):
    monkeypatch.setattr(tpu_native, "_get", lambda: None)
    monkeypatch.setattr(native, "_get", lambda: None)


def _spaces(order, bs=1, dofs_per_node=1):
    """(port space, bc, tpufem space, bc) on the spoke mesh of 3,000 dofs
    (weak scaling), tpufem's over the port's vertices and cells."""
    mesh = create_spoke_mesh(3000, False, dofs_per_node, 1, verbose=False)
    tmesh = TpuTopology(mesh.vertices, mesh.cells())
    marker = common.elasticity_bc_marker if bs == 3 else \
        common.poisson_bc_marker
    tmarker = tpu_common.elasticity_bc_marker if bs == 3 else \
        tpu_common.poisson_bc_marker
    space = FunctionSpace(mesh, order, bs=bs)
    tspace = TpuSpace(tmesh, order, bs=bs)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(marker))
    tbc = TpuBC.from_space(tspace, tmesh.locate_boundary_facets(tmarker))
    return space, bc, tspace, tbc


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("order", [2, 3])
def test_poisson_pk_csr_and_rhs_match_tpufem(order, route, monkeypatch):
    """The order-k CSR triplets (no Dirichlet dof on the spoke: no BC
    rows) and the host RHS with its order-k facet term, bit for bit, on
    one route in both packages."""
    _same_native(monkeypatch)
    if route == "numpy":
        _no_native(monkeypatch)
    space, bc, tspace, tbc = _spaces(order)
    assert bc.flat_dofs().size == 0
    csr = assemble_csr_np(space, bc, "poisson")
    _, ref = tpu_assemble_operator(tspace, tbc, "poisson", dtype=np.float64)
    for got, want in zip(csr, ref):
        assert np.array_equal(got, want)
    assert np.array_equal(poisson.assemble_poisson_rhs_np(space),
                          tpu_poisson.assemble_poisson_rhs_np(tspace))


def test_elasticity_csr_and_rhs_match_tpufem(monkeypatch):
    """The block CSR (bs = 3, no Dirichlet dof) and the unstructured host
    RHS (cell mass tensors, a bincount per component), bit for bit."""
    _same_native(monkeypatch)
    space, bc, tspace, tbc = _spaces(1, bs=3, dofs_per_node=3)
    assert bc.flat_dofs().size == 0
    csr = assemble_csr_np(space, bc, "elasticity")
    assert csr[2].shape[1:] == (3, 3)
    _, ref = tpu_assemble_operator(tspace, tbc, "elasticity",
                                   dtype=np.float64)
    for got, want in zip(csr, ref):
        assert np.array_equal(got, want)
    assert np.array_equal(elasticity.assemble_elasticity_rhs_np(space),
                          tpu_elasticity.assemble_elasticity_rhs_np(tspace))


@pytest.mark.parametrize("order", [2, 3])
def test_poisson_pk_runs_match_tpufem(order):
    """tpufem's f64 P2/P3 spoke runs: iterations exact, norms to rel 1e-9,
    certified with no refinement pass; the constant nullspace deflated."""
    its, norm, true_rel = TPU_POISSON_RUNS[order]
    res = cli.main(["--problem_type", "poisson", "--order", str(order)]
                   + SPOKE)
    assert res.iterations == its
    assert abs(res.norm - norm) <= 1e-9 * norm
    assert res.refine_passes == 0 and res.true_rel <= 1e-8
    assert abs(res.true_rel - true_rel) <= 1e-3 * true_rel
    solver = res.problem.solver_function
    assert solver.deflate and isinstance(solver.pc, SAAMG)
    assert solver.route in ("rcm", "plain")
    assert abs(float(res.x.sum())) <= 1e-9 * float(res.x.abs().sum())


@pytest.fixture
def one_timed_solve(monkeypatch):
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


@pytest.mark.parametrize("order,kmax", list(TPU_CG_RUNS),
                         ids=[f"P{o}_{k}" for o, k in TPU_CG_RUNS])
def test_cgpoisson_runs_match_tpufem(order, kmax, one_timed_solve):
    """tpufem's f64 matrix-free spoke runs: iterations exact, norms within
    TPU_CG_RUNS' tolerances; the operator is the matrix-free one, on no
    Dirichlet dof, undeflated."""
    its, norm, tol = TPU_CG_RUNS[(order, kmax)]
    res = cli.main(["--problem_type", "cgpoisson", "--order", str(order),
                    "-cg_kmax", str(kmax)] + SPOKE)
    solver = res.problem.solver_function
    assert isinstance(solver.op, MatFreePoissonOp)
    assert solver.op.bc_mask is None and solver.op.order == order
    assert res.iterations == its
    assert abs(res.norm - norm) <= tol * norm
    assert solver.gdofs > 0 and solver.cg_kernel_engaged is False


@pytest.mark.parametrize("kmax", list(TPU_ELASTICITY_RUNS))
def test_elasticity_runs_match_tpufem(kmax):
    """tpufem's f64 spoke elasticity runs: SA-AMG with bs = 3 on the plain
    route, no deflation; CG grows without bound on the singular,
    inconsistent system (true_rel 3.6 after 8 steps), as tpufem's
    does."""
    norm, true_rel, tol = TPU_ELASTICITY_RUNS[kmax]
    res = cli.main(["--problem_type", "elasticity", "-ksp_max_it", str(kmax)]
                   + SPOKE)
    solver = res.problem.solver_function
    assert res.iterations == kmax and res.problem.space.ndofs == 3000
    assert abs(res.norm - norm) <= tol * norm
    assert abs(res.true_rel - true_rel) <= 1e-3 * true_rel
    assert res.refine_passes == 0 and not solver.deflate
    assert solver.route == "plain" and not solver.planar
    assert isinstance(solver.pc, SAAMG)
    sizes = solver.pc.level_sizes
    assert sizes[0] == 3000 and sizes[1] % 6 == 0


def test_spoke_paths_run_with_tpufem_unimportable():
    """``sys.modules["tpufem"] = None``: the spoke mesh's cgpoisson and
    elasticity CLI runs need no tpufem and no jax."""
    code = (
        "import sys\n"
        "sys.modules['tpufem'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import tpufem_torch.problems.cgpoisson as c\n"
        "c.TIMING_PASSES = c.TIMING_REPS = 1\n"
        "from tpufem_torch.cli import main\n"
        "s = ['--mesh_type', 'unstructured', '--ndofs', '3000', '--device',"
        " 'cpu']\n"
        "a = main(['--problem_type', 'cgpoisson'] + s)\n"
        "e = main(['--problem_type', 'elasticity', '-ksp_max_it', '8'] + s)\n"
        "assert a.iterations == 100 and e.iterations == 8\n"
        "print('JAX_LOADED', any(m == 'jax' or m.startswith('jax.')"
        " for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout
