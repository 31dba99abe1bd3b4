"""The port's row-sharded solver (tpufem_torch/parallel/rowshard.py)
against tpufem's ShardedEllSolver: the maps and rounds (fine and level
1), each shard's rows, dinv and RHS bit for bit, and the float64 solves
to tpufem's iteration counts and solutions (pinned by
scripts/sharded_reference.py) on a small cube at order 2 (the replicated
and the distributed level 1, and unpreconditioned), elasticity, and a
small spoke mesh (pure Neumann, deflated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpufem.config import SolverOptions as TpuOptions
from tpufem.fem.assemble import assemble_operator as tpu_assemble_operator
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.mesh.spoke import create_spoke_mesh as tpu_spoke
from tpufem.parallel.rowshard import ShardedEllSolver as TpuEll

from tpufem_torch.config import SolverOptions
from tpufem_torch.fem.assemble import assemble_csr_np
from tpufem_torch.fem.csr_spmv import CsrMatrix
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.la.amg import SAAMG
from tpufem_torch.la.cg import cg_solve
from tpufem_torch.la.nullspace import build_near_nullspace
from tpufem_torch.mesh.spoke import create_spoke_mesh
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.parallel.rowshard import ShardedEllSolver
from tpufem_torch.problems import common
from tpufem_torch.problems.elasticity import assemble_elasticity_rhs_np
from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
from test_torch_gmap import FIELDS

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
L1 = dict(amg_dense_level_limit=0, amg_coarse_eq_limit=50)

# name: (mesh, order, problem, shards, options, precond, rtol)
CASES = {
    "p2-2": ("cube", 2, "poisson", 2, {}, True, 1e-8),
    "p2-8": ("cube", 2, "poisson", 8, {}, True, 1e-8),
    "p2-8-cg": ("cube", 2, "poisson", 8, {}, False, 1e-6),
    "p2-l1": ("cube", 2, "poisson", 4, L1, True, 1e-8),
    "elasticity": ("cube6", 1, "elasticity", 4, {}, True, 1e-8),
    "spoke": ("spoke", 1, "poisson", 2, {}, True, 1e-8),
}
# tpufem's ShardedEllSolver.build(...).solve(), float64: (iterations,
# ||x||, x at 7 evenly spaced dofs) (python scripts/sharded_reference.py
# --case row_p2_2 ...)
TPUFEM = {
    "p2-2": (20, 17.491777958221363, [
        0.0, 0.26404822977483944, 0.2717017873056932, 0.0,
        0.2743806593837677, 0.278613939455366, -0.05538889635620071]),
    "p2-8": (20, 17.49177795822138, [
        0.0, 0.2640482297748399, 0.27170178730569344, 0.0,
        0.27438065938376804, 0.2786139394553664, -0.0553888963562007]),
    "p2-8-cg": (96, 17.491777956026063, [
        0.0, 0.26404821560529773, 0.27170182555472955, 0.0,
        0.2743807069170619, 0.2786140020101067, -0.05538882398146099]),
    "p2-l1": (24, 17.491777954365286, [
        0.0, 0.2640482285951079, 0.27170178693541047, 0.0,
        0.2743806579210305, 0.27861393927523187, -0.05538889620620532]),
    "elasticity": (14, 7.5515972499041445e-06, [
        0.0, 3.3777095724352903e-07, 2.2379222029397197e-07,
        3.399647862193836e-07, 2.049341401226441e-07,
        -1.0127942912206995e-07, 1.974223820505621e-07]),
    "spoke": (44, 285.86581296135404, [
        2.4451167531902587, 2.9908943499932676, 7.144249621510453,
        -0.7210032459209647, 3.487110708880719, 2.2935489519816685,
        -5.334214827408372]),
}


def _system(name: str):
    """(port space, bc, csr, b, nns), (tpufem space, bc, csr), case."""
    mesh_kind, order, problem, S, opts, precond, rtol = CASES[name]
    bs = 3 if problem == "elasticity" else 1
    marker = (common.elasticity_bc_marker if problem == "elasticity"
              else common.poisson_bc_marker)
    if mesh_kind == "spoke":
        mesh = create_spoke_mesh(1500, False, 1, S, verbose=False)
        tmesh = tpu_spoke(1500, False, 1, S, verbose=False)
    else:
        dims = (8, 9, 10) if mesh_kind == "cube" else (6, 6, 8)
        mesh, tmesh = BoxTetMesh(*dims), TpuMesh(*dims)
    space = FunctionSpace(mesh, order, bs=bs)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(marker))
    csr = assemble_csr_np(space, bc, problem)
    b = (assemble_elasticity_rhs_np(space) if bs > 1
         else assemble_poisson_rhs_np(space))
    b[bc.flat_dofs()] = 0.0
    if bc.flat_dofs().size == 0:
        b = b - b.mean()
    nns = (build_near_nullspace(space.scalar_dof_coords()) if bs > 1
           else None)
    tspace = TpuSpace(tmesh, order, bs=bs)
    tbc = TpuBC.from_space(tspace, tmesh.locate_boundary_facets(marker))
    _, tcsr = tpu_assemble_operator(tspace, tbc, problem, dtype=np.float64)
    return (space, bc, csr, b, nns), (tspace, tbc, tcsr), CASES[name]


def _build(name: str, S=None):
    (space, bc, csr, b, nns), _, case = _system(name)
    _, _, _, S0, opts, precond, rtol = case
    return ShardedEllSolver.build(
        space, bc, csr, b, S or S0, SolverOptions(**opts), dtype=F64,
        near_nullspace=nns, rtol=rtol, maxit=100, precond=precond,
        deflate=bc.flat_dofs().size == 0, device=CPU)


def _dense_rows(cols, vals, n):
    """Shard rows of a padded ELL [rows, K] as a dense [rows, n]."""
    out = np.zeros((cols.shape[0], n))
    np.add.at(out, (np.repeat(np.arange(cols.shape[0]), cols.shape[1]),
                    cols.reshape(-1)), vals.reshape(-1))
    return out


def _assert_maps(mine, ref):
    for f in FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        assert (np.array_equal(a, b) and a.dtype == b.dtype
                if isinstance(b, np.ndarray) else a == b), f


@pytest.mark.parametrize("name", ["p2-2", "p2-l1", "elasticity", "spoke"])
def test_setup_matches_tpufem(name):
    """Maps, rounds, each shard's rows, dinv and RHS, the first / second
    coarse sizes and the level-1 maps, against tpufem's build (which
    compiles nothing)."""
    (space, bc, csr, b, nns), (tspace, tbc, tcsr), case = _system(name)
    _, _, _, S, opts, precond, rtol = case
    for a, r in zip(csr, tcsr):
        assert np.array_equal(a, r)
    mine = _build(name)
    ref = TpuEll.build(tspace, tbc, tcsr, b, S, TpuOptions(**opts),
                       dtype=jnp.float64, near_nullspace=nns, rtol=rtol,
                       maxit=100, precond=precond,
                       deflate=bc.flat_dofs().size == 0)
    _assert_maps(mine.gmap, ref.gmap)
    n = mine.gmap.nlocal
    A = mine.data["A"].to_scipy().toarray()
    for s in range(S):
        want = _dense_rows(np.asarray(ref.data["ell_cols"][s]),
                           np.asarray(ref.data["ell_vals"][s]), n)
        got = A[s * n: s * n + mine.gmap.max_owned, s * n: (s + 1) * n]
        assert np.array_equal(got, want)
    assert np.array_equal(mine.data["dinv"].numpy(),
                          np.asarray(ref.data["dinv"]))
    assert np.array_equal(mine.data["b"].numpy(), np.asarray(ref.data["b"]))
    assert (mine.has_fine_level, mine.nc0, mine.dist_l1, mine.nc1) == \
        (ref.has_fine_level, ref.nc0, ref.dist_l1, ref.nc1)
    assert mine.lmax0 == ref.lmax0
    if mine.dist_l1:
        assert mine.gmap_c.rounds == ref.c_rounds
        assert mine.gmap_c.max_owned == ref.max_owned_c
        assert np.array_equal(mine.data["c_dinv"].numpy(),
                              np.asarray(ref.data["c_dinv"]))
        assert np.array_equal(mine.data["c_owned"].numpy(),
                              np.asarray(ref.data["c_owned_mask"]))
        assert mine.lmax1 == ref.lmax1


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_tpufem(name):
    sh = _build(name)
    x, it, rel = sh.solve()
    it_ref, n_ref, samples = TPUFEM[name]
    assert it == it_ref
    assert abs(np.linalg.norm(x) - n_ref) <= 1e-9 * n_ref
    idx = np.linspace(0, x.shape[0] - 1, len(samples)).astype(np.int64)
    assert np.abs(x[idx] - np.asarray(samples)).max() <= \
        1e-9 * np.abs(x).max()
    assert rel < CASES[name][6]
    if name == "p2-l1":
        assert sh.dist_l1
    if name == "spoke":
        assert abs(x.sum()) <= 1e-9 * np.abs(x).sum()  # mean zero


def test_matches_single_device_saamg():
    """S = 8 against the port's one-device SA-AMG on the same CSR."""
    (space, bc, csr, b, nns), _, _ = _system("p2-8")
    A = CsrMatrix.from_csr(*csr, F64, CPU)
    amg = SAAMG.setup(csr, 1, SolverOptions(), CPU, dtype=F64,
                      bc_mask=bc.mask())
    x1, it1, _ = cg_solve(A.matvec, torch.from_numpy(b),
                          precond=amg.as_preconditioner(), rtol=1e-8,
                          maxit=100)
    xs, its, _ = _build("p2-8").solve()
    assert its == it1
    assert np.abs(xs - x1.numpy()).max() <= 1e-9 * np.abs(xs).max()


def test_localized_rows_are_the_matrix():
    """Every shard's local product, refreshed, is the global product."""
    (space, bc, csr, b, nns), _, _ = _system("p2-8")
    sh = _build("p2-8")
    M = sp.csr_matrix((csr[2], csr[1], csr[0]))
    xg = np.random.default_rng(4).standard_normal(M.shape[0])
    y = sh._spmv(torch.from_numpy(sh.gmap.distribute(xg)))
    assert np.allclose(sh.gmap.collect(y.numpy(), M.shape[0]), M @ xg,
                       rtol=1e-13, atol=1e-13)
