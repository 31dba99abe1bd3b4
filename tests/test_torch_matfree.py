"""The port's matrix-free Poisson operator (fem.matfree_op: the metric,
the scatter plan, the plain version, the walk of the kernel's two
launches, convert.matfree_from_tpufem and the entry twin) against
tpufem's ``MatFreePoissonOp`` on the CPU: the spoke mesh at 3,000 dofs
(9,254 cells, weak scaling) at P1-P3, and the 8^3 box of
``__graft_entry__.entry()``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from tpufem.fem.assemble import DofScatter
from tpufem.fem.assemble import metric_np as tpu_metric_np
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.mesh.structured import BoxTetMesh as TpuBox
from tpufem.mesh.topology import TetTopology as TpuTopology
from tpufem.problems import common as tpu_common
from tpufem.problems.cgpoisson import make_action

from tpufem_torch import convert
from tpufem_torch.entry import entry
from tpufem_torch.fem.assemble import metric_np, scatter_plan
from tpufem_torch.fem.dia_op import build_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.matfree_op import (MatFreePoissonOp, kernel_tables,
                                         matfree_action, matfree_action_bound,
                                         matfree_action_walk,
                                         matfree_apply_plain, plan_segments)
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.spoke import create_spoke_mesh
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _spoke():
    """The port's spoke mesh of 3,000 dofs (weak scaling) and tpufem's
    topology over the same vertices and cells."""
    mesh = create_spoke_mesh(3000, False, 1, 1, verbose=False)
    return mesh, TpuTopology(mesh.vertices, mesh.cells())


def _pair(order, mesh, tmesh):
    """(port space, port bc, tpufem space, tpufem bc) of the Poisson
    Dirichlet planes at ``order``."""
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    tspace = TpuSpace(tmesh, order)
    tbc = TpuBC.from_space(
        tspace, tmesh.locate_boundary_facets(tpu_common.poisson_bc_marker))
    return space, bc, tspace, tbc


@functools.lru_cache(maxsize=None)
def _spoke_ops(order):
    """(port f64 operator, tpufem f64 operator and its scatter) on the
    3k spoke mesh."""
    mesh, tmesh = _spoke()
    space, bc, tspace, tbc = _pair(order, mesh, tmesh)
    scatter = DofScatter(tspace.cell_dofs, tspace.ndofs_scalar)
    return (MatFreePoissonOp.build(space, bc, torch.float64, CPU),
            make_action(tspace, tbc, scatter, jnp.float64), scatter)


def _x(n, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def test_metric_matches_tpufem():
    mesh, _ = _spoke()
    coords = mesh.cell_coords()
    assert np.array_equal(metric_np(coords), tpu_metric_np(coords))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_scatter_plan_matches_tpufem(order):
    """perm is tpufem's DofScatter perm, and the segments that the
    offsets give are its segments; the operator's metric, cell dofs and
    Dirichlet dofs are tpufem's make_action state."""
    op, top, scatter = _spoke_ops(order)
    assert np.array_equal(op.perm.numpy(), np.asarray(scatter.perm))
    off = op.offsets.numpy()
    assert off[0] == 0 and off[-1] == op.perm.numel()
    assert op.ndofs == off.size - 1
    assert np.array_equal(plan_segments(op).numpy(),
                          np.asarray(scatter.segments))
    assert np.array_equal(op.G.numpy(), np.asarray(top.G))
    assert np.array_equal(op.cd.numpy(), np.asarray(top.cd))
    assert np.array_equal(op.bc_flat.numpy(), np.asarray(top.bc_flat))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_plain_matches_tpufem_apply(order):
    """matfree_apply_plain against tpufem's MatFreePoissonOp.apply, f64,
    rel 1e-12 (the two run the same pipeline; their matrix products sum
    in other orders)."""
    op, top, _ = _spoke_ops(order)
    x = _x(op.ndofs, order)
    y = matfree_action(op, torch.from_numpy(x)).numpy()
    ref = np.asarray(top.apply(jnp.asarray(x)))
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


def test_plain_matches_entry():
    """The entry twin against ``__graft_entry__.entry()``'s output (P2 on
    the 8^3 box, float32: the same metric and x bits; float32 rounding of
    two summation orders), and its configuration in float64 against
    tpufem's make_action in float64 at rel 1e-12."""
    fn, (op, x) = entry(CPU)
    tfn, (top, tx) = __graft_entry__.entry()
    assert np.array_equal(x.numpy(), np.asarray(tx))
    assert np.array_equal(op.G.numpy(), np.asarray(top.G))
    y, ref = fn(op, x).numpy(), np.asarray(tfn(top, tx))
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
    box, tbox = BoxTetMesh(8, 8, 8), TpuBox(8, 8, 8)
    space, bc, tspace, tbc = _pair(2, box, tbox)
    op64 = MatFreePoissonOp.build(space, bc, torch.float64, CPU)
    top64 = make_action(tspace, tbc, DofScatter(tspace.cell_dofs,
                                                tspace.ndofs_scalar),
                        jnp.float64)
    x64 = _x(space.ndofs, 3)
    y64 = matfree_apply_plain(op64, torch.from_numpy(x64)).numpy()
    ref64 = np.asarray(top64.apply(jnp.asarray(x64)))
    assert np.abs(y64 - ref64).max() <= 1e-12 * np.abs(ref64).max()


def test_entry_matches_dia_rows_zero():
    """The entry twin's apply equals the port's DIA operator with the
    rows-zero convention on the same box (one matrix, two forms)."""
    fn, (op, x) = entry(CPU)
    mesh = BoxTetMesh(8, 8, 8)
    bc = DirichletBC.from_space(
        FunctionSpace(mesh, 2),
        mesh.locate_boundary_facets(common.poisson_bc_marker))
    dia = build_operator(mesh, 2, "poisson", bc_dofs=bc.flat_dofs(),
                         dtype=torch.float32, device=CPU, bake_bc=False)
    y, ref = fn(op, x), dia.apply_bc_rows_zero(x)
    assert float((y - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert bool((y[torch.from_numpy(bc.flat_dofs())] == 0).all())


@pytest.mark.parametrize("order", [1, 2, 3])
def test_convert_round_trip(order):
    """matfree_from_tpufem carries tpufem's operator state (read back as
    numpy) into the port: the port's own operator, array for array (the
    kernel's cluster plan too), and the same bits from the plain
    version."""
    op, top, scatter = _spoke_ops(order)
    got = convert.matfree_from_tpufem(
        np.asarray(top.G), np.asarray(top.cd), np.asarray(top.bc_flat),
        np.asarray(scatter.perm), np.asarray(scatter.segments), order,
        torch.float64, CPU)
    for name in ("G", "cd", "bc_flat", "perm", "offsets"):
        assert torch.equal(getattr(got, name), getattr(op, name)), name
    assert got.ndofs == op.ndofs and got.order == op.order
    # the kernel's cluster plan, built from tpufem's cd, is the port's
    for name in ("order", "clusters", "gid", "sum_idx", "sum_end",
                 "halo_dof", "halo_off", "halo_src"):
        assert np.array_equal(getattr(got.cplan, name),
                              getattr(op.cplan, name)), name
    x = torch.from_numpy(_x(op.ndofs, 5))
    assert torch.equal(matfree_apply_plain(got, x), matfree_apply_plain(op, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_walk_matches_plain(order, dtype):
    """The kernel's two launches (the clusters' cell values and sums in
    shared memory, then the halo's partials) walked in plain numpy agree
    with the plain version within matfree_action_bound, and well inside
    it."""
    op64, _, _ = _spoke_ops(order)
    mesh, _ = _spoke()
    op = op64 if dtype == torch.float64 else MatFreePoissonOp.from_arrays(
        metric_np(mesh.cell_coords()), op64.cd.numpy(),
        op64.bc_flat.numpy(), op64.ndofs, order, dtype, CPU)
    x = torch.from_numpy(_x(op.ndofs, 7)).to(dtype)
    y = matfree_apply_plain(op, x).numpy()
    err = np.abs(matfree_action_walk(op, x.numpy()) - y)
    bound = matfree_action_bound(op, x).numpy()
    assert (err <= 0.1 * bound).all()


@pytest.mark.parametrize("order", [1, 2, 3])
def test_kernel_tables_are_the_stiffness(order):
    """The six tables weighted by a metric give tpufem's element stiffness
    G : K (tpufem/fem/assemble.py:_poisson_stiffness_np) on random cells."""
    from tpufem.fem.assemble import _poisson_stiffness_np
    coords = np.random.default_rng(order).standard_normal((6, 4, 3))
    G = metric_np(coords)
    S = kernel_tables(order)
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    A = sum(G[:, a, b][:, None, None] * S[s] for s, (a, b) in enumerate(pairs))
    ref = _poisson_stiffness_np(coords, order)
    assert np.abs(A - ref).max() <= 1e-13 * np.abs(ref).max()
    assert all(np.array_equal(S[s], S[s].T) for s in range(6))


def _single_cell(order, ndofs_extra=0, bc=()):
    """One tetrahedron at ``order``, its dofs 0..n-1 in a space of n +
    ``ndofs_extra`` dofs (the extra dofs are in no cell)."""
    from tpufem_torch.fem.reference import ReferenceTet
    n = ReferenceTet(order).ndofs
    coords = np.array([[[0.0, 0.0, 0.0], [1.0, 0.1, 0.0], [0.2, 0.9, 0.1],
                        [0.1, 0.2, 1.1]]])
    cd = np.arange(n)[None, :]
    return MatFreePoissonOp.from_arrays(metric_np(coords), cd,
                                        np.asarray(bc, dtype=np.int64),
                                        n + ndofs_extra, order,
                                        torch.float64, CPU)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_edge_cases_walk_and_plain(order):
    """A single cell, dofs in no cell (their rows 0), a Dirichlet row (0):
    the walk and the plain version agree; the element stiffness is
    singular with the constant in its kernel."""
    op = _single_cell(order, ndofs_extra=3, bc=(1,))
    x = torch.from_numpy(_x(op.ndofs, 11))
    y = matfree_apply_plain(op, x)
    w = matfree_action_walk(op, x.numpy())
    assert np.abs(w - y.numpy()).max() <= 1e-13 * float(y.abs().max())
    assert float(y[1]) == 0.0 and bool((y[-3:] == 0).all())
    assert int((op.offsets[1:] == op.offsets[:-1]).sum()) == 3
    ones = torch.ones(op.ndofs, dtype=torch.float64)
    free = _single_cell(order, ndofs_extra=0)
    assert float(matfree_apply_plain(free, ones[:free.ndofs]).abs().max()) \
        <= 1e-13


def test_wrapper_checks():
    """The wrapper refuses x of another dtype, shape or device, and an
    operator of another dtype or order."""
    op = _single_cell(1)
    with pytest.raises(TypeError):
        matfree_action(op, torch.zeros(op.ndofs, dtype=torch.float32))
    with pytest.raises(ValueError):
        matfree_action(op, torch.zeros(op.ndofs + 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        matfree_action(op, torch.zeros(2 * op.ndofs,
                                       dtype=torch.float64)[::2])
    with pytest.raises(TypeError):
        MatFreePoissonOp.from_arrays(np.zeros((1, 3, 3)),
                                     np.arange(4)[None, :], [], 4, 1,
                                     torch.bfloat16, CPU)
    with pytest.raises(ValueError):
        MatFreePoissonOp.from_arrays(np.zeros((1, 3, 3)),
                                     np.arange(4)[None, :], [], 4, 2,
                                     torch.float64, CPU)


def test_scatter_plan_of_an_unused_dof():
    """scatter_plan's offsets give an empty slot range to a dof in no
    cell, and the plan is tpufem's stable argsort."""
    cd = np.array([[0, 2, 3, 5], [5, 3, 2, 0]])
    plan = scatter_plan(cd, 7)
    assert np.array_equal(plan.perm, np.argsort(cd.ravel(), kind="stable"))
    assert np.array_equal(plan.offsets, [0, 2, 2, 4, 6, 6, 8, 8])


def test_convert_refuses_a_dof_in_no_cell():
    """matfree_from_tpufem counts the dofs from tpufem's segments, so a
    scatter with a dof in no cell below the largest is refused rather
    than given a wrong count."""
    cd = np.array([[0, 2, 3, 5]])
    perm = np.argsort(cd.ravel(), kind="stable")
    with pytest.raises(ValueError, match="in no cell"):
        convert.matfree_from_tpufem(np.eye(3)[None], cd, np.zeros(0),
                                    perm, cd.ravel()[perm], 1,
                                    torch.float64, CPU)
