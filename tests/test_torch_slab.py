"""The port's slab-sharded cube solver (tpufem_torch/parallel/slab.py)
against tpufem's ShardedCubeSolver: the host arrays bit for bit (local
dofs, interface plans, dinv, Dirichlet and owned masks, the per-host
builders' dinv and partial-RHS slabs), the float64 solves to tpufem's
iteration counts and solutions (tpufem's values pinned by
scripts/sharded_reference.py: its P3 program compiles for a minute), the
port at S = 4 against the port at S = 1, and the per-host build against
the global one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.parallel import slab as tpu_slab

from tpufem_torch.fem.dia_op import build_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import grid_layout
from tpufem_torch.la.cg import cg_solve
from tpufem_torch.la.gmg import GMG
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.parallel import slab
from tpufem_torch.parallel.slab import ShardedCubeSolver, _default_rhs
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64

# tpufem's ShardedCubeSolver.build(...).solve(), float64, gather_limit 500:
# (iterations, ||x||, x at 7 evenly spaced dofs)
# (python scripts/sharded_reference.py --case slab_p1 ...)
TPUFEM = {
    ("poisson", 1, True): (10, 7.532131792372765, [
        0.0, 0.30147466323350475, 0.0, 0.2928953234260413, 0.0,
        0.34600912092807995, 0.0]),
    ("elasticity", 1, True): (19, 1.3469799663255643e-05, [
        0.0, 4.5814108148985043e-07, 2.06316048650835e-07,
        3.4406158088836327e-07, 5.07763193447022e-08,
        -2.95437087116115e-08, 2.1686131184978037e-07]),
    ("poisson", 2, False): (78, 11.382201359027349, [
        0.0, 0.48319895011168734, 0.07531298702765332, 0.24421091830210545,
        0.43166647103819034, 0.20948937045928875, -0.04325012739928925]),
    ("poisson", 3, True): (21, 37.07770272036796, [
        0.0, 0.0, 0.01881932948959518, 0.2670910177498702,
        0.04386724208492475, 0.03047207958977324, 0.0]),
}
# the same on BoxTetMesh(8, 8, 12) over 2 shards, P3 Poisson with GMG, rtol
# 1e-8, maxit 60 (--case slab_p3_const): slabs of 6 planes
TPUFEM_P3_CONST = (17, 32.29587310033683, [
    0.0, 0.2465275076997665, 0.2983182301471514, 0.38126639411062757,
    0.30386609963034983, 0.1636432929507599, 0.0])
# the solve of each case: (dims, rtol, maxit)
SOLVE = {True: ((8, 8, 16), 1e-8, 60), False: ((6, 6, 8), 1e-6, 400)}


def _kw(problem, order, precond):
    dims, rtol, maxit = SOLVE[precond]
    return dims, dict(problem=problem, order=order, rtol=rtol, maxit=maxit,
                      precond=precond, gather_limit=500)


def _assert_pinned(x, it, ref):
    it_ref, n_ref, samples = ref
    assert it == it_ref
    assert abs(np.linalg.norm(x) - n_ref) <= 1e-9 * n_ref
    idx = np.linspace(0, x.shape[0] - 1, len(samples)).astype(np.int64)
    scale = np.abs(x).max()
    assert np.abs(x[idx] - np.asarray(samples)).max() <= 1e-9 * scale


@pytest.mark.parametrize("key", list(TPUFEM), ids=lambda k: f"{k[0]}-P{k[1]}"
                         + ("" if k[2] else "-cg"))
def test_host_arrays_match_tpufem(key):
    """Every host array the solve reads, against tpufem's build of the
    same case (its build compiles nothing)."""
    problem, order, precond = key
    dims, kw = _kw(problem, order, precond)
    ref = tpu_slab.ShardedCubeSolver.build(TpuMesh(*dims), 4,
                                           dtype=jnp.float64, **kw)
    mine = ShardedCubeSolver.build(BoxTetMesh(*dims), 4, dtype=F64,
                                   device=CPU, **kw)
    assert len(mine.levels) == len(ref.levels)
    for lm, lr in zip(mine.levels, ref.levels):
        assert (lm.dims, lm.nzl, lm.order, lm.iface) == \
            (lr.dims, lr.nzl, lr.order, lr.iface)
        assert lm.lmax == lr.lmax
        assert np.array_equal(lm.dinv, np.asarray(lr.dinv))
        assert np.array_equal(lm.bc, np.asarray(lr.bc))
    assert np.array_equal(mine._ids0, ref._ids0)
    assert np.array_equal(mine.owned.numpy(), np.asarray(ref.owned))
    b_ref = np.asarray(ref.b_local)
    assert np.abs(mine.b_local.numpy() - b_ref).max() <= \
        1e-13 * np.abs(b_ref).max()
    if precond:
        assert mine.suffix.dims == ref.suffix.dims


@pytest.mark.parametrize("order,nzl,bs", [(1, 4, 1), (1, 2, 3), (2, 4, 1),
                                          (3, 2, 1), (2, 2, 3)])
def test_ids_and_interface_plans_bitwise(order, nzl, bs):
    S = 3
    mine, lay = slab.slab_global_ids(BoxTetMesh(4, 5, nzl * S), order, nzl,
                                     S, bs)
    ref, lay_r = tpu_slab.slab_global_ids(TpuMesh(4, 5, nzl * S), order,
                                          nzl, S, bs)
    assert np.array_equal(mine, ref)
    assert slab.iface_plan(lay, nzl, bs) == tpu_slab.iface_plan(lay_r, nzl,
                                                                 bs)


@pytest.mark.parametrize("problem,order", [("poisson", 1), ("poisson", 2),
                                           ("poisson", 3), ("elasticity", 1)])
def test_per_host_builders_bitwise(problem, order):
    """The slab-local dinv rows and partial RHS of each shard, tpufem's
    functions on the same slab diagonal."""
    S, nzl = 4, 2
    mesh, tmesh = BoxTetMesh(6, 6, S * nzl), TpuMesh(6, 6, S * nzl)
    bs = 3 if problem == "elasticity" else 1
    op = build_operator(BoxTetMesh(6, 6, nzl), order, problem,
                        dtype=F64, bake_bc=False)
    d = op.diagonal_np()
    lay = grid_layout(BoxTetMesh(6, 6, nzl), order)
    from tpufem.fem.structured_op import grid_layout as tpu_layout
    lay_r = tpu_layout(TpuMesh(6, 6, nzl), order)
    for s in range(S):
        assert np.array_equal(slab._slab_dinv_row_k(d, lay, nzl, bs, s, S),
                              tpu_slab._slab_dinv_row_k(d, lay_r, nzl, bs,
                                                        s, S))
        assert np.array_equal(
            slab._slab_partial_rhs(mesh, problem, s, S, nzl, order),
            tpu_slab._slab_partial_rhs(tmesh, problem, s, S, nzl, order))
    if order == 1 and bs == 1:
        d3 = d.reshape(nzl + 1, -1)
        for s in range(S):
            assert np.array_equal(slab._slab_dinv_row(d3, s, S, nzl),
                                  tpu_slab._slab_dinv_row(d3, s, S, nzl))


def test_slab_gmg_viable_matches_tpufem():
    for dims in [(8, 8, 16), (8, 8, 10), (8, 8, 8), (4, 4, 8), (16, 24, 32),
                 (6, 6, 12)]:
        for S in (2, 3, 4, 8):
            for bs in (1, 3):
                for pre in (True, False):
                    assert slab.slab_gmg_viable(
                        BoxTetMesh(*dims), S, bs, 1000, 12, pre) == \
                        tpu_slab.slab_gmg_viable(TpuMesh(*dims), S, bs,
                                                 1000, 12, pre)


@pytest.mark.parametrize("key", list(TPUFEM), ids=lambda k: f"{k[0]}-P{k[1]}"
                         + ("" if k[2] else "-cg"))
def test_solve_matches_tpufem(key):
    problem, order, precond = key
    dims, kw = _kw(problem, order, precond)
    sh = ShardedCubeSolver.build(BoxTetMesh(*dims), 4, dtype=F64,
                                 device=CPU, **kw)
    x, it, rel = sh.solve()
    _assert_pinned(x, it, TPUFEM[key])
    assert rel < kw["rtol"]


def _single_device(mesh, problem, order, rtol, maxit):
    """The port's one-device CG + GMG solve of the same system (the
    Dirichlet rows of b zero)."""
    bs = 3 if problem == "elasticity" else 1
    marker = (common.elasticity_bc_marker if problem == "elasticity"
              else common.poisson_bc_marker)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order, bs=bs),
                                mesh.locate_boundary_facets(marker))
    b = _default_rhs(mesh, problem, bs, order)
    b[bc.flat_dofs()] = 0.0
    planar = bs > 1
    A = build_operator(mesh, order, problem, bc_dofs=bc.flat_dofs(),
                       dtype=F64, device=CPU, planar=planar)
    bt = torch.from_numpy(b)
    if planar:
        bt = bt.reshape(-1, 3).T.reshape(-1)
    pc = GMG.setup(mesh, order, problem, marker, CPU, dtype=F64,
                   planar=planar)
    x, it, _ = cg_solve(A.apply, bt, precond=pc.vcycle, rtol=rtol,
                        maxit=maxit)
    if planar:
        x = x.reshape(3, -1).T.reshape(-1)
    return x.numpy(), it


@pytest.mark.parametrize("problem,order,S", [
    ("poisson", 1, 4), ("elasticity", 1, 4), ("elasticity", 2, 2)])
def test_sharded_matches_single_device(problem, order, S):
    """Against the port's own one-device solve: the same GMG hierarchy,
    so equal iterations and solutions to rounding (P2 elasticity: the
    blocked per-perm slab operator and the p-transfer on the slabs,
    tpufem's test_sharded_pk_elasticity_matches_single_device)."""
    dims, kw = _kw(problem, order, True)
    mesh = BoxTetMesh(*dims)
    xs, its, _ = ShardedCubeSolver.build(mesh, S, dtype=F64, device=CPU,
                                           **kw).solve()
    x1, it1 = _single_device(mesh, problem, order, kw["rtol"], kw["maxit"])
    assert its == it1
    assert np.abs(xs - x1).max() <= 1e-10 * np.abs(x1).max()


@pytest.mark.parametrize("order,nzl,const", [
    (2, 6, True), (3, 6, True), (3, 4, False)])
def test_scalar_pk_slab_operator(order, nzl, const):
    """A scalar P2 / P3 slab of 6 planes or more is the const DIA (the
    dia_zones kernel on a card), carrying the global h; a thinner P3
    slab the per-perm product.  Either is the same matrix as the per-perm
    element matrices with the global h."""
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.structured_op import StructuredOperator
    sl = BoxTetMesh(6, 6, nzl)
    h = (1.0 / 6, 1.0 / 6, 1.0 / (4 * nzl))
    op = slab._slab_operator(sl, order, "poisson", F64, CPU, h)
    assert isinstance(op, DiaOperator) == const
    if const:
        assert op.is_const() and op.multi_kind
    ref = StructuredOperator.build(sl, order, "poisson", dtype=F64,
                                   device=CPU, h_override=h)
    x = torch.from_numpy(np.random.default_rng(order).standard_normal(
        ref.layout.ndofs))
    y, y_ref = op.apply(x), ref.apply_raw(x)
    assert (y - y_ref).abs().max() <= 1e-12 * y_ref.abs().max()


def test_p3_const_slabs_match_tpufem_and_one_device():
    """P3 GMG over 2 slabs of 6 planes, whose fine slab operators are the
    const DIA where tpufem's are the per-perm form: tpufem's iterations
    and solution, and the port's one-device solve."""
    mesh = BoxTetMesh(8, 8, 12)
    kw = dict(problem="poisson", order=3, rtol=1e-8, maxit=60, precond=True,
              gather_limit=500, device=CPU)
    sh = ShardedCubeSolver.build(mesh, 2, dtype=F64, **kw)
    assert sh.levels[0].op.is_const() and sh.levels[0].nzl == 6
    x, it, rel = sh.solve()
    _assert_pinned(x, it, TPUFEM_P3_CONST)
    assert rel < kw["rtol"]
    x1, it1 = _single_device(mesh, "poisson", 3, kw["rtol"], kw["maxit"])
    assert it == it1
    assert np.abs(x - x1).max() <= 1e-10 * np.abs(x1).max()


@pytest.mark.parametrize("problem,order,precond", [
    ("poisson", 1, True), ("elasticity", 1, True), ("poisson", 3, True),
    ("poisson", 2, False)])
def test_per_host_build_matches_global(problem, order, precond):
    """build_per_host (each shard from slab-local data) against build
    (tpufem/tests/test_multihost.py's case), and both solves."""
    dims, kw = _kw(problem, order, precond)
    mesh = BoxTetMesh(*dims)
    a = ShardedCubeSolver.build(mesh, 4, dtype=F64, device=CPU, **kw)
    b = ShardedCubeSolver.build_per_host(mesh, 4, dtype=F64, device=CPU,
                                         **kw)
    scale = a.b_local.abs().max()
    assert (b.b_local - a.b_local).abs().max() <= 1e-12 * scale
    for la, lb in zip(a.levels, b.levels):
        assert np.allclose(lb.dinv, la.dinv, rtol=1e-12, atol=0)
        assert np.array_equal(lb.bc, la.bc)
        assert lb.iface == la.iface
    assert torch.equal(a.owned, b.owned)
    if order == 3 or not precond:
        return  # their solves run in test_solve_matches_tpufem
    xa, ita, _ = a.solve()
    xb, itb, _ = b.solve()
    assert ita == itb
    assert np.abs(xa - xb).max() <= 1e-10 * np.abs(xa).max()


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="not divisible"):
        ShardedCubeSolver.build(BoxTetMesh(8, 8, 10), 4, device=CPU)
    with pytest.raises(ValueError, match="must be even"):
        ShardedCubeSolver.build(BoxTetMesh(8, 8, 8), 4, dtype=F64,
                                device=CPU)
