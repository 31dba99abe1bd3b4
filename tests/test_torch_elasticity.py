"""The port's elasticity operator pieces (tpufem_torch) against tpufem's,
in float64 on the CPU unless stated: the planar bs = 3 DIA build and
apply, the three-component stencil's plain version (what the CUDA
kernel is held to on the card), planar GMG, the RHS and the rigid-body
near-nullspace.

Tolerances: exact equality for the host builds (the same numpy
arithmetic); rel 1e-13 for applies (f64 sums of 45 terms in the same
order, tpufem's through XLA); 1e-12 for a V-cycle (tpufem's own test of
its GMG); rel 1e-6 for the float32 RHS (the same f32 products, XLA
against PyTorch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dia_op import DiaOperator as TpuDia
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.la import gmg as tpu_gmg
from tpufem.la import nullspace as tpu_nullspace
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import common as tpu_common
from tpufem.problems import elasticity as tpu_elasticity

from tpufem_torch import convert
from tpufem_torch.fem import stencil
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.stencil import (ZONE_ROWS, stencil_apply_bs3,
                                      stencil_apply_bs3_plain)
from tpufem_torch.la import gmg, nullspace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common, elasticity

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")

# (Nx, Ny, Nz): >= 6 cubes per axis builds the const (zone) form, smaller
# lattices the dense form
DIMS = [(8, 6, 10), (6, 6, 6), (5, 7, 6), (4, 4, 8)]


def _bc(dims):
    mesh = BoxTetMesh(*dims)
    return DirichletBC.from_space(
        FunctionSpace(mesh, 1, bs=3),
        mesh.locate_boundary_facets(common.elasticity_bc_marker)).flat_dofs()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("planar", [False, True], ids=["interleaved",
                                                       "planar"])
@pytest.mark.parametrize("dims", DIMS)
def test_build_equals_tpufem(dims, planar):
    """Plan, block weights, the (r, s) zone plan and its fields, the bc
    mask (permuted when planar), the diagonal and the CSR export."""
    bc = _bc(dims)
    ref = TpuDia.build(TpuMesh(*dims), 1, "elasticity", bc_dofs=bc,
                       dtype=jnp.float64, device=False, planar=planar)
    op = DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity", bc_dofs=bc,
                           dtype=torch.float64, planar=planar)
    assert op.bs == ref.bs == 3 and op.planar == ref.planar == planar
    assert op.is_const() == ref.is_const() == (min(dims) >= 6)
    assert op.plan == ref.plan
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(op.weights, ref.weights))
    assert op.zone_plan == ref.zone_plan
    if ref.zones is not None:
        assert len(op.zone_plan) == 135  # 15 shifts x 9 (r, s)
        assert all(np.array_equal(a, b) for za, zb in zip(op.zones, ref.zones)
                   for a, b in zip(za, zb))
    assert np.array_equal(op.bc_mask_np, np.asarray(ref.bc_mask))
    assert np.array_equal(op.diagonal_np(), ref.diagonal_np())
    A, B = op.to_scipy(), ref.to_scipy()
    assert (np.array_equal(A.indptr, B.indptr)
            and np.array_equal(A.indices, B.indices)
            and np.array_equal(A.data, B.data))


def test_float32_zone_fields_equal_tpufem():
    bc = _bc((8, 6, 10))
    ref = TpuDia.build(TpuMesh(8, 6, 10), 1, "elasticity", bc_dofs=bc,
                       dtype=jnp.float32, device=False, planar=True)
    op = DiaOperator.build(BoxTetMesh(8, 6, 10), 1, "elasticity",
                           bc_dofs=bc, dtype=torch.float32, planar=True,
                           device=CPU)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype == np.float32
               for za, zb in zip(op.zones, ref.zones) for a, b in zip(za, zb))
    # the device stack: [3 (r), D, 3 (s)] fields in zone form
    assert op.fields.dtype == torch.float32
    assert tuple(op.fields.shape) == (135, ZONE_ROWS, 7, 9)


@pytest.mark.parametrize("dims", DIMS)
def test_planar_apply_matches_tpufem(dims):
    """The port's apply (the three-component plain version on the CPU)
    against tpufem's planar ``_apply_zones`` (its dense form on small
    lattices) and against both host twins."""
    bc = _bc(dims)
    ref = TpuDia.build(TpuMesh(*dims), 1, "elasticity", bc_dofs=bc,
                       dtype=jnp.float64, planar=True)
    op = DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity", bc_dofs=bc,
                           dtype=torch.float64, planar=True, device=CPU)
    x = np.random.default_rng(0).standard_normal(op.layout.ndofs * 3)
    y = op.apply(torch.from_numpy(x)).numpy()
    assert _rel(y, np.asarray(ref.apply(jnp.asarray(x)))) <= 1e-13
    y_np = op.apply_np(x)
    assert np.array_equal(y_np, ref.apply_np(x))
    assert _rel(y, y_np) <= 1e-13
    assert torch.equal(op.apply(torch.from_numpy(x)), stencil_apply_bs3_plain(
        torch.from_numpy(x), op.fields, op.offsets, op.grid_dims))


def test_interleaved_operator_stays_on_the_host():
    """The interleaved bs = 3 operator (the certification twin, the lmax
    surrogate) is host-only: its apply_np is the planar one permuted, and
    a device build of it is refused (the solve runs planar)."""
    dims = (6, 7, 8)
    bc = _bc(dims)
    inter = DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity",
                              bc_dofs=bc, dtype=torch.float64)
    planar = DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity",
                               bc_dofs=bc, dtype=torch.float64, planar=True)
    x = np.random.default_rng(1).standard_normal(3 * inter.layout.ndofs)
    xp = x.reshape(-1, 3).T.reshape(-1)
    assert np.array_equal(planar.apply_np(xp),
                          inter.apply_np(x).reshape(-1, 3).T.reshape(-1))
    assert np.array_equal(planar.bc_mask_np,
                          inter.bc_mask_np.reshape(-1, 3).T.reshape(-1))
    with pytest.raises(NotImplementedError, match="planar"):
        DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity", bc_dofs=bc,
                          dtype=torch.float64, device=CPU)


def test_dense_field_form_equals_zone_form():
    """A const-mode operator and its dense build give the same apply
    through the two field forms (R = 7 and R = Z)."""
    dims = (6, 7, 9)
    bc = _bc(dims)
    zone, full = (DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity",
                                    bc_dofs=bc, dtype=torch.float64,
                                    mode=mode, device=CPU, planar=True)
                  for mode in ("const", "dense"))
    assert zone.fields.shape[1] == ZONE_ROWS
    assert full.fields.shape[1] == zone.grid_dims[0]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        3 * zone.layout.ndofs))
    torch.testing.assert_close(zone.apply(x), full.apply(x), rtol=0,
                               atol=1e-12)


def test_bs3_wrapper_checks_and_never_falls_back():
    op = DiaOperator.build(BoxTetMesh(6, 6, 6), 1, "elasticity",
                           bc_dofs=_bc((6, 6, 6)), dtype=torch.float64,
                           device=CPU, planar=True)
    grid, f, offs = op.grid_dims, op.fields, op.offsets
    n = 3 * op.layout.ndofs
    before = stencil_apply_bs3.launches
    x = torch.zeros(n, dtype=torch.float64)
    with pytest.raises(TypeError):
        stencil_apply_bs3(x.float(), f, offs, grid)          # dtype mismatch
    with pytest.raises(ValueError):
        stencil_apply_bs3(x[: n // 3], f, offs, grid)         # one component
    with pytest.raises(ValueError):
        stencil_apply_bs3(x, f[:-1].contiguous(), offs, grid)  # not 9 D fields
    with pytest.raises(ValueError):
        stencil_apply_bs3(x, f, offs[:-1], grid)              # offsets vs D
    with pytest.raises(ValueError):                           # over 15 shifts
        stencil_apply_bs3(x, torch.cat([f, f[:9]]).contiguous(),
                          offs + ((1, 1, 1),), grid)
    with pytest.raises(RuntimeError):                         # no kernel there
        stencil_apply_bs3(x.to("meta"), f.to("meta"), offs, grid)
    assert torch.equal(stencil_apply_bs3(x, f, offs, grid),
                       stencil_apply_bs3_plain(x, f, offs, grid))
    assert stencil_apply_bs3.launches == before  # the CPU launches nothing
    assert "_stencil" not in op.__dict__          # no launch was prepared


@pytest.mark.parametrize("dims,R,itemsize,run", [
    ((65, 49, 49), 7, 4, 4), ((65, 49, 49), 7, 8, 4),
    ((33, 25, 25), 7, 8, 4), ((9, 7, 7), 9, 8, 1), ((20, 3, 1200), 7, 8, 1),
    # the elasticity_10m row's grid (128x160x160 cubes)
    ((161, 161, 129), 7, 4, 4), ((161, 161, 129), 7, 8, 4)])
def test_three_component_runs_fit_the_shared_memory(dims, R, itemsize, run):
    """A block of the three-component kernel stages the run's planes of
    all three source components once for its three output components:
    128 points of the plane and X + 1 either side, z runs of at most 4
    mid planes, cut where the three components' planes would not fit
    227 KB."""
    Z, Y, X = dims
    runs = stencil.stencil_runs(dims, R, itemsize, comps=3)
    assert runs[:, 1].sum() == Z and int(runs[:, 1].max()) == run
    assert stencil.stencil_smem_bytes(run, X, itemsize, 3) <= stencil._MAX_SMEM
    assert (stencil.stencil_smem_bytes(run, X, itemsize, 3)
            == 3 * (run + 2) * (128 + 2 * (X + 1)) * itemsize)
    with pytest.raises(RuntimeError, match="shared memory"):
        stencil.stencil_runs((9, 3, 15000), 7, 8, comps=3)


# (cells, mode, dtype): the 9x7x7 GMG level's grid, a 17x13x13 grid wider
# than a block's 128 points (a partial last tile), two dense-mode lattices
# (full fields, R = Z) and a grid whose rows are wider than the tile
WALKS = {
    "level-9x7x7": ((6, 6, 8), "const", torch.float64),
    "level-33x25x25": ((24, 24, 32), "const", torch.float32),
    "17x13x13-partial-tile": ((12, 12, 16), "const", torch.float32),
    "dense-7x8x6": ((5, 7, 6), "dense", torch.float64),
    "dense-9x5x5": ((4, 4, 8), "dense", torch.float32),
    "wide-rows-21x7x41": ((40, 6, 20), "const", torch.float64),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _rebuilt_fields(packed, fields, dims):
    """The [9 D, R, Y, X] fields the table's segments give."""
    Z, Y, X = dims
    rows = stencil._field_rows(Z, fields.shape[1])
    W = packed.table[packed.classes.long()]  # [P, Y, X, 3, D, 3]
    out = torch.full_like(fields, float("nan"))
    for z0, z1, q in packed.segments:
        for z in range(z0, z1):
            out[:, rows[z]] = W[q].permute(2, 3, 4, 0, 1).reshape(-1, Y, X)
    return out


@pytest.mark.parametrize("sms", [None, 1], ids=["h100", "one-sm"])
@pytest.mark.parametrize("name", list(WALKS))
def test_three_component_walk_gives_the_plain_versions_bits(name, sms):
    """``stencil_bs3_walk`` (the kernel's blocks, stage, masks, runs, the
    table's weights and sum order, with the product and the sum
    rounded apart) is the plain version bit for bit; the table and class
    bytes of every one of these operators rebuild the fields bit for bit:
    on an H100 the kernel with a thread an output (these grids' blocks
    fit one wave), on a card of one SM the kernel with a thread a point;
    the walk's counts are ``stencil_bs3_counts``'s, its shared memory the
    launch's, and it loads fewer weights than the fields would give, one
    a point and (r, d, s) term a run."""
    cells, mode, dtype = WALKS[name]
    mesh = BoxTetMesh(*cells)
    op = DiaOperator.build(mesh, 1, "elasticity", bc_dofs=_bc(cells),
                           dtype=dtype, mode=mode, device=CPU, planar=True)
    dims, fields = op.grid_dims, op.fields
    Z, Y, X = dims
    x = torch.from_numpy(np.random.default_rng(len(name)).standard_normal(
        3 * Z * Y * X)).to(dtype)
    y, n = stencil.stencil_bs3_walk(x, fields, op.offsets, dims, sms)
    assert torch.equal(y, stencil_apply_bs3_plain(x, fields, op.offsets,
                                                  dims))
    plan = stencil.stencil_bs3_plan(fields, op.offsets, dims, sms)
    assert plan.per_point == (sms == 1)
    assert torch.equal(_bits(_rebuilt_fields(plan.table, fields, dims)),
                       _bits(fields))
    assert n == stencil.stencil_bs3_counts(fields, op.offsets, dims, sms)
    tiles = -(-(Y * X) // plan.tile)
    assert n["blocks"] == tiles * len(plan.runs)
    assert sum(nz for _, nz, _ in plan.runs) == Z
    assert n["weight_loads"] < fields.shape[0] * Y * X * len(plan.runs)
    smem = (stencil.bs3_table_smem_bytes if plan.per_point else
            lambda run, X, item: stencil.stencil_smem_bytes(run, X, item, 3))
    assert n["smem"] == smem(plan.run, X, x.element_size()) \
        <= stencil._MAX_SMEM
    assert (fields.shape[1] == Z) == (mode == "dense")


def test_elasticity_fields_hold_28_distinct_columns():
    """The 32x40x40 operator's 135 zone fields carry 28 distinct
    135-weight columns, 10 on each zone row; rows 1 to 5 share one class
    pattern, so the table has three segments of planes: z = 0,
    1 .. Z - 2, Z - 1."""
    cells = (32, 40, 40)
    op = DiaOperator.build(BoxTetMesh(*cells), 1, "elasticity",
                           bc_dofs=_bc(cells), dtype=torch.float32,
                           device=CPU, planar=True)
    Z = op.grid_dims[0]
    packed = stencil.compress_bs3(op.fields, op.grid_dims)
    assert tuple(packed.table.shape) == (28, 3, 15, 3)
    assert [len(torch.unique(c)) for c in packed.classes] == [10, 10, 10]
    assert [(z0, z1) for z0, z1, _ in packed.segments] == [
        (0, 1), (1, Z - 1), (Z - 1, Z)]
    assert torch.equal(_bits(_rebuilt_fields(packed, op.fields,
                                             op.grid_dims)),
                       _bits(op.fields))


def test_fields_without_a_table_have_no_kernel(monkeypatch):
    """Fields the table cannot hold raise, in ``compress_bs3`` and in the
    plan: random fields (a column a point), more distinct columns than
    MAX_CLASSES_BS3, and full fields (R = Z) whose planes alternate two
    patterns, more segments than MAX_SEGMENTS_BS3; so do shifts other
    than the Kuhn stencil's, which the kernels are built for.  The
    dense-mode (R = Z) operator itself has its table."""
    cells = (4, 4, 8)
    op = DiaOperator.build(BoxTetMesh(*cells), 1, "elasticity",
                           bc_dofs=_bc(cells), dtype=torch.float64,
                           mode="dense", device=CPU, planar=True)
    dims, fields = op.grid_dims, op.fields
    assert len(stencil.compress_bs3(fields, dims).segments) == 3
    assert op.offsets == stencil.P1_OFFSETS
    rng = np.random.default_rng(6)
    noise = torch.from_numpy(rng.standard_normal(tuple(fields.shape)))
    with pytest.raises(ValueError, match="distinct weight columns"):
        stencil.compress_bs3(noise, dims)
    with pytest.raises(ValueError, match="distinct weight columns"):
        stencil.stencil_bs3_plan(noise, op.offsets, dims)
    flipped = tuple((-dx, dy, dz) for dx, dy, dz in op.offsets)
    with pytest.raises(ValueError, match="15 shifts"):
        stencil.stencil_bs3_plan(fields, flipped, dims)
    alternating = fields.clone()
    alternating[:, 1::2] *= 2  # R = Z = 9: nine segments
    assert fields.shape[1] == 9
    with pytest.raises(ValueError, match="segments"):
        stencil.compress_bs3(alternating, dims)
    monkeypatch.setattr(stencil, "MAX_CLASSES_BS3", 27)
    with pytest.raises(ValueError, match="over the table's 27"):
        stencil.compress_bs3(fields, dims)


def test_table_form_cuts_the_10m_grids_weight_loads():
    """At 161x161x129 (the 10M-dof elasticity cell's grid) a kernel that
    read the fields (blocks of 128 points, the zone rows' runs of
    ``stencil_runs``) would load 135 weights a point a run: 990,225 tile
    loads over its 7,335 blocks, 126,171,675 values; the table's 1,722
    blocks of 512 points (the kernel with a thread a point) load at least
    ten times fewer, and stage half as many values."""
    cells = (128, 160, 160)
    op = DiaOperator.build(BoxTetMesh(*cells), 1, "elasticity",
                           bc_dofs=_bc(cells), dtype=torch.float32,
                           device=CPU, planar=True)
    dims = Z, Y, X = op.grid_dims
    assert dims == (161, 161, 129)
    field_runs = len(stencil.stencil_runs(dims, 7, 4, 3))
    tiles = -(-(Y * X) // stencil._TILE3)
    assert tiles * field_runs * 135 == 990225
    n = stencil.stencil_bs3_counts(op.fields, op.offsets, dims)
    assert n["blocks"] == 41 * 42 < tiles * field_runs
    assert 10 * n["weight_loads"] <= 135 * Y * X * field_runs == 126171675
    field_staged = tiles * 3 * 251 * (128 + 2 * (X + 1))
    assert 2 * n["staged"] <= field_staged


def test_convert_carries_tpufem_planar_operator():
    """dia_from_numpy on tpufem's planar bs = 3 host state gives the
    operator the port's own build gives."""
    dims = (8, 6, 10)
    bc = _bc(dims)
    ref = TpuDia.build(TpuMesh(*dims), 1, "elasticity", bc_dofs=bc,
                       dtype=jnp.float64, device=False, planar=True)
    got = convert.dia_from_numpy(
        ref.plan, ref.weights, np.asarray(ref.bc_mask), dims, CPU,
        zone_plan=ref.zone_plan, zones=ref.zones, surr_dims=ref.surr_dims,
        bs=ref.bs, planar=ref.planar)
    own = DiaOperator.build(BoxTetMesh(*dims), 1, "elasticity", bc_dofs=bc,
                            dtype=torch.float64, device=CPU, planar=True)
    assert got.offsets == own.offsets and got.planar and got.bs == 3
    assert torch.equal(got.fields, own.fields)
    assert torch.equal(got.bc_mask, own.bc_mask)


# -- planar GMG ----------------------------------------------------------------
MESH_G = (8, 8, 16)


@pytest.fixture(scope="module")
def gmg_pair():
    """tpufem's and the port's float64 planar GMG on 8x8x16 (one smoothed
    level + the 4x4x8 dense coarse solve, 675 dofs)."""
    ref = tpu_gmg.GMG.setup(TpuMesh(*MESH_G), 1, "elasticity",
                            tpu_common.elasticity_bc_marker,
                            dtype=jnp.float64, planar=True)
    port = gmg.GMG.setup(BoxTetMesh(*MESH_G), 1, "elasticity",
                         common.elasticity_bc_marker, CPU,
                         dtype=torch.float64, planar=True)
    return ref, port


def test_gmg_setup_matches_tpufem(gmg_pair):
    ref, port = gmg_pair
    assert port.dims == ref.dims and port.planar and port.bs == 3
    ci = np.asarray(ref.coarse_inv)
    assert np.abs(port.coarse_inv.numpy() - ci).max() <= 1e-12 * np.abs(ci).max()
    assert np.array_equal(port.coarse_bc_mask.numpy(),
                          np.asarray(ref.coarse_bc_mask))
    for lv, lv_ref in zip(port.levels, ref.levels):
        assert lv.lmax == lv_ref.lmax
        assert np.array_equal(lv.dinv.numpy(), np.asarray(lv_ref.dinv))
        assert np.array_equal(lv.op.bc_mask.numpy(),
                              np.asarray(lv_ref.op.bc_mask))


def test_vcycle_matches_tpufem(gmg_pair):
    ref, port = gmg_pair
    n = 3 * TpuMesh(*MESH_G).num_vertices_global
    r = np.random.default_rng(2).standard_normal(n)
    want = np.asarray(jax.jit(ref.vcycle)(jnp.asarray(r)))
    assert _rel(port.vcycle(torch.from_numpy(r)).numpy(), want) <= 1e-12
    # the same V-cycle from tpufem's arrays carried over by convert
    lv = ref.levels[0]
    op = convert.dia_from_numpy(
        lv.op.plan, lv.op.weights, np.asarray(lv.op.bc_mask), ref.dims[0],
        CPU, zone_plan=lv.op.zone_plan,
        zones=[[np.asarray(f) for f in z] for z in lv.op.zones],
        surr_dims=lv.op.surr_dims, bs=3, planar=True)
    carried = convert.gmg_from_numpy(
        [op], [np.asarray(lv.dinv)], [lv.lmax], np.asarray(ref.coarse_inv),
        np.asarray(ref.coarse_bc_mask), ref.dims, CPU, bs=3, planar=True)
    assert _rel(carried.vcycle(torch.from_numpy(r)).numpy(), want) <= 1e-12


def test_batched_transfers_act_per_component():
    """The h-transfers on [3, Z, Y, X] are the scalar ones per component."""
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.standard_normal((3, 5, 4, 3)))
    f = torch.from_numpy(rng.standard_normal((3, 9, 7, 5)))
    for batched, one in ((gmg.prolong_h(c), [gmg.prolong_h(v) for v in c]),
                         (gmg.restrict_h(f), [gmg.restrict_h(v) for v in f])):
        assert torch.equal(batched, torch.stack(one))


@pytest.mark.parametrize("dims", [(8, 8, 16), (12, 12, 20), (48, 48, 64)])
def test_level_walk_and_lmax_match_tpufem(dims):
    """The walk counts bs * nodes (48x48x64 stops at 3x3x4, 240 dofs, not
    at 6x6x8), and lmax comes from tpufem's interleaved surrogate."""
    mine = gmg.hierarchy(BoxTetMesh(*dims), bs=3)
    assert [(m.Nx, m.Ny, m.Nz) for m in mine][-1] == tuple(
        v >> (len(mine) - 1) for v in dims)
    if dims == (48, 48, 64):
        assert (mine[-1].Nx, mine[-1].Ny, mine[-1].Nz) == (3, 3, 4)
    for probe in (dims, (10, 10, 10), (40, 40, 40), (16, 16, 32)):
        assert (gmg.gmg_viable(BoxTetMesh(*probe), 3)
                == tpu_gmg.gmg_viable(TpuMesh(*probe), 3))
    for dtype in ("float32", "float64"):
        assert (gmg.surrogate_lmax(BoxTetMesh(*dims), 1, "elasticity",
                                   common.elasticity_bc_marker,
                                   getattr(torch, dtype))
                == tpu_gmg.surrogate_lmax(TpuMesh(*dims), 1, "elasticity",
                                          tpu_common.elasticity_bc_marker,
                                          getattr(jnp, dtype)))


# -- RHS and near-nullspace --------------------------------------------------
def test_float32_device_rhs_matches_tpufem():
    """Three scalar mass applies of the body force evaluated from
    coordinates, interleaved, BC values set."""
    dims = (8, 6, 10)
    tmesh = TpuMesh(*dims)
    tspace = TpuSpace(tmesh, 1, bs=3)
    tbc = TpuBC.from_space(tspace, tmesh.locate_boundary_facets(
        tpu_common.elasticity_bc_marker))
    want = np.asarray(tpu_elasticity.assemble_elasticity_rhs_structured_dev(
        tspace, tbc, jnp.float32))
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(
        common.elasticity_bc_marker))
    mass = DiaOperator.build(mesh, 1, "mass", dtype=torch.float32,
                             device=CPU)
    got = elasticity.assemble_elasticity_rhs_structured_dev(space, bc, mass)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy().astype(np.float64), want.astype(np.float64)) <= 1e-6
    want64 = tpu_elasticity.assemble_elasticity_rhs_np(tspace)
    assert _rel(elasticity.assemble_elasticity_rhs_np(space), want64) <= 1e-13


def test_near_nullspace_matches_tpufem():
    dims = (4, 5, 6)
    coords = FunctionSpace(BoxTetMesh(*dims), 1, bs=3).scalar_dof_coords()
    ref_coords = TpuSpace(TpuMesh(*dims), 1, bs=3).scalar_dof_coords()
    assert np.array_equal(coords, ref_coords)
    assert np.array_equal(nullspace.rigid_body_modes(coords),
                          tpu_nullspace.rigid_body_modes(ref_coords))
    B = nullspace.build_near_nullspace(coords)
    assert np.array_equal(B, tpu_nullspace.build_near_nullspace(ref_coords))
    assert np.allclose(B @ B.T, np.eye(6), atol=1e-12)
    with pytest.raises(RuntimeError, match="orthonormal"):
        nullspace.build_near_nullspace(np.zeros((5, 3)))
