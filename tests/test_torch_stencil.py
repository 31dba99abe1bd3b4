"""The port's P1 stencil and DiaOperator (tpufem_torch) against tpufem's
Pallas stencil kernels (interpret mode, as tests/test_pallas.py runs
them) and its DIA operator, in float64 on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
the CUDA kernel itself is checked on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Tolerances: atol 1e-12 for applies (f64 sums of 15
terms of O(1) values in different orders), exact equality for the host
builders (the same numpy arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dia_op import DiaOperator as TpuDia
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.pallas_stencil import (dia_apply_pallas, stencil_apply_pallas,
                                       stencil_apply_pallas_scalar)
from tpufem.fem.space import FunctionSpace
from tpufem.mesh import BoxTetMesh
from tpufem.problems import common as tpu_common

from tpufem_torch import convert
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.stencil import (ZONE_ROWS, stencil_apply,
                                      stencil_apply_plain)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")

# (Nx, Ny, Nz) lattices: >= 6 cubes per axis builds const (zone) mode,
# smaller ones dense mode
DIMS = [(8, 6, 10), (6, 6, 6), (5, 7, 6), (4, 4, 8)]
PROBLEMS = ["poisson", "mass"]


def _bc_dofs(mesh, problem):
    if problem == "mass":
        return None
    space = FunctionSpace(mesh, 1)
    facets = mesh.locate_boundary_facets(tpu_common.poisson_bc_marker)
    return TpuBC.from_space(space, facets).flat_dofs()


def _grid(dims):
    Nx, Ny, Nz = dims
    return (Nz + 1, Ny + 1, Nx + 1)


def _offsets(dims):
    op = TpuDia.build(BoxTetMesh(*dims), 1, "poisson", dtype=jnp.float64,
                      device=False)
    return tuple(tuple(int(v) for v in m[4]) for m in op.plan)


@pytest.mark.parametrize("dims", DIMS)
def test_plain_constant_fields_match_pallas_scalar(dims):
    """F filled with per-diagonal constants is K1 (both field forms)."""
    Z, Y, X = _grid(dims)
    offsets = _offsets(dims)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(len(offsets))
    x = rng.standard_normal(Z * Y * X)
    y_ref = np.asarray(stencil_apply_pallas_scalar(
        jnp.asarray(x), offsets, tuple(float(v) for v in w), (X, Y, Z),
        tz=4, interpret=True))
    for R in {Z, ZONE_ROWS} if Z >= ZONE_ROWS else {Z}:
        fields = torch.from_numpy(
            np.broadcast_to(w[:, None, None, None], (len(w), R, Y, X)).copy())
        y = stencil_apply(torch.from_numpy(x), fields, offsets, (Z, Y, X))
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", DIMS)
def test_plain_full_fields_match_pallas_dense(dims):
    """R == Z with full weight fields is K2."""
    Z, Y, X = _grid(dims)
    offsets = _offsets(dims)
    rng = np.random.default_rng(1)
    W = rng.standard_normal((len(offsets), Z, Y, X))
    x = rng.standard_normal(Z * Y * X)
    y_ref = np.asarray(stencil_apply_pallas(
        jnp.asarray(x), jnp.asarray(W), offsets, (X, Y, Z), tz=4,
        interpret=True))
    y = stencil_apply(torch.from_numpy(x), torch.from_numpy(W), offsets,
                      (Z, Y, X))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("dims", DIMS)
def test_dia_apply_matches_tpufem(dims, problem):
    mesh = BoxTetMesh(*dims)
    bc = _bc_dofs(mesh, problem)
    ref = TpuDia.build(mesh, 1, problem, bc_dofs=bc, dtype=jnp.float64)
    op = DiaOperator.build(mesh, 1, problem, bc_dofs=bc,
                           dtype=torch.float64, device=CPU)
    assert op.is_const() == ref.is_const() == (min(dims) >= 6)
    x = np.random.default_rng(2).standard_normal(op.layout.ndofs)
    y = op.apply(torch.from_numpy(x)).numpy()
    xj = jnp.asarray(x)
    for y_ref in (np.asarray(ref.apply(xj)),
                  np.asarray(dia_apply_pallas(ref, xj, interpret=True, tz=4)),
                  ref.apply_np(x)):
        np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(op.apply_np(x), ref.apply_np(x), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("dims", DIMS)
def test_builder_equals_tpufem(dims, problem, dtype):
    """The port's own host build (what the card uses) gives tpufem's
    arrays exactly."""
    mesh = BoxTetMesh(*dims)
    bc = _bc_dofs(mesh, problem)
    ref = TpuDia.build(mesh, 1, problem, bc_dofs=bc,
                       dtype=jnp.dtype(str(dtype).split(".")[1]),
                       device=False)
    op = DiaOperator.build(mesh, 1, problem, bc_dofs=bc, dtype=dtype)
    assert op.plan == ref.plan
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(op.weights, ref.weights))
    assert op.zone_plan == ref.zone_plan
    if ref.zones is not None:
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for za, zb in zip(op.zones, ref.zones)
                   for a, b in zip(za, zb))
    assert np.array_equal(op.bc_mask_np, np.asarray(ref.bc_mask))
    assert np.array_equal(op.diagonal_np(), ref.diagonal_np())
    A, B = op.to_scipy(), ref.to_scipy()
    assert (np.array_equal(A.indptr, B.indptr)
            and np.array_equal(A.indices, B.indices)
            and np.array_equal(A.data, B.data))


@pytest.mark.parametrize("dims", DIMS)
def test_convert_round_trip(dims):
    """dia_from_numpy on tpufem's host state gives the operator the
    port's builder gives, on the device state too."""
    mesh = BoxTetMesh(*dims)
    bc = _bc_dofs(mesh, "poisson")
    ref = TpuDia.build(mesh, 1, "poisson", bc_dofs=bc, dtype=jnp.float64,
                       device=False)
    got = convert.dia_from_numpy(
        ref.plan, ref.weights, np.asarray(ref.bc_mask), dims, CPU,
        zone_plan=ref.zone_plan, zones=ref.zones, surr_dims=ref.surr_dims)
    own = DiaOperator.build(mesh, 1, "poisson", bc_dofs=bc,
                            dtype=torch.float64, device=CPU)
    assert got.offsets == own.offsets
    assert torch.equal(got.fields, own.fields)
    assert torch.equal(got.bc_mask, own.bc_mask)
    x = np.random.default_rng(3).standard_normal(own.layout.ndofs)
    np.testing.assert_allclose(got.apply(torch.from_numpy(x)).numpy(),
                               ref.apply_np(x), rtol=0, atol=1e-12)


def test_dense_field_form_equals_zone_form():
    """A const-mode operator and its dense build give the same apply
    through the two field forms (R = 7 zones and R = Z full fields)."""
    mesh = BoxTetMesh(6, 7, 9)
    bc = _bc_dofs(mesh, "poisson")
    zone = DiaOperator.build(mesh, 1, "poisson", bc_dofs=bc,
                             dtype=torch.float64, device=CPU)
    full = DiaOperator.build(mesh, 1, "poisson", bc_dofs=bc,
                             dtype=torch.float64, mode="dense", device=CPU)
    assert zone.fields.shape[1] == ZONE_ROWS
    assert full.fields.shape[1] == zone.grid_dims[0]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        zone.layout.ndofs))
    torch.testing.assert_close(zone.apply(x), full.apply(x), rtol=0,
                               atol=1e-12)


def test_wrapper_checks_and_never_falls_back():
    op = DiaOperator.build(BoxTetMesh(6, 6, 6), 1, "poisson",
                           dtype=torch.float64, device=CPU)
    grid, f, offs = op.grid_dims, op.fields, op.offsets
    n = op.layout.ndofs
    before = stencil_apply.launches
    x = torch.zeros(n, dtype=torch.float64)
    with pytest.raises(TypeError):
        stencil_apply(x.float(), f, offs, grid)           # dtype mismatch
    with pytest.raises(TypeError):
        stencil_apply(x.long(), f.long(), offs, grid)      # not floating
    with pytest.raises(ValueError):
        stencil_apply(torch.zeros(2 * n, dtype=torch.float64)[::2], f,
                      offs, grid)                          # non-contiguous
    with pytest.raises(ValueError):
        stencil_apply(x[:-1], f, offs, grid)               # wrong size
    with pytest.raises(ValueError):
        stencil_apply(x, f[:, :5].contiguous(), offs, grid)  # bad zone rows
    with pytest.raises(ValueError):
        stencil_apply(x, f, offs[:-1], grid)               # offsets vs D
    with pytest.raises(ValueError):
        stencil_apply(x, f, ((2, 0, 0),) + offs[1:], grid)  # not P1
    with pytest.raises(RuntimeError):                      # no kernel there
        stencil_apply(x.to("meta"), f.to("meta"), offs, grid)
    assert torch.equal(stencil_apply(x, f, offs, grid),
                       stencil_apply_plain(x, f, offs, grid))
    assert stencil_apply.launches == before  # the CPU path launches nothing


# -- what the prepared launch packs (csrc/stencil_p1.cu) ---------------------
@pytest.mark.parametrize("dims", DIMS)
def test_packed_offsets_reproduce_the_operator(dims):
    from tpufem_torch.fem.stencil import MAX_DIAGONALS, pack_offsets
    op = DiaOperator.build(BoxTetMesh(*dims), 1, "poisson",
                           dtype=torch.float64, device=CPU)
    dx, dy, dz = pack_offsets(op.offsets)
    D = len(op.offsets)
    assert all(a.dtype == np.int8 and a.shape == (MAX_DIAGONALS,)
               for a in (dx, dy, dz))
    assert tuple(zip(dx[:D].tolist(), dy[:D].tolist(),
                     dz[:D].tolist())) == op.offsets
    assert not dx[D:].any() and not dy[D:].any() and not dz[D:].any()


@pytest.mark.parametrize("dims,R,itemsize", [
    ((97, 81, 65), 7, 4), ((49, 41, 33), 7, 4), ((13, 11, 9), 7, 8),
    ((7, 7, 7), 7, 4), ((8, 7, 9), 7, 8), ((10, 5, 5), 7, 4),
    ((97, 81, 65), 97, 4), ((4, 5, 8), 4, 8), ((20, 3, 4000), 7, 8),
    # the 10M rows' grid (208x208x224 cubes): 8-plane runs, 27 KB a block
    ((225, 209, 209), 7, 4), ((225, 209, 209), 7, 8)])
def test_stencil_runs_cover_the_grid_once(dims, R, itemsize):
    """The kernel's z runs cover every plane once, every plane of a run
    has the same field row (one weight load a run), a run has at most 8
    planes and its staged planes fit the shared memory."""
    from tpufem_torch.fem import stencil
    Z, Y, X = dims
    runs = stencil.stencil_runs(dims, R, itemsize)
    assert runs.dtype == np.int32 and runs.shape[1] == 2
    assert runs[:, 1].sum() == Z and runs[0, 0] == 0
    assert (runs[1:, 0] == np.cumsum(runs[:-1, 1])).all()
    rows = [min(z, 3) if z < Z - 3 else 4 + z - (Z - 3) for z in range(Z)]
    if R == Z:
        rows = list(range(Z))
    for z0, nz in runs:
        assert 1 <= nz <= 8 and len(set(rows[z0:z0 + nz])) == 1
        assert stencil.stencil_smem_bytes(int(nz), X, itemsize) \
            <= stencil._MAX_SMEM
    if R == 7 and Z > 7:
        # three single planes either end, the mid zone in equal runs
        assert runs[:3, 1].tolist() == [1, 1, 1] == runs[-3:, 1].tolist()
        mid = runs[3:-3, 1]
        assert mid.max() - mid[:-1].min(initial=mid.max()) == 0
    with pytest.raises(RuntimeError, match="shared memory"):
        stencil.stencil_runs((9, 3, 40000), 7, 8)


def test_stencil_launch_struct_mirrors_the_kernel():
    """_build.StencilLaunch lays out csrc/stencil_p1.cu's StencilLaunch:
    the fields pointer, 7 ints, then dx, dy, dz as 27 int8 each."""
    import ctypes
    from tpufem_torch import _build
    L = _build.StencilLaunch
    assert [n for n, _ in L._fields_] == ["F", "device", "Z", "Y", "X", "R",
                                          "D", "run", "dx", "dy", "dz"]
    assert (L.device.offset, L.run.offset) == (8, 32)
    assert (L.dx.offset, L.dy.offset, L.dz.offset) == (36, 63, 90)
    assert ctypes.sizeof(L) == 120


def test_bs3_table_launch_struct_mirrors_the_kernel():
    """_build.Bs3TableLaunch lays out csrc/stencil_p1.cu's Bs3TableLaunch:
    two pointers, 9 ints, the Segments (n, z[9], first_run[9],
    pattern[8]), then dx, dy, dz as 27 int8 each."""
    import ctypes
    from tpufem_torch import _build
    from tpufem_torch.fem import stencil
    L = _build.Bs3TableLaunch
    assert [n for n, _ in L._fields_] == [
        "table", "cls", "device", "Z", "Y", "X", "D", "C", "P", "run",
        "per_point", "nseg", "seg_z", "seg_first_run", "seg_pattern", "dx",
        "dy", "dz"]
    assert (L.device.offset, L.nseg.offset, L.seg_z.offset) == (16, 52, 56)
    assert (L.seg_first_run.offset, L.seg_pattern.offset) == (92, 128)
    assert (L.dx.offset, L.dz.offset, ctypes.sizeof(L)) == (160, 214, 248)
    assert len(L().seg_pattern) == stencil.MAX_SEGMENTS_BS3


def test_dia_apply_on_the_cpu_takes_the_plain_version():
    op = DiaOperator.build(BoxTetMesh(6, 7, 9), 1, "poisson",
                           dtype=torch.float64, device=CPU)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        op.layout.ndofs))
    before = stencil_apply.launches
    assert torch.equal(op.apply(x), stencil_apply_plain(
        x, op.fields, op.offsets, op.grid_dims))
    assert stencil_apply.launches == before
    assert "_stencil" not in op.__dict__  # no launch was prepared
