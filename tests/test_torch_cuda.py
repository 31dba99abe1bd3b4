"""The port's CUDA kernels (the P1 stencil and its three-component form,
the strip apply K3, the whole-CG kernel K4, the flat interior K5,
brick_flat, the multi-kind zone kernel, the blocked per-perm apply, the
CSR product, the bf16 dense level's product and the matrix-free action)
against their plain PyTorch versions, on the card; and the ``-use_conv
1`` operator (cuDNN's conv3d and einsums) against its float64 host form.
Marked ``cuda``: without a CUDA device every test skips.

This file imports no jax, so it also runs on a machine without jax; the
suite's conftest imports jax, so there run it without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.flat_op import FlatOperator
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.stencil import stencil_apply, stencil_apply_plain
from tpufem_torch.fem.strip_op import StripOperator
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems.common import poisson_bc_marker

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _op(dims, mode, dtype, device):
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(FunctionSpace(mesh, 1),
                                mesh.locate_boundary_facets(poisson_bc_marker))
    return DiaOperator.build(mesh, 1, "poisson", bc_dofs=bc.flat_dofs(),
                             dtype=dtype, mode=mode, device=device)


# |kernel - plain| <= 10 * (15 eps) * sum_d |F_d x_d|: the two sum the 15
# terms in the same order, the kernel with fused multiply-adds
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("dims,mode", [
    ((6, 6, 6), "const"), ((8, 6, 10), "const"), ((64, 80, 96), "const"),
    ((5, 7, 6), "dense"), ((8, 6, 10), "dense")])
def test_kernel_matches_plain(device, dims, mode, dtype, tol):
    op = _op(dims, mode, dtype, device)
    args = (op.fields, op.offsets, op.grid_dims)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(device,
                                                                   dtype)
    before = stencil_apply.launches
    y = stencil_apply(x, *args)
    assert stencil_apply.launches == before + 1
    yp = stencil_apply_plain(x, *args)
    bound = stencil_apply_plain(x.abs(), op.fields.abs(), *args[1:])
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())


def test_mixed_devices_raise(device):
    op = _op((6, 6, 6), "const", torch.float32, device)
    x = torch.zeros(op.layout.ndofs, device=device)
    with pytest.raises(TypeError):
        stencil_apply(x, op.fields.cpu(), op.offsets, op.grid_dims)
    with pytest.raises(TypeError):
        stencil_apply(x.cpu(), op.fields, op.offsets, op.grid_dims)


def test_refused_launch_reports_cuda_error(device):
    from tpufem_torch import _build
    lib = _build.load().lib
    x = torch.zeros(8, device=device)
    args = _build.StencilLaunch(F=x.data_ptr(), device=0, Z=2, Y=2, X=2, R=2,
                                D=0, run=1)
    rc = lib.tpufem_stencil_p1_f32(
        ctypes.addressof(args), x.data_ptr(), x.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0  # D = 0 diagonals is refused before any launch
    assert lib.tpufem_cuda_error_string(rc)


def test_refused_prepared_launches_raise_with_the_cuda_error(device,
                                                             monkeypatch):
    """A prepared launch the entry point refuses (a z run longer than the
    kernel's) raises from the wrapper, with CUDA's name for the error."""
    from tpufem_torch.fem import stencil
    sop, _, _ = _strip(2, (8, 9, 10), torch.float32, device)
    monkeypatch.setattr(StripOperator, "apply_shape",
                        lambda self, itemsize: (99, True))
    x = torch.zeros(sop.dims[0], sop.dims[7], sop.dims[6], device=device)
    with pytest.raises(RuntimeError, match=r"strip_apply.*invalid argument"):
        sop.apply_strips(x)
    op = _op((6, 6, 6), "const", torch.float32, device)
    monkeypatch.setattr(stencil, "stencil_runs",
                        lambda dims, R, itemsize, comps=1:
                        np.array([[0, 99]]))
    with pytest.raises(RuntimeError, match=r"stencil_p1.*invalid argument"):
        op.apply(torch.zeros(op.layout.ndofs, device=device))
    # and the three-component form's
    monkeypatch.setattr(stencil, "bs3_table_run",
                        lambda dims, itemsize, per_point: 99)
    op3 = _elast_op((6, 6, 6), "const", torch.float32, device)
    with pytest.raises(RuntimeError,
                       match=r"stencil_p1_bs3.*invalid argument"):
        op3.apply(torch.zeros(3 * op3.layout.ndofs, device=device))
    torch.cuda.synchronize()


# grids narrower than a warp, of exactly 7 planes (every plane a zone
# plane), of fewer (full fields), wide ones, and the 500k-dof grid
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("dims,mode", [
    ((20, 9, 6), "const"), ((7, 4, 3), "dense"), ((300, 6, 6), "const"),
    ((9, 9, 40), "const"), ((64, 80, 96), "dense")])
def test_kernel_matches_plain_on_odd_grids(device, dims, mode, dtype, tol):
    op = _op(dims, mode, dtype, device)
    Z = op.grid_dims[0]
    assert op.fields.shape[1] == (7 if mode == "const" else Z)
    args = (op.fields, op.offsets, op.grid_dims)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(device,
                                                                   dtype)
    before = stencil_apply.launches
    y = op.apply(x)                      # the operator's prepared launch
    assert stencil_apply.launches == before + 1
    assert torch.equal(stencil_apply(x, *args), y)
    yp = stencil_apply_plain(x, *args)
    bound = stencil_apply_plain(x.abs(), op.fields.abs(), *args[1:])
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())
    with pytest.raises(ValueError):
        op.apply(x[:-1])


# all 27 offsets of the cube (the kernel's other static bound), in zone
# form, with full fields, and under 7 planes; 27-term sums: 2 x the P1 bound
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 2e-13)])
@pytest.mark.parametrize("dims,R", [((9, 11, 13), 9), ((9, 11, 13), 7),
                                    ((5, 4, 70), 5)])
def test_kernel_matches_plain_with_27_diagonals(device, dims, R, dtype, tol):
    Z, Y, X = dims
    offs = tuple((dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1))
    rng = np.random.default_rng(1)
    F = torch.from_numpy(rng.standard_normal((27, R, Y, X))).to(device, dtype)
    x = torch.from_numpy(rng.standard_normal(Z * Y * X)).to(device, dtype)
    y = stencil_apply(x, F, offs, dims)
    yp = stencil_apply_plain(x, F, offs, dims)
    bound = stencil_apply_plain(x.abs(), F.abs(), offs, dims)
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())


def test_kernel_matches_plain_on_a_gmg_hierarchy(device):
    """Every operator of a Poisson CG+GMG solve (the CG matrix, the four
    levels, the RHS mass operator) through its prepared launch."""
    from tpufem_torch import cli
    res = cli.main(["--problem_type", "poisson", "--ndofs", "500000",
                    "--scaling_type", "strong", "--dtype", "float32",
                    "-pc_type", "gmg", "--device", "cuda"])
    solver = res.problem.solver_function
    ops = [solver.A, res.problem.rhs_op] + [lv.op for lv in solver.pc.levels]
    assert len(solver.pc.levels) == 4
    rng = np.random.default_rng(2)
    for op in ops:
        x = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(
            device, torch.float32)
        args = (op.fields, op.offsets, op.grid_dims)
        y = op.apply(x)
        yp = stencil_apply_plain(x, *args)
        bound = stencil_apply_plain(x.abs(), op.fields.abs(), *args[1:])
        torch.cuda.synchronize()
        assert bool(((y - yp).abs() <= 1e-5 * bound).all()), op.grid_dims


def _strip(order, dims, dtype, device):
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(space,
                                mesh.locate_boundary_facets(poisson_bc_marker))
    dia = DiaOperator.try_const(mesh, order, "poisson",
                                bc_dofs=bc.flat_dofs(), dtype=dtype)
    return StripOperator.from_dia(dia, dtype=dtype, device=device), bc, dia


# |kernel - plain| <= tol * sum |W| |x|: the two sum the same <= ~60 terms
# per element in different orders (the plain version with index_add, the
# kernel with fused multiply-adds), each within 60 eps of the abs sum
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("order,dims", [
    (2, (8, 9, 10)), (3, (8, 8, 9)), (1, (9, 8, 10)), (2, (8, 8, 6)),
    (3, (24, 24, 32))], ids=["P2", "P3", "P1", "P2-full", "P3-500k"])
def test_strip_apply_kernel_matches_plain(device, order, dims, dtype, tol):
    import dataclasses
    op, _, _ = _strip(order, dims, dtype, device)
    rng = np.random.default_rng(0)
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    u = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(device, dtype)
    x = op.to_strips(u)
    before = StripOperator.apply_strips.launches
    y = op.apply_strips(x)
    assert StripOperator.apply_strips.launches == before + 1
    yp = op.apply_strips_plain(x)
    absop = dataclasses.replace(op, mid_pack=op.mid_pack.abs(),
                                dlt_pack=op.dlt_pack.abs())
    bound = absop.apply_strips_plain(x.abs())
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())
    mask = op.to_strips(torch.ones_like(u)) != 0
    assert bool((y[~mask] == 0).all())


# other block shapes of the K3 kernel: a lane tile with a ragged tail (289
# of 384 lanes hold dofs), a halo so wide that no run's delta weights fit
# the shared memory beside its planes (they come from global memory), and
# the 128-thread blocks of few channels; on a stream of its own
@pytest.mark.parametrize("order,dims,dtype,tol,staged", [
    (2, (14, 14, 8), torch.float32, 2e-5, True),
    (3, (40, 6, 6), torch.float32, 2e-5, False),
    (3, (40, 6, 6), torch.float64, 1e-13, False),
    (3, (24, 24, 32), torch.float64, 1e-13, True),
    (1, (9, 8, 10), torch.float64, 1e-13, True)],
    ids=["ragged-tile", "global-deltas-f32", "global-deltas-f64",
         "P3-500k-f64", "P1"])
def test_strip_apply_kernel_shapes_and_streams(device, order, dims, dtype,
                                               tol, staged):
    import dataclasses
    op, _, _ = _strip(order, dims, dtype, device)
    run, got = op.apply_shape(op.mid_pack.element_size())
    assert got is staged and 1 <= run <= 8
    zk = {op.kdims[kind][0] for kind, _ in op.channels}
    assert order == 1 or len(zk) > 1     # channels of unequal z extent
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(device, dtype)
    x = op.to_strips(u)
    y0 = op.apply_strips(x)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        y = op.apply_action(x)(x)        # the solver loop's route
    side.synchronize()
    assert torch.equal(y, y0)
    yp = op.apply_strips_plain(x)
    absop = dataclasses.replace(op, mid_pack=op.mid_pack.abs(),
                                dlt_pack=op.dlt_pack.abs())
    bound = absop.apply_strips_plain(x.abs())
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())
    mask = op.to_strips(torch.ones_like(u)) != 0
    assert bool((y[~mask] == 0).all())
    # pad and guard slots are written, not left as they were
    with torch.cuda.stream(side):
        z = op.apply_strips(torch.zeros_like(x))
    side.synchronize()
    assert bool((z == 0).all())


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float64, 1e-8),
                                           (torch.float32, 1e-3)])
def test_strip_cg_kernel_matches_plain(device, dtype, rel_tol):
    """The cooperative whole-CG kernel against its plain version: the
    same iteration count +-1 and the same solution (float64: both
    converge to 1e-8; float32: 300 steps of two rounding orders, 1e-3)."""
    op, bc, dia = _strip(2, (6, 6, 7), dtype, device)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(op.layout.ndofs)
    b[bc.flat_dofs()] = 0.0
    bs = op.to_strips(torch.from_numpy(b).to(device, dtype))
    before = StripOperator.cg_resident.launches
    x_k, it_k, rel_k = op.cg_resident(bs, 1e-8, 300)
    assert StripOperator.cg_resident.launches == before + 1
    x_p, it_p, rel_p = op.cg_resident_plain(bs, 1e-8, 300)
    torch.cuda.synchronize()
    assert abs(int(it_k) - int(it_p)) <= 1
    if dtype == torch.float64:
        assert float(rel_k) < 1e-8 and float(rel_p) < 1e-8
    err = float((x_k - x_p).norm() / x_p.norm())
    assert err <= rel_tol, err
    mask = op.to_strips(torch.ones(op.layout.ndofs, device=device,
                                   dtype=dtype)) != 0
    assert bool((x_k[~mask] == 0).all())


def test_strip_cg_kernel_maxit_cap(device):
    op, bc, _ = _strip(1, (8, 8, 8), torch.float64, device)
    b = np.random.default_rng(6).standard_normal(op.layout.ndofs)
    b[bc.flat_dofs()] = 0.0
    bs = op.to_strips(torch.from_numpy(b).to(device))
    _, it, rel = op.cg_resident(bs, 1e-30, 7)
    _, it_p, rel_p = op.cg_resident_plain(bs, 1e-30, 7)
    assert int(it) == int(it_p) == 7
    assert abs(float(rel) - float(rel_p)) <= 1e-10 * float(rel_p)


def test_strip_cg_launch_too_large_raises(device):
    """A cooperative grid above the co-resident capacity is refused by
    the launch, a grid of more blocks than bricks by the entry point, and
    the wrapper raises."""
    from tpufem_torch import _build
    op, _, _ = _strip(1, (40, 40, 100), torch.float32, device)
    lib = _build.load().lib
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    mptr, ment, dptr, dent, zk = op.tables
    halo = op.cg_halo
    dcap = op.cg_delta_cap(op.cg_bricks())
    cap = lib.tpufem_strip_cg_blocks_f32(device.index, C, halo,
                                         ment.shape[0], dcap)
    assert cap > 0
    bricks = torch.from_numpy(op.cg_bricks()).to(device)
    nbricks = bricks.shape[0]
    assert nbricks > cap
    b = torch.zeros((C, Zp, LW), device=device)
    x = torch.empty_like(b)
    work = torch.empty((3, C, Zp, LW), device=device)
    part = torch.empty(3 * (nbricks + 1), device=device)
    it = torch.empty((), dtype=torch.int32, device=device)
    rel = torch.empty((), device=device)

    def launch(nblk):
        return lib.tpufem_strip_cg_f32(
            device.index, b.data_ptr(), op.mid_pack.data_ptr(),
            op.dlt_pack.data_ptr(), mptr.data_ptr(), ment.data_ptr(),
            dptr.data_ptr(), dent.data_ptr(), zk.data_ptr(),
            bricks.data_ptr(), x.data_ptr(), work.data_ptr(),
            part.data_ptr(), it.data_ptr(), rel.data_ptr(), C, Zc, Zp, LW,
            TILE, 128, nbricks, halo, ment.shape[0], dcap, 1e-12, 5, nblk,
            torch.cuda.current_stream().cuda_stream)

    rc = launch(cap + 1)
    assert rc == 720  # cudaErrorCooperativeLaunchTooLarge
    assert lib.tpufem_cuda_error_string(rc)
    assert launch(nbricks + 1) == 1  # cudaErrorInvalidValue: blocks > bricks
    # the refused launch left no error behind: the next launch runs
    op.cg_resident(b, 1e-8, 3)
    torch.cuda.synchronize()


@pytest.mark.parametrize("order,dims,max_blocks", [
    (2, (8, 9, 10), 3), (3, (8, 8, 9), 7), (1, (40, 40, 100), None)],
    ids=["P2-3-blocks", "P3-7-blocks", "P1-170k"])
def test_strip_cg_kernel_more_bricks_than_blocks(device, order, dims,
                                                 max_blocks):
    """Blocks that own several bricks each: a grid capped far below the
    brick count, and an operator with more bricks than the card holds
    co-resident blocks.  The same solve as the plain version (float64,
    both converged to 1e-8 within a step of each other, so the solutions
    differ by at most one step's update: 1e-6)."""
    op, bc, _ = _strip(order, dims, torch.float64, device)
    bricks, _, _, nblk = op._cg_launch_shape(torch.float64)
    if max_blocks is None:
        assert bricks.shape[0] > nblk
    else:
        assert bricks.shape[0] > max_blocks
    b = np.random.default_rng(8).standard_normal(op.layout.ndofs)
    b[bc.flat_dofs()] = 0.0
    bs = op.to_strips(torch.from_numpy(b).to(device))
    x_k, it_k, rel_k = op._launch_cg(bs, 1e-8, 600, max_blocks=max_blocks)
    x_p, it_p, rel_p = op.cg_resident_plain(bs, 1e-8, 600)
    torch.cuda.synchronize()
    assert abs(int(it_k) - int(it_p)) <= 1
    assert float(rel_k) < 1e-8 and float(rel_p) < 1e-8
    err = float((x_k - x_p).norm() / x_p.norm())
    assert err <= 1e-6, err
    mask = op.to_strips(torch.ones(op.layout.ndofs, device=device,
                                   dtype=torch.float64)) != 0
    assert bool((x_k[~mask] == 0).all())


def test_strip_cg_sync_floor_runs(device):
    """The barrier-only kernel of the whole-CG grid launches and ends."""
    from tpufem_torch import _build
    op, _, _ = _strip(2, (6, 6, 7), torch.float32, device)
    lib = _build.load().lib
    _, _, _, nblk = op._cg_launch_shape(torch.float32)
    rc = lib.tpufem_strip_cg_sync_floor(
        device.index, nblk, 20, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()


def test_cgpoisson_cli_engages_the_kernels(device):
    from tpufem_torch import cli
    from tpufem_torch.problems import cgpoisson
    cgpoisson.TIMING_PASSES = cgpoisson.TIMING_REPS = 1
    try:
        k3, k4 = StripOperator.apply_strips.launches, \
            StripOperator.cg_resident.launches
        off = cli.main(["--problem_type", "cgpoisson", "--order", "2",
                        "--ndofs", "3000", "--dtype", "float64",
                        "--device", "cuda"])
        assert StripOperator.apply_strips.launches > k3
        on = cli.main(["--problem_type", "cgpoisson", "--order", "2",
                       "--ndofs", "3000", "--dtype", "float64",
                       "--device", "cuda", "-cg_kernel", "on"])
        assert StripOperator.cg_resident.launches > k4
        assert on.problem.solver_function.cg_kernel_engaged
        assert abs(on.iterations - off.iterations) <= 1
        assert abs(on.norm - off.norm) <= 1e-9 * off.norm
    finally:
        cgpoisson.TIMING_PASSES, cgpoisson.TIMING_REPS = 3, 10


# |kernel - plain| <= tol * sum |WT| |x|: K = 120 (P2) or 480 (P3) terms
# per element in two orders (cuBLAS or the CPU's bmm against sequential
# fused multiply-adds): 480 * 2^-24 and 480 * 2^-53, rounded up
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("order,dims", [
    (2, (8, 9, 10)), (3, (8, 8, 9)), (3, (24, 24, 32)), (2, (14, 14, 8))],
    ids=["P2", "P3", "P3-500k", "P2-3-tiles"])
def test_flat_interior_kernel_matches_plain(device, order, dims, dtype, tol):
    import dataclasses
    _, _, dia = _strip(order, dims, torch.float32, device)
    op = FlatOperator.from_dia(dia, device=device).astype(dtype)
    g = op.geom
    if dims == (14, 14, 8):  # an odd count of 128-lane tiles
        assert g.TILE == 384
    rng = np.random.default_rng(0)
    # a nonzero halo: the kernel reads it on the tile's halo lanes
    x = torch.from_numpy(rng.standard_normal((g.Zp, g.CP, g.LW))).to(
        device, dtype)
    before = FlatOperator.interior.launches
    y = op.interior(x)
    assert FlatOperator.interior.launches == before + 1
    yp = op.interior_plain(x)
    absop = dataclasses.replace(op, W0=op.W0.abs(), AZT=op.AZT.abs())
    bound = absop.interior_plain(x.abs())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert bool(((y - yp).abs() <= tol * bound).all())
    body = torch.zeros_like(y, dtype=torch.bool)
    body[1:1 + g.Zc, :, 128:128 + g.TILE] = True
    assert bool((y[~body] == 0).all())
    # blocks of 64 and of 128 lanes (2 and 4 a thread) give the same bits
    for lanes in (2, 4):
        assert torch.equal(op._prepare_interior(lanes)(x), y)


def test_flat_interior_rejects_mismatched_buffers(device):
    _, _, dia = _strip(2, (8, 9, 10), torch.float32, device)
    op = FlatOperator.from_dia(dia, device=device)
    g = op.geom
    with pytest.raises(TypeError):
        op.interior(torch.zeros((g.Zp, g.CP, g.LW), device=device,
                                dtype=torch.float64))
    with pytest.raises(ValueError):
        op.interior(torch.zeros((g.Zp, g.CP, g.LW + 128), device=device))


def test_cgpoisson_use_flat_engages_the_kernel(device):
    """-use_flat 1 runs the flat interior kernel and no strip kernel,
    and solves the same system as the strip form (both converged)."""
    from tpufem_torch import cli
    from tpufem_torch.problems import cgpoisson
    cgpoisson.TIMING_PASSES = cgpoisson.TIMING_REPS = 1
    try:
        argv = ["--problem_type", "cgpoisson", "--order", "2", "--ndofs",
                "6000", "--dtype", "float32", "--device", "cuda",
                "-cg_kmax", "1000"]
        k3, k5 = (StripOperator.apply_strips.launches,
                  FlatOperator.interior.launches)
        flat = cli.main(argv + ["-use_flat", "1"])
        assert isinstance(flat.problem.solver_function.op, FlatOperator)
        assert FlatOperator.interior.launches > k5
        assert StripOperator.apply_strips.launches == k3
        strip = cli.main(argv)
        err = float((flat.x - strip.x).norm() / strip.x.norm())
        assert err <= 1e-4, err
    finally:
        cgpoisson.TIMING_PASSES, cgpoisson.TIMING_REPS = 3, 10


# -- the three-component form (planar bs = 3 elasticity) ----------------------
def _elast_op(dims, mode, dtype, device, planar=True):
    from tpufem_torch.problems.common import elasticity_bc_marker
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(
        FunctionSpace(mesh, 1, bs=3),
        mesh.locate_boundary_facets(elasticity_bc_marker))
    return DiaOperator.build(mesh, 1, "elasticity", bc_dofs=bc.flat_dofs(),
                             dtype=dtype, mode=mode, device=device,
                             planar=planar)


# |kernel - plain| <= tol * sum_t |F_t x_t|: the two sum the 45 terms of an
# output in the same order, the kernel with fused multiply-adds
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("dims,mode", [
    ((48, 48, 64), "const"), ((24, 24, 32), "const"), ((12, 12, 16), "const"),
    ((6, 6, 8), "const"), ((5, 7, 6), "dense"), ((4, 4, 8), "dense")],
    ids=["500k", "level1", "level2", "level3", "dense", "dense-thin"])
def test_bs3_kernel_matches_plain(device, dims, mode, dtype, tol):
    """The 500k elasticity CG matrix, its smoothed GMG levels and two
    dense-mode (R = Z) lattices, through the operator's prepared launch
    (one launch an apply) and the public wrapper."""
    from tpufem_torch.fem.stencil import (stencil_apply_bs3,
                                          stencil_apply_bs3_plain)
    op = _elast_op(dims, mode, dtype, device)
    args = (op.fields, op.offsets, op.grid_dims)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(3 * op.layout.ndofs)).to(
        device, dtype)
    before = stencil_apply_bs3.launches
    y = op.apply(x)
    assert stencil_apply_bs3.launches == before + 1
    yp = stencil_apply_bs3_plain(x, *args)
    bound = stencil_apply_bs3_plain(x.abs(), op.fields.abs(), *args[1:])
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())
    assert torch.equal(stencil_apply_bs3(x, *args), y)


def test_bs3_refusals(device):
    """Mixed devices raise in the wrapper; the entry point refuses more
    than 15 diagonals and a run longer than the kernel's."""
    from tpufem_torch import _build
    from tpufem_torch.fem.stencil import stencil_apply_bs3
    op = _elast_op((6, 6, 6), "const", torch.float32, device)
    x = torch.zeros(3 * op.layout.ndofs, device=device)
    with pytest.raises(TypeError):
        stencil_apply_bs3(x, op.fields.cpu(), op.offsets, op.grid_dims)
    with pytest.raises(TypeError):
        stencil_apply_bs3(x.cpu(), op.fields, op.offsets, op.grid_dims)
    lib = _build.load().lib
    stream = torch.cuda.current_stream().cuda_stream
    from tpufem_torch.fem.stencil import prepare_stencil_bs3
    table = prepare_stencil_bs3(op.fields, op.offsets, op.grid_dims).keep[0]
    for key, value in (("D", 16), ("run", 9)):
        args = _build.Bs3TableLaunch.from_buffer_copy(table)
        setattr(args, key, value)
        rc = lib.tpufem_stencil_p1_bs3_table_f32(
            ctypes.addressof(args), x.data_ptr(), x.data_ptr(), stream)
        assert rc != 0 and lib.tpufem_cuda_error_string(rc)
    # and segments that miss the last plane, a run count that does not
    # follow from the run, a pattern past the class bytes
    for key, value in (("seg_z", 2), ("seg_first_run", 5),
                       ("seg_pattern", 7)):
        args = _build.Bs3TableLaunch.from_buffer_copy(table)
        getattr(args, key)[args.nseg if key == "seg_z" else 1] = value
        rc = lib.tpufem_stencil_p1_bs3_table_f32(
            ctypes.addressof(args), x.data_ptr(), x.data_ptr(), stream)
        assert rc != 0 and lib.tpufem_cuda_error_string(rc)
    torch.cuda.synchronize()


# the three-component kernel's plan on the grids its CPU walk covers
# (tests/test_torch_elasticity.py): a partial last tile, dense fields, rows
# wider than a block's points
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("dims,mode", [
    ((6, 6, 8), "const"), ((12, 12, 16), "const"), ((5, 7, 6), "dense"),
    ((40, 6, 20), "const")], ids=["9x7x7", "17x13x13", "dense", "wide"])
def test_bs3_kernel_matches_plain_on_the_walk_grids(device, dims, mode,
                                                    dtype, tol):
    from tpufem_torch.fem.stencil import (prepare_stencil_bs3,
                                          stencil_apply_bs3_plain)
    op = _elast_op(dims, mode, dtype, device)
    args = (op.fields, op.offsets, op.grid_dims)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        3 * op.layout.ndofs)).to(device, dtype)
    launch = prepare_stencil_bs3(*args)
    y = launch(x)
    yp = stencil_apply_bs3_plain(x, *args)
    bound = stencil_apply_bs3_plain(x.abs(), op.fields.abs(), *args[1:])
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())
    assert torch.equal(launch(x), y)


# the two three-component kernels (a thread a point, a thread an output)
# against each other on the 10M-dof elasticity cell's grid and its four smoothed levels below it, the
# 500k grid and a 17x49x49 slab of the 4-slab 500k run (no Dirichlet
# rows); every plane of them ends in a ragged tile
BS3_TABLE_CASES = {"161x161x129": (128, 160, 160), "81x81x65": (64, 80, 80),
                   "41x41x33": (32, 40, 40), "21x21x17": (16, 20, 20),
                   "11x11x9": (8, 10, 10), "65x49x49": (48, 48, 64),
                   "slab-17x49x49": (48, 48, 16)}


def _bs3_table_op(name, dtype, device):
    cells = BS3_TABLE_CASES[name]
    if name.startswith("slab"):
        return DiaOperator.build(BoxTetMesh(*cells), 1, "elasticity",
                                 dtype=dtype, device=device, bake_bc=False,
                                 h_override=(1 / 48, 1 / 48, 1 / 64),
                                 planar=True)
    return _elast_op(cells, "const", dtype, device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("name", list(BS3_TABLE_CASES))
def test_bs3_kernels_give_each_others_bits(device, name, dtype, tol):
    """The kernel with a thread a point (the plan on a card of one SM)
    and the kernel with a thread an output (on a card of a million) give
    each other's bits (``torch.equal``), one of them the operator's own
    launch, and lie within TOL_BS3 of the plain version."""
    from tpufem_torch.fem import stencil
    op = _bs3_table_op(name, dtype, device)
    args = (op.fields, op.offsets, op.grid_dims)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        3 * op.layout.ndofs)).to(device, dtype)
    y = op.apply(x)
    assert [stencil.stencil_bs3_plan(*args, sms).per_point
            for sms in (1, 10 ** 6)] == [True, False]
    point, output = (stencil.prepare_stencil_bs3(*args, sms)(x)
                     for sms in (1, 10 ** 6))
    assert torch.equal(point, output) and torch.equal(point, y)
    yp = stencil.stencil_apply_bs3_plain(x, *args)
    bound = stencil.stencil_apply_bs3_plain(x.abs(), op.fields.abs(),
                                            *args[1:])
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= tol * bound).all())


def test_bs3_table_counter_engages_on_the_cells_operators(device):
    """With the spans on, ``stencil.bs3.table`` counts every apply of the
    10M cell's five smoothed grids (its CG operator's is the first) as
    ``stencil.bs3`` does, 1.0 of them; an operator with random fields,
    which have no table, raises and counts nothing."""
    from tpufem_torch import timing
    ops = [_bs3_table_op(name, torch.float32, device)
           for name in list(BS3_TABLE_CASES)[:5]]
    noise = dataclasses.replace(ops[-1], fields=torch.randn_like(
        ops[-1].fields))
    was = timing.enable_spans(True)
    try:
        timing.SPANS.reset()
        for op in ops:
            op.apply(torch.randn(3 * op.layout.ndofs, device=device))
        counters = dict(timing.SPANS.counters)
        timing.SPANS.reset()
        with pytest.raises(ValueError, match="distinct weight columns"):
            noise.apply(torch.randn(3 * noise.layout.ndofs, device=device))
        noisy = dict(timing.SPANS.counters)
    finally:
        timing.enable_spans(was)
        timing.SPANS.reset()
    torch.cuda.synchronize()
    assert counters["stencil.bs3.table"] == counters["stencil.bs3"] == 5
    assert noisy == {}


def test_bs3_on_a_side_stream_and_its_residency(device):
    """The prepared three-component launch on a non-default stream gives
    the default stream's bits; the float32 kernel with a thread a point
    keeps two blocks of the 161x161x129 grid's stage resident on an
    SM."""
    from tpufem_torch import _build
    from tpufem_torch.fem import stencil
    op = _elast_op((12, 12, 16), "const", torch.float32, device)
    x = torch.randn(3 * op.layout.ndofs, device=device)
    y0 = op.apply(x)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        y = op.apply(x)
    side.synchronize()
    assert torch.equal(y, y0)
    smem = stencil.bs3_table_smem_bytes(4, 129, 4)
    assert _build.load().lib.tpufem_stencil_p1_bs3_blocks(smem) >= 2


def test_elasticity_cli_engages_the_kernel(device):
    """The 500k float32 elasticity run: every operator apply is a
    three-component launch (17 per CG iteration), the RHS three scalar
    ones; 17 iterations and 2 refinement passes (tpufem's elasticity_p1)."""
    from tpufem_torch import cli
    from tpufem_torch.fem.stencil import stencil_apply_bs3
    stencil_apply.launches = stencil_apply_bs3.launches = 0
    res = cli.main(["--problem_type", "elasticity", "--ndofs", "500000",
                    "--scaling_type", "strong", "--dtype", "float32",
                    "-pc_type", "gmg", "--device", "cuda"])
    its = res.iterations + res.refine_iterations
    assert stencil_apply_bs3.launches == 17 * its
    assert stencil_apply.launches == 3
    assert res.true_rel <= 1e-8 and 0 < res.iterations < 100


# -- brick-AMG's flat stencil (csrc/brick_flat.cu) ----------------------------
def _brick_level(gdims, m, dtype, device, seed=0):
    """Random dense block-stencil fields of a brick-AMG level, flattened
    as the setup flattens them (27 fields at m = 1, 207 at m = 6)."""
    from tpufem_torch.la.bramg import stencil_to_flat_fields
    rng = np.random.default_rng(seed)
    plan, fields = stencil_to_flat_fields(
        rng.standard_normal((3, 3, 3) + gdims + (m, m)), m)
    return (torch.from_numpy(np.stack(fields)).to(device, dtype), plan,
            gdims, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gdims,m", [
    ((21, 21, 21), 1), ((33, 27, 22), 1), ((22, 17, 17), 6),
    ((22, 27, 33), 1), ((1, 4, 5), 6), ((3, 2, 7), 1), ((2, 3, 5), 6),
    ((3, 4, 25), 6), ((3, 1, 5), 1), ((2, 1, 4), 6), ((2, 3, 1), 6)],
    ids=["poisson_amg_l1", "poisson_500k_l1", "elasticity_500k_l1",
         "W33_rows_end_inside", "az1", "W7", "W30", "W150", "ay1", "ay1_m6",
         "W6_m6"])
def test_brick_flat_kernel_matches_plain(device, gdims, m, dtype):
    """The level-1 grids of the AMG bench rows, one of 33 lanes whose
    tiles of 2 rows end inside its 27 rows, one plane (az = 1), one
    row (ay = 1), minor axes that are no multiple of 32, one of 150
    lanes (two lane tiles, the second of 22) and one of 6 (m = 6,
    narrower than the halo of 11 lanes), through the public wrapper (one
    launch) and a prepared launch: the plain version's bits (the same
    terms in plan order, each product and sum rounded alike)."""
    from tpufem_torch.la.brick_flat import (brick_flat_apply,
                                            brick_flat_apply_plain,
                                            prepare_brick_flat)
    args = _brick_level(gdims, m, dtype, device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(args[0][0].numel())).to(
        device, dtype)
    before = brick_flat_apply.launches
    y = brick_flat_apply(x, *args)
    assert brick_flat_apply.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(y, brick_flat_apply_plain(x, *args))
    assert torch.equal(prepare_brick_flat(*args)(x), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gdims,m,shape", [
    ((132, 5, 4), 1, (4, 4, 2, 1, 32)), ((53, 9, 6), 1, (2, 6, 5, 1, 32)),
    ((2, 5, 22), 6, (1, 128, 5, 2, 128)), ((2, 5, 27), 6, (1, 128, 5, 2, 128)),
    ((264, 4, 2), 6, (4, 12, 1, 1, 64))],
    ids=["rows4_of_5", "rows2_of_9", "lanes128_of_132", "last_strip34_m6",
         "whole_plane_m6"])
def test_brick_flat_kernel_tilings(device, gdims, m, shape, dtype):
    """Grids whose brick_flat_tiling (rows, lanes, ytiles, xtiles,
    threads) has the tiling's edges: a run of rows that ends inside the
    grid (5 rows in tiles of 4, 9 in tiles of 2), strips of 128 lanes of
    a 132- and a 162-lane row, more threads than points, a tile of a
    whole plane: the plain version's bits, as brick_flat_walk gives them
    on the CPU."""
    from tpufem_torch.la.brick_flat import (brick_flat_apply_plain,
                                            brick_flat_tiling,
                                            prepare_brick_flat)
    t = brick_flat_tiling(gdims, m)
    assert (t.rows, t.lanes, t.ytiles, t.xtiles, t.threads) == shape
    args = _brick_level(gdims, m, dtype, device, seed=3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(args[0][0].numel())).to(
        device, dtype)
    y = prepare_brick_flat(*args)(x)
    torch.cuda.synchronize()
    assert torch.equal(y, brick_flat_apply_plain(x, *args))


def test_brick_flat_refusals(device):
    """A wrong-dtype or non-contiguous x raises in the wrapper and in a
    prepared launch; a plan shift outside the staged box raises in
    prepare_brick_flat; the entry point refuses an empty plan and a
    packed launch whose tiling it cannot run (several rows of a partial
    row, threads no multiple of 32, too few threads for the tile, more
    than 256 threads) or whose fields are not aligned to their type; a
    packed launch whose reach is below the plan's shifts stores NaN and
    reads nothing outside its box."""
    from tpufem_torch import _build
    from tpufem_torch.la.brick_flat import brick_flat_apply, prepare_brick_flat
    fields, plan, gdims, m = _brick_level((3, 4, 5), 6, torch.float32, device)
    n = fields[0].numel()
    with pytest.raises(TypeError):
        brick_flat_apply(torch.zeros(n, device=device, dtype=torch.float64),
                         fields, plan, gdims, m)
    with pytest.raises(ValueError):
        brick_flat_apply(torch.zeros(2 * n, device=device)[::2], fields, plan,
                         gdims, m)
    launch = prepare_brick_flat(fields, plan, gdims, m)
    with pytest.raises(ValueError):
        launch(torch.zeros(2 * n, device=device)[::2])
    with pytest.raises(ValueError):
        launch(torch.zeros(n, device=device, dtype=torch.float64))
    with pytest.raises(ValueError, match="plan entries"):
        prepare_brick_flat(fields, [(0, 0, 12)] + list(plan[1:]), gdims, m)
    lib = _build.load().lib
    x = torch.zeros(n, device=device)
    y = torch.empty_like(x)
    table = launch.keep[2]
    good = dict(F=fields.data_ptr(), plan=table.data_ptr(), device=0, az=3,
                ay=4, W=30, nf=len(plan), rows=1, lanes=30, reach=11,
                threads=32)

    def rc(**change):
        args = _build.BrickFlatLaunch(**{**good, **change})
        return lib.tpufem_brick_flat_f32(
            ctypes.addressof(args), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    assert rc() == 0
    for bad in (dict(nf=0), dict(rows=2, lanes=20), dict(threads=48),
                dict(rows=2, threads=32), dict(threads=512),
                dict(F=fields.data_ptr() + 2)):
        code = rc(**bad)
        assert code != 0 and lib.tpufem_cuda_error_string(code), bad
    assert rc(reach=5) == 0  # the plan's shifts reach 11 lanes
    torch.cuda.synchronize()
    assert torch.isnan(y).all()


@pytest.mark.parametrize("extra,iterations,norm,flat", [
    ([], 11, 26.53502029905387, False),
    (["-amg_coarse_eq_limit", "50"], 12, 26.535020303199435, True)],
    ids=["default", "coarse_limit_50"])
def test_poisson_amg_cli_on_the_card(device, extra, iterations, norm, flat):
    """-pc_type amg at 15k dofs, float64, on the card: tpufem's CPU
    iterations and norm; with a flat m = 1 level the brick_flat kernel
    launches (6 a CG iteration and 81 in the setup's probes)."""
    from tpufem_torch import cli
    from tpufem_torch.la.brick_flat import brick_flat_apply
    brick_flat_apply.launches = 0
    res = cli.main(["--ndofs", "15000", "--dtype", "float64", "-ksp_rtol",
                    "1e-8", "-pc_type", "amg", "--device", "cuda"] + extra)
    assert type(res.problem.solver_function.pc).__name__ == "BrickAMG"
    assert res.iterations == iterations
    assert abs(res.norm - norm) <= 1e-9 * norm
    assert (brick_flat_apply.launches > 0) == flat


# -- the multi-kind (P2/P3) DIA apply: csrc/dia_zones.cu ----------------------
def _pk_dia(order, dims, dtype, device, mode="const"):
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order),
                                mesh.locate_boundary_facets(poisson_bc_marker))
    if mode == "dense":
        return DiaOperator.build(mesh, order, "poisson",
                                 bc_dofs=bc.flat_dofs(), dtype=dtype,
                                 mode="dense", device=device)
    op = DiaOperator.try_const(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                               dtype=dtype, device=device)
    assert op is not None and op.multi_kind
    return op


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order,dims,mode", [
    (2, (32, 40, 48), "const"), (3, (24, 24, 32), "const"),
    (2, (7, 9, 11), "const"), (3, (8, 7, 6), "const"),
    (2, (5, 4, 3), "dense"), (3, (3, 4, 5), "dense")],
    ids=["P2-500k", "P3-500k", "P2-odd", "P3-short-z", "P2-dense",
         "P3-dense"])
def test_dia_zones_kernel_gives_the_plain_versions_bits(device, order, dims,
                                                        mode, dtype):
    """The P2/P3 500k fine operators, odd lattices, edge grids of 6 planes
    (full fields beside zone fields) and dense-mode operators (full fields
    only): one launch through the public wrapper, the prepared launch the
    operator keeps, and the plain version's bits (product and sum rounded
    apart, in plan order)."""
    from tpufem_torch.fem.dia_zones import (dia_zones_apply,
                                            dia_zones_apply_plain)
    op = _pk_dia(order, dims, dtype, device, mode)
    pack = op.zone_pack
    assert (mode == "dense") == (not pack.terms[:, 6].any())
    rng = np.random.default_rng(order)
    x = torch.from_numpy(rng.standard_normal(pack.ndofs)).to(device, dtype)
    before = dia_zones_apply.launches
    y = dia_zones_apply(x, pack)
    assert dia_zones_apply.launches == before + 1
    assert torch.equal(y, dia_zones_apply_plain(x, pack))
    assert torch.equal(op.apply(x), y)
    assert bool(torch.isfinite(y).all())


def test_dia_zones_on_a_side_stream_and_refusals(device):
    """The prepared launch on a non-default stream; a wrong dtype, length
    or device raises; the entry point refuses a launch it cannot make."""
    from tpufem_torch import _build
    from tpufem_torch.fem.dia_zones import dia_zones_apply, prepare_dia_zones
    op = _pk_dia(2, (7, 6, 8), torch.float32, device)
    pack = op.zone_pack
    x = torch.randn(pack.ndofs, device=device)
    y0 = dia_zones_apply(x, pack)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        y = op.apply(x)
    side.synchronize()
    assert torch.equal(y, y0)
    launch = prepare_dia_zones(pack)
    with pytest.raises(ValueError):
        launch(x.double())
    with pytest.raises(ValueError):
        launch(torch.zeros(2 * pack.ndofs, device=device)[::2])
    with pytest.raises(TypeError):
        dia_zones_apply(x.cpu(), pack)
    lib = _build.load().lib
    bad = _build.DiaZonesLaunch(
        F=pack.fields.data_ptr(), terms=pack.dev_terms.data_ptr(),
        outputs=pack.dev_outputs.data_ptr(), kinds=pack.dev_kinds.data_ptr(),
        device=0, nterms=len(pack.terms), nout=len(pack.outputs),
        nkinds=len(pack.kinds), max_terms=100000, max_points=pack.max_points)
    rc = lib.tpufem_dia_zones_f32(ctypes.addressof(bad), x.data_ptr(),
                                  y.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    assert rc != 0 and lib.tpufem_cuda_error_string(rc)
    torch.cuda.synchronize()


@pytest.mark.parametrize("order,dims,mode", [
    (2, (12, 11, 8), "const"), (3, (7, 6, 6), "const"),
    (3, (3, 4, 5), "dense")], ids=["P2-ragged", "P3-six-planes", "P3-dense"])
def test_dia_zones_kernel_gives_the_walks_bits(device, order, dims, mode):
    """The kernel against its plan walked in plain PyTorch on the host
    (fem.dia_zones.dia_zones_walk, the CPU tests' walk), float64."""
    import dataclasses
    from tpufem_torch.fem.dia_zones import dia_zones_apply, dia_zones_walk
    pack = _pk_dia(order, dims, torch.float64, device, mode).zone_pack
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        pack.ndofs))
    y = dia_zones_apply(x.to(device), pack)
    walk, n = dia_zones_walk(x, dataclasses.replace(
        pack, fields=pack.fields.cpu()))
    assert n["twice"] == 0 and torch.equal(y.cpu(), walk)


def test_order3_golden_on_the_card(device):
    """tests/test_golden.py's order3 in float64 through the zone kernel
    (the P3 level; the P1 level is the coarse inverse)."""
    from tpufem_torch import cli
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    dia_zones_apply.launches = 0
    res = cli.main(["--problem_type", "poisson", "--order", "3", "--ndofs",
                    "15000", "--dtype", "float64", "-ksp_rtol", "1e-8",
                    "--device", "cuda"])
    assert res.iterations == 19
    assert abs(res.norm - 25.64720150160304) <= 1e-9 * 25.64720150160304
    assert dia_zones_apply.launches > 0


def test_cgpoisson_use_strip0_engages_the_zone_kernel(device):
    from tpufem_torch import cli
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    dia_zones_apply.launches = 0
    StripOperator.apply_strips.launches = 0
    res = cli.main(["--problem_type", "cgpoisson", "--order", "2", "--ndofs",
                    "3000", "--dtype", "float64", "--device", "cuda",
                    "-use_strip", "0"])
    assert isinstance(res.problem.solver_function.op, DiaOperator)
    assert dia_zones_apply.launches > 0
    assert StripOperator.apply_strips.launches == 0
    assert res.iterations == 78
    assert abs(res.norm - 11.382201359027317) <= 1e-9 * 11.382201359027317


# -- the blocked per-perm apply of P2/P3 elasticity: csrc/perm_apply.cu -------
def _perm_op(order, dims, dtype, device):
    from tpufem_torch.fem.structured_op import StructuredOperator
    from tpufem_torch.problems.common import elasticity_bc_marker
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(
        FunctionSpace(mesh, order, bs=3),
        mesh.locate_boundary_facets(elasticity_bc_marker))
    return StructuredOperator.build(mesh, order, "elasticity",
                                    bc_dofs=bc.flat_dofs(), dtype=dtype,
                                    device=device, planar=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order,dims", [
    (2, (2, 3, 2)), (3, (2, 3, 2)), (2, (24, 24, 32)), (3, (16, 16, 24)),
    (3, (5, 3, 7)), (2, (5, 1, 6)), (3, (1, 6, 3)), (3, (6, 5, 1)),
    (2, (9, 2, 13))],
    ids=["P2-2x3x2", "P3-2x3x2", "P2-500k", "P3-500k", "P3-odd",
         "P2-5x1x6", "P3-1x6x3", "P3-6x5x1", "P2-9x2x13"])
def test_perm_apply_kernel_matches_plain(device, order, dims, dtype):
    """Lattices where every entry lies near the boundary (2x3x2 cubes), the
    500k fine operators (192 / 576 bricks of 8 x 2 x 2 cubes; P3 f64
    stages the most shared memory, 139,376 bytes a block), an odd
    lattice and lattices one cube thick or not a multiple of the brick
    (ragged bricks): one launch an apply, through the
    operator's prepared launch and the public wrapper, within
    perm_apply_bound of the plain version, the same bits twice;
    Dirichlet rows return x exactly."""
    from tpufem_torch.fem.perm_apply import (perm_apply, perm_apply_bound,
                                             perm_apply_plain)
    op = _perm_op(order, dims, dtype, device)
    pack = op.pack
    assert pack.mask.any()
    if dims[0] >= 16:  # the 500k operators: more bricks than SMs
        assert np.prod(pack.bricks) > 132
    x = torch.from_numpy(np.random.default_rng(order).standard_normal(
        3 * pack.ns)).to(device, dtype)
    before = perm_apply.launches
    y = op.apply(x)
    assert perm_apply.launches == before + 1
    yp = perm_apply_plain(x, pack)
    torch.cuda.synchronize()
    assert bool(((y - yp).abs() <= perm_apply_bound(x, pack)).all())
    assert torch.equal(y[pack.mask], x[pack.mask])
    assert torch.equal(perm_apply(x, pack), y)
    assert torch.equal(op.apply(x), y)
    assert bool(torch.isfinite(y).all())


def test_perm_apply_on_a_side_stream_and_refusals(device):
    """The prepared launch on a non-default stream; a wrong dtype, length
    or device raises; the entry point refuses cells it has no form for."""
    from tpufem_torch import _build
    from tpufem_torch.fem.perm_apply import perm_apply, prepare_perm_apply
    op = _perm_op(2, (4, 3, 5), torch.float32, device)
    pack = op.pack
    x = torch.randn(3 * pack.ns, device=device)
    y0 = perm_apply(x, pack)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        y = op.apply(x)
    side.synchronize()
    assert torch.equal(y, y0)
    launch = prepare_perm_apply(pack)
    with pytest.raises(ValueError):
        launch(x.double())
    with pytest.raises(ValueError):
        launch(torch.zeros(2 * x.numel(), device=device)[::2])
    with pytest.raises(ValueError):
        launch(x[1:])
    with pytest.raises(TypeError):
        perm_apply(x.cpu(), pack)
    with pytest.raises(TypeError):
        perm_apply(x.double(), pack)
    lib = _build.load().lib
    Nx, Ny, Nz = pack.dims
    stream = torch.cuda.current_stream().cuda_stream
    bx, by, bz = pack.bricks
    Y = torch.empty(6 * 3 * pack.n * pack.y_cubes, device=device)
    for n, nchan, nout in ((7, len(pack.chans), len(pack.outputs)),
                           (pack.n, 2000, len(pack.outputs)),
                           (pack.n, len(pack.chans), 0)):
        bad = _build.PermApplyLaunch(
            W=pack.weights.data_ptr(), Y=Y.data_ptr(),
            entries=pack.dev_entries.data_ptr(),
            outputs=pack.dev_outputs.data_ptr(),
            sources=pack.dev_sources.data_ptr(),
            kinds=pack.dev_kinds.data_ptr(), chans=pack.dev_chans.data_ptr(),
            mask=pack.mask.data_ptr(), bc=pack.dev_bc_bricks.data_ptr(),
            device=0, n=n, ns=pack.ns, nout=nout,
            nchan=nchan, Nx=Nx, Ny=Ny, Nz=Nz, bx=bx, by=by, bz=bz,
            max_points=pack.max_points)
        rc = lib.tpufem_perm_apply_f32(ctypes.addressof(bad), x.data_ptr(),
                                       y.data_ptr(), stream)
        assert rc != 0 and lib.tpufem_cuda_error_string(rc)
    torch.cuda.synchronize()


@pytest.mark.parametrize("order,iterations,norm", [
    (2, 19, 2.2017755354284647e-05), (3, 33, 2.098447872071006e-05)])
def test_elasticity_pk_goldens_on_the_card(device, order, iterations, norm):
    """tpufem's float64 P2 (10,647 dofs) and P3 (9,633 dofs) elasticity
    runs through the perm_apply kernel: 5 launches per CG iteration."""
    from tpufem_torch import cli
    from tpufem_torch.fem.perm_apply import perm_apply
    perm_apply.launches = 0
    res = cli.main(["--problem_type", "elasticity", "--order", str(order),
                    "--ndofs", "10000", "--dtype", "float64", "--device",
                    "cuda"])
    assert res.iterations == iterations
    assert abs(res.norm - norm) <= 1e-9 * norm
    assert perm_apply.launches == 5 * res.iterations


def _random_csr(n, m, density, seed, wide_rows=0):
    """A random n x m CSR matrix; ``wide_rows`` rows get every column (a
    hub row, as the spoke mesh's)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    M = sp.random(n, m, density=density, random_state=seed, format="lil")
    for r in range(wide_rows):
        M[r, :] = rng.standard_normal(m)
    M = M.tocsr()
    M.data = rng.standard_normal(M.nnz)
    return M


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (5000, 5000, 0.003, 0), (4000, 300, 0.013, 0), (300, 4000, 0.05, 0),
    (7, 9, 0.4, 0), (2000, 2000, 0.002, 3), (1, 33, 1.0, 0)],
    ids=["square", "P", "PT", "tiny", "hub", "one_row"])
def test_csr_spmv_kernel_matches_plain(device, shape, dtype):
    """The CSR kernel against its plain version within csr_spmv_bound,
    one wrapper call a product, the same bits twice."""
    from tpufem_torch.fem.csr_spmv import (CsrMatrix, csr_spmv,
                                           csr_spmv_bound, csr_spmv_plain)
    n, m, dens, wide = shape
    M = _random_csr(n, m, dens, 2, wide)
    A = CsrMatrix.from_scipy(M, getattr(torch, dtype), device)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(m)).to(
        device, A.out_dtype)
    before = csr_spmv.launches
    y = A.matvec(x)
    assert csr_spmv.launches == before + 1
    yp = csr_spmv_plain(A, x)
    torch.cuda.synchronize()
    assert y.dtype == A.out_dtype and bool(torch.isfinite(y).all())
    assert bool(((y - yp).abs() <= csr_spmv_bound(A, x)).all())
    assert torch.equal(csr_spmv(A, x), y)  # deterministic: the same bits


def test_csr_spmv_on_a_side_stream_and_refusals(device):
    from tpufem_torch import _build
    from tpufem_torch.fem.csr_spmv import CsrMatrix, csr_spmv
    A = CsrMatrix.from_scipy(_random_csr(300, 200, 0.05, 1), torch.float32,
                             device)
    x = torch.randn(200, device=device)
    y0 = csr_spmv(A, x)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        y = A.matvec(x)
    side.synchronize()
    assert torch.equal(y, y0)
    with pytest.raises(ValueError):
        A.matvec(x.double())
    with pytest.raises(ValueError):
        A.matvec(x[1:])
    with pytest.raises(ValueError):
        A.matvec(torch.zeros(400, device=device)[::2])
    with pytest.raises(ValueError):
        csr_spmv(A, x.cpu())
    with pytest.raises(ValueError):  # vals off a 16-byte boundary
        dataclasses.replace(A, vals=A.vals[1:], indices=A.indices[1:],
                            _launch=None).matvec(x[:A.ncols])
    lib = _build.load().lib
    stream = torch.cuda.current_stream().cuda_stream
    launch = A._launch.keep[0]
    for field, value in (("tiles", A.tiles + 1), ("n", 0), ("nnz", -1),
                         ("vals", A.vals.data_ptr() + 4),
                         ("tile_row", 0)):
        bad = _build.CsrLaunch.from_buffer_copy(launch)
        setattr(bad, field, value)
        rc = lib.tpufem_csr_spmv_f32(ctypes.addressof(bad), x.data_ptr(),
                                     y.data_ptr(), stream)
        assert rc != 0 and lib.tpufem_cuda_error_string(rc)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("name", ["long_rows", "three_tiles", "one_entry",
                                  "empty_runs", "ragged", "hub"])
def test_csr_spmv_cut_rows_on_the_card(device, name, dtype):
    """The cases the plan must cut right (tests/test_torch_csr_plan.py:
    rows longer than a tile, a row across three tiles, one-entry rows,
    runs of empty rows at the start, the middle and the end, n and nnz no
    multiple of the tile, the hub row): within csr_spmv_bound of the
    plain version, empty rows 0, the same bits on two launches."""
    from test_torch_csr_plan import TILE, csr_of_lengths, plan_cases
    from tpufem_torch.fem.csr_spmv import (CsrMatrix, csr_spmv_bound,
                                           csr_spmv_plain)
    lengths, ncols = plan_cases(TILE)[name]
    M = csr_of_lengths(lengths, ncols, 11)
    A = CsrMatrix.from_scipy(M, getattr(torch, dtype), device)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        ncols)).to(device, A.out_dtype)
    y = A.matvec(x)
    yp = csr_spmv_plain(A, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert bool(((y - yp).abs() <= csr_spmv_bound(A, x)).all())
    empty = torch.from_numpy(np.diff(M.indptr) == 0).to(device)
    assert bool((y[empty] == 0).all())
    assert torch.equal(A.matvec(x), y)


@pytest.mark.parametrize("n", [1, 7, 8, 333, 4096, 9512, 18840, 25001])
def test_dense_gemv_bf16_kernel_matches_plain(device, n):
    """The bf16 level's product against its plain version within
    dense_gemv_bound (ragged and aligned widths; the spoke 500k level's
    9,512 rows, elasticity P1's 18,840 and a width whose bf16(x) takes
    more than 48 KB of shared memory), float32 out, the same bits on
    two launches."""
    import scipy.sparse as sp
    from tpufem_torch.fem.dense_gemv import (DenseMat, dense_gemv_bf16,
                                             dense_gemv_bf16_plain,
                                             dense_gemv_bound,
                                             dense_smem_bytes)
    rng = np.random.default_rng(n)
    if n <= 4096:
        S = sp.csr_matrix(rng.standard_normal((n, n))
                          * (rng.random((n, n)) < .3))
        D = DenseMat.from_csr(S.indptr, S.indices, S.data, n, torch.bfloat16,
                              device)
    else:  # made on the card: the host would hold n^2 float64
        gen = torch.Generator(device=device).manual_seed(n)
        M = torch.zeros(n, -(-n // 8) * 8, dtype=torch.bfloat16,
                        device=device)
        M[:, :n] = torch.randn(n, n, generator=gen, device=device).to(
            torch.bfloat16)
        D = DenseMat(M, n)
    if n > 24576:
        assert dense_smem_bytes(n) > 48 * 1024
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    before = dense_gemv_bf16.launches
    y = D.matvec(x)
    assert dense_gemv_bf16.launches == before + 1 and y.dtype == torch.float32
    torch.cuda.synchronize()
    err = (y - dense_gemv_bf16_plain(D, x)).abs()
    assert bool((err <= dense_gemv_bound(D, x)).all())
    assert torch.equal(dense_gemv_bf16(D, x), y)
    with pytest.raises(ValueError):
        D.matvec(x.double())


@pytest.mark.parametrize("argv,iterations,norm", [
    (["--ndofs", "15000", "-pc_type", "amg", "-amg_brick", "off"], 13,
     26.53502030570293),
    (["--mesh_type", "unstructured", "--ndofs", "20000"], 58,
     738.3125824626104)], ids=["cube", "spoke"])
def test_saamg_goldens_on_the_card(device, argv, iterations, norm):
    """tpufem's float64 SA-AMG runs through the CSR kernel (the factored
    P0 / P0^T on the cube; the fine operator, P, P^T on the spoke)."""
    from tpufem_torch import cli
    from tpufem_torch.fem.csr_spmv import csr_spmv
    csr_spmv.launches = 0
    res = cli.main(argv + ["--dtype", "float64", "--device", "cuda"])
    assert res.iterations == iterations
    assert abs(res.norm - norm) <= 1e-9 * norm
    assert csr_spmv.launches >= 2 * res.iterations


def _matfree_op(order, dtype, device, ndofs=3000):
    """The matrix-free operator of the spoke mesh at ``order`` (weak
    scaling: 9,254 cells at 3,000 dofs) on ``device``."""
    from tpufem_torch.fem.matfree_op import MatFreePoissonOp
    from tpufem_torch.mesh.spoke import create_spoke_mesh
    mesh = create_spoke_mesh(ndofs, False, 1, 1, verbose=False)
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(poisson_bc_marker))
    return MatFreePoissonOp.build(space, bc, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_matfree_action_kernel_matches_plain(device, order, dtype):
    """The matrix-free kernel against its plain version on the spoke mesh
    at P1-P3, within matfree_action_bound; one count an apply; the same
    bits twice."""
    from tpufem_torch.fem.matfree_op import (matfree_action,
                                             matfree_action_bound,
                                             matfree_apply_plain)
    op = _matfree_op(order, dtype, device)
    x = torch.from_numpy(np.random.default_rng(order).standard_normal(
        op.ndofs)).to(device, dtype)
    before = matfree_action.launches
    y = op.apply(x)
    assert matfree_action.launches == before + 1
    torch.cuda.synchronize()
    err = (y - matfree_apply_plain(op, x)).abs()
    assert bool(torch.isfinite(y).all())
    assert bool((err <= matfree_action_bound(op, x)).all())
    assert torch.equal(matfree_action(op, x), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_matfree_action_single_cell_empty_dofs_and_bc(device, order, dtype):
    """One cell, three dofs in no cell (no slots: 0), a Dirichlet row (0):
    the kernel gives the plain version's values."""
    from tpufem_torch.fem.assemble import metric_np
    from tpufem_torch.fem.matfree_op import (MatFreePoissonOp,
                                             matfree_action_bound,
                                             matfree_apply_plain)
    from tpufem_torch.fem.reference import ReferenceTet
    n = ReferenceTet(order).ndofs
    coords = np.array([[[0.0, 0.0, 0.0], [1.0, 0.1, 0.0], [0.2, 0.9, 0.1],
                        [0.1, 0.2, 1.1]]])
    op = MatFreePoissonOp.from_arrays(metric_np(coords),
                                      np.arange(n)[None, :], [1], n + 3,
                                      order, dtype, device)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        op.ndofs)).to(device, dtype)
    y = op.apply(x)
    torch.cuda.synchronize()
    assert float(y[1]) == 0.0 and bool((y[-3:] == 0).all())
    err = (y - matfree_apply_plain(op, x)).abs()
    assert bool((err <= matfree_action_bound(op, x)).all())


def _matfree_cluster_case(case, order, dtype, device):
    """A CUDA operator whose cluster plan is an edge of the design:
    ``all_halo``, three copies of one cell in clusters of one cell (every
    free dof summed from partials, a Dirichlet row); ``smem_limit``, one
    cluster of distinct cells whose float64 block needs just under the
    card's 227 KB of shared memory."""
    from tpufem_torch.fem.assemble import SMEM_BYTES, cluster_plan, metric_np
    from tpufem_torch.fem.matfree_op import MatFreePoissonOp
    from tpufem_torch.fem.reference import ReferenceTet
    n = ReferenceTet(order).ndofs
    rng = np.random.default_rng(order)
    if case == "all_halo":
        cells, cd, bc = 1, np.tile(np.arange(n), (3, 1)), np.array([0])
    else:  # distinct dofs: 24 bytes a slot in float64
        cells = SMEM_BYTES // (24 * n)
        while True:
            try:   # the plan refuses a cluster over the limit
                cluster_plan(np.arange(cells * n).reshape(cells, n),
                             cells * n, cells=cells)
                break
            except ValueError:
                cells -= 1
        cd, bc = np.arange(cells * n).reshape(cells, n), np.zeros(0, int)
    coords = (np.array([[0.0, 0.0, 0.0], [1.0, 0.1, 0.0], [0.2, 0.9, 0.1],
                        [0.1, 0.2, 1.1]])[None]
              + 0.05 * rng.standard_normal((cd.shape[0], 4, 3)))
    N = int(cd.max()) + 1
    op = MatFreePoissonOp.from_arrays(metric_np(coords), cd, bc, N, order,
                                      dtype, device)
    op.cplan = cluster_plan(cd, N, bc, cells=cells)
    if case == "smem_limit":
        assert SMEM_BYTES - 48 * n < op.cplan.smem_bytes(8) <= SMEM_BYTES
    return op


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("case", ["all_halo", "smem_limit"])
def test_matfree_action_cluster_edges(device, case, order, dtype):
    """The kernel on a cluster that is all halo and on one at the shared-
    memory limit: within matfree_action_bound of the plain version, the
    same bits twice, one count an apply."""
    from tpufem_torch.fem.matfree_op import (matfree_action,
                                             matfree_action_bound,
                                             matfree_apply_plain)
    op = _matfree_cluster_case(case, order, dtype, device)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        op.ndofs)).to(device, dtype)
    before = matfree_action.launches
    y = op.apply(x)
    assert matfree_action.launches == before + 1
    torch.cuda.synchronize()
    err = (y - matfree_apply_plain(op, x)).abs()
    assert bool(torch.isfinite(y).all())
    assert bool((err <= matfree_action_bound(op, x)).all())
    assert torch.equal(matfree_action(op, x), y)
    if case == "all_halo":
        assert float(y[0]) == 0.0


def test_matfree_action_refusals(device):
    """A CUDA operator with x on the CPU raises (no fallback to the plain
    version), as do x of another dtype or shape."""
    from tpufem_torch.fem.matfree_op import matfree_action
    op = _matfree_op(1, torch.float32, device)
    with pytest.raises(ValueError):
        matfree_action(op, torch.zeros(op.ndofs))
    with pytest.raises(TypeError):
        matfree_action(op, torch.zeros(op.ndofs, dtype=torch.float64,
                                       device=device))
    with pytest.raises(ValueError):
        matfree_action(op, torch.zeros(op.ndofs + 1, device=device))


def test_matfree_entry_and_cgpoisson_on_the_card(device):
    """The entry twin launches the kernel; tpufem's f64 spoke cgpoisson
    P1 run (100 steps, norm 251.62201939995953) through it."""
    from tpufem_torch import cli
    from tpufem_torch.entry import entry
    from tpufem_torch.fem.matfree_op import matfree_action
    fn, (op, x) = entry()
    before = matfree_action.launches
    y = fn(op, x)
    assert matfree_action.launches == before + 1 and y.is_cuda
    matfree_action.launches = 0
    res = cli.main(["--problem_type", "cgpoisson", "--mesh_type",
                    "unstructured", "--ndofs", "3000", "--dtype", "float64",
                    "--device", "cuda"])
    assert res.iterations == 100 and matfree_action.launches >= 100
    assert abs(res.norm - 251.62201939995953) <= 1e-9 * 251.62201939995953


# -- sharded runs: the slab and row-sharded solvers on the card ----------


@pytest.mark.parametrize("problem,order,precond,dims,S", [
    ("poisson", 1, True, (8, 8, 16), 4),
    ("elasticity", 1, True, (8, 8, 16), 4),
    ("poisson", 2, False, (6, 6, 8), 4), ("poisson", 3, True, (8, 8, 16), 4),
    ("poisson", 2, True, (8, 8, 24), 4), ("poisson", 3, True, (8, 8, 12), 2)],
    ids=["poisson-1-True", "elasticity-1-True", "poisson-2-False",
         "poisson-3-True", "poisson-2-True-const", "poisson-3-True-const"])
def test_slab_sharded_solve_on_the_card(device, problem, order, precond, dims,
                                        S):
    """A small float64 slab-sharded solve (S shards on the one card, the
    slab operators' kernels: K1, its three-component form, dia_zones;
    slabs of 6 planes: the P2 / P3 const DIA) against the same solve on
    the CPU (the plain versions): the same iterations and solutions to
    rounding."""
    from tpufem_torch.fem.stencil import stencil_apply_bs3
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    from tpufem_torch.la.gmg import prepare_h_transfers
    from tpufem_torch.parallel.slab import ShardedCubeSolver
    kw = dict(problem=problem, order=order, dtype=torch.float64,
              rtol=1e-8 if precond else 1e-6, maxit=60 if precond else 400,
              precond=precond, gather_limit=500)
    counters = (stencil_apply, stencil_apply_bs3, dia_zones_apply,
                prepare_h_transfers)
    for c in counters:
        c.launches = 0
    sh = ShardedCubeSolver.build(BoxTetMesh(*dims), S, device=device, **kw)
    xg, itg, _ = sh.solve()
    launched = [c.launches for c in counters]
    xc, itc, _ = ShardedCubeSolver.build(BoxTetMesh(*dims), S,
                                         device=torch.device("cpu"),
                                         **kw).solve()
    assert itg == itc if precond else abs(itg - itc) <= 1
    assert np.abs(xg - xc).max() <= 1e-9 * np.abs(xc).max()
    k = {("poisson", 1): 0, ("elasticity", 1): 1, ("poisson", 2): 2}.get(
        (problem, order))
    if getattr(sh.levels[0].op, "zone_pack", None) is not None:
        k = 2
    if k is not None:
        assert launched[k] > 0, launched
    if precond:
        assert launched[0 if problem == "poisson" else 1] > 0
    if precond and order == 1:  # the slabs' h-transfers: the kernel
        assert launched[3] > 0, launched


def test_dryrun_multichip_on_the_card(device, capsys):
    """The dryrun_multichip twin's four sharded paths, 8 shards on the
    one card against one (it asserts convergence and parity)."""
    from tpufem_torch.entry import dryrun_multichip
    dryrun_multichip(8, device)
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip[") == 4


def test_rowshard_solve_on_the_card(device):
    """The row-sharded P2 solve (8 shards, the distributed level 1 and
    the replicated one) on csr_spmv against the CPU's."""
    from tpufem_torch.config import SolverOptions
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.fem.csr_spmv import csr_spmv
    from tpufem_torch.parallel.rowshard import ShardedEllSolver
    from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, 2)
    bc = DirichletBC.from_space(space,
                                mesh.locate_boundary_facets(poisson_bc_marker))
    csr = assemble_csr_np(space, bc, "poisson")
    b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    for opts in ({}, dict(amg_dense_level_limit=0, amg_coarse_eq_limit=50)):
        out = []
        for dev in (device, torch.device("cpu")):
            csr_spmv.launches = 0
            sh = ShardedEllSolver.build(space, bc, csr, b, 8,
                                        SolverOptions(**opts),
                                        dtype=torch.float64, device=dev)
            out.append(sh.solve() + (csr_spmv.launches,))
        (xg, itg, _, n), (xc, itc, _, _) = out
        assert n > 0 and itg == itc
        assert np.abs(xg - xc).max() <= 1e-9 * np.abs(xc).max()


def test_sharded_goldens_on_the_card(device):
    """tpufem's sharded float64 goldens through the CLI on the card."""
    from tpufem_torch import cli
    from tpufem_torch.problems import sharded
    orig, sharded.TIMING_REPS = sharded.TIMING_REPS, 0
    try:
        for args, it, norm in (
                ("--problem_type poisson --ndofs 100000 --scaling_type "
                 "strong --num_shards 8 -ksp_rtol 1e-8", 11,
                 68.43884037046897),
                ("--problem_type elasticity --ndofs 10000 --scaling_type "
                 "weak --num_shards 4", 20, 4.3635484081745004e-05)):
            r = cli.main(args.split() + ["--dtype", "float64",
                                         "--device", "cuda"])
            assert r.iterations == it
            assert abs(r.norm - norm) <= 1e-9 * norm
    finally:
        sharded.TIMING_REPS = orig


# -- --output, --memory_profiling and the reduced ZZZ table on the card ----


@pytest.mark.parametrize("args", [
    "--ndofs 20000", "--problem_type elasticity --ndofs 10000"],
    ids=["poisson", "elasticity"])
def test_output_on_the_card(device, args, tmp_path):
    """--output of a card run: the file re-read (where h5py is installed;
    elsewhere --output raises naming it, and the datasets the writer
    would write are built instead) holds the run's x moved to the host,
    node-interleaved for elasticity, bit for bit, and the mesh."""
    import importlib.util
    from tpufem_torch import cli
    from tpufem_torch.io import read_xdmf, xdmf_datasets
    argv = args.split() + ["--dtype", "float32", "--device", "cuda"]
    out = tmp_path / "out"
    if importlib.util.find_spec("h5py") is not None:
        res = cli.main(argv + ["--output", str(out)])
        got = read_xdmf(str(out / "solution-1.xdmf"))
        values, topology = got["values"], got["topology"]
    else:
        with pytest.raises(ImportError, match=r"--output.*h5py"):
            cli.main(argv + ["--output", str(out)])
        assert not out.exists()
        res = cli.main(argv)
        data, _ = xdmf_datasets(res.problem.space.mesh, res.x.cpu().numpy(),
                                res.problem.space.bs, res.problem.space)
        values, topology = data["/function/values"], data["/mesh/topology"]
    space = res.problem.space
    x = res.x.cpu().numpy()
    assert res.x.device.type == "cuda" and x.shape == (space.ndofs,)
    nv = space.mesh.num_vertices_global
    assert values.tobytes() == x.reshape(-1, space.bs)[:nv].tobytes()
    assert np.array_equal(topology, space.mesh.cells())


def test_device_memory_stats_on_the_card(device):
    """tpufem's keys from the caching allocator: bytes_in_use counts a
    live tensor."""
    from tpufem_torch.memprof import device_memory_stats
    x = torch.ones(1 << 20, device=device)
    stats = device_memory_stats(device)
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        device).total_memory
    assert device_memory_stats(torch.device("cpu")) == {}


def test_reduced_table_of_a_sharded_card_run(device, capsys):
    """--num_shards 2 on the card prints tpufem's reduced ZZZ table."""
    from tpufem_torch import cli
    from tpufem_torch.problems import sharded
    orig, sharded.TIMING_REPS = sharded.TIMING_REPS, 0
    try:
        cli.main(["--ndofs", "20000", "--num_shards", "2", "--device",
                  "cuda"])
    finally:
        sharded.TIMING_REPS = orig
    out = capsys.readouterr().out
    assert "wall min" in out and "wall max" in out
    assert "(reduced over 2 shards; SPMD lockstep" in out


# -- tpufem's strong-scaling widths: K1 at X = 209, the three-component K1
#    at X = 129 (its 10M elasticity grid is 161x161x129) -----------------
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
def test_kernel_matches_plain_at_the_10m_widths(device, dtype, tol):
    """A few planes of the 10M rows' (y, x) planes: each block stages a
    halo of X + 1 points either side of its 256 (128) points."""
    from tpufem_torch.fem import stencil
    op = _op((208, 208, 21), "const", dtype, device)
    assert op.grid_dims == (22, 209, 209)
    assert stencil.stencil_runs(op.grid_dims, 7, op.fields.element_size()
                                )[:, 1].max() == 8
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(device,
                                                                   dtype)
    args = (op.fields, op.offsets, op.grid_dims)
    yk = stencil_apply(x, *args)
    yp = stencil_apply_plain(x, *args)
    bound = stencil_apply_plain(x.abs(), op.fields.abs(), *args[1:])
    assert bool(((yk - yp).abs() <= tol * bound).all())
    op3 = _elast_op((128, 160, 9), "const", dtype, device)
    assert op3.grid_dims == (10, 161, 129)
    x3 = torch.from_numpy(rng.standard_normal(3 * op3.layout.ndofs)).to(
        device, dtype)
    args3 = (op3.fields, op3.offsets, op3.grid_dims)
    yk3 = stencil.stencil_apply_bs3(x3, *args3)
    yp3 = stencil.stencil_apply_bs3_plain(x3, *args3)
    bound3 = stencil.stencil_apply_bs3_plain(x3.abs(), op3.fields.abs(),
                                             *args3[1:])
    assert bool(((yk3 - yp3).abs() <= 3 * tol * bound3).all())


# -- -use_conv 1: the channel convolution (cuDNN conv3d + torch.einsum) -----
def _conv(order, dims, dtype, device):
    from tpufem_torch.fem.conv_op import ConvStencilOp
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order),
                                mesh.locate_boundary_facets(poisson_bc_marker))
    dia = DiaOperator.try_const(mesh, order, "poisson",
                                bc_dofs=bc.flat_dofs(), dtype=torch.float64)
    return (ConvStencilOp.from_dia(dia, dtype=dtype, device=device),
            ConvStencilOp.from_dia(dia, dtype=torch.float64), dia)


@pytest.mark.parametrize("order,dims", [(2, (8, 9, 10)), (3, (8, 9, 10)),
                                        (3, (24, 24, 32))],
                         ids=["P2", "P3", "P3-500k"])
def test_conv_op_on_the_card(device, monkeypatch, order, dims):
    """float32 on the card against the float64 operator on the host
    within tpufem's 2e-5 * max|ref| for two forms of one matrix, TF32 off;
    the channel-resident apply keeps phantoms and the ring zero; with
    cuDNN's TF32 on, the apply refuses."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    op, ref_op, dia = _conv(order, dims, torch.float32, device)
    x = np.random.default_rng(3).standard_normal(dia.layout.ndofs)
    ref = ref_op.apply(torch.from_numpy(x))
    xd = torch.from_numpy(x).to(device, torch.float32)
    got = op.apply(xd).double().cpu()
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    xp = op.to_channels_padded(xd)
    yp = op.apply_channels(xp)
    assert not (yp[1:-1, 1:-1, 1:-1] * (1 - op.chan_mask)).any()
    assert torch.equal(op.from_channels_padded(yp), op.apply(xd))
    # float64 on the card: cuDNN's double convolution
    op64, _, _ = _conv(order, dims, torch.float64, device)
    got64 = op64.apply(torch.from_numpy(x).to(device)).cpu()
    assert float((got64 - ref).abs().max()) <= 1e-12 * float(
        ref.abs().max())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        op.apply(xd)
    torch.cuda.synchronize()


def test_cgpoisson_use_conv_on_the_card(device):
    """-use_conv 1 through the CLI on the card (P2 8x8x10, float64, 60
    steps): the conv operator channel-resident, no stencil kernel
    launched, at tpufem's norm (tests/test_torch_conv.py's CONV_P2_REF)."""
    from tpufem_torch import cli
    from tpufem_torch.fem.conv_op import ConvStencilOp
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    StripOperator.apply_strips.launches = 0
    FlatOperator.interior.launches = 0
    dia_zones_apply.launches = 0
    res = cli.main(["--problem_type", "cgpoisson", "--order", "2", "--ndofs",
                    "6000", "--dtype", "float64", "--device", "cuda",
                    "-use_conv", "1", "-cg_kmax", "60", "-cg_rtol", "0",
                    "-use_flat", "1"])
    solver = res.problem.solver_function
    assert isinstance(solver.op, ConvStencilOp) and solver.channels
    assert solver.op.device.type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert (StripOperator.apply_strips.launches, FlatOperator.interior.launches,
            dia_zones_apply.launches) == (0, 0, 0)
    assert res.iterations == 60
    assert abs(res.norm - 16.571713427813453) <= 1e-9 * 16.571713427813453


# -- the GMG h-transfers with their masks: csrc/gmg_transfer.cu -------------
# coarse lattices (Nx, Ny, Nz) of the transfers: two odd small ones and the
# 10M strong-scaling row's four (208x208x224 cubes halved down to 13x13x14)
GMG_10M_COARSE = tuple(tuple(n >> k for n in (208, 208, 224))
                       for k in range(1, 5))


@functools.lru_cache(maxsize=None)
def _vertex_bc_mask(dims):
    """The Poisson Dirichlet mask of a lattice's vertices, flat, on the
    host."""
    from tpufem_torch.la.gmg import vertex_bc_mask
    return torch.from_numpy(vertex_bc_mask(BoxTetMesh(*dims),
                                           poisson_bc_marker))


def _transfer_case(cd, batch, dtype, device, masks, seed=0):
    """(fine grids, coarse grids, fine mask, coarse mask) of a batch on
    the card: standard normal values, every 7th (5th) -0.0; the masks
    the lattices' Dirichlet masks, one a grid, or None."""
    fd = tuple(2 * v for v in cd)
    g = torch.Generator(device=device).manual_seed(seed)
    f = torch.randn((batch, fd[2] + 1, fd[1] + 1, fd[0] + 1), generator=g,
                    device=device, dtype=dtype)
    c = torch.randn((batch, cd[2] + 1, cd[1] + 1, cd[0] + 1), generator=g,
                    device=device, dtype=dtype)
    f.view(-1)[::7] = -0.0
    c.view(-1)[::5] = -0.0
    if not masks:
        return f, c, None, None
    return (f, c, _vertex_bc_mask(fd).repeat(batch).to(device),
            _vertex_bc_mask(cd).repeat(batch).to(device))


def _same_bits(a, b):
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(it), b.view(it))


def _slices(f, c, fm, cm):
    """The slice path with GMG.vcycle's masked_fills, on the card."""
    from tpufem_torch.la import gmg

    def fill(v, m):
        v = v.reshape(-1)
        return v if m is None else v.masked_fill(m, 0.0)

    rc = fill(gmg.restrict_h_plain(fill(f, fm).reshape(f.shape)), cm)
    pc = fill(gmg.prolong_h_plain(fill(c, cm).reshape(c.shape)), fm)
    return rc, pc


@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("cd", ((3, 2, 4), (4, 5, 6)) + GMG_10M_COARSE)
@pytest.mark.parametrize("batch", [1, 3, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gmg_transfer_kernels_give_the_slices_bits(device, dtype, batch, cd,
                                                   masks):
    from tpufem_torch import timing
    from tpufem_torch.la import gmg
    f, c, fm, cm = _transfer_case(cd, batch, dtype, device, masks)
    restrict, prolong = gmg.prepare_h_transfers(
        batch, tuple(c.shape[1:]), dtype, device, fine_mask=fm,
        coarse_mask=cm)
    was = timing.enable_spans(True)
    timing.SPANS.reset()
    try:
        rk, pk = restrict(f), prolong(c)
        counters = dict(timing.SPANS.counters)
    finally:
        timing.enable_spans(was)
        timing.SPANS.reset()
    rs, ps = _slices(f, c, fm, cm)
    torch.cuda.synchronize()
    assert counters == {"gmg.transfers": 2, "gmg.transfers.kernel": 2}
    assert _same_bits(rk, rs) and _same_bits(pk, ps)
    if not masks:  # the unmasked public pair launches the same kernels
        assert _same_bits(gmg.restrict_h(f), rs.reshape(c.shape))
        assert _same_bits(gmg.prolong_h(c).reshape(-1), ps)


@pytest.mark.parametrize("masks", [True, False])
def test_gmg_transfer_kernels_are_adjoint(device, masks):
    """<P c, f> = <c, R f> in float64, masks on both sides or none."""
    from tpufem_torch.la import gmg
    cd = GMG_10M_COARSE[2]
    f, c, fm, cm = _transfer_case(cd, 3, torch.float64, device, masks, 1)
    restrict, prolong = gmg.prepare_h_transfers(
        3, tuple(c.shape[1:]), torch.float64, device, fine_mask=fm,
        coarse_mask=cm)
    lhs = float(torch.dot(prolong(c), f.reshape(-1)))
    rhs = float(torch.dot(c.reshape(-1), restrict(f)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_gmg_vcycle_launches_the_transfer_kernels(device):
    """A V-cycle of the 10M row's float32 GMG (four smoothed levels):
    every h-transfer is one launch of the kernel, gmg.transfers.kernel =
    gmg.transfers = 8, and the V-cycle has the bits of the same V-cycle
    through the slice path."""
    from tpufem_torch import timing
    from tpufem_torch.la import gmg
    from tpufem_torch.mesh.structured import BoxTetMesh as Mesh
    pc = gmg.GMG.setup(Mesh(208, 208, 224), 1, "poisson", poisson_bc_marker,
                       device, dtype=torch.float32)
    assert len(pc.levels) == 4
    n = pc.levels[0].op.layout.ndofs
    r = torch.randn(n, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).masked_fill(pc.levels[0].op.bc_mask, 0.0)
    was = timing.enable_spans(True)
    timing.SPANS.reset()
    try:
        z = pc.vcycle(r)
        counters = dict(timing.SPANS.counters)
    finally:
        timing.enable_spans(was)
        timing.SPANS.reset()
    assert counters == {"gmg.transfers": 8, "gmg.transfers.kernel": 8}

    def slice_pair(i):
        fm, cm = pc.levels[i].op.bc_mask, pc._bc_mask_of(i + 1)
        fine, coarse = pc._vertex_grid(i), pc._vertex_grid(i + 1)

        def restrict(v):
            return gmg.restrict_h_plain(v.masked_fill(fm, 0.0).reshape(
                fine)).reshape(-1).masked_fill(cm, 0.0)

        def prolong(v):
            return gmg.prolong_h_plain(v.masked_fill(cm, 0.0).reshape(
                coarse)).reshape(-1).masked_fill(fm, 0.0)

        return restrict, prolong

    kernels = pc._transfers
    pc._transfers = [slice_pair(i) for i in range(len(pc.levels))]
    z_slices = pc.vcycle(r)
    pc._transfers = kernels
    torch.cuda.synchronize()
    assert _same_bits(z, z_slices)


def test_gmg_transfer_refusals_and_a_side_stream(device):
    from tpufem_torch.la import gmg
    f, c, fm, cm = _transfer_case((3, 2, 4), 1, torch.float32, device, True)
    restrict, prolong = gmg.prepare_h_transfers(1, tuple(c.shape[1:]),
                                                torch.float32, device,
                                                fine_mask=fm, coarse_mask=cm)
    with pytest.raises(ValueError, match="contiguous"):
        gmg.restrict_h(f.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="contiguous"):
        prolong(torch.cat([c, c], dim=-1)[..., ::2])
    with pytest.raises(ValueError, match="odd"):
        gmg.restrict_h(f[..., :-1].contiguous())
    with pytest.raises(ValueError, match="grids"):
        gmg.prolong_h(c[0, 0].contiguous())
    with pytest.raises(ValueError, match="expected"):
        restrict(c)                                  # a coarse grid's entries
    with pytest.raises(ValueError, match="expected"):
        restrict(f.double())
    with pytest.raises(TypeError):
        gmg.restrict_h(f.half())
    with pytest.raises(ValueError, match="mask"):
        gmg.prepare_h_transfers(1, tuple(c.shape[1:]), torch.float32, device,
                                fine_mask=fm.cpu())
    rs, ps = _slices(f, c, fm, cm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rk, pk = restrict(f), prolong(c)
    side.synchronize()
    assert _same_bits(rk, rs) and _same_bits(pk, ps)
