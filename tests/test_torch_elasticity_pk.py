"""The port's P2/P3 elasticity pieces against tpufem's, on the CPU: the
blocked (bs = 3) StructuredOperator's apply on planar vectors (the plain
version of the perm_apply kernel), the kernel's tables walked as the
kernel walks them, the batched p-transfers, the elasticity surrogate
lmax at order k and the order-k planar V-cycle.

Tolerances: exact equality for the host twins and tables (the same
numpy arithmetic) and the batched transfers (the same elementwise
operations); rel 1e-13 for applies (float64 sums of up to 24 x 60 terms,
tpufem's through an XLA einsum, the port's through torch.matmul); 1e-12
for a V-cycle (tpufem's own test of its GMG).  tpufem runs in float64
only (its order-k float32 solve fails with x64 on, which these tests
need); tpufem solves order-k elasticity interleaved, the port planar, so
vectors are permuted between the two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dia_op import build_operator as tpu_build_operator
from tpufem.fem.structured_op import StructuredOperator as TpuStructured
from tpufem.la import gmg as tpu_gmg
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import common as tpu_common

from tpufem_torch import convert
from tpufem_torch.fem.dia_op import DiaOperator, build_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.perm_apply import (pack_perm, perm_apply,
                                         perm_apply_bound, perm_apply_plain)
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import (StructuredOperator,
                                            dof_slice_plan, grid_layout,
                                            to_interleaved, to_planar)
from tpufem_torch.la import gmg
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def _bc(dims, order):
    mesh = BoxTetMesh(*dims)
    return DirichletBC.from_space(
        FunctionSpace(mesh, order, bs=3),
        mesh.locate_boundary_facets(common.elasticity_bc_marker)).flat_dofs()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the blocked operator's device apply (the kernel's plain version) ------
@pytest.mark.parametrize("with_bc", [True, False], ids=["bc", "no-bc"])
@pytest.mark.parametrize("order,dims", [
    (2, (2, 3, 2)), (3, (2, 3, 2)), (2, (4, 4, 6)), (3, (4, 4, 6))],
    ids=["P2-2x3x2", "P3-2x3x2", "P2-4x4x6", "P3-4x4x6"])
def test_planar_apply_matches_tpufem(order, dims, with_bc):
    """perm_apply's plain version on a planar x against tpufem's
    interleaved ``StructuredOperator.apply`` (XLA, float64), permuted; on
    2x3x2 cubes every entry of every output lies near the boundary."""
    bc = _bc(dims, order) if with_bc else None
    op = StructuredOperator.build(BoxTetMesh(*dims), order, "elasticity",
                                  bc_dofs=bc, dtype=F64, device=CPU,
                                  planar=True)
    ref = TpuStructured.build(TpuMesh(*dims), order, "elasticity",
                              bc_dofs=bc, dtype=jnp.float64)
    x = np.random.default_rng(order).standard_normal(3 * op.layout.ndofs)
    want = np.asarray(ref.apply(jnp.asarray(x)))
    y = op.apply(torch.from_numpy(to_planar(x, 3)))
    assert _rel(to_interleaved(y.numpy(), 3), want) <= 1e-13
    assert op.pack.mask.any() == with_bc
    if with_bc:
        assert np.array_equal(to_interleaved(y.numpy(), 3)[bc], x[bc])


def _kernel_walk(x: np.ndarray, pack) -> np.ndarray:
    """csrc/perm_apply.cu's two kernels on the pack's tables, in numpy.
    The first, per brick of 8 x 2 x 2 cubes: the masked tile [C, 3, 3, 9,
    3] (zero outside each channel's grid), and Y[p, :, c] = W[p]^T u(p, c)
    with u gathered through the tile offsets of ``sources``; the second,
    per output point: the Y of its entries where the cube lies in the
    lattice, in plan order, and the mask on outputs.  Every output value
    is written once."""
    W = pack.weights.numpy()
    mask = pack.mask.numpy()
    ns, n = pack.ns, pack.n
    Nx, Ny, Nz = pack.dims
    bx, by, bz = pack.bricks
    NxP, NyP = 8 * bx, 2 * by
    Y = np.full((6, 3 * n, pack.y_cubes), np.nan)
    tz, ty, tx = np.meshgrid(np.arange(3), np.arange(3), np.arange(9),
                             indexing="ij")
    cz, cy, cx = [a.reshape(-1) for a in np.meshgrid(
        np.arange(2), np.arange(2), np.arange(8), indexing="ij")]
    for brick in range(bx * by * bz):
        x0, y0, z0 = (8 * (brick % bx), 2 * ((brick // bx) % by),
                      2 * (brick // (bx * by)))
        tile = np.zeros((len(pack.chans), 3, 3, 9, 3))  # [ch, z, y, x, b]
        gz, gy, gx = z0 + tz, y0 + ty, x0 + tx
        for ch, (base, X, Yd, Z, slots) in enumerate(pack.chans):
            ok = (gx < X) & (gy < Yd) & (gz < Z)
            for b in range(3):
                j = np.where(ok, b * ns + base + ((gz * Yd + gy) * X + gx)
                             * slots, 0)
                # a brick not flagged reads no mask: none may lie there
                assert pack.bc_bricks[brick] or not (ok & mask[j]).any()
                tile[ch, ..., b] = np.where(ok & ~mask[j], x[j], 0.0)
        flat = tile.reshape(-1)
        tpos = 3 * ((cz * 3 + cy) * 9 + cx)  # the brick's 32 cubes
        col = ((z0 + cz) * NyP + y0 + cy) * NxP + x0 + cx
        for p in range(6):
            U = np.stack([flat[tpos + pack.sources[p * n + li] + b]
                          for li in range(n) for b in range(3)])
            Y[p][:, col] = W[p].T @ U
    y = np.full_like(x, np.nan)
    writes = np.zeros(x.size, dtype=int)
    for ko, so, first, count in pack.outputs:
        obase, Xo, Yo, Zo, oslots = pack.kinds[ko]
        q = np.arange(Xo * Yo * Zo)
        qx, qy, qz = q % Xo, (q // Xo) % Yo, q // (Xo * Yo)
        acc = np.zeros((3, q.size))
        for code in pack.entries[first: first + count]:
            c = (qx - (code & 1), qy - ((code >> 1) & 1),
                 qz - ((code >> 2) & 1))
            ok = ((c[0] >= 0) & (c[0] < Nx) & (c[1] >= 0) & (c[1] < Ny)
                  & (c[2] >= 0) & (c[2] < Nz))
            at = np.where(ok, (c[2] * NyP + c[1]) * NxP + c[0], 0)
            p, lo = code >> 8, (code >> 3) & 31
            acc += np.where(ok, Y[p, 3 * lo: 3 * lo + 3][:, at], 0.0)
        for a in range(3):
            ja = a * ns + obase + q * oslots + so
            y[ja] = np.where(mask[ja], x[ja], acc[a])
            writes[ja] += 1
    assert np.all(writes == 1)
    return y


@pytest.mark.parametrize("order,dims,with_bc", [
    (2, (2, 3, 2), True), (3, (3, 2, 4), True), (2, (2, 3, 2), False),
    (3, (3, 2, 4), False), (2, (5, 1, 6), True), (3, (5, 1, 6), True),
    (2, (6, 5, 1), False), (3, (1, 6, 3), False), (3, (6, 5, 1), True)],
    ids=["P2", "P3", "P2-no-bc", "P3-no-bc", "P2-5x1x6", "P3-5x1x6",
         "P2-6x5x1-no-bc", "P3-1x6x3-no-bc", "P3-6x5x1"])
def test_kernel_tables_give_the_plain_apply(order, dims, with_bc):
    """The kernel's tables, walked brick by brick as the kernel walks them,
    cover every output once and give the plain version's apply within
    perm_apply_bound (float64); lattices one cube thick and not a multiple
    of the 4-position brick leave ragged bricks."""
    op = StructuredOperator.build(BoxTetMesh(*dims), order, "elasticity",
                                  bc_dofs=_bc(dims, order) if with_bc
                                  else None, dtype=F64, device=CPU,
                                  planar=True)
    pack = op.pack
    assert len(pack.entries) == 6 * pack.n and pack.max_entries == 24
    assert sorted((int(k), int(s)) for k, s in pack.outputs[:, :2]) == [
        (k, s) for k, (_, _, slots) in enumerate(op.layout.kinds)
        for s in range(slots)]
    assert list(pack.outputs[:, 3]) == sorted(pack.outputs[:, 3],
                                              reverse=True)
    # the 24-entry vertex output first; entries in plan order by output
    assert int(pack.outputs[0, 3]) == 24 and int(pack.outputs[1, 3]) == 6
    for ko, so, first, count in pack.outputs:
        for code in pack.entries[first: first + count]:
            p, lo = code >> 8, (code >> 3) & 31
            kind, off, slot = pack.plan[p][lo]
            assert (kind, slot) == (ko, so)
            assert code & 7 == off[0] | off[1] << 1 | off[2] << 2
    assert len(pack.chans) == {2: 8, 3: 27}[order]
    x = np.random.default_rng(5).standard_normal(3 * pack.ns)
    xt = torch.from_numpy(x)
    want = perm_apply_plain(xt, pack).numpy()
    got = _kernel_walk(x, pack)
    assert np.all(np.abs(got - want) <= perm_apply_bound(xt, pack).numpy())
    if dims in ((2, 3, 2), (3, 2, 4)) and with_bc:
        assert _rel(got, want) <= 1e-14


@pytest.mark.parametrize("order,dims,blocks", [
    (2, (24, 24, 32), (3, 12, 16)), (3, (16, 16, 24), (2, 8, 12))])
def test_kernel_bricks_and_shared_memory_at_500k(order, dims, blocks):
    """The 500k fine operators: bricks of 8 x 2 x 2 cubes, more blocks
    than the card's 132 SMs, and a block's shared memory (the source
    table, the tile and the matrices of its perms) within the
    227 KB, P3 float64 the most (139,376 bytes)."""
    n = {2: 10, 3: 20}[order]
    lay = grid_layout(BoxTetMesh(*dims), order)
    pack = pack_perm(np.zeros((6, 3 * n, 3 * n)), dof_slice_plan(order),
                     lay.kinds, dims, np.zeros(3 * lay.ndofs, dtype=bool),
                     F64)
    assert pack.bricks == blocks and np.prod(blocks) > 132
    assert pack.y_cubes == np.prod(blocks) * 32 >= np.prod(dims)
    assert pack.smem_bytes(8) <= 232448
    if order == 3:
        # 480 + 52,488 bytes, to 16, and the matrices of 3 perms
        assert pack.smem_bytes(8) == 52976 + 3 * 60 * 60 * 8 == 139376
        assert pack.smem_bytes(4) == 26736 + 3 * 60 * 60 * 4


def test_perm_apply_wrapper_refusals():
    op = StructuredOperator.build(BoxTetMesh(2, 2, 2), 2, "elasticity",
                                  dtype=F64, device=CPU, planar=True)
    x = torch.zeros(3 * op.pack.ns, dtype=F64)
    with pytest.raises(TypeError, match="match"):
        perm_apply(x.float(), op.pack)
    with pytest.raises(ValueError, match="planar vector"):
        perm_apply(x[1:], op.pack)
    with pytest.raises(NotImplementedError, match="planar"):
        StructuredOperator.build(BoxTetMesh(2, 2, 2), 2, "elasticity",
                                 dtype=F64, device=CPU)
    with pytest.raises(NotImplementedError, match="StructuredOperator"):
        DiaOperator.build(BoxTetMesh(2, 2, 2), 2, "elasticity", dtype=F64,
                          device=CPU, planar=True)


def test_device_diagonal_is_the_planar_host_diagonal():
    dims = (3, 2, 4)
    op = StructuredOperator.build(BoxTetMesh(*dims), 3, "elasticity",
                                  bc_dofs=_bc(dims, 3), dtype=F64,
                                  device=CPU, planar=True)
    host = StructuredOperator.build(BoxTetMesh(*dims), 3, "elasticity",
                                    bc_dofs=_bc(dims, 3), dtype=F64)
    assert np.array_equal(op.diagonal().numpy(), op.diagonal_np())
    assert np.array_equal(op.diagonal_np(), to_planar(host.diagonal_np(), 3))
    x = np.random.default_rng(1).standard_normal(3 * op.layout.ndofs)
    assert np.array_equal(op.apply_np(to_planar(x, 3)),
                          to_planar(host.apply_np(x), 3))


def test_convert_carries_tpufem_blocked_operator():
    dims = (3, 4, 2)
    bc = _bc(dims, 2)
    ref = TpuStructured.build(TpuMesh(*dims), 2, "elasticity", bc_dofs=bc,
                              dtype=jnp.float32, device=False)
    got = convert.structured_from_numpy(ref.Ap, ref.bc_mask, dims, 2, CPU,
                                        planar=True)
    own = StructuredOperator.build(BoxTetMesh(*dims), 2, "elasticity",
                                   bc_dofs=bc, dtype=torch.float32,
                                   device=CPU, planar=True)
    assert got.planar and got.bs == 3
    for name in ("Ap", "weights", "mask", "dev_entries", "dev_outputs",
                 "dev_sources"):
        assert torch.equal(getattr(got.pack, name), getattr(own.pack, name))


# -- the p-transfers with a leading component axis -------------------------
@pytest.mark.parametrize("order", [2, 3])
def test_batched_p_transfers_are_per_component(order):
    """[3, Z+1, Y+1, X+1] -> [3, ns] and back: the scalar transfers per
    component, bit for bit, and an exact adjoint pair."""
    lay = StructuredOperator.build(BoxTetMesh(3, 4, 2), order, "poisson",
                                   dtype=F64).layout
    rng = np.random.default_rng(order)
    v = torch.from_numpy(rng.standard_normal((3, 3, 5, 4)))
    r = torch.from_numpy(rng.standard_normal((3, lay.ndofs)))
    pv = gmg.prolong_p(v, lay)
    rr = gmg.restrict_p(r, lay)
    assert pv.shape == (3, lay.ndofs) and rr.shape == v.shape
    assert torch.equal(pv, torch.stack([gmg.prolong_p(c, lay) for c in v]))
    assert torch.equal(rr, torch.stack([gmg.restrict_p(c, lay) for c in r]))
    lhs, rhs = float((pv * r).sum()), float((v * rr).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("order", [2, 3])
def test_p_transfers_match_tpufem_interleaved(order):
    """The planar batched transfers are tpufem's interleaved ones (a
    trailing component axis), permuted."""
    dims = (3, 2, 4)
    ref_op = TpuStructured.build(TpuMesh(*dims), order, "elasticity",
                                 dtype=jnp.float64, device=False)
    lay = StructuredOperator.build(BoxTetMesh(*dims), order, "poisson",
                                   dtype=F64).layout
    rng = np.random.default_rng(7 + order)
    v = rng.standard_normal((5, 3, 4, 3))  # [Z+1, Y+1, X+1, c]
    r = rng.standard_normal(3 * lay.ndofs)  # interleaved
    want_p = np.asarray(tpu_gmg.prolong_p(jnp.asarray(v), ref_op)).reshape(-1)
    want_r = np.asarray(tpu_gmg.restrict_p(jnp.asarray(r), ref_op, 3))
    got_p = gmg.prolong_p(torch.from_numpy(np.moveaxis(v, -1, 0).copy()),
                          lay)
    got_r = gmg.restrict_p(torch.from_numpy(to_planar(r, 3)).reshape(3, -1),
                           lay)
    assert np.array_equal(to_interleaved(got_p.reshape(-1).numpy(), 3),
                          want_p)
    assert np.array_equal(np.moveaxis(got_r.numpy(), 0, -1), want_r)


# -- the order-k elasticity hierarchy ----------------------------------------
@pytest.mark.parametrize("order,dims", [
    (2, (6, 6, 10)), (3, (4, 4, 6)), (2, (24, 24, 32)), (3, (16, 16, 24))],
    ids=["P2-10k", "P3-10k", "P2-500k", "P3-500k"])
def test_surrogate_lmax_matches_tpufem(order, dims):
    """The interleaved host bs = 3 operator on the surrogate lattice:
    tpufem's seeded power iteration, to the last bit (float32 matrices)."""
    want = tpu_gmg.surrogate_lmax(TpuMesh(*dims), order, "elasticity",
                                  tpu_common.elasticity_bc_marker,
                                  jnp.float32)
    got = gmg.surrogate_lmax(BoxTetMesh(*dims), order, "elasticity",
                             common.elasticity_bc_marker, torch.float32)
    assert got == want


# (order, lattice, coarse limit): one smoothed P1 level below the order-k
# one, and a dense coarse inverse
HIER = [(2, (4, 4, 8), 200), (3, (4, 4, 8), 200)]


@pytest.fixture(scope="module", params=HIER, ids=["P2", "P3"])
def gmg_pair(request):
    order, dims, limit = request.param
    ref = tpu_gmg.GMG.setup(TpuMesh(*dims), order, "elasticity",
                            tpu_common.elasticity_bc_marker,
                            dtype=jnp.float64, coarse_limit=limit)
    port = gmg.GMG.setup(BoxTetMesh(*dims), order, "elasticity",
                         common.elasticity_bc_marker, CPU, dtype=F64,
                         coarse_limit=limit, planar=True)
    return order, dims, ref, port


def test_order_k_gmg_setup_matches_tpufem(gmg_pair):
    """The level walk, per-order lmax, Jacobi diagonals, masks and coarse
    inverse of tpufem's interleaved hierarchy, permuted to planar."""
    order, dims, ref, port = gmg_pair
    assert port.dims == ref.dims and len(port.levels) == len(ref.levels) == 2
    assert port.order == order and port.planar and port.bs == 3
    assert isinstance(port.levels[0].op, StructuredOperator)
    for lv, lv_ref in zip(port.levels, ref.levels):
        assert lv.lmax == lv_ref.lmax
        assert np.array_equal(lv.dinv.numpy(),
                              to_planar(np.asarray(lv_ref.dinv), 3))
        assert np.array_equal(lv.op.bc_mask.numpy(),
                              to_planar(np.asarray(lv_ref.op.bc_mask), 3))
    n = port.coarse_inv.shape[0]
    perm = np.arange(n).reshape(-1, 3).T.reshape(-1)
    ci = np.asarray(ref.coarse_inv)[np.ix_(perm, perm)]
    assert np.abs(port.coarse_inv.numpy() - ci).max() <= 1e-12 * np.abs(
        ci).max()


def test_order_k_vcycle_matches_tpufem(gmg_pair):
    """The port's planar V-cycle against tpufem's interleaved one, from
    its own setup and from tpufem's arrays carried over by convert."""
    order, dims, ref, port = gmg_pair
    n = 3 * ref.levels[0].op.layout.ndofs
    r = np.random.default_rng(order).standard_normal(n)
    want = to_planar(np.asarray(jax.jit(ref.vcycle)(jnp.asarray(r))), 3)
    rp = torch.from_numpy(to_planar(r, 3))
    assert _rel(port.vcycle(rp).numpy(), want) <= 1e-12
    lv0, lv1 = ref.levels
    ops = [convert.structured_from_numpy(
        lv0.op.Ap, np.asarray(lv0.op.bc_mask), dims, order, CPU,
        planar=True),
        convert.dia_from_numpy(
            lv1.op.plan, lv1.op.weights,
            to_planar(np.asarray(lv1.op.bc_mask), 3), ref.dims[1], CPU,
            zone_plan=lv1.op.zone_plan,
            zones=None if lv1.op.zones is None else [
                [np.asarray(f) for f in z] for z in lv1.op.zones],
            surr_dims=lv1.op.surr_dims, bs=3, planar=True)]
    nc = ref.coarse_inv.shape[0]
    perm = np.arange(nc).reshape(-1, 3).T.reshape(-1)
    carried = convert.gmg_from_numpy(
        ops, [to_planar(np.asarray(lv.dinv), 3) for lv in ref.levels],
        [lv.lmax for lv in ref.levels],
        np.asarray(ref.coarse_inv)[np.ix_(perm, perm)],
        np.asarray(ref.coarse_bc_mask)[perm], ref.dims, CPU, bs=3,
        planar=True, order=order)
    assert _rel(carried.vcycle(rp).numpy(), want) <= 1e-12


def test_fidelity_twin_is_tpufem_interleaved_operator():
    """The certification twin at order k: tpufem's host bs = 3 operator,
    interleaved, bit for bit."""
    dims = (3, 2, 4)
    bc = _bc(dims, 2)
    mine = build_operator(BoxTetMesh(*dims), 2, "elasticity", bc_dofs=bc,
                          dtype=F64)
    ref = tpu_build_operator(TpuMesh(*dims), 2, "elasticity", bc_dofs=bc,
                             dtype=jnp.float64, device=False)
    assert isinstance(mine, StructuredOperator) and not mine.planar
    assert np.array_equal(mine.Ap, ref.Ap)
    x = np.random.default_rng(4).standard_normal(3 * mine.layout.ndofs)
    assert np.array_equal(mine.apply_np(x), ref.apply_np(x))
    assert np.array_equal(mine.diagonal_np(), ref.diagonal_np())
