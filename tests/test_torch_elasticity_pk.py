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
from tpufem_torch.fem.perm_apply import perm_apply, perm_apply_plain
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import (StructuredOperator, to_planar,
                                            to_interleaved)
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
    """csrc/perm_apply.cu's loops on the pack's tables, in numpy over all
    the points of an output at once: lane g of G sums the entries g, g +
    G, ... (the cube test, the source descriptors, the weights W[e, li,
    b, a], the mask on sources), the lanes' totals summed by the shuffle
    tree, the mask on outputs."""
    W = pack.weights.numpy()
    mask = pack.mask.numpy()
    ns, n = pack.ns, pack.n
    Nx, Ny, Nz = pack.dims
    y = np.full_like(x, np.nan)
    for ko, so, first, count, lanes in pack.outputs:
        base, Xo, Yo, Zo, slots = pack.kinds[ko]
        q = np.arange(Xo * Yo * Zo)
        qx, qy, qz = q % Xo, (q // Xo) % Yo, q // (Xo * Yo)
        acc = np.zeros((lanes, 3, q.size))
        for e in range(first, first + count):
            code = int(pack.entries[e])
            cx, cy, cz = qx - (code & 1), qy - ((code >> 1) & 1), \
                qz - ((code >> 2) & 1)
            ok = ((cx >= 0) & (cx < Nx) & (cy >= 0) & (cy < Ny)
                  & (cz >= 0) & (cz < Nz))
            t = np.zeros((3, q.size))
            for li in range(n):
                s0, s1, s2, s3 = pack.sources[(code >> 3) * n + li]
                j = np.where(ok, s0 + cz * s1 + cy * s2 + cx * s3, 0)
                for b in range(3):
                    v = np.where(mask[j + b * ns], 0.0, x[j + b * ns])
                    t += W[e, li, b][:, None] * v[None]
            acc[(e - first) % lanes] += np.where(ok, t, 0.0)
        off = lanes // 2
        while off:
            acc[:off] += acc[off: 2 * off]
            off //= 2
        for a in range(3):
            at = a * ns + base + q * slots + so
            y[at] = np.where(mask[at], x[at], acc[0, a])
    return y


@pytest.mark.parametrize("order,dims", [(2, (2, 3, 2)), (3, (3, 2, 4))],
                         ids=["P2", "P3"])
def test_kernel_tables_give_the_plain_apply(order, dims):
    """The kernel's tables, walked as the kernel walks them, cover every
    output once and give the plain version's apply (float64)."""
    op = StructuredOperator.build(BoxTetMesh(*dims), order, "elasticity",
                                  bc_dofs=_bc(dims, order), dtype=F64,
                                  device=CPU, planar=True)
    pack = op.pack
    assert len(pack.entries) == 6 * pack.n and pack.max_entries == 24
    assert sorted((int(k), int(s)) for k, s in pack.outputs[:, :2]) == [
        (k, s) for k, (_, _, slots) in enumerate(op.layout.kinds)
        for s in range(slots)]
    assert list(pack.outputs[:, 3]) == sorted(pack.outputs[:, 3],
                                              reverse=True)
    # 4 lanes share a point of the 24-entry vertex output, 1 elsewhere
    assert [(int(c), int(g)) for c, g in pack.outputs[:2, 3:]] == [
        (24, 4), (6, 1)]
    x = np.random.default_rng(5).standard_normal(3 * pack.ns)
    want = perm_apply_plain(torch.from_numpy(x), pack).numpy()
    assert _rel(_kernel_walk(x, pack), want) <= 1e-14


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
