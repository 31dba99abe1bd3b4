"""The port's P2/P3 pieces against tpufem in float64 on the CPU: the
multi-kind DIA apply (fem.dia_zones, the plain version of the zone
kernel) and its term tables, the p-transfers, the per-order surrogate
lmax and the order-k V-cycle.  tpufem
runs its numpy twins or eager XLA (no jit, no Pallas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dia_op import DiaOperator as TpuDia
from tpufem.fem.structured_op import StructuredOperator as TpuStructured
from tpufem.la import gmg as tpu_gmg
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import common as tpu_common

from tpufem_torch import convert
from tpufem_torch.fem.dia_op import DiaOperator, build_operator
from tpufem_torch.fem.dia_zones import (ZONE_ROWS, dia_zones_apply,
                                        dia_zones_apply_plain)
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import grid_layout
from tpufem_torch.la import gmg
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
# (order, lattice): P2 whose grids all have >= 7 planes, and P3 on Nz = 6,
# where the edge grids along z have 6 planes (one full field) and the
# others 7 (zone form)
CASES = [(2, (6, 7, 8)), (3, (7, 6, 6))]
IDS = ["P2-6x7x8", "P3-7x6x6"]


def _bc_dofs(dims, order):
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order),
                                mesh.locate_boundary_facets(
                                    common.poisson_bc_marker))
    return mesh, bc.flat_dofs()


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def dia_pair(request):
    """The port's const-mode multi-kind DIA on the CPU and tpufem's
    host-only one, BC baked, float64."""
    order, dims = request.param
    mesh, bc = _bc_dofs(dims, order)
    op = build_operator(mesh, order, "poisson", bc_dofs=bc, dtype=F64,
                        device=CPU)
    ref = TpuDia.build(TpuMesh(*dims), order, "poisson", bc_dofs=bc,
                       dtype=jnp.float64, mode="const", device=False)
    assert isinstance(op, DiaOperator) and op.multi_kind and op.is_const()
    return order, dims, op, ref


def test_multi_kind_apply_matches_tpufem(dia_pair):
    """One launch's worth of terms (P2 230, P3 1311) against tpufem's
    float64 host twin."""
    order, dims, op, ref = dia_pair
    x = np.random.default_rng(order).standard_normal(op.layout.ndofs)
    y = op.apply(torch.from_numpy(x)).numpy()
    want = ref.apply_np(x)
    assert np.abs(y - want).max() <= 1e-13 * np.abs(want).max()
    assert len(op.zone_pack.terms) == len(ref.zone_plan)


def test_term_table_reproduces_host_zones(dia_pair):
    """The packed table walks the zone plan in plan order, grouped by
    output, every (kind, slot) once, heaviest first; each entry's
    offset and zone flag give back its host fields."""
    order, dims, op, _ = dia_pair
    pack = op.zone_pack
    lay = op.layout
    assert [tuple(k) for k in pack.kinds] == [
        (b, X, Y, Z, s) for b, (X, Y, Z), s in lay.kinds]
    outs = sorted((int(ko), int(so)) for ko, so, _, _ in pack.outputs)
    assert outs == [(k, s) for k, (_, _, sl) in enumerate(lay.kinds)
                    for s in range(sl)]
    counts = pack.outputs[:, 3]
    assert np.all(counts[:-1] >= counts[1:])
    assert len(pack.outputs) == (8 if order == 2 else 27)
    # the table in output order: the zone plan, grouped
    by_start = sorted(pack.outputs.tolist(), key=lambda o: o[2])
    walked = [t for _, _, s, c in by_start for t in range(s, s + c)]
    assert walked == list(range(len(pack.terms)))
    fields = pack.fields.numpy()
    seen_short = seen_zoned = False
    for ko, so, start, count in pack.outputs:
        idx = [i for i, zp in enumerate(op.zone_plan) if zp[:2] == (ko, so)]
        assert count == len(idx)
        _, (X, Y, Z), _ = lay.kinds[ko]
        for t, i in zip(pack.terms[start: start + count], idx):
            ki, si, d = op.zone_plan[i][2:5]
            z = op.zones[i]
            assert tuple(t[:5]) == (ki, si) + tuple(d)
            assert bool(t[6]) == (len(z) == 3) == (Z >= ZONE_ROWS)
            rows = ZONE_ROWS if t[6] else Z
            np.testing.assert_array_equal(
                fields[t[5]: t[5] + rows * Y * X].reshape(rows, Y, X),
                np.concatenate(z))
            seen_short |= not t[6]
            seen_zoned |= bool(t[6])
    assert seen_zoned and seen_short == (dims[2] < 7)


def test_dense_multi_kind_apply_matches_tpufem():
    """A dense-mode P2 operator (full fields, zero outside each term's
    dst slice) on a lattice too small for the const form."""
    dims = (3, 4, 5)
    mesh, bc = _bc_dofs(dims, 2)
    op = DiaOperator.build(mesh, 2, "poisson", bc_dofs=bc, dtype=F64,
                           mode="dense", device=CPU)
    ref = TpuDia.build(TpuMesh(*dims), 2, "poisson", bc_dofs=bc,
                       dtype=jnp.float64, mode="dense", device=False)
    x = np.random.default_rng(5).standard_normal(op.layout.ndofs)
    want = ref.apply_np(x)
    y = dia_zones_apply(torch.from_numpy(x), op.zone_pack).numpy()
    assert not op.zone_pack.terms[:, 6].any()
    assert np.abs(y - want).max() <= 1e-13 * np.abs(want).max()


def test_rows_zero_convention_on_an_unbaked_operator():
    """cgpoisson's unbaked multi-kind operator: BC rows zeroed after the
    apply (tpufem's apply_bc_rows_zero, here on its host twin)."""
    dims = (6, 6, 7)
    mesh, bc = _bc_dofs(dims, 2)
    op = build_operator(mesh, 2, "poisson", bc_dofs=bc, dtype=F64,
                        device=CPU, bake_bc=False)
    ref = TpuDia.try_const(TpuMesh(*dims), 2, "poisson", bc_dofs=bc,
                           dtype=jnp.float64, bake_bc=False)
    x = np.random.default_rng(6).standard_normal(op.layout.ndofs)
    y = op.apply_bc_rows_zero(torch.from_numpy(x)).numpy()
    want = np.where(np.asarray(ref.bc_mask), 0.0, ref.apply_np(x))
    assert np.all(y[bc] == 0.0)
    assert np.abs(y - want).max() <= 1e-13 * np.abs(want).max()


def test_plain_version_refuses_a_mismatched_vector(dia_pair):
    _, _, op, _ = dia_pair
    with pytest.raises(ValueError, match="dofs"):
        dia_zones_apply(torch.zeros(op.layout.ndofs + 1, dtype=F64),
                        op.zone_pack)
    with pytest.raises(TypeError, match="match"):
        dia_zones_apply(torch.zeros(op.layout.ndofs, dtype=torch.float32),
                        op.zone_pack)
    y = dia_zones_apply_plain(torch.zeros(op.layout.ndofs, dtype=F64),
                              op.zone_pack)
    assert not y.any()


# -- the p-transfers ----------------------------------------------------------
@pytest.mark.parametrize("order", [2, 3])
def test_p_transfers_match_tpufem_and_are_adjoint(order):
    """prolong_p / restrict_p against tpufem's, eager on jnp arrays, and
    <P v, r> = <v, R r>."""
    dims = (3, 4, 5)
    mesh = BoxTetMesh(*dims)
    lay = grid_layout(mesh, order)
    ref_op = TpuStructured.build(TpuMesh(*dims), order, "poisson",
                                 dtype=jnp.float64, device=False)
    rng = np.random.default_rng(order)
    v = rng.standard_normal((dims[2] + 1, dims[1] + 1, dims[0] + 1))
    r = rng.standard_normal(lay.ndofs)
    Pv = gmg.prolong_p(torch.from_numpy(v), lay).numpy()
    Rr = gmg.restrict_p(torch.from_numpy(r), lay).numpy()
    Pv_ref = np.asarray(tpu_gmg.prolong_p(jnp.asarray(v[..., None]),
                                          ref_op)).reshape(-1)
    Rr_ref = np.asarray(tpu_gmg.restrict_p(jnp.asarray(r), ref_op, 1))
    np.testing.assert_allclose(Pv, Pv_ref, rtol=0, atol=1e-14)
    np.testing.assert_allclose(Rr, Rr_ref[..., 0], rtol=0, atol=1e-14)
    assert Pv.shape == (lay.ndofs,)
    assert np.isclose(np.dot(Pv, r), np.sum(v * Rr), rtol=1e-13)


# -- the per-order lmax --------------------------------------------------------
@pytest.mark.parametrize("order,dims,dtype", [
    (2, (32, 40, 48), "float32"), (3, (24, 24, 32), "float32"),
    (2, (12, 12, 12), "float64"), (3, (6, 8, 10), "float64"),
], ids=["P2-500k", "P3-500k", "P2-15k", "order3-golden"])
def test_surrogate_lmax_at_order_k_equals_tpufem(order, dims, dtype):
    assert (gmg.surrogate_lmax(BoxTetMesh(*dims), order, "poisson",
                               common.poisson_bc_marker,
                               getattr(torch, dtype))
            == tpu_gmg.surrogate_lmax(TpuMesh(*dims), order, "poisson",
                                      tpu_common.poisson_bc_marker,
                                      getattr(jnp, dtype)))


# -- the order-k V-cycle -------------------------------------------------------
def test_order_k_vcycle_matches_tpufem():
    """The port's P2 GMG on the 12^3 lattice (the P2 level, the P1 level
    on the same lattice, the 6^3 coarse inverse) against tpufem's: the
    level walk, per-order lmax, dinv and coarse inverse, and one
    V-cycle, run by the port's setup and with tpufem's state carried by
    convert (1e-12)."""
    order, dims = 2, (12, 12, 12)
    ref = tpu_gmg.GMG.setup(TpuMesh(*dims), order, "poisson",
                            tpu_common.poisson_bc_marker, dtype=jnp.float64)
    port = gmg.GMG.setup(BoxTetMesh(*dims), order, "poisson",
                         common.poisson_bc_marker, CPU, dtype=F64)
    assert port.dims == ref.dims == (dims, dims, (6, 6, 6))
    assert port.order == ref.order == order
    assert len(port.levels) == len(ref.levels) == 2
    for lv, lv_ref in zip(port.levels, ref.levels):
        assert lv.lmax == lv_ref.lmax
        assert np.array_equal(lv.dinv.numpy(), np.asarray(lv_ref.dinv))
    assert port.levels[0].lmax != port.levels[1].lmax
    np.testing.assert_allclose(
        port.coarse_inv.numpy(), np.asarray(ref.coarse_inv), rtol=0,
        atol=1e-10 * np.abs(np.asarray(ref.coarse_inv)).max())
    n = port.levels[0].op.layout.ndofs
    r = np.random.default_rng(order).standard_normal(n)
    want = np.asarray(jax.jit(ref.vcycle)(jnp.asarray(r)))
    got = port.vcycle(torch.from_numpy(r)).numpy()
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    # tpufem's state carried over: its level operators and arrays
    ops = [convert.dia_from_numpy(
        o.plan, o.weights, np.asarray(o.bc_mask),
        (o.layout.Nx, o.layout.Ny, o.layout.Nz), CPU, zone_plan=o.zone_plan,
        zones=[[np.asarray(f) for f in z] for z in o.zones],
        surr_dims=o.surr_dims, order=o.layout.order, kinds=o.layout.kinds)
        for o in (lv.op for lv in ref.levels)]
    assert ops[0].multi_kind and not ops[1].multi_kind
    carried = convert.gmg_from_numpy(
        ops, [np.asarray(lv.dinv) for lv in ref.levels],
        [lv.lmax for lv in ref.levels], np.asarray(ref.coarse_inv),
        np.asarray(ref.coarse_bc_mask), ref.dims, CPU, order=order)
    got2 = carried.vcycle(torch.from_numpy(r)).numpy()
    assert np.linalg.norm(got2 - want) <= 1e-12 * np.linalg.norm(want)
