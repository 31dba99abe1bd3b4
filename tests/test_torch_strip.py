"""The port's P2/P3 operators (tpufem_torch.fem.dia_op, .structured_op,
.strip_op) against tpufem's, in float64 on the CPU.

On the CPU the strip wrappers run the kernels' plain PyTorch versions;
the CUDA kernels themselves are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Host tables must be equal
(the same numpy arithmetic); applies agree to rtol/atol 1e-13 (f64 sums
of ~50 O(1) terms in different orders) with tpufem's XLA twin
``_apply_xla`` for P1-P3 and with its Pallas kernel in interpret mode
for P1 and P2 (at P3, interpret mode takes ~50 s on the CPU, and
tests/test_strip_op.py already pins the P3 kernel to the XLA twin);
the whole-CG kernel's plain version must match tpufem's ``cg_pallas``
(interpret mode) to +-1 iteration and x to rtol 1e-4, as
tests/test_strip_op.py holds cg_pallas to tpufem's own split loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dia_op import DiaOperator as TpuDia
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.fem.strip_op import StripOperator as TpuStrip
from tpufem.fem.structured_op import StructuredOperator as TpuStructured
from tpufem.la.cg import cg_solve_fused as tpu_cg_fused
from tpufem.mesh.structured import BoxTetMesh as TpuMesh
from tpufem.problems import common as tpu_common

from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.strip_op import StripOperator
from tpufem_torch.fem.structured_op import StructuredOperator
from tpufem_torch.la.cg import cg_solve_fused
from tpufem_torch.mesh.structured import BoxTetMesh

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
F64 = torch.float64


def _ops(order, dims):
    """(tpufem const DIA, port const DIA, bc dofs, ndofs), both float64."""
    mesh = TpuMesh(*dims)
    space = TpuSpace(mesh, order)
    bc = TpuBC.from_space(
        space, mesh.locate_boundary_facets(tpu_common.poisson_bc_marker))
    tdia = TpuDia.try_const(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                            dtype=jnp.float64, device=False)
    pdia = DiaOperator.try_const(BoxTetMesh(*dims), order, "poisson",
                                 bc_dofs=bc.flat_dofs(), dtype=F64)
    assert tdia is not None and pdia is not None
    return tdia, pdia, bc.flat_dofs(), space.ndofs


# (8, 8, 6): the z-extent-6 edge grids are too short for z-zones, so
# tpufem has no kernel plan there ("full" mode); the port still has one
CASES = [(2, (8, 9, 10)), (3, (8, 8, 9)), (1, (9, 8, 10)), (2, (8, 8, 6))]
IDS = ["P2", "P3", "P1", "P2-full"]


@pytest.mark.parametrize("order,dims", CASES, ids=IDS)
def test_dia_tables_equal_tpufem(order, dims):
    tdia, pdia, _, _ = _ops(order, dims)
    assert pdia.plan == tdia.plan and pdia.zone_plan == tdia.zone_plan
    assert all(np.array_equal(a, b) for a, b in zip(pdia.weights, tdia.weights))
    assert all(len(za) == len(zb) and all(np.array_equal(a, b)
                                          for a, b in zip(za, zb))
               for za, zb in zip(pdia.zones, tdia.zones))
    A, B = pdia.to_scipy(), tdia.to_scipy()
    A.sort_indices()
    B.sort_indices()
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


@pytest.mark.parametrize("order,dims", CASES, ids=IDS)
def test_strip_layout_and_plain_apply_match_tpufem(order, dims):
    tdia, pdia, _, ndofs = _ops(order, dims)
    tpu = TpuStrip.from_dia(tdia, dtype=jnp.float64, use_pallas=False)
    op = StripOperator.from_dia(pdia, dtype=F64)
    assert op.dims == tpu.dims and op.channels == tpu.channels
    if tpu.kplan is not None:
        assert op.kplan == tpu.kplan
        assert np.array_equal(op.mid_pack.numpy(), np.asarray(tpu.mid_pack))
        assert np.array_equal(op.dlt_pack.numpy(), np.asarray(tpu.dlt_pack))
    else:  # full mode: the port's plan is its own, the matrix the same
        assert any(len(kd) for _, kd in op.kplan)
    u = np.random.default_rng(3).standard_normal(ndofs)
    xf = op.to_strips(torch.from_numpy(u))
    xf_t = np.asarray(jax.jit(tpu.to_strips)(jnp.asarray(u)))
    assert np.array_equal(xf.numpy(), xf_t)
    assert np.array_equal(op.from_strips(xf).numpy(),
                          np.asarray(jax.jit(tpu.from_strips)(xf_t)))
    assert np.array_equal(op.from_strips(xf).numpy(), u)
    y = op.apply_strips(xf).numpy()
    np.testing.assert_allclose(y, np.asarray(tpu._apply_xla(jnp.asarray(xf_t))),
                               rtol=1e-13, atol=1e-13)
    if tpu.kplan is not None and order < 3:
        pal = TpuStrip.from_dia(tdia, dtype=jnp.float64, use_pallas=True)
        np.testing.assert_allclose(
            y, np.asarray(pal._apply_pallas(jnp.asarray(xf_t))),
            rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op.apply(torch.from_numpy(u)).numpy(),
                               tdia.apply_np(u), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("order,dims", [(2, (8, 9, 8)), (2, (8, 8, 6))],
                         ids=["P2", "P2-full"])
def test_strip_padding_stays_zero(order, dims):
    """Pad, guard and out-of-extent planes of the output are exactly
    zero, so buffer dots equal dof dots through a channel-resident CG."""
    _, pdia, _, ndofs = _ops(order, dims)
    op = StripOperator.from_dia(pdia, dtype=F64)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal(ndofs))
    xf = op.to_strips(u)
    mask = op.to_strips(torch.ones(ndofs, dtype=F64)) != 0.0
    yf = op.apply_strips(xf)
    assert bool((yf[~mask] == 0.0).all())
    y = op.from_strips(yf)
    assert np.isclose(float((yf * xf).sum()), float(y @ u), rtol=1e-12)


def _rhs(ndofs, bc_dofs, seed):
    b = np.random.default_rng(seed).standard_normal(ndofs)
    b[bc_dofs] = 0.0
    return b


@pytest.mark.parametrize("order,dims,maxit", [(1, (9, 8, 10), 120),
                                              (2, (6, 6, 7), 300)],
                         ids=["P1", "P2"])
def test_cg_resident_plain_matches_cg_pallas(order, dims, maxit):
    """The whole-CG kernel's plain version against tpufem's cg_pallas in
    interpret mode, on the cases of tests/test_strip_op.py."""
    tdia, pdia, bc_dofs, ndofs = _ops(order, dims)
    tpu = TpuStrip.from_dia(tdia, dtype=jnp.float64, use_pallas=True)
    op = StripOperator.from_dia(pdia, dtype=F64)
    assert op.cg_kernel_ok
    b = _rhs(ndofs, bc_dofs, 5)
    x_t, it_t, rel_t = jax.jit(lambda r: tpu.cg_pallas(r, rtol=1e-8,
                                                       maxit=maxit))(
        tpu.to_strips(jnp.asarray(b)))
    x_f, it, rel = op.cg_resident(op.to_strips(torch.from_numpy(b)), 1e-8,
                                  maxit)
    assert it.dtype == torch.int32 and rel.dtype == F64
    assert abs(int(it) - int(it_t)) <= 1
    assert float(rel) < 1e-8 and float(rel_t) < 1e-8
    x = op.from_strips(x_f).numpy()
    r = b - pdia.apply_np(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7
    np.testing.assert_allclose(x, np.asarray(tpu.from_strips(x_t)),
                               rtol=1e-4, atol=1e-6)


def test_cg_resident_plain_maxit_cap():
    """With an unreachable tolerance the loop runs exactly maxit steps
    and reports the recurrence residual there, as cg_pallas does."""
    tdia, pdia, bc_dofs, ndofs = _ops(1, (8, 8, 8))
    tpu = TpuStrip.from_dia(tdia, dtype=jnp.float64, use_pallas=True)
    op = StripOperator.from_dia(pdia, dtype=F64)
    b = _rhs(ndofs, bc_dofs, 6)
    _, it, rel = op.cg_resident(op.to_strips(torch.from_numpy(b)), 1e-30, 7)
    _, it_t, rel_t = tpu.cg_pallas(tpu.to_strips(jnp.asarray(b)),
                                   rtol=1e-30, maxit=7)
    assert int(it) == int(it_t) == 7
    # cg_pallas reports rel in float32
    assert float(rel) == pytest.approx(float(rel_t), rel=1e-6)


@pytest.mark.parametrize("order,dims", [(2, (8, 9, 10)), (3, (8, 8, 9)),
                                        (1, (9, 8, 10)), (2, (8, 8, 6))],
                         ids=IDS)
def test_cg_bricks_cover_the_body_once(order, dims):
    """The whole-CG kernel's brick table: every body element (all
    channels, planes 1..Zc, lanes G..G + TILE) lies in exactly one brick,
    every dof lies in the body, and the halo covers every lane offset of
    the plan without leaving the buffer."""
    _, pdia, _, ndofs = _ops(order, dims)
    op = StripOperator.from_dia(pdia, dtype=F64)
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    lanes, planes = 32, 2  # the kernel's brick: 2 planes of 32 lanes
    bricks = op.cg_bricks()
    assert bricks.dtype == np.int32 and bricks.shape[1] == 3
    count = np.zeros((C, Zp, LW), dtype=np.int64)
    for z0, nz, l0 in bricks:
        assert 1 <= nz <= planes and l0 % lanes == 0
        count[:, 1 + z0:1 + z0 + nz, l0:l0 + lanes] += 1
    body = np.zeros((C, Zp, LW), dtype=bool)
    body[:, 1:1 + Zc, 128:128 + TILE] = True
    assert np.array_equal(count, body.astype(np.int64))
    dofs = op.to_strips(torch.ones(ndofs, dtype=F64)).numpy() != 0
    assert not (dofs & ~body).any()
    halo = op.cg_halo
    offs = [abs(e[-1]) for km, kd in op.kplan for e in km + kd]
    assert halo % 4 == 0 and max(offs) <= halo <= 128
    assert bricks[:, 2].min() - halo >= 0
    assert bricks[:, 2].max() + lanes + halo <= LW
    # the delta entries a brick stages: its planes' rows of every channel
    per_brick = [sum(1 for _, kd in op.kplan for e in kd
                     if z0 <= e[1] < z0 + nz) for z0, nz, _ in bricks]
    assert op.cg_delta_cap(bricks) == max(per_brick)
    assert sum(per_brick) * lanes == TILE * sum(len(kd) for _, kd in op.kplan)


def test_fused_cg_on_strips_matches_tpufem():
    """The port's cg_solve_fused on the strip operator follows tpufem's
    (the split form of the cgpoisson P2/P3 loop)."""
    tdia, pdia, bc_dofs, ndofs = _ops(2, (8, 8, 8))
    tpu = TpuStrip.from_dia(tdia, dtype=jnp.float64, use_pallas=False)
    op = StripOperator.from_dia(pdia, dtype=F64)
    b = _rhs(ndofs, bc_dofs, 1)
    x_t, it_t, _ = jax.jit(lambda r: tpu_cg_fused(
        tpu.apply_strips, r, x0=None, rtol=1e-8, maxit=400))(
        tpu.to_strips(jnp.asarray(b)))
    x_f, it, rel = cg_solve_fused(op.apply_strips,
                                  op.to_strips(torch.from_numpy(b)),
                                  rtol=1e-8, maxit=400)
    assert abs(it - int(it_t)) <= 1 and rel < 1e-8
    np.testing.assert_allclose(op.from_strips(x_f).numpy(),
                               np.asarray(tpu.from_strips(x_t)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("order,dims", [(2, (4, 5, 6)), (3, (4, 4, 5))],
                         ids=["P2", "P3"])
def test_structured_operator_matches_tpufem(order, dims):
    mesh = TpuMesh(*dims)
    space = TpuSpace(mesh, order)
    bc = TpuBC.from_space(
        space, mesh.locate_boundary_facets(tpu_common.poisson_bc_marker))
    tpu = TpuStructured.build(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                              dtype=jnp.float64, device=True)
    op = StructuredOperator.build(BoxTetMesh(*dims), order, "poisson",
                                  bc_dofs=bc.flat_dofs(), dtype=F64,
                                  device=torch.device("cpu"))
    assert np.array_equal(op.Ap, tpu.Ap)
    u = np.random.default_rng(2).standard_normal(space.ndofs)
    y_raw = np.asarray(tpu.apply_raw(jnp.asarray(u)))
    np.testing.assert_allclose(op.apply_raw(torch.from_numpy(u)).numpy(),
                               y_raw, rtol=1e-13, atol=1e-13)
    assert np.array_equal(op.apply_raw_np(u), tpu.apply_raw_np(u))
    # the two BC conventions around apply_raw (structured_op.py:318-328)
    mask = np.zeros(space.ndofs, dtype=bool)
    mask[bc.flat_dofs()] = True
    np.testing.assert_allclose(
        op.apply_bc_rows_zero(torch.from_numpy(u)).numpy(),
        np.where(mask, 0.0, y_raw), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op.apply(torch.from_numpy(u)).numpy(),
                               tpu.apply_np(u), rtol=1e-13, atol=1e-13)


def test_build_operator_picks_tpufem_forms():
    """P2/P3 const DIA when the lattice allows it, else the per-perm
    operator; the multi-kind DIA applies on its device (the zone
    kernel's plain version on the CPU)."""
    from tpufem_torch.fem.dia_op import build_operator
    cpu = torch.device("cpu")
    big = build_operator(BoxTetMesh(6, 6, 8), 3, "poisson", dtype=F64,
                         device=cpu)
    assert isinstance(big, DiaOperator) and big.is_const()
    x = np.random.default_rng(0).standard_normal(big.layout.ndofs)
    np.testing.assert_allclose(big.apply(torch.from_numpy(x)).numpy(),
                               big.apply_np(x), rtol=0,
                               atol=1e-13 * np.abs(big.apply_np(x)).max())
    small = build_operator(BoxTetMesh(4, 4, 6), 3, "poisson", dtype=F64,
                           device=cpu)
    assert isinstance(small, StructuredOperator)


# -- the host tables of the apply kernel (csrc/strip_apply.cu) ---------------
@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("order,dims", CASES, ids=IDS)
def test_apply_runs_and_units_cover_the_body_once(order, dims, itemsize):
    """The apply kernel's blocks (32 lanes x a z run) and their units
    (a channel of ``apply_order`` x 4 planes) cover every body element
    (all channels, planes 1..Zc, lanes G..G + TILE) exactly once, the
    guard columns take the rest, and a block fits the shared memory."""
    from tpufem_torch.fem import strip_op
    _, pdia, _, _ = _ops(order, dims)
    op = StripOperator.from_dia(pdia, dtype=F64)
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    run, staged = op.apply_shape(itemsize)
    runs = op.apply_runs(itemsize)
    assert runs.dtype == np.int32 and runs.shape[1] == 2
    assert 1 <= run <= 8 and int(runs[:, 1].max()) == run
    assert op.apply_smem_bytes(run, itemsize, staged) <= strip_op._MAX_SMEM
    order_ = op.apply_order
    assert sorted(order_.tolist()) == list(range(C))
    counts = [len(op.kplan[c][0]) for c in order_]
    assert counts == sorted(counts, reverse=True)
    count = np.zeros((C, Zp, LW), dtype=np.int64)
    for col in range(LW // 32):
        l0 = 32 * col
        if not 128 <= l0 < 128 + TILE:
            continue  # a guard column: its blocks write zeros
        for z0, nz in runs:
            groups = -(-nz // 4)
            for u in range(C * groups):
                co, p0 = order_[u // groups], 4 * (u % groups)
                n = min(4, nz - p0)
                count[co, 1 + z0 + p0:1 + z0 + p0 + n, l0:l0 + 32] += 1
    body = np.zeros((C, Zp, LW), dtype=bool)
    body[:, 1:1 + Zc, 128:128 + TILE] = True
    assert np.array_equal(count, body.astype(np.int64))
    # the delta entries a run stages: its planes' rows of every channel
    per_run = [sum(1 for _, kd in op.kplan for e in kd if z0 <= e[1] < z0 + nz)
               for z0, nz in runs]
    assert op.apply_delta_cap(run) == max(per_run)
    assert sum(per_run) == sum(len(kd) for _, kd in op.kplan)
    ends = op.delta_plane_ends
    assert ends[0] == 0 and ends[-1] == sum(per_run)


@pytest.mark.parametrize("order,dims", CASES, ids=IDS)
def test_kernel_tables_reproduce_kplan(order, dims):
    """The int32 CSR tables the kernels walk hold kplan's entries, in its
    order: mid by output channel, delta by (channel, row)."""
    _, pdia, _, _ = _ops(order, dims)
    op = StripOperator.from_dia(pdia, dtype=F64)
    C, Zc = op.dims[0], op.dims[1]
    mptr, ment, dptr, dent, zk = (t.numpy() for t in op.tables)
    assert all(t.dtype == np.int32 for t in (mptr, ment, dptr, dent, zk))
    assert zk.tolist() == [op.kdims[kind][0] for kind, _ in op.channels]
    for co, (km, kd) in enumerate(op.kplan):
        assert [tuple(r) for r in ment[mptr[co]:mptr[co + 1]]] == list(km)
        for row in range(Zc):
            got = dent[dptr[co * Zc + row]:dptr[co * Zc + row + 1]]
            want = [(di, ci, dz, off) for di, r, ci, dz, off in kd if r == row]
            assert [tuple(r) for r in got] == want
    assert mptr[-1] == len(ment) and dptr[-1] == len(dent)


def test_apply_shape_follows_the_shared_memory(monkeypatch):
    """A block that does not fit takes a shorter z run, then leaves the
    delta weights in global memory; one that cannot fit at all raises."""
    from tpufem_torch.fem import strip_op
    _, pdia, _, _ = _ops(3, (8, 8, 9))
    op = StripOperator.from_dia(pdia, dtype=F64)
    Zc = op.dims[1]
    full = op.apply_shape(4)
    assert full == (5, True)
    seen = set()
    for limit in (120000, 90000, 70000, 50000, 40000):
        monkeypatch.setattr(strip_op, "_MAX_SMEM", limit)
        run, staged = op.apply_shape(4)
        assert op.apply_smem_bytes(run, 4, staged) <= limit
        runs = op.apply_runs(4)
        assert runs[:, 1].sum() == Zc and (runs[1:, 0] ==
                                            np.cumsum(runs[:-1, 1])).all()
        seen.add((run, staged))
    assert any(not staged for _, staged in seen)
    assert any(run < full[0] for run, _ in seen)
    monkeypatch.setattr(strip_op, "_MAX_SMEM", 10000)
    with pytest.raises(RuntimeError, match="shared memory"):
        op.apply_shape(4)


def test_strip_launch_struct_mirrors_the_kernel():
    """_build.StripLaunch lays out csrc/strip_apply.cu's StripLaunch: 8
    pointers, then 12 ints."""
    import ctypes
    from tpufem_torch import _build
    names = [n for n, _ in _build.StripLaunch._fields_]
    assert names == ["mid", "dlt", "mid_ptr", "mid_ent", "dlt_ptr", "dlt_ent",
                     "zk", "order", "device", "C", "Zc", "Zp", "LW", "TILE",
                     "G", "halo", "nmid", "run", "dcap",
                     "stage_delta_weights"]
    assert _build.StripLaunch.device.offset == 64
    assert _build.StripLaunch.stage_delta_weights.offset == 64 + 11 * 4
    assert ctypes.sizeof(_build.StripLaunch) == 112


def test_apply_action_checks_once_and_takes_the_plain_version():
    _, pdia, _, ndofs = _ops(2, (8, 9, 8))
    op = StripOperator.from_dia(pdia, dtype=F64)
    xf = op.to_strips(torch.from_numpy(
        np.random.default_rng(1).standard_normal(ndofs)))
    action = op.apply_action(xf)
    assert torch.equal(action(xf), op.apply_strips(xf))
    with pytest.raises(ValueError):
        op.apply_action(xf[:, :, :-1])
    with pytest.raises(TypeError):
        op.apply_action(xf.float())
