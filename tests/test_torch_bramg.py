"""The port's lattice-brick AMG (tpufem_torch.la.bramg, la.brick_flat)
against tpufem.la.bramg on the CPU, in float64: the host copies bit for
bit, the flat stencil apply and the brick transfers, the probed Galerkin
operator against scipy's P^T A P, the whole setup, and the V-cycle on
tpufem's own hierarchy (carried over by convert.bramg_from_numpy).  Only
scalar hierarchies run through tpufem: its elasticity setup compiles for
half a minute on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.fem.dia_op import build_operator as tpu_build_operator
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.la import bramg as tpu_bramg
from tpufem.mesh import BoxTetMesh as TpuMesh
from tpufem.problems import common as tpu_common

from tpufem_torch import convert
from tpufem_torch.config import SolverOptions
from tpufem_torch.fem.dia_op import build_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.la import bramg
from tpufem_torch.la.brick_flat import (brick_flat_apply,
                                        brick_flat_apply_plain)
from tpufem_torch.la.nullspace import build_near_nullspace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def _poisson(dims, problem="poisson"):
    """The port's float64 P1 operator and BC of a small lattice."""
    mesh = BoxTetMesh(*dims)
    bs = 3 if problem == "elasticity" else 1
    marker = (common.elasticity_bc_marker if bs == 3
              else common.poisson_bc_marker)
    space = FunctionSpace(mesh, 1, bs=bs)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(marker))
    A = build_operator(mesh, 1, problem, bc_dofs=bc.flat_dofs(), dtype=F64,
                       device=CPU, planar=bs == 3)
    return mesh, space, bc, A


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


# -- host copies, bit for bit ------------------------------------------------
def _elasticity_candidates(dims):
    """Rigid-body candidates on the lattice, BC rows zeroed, as setup
    builds them: [gz, gy, gx, 3, 6]."""
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.elasticity_bc_marker))
    B = build_near_nullspace(space.scalar_dof_coords()).T
    B = B * (~np.repeat(bc.mask(), 3))[:, None]
    return B.reshape(dims[2] + 1, dims[1] + 1, dims[0] + 1, 3, 6)


@pytest.mark.parametrize("case", ["scalar", "rank_deficient", "coarse_m6"])
def test_brick_qr_bitwise(case):
    """Constant candidates; rigid-body ones on a 4^3 node lattice, whose
    one-node corner bricks have rank 3 < 6 (dead coarse dofs); random
    m = 6 candidates of a coarse level (c = m)."""
    rng = np.random.default_rng(3)
    B = {"scalar": np.ones((5, 7, 8, 1, 1)),
         "rank_deficient": _elasticity_candidates((3, 3, 3)),
         "coarse_m6": rng.standard_normal((4, 5, 3, 6, 6))}[case]
    got, want = bramg.brick_qr(B), tpu_bramg.brick_qr(B)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[2].any() == (case == "rank_deficient")


@pytest.mark.parametrize("m", [1, 6])
def test_flat_fields_and_plan_bitwise(m):
    """A dense random block stencil keeps every (dz, dy, s): 27 fields at
    m = 1, 9 (4m - 1) = 207 at m = 6 (not the 9 (4m - 3) of tpufem's
    docstring); the host apply of those fields too."""
    rng = np.random.default_rng(m)
    W = rng.standard_normal((3, 3, 3, 3, 4, 2, m, m))
    plan, fields = bramg.stencil_to_flat_fields(W, m)
    plan_ref, fields_ref = tpu_bramg.stencil_to_flat_fields(W, m)
    assert plan == plan_ref and len(plan) == 9 * (4 * m - 1)
    assert all(np.array_equal(a, b) for a, b in zip(fields, fields_ref))
    assert bramg._flat_plan(m) == tpu_bramg._flat_plan(m) == list(plan)
    x = rng.standard_normal(3 * 4 * 2 * m)
    assert np.array_equal(
        bramg.flat_apply_np(plan, fields, (3, 4, 2), m, x),
        tpu_bramg.flat_apply_np(plan_ref, fields_ref, (3, 4, 2), m, x))


@pytest.mark.parametrize("m", [1, 6])
def test_symmetrize_dense_and_lmax_bitwise(m):
    rng = np.random.default_rng(10 + m)
    adims = (3, 4, 2)
    W = rng.standard_normal((3, 3, 3) + adims + (m, m))
    Ws = bramg._symmetrize_stencil(W)
    assert np.array_equal(Ws, tpu_bramg._symmetrize_stencil(W))
    dense = bramg._stencil_to_dense(Ws, adims, m)
    assert np.array_equal(dense, tpu_bramg._stencil_to_dense(Ws, adims, m))
    plan, fields = bramg.stencil_to_flat_fields(Ws, m)
    dinv = 1.0 / (1.0 + rng.random(int(np.prod(adims)) * m))
    assert (bramg._power_lmax_np(plan, fields, adims, m, dinv)
            == tpu_bramg._power_lmax_np(plan, fields, adims, m, dinv))


@pytest.mark.parametrize("opts,mesh,order,want", [
    ({}, (4, 4, 4), 1, True),
    ({}, (4, 4, 4), 2, False),
    ({"amg_brick": "off"}, (4, 4, 4), 1, False),
], ids=["p1", "p2", "off"])
def test_brick_viable_gate(opts, mesh, order, want):
    """The three cases of tpufem's test_brick_viable_gate, both ways."""
    assert bramg.brick_viable(BoxTetMesh(*mesh), order,
                              SolverOptions(**opts)) is want
    assert tpu_bramg.brick_viable(TpuMesh(*mesh), order,
                                  TpuSolverOptions(**opts)) is want


# -- the flat apply and the transfers ----------------------------------------
@pytest.mark.parametrize("m,adims", [(1, (5, 4, 6)), (6, (3, 4, 2))])
def test_flat_apply_plain_matches_tpufem(m, adims):
    """The plain version (and the public wrapper on CPU tensors) against
    tpufem's jnp flat_apply, float64, to 1e-14; no kernel launch."""
    rng = np.random.default_rng(20 + m)
    W = rng.standard_normal((3, 3, 3) + adims + (m, m))
    plan, fields = bramg.stencil_to_flat_fields(W, m)
    x = rng.standard_normal(int(np.prod(adims)) * m)
    want = np.asarray(tpu_bramg.flat_apply(
        plan, tuple(jnp.asarray(f) for f in fields), adims, m,
        jnp.asarray(x)))
    F = torch.from_numpy(np.stack(fields))
    before = brick_flat_apply.launches
    got = brick_flat_apply_plain(torch.from_numpy(x), F, plan, adims, m)
    assert _rel(got.numpy(), want) <= 1e-14
    assert torch.equal(brick_flat_apply(torch.from_numpy(x), F, plan, adims,
                                        m), got)
    assert brick_flat_apply.launches == before


def test_flat_apply_refusals():
    plan, fields = bramg.stencil_to_flat_fields(
        np.ones((3, 3, 3, 2, 2, 2, 1, 1)), 1)
    F = torch.from_numpy(np.stack(fields))
    x = torch.zeros(8, dtype=F64)
    with pytest.raises(TypeError):
        brick_flat_apply(x.float(), F, plan, (2, 2, 2), 1)
    with pytest.raises(TypeError):
        brick_flat_apply(x.to(torch.int64), F.to(torch.int64), plan,
                         (2, 2, 2), 1)
    with pytest.raises(ValueError):
        brick_flat_apply(torch.zeros(16, dtype=F64)[::2], F, plan,
                         (2, 2, 2), 1)
    with pytest.raises(ValueError):
        brick_flat_apply(torch.zeros(9, dtype=F64), F, plan, (2, 2, 2), 1)
    with pytest.raises(ValueError):
        brick_flat_apply(x, F, plan[:-1], (2, 2, 2), 1)
    # a device that has no kernel and is not the CPU
    with pytest.raises(RuntimeError, match="no brick flat kernel"):
        brick_flat_apply(x.to("meta"), F.to("meta"), plan, (2, 2, 2), 1)


def test_brick_flat_launch_struct_mirrors_the_kernel():
    """_build.BrickFlatLaunch lays out csrc/brick_flat.cu's
    BrickFlatLaunch: the fields and plan pointers, then 9 ints (the
    device, the dims, the field count, the tiling)."""
    import ctypes
    from tpufem_torch import _build
    L = _build.BrickFlatLaunch
    assert [n for n, _ in L._fields_] == ["F", "plan", "device", "az", "ay",
                                          "W", "nf", "rows", "lanes", "reach",
                                          "threads"]
    assert (L.plan.offset, L.device.offset, L.nf.offset, L.rows.offset,
            L.threads.offset) == (8, 16, 32, 36, 48)
    assert ctypes.sizeof(L) == 56


@pytest.mark.parametrize("gdims,c,m,planar", [
    ((8, 9, 10), 1, 1, False), ((5, 4, 6), 3, 6, True),
    ((4, 5, 3), 6, 6, False)], ids=["scalar", "planar_bs3", "flat_m6"])
def test_transfers_match_tpufem_and_are_adjoint(gdims, c, m, planar):
    """p0_apply / p0t_apply against tpufem's on the same random level,
    and <P0 xc, v> == <xc, P0^T v>."""
    rng = np.random.default_rng(30 + c)
    adims = tuple(-(-g // 3) for g in gdims)
    fw = rng.standard_normal(gdims + (c, m))
    n, nc = int(np.prod(gdims)) * c, int(np.prod(adims)) * m
    d = rng.random(n)
    ref = tpu_bramg._BLevel(None, jnp.asarray(d), jnp.asarray(fw),
                            jnp.asarray(d), 1.0, (), gdims, adims, c, m,
                            planar)
    lv = bramg._BLevel(None, torch.from_numpy(d), torch.from_numpy(fw),
                       torch.from_numpy(d), 1.0, (), gdims, adims, c, m,
                       planar)
    v, xc = rng.standard_normal(n), rng.standard_normal(nc)
    up = lv.p0_apply(torch.from_numpy(xc)).numpy()
    down = lv.p0t_apply(torch.from_numpy(v)).numpy()
    assert _rel(up, np.asarray(ref.p0_apply(jnp.asarray(xc)))) <= 1e-14
    assert _rel(down, np.asarray(ref.p0t_apply(jnp.asarray(v)))) <= 1e-14
    lhs, rhs = float(up @ v), float(xc @ down)
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


# -- the hierarchy -----------------------------------------------------------
def _explicit_tentative(lv0, n):
    """Host CSR of the tentative prolongator from the level-0 fw field
    (tests/test_bramg.py's helper)."""
    gz, gy, gx = lv0.gdims
    az, ay, ax = lv0.adims
    fw = lv0.fw.numpy()
    c, m = fw.shape[3], fw.shape[4]
    z, y, x = np.meshgrid(np.arange(gz), np.arange(gy), np.arange(gx),
                          indexing="ij")
    agg = ((z // 3) * ay + y // 3) * ax + x // 3
    node = (z * gy + y) * gx + x
    rows = (node[..., None, None] * c
            + np.arange(c)[:, None]) * np.ones(m, dtype=np.int64)
    cols = agg[..., None, None] * m + np.arange(m)[None, :]
    cols, rows = np.broadcast_to(cols, fw.shape), np.broadcast_to(rows, fw.shape)
    return sp.coo_matrix((fw.ravel(), (rows.ravel(), cols.ravel())),
                         shape=(n, az * ay * ax * m)).tocsr()


def test_probed_galerkin_matches_explicit():
    """Level-1 stencil from the colouring probes == scipy's P^T A P
    (twin of tests/test_bramg.py:46-74)."""
    mesh, _, bc, A = _poisson((7, 8, 9))
    pc = bramg.BrickAMG.setup(A, mesh, 1, SolverOptions(
        pc_type="amg", amg_coarse_eq_limit=4), dtype=F64, bc_mask=bc.mask())
    assert len(pc.levels) >= 2  # a real stencil level exists
    M = A.to_scipy()
    n = M.shape[0]
    P0 = _explicit_tentative(pc.levels[0], n)
    P = P0 - sp.diags(pc.levels[0].omega_dinv.numpy()) @ (M @ P0)
    Ac_ref = (P.T @ M @ P).toarray()
    nc = pc.level_sizes[1]
    eye = torch.eye(nc, dtype=F64)
    Ac = np.stack([pc.levels[1].matvec(eye[k].contiguous()).numpy()
                   for k in range(nc)], axis=1)
    assert np.abs(Ac - Ac_ref).max() < 1e-12 * np.abs(Ac_ref).max()


@pytest.fixture(scope="module")
def hier():
    """tpufem's and the port's float64 hierarchies of the 7x8x9 Poisson
    problem with amg_coarse_eq_limit 4 (levels 720, 36, 4)."""
    mesh_t = TpuMesh(7, 8, 9)
    bc_t = TpuBC.from_space(TpuSpace(mesh_t, 1), mesh_t.locate_boundary_facets(
        tpu_common.poisson_bc_marker))
    A_t = tpu_build_operator(mesh_t, 1, "poisson", bc_dofs=bc_t.flat_dofs(),
                             dtype=jnp.float64)
    ref = tpu_bramg.BrickAMG.setup(A_t, mesh_t, 1, TpuSolverOptions(
        pc_type="amg", amg_coarse_eq_limit=4), dtype=jnp.float64,
        bc_mask=bc_t.mask())
    mesh, _, bc, A = _poisson((7, 8, 9))
    port = bramg.BrickAMG.setup(A, mesh, 1, SolverOptions(
        pc_type="amg", amg_coarse_eq_limit=4), dtype=F64, bc_mask=bc.mask())
    return ref, A_t, port, A


def test_setup_matches_tpufem(hier):
    """Level sizes, plans, lmax, the level tensors and fields, and the
    eigen-clipped coarse inverse, to 1e-12 relative; the phase record."""
    ref, _, port, _ = hier
    assert port.level_sizes == ref.level_sizes and len(port.level_sizes) == 3
    assert port.smoother_degree == ref.smoother_degree
    for lv, lv_ref in zip(port.levels, ref.levels):
        assert (lv.gdims, lv.adims, lv.c, lv.m, lv.planar, tuple(lv.plan)) == \
            (lv_ref.gdims, lv_ref.adims, lv_ref.c, lv_ref.m, lv_ref.planar,
             tuple(lv_ref.plan))
        assert abs(lv.lmax - lv_ref.lmax) <= 1e-12 * lv_ref.lmax
        for name in ("dinv", "fw", "omega_dinv"):
            assert _rel(getattr(lv, name).numpy(),
                        np.asarray(getattr(lv_ref, name))) <= 1e-12, name
        if lv_ref.fields is not None:
            assert _rel(lv.fields.numpy(),
                        np.stack([np.asarray(f) for f in lv_ref.fields])) <= 1e-12
    assert _rel(port.coarse_inv.numpy(), np.asarray(ref.coarse_inv)) <= 1e-12
    assert set(port.last_phase_s) == {"qr", "probe", "fields", "eig",
                                      "coarse", "total"}


def test_vcycle_matches_tpufem(hier):
    """The V-cycle on tpufem's own hierarchy (convert.bramg_from_numpy)
    equals tpufem's vcycle on the same r, and so does the port's own
    setup's, to 1e-12."""
    ref, A_t, port, A = hier
    r = np.random.default_rng(5).standard_normal(port.level_sizes[0])
    want = np.asarray(jax.jit(lambda v: ref.vcycle(
        v, fine_matvec=A_t.apply))(jnp.asarray(r)))
    carried = convert.bramg_from_numpy(
        [dict(fields=None if lv.fields is None else
              [np.asarray(f) for f in lv.fields], plan=lv.plan,
              dinv=np.asarray(lv.dinv), fw=np.asarray(lv.fw),
              omega_dinv=np.asarray(lv.omega_dinv), lmax=lv.lmax,
              gdims=lv.gdims, adims=lv.adims, c=lv.c, m=lv.m,
              planar=lv.planar) for lv in ref.levels],
        np.asarray(ref.coarse_inv), ref.smoother_degree, ref.level_sizes, CPU)
    for pc in (carried, port):
        got = pc.vcycle(torch.from_numpy(r), fine_matvec=A.apply).numpy()
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


@pytest.mark.parametrize("problem,dims,limit", [
    ("poisson", (7, 6, 8), 30), ("elasticity", (4, 4, 5), 30)])
def test_vcycle_symmetric(problem, dims, limit):
    """The V(2,2) cycle is a symmetric operator, PCG's requirement (twin
    of tests/test_bramg.py:97-114; planar bs = 3 with the rigid-body
    near-nullspace too)."""
    mesh, space, bc, A = _poisson(dims, problem)
    nns = (build_near_nullspace(space.scalar_dof_coords())
           if problem == "elasticity" else None)
    pc = bramg.BrickAMG.setup(A, mesh, A.bs, SolverOptions(
        amg_coarse_eq_limit=limit), dtype=F64, near_nullspace=nns,
        bc_mask=bc.mask())
    rng = np.random.default_rng(1)
    u, v = (torch.from_numpy(rng.standard_normal(pc.level_sizes[0]))
            for _ in range(2))
    M = pc.as_preconditioner(A.apply)
    a, b = float(M(u) @ v), float(u @ M(v))
    assert abs(a - b) < 1e-9 * max(abs(a), 1.0)


def test_profile_vcycle_on_cpu(hier):
    _, _, port, A = hier
    out = port.profile_vcycle(A, port.level_sizes[0], reps=2)
    assert set(out) == {"smooth", "transfer", "below", "coarse", "total",
                        "smoother_degree"}
    assert all(out[k] > 0.0 for k in ("smooth", "transfer", "below",
                                      "coarse", "total"))
