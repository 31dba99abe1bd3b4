"""The port's channel-plane P2/P3 operator (tpufem_torch.fem.flat_op)
against tpufem's FlatOperator on the CPU, and the ``-use_flat 1``
cgpoisson path end to end.

On the CPU the interior wrapper runs the K5 kernel's plain PyTorch
version; the CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Host tables and the layout
must be equal (the same numpy arithmetic); the interior must match
tpufem's Pallas kernel in interpret mode elementwise within 3e-5 of the
sum of |terms| (float32 sums of up to K = 480 terms in another order:
480 * 2^-24 = 2.9e-5); the apply must match tpufem's XLA twin and the
float64 DIA host twin within tpufem's own 2e-5 * max|ref|
(tests/test_flat_op.py)."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.config import Config as TpuConfig
from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.fem.dia_op import DiaOperator as TpuDia
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.flat_op import FlatOperator as TpuFlat
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.mesh.structured import BoxTetMesh as TpuMesh
from tpufem.problems import cgpoisson as tpu_cgpoisson
from tpufem.problems import common as tpu_common

from tpufem_torch.config import Config, SolverOptions
from tpufem_torch.convert import flat_from_numpy
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.flat_op import FlatOperator
from tpufem_torch.fem.strip_op import StripOperator
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import cgpoisson

torch.set_num_threads(1)
CPU = torch.device("cpu")
TABLES = ("W0", "AZT", "slot_of", "TY", "TX", "BYZ", "BZX", "BYX", "CC",
          "fmask")
CASES = [(2, (8, 9, 10)), (3, (8, 8, 9))]
TOL_INTERIOR = 3e-5
TOL_APPLY = 2e-5


@pytest.fixture
def one_timed_solve(monkeypatch):
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


def _dias(order, dims):
    """(tpufem const DIA, port const DIA, ndofs), float32 tables."""
    mesh = TpuMesh(*dims)
    space = TpuSpace(mesh, order)
    bc = TpuBC.from_space(
        space, mesh.locate_boundary_facets(tpu_common.poisson_bc_marker))
    tdia = TpuDia.try_const(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                            device=False)
    pdia = DiaOperator.try_const(BoxTetMesh(*dims), order, "poisson",
                                 bc_dofs=bc.flat_dofs())
    return tdia, pdia, space.ndofs


def _carried(tpu: TpuFlat) -> FlatOperator:
    return flat_from_numpy(*(np.asarray(getattr(tpu, k)) for k in TABLES),
                           meta=tpu.meta, device=CPU)


@pytest.mark.parametrize("order,dims", CASES, ids=["P2", "P3"])
def test_host_tables_equal_tpufem(order, dims):
    tdia, pdia, _ = _dias(order, dims)
    tpu = TpuFlat.from_dia(tdia, use_pallas=False)
    op = FlatOperator.from_dia(pdia)
    assert tuple(op.geom) == tpu.meta[0]
    assert op.channels == tpu.channels
    assert dataclasses.astuple(op.layout) == dataclasses.astuple(tpu.layout)
    for k in TABLES:
        a, b = getattr(op, k).numpy(), np.asarray(getattr(tpu, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    carried = _carried(tpu)
    assert carried.geom == op.geom and carried.layout == op.layout
    assert all(torch.equal(getattr(carried, k), getattr(op, k))
               for k in TABLES)


@pytest.mark.parametrize("order,dims", [(2, (6, 6, 8)), (3, (6, 6, 7))],
                         ids=["P2", "P3"])
def test_from_dia_none_where_tpufem_is(order, dims):
    """A lattice with a typed grid shorter than 8 does not fit."""
    tdia, pdia, _ = _dias(order, dims)
    assert tdia is not None and pdia is not None
    assert TpuFlat.from_dia(tdia, use_pallas=False) is None
    assert FlatOperator.from_dia(pdia) is None


def test_layout_roundtrip_equals_tpufem():
    tdia, pdia, ndofs = _dias(3, (8, 8, 9))
    tpu = TpuFlat.from_dia(tdia, use_pallas=False)
    op = FlatOperator.from_dia(pdia)
    u = np.random.default_rng(1).standard_normal(ndofs).astype(np.float32)
    xf = op.to_flat(torch.from_numpy(u))
    xt = np.asarray(tpu.to_flat(jnp.asarray(u)))
    assert xf.dtype == torch.float32 and np.array_equal(xf.numpy(), xt)
    assert np.array_equal(op.from_flat(xf).numpy(), u)
    assert np.array_equal(op.from_flat(xf).numpy(),
                          np.asarray(tpu.from_flat(jnp.asarray(xt))))


def test_interior_plain_matches_pallas_interpret():
    """K5's plain version against tpufem's Pallas kernel (interpret mode
    on the CPU), on tables carried over with flat_from_numpy."""
    tdia, _, ndofs = _dias(3, (8, 8, 9))
    tpu = TpuFlat.from_dia(tdia, use_pallas=True)
    op = _carried(tpu)
    u = np.random.default_rng(2).standard_normal(ndofs)
    xt = tpu.to_flat(jnp.asarray(u, dtype=jnp.float32))
    # nonzero halo and guard lanes too: the interior reads the halo
    x = np.asarray(xt) + np.random.default_rng(3).standard_normal(
        xt.shape).astype(np.float32) * (np.asarray(tpu.fmask) == 0)
    ref = np.asarray(tpu._interior_pallas(jnp.asarray(x)))
    got = op.interior(torch.from_numpy(x)).numpy()
    absop = dataclasses.replace(op, W0=op.W0.abs(), AZT=op.AZT.abs())
    bound = absop.interior_plain(torch.from_numpy(np.abs(x))).numpy()
    assert np.all(np.abs(got - ref) <= TOL_INTERIOR * bound)
    g = op.geom
    assert not got[0].any() and not got[1 + g.Zc:].any()
    assert not got[:, :, :128].any() and not got[:, :, 128 + g.TILE:].any()


def _sparse_interior(op, x):
    """The interior product from the sparse plan alone: per entry gather
    the shifted source row, multiply by the plane's weight, and sum into
    the entry's output channel."""
    g, plan = op.geom, op.sparse_plan
    co = torch.from_numpy(np.repeat(np.arange(g.CP), np.diff(plan.ptr)))
    row = torch.from_numpy(plan.ent[:, 0].astype(np.int64))
    off = torch.from_numpy(plan.ent[:, 1].astype(np.int64))
    bp = 1 + torch.arange(g.Zc)
    slot = op.slot_of[0, :g.Zc].long()
    vals = plan.vals[torch.where(slot >= 0, 1 + slot, 0)]      # [Zc, nnz]
    plane = bp[:, None] - 1 + row[None, :] // g.CP             # [Zc, nnz]
    lane = 128 + off[:, None] + torch.arange(g.TILE)[None, :]  # [nnz, TILE]
    src = x[plane[:, :, None], (row % g.CP)[None, :, None], lane[None]]
    body = torch.zeros((g.Zc, g.CP, g.TILE), dtype=x.dtype)
    body.index_add_(1, co, vals[:, :, None] * src)
    y = torch.zeros_like(x)
    y[1:1 + g.Zc, :, 128:128 + g.TILE] = body
    return y


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("order,dims", CASES, ids=["P2", "P3"])
def test_sparse_plan_equals_interior_plain(order, dims, dtype, tol):
    """K5's sparse plan (what the CUDA kernel walks) against the dense
    plain version on an operator with boundary-plane deltas: the same
    terms, so they differ by the summation order only (relative to the
    largest output: 1e-6 in float32, 1e-13 in float64); the entries
    ascend in k within a channel and cover every nonzero of W0 and AZT."""
    _, pdia, _ = _dias(order, dims)
    op = FlatOperator.from_dia(pdia).astype(dtype)
    g, plan = op.geom, op.sparse_plan
    assert bool((op.AZT != 0).any()) and bool((op.slot_of >= 0).any())
    assert plan.ptr[0] == 0 and plan.ptr[-1] == len(plan.k)
    assert plan.vals.shape == (1 + op.AZT.shape[0], len(plan.k))
    assert plan.vals.dtype == dtype
    covered = np.zeros((g.CP, g.K), dtype=bool)
    for co in range(g.CP):
        k = plan.k[plan.ptr[co]:plan.ptr[co + 1]]
        assert np.all(np.diff(k) > 0)
        covered[co, k] = True
    nonzero = ((op.W0 != 0) | (op.AZT != 0).any(dim=0)).numpy()
    assert np.array_equal(covered, nonzero)
    # every entry's source row and lane offset are its shift's
    dz, off = op.shift_tables
    j, ci = np.divmod(plan.k, g.CP)
    assert np.array_equal(plan.ent[:, 0], (dz[j] + 1) * g.CP + ci)
    assert np.array_equal(plan.ent[:, 1], off[j])
    # the weights are the planes' dense weights at those positions
    co_of = np.repeat(np.arange(g.CP), np.diff(plan.ptr))
    WT = op.plane_weights()
    slot = op.slot_of[0, :g.Zc].long()
    assert torch.equal(plan.vals[torch.where(slot >= 0, 1 + slot, 0)],
                       WT[:, co_of, plan.k])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (g.Zp, g.CP, g.LW))).to(dtype)
    ref = op.interior_plain(x)
    got = _sparse_interior(op, x)
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    assert not got[0].any() and not got[1 + g.Zc:].any()


@pytest.mark.parametrize("order,dims", CASES, ids=["P2", "P3"])
def test_apply_matches_tpufem_and_dia(order, dims):
    tdia, pdia, ndofs = _dias(order, dims)
    tpu = TpuFlat.from_dia(tdia, use_pallas=False)
    op = FlatOperator.from_dia(pdia)
    u = np.random.default_rng(0).standard_normal(ndofs)
    got = op.apply(torch.from_numpy(u)).numpy()
    assert got.dtype == np.float64
    for ref in (np.asarray(tpu.apply(jnp.asarray(u, dtype=jnp.float32))),
                pdia.apply_np(u)):
        assert np.abs(got - ref).max() < TOL_APPLY * np.abs(ref).max()
    # pad and guard lanes, pad channels and halo planes stay exactly zero
    xf = op.to_flat(torch.from_numpy(u))
    yf = op.apply_flat(xf)
    pad = op.to_flat(torch.ones(ndofs)) == 0
    assert bool((yf[pad] == 0).all())
    assert float((yf.double() * xf.double()).sum()) == pytest.approx(
        float(op.from_flat(yf).double() @ op.from_flat(xf).double()),
        rel=1e-12)


def _tpu_problem(mesh_dims, order, dtype, use_flat):
    cfg = TpuConfig(problem_type="cgpoisson", dtype=dtype,
                    solver=TpuSolverOptions(extra={"use_flat": use_flat}))
    ref = tpu_cgpoisson.problem(TpuMesh(*mesh_dims), order, cfg)
    x, it = ref.solver_function(ref.u, ref.b)
    return np.asarray(x), it


def _port_problem(mesh_dims, order, dtype, use_flat):
    cfg = Config(problem_type="cgpoisson", dtype=dtype,
                 solver=SolverOptions(extra={"use_flat": use_flat}))
    prob = cgpoisson.problem(BoxTetMesh(*mesh_dims), order, cfg, CPU)
    x, it = prob.solver_function(prob.u, prob.b)
    return prob, x.numpy(), it


def test_use_flat_problem_matches_tpufem(one_timed_solve):
    """``-use_flat 1`` at P2 (8, 9, 10) in float32: the port's problem
    against tpufem's with the same option (tests/conftest.py turns jax's
    x64 mode on, where tpufem's float32 dots accumulate in float64: the
    port's ``mixed`` dtype).  Iterations and solution to tests/test_flat_op.py's
    tolerances (float32 CG in two summation orders)."""
    x_ref, it_ref = _tpu_problem((8, 9, 10), 2, "float32", 1)
    prob, x, it = _port_problem((8, 9, 10), 2, "mixed", 1)
    op = prob.solver_function.op
    assert isinstance(op, FlatOperator)
    assert x.dtype == np.float32
    assert abs(it - it_ref) <= 3
    assert np.abs(x - x_ref).max() < 1e-4 * np.abs(x_ref).max()


def test_use_flat_float64_runs_float32_loop(one_timed_solve, caplog):
    """tpufem's flat form is float32 whatever --dtype: the port runs the
    same float32 loop (with float64 dots) and casts the solution back."""
    caplog.set_level("INFO", logger="tpufem_torch")
    x_ref, it_ref = _tpu_problem((8, 9, 10), 2, "float64", 1)
    prob, x, it = _port_problem((8, 9, 10), 2, "float64", 1)
    assert prob.solver_function.op.dtype == torch.float32
    assert x.dtype == np.float64
    assert "run in float32" in caplog.text
    assert abs(it - it_ref) <= 3
    assert np.abs(x - x_ref).max() < 1e-4 * np.abs(x_ref).max()


def test_use_flat_falls_back_to_strip(one_timed_solve, caplog):
    """Where the lattice does not fit the flat layout both packages warn
    and run the strip form: the same float64 solve as tpufem's.

    The lattice is one no other test solves at P2: tpufem's StripOperator
    keeps a numpy array in its pytree metadata, so a second jit of an
    equal-geometry operator in the same process cannot compare the two."""
    caplog.set_level(logging.WARNING)
    prob, x, it = _port_problem((6, 7, 8), 2, "float64", 1)
    assert isinstance(prob.solver_function.op, StripOperator)
    port_warn = [r for r in caplog.records if r.name == "tpufem_torch"
                 and "use_flat ignored" in r.getMessage()]
    assert len(port_warn) == 1
    caplog.clear()
    x_ref, it_ref = _tpu_problem((6, 7, 8), 2, "float64", 1)
    assert any(r.name == "tpufem" and "use_flat ignored" in r.getMessage()
               for r in caplog.records)
    n_ref = float(np.linalg.norm(x_ref))
    assert it == it_ref
    assert abs(float(np.linalg.norm(x)) - n_ref) <= 1e-9 * n_ref
