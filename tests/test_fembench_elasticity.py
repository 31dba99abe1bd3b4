"""The benchmark's elasticity reference (fembench/reference/elasticity.py)
on the CPU, and the pieces of the elasticity cell that need no run: the
reference's operator against the port's planar bs = 3 DIA operator, its
box matrix, its sizing, its pool and its nonzero count; the cell's three
per-layer readers on synthetic records; and the port's ``solve.layout``
span and ``stencil.bs3`` counter.

Tolerances: rel 1e-12 between the two float64 operators, both exact
assemblies of one form that differ only in their order of summation;
1e-9 of the box matrix's largest entry for the rigid-body modes, whose
products cancel terms of size E / h."""

import math

import numpy as np
import pytest
import torch

from fembench import harness, peaks
from fembench.reference import elasticity as ref
from tpufem_torch import cli, timing
from tpufem_torch.fem.dia_op import build_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.structured import (BoxTetMesh,
                                          compute_box_size_structured)
from tpufem_torch.problems import common, elasticity

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**31 + 2024


def _program_operator(dims):
    mesh = BoxTetMesh(*dims)
    bc = DirichletBC.from_space(
        FunctionSpace(mesh, 1, bs=3),
        mesh.locate_boundary_facets(common.elasticity_bc_marker)).flat_dofs()
    return build_operator(mesh, 1, "elasticity", bc_dofs=bc,
                          dtype=torch.float64, device=CPU, planar=True)


@pytest.mark.parametrize("dims", [(6, 7, 8), (8, 6, 10)])
def test_reference_operator_is_the_ports(dims):
    """The reference's interleaved float64 apply against the port's planar
    one, converted; and the reference's nonzero count against the port's
    assembled matrix, counted above the same tolerance."""
    A = _program_operator(dims)
    op = ref.ElasticOperator(dims, CPU, block_layers=3)
    g = torch.Generator().manual_seed(SEED)
    for _ in range(2):
        x = torch.randn(op.n, dtype=torch.float64, generator=g)
        yp = A.apply(x.reshape(-1, 3).T.contiguous().reshape(-1))
        y = yp.reshape(3, -1).T.reshape(-1)
        yr = op.apply(x)
        assert float((y - yr).norm() / yr.norm()) <= 1e-12
    M = abs(A.to_scipy()).toarray()
    assert ref.nnz(dims) == int((M > 1e-12 * M.max()).sum())


def test_box_matrix_is_symmetric_with_the_rigid_body_modes_in_its_kernel():
    dims = (5, 3, 4)
    K = ref.box_matrix(dims)
    assert np.array_equal(K, K.T)
    h = 1.0 / np.asarray(dims, dtype=np.float64)
    corners = np.array([[dx, dy, dz] for dz in (0, 1) for dy in (0, 1)
                        for dx in (0, 1)], dtype=np.float64) * h
    modes = [np.tile(np.eye(3)[c], 8) for c in range(3)]
    for axis in np.eye(3):
        modes.append(np.cross(axis, corners).reshape(-1))
    for m in modes:
        assert np.abs(K @ m).max() <= 1e-9 * np.abs(K).max()
    # the six modes are the whole kernel: the rest of the spectrum is
    # positive
    w = np.linalg.eigvalsh(K)
    assert np.sum(np.abs(w) <= 1e-9 * w.max()) == 6 and w.min() > \
        -1e-9 * w.max()


@pytest.mark.parametrize("ndofs", [20_000, 500_000, 10_000_000])
def test_lattice_is_the_programs(ndofs):
    nx, ny, nz, _ = compute_box_size_structured(ndofs, True, 3, 1, 1)
    assert ref.lattice_of(dict(ndofs=ndofs)) == (nx, ny, nz)


def test_the_cells_lattice():
    dims = ref.lattice_of(dict(ndofs=10_000_000))
    assert dims == (128, 160, 160)
    assert 3 * (dims[0] + 1) * (dims[1] + 1) * (dims[2] + 1) == 10_031_427


def test_pool_repeats_per_seed_and_is_zero_on_the_clamped_face():
    mix = dict(ndofs=600)
    Nx, Ny, Nz = ref.lattice_of(mix)
    a = ref.rhs_pool(SEED, 3, mix, torch.float32, CPU)
    b = ref.rhs_pool(SEED, 3, mix, torch.float32, CPU)
    c = ref.rhs_pool(SEED + 1, 3, mix, torch.float32, CPU)
    assert a.shape == (3, 3 * (Nx + 1) * (Ny + 1) * (Nz + 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = a.view(3, Nz + 1, Ny + 1, Nx + 1, 3)
    assert not g[:, :, 0].any()
    assert bool((g[:, :, 1:] != 0).all())
    assert math.isclose(float(a.std()), 1.0, rel_tol=0.5)


def test_apply_work_counts_three_components():
    rec = dict(lattice=(128, 160, 160), itemsize=4)
    nbytes, flops = ref.apply_work(rec)
    assert nbytes == 2 * 4 * 10_031_427
    assert flops == 2 * ref.nnz((128, 160, 160))
    # bandwidth bound: 80.25 MB at 3.35 TB/s
    assert peaks.bound_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)


def _record(**ranges):
    return dict(problem_type="elasticity", lattice=(128, 160, 160),
                itemsize=4, trace=dict(ranges=ranges))


def test_apply_roofline_reads_the_programs_apply_spans():
    mod = harness.load_module("metrics", "apply_roofline.elasticity")
    bound = peaks.bound_s(*ref.apply_work(_record()))
    rec = _record(**{"cg.apply": dict(calls=300, host_s=0.1, kernels=300,
                                      device_s=300 * 0.256e-3)})
    assert mod.read(rec) == pytest.approx(100 * bound / 0.256e-3, rel=1e-9)
    assert 8.0 < mod.read(rec) < 12.0
    # the benchmark's own range around the action is not the program's
    assert mod.read(_record(**{"fembench.apply": dict(
        calls=300, host_s=0.1, kernels=300, device_s=0.1)})) is None
    assert mod.read(_record(**{"cg.apply": dict(
        calls=300, host_s=0.1, kernels=0, device_s=0.0)})) is None
    assert mod.read(dict(_record(), trace=None)) is None


def test_vcycle_device_ms_reads_the_vcycle_range():
    mod = harness.load_module("metrics", "vcycle_device_ms.elasticity")
    rec = _record(**{"fembench.vcycle": dict(calls=320, host_s=1.0,
                                             kernels=40000, device_s=0.8)})
    assert mod.read(rec) == pytest.approx(2.5)
    assert mod.read(_record()) is None
    assert mod.read(dict(_record(), trace=None)) is None


def test_smooth_l0_share_reads_both_ranges():
    mod = harness.load_module("metrics", "smooth_l0_share.elasticity")
    vc = dict(calls=320, host_s=1.0, kernels=40000, device_s=0.8)
    l0 = dict(calls=640, host_s=0.5, kernels=8000, device_s=0.6)
    rec = _record(**{"fembench.vcycle": vc, "gmg.smooth.L0": l0})
    assert mod.read(rec) == pytest.approx(75.0)
    assert mod.read(_record(**{"fembench.vcycle": vc})) is None
    assert mod.read(_record(**{"gmg.smooth.L0": l0})) is None
    assert mod.read(_record(**{"fembench.vcycle": dict(vc, device_s=0.0),
                               "gmg.smooth.L0": l0})) is None


@pytest.fixture
def fresh_spans():
    timing.SPANS.reset()
    was = timing.enable_spans(False)
    yield
    timing.enable_spans(was)
    timing.SPANS.reset()


def _elasticity(dims, *args):
    cfg, dev = cli.parse_args(["--problem_type", "elasticity", "--dtype",
                               "float64", "--device", "cpu"] + list(args))
    return elasticity.problem(BoxTetMesh(*dims), 1, cfg, dev)


def test_layout_span_and_bs3_counter(fresh_spans, monkeypatch):
    """With spans on, a planar GMG solve records ``solve.layout`` twice
    (in and out) and counts every three-component apply, CG's and every
    smoothed level's, in ``stencil.bs3``; with spans off, neither.  A
    Poisson solve records neither."""
    from tpufem_torch.fem.dia_op import DiaOperator
    prob = _elasticity((12, 12, 16), "-pc_type", "gmg", "-ksp_rtol", "1e-8")
    solver = prob.solver_function
    applies = {"n": 0}
    inner = DiaOperator.apply

    def counted(self, x):
        applies["n"] += self.bs == 3
        return inner(self, x)

    monkeypatch.setattr(DiaOperator, "apply", counted)
    x_off, it_off, _ = solver.run(prob.u, prob.b)   # builds the V-cycle
    assert timing.SPANS.records == [] and timing.SPANS.counters == {}
    assert len(solver.pc.levels) == 2
    applies["n"] = 0
    timing.enable_spans(True)
    for _ in range(2):
        x_on, it_on, _ = solver.run(prob.u, prob.b)
    summ = timing.SPANS.summary()
    assert summ["spans"]["solve.layout"]["calls"] == 4
    assert summ["counters"]["stencil.bs3"] == applies["n"] > 2 * it_on
    assert torch.equal(x_on, x_off) and it_on == it_off
    layout = [r for r in timing.SPANS.records if r[0] == "solve.layout"]
    assert all(timing.SPANS.records[r[2]][0] == "solve" for r in layout)

    timing.SPANS.reset()
    cfg, dev = cli.parse_args(["--problem_type", "poisson", "--dtype",
                               "float64", "--device", "cpu", "-pc_type",
                               "gmg"])
    from tpufem_torch.problems import poisson
    p = poisson.problem(BoxTetMesh(8, 8, 12), 1, cfg, dev)
    p.solver_function.run(p.u, p.b)
    summ = timing.SPANS.summary()
    assert "solve" in summ["spans"] and "solve.layout" not in summ["spans"]
    assert "stencil.bs3" not in summ["counters"]
