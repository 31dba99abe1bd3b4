"""The solve path's spans and counters (tpufem_torch/timing.py: span,
count, enable_spans, SPANS) on the CPU: off they record nothing and
enter no profiler range; on they leave every solve bit for bit as it
was, count each CG step and readback and each V-cycle level, nest, and
appear in a torch.profiler trace inside their solve."""

import pytest
import torch

from tpufem_torch import cli, timing
from tpufem_torch.config import SolverOptions
from tpufem_torch.fem.assemble import assemble_csr_np
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.la.cg import cg_solve_fused
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.parallel.rowshard import ShardedEllSolver
from tpufem_torch.parallel.slab import ShardedCubeSolver
from tpufem_torch.problems import cgpoisson, common, poisson

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_spans():
    """Each test starts with spans off and an empty record, and leaves
    them so."""
    timing.SPANS.reset()
    was = timing.enable_spans(False)
    yield
    timing.enable_spans(was)
    timing.SPANS.reset()


def _problem(kind, dims, *args):
    cfg, dev = cli.parse_args(["--problem_type", kind, "--dtype", "float64",
                               "--device", "cpu"] + list(args))
    mod = {"poisson": poisson, "cgpoisson": cgpoisson}[kind]
    return mod.problem(BoxTetMesh(*dims), 1, cfg, dev)


@pytest.fixture(scope="module")
def gmg():
    """A float64 GMG-CG Poisson problem with two smoothed levels and the
    dense coarse solve; its preconditioner is built by a first solve."""
    prob = _problem("poisson", (16, 16, 32), "-pc_type", "gmg",
                    "-ksp_rtol", "1e-8")
    prob.solver_function.run(prob.u, prob.b)
    return prob


@pytest.fixture(scope="module")
def matfree():
    """A float64 matrix-free CG Poisson problem (cg_solve_fused on the
    operator's action), 30 steps with no tolerance: it ends at maxit."""
    return _problem("cgpoisson", (8, 8, 10), "-cg_kmax", "30",
                    "-cg_rtol", "0")


def _solve(prob):
    return prob.solver_function.run(prob.u, prob.b)


def _fused(n=40, maxit=25):
    """cg_solve_fused on a small dense SPD matrix."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(n, n, generator=g, dtype=torch.float64)
    a = q @ q.T + n * torch.eye(n, dtype=torch.float64)
    b = torch.randn(n, generator=g, dtype=torch.float64)
    return cg_solve_fused(lambda v: a @ v, b, rtol=0.0, maxit=maxit)


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with spans off")


def test_off_records_nothing_and_enters_no_profiler_range(gmg, matfree,
                                                          monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _solve(gmg)
        _solve(matfree)
    _fused()
    assert timing.SPANS.records == []
    assert timing.SPANS.counters == {}
    assert timing.span("solve") is timing.span("cg.step")


@pytest.mark.parametrize("which", ["gmg", "matfree", "fused"])
def test_spans_leave_the_solve_bit_identical(which, request):
    run = (_fused if which == "fused"
           else lambda: _solve(request.getfixturevalue(which)))
    x_off, it_off, rel_off = run()
    timing.enable_spans(True)
    x_on, it_on, rel_on = run()
    assert timing.SPANS.records
    assert torch.equal(x_on, x_off)
    assert (it_on, rel_on) == (it_off, rel_off)


@pytest.mark.parametrize("which,extra", [("gmg", 2), ("matfree", 1),
                                         ("fused", 1)])
def test_steps_and_readbacks_are_counted(which, extra, request):
    """One cg.step a CG iteration; one readback each loop test and one
    for the returned rel: iterations + 2 where the loop converges (its
    last test reads False), + 1 where it stops at maxit."""
    timing.enable_spans(True)
    if which == "fused":
        _, it, _ = _fused()
        assert it == 25
    else:
        _, it, rel = _solve(request.getfixturevalue(which))
        assert (rel <= 1e-8) if which == "gmg" else (it == 30)
    summ = timing.SPANS.summary()
    assert summ["spans"]["cg.step"]["calls"] == it
    assert summ["spans"]["cg.apply"]["calls"] == it
    assert summ["counters"]["cg.readbacks"] == it + extra
    assert summ["spans"]["cg.readback"]["calls"] == it + extra
    assert ("cg.precond" in summ["spans"]) == (which == "gmg")


def test_every_vcycle_level_has_its_spans(gmg):
    timing.enable_spans(True)
    _, it, _ = _solve(gmg)
    spans = timing.SPANS.summary()["spans"]
    nlev = len(gmg.solver_function.pc.levels)
    assert nlev == 2
    for i in range(nlev):
        assert spans[f"gmg.smooth.L{i}"]["calls"] == 2 * it
        assert spans[f"gmg.restrict.L{i}"]["calls"] == it
        assert spans[f"gmg.prolong.L{i}"]["calls"] == it
    assert spans["gmg.coarse"]["calls"] == it
    assert spans["cg.precond"]["calls"] == it
    assert f"gmg.smooth.L{nlev}" not in spans
    # the level spans nest no other span: the recursion lies between
    # restrict and prolong
    names = [r[0] for r in timing.SPANS.records]
    parents = {names[r[2]] for r in timing.SPANS.records
               if r[0].startswith("gmg.")}
    assert parents == {"cg.precond"}


def test_self_time_and_nesting(gmg):
    timing.enable_spans(True)
    _solve(gmg)
    _solve(gmg)
    recs = timing.SPANS.records
    assert all(r[4] >= r[3] > 0 for r in recs)
    for name, s in timing.SPANS.summary()["spans"].items():
        assert 0 <= s["self_s"] <= s["host_s"], name
    # a child lies inside its parent, and the children's totals sum to
    # no more than the parent's
    kids = {}
    for r in recs:
        if r[2] >= 0:
            p = recs[r[2]]
            assert p[3] <= r[3] <= r[4] <= p[4]
            assert r[1] == p[1]
            kids[r[2]] = kids.get(r[2], 0) + r[4] - r[3]
    assert kids and all(t <= recs[i][4] - recs[i][3]
                        for i, t in kids.items())
    # two solves, two solve ids, each held by every span of its solve
    assert [r[1] for r in recs if r[0] == "solve"] == [1, 2]
    assert {r[1] for r in recs} == {1, 2}


def test_profiler_ranges_carry_the_span_names_inside_solve(gmg):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    timing.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, it, _ = _solve(gmg)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.is_user_annotation()]
    solves = [(s, e) for n, s, e in ranges if n == "solve"]
    assert len(solves) == 1
    s0, e0 = solves[0]
    inner = [(n, s, e) for n, s, e in ranges if n != "solve"]
    assert all(s0 <= s <= e <= e0 for _, s, e in inner)
    got = {n for n, _, _ in inner}
    assert {"cg.step", "cg.apply", "cg.precond", "cg.update",
            "cg.readback", "gmg.smooth.L0", "gmg.restrict.L1",
            "gmg.prolong.L1", "gmg.coarse"} <= got
    assert sum(n == "cg.step" for n, _, _ in inner) == it


def _sharded(kind):
    """A small float64 Poisson solver over 2 shards on the CPU: the slab
    cube solver with GMG, or the row-sharded one with plain CG."""
    cpu, mesh = torch.device("cpu"), BoxTetMesh(8, 8, 16)
    if kind == "slab":
        return ShardedCubeSolver.build(
            mesh, 2, problem="poisson", order=1, rtol=1e-8, maxit=60,
            precond=True, dtype=torch.float64, device=cpu)
    space = FunctionSpace(mesh, 1)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    b = poisson.assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    return ShardedEllSolver.build(
        space, bc, assemble_csr_np(space, bc, "poisson"), b, 2,
        SolverOptions(), dtype=torch.float64, rtol=1e-6, maxit=200,
        precond=False, device=cpu)


@pytest.mark.parametrize("kind", ["slab", "rowshard"])
def test_sharded_solve_opens_its_solve_span(kind):
    """A sharded run's CG steps sit in a solve span of their own, one
    solve id a solve, as a one-device solve's do."""
    solver = _sharded(kind)
    timing.enable_spans(True)
    _, it, _ = solver.solve()
    _, it2, _ = solver.solve()
    recs = timing.SPANS.records
    solves = [i for i, r in enumerate(recs) if r[0] == "solve"]
    assert [recs[i][1:3] for i in solves] == [[1, -1], [2, -1]]
    steps = [r for r in recs if r[0] == "cg.step"]
    assert len(steps) == it + it2
    assert all(r[2] in solves for r in steps)
    assert all(r[2] >= 0 for r in recs if r[0] != "solve")


def test_certify_pass_holds_the_correction_solve_under_the_callers_id():
    """A float32 solve certified against its float64 twin: each
    refinement pass is a certify.pass span holding its correction solve,
    under the id of the solve it certifies."""
    cfg, dev = cli.parse_args(["--dtype", "float32", "-ksp_rtol", "1e-8",
                               "--device", "cpu"])
    prob = poisson.problem(BoxTetMesh(8, 8, 16), 1, cfg, dev)
    timing.enable_spans(True)
    prob.solver_function(prob.u, prob.b)
    solver = prob.solver_function
    recs = timing.SPANS.records
    passes = [i for i, r in enumerate(recs) if r[0] == "certify.pass"]
    assert solver.refine_passes >= 1
    assert len(passes) >= solver.refine_passes
    assert timing.SPANS.counters["certify.passes"] == solver.refine_passes
    first = recs[0]
    assert first[0] == "solve" and first[2] == -1
    for i in passes:
        assert recs[i][2] == -1 and recs[i][1] == first[1]
        nested = [r for r in recs if r[2] == i]
        assert [r[0] for r in nested] == ["solve"]
        assert nested[0][1] == first[1]
    assert timing.SPANS.solve_id == 1
