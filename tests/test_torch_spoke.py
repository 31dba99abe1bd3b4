"""The port's unstructured spoke path (mesh copies, assembled CSR, the
window gate and RCM order, the host RHS, Poisson P1 with SA-AMG and the
constant nullspace deflated) against tpufem on the CPU.  tpufem's CLI
runs are pinned as constants (its ``python -m tpufem ... --num_shards 1``
on this mesh); the pieces are compared live."""

import hashlib
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpufem import native as tpu_native
from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.fem.assemble import assemble_operator as tpu_assemble_operator
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.fem.window_op import rcm_csr as tpu_rcm_csr
from tpufem.mesh.spoke import create_spoke_mesh as tpu_create_spoke_mesh
from tpufem.problems import common as tpu_common
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli, native
from tpufem_torch.fem.assemble import assemble_csr_np, assemble_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.window_op import rcm_csr, window_gate
from tpufem_torch.mesh.spoke import create_spoke_mesh
from tpufem_torch.problems import common, poisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
SPOKE = ["--problem_type", "poisson", "--mesh_type", "unstructured",
         "--device", "cpu"]

# tpufem's CLI on this mesh (f64): (ndofs, extra options) -> (its, norm)
TPU_RUNS = {
    "20k": (["--ndofs", "20000"], 58, 738.3125824626104),
    "3k_plain": (["--ndofs", "3000", "-amg_fine_window", "off"], 44,
                 285.8658129613536),
    "3k_rcm": (["--ndofs", "3000", "-amg_fine_window", "on"], 45,
               285.8658129385631),
    "3k_over_budget": (["--ndofs", "3000", "-amg_window_budget_mb", "2"], 44,
                       285.8658129613536),
}


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _no_native(monkeypatch):
    monkeypatch.setattr(tpu_native, "_get", lambda: None)
    monkeypatch.setattr(native, "_get", lambda: None)


def _same_native(monkeypatch):
    """tpufem's loader on the port's library of the same pinned source
    (tests/test_torch_vendored.py): both packages take one route whichever
    test process built tpufem's own library first."""
    monkeypatch.setattr(tpu_native, "_get", native._get)


def _system(ndofs, tpu=False):
    make = tpu_create_spoke_mesh if tpu else create_spoke_mesh
    mesh = make(ndofs, True, 1, 1, verbose=False)
    space = (TpuSpace if tpu else FunctionSpace)(mesh, 1)
    marker = (tpu_common if tpu else common).poisson_bc_marker
    bc = (TpuBC if tpu else DirichletBC).from_space(
        space, mesh.locate_boundary_facets(marker))
    return mesh, space, bc


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_spoke_mesh_matches_tpufem(route, monkeypatch):
    """create_spoke_mesh(9000) (uniform and marked-edge refinement, the
    topology) on one route in both packages.  The native route is held to
    tpufem's and to its pinned digest."""
    _same_native(monkeypatch)
    if route == "numpy":
        _no_native(monkeypatch)
    mesh = create_spoke_mesh(9000, True, 1, 1, verbose=False)
    if route == "native":
        assert _digest(mesh.vertices, mesh.cells()) == "6748a21f07ead150"
    ref = tpu_create_spoke_mesh(9000, True, 1, 1, verbose=False)
    assert np.array_equal(mesh.vertices, ref.vertices)
    assert np.array_equal(mesh.cells(), ref.cells())
    assert np.array_equal(mesh.boundary_faces(), ref.boundary_faces())
    assert np.array_equal(mesh.cell_faces(), ref.cell_faces())
    assert np.array_equal(mesh.cell_edges()[0], ref.cell_edges()[0])
    facets = mesh.boundary_faces()
    for got, want in zip(
            common.facet_to_cell(mesh.cell_faces(), facets),
            tpu_common.facet_to_cell(ref.cell_faces(), facets)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_assembled_csr_matches_tpufem(route, monkeypatch):
    """The BC-eliminated CSR triplets bit for bit (native: against
    tpufem's and a pinned digest), and the device CsrMatrix holds them."""
    _same_native(monkeypatch)
    if route == "numpy":
        _no_native(monkeypatch)
    mesh, space, bc = _system(3000)
    csr = assemble_csr_np(space, bc, "poisson")
    if route == "native":
        assert _digest(*csr) == "72cf1b5f48f5ef5e"
    _, tspace, tbc = _system(3000, tpu=True)
    _, ref = tpu_assemble_operator(tspace, tbc, "poisson", dtype=np.float64)
    for got, want in zip(csr, ref):
        assert np.array_equal(got, want)
    A, host = assemble_operator(space, bc, "poisson", torch.float64, CPU)
    assert np.array_equal(A.to_scipy().toarray(),
                          sp.csr_matrix((csr[2], csr[1], csr[0])).toarray())
    assert all(np.array_equal(a, b) for a, b in zip(host, csr))


def test_rcm_and_rhs_match_tpufem(monkeypatch):
    _same_native(monkeypatch)
    mesh, space, bc = _system(3000)
    csr = assemble_csr_np(space, bc, "poisson")
    perm, csr_w = rcm_csr(*csr)
    rperm, rcsr_w = tpu_rcm_csr(*csr)
    assert np.array_equal(perm, rperm)
    for got, want in zip(csr_w, rcsr_w):
        assert np.array_equal(got, want)
    _, tspace, _ = _system(3000, tpu=True)
    assert np.array_equal(poisson.assemble_poisson_rhs_np(space),
                          tpu_poisson.assemble_poisson_rhs_np(tspace))


class _Mask:
    def __init__(self, m):
        self._m = m

    def mask(self):
        return self._m


@pytest.mark.parametrize("mode,budget", [
    ("auto", 4096), ("auto", 1), ("auto", 2), ("auto", 3), ("auto", 5),
    ("on", 1), ("off", 4096)])
def test_window_gate_decides_as_tpufem(mode, budget, monkeypatch):
    """The RCM route is taken exactly where tpufem's _try_window builds a
    window form (its pre-gate, its budget clamp and tail cut)."""
    _same_native(monkeypatch)
    mesh, space, bc = _system(3000)
    csr = assemble_csr_np(space, bc, "poisson")
    got = window_gate(csr, mode, budget, 4)
    opts = TpuSolverOptions()
    opts.amg_fine_window, opts.amg_window_budget_mb = mode, budget
    wop = tpu_poisson._try_window(csr, _Mask(bc.mask()), opts, jnp.float32)[0]
    assert (got is None) == (wop is None)
    if got is not None:
        assert np.array_equal(got[0], np.asarray(wop.perm))


@pytest.mark.parametrize("name", list(TPU_RUNS))
def test_spoke_f64_runs_match_tpufem(name):
    """tpufem's f64 spoke runs: iterations exact, norms to rel 1e-9, on
    the RCM route, the plain route and past the window budget."""
    extra, its, norm = TPU_RUNS[name]
    res = cli.main(SPOKE + ["--dtype", "float64"] + extra)
    assert res.iterations == its
    assert abs(res.norm - norm) <= 1e-9 * norm
    solver = res.problem.solver_function
    assert solver.route == ("plain" if name in ("3k_plain", "3k_over_budget")
                            else "rcm")
    assert solver.deflate and res.true_rel <= 1e-8
    assert abs(float(res.x.sum())) <= 1e-9 * float(res.x.abs().sum())


@pytest.mark.parametrize("extra", [[], ["-amg_window_bf16", "on"]],
                         ids=["f32", "bf16_twin"])
def test_spoke_f32_certified_at_the_bench_cap(extra):
    """float32 at the bench's 120-iteration cap: CG stalls at the cap,
    refinement closes the contract (tpufem's spoke behaviour, ROADMAP
    section 3); with -amg_window_bf16 on the V-cycle's fine applies use
    the bf16-valued twin while CG's own product stays float32."""
    res = cli.main(SPOKE + ["--ndofs", "20000", "-ksp_max_it", "120"] + extra)
    solver = res.problem.solver_function
    assert res.iterations == 120 and 1 <= res.refine_passes <= 3
    assert res.true_rel <= 1e-8
    assert abs(res.norm - 738.3125824626104) <= 1e-6 * 738.3125824626104
    assert solver.op.vals.dtype == torch.float32


@pytest.mark.parametrize("argv,item", [
    (["--num_shards", "2"], None),   # ported since: the row-sharded path
    (["--output", "out"], "M17"),    # ported since: the XDMF output
    (["--memory_profiling"], "M17"),  # ported since: the [MEM] sampler
], ids=["num_shards", "output", "memory_profiling"])
def test_unported_spoke_paths_raise(argv, item, tmp_path, monkeypatch,
                                    caplog):
    """The spoke paths once unported all run now: --num_shards on the
    row-sharded path, --output (ROADMAP M17: the file, in the run's
    directory, holds the mesh and the solution) and --memory_profiling
    (M17: [MEM] lines)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--mesh_type", "unstructured", "--ndofs", "3000",
            "--device", "cpu"] + argv
    with caplog.at_level(logging.INFO, logger="tpufem_torch"):
        res = cli.main(argv + ["--dtype", "float64", "-ksp_max_it", "40"])
    assert 0 < res.iterations <= 40 and np.isfinite(res.norm)
    if item is None:
        assert type(res.problem.solver_function.sh).__name__ == \
            "ShardedEllSolver"
    elif "--output" in argv:
        from tpufem_torch.io import read_xdmf
        got = read_xdmf(str(tmp_path / "out" / "solution-1.xdmf"))
        assert np.array_equal(got["topology"],
                              res.problem.space.mesh.cells())
        assert np.array_equal(got["values"][:, 0], res.x.numpy())
    else:
        assert re.search(r"\[MEM\] VSIZE = \d+\.\d{3} GB, RSS = "
                         r"\d+\.\d{3} GB", caplog.text)
