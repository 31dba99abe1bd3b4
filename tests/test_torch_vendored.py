"""The port's own copies of tpufem's jax-free host modules (mesh,
reference element, function space, configuration and argument parsing,
the elasticity constants, element tables, data and near-nullspace) agree
with tpufem's, and the port runs with ``tpufem`` unimportable."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from tpufem.cli import parse_args as tpu_parse_args
from tpufem.fem import assemble as tpu_assemble
from tpufem.fem import kernels as tpu_kernels
from tpufem.fem.reference import ReferenceTet as TpuRef
from tpufem.fem.reference import \
    _edge_interior_params as tpu_edge_interior_params
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.fem.structured_op import StructuredOperator as TpuStructured
from tpufem.fem.structured_op import \
    perm_element_matrices as tpu_perm_element_matrices
from tpufem.la import nullspace as tpu_nullspace
from tpufem.mesh import refine as tpu_refine
from tpufem.mesh import spoke as tpu_spoke
from tpufem.mesh import structured as tpu_structured
from tpufem.problems import common as tpu_common

from tpufem_torch import cli, native
from tpufem_torch.fem import assemble
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.reference import ReferenceTet, _edge_interior_params
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import (StructuredOperator,
                                            perm_element_matrices)
from tpufem_torch.la import nullspace
from tpufem_torch.mesh import refine, spoke, structured
from tpufem_torch.problems import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_box_sizing_matches_tpufem(order):
    for ndofs in (1000, 3000, 15000, 50000, 146461, 500000, 2_000_000):
        for strong in (False, True):
            args = (ndofs, strong, 1, order, 1)
            assert (structured.compute_box_size_structured(*args)
                    == tpu_structured.compute_box_size_structured(*args))


def test_mesh_tables_match_tpufem():
    for name in ("CELL_VERTEX_OFFSETS", "EDGE_TYPES", "LOCAL_EDGES",
                 "LOCAL_FACES", "FACE_TYPES"):
        assert np.array_equal(getattr(structured, name),
                              getattr(tpu_structured, name)), name
    assert structured._EDGE_TYPE_OF == tpu_structured._EDGE_TYPE_OF
    assert structured._FACE_TYPE_OF == tpu_structured._FACE_TYPE_OF
    mine, ref = structured.BoxTetMesh(3, 4, 5), tpu_structured.BoxTetMesh(3, 4, 5)
    assert np.array_equal(mine._edge_dims(), ref._edge_dims())
    assert np.array_equal(mine._face_dims(), ref._face_dims())
    assert np.array_equal(mine.boundary_faces(), ref.boundary_faces())


@pytest.mark.parametrize("order", [1, 2, 3])
def test_reference_element_bitwise(order):
    mine, ref = ReferenceTet(order), TpuRef(order)
    for name in ("nodes", "stiffness_tensors", "mass_tensor",
                 "facet_mass_tensors"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name


@pytest.mark.parametrize("variant", ["gll_warped", "equispaced"])
def test_edge_interior_params_bitwise(variant):
    """The P_k edge-node parameters the p-transfers interpolate at."""
    for k in (1, 2, 3, 4):
        assert np.array_equal(_edge_interior_params(k, variant),
                              tpu_edge_interior_params(k, variant))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("order", [2, 3])
def test_structured_operator_diagonal_and_twin_bitwise(order, dtype):
    """The per-perm operator's host diagonal (bitwise, from the element
    matrices in the working dtype), its device diagonal and its host
    BC-eliminated apply against tpufem's."""
    import jax.numpy as jnp
    import torch
    dims = (3, 4, 5)
    mesh = structured.BoxTetMesh(*dims)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order),
                                mesh.locate_boundary_facets(
                                    common.poisson_bc_marker)).flat_dofs()
    op = StructuredOperator.build(mesh, order, "poisson", bc_dofs=bc,
                                  dtype=getattr(torch, dtype),
                                  device=torch.device("cpu"))
    tmesh = tpu_structured.BoxTetMesh(*dims)
    ref = TpuStructured.build(tmesh, order, "poisson", bc_dofs=bc,
                              dtype=getattr(jnp, dtype), device=False)
    assert np.array_equal(op.diagonal_np(), ref.diagonal_np())
    ref_dev = TpuStructured.build(tmesh, order, "poisson", bc_dofs=bc,
                                  dtype=getattr(jnp, dtype))
    assert np.array_equal(op.diagonal().numpy(),
                          np.asarray(ref_dev.diagonal()))
    x = np.random.default_rng(3).standard_normal(op.layout.ndofs)
    assert np.array_equal(op.apply_np(x), ref.apply_np(x))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("order", [2, 3])
def test_blocked_structured_operator_bitwise(order, dtype):
    """The blocked (bs = 3) per-perm operator of P2/P3 elasticity: its
    element matrices, host diagonal and host BC-eliminated apply
    (interleaved, tpufem's layout) against tpufem's, and its device
    diagonal (planar) against tpufem's device diagonal, permuted."""
    import jax.numpy as jnp
    import torch
    from tpufem_torch.fem.structured_op import to_interleaved
    dims = (3, 4, 2)
    mesh = structured.BoxTetMesh(*dims)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order, bs=3),
                                mesh.locate_boundary_facets(
                                    common.elasticity_bc_marker)).flat_dofs()
    host = StructuredOperator.build(mesh, order, "elasticity", bc_dofs=bc,
                                    dtype=getattr(torch, dtype))
    tmesh = tpu_structured.BoxTetMesh(*dims)
    ref = TpuStructured.build(tmesh, order, "elasticity", bc_dofs=bc,
                              dtype=getattr(jnp, dtype), device=False)
    assert host.bs == ref.bs == 3 and np.array_equal(host.Ap, ref.Ap)
    assert np.array_equal(host.bc_mask_np, np.asarray(ref.bc_mask))
    assert np.array_equal(host.diagonal_np(), ref.diagonal_np())
    x = np.random.default_rng(order).standard_normal(3 * host.layout.ndofs)
    assert np.array_equal(host.apply_np(x), ref.apply_np(x))
    dev = StructuredOperator.build(mesh, order, "elasticity", bc_dofs=bc,
                                   dtype=getattr(torch, dtype),
                                   device=torch.device("cpu"), planar=True)
    ref_dev = TpuStructured.build(tmesh, order, "elasticity", bc_dofs=bc,
                                  dtype=getattr(jnp, dtype))
    assert np.array_equal(to_interleaved(dev.diagonal().numpy(), 3),
                          np.asarray(ref_dev.diagonal()))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_function_space_matches_tpufem(order):
    mine = FunctionSpace(structured.BoxTetMesh(3, 4, 5), order)
    ref = TpuSpace(tpu_structured.BoxTetMesh(3, 4, 5), order)
    assert mine.ndofs == ref.ndofs and mine.ndofs_scalar == ref.ndofs_scalar
    assert np.array_equal(mine.cell_dofs, ref.cell_dofs)
    assert np.array_equal(mine.scalar_dof_coords(), ref.scalar_dof_coords())


def test_elasticity_constants_equal_tpufem():
    for name in ("ELASTICITY_E", "ELASTICITY_NU", "ELASTICITY_MU",
                 "ELASTICITY_LMBDA"):
        assert getattr(assemble, name) == getattr(tpu_kernels, name), name


@pytest.mark.parametrize("order", [1, 2, 3])
def test_elasticity_element_tables_bitwise(order):
    """``_elasticity_ref_table``, ``_elasticity_stiffness_np`` on random
    cells, and the six Kuhn shapes' blocked matrices."""
    for a, b in zip(assemble._elasticity_ref_table(order),
                    tpu_kernels._elasticity_ref_table(order)):
        assert np.array_equal(a, b)
    coords = np.random.default_rng(order).standard_normal((5, 4, 3))
    assert np.array_equal(assemble._elasticity_stiffness_np(coords, order),
                          tpu_assemble._elasticity_stiffness_np(coords, order))
    mine = perm_element_matrices(structured.BoxTetMesh(3, 4, 5), order,
                                 "elasticity")
    ref = tpu_perm_element_matrices(tpu_structured.BoxTetMesh(3, 4, 5),
                                    order, "elasticity")
    assert mine.shape == (6, 3 * ReferenceTet(order).ndofs,
                          3 * ReferenceTet(order).ndofs)
    assert np.array_equal(mine, ref)


def test_elasticity_data_and_marker_equal_tpufem():
    pts = np.random.default_rng(7).random((50, 3))
    pts[::5, 1] = 0.0  # on the clamped face
    assert np.array_equal(common.elasticity_f(pts),
                          tpu_common.elasticity_f(pts))
    for a, b in zip(common.elasticity_f_components(*pts.T),
                    tpu_common.elasticity_f_components(*pts.T)):
        assert np.array_equal(a, b)
    assert np.array_equal(common.elasticity_bc_marker(pts),
                          tpu_common.elasticity_bc_marker(pts))


def test_near_nullspace_bitwise():
    coords = np.random.default_rng(8).random((40, 3))
    assert np.array_equal(nullspace.rigid_body_modes(coords),
                          tpu_nullspace.rigid_body_modes(coords))
    assert np.array_equal(nullspace.build_near_nullspace(coords),
                          tpu_nullspace.build_near_nullspace(coords))


@pytest.mark.parametrize("argv", [
    [],
    ["--problem_type", "cgpoisson", "--ndofs", "500000", "--order", "3",
     "--scaling_type", "strong", "-cg_kernel", "on", "-cg_rtol", "1e-6"],
    ["--dtype", "float64", "-ksp_rtol", "1e-8", "-pc_type", "gmg",
     "-ksp_max_it", "100", "-totally_bogus", "-1e-3"],
], ids=["defaults", "cgpoisson", "poisson"])
def test_parse_args_gives_tpufem_config(argv):
    cfg, device = cli.parse_args(argv + ["--device", "cpu"])
    assert device.type == "cpu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tpu_parse_args(argv))


def test_runs_with_tpufem_unimportable():
    """``sys.modules["tpufem"] = None`` makes any import of tpufem raise:
    the port's poisson, cgpoisson, cgpoisson -use_flat, elasticity (P1
    and P2) and -pc_type amg (la.bramg) CLI runs must not need it."""
    code = (
        "import sys\n"
        "sys.modules['tpufem'] = None\n"
        "import tpufem_torch.problems.cgpoisson as c\n"
        "c.TIMING_PASSES = c.TIMING_REPS = 1\n"
        "from tpufem_torch.cli import main\n"
        "a = main(['--ndofs', '3000', '--dtype', 'float64', '--device', 'cpu'])\n"
        "b = main(['--problem_type', 'cgpoisson', '--order', '2',"
        " '--ndofs', '3000', '--dtype', 'float32', '--device', 'cpu'])\n"
        "f = main(['--problem_type', 'cgpoisson', '--order', '2',"
        " '--ndofs', '6000', '-use_flat', '1', '--device', 'cpu'])\n"
        "e = main(['--problem_type', 'elasticity', '--ndofs', '3000',"
        " '--device', 'cpu'])\n"
        "e2 = main(['--problem_type', 'elasticity', '--order', '2',"
        " '--ndofs', '3000', '--device', 'cpu'])\n"
        "assert type(e2.problem.solver_function.A).__name__ =="
        " 'StructuredOperator' and e2.true_rel <= 1e-8\n"
        "g = main(['--ndofs', '3000', '-pc_type', 'amg', '--dtype',"
        " 'float64', '--device', 'cpu'])\n"
        "assert type(g.problem.solver_function.pc).__name__ == 'BrickAMG'\n"
        "assert g.iterations > 0 and g.true_rel <= 1e-8\n"
        "assert type(f.problem.solver_function.op).__name__ == 'FlatOperator'\n"
        "assert a.iterations > 0 and b.iterations > 0 and f.iterations > 0\n"
        "assert e.iterations > 0 and e.true_rel <= 1e-8\n"
        "print('JAX_LOADED', any(m == 'jax' or m.startswith('jax.')"
        " for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout


def test_saamg_runs_with_tpufem_unimportable():
    """The SA-AMG runs (-amg_brick off on the cube, la.amg; the spoke mesh
    with its native build) with ``tpufem`` unimportable."""
    code = (
        "import sys\n"
        "sys.modules['tpufem'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from tpufem_torch.cli import main\n"
        "s = main(['--ndofs', '3000', '-pc_type', 'amg', '-amg_brick', 'off',"
        " '--dtype', 'float64', '--device', 'cpu'])\n"
        "assert type(s.problem.solver_function.pc).__name__ == 'SAAMG'\n"
        "u = main(['--mesh_type', 'unstructured', '--ndofs', '3000',"
        " '--dtype', 'float64', '--device', 'cpu'])\n"
        "assert u.problem.solver_function.route == 'rcm'\n"
        "assert s.true_rel <= 1e-8 and u.true_rel <= 1e-8\n"
        "print('JAX_LOADED', any(m == 'jax' or m.startswith('jax.')"
        " for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout


def test_sharded_runs_with_tpufem_unimportable():
    """--num_shards (the slab path, the row-sharded spoke) with
    ``tpufem`` unimportable."""
    code = (
        "import sys\n"
        "sys.modules['tpufem'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from tpufem_torch.cli import main\n"
        "from tpufem_torch.problems import sharded\n"
        "sharded.TIMING_REPS = 0\n"
        "a = main(['--ndofs', '3000', '--num_shards', '2', '--dtype',"
        " 'float64', '--device', 'cpu'])\n"
        "assert type(a.problem.solver_function.sh).__name__ =="
        " 'ShardedCubeSolver'\n"
        "u = main(['--mesh_type', 'unstructured', '--ndofs', '1500',"
        " '--num_shards', '2', '--dtype', 'float64', '--device', 'cpu'])\n"
        "assert type(u.problem.solver_function.sh).__name__ =="
        " 'ShardedEllSolver'\n"
        "assert a.iterations > 0 and u.iterations > 0\n"
        "print('JAX_LOADED', any(m == 'jax' or m.startswith('jax.')"
        " for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout


def test_native_source_is_tpufem_byte_for_byte():
    """tpufem_torch/native/fastsetup.cpp is tpufem's source, and the
    library builds from it into a directory keyed by its hash."""
    mine = os.path.join(REPO, "tpufem_torch", "native", "fastsetup.cpp")
    ref = os.path.join(REPO, "tpufem", "native", "fastsetup.cpp")
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert native.have_native()
    assert native.library_path().exists()
    assert native.library_path().parent.parent.name == "native"


def test_spoke_constants_and_geometry_bitwise():
    for name in ("N_SPOKES", "R_INNER", "R_OUTER", "H_INNER", "H_OUTER",
                 "L_SPUR", "L0", "DTH", "TAPER"):
        assert getattr(spoke, name) == getattr(tpu_spoke, name), name
    for got, want in zip(spoke.build_spoke_geometry(),
                         tpu_spoke.build_spoke_geometry()):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_refinement_bitwise(route, monkeypatch):
    """uniform_refine equals tpufem's, and refine_marked_edges gives
    tpufem's bits on both of the port's routes (they are bit-identical,
    tpufem/native/__init__.py:196)."""
    verts, cells = spoke.build_spoke_geometry()
    v1, c1 = refine.uniform_refine(verts, cells)
    rv1, rc1 = tpu_refine.uniform_refine(verts, cells)
    assert np.array_equal(v1, rv1) and np.array_equal(c1, rc1)
    topo = spoke.TetTopology(v1, c1)
    marked = topo.edge_vertices(np.arange(0, topo.num_edges_global, 7))
    if route == "numpy":
        monkeypatch.setattr(native, "_get", lambda: None)
    got = refine.refine_marked_edges(v1, c1, marked)
    want = tpu_refine.refine_marked_edges(v1, c1, marked)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
