"""``--output``: the port's XDMF/HDF5 writer (tpufem_torch.io) against
tpufem's, file for file, its round trips (tests/test_xdmf.py's, on the
port's copy), and the CLI's files on every path at 3,000 dofs, float64:
the values are the run's solution in tpufem's dof order and
node-interleaved layout, bit for bit, and for one case of each layout
(elasticity, the strip form of cgpoisson P2, the slabs, the row shards)
within the path's parity tolerance of tpufem's own file (cgpoisson P2
live, the others pinned by ``scripts/xdmf_reference.py``)."""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

import jax  # noqa: E402

from tpufem import native as tpu_native  # noqa: E402
from tpufem.cli import parse_args as tpu_parse_args  # noqa: E402
from tpufem.fem.space import FunctionSpace as TpuSpace  # noqa: E402
from tpufem.io import write_xdmf as tpu_write_xdmf  # noqa: E402
from tpufem.mesh import BoxTetMesh as TpuMesh  # noqa: E402
from tpufem.mesh.spoke import \
    create_spoke_mesh as tpu_create_spoke_mesh  # noqa: E402
from tpufem.problems import cgpoisson as tpu_cgpoisson  # noqa: E402

from tpufem_torch import cli, native  # noqa: E402
from tpufem_torch.fem.space import FunctionSpace  # noqa: E402
from tpufem_torch.fem.strip_op import StripOperator  # noqa: E402
from tpufem_torch.io import read_xdmf, write_xdmf  # noqa: E402
from tpufem_torch.mesh.spoke import create_spoke_mesh  # noqa: E402
from tpufem_torch.mesh.structured import BoxTetMesh  # noqa: E402
from tpufem_torch.problems import cgpoisson, sharded  # noqa: E402

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_timed_solve(monkeypatch):
    """The timing loops cut to the one solve (the values are the same)."""
    monkeypatch.setattr(sharded, "TIMING_REPS", 0)
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


def _same_native(monkeypatch):
    """tpufem's loader on the port's library of the same pinned source
    (tests/test_torch_vendored.py): one refinement route in both."""
    monkeypatch.setattr(tpu_native, "_get", native._get)


def h5_contents(path: str):
    """({dataset path: array}, {attribute: value}) of an HDF5 file."""
    data = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: data.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
        attrs = {k: f.attrs[k] for k in f.attrs}
    return data, attrs


def assert_same_bits(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# (mesh, order, bs): the cube lattice, or ("spoke", ndofs)
WRITER_CASES = {
    "cube-P1": ((3, 4, 5), 1, 1),
    "cube-P2": ((3, 3, 4), 2, 1),
    "cube-P3": ((2, 3, 3), 3, 1),
    "elasticity-P1": ((3, 4, 5), 1, 3),
    "spoke-P1": (("spoke", 1500), 1, 1),
    "spoke-P2": (("spoke", 1500), 2, 1),
}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_writer_matches_tpufem(case, tmp_path, monkeypatch):
    """The same mesh, space and u through both writers: every dataset and
    attribute the same bits, and the .xdmf text identical."""
    where, order, bs = WRITER_CASES[case]
    if where[0] == "spoke":
        _same_native(monkeypatch)
        mesh = create_spoke_mesh(where[1], False, 1, 1, verbose=False)
        tmesh = tpu_create_spoke_mesh(where[1], False, 1, 1, verbose=False)
    else:
        mesh, tmesh = BoxTetMesh(*where), TpuMesh(*where)
    space, tspace = FunctionSpace(mesh, order, bs=bs), \
        TpuSpace(tmesh, order, bs=bs)
    u = np.random.default_rng(len(case)).standard_normal(space.ndofs)
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    mine.mkdir()
    ref.mkdir()
    write_xdmf(str(mine / "u.xdmf"), mesh, u, bs=bs, space=space)
    tpu_write_xdmf(str(ref / "u.xdmf"), tmesh, u, bs=bs, space=tspace)
    got, got_attrs = h5_contents(str(mine / "u.h5"))
    want, want_attrs = h5_contents(str(ref / "u.h5"))
    assert sorted(got) == sorted(want)
    assert ("function/dofs" in got) == (order >= 2)
    for name in want:
        assert_same_bits(got[name], want[name], name)
    assert got_attrs.keys() == want_attrs.keys()
    for k, v in want_attrs.items():
        assert got_attrs[k] == v and type(got_attrs[k]) is type(v), k
    assert (mine / "u.xdmf").read_text() == (ref / "u.xdmf").read_text()


@pytest.mark.parametrize("order", [1, 2, 3])
def test_roundtrip_scalar(order, tmp_path):
    """tests/test_xdmf.py's scalar round trip on the port's copy."""
    mesh = BoxTetMesh(3, 3, 3)
    space = FunctionSpace(mesh, order)
    f = lambda x: 1.0 + 2.0 * x[:, 0] - 0.5 * x[:, 1] + 0.25 * x[:, 2]
    u = space.interpolate(f)
    fn = str(tmp_path / "sol.xdmf")
    write_xdmf(fn, mesh, u, bs=1, space=space)

    got = read_xdmf(fn)
    np.testing.assert_array_equal(got["topology"], mesh.cells())
    nv = mesh.num_vertices_global
    np.testing.assert_allclose(
        got["geometry"], mesh.vertex_coords(np.arange(nv)), rtol=0, atol=0)
    assert got["order"] == order and got["bs"] == 1
    np.testing.assert_allclose(got["values"][:, 0], u[:nv], rtol=0, atol=0)
    if order >= 2:
        np.testing.assert_allclose(got["dofs"][:, 0], u, rtol=0, atol=0)
        np.testing.assert_allclose(got["dof_coords"],
                                   space.scalar_dof_coords())
        np.testing.assert_array_equal(got["cell_dofs"], space.cell_dofs)
        np.testing.assert_allclose(got["dofs"][:, 0], f(got["dof_coords"]),
                                   rtol=1e-12, atol=1e-12)
    else:
        assert "dofs" not in got


def test_roundtrip_vector(tmp_path):
    """tests/test_xdmf.py's vector round trip on the port's copy."""
    mesh = BoxTetMesh(2, 2, 2)
    space = FunctionSpace(mesh, 1, bs=3)
    nv = mesh.num_vertices_global
    u = np.arange(3 * space.ndofs_scalar, dtype=np.float64)
    fn = str(tmp_path / "vec.xdmf")
    write_xdmf(fn, mesh, u, bs=3, space=space)
    got = read_xdmf(fn)
    assert got["values"].shape == (nv, 3)
    np.testing.assert_allclose(got["values"], u.reshape(-1, 3)[:nv])
    assert 'AttributeType="Vector"' in open(fn).read()


def test_missing_h5py_raises_naming_the_flag(tmp_path, monkeypatch):
    """Without h5py the writer raises ImportError naming h5py and
    --output, and writes nothing."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    mesh = BoxTetMesh(2, 2, 2)
    with pytest.raises(ImportError, match=r"--output.*h5py"):
        write_xdmf(str(tmp_path / "u.xdmf"), mesh,
                   np.zeros(mesh.num_vertices_global))
    assert not os.listdir(tmp_path)


def test_cli_without_h5py_raises_before_the_run(tmp_path, monkeypatch):
    """--output without h5py raises its ImportError before the mesh is
    built, and makes no directory."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(cli, "BoxTetMesh", None)  # the run must not start
    out = tmp_path / "out"
    with pytest.raises(ImportError, match=r"--output.*h5py"):
        cli.main(["--ndofs", "3000", "--device", "cpu", "--output",
                  str(out)])
    assert not out.exists()


def _tpu_cgpoisson(argv, dims):
    cfg = tpu_parse_args(argv)
    ref = tpu_cgpoisson.problem(TpuMesh(*dims), 2, cfg)
    return ref.solver_function(ref.u, ref.b)[0], ref.space


# tpufem's own --output files, python scripts/xdmf_reference.py:
# (iterations, vertices, cells, norm of the values, the flattened values
# at 11 evenly spaced places, SHA-256 of the topology and the geometry)
TPUFEM_FILES = {
    "elasticity": (15, 1053, 4608, 1.1781546749807176e-05,
                   [0.0, 2.9121471718885268e-08, 3.947816735943446e-07,
                    -2.1097972945843458e-07, -3.870092547474062e-08,
                    3.439512437941409e-07, 4.5485998268046834e-07, 0.0,
                    -9.333125734189645e-08, 4.343623941531696e-07,
                    2.1514294107963484e-07],
                   "e36aa2ca2adfd29446bb5e74f3c2f779091b8af4adc50e292eaade660a03c147",
                   "c19d8b9e4b50311f9fe5963e3512f33bd28a3cb3f7bb89d09bf9897bba76ad82"),
    "slab": (9, 6069, 30720, 16.411472776307928,
             [0.0, 0.11361145630887517, 0.3042942995432637,
              0.060740368800532206, 0.10305774448919709, 0.3039602003221896,
              0.10788521201219053, 0.058155709855676634, 0.2436915513383822,
              0.35397388123009926, 0.0],
             "d3edea3cc6abd88a3d97bf9b7653b45b7ded8d0374365ebaed6feb063edb3c21",
             "c1adb1dc67424b26270c20d6d7405f7d9cad056269528de71eba1bc436301aa7"),
    "rowshard-spoke": (40, 5997, 21569, 403.5983447629191,
                       [3.9202774992447393, 0.3340194453292721,
                        -5.3426226584466665, 3.7896953114374057,
                        -9.939801879246373, -5.298940372842174,
                        5.037800574213594, 6.008961874073747,
                        6.380093435386069, -1.112106784989396,
                        7.148680444678355],
                       "8158fb4ad0411f0c5801ee02ce6e85d7f2ad6207d4d04f56f510a6fa2f9c9863",
                       "30ad4a82a4c15ea11d5aaa1d2cae014e1d28e60ee391a9bb3d2c3e195f78b019"),
}

# argv -> (tpufem's file: a live run, a pinned file or None; the path's
# parity tolerance: max |mine - tpufem's| over max |x|, and the norm).
# Elasticity: tests/test_torch_elasticity_slice.py holds the norms to
# 1e-10; cgpoisson P2 and the sharded paths to 1e-9
# (test_torch_cgpoisson.py, test_torch_slab.py, test_torch_rowshard.py).
CLI_CASES = {
    "poisson-P1": ("--ndofs 3000", None, None),
    "poisson-P2": ("--ndofs 3000 --order 2", None, None),
    "elasticity-P1": ("--problem_type elasticity --ndofs 3000",
                      "elasticity", 1e-10),
    "cgpoisson-P1": ("--problem_type cgpoisson --ndofs 3000", None, None),
    "cgpoisson-P2-strip": ("--problem_type cgpoisson --order 2 --ndofs 3000",
                           _tpu_cgpoisson, 1e-9),
    "spoke-poisson-P1": ("--mesh_type unstructured --ndofs 3000", None,
                         None),
    "spoke-cgpoisson-P2": ("--problem_type cgpoisson --mesh_type "
                           "unstructured --order 2 --ndofs 3000 -cg_kmax 30",
                           None, None),
    "slab": ("--ndofs 3000 --num_shards 2", "slab", 1e-9),
    "rowshard-spoke": ("--mesh_type unstructured --ndofs 3000 --num_shards 2 "
                       "-ksp_max_it 40", "rowshard-spoke", 1e-9),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_output(case, tmp_path, monkeypatch):
    """``--output DIR`` writes DIR/solution-<num_shards>.xdmf: topology
    and geometry the mesh's, the values and (order >= 2) the dofs the
    run's returned x, bit for bit, reshaped (-1, bs) as tpufem writes its
    x; for one case of each layout, tpufem's own file within the path's
    tolerance."""
    _same_native(monkeypatch)
    args, ref, tol = CLI_CASES[case]
    argv = args.split() + ["--dtype", "float64"]
    out = tmp_path / "out"
    res = cli.main(argv + ["--device", "cpu", "--output", str(out)])
    space, mesh = res.problem.space, res.problem.space.mesh
    shards = 2 if "--num_shards" in args else 1
    fn = out / f"solution-{shards}.xdmf"
    got = read_xdmf(str(fn))
    data, _ = h5_contents(str(out / f"solution-{shards}.h5"))
    x = res.x.numpy()
    nv, bs = mesh.num_vertices_global, space.bs
    assert x.shape == (space.ndofs,)
    assert got["order"] == space.order and got["bs"] == bs
    assert_same_bits(got["topology"], np.asarray(mesh.cells(), np.int64),
                     "topology")
    assert_same_bits(got["geometry"], mesh.vertex_coords(np.arange(nv)),
                     "geometry")
    assert_same_bits(got["values"], x.reshape(-1, bs)[:nv], "values")
    if space.order >= 2:
        assert_same_bits(got["dofs"], x.reshape(-1, bs), "dofs")
        assert_same_bits(data["function/cell_dofs"],
                         np.asarray(space.cell_dofs, np.int64), "cell_dofs")
    else:
        assert "dofs" not in got
    if case == "cgpoisson-P2-strip":
        assert isinstance(res.problem.solver_function.op, StripOperator)
    if shards > 1:
        assert type(res.problem.solver_function.sh).__name__ == (
            "ShardedCubeSolver" if case == "slab" else "ShardedEllSolver")
    if ref is None:
        return
    v = got["values"].reshape(-1)
    if callable(ref):
        dims = (mesh.Nx, mesh.Ny, mesh.Nz)
        x_ref, tspace = ref(argv, dims)
        tdir = tmp_path / "tpufem"
        tdir.mkdir()
        tpu_write_xdmf(str(tdir / "u.xdmf"), TpuMesh(*dims),
                       np.asarray(x_ref), bs=bs, space=tspace)
        want = read_xdmf(str(tdir / "u.xdmf"))
        for key in ("topology", "geometry"):
            assert_same_bits(got[key], want[key], key)
        assert sorted(got) == sorted(want)
        w = want["values"].reshape(-1)
        assert np.abs(v - w).max() <= tol * np.abs(w).max()
        if "dofs" in want:
            assert np.abs(got["dofs"] - want["dofs"]).max() <= \
                tol * np.abs(want["dofs"]).max()
            assert_same_bits(got["dof_coords"], want["dof_coords"],
                             "dof_coords")
        return
    it, nverts, ncells, norm, samples, topo, geom = TPUFEM_FILES[ref]
    assert res.iterations == it
    assert got["geometry"].shape[0] == nverts
    assert got["topology"].shape[0] == ncells
    assert _digest(got["topology"]) == topo
    assert _digest(got["geometry"]) == geom
    assert abs(float(np.linalg.norm(v)) - norm) <= tol * norm
    idx = np.linspace(0, v.shape[0] - 1, len(samples)).astype(np.int64)
    assert np.abs(v[idx] - np.asarray(samples)).max() <= \
        tol * np.abs(v).max()


def test_output_across_processes_raises(tmp_path, monkeypatch):
    """A run whose process group has two ranks: the solve runs (here one
    process holds both shards), and the output step raises naming
    --output before it writes anything."""
    monkeypatch.setattr(cli, "init_from_env", lambda device: (0, 2))
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=r"--output across 2 processes"):
        cli.main(["--ndofs", "3000", "--num_shards", "2", "--dtype",
                  "float64", "--device", "cpu", "--output", str(out)])
    assert not out.exists()
