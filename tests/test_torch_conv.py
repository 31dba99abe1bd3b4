"""The port's channel-convolution operator (tpufem_torch.fem.conv_op)
against tpufem's ConvStencilOp on the CPU, and ``cgpoisson -use_conv 1``
end to end.

In float64: the kernels ``from_dia`` extracts are the same numbers as
tpufem's (the same numpy arithmetic); the applies match tpufem's and the
port's own DiaOperator within 1e-12 of max|ref| (the dims and orders of
tests/test_dia_op.py's conv test, bake on and off); the channel-resident
round trip, the form a CG loop runs, matches the flat apply.  The
operator on the card is checked by tests/test_torch_cuda.py and
chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.conv_op import ConvStencilOp as TpuConv
from tpufem.fem.dia_op import DiaOperator as TpuDia
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.fem.space import FunctionSpace as TpuSpace
from tpufem.mesh.structured import BoxTetMesh as TpuMesh
from tpufem.problems import common as tpu_common

from tpufem_torch import cli
from tpufem_torch.fem.conv_op import ConvStencilOp
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import cgpoisson

torch.set_num_threads(1)
CPU = torch.device("cpu")
# tests/test_dia_op.py:230-232
CASES = [(2, (8, 9, 10)), (3, (8, 9, 10)), (2, (6, 6, 6)), (3, (6, 7, 6)),
         (1, (8, 9, 10))]
IDS = ["P2-8x9x10", "P3-8x9x10", "P2-6x6x6", "P3-6x7x6", "P1-8x9x10"]
TOL = 1e-12
# tpufem's -use_conv 1 loop at P2 6,069 dofs (8x8x10), float64, from
#   python scripts/cgpoisson_reference.py --order 2 --ndofs 6000 \
#       --scaling_type weak --dtype float64 --conv [--kmax 60 --rtol 0]
# (kmax, rtol) -> (iterations, rel, norm).  60 fixed steps: the conv form's
# own trajectory (tpufem's strip form of the same matrix ends 60 steps at
# rel 4.82e-4, norm 16.571713816670666, 2.3e-8 away).  To rtol 1e-6 the
# stop falls where the recurrence crosses 1e-6 within rounding: tpufem's
# conv loop is at rel 1.12e-6 after step 94 and stops at 95, its strip
# loop stops at 94 (9.17e-7), and the port's conv loop sits at 9.996e-7
# after step 94; so there the iterations are held within one.
CONV_P2_ARGS = ["--problem_type", "cgpoisson", "--order", "2", "--ndofs",
                "6000", "--dtype", "float64", "--device", "cpu",
                "-use_conv", "1"]
CONV_P2_REF = {(60, 0.0): (60, 0.0005379028744032867, 16.571713427813453),
               (100, 1e-6): (95, 8.96897026954723e-07, 16.57171572447316)}
CONV_P2_DOFS = 6069
# the recurrence rel of the fixed-step run moves by ~cond(A) times the
# rounding of x: the port's sits 5.3e-7 off tpufem's
CONV_REL_TOL = 1e-5

# one compile for every operator of a shape (bake on and off alike)
_tpu_rows_zero = jax.jit(lambda o, v: o.apply_bc_rows_zero(v))


@pytest.fixture
def one_timed_solve(monkeypatch):
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


@functools.lru_cache(maxsize=None)
def _ops(order, dims, bake):
    """(tpufem's conv operator, the port's, the port's const DIA, ndofs),
    float64, built once for both tests of a case."""
    tdia, pdia, n = _dias(order, dims, bake)
    return (TpuConv.from_dia(tdia, dtype=jnp.float64),
            ConvStencilOp.from_dia(pdia, dtype=torch.float64, device=CPU),
            pdia, n)


def _dias(order, dims, bake):
    """(tpufem const DIA, port const DIA, ndofs), float64 tables."""
    mesh = TpuMesh(*dims)
    space = TpuSpace(mesh, order)
    bc = TpuBC.from_space(
        space, mesh.locate_boundary_facets(tpu_common.poisson_bc_marker))
    tdia = TpuDia.try_const(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                            dtype=jnp.float64, bake_bc=bake, device=False)
    pdia = DiaOperator.try_const(BoxTetMesh(*dims), order, "poisson",
                                 bc_dofs=bc.flat_dofs(), dtype=torch.float64,
                                 bake_bc=bake)
    assert tdia is not None and pdia is not None
    return tdia, pdia, space.ndofs


def _x(n):
    return np.random.default_rng(1).standard_normal(n)


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "rows_zero"])
@pytest.mark.parametrize("order,dims", CASES, ids=IDS)
def test_conv_matches_tpufem(order, dims, bake):
    """The kernels and masks are tpufem's numbers, in tpufem's layout
    (the bulk kernel permuted to conv3d's [co, ci, kz, ky, kx]); the
    rows-zero apply is tpufem's within 1e-12."""
    tpu, op, _, n = _ops(order, dims, bake)
    assert op.gdims == tpu.gdims
    assert np.array_equal(op.weight.numpy(),
                          np.asarray(tpu.Kc).transpose(4, 3, 0, 1, 2))
    for mine, theirs in ((op.Kfaces, tpu.Kfaces), (op.Kedges, tpu.Kedges),
                         (op.Kcorners, tpu.Kcorners)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(op.chan_mask.numpy(), np.asarray(tpu.chan_mask))
    assert np.array_equal(op.bc_mask.numpy(), np.asarray(tpu.bc_mask))
    x = _x(n)
    ref = np.asarray(_tpu_rows_zero(tpu, jnp.asarray(x)))
    got = op.apply_bc_rows_zero(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() < TOL * np.abs(ref).max()


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "rows_zero"])
@pytest.mark.parametrize("order,dims", CASES, ids=IDS)
def test_conv_matches_port_dia(order, dims, bake):
    """The same matrix as the port's DiaOperator (its CPU plain
    versions), flat and, for the baked operator, channel-resident: the
    padded tensor in and out, the phantoms and the ring zero again after
    the apply, and the layout's round trip exact."""
    _, op, pdia, n = _ops(order, dims, bake)
    dia = pdia._finalize(CPU)
    x = torch.from_numpy(_x(n))
    if bake:
        ref, got = dia.apply(x), op.apply(x)
    else:
        ref, got = dia.apply_bc_rows_zero(x), op.apply_bc_rows_zero(x)
    s = float(ref.abs().max())
    assert float((got - ref).abs().max()) < TOL * s
    if bake:
        xp = op.to_channels_padded(x)
        assert torch.equal(op.from_channels_padded(xp), x)
        yp = op.apply_channels(xp)
        assert yp.shape == xp.shape
        inner = yp[1:-1, 1:-1, 1:-1] * (1 - op.chan_mask)
        ring = yp.clone()
        ring[1:-1, 1:-1, 1:-1] = 0
        assert not inner.any() and not ring.any()
        rt = op.from_channels_padded(yp)
        assert float((rt - ref).abs().max()) < TOL * s
        # dots over the padded tensor are dots over the dofs
        assert abs(float((yp * xp).sum()) - float(ref @ x)) < TOL * s * n


def _refused(kind):
    """A DiaOperator (tpufem's, the port's) that the conv form refuses: a
    dense-mode P1 lattice, or the bs = 3 operator."""
    problem, dims = (("poisson", (4, 4, 5)) if kind == "dense"
                     else ("elasticity", (6, 6, 7)))
    return (TpuDia.build(TpuMesh(*dims), 1, problem, dtype=jnp.float64,
                         device=False),
            DiaOperator.build(BoxTetMesh(*dims), 1, problem,
                              dtype=torch.float64))


@pytest.mark.parametrize("kind", ["dense", "bs3"])
def test_from_dia_raises_where_tpufem_does(kind):
    tdia, pdia = _refused(kind)
    with pytest.raises(ValueError) as theirs:
        TpuConv.from_dia(tdia, dtype=jnp.float64)
    with pytest.raises(ValueError) as mine:
        ConvStencilOp.from_dia(pdia, dtype=torch.float64)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("kmax,rtol", list(CONV_P2_REF),
                         ids=["60_steps", "rtol_1e-6"])
def test_use_conv_cli_matches_tpufem(one_timed_solve, kmax, rtol):
    """``-use_conv 1`` at P2 (float64): the conv operator, not the strip
    one, solved channel-resident, at tpufem's iterations (within one where
    the stop is at rtol, see CONV_P2_REF) and norm to 1e-9."""
    its, rel, norm = CONV_P2_REF[(kmax, rtol)]
    res = cli.main(CONV_P2_ARGS + ["-cg_kmax", str(kmax), "-cg_rtol",
                                   str(rtol)])
    solver = res.problem.solver_function
    assert isinstance(solver.op, ConvStencilOp) and solver.channels
    assert res.problem.space.ndofs == CONV_P2_DOFS
    assert abs(res.norm - norm) <= 1e-9 * norm
    if rtol:
        assert abs(res.iterations - its) <= 1 and solver.rel <= rtol
    else:
        assert res.iterations == its
        assert abs(solver.rel - rel) <= CONV_REL_TOL * rel


@pytest.mark.parametrize("flag", ["-use_flat", "-use_strip"])
def test_use_conv_takes_precedence(one_timed_solve, flag):
    """tpufem's order (tpufem/problems/cgpoisson.py:131-176): the conv
    form is taken first, and the flat and strip forms, which need a
    DiaOperator, no longer apply."""
    res = cli.main(["--problem_type", "cgpoisson", "--order", "2", "--ndofs",
                    "3000", "--dtype", "float64", "--device", "cpu",
                    "-use_conv", "1", flag, "1", "-cg_kmax", "5"])
    assert isinstance(res.problem.solver_function.op, ConvStencilOp)
    assert res.iterations == 5
