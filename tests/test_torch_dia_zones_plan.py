"""The multi-kind zone kernel's plan (csrc/dia_zones.cu), walked in plain
PyTorch by ``fem.dia_zones.dia_zones_walk`` on the CPU: its blocks of 256
points of each output grid's flattened (z, y, x) index, each point's sum
over the terms in plan order with the product and the sum rounded apart,
the zone row or full field of its weights and the zeros outside every
source grid, against the plain version (``dia_zones_apply_plain``, which
tests/test_torch_pk.py holds to tpufem), bit for bit.  Lattices: P2 and
P3, with and without Dirichlet rows, grids of 7 planes (a mid zone of one
plane) and of 6 (full fields beside zone fields), dense-mode operators
(full fields only), and planes whose points end in a partial block."""

import numpy as np
import pytest
import torch

from tpufem_torch.fem import dia_zones
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.dia_zones import dia_zones_apply_plain, dia_zones_walk
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems.common import poisson_bc_marker

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (order, cells, Dirichlet rows, mode, dtype)
CASES = {
    "P2-bc-ragged": (2, (12, 11, 8), True, "const", torch.float64),
    "P2-nobc-long-z": (2, (6, 7, 18), False, "const", torch.float32),
    "P3-bc": (3, (6, 6, 9), True, "const", torch.float64),
    "P3-bc-float32": (3, (6, 7, 8), True, "const", torch.float32),
    "P3-nobc-seven-and-six-planes": (3, (7, 6, 6), False, "const",
                                     torch.float64),
    "P2-bc-seven-and-six-planes": (2, (7, 6, 6), True, "const",
                                   torch.float32),
    "P2-dense": (2, (5, 4, 3), True, "dense", torch.float64),
    "P2-dense-nobc": (2, (4, 5, 3), False, "dense", torch.float32),
    "P3-dense": (3, (3, 4, 5), True, "dense", torch.float32),
}


def _pack(order, cells, bc, mode, dtype):
    mesh = BoxTetMesh(*cells)
    dofs = (DirichletBC.from_space(
        FunctionSpace(mesh, order),
        mesh.locate_boundary_facets(poisson_bc_marker)).flat_dofs()
        if bc else None)
    if mode == "dense":
        op = DiaOperator.build(mesh, order, "poisson", bc_dofs=dofs,
                               dtype=dtype, mode="dense", device=CPU)
    else:
        op = DiaOperator.try_const(mesh, order, "poisson", bc_dofs=dofs,
                                   dtype=dtype, device=CPU)
    assert op is not None and op.multi_kind
    return op.zone_pack


@pytest.mark.parametrize("name", list(CASES))
def test_dia_zones_walk_gives_the_plain_versions_bits(name):
    order, cells, bc, mode, dtype = CASES[name]
    pack = _pack(order, cells, bc, mode, dtype)
    rng = np.random.default_rng(order * 100 + len(name))
    x = torch.from_numpy(rng.standard_normal(pack.ndofs)).to(dtype)
    y, n = dia_zones_walk(x, pack)
    assert torch.equal(y, dia_zones_apply_plain(x, pack))  # no NaN left
    assert n["twice"] == 0
    points = [int(X * Y * Z) for _, X, Y, Z, _ in pack.kinds]
    assert n["blocks"] == sum(-(-pts // dia_zones._THREADS)
                              for pts in (points[int(o[0])]
                                          for o in pack.outputs))
    zoned = pack.terms[:, 6].astype(bool)
    if mode == "dense":
        assert not zoned.any()
    else:
        assert zoned.any()
    if "six-planes" in name:  # grids of 6 planes: full fields
        assert not zoned.all()
    if "ragged" in name:  # an output grid ends inside a block
        assert any(pts % dia_zones._THREADS for pts in points)
