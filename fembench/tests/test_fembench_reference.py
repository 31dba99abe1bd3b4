"""The plain reference on tiny lattices on the CPU: its sizing, its
operator against a dense matrix assembled tetrahedron by tetrahedron,
its nonzero count, its CG and its TF32 rounding."""

import itertools

import numpy as np
import pytest
import torch

from fembench.reference import p1_cube

CPU = torch.device("cpu")


def dense_matrix(dims):
    """The Dirichlet-eliminated P1 stiffness matrix, assembled over every
    tetrahedron of every box from the vertices' coordinates."""
    Nx, Ny, Nz = dims
    n = (Nx + 1) * (Ny + 1) * (Nz + 1)
    gid = lambda x, y, z: (z * (Ny + 1) + y) * (Nx + 1) + x  # noqa: E731
    A = np.zeros((n, n))
    h = np.array([1.0 / Nx, 1.0 / Ny, 1.0 / Nz])
    for bx, by, bz in itertools.product(range(Nx), range(Ny), range(Nz)):
        for perm in itertools.permutations(range(3)):
            v = [np.array([bx, by, bz])]
            for axis in perm:
                v.append(v[-1] + np.eye(3, dtype=int)[axis])
            P = np.array(v) * h
            M = np.hstack([np.ones((4, 1)), P])        # rows [1, x, y, z]
            C = np.linalg.inv(M)                        # columns: lambda_i
            grads = C[1:].T                             # [4, 3]
            vol = abs(np.linalg.det(M)) / 6.0
            ids = [gid(*p) for p in v]
            A[np.ix_(ids, ids)] += vol * grads @ grads.T
    bc = [gid(x, y, z) for z in range(Nz + 1) for y in range(Ny + 1)
          for x in (0, Nx)]
    A[bc, :] = 0.0
    A[:, bc] = 0.0
    A[bc, bc] = 1.0
    return A


@pytest.mark.parametrize("dims", [(2, 3, 4), (3, 2, 2), (4, 4, 5)])
def test_operator_is_the_assembled_matrix(dims):
    A = dense_matrix(dims)
    op = p1_cube.CubeOperator(dims, CPU, block_layers=2)
    x = torch.randn(op.n, dtype=torch.float64, generator=torch.Generator()
                    .manual_seed(1))
    np.testing.assert_allclose(op.apply(x).numpy(), A @ x.numpy(),
                               rtol=0, atol=1e-13 * np.abs(A).max())
    assert p1_cube.nnz(dims) == np.count_nonzero(
        np.abs(A) > 1e-12 * np.abs(A).max())


@pytest.mark.parametrize("ndofs, dims", [
    (10_000_000, (208, 208, 224)),     # the cells' lattice, 9,828,225 dofs
    (2_000_000, (112, 128, 144)),
    (500_000, (64, 80, 96)),
    (20_000, (24, 24, 32)),
])
def test_lattice_sizing(ndofs, dims):
    assert p1_cube.lattice(ndofs) == dims


def test_cg_solves_and_stops_at_rtol():
    dims = (4, 4, 5)
    A = dense_matrix(dims)
    op = p1_cube.CubeOperator(dims, CPU)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(op.n))
    b.view(6, 5, 5)[..., 0] = 0
    b.view(6, 5, 5)[..., 4] = 0
    x, k, rel = p1_cube.cg(op.apply, b, 1000, 1e-12)
    assert rel <= 1e-12 and k < 1000
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b.numpy()),
                               rtol=0, atol=1e-9 * np.abs(x.numpy()).max())
    x3, k3, _ = p1_cube.cg(op.apply, b, 3)
    assert k3 == 3


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-12, -3.0e-5, 0.0])
    r = p1_cube.to_tf32(x)
    assert r.tolist()[:5] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0]
    assert r[6] == 0.0
    assert abs(float(r[5]) / -3.0e-5 - 1) <= 2**-11
    m = r.view(torch.int32) & 0x1FFF
    assert not m.any()
