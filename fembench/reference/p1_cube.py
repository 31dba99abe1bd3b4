"""Plain reference of the P1 Poisson system on the Kuhn cube lattice.

Written from the finite-element definition alone, in plain numpy and
torch: the unit cube cut into Nx x Ny x Nz boxes, each box into the six
tetrahedra of the monotone lattice paths from its corner (0,0,0) to its
corner (1,1,1), P1 Lagrange functions at the lattice vertices (numbered
x fastest, then y, then z), the stiffness form  a(u, v) = int grad u .
grad v  and Dirichlet planes x = 0 and x = 1, eliminated (zero rows and
columns, unit diagonal).

Every box has the same six tetrahedra, so the matrix is the sum over
boxes of one 8 x 8 box matrix; ``CubeOperator.apply`` gathers the eight
corners of every box, multiplies by that matrix and adds the products
back, a block of z-layers at a time.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch


def lattice(ndofs: int, levels: int = 4) -> Tuple[int, int, int]:
    """(Nx, Ny, Nz) boxes of the strong-scaling lattice for ``ndofs``
    P1 dofs, sized for a multigrid of ``levels`` coarsenings: every
    dimension a multiple of m = 2**levels, Nx <= Ny <= Nz <= Nx + 2m,
    Nx / m within two of a0, the nearest whole number to s / m (s the
    cube edge that first reaches ``ndofs`` vertices), and the vertex
    count nearest ``ndofs`` (the first such triple in that order wins a
    tie).  Where a0 < 3 the lattice is too small for so many levels, and
    it is sized for one fewer."""
    s = 1
    while (s + 1) ** 3 < ndofs:
        s += 1
    while True:
        m = 1 << levels
        a0 = max(2, round(s / m))
        if a0 >= 3 or levels == 1:
            break
        levels -= 1
    best = None
    for a in range(max(a0 - 2, 2), a0 + 3):
        for b in range(a, a + 3):
            for c in range(b, min(b + 3, a + 3)):
                nv = (a * m + 1) * (b * m + 1) * (c * m + 1)
                if best is None or abs(nv - ndofs) < best[0]:
                    best = (abs(nv - ndofs), (a * m, b * m, c * m))
    return best[1]


def box_matrix(dims: Tuple[int, int, int]) -> np.ndarray:
    """The 8 x 8 stiffness matrix of one box, float64; corner
    dx + 2 dy + 4 dz sits at offset (dx, dy, dz)."""
    h = 1.0 / np.asarray(dims, dtype=np.float64)
    K = np.zeros((8, 8))
    eye = np.eye(3, dtype=np.int64)
    for perm in itertools.permutations(range(3)):
        corners = [np.zeros(3, dtype=np.int64)]
        for axis in perm:
            corners.append(corners[-1] + eye[axis])
        P = np.array(corners, dtype=np.float64) * h
        J = (P[1:] - P[0]).T                   # columns: the three edges
        Jinv = np.linalg.inv(J)                 # rows: grad of lambda_1..3
        G = np.vstack([-Jinv.sum(axis=0), Jinv])
        vol = abs(np.linalg.det(J)) / 6.0
        idx = [int(c[0] + 2 * c[1] + 4 * c[2]) for c in corners]
        K[np.ix_(idx, idx)] += vol * (G @ G.T)
    return K


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 stored mantissa bits, to the
    nearest (ties to even): what a TF32 matrix product reads."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


class CubeOperator:
    """The Dirichlet-eliminated stiffness matrix of a lattice, applied to
    flat vectors of its vertices.  ``dtype`` float64 is the reference;
    ``tf32=True`` (float32) is the lower-precision control, with both
    operands of the box product rounded to TF32 and float32 sums."""

    def __init__(self, dims: Tuple[int, int, int], device: torch.device,
                 dtype: torch.dtype = torch.float64, tf32: bool = False,
                 block_layers: int = 32) -> None:
        if tf32 and dtype != torch.float32:
            raise ValueError("the TF32 control computes in float32")
        self.dims = tuple(int(d) for d in dims)
        self.dtype, self.device, self.tf32 = dtype, device, tf32
        self.block_layers = block_layers
        K = torch.from_numpy(box_matrix(self.dims)).to(dtype)
        self.K = (to_tf32(K) if tf32 else K).to(device)
        Nx, Ny, Nz = self.dims
        self.shape = (Nz + 1, Ny + 1, Nx + 1)
        self.n = (Nx + 1) * (Ny + 1) * (Nz + 1)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        Nx, Ny, Nz = self.dims
        xg = x.to(self.dtype).reshape(self.shape)
        xm = xg.clone()
        xm[:, :, 0] = 0.0
        xm[:, :, Nx] = 0.0
        y = torch.zeros_like(xm)
        for z0 in range(0, Nz, self.block_layers):
            z1 = min(z0 + self.block_layers, Nz)
            X = torch.stack([xm[z0 + dz:z1 + dz, dy:dy + Ny, dx:dx + Nx]
                             .reshape(-1)
                             for dz in (0, 1) for dy in (0, 1)
                             for dx in (0, 1)])
            if self.tf32:
                X = to_tf32(X)
            Y = self.K @ X
            c = 0
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        y[z0 + dz:z1 + dz, dy:dy + Ny, dx:dx + Nx] += \
                            Y[c].reshape(z1 - z0, Ny, Nx)
                        c += 1
        y[:, :, 0] = xg[:, :, 0]
        y[:, :, Nx] = xg[:, :, Nx]
        return y.reshape(-1)


def rhs_pool(seed: int, count: int, dims: Tuple[int, int, int],
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[count, vertices] right-hand sides, standard normal entries from
    the seed, drawn on the device in one call, zero on the Dirichlet
    planes x = 0 and x = 1 of the lattice ``dims`` = (Nx, Ny, Nz)."""
    Nx, Ny, Nz = dims
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pool = torch.randn((count, (Nz + 1) * (Ny + 1) * (Nx + 1)), generator=g,
                       dtype=dtype, device=device)
    grid = pool.view(count, Nz + 1, Ny + 1, Nx + 1)
    grid[..., 0] = 0.0
    grid[..., Nx] = 0.0
    return pool


def apply_work(dims: Tuple[int, int, int], itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) that any application of the lattice's matrix
    has to do: x read once and y written once, ``itemsize`` bytes an
    entry, and a multiply and an add for each entry of the matrix that
    is not zero."""
    Nx, Ny, Nz = dims
    return 2 * itemsize * (Nx + 1) * (Ny + 1) * (Nz + 1), 2 * nnz(dims)


def nnz(dims: Tuple[int, int, int]) -> int:
    """Entries of the lattice's matrix that are not zero: the Dirichlet
    rows' unit diagonals, and each coupling of two free vertices whose
    sum over the boxes holding both is not zero."""
    K = box_matrix(dims)
    tol = 1e-12 * np.abs(K).max()

    def classes(N: int, o: int, free: bool):
        """[(vertices, [(corner bit of the row, of the column), one pair
        per box holding both])] along one axis of N boxes, for a column
        ``o`` vertices on; ``free``: rows and columns on 1..N-1 only
        (the Dirichlet axis)."""
        if o:
            n = N - 2 if free else N
            return [(n, [(0, 1)] if o > 0 else [(1, 0)])]
        if free:
            return [(N - 1, [(0, 0), (1, 1)])]
        return [(1, [(0, 0)]), (1, [(1, 1)]), (N - 1, [(0, 0), (1, 1)])]

    Nx, Ny, Nz = dims
    total = 2 * (Ny + 1) * (Nz + 1)        # Dirichlet rows
    for o in itertools.product((-1, 0, 1), repeat=3):
        axes = [classes(Nx, o[0], True), classes(Ny, o[1], False),
                classes(Nz, o[2], False)]
        for combo in itertools.product(*axes):
            v = sum(K[ax + 2 * ay + 4 * az, bx + 2 * by + 4 * bz]
                    for (ax, bx), (ay, by), (az, bz)
                    in itertools.product(*(c[1] for c in combo)))
            if abs(v) > tol:
                total += combo[0][0] * combo[1][0] * combo[2][0]
    return int(total)


def cg(apply, b: torch.Tensor, steps: int, rtol: float = 0.0):
    """Conjugate gradients from x = 0 in ``b``'s dtype: at most ``steps``
    steps, stopping once ||r|| <= rtol ||b|| on the recurrence.  Returns
    (x, steps taken, ||r|| / ||b||)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr0 = rr = torch.dot(r, r)
    k = 0
    while k < steps and float(rr) > rtol * rtol * float(rr0):
        q = apply(p)
        alpha = rr / torch.dot(p, q)
        x += alpha * p
        r -= alpha * q
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        k += 1
    return x, k, float(torch.sqrt(rr / rr0))


class ReferenceSubject:
    """The reference in the program's place, as the control puts it:
    ``solve(rhs)`` runs ``cg`` on the reference's operator of ``dims``,
    in float32 or, with ``precision`` "tf32", in float32 with the box
    product's operands rounded to TF32; no preconditioner, to the
    configuration's ``rtol`` within its ``control.max_it`` steps."""

    def __init__(self, dims: Tuple[int, int, int], config: dict,
                 device: torch.device, precision: str) -> None:
        if precision not in ("tf32", "float32"):
            raise ValueError(f"no reference subject in {precision!r}")
        self.lattice = tuple(dims)
        self.dtype = torch.float32
        self.op = CubeOperator(self.lattice, device, dtype=self.dtype,
                               tf32=precision == "tf32")
        self.ndofs = self.op.n
        self.max_it = int(config["control"]["max_it"])
        self.rtol = float(config["guarantee"]["rtol"])

    def solve(self, rhs: torch.Tensor):
        return cg(self.op.apply, rhs.to(self.dtype), self.max_it, self.rtol)

    def registry(self) -> dict:
        return {}
