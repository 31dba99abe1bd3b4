"""The plain reference of problem type ``elasticity``: vector P1 linear
elasticity on the Kuhn cube lattice, clamped on the face y = 0, solved
to a relative residual.

Written from the finite-element definition alone, in plain numpy and
torch, as ``p1_cube`` is for Poisson: the lattice, its six tetrahedra a
box and the vertex numbering (x fastest, then y, then z) are
``p1_cube``'s; three components a vertex, interleaved (dof ``3 i + c``);
the form  a(u, v) = int sigma(u) : eps(v),  sigma = 2 mu eps + lambda
tr(eps) I, with E = 1e6 and nu = 0.3 (upstream's src/Elasticity.py); the
three components of every vertex on y = 0 eliminated (zero rows and
columns, unit diagonal).  Every box has the same six tetrahedra, so the
matrix is the sum over boxes of one 24 x 24 box matrix;
``ElasticOperator.apply`` gathers the eight corners of every box,
multiplies by that matrix and adds the products back, a block of
z-layers at a time.

Its numbers, each with the configuration's limit (``limits``):

- ``lattice_off``: 0 when the lattice the program sized is the one
  ``p1_cube.lattice`` gives for the mix's dofs over three, else 1
  (limit 0);
- ``rel``: the largest recurrence ||r|| / ||b|| that a solve of the
  window reported; the configuration's guarantee, its ``rtol``, is the
  limit;
- ``its``: the most iterations that a solve of the window took (the
  Krylov loop's count, and through it the preconditioner's strength);
- ``true_rel``: over the sampled solves, the largest ||b - A x|| / ||b||
  in float64, A this module's own eliminated matrix, x the program's
  answer as it returned it.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fembench.reference import p1_cube
from fembench.reference.poisson import true_rel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E = 1.0e6
NU = 0.3
MU = E / (2.0 * (1.0 + NU))
LMBDA = E * NU / ((1.0 + NU) * (1.0 - 2.0 * NU))


def lattice_of(mix: dict) -> Tuple[int, int, int]:
    """(Nx, Ny, Nz) of the mix's dofs, three a vertex."""
    return p1_cube.lattice(int(mix["ndofs"]) // 3)


def box_matrix(dims: Tuple[int, int, int]) -> np.ndarray:
    """The 24 x 24 stiffness matrix of one box, float64; row and column
    3 k + c are component c of corner k = dx + 2 dy + 4 dz, at offset
    (dx, dy, dz).  Of a tetrahedron with gradients G (one row a vertex)
    and volume vol: vol (lambda G[a, i] G[b, j] + mu delta_ij G[a] . G[b]
    + mu G[a, j] G[b, i]) at row (a, i), column (b, j)."""
    h = 1.0 / np.asarray(dims, dtype=np.float64)
    K = np.zeros((24, 24))
    eye = np.eye(3, dtype=np.int64)
    for perm in itertools.permutations(range(3)):
        corners = [np.zeros(3, dtype=np.int64)]
        for axis in perm:
            corners.append(corners[-1] + eye[axis])
        P = np.array(corners, dtype=np.float64) * h
        J = (P[1:] - P[0]).T
        Jinv = np.linalg.inv(J)
        G = np.vstack([-Jinv.sum(axis=0), Jinv])     # [4 vertices, 3]
        vol = abs(np.linalg.det(J)) / 6.0
        Ke = (LMBDA * np.einsum("ai,bj->aibj", G, G)
              + MU * np.einsum("ij,ab->aibj", np.eye(3), G @ G.T)
              + MU * np.einsum("aj,bi->aibj", G, G)).reshape(12, 12)
        idx = [3 * int(c[0] + 2 * c[1] + 4 * c[2]) + r
               for c in corners for r in range(3)]
        K[np.ix_(idx, idx)] += vol * Ke
    return K


class ElasticOperator:
    """The eliminated stiffness matrix of a lattice, applied to flat
    interleaved vectors.  ``dtype`` float64 is the reference; ``tf32=True``
    (float32) is the lower-precision control, with both operands of the
    box product rounded to TF32 and float32 sums."""

    def __init__(self, dims: Tuple[int, int, int], device: torch.device,
                 dtype: torch.dtype = torch.float64, tf32: bool = False,
                 block_layers: int = 32) -> None:
        if tf32 and dtype != torch.float32:
            raise ValueError("the TF32 control computes in float32")
        self.dims = tuple(int(d) for d in dims)
        self.dtype, self.device, self.tf32 = dtype, device, tf32
        self.block_layers = block_layers
        K = torch.from_numpy(box_matrix(self.dims)).to(dtype)
        self.K = (p1_cube.to_tf32(K) if tf32 else K).to(device)
        Nx, Ny, Nz = self.dims
        self.shape = (Nz + 1, Ny + 1, Nx + 1, 3)
        self.n = 3 * (Nx + 1) * (Ny + 1) * (Nz + 1)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        Nx, Ny, Nz = self.dims
        xg = x.to(self.dtype).reshape(self.shape)
        xm = xg.clone()
        xm[:, 0] = 0.0
        y = torch.zeros_like(xm)
        corners = list(itertools.product((0, 1), repeat=3))  # (dz, dy, dx)
        for z0 in range(0, Nz, self.block_layers):
            z1 = min(z0 + self.block_layers, Nz)
            X = torch.stack([xm[z0 + dz:z1 + dz, dy:dy + Ny, dx:dx + Nx]
                             .movedim(-1, 0).reshape(3, -1)
                             for dz, dy, dx in corners]).reshape(24, -1)
            if self.tf32:
                X = p1_cube.to_tf32(X)
            Y = (self.K @ X).reshape(8, 3, z1 - z0, Ny, Nx)
            for k, (dz, dy, dx) in enumerate(corners):
                y[z0 + dz:z1 + dz, dy:dy + Ny, dx:dx + Nx] += \
                    Y[k].movedim(0, -1)
        y[:, 0] = xg[:, 0]
        return y.reshape(-1)


def rhs_pool(seed: int, count: int, mix: dict, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """[count, 3 vertices] right-hand sides, standard normal in every
    component from the seed, drawn on the device in one call, zero on the
    clamped face y = 0."""
    Nx, Ny, Nz = lattice_of(mix)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pool = torch.randn((count, 3 * (Nz + 1) * (Ny + 1) * (Nx + 1)),
                       generator=g, dtype=dtype, device=device)
    pool.view(count, Nz + 1, Ny + 1, Nx + 1, 3)[:, :, 0] = 0.0
    return pool


def apply_work(record: dict) -> Tuple[int, int]:
    """(bytes, operations) that any application of the matrix that the run
    solved with has to do: x read once and y written once, ``itemsize``
    bytes an entry, and a multiply and an add for each entry of the
    matrix that is not zero."""
    Nx, Ny, Nz = record["lattice"]
    n = 3 * (Nx + 1) * (Ny + 1) * (Nz + 1)
    return 2 * record["itemsize"] * n, 2 * nnz(record["lattice"])


def nnz(dims: Tuple[int, int, int]) -> int:
    """Entries of the lattice's matrix that are not zero: the clamped
    rows' unit diagonals, and each coupling of two free dofs whose sum
    over the boxes holding both vertices is not zero."""
    K = box_matrix(dims)
    tol = 1e-12 * np.abs(K).max()

    def classes(N: int, o: int, clamped: bool):
        """[(vertices, [(corner bit of the row, of the column), one pair
        per box holding both])] along one axis of N boxes, for a column
        ``o`` vertices on; ``clamped``: rows and columns on 1..N only
        (the axis whose 0 is clamped)."""
        if o:
            n = N - 1 if clamped else N
            return [(n, [(0, 1)] if o > 0 else [(1, 0)])]
        ends = [(1, [(1, 1)])] if clamped else [(1, [(0, 0)]), (1, [(1, 1)])]
        return ends + [(N - 1, [(0, 0), (1, 1)])]

    Nx, Ny, Nz = dims
    total = 3 * (Nx + 1) * (Nz + 1)        # the clamped rows
    for o in itertools.product((-1, 0, 1), repeat=3):
        axes = [classes(Nx, o[0], False), classes(Ny, o[1], True),
                classes(Nz, o[2], False)]
        for combo in itertools.product(*axes):
            pairs = list(itertools.product(*(c[1] for c in combo)))
            block = sum(K[3 * (ax + 2 * ay + 4 * az):3 * (ax + 2 * ay + 4 * az)
                          + 3,
                          3 * (bx + 2 * by + 4 * bz):3 * (bx + 2 * by + 4 * bz)
                          + 3]
                        for (ax, bx), (ay, by), (az, bz) in pairs)
            total += (int((np.abs(block) > tol).sum())
                      * combo[0][0] * combo[1][0] * combo[2][0])
    return int(total)


class ReferenceSubject:
    """The reference in the program's place, as the control puts it:
    ``solve(rhs)`` runs ``p1_cube.cg`` on this module's operator, in
    float32 or, with ``precision`` "tf32", in float32 with the box
    product's operands rounded to TF32; no preconditioner, to the
    configuration's ``rtol`` within its ``control.max_it`` steps.  The
    operator takes every z-layer in one block: the control's time is
    its launches."""

    def __init__(self, dims: Tuple[int, int, int], config: dict,
                 device: torch.device, precision: str) -> None:
        if precision not in ("tf32", "float32"):
            raise ValueError(f"no reference subject in {precision!r}")
        self.lattice = tuple(dims)
        self.dtype = torch.float32
        self.op = ElasticOperator(self.lattice, device, dtype=self.dtype,
                                  tf32=precision == "tf32",
                                  block_layers=self.lattice[2])
        self.ndofs = self.op.n
        self.max_it = int(config["control"]["max_it"])
        self.rtol = float(config["guarantee"]["rtol"])

    def solve(self, rhs: torch.Tensor):
        return p1_cube.cg(self.op.apply, rhs.to(self.dtype), self.max_it,
                          self.rtol)

    def registry(self) -> dict:
        return {}


def control_subject(config: dict, mix: dict, device: torch.device,
                    precision: str) -> ReferenceSubject:
    """The reference in the program's place, for ``fembench/control.py``."""
    return ReferenceSubject(lattice_of(mix), config, device, precision)


def check(record: dict, pool: torch.Tensor, sample: Sequence[dict],
          config: dict, mix: dict, device: torch.device) -> List[dict]:
    dims = lattice_of(mix)
    limits = config["limits"]
    lattice_off = 0.0 if tuple(record["lattice"]) == tuple(dims) else 1.0
    worst = math.inf
    if sample and not lattice_off:
        op = ElasticOperator(dims, device)
        worst = max(true_rel(op, pool[s["pool"]], s["x"]) for s in sample)
    rels = [s[3] for s in record["solves"]]
    its = [s[2] if s[2] >= 0 else math.inf for s in record["solves"]]
    return [dict(name="lattice_off", value=lattice_off, limit=0.0),
            dict(name="rel", value=max(rels) if rels else math.inf,
                 limit=float(config["guarantee"]["rtol"])),
            dict(name="its", value=float(max(its)) if its else math.inf,
                 limit=float(limits["its"])),
            dict(name="true_rel", value=worst,
                 limit=float(limits["true_rel"]))]
