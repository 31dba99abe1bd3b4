"""Reference tetrahedron: Lagrange P1-P3 (GLL-warped) tabulation + quadrature
(the port's copy of tpufem/fem/reference.py: pure numpy and scipy, the
same arithmetic, so element tensors are bitwise equal to tpufem's).

Replaces Basix element creation (reference call sites:
src/poisson_problem.cpp:35-38, src/elasticity_problem.cpp:103-106 — family P,
tetrahedron, ``lagrange_variant::gll_warped``).  Everything is precomputed at
setup on the host in float64: node placement, basis coefficients via a
generalized Vandermonde solve against the monomial basis, and the reference
integral tensors the Pallas/XLA element kernels contract against
(the TPU-native replacement for FFCx ``tabulate_tensor`` C kernels,
reference: src/CMakeLists.txt:23-33).

Reference cell: v0=(0,0,0), v1=(1,0,0), v2=(0,1,0), v3=(0,0,1).
Dof layout (matches tpufem.fem.space dof numbering):
  vertices (4) | edge dofs (6 edges x (k-1), LOCAL_EDGES order, ordered
  along the local edge direction) | face dofs (4 faces x (k-3 ? 1 : 0),
  LOCAL_FACES order).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Tuple

import numpy as np
from scipy.special import roots_jacobi

from tpufem_torch.mesh.structured import LOCAL_EDGES, LOCAL_FACES

REF_VERTICES = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])


# ---------------------------------------------------------------------------
# Quadrature: collapsed Gauss-Jacobi (Duffy transform) on simplices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tet_quadrature(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """(points [nq, 3], weights [nq]) exact for polynomials of ``degree``."""
    n = max(1, (degree + 2) // 2)
    xa, wa = roots_jacobi(n, 0, 0)
    xb, wb = roots_jacobi(n, 1, 0)
    xc, wc = roots_jacobi(n, 2, 0)
    # map from [-1, 1] to [0, 1]
    xa, xb, xc = (xa + 1) / 2, (xb + 1) / 2, (xc + 1) / 2
    pts = []
    wts = []
    for (i, a), (j, b), (k, c) in itertools.product(
            enumerate(xa), enumerate(xb), enumerate(xc)):
        # Duffy: collapse the cube onto the tet
        x = c
        y = b * (1 - c)
        z = a * (1 - b) * (1 - c)
        pts.append((x, y, z))
        # jacobi weights absorb the (1-c)^2 (1-b) Duffy jacobian
        wts.append(wa[i] * wb[j] * wc[k] / 8.0)
    pts = np.array(pts)
    wts = np.array(wts)
    wts *= (1.0 / 6.0) / wts.sum()
    return pts, wts


@functools.lru_cache(maxsize=None)
def triangle_quadrature(degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """(points [nq, 2], weights [nq]) on the reference triangle, exact for
    polynomials of ``degree``."""
    n = max(1, (degree + 2) // 2)
    xa, wa = roots_jacobi(n, 0, 0)
    xb, wb = roots_jacobi(n, 1, 0)
    xa, xb = (xa + 1) / 2, (xb + 1) / 2
    pts = []
    wts = []
    for (i, a), (j, b) in itertools.product(enumerate(xa), enumerate(xb)):
        x = b
        y = a * (1 - b)
        pts.append((x, y))
        wts.append(wa[i] * wb[j] / 4.0)
    pts = np.array(pts)
    wts = np.array(wts)
    wts *= 0.5 / wts.sum()
    return pts, wts


# ---------------------------------------------------------------------------
# Node placement (GLL-warped Lagrange variant)
# ---------------------------------------------------------------------------


def _gll_points_01(k: int) -> np.ndarray:
    """The k+1 Gauss-Lobatto-Legendre points on [0, 1]."""
    if k == 1:
        return np.array([0.0, 1.0])
    # interior GLL points are roots of Jacobi P_{k-1}^{(1,1)}
    xi, _ = roots_jacobi(k - 1, 1, 1)
    return np.concatenate([[0.0], (xi + 1) / 2, [1.0]])


def _edge_interior_params(k: int, variant: str) -> np.ndarray:
    """Interior node parameters t in (0, 1) along an edge."""
    if k < 2:
        return np.zeros((0,))
    if variant == "gll_warped":
        return _gll_points_01(k)[1:-1]
    return np.arange(1, k) / k  # equispaced


# ---------------------------------------------------------------------------
# Element
# ---------------------------------------------------------------------------


def _monomial_exponents(k: int) -> np.ndarray:
    exps = [(a, b, c)
            for c in range(k + 1)
            for b in range(k + 1 - c)
            for a in range(k + 1 - c - b)]
    return np.array(exps, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class ReferenceTet:
    """P_k Lagrange element on the reference tetrahedron."""

    order: int
    variant: str = "gll_warped"

    def __post_init__(self) -> None:
        if not 1 <= self.order <= 3:
            raise ValueError("only P1..P3 supported (reference forms cover 1-3)")
        nodes = self._make_nodes()
        exps = _monomial_exponents(self.order)
        V = self._eval_monomials(nodes, exps)
        coeffs = np.linalg.solve(V, np.eye(len(nodes)))  # [mono, dof]
        object.__setattr__(self, "nodes", nodes)
        object.__setattr__(self, "_exps", exps)
        object.__setattr__(self, "_coeffs", coeffs)

    @property
    def ndofs(self) -> int:
        return self.nodes.shape[0]

    @property
    def ndofs_per_entity(self) -> Tuple[int, int, int, int]:
        """(per-vertex, per-edge, per-face, per-cell) dof counts."""
        k = self.order
        return (1, k - 1, max(k - 2, 0) * (k - 1) // 2, 0)

    def _make_nodes(self) -> np.ndarray:
        k = self.order
        nodes = [REF_VERTICES[i] for i in range(4)]
        tparams = _edge_interior_params(k, self.variant)
        for (a, b) in LOCAL_EDGES:
            va, vb = REF_VERTICES[a], REF_VERTICES[b]
            for t in tparams:
                nodes.append(va + t * (vb - va))
        if k >= 3:
            for (a, b, c) in LOCAL_FACES:
                nodes.append((REF_VERTICES[a] + REF_VERTICES[b] + REF_VERTICES[c]) / 3.0)
        return np.array(nodes)

    @staticmethod
    def _eval_monomials(pts: np.ndarray, exps: np.ndarray) -> np.ndarray:
        x = pts[:, None, :]  # [np, 1, 3]
        e = exps[None, :, :]  # [1, nm, 3]
        return np.prod(np.power(x, e), axis=-1)  # [np, nm]

    def tabulate(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(phi [npts, ndofs], dphi [npts, ndofs, 3]) at reference points."""
        pts = np.atleast_2d(points)
        V = self._eval_monomials(pts, self._exps)
        phi = V @ self._coeffs
        dphi = np.zeros((pts.shape[0], self.ndofs, 3))
        for a in range(3):
            e = self._exps.copy()
            fac = e[:, a].astype(float)
            e[:, a] = np.maximum(e[:, a] - 1, 0)
            dV = self._eval_monomials(pts, e) * fac[None, :]
            dphi[:, :, a] = dV @ self._coeffs
        return phi, dphi

    # -- precomputed reference tensors for element kernels -------------------
    @functools.cached_property
    def stiffness_tensors(self) -> np.ndarray:
        """K[alpha, beta, i, j] = int_ref d_alpha phi_i d_beta phi_j."""
        pts, wts = tet_quadrature(2 * (self.order - 1))
        _, dphi = self.tabulate(pts)  # [q, n, 3]
        return np.einsum("q,qia,qjb->abij", wts, dphi, dphi, optimize=True)

    @functools.cached_property
    def mass_tensor(self) -> np.ndarray:
        """M[i, j] = int_ref phi_i phi_j."""
        pts, wts = tet_quadrature(2 * self.order)
        phi, _ = self.tabulate(pts)
        return np.einsum("q,qi,qj->ij", wts, phi, phi, optimize=True)

    @functools.cached_property
    def facet_mass_tensors(self) -> np.ndarray:
        """S[f, i, j] = int over reference face f of phi_i phi_j dA.

        Used for the surface term ``g*v*ds`` (reference: src/Poisson.py:32)
        with g interpolated into V.  Physical integral = S * (2 * area).
        """
        pts2, wts2 = triangle_quadrature(2 * self.order)
        out = np.zeros((4, self.ndofs, self.ndofs))
        for f, (a, b, c) in enumerate(LOCAL_FACES):
            va, vb, vc = REF_VERTICES[a], REF_VERTICES[b], REF_VERTICES[c]
            pts3 = va + pts2[:, :1] * (vb - va) + pts2[:, 1:2] * (vc - va)
            phi, _ = self.tabulate(pts3)
            # reference face area factor: the map (s,t)->face has area
            # |(vb-va) x (vc-va)|; wts2 integrate over the unit triangle
            # (area 1/2), so scale by |cross| / (1/2) ... we fold the
            # physical area in at assembly; here keep the unit-triangle
            # parametrization: S = sum_q w_q phi_i phi_j  (area 1/2 measure)
            out[f] = np.einsum("q,qi,qj->ij", wts2, phi, phi, optimize=True)
        return out

    @functools.cached_property
    def quad_data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(wts [q], phi [q, n], dphi [q, n, 3]) at a 2(k-1)-exact rule —
        inputs to matrix-free action kernels."""
        pts, wts = tet_quadrature(2 * (self.order - 1))
        phi, dphi = self.tabulate(pts)
        return pts, wts, phi, dphi
