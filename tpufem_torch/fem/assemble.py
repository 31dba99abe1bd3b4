"""Host float64 cell geometry and the Poisson and elasticity element
stiffness (numpy; counterpart of tpufem/fem/assemble.py:280-347 and
tpufem/fem/kernels.py:73-77, 180-200).

The structured path needs the element matrices of the six Kuhn tet
shapes only, so assembly is this closed-form geometry on the host.
"""

from __future__ import annotations

import functools

import numpy as np

from tpufem_torch.fem.reference import ReferenceTet


# Lame parameters of the reference's generated forms (src/Elasticity.py:12-15)
ELASTICITY_E = 1.0e6
ELASTICITY_NU = 0.3
ELASTICITY_MU = ELASTICITY_E / (2.0 * (1.0 + ELASTICITY_NU))
ELASTICITY_LMBDA = (ELASTICITY_E * ELASTICITY_NU
                    / ((1.0 + ELASTICITY_NU) * (1.0 - 2.0 * ELASTICITY_NU)))


@functools.lru_cache(maxsize=None)
def _poisson_ref_tables(order: int):
    el = ReferenceTet(order)
    K = el.stiffness_tensors  # [3, 3, n, n]
    n = el.ndofs
    return np.ascontiguousarray(K.reshape(9, n * n)), el.mass_tensor, n


def _cell_jacobians(coords: np.ndarray):
    """Per-cell Jacobian J [C,3,3] plus the first cofactor row and det."""
    E = coords[:, 1:4, :] - coords[:, 0:1, :]
    J = np.swapaxes(E, 1, 2)  # [C, a, l]
    c00 = J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1]
    c01 = J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2]
    c02 = J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]
    det = J[:, 0, 0] * c00 + J[:, 0, 1] * c01 + J[:, 0, 2] * c02
    return J, c00, c01, c02, det


def _geometry_np(coords: np.ndarray):
    """(Jinv [C,3,3], |detJ| [C]) by the closed-form adjugate."""
    J, c00, c01, c02, det = _cell_jacobians(coords)
    adj = np.empty_like(J)
    adj[:, 0, 0] = c00
    adj[:, 0, 1] = J[:, 0, 2] * J[:, 2, 1] - J[:, 0, 1] * J[:, 2, 2]
    adj[:, 0, 2] = J[:, 0, 1] * J[:, 1, 2] - J[:, 0, 2] * J[:, 1, 1]
    adj[:, 1, 0] = c01
    adj[:, 1, 1] = J[:, 0, 0] * J[:, 2, 2] - J[:, 0, 2] * J[:, 2, 0]
    adj[:, 1, 2] = J[:, 0, 2] * J[:, 1, 0] - J[:, 0, 0] * J[:, 1, 2]
    adj[:, 2, 0] = c02
    adj[:, 2, 1] = J[:, 0, 1] * J[:, 2, 0] - J[:, 0, 0] * J[:, 2, 1]
    adj[:, 2, 2] = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    Jinv = adj / det[:, None, None]
    return Jinv, np.abs(det)


def _poisson_stiffness_np(coords: np.ndarray, order: int) -> np.ndarray:
    """[C, n, n] stiffness of a = inner(grad u, grad v) dx per cell."""
    Kflat, _, n = _poisson_ref_tables(order)
    Jinv, adet = _geometry_np(coords)
    G = np.einsum("cal,cbl->cab", Jinv, Jinv) * adet[:, None, None]
    return (G.reshape(-1, 9) @ Kflat).reshape(-1, n, n)


@functools.lru_cache(maxsize=None)
def _elasticity_ref_table(order: int):
    """TT[(alpha,beta,r,s) = 81, (3n)^2] with
    A_c[(i,r),(j,s)] = sum_{ab rs} C_c[a,b,r,s] K[a,b,i,j]."""
    el = ReferenceTet(order)
    K = el.stiffness_tensors  # [3, 3, n, n]
    n = el.ndofs
    TT = np.zeros((3, 3, 3, 3, 3 * n, 3 * n))
    for r in range(3):
        for s in range(3):
            # rows 3i+r, cols 3j+s get K[a,b,i,j] for channel (a,b,r,s)
            TT[:, :, r, s, r::3, s::3] = K
    return np.ascontiguousarray(TT.reshape(81, 9 * n * n)), el.mass_tensor, n


def _elasticity_stiffness_np(coords: np.ndarray, order: int) -> np.ndarray:
    """[C, 3n, 3n] stiffness of a = inner(sigma(u), eps(v)) dx per cell,
    sigma = 2 mu eps + lambda tr(eps) I (src/Elasticity.py:30-39); dofs
    interleaved, (i, r) -> 3i + r."""
    TT, _, n = _elasticity_ref_table(order)
    mu, lam = ELASTICITY_MU, ELASTICITY_LMBDA
    Jinv, adet = _geometry_np(coords)
    JJ = np.einsum("cal,cbl->cab", Jinv, Jinv)
    eye = np.eye(3)
    C = (mu * JJ[:, :, :, None, None] * eye[None, None, None, :, :]
         + mu * np.einsum("cas,cbr->cabrs", Jinv, Jinv)
         + lam * np.einsum("car,cbs->cabrs", Jinv, Jinv))
    C = C * adet[:, None, None, None, None]
    return (C.reshape(-1, 81) @ TT).reshape(-1, 3 * n, 3 * n)
