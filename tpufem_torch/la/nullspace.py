"""Rigid-body near-nullspace of elasticity (the port's copy of
tpufem/la/nullspace.py: numpy only).

Rebuild of ``build_near_nullspace`` (reference:
src/elasticity_problem.cpp:36-94): six modes, three translations and
three rotations built from dof coordinates, orthonormalized with a hard
``is_orthonormal`` check (the PETSc ``MatSetNearNullSpace`` analogue,
elasticity_problem.cpp:239-241).  Only algebraic multigrid consumes them
(brick-AMG, la.bramg; SA-AMG, la.amg); the elasticity problem
builds them whatever the preconditioner, as the reference times the
stage ("ZZZ Create near-nullspace").
"""

from __future__ import annotations

from typing import List

import numpy as np


def rigid_body_modes(dof_coords: np.ndarray) -> np.ndarray:
    """[6, 3 * nnodes] rigid-body modes from scalar-dof coordinates.

    Modes (matching elasticity_problem.cpp:46-70):
      0..2: unit translations along x, y, z
      3: (-y, x, 0) rotation about z
      4: (z, 0, -x) rotation about y
      5: (0, -z, y) rotation about x
    """
    n = dof_coords.shape[0]
    x, y, z = dof_coords[:, 0], dof_coords[:, 1], dof_coords[:, 2]
    modes = np.zeros((6, n, 3))
    modes[0, :, 0] = 1.0
    modes[1, :, 1] = 1.0
    modes[2, :, 2] = 1.0
    modes[3, :, 0] = -y
    modes[3, :, 1] = x
    modes[4, :, 0] = z
    modes[4, :, 2] = -x
    modes[5, :, 1] = -z
    modes[5, :, 2] = y
    return modes.reshape(6, 3 * n)


def build_near_nullspace(dof_coords: np.ndarray) -> np.ndarray:
    """Orthonormalized [6, ndofs] near-nullspace (host float64, Gram-Schmidt
    in mode order).  Raises if the result fails the orthonormality check,
    as the reference fails hard (elasticity_problem.cpp:76-81)."""
    basis: List[np.ndarray] = []
    for m in rigid_body_modes(dof_coords):
        v = m.astype(np.float64)
        for u in basis:
            v = v - (u @ v) * u
        n = np.linalg.norm(v)
        if n == 0.0:
            raise RuntimeError("Space not orthonormal")
        basis.append(v / n)
    B = np.stack(basis)
    if not np.allclose(B @ B.T, np.eye(6), atol=1e-4):
        raise RuntimeError("Space not orthonormal")
    return B
