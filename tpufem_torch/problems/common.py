"""Shared problem-construction helpers (counterpart of
tpufem/problems/common.py): the Poisson data f, g and Dirichlet marker,
the elasticity body force and clamped face, the problem record, the
facet -> cell table of an unstructured mesh, and dtype resolution to
torch dtypes."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Problem:
    """What a problem constructor returns: the reference's
    ``{b, u, solver_function}`` (src/poisson_problem.h:19-23)."""

    b: torch.Tensor
    u: torch.Tensor
    solver_function: Callable[[torch.Tensor, torch.Tensor],
                              Tuple[torch.Tensor, int]]
    space: object
    bc: object
    rhs_op: Optional[object] = None  # the device operator of the RHS, if any
    near_nullspace: Optional[np.ndarray] = None  # elasticity: [6, ndofs]


def facet_to_cell(cell_faces: np.ndarray,
                  facets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(cell index, local face index) of each boundary facet: the
    reference's facet -> cell connectivity (src/main.cpp:148;
    tpufem/problems/common.py:25-38).  A boundary facet belongs to one
    cell, so any match is its owner."""
    flat = cell_faces.reshape(-1)
    order = np.argsort(flat, kind="stable")
    pos = np.searchsorted(flat[order], facets)
    hit = order[pos]
    if not np.array_equal(flat[hit], facets):
        raise ValueError("facet not found in cell_faces")
    return hit // cell_faces.shape[1], hit % cell_faces.shape[1]


def poisson_f_xy(x, y, xp=np):
    """RHS bump on broadcastable x/y coordinate arrays, ``xp`` = numpy or
    torch: the single closed form of the host and device RHS paths."""
    return 10.0 * xp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)


def poisson_f(x: np.ndarray) -> np.ndarray:
    """f = 10 exp(-((x-.5)^2+(y-.5)^2)/0.02)
    (reference: src/poisson_problem.cpp:85-98)."""
    return poisson_f_xy(x[:, 0], x[:, 1])


def poisson_g(x: np.ndarray) -> np.ndarray:
    """g = sin(5 x0) (reference: src/poisson_problem.cpp:99-106)."""
    return np.sin(5.0 * x[:, 0])


def poisson_bc_marker(x: np.ndarray) -> np.ndarray:
    """Dirichlet planes x0 = 0 and x0 = 1
    (reference: src/poisson_problem.cpp:58-71)."""
    eps = 1.0e-8
    return (np.abs(x[:, 0]) < eps) | (np.abs(x[:, 0] - 1.0) < eps)


def elasticity_f_components(x, y, z, xp=np):
    """Rotational body force (-dz*r*y, 1, dx*r*y) on broadcastable
    coordinate arrays, ``xp`` = numpy or torch: the single closed form of
    the host and device RHS paths (reference:
    src/elasticity_problem.cpp:154-176)."""
    dx = x - 0.5
    dz = z - 0.5
    r = xp.sqrt(dx * dx + dz * dz)
    return (-dz * r * y, xp.ones_like(r * y), dx * r * y)


def elasticity_f(x: np.ndarray) -> np.ndarray:
    """Rotational body force at point rows [n, 3]."""
    return np.stack(
        elasticity_f_components(x[:, 0], x[:, 1], x[:, 2]), axis=-1)


def elasticity_bc_marker(x: np.ndarray) -> np.ndarray:
    """Clamped y = 0 plane (reference: src/elasticity_problem.cpp:125-138)."""
    return np.abs(x[:, 1]) < 1.0e-8


def resolve_dtype(cfg) -> Tuple[torch.dtype, torch.dtype]:
    """(working dtype, dot accumulation dtype) of ``cfg.dtype``.

    float32 accumulates in float32 and mixed in float64, as tpufem's CLI
    does by enabling jax's x64 mode for --dtype float64|mixed only."""
    if cfg.dtype == "float64":
        return torch.float64, torch.float64
    if cfg.dtype == "mixed":
        return torch.float32, torch.float64
    return torch.float32, torch.float32
