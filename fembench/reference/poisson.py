"""The plain reference's judgement of problem type ``poisson``: the
assembled P1 Poisson system on the cube, solved to a relative residual.

Its numbers, each with the configuration's limit (``limits``):

- ``lattice_off``: 0 when the lattice the program sized is the one
  ``p1_cube.lattice`` gives for the mix's dofs, else 1 (limit 0);
- ``rel``: the largest recurrence ||r|| / ||b|| that a solve of the
  window reported; the configuration's guarantee, its ``rtol``, is the
  limit;
- ``its``: the most iterations that a solve of the window took (the
  Krylov loop's count, and through it the preconditioner's strength);
- ``true_rel``: over the sampled solves, the largest ||b - A x|| / ||b||
  in float64, A the reference's own Dirichlet-eliminated stiffness
  matrix, x the program's answer as it returned it: the operator, its
  Dirichlet rows, the Krylov iterate and the preconditioner, through
  the solution they yield.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from fembench.reference import p1_cube


def lattice_of(mix: dict):
    return p1_cube.lattice(int(mix["ndofs"]))


def rhs_pool(seed: int, count: int, mix: dict, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The mix's pool of right-hand sides (``p1_cube.rhs_pool``)."""
    return p1_cube.rhs_pool(seed, count, lattice_of(mix), dtype, device)


def apply_work(record: dict):
    """(bytes, operations) of one application of the matrix that the run
    solved with (``p1_cube.apply_work``)."""
    return p1_cube.apply_work(record["lattice"], record["itemsize"])


def control_subject(config: dict, mix: dict, device: torch.device,
                    precision: str) -> p1_cube.ReferenceSubject:
    """The reference in the program's place, for ``fembench/control.py``."""
    return p1_cube.ReferenceSubject(lattice_of(mix), config, device,
                                    precision)


def true_rel(op: p1_cube.CubeOperator, b: torch.Tensor,
             x: torch.Tensor) -> float:
    b64 = b.to(torch.float64)
    return float(torch.linalg.vector_norm(b64 - op.apply(x))
                 / torch.linalg.vector_norm(b64))


def check(record: dict, pool: torch.Tensor, sample: Sequence[dict],
          config: dict, mix: dict, device: torch.device) -> List[dict]:
    dims = lattice_of(mix)
    limits = config["limits"]
    op = p1_cube.CubeOperator(dims, device)
    lattice_off = 0.0 if tuple(record["lattice"]) == tuple(dims) else 1.0
    worst = (max(true_rel(op, pool[s["pool"]], s["x"]) for s in sample)
             if sample and not lattice_off else math.inf)
    rels = [s[3] for s in record["solves"]]
    its = [s[2] if s[2] >= 0 else math.inf for s in record["solves"]]
    return [dict(name="lattice_off", value=lattice_off, limit=0.0),
            dict(name="rel", value=max(rels) if rels else math.inf,
                 limit=float(config["guarantee"]["rtol"])),
            dict(name="its", value=float(max(its)) if its else math.inf,
                 limit=float(limits["its"])),
            dict(name="true_rel", value=worst,
                 limit=float(limits["true_rel"]))]
