"""The plain reference's judgement of problem type ``cgpoisson``: the
P1 Poisson system on the cube, a fixed budget of unpreconditioned CG
steps from x = 0 (``guarantee``: at most ``max_it`` steps, stopping at
the recurrence's ``rtol``).

The reference follows the same steps itself in float64
(``p1_cube.cg``, Hestenes-Stiefel CG on its own matrix: the same
iterates as the program's Chronopoulos-Gear form in exact arithmetic),
once for each right-hand side of the pool that the window used.  Its
numbers, each with the configuration's limit (``limits``):

- ``lattice_off``: 0 when the lattice the program sized is the
  reference's, else 1 (limit 0);
- ``its_off``: over every solve of the window, the largest difference
  between the steps it took and the reference's for its right-hand
  side (limit 0);
- ``x_err``: over the sampled solves, the largest max|x - x_ref| /
  max|x_ref|;
- ``rel_err``: over the sampled solves, the largest |rel - rel_ref| /
  rel_ref of the recurrence's ||r|| / ||b||.
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


def check(record: dict, pool: torch.Tensor, sample: Sequence[dict],
          config: dict, mix: dict, device: torch.device) -> List[dict]:
    dims = lattice_of(mix)
    limits = config["limits"]
    g = config["guarantee"]
    lattice_off = 0.0 if tuple(record["lattice"]) == tuple(dims) else 1.0
    its_off = x_err = rel_err = math.inf
    if not lattice_off:
        op = p1_cube.CubeOperator(dims, device)
        used = sorted({s[4] for s in record["solves"]})
        ref = {k: p1_cube.cg(op.apply, pool[k].to(torch.float64),
                             int(g["max_it"]), float(g["rtol"]))
               for k in used}
        its_off = float(max(abs(s[2] - ref[s[4]][1])
                            for s in record["solves"]))
        if sample:
            x_err = max(float((s["x"].to(torch.float64) - ref[s["pool"]][0])
                              .abs().max() / ref[s["pool"]][0].abs().max())
                        for s in sample)
            rel_err = max(abs(s["rel"] - ref[s["pool"]][2])
                          / ref[s["pool"]][2] for s in sample)
    return [dict(name="lattice_off", value=lattice_off, limit=0.0),
            dict(name="its_off", value=its_off, limit=0.0),
            dict(name="x_err", value=x_err, limit=float(limits["x_err"])),
            dict(name="rel_err", value=rel_err,
                 limit=float(limits["rel_err"]))]
