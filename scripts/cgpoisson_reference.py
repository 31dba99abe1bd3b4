#!/usr/bin/env python3
"""Reference values of tpufem's own matrix-free cgpoisson solve on the
CPU, for the port's checks on the card (chip_smoke.py pins them).

Runs, with JAX on the CPU, the loop tpufem's ``cgpoisson.problem`` runs
on the cube mesh for P2/P3 (tpufem/problems/cgpoisson.py:259-266): the
device RHS, the const-table DIA as a StripOperator, and
``cg_solve_fused`` on the strip buffer; for P1 the baked DIA with
``cg_solve_fused``.  With ``--flat`` (P2/P3) it runs the ``-use_flat 1``
loop instead (cgpoisson.py:268-277): the DIA as a FlatOperator (its XLA
interior twin on the CPU) and ``cg_solve_fused`` on the float32
channel-plane buffer.  With ``--conv`` (P2/P3) it runs the ``-use_conv 1``
loop (cgpoisson.py:131-150, 279-287): the DIA as a ConvStencilOp and
``cg_solve_fused`` on its padded channel tensor.  With ``--mesh_type
unstructured`` it runs the
spoke mesh's loop (cgpoisson.py:84-107, 205-209, 278-282): the host RHS
with b[bc] = 0, the matrix-free ``MatFreePoissonOp`` (gather, metric
action, sorted segment sum) and ``cg_solve_fused`` on it.  It prints one
JSON line per configuration: the lattice (the cube) or the cell count
(the spoke), ndofs, iterations, the recurrence rel and the solution norm.
``--ulp_seed S`` moves every nonzero entry of the RHS, in the
solve's dtype, by one ulp up or down, the directions drawn from
``numpy.random.default_rng(S)``: how far the loop's own rounding can move
its result, the measure of the port's tolerances on these runs.

    python scripts/cgpoisson_reference.py --order 3 --ndofs 500000 \\
        --scaling_type strong --dtype float32 [--flat | --conv] \\
        [--ulp_seed 1]
    python scripts/cgpoisson_reference.py --mesh_type unstructured \\
        --order 1 --ndofs 500000 --scaling_type strong --dtype float32 \\
        [--ulp_seed 1]

float64 turns on jax's x64 mode, as tpufem's CLI does; float32 keeps it
off, so dots accumulate in float32, as in a tpufem float32 run.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

# run as a script from anywhere: tpufem is the repository's own package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--order", type=int, required=True)
    p.add_argument("--ndofs", type=int, required=True)
    p.add_argument("--scaling_type", default="strong")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--rtol", type=float, default=1e-6)
    p.add_argument("--kmax", type=int, default=100)
    p.add_argument("--flat", action="store_true",
                   help="the -use_flat 1 operator (P2/P3)")
    p.add_argument("--conv", action="store_true",
                   help="the -use_conv 1 operator (P2/P3)")
    p.add_argument("--mesh_type", default="cube",
                   choices=("cube", "unstructured"))
    p.add_argument("--ulp_seed", type=int, default=None,
                   help="move the RHS by one ulp (this seed)")
    a = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if a.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from tpufem.fem.conv_op import ConvStencilOp
    from tpufem.fem.dia_op import build_operator
    from tpufem.fem.flat_op import FlatOperator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.fem.strip_op import StripOperator
    from tpufem.la.cg import cg_solve_fused
    from tpufem.mesh.structured import (BoxTetMesh,
                                        compute_box_size_structured)
    from tpufem.problems import common
    from tpufem.problems.poisson import (assemble_poisson_rhs_np,
                                         assemble_poisson_rhs_structured_dev)

    dtype = jnp.float32 if a.dtype == "float32" else jnp.float64
    if a.mesh_type == "unstructured":
        return spoke(a, dtype)
    nx, ny, nz, _ = compute_box_size_structured(
        a.ndofs, a.scaling_type == "strong", 1, a.order, 1)
    mesh = BoxTetMesh(nx, ny, nz)
    space = FunctionSpace(mesh, a.order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    if dtype == jnp.float32:
        b = assemble_poisson_rhs_structured_dev(space, bc, dtype)
    else:
        b_np = assemble_poisson_rhs_np(space)
        b_np[bc.flat_dofs()] = 0.0
        b = jnp.asarray(b_np)
    if a.ulp_seed is not None:
        b = jnp.asarray(ulp_nudge(np.asarray(b), a.ulp_seed))
    op = build_operator(mesh, a.order, "poisson", bc_dofs=bc.flat_dofs(),
                        dtype=dtype, bake_bc=True)
    if a.flat and a.conv:
        raise SystemExit("--flat and --conv are two operators: pick one")
    if a.conv:
        op = ConvStencilOp.from_dia(op, dtype=dtype)

        def run(r):
            x_ch, it, rel = cg_solve_fused(op.apply_channels,
                                           op.to_channels_padded(r), x0=None,
                                           rtol=a.rtol, maxit=a.kmax)
            return op.from_channels_padded(x_ch), it, rel
    elif a.flat:
        op = FlatOperator.from_dia(op)
        if op is None:
            raise SystemExit("the lattice does not fit the flat operator")

        def run(r):
            x_f, it, rel = cg_solve_fused(op.apply_flat, op.to_flat(r),
                                          x0=None, rtol=a.rtol, maxit=a.kmax)
            return op.from_flat(x_f).astype(r.dtype), it, rel
    elif a.order >= 2:
        op = StripOperator.from_dia(op, dtype=dtype)

        def run(r):
            x_f, it, rel = cg_solve_fused(op.apply_strips, op.to_strips(r),
                                          x0=None, rtol=a.rtol, maxit=a.kmax)
            return op.from_strips(x_f, dtype=r.dtype), it, rel
    else:
        def run(r):
            return cg_solve_fused(op.apply, r, x0=None, rtol=a.rtol,
                                  maxit=a.kmax)
    t0 = time.perf_counter()
    x, it, rel = jax.jit(run)(b)
    x = np.asarray(x)
    print(json.dumps({
        "order": a.order, "ndofs": int(space.ndofs), "lattice": [nx, ny, nz],
        "scaling_type": a.scaling_type, "dtype": a.dtype, "flat": a.flat,
        "conv": a.conv, "ulp_seed": a.ulp_seed,
        "iterations": int(it), "rel": float(rel),
        "norm": float(np.linalg.norm(x.astype(np.float64))),
        "norm_in_dtype": float(jnp.sqrt(jnp.sum(jnp.asarray(x) ** 2))),
        "seconds": time.perf_counter() - t0}), flush=True)


def ulp_nudge(b, seed: int):
    """``b`` with each nonzero entry one ulp of its dtype up or down, the
    directions from ``numpy.random.default_rng(seed)``."""
    import numpy as np
    up = np.random.default_rng(seed).random(b.shape) < 0.5
    moved = np.where(up, np.nextafter(b, b.dtype.type(np.inf)),
                     np.nextafter(b, b.dtype.type(-np.inf)))
    return np.where(b != 0, moved, b).astype(b.dtype)


def spoke(a, dtype) -> None:
    """tpufem's matrix-free loop on the spoke mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpufem.fem.assemble import DofScatter
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.la.cg import cg_solve_fused
    from tpufem.mesh.spoke import create_spoke_mesh
    from tpufem.problems import common
    from tpufem.problems.cgpoisson import make_action
    from tpufem.problems.poisson import assemble_poisson_rhs_np

    mesh = create_spoke_mesh(a.ndofs, a.scaling_type == "strong", 1, 1,
                             verbose=False)
    space = FunctionSpace(mesh, a.order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    b_np = assemble_poisson_rhs_np(space)
    b_np[bc.flat_dofs()] = 0.0
    b_np = b_np.astype(np.dtype(dtype))
    if a.ulp_seed is not None:
        b_np = ulp_nudge(b_np, a.ulp_seed)
    b = jnp.asarray(b_np)
    op = make_action(space, bc, DofScatter(space.cell_dofs,
                                           space.ndofs_scalar), dtype)

    def run(o, r):
        return cg_solve_fused(o.apply, r, x0=None, rtol=a.rtol, maxit=a.kmax)

    t0 = time.perf_counter()
    x, it, rel = jax.jit(run)(op, b)
    x = np.asarray(x)
    print(json.dumps({
        "mesh_type": "unstructured", "order": a.order,
        "ndofs": int(space.ndofs), "cells": int(mesh.num_cells_global),
        "scaling_type": a.scaling_type, "dtype": a.dtype,
        "ulp_seed": a.ulp_seed, "iterations": int(it), "rel": float(rel),
        "norm": float(np.linalg.norm(x.astype(np.float64))),
        "norm_in_dtype": float(jnp.sqrt(jnp.sum(jnp.asarray(x) ** 2))),
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
