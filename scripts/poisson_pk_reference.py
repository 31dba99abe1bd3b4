#!/usr/bin/env python3
"""Reference values of tpufem's own P2/P3 runs on the CPU, for the port's
checks on the card (chip_smoke.py pins them in POISSON_PK_REF,
ELASTICITY_PK_REF and CGPOISSON_REF).

``--problem_type poisson`` (the default) and ``elasticity`` run tpufem's
CLI (``tpufem.cli.solve``) with JAX on the CPU: the assembled P2/P3
Poisson or elasticity problem on the cube mesh, CG to rtol 1e-8
preconditioned by GMG (the order-k fine level, one p-transfer to P1, the
P1 h-hierarchy), and the float64 certification.  ``--problem_type
cgpoisson`` runs, without the CLI's timing loop of 30 more solves, the
loop tpufem's ``cgpoisson.problem`` runs under ``-use_strip 0``
(tpufem/problems/cgpoisson.py:170-183, 259-266): the device RHS, the
baked const-table DIA operator and ``cg_solve_fused`` (kmax 100, rtol
1e-6).  It prints one JSON line: the lattice, ndofs, iterations, the
solution norm and, for poisson and elasticity, the certified true
residual.

    python scripts/poisson_pk_reference.py --order 2 --ndofs 500000 \\
        --scaling_type strong --dtype float32
    python scripts/poisson_pk_reference.py --problem_type elasticity \\
        --order 2 --ndofs 500000 --scaling_type strong --dtype float32
    python scripts/poisson_pk_reference.py --problem_type elasticity \\
        --order 1 --ndofs 10000000 --ksp_max_it 200
    python scripts/poisson_pk_reference.py --problem_type cgpoisson \\
        --order 3 --ndofs 500000 --scaling_type strong --dtype float32

float64 turns on jax's x64 mode, as tpufem's CLI does; float32 keeps it
off, so dots accumulate in float32, as in a tpufem float32 run (tpufem's
order-k float32 solve fails with x64 on: its CG carry turns float64).
Run each case in a fresh process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import sys
import time

# run as a script from anywhere: tpufem is the repository's own package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def cli_run(a) -> dict:
    """tpufem's CLI run: (iterations, norm, true_rel, refinement passes)."""
    from tpufem.cli import parse_args, solve
    cfg = parse_args(["--problem_type", a.problem_type, "--order",
                      str(a.order), "--ndofs", str(a.ndofs), "--scaling_type",
                      a.scaling_type, "--dtype", a.dtype, "--num_shards", "1",
                      "-pc_type", "gmg", "-ksp_rtol", "1e-8",
                      "-ksp_max_it", str(a.ksp_max_it)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        its, norm = solve(cfg)
    text = out.getvalue()
    sys.stderr.write(text)
    m = re.search(r"True residual \|\|b-Ax\|\|/\|\|b\|\| \(f64\): (\S+) "
                  r"\((\d+) refinement", text)
    return {"iterations": int(its), "norm": float(norm),
            "true_rel": float(m.group(1)) if m else None,
            "refine_passes": int(m.group(2)) if m else None}


def cgpoisson_dia(a, mesh, space, bc, dtype) -> dict:
    """tpufem's -use_strip 0 loop: the baked const-table DIA operator."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpufem.fem.dia_op import DiaOperator, build_operator
    from tpufem.la.cg import cg_solve_fused
    from tpufem.problems.poisson import (assemble_poisson_rhs_np,
                                         assemble_poisson_rhs_structured_dev)
    if dtype == jnp.float32:
        b = assemble_poisson_rhs_structured_dev(space, bc, dtype)
    else:
        b_np = assemble_poisson_rhs_np(space)
        b_np[bc.flat_dofs()] = 0.0
        b = jnp.asarray(b_np)
    op = build_operator(mesh, a.order, "poisson", bc_dofs=bc.flat_dofs(),
                        dtype=dtype, bake_bc=True)
    if not (isinstance(op, DiaOperator) and op.is_const()):
        raise SystemExit("the lattice is too small for the const DIA form")
    x, it, rel = jax.jit(lambda r: cg_solve_fused(
        op.apply, r, x0=None, rtol=a.rtol, maxit=a.kmax))(b)
    return {"iterations": int(it), "rel": float(rel),
            "norm": float(np.linalg.norm(np.asarray(x).astype(np.float64)))}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--problem_type", default="poisson",
                   choices=("poisson", "elasticity", "cgpoisson"))
    p.add_argument("--order", type=int, required=True)
    p.add_argument("--ndofs", type=int, required=True)
    p.add_argument("--scaling_type", default="strong")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--rtol", type=float, default=1e-6,
                   help="cgpoisson's rtol")
    p.add_argument("--kmax", type=int, default=100, help="cgpoisson's kmax")
    p.add_argument("--ksp_max_it", type=int, default=100,
                   help="poisson / elasticity: CG's cap (bench.py's "
                        "elasticity_10m row runs 200)")
    a = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if a.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.mesh.structured import (BoxTetMesh,
                                        compute_box_size_structured)
    from tpufem.problems import common

    bs = 3 if a.problem_type == "elasticity" else 1
    nx, ny, nz, _ = compute_box_size_structured(
        a.ndofs, a.scaling_type == "strong", bs, a.order, 1)
    mesh = BoxTetMesh(nx, ny, nz)
    space = FunctionSpace(mesh, a.order, bs=bs)
    t0 = time.perf_counter()
    if a.problem_type != "cgpoisson":
        rec = cli_run(a)
    else:
        bc = DirichletBC.from_space(
            space, mesh.locate_boundary_facets(common.poisson_bc_marker))
        rec = cgpoisson_dia(a, mesh, space, bc, jnp.float32
                            if a.dtype == "float32" else jnp.float64)
    print(json.dumps({
        "problem_type": a.problem_type, "order": a.order,
        "ndofs": int(space.ndofs), "lattice": [nx, ny, nz],
        "scaling_type": a.scaling_type, "dtype": a.dtype, **rec,
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
