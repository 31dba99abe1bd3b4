#!/usr/bin/env python3
"""Reference values of tpufem's own SA-AMG runs on the CPU, for the
port's checks on the card (chip_smoke.py pins them in SAAMG_REF).

Runs tpufem's CLI (``tpufem.cli.solve``) with JAX on the CPU and one
shard: a cube problem with ``-pc_type amg`` (and the options given, such
as ``-amg_brick off``), or the spoke mesh (``--mesh_type unstructured``),
CG to rtol 1e-8 and the float64 certification.  It prints one JSON line:
ndofs, the SA-AMG level sizes, iterations, the solution norm, the
certified true residual and the refinement passes.  ``--levels_only``
(the spoke mesh, Poisson at ``--order``) stops after the preconditioner's
setup, as tpufem's make_solver runs it (tpufem/problems/poisson.py:
323-368: the window gate, then SA-AMG on the RCM route or the plain one),
and prints ndofs, the route and the level sizes without a solve.
``--ulp_seed S`` (elasticity) moves every nonzero entry of tpufem's host
RHS by one ulp of the solve's dtype, up or down as
``cgpoisson_reference.ulp_nudge`` draws them: how far the run's own
rounding can move its result.

    python scripts/saamg_reference.py --ndofs 500000 --scaling_type strong \\
        --dtype float32 -- -pc_type amg -amg_brick off
    python scripts/saamg_reference.py --order 2 --ndofs 500000 \\
        --scaling_type strong --dtype float32 -- -pc_type amg
    python scripts/saamg_reference.py --problem_type elasticity \\
        --ndofs 500000 --scaling_type strong --dtype float32 \\
        -- -pc_type amg -amg_brick off
    python scripts/saamg_reference.py --mesh_type unstructured \\
        --ndofs 500000 --scaling_type strong --dtype float32 --levels_only
    python scripts/saamg_reference.py --problem_type elasticity \\
        --mesh_type unstructured --ndofs 150000 --scaling_type strong \\
        --dtype float32 --ulp_seed 1 -- -ksp_max_it 8

float64 turns on jax's x64 mode, as tpufem's CLI does; float32 keeps it
off, so dots accumulate in float32, as in a tpufem float32 run.  Run each
case in a fresh process.
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


def levels_only(a) -> None:
    """tpufem's spoke problem and its SA-AMG setup, without a solve."""
    import jax.numpy as jnp
    import numpy as np

    from tpufem.config import SolverOptions
    from tpufem.fem.assemble import assemble_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.la.amg import SAAMG
    from tpufem.mesh.spoke import create_spoke_mesh
    from tpufem.problems import common, poisson
    t0 = time.perf_counter()
    dtype = jnp.float32 if a.dtype == "float32" else jnp.float64
    mesh = create_spoke_mesh(a.ndofs, a.scaling_type == "strong", 1, 1,
                             verbose=False)
    space = FunctionSpace(mesh, a.order)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(
        common.poisson_bc_marker))
    _, csr = assemble_operator(space, bc, "poisson", dtype=np.dtype(dtype))
    solver = SolverOptions()
    wop, csr_w, mask_w, _ = poisson._try_window(csr, bc, solver, dtype)
    if wop is not None:
        pc = SAAMG.setup(csr_w, bs=1, options=solver, dtype=dtype,
                         bc_mask=mask_w, fine_factored=False,
                         fine_store_a=False, fine_transfer_window=True)
    else:
        pc = SAAMG.setup(csr, bs=1, options=solver, dtype=dtype,
                         bc_mask=bc.mask(), fine_factored=False)
    print(json.dumps({
        "mesh_type": "unstructured", "order": a.order,
        "ndofs": int(space.ndofs),
        "scaling_type": a.scaling_type, "dtype": a.dtype,
        "route": "rcm" if wop is not None else "plain",
        "levels": list(pc.level_sizes),
        "seconds": time.perf_counter() - t0}), flush=True)


def nudge_elasticity_rhs(a) -> None:
    """Wrap tpufem's host elasticity RHS so that each nonzero entry moves
    by one ulp of the solve's dtype (the certification's float64 RHS is
    the same moved vector)."""
    import numpy as np

    from cgpoisson_reference import ulp_nudge
    from tpufem.problems import elasticity
    if a.problem_type != "elasticity":
        raise SystemExit("--ulp_seed moves the elasticity RHS only")
    rhs, dt = elasticity.assemble_elasticity_rhs_np, np.dtype(a.dtype)
    elasticity.assemble_elasticity_rhs_np = lambda space: ulp_nudge(
        rhs(space).astype(dt), a.ulp_seed).astype(np.float64)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--problem_type", default="poisson",
                   choices=("poisson", "elasticity"))
    p.add_argument("--mesh_type", default="cube")
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--ndofs", type=int, required=True)
    p.add_argument("--scaling_type", default="strong")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--levels_only", action="store_true",
                   help="the spoke mesh: stop after the SA-AMG setup")
    p.add_argument("--ulp_seed", type=int, default=None,
                   help="elasticity: move the RHS by one ulp (this seed)")
    p.add_argument("options", nargs="*",
                   help="solver options for tpufem's CLI (after --)")
    a = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if a.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    from tpufem.cli import parse_args, solve
    if a.levels_only:
        return levels_only(a)
    if a.ulp_seed is not None:
        nudge_elasticity_rhs(a)
    cfg = parse_args(["--problem_type", a.problem_type, "--mesh_type",
                      a.mesh_type, "--order", str(a.order), "--ndofs",
                      str(a.ndofs), "--scaling_type", a.scaling_type,
                      "--dtype", a.dtype, "--num_shards", "1",
                      "-ksp_rtol", "1e-8"] + a.options)
    out, log = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(log):
        its, norm = solve(cfg)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    sys.stderr.write(log.getvalue() + text)
    m = re.search(r"True residual \|\|b-Ax\|\|/\|\|b\|\| \(f64\): (\S+) "
                  r"\((\d+) refinement", text)
    levels = re.search(r"SA-AMG setup \S+: levels (\[[\d, ]+\])",
                       log.getvalue())
    ndofs = re.search(r"Total degrees of freedom:\s+(\d+)", text)
    print(json.dumps({
        "problem_type": a.problem_type, "mesh_type": a.mesh_type,
        "order": a.order, "ndofs": int(ndofs.group(1)) if ndofs else None,
        "scaling_type": a.scaling_type, "dtype": a.dtype,
        "options": a.options, "ulp_seed": a.ulp_seed,
        "levels": json.loads(levels.group(1)) if levels else None,
        "iterations": int(its), "norm": float(norm),
        "true_rel": float(m.group(1)) if m else None,
        "refine_passes": int(m.group(2)) if m else None,
        "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
