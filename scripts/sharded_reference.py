"""tpufem's own sharded solves on the CPU (JAX, its 8-device virtual
mesh), the values tests/test_torch_slab.py and tests/test_torch_rowshard.py
pin: iterations, the recurrence residual, the solution norm and the
solution at a few fixed dofs, printed as Python literals.

    python scripts/sharded_reference.py [--case NAME ...]

Cases: the slab solver on BoxTetMesh(8, 8, 16) over 4 shards (P1 Poisson
and elasticity with GMG, P3 Poisson with GMG, gather_limit 500), on
BoxTetMesh(8, 8, 12) over 2 shards (P3 Poisson with GMG), on
BoxTetMesh(6, 6, 8) P2 unpreconditioned (rtol 1e-6, maxit 400), and the
row-sharded solver on BoxTetMesh(8, 9, 10) P2 Poisson (2 and 8 shards,
8 unpreconditioned at rtol 1e-6, the distributed level 1 over 4 shards
with -amg_dense_level_limit 0 -amg_coarse_eq_limit 50), on
BoxTetMesh(6, 6, 8) elasticity over 4 shards, and on the spoke mesh at
--ndofs 1500 over 2 shards (Poisson P1, pure Neumann, deflated).

    python scripts/sharded_reference.py --cli

runs instead tpufem's CLI on the sharded cases of tests/test_cli.py and
tests/test_golden.py (CLI_CASES) and prints (iterations, norm) of each."""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# float64 throughout, but for --cli, whose runs set it as tpufem's CLI
# does (x64 for --dtype float64 only: its order-k float32 loop refuses x64)
jax.config.update("jax_enable_x64", "--cli" not in sys.argv)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

SAMPLES = 7  # solution entries printed, evenly spaced over the dofs


def slab(dims, S, problem, order, precond, rtol, maxit):
    from tpufem.mesh import BoxTetMesh
    from tpufem.parallel.slab import ShardedCubeSolver
    sh = ShardedCubeSolver.build(BoxTetMesh(*dims), S, problem=problem,
                                 order=order, dtype=jnp.float64, rtol=rtol,
                                 maxit=maxit, precond=precond,
                                 gather_limit=500)
    return sh.solve()


def rowshard(mesh, order, problem, S, opts, precond, rtol):
    from tpufem.config import SolverOptions
    from tpufem.fem.assemble import assemble_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.parallel.rowshard import ShardedEllSolver
    from tpufem.problems import common
    bs = 3 if problem == "elasticity" else 1
    marker = (common.elasticity_bc_marker if problem == "elasticity"
              else common.poisson_bc_marker)
    space = FunctionSpace(mesh, order, bs=bs)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(marker))
    _, csr = assemble_operator(space, bc, problem, dtype=np.float64)
    nns = None
    if problem == "elasticity":
        from tpufem.la.nullspace import build_near_nullspace
        from tpufem.problems.elasticity import assemble_elasticity_rhs_np
        b = assemble_elasticity_rhs_np(space)
        nns = build_near_nullspace(space.scalar_dof_coords())
    else:
        from tpufem.problems.poisson import assemble_poisson_rhs_np
        b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    deflate = bc.flat_dofs().size == 0
    if deflate:
        b = b - b.mean()
    sh = ShardedEllSolver.build(space, bc, csr, b, S, SolverOptions(**opts),
                                dtype=jnp.float64, near_nullspace=nns,
                                rtol=rtol, maxit=100, precond=precond,
                                deflate=deflate)
    return sh.solve()


def cases():
    from tpufem.mesh import BoxTetMesh
    from tpufem.mesh.spoke import create_spoke_mesh
    l1 = dict(amg_dense_level_limit=0, amg_coarse_eq_limit=50)
    return {
        "slab_p1": lambda: slab((8, 8, 16), 4, "poisson", 1, True, 1e-8, 60),
        "slab_elasticity": lambda: slab((8, 8, 16), 4, "elasticity", 1,
                                        True, 1e-8, 60),
        "slab_p2_cg": lambda: slab((6, 6, 8), 4, "poisson", 2, False, 1e-6,
                                   400),
        "slab_p3": lambda: slab((8, 8, 16), 4, "poisson", 3, True, 1e-8, 60),
        # slabs of 6 planes: the port's P3 slab operator is the const DIA
        "slab_p3_const": lambda: slab((8, 8, 12), 2, "poisson", 3, True,
                                      1e-8, 60),
        "row_p2_2": lambda: rowshard(BoxTetMesh(8, 9, 10), 2, "poisson", 2,
                                     {}, True, 1e-8),
        "row_p2_8": lambda: rowshard(BoxTetMesh(8, 9, 10), 2, "poisson", 8,
                                     {}, True, 1e-8),
        "row_p2_8_cg": lambda: rowshard(BoxTetMesh(8, 9, 10), 2, "poisson",
                                        8, {}, False, 1e-6),
        "row_p2_l1": lambda: rowshard(BoxTetMesh(8, 9, 10), 2, "poisson", 4,
                                      l1, True, 1e-8),
        "row_elasticity": lambda: rowshard(BoxTetMesh(6, 6, 8), 1,
                                           "elasticity", 4, {}, True, 1e-8),
        "row_spoke": lambda: rowshard(create_spoke_mesh(1500, False, 1, 2,
                                                        verbose=False),
                                      1, "poisson", 2, {}, True, 1e-8),
    }


CLI_CASES = {
    "poisson100k-8shard": "--problem_type poisson --ndofs 100000 "
    "--scaling_type strong --num_shards 8 --dtype float64 -ksp_rtol 1e-8",
    "elasticity10k-4shard": "--problem_type elasticity --ndofs 10000 "
    "--scaling_type weak --num_shards 4 --dtype float64",
    "strong35937-8": "--problem_type poisson --ndofs 35937 --scaling_type "
    "strong --dtype float64 -ksp_rtol 1e-8 --num_shards 8",
    "elasticity4000-8": "--problem_type elasticity --ndofs 4000 "
    "--num_shards 8 --dtype float64",
    "cgpoisson35937-8": "--problem_type cgpoisson --ndofs 35937 "
    "--scaling_type strong --dtype float64 --num_shards 8",
    "order2-15000-8": "--problem_type poisson --ndofs 15000 --order 2 "
    "--num_shards 8 --dtype float64",
    "spoke4000-2": "--problem_type poisson --mesh_type unstructured "
    "--ndofs 4000 --num_shards 2 --dtype float64 -ksp_max_it 40",
    "weak15000-8": "--problem_type poisson --ndofs 15000 --scaling_type "
    "weak --dtype float64 -ksp_rtol 1e-8 --num_shards 8",
    "order3-2000-8": "--problem_type poisson --ndofs 2000 --scaling_type "
    "weak --num_shards 8 --order 3 --dtype float64 -ksp_rtol 1e-8",
    "cgpoisson2000-8": "--problem_type cgpoisson --ndofs 2000 "
    "--scaling_type weak --num_shards 8 --dtype float64",
    # float32, the sharded run of chip_smoke.py's phase 16 (its lattice,
    # 16x16x24, is not the one-shard run's 16x16x20)
    "cgpoisson-p3-150k-4-f32": "--problem_type cgpoisson --order 3 "
    "--ndofs 150000 --scaling_type strong --dtype float32 --num_shards 4",
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--case", nargs="*")
    p.add_argument("--cli", action="store_true")
    args = p.parse_args()
    if args.cli:
        from tpufem.cli import parse_args, solve
        for name in args.case or list(CLI_CASES):
            it, norm = solve(parse_args(CLI_CASES[name].split()))
            print(f"RESULT {name!r}: ({it}, {norm!r}),", flush=True)
            jax.config.update("jax_enable_x64", False)
        return
    table = cases()
    for name in args.case or list(table):
        x, it, rel = table[name]()
        idx = np.linspace(0, x.shape[0] - 1, SAMPLES).astype(np.int64)
        print(f"{name!r}: ({it}, {float(np.linalg.norm(x))!r}, "
              f"{[float(v) for v in x[idx]]!r}),  # rel {rel:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
