"""Command-line entry point of the port (counterpart of tpufem/cli.py).

Takes tpufem's flags (``parse_args`` is a copy of tpufem's) plus
``--device`` (default ``cuda``; there is no fallback to the CPU), builds
the cube or the spoke mesh, runs the Poisson (P1-P3), matrix-free CG
Poisson (P1-P3) or elasticity (P1-P3) problem on one device, prints the
reproducibility summary, the ZZZ timing table, the Krylov iterations, the
solution norm and, for ``poisson`` and ``elasticity``, the certified true
residual.
``-log_view`` writes a ``torch.profiler`` trace of the solve, as tpufem
writes a ``jax.profiler`` one (tpufem/cli.py:238-255).

``-pc_type amg`` runs lattice-brick AMG (la.bramg) for P1 Poisson and
elasticity, as does tpufem's fallback where GMG cannot coarsen the
lattice; ``-amg_brick off``, and ``-pc_type amg`` at orders above 1, run
tpufem's generic SA-AMG (la.amg).  ``--mesh_type unstructured`` builds
tpufem's spoke mesh and runs on it Poisson P1-P3 (assembled CSR, SA-AMG,
the constant nullspace deflated), elasticity (block CSR, SA-AMG with the
rigid-body modes) and the matrix-free cgpoisson P1-P3 (the gather /
metric action / scatter kernel).  ``--num_shards N`` (N > 1) runs what
tpufem runs: the cube on z-slabs, CG + distributed GMG at every order
(parallel.slab), and the row-sharded CG + SA-AMG on the spoke and on
cubes too small for slabs (parallel.rowshard); a process holds its
shards on its one device, and processes join over torch.distributed
(parallel.multihost: MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE).
Not ported yet (each raises NotImplementedError naming its ROADMAP
item): --output and --memory_profiling.

Run:  python -m tpufem_torch --problem_type poisson --ndofs 500000 \\
          --scaling_type strong --device cuda [--order 2|3]
      python -m tpufem_torch --problem_type cgpoisson --order 3 \\
          --ndofs 500000 --scaling_type strong --device cuda [-use_flat 1]
      python -m tpufem_torch --problem_type elasticity --ndofs 500000 \\
          --scaling_type strong --device cuda [-pc_type amg | --order 2|3]
      python -m tpufem_torch --problem_type poisson --mesh_type \\
          unstructured --ndofs 150000 --scaling_type strong --device cuda
      python -m tpufem_torch --problem_type cgpoisson --mesh_type \\
          unstructured --order 3 --ndofs 150000 --scaling_type strong
      python -m tpufem_torch --ndofs 500000 --scaling_type strong \\
          --num_shards 4 --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
from typing import List, NamedTuple, Optional, Tuple

import torch

from tpufem_torch import __version__
from tpufem_torch.config import Config, SolverOptions
from tpufem_torch.la.vector import norm
from tpufem_torch.logutil import init_logging, int64_to_human
from tpufem_torch.mesh.spoke import create_spoke_mesh
from tpufem_torch.mesh.structured import (BoxTetMesh,
                                          compute_box_size_structured)
from tpufem_torch.parallel.multihost import init_from_env
from tpufem_torch.problems import (cgpoisson, common, elasticity, poisson,
                                   sharded)
from tpufem_torch.timing import Timer, list_timings

logger = logging.getLogger("tpufem_torch")


class SolveResult(NamedTuple):
    iterations: int
    norm: float
    true_rel: Optional[float]
    refine_passes: int
    refine_iterations: int
    problem: common.Problem
    x: torch.Tensor


def _parse_config(argv: Optional[List[str]] = None) -> Config:
    """tpufem's ``parse_args`` (tpufem/cli.py:28-97): the double-hyphen
    app flags, and single-hyphen options passed through to the solver
    namespace (the PETSc options DB analogue, reference main.cpp:77-81)."""
    parser = argparse.ArgumentParser(
        prog="tpufem_torch", description="FEM scaling test (PyTorch + CUDA)",
        allow_abbrev=False)
    parser.add_argument("--problem_type", default="poisson",
                        help="problem (poisson, cgpoisson, or elasticity)")
    parser.add_argument("--mesh_type", default="cube",
                        help="mesh (cube or unstructured)")
    parser.add_argument("--scaling_type", default="weak",
                        help="scaling (weak or strong)")
    parser.add_argument("--ndofs", type=int, default=50000,
                        help="number of degrees of freedom")
    parser.add_argument("--order", type=int, default=1, help="polynomial order")
    parser.add_argument("--scatterer", default="neighbor",
                        help="ghost exchange schedule (neighbor or p2p)")
    parser.add_argument("--output", default="",
                        help="output directory (no output unless set)")
    parser.add_argument("--memory_profiling", action="store_true")
    parser.add_argument("--subcomm_partition", action="store_true")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "float64", "mixed"])
    parser.add_argument("--num_shards", type=int, default=0,
                        help="device shards (0 = all visible devices)")
    args, unknown = parser.parse_known_args(argv)

    solver = SolverOptions()
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("-"):
            raise SystemExit(f"unrecognized argument: {tok}")
        key = tok.lstrip("-")
        val: object = True

        def _is_number(s: str) -> bool:
            try:
                float(s)
                return True
            except ValueError:
                return False

        # a following token is this option's value unless it starts a
        # new flag; negative numbers ("-ksp_rtol -1e-6") are values
        if i + 1 < len(unknown) and (not unknown[i + 1].startswith("-")
                                     or _is_number(unknown[i + 1])):
            raw = unknown[i + 1]
            try:
                val = int(raw)
            except ValueError:
                try:
                    val = float(raw)
                except ValueError:
                    val = raw
            i += 1
        if hasattr(solver, key) and key not in ("extra",):
            setattr(solver, key, type(getattr(solver, key))(val)
                    if not isinstance(val, bool) else val)
        else:
            solver.extra[key] = val
        i += 1

    return Config(
        problem_type=args.problem_type, mesh_type=args.mesh_type,
        scaling_type=args.scaling_type, ndofs=args.ndofs, order=args.order,
        scatterer=args.scatterer, output=args.output,
        memory_profiling=args.memory_profiling,
        subcomm_partition=args.subcomm_partition, dtype=args.dtype,
        num_shards=args.num_shards, solver=solver)


def parse_args(argv: Optional[List[str]] = None) -> Tuple[Config, torch.device]:
    """tpufem's flags and options, plus ``--device``."""
    p = argparse.ArgumentParser(prog="tpufem_torch", add_help=False,
                                allow_abbrev=False)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    args, rest = p.parse_known_args(argv)
    return _parse_config(rest), resolve_device(args.device)


def resolve_device(name: str) -> torch.device:
    """The requested device; CUDA without a usable card raises."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: torch.cuda.is_available() "
                               "is False (the port never falls back to the "
                               "CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"--device {name}: cuda or cpu")
    return dev


def _check_scope(cfg: Config) -> None:
    unported = [
        (bool(cfg.output), "--output (XDMF): ROADMAP M17"),
        (cfg.memory_profiling, "--memory_profiling: ROADMAP M17"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"not ported yet: {what}")


def _log_view(cfg: Config, device: torch.device):
    """(trace directory or None, context of the solve): ``-log_view``
    traces the solve with torch.profiler into the given directory, or
    ``<--output or .>/tpufem-trace`` when it has no value, tpufem's rule
    (tpufem/cli.py:238-255)."""
    log_view = cfg.solver.extra.get("log_view")
    cfg.solver._consumed.add("log_view")
    if not log_view:
        return None, contextlib.nullcontext()
    trace_dir = (log_view if isinstance(log_view, str)
                 else (cfg.output or ".") + "/tpufem-trace")
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return trace_dir, profile(activities=activities)


def solve(cfg: Config, device: torch.device) -> SolveResult:
    """Run one configuration on ``device``."""
    _check_scope(cfg)
    # full-precision float32 matmuls (tpufem's Precision.HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the process group (the MPI_Init analogue, tpufem/cli.py:112-119):
    # joined where MASTER_ADDR / WORLD_SIZE are set, else one process
    proc_id, proc_count = init_from_env(device)
    if device.type == "cuda" and proc_count > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    init_logging(rank=proc_id)
    num_shards = cfg.num_shards or proc_count

    if device.type == "cuda":
        from tpufem_torch import _build
        with Timer("ZZZ Build kernels"):
            _build.load()

    # multi-shard execution (tpufem/cli.py:130-149): the cube on z-slabs
    # at every order; unstructured meshes, and cubes too small for a
    # sharded multigrid chain, on the row-sharded assembled path
    use_sharded = num_shards > 1 and cfg.mesh_type == "cube"
    use_rowshard = num_shards > 1 and not use_sharded
    if num_shards > 1 and num_shards % proc_count:
        raise SystemExit(f"num_shards={num_shards} over {proc_count} "
                         "processes: each process holds as many shards")
    if cfg.scatterer == "p2p":
        logger.info("scatterer=p2p: slab halos use one exchange a direction "
                    "either way; schedule identical to 'neighbor'")
    if cfg.subcomm_partition:
        logger.info("subcomm_partition: no-op (each process builds only "
                    "its own shards)")

    strong = cfg.scaling_type == "strong"
    with Timer("ZZZ Create Mesh"):
        if cfg.mesh_type == "cube":
            nx, ny, nz, r = compute_box_size_structured(
                cfg.ndofs, strong, cfg.dofs_per_node, cfg.order, num_shards)
            mesh = BoxTetMesh(nx, ny, nz)
            print(f"UnitCube ({nx >> r}x{ny >> r}x{nz >> r}) to be "
                  f"refined {r} times", flush=True)
        else:
            mesh = create_spoke_mesh(cfg.ndofs, strong, cfg.dofs_per_node,
                                     num_shards)

    with Timer("ZZZ Create facets and facet->cell connectivity"):
        if cfg.mesh_type == "cube":
            mesh.boundary_facet_cells(mesh.boundary_faces())
        else:
            common.facet_to_cell(mesh.cell_faces(), mesh.boundary_faces())

    if use_sharded and cfg.problem_type != "cgpoisson":
        from tpufem_torch.parallel.slab import slab_gmg_viable
        if not slab_gmg_viable(
                mesh, num_shards, bs=cfg.dofs_per_node,
                coarse_limit=int(cfg.solver.get("amg_coarse_eq_limit")),
                max_levels=int(cfg.solver.get("amg_max_levels")),
                precond=cfg.solver.get("pc_type") != "none"):
            logger.info("cube mesh %dx%dx%d too small for a sharded "
                        "multigrid chain over %d slabs; using the "
                        "row-sharded path", mesh.Nx, mesh.Ny, mesh.Nz,
                        num_shards)
            use_sharded, use_rowshard = False, True
    if use_sharded:
        prob = sharded.problem(mesh, cfg.order, cfg, cfg.problem_type,
                               num_shards, device)
    elif use_rowshard:
        prob = sharded.problem_rowshard(mesh, cfg.order, cfg,
                                        cfg.problem_type, num_shards, device)
    else:
        problems = {"poisson": poisson.problem,
                    "cgpoisson": cgpoisson.problem,
                    "elasticity": elasticity.problem}
        prob = problems[cfg.problem_type](mesh, cfg.order, cfg, device)

    num_dofs = prob.space.ndofs
    num_cells = mesh.num_cells_global
    line = "-" * 64
    print(line)
    print("Test problem summary")
    print(f"  tpufem_torch version: {__version__}")
    print(f"  torch version:   {torch.__version__}")
    print(f"  CUDA version:    {torch.version.cuda}")
    print(f"  device:          {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"  dtype:           {cfg.dtype}")
    print(f"  Problem type:    {cfg.problem_type}")
    print(f"  Scaling type:    {cfg.scaling_type}")
    print(f"  Num processes:   {proc_count}")
    print(f"  Num shards:      {num_shards}")
    print(f"  Num cells:       {num_cells}{int64_to_human(num_cells)}")
    print(f"  Total degrees of freedom:               "
          f"{num_dofs}{int64_to_human(num_dofs)}")
    print(f"  Average degrees of freedom per shard:   "
          f"{num_dofs // num_shards}")
    print(line, flush=True)

    trace_dir, trace_cm = _log_view(cfg, device)
    with Timer("ZZZ Solve", device), trace_cm as prof:
        x, num_iter = prob.solver_function(prob.u, prob.b)
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "solve.trace.json"))
        print(f"-log_view: profiler trace written to {trace_dir}", flush=True)

    list_timings()
    solver = prob.solver_function
    # across processes the sharded solve reports the owned-masked norm
    # itself (x stays sharded)
    sol_norm = getattr(solver, "solution_norm", None)
    if sol_norm is None:
        sol_norm = float(norm(x, solver.acc_dtype))
    print(f"*** Number of Krylov iterations: {num_iter}")
    print(f"*** Solution norm:  {sol_norm}", flush=True)
    true_rel = getattr(solver, "true_rel", None)
    passes = getattr(solver, "refine_passes", 0)
    extra = getattr(solver, "refine_iterations", 0)
    if true_rel is not None:
        print(f"*** True residual ||b-Ax||/||b|| (f64): {true_rel:.3e}"
              f" ({passes} refinement pass(es), +{extra} iterations)",
              flush=True)
    cfg.solver.warn_options_left()
    return SolveResult(iterations=num_iter, norm=sol_norm, true_rel=true_rel,
                       refine_passes=passes, refine_iterations=extra,
                       problem=prob, x=x)


def main(argv: Optional[List[str]] = None) -> SolveResult:
    cfg, device = parse_args(argv)
    return solve(cfg, device)
