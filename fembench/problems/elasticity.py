"""Problem type ``elasticity``: tpufem_torch's vector P1 linear elasticity
on the cube (``tpufem_torch.problems.elasticity``), clamped on y = 0,
solved by its CG with the configured preconditioner in the
component-planar layout.  Built step for step as ``port.build_cube``
builds the scalar problems, whose table of problem types this one is not
in.

The traced stretch wraps each call of the preconditioner
(``Solver.precond``, the V-cycle under ``-pc_type gmg``) in the range
``fembench.vcycle``, as the Poisson cell does, and turns the port's own
spans on for that stretch alone, so that the trace also holds the
program's ``cg.apply`` and ``gmg.smooth.L0`` ranges; the window and the
timed stretch run with the spans off."""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from fembench import port

RANGES = ["fembench.vcycle", "cg.apply", "gmg.smooth.L0"]


def build_mesh_problem(config: dict, mix: dict, device: torch.device):
    """(mesh, problem) as the CLI builds them on one process: TF32 off,
    the host allocator tuned, the kernel library built or loaded, the
    mesh sized for three dofs a vertex and made, its facets, then
    ``problems.elasticity.problem``.  The port's timing registry is
    cleared first, so it holds this set-up's stages."""
    from tpufem_torch import cli, hostmem
    from tpufem_torch.mesh.structured import (BoxTetMesh,
                                              compute_box_size_structured)
    from tpufem_torch.problems import elasticity
    from tpufem_torch.timing import REGISTRY, Timer

    REGISTRY.reset()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, dev = cli.parse_args(
        list(config["args"])
        + ["--ndofs", str(mix["ndofs"]), "--scaling_type",
           mix["scaling_type"], "--device", str(device)])
    hostmem.tune_allocator()
    if dev.type == "cuda":
        from tpufem_torch import _build
        with Timer("ZZZ Build kernels"):
            _build.load()
    with Timer("ZZZ Create Mesh"):
        nx, ny, nz, _ = compute_box_size_structured(
            cfg.ndofs, cfg.scaling_type == "strong", cfg.dofs_per_node,
            cfg.order, 1)
        mesh = BoxTetMesh(nx, ny, nz)
    with Timer("ZZZ Create facets and facet->cell connectivity"):
        mesh.boundary_facet_cells(mesh.boundary_faces())
    return mesh, elasticity.problem(mesh, cfg.order, cfg, dev)


class Subject(port.Subject):
    """``port.Subject`` with the program's spans on in the traced
    stretch, the one the harness runs with ``record_function``."""

    def __init__(self, mesh, problem) -> None:
        super().__init__(mesh, problem, hook="precond",
                         range_name=RANGES[0])
        self.ranges = list(RANGES)

    @contextlib.contextmanager
    def instrumented(self, around: Callable):
        from torch.profiler import record_function
        from tpufem_torch import timing
        with super().instrumented(around):
            if around is not record_function:
                yield
                return
            timing.SPANS.reset()
            was = timing.enable_spans(True)
            try:
                yield
            finally:
                timing.enable_spans(was)
                timing.SPANS.reset()


def build(config: dict, mix: dict, device):
    return Subject(*build_mesh_problem(config, mix, device))
