"""The system under test: tpufem_torch's problem on the cube, built by the
same functions its CLI calls (``tpufem_torch/cli.py``: ``solve``'s
preamble and ``_run``'s mesh and problem steps), without the CLI's
certified solve and report.

Only this module and ``problems/<type>.py`` import the port.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch


def build_cube(config: dict, mix: dict, device: torch.device):
    """(mesh, problem) of the configuration's problem on the mix's
    cube, as the CLI builds it on one process: TF32 off, the host
    allocator tuned, the kernel library built or loaded, the mesh sized
    and made, its facets, then ``problems.<type>.problem``.  The port's
    timing registry is cleared first, so it holds this set-up's stages."""
    from tpufem_torch import cli, hostmem
    from tpufem_torch.mesh.structured import (BoxTetMesh,
                                              compute_box_size_structured)
    from tpufem_torch.problems import cgpoisson, poisson
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
    problem = {"poisson": poisson.problem,
               "cgpoisson": cgpoisson.problem}[cfg.problem_type]
    return mesh, problem(mesh, cfg.order, cfg, dev)


class Subject:
    """A built problem as the window drives it: ``solve(rhs)`` is the
    uncertified ``Solver.run(u0, rhs)`` -> (x, iterations, recurrence
    rel).  ``hook`` names the solver's attribute that the timed and the
    traced stretch wrap in a range of its own (``ranges[0]``)."""

    def __init__(self, mesh, problem, hook: str, range_name: str) -> None:
        self.solver = problem.solver_function
        self.u0 = problem.u
        self.dtype = problem.b.dtype
        self.lattice: Tuple[int, int, int] = (mesh.Nx, mesh.Ny, mesh.Nz)
        self.ndofs = problem.space.ndofs
        self.hook = hook
        self.ranges: List[str] = [range_name]

    def solve(self, rhs: torch.Tensor):
        return self.solver.run(self.u0, rhs)

    def registry(self) -> Dict[str, float]:
        """The port's timing registry: seconds by stage."""
        from tpufem_torch.timing import REGISTRY
        return {name: total for name, _, total in REGISTRY.rows()}

    @contextlib.contextmanager
    def instrumented(self, around: Callable):
        """While inside, each call of the hooked callable runs inside
        ``around(ranges[0])``, a context manager: ``record_function`` or
        a host timer.  Nothing is wrapped where the solver has none."""
        inner: Callable = getattr(self.solver, self.hook, None)
        if inner is None:
            yield
            return
        name = self.ranges[0]

        def wrapped(*args, **kwargs):
            with around(name):
                return inner(*args, **kwargs)

        setattr(self.solver, self.hook, wrapped)
        try:
            yield
        finally:
            setattr(self.solver, self.hook, inner)
