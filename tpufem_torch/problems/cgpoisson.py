"""Matrix-free CG Poisson problem (counterpart of
tpufem/problems/cgpoisson.py:80-328), on the cube mesh and on an
unstructured mesh.

Rebuild of ``cgpoisson::problem`` (reference src/cgpoisson_problem.cpp):
unpreconditioned CG (kmax = 100, rtol = 1e-6 by default) on the
operator action, with the reference's throughput metric

    Gdof/s = iterations * global dofs / solve seconds / 1e9

(cgpoisson_problem.cpp:236-242).  The operator, by tpufem's decision
chain (cgpoisson.py:110-212):

- P1: the const-table DIA stencil with the BC baked in, one launch of
  the CUDA stencil kernel per apply (TPU kernel K1); smaller lattices
  take the dense DIA form (K2) with the rows-zero convention;
- P2/P3: the const-table DIA's matrix on the channel-strip layout
  (fem.strip_op), one launch of the strip kernel per apply (K3); with
  ``-cg_kernel on`` and a resident state within tpufem's 14 MiB gate,
  the whole CG loop is one launch of the cooperative CG kernel (K4);
  with ``-use_strip 0``, or where the matrix does not fit the strip
  layout, the multi-kind DIA itself, one launch of the zone kernel per
  apply (fem.dia_zones); lattices too small for the const form use the
  per-perm StructuredOperator with the rows-zero convention;
- P2/P3 with ``-use_conv 1`` (taken first, tpufem's cgpoisson.py:131-150):
  the same matrix as a channel convolution (fem.conv_op: cuDNN's conv3d
  and 26 einsums, as tpufem's XLA form), the CG loop on its padded
  channel tensor (cgpoisson.py:279-287); the flat and strip forms need a
  DiaOperator and no longer apply;
- P2/P3 with ``-use_flat 1``: the same matrix on the channel-plane layout
  (fem.flat_op), one launch of the flat interior kernel (K5) per apply
  plus the slab corrections in torch; float32 whatever ``--dtype``, as in
  tpufem.  Where the lattice does not fit that layout, tpufem's warning
  and the strip form.

With b[bc] = 0 the Krylov trajectory on a baked operator equals the
reference's rows-zero convention (cgpoisson_problem.cpp:207).

On an unstructured mesh (the spoke mesh; tpufem/problems/cgpoisson.py:
84-107, 205-209) the operator is the gather / metric action / sorted
scatter of fem.matfree_op, one apply of the matrix-free kernel per CG
step, with the host float64 RHS and b[bc] = 0; ``-cg_kernel``,
``-use_flat`` and ``-use_strip`` stay unread there, as in tpufem.  The
spoke mesh has no Dirichlet facet, so its system is singular and CG
runs its 100 steps on it undeflated, as tpufem's does.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple

import torch

from tpufem_torch.config import Config
from tpufem_torch.fem.conv_op import ConvStencilOp
from tpufem_torch.fem.dia_op import DiaOperator, build_operator, np_dtype
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.flat_op import FlatOperator
from tpufem_torch.fem.matfree_op import MatFreePoissonOp
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.strip_op import StripOperator
from tpufem_torch.fem.structured_op import StructuredOperator
from tpufem_torch.la.cg import cg_solve_fused
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common
from tpufem_torch.problems.poisson import (assemble_poisson_rhs_np,
                                           assemble_poisson_rhs_structured_dev)
from tpufem_torch.timing import Timer, span

logger = logging.getLogger("tpufem_torch")

# tpufem's timing scheme (cgpoisson.py:295-325): the minimum over
# TIMING_PASSES passes of TIMING_REPS perturbed-RHS solves
TIMING_PASSES = 3
TIMING_REPS = 10


class Solver:
    """The matrix-free CG solve, ``(u0, rhs) -> (x, iterations)``.

    A call runs one warm solve, which it returns, then times
    ``TIMING_PASSES`` passes of ``TIMING_REPS`` perturbed-RHS solves,
    each pass ended by a device synchronisation, and keeps the fastest
    pass's seconds per solve: ``solve_s``, ``gdofs`` (the reference's
    Gdof/s), ``rel`` (the returned solve's recurrence ||r|| / ||r0||),
    and ``cg_kernel_engaged`` (True when the whole-CG kernel K4 ran the
    loop, False when the split form did)."""

    def __init__(self, op, apply: Callable[[torch.Tensor], torch.Tensor],
                 ndofs: int, rtol: float, kmax: int, acc_dtype: torch.dtype,
                 device: torch.device, cg_kernel: bool) -> None:
        self.op, self.apply, self.ndofs = op, apply, ndofs
        self.rtol, self.kmax = rtol, kmax
        self.acc_dtype, self.device = acc_dtype, device
        self.cg_kernel = cg_kernel
        # the baked conv form runs channel-resident (tpufem's run_ch,
        # cgpoisson.py:279-287)
        self.channels = (isinstance(op, ConvStencilOp)
                         and apply == op.apply)
        self.gdofs: Optional[float] = None
        self.solve_s: Optional[float] = None
        self.rel: Optional[float] = None
        self.cg_kernel_engaged: Optional[bool] = None

    def run(self, x0: torch.Tensor,
            rhs: torch.Tensor) -> Tuple[torch.Tensor, object, object]:
        """One solve from a zero guess (``x0`` is not read: the reference's
        un starts at 0 with the BC lifted into b): (x, iterations, rel);
        the K4 form returns iterations and rel as device tensors (no
        readback).  A ``solve`` span."""
        with span("solve"):
            return self._run(rhs)

    def _run(self, rhs: torch.Tensor) -> Tuple[torch.Tensor, object, object]:
        op = self.op
        if isinstance(op, StripOperator):
            # channel-resident loop: the strip relayout pays once per
            # solve; pad and guard lanes stay exactly zero, so buffer
            # dots equal dof dots
            r_f = op.to_strips(rhs)
            if self.cg_kernel:
                x_f, it, rel = op.cg_resident(r_f, self.rtol, self.kmax)
            else:
                x_f, it, rel = cg_solve_fused(op.apply_action(r_f), r_f,
                                              rtol=self.rtol, maxit=self.kmax,
                                              acc_dtype=self.acc_dtype)
            return op.from_strips(x_f, dtype=rhs.dtype), it, rel
        if self.channels:
            # channel-resident loop: the flat <-> channel relayout pays
            # once per solve; phantoms and the zero ring stay zero, so
            # tensor dots equal dof dots
            x_c, it, rel = cg_solve_fused(op.apply_channels,
                                          op.to_channels_padded(rhs),
                                          rtol=self.rtol, maxit=self.kmax,
                                          acc_dtype=self.acc_dtype)
            return op.from_channels_padded(x_c), it, rel
        if isinstance(op, FlatOperator):
            # channel-resident loop on the float32 plane buffer; pad and
            # guard lanes stay exactly zero (the fmask product)
            x_f, it, rel = cg_solve_fused(op.apply_flat, op.to_flat(rhs),
                                          rtol=self.rtol, maxit=self.kmax,
                                          acc_dtype=self.acc_dtype)
            return op.from_flat(x_f).to(rhs.dtype), it, rel
        return cg_solve_fused(self.apply, rhs, rtol=self.rtol,
                              maxit=self.kmax, acc_dtype=self.acc_dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, u0: torch.Tensor,
                 rhs: torch.Tensor) -> Tuple[torch.Tensor, int]:
        x, it, rel = self.run(u0, rhs)
        it, self.rel = int(it), float(rel)
        self._sync()
        dt = float("inf")
        for _ in range(TIMING_PASSES):
            t0 = time.perf_counter()
            for i in range(TIMING_REPS):
                self.run(u0, rhs * (1.0 + 1e-6 * (i + 1)))
            self._sync()
            dt = min(dt, (time.perf_counter() - t0) / TIMING_REPS)
        self.solve_s = dt
        self.gdofs = it * self.ndofs / dt / 1e9
        self.cg_kernel_engaged = self.cg_kernel
        print(f"CG matrix-free action processed: {self.gdofs} Gdof/s",
              flush=True)
        return x, it


def _operator(mesh: BoxTetMesh, order: int, bc: DirichletBC, cfg: Config,
              dtype: torch.dtype, device: torch.device):
    """tpufem's operator decision chain (cgpoisson.py:110-212): (the
    operator, its apply: the baked operator's own, or the rows-zero
    convention for an unbaked one)."""
    extra = cfg.solver.extra
    consumed = cfg.solver._consumed
    # P2/P3: the DIA's device state ships only if it stays the operator
    op = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                        dtype=dtype, device=device if order == 1 else None,
                        bake_bc=True)
    baked = isinstance(op, DiaOperator) and op.is_const()
    if not baked:
        op = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                            dtype=dtype, device=device, bake_bc=False)
    if (order >= 2 and isinstance(op, DiaOperator) and op.is_const()
            and extra.get("use_conv")):
        # -use_conv 1: the same matrix as a channel convolution
        # (fem.conv_op); taken first, so the flat and strip forms, which
        # need a DiaOperator, no longer apply
        try:
            op = ConvStencilOp.from_dia(op, dtype=dtype, device=device)
        except ValueError:
            pass
    if "use_conv" in extra:
        consumed.add("use_conv")
    if "use_pallas" in extra:
        consumed.add("use_pallas")
        if extra["use_pallas"]:
            logger.info("use_pallas ignored: the CUDA stencil kernel is "
                        "already the P1 operator")
    if (order >= 2 and baked and isinstance(op, DiaOperator)
            and extra.get("use_flat")):
        fop = FlatOperator.from_dia(op, device=device)
        if fop is None:
            logger.warning("use_flat ignored: operator structure does not fit "
                           "(non-unit shifts, tiny grid, or bs > 1)")
        else:
            if dtype != torch.float32:
                logger.info("use_flat: the channel-plane operator and its CG "
                            "loop run in float32 (as tpufem's flat form), "
                            "whatever --dtype")
            op = fop
    consumed.add("use_flat")
    use_strip = int(extra.get("use_strip", 1))
    consumed.add("use_strip")
    if order >= 2 and baked and isinstance(op, DiaOperator):
        sop = (StripOperator.from_dia(op, dtype=dtype, device=device)
               if use_strip else None)
        op = op._finalize(device) if sop is None else sop
    apply = op.apply if baked else op.apply_bc_rows_zero
    return op, apply


def problem(mesh, order: int, cfg: Config,
            device: torch.device) -> common.Problem:
    dtype, acc_dtype = common.resolve_dtype(cfg)
    structured = isinstance(mesh, BoxTetMesh)

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order)
        if not structured:
            _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(common.poisson_bc_marker)
        bc = DirichletBC.from_space(space, facets)

    rhs_op = None
    with Timer("ZZZ Assemble vector", device):
        # matrix-free lifting vanishes (u0 = 0); b[bc] = 0 zeroes the
        # columns of A (cgpoisson_problem.cpp:159-168)
        if dtype == torch.float32 and structured:
            if order == 1:
                rhs_op = DiaOperator.build(mesh, 1, "mass", dtype=dtype,
                                           device=device)
            else:
                rhs_op = StructuredOperator.build(mesh, order, "mass",
                                                  dtype=dtype, device=device)
            b = assemble_poisson_rhs_structured_dev(space, bc, rhs_op)
        else:
            b_np = assemble_poisson_rhs_np(space)
            b_np[bc.flat_dofs()] = 0.0
            b = torch.from_numpy(b_np.astype(np_dtype(dtype))).to(device)

    with Timer("ZZZ Assemble matrix", device):
        if structured:
            op, apply = _operator(mesh, order, bc, cfg, dtype, device)
        else:
            op = MatFreePoissonOp.build(space, bc, dtype, device)
            apply = op.apply

    solver_opts = cfg.solver
    rtol = float(solver_opts.extra.get("cg_rtol", 1e-6))
    kmax = int(solver_opts.extra.get("cg_kmax", 100))
    solver_opts._consumed.update(("cg_rtol", "cg_kmax"))
    use_ck = False
    if isinstance(op, StripOperator):
        # read only where the whole-CG kernel could run, as tpufem does
        # (tpufem/problems/cgpoisson.py:232-234): elsewhere it is left over
        solver_opts._consumed.add("cg_kernel")
        use_ck = (str(solver_opts.extra.get("cg_kernel", "off")) == "on"
                  and op.cg_kernel_ok)
    u = torch.zeros(space.ndofs, dtype=dtype, device=device)
    solver = Solver(op, apply, space.ndofs, rtol, kmax, acc_dtype, device,
                    cg_kernel=use_ck)
    return common.Problem(b=b, u=u, solver_function=solver, space=space,
                          bc=bc, rhs_op=rhs_op)
