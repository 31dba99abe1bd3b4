"""Conjugate gradients (counterpart of tpufem/la/cg.py): preconditioned
``cg_solve`` (:24-79) and the Chronopoulos-Gear ``cg_solve_fused``
(:82-158).

tpufem runs the loop as a ``lax.while_loop`` on the device.  Here it is
a Python loop over device tensors with ONE scalar readback per iteration
(the convergence test); every other scalar (alpha, beta, the residual
norms) stays a 0-d device tensor.  The iterates are those of tpufem's
"z-first" rotation: a zero initial guess (r0 = b, no operator
application), beta = 0 at k = 0, and the test of src/cg.h:78,
``k < maxit and ||r||^2 > rtol^2 ||r0||^2`` on the unpreconditioned
recurrence residual.

Each iteration is a ``cg.step`` span (``tpufem_torch.timing``) holding
``cg.apply`` (the operator's action), ``cg.precond`` (the
preconditioner) and ``cg.update`` (the dots and vector updates); each
scalar readback is a ``cg.readback`` span and counts one
``cg.readbacks``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpufem_torch.la.vector import dot
from tpufem_torch.timing import count, span


def _above(v: torch.Tensor, thresh: torch.Tensor) -> bool:
    """The loop test's readback: ``v > thresh`` on the host."""
    with span("cg.readback"):
        count("cg.readbacks")
        return bool(v > thresh)


def _rel(rr: torch.Tensor, rr0: torch.Tensor) -> float:
    """The final readback: ``sqrt(rr / rr0)`` on the host."""
    with span("cg.readback"):
        count("cg.readbacks")
        return float(torch.sqrt(rr / rr0))


def cg_solve(action: Callable[[torch.Tensor], torch.Tensor],
             b: torch.Tensor,
             x0: Optional[torch.Tensor] = None,
             precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
             rtol: float = 1e-8,
             maxit: int = 100,
             acc_dtype: Optional[torch.dtype] = None,
             dot_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]] = None,
             ) -> Tuple[torch.Tensor, int, float]:
    """Solve A x = b.  Returns (x, iterations, ||r|| / ||r0||).

    ``acc_dtype`` is the accumulation dtype of the dots (default b's);
    ``dot_fn`` replaces the dot itself (the sharded solvers' owned-masked
    sum over every shard, tpufem/la/cg.py:24-31)."""
    if dot_fn is None:
        dot_fn = lambda u, v: dot(u, v, acc_dtype)  # noqa: E731
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        with span("cg.apply"):
            ax0 = action(x0)
        r = b - ax0
    rnorm0 = dot_fn(r, r)
    thresh = rtol * rtol * rnorm0
    p = rz_prev = None
    rnorm = rnorm0
    k = 0
    while k < maxit and _above(rnorm, thresh):
        with span("cg.step"):
            if precond is None:
                z = r
            else:
                with span("cg.precond"):
                    z = precond(r)
            with span("cg.update"):
                rz = dot_fn(r, z)
                p = z if k == 0 else z + (rz / rz_prev).to(b.dtype) * p
            with span("cg.apply"):
                y = action(p)
            with span("cg.update"):
                alpha = (rz / dot_fn(p, y)).to(b.dtype)
                x = x + alpha * p
                r = r - alpha * y
                rz_prev = rz
                rnorm = dot_fn(r, r)
        k += 1
    return x, k, _rel(rnorm, rnorm0)


def cg_solve_fused(action: Callable[[torch.Tensor], torch.Tensor],
                   b: torch.Tensor,
                   rtol: float = 1e-8,
                   maxit: int = 100,
                   acc_dtype: Optional[torch.dtype] = None,
                   ) -> Tuple[torch.Tensor, int, float]:
    """Unpreconditioned CG in the Chronopoulos-Gear single-matvec form
    (counterpart of tpufem/la/cg.py:82-158, ``cg_solve_fused``), from a
    zero initial guess.  Returns (x, iterations, ||r|| / ||r0||).

    The same Krylov trajectory as ``cg_solve`` in exact arithmetic: per
    iteration one matvec w = A r and the two reductions w.r, r.r, and
    the four updates use only known scalars:

        p' = r + beta p        s' = w + beta s   (s = A p, no second matvec)
        x' = x + alpha p'      r' = r - alpha s'

    with beta_k = rr_k / rr_{k-1} (0 at k = 0) and alpha_k = rr_k /
    (w_k.r_k - beta_k rr_k / alpha_{k-1}), alpha_{-1} = 1.  The loop test
    is tpufem's ``k < maxit and rr > rtol^2 rr0`` (reference
    src/cg.h:78), one scalar readback per iteration."""
    dt = b.dtype
    x = torch.zeros_like(b)
    r = b
    rr0 = dot(r, r, acc_dtype)
    thresh = rtol * rtol * rr0
    p = s = torch.zeros_like(b)
    rr = rr0
    rr_prev = alpha_prev = torch.ones_like(rr0)
    k = 0
    while k < maxit and _above(rr, thresh):
        with span("cg.step"):
            with span("cg.apply"):
                w = action(r)
            with span("cg.update"):
                wr = dot(w, r, acc_dtype)
                beta = torch.zeros_like(rr) if k == 0 else rr / rr_prev
                alpha = rr / (wr - beta * rr / alpha_prev)
                a, bt = alpha.to(dt), beta.to(dt)
                p = r + bt * p
                s = w + bt * s
                x = x + a * p
                r = r - a * s
                rr_prev, rr, alpha_prev = rr, dot(r, r, acc_dtype), alpha
        k += 1
    return x, k, _rel(rr, rr0)
