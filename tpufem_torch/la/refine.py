"""True-residual certification + mixed-precision iterative refinement
(tpufem/la/refine.py, copied: it is pure numpy, but tpufem's ``la``
package imports jax), with the port's spans.

The reference runs the whole pipeline in double precision (PetscScalar =
double, src/poisson_problem.cpp:27) and converges CG to ``-ksp_rtol
1.0e-8`` (README.md:72) on the recurrence residual (src/cg.h:78).  The
production path solves in float32 on the device, where the recurrence
residual keeps contracting long after the TRUE residual
||b - A x|| / ||b|| has stalled near f32 working precision.

This module closes that gap the mixed-precision way:

- :class:`Certifier` holds a float64 HOST twin of the assembled system
  (the same operator construction evaluated in f64 — one numpy stencil /
  CSR apply per check, off the device hot path) and measures the true
  relative residual of any candidate solution;
- :meth:`Certifier.certify` runs classical iterative refinement
  (Wilkinson): the f32 device solve is the inner solver, the residual is
  computed in f64, and the iterate accumulates in f64.  Each pass
  contracts the true residual by roughly the limiting accuracy of the
  f32 solve (~1e-5), so ONE pass typically lands below 1e-8 and two are
  ample.  The refined f64 iterate is the certified solution; its f32
  cast goes back to the device.

Each refinement pass is a ``certify.pass`` span (``tpufem_torch.timing``;
the correction solve is its child), and each pass kept counts one
``certify.passes``.

Cost per certified solve: one to two f64 host applies (~O(nnz) numpy)
plus at most ``max_passes`` extra device solves — outside the CG
iteration loop, so warm per-iteration throughput is untouched.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

from tpufem_torch.timing import count, span


class Certifier:
    """f64 true-residual check + iterative refinement loop.

    Parameters
    ----------
    apply64 : callable ``(np.ndarray[f64]) -> np.ndarray[f64]``
        Host float64 application of the (BC-eliminated) system operator.
    b64 : np.ndarray
        Host float64 right-hand side of the same system.
    rtol : float
        The contract: refinement stops once ``||b - A x|| / ||b|| <=
        rtol`` (the reference's -ksp_rtol, README.md:72).
    """

    def __init__(self, apply64: Callable[[np.ndarray], np.ndarray],
                 b64: np.ndarray, rtol: float):
        self.apply64 = apply64
        self.b64 = np.asarray(b64, dtype=np.float64)
        self.bnorm = float(np.linalg.norm(self.b64))
        self.rtol = float(rtol)

    def residual(self, x64: np.ndarray) -> Tuple[np.ndarray, float]:
        """r = b - A x in f64; returns (r, ||r|| / ||b||)."""
        r = self.b64 - self.apply64(np.asarray(x64, dtype=np.float64))
        denom = self.bnorm if self.bnorm > 0.0 else 1.0
        return r, float(np.linalg.norm(r)) / denom

    def certify(self, x: np.ndarray,
                solve_correction: Optional[Callable[[np.ndarray],
                                                    Tuple[np.ndarray, int]]],
                max_passes: int = 3) -> "CertifyResult":
        """Measure, and refine while the contract is unmet.

        ``solve_correction(r) -> (d, iterations)`` solves ``A d = r``
        with the production (f32 device) solver; ``None`` or
        ``max_passes=0`` measures only.
        """
        t0 = time.perf_counter()
        x64 = np.asarray(x, dtype=np.float64)
        r, rel = self.residual(x64)
        passes = 0
        extra_it = 0
        while (solve_correction is not None and np.isfinite(rel)
               and rel > self.rtol and passes < max_passes):
            with span("certify.pass"):
                d, it = solve_correction(r)
                x64_new = x64 + np.asarray(d, dtype=np.float64)
                r_new, rel_new = self.residual(x64_new)
            if not np.isfinite(rel_new) or rel_new >= rel:
                # a diverged/NaN correction must not destroy the best
                # iterate: keep x64 and report its (finite) residual
                break
            x64, r, rel = x64_new, r_new, rel_new
            passes += 1
            count("certify.passes")
            extra_it += int(it)
        return CertifyResult(x64=x64, true_rel=rel, passes=passes,
                             extra_iterations=extra_it,
                             seconds=time.perf_counter() - t0)


class CertifyResult:
    __slots__ = ("x64", "true_rel", "passes", "extra_iterations", "seconds")

    def __init__(self, x64, true_rel, passes, extra_iterations, seconds):
        self.x64 = x64
        self.true_rel = true_rel
        self.passes = passes
        self.extra_iterations = extra_iterations
        self.seconds = seconds
