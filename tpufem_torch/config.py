"""Typed configuration (the port's copy of tpufem/config.py, without
its jax compilation-cache helper; the fields and defaults are tpufem's).

Mirrors the reference's two-namespace flag scheme: double-hyphen app
options (reference: src/main.cpp:54-74, boost::program_options) and a
pass-through solver-options namespace (reference: src/main.cpp:77-81,
PETSc options DB with ``allow_unregistered`` + ``-options_left`` audit).
Here both are typed dataclasses; unknown solver keys are accepted and
audited with a warn-on-unused report (the `-options_left` analogue).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List

logger = logging.getLogger("tpufem_torch")


@dataclasses.dataclass
class SolverOptions:
    """Solver-options namespace.

    Mirrors the recommended PETSc knobs from the reference README
    (README.md:66-146): CG + rtol, AMG controls (GAMG/BoomerAMG
    equivalents of the from-scratch SA-AMG), Chebyshev/Jacobi smoothers.
    """

    ksp_type: str = "cg"                 # "cg" (only Krylov method the reference uses)
    ksp_rtol: float = 1.0e-8             # README.md:72 -ksp_rtol 1.0e-8
    ksp_max_it: int = 500
    pc_type: str = "auto"                # auto | gmg | amg | jacobi | none
    # auto = geometric multigrid on the structured cube mesh, SA-AMG on
    # unstructured meshes (both replace PETSc GAMG / Hypre BoomerAMG)
    # SA-AMG controls (functional equivalent of GAMG/BoomerAMG knobs)
    amg_coarse_eq_limit: int = 1000      # README.md:77 -pc_gamg_coarse_eq_limit 1000
    amg_strength_threshold: float = 0.0  # SA strength-of-connection drop tolerance
    amg_max_levels: int = 12
    amg_smoother: str = "chebyshev"      # README.md:78 -mg_levels_ksp_type chebyshev
    amg_smoother_degree: int = 2
    amg_dense_level_limit: int = 32768   # levels at/below this size run
    # dense MXU matvecs (random ELL gathers measured ~7 cycles/element on
    # v5e; a 15k dense f32 matmul is ~6x faster than the K=60 ELL SpMV).
    # The row cap is additionally gated by a device-byte budget in
    # SAAMG.setup (bf16 storage for f32 solves), so the effective limit
    # is ~27k rows bf16 / ~13k rows f64.
    amg_aggressive_levels: int = 1       # distance-2 (composed) aggregation
    # on the finest k levels — BoomerAMG's agg_nl (the reference runs
    # -pc_hypre_boomeramg_agg_nl 4, README.md:125).  Keeps every coarse
    # level inside the dense-MXU regime (a 500k fine level coarsens to
    # ~5k instead of ~34k rows of gather-bound ELL).
    amg_filter_k: int = 4                # keep k largest P entries/row, lump
    # the rest into the survivors (transfer gathers are the TPU V-cycle
    # bottleneck; the -pc_gamg_threshold filtering analogue).  Scalar
    # nullspaces only — auto-disabled when the near-nullspace has >1
    # column (lumping preserves constants, not rotations; elasticity
    # measured 15 its unfiltered vs 73 at k=4 — la/amg.py)
    amg_brick: str = "auto"              # auto | off — lattice-brick SA-AMG
    # (la/bramg.py) on structured P1 problems: 3x3x3 geometric aggregates
    # make every coarse level a gather-free 27-point block stencil and the
    # setup a device probing pass (no CSR export / scipy SpGEMM).  "off"
    # falls back to the generic SA path (la/amg.py).
    amg_fine_window: str = "auto"        # auto | on | off — RCM + block-
    # windowed fine-level SpMV on unstructured meshes (fem.window_op):
    # trades a dense-window value buffer (~350x the CSR bytes) for a
    # gather-free apply, ~8x faster on v5e.  "auto" uses it when the
    # buffer fits the byte budget below; coarse levels stay ELL/dense.
    amg_window_budget_mb: int = 4096
    amg_window_bf16: str = "off"         # on | off — store the V-cycle
    # fine-level twin of the windowed operator in bfloat16 (halved
    # streaming traffic; CG's own matvec stays exact f32).  Off by
    # default: on the spoke mesh's wildly-scaled entries the bf16
    # smoother stalls CG at ~2e-2 where the f32 twin reaches the
    # refinement-engagement threshold and closes the 1e-8 contract.
    # f32 fidelity contract (the reference solves in f64 end-to-end,
    # src/poisson_problem.cpp:27 PetscScalar): after the device solve,
    # measure the TRUE residual ||b - A x|| / ||b|| against a float64
    # host twin of the assembled system, and run mixed-precision
    # iterative refinement (f32 device solves as the inner solver, f64
    # residual + iterate accumulation) until it meets ksp_rtol
    ksp_true_residual: str = "on"        # on | off
    ksp_refine_max: int = 3              # max refinement passes (f32 runs)
    amg_jacobi_omega: float = 0.6667
    amg_prolongator_damping: float = 1.3333  # omega/rho(D^-1 A) Jacobi smoothing of P
    # extras (audited if unused)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _consumed: set = dataclasses.field(default_factory=set, repr=False)

    def get(self, key: str, default: Any = None) -> Any:
        self._consumed.add(key)
        if hasattr(self, key):
            return getattr(self, key)
        return self.extra.get(key, default)

    def options_left(self) -> List[str]:
        """Unconsumed extra options — the `-options_left` audit
        (reference: README.md:81)."""
        return [k for k in self.extra if k not in self._consumed]

    def warn_options_left(self) -> None:
        for k in self.options_left():
            logger.warning("Option left: unused solver option '%s'", k)


@dataclasses.dataclass
class Config:
    """Application options (reference: src/main.cpp:57-74)."""

    problem_type: str = "poisson"        # poisson | cgpoisson | elasticity
    mesh_type: str = "cube"              # cube | unstructured
    scaling_type: str = "weak"           # weak | strong
    ndofs: int = 50000
    order: int = 1
    scatterer: str = "neighbor"          # neighbor | p2p (ppermute schedule variant)
    output: str = ""                     # output directory ("" = no output)
    memory_profiling: bool = False
    subcomm_partition: bool = False      # per-host setup analogue; accepted for parity
    # TPU-specific knobs (no reference analogue)
    dtype: str = "float32"               # float32 | float64 | mixed
    num_shards: int = 0                  # 0 = all visible devices
    solver: SolverOptions = dataclasses.field(default_factory=SolverOptions)

    def __post_init__(self) -> None:
        if self.scaling_type not in ("weak", "strong"):
            # reference: src/main.cpp:115 throws on unknown scaling type
            raise ValueError(f"Scaling type '{self.scaling_type}' unknown")
        if self.problem_type not in ("poisson", "cgpoisson", "elasticity"):
            raise ValueError(f"Unknown problem type: {self.problem_type}")

    @property
    def dofs_per_node(self) -> int:
        # reference: src/main.cpp:128
        return 3 if self.problem_type == "elasticity" else 1
