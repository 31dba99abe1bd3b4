#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (tpufem_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no phase carries on after one):

1. environment: the card's name and power limit (nvidia-smi), torch,
   CUDA and nvcc versions, and the build of tpufem_torch/csrc/*.cu;
2. the main path: ``python -m tpufem_torch --ndofs 500000 --scaling_type
   strong --dtype float32 -pc_type gmg`` through tpufem_torch.cli, which
   must launch the stencil kernel (counted from zero around this run
   only), converge, and certify a true residual <= 1e-8; then warm
   solves and a warm build of the problem (the bench headline's terms);
3. the stencil kernel against its plain PyTorch version on the card, on
   the operators the main path built (the CG matrix, the four smoothed
   GMG levels and the RHS mass operator, zone form = TPU kernel K1; the
   CG matrix in full-field form = K2), in float32 and float64, through
   the public ``stencil_apply`` and the prepared launch an operator
   keeps, with median times, the wrapper's host cost, the bound and, on
   the CG matrix, ``torch.sparse.mm`` of its CSR (the library yardstick,
   also in phases 6 and 10);
4. float64 on the card: the poisson50k golden of tests/test_golden.py
   (10 iterations, norm 48.94285576880367 at rel 1e-9);
5. the matrix-free cgpoisson path at the bench's sizes: ``python -m
   tpufem_torch --problem_type cgpoisson --order 2|3 --ndofs 500000
   --scaling_type strong --dtype float32``, which must launch the strip
   kernel (K3, counted from zero around each run), run 100 iterations
   and agree with tpufem's own float32 CPU run (CGPOISSON_REF);
6. the strip kernel against its plain version on the P2 and P3
   operators those runs built, in float32 and, with the same tables
   cast, float64, with times, the wrapper's host cost and the bound
   (and again on the P3 150k operator of phase 7, the small float64 P3
   operator of phase 9 and a 40x6x6-cube P3 operator: other z extents,
   and a halo so wide that the delta weights stay in global memory);
7. cgpoisson P3 at 150k with ``-cg_kernel off`` and then ``on``: the
   whole-CG kernel (K4) must engage and launch, and the two solutions
   agree; K4 against its plain version in float32 there and in float64
   at a size within the residency gate, with its time per solve beside
   the time of the same grid through the grid barriers alone
   (``barrier_floor_ms``);
8. cgpoisson P2 and P3 at 500k with ``-use_flat 1``: the channel-plane
   operator, which must launch the flat interior kernel (K5, counted
   from zero around each run) and no strip kernel, run 100 iterations
   and agree with tpufem's own float32 CPU flat run (CGPOISSON_REF); its
   apply must equal the strip apply of phase 5 (the same matrix), and a
   solve of each form to rtol 1e-6 the other's; K5 against its plain
   version in float32 and, with the tables cast, float64, with times,
   the wrapper's host cost, the bound and one ``torch.bmm`` of the same
   product;
9. float64 goldens of the matrix-free path: cgpoisson15k of
   tests/test_golden.py (P1 through the stencil kernel, 100 iterations,
   norm 26.535020300527723 at rel 1e-9) and P3 at 9,025 dofs against
   tpufem's CPU run (CGPOISSON_REF);
10. elasticity: ``python -m tpufem_torch --problem_type elasticity --ndofs
   500000 --scaling_type strong --dtype float32 -pc_type gmg`` (468,195
   dofs, the planar bs = 3 operator), which must launch the
   three-component form of the stencil kernel (counted from zero around
   this run only), converge in under 100 iterations and certify a true
   residual <= 1e-8; warm solves and a warm build; the f64 elasticity100k
   golden of tests/test_golden.py (18 iterations, norm
   6.784162962970475e-05 at rel 1e-9); the three-component kernel against
   its plain version on the CG matrix (zone and full-field forms) and the
   four smoothed GMG levels, in float32 and float64, with times, the
   wrapper's host cost and the bound;
11. brick-AMG (``-pc_type amg``): tpufem's bench rows ``poisson_amg``
   (60^3 lattice), ``poisson_amg_500k`` and ``elasticity_amg_500k``
   through the port's problem API, f32, rtol 1e-8, each with the stencil
   and brick_flat launches counted from zero around its build and first
   solve (iterations within 1 of tpufem's 13 / 17 / 19, certified
   true_rel <= 1e-8 in at most 3 refinement passes), warm solves, a timed
   second build and the V-cycle split; the brick_flat kernel against its
   plain version on the level-1 operators of the three rows (m = 1 and m
   = 6) and three edge grids, in float32 and float64 (the same bits), with
   times, the host cost, the bound and ``torch.sparse.mm`` of the same
   operator as the library yardstick; and the float64 goldens of tpufem's
   brick-AMG runs
   (elasticity 100k: 20 iterations; poisson 50k: 13; norms to rel 1e-9);
12. P2/P3 Poisson: ``python -m tpufem_torch --problem_type poisson --order
   2|3 --ndofs 500000 --scaling_type strong --dtype float32 -pc_type
   gmg`` (CG + GMG with the p-transfer to P1), each of which must launch
   the multi-kind zone kernel (dia_zones, the fine level) and K1 (the
   P1 levels), counted from zero around the run, converge within one
   iteration of tpufem's own float32 CPU run (POISSON_PK_REF) and
   certify a true residual <= 1e-8; warm solves and a warm build; the
   zone kernel against its plain version on the two fine operators, a
   P3 operator with edge grids of 6 planes and a dense-mode P2 operator,
   in float32 and float64 (the same bits), with times, the host cost,
   the bound, ``torch.sparse.mm`` of the CSR and K3 on the same matrix in
   strip form; the float64 order3 golden of tests/test_golden.py (19
   iterations, norm 25.64720150160304 at rel 1e-9); and ``cgpoisson
   --order 3 --ndofs 500000 --scaling_type strong --dtype float32
   -use_strip 0``, which must launch the zone kernel and no K3, run 100
   iterations and agree with tpufem's float32 DIA run (CGPOISSON_REF),
   and whose solve to rtol 1e-6 must agree with the strip form's;
13. P2/P3 elasticity: ``python -m tpufem_torch --problem_type elasticity
   --order 2|3 --ndofs 500000 --scaling_type strong --dtype float32
   -pc_type gmg`` (the blocked per-perm fine level, planar, the
   p-transfer to the P1 levels), each of which must launch the perm_apply
   kernel (5 a CG iteration) and the three-component K1 (the P1 levels),
   counted from zero around the run, build tpufem's GMG hierarchy,
   converge within one iteration of tpufem's own float32 CPU run
   (ELASTICITY_PK_REF) and certify a true residual <= 1e-8; warm solves
   and a warm build; perm_apply against its plain version on the two fine
   operators and two small lattices, in float32 and float64 (within
   ``perm_apply_bound``), with times, the host cost, the bound (bytes,
   the needed operations 2 nnz, beside the per-perm form's count) and
   ``torch.sparse.mm`` of the planar CSR; and tpufem's float64 P2 (10,647
   dofs) and P3 (9,633) runs on the card (ELASTICITY_PK_GOLD, rel 1e-9).

14. SA-AMG (tpufem's generic smoothed aggregation, la.amg): the spoke
   mesh's Poisson P1 through the CLI at tpufem's two bench sizes
   (``--mesh_type unstructured --ndofs 150000|500000 --scaling_type
   strong --dtype float32 -ksp_max_it 120``: 149,871 / 499,964 dofs,
   tpufem's level sizes, the 120-iteration cap, certified true residual
   <= 1e-8 in at most 3 refinement passes, printed beside tpufem's 2 / 2)
   and the cube's SA-AMG at 500k, f32 (Poisson P1 ``-amg_brick off``,
   Poisson P2 ``-pc_type amg``, elasticity P1 ``-amg_brick off``: levels
   as tpufem's, iterations within one of tpufem's float32 CPU runs,
   SAAMG_REF, certified), each with the CSR and dense kernels' launches
   counted from zero around its run, warm solves, launches per CG
   iteration and the warm solve's device-busy share; the CSR kernel
   against its plain version on the path's matrices (the spoke 500k
   fine operator in float32, float64 and bf16, its P and P^T and its
   level-1 P and P^T, a sparse coarse level, the cube's P0, which has
   empty rows, P0^T and its level-1 P and P^T), the same bits on two
   launches, and the bf16 dense kernel on
   the spoke 500k dense level and elasticity P1's level 1 (9,512 and
   18,840 rows), with times, the host cost, the bound and the share of
   it, the floor of the method (an empty launch and an elementwise pass
   over y after the same flush) and
   torch.sparse.mm / torch.matmul beside them; tpufem's four float64
   SA-AMG runs (SAAMG_GOLDS: iterations exact, norms to rel 1e-9).
15. the spoke mesh's remaining problems: the matrix-free cgpoisson
   (``--mesh_type unstructured --order 1 --ndofs 500000`` and ``--order
   2|3 --ndofs 150000``, strong, float32), each of which must launch the
   matrix-free kernel (matfree_action, counted from zero around the run)
   and no other operator kernel, run 100 steps and agree with tpufem's own
   float32 CPU run (SPOKE_CG_REF, within CG_SPOKE_NORM_TOL /
   CG_SPOKE_REL_TOL: the singular system's trajectory amplifies
   rounding); the kernel against its plain version on those three
   operators in float32 and float64 (the same bits twice, within
   matfree_action_bound), with times, the host cost, the bound, the
   cluster plan's halo share and largest cluster and torch.sparse.mm of
   the assembled CSR at P1 and P2; Poisson P2 150k and
   P3 50k on SA-AMG (levels as tpufem's, iterations within one of its
   float32 CPU runs, certified, SPOKE_PK_REF); elasticity 150k for 8
   steps (the bs = 3 hierarchy on csr_spmv, its norm against tpufem's;
   the system is singular and CG diverges, as in tpufem); and tpufem's
   float64 runs at 3,000 dofs (SPOKE_F64_GOLDS).
16. sharded runs (``--num_shards``, the shards of the process as one
   stacked tensor on the card; tpufem_torch/parallel): Poisson P1 and P2
   and elasticity P1 500k f32 over 4 slabs, each against
   ``--num_shards 1`` in the phase (iterations within 1, solutions within
   SHARD_F32_X_TOL, the median of 3 warm solves of the same RHS on both
   sides), each of which must launch K1 / dia_zones / the three-component
   K1; cgpoisson P3 150k over 4 slabs, which must launch dia_zones (100
   steps, Gdof/s, tpufem's sharded f32 run, SHARD_CG_REF); tpufem's
   sharded float64 goldens (SHARD_GOLDS, to the
   iteration and rel 1e-9); the spoke's row-sharded Poisson P1 150k over
   2 shards, which must launch csr_spmv, certified in float64 through the
   sharded solver against the single-device run (SPOKE_SHARD_NORM_TOL);
   the process-group form, one rank over NCCL (poisson100k-8shard); K1,
   the three-component K1, dia_zones and csr_spmv against their plain
   versions on the shard shapes.  Every kernel's launches counted from
   zero around each run and printed.

Device times come from the profiler's spans of the kernel itself, each
timed call after a read of 256 MB that evicts the L2 (``device_ms``);
the count of spans must match the launches, and a reading under the
kernel's bound is printed and recorded as "below bound", not as a time
(for the two dense levels, perm_apply on P3 500k and brick_flat on the
500k AMG levels it fails the run).

The last lines are a JSON record of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository around it, the script fails before
printing them.  At its end it checks that ``tpufem`` was never imported.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

TOL_F32 = 1e-5   # 15-term sums: |kernel - plain| <= 15 eps |terms|, x10
TOL_F64 = 1e-13  # same bound in float64
TOL_BS3_F32 = 3e-5   # the three-component form: 45-term sums, 45 eps x10
TOL_BS3_F64 = 1e-13  # 45 * 2^-53 = 5e-15, x10 and more
MAIN_ARGS = ["--problem_type", "poisson", "--ndofs", "500000",
             "--scaling_type", "strong", "--dtype", "float32",
             "-pc_type", "gmg", "-ksp_rtol", "1e-8", "-ksp_max_it", "100",
             "--device", "cuda"]
GOLD_ARGS = ["--problem_type", "poisson", "--ndofs", "50000",
             "--scaling_type", "weak", "--dtype", "float64",
             "-ksp_rtol", "1e-8", "--device", "cuda"]
GOLD_ITERATIONS, GOLD_NORM = 10, 48.94285576880367
CG_ARGS = ["--problem_type", "cgpoisson", "--scaling_type", "strong",
           "--dtype", "float32", "--device", "cuda"]
CG15K_ARGS = ["--problem_type", "cgpoisson", "--ndofs", "15000",
              "--dtype", "float64", "--device", "cuda"]
CG15K_NORM = 26.535020300527723
ELAST_ARGS = ["--problem_type", "elasticity", "--ndofs", "500000",
              "--scaling_type", "strong", "--dtype", "float32",
              "-pc_type", "gmg", "-ksp_rtol", "1e-8", "-ksp_max_it", "100",
              "--device", "cuda"]
ELAST_DOFS = 468195
ELAST_GOLD_ARGS = ["--problem_type", "elasticity", "--ndofs", "100000",
                   "--scaling_type", "weak", "--dtype", "float64",
                   "-ksp_rtol", "1e-8", "--device", "cuda"]
ELAST_GOLD_ITERATIONS, ELAST_GOLD_NORM = 18, 6.784162962970475e-05
# tpufem's own matrix-free cgpoisson runs on the CPU (jax 0.9.0, x64 off
# in float32, as tpufem's CLI runs it), from
#   python scripts/cgpoisson_reference.py --order O --ndofs N \
#       --scaling_type S --dtype D [--flat]
# (order, ndofs arg, scaling, dtype[, "flat"]) -> (ndofs, iterations,
# rel, norm)
CGPOISSON_REF = {
    (2, 500000, "strong", "float32", "flat"): (510705, 100,
                                               0.4377756714820862,
                                               123.99197587640391),
    (3, 500000, "strong", "float32", "flat"): (516913, 100,
                                               0.7471747398376465,
                                               97.32275916772949),
    (2, 500000, "strong", "float32"): (510705, 100, 0.41542431712150574,
                                       134.25605721102153),
    (3, 500000, "strong", "float32"): (516913, 100, 0.6869486570358276,
                                       106.23303603446594),
    (3, 150000, "strong", "float32"): (146461, 100, 0.4011581242084503,
                                       77.29297299152508),
    (3, 10000, "weak", "float64"): (9025, 100, 0.00014496547881479667,
                                    20.20326073714228),
    # -use_strip 0, the baked DIA operator: scripts/poisson_pk_reference.py
    # --problem_type cgpoisson --order 3 --ndofs 500000 --dtype float32
    (3, 500000, "strong", "float32", "dia"): (516913, 100,
                                              0.6854984164237976,
                                              106.23026483542395),
}
# float32 after 100 CG steps depends on the summation order: tpufem's own
# float32 CPU run sits 5.5e-4 (norm) and 1.9e-3 (rel) off its float64 run
# at P3 150k, and 7.0e-4 / 2.1e-3 at P2 500k, while the port's float32 CPU
# run sits within 4.5e-5 / 3.4e-4 of them; so the port's float32 run is
# held to tpufem's float32 values within:
CG_F32_NORM_TOL, CG_F32_REL_TOL = 3e-3, 1e-2
# two float32 CG forms of one solve (K4 vs the split form, K4 vs its
# plain version), norm-wise on x; 4.7e-5 measured on the CPU at P3 150k
CG_F32_X_TOL = 1e-3
# float64: the norm to rel 1e-9; the recurrence rel (1.45e-4 at P3 9,025
# dofs) only to 1e-2: it moves by ~cond(A) times the rounding of x (the
# port's CPU run sits 6.6e-4 off tpufem's, the card's run 2.8e-3 off,
# with the norms within 1e-11)
CG_F64_TOL, CG_F64_REL_TOL = 1e-9, 1e-2
TOL_STRIP_F32 = 2e-5  # <= ~60 terms per element, other order: 60 eps
TOL_STRIP_F64 = 1e-13
# the flat form's float32 tables split each weight into an interior part
# and deviation parts that cancel only to float32 rounding, so its
# Dirichlet rows pick up rounding noise from their neighbours every
# apply; CG then excites the unit-eigenvalue outlier modes, and after 100
# (unconverged) steps the trajectory depends on the summation order far
# more than the strip form's: tpufem's own flat runs above end 7.6% (P2)
# and 8.4% (P3) off its strip runs in norm, and on an H100 the port's
# flat runs sat up to 6.9e-3 (norm) and 7.2e-2 (rel) off tpufem's flat
# runs.  So a flat run is held to tpufem's flat run within:
CG_FLAT_NORM_TOL, CG_FLAT_REL_TOL = 3e-2, 0.15
# and, converged (rtol 1e-6, at most CONVERGED_KMAX steps), to the strip
# form's solve of the same system within CG_F32_X_TOL (on an H100 5.4e-6
# at P2 500k and 5.5e-6 at P3 500k)
CONVERGED_RTOL, CONVERGED_KMAX = 1e-6, 3000
# |K5 - plain| <= tol * sum |WT| |x|: K = 480 terms in two orders
TOL_FLAT_F32 = 3e-5   # 480 * 2^-24
TOL_FLAT_F64 = 1e-13  # 480 * 2^-53 = 5.3e-14
TOL_APPLY = 2e-5      # two forms of one matrix: tpufem's 2e-5 * max|ref|
# tpufem's -pc_type amg bench rows (bench.py:474-599, f32, rtol 1e-8;
# BENCH.json round 5, on a TPU: only iterations and residuals are
# targets): (key, problem, lattice (None: --ndofs 500000 strong), ndofs,
# tpufem's iterations, ksp_max_it)
AMG_ROWS = (("poisson_amg", "poisson", (60, 60, 60), 226981, 13, 100),
            ("poisson_amg_500k", "poisson", None, 510705, 17, 100),
            ("elasticity_amg_500k", "elasticity", None, 468195, 19, 200))
# tpufem's own float64 CPU runs through BrickAMG: (argv, iterations, norm)
AMG_GOLDS = (
    (["--problem_type", "elasticity", "--ndofs", "100000", "--scaling_type",
      "strong", "--dtype", "float64", "-pc_type", "amg", "--device", "cuda"],
     20, 6.784162962852132e-05),
    (["--problem_type", "poisson", "--ndofs", "50000", "--scaling_type",
      "weak", "--dtype", "float64", "-ksp_rtol", "1e-8", "-pc_type", "amg",
      "--device", "cuda"], 13, 48.942855769743645))
# P2/P3 Poisson (phase 12): tpufem's own float32 CPU runs through its CLI
# (jax 0.9.0, CG + GMG to rtol 1e-8, certified), from
#   python scripts/poisson_pk_reference.py --order O --ndofs 500000 \
#       --scaling_type strong --dtype float32
# order -> (ndofs, iterations, norm, true_rel, refinement passes)
PK_ARGS = ["--problem_type", "poisson", "--ndofs", "500000",
           "--scaling_type", "strong", "--dtype", "float32",
           "-pc_type", "gmg", "-ksp_rtol", "1e-8", "-ksp_max_it", "100",
           "--device", "cuda"]
POISSON_PK_REF = {2: (510705, 10, 151.78231811523438, 2.893e-09, 1),
                  3: (516913, 16, 152.88658142089844, 5.807e-09, 1)}
ORDER3_ARGS = ["--problem_type", "poisson", "--order", "3", "--ndofs",
               "15000", "--dtype", "float64", "-ksp_rtol", "1e-8",
               "--device", "cuda"]
ORDER3_ITERATIONS, ORDER3_NORM = 19, 25.64720150160304
# P2/P3 elasticity (phase 13): tpufem's own CPU runs through its CLI (jax
# 0.9.0, CG + GMG to rtol 1e-8, certified; x64 off in float32), from
#   python scripts/poisson_pk_reference.py --problem_type elasticity \
#       --order O --ndofs 500000 --scaling_type strong --dtype float32
# order -> (ndofs, iterations, norm, true_rel, refinement passes), and
# the GMG hierarchy (level dofs, coarse dofs) with the default coarse
# limit of 1000
ELAST_PK_ARGS = ["--problem_type", "elasticity", "--ndofs", "500000",
                 "--scaling_type", "strong", "--dtype", "float32",
                 "-pc_type", "gmg", "-ksp_rtol", "1e-8", "-ksp_max_it", "100",
                 "--device", "cuda"]
ELASTICITY_PK_REF = {2: (468195, 18, 0.00014600757276639342, 9.722e-13, 2),
                     3: (525819, 34, 0.00015475328837055713, 5.004e-11, 2)}
ELASTICITY_PK_LEVELS = {2: ([468195, 61875, 8619, 1323], 240),
                        3: ([525819, 21675, 3159], 525)}
# tpufem's float64 runs (--ndofs 10000 --scaling_type weak --dtype
# float64): order -> (ndofs, iterations, norm)
ELASTICITY_PK_GOLD = {2: (10647, 19, 2.2017755354284647e-05),
                      3: (9633, 33, 2.098447872071006e-05)}
# SA-AMG (phase 14).  tpufem's spoke bench rows (bench.py:601-658;
# BENCH.json round 5, on a TPU: only ndofs, the 120-iteration cap, the
# refinement passes and the certified residual are targets), with the
# level sizes of tpufem's own setup on the CPU, from
#   python scripts/saamg_reference.py --mesh_type unstructured \
#       --ndofs N --scaling_type strong --dtype float32 --levels_only
# key -> (--ndofs, ndofs, SA-AMG levels, passes, true_rel)
SPOKE_ARGS = ["--problem_type", "poisson", "--mesh_type", "unstructured",
              "--scaling_type", "strong", "--dtype", "float32",
              "-ksp_rtol", "1e-8", "-ksp_max_it", "120", "--device", "cuda"]
SPOKE_ROWS = {
    "poisson_spoke": (150000, 149871, [149871, 3328, 84], 2, 2.16e-12),
    "poisson_spoke_500k": (500000, 499964, [499964, 9512, 199], 2, 5.624e-11)}
# the cube's SA-AMG at 500k, f32: tpufem's own CPU runs (jax 0.9.0, x64 off,
# rtol 1e-8, certified), from
#   python scripts/saamg_reference.py [--problem_type elasticity] \
#       [--order 2] --ndofs 500000 --scaling_type strong --dtype float32 \
#       -- -pc_type amg [-amg_brick off]
# key -> (options, ndofs, levels, iterations, norm, true_rel, passes)
SAAMG_BASE = ["--ndofs", "500000", "--scaling_type", "strong", "--dtype",
              "float32", "-ksp_rtol", "1e-8", "-pc_type", "amg", "--device",
              "cuda"]
SAAMG_REF = {
    "poisson_p1_amg_brick_off": (
        ["--problem_type", "poisson", "-amg_brick", "off"], 510705,
        [510705, 10023, 164], 22, 151.70169067382812, 2.498e-12, 2),
    "poisson_p2_amg": (
        ["--problem_type", "poisson", "--order", "2"], 510705,
        [510705, 3364, 44], 35, 151.78231811523438, 3.684e-09, 1),
    "elasticity_p1_amg_brick_off": (
        ["--problem_type", "elasticity", "-amg_brick", "off"], 468195,
        [468195, 18840, 348], 29, 0.00014582138101104647, 9.954e-12, 2),
}
# tpufem's float64 SA-AMG runs on the CPU (--dtype float64, weak scaling):
# argv -> (iterations, norm)
SAAMG_GOLDS = (
    (["--problem_type", "poisson", "--ndofs", "15000", "-pc_type", "amg",
      "-amg_brick", "off"], 13, 26.53502030570293),
    (["--problem_type", "poisson", "--order", "2", "--ndofs", "15000",
      "-pc_type", "amg"], 21, 26.65797245999097),
    (["--problem_type", "elasticity", "--ndofs", "10000", "-pc_type", "amg",
      "-amg_brick", "off"], 17, 2.181054945892062e-05),
    (["--problem_type", "poisson", "--mesh_type", "unstructured", "--ndofs",
      "20000"], 58, 738.3125824626104))
# The spoke mesh's remaining problems (phase 15).  tpufem's own
# matrix-free cgpoisson runs on the spoke, f32 on the CPU (jax 0.9.0, x64
# off), from
#   python scripts/cgpoisson_reference.py --mesh_type unstructured \
#       --order O --ndofs N --scaling_type strong --dtype float32
# (order, --ndofs) -> (ndofs, cells, iterations, rel, norm)
SPOKE_CG_ARGS = ["--problem_type", "cgpoisson", "--mesh_type",
                 "unstructured", "--scaling_type", "strong", "--dtype",
                 "float32", "--device", "cuda"]
SPOKE_CG_REF = {
    (1, 500000): (499964, 2644284, 100, 3.5911428928375244,
                  1153.1087498311513),
    (2, 150000): (1086647, 745612, 100, 3.8204472064971924,
                  938.7067262991673),
    (3, 150000): (3555940, 745612, 100, 4.42650032043457,
                  483.66056085258515),
}
# The spoke's cgpoisson system is singular (no Dirichlet facet) and
# inconsistent, and CG diverges on it (rel > 1 after 100 steps), so its
# float32 trajectory amplifies rounding: tpufem's own float32 loop moves
# by up to 1.17e-3 (norm) and 2.26e-2 (rel) at P1 500k, 1.60e-4 /
# 2.25e-3 at P2 150k and 1.09e-4 / 1.15e-4 at P3 150k when every entry
# of its RHS moves by one ulp (ten perturbations each,
# ``scripts/cgpoisson_reference.py --mesh_type unstructured ... --ulp_seed
# S`` for S = 1..10).  Phase 5's CG_F32_NORM_TOL / CG_F32_REL_TOL (3e-3 /
# 1e-2) are below that spread at P1; the spoke runs are held to
CG_SPOKE_NORM_TOL, CG_SPOKE_REL_TOL = 1e-2, 5e-2
# tpufem's float64 CLI runs at --ndofs 3000 (weak scaling): (problem,
# order, options) -> (iterations, norm, tolerance on the norm).  The
# 100-step cgpoisson runs at P2 / P3 move by up to 2.1e-7 / 9.9e-4 in
# tpufem's own float64 loop when its RHS moves by one ulp (ten
# perturbations, cgpoisson_reference.py --ulp_seed); 30 steps by 2.5e-13.
SPOKE_F64_GOLDS = (
    ("cgpoisson", 1, [], 100, 251.62201939995953, 1e-9),
    ("cgpoisson", 2, [], 100, 394.3962889459107, 1e-6),
    ("cgpoisson", 3, [], 100, 441.479374154072, 1e-2),
    ("cgpoisson", 2, ["-cg_kmax", "30"], 30, 154.78174093206965, 1e-9),
    ("cgpoisson", 3, ["-cg_kmax", "30"], 30, 131.05255459697148, 1e-9),
    ("poisson", 2, [], 101, 728.1316879075519, 1e-9),
    ("poisson", 3, [], 184, 1276.4638392089626, 1e-9),
    ("elasticity", 1, ["-ksp_max_it", "8"], 8, 0.0003120250060742934, 1e-9),
)
# the spoke's SA-AMG rows, f32, rtol 1e-8: tpufem's own CPU runs, from
#   python scripts/saamg_reference.py --mesh_type unstructured \
#       [--problem_type elasticity] --order O --ndofs N --scaling_type \
#       strong --dtype float32 [-- -ksp_max_it 8]
# key -> (argv, ndofs, levels, iterations, norm, true_rel, passes).  At
# order 2/3 the card's host (numpy 2.3.5, scipy 1.18.1 against 2.0.2 /
# 1.17.0 where tpufem's runs were made) assembles another CSR in the last
# bits, which moves ties of the aggregation: levels 7,102 / 122 at P2 150k
# and 2,941 / 58 at P3 50k on the card against tpufem's 7,099 / 123 and
# 2,939 / 57.  Shown by scripts/spoke_levels.py: the reference tables,
# the mesh and the metric are the same bits on both hosts; the element
# matrices (a BLAS product, fem/assemble.py:_poisson_stiffness_np) are
# the first step that differs, then the CSR (its values, and from
# --ndofs 6000 its pattern: exact-zero sums are dropped) and the RCM
# order; the smallest order-2 size whose levels differ is --ndofs 25000
# (2,342 / 53 on the card, 2,342 / 52 where tpufem ran), and that card
# CSR gives the card's levels to tpufem's setup and to the port's alike.
# A behaviour of the host's libraries, not of the port.  The coarse
# sizes of those rows are held within
SPOKE_PK_LEVELS_TOL = 0.03
SPOKE_PK_ARGS = ["--mesh_type", "unstructured", "--scaling_type", "strong",
                 "--dtype", "float32", "--device", "cuda"]
SPOKE_PK_REF = {
    "poisson_spoke_p2_150k": (
        ["--problem_type", "poisson", "--order", "2", "--ndofs", "150000"]
        + SPOKE_PK_ARGS, 1086647, [1086647, 7099, 123], 500, 5762.8125,
        4.986e-11, 2),
    "poisson_spoke_p3_50k": (
        ["--problem_type", "poisson", "--order", "3", "--ndofs", "50000"]
        + SPOKE_PK_ARGS, 1136826, [1136826, 2939, 57], 500, 5724.54296875,
        2.199e-10, 2),
    "elasticity_spoke_8": (
        ["--problem_type", "elasticity", "--ndofs", "150000",
         "-ksp_max_it", "8"] + SPOKE_PK_ARGS, 149973, [149973, 12708, 276],
        8, 0.003613180248066783, 22.97, 0),
}
# the float32 elasticity run on the spoke, 8 steps of a diverging CG on a
# singular system, amplifies rounding: tpufem's own float32 run moves its
# norm by 7.1e-5 to 1.92e-3 (median 9.0e-4) when every entry of its RHS
# moves by one ulp (ten perturbations, ``saamg_reference.py ... --ulp_seed
# S`` for S = 1..10), and the port's card runs sit 1.71e-3 off.  Held to
# tpufem's float32 norm within about 5x the largest of those moves:
SPOKE_ELAST_NORM_TOL = 1e-2
# Sharded runs (phase 16): --num_shards N on the one card, the shards of a
# process as one stacked tensor (tpufem_torch/parallel).  The float32 runs
# are held to the port's own single-device run of the same arguments:
# iterations within 1 (tpufem's dryrun_multichip rule), and the solution
# (the single run's uncertified solve) within SHARD_F32_X_TOL in norm-wise
# difference; on the CPU the two sit 2.1e-7 (Poisson P1 200k) and 3.8e-6
# (elasticity P1 100k) apart
SHARD_F32_X_TOL = 1e-4
SHARD_ARGS = ["--scaling_type", "strong", "--dtype", "float32",
              "-ksp_rtol", "1e-8", "-ksp_max_it", "100", "--device", "cuda"]
# tpufem's sharded float64 goldens (tests/test_golden.py): (argv,
# iterations, norm), held to the iteration and rel 1e-9
SHARD_GOLDS = (
    (["--problem_type", "poisson", "--ndofs", "100000", "--scaling_type",
      "strong", "--num_shards", "8", "--dtype", "float64", "-ksp_rtol",
      "1e-8", "--device", "cuda"], 11, 68.43884037046897),
    (["--problem_type", "elasticity", "--ndofs", "10000", "--scaling_type",
      "weak", "--num_shards", "4", "--dtype", "float64", "--device",
      "cuda"], 20, 4.3635484081745004e-05))
# the spoke's row-sharded Poisson P1 150k, f32, at the 120 cap, against
# the port's single-device run: each solution certified in float64 (the
# sharded one by refinement through the sharded solver), true_rel <= 1e-8,
# passes within 1 of each other, and the certified norms within
# SPOKE_SHARD_NORM_TOL (two solutions each within 1e-8 of the system's
# residual; on the CPU at 20k dofs 5.4e-8 apart)
SPOKE_SHARD_NORM_TOL = 1e-4
# tpufem's own sharded cgpoisson P3 150k over 4 slabs, f32 on the CPU (x64
# off; its lattice, 16x16x24, is not the one-shard run's), from
#   python scripts/sharded_reference.py --cli --case cgpoisson-p3-150k-4-f32
# (ndofs, iterations, norm), the norm held within CG_F32_NORM_TOL
SHARD_CG_REF = (175273, 100, 80.32685852050781)

# the card's published peaks (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
L2_FLUSH_BYTES = 256 * 2 ** 20  # read between timed calls: 5x the 50 MB L2
PROFILE_TRIES = 5  # profiles of one device time before CUDA events
REFUSED_PROFILES = []  # device_ms's profiles whose count of spans was wrong
EVENT_TIMES = [0]      # device times that device_ms took by CUDA events


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    from tpufem_torch._build import _nvcc
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def median_ms(fn, reps: int = 20, samples: int = 11) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def device_ms(fn, kernel: str, bound: float, what: str,
              must_hold: bool = False, launches: int = 1, reps: int = 20):
    """(device ms per call, note) of ``fn``, which launches the port kernel
    ``kernel`` (a name of profile_solve.PORT_KERNELS, or a part of one)
    ``launches`` times a call, each timed call after a read of
    L2_FLUSH_BYTES that evicts the L2, so that its inputs come from HBM
    as the byte bound assumes.  The time is the union of the kernel's
    profiler spans over ``reps`` calls (profile_solve.kernel_device_ms,
    which refuses a count of spans other than reps x launches).  The
    profiler misses launches now and then (after a warm-up window too):
    a refused profile is printed, kept in REFUSED_PROFILES and taken
    again, PROFILE_TRIES times at most, and then the time comes from CUDA
    events around each call instead, and the note says so.  A reading
    under ``bound`` ms is no time: it comes back as None with the note
    "below bound", and fails the phase where ``must_hold`` (inputs far
    larger than the L2, or a bound set by operations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from tpufem_torch.profile_solve import kernel_device_ms
    flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    dev, note = None, None
    for _ in range(PROFILE_TRIES):
        # a warm-up window first, then the window that is read
        spans = []

        def ready(prof):
            spans.extend((e.name, e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA)

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(reps):
                    flush.sum()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        try:
            dev = kernel_device_ms(spans, kernel, reps, launches)
            break
        except ValueError as e:
            REFUSED_PROFILES.append(f"{what}: {e}")
            print(f"device_ms: profile refused, {what}: {e}", flush=True)
    if dev is None:
        pairs = []
        for _ in range(reps):
            flush.sum()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        dev = sum(a.elapsed_time(b) for a, b in pairs) / reps
        note = "by CUDA events"
        EVENT_TIMES[0] += 1
    del flush
    if dev >= bound:
        return dev, note
    note = f"below bound ({dev:.4f} ms read, bound {bound:.4f} ms)"
    check(not must_hold, f"{what}: the device time reads {note}")
    return None, note


def fmt_dev(dev, note) -> str:
    """A device time as printed, with its note: 'below bound (...)' where
    it read under its bound, 'by CUDA events' where the profiler missed
    launches."""
    if dev is None:
        return note or fmt_ms(dev)
    return fmt_ms(dev) + (f" ({note})" if note else "")


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call: the host clock over ``calls`` queued calls
    (none waits for the device), after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def full_fields(fields: "torch.Tensor", Z: int) -> "torch.Tensor":
    """Zone-form fields [D, 7, Y, X] expanded to one row per z-plane: the
    same operator in the full-field (R = Z) form of TPU kernel K2."""
    rows = [min(z, 3) if z < Z - 3 else 4 + z - (Z - 3) for z in range(Z)]
    return fields[:, rows].contiguous()


def torch_csr(A, device, dtype):
    """A scipy CSR matrix as a torch CSR tensor of ``dtype`` on
    ``device`` (the library yardstick: torch.sparse.mm, cuSPARSE)."""
    import numpy as np
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data), size=A.shape).to(device=device,
                                                   dtype=dtype)


def pk_csr(layout):
    """The BC-eliminated P2/P3 Poisson matrix of ``layout``'s lattice as
    a float64 scipy CSR (host): the matrix of the cgpoisson strip runs
    and of the P2/P3 Poisson runs' fine level."""
    return _pk_csr(layout.order, layout.Nx, layout.Ny, layout.Nz)


@functools.lru_cache(maxsize=None)
def _pk_csr(order: int, Nx: int, Ny: int, Nz: int):
    import torch
    from tpufem_torch.fem.dia_op import build_operator
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import poisson_bc_marker
    mesh = BoxTetMesh(Nx, Ny, Nz)
    bc = DirichletBC.from_space(FunctionSpace(mesh, order),
                                mesh.locate_boundary_facets(poisson_bc_marker))
    return build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                          dtype=torch.float32).to_scipy()


def library_ms(A, x, y_ref):
    """(ms per call, max |A x - y_ref|) of torch.sparse.mm(A, x)."""
    import torch
    y = torch.sparse.mm(A, x[:, None])[:, 0]
    err = float((y - y_ref).abs().max())
    return median_ms(lambda: torch.sparse.mm(A, x[:, None])), err


def kernel_phase(problem, gpu: str, comps: int = 1):
    """The kernel against its plain version on the operators the main
    path ran: the CG matrix, every smoothed GMG level and the RHS mass
    operator (zone form, K1), and the CG matrix in full-field form (K2),
    in float32 and, with the same weights cast, float64.  ``comps`` = 3:
    the three-component form on the elasticity path's operators (its RHS
    mass operator is scalar and was held in phase 3's form).  On the CG
    matrix also torch.sparse.mm of its CSR (``library_ms``; planar order
    for comps = 3).  Returns (rows, worst abs error)."""
    import numpy as np
    import torch
    from tpufem_torch.fem import stencil as st
    if comps == 1:
        apply, plain, prepare = (st.stencil_apply, st.stencil_apply_plain,
                                 st.prepare_stencil)
        tols = ((torch.float32, TOL_F32), (torch.float64, TOL_F64))
        kernel = "stencil_p1_kernel"
    else:
        apply, plain, prepare = (st.stencil_apply_bs3,
                                 st.stencil_apply_bs3_plain,
                                 st.prepare_stencil_bs3)
        tols = ((torch.float32, TOL_BS3_F32), (torch.float64, TOL_BS3_F64))
        kernel = "stencil_p1_bs3_kernel"

    solver = problem.solver_function
    ops = [("CG matrix", solver.A)]
    ops += [(f"GMG level {i}", lv.op) for i, lv in enumerate(solver.pc.levels)]
    if comps == 1:
        ops.append(("RHS mass", problem.rhs_op))
    check(all(op.fields.shape[1] == 7 for _, op in ops),
          "a main-path operator is not in zone form")
    cases = [(f"{name} {'x'.join(map(str, op.grid_dims))}", op.fields,
              op.offsets, op.grid_dims) for name, op in ops]
    A = solver.A
    cases.append((f"CG matrix full-field (K2) "
                  f"{'x'.join(map(str, A.grid_dims))}",
                  full_fields(A.fields, A.grid_dims[0]), A.offsets,
                  A.grid_dims))
    device = A.fields.device
    csr = A.to_scipy()
    if comps == 3:
        perm = np.arange(csr.shape[0]).reshape(-1, 3).T.reshape(-1)
        csr = csr[perm][:, perm]
    rows = []
    worst = 0.0
    for dtype, tol in tols:
        gen = torch.Generator(device=device).manual_seed(1234)
        lib = torch_csr(csr, device, dtype)
        for name, fields32, offsets, dims in cases:
            fields = fields32.to(dtype)
            args = (fields, offsets, dims)
            x = torch.randn(comps * fields.shape[2] * fields.shape[3]
                            * dims[0], generator=gen, device=device,
                            dtype=dtype)
            yk = apply(x, *args)
            # what a DiaOperator keeps: the same launch, prepared once
            prepared = prepare(*args)
            check(torch.equal(prepared(x), yk), f"{name} {dtype}: the "
                  "prepared launch and the public wrapper differ")
            yp = plain(x, *args)
            bound = plain(x.abs(), fields.abs(), *args[1:])
            torch.cuda.synchronize()
            err = (yk - yp).abs()
            abs_err = float(err.max())
            rel_err = abs_err / max(float(yp.abs().max()), 1e-300)
            check(bool((err <= tol * bound).all()),
                  f"{name} {dtype}: kernel disagrees with the plain "
                  f"version (max abs err {abs_err:.3e})")
            worst = max(worst, abs_err)
            ms = median_ms(lambda: prepared(x))
            public_ms = median_ms(lambda: apply(x, *args))
            plain_ms = median_ms(lambda: plain(x, *args), reps=10, samples=5)
            host = host_ms(lambda: prepared(x))
            b_ms, b_by = bound_ms(*stencil_work(fields, dims, comps))
            # the three-component CG matrix at 65x49x49: 12.8 MB of inputs
            dev, note = device_ms(lambda: prepared(x), kernel, b_ms,
                                  f"{name} {dtype}",
                                  must_hold=comps == 3
                                  and name.startswith("CG matrix 65x"))
            lib_ms, lib_err = (library_ms(lib, x, yp)
                               if name.startswith("CG matrix") else
                               (None, None))
            rows.append(dict(name=name, dtype=str(dtype).split(".")[1],
                             D=fields.shape[0], R=fields.shape[1],
                             max_abs_err=abs_err, max_rel_err=rel_err,
                             ms=ms, public_ms=public_ms, plain_ms=plain_ms,
                             device_ms=dev, device_note=note,
                             host_ms=host, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms,
                             call_minus_device_ms=(None if dev is None
                                                   else ms - dev)))
            lib_txt = ("" if lib_ms is None else
                       f" | torch.sparse.mm (CSR, {lib.values().numel()} "
                       f"entries, off the plain version by {lib_err:.3e}) "
                       f"{lib_ms:.4f} ms")
            print(f"kernel{'' if comps == 1 else ' bs3'} {name:<34} "
                  f"{rows[-1]['dtype']:<7} "
                  f"D={rows[-1]['D']:<3} R={rows[-1]['R']:<3} "
                  f"abs {abs_err:.3e} rel {rel_err:.3e} | per call: "
                  f"kernel {ms:.4f} ms (through the public wrapper, which "
                  f"packs the launch anew, {public_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms{lib_txt} | device: kernel "
                  f"{fmt_dev(dev, note)} | wrapper's "
                  f"host cost {host:.4f} ms per queued call | bound "
                  f"{b_ms:.4f} ms ({b_by})  [{gpu}]", flush=True)
        del lib
    return rows, worst


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it): the bytes over the card's
    memory rate against the operations over its float32 peak."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def stencil_work(fields, dims, comps: int = 1):
    """(bytes, flops) of one stencil apply: x read and y written once,
    the weight fields read once; one multiply-add per field and point of
    its output component (``comps`` components of x and y)."""
    Z, Y, X = dims
    n, item = Z * Y * X, fields.element_size()
    return (2 * comps * n * item + fields.numel() * item,
            2 * fields.shape[0] * n)


def strip_work(op):
    """(bytes, flops) of one strip apply: x read and y written once, the
    packs and plan tables read once; a multiply-add per plan entry, plane
    and lane."""
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    item = op.mid_pack.element_size()
    zk = [op.kdims[kind][0] for kind, _ in op.channels]
    terms = sum(len(km) * zk[co] + len(kd)
                for co, (km, kd) in enumerate(op.kplan))
    nbytes = (2 * C * Zp * LW + op.mid_pack.numel() + op.dlt_pack.numel()
              ) * item + sum(t.numel() * 4 for t in op.tables)
    return nbytes, 2 * terms * TILE


def strip_cg_work(op, iterations: int):
    """(bytes, flops) of one whole-CG solve of ``iterations`` steps: b
    read and x written once with the packs and tables; per step one
    apply plus three dots and four vector updates over the buffer."""
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op.dims
    nbytes, apply_flops = strip_work(op)
    return nbytes + 8, iterations * (apply_flops + 14 * C * Zp * LW)


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def cgpoisson_run(cli, argv, ref_key, gpu: str):
    """One cgpoisson CLI run with the K3, K4 and K5 counts set to zero
    just before it and read just after; checked against tpufem's run.
    Returns (result, {kernel id: launches})."""
    import torch
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    from tpufem_torch.fem.flat_op import FlatOperator
    from tpufem_torch.fem.strip_op import StripOperator
    from tpufem_torch.timing import REGISTRY
    REGISTRY.reset()
    StripOperator.apply_strips.launches = 0
    StripOperator.cg_resident.launches = 0
    FlatOperator.interior.launches = 0
    dia_zones_apply.launches = 0
    res = cli.main(argv)
    n = {"K3": StripOperator.apply_strips.launches,
         "K4": StripOperator.cg_resident.launches,
         "K5": FlatOperator.interior.launches,
         "dia_zones": dia_zones_apply.launches}
    solver = res.problem.solver_function
    ndofs, ref_it, ref_rel, ref_norm = CGPOISSON_REF[ref_key]
    if "flat" in ref_key:
        norm_tol, rel_tol = CG_FLAT_NORM_TOL, CG_FLAT_REL_TOL
    elif ref_key[3] == "float32":
        norm_tol, rel_tol = CG_F32_NORM_TOL, CG_F32_REL_TOL
    else:
        norm_tol, rel_tol = CG_F64_TOL, CG_F64_REL_TOL
    norm_err = abs(res.norm - ref_norm) / ref_norm
    rel_err = abs(solver.rel - ref_rel) / ref_rel
    print(f"cgpoisson P{ref_key[0]} {ref_key[3]} {ndofs} dofs "
          f"{' '.join(argv[argv.index('--ndofs'):])}: {res.iterations} "
          f"iterations, rel {solver.rel!r} (tpufem {ref_rel!r}, off by "
          f"{rel_err:.2e}), norm {res.norm!r} (tpufem {ref_norm!r}, off by "
          f"{norm_err:.2e}); launches K3 {n['K3']}, K4 {n['K4']}, K5 "
          f"{n['K5']}, dia_zones {n['dia_zones']}, whole-CG kernel engaged "
          f"{solver.cg_kernel_engaged}; "
          f"{solver.gdofs:.4f} Gdof/s, {solver.solve_s:.6f} s per solve  "
          f"[{gpu}]", flush=True)
    check(res.problem.space.ndofs == ndofs,
          f"{res.problem.space.ndofs} dofs, tpufem's run had {ndofs}")
    check(res.iterations == ref_it,
          f"{res.iterations} iterations, tpufem's run took {ref_it}")
    check(res.x.shape == (ndofs,) and bool(torch.isfinite(res.x).all()),
          "the solution is not a finite vector of ndofs")
    check(norm_err <= norm_tol, f"norm off tpufem's by rel {norm_err:.2e}")
    check(rel_err <= rel_tol,
          f"recurrence rel off tpufem's by rel {rel_err:.2e}")
    return res, n


def strip_kernel_phase(ops, gpu: str):
    """K3 against its plain version on the operators the cgpoisson runs
    built, in float32 and (same tables cast) float64, with torch.sparse.mm
    of the same matrix as a CSR on dof-ordered vectors (the library
    yardstick)."""
    import dataclasses
    import torch
    rows, worst = [], 0.0
    for dtype, tol in ((torch.float32, TOL_STRIP_F32),
                       (torch.float64, TOL_STRIP_F64)):
        for name, op32 in ops:
            lib = torch_csr(pk_csr(op32.layout), op32.device, dtype)
            op = dataclasses.replace(op32, mid_pack=op32.mid_pack.to(dtype),
                                     dlt_pack=op32.dlt_pack.to(dtype))
            absop = dataclasses.replace(op, mid_pack=op.mid_pack.abs(),
                                        dlt_pack=op.dlt_pack.abs())
            gen = torch.Generator(device=op.device).manual_seed(4321)
            u = torch.randn(op.layout.ndofs, generator=gen,
                            device=op.device, dtype=dtype)
            x = op.to_strips(u)
            yk = op.apply_strips(x)
            yp = op.apply_strips_plain(x)
            bnd = absop.apply_strips_plain(x.abs())
            torch.cuda.synchronize()
            err = (yk - yp).abs()
            abs_err = float(err.max())
            check(bool((err <= tol * bnd).all()),
                  f"strip kernel {name} {dtype}: disagrees with the plain "
                  f"version (max abs err {abs_err:.3e})")
            pad = op.to_strips(torch.ones_like(u)) == 0
            check(bool((yk[pad] == 0).all()),
                  f"strip kernel {name} {dtype}: nonzero padding")
            worst = max(worst, abs_err)
            ms = median_ms(lambda: op.apply_strips(x))
            plain_ms = median_ms(lambda: op.apply_strips_plain(x), reps=5,
                                 samples=5)
            host = host_ms(lambda: op.apply_strips(x))
            lib_ms, lib_err = library_ms(lib, u, op.from_strips(yp))
            del lib
            nbytes, flops = strip_work(op)
            b_ms, b_by = bound_ms(nbytes, flops)
            dev, note = device_ms(lambda: op.apply_strips(x),
                                  "strip_apply_kernel", b_ms,
                                  f"strip kernel {name} {dtype}")
            run, staged = op.apply_shape(op.mid_pack.element_size())
            rows.append(dict(name=name, dtype=str(dtype).split(".")[1],
                             max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             device_ms=dev, device_note=note,
                             bound_ms=b_ms, bound_by=b_by, host_ms=host,
                             library_ms=lib_ms,
                             call_minus_device_ms=(None if dev is None
                                                   else ms - dev)))
            print(f"strip kernel {name:<28} {rows[-1]['dtype']:<7} abs "
                  f"{abs_err:.3e} | per call: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.sparse.mm (CSR, off the plain "
                  f"version by {lib_err:.3e}) {lib_ms:.4f} ms | device: "
                  f"kernel {fmt_dev(dev, note)} | wrapper's host cost "
                  f"{host:.4f} ms per queued call | z runs of {run} planes, delta weights "
                  f"{'in shared memory' if staged else 'from global memory'}"
                  f" | bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP)  [{gpu}]", flush=True)
    return rows, worst


def wide_halo_operator(device):
    """The P3 strip operator of a 40 x 6 x 6 cube lattice (a lane halo of
    124, 7 planes), float32."""
    import torch
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.fem.strip_op import StripOperator
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import poisson_bc_marker
    mesh = BoxTetMesh(40, 6, 6)
    bc = DirichletBC.from_space(
        FunctionSpace(mesh, 3), mesh.locate_boundary_facets(poisson_bc_marker))
    dia = DiaOperator.try_const(mesh, 3, "poisson", bc_dofs=bc.flat_dofs(),
                                dtype=torch.float32)
    return StripOperator.from_dia(dia, dtype=torch.float32, device=device)


def strip_cg_compare(op, b, rtol: float, maxit: int, x_tol: float,
                     name: str, gpu: str):
    """K4 against its plain version on one right-hand side: iterations
    +-1, the solutions within ``x_tol`` (norm-wise relative), padding
    zero; with times per solve and the grid-barrier floor."""
    import torch
    xk, itk, relk = op.cg_resident(b, rtol, maxit)
    xp, itp, relp = op.cg_resident_plain(b, rtol, maxit)
    torch.cuda.synchronize()
    err = float((xk - xp).norm() / xp.norm())
    abs_err = float((xk - xp).abs().max())
    print(f"whole-CG kernel {name}: {int(itk)} iterations (plain "
          f"{int(itp)}), rel {float(relk):.6e} (plain {float(relp):.6e}), "
          f"solutions off by {err:.3e} norm-wise, {abs_err:.3e} max abs  "
          f"[{gpu}]", flush=True)
    check(abs(int(itk) - int(itp)) <= 1,
          f"whole-CG kernel {name}: {int(itk)} vs {int(itp)} iterations")
    check(err <= x_tol, f"whole-CG kernel {name}: solutions off by {err:.3e}")
    pad = op.to_strips(torch.ones(op.layout.ndofs, device=b.device,
                                  dtype=b.dtype)) == 0
    check(bool((xk[pad] == 0).all()), f"whole-CG kernel {name}: padding")
    ms = median_ms(lambda: op.cg_resident(b, rtol, maxit), reps=3, samples=5)
    plain_ms = median_ms(lambda: op.cg_resident_plain(b, rtol, maxit),
                         reps=1, samples=3)
    nbytes, flops = strip_cg_work(op, int(itk))
    b_ms, b_by = bound_ms(nbytes, flops)
    bricks, halo, _, nblk = op._cg_launch_shape(b.dtype)
    nsync = 2 * int(itk) + 1
    floor_ms = median_ms(lambda: grid_barriers(op, nblk, nsync), reps=3,
                         samples=5)
    print(f"whole-CG kernel {name}: {ms:.4f} ms per solve, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); {nblk} blocks "
          f"own {bricks.shape[0]} bricks of 2 planes x 32 lanes (halo "
          f"{halo}); the same grid through {nsync} grid barriers alone {floor_ms:.4f} ms"
          f"  [{gpu}]", flush=True)
    return dict(name=name, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, iterations=int(itk),
                barrier_floor_ms=floor_ms, blocks=nblk,
                bricks=int(bricks.shape[0]))


def grid_barriers(op, nblk: int, nsync: int) -> None:
    """The whole-CG kernel's grid (``nblk`` co-resident blocks) through
    ``nsync`` grid barriers and nothing else."""
    import torch
    from tpufem_torch import _build
    lib = _build.load().lib
    rc = lib.tpufem_strip_cg_sync_floor(
        op.device.index, nblk, nsync,
        torch.cuda.current_stream(op.device).cuda_stream)
    _build.raise_on(lib, rc, f"{nsync} grid barriers of {nblk} blocks")


def flat_work(op):
    """(bytes, flops) of one flat interior: x read and y written once,
    W0, AZT and slot_of read once; a multiply-add per nonzero entry of
    each body plane's weights WT_bp (W0 with its delta folded in), and
    lane of the tile.  The TPU kernel's dense product (2 CP K TILE per
    plane, again on each delta plane) is ``flat_dense_flops``."""
    g = op.geom
    item = op.W0.element_size()
    nbytes = ((2 * g.Zp * g.CP * g.LW + op.W0.numel() + op.AZT.numel()) * item
              + op.slot_of.numel() * 4)
    return nbytes, 2 * int((op.plane_weights() != 0).sum()) * g.TILE


def flat_dense_flops(op) -> int:
    """The TPU kernel's dense work: 2 CP K TILE per body plane and the
    same again per plane with a delta slot (what its MXU product runs)."""
    g = op.geom
    planes = g.Zc + int((op.slot_of[0, :g.Zc] >= 0).sum())
    return 2 * g.CP * g.K * g.TILE * planes


def same_matrix(form: str, other, sop, b, name: str, gpu: str):
    """Another form of the strip operator's matrix (``form``: "flat", K5
    + corrections, or "dia", the zone kernel; ``other`` = (apply on a
    dof vector, the CG loop's apply, to its buffer, back)) against the
    strip apply (K3) on one random vector, and a solve of each form to
    CONVERGED_RTOL against the other's: the same matrix on the card."""
    import torch
    from tpufem_torch.la.cg import cg_solve_fused
    gen = torch.Generator(device=b.device).manual_seed(99)
    u = torch.randn(b.shape, generator=gen, device=b.device, dtype=b.dtype)
    yf, ys = other[0](u), sop.apply(u)
    app_err = float((yf - ys).abs().max() / ys.abs().max())
    runs = {}
    for f, apply, to, back in (
            ("strip", sop.apply_strips, sop.to_strips, sop.from_strips),
            (form,) + tuple(other[1:])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, rel = cg_solve_fused(apply, to(b), rtol=CONVERGED_RTOL,
                                    maxit=CONVERGED_KMAX)
        torch.cuda.synchronize()
        runs[f] = (back(x), it, rel, time.perf_counter() - t0)
    xs, xf = runs["strip"][0], runs[form][0]
    x_err = float((xf - xs).norm() / xs.norm())
    print(f"{name} same matrix: {form} vs strip apply {app_err:.3e} of max "
          f"(tolerance {TOL_APPLY:g}); solved to rtol {CONVERGED_RTOL:g}: "
          + ", ".join(f"{f} {it} iterations rel {rel:.3e} {sec:.3f} s"
                      for f, (_, it, rel, sec) in runs.items())
          + f", solutions {x_err:.3e} apart norm-wise (tolerance "
          f"{CG_F32_X_TOL:g})  [{gpu}]", flush=True)
    check(app_err <= TOL_APPLY, f"{name}: {form} apply off the strip "
          f"apply by {app_err:.3e}")
    check(all(rel <= CONVERGED_RTOL for _, _, rel, _ in runs.values()),
          f"{name}: a form did not converge in {CONVERGED_KMAX} steps")
    check(x_err <= CG_F32_X_TOL, f"{name}: converged {form} and strip "
          f"solutions off by {x_err:.3e}")


def flat_kernel_phase(ops, gpu: str):
    """K5 against its plain version on the operators the flat runs built,
    in float32 and (same tables cast) float64, with times, the bound and
    one torch.bmm of the same product (the library yardstick)."""
    import dataclasses
    import torch
    rows, worst = [], 0.0
    for dtype, tol in ((torch.float32, TOL_FLAT_F32),
                       (torch.float64, TOL_FLAT_F64)):
        for name, op32 in ops:
            op = op32.astype(dtype)
            absop = dataclasses.replace(op, W0=op.W0.abs(), AZT=op.AZT.abs())
            g = op.geom
            gen = torch.Generator(device=op.device).manual_seed(4321)
            u = torch.randn(op.layout.ndofs, generator=gen, device=op.device,
                            dtype=dtype)
            x = op.to_flat(u)
            yk = op.interior(x)
            yp = op.interior_plain(x)
            bnd = absop.interior_plain(x.abs())
            torch.cuda.synchronize()
            err = (yk - yp).abs()
            abs_err = float(err.max())
            check(bool(torch.isfinite(yk).all()) and
                  bool((err <= tol * bnd).all()),
                  f"flat interior {name} {dtype}: disagrees with the plain "
                  f"version (max abs err {abs_err:.3e})")
            body = torch.zeros_like(yk, dtype=torch.bool)
            body[1:1 + g.Zc, :, 128:128 + g.TILE] = True
            check(bool((yk[~body] == 0).all()),
                  f"flat interior {name} {dtype}: nonzero halo or guard")
            worst = max(worst, abs_err)
            ms = median_ms(lambda: op.interior(x))
            plain_ms = median_ms(lambda: op.interior_plain(x))
            host = host_ms(lambda: op.interior(x))
            nbytes, flops = flat_work(op)
            b_ms, b_by = bound_ms(nbytes, flops)
            what = f"flat interior {name} {dtype}"
            dev, note = device_ms(lambda: op.interior(x),
                                  "flat_interior_kernel", b_ms, what)
            # each block width on its own (the wrapper lets the launch
            # choose): the same bits
            width = {}
            for lanes in (4, 2):
                fixed = op._prepare_interior(lanes)
                check(torch.equal(fixed(x), yk), f"flat interior {name} "
                      f"{dtype}: blocks of {32 * lanes} lanes differ")
                width[32 * lanes] = device_ms(
                    lambda: fixed(x), "flat_interior_kernel", b_ms,
                    f"{what}, {32 * lanes}-lane blocks")
            WT, S = op.plane_weights(), op.shift_stack(x)
            lib_ms = median_ms(lambda: torch.bmm(WT, S))
            nnz = int((op.W0 != 0).sum())
            dense = flat_dense_flops(op)
            rows.append(dict(name=name, dtype=str(dtype).split(".")[1],
                             max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             device_ms=dev, device_note=note,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                             host_ms=host,
                             call_minus_device_ms=(None if dev is None
                                                   else ms - dev),
                             width_device_ms={w: d for w, (d, _)
                                              in width.items()}))
            print(f"flat interior {name:<26} {rows[-1]['dtype']:<7} abs "
                  f"{abs_err:.3e} | per call: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms | device: "
                  f"kernel {fmt_dev(dev, note)} (128-lane blocks "
                  f"{fmt_dev(*width[128])}, 64-lane blocks "
                  f"{fmt_dev(*width[64])}) | "
                  f"wrapper's host cost {host:.4f} ms per queued call, per "
                  f"call minus device {fmt_ms(rows[-1]['call_minus_device_ms'])}"
                  f" | plan {len(op.sparse_plan.k)} entries | bound "
                  f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.4f} GFLOP needed; dense TPU form "
                  f"{dense / 1e9:.3f} GFLOP) | W0 nonzero {nnz} of "
                  f"{op.W0.numel()} ({100 * nnz / op.W0.numel():.1f}%)  "
                  f"[{gpu}]", flush=True)
            del WT, S
    return rows, worst


def elasticity_phase(cli, gpu: str):
    """Phase 10: the 500k float32 elasticity run with the three-component
    launches counted from zero around it, warm solves and a warm build,
    the float64 elasticity100k golden, and the kernel against its plain
    version on the run's operators.  Returns (launches, kernel rows,
    worst abs error)."""
    import torch
    from tpufem_torch.fem.stencil import stencil_apply, stencil_apply_bs3
    from tpufem_torch.problems import elasticity
    from tpufem_torch.timing import REGISTRY
    REGISTRY.reset()
    stencil_apply.launches = 0
    stencil_apply_bs3.launches = 0
    t0 = time.perf_counter()
    res = cli.main(ELAST_ARGS)
    first_s = time.perf_counter() - t0
    launches, scalar = stencil_apply_bs3.launches, stencil_apply.launches
    solver, prob = res.problem.solver_function, res.problem
    # a CG iteration applies A once and smooths each of the 4 levels with
    # 2 + 2 applies (degree 2, pre and post): 17 applies
    per_it = launches / max(1, res.iterations + res.refine_iterations)
    print(f"elasticity 500k float32: {prob.space.ndofs} dofs, "
          f"{res.iterations} iterations, norm {res.norm!r}, true_rel "
          f"{res.true_rel!r}, {res.refine_passes} refinement pass(es) "
          f"(+{res.refine_iterations} its), three-component launches "
          f"{launches} ({per_it:.1f} per CG iteration), scalar stencil "
          f"launches {scalar} (the RHS), PC setup {solver.pc_setup_s:.3f} s,"
          f" certify {solver.certify_s:.3f} s, first solve (ZZZ Solve) "
          f"{REGISTRY.get('ZZZ Solve'):.3f} s, whole CLI run {first_s:.3f} s"
          f"  [{gpu}]", flush=True)
    check(prob.space.ndofs == ELAST_DOFS,
          f"{prob.space.ndofs} dofs, tpufem's elasticity_p1 has {ELAST_DOFS}")
    check(launches > 0, "the elasticity run launched no three-component "
          "stencil kernel")
    check(solver.A.planar and solver.A.bs == 3 and solver.pc.planar,
          "the elasticity solve is not planar")
    check(0 < res.iterations < 100,
          f"elasticity CG did not converge ({res.iterations})")
    check(res.true_rel is not None and res.true_rel <= 1e-8,
          f"elasticity certified true residual {res.true_rel} > 1e-8")
    check(res.x.shape == (ELAST_DOFS,) and bool(torch.isfinite(res.x).all()),
          "the elasticity solution is not a finite vector of ndofs")
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, its, _ = solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    check(its == res.iterations, f"warm solve took {its} iterations, "
          f"first took {res.iterations}")
    solve_s = statistics.median(runs)
    cfg, device = cli.parse_args(ELAST_ARGS)
    t0 = time.perf_counter()
    elasticity.problem(prob.space.mesh, 1, cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"elasticity warm CG+GMG solve (uncertified): median "
          f"{solve_s:.4f} s of 5 (min {min(runs):.4f}, max {max(runs):.4f}), "
          f"{solve_s / its * 1e3:.2f} ms/iteration; warm build {build_s:.4f}"
          f" s; {prob.space.ndofs / (build_s + solve_s):.1f} dofs/s "
          f"build+solve  [{gpu}]", flush=True)

    REGISTRY.reset()
    gold = cli.main(ELAST_GOLD_ARGS)
    rel = abs(gold.norm - ELAST_GOLD_NORM) / ELAST_GOLD_NORM
    print(f"elasticity100k float64: {gold.iterations} iterations, norm "
          f"{gold.norm!r} (golden {ELAST_GOLD_NORM!r}, rel {rel:.2e}), "
          f"true_rel {gold.true_rel!r}  [{gpu}]", flush=True)
    check(gold.iterations == ELAST_GOLD_ITERATIONS,
          f"elasticity100k took {gold.iterations} iterations, golden "
          f"{ELAST_GOLD_ITERATIONS}")
    check(rel <= 1e-9, f"elasticity100k norm off by rel {rel:.2e}")
    del gold

    rows, worst = kernel_phase(prob, gpu, comps=3)
    return launches, rows, worst


def amg_row(key, problem, dims, ndofs, ref_it, maxit, device, gpu: str):
    """One of tpufem's -pc_type amg bench rows through the port's problem
    API, f32: the build and the first (certified) solve with the stencil
    and brick_flat counts set to zero just before and read just after;
    five warm uncertified solves (their launches per CG iteration); a
    timed second build; the V-cycle split.  Returns (the run's
    brick_flat launches, the level-1 operator (fields, plan, gdims, c),
    the row's numbers)."""
    import torch
    from tpufem_torch.config import Config, SolverOptions
    from tpufem_torch.fem.stencil import stencil_apply, stencil_apply_bs3
    from tpufem_torch.la.brick_flat import brick_flat_apply
    from tpufem_torch.la.bramg import BrickAMG
    from tpufem_torch.mesh.structured import (BoxTetMesh,
                                              compute_box_size_structured)
    from tpufem_torch.problems import elasticity, poisson
    from tpufem_torch.timing import REGISTRY
    bs = 3 if problem == "elasticity" else 1
    if dims is None:
        dims = compute_box_size_structured(500000, True, bs, 1, 1)[:3]
    mesh = BoxTetMesh(*dims)
    cfg = Config(problem_type=problem, ndofs=ndofs, scaling_type="strong",
                 dtype="float32",
                 solver=SolverOptions(pc_type="amg", ksp_rtol=1e-8,
                                      ksp_max_it=maxit))
    build = (elasticity if bs == 3 else poisson).problem
    fine = stencil_apply_bs3 if bs == 3 else stencil_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    REGISTRY.reset()
    stencil_apply.launches = stencil_apply_bs3.launches = 0
    brick_flat_apply.launches = 0
    t0 = time.perf_counter()
    prob = build(mesh, 1, cfg, device)
    x, its = prob.solver_function(prob.u, prob.b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n_fine, n_scalar = fine.launches, stencil_apply.launches
    n_flat = brick_flat_apply.launches
    solver = prob.solver_function
    pc = solver.pc
    check(isinstance(pc, BrickAMG), f"{key}: the solve is not brick-AMG")
    check(prob.space.ndofs == ndofs, f"{key}: {prob.space.ndofs} dofs, "
          f"tpufem's row has {ndofs}")
    check(n_fine > 0 and n_flat > 0, f"{key}: launches fine {n_fine}, "
          f"brick_flat {n_flat}")
    check(x.shape == (ndofs,) and bool(torch.isfinite(x).all()),
          f"{key}: the solution is not a finite vector of ndofs")
    check(abs(its - ref_it) <= 1, f"{key}: {its} iterations, tpufem {ref_it}")
    check(solver.true_rel is not None and solver.true_rel <= 1e-8
          and solver.refine_passes <= 3,
          f"{key}: true_rel {solver.true_rel}, {solver.refine_passes} passes")
    its_total = its + solver.refine_iterations
    print(f"{key}: {ndofs} dofs ({'x'.join(map(str, dims))} lattice), "
          f"levels {pc.level_sizes}, {its} iterations (tpufem {ref_it}), "
          f"{solver.refine_passes} refinement pass(es) (+"
          f"{solver.refine_iterations} its), true_rel {solver.true_rel!r}; "
          f"PC setup {solver.pc_setup_s:.3f} s, phases "
          + ", ".join(f"{k} {v:.3f}" for k, v in pc.last_phase_s.items())
          + f" s; certify {solver.certify_s:.3f} s; build + first solve "
          f"{first_s:.3f} s; launches in the run: "
          f"{'three-component' if bs == 3 else 'K1'} {n_fine}"
          + (f" (+{n_scalar} scalar, the RHS)" if bs == 3 else "")
          + f", brick_flat {n_flat}, over {its_total} CG iterations  [{gpu}]",
          flush=True)

    runs = []
    stencil_apply.launches = stencil_apply_bs3.launches = 0
    brick_flat_apply.launches = 0
    for _ in range(5):
        t0 = time.perf_counter()
        _, its_w, _ = solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    check(its_w == its, f"{key}: warm solve took {its_w} iterations")
    per_it = (fine.launches / (5 * its), brick_flat_apply.launches / (5 * its))
    solve_s = statistics.median(runs)
    t0 = time.perf_counter()
    build(mesh, 1, cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    split = pc.profile_vcycle(solver.A, ndofs)
    print(f"{key} warm CG+brick-AMG solve (uncertified): median "
          f"{solve_s:.4f} s of 5 (min {min(runs):.4f}, max {max(runs):.4f}), "
          f"{solve_s / its * 1e3:.3f} ms/iteration; timed second build "
          f"{build_s:.4f} s; {ndofs / (build_s + solve_s):.1f} dofs/s "
          f"build+solve; launches per CG iteration: fine {per_it[0]:.1f}, "
          f"brick_flat {per_it[1]:.1f}; V-cycle split (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()
                      if k != "smoother_degree")
          + f"  [{gpu}]", flush=True)
    lv1 = pc.levels[1]
    stats = dict(key=key, iterations=its, true_rel=solver.true_rel,
                 refine_passes=solver.refine_passes, solve_s=solve_s,
                 solve_min_s=min(runs), solve_max_s=max(runs),
                 ms_per_iteration=solve_s / its * 1e3, brick_flat=n_flat,
                 brick_flat_per_iteration=per_it[1])
    return n_flat, (lv1.fields, lv1.plan, lv1.gdims, lv1.c), stats


def brick_flat_csr(fields, plan, gdims, c):
    """The level's operator as a torch CSR matrix on its device (the
    library yardstick): one entry per nonzero weight with its neighbour
    inside the grid."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    az, ay, ax = gdims
    W = ax * c
    n = az * ay * W
    F = fields.cpu().numpy().reshape(len(plan), n)
    z, y, xw = (a.reshape(-1) for a in np.meshgrid(
        np.arange(az), np.arange(ay), np.arange(W), indexing="ij"))
    rows, cols, vals = [], [], []
    for f, (dz, dy, s) in zip(F, plan):
        zz, yy, xx = z + dz, y + dy, xw + s
        ok = ((zz >= 0) & (zz < az) & (yy >= 0) & (yy < ay) & (xx >= 0)
              & (xx < W) & (f != 0))
        rows.append(np.flatnonzero(ok))
        cols.append(((zz * ay + yy) * W + xx)[ok])
        vals.append(f[ok])
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n))
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data), size=(n, n)).to(fields.device)


def brick_flat_work(fields, plan):
    """(bytes, flops) of one brick_flat apply: every field read once, x
    read and y written once, the plan table read once; a multiply and an
    add per nonzero weight."""
    item = fields.element_size()
    nbytes = (fields.numel() + 2 * fields[0].numel()) * item + 12 * len(plan)
    return nbytes, 2 * int((fields != 0).sum())


def brick_flat_phase(levels, device, gpu: str):
    """The brick_flat kernel against its plain version on the level-1
    operators of the AMG runs and three edge grids (az = 1 with m = 6; a
    minor axis of 7, no multiple of 32; one of 150 lanes, cut into two
    lane tiles), in float32 and float64: the plain version's bits, with
    times, the wrapper's host cost, the bound and one torch.sparse.mm of
    the same operator as a CSR matrix.  The device time must hold its
    bound on the 500k levels.  Returns (rows, worst abs error)."""
    import numpy as np
    import torch
    from tpufem_torch.la import bramg
    from tpufem_torch.la.brick_flat import (brick_flat_apply,
                                            brick_flat_apply_plain,
                                            prepare_brick_flat)
    cases = list(levels)
    rng = np.random.default_rng(7)
    for name, gdims, c in (("edge az=1", (1, 4, 5), 6),
                           ("edge W=7", (3, 2, 7), 1),
                           ("edge W=150", (3, 4, 25), 6)):
        plan, fields = bramg.stencil_to_flat_fields(
            rng.standard_normal((3, 3, 3) + gdims + (c, c)), c)
        cases.append((f"{name} {'x'.join(map(str, gdims))} m={c}",
                      torch.from_numpy(np.stack(fields)).to(device), plan,
                      gdims, c))
    rows, worst = [], 0.0
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(2024)
        for name, fields_any, plan, gdims, c in cases:
            fields = fields_any.to(dtype).contiguous()
            args = (fields, plan, gdims, c)
            x = torch.randn(fields[0].numel(), generator=gen, device=device,
                            dtype=dtype)
            before = brick_flat_apply.launches
            yk = brick_flat_apply(x, *args)
            check(brick_flat_apply.launches == before + 1,
                  f"brick_flat {name}: the wrapper did not launch once")
            launch = prepare_brick_flat(*args)
            check(torch.equal(launch(x), yk), f"brick_flat {name} {dtype}: "
                  "the prepared launch and the public wrapper differ")
            yp = brick_flat_apply_plain(x, *args)
            bnd = brick_flat_apply_plain(x.abs(), fields.abs(), *args[1:])
            torch.cuda.synchronize()
            abs_err = float((yk - yp).abs().max())
            check(bool(torch.isfinite(yk).all()) and torch.equal(yk, yp),
                  f"brick_flat {name} {dtype}: kernel gives other bits than "
                  f"the plain version (max abs err {abs_err:.3e})")
            worst = max(worst, abs_err)
            A = brick_flat_csr(fields, plan, gdims, c)
            ylib = torch.sparse.mm(A, x[:, None])[:, 0]
            lib_err = float((ylib - yp).abs().max())
            ms = median_ms(lambda: launch(x))
            public_ms = median_ms(lambda: brick_flat_apply(x, *args))
            plain_ms = median_ms(lambda: brick_flat_apply_plain(x, *args),
                                 reps=5, samples=5)
            host = host_ms(lambda: launch(x))
            lib_ms = median_ms(lambda: torch.sparse.mm(A, x[:, None]))
            nbytes, flops = brick_flat_work(fields, plan)
            b_ms, b_by = bound_ms(nbytes, flops)
            dev, note = device_ms(lambda: launch(x), "brick_flat_kernel",
                                  b_ms, f"brick_flat {name} {dtype}",
                                  must_hold="500k" in name)
            rows.append(dict(name=name, dtype=str(dtype).split(".")[1],
                             fields=len(plan), max_abs_err=abs_err,
                             same_bits=bool(torch.equal(yk, yp)), ms=ms,
                             public_ms=public_ms, plain_ms=plain_ms,
                             device_ms=dev, device_note=note,
                             host_ms=host, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             call_minus_device_ms=(None if dev is None
                                                   else ms - dev)))
            print(f"brick_flat {name:<40} {rows[-1]['dtype']:<7} "
                  f"{len(plan)} fields | max |kernel - plain| {abs_err:.3e} "
                  f"(max sum |F x| {float(bnd.max()):.3e}; the same bits: "
                  f"{rows[-1]['same_bits']}) | per call: kernel {ms:.4f} ms "
                  f"(public wrapper {public_ms:.4f}), plain {plain_ms:.4f} ms, "
                  f"torch.sparse.mm (CSR, {A.values().numel()} entries, off "
                  f"the plain version by {lib_err:.3e}) {lib_ms:.4f} ms | "
                  f"device: kernel {fmt_dev(dev, note)} | "
                  f"wrapper's host cost {host:.4f} ms per queued call | bound "
                  f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.2f} MFLOP)  [{gpu}]", flush=True)
            del A
    return rows, worst


def amg_phase(cli, device, gpu: str):
    """Phase 11: tpufem's three -pc_type amg bench rows, the brick_flat
    kernel against its plain version on their level-1 operators and on
    edge grids, and the float64 goldens of tpufem's brick-AMG runs.
    Returns (brick_flat launches, kernel rows, worst abs error)."""
    import torch
    from tpufem_torch.timing import REGISTRY
    launches, levels = 0, []
    for key, problem, dims, ndofs, ref_it, maxit in AMG_ROWS:
        n, (fields, plan, gdims, c), _ = amg_row(key, problem, dims, ndofs,
                                                 ref_it, maxit, device, gpu)
        launches += n
        levels.append((f"{key} level 1 {'x'.join(map(str, gdims))} m={c}",
                       fields, plan, gdims, c))
        torch.cuda.empty_cache()
    rows, worst = brick_flat_phase(levels, device, gpu)
    del levels
    for argv, gold_it, gold_norm in AMG_GOLDS:
        REGISTRY.reset()
        res = cli.main(argv)
        rel = abs(res.norm - gold_norm) / gold_norm
        print(f"{argv[1]} {argv[3]} float64 -pc_type amg: {res.iterations} "
              f"iterations, norm {res.norm!r} (tpufem {gold_norm!r}, rel "
              f"{rel:.2e}), levels {res.problem.solver_function.pc.level_sizes}"
              f"  [{gpu}]", flush=True)
        check(res.iterations == gold_it, f"{argv[1]} {argv[3]} amg took "
              f"{res.iterations} iterations, tpufem {gold_it}")
        check(rel <= 1e-9, f"{argv[1]} {argv[3]} amg norm off by {rel:.2e}")
        del res
    torch.cuda.empty_cache()
    return launches, rows, worst


def pk_poisson_run(cli, order: int, gpu: str):
    """P2/P3 Poisson 500k f32 through the CLI with the zone kernel's and
    K1's counts set to zero just before it and read just after; warm
    solves and a warm build.  Returns (result, {kernel: launches})."""
    import torch
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    from tpufem_torch.fem.stencil import stencil_apply
    from tpufem_torch.problems import poisson
    from tpufem_torch.timing import REGISTRY
    argv = PK_ARGS + ["--order", str(order)]
    REGISTRY.reset()
    dia_zones_apply.launches = stencil_apply.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    first_s = time.perf_counter() - t0
    n = {"dia_zones": dia_zones_apply.launches, "K1": stencil_apply.launches}
    solver, prob = res.problem.solver_function, res.problem
    ndofs, ref_it, ref_norm, ref_rel, ref_passes = POISSON_PK_REF[order]
    its = res.iterations + res.refine_iterations
    pc = solver.pc
    print(f"poisson P{order} 500k float32: {prob.space.ndofs} dofs, levels "
          f"{[lv.op.layout.ndofs for lv in pc.levels]} + coarse "
          f"{pc.coarse_inv.shape[0]}, {res.iterations} iterations (tpufem "
          f"{ref_it}), norm {res.norm!r} (tpufem {ref_norm!r}, off by "
          f"{abs(res.norm - ref_norm) / ref_norm:.2e}), true_rel "
          f"{res.true_rel!r} (tpufem {ref_rel:g}), {res.refine_passes} "
          f"refinement pass(es) (tpufem {ref_passes}, +"
          f"{res.refine_iterations} its); launches dia_zones {n['dia_zones']}"
          f" ({n['dia_zones'] / its:.1f} per CG iteration), K1 {n['K1']} "
          f"({n['K1'] / its:.1f} per CG iteration) over {its} CG "
          f"iterations; PC setup {solver.pc_setup_s:.3f} s, certify "
          f"{solver.certify_s:.3f} s, first solve (ZZZ Solve) "
          f"{REGISTRY.get('ZZZ Solve'):.3f} s, whole CLI run {first_s:.3f} s"
          f"  [{gpu}]", flush=True)
    check(prob.space.ndofs == ndofs,
          f"P{order}: {prob.space.ndofs} dofs, tpufem's run had {ndofs}")
    check(n["dia_zones"] > 0 and n["K1"] > 0, f"P{order}: launches {n}")
    check(abs(res.iterations - ref_it) <= 1,
          f"P{order}: {res.iterations} iterations, tpufem {ref_it}")
    check(res.true_rel is not None and res.true_rel <= 1e-8,
          f"P{order}: certified true residual {res.true_rel}")
    check(res.x.shape == (ndofs,) and bool(torch.isfinite(res.x).all()),
          f"P{order}: the solution is not a finite vector of ndofs")
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, its_w, _ = solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    check(its_w == res.iterations, f"P{order}: warm solve took {its_w} its")
    solve_s = statistics.median(runs)
    cfg, device = cli.parse_args(argv)
    t0 = time.perf_counter()
    poisson.problem(prob.space.mesh, order, cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"poisson P{order} 500k warm CG+GMG solve (uncertified): median "
          f"{solve_s:.4f} s of 5 (min {min(runs):.4f}, max {max(runs):.4f}),"
          f" {solve_s / its_w * 1e3:.3f} ms/iteration; warm build "
          f"{build_s:.4f} s; {ndofs / (build_s + solve_s):.1f} dofs/s "
          f"build+solve  [{gpu}]", flush=True)
    return res, n


def dia_zones_work(pack):
    """(bytes, flops) of one zone apply: the fields and the three tables
    read once, x read and y written once; a multiply-add per term and
    point of its output grid."""
    item = pack.fields.element_size()
    points = {ko: int(X * Y * Z) for ko, (_, X, Y, Z, _) in
              enumerate(pack.kinds)}
    nbytes = ((pack.fields.numel() + 2 * pack.ndofs) * item
              + 4 * (pack.terms.size + pack.outputs.size + pack.kinds.size))
    return nbytes, 2 * sum(int(c) * points[int(ko)]
                           for ko, _, _, c in pack.outputs)


def dia_zones_phase(ops, gpu: str):
    """The zone kernel against its plain version on ``ops`` ((name, the
    DiaOperator, compare with K3?)), in float32 and, with the fields cast,
    float64: the same bits, one launch per wrapper call, the prepared
    launch; times, the wrapper's host cost, the bound, torch.sparse.mm of
    the operator's CSR and, where asked, K3 on StripOperator.from_dia of
    the same matrix.  Returns (rows, worst abs error)."""
    import dataclasses
    import torch
    from tpufem_torch.fem.dia_zones import (dia_zones_apply,
                                            dia_zones_apply_plain,
                                            prepare_dia_zones)
    from tpufem_torch.fem.strip_op import StripOperator
    rows, worst = [], 0.0
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device="cuda").manual_seed(808)
        for name, op, with_k3 in ops:
            pack = dataclasses.replace(op.zone_pack,
                                       fields=op.zone_pack.fields.to(dtype))
            device = pack.fields.device
            x = torch.randn(pack.ndofs, generator=gen, device=device,
                            dtype=dtype)
            before = dia_zones_apply.launches
            yk = dia_zones_apply(x, pack)
            check(dia_zones_apply.launches == before + 1,
                  f"dia_zones {name}: the wrapper did not launch once")
            launch = prepare_dia_zones(pack)
            check(torch.equal(launch(x), yk), f"dia_zones {name} {dtype}: "
                  "the prepared launch and the public wrapper differ")
            yp = dia_zones_apply_plain(x, pack)
            torch.cuda.synchronize()
            abs_err = float((yk - yp).abs().max())
            same = bool(torch.equal(yk, yp))
            check(same and bool(torch.isfinite(yk).all()),
                  f"dia_zones {name} {dtype}: not the plain version's bits "
                  f"(max abs err {abs_err:.3e})")
            worst = max(worst, abs_err)
            csr = (pk_csr(op.layout) if op.layout.ndofs > 100000
                   else op.to_scipy())
            lib = torch_csr(csr, device, dtype)
            lib_ms, lib_err = library_ms(lib, x, yp)
            del lib
            ms = median_ms(lambda: launch(x))
            public_ms = median_ms(lambda: dia_zones_apply(x, pack))
            plain_ms = median_ms(lambda: dia_zones_apply_plain(x, pack),
                                 reps=3, samples=3)
            host = host_ms(lambda: launch(x))
            nbytes, flops = dia_zones_work(pack)
            b_ms, b_by = bound_ms(nbytes, flops)
            # the 500k fine operators: 26 / 13 MB of inputs, far past what
            # an L2 flush leaves, so a reading under the bound is a fault
            dev, note = device_ms(lambda: launch(x), "dia_zones_kernel", b_ms,
                                  f"dia_zones {name} {dtype}",
                                  must_hold=" 500k " in f" {name} ")
            k3 = ""
            k3_ms = k3_dev = None
            if with_k3 and dtype == torch.float32:
                sop = StripOperator.from_dia(op, dtype=dtype, device=device)
                xs = sop.to_strips(x)
                ys = sop.from_strips(sop.apply_strips(xs))
                app_err = float((ys - yk).abs().max() / yk.abs().max())
                check(app_err <= TOL_APPLY, f"dia_zones {name}: the strip "
                      f"apply of the same matrix is off by {app_err:.3e}")
                k3_ms = median_ms(lambda: sop.apply_strips(xs))
                k3_dev, k3_note = device_ms(
                    lambda: sop.apply_strips(xs), "strip_apply_kernel",
                    bound_ms(*strip_work(sop))[0], f"K3 on {name} {dtype}")
                k3 = (f" | K3 on the same matrix in strip form "
                      f"{k3_ms:.4f} ms per call, {fmt_dev(k3_dev, k3_note)} "
                      f"device "
                      f"(apply off by {app_err:.3e} of max)")
                del sop, xs, ys
            counts = pack.outputs[:, 3]
            rows.append(dict(name=name, dtype=str(dtype).split(".")[1],
                             terms=len(pack.terms), outputs=len(counts),
                             max_abs_err=abs_err, same_bits=same, ms=ms,
                             public_ms=public_ms, plain_ms=plain_ms,
                             device_ms=dev, device_note=note,
                             host_ms=host, library_ms=lib_ms, bound_ms=b_ms,
                             bound_by=b_by, strip_apply_ms=k3_ms,
                             strip_apply_device_ms=k3_dev,
                             call_minus_device_ms=(None if dev is None
                                                   else ms - dev)))
            print(f"dia_zones {name:<34} {rows[-1]['dtype']:<7} "
                  f"{len(pack.terms)} terms over {len(counts)} outputs "
                  f"({counts.min()}-{counts.max()} each) | the same bits as "
                  f"the plain version: {same} (max abs diff {abs_err:.3e}) |"
                  f" per call: kernel {ms:.4f} ms (public wrapper "
                  f"{public_ms:.4f}), plain {plain_ms:.4f} ms, "
                  f"torch.sparse.mm (CSR, {csr.nnz} entries, off the plain "
                  f"version by {lib_err:.3e}) {lib_ms:.4f} ms | device: "
                  f"kernel {fmt_dev(dev, note)} | "
                  f"wrapper's host cost {host:.4f} ms per queued call | bound"
                  f" {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP){k3}  [{gpu}]", flush=True)
    return rows, worst


def pk_phase(cli, gpu: str):
    """Phase 12: P2/P3 Poisson 500k f32 (CG + p-then-h GMG, certified),
    the zone kernel against its plain version, the f64 order3 golden, and
    cgpoisson P3 500k with -use_strip 0.  Returns (the Poisson runs'
    zone-kernel launches, the -use_strip 0 run's, kernel rows, worst abs
    error)."""
    import torch
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.fem.strip_op import StripOperator
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import poisson_bc_marker
    from tpufem_torch.timing import REGISTRY
    launches, ops = 0, []
    for order in (2, 3):
        res, n = pk_poisson_run(cli, order, gpu)
        launches += n["dia_zones"]
        A = res.problem.solver_function.A
        check(isinstance(A, DiaOperator) and A.multi_kind,
              f"P{order} 500k: the fine operator is not the multi-kind DIA")
        lay = A.layout
        ops.append((f"P{order} 500k {lay.Nx}x{lay.Ny}x{lay.Nz}", A, True))
        del res
        torch.cuda.empty_cache()
    # edge grids of 6 planes (full fields beside zone fields), and a
    # dense-mode operator (full fields only, every grid under 7 planes)
    device = torch.device("cuda", 0)
    for order, dims, mode in ((3, (8, 7, 6), "const"), (2, (5, 4, 3),
                                                        "dense")):
        mesh = BoxTetMesh(*dims)
        bc = DirichletBC.from_space(FunctionSpace(mesh, order),
                                    mesh.locate_boundary_facets(
                                        poisson_bc_marker)).flat_dofs()
        op = DiaOperator.build(mesh, order, "poisson", bc_dofs=bc,
                               dtype=torch.float32, mode=mode,
                               device=device)
        ops.append((f"P{order} {mode} {'x'.join(map(str, dims))}", op,
                    False))
    rows, worst = dia_zones_phase(ops, gpu)
    del ops
    torch.cuda.empty_cache()

    REGISTRY.reset()
    dia_zones_apply.launches = 0
    gold = cli.main(ORDER3_ARGS)
    rel = abs(gold.norm - ORDER3_NORM) / ORDER3_NORM
    print(f"order3 float64: {gold.iterations} iterations, norm "
          f"{gold.norm!r} (golden {ORDER3_NORM!r}, rel {rel:.2e}), dia_zones "
          f"launches {dia_zones_apply.launches}  [{gpu}]", flush=True)
    check(gold.iterations == ORDER3_ITERATIONS and rel <= 1e-9
          and dia_zones_apply.launches > 0, "order3 golden not held")
    del gold

    key = (3, 500000, "strong", "float32", "dia")
    r, n = cgpoisson_run(cli, CG_ARGS + ["--order", "3", "--ndofs", "500000",
                                         "-use_strip", "0"], key, gpu)
    dia = r.problem.solver_function.op
    check(isinstance(dia, DiaOperator) and n["dia_zones"] > 0
          and n["K3"] == 0 and n["K4"] == 0 and n["K5"] == 0,
          f"P3 -use_strip 0: launches {n}")
    sop = StripOperator.from_dia(dia, dtype=torch.float32,
                                 device=dia.bc_mask.device)
    same_matrix("dia", (dia.apply, dia.apply, lambda v: v, lambda v: v), sop,
                r.problem.b, "P3 500k", gpu)
    del r, dia, sop
    torch.cuda.empty_cache()
    return launches, n["dia_zones"], rows, worst


def elasticity_pk_run(cli, order: int, gpu: str):
    """P2/P3 elasticity 500k f32 through the CLI with perm_apply's and the
    three-component K1's counts set to zero just before it and read just
    after; the hierarchy, warm solves and a warm build.  Returns (result,
    {kernel: launches})."""
    import torch
    from tpufem_torch.fem.perm_apply import perm_apply
    from tpufem_torch.fem.stencil import stencil_apply_bs3
    from tpufem_torch.fem.structured_op import StructuredOperator
    from tpufem_torch.problems import elasticity
    from tpufem_torch.timing import REGISTRY
    argv = ELAST_PK_ARGS + ["--order", str(order)]
    REGISTRY.reset()
    perm_apply.launches = stencil_apply_bs3.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    first_s = time.perf_counter() - t0
    n = {"perm_apply": perm_apply.launches,
         "K1_bs3": stencil_apply_bs3.launches}
    solver, prob = res.problem.solver_function, res.problem
    ndofs, ref_it, ref_norm, ref_rel, ref_passes = ELASTICITY_PK_REF[order]
    its = res.iterations + res.refine_iterations
    pc = solver.pc
    levels = [3 * lv.op.layout.ndofs for lv in pc.levels]
    print(f"elasticity P{order} 500k float32: {prob.space.ndofs} dofs, GMG "
          f"levels {levels} + coarse {pc.coarse_inv.shape[0]} (dims "
          f"{list(pc.dims)}), {res.iterations} iterations (tpufem {ref_it}),"
          f" norm {res.norm!r} (tpufem {ref_norm!r}, off by "
          f"{abs(res.norm - ref_norm) / ref_norm:.2e}), true_rel "
          f"{res.true_rel!r} (tpufem {ref_rel:g}), {res.refine_passes} "
          f"refinement pass(es) (tpufem {ref_passes}, +"
          f"{res.refine_iterations} its); launches perm_apply "
          f"{n['perm_apply']} ({n['perm_apply'] / its:.2f} per CG "
          f"iteration), three-component K1 {n['K1_bs3']} "
          f"({n['K1_bs3'] / its:.2f} per CG iteration) over {its} CG "
          f"iterations; PC setup {solver.pc_setup_s:.3f} s, certify "
          f"{solver.certify_s:.3f} s, first solve (ZZZ Solve) "
          f"{REGISTRY.get('ZZZ Solve'):.3f} s, whole CLI run {first_s:.3f} s"
          f"  [{gpu}]", flush=True)
    check(prob.space.ndofs == ndofs,
          f"P{order}: {prob.space.ndofs} dofs, tpufem's run had {ndofs}")
    check((levels, pc.coarse_inv.shape[0]) == ELASTICITY_PK_LEVELS[order],
          f"P{order}: GMG levels {levels} + {pc.coarse_inv.shape[0]}")
    check(isinstance(solver.A, StructuredOperator) and solver.A.planar
          and solver.A.bs == 3, f"P{order}: the fine operator is not the "
          "planar blocked StructuredOperator")
    check(n["perm_apply"] == 5 * its and n["K1_bs3"] > 0,
          f"P{order}: launches {n} over {its} CG iterations")
    check(abs(res.iterations - ref_it) <= 1,
          f"P{order}: {res.iterations} iterations, tpufem {ref_it}")
    check(res.true_rel is not None and res.true_rel <= 1e-8
          and res.refine_passes <= 3,
          f"P{order}: certified true residual {res.true_rel} after "
          f"{res.refine_passes} passes")
    check(res.x.shape == (ndofs,) and bool(torch.isfinite(res.x).all()),
          f"P{order}: the solution is not a finite vector of ndofs")
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, its_w, _ = solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    check(its_w == res.iterations, f"P{order}: warm solve took {its_w} its")
    solve_s = statistics.median(runs)
    cfg, device = cli.parse_args(argv)
    t0 = time.perf_counter()
    elasticity.problem(prob.space.mesh, order, cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"elasticity P{order} 500k warm CG+GMG solve (uncertified): median "
          f"{solve_s:.4f} s of 5 (min {min(runs):.4f}, max {max(runs):.4f}),"
          f" {solve_s / its_w * 1e3:.3f} ms/iteration; warm build "
          f"{build_s:.4f} s; {ndofs / (build_s + solve_s):.1f} dofs/s "
          f"build+solve  [{gpu}]", flush=True)
    return res, n


def perm_csr(pack, dtype):
    """The BC-eliminated blocked operator of ``pack`` as a torch CSR
    matrix in planar order on its device (the library yardstick:
    torch.sparse.mm, cuSPARSE), assembled there from the element matrices
    and dof_gids_for_cells: zeroed Dirichlet rows and columns, a unit
    diagonal on them."""
    import numpy as np
    import torch
    from tpufem_torch.fem.structured_op import dof_gids_for_cells
    from tpufem_torch.mesh.structured import BoxTetMesh
    Nx, Ny, Nz = pack.dims
    mesh = BoxTetMesh(Nx, Ny, Nz)
    cz, cy, cx = np.meshgrid(np.arange(Nz), np.arange(Ny), np.arange(Nx),
                             indexing="ij")
    cubes = np.repeat(np.stack([cx, cy, cz], -1).reshape(-1, 3), 6, axis=0)
    perms = np.tile(np.arange(6), Nx * Ny * Nz)
    order = 2 if pack.n == 10 else 3
    device, ns, n = pack.weights.device, pack.ns, pack.n
    gids = torch.from_numpy(dof_gids_for_cells(mesh, order, cubes,
                                               perms)).to(device)
    # planar index of the cell's interleaved local dof 3 l + c
    idx = (torch.arange(3, device=device)[None, None, :] * ns
           + gids[:, :, None]).reshape(len(perms), 3 * n)
    rows = idx[:, :, None].expand(-1, -1, 3 * n)
    cols = idx[:, None, :].expand(-1, 3 * n, -1)
    vals = pack.Ap.to(torch.float64)[torch.from_numpy(perms).to(device)]
    keep = ~(pack.mask[rows] | pack.mask[cols])
    bc = torch.nonzero(pack.mask)[:, 0]
    r = torch.cat([rows[keep], bc])
    c = torch.cat([cols[keep], bc])
    v = torch.cat([vals[keep], torch.ones(len(bc), dtype=torch.float64,
                                          device=device)])
    A = torch.sparse_coo_tensor(torch.stack([r, c]), v,
                                (3 * ns, 3 * ns)).coalesce()
    del rows, cols, vals, keep, r, c, v
    nz = A.values() != 0.0  # entries that cancel in the assembly
    A = torch.sparse_coo_tensor(A.indices()[:, nz], A.values()[nz],
                                A.shape).coalesce()
    return A.to_sparse_csr().to(dtype)


def perm_work(pack, nnz: int):
    """(bytes, needed flops, per-perm flops) of one perm apply: x, the
    mask, the element matrices and the tables read once, y written once;
    2 nnz operations (the assembled matrix's), beside the per-perm form's
    2 x 6 cubes (3n)^2."""
    item = pack.weights.element_size()
    Nx, Ny, Nz = pack.dims
    nbytes = (3 * pack.ns * (2 * item + 1) + pack.Ap.numel() * item
              + 4 * (pack.entries.size + pack.outputs.size
                     + pack.sources.size + pack.kinds.size
                     + pack.chans.size))
    return nbytes, 2 * nnz, 2 * 6 * Nx * Ny * Nz * (3 * pack.n) ** 2


def perm_apply_phase(ops, gpu: str):
    """perm_apply against its plain version on ``ops`` ((name, the blocked
    StructuredOperator)), in float32 and, with the matrices cast, float64:
    within perm_apply_bound, Dirichlet rows equal to x, one launch per
    wrapper call, the prepared launch; times, the wrapper's host cost, the
    bound and torch.sparse.mm of the planar CSR.  Returns (rows, worst
    abs error)."""
    import dataclasses
    import torch
    from tpufem_torch.fem.perm_apply import (perm_apply, perm_apply_bound,
                                             perm_apply_plain,
                                             prepare_perm_apply)
    rows, worst = [], 0.0
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device="cuda").manual_seed(909)
        for name, op in ops:
            pack = dataclasses.replace(op.pack, Ap=op.pack.Ap.to(dtype),
                                       weights=op.pack.weights.to(dtype))
            device = pack.weights.device
            x = torch.randn(3 * pack.ns, generator=gen, device=device,
                            dtype=dtype)
            before = perm_apply.launches
            yk = perm_apply(x, pack)
            check(perm_apply.launches == before + 1,
                  f"perm_apply {name}: the wrapper did not launch once")
            launch = prepare_perm_apply(pack)
            check(torch.equal(launch(x), yk), f"perm_apply {name} {dtype}: "
                  "the prepared launch and the public wrapper differ")
            yp = perm_apply_plain(x, pack)
            bound = perm_apply_bound(x, pack)
            torch.cuda.synchronize()
            diff = (yk - yp).abs()
            abs_err = float(diff.max())
            ratio = float((diff / torch.where(bound > 0, bound, 1.0)).max())
            check(bool((diff <= bound).all())
                  and torch.equal(yk[pack.mask], x[pack.mask])
                  and bool(torch.isfinite(yk).all()),
                  f"perm_apply {name} {dtype}: off the plain version by "
                  f"{abs_err:.3e} ({ratio:.3e} of perm_apply_bound)")
            worst = max(worst, abs_err)
            lib = perm_csr(pack, dtype)
            nnz = lib._nnz()
            lib_ms, lib_err = library_ms(lib, x, yp)
            del lib
            ms = median_ms(lambda: launch(x))
            public_ms = median_ms(lambda: perm_apply(x, pack))
            plain_ms = median_ms(lambda: perm_apply_plain(x, pack), reps=3,
                                 samples=3)
            host = host_ms(lambda: launch(x))
            nbytes, flops, perm_flops = perm_work(pack, nnz)
            b_ms, b_by = bound_ms(nbytes, flops)
            pp_ms = bound_ms(nbytes, perm_flops)[0]
            # P3 500k: a bound set by operations, which no cache lowers
            # two launches a call: the cube products and the output sums
            dev, note = device_ms(lambda: launch(x), "perm_apply_", b_ms,
                                  f"perm_apply {name} {dtype}",
                                  must_hold=name.startswith("P3 500k"),
                                  launches=2)
            rows.append(dict(name=name, dtype=str(dtype).split(".")[1],
                             entries=len(pack.entries), nnz=nnz,
                             max_abs_err=abs_err, err_of_bound=ratio, ms=ms,
                             public_ms=public_ms, plain_ms=plain_ms,
                             device_ms=dev, device_note=note,
                             host_ms=host, library_ms=lib_ms, bound_ms=b_ms,
                             bound_by=b_by, per_perm_bound_ms=pp_ms,
                             smem_bytes=pack.smem_bytes(),
                             call_minus_device_ms=(None if dev is None
                                                   else ms - dev)))
            print(f"perm_apply {name:<22} {rows[-1]['dtype']:<7} "
                  f"{len(pack.entries)} entries over {len(pack.outputs)} "
                  f"outputs, {pack.smem_bytes()} B shared a block, "
                  f"{'x'.join(map(str, pack.bricks))} bricks | off the "
                  f"plain version by {abs_err:.3e} ({ratio:.3e} of the "
                  f"bound) | per call: kernel {ms:.4f} ms (public wrapper "
                  f"{public_ms:.4f}), plain {plain_ms:.4f} ms, "
                  f"torch.sparse.mm (CSR, {nnz} entries, off the plain "
                  f"version by {lib_err:.3e}) {lib_ms:.4f} ms | device: "
                  f"kernel {fmt_dev(dev, note)} | "
                  f"wrapper's host cost {host:.4f} ms per queued call | bound"
                  f" {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP needed; the per-perm form's "
                  f"{perm_flops / 1e6:.1f} MFLOP: {pp_ms:.4f} ms)  [{gpu}]",
                  flush=True)
            torch.cuda.empty_cache()
    return rows, worst


def elasticity_pk_phase(cli, gpu: str):
    """Phase 13: P2/P3 elasticity 500k f32 (CG + p-then-h GMG, planar,
    certified), perm_apply against its plain version, the f64 P2/P3
    goldens.  Returns (the runs' perm_apply launches, kernel rows, worst
    abs error)."""
    import torch
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.perm_apply import perm_apply
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.fem.structured_op import StructuredOperator
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import elasticity_bc_marker
    from tpufem_torch.timing import REGISTRY
    launches, ops = 0, []
    for order in (2, 3):
        res, n = elasticity_pk_run(cli, order, gpu)
        launches += n["perm_apply"]
        A = res.problem.solver_function.A
        ops.append((f"P{order} 500k {A.layout.Nx}x{A.layout.Ny}x"
                    f"{A.layout.Nz}", A))
        del res
        torch.cuda.empty_cache()
    # every entry near the boundary (2x3x2 cubes), and an odd lattice
    device = torch.device("cuda", 0)
    for order, dims in ((3, (2, 3, 2)), (2, (5, 3, 7))):
        mesh = BoxTetMesh(*dims)
        bc = DirichletBC.from_space(
            FunctionSpace(mesh, order, bs=3),
            mesh.locate_boundary_facets(elasticity_bc_marker)).flat_dofs()
        ops.append((f"P{order} {'x'.join(map(str, dims))}",
                    StructuredOperator.build(mesh, order, "elasticity",
                                             bc_dofs=bc, dtype=torch.float32,
                                             device=device, planar=True)))
    rows, worst = perm_apply_phase(ops, gpu)
    del ops
    torch.cuda.empty_cache()

    for order, (ndofs, its, norm) in ELASTICITY_PK_GOLD.items():
        REGISTRY.reset()
        perm_apply.launches = 0
        gold = cli.main(["--problem_type", "elasticity", "--order",
                         str(order), "--ndofs", "10000", "--scaling_type",
                         "weak", "--dtype", "float64", "-ksp_rtol", "1e-8",
                         "--device", "cuda"])
        rel = abs(gold.norm - norm) / norm
        print(f"elasticity P{order} float64 ({gold.problem.space.ndofs} "
              f"dofs): {gold.iterations} iterations (tpufem {its}), norm "
              f"{gold.norm!r} (tpufem {norm!r}, rel {rel:.2e}), perm_apply "
              f"launches {perm_apply.launches}  [{gpu}]", flush=True)
        check(gold.problem.space.ndofs == ndofs and gold.iterations == its
              and rel <= 1e-9 and perm_apply.launches > 0,
              f"elasticity P{order} float64 golden not held")
        del gold
    return launches, rows, worst


def busy_share(fn):
    """(device-busy share, wall s) of one call of ``fn``: the union of the
    CUDA kernel and copy intervals the profiler records, over the host
    clock around the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpufem_torch.profile_solve import busy_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return busy_us(spans) / 1e6 / wall, wall


def saamg_run(cli, key, argv, gpu, ndofs, levels, ref_it=None,
              ref_norm=None, levels_tol=0.0):
    """One SA-AMG run through the CLI, f32: the build and first certified
    solve with the CSR and dense kernels' counts set to zero just before
    and read just after; five warm uncertified solves (their launches
    per CG iteration, ms per iteration); the device-busy share of one
    more.  Spoke rows run to the 120-iteration cap (``ref_it`` None);
    cube rows are held within one iteration of tpufem's f32 CPU run.  The
    coarse level sizes are tpufem's, or within a share ``levels_tol`` of
    them.  Returns (the run's csr_spmv and dense_gemv launches, the
    problem)."""
    import torch
    from tpufem_torch.fem.csr_spmv import csr_spmv
    from tpufem_torch.fem.dense_gemv import DenseMat, dense_gemv_bf16
    from tpufem_torch.la.amg import SAAMG
    from tpufem_torch.timing import REGISTRY
    REGISTRY.reset()
    csr_spmv.launches = dense_gemv_bf16.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n_csr, n_dense = csr_spmv.launches, dense_gemv_bf16.launches
    prob = res.problem
    solver = prob.solver_function
    pc = solver.pc
    check(isinstance(pc, SAAMG), f"{key}: the solve is not SA-AMG")
    check(prob.space.ndofs == ndofs,
          f"{key}: {prob.space.ndofs} dofs, tpufem's has {ndofs}")
    check(len(pc.level_sizes) == len(levels) and pc.level_sizes[0] == levels[0]
          and all(abs(a - b) <= levels_tol * b
                  for a, b in zip(pc.level_sizes, levels)),
          f"{key}: levels {pc.level_sizes}, tpufem's {levels}")
    dense = any(isinstance(lv.A, DenseMat) for lv in pc.levels)
    check(n_csr > 0 and (n_dense > 0 or not dense),
          f"{key}: launches csr_spmv {n_csr}, dense_gemv_bf16 {n_dense}")
    check(res.x.shape == (ndofs,) and bool(torch.isfinite(res.x).all()),
          f"{key}: the solution is not a finite vector of ndofs")
    if ref_it is None:
        check(res.iterations == 120, f"{key}: {res.iterations} iterations, "
              "not the 120-iteration cap")
    else:
        check(abs(res.iterations - ref_it) <= 1,
              f"{key}: {res.iterations} iterations, tpufem {ref_it}")
    check(res.true_rel is not None and res.true_rel <= 1e-8
          and res.refine_passes <= 3,
          f"{key}: true_rel {res.true_rel}, {res.refine_passes} passes")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in pc.last_phase_s.items())
    print(f"{key}: {ndofs} dofs, route {solver.route}, levels "
          f"{pc.level_sizes}, {res.iterations} iterations"
          + (f" (tpufem {ref_it})" if ref_it is not None else "")
          + f", norm {res.norm!r}"
          + (f" (tpufem {ref_norm!r}, rel "
             f"{abs(res.norm - ref_norm) / ref_norm:.2e})"
             if ref_norm is not None else "")
          + f", {res.refine_passes} refinement pass(es) (+"
          f"{res.refine_iterations} its), true_rel {res.true_rel!r}; mesh "
          f"{REGISTRY.get('ZZZ Create Mesh'):.3f} s, assemble matrix "
          f"{REGISTRY.get('ZZZ Assemble matrix'):.3f} s, first solve "
          f"{REGISTRY.get('ZZZ Solve'):.3f} s = PC setup "
          f"{solver.pc_setup_s:.3f} s ({phases} s) + iterations + certify "
          f"{solver.certify_s:.3f} s; whole CLI run {first_s:.3f} s; "
          f"launches in the run: csr_spmv {n_csr}, dense_gemv_bf16 "
          f"{n_dense}  [{gpu}]", flush=True)
    runs = []
    csr_spmv.launches = dense_gemv_bf16.launches = 0
    for _ in range(5):
        t0 = time.perf_counter()
        _, its, _ = solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    check(its == res.iterations, f"{key}: warm solve took {its} iterations")
    per_it = (csr_spmv.launches / (5 * its),
              dense_gemv_bf16.launches / (5 * its))
    share, wall = busy_share(lambda: solver.run(prob.u, prob.b))
    solve_s = statistics.median(runs)
    print(f"{key} warm CG+SA-AMG solve (uncertified): median {solve_s:.4f} s "
          f"of 5 (min {min(runs):.4f}, max {max(runs):.4f}), "
          f"{solve_s / its * 1e3:.3f} ms/iteration; launches per CG "
          f"iteration: csr_spmv {per_it[0]:.2f}, dense_gemv_bf16 "
          f"{per_it[1]:.2f}; profiled warm solve {wall:.4f} s, device busy "
          f"{100 * share:.1f}%  [{gpu}]", flush=True)
    return n_csr, n_dense, res


def csr_work(A):
    """(bytes, flops) a CSR product needs: values, indices and indptr
    read once, x read once, y written once; 2 nnz flops."""
    import torch
    item_v = A.vals.element_size()
    item_x = torch.finfo(A.out_dtype).bits // 8
    nbytes = A.nnz * (item_v + 4) + (A.n + 1) * 4 + (A.ncols + A.n) * item_x
    return nbytes, 2 * A.nnz


def csr_kernel_phase(mats, gpu: str):
    """The CSR kernel against its plain version on the path's own
    matrices, within csr_spmv_bound and the same bits on two launches,
    with times, the wrapper's host cost, the bound and the share of it,
    the floor of the method at the matrix's n (an empty launch and an
    elementwise pass over y, each after the same L2 flush) and
    torch.sparse.mm of the same float32 / float64 matrix (cuSPARSE; none
    computes the bf16 product).  Returns (rows, worst abs error)."""
    import torch
    from tpufem_torch.fem.csr_spmv import (csr_spmv, csr_spmv_bound,
                                           csr_spmv_plain)
    rows, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(14)
    empty_ms, _ = device_ms(lambda: torch.cuda._sleep(0), "spin_kernel",
                            0.0, "an empty launch")
    print(f"csr_spmv: an empty launch after the L2 flush {fmt_ms(empty_ms)} "
          f"device  [{gpu}]", flush=True)
    for name, A in mats:
        x = torch.randn(A.ncols, generator=gen, device=A.device,
                        dtype=torch.float64).to(A.out_dtype)
        before = csr_spmv.launches
        y = A.matvec(x)
        check(csr_spmv.launches == before + 1,
              f"csr_spmv {name}: the product did not launch once")
        check(torch.equal(csr_spmv(A, x), y),
              f"csr_spmv {name}: two launches differ (not deterministic)")
        yp = csr_spmv_plain(A, x)
        bnd = csr_spmv_bound(A, x)
        torch.cuda.synchronize()
        err = (y - yp).abs()
        abs_err = float(err.max())
        check(bool(torch.isfinite(y).all()) and bool((err <= bnd).all()),
              f"csr_spmv {name}: kernel disagrees with the plain version "
              f"(max abs err {abs_err:.3e}, worst share of the bound "
              f"{float((err / bnd.clamp_min(1e-300)).max()):.3e})")
        worst = max(worst, abs_err)
        empty = int((A.indptr[1:] == A.indptr[:-1]).sum())
        ms = median_ms(lambda: A.matvec(x))
        host = host_ms(lambda: A.matvec(x))
        plain_ms = median_ms(lambda: csr_spmv_plain(A, x), reps=5, samples=5)
        lib_ms = lib_err = None
        if A.vals.dtype != torch.bfloat16:
            L = torch.sparse_csr_tensor(A.indptr.long(), A.indices.long(),
                                        A.vals, size=(A.n, A.ncols))
            lib_ms, lib_err = library_ms(L, x, yp)
            del L
        nbytes, flops = csr_work(A)
        b_ms, b_by = bound_ms(nbytes, flops)
        dev, note = device_ms(lambda: A.matvec(x), "csr_spmv_kernel", b_ms,
                              f"csr_spmv {name} {A.vals.dtype}")
        out = torch.empty_like(y)
        y_ms, _ = device_ms(lambda: torch.neg(y, out=out),
                            "elementwise_kernel", 0.0, f"a pass over y, {name}")
        rows.append(dict(name=name, dtype=str(A.vals.dtype).split(".")[1],
                         n=A.n, ncols=A.ncols, nnz=A.nnz, empty_rows=empty,
                         tiles=A.tiles,
                         max_abs_err=abs_err, ms=ms, device_ms=dev,
                         device_note=note, host_ms=host, plain_ms=plain_ms,
                         library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         share_of_bound=None if dev is None else b_ms / dev,
                         empty_launch_ms=empty_ms, y_pass_ms=y_ms,
                         call_minus_device_ms=(None if dev is None
                                               else ms - dev)))
        share = "n/a" if dev is None else f"{100 * b_ms / dev:.0f}%"
        print(f"csr_spmv {name:<34} {rows[-1]['dtype']:<8} {A.n}x{A.ncols}, "
              f"{A.nnz} entries, {empty} empty rows, {A.tiles} tiles | "
              f"max |kernel - plain| "
              f"{abs_err:.3e}, the same bits twice | per call: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse.mm "
              f"{fmt_ms(lib_ms)}"
              + (f" (off the plain version by {lib_err:.3e})"
                 if lib_err is not None else "")
              + f" | device {fmt_dev(dev, note)}, {share} of the bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB); floor: an "
              f"empty launch {fmt_ms(empty_ms)}, a pass over y "
              f"{fmt_ms(y_ms)} | host cost {host:.4f} ms per queued call  "
              f"[{gpu}]", flush=True)
    return rows, worst


def dense_kernel_phase(levels, gpu: str):
    """The bf16 dense kernel against its plain version on the path's
    dense levels, within dense_gemv_bound, with times, the bound, and
    torch.matmul of the bf16 operands (bf16 out: one more rounding) and
    torch.mv of the level widened to float32 beside it."""
    import torch
    from tpufem_torch.fem.dense_gemv import (dense_gemv_bf16,
                                             dense_gemv_bf16_plain,
                                             dense_gemv_bound)
    rows, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(15)
    for name, D in levels:
        n = D.n
        x = torch.randn(n, generator=gen, device=D.M.device)
        before = dense_gemv_bf16.launches
        y = D.matvec(x)
        check(dense_gemv_bf16.launches == before + 1,
              f"dense_gemv_bf16 {name}: the product did not launch once")
        check(torch.equal(dense_gemv_bf16(D, x), y),
              f"dense_gemv_bf16 {name}: two launches differ")
        yp = dense_gemv_bf16_plain(D, x)
        bnd = dense_gemv_bound(D, x)
        torch.cuda.synchronize()
        err = (y - yp).abs()
        abs_err = float(err.max())
        check(bool(torch.isfinite(y).all()) and bool((err <= bnd).all()),
              f"dense_gemv_bf16 {name}: kernel disagrees with the plain "
              f"version (max abs err {abs_err:.3e})")
        worst = max(worst, abs_err)
        ms = median_ms(lambda: D.matvec(x))
        host = host_ms(lambda: D.matvec(x))
        plain_ms = median_ms(lambda: dense_gemv_bf16_plain(D, x), reps=5,
                             samples=5)
        Mb, xb = D.M[:, :n], x.to(torch.bfloat16)
        bf16_ms = median_ms(lambda: torch.matmul(Mb, xb))
        bf16_err = float((torch.matmul(Mb, xb).float() - yp).abs().max())
        Mf = Mb.float()
        mv_ms = median_ms(lambda: torch.mv(Mf, x))
        del Mf
        nbytes = D.nbytes + 8 * n
        b_ms, b_by = bound_ms(nbytes, 2 * n * n)
        # M is far larger than the 50 MB L2: a reading under the bound is
        # a fault of the measurement; a call is two launches (the product
        # and the second step over split rows)
        dev, note = device_ms(lambda: D.matvec(x), "dense_gemv_bf16", b_ms,
                              f"dense_gemv_bf16 {name}", must_hold=True,
                              launches=2)
        rows.append(dict(name=name, n=n, max_abs_err=abs_err, ms=ms,
                         device_ms=dev, device_note=note, host_ms=host,
                         plain_ms=plain_ms, warps=D._launch.warps,
                         library_ms=bf16_ms, mv_f32_ms=mv_ms,
                         bf16_matmul_err=bf16_err, bound_ms=b_ms,
                         bound_by=b_by,
                         call_minus_device_ms=(None if dev is None
                                               else ms - dev)))
        print(f"dense_gemv_bf16 {name}: {n} rows | max |kernel - plain| "
              f"{abs_err:.3e} | per call: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.matmul(bf16, bf16) {bf16_ms:.4f} ms "
              f"(bf16 out, off the plain version by {bf16_err:.3e}), "
              f"torch.mv(f32) {mv_ms:.4f} ms | device {fmt_dev(dev, note)} "
              f"({D._launch.warps} warps) | host "
              f"cost {host:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
              f"{nbytes / 1e6:.2f} MB)  [{gpu}]", flush=True)
    return rows, worst


def saamg_phase(cli, gpu: str):
    """Phase 14: the spoke mesh's Poisson P1 at tpufem's two bench sizes
    and the cube's SA-AMG at 500k, f32, certified, through the CLI; the
    CSR kernel on the path's matrices (the spoke fine operator in f32,
    f64 and bf16, its P and P^T, sparse coarse levels, the cube's P0 and
    P0^T, a sparse coarse level: the spoke 150k level 1 under
    -amg_dense_level_limit 1000) and the dense kernel on the spoke 500k
    dense level (9,512 rows) and elasticity P1's level 1 (18,840);
    tpufem's f64 SA-AMG goldens.  Returns (csr launches, dense launches,
    csr rows, dense rows, worst csr error, worst dense error)."""
    import torch
    from tpufem_torch.fem.csr_spmv import CsrMatrix
    from tpufem_torch.fem.dense_gemv import DenseMat
    from tpufem_torch.timing import REGISTRY
    n_csr = n_dense = 0
    mats, dense_levels = [], []
    for key, (nd_arg, ndofs, levels, passes, true_rel) in SPOKE_ROWS.items():
        c, d, res = saamg_run(cli, key, SPOKE_ARGS + ["--ndofs", str(nd_arg)],
                              gpu, ndofs, levels)
        n_csr, n_dense = n_csr + c, n_dense + d
        print(f"{key}: refinement passes {res.refine_passes} (tpufem's TPU "
              f"row {passes}), true_rel {res.true_rel!r} (tpufem's "
              f"{true_rel})  [{gpu}]", flush=True)
        solver = res.problem.solver_function
        if key == "poisson_spoke":
            # every coarse level of the bench rows is dense; a sparse one,
            # as SA-AMG keeps it above the densify guard, from the same
            # fine matrix with -amg_dense_level_limit 1000
            from tpufem_torch.config import SolverOptions
            from tpufem_torch.la.amg import SAAMG
            opts = SolverOptions(amg_dense_level_limit=1000)
            sparse = SAAMG.setup(solver.csr, 1, opts, solver.device,
                                 dtype=torch.float32, bc_mask=solver.bc_mask)
            lv1 = sparse.levels[1].A
            check(isinstance(lv1, CsrMatrix), "spoke 150k: level 1 with "
                  "-amg_dense_level_limit 1000 is not a CSR matrix")
            mats.append(("spoke 150k level 1 (sparse)", lv1))
            del sparse
        if key.endswith("500k"):
            op = solver.op
            lv = solver.pc.levels
            mats += [("spoke 500k fine", op),
                     ("spoke 500k fine", op.astype(torch.float64)),
                     ("spoke 500k fine", op.astype(torch.bfloat16)),
                     ("spoke 500k P", lv[0].P), ("spoke 500k P^T", lv[0].PT),
                     ("spoke 500k level-1 P", lv[1].P),
                     ("spoke 500k level-1 P^T", lv[1].PT)]
            for i, lv in enumerate(solver.pc.levels[1:], 1):
                if isinstance(lv.A, DenseMat):
                    dense_levels.append((f"spoke 500k level {i}", lv.A))
                elif isinstance(lv.A, CsrMatrix):
                    mats.append((f"spoke 500k level {i}", lv.A))
        del res
        torch.cuda.empty_cache()
    for key, (opts, ndofs, levels, its, norm, true_rel, passes) in \
            SAAMG_REF.items():
        c, d, res = saamg_run(cli, key, SAAMG_BASE + opts, gpu, ndofs,
                              levels, its, norm)
        n_csr, n_dense = n_csr + c, n_dense + d
        print(f"{key}: refinement passes {res.refine_passes} (tpufem "
              f"{passes}), true_rel {res.true_rel!r} (tpufem {true_rel})"
              f"  [{gpu}]", flush=True)
        pc = res.problem.solver_function.pc
        if key == "poisson_p1_amg_brick_off":
            P0 = pc.levels[0].P0
            check(bool((P0.indptr[1:] == P0.indptr[:-1]).any()),
                  "cube P1 500k: P0 has no empty row")
            mats += [("cube P1 500k P0 (empty rows)", P0),
                     ("cube P1 500k P0^T", pc.levels[0].P0T),
                     ("cube P1 500k level-1 P", pc.levels[1].P),
                     ("cube P1 500k level-1 P^T", pc.levels[1].PT)]
        for i, lv in enumerate(pc.levels[1:], 1):
            if isinstance(lv.A, CsrMatrix):
                mats.append((f"{key} level {i}", lv.A))
            elif (isinstance(lv.A, DenseMat)
                  and key == "elasticity_p1_amg_brick_off"):
                # 18,840 rows, 710 MB of M: the busiest dense level
                dense_levels.append((f"elasticity P1 500k level {i}", lv.A))
        del res, pc
        torch.cuda.empty_cache()
    csr_rows, csr_worst = csr_kernel_phase(mats, gpu)
    dense_rows, dense_worst = dense_kernel_phase(dense_levels, gpu)
    check(sorted(r["n"] for r in dense_rows) == [9512, 18840],
          f"phase 14's dense bf16 levels: {[r['n'] for r in dense_rows]}, "
          "expected the spoke 500k's 9,512 rows and elasticity P1's 18,840")
    del mats, dense_levels
    torch.cuda.empty_cache()
    for argv, gold_it, gold_norm in SAAMG_GOLDS:
        REGISTRY.reset()
        res = cli.main(argv + ["--dtype", "float64", "--device", "cuda"])
        rel = abs(res.norm - gold_norm) / gold_norm
        print(f"SA-AMG float64 {' '.join(argv)}: {res.iterations} "
              f"iterations, norm {res.norm!r} (tpufem {gold_norm!r}, rel "
              f"{rel:.2e}), levels "
              f"{res.problem.solver_function.pc.level_sizes}  [{gpu}]",
              flush=True)
        check(res.iterations == gold_it, f"{' '.join(argv)}: "
              f"{res.iterations} iterations, tpufem {gold_it}")
        check(rel <= 1e-9, f"{' '.join(argv)}: norm off by rel {rel:.2e}")
        del res
    torch.cuda.empty_cache()
    return n_csr, n_dense, csr_rows, dense_rows, csr_worst, dense_worst


def matfree_work(op):
    """(bytes, flops, the plan's bytes) of one matrix-free apply: the
    metric as its six distinct entries, the cell dofs, x and y once each
    (what y = A x must move, the bound's bytes); the multiply-adds a cell
    of the tables' form with their zero entries left out
    (matfree_op.kernel_multiply_adds: P1 37, P2 277, P3 1,417); apart,
    what the design's plan adds: the cluster plan's slot locals and
    summing order (2 bytes a slot each), its locals' dofs and run ends,
    the halo lists and the partial sums written and read."""
    from tpufem_torch.fem.matfree_op import kernel_multiply_adds
    item = op.G.element_size()
    C, n, N = op.ncells, op.n, op.ndofs
    nbytes = C * 6 * item + C * n * 4 + 2 * N * item
    p = op.cplan
    plan = (p.ld.nbytes + p.sum_idx.nbytes + p.gid.nbytes
            + p.sum_end.nbytes + p.clusters.nbytes + p.halo_dof.nbytes
            + p.halo_off.nbytes + p.halo_src.nbytes * (4 + 2 * item) // 4)
    return nbytes, 2 * kernel_multiply_adds(op.order) * C, plan


def matfree_kernel_phase(ops, gpu: str):
    """The matrix-free kernel against its plain version on the spoke's
    operators, within matfree_action_bound, the same bits on two
    launches, with times (the device time of its launches after an L2
    flush, per call, the host cost), the bound, the cluster plan's halo
    share and largest cluster, and torch.sparse.mm of the assembled CSR
    of the same operator where it is given.  Returns (rows, worst abs
    error)."""
    import torch
    from tpufem_torch.fem.matfree_op import (matfree_action,
                                             matfree_action_bound,
                                             matfree_apply_plain,
                                             matfree_launches)
    rows, worst = [], 0.0
    for name, op, L in ops:
        gen = torch.Generator(device=op.device).manual_seed(15)
        x = torch.randn(op.ndofs, generator=gen, device=op.device,
                        dtype=torch.float64).to(op.dtype)
        before = matfree_action.launches
        y = op.apply(x)
        check(matfree_action.launches == before + 1,
              f"matfree_action {name}: the apply did not count once")
        check(torch.equal(matfree_action(op, x), y),
              f"matfree_action {name}: two launches differ")
        yp = matfree_apply_plain(op, x)
        bnd = matfree_action_bound(op, x)
        torch.cuda.synchronize()
        err = (y - yp).abs()
        abs_err = float(err.max())
        check(bool(torch.isfinite(y).all()) and bool((err <= bnd).all()),
              f"matfree_action {name}: kernel disagrees with the plain "
              f"version (max abs err {abs_err:.3e}, worst share of the bound "
              f"{float((err / bnd.clamp_min(1e-300)).max()):.3e})")
        worst = max(worst, abs_err)
        ms = median_ms(lambda: op.apply(x))
        host = host_ms(lambda: op.apply(x))
        plain_ms = median_ms(lambda: matfree_apply_plain(op, x), reps=3,
                             samples=3)
        lib_ms = lib_err = None
        if L is not None:
            lib_ms, lib_err = library_ms(L, x, yp)
        nbytes, flops, plan_bytes = matfree_work(op)
        b_ms, b_by = bound_ms(nbytes, flops)
        dev, note = device_ms(lambda: op.apply(x), "matfree_action", b_ms,
                              f"matfree_action {name} {op.dtype}",
                              launches=matfree_launches(op))
        dtype = str(op.dtype).split(".")[1]
        plan = op.cplan
        rows.append(dict(name=name, dtype=dtype, order=op.order,
                         cells=op.ncells, ndofs=op.ndofs, max_abs_err=abs_err,
                         ms=ms, device_ms=dev, device_note=note,
                         host_ms=host, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_ms_with_plan=bound_ms(nbytes + plan_bytes,
                                                     flops)[0],
                         share_of_bound=None if dev is None else b_ms / dev,
                         call_minus_device_ms=(None if dev is None
                                               else ms - dev),
                         halo_share=plan.halo_share,
                         largest_cluster=plan.max_locals))
        share = "n/a" if dev is None else f"{100 * b_ms / dev:.0f}%"
        print(f"matfree_action {name:<22} {dtype:<8} P{op.order}, "
              f"{op.ncells} cells, {op.ndofs} dofs | max |kernel - plain| "
              f"{abs_err:.3e}, the same bits twice | per call: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse.mm "
              + (f"{fmt_ms(lib_ms)} (off the plain version by {lib_err:.3e})"
                 if L is not None else "none (no CSR assembled)")
              + f" | device {fmt_dev(dev, note)}, {share} of the bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB; the plan "
              f"{plan_bytes / 1e6:.2f} MB more; {flops / 1e9:.3f} "
              f"GFLOP) | clusters of {plan.cells} cells, halo share "
              f"{plan.halo_share:.3f}, largest cluster {plan.max_locals} "
              f"dofs | host cost {host:.4f} ms per queued call  [{gpu}]",
              flush=True)
    return rows, worst


def spoke_cg_run(cli, order: int, nd: int, gpu: str):
    """One matrix-free cgpoisson CLI run on the spoke, f32, with every
    operator kernel's count set to zero just before it and read just
    after: it must launch matfree_action and no other operator kernel,
    run 100 steps and agree with tpufem's float32 run (SPOKE_CG_REF,
    within CG_SPOKE_NORM_TOL / CG_SPOKE_REL_TOL).  Returns (result,
    matfree_action launches)."""
    import torch
    from tpufem_torch.fem.csr_spmv import csr_spmv
    from tpufem_torch.fem.dense_gemv import dense_gemv_bf16
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    from tpufem_torch.fem.flat_op import FlatOperator
    from tpufem_torch.fem.matfree_op import MatFreePoissonOp, matfree_action
    from tpufem_torch.fem.perm_apply import perm_apply
    from tpufem_torch.fem.stencil import stencil_apply, stencil_apply_bs3
    from tpufem_torch.fem.strip_op import StripOperator
    from tpufem_torch.la.brick_flat import brick_flat_apply
    from tpufem_torch.timing import REGISTRY
    others = (stencil_apply, stencil_apply_bs3, StripOperator.apply_strips,
              StripOperator.cg_resident, FlatOperator.interior,
              dia_zones_apply, perm_apply, csr_spmv, dense_gemv_bf16,
              brick_flat_apply)
    REGISTRY.reset()
    for k in others:
        k.launches = 0
    matfree_action.launches = 0
    t0 = time.perf_counter()
    res = cli.main(SPOKE_CG_ARGS + ["--order", str(order), "--ndofs",
                                    str(nd)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_mf = matfree_action.launches
    n_other = sum(k.launches for k in others)
    solver = res.problem.solver_function
    ndofs, cells, ref_it, ref_rel, ref_norm = SPOKE_CG_REF[(order, nd)]
    norm_err = abs(res.norm - ref_norm) / ref_norm
    rel_err = abs(solver.rel - ref_rel) / ref_rel
    print(f"cgpoisson spoke P{order} --ndofs {nd} f32: {ndofs} dofs, "
          f"{res.problem.space.mesh.num_cells_global} cells, "
          f"{res.iterations} iterations, rel {solver.rel!r} (tpufem "
          f"{ref_rel!r}, off by {rel_err:.2e}), norm {res.norm!r} (tpufem "
          f"{ref_norm!r}, off by {norm_err:.2e}); launches matfree_action "
          f"{n_mf}, other operator kernels {n_other}; {solver.gdofs:.4f} "
          f"Gdof/s, {solver.solve_s:.6f} s per solve; mesh "
          f"{REGISTRY.get('ZZZ Create Mesh'):.3f} s, operator "
          f"{REGISTRY.get('ZZZ Assemble matrix'):.3f} s, RHS "
          f"{REGISTRY.get('ZZZ Assemble vector'):.3f} s, whole CLI run "
          f"{run_s:.3f} s  [{gpu}]", flush=True)
    check(isinstance(solver.op, MatFreePoissonOp),
          f"cgpoisson spoke P{order}: the operator is "
          f"{type(solver.op).__name__}")
    check(res.problem.space.ndofs == ndofs and
          res.problem.space.mesh.num_cells_global == cells,
          f"cgpoisson spoke P{order}: {res.problem.space.ndofs} dofs, "
          f"tpufem's run had {ndofs}")
    check(n_mf > 0 and n_other == 0,
          f"cgpoisson spoke P{order}: launches matfree_action {n_mf}, "
          f"other operator kernels {n_other}")
    check(res.iterations == ref_it,
          f"cgpoisson spoke P{order}: {res.iterations} iterations")
    check(res.x.shape == (ndofs,) and bool(torch.isfinite(res.x).all()),
          f"cgpoisson spoke P{order}: the solution is not finite")
    check(norm_err <= CG_SPOKE_NORM_TOL and rel_err <= CG_SPOKE_REL_TOL,
          f"cgpoisson spoke P{order}: off tpufem's norm by {norm_err:.2e}, "
          f"rel by {rel_err:.2e}")
    return res, n_mf


def spoke_elasticity_run(cli, gpu: str):
    """Elasticity on the spoke, f32, 8 CG steps (SPOKE_PK_REF's
    ``elasticity``): the bs = 3 SA-AMG hierarchy on csr_spmv (and the
    bf16 dense level), counted from zero around the run, its levels as
    tpufem's, the norm against tpufem's f32 run.  The system is singular
    and inconsistent (no clamped face): true_rel is printed, not held.
    Returns (csr launches, dense launches, the result)."""
    import torch
    from tpufem_torch.fem.csr_spmv import csr_spmv
    from tpufem_torch.fem.dense_gemv import dense_gemv_bf16
    from tpufem_torch.la.amg import SAAMG
    from tpufem_torch.timing import REGISTRY
    argv, ndofs, levels, ref_it, ref_norm, ref_true, _ = \
        SPOKE_PK_REF["elasticity_spoke_8"]
    REGISTRY.reset()
    csr_spmv.launches = dense_gemv_bf16.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_csr, n_dense = csr_spmv.launches, dense_gemv_bf16.launches
    solver = res.problem.solver_function
    pc = solver.pc
    norm_err = abs(res.norm - ref_norm) / ref_norm
    print(f"elasticity spoke f32 -ksp_max_it 8: {res.problem.space.ndofs} "
          f"dofs, route {solver.route}, levels {pc.level_sizes} (tpufem "
          f"{levels}), {res.iterations} iterations (tpufem {ref_it}), norm "
          f"{res.norm!r} (tpufem {ref_norm!r}, off by {norm_err:.2e}), "
          f"true_rel {res.true_rel!r} (tpufem {ref_true}; the system is "
          f"singular and inconsistent, CG grows until its cap: tpufem's "
          f"6,000-dof run at the default cap of 500 ends at true_rel "
          f"2.680e+08, a known behaviour of the reference); PC setup "
          f"{solver.pc_setup_s:.3f} s; launches csr_spmv {n_csr}, "
          f"dense_gemv_bf16 {n_dense}; whole CLI run {run_s:.3f} s  [{gpu}]",
          flush=True)
    check(isinstance(pc, SAAMG) and solver.route == "plain",
          "elasticity spoke: not SA-AMG on the plain route")
    check(res.problem.space.ndofs == ndofs and pc.level_sizes == levels,
          f"elasticity spoke: {res.problem.space.ndofs} dofs, levels "
          f"{pc.level_sizes}; tpufem {ndofs}, {levels}")
    check(res.iterations == ref_it, f"elasticity spoke: {res.iterations} "
          "iterations")
    check(n_csr > 0, "elasticity spoke: no csr_spmv launch")
    check(bool(torch.isfinite(res.x).all()) and norm_err <=
          SPOKE_ELAST_NORM_TOL,
          f"elasticity spoke: off tpufem's norm by {norm_err:.2e}")
    return n_csr, n_dense, res


def spoke_pk_phase(cli, gpu: str):
    """Phase 15: the spoke mesh's matrix-free cgpoisson P1 500k and P2 /
    P3 150k (matfree_action), Poisson P2 150k and P3 50k on SA-AMG
    (certified), elasticity 150k (8 steps), the kernel against its plain
    version on the three cgpoisson operators in float32 and float64 (the
    float64 operators rebuilt from the same meshes) with torch.sparse.mm
    of the assembled CSR at P1 and P2, and tpufem's float64 runs at 3,000
    dofs.  Returns (matfree launches, rows, worst error, csr launches,
    dense launches)."""
    import numpy as np
    import torch
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.fem.matfree_op import MatFreePoissonOp
    from tpufem_torch.timing import REGISTRY
    n_mf, ops = 0, []
    for order, nd in SPOKE_CG_REF:
        res, n = spoke_cg_run(cli, order, nd, gpu)
        n_mf += n
        prob = res.problem
        op = prob.solver_function.op
        L = L64 = None
        if order <= 2:
            t0 = time.perf_counter()
            ip, ix, data = assemble_csr_np(prob.space, prob.bc, "poisson")
            ip = torch.from_numpy(ip.astype(np.int64))
            ix = torch.from_numpy(ix.astype(np.int64))
            L = torch.sparse_csr_tensor(ip, ix, torch.from_numpy(data),
                                        size=(op.ndofs, op.ndofs))
            L64 = L.to(device=op.device)
            L = L64.to(torch.float32)
            print(f"spoke P{order}: the assembled CSR ({data.shape[0]} "
                  f"entries) in {time.perf_counter() - t0:.3f} s  [{gpu}]",
                  flush=True)
        op64 = MatFreePoissonOp.build(prob.space, prob.bc, torch.float64,
                                      op.device)
        label = f"spoke P{order} {nd // 1000}k"
        ops += [(label, op, L), (label, op64, L64)]
        del res, prob
    rows, worst = matfree_kernel_phase(ops, gpu)
    del ops
    torch.cuda.empty_cache()
    n_csr = n_dense = 0
    for key, (argv, ndofs, levels, its, norm, true_rel, passes) in \
            SPOKE_PK_REF.items():
        if key.startswith("elasticity"):
            continue
        c, d, res = saamg_run(cli, key, argv, gpu, ndofs, levels, its, norm,
                              levels_tol=SPOKE_PK_LEVELS_TOL)
        n_csr, n_dense = n_csr + c, n_dense + d
        print(f"{key}: refinement passes {res.refine_passes} (tpufem "
              f"{passes}), true_rel {res.true_rel!r} (tpufem {true_rel}), "
              f"order {res.problem.space.order}  [{gpu}]", flush=True)
        del res
        torch.cuda.empty_cache()
    c, d, res = spoke_elasticity_run(cli, gpu)
    n_csr, n_dense = n_csr + c, n_dense + d
    del res
    torch.cuda.empty_cache()
    for problem, order, extra, gold_it, gold_norm, tol in SPOKE_F64_GOLDS:
        REGISTRY.reset()
        argv = ["--problem_type", problem, "--mesh_type", "unstructured",
                "--order", str(order), "--ndofs", "3000", "--dtype",
                "float64", "--device", "cuda"] + extra
        res = cli.main(argv)
        rel = abs(res.norm - gold_norm) / gold_norm
        print(f"spoke float64 {problem} P{order} {' '.join(extra)}: "
              f"{res.iterations} iterations, norm {res.norm!r} (tpufem "
              f"{gold_norm!r}, rel {rel:.2e}, held to {tol:g})  [{gpu}]",
              flush=True)
        check(res.iterations == gold_it, f"spoke float64 {problem} "
              f"P{order}: {res.iterations} iterations, tpufem {gold_it}")
        check(rel <= tol, f"spoke float64 {problem} P{order}: norm off by "
              f"rel {rel:.2e}")
        del res
    torch.cuda.empty_cache()
    return n_mf, rows, worst, n_csr, n_dense


def shard_counters():
    """The launch counters of the kernels a sharded run may reach."""
    from tpufem_torch.fem.csr_spmv import csr_spmv
    from tpufem_torch.fem.dense_gemv import dense_gemv_bf16
    from tpufem_torch.fem.dia_zones import dia_zones_apply
    from tpufem_torch.fem.perm_apply import perm_apply
    from tpufem_torch.fem.stencil import stencil_apply, stencil_apply_bs3
    return {"stencil_p1": stencil_apply, "stencil_p1_bs3": stencil_apply_bs3,
            "dia_zones": dia_zones_apply, "perm_apply": perm_apply,
            "csr_spmv": csr_spmv, "dense_gemv_bf16": dense_gemv_bf16}


def shard_run(cli, name: str, argv, gpu: str):
    """One run through the CLI with every kernel's count set to 0 just
    before and read just after: (result, launches, seconds)."""
    import torch
    counters = shard_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: c.launches for k, c in counters.items()}
    check(res.x.shape == (res.problem.space.ndofs,)
          and bool(torch.isfinite(res.x).all()),
          f"{name}: the solution is not a finite vector of ndofs")
    solver = res.problem.solver_function
    extra = ""
    if hasattr(solver, "sh"):
        extra = (f", warm solve {solver.solve_s:.4f} s, rel {solver.rel:.3e}"
                 + (f", {solver.gdofs:.4f} Gdof/s" if solver.gdofs else ""))
    print(f"{name}: {res.iterations} iterations, norm {res.norm!r}, "
          f"{res.problem.space.ndofs} dofs{extra}, CLI run {dt:.2f} s; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in n.items() if v)
          + f"  [{gpu}]", flush=True)
    return res, n, dt


def slab_kernel_rows(sh, name: str, gpu: str):
    """The kernel of a sharded solver's finest slab operator against its
    plain version on the shard shapes the sharded path gives it, with
    times and the bound: (kernel name, row).  K1 and its three-component
    form (f32) within their tolerances, ``dia_zones`` (the P2 / P3 const
    DIA) to the plain version's bits."""
    import torch
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.dia_zones import (dia_zones_apply,
                                            dia_zones_apply_plain)
    op = sh.levels[0].op
    if getattr(op, "zone_pack", None) is not None:
        kernel, pack = "dia_zones", op.zone_pack
        dev, dtype = pack.fields.device, pack.fields.dtype
        gen = torch.Generator(device=dev).manual_seed(16)
        x = torch.randn(pack.ndofs, generator=gen, device=dev, dtype=dtype)
        yk, yp = dia_zones_apply(x, pack), dia_zones_apply_plain(x, pack)
        abs_err = float((yk - yp).abs().max())
        check(bool(torch.equal(yk, yp)), f"{name}: the slab kernel "
              f"dia_zones is not its plain version's bits (max abs err "
              f"{abs_err:.3e})")
        ms = median_ms(lambda: dia_zones_apply(x, pack))
        plain_ms = median_ms(lambda: dia_zones_apply_plain(x, pack), reps=3,
                             samples=3)
        b_ms, b_by = bound_ms(*dia_zones_work(pack))
        lay = op.layout
        shape, width = f"{lay.Nx}x{lay.Ny}x{lay.Nz} P{lay.order}", \
            len(pack.terms)
    else:
        comps = 3 if op.bs > 1 else 1
        kernel = "stencil_p1_bs3" if comps == 3 else "stencil_p1"
        apply, plain, tol = ((st.stencil_apply_bs3,
                              st.stencil_apply_bs3_plain, TOL_BS3_F32)
                             if comps == 3 else
                             (st.stencil_apply, st.stencil_apply_plain,
                              TOL_F32))
        args = (op.fields, op.offsets, op.grid_dims)
        dev = op.fields.device
        gen = torch.Generator(device=dev).manual_seed(16)
        x = torch.randn(comps * op.fields.shape[2] * op.fields.shape[3]
                        * op.grid_dims[0], generator=gen, device=dev,
                        dtype=op.fields.dtype)
        yk, yp = op.apply(x), plain(x, *args)
        bound = plain(x.abs(), op.fields.abs(), *args[1:])
        err = (yk - yp).abs()
        abs_err = float(err.max())
        check(bool((err <= tol * bound).all()),
              f"{name}: the slab kernel disagrees with its plain version "
              f"(max abs err {abs_err:.3e})")
        ms = median_ms(lambda: op.apply(x))
        plain_ms = median_ms(lambda: plain(x, *args), reps=10, samples=5)
        b_ms, b_by = bound_ms(*stencil_work(op.fields, op.grid_dims, comps))
        shape, width = "x".join(map(str, op.grid_dims)), op.fields.shape[1]
    row = dict(name=name, shape=shape, R=width, max_abs_err=abs_err, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"slab kernel {kernel} {name} {shape} R={width}: abs "
          f"{abs_err:.3e} | kernel {ms:.4f} ms per call, plain "
          f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})  [{gpu}]",
          flush=True)
    return kernel, row


def warm_median_s(solve, n: int = 3) -> float:
    """The median seconds of ``n`` warm solves ``solve()`` of one RHS,
    after one untimed."""
    import torch
    solve()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def rowshard_kernel_row(sh, name: str, gpu: str):
    """csr_spmv on the row-sharded block-diagonal operator of every local
    shard against its plain version (within csr_spmv_bound)."""
    import torch
    from tpufem_torch.fem.csr_spmv import csr_spmv_bound, csr_spmv_plain
    A = sh.data["A"]
    gen = torch.Generator(device=A.device).manual_seed(16)
    x = torch.randn(A.ncols, generator=gen, device=A.device,
                    dtype=torch.float64).to(A.out_dtype)
    y, yp = A.matvec(x), csr_spmv_plain(A, x)
    err = (y - yp).abs()
    abs_err = float(err.max())
    check(bool((err <= csr_spmv_bound(A, x)).all()),
          f"{name}: csr_spmv disagrees with its plain version on the "
          f"block-diagonal shard rows (max abs err {abs_err:.3e})")
    ms = median_ms(lambda: A.matvec(x))
    plain_ms = median_ms(lambda: csr_spmv_plain(A, x), reps=5, samples=5)
    b_ms, b_by = bound_ms(*csr_work(A))
    row = dict(name=name, n=A.n, nnz=A.nnz, max_abs_err=abs_err, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"rowshard csr_spmv {name} ({A.n} rows, {A.nnz} entries): abs "
          f"{abs_err:.3e} | kernel {ms:.4f} ms per call, plain "
          f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})  [{gpu}]",
          flush=True)
    return row


def certify_rowshard(res, rtol: float):
    """A row-sharded spoke solution certified in float64 against the
    assembled CSR, refined through the sharded solver itself (at most 3
    passes): the CertifyResult."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.la.refine import Certifier
    from tpufem_torch.problems.poisson import assemble_poisson_rhs_np
    sh = res.problem.solver_function.sh
    space, bc = res.problem.space, res.problem.bc
    csr = assemble_csr_np(space, bc, "poisson")
    M = sp.csr_matrix((csr[2], csr[1], csr[0]))
    b64 = assemble_poisson_rhs_np(space)
    b64 = b64 - b64.mean()  # the compatible RHS of the Neumann system

    def corr(r):
        s = float(np.linalg.norm(r))
        b = torch.from_numpy(sh.gmap.distribute(r / s)[sh.comm.local]
                             .astype(np.float32)).to(sh.comm.device)
        x, it, _ = sh._run(b)
        return sh.collect(x).astype(np.float64) * s, it

    return Certifier(lambda v: M @ v, b64, rtol).certify(
        res.x.cpu().numpy(), corr, max_passes=3)


def sharded_phase(cli, gpu: str):
    """Phase 16: --num_shards on the one card.  Poisson P1 and P2 and
    elasticity P1 500k f32 over 4 slabs against --num_shards 1, the warm
    solves of both timed alike; cgpoisson P3 150k over 4 slabs (100
    steps, Gdof/s, tpufem's f32 run); tpufem's sharded
    float64 goldens; the spoke's row-sharded Poisson P1 150k over 2 shards
    against the single-device run, both certified; the process-group form
    with one rank over NCCL (the poisson100k-8shard golden); the slab and
    row-sharded kernels against their plain versions on their shard
    shapes.  Returns (launches by kernel, kernel rows)."""
    import socket
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist
    from tpufem_torch.problems import sharded
    total = {k: 0 for k in shard_counters()}

    def add(n):
        for k, v in n.items():
            total[k] += v

    rows = {"stencil_p1": [], "stencil_p1_bs3": [], "dia_zones": [],
            "csr_spmv": []}
    for problem, order, kernel in (("poisson", 1, "stencil_p1"),
                                   ("poisson", 2, "dia_zones"),
                                   ("elasticity", 1, "stencil_p1_bs3")):
        what = f"{problem} P{order} 500k"
        argv = SHARD_ARGS + ["--problem_type", problem, "--ndofs", "500000",
                             "--order", str(order)]
        r1, n1, _ = shard_run(cli, f"{what}, 1 shard",
                              argv + ["--num_shards", "1"], gpu)
        solver1 = r1.problem.solver_function
        x1, it1, _ = solver1.run(r1.problem.u, r1.problem.b)
        warm1 = warm_median_s(
            lambda: solver1.run(r1.problem.u, r1.problem.b))
        r4, n4, _ = shard_run(cli, f"{what}, 4 shards",
                              argv + ["--num_shards", "4"], gpu)
        add(n4)
        sh = r4.problem.solver_function.sh
        warm4 = warm_median_s(lambda: sh._run(sh.b_local))
        diff = float((r4.x - x1).norm() / x1.norm())
        print(f"{what}: 4 shards {r4.iterations} iterations against 1 "
              f"shard {r1.iterations}; solutions off by {diff:.3e} (tol "
              f"{SHARD_F32_X_TOL:.0e}); warm uncertified solve of the same "
              f"RHS (median of 3): 4 shards {warm4:.4f} s, 1 shard "
              f"{warm1:.4f} s ({warm4 / warm1:.2f}x); the 1-shard run "
              f"certified {r1.true_rel!r} in {r1.refine_passes} pass(es)  "
              f"[{gpu}]", flush=True)
        check(abs(r4.iterations - r1.iterations) <= 1,
              f"{what}: 4 shards {r4.iterations} iterations, 1 shard "
              f"{r1.iterations}")
        check(diff <= SHARD_F32_X_TOL,
              f"{what}: 4-shard solution off by {diff:.3e}")
        check(n4[kernel] > 0, f"{what}, 4 shards: {kernel} never launched")
        k, row = slab_kernel_rows(sh, f"{what} slab", gpu)
        check(k == kernel, f"{what}: the slab operator is {k}, not {kernel}")
        rows[k].append(row)
        del r1, r4, x1, solver1, sh
        torch.cuda.empty_cache()

    argv = (CG_ARGS + ["--order", "3", "--ndofs", "150000", "--num_shards",
                       "4"])
    r, n, _ = shard_run(cli, "cgpoisson P3 150k, 4 shards", argv, gpu)
    add(n)
    nd_ref, it_ref, norm_ref = SHARD_CG_REF
    off = abs(r.norm - norm_ref) / norm_ref
    print(f"cgpoisson P3 150k, 4 shards: {r.problem.space.ndofs} dofs, "
          f"{r.iterations} steps, {r.problem.solver_function.gdofs:.4f} "
          f"Gdof/s, norm off tpufem's f32 sharded run by {off:.2e} (tol "
          f"{CG_F32_NORM_TOL:.0e})  [{gpu}]", flush=True)
    check(r.problem.space.ndofs == nd_ref and r.iterations == it_ref,
          f"cgpoisson P3 150k sharded: {r.problem.space.ndofs} dofs, "
          f"{r.iterations} steps")
    check(off <= CG_F32_NORM_TOL, f"cgpoisson P3 150k sharded: norm off "
          f"tpufem's by {off:.2e}")
    check(n["dia_zones"] > 0, "cgpoisson P3 150k, 4 shards: dia_zones never "
          "launched")
    k, row = slab_kernel_rows(r.problem.solver_function.sh,
                              "cgpoisson P3 150k slab", gpu)
    check(k == "dia_zones", f"cgpoisson P3 150k: the slab operator is {k}")
    rows[k].append(row)
    del r
    torch.cuda.empty_cache()

    for argv, it, norm in SHARD_GOLDS:
        r, n, _ = shard_run(cli, "golden " + " ".join(argv[1:8:2]), argv,
                            gpu)
        add(n)
        rel = abs(r.norm - norm) / norm
        check(r.iterations == it and rel <= 1e-9,
              f"sharded golden {argv}: {r.iterations} iterations (golden "
              f"{it}), norm off by {rel:.2e}")
        check(n["stencil_p1"] + n["stencil_p1_bs3"] > 0,
              f"sharded golden {argv}: K1 never launched")
        print(f"  golden held: {it} iterations, norm rel {rel:.2e}",
              flush=True)

    argv = SPOKE_ARGS + ["--ndofs", "150000"]
    r1, n1, _ = shard_run(cli, "spoke P1 150k, 1 device", argv, gpu)
    r2, n2, _ = shard_run(cli, "spoke P1 150k, 2 shards",
                          argv + ["--num_shards", "2"], gpu)
    add(n2)
    check(n2["csr_spmv"] > 0, "spoke 150k, 2 shards: csr_spmv never "
          "launched")
    cert = certify_rowshard(r2, 1e-8)
    n64 = float(np.linalg.norm(cert.x64))
    off = abs(n64 - r1.norm) / r1.norm
    print(f"spoke P1 150k: 2 shards {r2.iterations} iterations (cap), "
          f"certified true_rel {cert.true_rel:.3e} in {cert.passes} "
          f"pass(es), norm {n64!r}; 1 device {r1.iterations}, true_rel "
          f"{r1.true_rel:.3e} in {r1.refine_passes} pass(es), norm "
          f"{r1.norm!r}; certified norms off by {off:.2e} (tol "
          f"{SPOKE_SHARD_NORM_TOL:.0e})  [{gpu}]", flush=True)
    check(r2.iterations == 120 and r1.iterations == 120,
          "spoke 150k: not at the 120-iteration cap")
    check(cert.true_rel <= 1e-8 and abs(cert.passes - r1.refine_passes) <= 1,
          f"spoke 150k sharded: true_rel {cert.true_rel}, {cert.passes} "
          f"passes against {r1.refine_passes}")
    check(off <= SPOKE_SHARD_NORM_TOL, f"spoke 150k sharded: certified "
          f"norm off by {off:.2e}")
    rows["csr_spmv"].append(rowshard_kernel_row(
        r2.problem.solver_function.sh, "spoke 150k, 2 shards", gpu))
    del r1, r2, cert
    torch.cuda.empty_cache()

    # the process-group form, one rank over NCCL
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        argv, it, norm = SHARD_GOLDS[0]
        r, n, _ = shard_run(cli, "NCCL group of 1 rank, golden", argv, gpu)
        add(n)
        comm = r.problem.solver_function.sh.comm
        rel = abs(r.norm - norm) / norm
        check(comm.group and dist.get_backend() == "nccl",
              "the NCCL run did not use the process group")
        check(r.iterations == it and rel <= 1e-9,
              f"NCCL golden: {r.iterations} iterations, norm off by "
              f"{rel:.2e}")
        print(f"NCCL process group (1 rank, 8 shards): {r.iterations} "
              f"iterations, norm rel {rel:.2e}  [{gpu}]", flush=True)
    finally:
        dist.destroy_process_group()
    print("phase 16 launches: " + ", ".join(f"{k} {v}" for k, v in
                                            total.items()), flush=True)
    return total, rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpufem_torch import _build, cli
    from tpufem_torch.problems import poisson
    from tpufem_torch.fem.stencil import stencil_apply
    from tpufem_torch.timing import REGISTRY

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc_version()}, device count {torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    kern = _build.load()
    print(f"kernel build: {kern.build_seconds:.2f} s nvcc, "
          f"{time.perf_counter() - t0:.2f} s with load ({kern.path.name})",
          flush=True)
    for line in kern.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 2. the main path ---------------------------------------------------
    REGISTRY.reset()
    stencil_apply.launches = 0
    t0 = time.perf_counter()
    res = cli.main(MAIN_ARGS)
    first_s = time.perf_counter() - t0
    launches = stencil_apply.launches
    solver = res.problem.solver_function
    print(f"main path: {res.iterations} iterations, norm {res.norm!r}, "
          f"true_rel {res.true_rel!r}, {res.refine_passes} refinement "
          f"pass(es) (+{res.refine_iterations} its), stencil launches "
          f"{launches}, PC setup {solver.pc_setup_s:.3f} s, certify "
          f"{solver.certify_s:.3f} s, first solve (ZZZ Solve) "
          f"{REGISTRY.get('ZZZ Solve'):.3f} s, whole CLI run {first_s:.3f} s"
          f"  [{gpu}]", flush=True)
    check(launches > 0, "the main path launched no stencil kernel")
    check(0 < res.iterations < 100, f"CG did not converge ({res.iterations})")
    check(res.true_rel is not None and res.true_rel <= 1e-8,
          f"certified true residual {res.true_rel} > 1e-8")
    prob = res.problem
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, its = solver(prob.u, prob.b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(x.shape == (prob.space.ndofs,) and bool(torch.isfinite(x).all()),
          "main-path solution is not a finite vector of ndofs")
    check(its == res.iterations, f"warm solve took {its} iterations, "
          f"first took {res.iterations}")
    print(f"warm solve: {warm_s:.3f} s with certification "
          f"({solver.certify_s:.3f} s of it, {solver.refine_passes} "
          f"pass(es)), {its} iterations, true_rel {solver.true_rel!r}"
          f"  [{gpu}]", flush=True)
    # the bench headline's terms (bench.py:249-274): a warm build of the
    # problem (the first build took the process's first-touch costs) and
    # the warm uncertified CG+GMG solve
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    solve_s = statistics.median(runs)
    cfg, device = cli.parse_args(MAIN_ARGS)
    t0 = time.perf_counter()
    poisson.problem(prob.space.mesh, 1, cfg, device)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    print(f"warm CG+GMG solve (uncertified): median {solve_s:.4f} s of 5 "
          f"(min {min(runs):.4f}, max {max(runs):.4f}), "
          f"{solve_s / its * 1e3:.2f} ms/iteration; warm build {assemble_s:.4f}"
          f" s; {prob.space.ndofs / (assemble_s + solve_s):.1f} dofs/s "
          f"assemble+solve  [{gpu}]", flush=True)

    # -- 3. kernel vs plain, on the main path's operators -------------------
    rows, worst = kernel_phase(prob, gpu)
    cg_f32 = rows[0]

    # -- 4. float64 golden on the card -----------------------------------------
    REGISTRY.reset()
    gold = cli.main(GOLD_ARGS)
    rel = abs(gold.norm - GOLD_NORM) / GOLD_NORM
    print(f"poisson50k float64: {gold.iterations} iterations, norm "
          f"{gold.norm!r} (golden {GOLD_NORM!r}, rel {rel:.2e})", flush=True)
    check(gold.iterations == GOLD_ITERATIONS,
          f"poisson50k took {gold.iterations} iterations, golden "
          f"{GOLD_ITERATIONS}")
    check(rel <= 1e-9, f"poisson50k norm off by rel {rel:.2e}")

    del res, prob, solver, gold, x
    torch.cuda.empty_cache()

    # -- 5. cgpoisson P2/P3 at 500k, float32: the strip kernel (K3) ----------
    strip_ops, strip_keep, k3_launches = [], {}, 0
    for order in (2, 3):
        r, n = cgpoisson_run(
            cli, CG_ARGS + ["--order", str(order), "--ndofs", "500000"],
            (order, 500000, "strong", "float32"), gpu)
        k3 = n["K3"]
        check(k3 > 0 and n["K4"] == 0 and n["K5"] == 0,
              f"P{order}: launches {n}")
        check(r.problem.solver_function.cg_kernel_engaged is False,
              f"P{order} 500k: the whole-CG kernel engaged above the gate")
        k3_launches += k3
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = r.problem.solver_function.op.dims
        strip_ops.append((f"P{order} 500k [{C},{Zp},{LW}]",
                          r.problem.solver_function.op))
        strip_keep[order] = dict(op=r.problem.solver_function.op,
                                 b=r.problem.b, x=r.x,
                                 gdofs=r.problem.solver_function.gdofs)
        del r

    # -- 6. K3 against its plain version on those operators --------------------
    strip_rows, strip_worst = strip_kernel_phase(strip_ops, gpu)
    k3_row = [r for r in strip_rows
              if r["name"].startswith("P3") and r["dtype"] == "float32"][0]
    del strip_ops
    torch.cuda.empty_cache()

    # -- 7. P3 150k: split form, then the whole-CG kernel (K4) ----------------
    args150 = CG_ARGS + ["--order", "3", "--ndofs", "150000"]
    key150 = (3, 150000, "strong", "float32")
    off, n_off = cgpoisson_run(cli, args150, key150, gpu)
    k3_off = n_off["K3"]
    check(off.problem.solver_function.cg_kernel_engaged is False and
          k3_off > 0, "P3 150k -cg_kernel off: not the split form")
    on, n_on = cgpoisson_run(cli, args150 + ["-cg_kernel", "on"], key150, gpu)
    k3_on, k4_launches = n_on["K3"], n_on["K4"]
    s_on = on.problem.solver_function
    check(s_on.cg_kernel_engaged is True and k4_launches > 0 and k3_on == 0,
          f"P3 150k -cg_kernel on: engaged {s_on.cg_kernel_engaged}, K4 "
          f"launches {k4_launches}, K3 launches {k3_on}")
    diff = float((on.x - off.x).norm() / off.x.norm())
    print(f"P3 150k: whole-CG kernel {s_on.gdofs:.4f} Gdof/s vs split form "
          f"{off.problem.solver_function.gdofs:.4f} Gdof/s; solutions off by "
          f"{diff:.3e} norm-wise (tolerance {CG_F32_X_TOL:g})  [{gpu}]",
          flush=True)
    check(diff <= CG_F32_X_TOL, f"P3 150k: K4 and split solutions off "
          f"by {diff:.3e}")
    op150 = s_on.op
    b150 = op150.to_strips(on.problem.b)
    k4_row = strip_cg_compare(op150, b150, s_on.rtol, s_on.kmax,
                              CG_F32_X_TOL, "P3 150k float32", gpu)
    # K3 on this operator too: another z extent and lane count
    C, Zc, Yp, Xp, PF, TILE, LW, Zp = op150.dims
    rows150, worst150 = strip_kernel_phase(
        [(f"P3 150k [{C},{Zp},{LW}]", op150)], gpu)
    strip_rows += rows150
    strip_worst = max(strip_worst, worst150)
    del off, on, s_on, op150, b150
    torch.cuda.empty_cache()

    # -- 8. cgpoisson P2/P3 at 500k with -use_flat 1: the flat interior (K5) --
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the flat corrections need full float32")
    flat_ops, k5_launches = [], 0
    for order in (2, 3):
        r, n = cgpoisson_run(
            cli, CG_ARGS + ["--order", str(order), "--ndofs", "500000",
                            "-use_flat", "1"],
            (order, 500000, "strong", "float32", "flat"), gpu)
        check(n["K5"] > 0 and n["K3"] == 0 and n["K4"] == 0,
              f"P{order} -use_flat 1: launches {n}")
        k5_launches += n["K5"]
        fop = r.problem.solver_function.op
        keep = strip_keep.pop(order)
        diff100 = float((r.x - keep["x"]).norm() / keep["x"].norm())
        print(f"P{order} 500k: flat form {r.problem.solver_function.gdofs:.4f}"
              f" Gdof/s vs strip form {keep['gdofs']:.4f} Gdof/s; 100-step "
              f"solutions {diff100:.3e} apart norm-wise (not held: see "
              f"CG_FLAT_NORM_TOL)  [{gpu}]", flush=True)
        same_matrix("flat", (fop.apply, fop.apply_flat, fop.to_flat,
                             fop.from_flat), keep["op"], keep["b"],
                    f"P{order} 500k", gpu)
        g = fop.geom
        flat_ops.append((f"P{order} 500k [{g.Zp},{g.CP},{g.LW}]", fop))
        del r, keep
    flat_rows, flat_worst = flat_kernel_phase(flat_ops, gpu)
    k5_row = [r for r in flat_rows
              if r["name"].startswith("P3") and r["dtype"] == "float32"][0]
    del flat_ops, strip_keep
    torch.cuda.empty_cache()

    # -- 9. float64 goldens of the matrix-free path ----------------------------
    REGISTRY.reset()
    stencil_apply.launches = 0
    g15 = cli.main(CG15K_ARGS)
    rel15 = abs(g15.norm - CG15K_NORM) / CG15K_NORM
    print(f"cgpoisson15k float64: {g15.iterations} iterations, norm "
          f"{g15.norm!r} (golden {CG15K_NORM!r}, rel {rel15:.2e}), stencil "
          f"launches {stencil_apply.launches}  [{gpu}]", flush=True)
    check(g15.iterations == 100 and rel15 <= 1e-9 and
          stencil_apply.launches > 0, "cgpoisson15k golden not held")
    p3, _ = cgpoisson_run(
        cli, ["--problem_type", "cgpoisson", "--order", "3", "--ndofs",
              "10000", "--dtype", "float64", "--device", "cuda"],
        (3, 10000, "weak", "float64"), gpu)
    s3 = p3.problem.solver_function
    b3 = s3.op.to_strips(p3.problem.b)
    strip_cg_compare(s3.op, b3, 1e-8, 400, 1e-6, "P3 9025 float64", gpu)
    # K3 on this small operator, and on one with a halo of 124 lanes: no
    # run's delta weights fit the shared memory beside its planes there,
    # so they come from global memory
    wide = wide_halo_operator(s3.op.device)
    check(not wide.apply_shape(4)[1] and not wide.apply_shape(8)[1],
          "the 40x6x6 P3 operator's delta weights fit the shared memory")
    small_ops = [(f"P3 {name} [{op.dims[0]},{op.dims[7]},{op.dims[6]}]", op)
                 for name, op in (("9025", s3.op), ("40x6x6", wide))]
    rows9k, worst9k = strip_kernel_phase(small_ops, gpu)
    strip_rows += rows9k
    strip_worst = max(strip_worst, worst9k)
    del g15, p3, s3, b3, wide, small_ops
    torch.cuda.empty_cache()

    # -- 10. elasticity: the three-component stencil kernel --------------------
    elast_launches, elast_rows, elast_worst = elasticity_phase(cli, gpu)
    bs3 = elast_rows[0]
    torch.cuda.empty_cache()

    # -- 11. brick-AMG (-pc_type amg): the brick_flat kernel -------------------
    bf_launches, bf_rows, bf_worst = amg_phase(cli, torch.device("cuda", 0),
                                               gpu)
    bf = [r for r in bf_rows if r["name"].startswith("elasticity")
          and r["dtype"] == "float32"][0]

    # -- 12. P2/P3 Poisson and -use_strip 0: the multi-kind zone kernel ------
    dz_launches, dz_cg_launches, dz_rows, dz_worst = pk_phase(cli, gpu)
    dz = [r for r in dz_rows if r["name"].startswith("P3 500k")
          and r["dtype"] == "float32"][0]

    # -- 13. P2/P3 elasticity: the blocked per-perm apply (perm_apply) -------
    t13 = time.perf_counter()
    pa_launches, pa_rows, pa_worst = elasticity_pk_phase(cli, gpu)
    pa = [r for r in pa_rows if r["name"].startswith("P2 500k")
          and r["dtype"] == "float32"][0]
    print(f"phase 13: {time.perf_counter() - t13:.1f} s; chip_smoke so far "
          f"{time.perf_counter() - t_start:.1f} s  [{gpu}]", flush=True)

    # -- 14. SA-AMG: the spoke mesh and the cube (csr_spmv, dense_gemv) ------
    t14 = time.perf_counter()
    (csr_launches, dense_launches, csr_rows, dense_rows, csr_worst,
     dense_worst) = saamg_phase(cli, gpu)
    csr = [r for r in csr_rows if r["name"] == "spoke 500k fine"
           and r["dtype"] == "float32"][0]
    dense = dense_rows[0]
    print(f"phase 14: {time.perf_counter() - t14:.1f} s; chip_smoke so far "
          f"{time.perf_counter() - t_start:.1f} s  [{gpu}]", flush=True)

    # -- 15. the spoke's matrix-free cgpoisson (matfree_action), Poisson
    #        P2/P3 and elasticity on SA-AMG --------------------------------
    t15 = time.perf_counter()
    mf_launches, mf_rows, mf_worst, csr15, dense15 = spoke_pk_phase(cli, gpu)
    mf = [r for r in mf_rows if r["name"] == "spoke P1 500k"
          and r["dtype"] == "float32"][0]
    csr_launches += csr15
    dense_launches += dense15
    print(f"phase 15: {time.perf_counter() - t15:.1f} s; chip_smoke so far "
          f"{time.perf_counter() - t_start:.1f} s  [{gpu}]", flush=True)

    # -- 16. sharded runs: --num_shards on the one card ----------------------
    t16 = time.perf_counter()
    shard_launches, shard_rows = sharded_phase(cli, gpu)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s; chip_smoke so far "
          f"{time.perf_counter() - t_start:.1f} s  [{gpu}]", flush=True)

    kernels = [
        {"name": "stencil_p1", "route": "cuda",
         "source": "tpufem_torch/csrc/stencil_p1.cu",
         "replaces": "tpufem/fem/pallas_stencil.py:72 (K1), "
                     "tpufem/fem/pallas_stencil.py:185 (K2)",
         "launches": launches, "max_abs_err": worst,
         "ms": cg_f32["ms"], "plain_ms": cg_f32["plain_ms"],
         "bound_ms": cg_f32["bound_ms"], "bound_by": cg_f32["bound_by"],
         "library_ms": cg_f32["library_ms"], "device_ms": cg_f32["device_ms"],
         "host_ms": cg_f32["host_ms"],
         "call_minus_device_ms": cg_f32["call_minus_device_ms"],
         "grids": [{k: r[k] for k in ("name", "R", "ms", "device_ms",
                                      "host_ms", "plain_ms", "library_ms",
                                      "bound_ms")}
                   for r in rows if r["dtype"] == "float32"]},
        {"name": "strip_apply", "route": "cuda",
         "source": "tpufem_torch/csrc/strip_apply.cu",
         "replaces": "tpufem/fem/strip_op.py:300",
         "launches": k3_launches, "max_abs_err": strip_worst,
         "ms": k3_row["ms"], "plain_ms": k3_row["plain_ms"],
         "bound_ms": k3_row["bound_ms"], "bound_by": k3_row["bound_by"],
         "library_ms": k3_row["library_ms"],
         "device_ms": k3_row["device_ms"],
         "host_ms": k3_row["host_ms"],
         "call_minus_device_ms": k3_row["call_minus_device_ms"],
         "operators": [{k: r[k] for k in ("name", "dtype", "ms", "device_ms",
                                          "host_ms", "plain_ms", "library_ms",
                                          "bound_ms")}
                       for r in strip_rows]},
        {"name": "strip_cg", "route": "cuda",
         "source": "tpufem_torch/csrc/strip_cg.cu",
         "replaces": "tpufem/fem/strip_op.py:434",
         "launches": k4_launches, "max_abs_err": k4_row["max_abs_err"],
         "ms": k4_row["ms"], "plain_ms": k4_row["plain_ms"],
         "bound_ms": k4_row["bound_ms"], "bound_by": k4_row["bound_by"],
         "library_ms": None,
         "barrier_floor_ms": k4_row["barrier_floor_ms"],
         "blocks": k4_row["blocks"], "bricks": k4_row["bricks"]},
        {"name": "flat_interior", "route": "cuda",
         "source": "tpufem_torch/csrc/flat_interior.cu",
         "replaces": "tpufem/fem/flat_op.py:308",
         "launches": k5_launches, "max_abs_err": flat_worst,
         "ms": k5_row["ms"], "plain_ms": k5_row["plain_ms"],
         "bound_ms": k5_row["bound_ms"], "bound_by": k5_row["bound_by"],
         "library_ms": k5_row["library_ms"],
         "device_ms": k5_row["device_ms"], "host_ms": k5_row["host_ms"],
         "call_minus_device_ms": k5_row["call_minus_device_ms"]},
        {"name": "stencil_p1_bs3", "route": "cuda",
         "source": "tpufem_torch/csrc/stencil_p1.cu",
         "replaces": "tpufem/fem/dia_op.py:462 (DiaOperator._apply_zones, "
                     "planar bs = 3: XLA in tpufem, no Pallas kernel; the "
                     "three-component form of "
                     "tpufem/fem/pallas_stencil.py:72, K1)",
         "launches": elast_launches, "max_abs_err": elast_worst,
         "ms": bs3["ms"], "plain_ms": bs3["plain_ms"],
         "bound_ms": bs3["bound_ms"], "bound_by": bs3["bound_by"],
         "library_ms": bs3["library_ms"], "device_ms": bs3["device_ms"],
         "host_ms": bs3["host_ms"],
         "call_minus_device_ms": bs3["call_minus_device_ms"],
         "grids": [{k: r[k] for k in ("name", "R", "ms", "device_ms",
                                      "host_ms", "plain_ms", "library_ms",
                                      "bound_ms")}
                   for r in elast_rows if r["dtype"] == "float32"]},
        {"name": "brick_flat", "route": "cuda",
         "source": "tpufem_torch/csrc/brick_flat.cu",
         "replaces": "tpufem/la/bramg.py:163 (flat_apply, brick-AMG's coarse "
                     "level operator: XLA in tpufem, no Pallas kernel)",
         "launches": bf_launches, "max_abs_err": bf_worst,
         "ms": bf["ms"], "plain_ms": bf["plain_ms"],
         "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
         "library_ms": bf["library_ms"], "device_ms": bf["device_ms"],
         "host_ms": bf["host_ms"],
         "call_minus_device_ms": bf["call_minus_device_ms"],
         "grids": [{k: r[k] for k in ("name", "dtype", "fields", "ms",
                                      "device_ms", "host_ms", "plain_ms",
                                      "library_ms", "bound_ms", "same_bits")}
                   for r in bf_rows]},
        {"name": "dia_zones", "route": "cuda",
         "source": "tpufem_torch/csrc/dia_zones.cu",
         "replaces": "none (XLA _apply_zones, tpufem/fem/dia_op.py:462)",
         "launches": dz_launches, "launches_use_strip0": dz_cg_launches,
         "max_abs_err": dz_worst,
         "ms": dz["ms"], "plain_ms": dz["plain_ms"],
         "bound_ms": dz["bound_ms"], "bound_by": dz["bound_by"],
         "library_ms": dz["library_ms"], "device_ms": dz["device_ms"],
         "host_ms": dz["host_ms"],
         "call_minus_device_ms": dz["call_minus_device_ms"],
         "strip_apply_ms": dz["strip_apply_ms"],
         "grids": [{k: r[k] for k in ("name", "dtype", "terms", "ms",
                                      "device_ms", "host_ms", "plain_ms",
                                      "library_ms", "bound_ms",
                                      "strip_apply_ms", "same_bits")}
                   for r in dz_rows]},
        {"name": "perm_apply", "route": "cuda",
         "source": "tpufem_torch/csrc/perm_apply.cu",
         "replaces": "none (XLA StructuredOperator.apply at bs = 3, "
                     "tpufem/fem/structured_op.py:263)",
         "launches": pa_launches, "max_abs_err": pa_worst,
         "ms": pa["ms"], "plain_ms": pa["plain_ms"],
         "bound_ms": pa["bound_ms"], "bound_by": pa["bound_by"],
         "library_ms": pa["library_ms"], "device_ms": pa["device_ms"],
         "host_ms": pa["host_ms"],
         "call_minus_device_ms": pa["call_minus_device_ms"],
         "per_perm_bound_ms": pa["per_perm_bound_ms"],
         "grids": [{k: r[k] for k in ("name", "dtype", "entries", "nnz", "ms",
                                      "device_ms", "host_ms", "plain_ms",
                                      "library_ms", "bound_ms",
                                      "per_perm_bound_ms", "err_of_bound")}
                   for r in pa_rows]},
        {"name": "csr_spmv", "route": "cuda",
         "source": "tpufem_torch/csrc/csr_spmv.cu",
         "replaces": "none (XLA ELLMatrix.matvec, tpufem/fem/assemble.py:117,"
                     " and WindowedMatrix.matvec, "
                     "tpufem/fem/window_op.py:101: SA-AMG's sparse "
                     "operators)",
         "launches": csr_launches, "max_abs_err": csr_worst,
         "ms": csr["ms"], "plain_ms": csr["plain_ms"],
         "bound_ms": csr["bound_ms"], "bound_by": csr["bound_by"],
         "library_ms": csr["library_ms"], "device_ms": csr["device_ms"],
         "host_ms": csr["host_ms"],
         "call_minus_device_ms": csr["call_minus_device_ms"],
         "matrices": [{k: r[k] for k in ("name", "dtype", "n", "ncols", "nnz",
                                         "empty_rows", "tiles",
                                         "ms", "device_ms", "host_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "share_of_bound",
                                         "empty_launch_ms", "y_pass_ms",
                                         "max_abs_err")}
                      for r in csr_rows]},
        {"name": "dense_gemv_bf16", "route": "cuda",
         "source": "tpufem_torch/csrc/dense_gemv.cu",
         "replaces": "none (XLA DenseMat.matvec in bf16, "
                     "tpufem/la/amg.py:417)",
         "launches": dense_launches, "max_abs_err": dense_worst,
         "ms": dense["ms"], "plain_ms": dense["plain_ms"],
         "bound_ms": dense["bound_ms"], "bound_by": dense["bound_by"],
         "library_ms": dense["library_ms"], "device_ms": dense["device_ms"],
         "host_ms": dense["host_ms"], "mv_f32_ms": dense["mv_f32_ms"],
         "call_minus_device_ms": dense["call_minus_device_ms"],
         "levels": dense_rows},
        {"name": "matfree_action", "route": "cuda",
         "source": "tpufem_torch/csrc/matfree_action.cu",
         "replaces": "none (XLA MatFreePoissonOp.apply, "
                     "tpufem/problems/cgpoisson.py:59: the gather, "
                     "poisson_action_from_metric, tpufem/fem/kernels.py:149,"
                     " and DofScatter.scatter_add, "
                     "tpufem/fem/assemble.py:250)",
         "launches": mf_launches, "max_abs_err": mf_worst,
         "ms": mf["ms"], "plain_ms": mf["plain_ms"],
         "bound_ms": mf["bound_ms"], "bound_by": mf["bound_by"],
         "library_ms": mf["library_ms"], "device_ms": mf["device_ms"],
         "host_ms": mf["host_ms"],
         "call_minus_device_ms": mf["call_minus_device_ms"],
         "operators": mf_rows},
    ]
    # the sharded runs' launches (phase 16, counted from zero around each
    # run) and the slab / shard-row shapes each kernel was held on there
    for k in kernels:
        k["launches_sharded"] = shard_launches.get(k["name"], 0)
        if shard_rows.get(k["name"]):
            k["sharded"] = shard_rows[k["name"]]
    print(f"device_ms: {len(REFUSED_PROFILES)} profile(s) refused for a "
          f"wrong count of kernel spans, {EVENT_TIMES[0]} device time(s) "
          f"taken by CUDA events instead", flush=True)
    check("tpufem" not in sys.modules and "jax" not in sys.modules,
          "tpufem or jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
