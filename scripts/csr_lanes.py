#!/usr/bin/env python3
"""Lanes per row of the CSR product (tpufem_torch/csrc/csr_spmv.cu)
against each other, on one NVIDIA GPU.

A ``CsrMatrix`` gives its launch G lanes a row (``lanes_for``: the power
of two at or above the mean row length, 1 to 32).  G is a field of the
launch struct, so one build serves every variant.  On the matrices of
the spoke mesh's SA-AMG at ``--ndofs`` (the RCM-ordered fine operator in
float32, float64 and bf16, the assembled P and P^T), this times one
product with each G in turns (the chosen G first and last): the
kernel's device time from the profiler and the time per call from CUDA
events, each variant checked against the plain version first.  Run from
the repository root:

    python scripts/csr_lanes.py [--ndofs 500000] [--lanes 2,4,8,16,32]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ndofs", type=int, default=500000)
    p.add_argument("--lanes", default="2,4,8,16,32",
                   help="lanes a row to time, comma-separated")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("csr_lanes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from tpufem_torch import cli
    from tpufem_torch.fem.csr_spmv import csr_spmv_bound, csr_spmv_plain
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = cli.main(["--problem_type", "poisson", "--mesh_type",
                    "unstructured", "--ndofs", str(args.ndofs),
                    "--scaling_type", "strong", "-ksp_max_it", "1",
                    "-ksp_true_residual", "off", "--device", "cuda"])
    solver = res.problem.solver_function
    op, lv0 = solver.op, solver.pc.levels[0]
    mats = [("fine", op), ("fine", op.astype(torch.float64)),
            ("fine", op.astype(torch.bfloat16)), ("P", lv0.P),
            ("P^T", lv0.PT)]
    lanes = [int(v) for v in args.lanes.split(",")]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, A in mats:
        x = torch.randn(A.ncols, generator=gen, device=A.device,
                        dtype=torch.float64).to(A.out_dtype)
        yp, bnd = csr_spmv_plain(A, x), csr_spmv_bound(A, x)
        order = [A.G] + [g for g in lanes if g != A.G] + [A.G]
        for g in order:
            B = dataclasses.replace(A, G=g, _launch=None)
            y = B.matvec(x)
            torch.cuda.synchronize()
            ok = bool(((y - yp).abs() <= bnd).all())
            ms = chip_smoke.median_ms(lambda: B.matvec(x))
            dev = chip_smoke.device_ms(lambda: B.matvec(x))
            print(f"csr_lanes {name:<5} {str(A.vals.dtype)[6:]:<8} "
                  f"{A.n}x{A.ncols} {A.nnz} entries, mean "
                  f"{A.nnz / A.n:.2f} a row | G {g:>2}"
                  f"{' (chosen)' if g == A.G else ''}: device "
                  f"{chip_smoke.fmt_ms(dev)}, per call {ms:.4f} ms, within "
                  f"the bound {ok}  [{gpu}]", flush=True)
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
