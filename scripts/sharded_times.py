#!/usr/bin/env python3
"""Times of the port's sharded runs (``--num_shards``) of one tree, on one
NVIDIA GPU: each case through the CLI, then the median of 3 warm solves of
the solver's own RHS (after one untimed), and for cgpoisson the Gdof/s of
those solves (iterations x dofs / seconds).

Run one process a tree, from the repository root; to compare two trees,
unpack the other (``git archive <commit> tpufem_torch``) into a
git-ignored directory and run them in turns in one call on the card
(A, B, B, A):

    python scripts/sharded_times.py [--tree DIR] [--case NAME ...]
        [--json PATH]

Cases (float32, strong scaling, 4 shards): cgpoisson-p3-150k (the
default), poisson-p1-500k, poisson-p2-500k, elasticity-p1-500k.  Each
prints its iterations, norm, the slab operator's class and mode, the
CLI's own Gdof/s (cgpoisson; the mean of 3 perturbed-RHS solves), the
warm median and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--scaling_type", "strong", "--dtype", "float32", "--num_shards",
        "4", "--device", "cuda"]
CASES = {
    "cgpoisson-p3-150k": ["--problem_type", "cgpoisson", "--order", "3",
                          "--ndofs", "150000"],
    "poisson-p1-500k": ["--problem_type", "poisson", "--ndofs", "500000",
                        "-ksp_rtol", "1e-8", "-ksp_max_it", "100"],
    "poisson-p2-500k": ["--problem_type", "poisson", "--order", "2",
                        "--ndofs", "500000", "-ksp_rtol", "1e-8",
                        "-ksp_max_it", "100"],
    "elasticity-p1-500k": ["--problem_type", "elasticity", "--ndofs",
                           "500000", "-ksp_rtol", "1e-8", "-ksp_max_it",
                           "100"],
}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--case", nargs="*", default=["cgpoisson-p3-150k"])
    p.add_argument("--json")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("sharded_times: no CUDA device", file=sys.stderr)
        return 1
    from tpufem_torch import _build, cli
    _build.load()
    gpu = gpu_line()
    out = []
    for name in args.case:
        res = cli.main(CASES[name] + BASE)
        solver = res.problem.solver_function
        sh = solver.sh
        times = []
        sh._run(sh.b_local)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            sh._run(sh.b_local)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = statistics.median(times)
        op = sh.levels[0].op
        row = dict(tree=args.tree, case=name, ndofs=res.problem.space.ndofs,
                   iterations=res.iterations, norm=res.norm,
                   slab_operator=type(op).__name__,
                   const=bool(getattr(op, "is_const", lambda: False)()),
                   cli_gdofs=solver.gdofs, warm_s=warm, warm_all_s=times,
                   gdofs=(res.iterations * res.problem.space.ndofs / warm
                          / 1e9 if solver.matfree else None), gpu=gpu)
        out.append(row)
        print("SHARDED_TIMES " + json.dumps(row), flush=True)
        del res, solver, sh, op
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "a") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
