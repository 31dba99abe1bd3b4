#!/usr/bin/env python3
"""Where a step of the whole-CG kernel (tpufem_torch/csrc/strip_cg.cu)
spends its time, on one NVIDIA GPU.

Builds the port's kernels with ``-DTPUFEM_CG_PHASES``, so that thread 0
of every block counts the SM cycles of each phase of a step (staging the
brick's sources, the apply, the block sum, the first grid barrier, the
first grid total, the update with its block sum, the second barrier, the
second total) and prints them at the end of the solve; then runs one
solve of cgpoisson P3 (default 150000 dofs, strong scaling, float32, 100
steps) and prints, per phase, the median and the largest count over the
blocks whose brick has no plane with delta rows (the z-boundary planes)
and over the others.  A block waits at a barrier for the slowest one, so
the step is as long as the largest apply.  Run from the repository root:

    python scripts/strip_cg_phases.py [--ndofs N] [--order P]
"""

import argparse
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("stage", "apply", "sum1", "sync1", "total1", "update", "sync2",
          "total2")
CHILD = """
import torch
from tpufem_torch import _build, cli
from tpufem_torch.problems import cgpoisson
_build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DTPUFEM_CG_PHASES",)
cgpoisson.TIMING_PASSES = cgpoisson.TIMING_REPS = 1
res = cli.main(["--problem_type", "cgpoisson", "--order", "{order}",
                "--ndofs", "{ndofs}", "--scaling_type", "strong", "--dtype",
                "float32", "--device", "cuda", "-cg_kernel", "on"])
torch.cuda.synchronize()
s = res.problem.solver_function
assert s.cg_kernel_engaged
print("PHASES_RUN", res.iterations, s.op.dims, s.op.cg_bricks().shape[0])
print("PHASES_DELTA_PLANES", *sorted({{e[1] for _, kd in s.op.kplan
                                      for e in kd}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ndofs", type=int, default=150000)
    ap.add_argument("--order", type=int, default=3)
    args = ap.parse_args()
    # a child process: the kernel's printf lines come on its stdout
    out = subprocess.run(
        [sys.executable, "-c",
         CHILD.format(order=args.order, ndofs=args.ndofs)],
        capture_output=True, text=True)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        return out.returncode
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows, delta_planes = [], set()
    for line in out.stdout.splitlines():
        m = re.match(r"strip_cg block (\d+) z0 (\d+) nz (\d+): (.*) cycles "
                     r"per step, (\d+) steps", line)
        if m:
            vals = dict(zip(m.group(4).split()[0::2],
                            map(int, m.group(4).split()[1::2])))
            rows.append((int(m.group(2)), int(m.group(3)), vals,
                         int(m.group(5)), int(m.group(1))))
        elif line.startswith("PHASES_DELTA_PLANES"):
            delta_planes = set(map(int, line.split()[1:]))
        elif line.startswith("PHASES_RUN"):
            print(line)
    if not rows:
        sys.stderr.write("no phase lines: did the whole-CG kernel run?\n")
        return 1
    # every launch prints: keep the last one (a warm solve)
    rows = rows[-(1 + max(r[4] for r in rows)):]
    steps = rows[-1][3]
    groups = {"interior": [], "z-boundary": []}
    for z0, nz, vals, *_ in rows:
        edge = bool(delta_planes & set(range(z0, z0 + nz)))
        groups["z-boundary" if edge else "interior"].append(vals)
    print(f"gpu: {gpu}; {len(rows)} block reports of {steps} steps each; "
          f"SM cycles per step, median / max over blocks")
    for name, vs in groups.items():
        if not vs:
            continue
        cells = [f"{ph} {statistics.median(v[ph] for v in vs):.0f} / "
                 f"{max(v[ph] for v in vs)}" for ph in PHASES]
        total = statistics.median(sum(v.values()) for v in vs)
        print(f"{name:<11} ({len(vs)} blocks): " + ", ".join(cells)
              + f"; a block's sum, median {total:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
