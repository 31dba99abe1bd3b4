#!/usr/bin/env python3
"""Lanes per output point of the blocked per-perm apply
(tpufem_torch/csrc/perm_apply.cu) against each other, on one NVIDIA GPU.

``pack_perm`` gives each output (kind, slot) G lanes that share a point
(the fifth column of the pack's ``outputs``: 4 on the 24-entry vertex
output, 1 on the edge and face outputs).  G = 1 everywhere is the
kernel's first design, one point a thread.  G is a column of a table,
not a constant of the source, so one build serves every variant.  For
the P2 and P3 500k elasticity operators (the fine levels of
chip_smoke.py's phase 13), float32 and float64, this times one apply
with the vertex output's G set in turns (the packed G, 1, 1, the packed
G, then each other value of ``--lanes`` once): the kernel's device time
from the profiler and the time per call from CUDA events, each variant
checked against the plain version first.  Run from the repository root:

    python scripts/perm_apply_lanes.py [--lanes 1,2,4,8]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--lanes", default="1,2,4,8",
                   help="lanes of the vertex output to time, comma-separated")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("perm_apply_lanes: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.perm_apply import (perm_apply_bound,
                                             perm_apply_plain,
                                             prepare_perm_apply)
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.fem.structured_op import StructuredOperator
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.profile_solve import busy_us
    from tpufem_torch.problems.common import elasticity_bc_marker

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def per_call_ms(fn, reps=20, samples=11):
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

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        return busy_us(spans) / reps / 1e3

    wanted = [int(v) for v in args.lanes.split(",")]
    for order, dims in ((2, (24, 24, 32)), (3, (16, 16, 24))):
        mesh = BoxTetMesh(*dims)
        bc = DirichletBC.from_space(
            FunctionSpace(mesh, order, bs=3),
            mesh.locate_boundary_facets(elasticity_bc_marker)).flat_dofs()
        for dtype in (torch.float32, torch.float64):
            op = StructuredOperator.build(mesh, order, "elasticity",
                                          bc_dofs=bc, dtype=dtype,
                                          device=dev, planar=True)
            pack = op.pack
            heavy = int(pack.outputs[:, 3].argmax())
            packed = int(pack.outputs[heavy, 4])
            x = torch.randn(3 * pack.ns, device=dev, dtype=dtype,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(order))
            yp = perm_apply_plain(x, pack)
            bound = perm_apply_bound(x, pack)
            order_of_runs = [packed, 1, 1, packed] + [
                g for g in wanted if g not in (1, packed)]
            for g in order_of_runs:
                outputs = pack.outputs.copy()
                outputs[heavy, 4] = g
                variant = dataclasses.replace(
                    pack, outputs=outputs,
                    dev_outputs=torch.from_numpy(outputs).to(dev))
                launch = prepare_perm_apply(variant)
                ok = bool(((launch(x) - yp).abs() <= bound).all())
                print(f"P{order} 500k {str(dtype)[6:]:<7} vertex output "
                      f"lanes {g} ({'packed' if g == packed else 'variant'}):"
                      f" {variant.max_blocks} x {len(outputs)} blocks, "
                      f"within perm_apply_bound {ok}, device "
                      f"{device_ms(lambda: launch(x)):.4f} ms, per call "
                      f"{per_call_ms(lambda: launch(x)):.4f} ms  [{gpu}]",
                      flush=True)
                if not ok:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
