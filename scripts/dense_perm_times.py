#!/usr/bin/env python3
"""Times of the bf16 dense level product (dense_gemv_bf16) and the blocked
P2/P3 elasticity apply (perm_apply) of one tree of the port, and the warm
solve of elasticity P1 500k ``-pc_type amg -amg_brick off`` that the dense
kernel serves, on one NVIDIA GPU.

Run one process a tree, from the repository root; to compare two trees,
unpack the other (``git archive <commit>``) into a git-ignored directory
and run them in turns in one call on the card (A, B, B, A):

    python scripts/dense_perm_times.py [--tree DIR] [--skip-solve]

For each kernel: the time per call (CUDA events, median of 11 means of 20
back-to-back calls), the device time per call (the profiler's spans of
the kernel itself over 20 calls, each after a 256 MB read that evicts
the L2, counted: a profile with another count than the launches is
reported and taken again), within the plain version's bound and the same
bits twice.  Dense levels: random bf16 matrices of the spoke 500k level's
9,512 rows and elasticity P1's 18,840, beside ``torch.matmul`` of the
bf16 operands and the byte bound.  perm_apply: the P2 (24x24x32) and P3
(16x16x24) 500k fine operators, float32 and float64.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import time

FLUSH_BYTES = 256 * 2 ** 20
HBM_BYTES_PER_S = 3.35e12
ELAST_AMG = ["--problem_type", "elasticity", "--ndofs", "500000",
             "--scaling_type", "strong", "--dtype", "float32", "-ksp_rtol",
             "1e-8", "-pc_type", "amg", "-amg_brick", "off", "--device",
             "cuda"]


def per_call_ms(fn, reps=20, samples=11):
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


def device_ms(fn, kernel, launches, reps=20, tries=3):
    """(device ms per call, {kernel name: ms per call}) from the spans of
    ``kernel`` (a part of the names) after a warm-up window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
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
        own = [(n, s, e) for n, s, e in spans if kernel in n]
        if len(own) == reps * launches:
            break
        print(f"  profile refused: {len(own)} spans of {kernel!r}, expected "
              f"{reps * launches}", flush=True)
    else:
        return None, {}
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(own, key=lambda t: t[1]):
        if e > end:
            busy += e - max(s, end)
            end = e
    split = {}
    for n, s, e in own:
        key = re.search(r"\w*" + kernel + r"\w*", n).group(0)
        split[key] = round(split.get(key, 0.0) + (e - s) / reps / 1e3, 4)
    return busy / reps / 1e3, split


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=".",
                   help="root of the tree whose tpufem_torch to time")
    p.add_argument("--skip-solve", action="store_true",
                   help="time the kernels only")
    args = p.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("dense_perm_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tpufem_torch
    if not tpufem_torch.__file__.startswith(root):
        print(f"dense_perm_times: imported {tpufem_torch.__file__}, not the "
              f"tree {root}", file=sys.stderr)
        return 1
    from tpufem_torch import _build
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    tag = os.path.relpath(root)
    kern = _build.load()
    print(f"[{tag}] kernels built in {kern.build_seconds:.1f} s  [{gpu}]",
          flush=True)
    dev = torch.device("cuda", 0)

    from tpufem_torch.fem.dense_gemv import (DenseMat, dense_gemv_bf16_plain,
                                             dense_gemv_bound)
    for n in (9512, 18840):
        gen = torch.Generator(device=dev).manual_seed(n)
        ld = -(-n // 8) * 8
        M = torch.zeros(n, ld, dtype=torch.bfloat16, device=dev)
        M[:, :n] = (torch.randn(n, n, generator=gen, device=dev)
                    / n ** 0.5).to(torch.bfloat16)
        D = DenseMat(M, n)
        x = torch.randn(n, generator=gen, device=dev)
        y = D.matvec(x)
        same = torch.equal(D.matvec(x), y)
        ok = bool(((y - dense_gemv_bf16_plain(D, x)).abs()
                   <= dense_gemv_bound(D, x)).all())
        launches = 2 if "dense_gemv_bf16_combine" in open(
            os.path.join(root, "tpufem_torch/csrc/dense_gemv.cu")).read() \
            else 1
        d, split = device_ms(lambda: D.matvec(x), "dense_gemv_bf16",
                             launches)
        ms = per_call_ms(lambda: D.matvec(x))
        Mb, xb = M[:, :n], x.to(torch.bfloat16)
        lib = per_call_ms(lambda: torch.matmul(Mb, xb))
        bound = (2 * n * ld + 8 * n) / HBM_BYTES_PER_S * 1e3
        print(f"[{tag}] dense_gemv_bf16 {n} rows: per call {ms:.4f} ms, "
              f"device {d if d is None else round(d, 4)} ms {split}, "
              f"torch.matmul(bf16, bf16) {lib:.4f} ms, bound {bound:.4f} ms "
              f"(bytes); within dense_gemv_bound {ok}, the same bits twice "
              f"{same}  [{gpu}]", flush=True)
        del M, D, Mb
        torch.cuda.empty_cache()

    import dataclasses
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.perm_apply import (perm_apply_bound,
                                             perm_apply_plain,
                                             prepare_perm_apply)
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.fem.structured_op import StructuredOperator
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import elasticity_bc_marker
    two = "perm_apply_sum_kernel" in open(
        os.path.join(root, "tpufem_torch/csrc/perm_apply.cu")).read()
    for order, dims in ((2, (24, 24, 32)), (3, (16, 16, 24))):
        mesh = BoxTetMesh(*dims)
        bc = DirichletBC.from_space(
            FunctionSpace(mesh, order, bs=3),
            mesh.locate_boundary_facets(elasticity_bc_marker)).flat_dofs()
        op = StructuredOperator.build(mesh, order, "elasticity", bc_dofs=bc,
                                      dtype=torch.float32, device=dev,
                                      planar=True)
        for dtype in (torch.float32, torch.float64):
            pack = dataclasses.replace(op.pack, Ap=op.pack.Ap.to(dtype),
                                       weights=op.pack.weights.to(dtype))
            launch = prepare_perm_apply(pack)
            x = torch.randn(3 * pack.ns, device=dev, dtype=dtype)
            y = launch(x)
            same = torch.equal(launch(x), y)
            ok = bool(((y - perm_apply_plain(x, pack)).abs()
                       <= perm_apply_bound(x, pack)).all())
            d, split = device_ms(lambda: launch(x), "perm_apply_",
                                 2 if two else 1)
            ms = per_call_ms(lambda: launch(x))
            print(f"[{tag}] perm_apply P{order} 500k {str(dtype)[6:]}: per "
                  f"call {ms:.4f} ms, device "
                  f"{d if d is None else round(d, 4)} ms {split}; within "
                  f"perm_apply_bound {ok}, the same bits twice {same}  "
                  f"[{gpu}]", flush=True)
        del op
        torch.cuda.empty_cache()

    if not args.skip_solve:
        from tpufem_torch import cli
        from tpufem_torch.fem.dense_gemv import dense_gemv_bf16
        res = cli.main(ELAST_AMG)
        solver, prob = res.problem.solver_function, res.problem
        runs = []
        dense_gemv_bf16.launches = 0
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, its, _ = solver.run(prob.u, prob.b)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        med = statistics.median(runs)
        print(f"[{tag}] elasticity P1 500k -amg_brick off f32: "
              f"{res.iterations} iterations, levels {solver.pc.level_sizes},"
              f" warm solve (uncertified) median {med:.4f} s of 5 (min "
              f"{min(runs):.4f}, max {max(runs):.4f}), "
              f"{med / its * 1e3:.3f} ms/iteration, dense_gemv_bf16 "
              f"{dense_gemv_bf16.launches / (5 * its):.2f} an iteration  "
              f"[{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
