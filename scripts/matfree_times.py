#!/usr/bin/env python3
"""Times of the matrix-free Poisson kernel (matfree_action) of one tree of
the port on the spoke mesh's operators, on one NVIDIA GPU, and the
matrix-free cgpoisson runs that launch it.

Run one process a tree, from the repository root; to compare two trees,
unpack the other (``git archive <commit> tpufem_torch chip_smoke.py``)
into a git-ignored directory and run them in turns in one call on the
card (A, B, B, A):

    python scripts/matfree_times.py [--tree DIR] [--json PATH]
        [--no-library] [--cli] [--no-kernel] [--quick] [--sizes O:N,...]
        [--cells N:B,...] [--sass]

The operators: the spoke mesh (strong scaling) at P1 500k (2,644,284
cells), P2 and P3 150k (745,612 cells), float32 and float64, built as
the cgpoisson path builds them (``--sizes`` others, for the CLI runs
too; ``--cells`` other cluster sizes). Each is held to its plain version
(within matfree_action_bound, the same bits on two launches) and timed:
per call (CUDA events, median of 11 means of 20 back-to-back calls),
device time per call by chip_smoke.device_ms (an L2 flush before each
call, the kernel's own profiler spans counted: both launches, then each
alone), the wrapper's host cost per queued call, the bound
(chip_smoke.matfree_work), the cluster plan's halo share and largest
cluster, and ``torch.sparse.mm`` of the assembled CSR of the same
operator (float32; ``--no-library`` skips it). ``--cli`` also runs
``python -m tpufem_torch --problem_type cgpoisson --mesh_type
unstructured`` at those sizes, float32, and prints their Gdof/s,
seconds per solve and setup stages (mesh, operator, RHS: the CLI's ZZZ
timers); ``--no-kernel`` runs only those, which any tree of the port can
(the kernel rows need the cluster design); ``--quick`` times float32
only. ``--sass`` prints each matfree kernel's SASS instructions by
opcode (cuobjdump) and ptxas's lines. The methods are this repository's
chip_smoke.py's, whichever tree is timed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((1, 500000), (2, 150000), (3, 150000))


def _smoke():
    """This repository's chip_smoke.py, whichever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sm_clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _ptxas(log: str) -> list:
    """(kernel, its ptxas 'Used ...' line) for the matfree_action entry
    functions."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "Used" in line and "matfree_action" in name:
            out.append((name, line.split(":", 1)[-1].strip()))
            name = None
    return out


def operators(dtypes, library: bool, dev, sizes=SIZES):
    """(name, operator, torch CSR of it or None) on the spoke mesh, at
    ``sizes`` ((order, --ndofs), strong scaling); the CSR (float32) where
    ``library``."""
    import numpy as np
    import torch
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.matfree_op import MatFreePoissonOp
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.spoke import create_spoke_mesh
    from tpufem_torch.problems.common import poisson_bc_marker
    out, meshes = [], {}
    for order, nd in sizes:
        if nd not in meshes:
            meshes[nd] = create_spoke_mesh(nd, True, 1, 1, verbose=False)
        mesh = meshes[nd]
        space = FunctionSpace(mesh, order)
        bc = DirichletBC.from_space(
            space, mesh.locate_boundary_facets(poisson_bc_marker))
        L = None
        if library:
            t0 = time.perf_counter()
            ip, ix, data = assemble_csr_np(space, bc, "poisson")
            print(f"spoke P{order} {nd}: CSR of {data.shape[0]} entries "
                  f"assembled in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            L = torch.sparse_csr_tensor(
                torch.from_numpy(ip.astype(np.int64)),
                torch.from_numpy(ix.astype(np.int64)),
                torch.from_numpy(data.astype(np.float32)),
                size=(space.ndofs, space.ndofs)).to(dev)
        for dt in dtypes:
            op = MatFreePoissonOp.build(space, bc, dt, dev)
            out.append((f"spoke P{order} {nd // 1000}k", op,
                        L if dt == torch.float32 else None))
    return out


def kernel_rows(sm, ops, tag, gpu):
    import torch
    from tpufem_torch.fem.matfree_op import (matfree_action,
                                             matfree_action_bound,
                                             matfree_apply_plain,
                                             matfree_launches)
    parts = (("clusters", "matfree_action_clusters"),
             ("halo", "matfree_action_halo"))
    rows, ok = [], True
    for name, op, L in ops:
        dt = str(op.dtype).split(".")[1]
        gen = torch.Generator(device=op.device).manual_seed(15)
        x = torch.randn(op.ndofs, generator=gen, device=op.device,
                        dtype=torch.float64).to(op.dtype)
        before = matfree_action.launches
        y = op.apply(x)
        same = bool(torch.equal(op.apply(x), y))
        yp = matfree_apply_plain(op, x)
        err = (y - yp).abs()
        held = bool(torch.isfinite(y).all()
                    and (err <= matfree_action_bound(op, x)).all())
        ok = ok and held and same and matfree_action.launches == before + 2
        nbytes, flops, plan_bytes = sm.matfree_work(op)
        b_ms, b_by = sm.bound_ms(nbytes, flops)
        ms = sm.median_ms(lambda: op.apply(x))
        host = sm.host_ms(lambda: op.apply(x))
        launches = matfree_launches(op)
        dev, note = sm.device_ms(lambda: op.apply(x), "matfree_action", b_ms,
                                 f"matfree_action {name} {dt}",
                                 launches=launches)
        part_ms = {label: sm.device_ms(lambda: op.apply(x), kname, 0.0,
                                       f"{label} {name} {dt}")[0]
                   for label, kname in parts[:launches]}
        plan = op.cplan
        lib_ms = None
        if L is not None:
            lib_ms, _ = sm.library_ms(L, x, yp)
        row = dict(tree=tag, name=name, dtype=dt, order=op.order,
                   cells=op.ncells, ndofs=op.ndofs,
                   max_abs_err=float(err.max()), within_bound=held,
                   same_bits=same, ms=ms, device_ms=dev, device_note=note,
                   launch_ms=part_ms, launches=launches,
                   halo_share=plan.halo_share, max_locals=plan.max_locals,
                   host_ms=host, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes,
                   plan_bytes=plan_bytes,
                   flops=flops, library_ms=lib_ms,
                   share_of_bound=None if dev is None else b_ms / dev)
        rows.append(row)
        share = "n/a" if dev is None else f"{100 * b_ms / dev:.0f}%"
        print(f"[{tag}] matfree_action {name} {dt}: {op.ncells} cells, "
              f"{op.ndofs} dofs | device {sm.fmt_dev(dev, note)} ("
              + ", ".join(f"{k} {sm.fmt_ms(v)}" for k, v in part_ms.items())
              + f"; halo share {plan.halo_share:.3f}, largest cluster "
              f"{plan.max_locals} dofs"
              + f"), per call "
              f"{ms:.4f} ms, host cost {host:.4f} ms | bound {b_ms:.4f} ms "
              f"({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP): "
              f"{share} of it | torch.sparse.mm {sm.fmt_ms(lib_ms)} | within "
              f"bound {held}, same bits {same}  [{gpu}]", flush=True)
    return rows, ok


def _compile_alone(root) -> str:
    """nvcc's output (ptxas's lines) for the tree's matfree_action.cu
    compiled alone."""
    from tpufem_torch import _build
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
             os.path.join(tmp, "m.o"),
             os.path.join(root, "tpufem_torch", "csrc", "matfree_action.cu")],
            capture_output=True, text=True)
    return proc.stdout + proc.stderr


def sass_rows(kern, tag, gpu):
    """Instructions in the SASS of each matfree_action kernel of the
    built library (cuobjdump -sass)."""
    from tpufem_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(kern.path)],
                         capture_output=True, text=True).stdout
    counts, ops, name = {}, {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if m:
                op = ops.setdefault(name, {})
                key = m.group(1).split(".")[0]
                op[key] = op.get(key, 0) + 1
    rows = []
    for name, k in counts.items():
        if "matfree" in name:
            rows.append(dict(kernel=name, sass_instructions=k,
                             opcodes=ops.get(name, {})))
            top = sorted(ops.get(name, {}).items(), key=lambda t: -t[1])[:12]
            print(f"[{tag}] SASS {name}: {k} instructions ({16 * k} bytes); "
                  + ", ".join(f"{o} {c}" for o, c in top) + f"  [{gpu}]",
                  flush=True)
    return rows


def cli_rows(tag, gpu, sizes=SIZES):
    """The cgpoisson CLI runs on the spoke at ``sizes``, f32: Gdof/s, s
    per solve and the setup stages (the CLI's ZZZ timers: mesh,
    operator, RHS)."""
    import torch
    from tpufem_torch import cli
    from tpufem_torch.fem.matfree_op import matfree_action
    from tpufem_torch.timing import REGISTRY
    out = []
    for order, nd in sizes:
        matfree_action.launches = 0
        REGISTRY.reset()
        t0 = time.perf_counter()
        res = cli.main(["--problem_type", "cgpoisson", "--mesh_type",
                        "unstructured", "--order", str(order), "--ndofs",
                        str(nd), "--scaling_type", "strong", "--dtype",
                        "float32", "--device", "cuda"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        s = res.problem.solver_function
        stages = {k: REGISTRY.get(f"ZZZ {v}") for k, v in (
            ("mesh", "Create Mesh"), ("operator", "Assemble matrix"),
            ("rhs", "Assemble vector"))}
        out.append(dict(tree=tag, order=order, ndofs=res.problem.space.ndofs,
                        iterations=res.iterations, norm=res.norm, rel=s.rel,
                        gdofs=s.gdofs, solve_s=s.solve_s,
                        launches=matfree_action.launches, run_s=run_s,
                        **{f"{k}_s": v for k, v in stages.items()}))
        print(f"[{tag}] cgpoisson spoke P{order} {nd}: {res.iterations} "
              f"iterations, norm {res.norm!r}, rel {s.rel!r}; {s.gdofs:.4f} "
              f"Gdof/s, {s.solve_s:.6f} s per solve, "
              f"{s.solve_s / res.iterations * 1e3:.4f} ms a step; "
              f"matfree_action {matfree_action.launches}; setup: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
              + f", whole CLI run {run_s:.3f} s  [{gpu}]", flush=True)
        del res
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=".",
                   help="root of the tree whose tpufem_torch to time")
    p.add_argument("--json", metavar="PATH", help="write the rows to PATH")
    p.add_argument("--no-library", action="store_true",
                   help="no torch.sparse.mm")
    p.add_argument("--cli", action="store_true",
                   help="also the cgpoisson CLI runs")
    p.add_argument("--quick", action="store_true", help="float32 only")
    p.add_argument("--sass", action="store_true",
                   help="instructions in each matfree kernel's SASS")
    p.add_argument("--no-kernel", action="store_true",
                   help="no kernel rows: the CLI runs alone (with --cli)")
    p.add_argument("--sizes", default="1:500000,2:150000,3:150000",
                   help="order:--ndofs of each operator and CLI run")
    p.add_argument("--cells", metavar="N:B,...",
                   help="cells a cluster for a cell of N dofs, in place of "
                        "fem.assemble.CLUSTER_CELLS")
    args = p.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("matfree_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tpufem_torch
    if not tpufem_torch.__file__.startswith(root):
        print(f"matfree_times: imported {tpufem_torch.__file__}, not the "
              f"tree {root}", file=sys.stderr)
        return 1
    from tpufem_torch import _build
    tag = os.path.relpath(root, ROOT)
    sm = _smoke()
    gpu = sm.gpu_line()
    kern = _build.load()
    print(f"[{tag}] kernels built in {kern.build_seconds:.1f} s  [{gpu}]",
          flush=True)
    for name, used in _ptxas(kern.log):
        print(f"[{tag}] ptxas {name}: {used}", flush=True)
    extra = []
    if args.sass:
        extra = sass_rows(kern, tag, gpu)
        if not kern.log:  # built by an earlier process: compile it alone
            for name, used in _ptxas(_compile_alone(root)):
                print(f"[{tag}] ptxas {name}: {used}", flush=True)
                extra.append(dict(kernel=name, ptxas=used))
    if args.cells:
        from tpufem_torch.fem import assemble
        assemble.CLUSTER_CELLS.update(
            {int(k): int(v) for k, v in (t.split(":")
                                         for t in args.cells.split(","))})
        print(f"[{tag}] cells a cluster by dofs a cell: "
              f"{assemble.CLUSTER_CELLS}", flush=True)
    dev = torch.device("cuda", 0)
    clocks_before = sm_clocks()
    dtypes = ([torch.float32] if args.quick
              else [torch.float32, torch.float64])
    sizes = tuple(tuple(int(v) for v in t.split(":"))
                  for t in args.sizes.split(","))
    rows, ok = [], True
    if not args.no_kernel:
        ops = operators(dtypes, not args.no_library, dev, sizes)
        rows, ok = kernel_rows(sm, ops, tag, gpu)
        del ops
        torch.cuda.empty_cache()
    runs = cli_rows(tag, gpu, sizes) if args.cli else []
    clocks_after = sm_clocks()
    print(f"[{tag}] clocks before {clocks_before}, after {clocks_after}  "
          f"[{gpu}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(tree=tag, gpu=gpu, rows=rows, cli=runs,
                           extra=extra,
                           clocks=[clocks_before, clocks_after],
                           refused_profiles=len(sm.REFUSED_PROFILES),
                           event_times=sm.EVENT_TIMES[0]), f, indent=1)
    print(json.dumps(dict(tree=tag, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
