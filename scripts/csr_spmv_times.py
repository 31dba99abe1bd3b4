#!/usr/bin/env python3
"""Times of the CSR product kernel (csr_spmv) of one tree of the port on
SA-AMG's own matrices, on one NVIDIA GPU, and the two SA-AMG rows that
run it.

Run one process a tree, from the repository root; to compare two trees,
unpack the other (``git archive <commit> tpufem_torch chip_smoke.py``)
into a git-ignored directory and run them in turns in one call on the
card (A, B, B, A):

    python scripts/csr_spmv_times.py [--tree DIR] [--json PATH]
                                     [--save DIR | --load DIR]
                                     [--check] [--no-library] [--warm]

The rows, f32, rtol 1e-8, certified, through the CLI: tpufem's
``poisson_spoke_500k`` (the spoke mesh, 120 iterations at the cap) and
the cube's Poisson P1 500k ``-pc_type amg -amg_brick off`` (22
iterations, tpufem's f32 CPU run), each with its warm solve (median,
min and max of 5); and the spoke 150k's level 1 as SA-AMG keeps it
sparse under ``-amg_dense_level_limit 1000``.  The matrices: the spoke
500k fine operator (f32, f64, bf16), its P and P^T, its level-1 P and
P^T, the cube's factored P0 (it has empty rows: the Dirichlet rows) and
P0^T, the cube's level-1 P and P^T, the sparse coarse level.  Each is
held to its plain version (within csr_spmv_bound, the same bits on two
launches) and timed: per call (CUDA events, median of 11 means of 20
back-to-back calls), device time per call by chip_smoke.device_ms (an
L2 flush before each call, the kernel's own profiler spans counted), the
wrapper's host cost per queued call, the byte bound, ``torch.sparse.mm``
of the same matrix (f32, f64), and the floor of the method at the
matrix's n: an empty launch after the same flush (``torch.cuda._sleep(0)``)
and an elementwise pass over y after it.  The methods are this
repository's chip_smoke.py's, whichever tree is timed.

``--save DIR`` keeps the matrices (float32 CSR, npz) for ``--load DIR``,
which times them with no rows.  ``--check``: only the plain version's
test of every matrix, no time.  ``--warm``: also the device time with no
L2 flush (the inputs and the kernel's code in L2).  The card's SM and
memory clocks and power draw are printed before and after.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE = "poisson_p1_amg_brick_off"


def _smoke():
    """This repository's chip_smoke.py, whichever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sm_clocks() -> str:
    """The card's SM and memory clocks and power draw, as nvidia-smi
    reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _ptxas(log: str) -> list:
    """(kernel, its ptxas 'Used ...' line) for the csr_spmv entry
    functions."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "Used" in line and "csr_spmv" in name:
            out.append((name, line.split(":", 1)[-1].strip()))
            name = None
    return out


def run_row(sm, cli, key, argv, ref_it, tag, gpu):
    """One SA-AMG row: the first (certified) solve and 5 warm ones."""
    import torch
    res = cli.main(argv)
    torch.cuda.synchronize()
    sm.check(res.iterations == ref_it if ref_it == 120
             else abs(res.iterations - ref_it) <= 1,
             f"{key}: {res.iterations} iterations, expected {ref_it}")
    sm.check(res.true_rel is not None and res.true_rel <= 1e-8
             and res.refine_passes <= 3,
             f"{key}: true_rel {res.true_rel}, {res.refine_passes} passes")
    prob, solver = res.problem, res.problem.solver_function
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, its, _ = solver.run(prob.u, prob.b)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    st = dict(tree=tag, row=key, iterations=res.iterations,
              true_rel=res.true_rel, passes=res.refine_passes,
              levels=solver.pc.level_sizes,
              solve_s=statistics.median(runs), solve_min_s=min(runs),
              solve_max_s=max(runs), runs=runs)
    print(f"[{tag}] {key}: levels {st['levels']}, {res.iterations} "
          f"iterations, {res.refine_passes} pass(es), true_rel "
          f"{res.true_rel:.3e}; warm solve median {st['solve_s']:.4f} s (min "
          f"{min(runs):.4f}, max {max(runs):.4f}), "
          f"{st['solve_s'] / its * 1e3:.3f} ms an iteration  [{gpu}]",
          flush=True)
    return st, res


def row_matrices(sm, tag, gpu):
    """The rows, then the path's matrices as (name, CsrMatrix)."""
    import torch
    from tpufem_torch import cli
    from tpufem_torch.config import SolverOptions
    from tpufem_torch.la.amg import SAAMG
    stats, mats = [], []
    res = cli.main(sm.SPOKE_ARGS + ["--ndofs", "150000"])
    solver = res.problem.solver_function
    sparse = SAAMG.setup(solver.csr, 1,
                         SolverOptions(amg_dense_level_limit=1000),
                         solver.device, dtype=torch.float32,
                         bc_mask=solver.bc_mask)
    mats.append(("spoke 150k level 1 (sparse)", sparse.levels[1].A))
    del res, solver, sparse
    st, res = run_row(sm, cli, "poisson_spoke_500k",
                      sm.SPOKE_ARGS + ["--ndofs", "500000"], 120, tag, gpu)
    stats.append(st)
    solver = res.problem.solver_function
    lv = solver.pc.levels
    mats += [("spoke 500k fine", solver.op), ("spoke 500k P", lv[0].P),
             ("spoke 500k P^T", lv[0].PT), ("spoke 500k level-1 P", lv[1].P),
             ("spoke 500k level-1 P^T", lv[1].PT)]
    del res, solver, lv
    opts, _, _, ref_it = sm.SAAMG_REF[CUBE][:4]
    st, res = run_row(sm, cli, CUBE, sm.SAAMG_BASE + opts, ref_it, tag, gpu)
    stats.append(st)
    lv = res.problem.solver_function.pc.levels
    mats += [("cube P1 500k P0", lv[0].P0), ("cube P1 500k P0^T", lv[0].P0T),
             ("cube P1 500k level-1 P", lv[1].P),
             ("cube P1 500k level-1 P^T", lv[1].PT)]
    del res, lv
    torch.cuda.empty_cache()
    return stats, mats


def save(mats, where):
    import numpy as np
    os.makedirs(where, exist_ok=True)
    for i, (name, A) in enumerate(mats):
        np.savez(os.path.join(where, f"{i:02d}.npz"), name=name,
                 indptr=A.indptr.cpu().numpy(),
                 indices=A.indices.cpu().numpy(),
                 data=A.vals.float().cpu().numpy(), ncols=A.ncols)


def load(where, dev):
    import numpy as np
    import torch
    from tpufem_torch.fem.csr_spmv import CsrMatrix
    out = []
    for f in sorted(os.listdir(where)):
        z = np.load(os.path.join(where, f))
        out.append((str(z["name"]), CsrMatrix.from_csr(
            z["indptr"], z["indices"], z["data"], torch.float32, dev,
            ncols=int(z["ncols"]))))
    return out


def with_dtypes(mats):
    """The fine operator in f32, f64 and bf16 (as the path rounds it);
    the rest f32."""
    import torch
    out = []
    for name, A in mats:
        out.append((name, A))
        if name.endswith("fine"):
            out += [(name, A.astype(torch.float64)),
                    (name, A.astype(torch.bfloat16))]
    return out


def kernel_rows(sm, mats, tag, gpu, check_only, library, args_warm=False):
    import torch
    from tpufem_torch.fem.csr_spmv import (csr_spmv, csr_spmv_bound,
                                           csr_spmv_plain)
    rows, ok = [], True
    empty_ms = None
    if not check_only:
        empty_ms, _ = sm.device_ms(lambda: torch.cuda._sleep(0),
                                   "spin_kernel", 0.0, "empty launch")
        print(f"[{tag}] an empty launch after the flush: device "
              f"{sm.fmt_ms(empty_ms)}  [{gpu}]", flush=True)
    for name, A in mats:
        dt = str(A.vals.dtype).split(".")[1]
        gen = torch.Generator(device=A.device).manual_seed(14)
        x = torch.randn(A.ncols, generator=gen, device=A.device,
                        dtype=torch.float64).to(A.out_dtype)
        before = csr_spmv.launches
        y = A.matvec(x)
        same = bool(torch.equal(A.matvec(x), y))
        yp = csr_spmv_plain(A, x)
        err = (y - yp).abs()
        held = bool(torch.isfinite(y).all()
                    and (err <= csr_spmv_bound(A, x)).all())
        ok = ok and held and same and csr_spmv.launches == before + 2
        nempty = int((A.indptr[1:] == A.indptr[:-1]).sum())
        row = dict(tree=tag, name=name, dtype=dt, n=A.n, ncols=A.ncols,
                   nnz=A.nnz, empty_rows=nempty, max_abs_err=float(err.max()),
                   within_bound=held, same_bits=same)
        if check_only:
            rows.append(row)
            print(f"[{tag}] csr_spmv {name} {dt}: {A.n}x{A.ncols}, {A.nnz} "
                  f"entries, {nempty} empty rows | within csr_spmv_bound "
                  f"{held}, the same bits twice {same}, max |kernel - plain| "
                  f"{row['max_abs_err']:.3e}  [{gpu}]", flush=True)
            continue
        nbytes, flops = sm.csr_work(A)
        b_ms, b_by = sm.bound_ms(nbytes, flops)
        ms = sm.median_ms(lambda: A.matvec(x))
        host = sm.host_ms(lambda: A.matvec(x))
        dev, note = sm.device_ms(lambda: A.matvec(x), "csr_spmv_kernel",
                                 b_ms, f"csr_spmv {name} {dt}")
        warm_ms = None
        if args_warm:  # the same count with no flush: inputs and code in L2
            flush_bytes, sm.L2_FLUSH_BYTES = sm.L2_FLUSH_BYTES, 4096
            warm_ms, _ = sm.device_ms(lambda: A.matvec(x), "csr_spmv_kernel",
                                      0.0, f"warm {name} {dt}")
            sm.L2_FLUSH_BYTES = flush_bytes
            print(f"[{tag}] warm {name} {dt}: {sm.fmt_ms(warm_ms)}",
                  flush=True)
        out = torch.empty_like(y)
        y_ms, _ = sm.device_ms(lambda: torch.neg(y, out=out),
                               "elementwise_kernel", 0.0, f"y pass {name}")
        lib_ms = None
        if library and A.vals.dtype != torch.bfloat16:
            L = torch.sparse_csr_tensor(A.indptr.long(), A.indices.long(),
                                        A.vals, size=(A.n, A.ncols))
            lib_ms, _ = sm.library_ms(L, x, yp)
            del L
        row.update(ms=ms, device_ms=dev, warm_ms=warm_ms, device_note=note, host_ms=host,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   library_ms=lib_ms, empty_launch_ms=empty_ms,
                   y_pass_ms=y_ms,
                   share_of_bound=None if dev is None else b_ms / dev)
        rows.append(row)
        share = ("n/a" if dev is None else f"{100 * b_ms / dev:.0f}%")
        print(f"[{tag}] csr_spmv {name} {dt}: {A.n}x{A.ncols}, {A.nnz} "
              f"entries, {nempty} empty rows | device "
              f"{sm.fmt_dev(dev, note)}, per call {ms:.4f} ms, host cost "
              f"{host:.4f} ms | bound {b_ms:.4f} ms ({b_by}, "
              f"{nbytes / 1e6:.2f} MB): {share} of it | floor: empty launch "
              f"{sm.fmt_ms(empty_ms)}, a pass over y {sm.fmt_ms(y_ms)} | "
              f"torch.sparse.mm {sm.fmt_ms(lib_ms)} | within bound {held}, "
              f"same bits {same}  [{gpu}]", flush=True)
        torch.cuda.empty_cache()
    return rows, ok


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=".",
                   help="root of the tree whose tpufem_torch to time")
    p.add_argument("--json", metavar="PATH", help="write the rows to PATH")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--save", metavar="DIR",
                   help="keep the rows' matrices in DIR")
    g.add_argument("--load", metavar="DIR",
                   help="time the matrices kept in DIR, no rows")
    p.add_argument("--check", action="store_true",
                   help="only hold each matrix to the plain version")
    p.add_argument("--no-library", action="store_true",
                   help="no torch.sparse.mm")
    p.add_argument("--warm", action="store_true",
                   help="also the device time with no L2 flush")
    args = p.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("csr_spmv_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tpufem_torch
    if not tpufem_torch.__file__.startswith(root):
        print(f"csr_spmv_times: imported {tpufem_torch.__file__}, not the "
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
    dev = torch.device("cuda", 0)
    clocks_before = sm_clocks()
    stats = []
    if args.load:
        base = load(args.load, dev)
    else:
        stats, base = row_matrices(sm, tag, gpu)
        if args.save:
            save(base, args.save)
    rows, ok = kernel_rows(sm, with_dtypes(base), tag, gpu, args.check,
                           not args.no_library, args.warm)
    clocks_after = sm_clocks()
    print(f"[{tag}] clocks before {clocks_before}, after {clocks_after}  "
          f"[{gpu}]", flush=True)
    result = dict(tree=tag, gpu=gpu, rows=rows, sa_rows=stats,
                  clocks=[clocks_before, clocks_after],
                  refused_profiles=len(sm.REFUSED_PROFILES),
                  event_times=sm.EVENT_TIMES[0])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(dict(tree=tag, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
