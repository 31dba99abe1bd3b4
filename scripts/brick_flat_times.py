#!/usr/bin/env python3
"""Times of brick-AMG's flat stencil kernel (brick_flat) of one tree of
the port, on one NVIDIA GPU, and the three brick-AMG rows that run it.

Run one process a tree, from the repository root; to compare two trees,
unpack the other (``git archive <commit>``) into a git-ignored directory
and run them in turns in one call on the card (A, B, B, A):

    python scripts/brick_flat_times.py [--tree DIR] [--json PATH]
                                       [--random] [--quick] [--split]
                                       [--sass DIR] [--set NAME=VALUE]

The rows: tpufem's ``poisson_amg`` (60^3 lattice), ``poisson_amg_500k``
and ``elasticity_amg_500k`` bench rows through chip_smoke.amg_row (f32,
rtol 1e-8, certified; iterations against tpufem's 13 / 17 / 19; the warm
solve's median, min and max of 5), whose level-1 operators ([21,21,21]
m = 1, [33,27,22] m = 1, [22,17,102] m = 6) are then timed in float32
and float64: the plain version's bits (torch.equal), the time per call
(CUDA events, median of 11 means of 20 back-to-back calls), the device
time per call by chip_smoke.device_ms (an L2 flush before each call, the
kernel's own profiler spans counted, a retake where the count is wrong,
CUDA events where the profiler keeps missing spans), the wrapper's host
cost per queued call, the byte bound, ``torch.sparse.mm`` of the same
operator as a CSR matrix, and the device time of an elementwise pass
over x after the same flush (the floor of the method: a launch, x read
and y written).  The methods are this repository's
chip_smoke.py's, whichever tree is timed.

``--random``: random fields on the three grids, no rows (a design
iteration).  ``--quick``: float32 only, no torch.sparse.mm;
``--no-library``: no torch.sparse.mm.
``--split``: temporary copies of the tree's csrc/brick_flat.cu, built
alone and edited as ``_split_source`` says: whole, the field loads
summed without x, and the x reads and products without the field loads,
each timed at the m = 6 level, float32, with the registers ptxas
reports.  ``--sass DIR``: the SASS of the tree's brick_flat kernels
(cuobjdump) into DIR.  ``--set NAME=VALUE``: a constant of the tree's
tpufem_torch.la.brick_flat (its tiling's MIN_BLOCKS, MAX_POINTS,
MAX_LANES).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = (((21, 21, 21), 1), ((33, 27, 22), 1), ((22, 17, 17), 6))


def _smoke():
    """This repository's chip_smoke.py, whichever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid(gdims, m) -> str:
    az, ay, ax = gdims
    return f"{az}x{ay}x{ax * m}"


def _ptxas(log: str) -> list:
    """(kernel, its ptxas 'Used ...' line with its stack and spills) for
    the brick_flat entry functions."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, frame = m.group(1), ""
        elif "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "brick_flat" in name:
            out.append((name, line.split(":", 1)[-1].strip()
                        + (f" ({frame})" if frame else "")))
            name = None
    return out


def row_levels(sm, dev, tag, gpu):
    """The three AMG rows: (their numbers, their level-1 operators)."""
    import torch
    stats, levels = [], []
    for key, problem, dims, ndofs, ref_it, maxit in sm.AMG_ROWS:
        _, (fields, plan, gdims, c), st = sm.amg_row(
            key, problem, dims, ndofs, ref_it, maxit, dev, gpu)
        st["tree"] = tag
        stats.append(st)
        print(f"[{tag}] {key}: {st['iterations']} iterations (tpufem "
              f"{ref_it}), true_rel {st['true_rel']:.3e}, warm solve median "
              f"{st['solve_s']:.4f} s (min {st['solve_min_s']:.4f}, max "
              f"{st['solve_max_s']:.4f}), {st['ms_per_iteration']:.3f} ms an "
              f"iteration, brick_flat {st['brick_flat_per_iteration']:.1f} an "
              f"iteration  [{gpu}]", flush=True)
        levels.append((f"{key} level 1 {_grid(gdims, c)} m={c}", fields,
                       plan, gdims, c))
        torch.cuda.empty_cache()
    return stats, levels


def random_levels(dev):
    import numpy as np
    import torch
    from tpufem_torch.la.bramg import stencil_to_flat_fields
    rng = np.random.default_rng(13)
    out = []
    for gdims, m in GRIDS:
        plan, fields = stencil_to_flat_fields(
            rng.standard_normal((3, 3, 3) + gdims + (m, m)), m)
        out.append((f"random {_grid(gdims, m)} m={m}",
                    torch.from_numpy(np.stack(fields)).to(dev, torch.float32),
                    plan, gdims, m))
    return out


def kernel_rows(sm, levels, dev, tag, gpu, quick, library=True):
    import torch
    from tpufem_torch.la import brick_flat as bf
    rows = []
    dtypes = (torch.float32,) if quick else (torch.float32, torch.float64)
    for dtype in dtypes:
        for name, fields_any, plan, gdims, c in levels:
            fields = fields_any.to(dtype).contiguous()
            args = (fields, plan, gdims, c)
            launch = bf.prepare_brick_flat(*args)
            gen = torch.Generator(device=dev).manual_seed(2024)
            x = torch.randn(fields[0].numel(), generator=gen, device=dev,
                            dtype=dtype)
            y = launch(x)
            same = bool(torch.equal(y, bf.brick_flat_apply_plain(x, *args))
                        and torch.equal(launch(x), y))
            b_ms, b_by = sm.bound_ms(*sm.brick_flat_work(fields, plan))
            ms = sm.median_ms(lambda: launch(x))
            host = sm.host_ms(lambda: launch(x))
            what = f"{name} {str(dtype)[6:]}"
            dev_ms, note = sm.device_ms(lambda: launch(x),
                                        "brick_flat_kernel", b_ms, what)
            # the floor of this method: an elementwise pass over x after
            # the same flush (x read, y written; no fields)
            out = torch.empty_like(x)
            floor_ms, _ = sm.device_ms(lambda: torch.neg(x, out=out),
                                       "elementwise_kernel", 0.0,
                                       f"floor {what}")
            lib_ms = None
            if library and not quick:
                A = sm.brick_flat_csr(fields, plan, gdims, c)
                lib_ms, _ = sm.library_ms(A, x, y)
                del A
            tiling = None
            if hasattr(bf, "brick_flat_tiling"):
                t = bf.brick_flat_tiling(gdims, c)
                tiling = dict(rows=t.rows, lanes=t.lanes, threads=t.threads,
                              blocks=t.blocks)
            rows.append(dict(tree=tag, name=what, fields=len(plan), ms=ms,
                             device_ms=dev_ms, device_note=note,
                             host_ms=host, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, plain_bits=same,
                             floor_ms=floor_ms, tiling=tiling))
            print(f"[{tag}] brick_flat {what}: per call {ms:.4f} ms, device "
                  f"{sm.fmt_dev(dev_ms, note)}, host cost {host:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), torch.sparse.mm "
                  f"{sm.fmt_ms(lib_ms)}, an elementwise pass over x "
                  f"{sm.fmt_ms(floor_ms)} device, the plain version's bits "
                  f"{same}, "
                  f"tiling {tiling}  [{gpu}]", flush=True)
            del fields, launch
        torch.cuda.empty_cache()
    return rows


# The split of the kernel: the lines of csrc/brick_flat.cu that a
# temporary copy edits, to time the field loads or the products alone.
_FIELD_LOAD = "r[kk] = __ldg(f0 + k * n);"
_PRODUCT = "acc = add_rn(acc, mul_rn(cur[kk], box[xb + xoff[k0 + kk]]));"


def _split_source(src: str, phase: int):
    """The source for phase 0 (whole), 1 (the field loads summed without
    x) or 2 (the x reads and products with no field loads), or None where
    the source has not the lines the split edits."""
    if _FIELD_LOAD not in src or _PRODUCT not in src:
        return None
    if phase == 1:
        return src.replace(_PRODUCT, "acc = add_rn(acc, cur[kk]);")
    if phase == 2:
        return src.replace(_FIELD_LOAD, "r[kk] = T(1);")
    return src


def split_rows(sm, root, levels, dev, tag, gpu):
    """The m = 6 level, float32, through edited copies of the tree's
    csrc/brick_flat.cu, each built alone (see _split_source)."""
    import torch
    from tpufem_torch import _build
    from tpufem_torch.la import brick_flat as bf
    csrc = os.path.join(root, "tpufem_torch", "csrc")
    with open(os.path.join(csrc, "brick_flat.cu")) as f:
        src = f.read()
    if _split_source(src, 0) is None:
        print(f"[{tag}] --split: csrc/brick_flat.cu has not the split's "
              f"lines", flush=True)
        return []
    name, fields, plan, gdims, c = [lv for lv in levels if lv[4] == 6][0]
    fields = fields.to(torch.float32).contiguous()
    launch = bf.prepare_brick_flat(fields, plan, gdims, c)
    args = launch.keep[0]
    x = torch.randn(fields[0].numel(), device=dev)
    y = torch.empty_like(x)
    b_ms = sm.bound_ms(*sm.brick_flat_work(fields, plan))[0]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for phase, what in ((0, "whole"), (1, "field loads alone"),
                            (2, "products alone")):
            cu = os.path.join(tmp, f"split{phase}.cu")
            so = os.path.join(tmp, f"split{phase}.so")
            with open(cu, "w") as f:
                f.write(_split_source(src, phase))
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared",
                   "-o", so, cu]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed: {proc.stderr}")
            ptx = _ptxas(proc.stdout + proc.stderr)
            lib = ctypes.CDLL(so)
            fn = lib.tpufem_brick_flat_f32
            fn.argtypes = [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int

            def call():
                rc = fn(ctypes.addressof(args), x.data_ptr(), y.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"split {what}: cuda error {rc}")

            ms = sm.median_ms(call)
            dev_ms, note = sm.device_ms(call, "brick_flat_kernel", 0.0,
                                        f"brick_flat split {what}")
            rows.append(dict(tree=tag, name=f"split {what}", ms=ms,
                             device_ms=dev_ms, device_note=note,
                             bound_ms=b_ms, ptxas=ptx))
            print(f"[{tag}] brick_flat {name} float32 {what}: per call "
                  f"{ms:.4f} ms, device {sm.fmt_dev(dev_ms, note)} (whole "
                  f"kernel's bound {b_ms:.4f} ms); ptxas {ptx}  [{gpu}]",
                  flush=True)
    return rows


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=".",
                   help="root of the tree whose tpufem_torch to time")
    p.add_argument("--json", metavar="PATH", help="write the rows to PATH")
    p.add_argument("--random", action="store_true",
                   help="random fields on the three grids, no AMG rows")
    p.add_argument("--quick", action="store_true",
                   help="float32 only, no library call")
    p.add_argument("--no-library", action="store_true",
                   help="no library call")
    p.add_argument("--split", action="store_true",
                   help="also the field loads and the products alone "
                        "(m = 6)")
    p.add_argument("--sass", metavar="DIR",
                   help="write the kernels' SASS into DIR")
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="a tiling constant of la.brick_flat")
    args = p.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("brick_flat_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tpufem_torch
    if not tpufem_torch.__file__.startswith(root):
        print(f"brick_flat_times: imported {tpufem_torch.__file__}, not the "
              f"tree {root}", file=sys.stderr)
        return 1
    from tpufem_torch import _build
    from tpufem_torch.la import brick_flat as bf
    tag = os.path.relpath(root, ROOT)
    for item in args.set:
        key, value = item.split("=")
        if not hasattr(bf, key):
            print(f"brick_flat_times: la.brick_flat has no {key}",
                  file=sys.stderr)
            return 1
        setattr(bf, key, int(value))
    if args.set:
        tag += " " + " ".join(args.set)
    sm = _smoke()
    gpu = sm.gpu_line()
    kern = _build.load()
    print(f"[{tag}] kernels built in {kern.build_seconds:.1f} s  [{gpu}]",
          flush=True)
    for name, used in _ptxas(kern.log):
        print(f"[{tag}] ptxas {name}: {used}", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        out = os.path.join(args.sass,
                           (re.sub(r"\W+", "_", tag).strip("_") or "tree")
                           + ".sass")
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        with open(out, "w") as f:
            subprocess.run([cuobjdump, "-sass", str(kern.path)], stdout=f,
                           check=True)
        print(f"[{tag}] SASS written to {out}", flush=True)
    dev = torch.device("cuda", 0)
    stats = []
    if args.random:
        levels = random_levels(dev)
    else:
        stats, levels = row_levels(sm, dev, tag, gpu)
    rows = kernel_rows(sm, levels, dev, tag, gpu, args.quick,
                       not args.no_library)
    if args.split:
        rows += split_rows(sm, root, levels, dev, tag, gpu)
    result = dict(tree=tag, gpu=gpu, rows=rows, amg_rows=stats,
                  refused_profiles=len(sm.REFUSED_PROFILES),
                  event_times=sm.EVENT_TIMES[0])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    ok = all(r.get("plain_bits", True) for r in rows)
    print(json.dumps(dict(tree=tag, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
