#!/usr/bin/env python3
"""Times of the multi-kind zone apply (dia_zones) and of the P1 stencil
kernel's three-component form (the planar elasticity operator) of one
tree of the port, on one NVIDIA GPU, with the scalar P1 stencil (K1) and
the strip apply (K3) beside them.

Run one process a tree, from the repository root; to compare two trees,
unpack the other (``git archive <commit>``) into a git-ignored directory
and run them in turns in one call on the card (A, B, B, A):

    python scripts/zones_bs3_times.py [--tree DIR] [--split] [--sass DIR]
                                      [--json PATH] [--bs3-shape T,R]
                                      [--quick] [--only zones|bs3]

Cases, float32 and float64:

- dia_zones on the Poisson P2 500k (32x40x48 cells) and P3 500k
  (24x24x32) fine operators (``DiaOperator.try_const``), the plain
  version's bits; K3 on ``StripOperator.from_dia`` of the same matrix;
- the three-component form on the elasticity P1 500k CG matrix (grid
  65x49x49) and the three GMG levels below it (33x25x25, 17x13x13,
  9x7x7), within chip_smoke's TOL_BS3 of the plain version, the same
  bits twice;
- the scalar K1 on the Poisson P1 500k grid (97x81x65).

For each: the time per call (CUDA events, median of 11 means of 20
back-to-back calls), the device time per call by chip_smoke.device_ms
(an L2 flush before each call, the kernel's own profiler spans counted,
a retake where the count is wrong, CUDA events where the profiler keeps
missing spans), the byte or operation bound, and ``torch.sparse.mm`` of
the same matrix's CSR (on the finest grid of each kind).  The methods
are this repository's chip_smoke.py's, whichever tree is timed.

``--split``: the three-component kernel at 65x49x49 float32 built alone,
whole, with its staging alone, with its products alone and (a source with
the TPUFEM_BS3_PHASE switch) with its products but not their weights'
loads; the tree's csrc/stencil_p1.cu in a temporary copy, the earlier
templated form edited as ``_split_source`` says; each with the registers and
spills ptxas reports and the blocks resident on an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor).  ``--sass DIR``: the
SASS of the tree's dia_zones and stencil kernels (cuobjdump) into DIR.
``--bs3-shape T,R``: the three-component kernel rebuilt with blocks of T
points x R planes (the source's TPUFEM_BS3_TILE / _RUN macros and the
wrapper's mirrors of them), for a tree whose source has them.
``--quick``: float32 only, without torch.sparse.mm and K3; ``--only``:
one of the two kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZONE_CASES = ((2, (32, 40, 48)), (3, (24, 24, 32)))
BS3_CASES = ((48, 48, 64), (24, 24, 32), (12, 12, 16), (6, 6, 8))
SCALAR_CASE = (64, 80, 96)


def _smoke():
    """This repository's chip_smoke.py, whichever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid(dims) -> str:
    return "x".join(map(str, dims))


def _ptxas(log: str, keys) -> list:
    """(kernel, its ptxas 'Used ...' line with its stack and spills) for
    the entry functions whose mangled name holds one of ``keys``."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, frame = m.group(1), ""
        elif "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and any(k in name for k in keys):
            out.append((name, line.split(":", 1)[-1].strip()
                        + (f" ({frame})" if frame else "")))
            name = None
    return out


def _dtypes(quick: bool):
    import torch
    return (torch.float32,) if quick else (torch.float32, torch.float64)


def zone_rows(sm, dev, tag, gpu, quick=False):
    import torch
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dia_zones import (dia_zones_apply_plain,
                                            prepare_dia_zones)
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.fem.strip_op import StripOperator
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import poisson_bc_marker
    rows = []
    for order, cells in ZONE_CASES:
        mesh = BoxTetMesh(*cells)
        bc = DirichletBC.from_space(
            FunctionSpace(mesh, order),
            mesh.locate_boundary_facets(poisson_bc_marker))
        op = DiaOperator.try_const(mesh, order, "poisson",
                                   bc_dofs=bc.flat_dofs(),
                                   dtype=torch.float32, device=dev)
        csr = None if quick else sm.pk_csr(op.layout)
        for dtype in _dtypes(quick):
            name = f"dia_zones P{order} 500k {_grid(cells)} {str(dtype)[6:]}"
            pack = dataclasses.replace(op.zone_pack,
                                       fields=op.zone_pack.fields.to(dtype))
            launch = prepare_dia_zones(pack)
            gen = torch.Generator(device=dev).manual_seed(808)
            x = torch.randn(pack.ndofs, generator=gen, device=dev,
                            dtype=dtype)
            y = launch(x)
            same = bool(torch.equal(y, dia_zones_apply_plain(x, pack))
                        and torch.equal(launch(x), y))
            b_ms, b_by = sm.bound_ms(*sm.dia_zones_work(pack))
            ms = sm.median_ms(lambda: launch(x))
            dev_ms, note = sm.device_ms(lambda: launch(x), "dia_zones",
                                        b_ms, name)
            lib_ms = k3_ms = k3_dev = k3_note = None
            if not quick:
                lib = sm.torch_csr(csr, dev, dtype)
                lib_ms, _ = sm.library_ms(lib, x, y)
                del lib
                sop = StripOperator.from_dia(op, dtype=dtype, device=dev)
                xs = sop.to_strips(x)
                k3_ms = sm.median_ms(lambda: sop.apply_strips(xs))
                k3_dev, k3_note = sm.device_ms(
                    lambda: sop.apply_strips(xs), "strip_apply_kernel",
                    sm.bound_ms(*sm.strip_work(sop))[0], f"K3 on {name}")
                del sop, xs
            rows.append(dict(kernel="dia_zones", name=name, ms=ms,
                             device_ms=dev_ms, device_note=note,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, plain_bits=same,
                             k3_ms=k3_ms, k3_device_ms=k3_dev,
                             k3_device_note=k3_note))
            print(f"[{tag}] {name}: per call {ms:.4f} ms, device "
                  f"{sm.fmt_dev(dev_ms, note)}, bound {b_ms:.4f} ms "
                  f"({b_by}), torch.sparse.mm {sm.fmt_ms(lib_ms)}, the "
                  f"plain version's bits {same} | K3 on the same matrix: "
                  f"per call {sm.fmt_ms(k3_ms)}, device "
                  f"{sm.fmt_dev(k3_dev, k3_note)}  [{gpu}]", flush=True)
        del op
        torch.cuda.empty_cache()
    return rows


def stencil_rows(sm, dev, tag, gpu, quick=False):
    import numpy as np
    import torch
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import (elasticity_bc_marker,
                                              poisson_bc_marker)
    cases = [(c, 3) for c in BS3_CASES] + [(SCALAR_CASE, 1)]
    rows = []
    for cells, comps in cases:
        mesh = BoxTetMesh(*cells)
        problem, marker = (("elasticity", elasticity_bc_marker) if comps == 3
                           else ("poisson", poisson_bc_marker))
        bc = DirichletBC.from_space(FunctionSpace(mesh, 1, bs=comps),
                                    mesh.locate_boundary_facets(marker))
        op = DiaOperator.build(mesh, 1, problem, bc_dofs=bc.flat_dofs(),
                               dtype=torch.float32, device=dev,
                               planar=comps == 3)
        dims = op.grid_dims
        csr = None
        if cells in (BS3_CASES[0], SCALAR_CASE) and not quick:
            csr = op.to_scipy()
            if comps == 3:
                perm = np.arange(csr.shape[0]).reshape(-1, 3).T.reshape(-1)
                csr = csr[perm][:, perm]
        if comps == 3:
            prepare, plain = st.prepare_stencil_bs3, st.stencil_apply_bs3_plain
            tols = {torch.float32: sm.TOL_BS3_F32,
                    torch.float64: sm.TOL_BS3_F64}
            kind = "bs3"
        else:
            prepare, plain = st.prepare_stencil, st.stencil_apply_plain
            tols = {torch.float32: sm.TOL_F32, torch.float64: sm.TOL_F64}
            kind = "K1"
        for dtype in _dtypes(quick):
            tol = tols[dtype]
            name = f"{kind} {_grid(dims)} {str(dtype)[6:]}"
            fields = op.fields.to(dtype)
            args = (fields, op.offsets, dims)
            launch = prepare(*args)
            gen = torch.Generator(device=dev).manual_seed(1234)
            x = torch.randn(comps * int(np.prod(dims)), generator=gen,
                            device=dev, dtype=dtype)
            y = launch(x)
            again = bool(torch.equal(launch(x), y))
            bound = plain(x.abs(), fields.abs(), *args[1:])
            ok = bool(((y - plain(x, *args)).abs() <= tol * bound).all())
            b_ms, b_by = sm.bound_ms(*sm.stencil_work(fields, dims, comps))
            ms = sm.median_ms(lambda: launch(x))
            dev_ms, note = sm.device_ms(
                lambda: launch(x),
                "stencil_p1" if comps == 3 else "stencil_p1_kernel", b_ms,
                name)
            lib_ms = None
            if csr is not None:
                lib = sm.torch_csr(csr, dev, dtype)
                lib_ms, _ = sm.library_ms(lib, x, y)
                del lib
            rows.append(dict(kernel=kind, name=name, ms=ms,
                             device_ms=dev_ms, device_note=note,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, within_tol=ok,
                             same_twice=again))
            lib_txt = ("" if lib_ms is None
                       else f", torch.sparse.mm {lib_ms:.4f} ms")
            print(f"[{tag}] {name}: per call {ms:.4f} ms, device "
                  f"{sm.fmt_dev(dev_ms, note)}, bound {b_ms:.4f} ms "
                  f"({b_by}){lib_txt}; within tolerance {ok}, the same "
                  f"bits twice {again}  [{gpu}]", flush=True)
        del op
        torch.cuda.empty_cache()
    return rows


# The split of the three-component kernel: how a temporary copy of the
# tree's csrc/stencil_p1.cu is cut to its staging alone or its products
# alone.  A source with the TPUFEM_BS3_PHASE switch (1 staging alone, 2
# products alone) takes it as a macro; the earlier templated form
# (stencil_p1_kernel<T, MD, NC>) is edited as its text says.
_OLD_STAGE = "tpufem::cp_async_value(s + i,"
_OLD_PRODUCTS = "  if (!active) return;\n\n  for (int zl"
_OLD_OCCUPANCY = r"""
extern "C" int tpufem_split_blocks(int smem) {
  int n = 0;
  cudaError_t e = allow_smem<float, kP1Diagonals, 3>(0, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, stencil_p1_kernel<float, kP1Diagonals, 3>, kTile, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
"""


def _split_source(src: str, phase: int):
    """(source text, extra nvcc flags) of ``phase`` (0 whole, 1 staging
    alone, 2 products alone, 3 products without their weight loads: the
    new form only), or None where the form does not have it."""
    if "TPUFEM_BS3_PHASE" in src:
        return src, [f"-DTPUFEM_BS3_PHASE={phase}"]
    if _OLD_STAGE not in src or _OLD_PRODUCTS not in src or phase == 3:
        return None
    if phase == 1:
        src = src.replace(_OLD_PRODUCTS, "  if (!active || NC == 3) return;"
                          "\n\n  for (int zl")
    elif phase == 2:
        src = src.replace(_OLD_STAGE, "if (NC == 1) " + _OLD_STAGE)
    return src + _OLD_OCCUPANCY, []


def split_rows(sm, root, dev, tag, gpu):
    import torch
    from tpufem_torch import _build
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import elasticity_bc_marker
    csrc = os.path.join(root, "tpufem_torch", "csrc")
    with open(os.path.join(csrc, "stencil_p1.cu")) as f:
        src = f.read()
    if _split_source(src, 0) is None:
        print(f"[{tag}] --split: csrc/stencil_p1.cu has neither form",
              flush=True)
        return []
    mesh = BoxTetMesh(*BS3_CASES[0])
    bc = DirichletBC.from_space(FunctionSpace(mesh, 1, bs=3),
                                mesh.locate_boundary_facets(
                                    elasticity_bc_marker))
    op = DiaOperator.build(mesh, 1, "elasticity", bc_dofs=bc.flat_dofs(),
                           dtype=torch.float32, device=dev, planar=True)
    Z, Y, X = dims = op.grid_dims
    T, R = op.fields.shape[:2]
    run = int(st.stencil_runs(dims, R, 4, 3)[:, 1].max())
    args = _build.StencilLaunch(F=op.fields.data_ptr(), device=dev.index,
                                Z=Z, Y=Y, X=X, R=R, D=T // 9, run=run)
    for key, col in zip(("dx", "dy", "dz"), st.pack_offsets(op.offsets)):
        getattr(args, key)[:] = col.tolist()
    x = torch.randn(3 * Z * Y * X, device=dev)
    y = torch.empty_like(x)
    smem = st.stencil_smem_bytes(run, X, 4, 3)
    b_ms = sm.bound_ms(*sm.stencil_work(op.fields, dims, 3))[0]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), tmp)
        for phase, what in ((0, "whole"), (1, "staging alone"),
                            (2, "products alone"),
                            (3, "products without weight loads")):
            if _split_source(src, phase) is None:
                continue
            text, flags = _split_source(src, phase)
            cu = os.path.join(tmp, f"split{phase}.cu")
            so = os.path.join(tmp, f"split{phase}.so")
            with open(cu, "w") as f:
                f.write(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
                   "-o", so, cu]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed: {proc.stderr}")
            # the float instance of the three-component kernel
            ptx = [u for n, u in _ptxas(proc.stdout + proc.stderr,
                                        ("IfLi15ELi3E", "bs3_kernelIf"))]
            lib = ctypes.CDLL(so)
            fn = lib.tpufem_stencil_p1_bs3_f32
            fn.argtypes = [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
            blocks = getattr(lib, "tpufem_split_blocks", None)
            if blocks is None:
                blocks = lib.tpufem_stencil_p1_bs3_blocks
            blocks.argtypes = [ctypes.c_int]
            blocks.restype = ctypes.c_int
            resident = blocks(smem)

            def call():
                rc = fn(ctypes.addressof(args), x.data_ptr(), y.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"split {what}: cuda error {rc}")

            ms = sm.median_ms(call)
            dev_ms, note = sm.device_ms(call, "stencil_p1", 0.0,
                                        f"bs3 split {what}")
            rows.append(dict(kernel="bs3 split", name=what, ms=ms,
                             device_ms=dev_ms, device_note=note,
                             bound_ms=b_ms, resident_blocks=resident,
                             ptxas=ptx))
            print(f"[{tag}] bs3 {_grid(dims)} float32 {what}: per call "
                  f"{ms:.4f} ms, device {sm.fmt_dev(dev_ms, note)} (whole "
                  f"kernel's bound {b_ms:.4f} ms); {resident} block(s) of "
                  f"{smem} B shared memory resident an SM; ptxas {ptx}  "
                  f"[{gpu}]", flush=True)
    return rows


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=".",
                   help="root of the tree whose tpufem_torch to time")
    p.add_argument("--split", action="store_true",
                   help="also the three-component kernel's staging and "
                        "products alone")
    p.add_argument("--sass", metavar="DIR",
                   help="write the kernels' SASS into DIR")
    p.add_argument("--json", metavar="PATH", help="write the rows to PATH")
    p.add_argument("--bs3-shape", metavar="T,R",
                   help="three-component blocks of T points x R planes")
    p.add_argument("--quick", action="store_true",
                   help="float32 only, no library call, no K3")
    p.add_argument("--only", choices=("zones", "bs3"))
    args = p.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("zones_bs3_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tpufem_torch
    if not tpufem_torch.__file__.startswith(root):
        print(f"zones_bs3_times: imported {tpufem_torch.__file__}, not the "
              f"tree {root}", file=sys.stderr)
        return 1
    from tpufem_torch import _build
    from tpufem_torch.fem import stencil
    tag = os.path.relpath(root, ROOT)
    if args.bs3_shape:
        t, r = (int(v) for v in args.bs3_shape.split(","))
        _build.NVCC_FLAGS += (f"-DTPUFEM_BS3_TILE={t}",
                              f"-DTPUFEM_BS3_RUN={r}")
        stencil._TILE3, stencil._RUN3 = t, r
        tag += f" bs3 {args.bs3_shape}"
    sm = _smoke()
    gpu = sm.gpu_line()
    kern = _build.load()
    print(f"[{tag}] kernels built in {kern.build_seconds:.1f} s  [{gpu}]",
          flush=True)
    for name, used in _ptxas(kern.log, ("dia_zones", "stencil_p1")):
        print(f"[{tag}] ptxas {name}: {used}", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        out = os.path.join(args.sass,
                           (re.sub(r"\W+", "_", tag).strip("_") or "tree")
                           + ".sass")
        with open(out, "w") as f:
            cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                     "cuobjdump")
            subprocess.run([cuobjdump, "-sass", str(kern.path)], stdout=f,
                           check=True)
        print(f"[{tag}] SASS written to {out}", flush=True)
    dev = torch.device("cuda", 0)
    rows = []
    if args.only != "bs3":
        rows += zone_rows(sm, dev, tag, gpu, args.quick)
    if args.only != "zones":
        rows += stencil_rows(sm, dev, tag, gpu, args.quick)
    if args.split:
        rows += split_rows(sm, root, dev, tag, gpu)
    result = dict(tree=tag, gpu=gpu, rows=rows,
                  refused_profiles=len(sm.REFUSED_PROFILES),
                  event_times=sm.EVENT_TIMES[0])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    ok = all(r.get("plain_bits", True) and r.get("within_tol", True)
             and r.get("same_twice", True) for r in rows)
    print(json.dumps(dict(tree=tag, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
