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
                                      [--grids 500k,10m,slab]
                                      [--same-bits-as PATH]

Cases, float32 and float64:

- dia_zones on the Poisson P2 500k (32x40x48 cells) and P3 500k
  (24x24x32) fine operators (``DiaOperator.try_const``), the plain
  version's bits; K3 on ``StripOperator.from_dia`` of the same matrix;
- the three-component form on the elasticity P1 500k CG matrix (grid
  65x49x49) and the three GMG levels below it (33x25x25, 17x13x13,
  9x7x7), and on the 10M-dof elasticity cell's matrix (161x161x129) and
  its four smoothed levels below it (81x81x65, 41x41x33, 21x21x17,
  11x11x9), and on a 17x49x49 slab of the 4-slab 500k run (no Dirichlet
  rows), within chip_smoke's TOL_BS3 of the plain version, the same bits
  twice; on a tree whose kernels read a table (fem.stencil.compress_bs3)
  the kernel ``prepare_stencil_bs3`` picks and, beside it, the other one
  (a thread a point, a thread an output), and whether the two give the
  same bits; a digest of y's bits, the same x on every tree;
- the scalar K1 on the Poisson P1 500k grid (97x81x65).

For each: the time per call (CUDA events, median of 11 means of 20
back-to-back calls), the device time per call by chip_smoke.device_ms
(an L2 flush before each call, the kernel's own profiler spans counted,
a retake where the count is wrong, CUDA events where the profiler keeps
missing spans), the byte or operation bound, and ``torch.sparse.mm`` of
the same matrix's CSR (on the 500k grids).  The methods are this
repository's chip_smoke.py's, whichever tree is timed, the bound too: the
three-component rows' counts x, y and the table of the fields' distinct
columns with its class bytes, what the table's kernels read.

``--split``: the three-component kernel at 65x49x49 and at 161x161x129
(``--grids``) float32, in the form the tree's ``prepare_stencil_bs3``
picks, built alone, whole, with its staging alone, with its products
alone and (a source with the TPUFEM_BS3_PHASE switch) with its products
but not their weights' loads; the tree's csrc/stencil_p1.cu in a
temporary copy, the earlier templated form edited as ``_split_source``
says, launched through the tree's own wrapper; each with the registers
and spills ptxas reports and the blocks resident on an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor).  ``--sass DIR``: the
SASS of the tree's dia_zones and stencil kernels (cuobjdump) into DIR.
``--bs3-shape T,R``: the three-component kernel rebuilt with blocks of T
points x R planes (the source's TPUFEM_BS3_TILE / _RUN macros and the
wrapper's mirrors of them), for a tree whose source has them;
``--bs3t-tile T``: the table form's kernel with blocks of T points
(TPUFEM_BS3T_TILE and its mirror).
``--quick``: float32 only, without torch.sparse.mm and K3; ``--only``:
one of the two kernels; ``--grids``: the three-component grids, those of
the 500k path, of the 10M cell (the default both) and of the slab.
``--same-bits-as PATH``: the ``--json`` of another tree's run; every
three-component row here must give that run's bits for the same name.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
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
BS3_CASES = {"500k": ((48, 48, 64), (24, 24, 32), (12, 12, 16), (6, 6, 8)),
             "10m": ((128, 160, 160), (64, 80, 80), (32, 40, 40),
                     (16, 20, 20), (8, 10, 10)),
             "slab": ((48, 48, 16),)}
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


def _elasticity_op(cells, dev):
    """The planar P1 elasticity matrix of ``cells`` cubes, clamped on
    y = 0, float32 on ``dev``."""
    import torch
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import elasticity_bc_marker
    mesh = BoxTetMesh(*cells)
    bc = DirichletBC.from_space(FunctionSpace(mesh, 1, bs=3),
                                mesh.locate_boundary_facets(
                                    elasticity_bc_marker))
    return DiaOperator.build(mesh, 1, "elasticity", bc_dofs=bc.flat_dofs(),
                             dtype=torch.float32, device=dev, planar=True)


def stencil_rows(sm, dev, tag, gpu, quick=False, grids=("500k", "10m")):
    import numpy as np
    import torch
    from tpufem_torch.fem import stencil as st
    from tpufem_torch.fem.dia_op import DiaOperator
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.problems.common import (elasticity_bc_marker,
                                              poisson_bc_marker)
    cases = ([(c, 3) for g in grids for c in BS3_CASES[g]]
             + [(SCALAR_CASE, 1)])
    rows = []
    for cells, comps in cases:
        mesh = BoxTetMesh(*cells)
        problem, marker = (("elasticity", elasticity_bc_marker) if comps == 3
                           else ("poisson", poisson_bc_marker))
        if cells in BS3_CASES["slab"]:  # parallel.slab._slab_operator's
            op = DiaOperator.build(mesh, 1, problem, dtype=torch.float32,
                                   device=dev, bake_bc=False,
                                   h_override=(1 / 48, 1 / 48, 1 / 64),
                                   planar=True)
        else:
            bc = DirichletBC.from_space(FunctionSpace(mesh, 1, bs=comps),
                                        mesh.locate_boundary_facets(marker))
            op = DiaOperator.build(mesh, 1, problem, bc_dofs=bc.flat_dofs(),
                                   dtype=torch.float32, device=dev,
                                   planar=comps == 3)
        dims = op.grid_dims
        csr = None
        if cells in (BS3_CASES["500k"][0], SCALAR_CASE) and not quick:
            csr = op.to_scipy()
            if comps == 3:
                perm = np.arange(csr.shape[0]).reshape(-1, 3).T.reshape(-1)
                csr = csr[perm][:, perm]
        if comps == 3:
            prepare, plain = st.prepare_stencil_bs3, st.stencil_apply_bs3_plain
            tols = {torch.float32: sm.TOL_BS3_F32,
                    torch.float64: sm.TOL_BS3_F64}
            kind = "bs3" + (" slab" if cells in BS3_CASES["slab"] else "")
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
            digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
            b_ms, b_by = sm.bound_ms(*sm.stencil_work(fields, dims, comps))
            # the kernels: the one prepare picks and, on a tree whose
            # kernels read a table, the other beside it (the plan for a
            # card of one SM takes a thread a point, of a million a thread
            # an output); a tree that reads the fields has one
            forms = [("picked", launch)]
            if comps == 3 and hasattr(st, "stencil_bs3_plan"):
                point = st.stencil_bs3_plan(*args).per_point
                forms = [("a thread " + ("a point" if p else "an output"),
                          st.prepare_stencil_bs3(*args, 1 if p else 10 ** 6))
                         for p in (point, not point)]
            elif comps == 3:
                forms = [("fields", launch)]
            same_forms = all(bool(torch.equal(f(x), y)) for _, f in forms)
            for form, fn in forms:
                ms = sm.median_ms(lambda: fn(x))
                dev_ms, note = sm.device_ms(
                    lambda: fn(x),
                    "stencil_p1" if comps == 3 else "stencil_p1_kernel",
                    b_ms, f"{name} {form}")
                lib_ms = None
                if csr is not None and form == forms[0][0]:
                    lib = sm.torch_csr(csr, dev, dtype)
                    lib_ms, _ = sm.library_ms(lib, x, y)
                    del lib
                rows.append(dict(kernel=kind, name=name, form=form, ms=ms,
                                 device_ms=dev_ms, device_note=note,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, within_tol=ok,
                                 same_twice=again, same_forms=same_forms,
                                 bits=digest))
                lib_txt = ("" if lib_ms is None
                           else f", torch.sparse.mm {lib_ms:.4f} ms")
                print(f"[{tag}] {name} ({form}): per call {ms:.4f} ms, "
                      f"device {sm.fmt_dev(dev_ms, note)}, bound "
                      f"{b_ms:.4f} ms ({b_by}){lib_txt}; within tolerance "
                      f"{ok}, the same bits twice {again}, both kernels' "
                      f"bits {same_forms}, bits {digest[:16]}  [{gpu}]",
                      flush=True)
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


def _split_lib(so: str):
    """The split library as ``_build.load`` returns the kernels: its
    three-component entries (StencilLaunch* or Bs3TableLaunch*, x, y,
    stream) and its error strings declared."""
    from tpufem_torch import _build
    lib = ctypes.CDLL(so)
    for name in ("tpufem_stencil_p1_bs3_f32",
                 "tpufem_stencil_p1_bs3_table_f32"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
    lib.tpufem_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpufem_cuda_error_string.restype = ctypes.c_char_p
    return _build.Kernels(lib=lib, path=so, build_seconds=0.0, log="")


def split_rows(sm, root, dev, tag, gpu, grids=("500k", "10m")):
    import torch
    from tpufem_torch import _build
    from tpufem_torch.fem import stencil as st
    csrc = os.path.join(root, "tpufem_torch", "csrc")
    with open(os.path.join(csrc, "stencil_p1.cu")) as f:
        src = f.read()
    if _split_source(src, 0) is None:
        print(f"[{tag}] --split: csrc/stencil_p1.cu has neither form",
              flush=True)
        return []
    rows = []
    load = _build.load
    with tempfile.TemporaryDirectory() as tmp:
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), tmp)
        libs = []
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
            # the float instances of the three-component kernels
            ptx = [u for n, u in _ptxas(proc.stdout + proc.stderr,
                                        ("IfLi15ELi3E", "bs3_kernelIf",
                                         "bs3_table_kernelIf"))]
            libs.append((what, so, ptx))
        for g in grids:
            cells = BS3_CASES[g][0]
            op = _elasticity_op(cells, dev)
            Z, Y, X = dims = op.grid_dims
            x = torch.randn(3 * Z * Y * X, device=dev)
            b_ms = sm.bound_ms(*sm.stencil_work(op.fields, dims, 3))[0]
            for what, so, ptx in libs:
                kern = _split_lib(so)
                _build.load = lambda: kern
                try:
                    launch = st.prepare_stencil_bs3(op.fields, op.offsets,
                                                    dims)
                finally:
                    _build.load = load
                form = ("table" if getattr(launch, "table", None) is not None
                        else "fields")
                blocks = getattr(kern.lib, "tpufem_split_blocks", None)
                if blocks is None:
                    blocks = kern.lib.tpufem_stencil_p1_bs3_blocks
                blocks.argtypes = [ctypes.c_int]
                blocks.restype = ctypes.c_int
                if form == "table":
                    smem = st.stencil_bs3_plan(op.fields, op.offsets,
                                               dims).smem
                else:
                    runs = st.stencil_runs(dims, op.fields.shape[1], 4, 3)
                    smem = st.stencil_smem_bytes(int(runs[:, 1].max()), X, 4,
                                                 3)
                resident = blocks(smem)
                ms = sm.median_ms(lambda: launch(x))
                dev_ms, note = sm.device_ms(lambda: launch(x), "stencil_p1",
                                            0.0, f"bs3 split {what}")
                rows.append(dict(kernel="bs3 split", name=what,
                                 grid=_grid(dims), form=form, ms=ms,
                                 device_ms=dev_ms, device_note=note,
                                 bound_ms=b_ms, resident_blocks=resident,
                                 ptxas=ptx))
                print(f"[{tag}] bs3 {_grid(dims)} float32 {form} form "
                      f"{what}: per call {ms:.4f} ms, device "
                      f"{sm.fmt_dev(dev_ms, note)} (whole kernel's bound "
                      f"{b_ms:.4f} ms); {resident} block(s) of {smem} B "
                      f"shared memory resident an SM; ptxas {ptx}  [{gpu}]",
                      flush=True)
                del launch
            del op, x
            torch.cuda.empty_cache()
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
    p.add_argument("--bs3t-tile", metavar="T", type=int,
                   help="table-form blocks of T points")
    p.add_argument("--quick", action="store_true",
                   help="float32 only, no library call, no K3")
    p.add_argument("--only", choices=("zones", "bs3"))
    p.add_argument("--grids", default="500k,10m",
                   help="the three-component grids: 500k, 10m, slab")
    p.add_argument("--same-bits-as", metavar="PATH",
                   help="another tree's --json, whose bits to give")
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
    if args.bs3t_tile:
        _build.NVCC_FLAGS += (f"-DTPUFEM_BS3T_TILE={args.bs3t_tile}",)
        stencil._TILE3T = args.bs3t_tile
        tag += f" table tile {args.bs3t_tile}"
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
    grids = tuple(args.grids.split(","))
    if args.only != "bs3":
        rows += zone_rows(sm, dev, tag, gpu, args.quick)
    if args.only != "zones":
        rows += stencil_rows(sm, dev, tag, gpu, args.quick, grids)
    if args.split:
        rows += split_rows(sm, root, dev, tag, gpu, grids)
    result = dict(tree=tag, gpu=gpu, rows=rows,
                  refused_profiles=len(sm.REFUSED_PROFILES),
                  event_times=sm.EVENT_TIMES[0])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    ok = all(r.get("plain_bits", True) and r.get("within_tol", True)
             and r.get("same_twice", True) and r.get("same_forms", True)
             for r in rows)
    if args.same_bits_as:
        with open(args.same_bits_as) as f:
            theirs = {r["name"]: r["bits"] for r in json.load(f)["rows"]
                      if r.get("bits") and r["kernel"].startswith("bs3")}
        ours = {r["name"]: r["bits"] for r in rows
                if r.get("bits") and r["kernel"].startswith("bs3")}
        same = {n: theirs.get(n) == b for n, b in ours.items()}
        print(json.dumps(dict(tree=tag, same_bits_as=args.same_bits_as,
                              rows=len(same), differ=[n for n, v in
                                                      same.items() if not v])),
              flush=True)
        ok = ok and bool(same) and all(same.values())
    print(json.dumps(dict(tree=tag, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
