#!/usr/bin/env python3
"""Block shapes of the strip apply (tpufem_torch/csrc/strip_apply.cu) and
the P1 stencil (csrc/stencil_p1.cu) against each other, on one NVIDIA GPU.

The shapes are constants of the sources (threads of a block, threads of
a block where four fit an SM, and planes of a z run for the strip apply; points of a tile and
planes of a mid-zone run for the stencil).  This script rebuilds the
port's kernels once per variant with the sources' ``-DTPUFEM_STRIP_*`` /
``-DTPUFEM_STENCIL_*`` macros, sets the wrappers' mirrors of them, and
times one apply of the cgpoisson P3 and P2 operators at 500k dofs and P3
at 150k (strip) and of the Poisson 500k hierarchy's four grids in zone
form and its finest in full-field form (stencil), float32: the kernel's
device time from the profiler and the time per call from CUDA events,
each checked against the plain version first.  Run from the repository
root:

    python scripts/kernel_shapes.py [--strip T,S,R ...] [--stencil T,R ...]

With no arguments it runs the shipped shapes and a few neighbours.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r'''
import statistics, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from tpufem_torch import _build
from tpufem_torch.fem import stencil, strip_op
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.structured import BoxTetMesh, compute_box_size_structured
from tpufem_torch.problems.common import poisson_bc_marker
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

kind, shape = {kind!r}, {shape!r}
if kind == "strip":
    T, S, R = shape
    _build.NVCC_FLAGS += (f"-DTPUFEM_STRIP_THREADS={{T}}",
                          f"-DTPUFEM_STRIP_SMALL_THREADS={{S}}",
                          f"-DTPUFEM_STRIP_RUN={{R}}")
    strip_op._APPLY_RUN = R
else:
    T, R = shape
    _build.NVCC_FLAGS += (f"-DTPUFEM_STENCIL_TILE={{T}}", f"-DTPUFEM_STENCIL_RUN={{R}}")
    stencil._TILE, stencil._RUN = T, R
dev = torch.device("cuda", 0)
_build.load()


def device_ms(fn, reps=30):
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def call_ms(fn, reps=50, samples=7):
    for _ in range(5):
        fn()
    ts = []
    for _ in range(samples):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record(); torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / reps)
    return statistics.median(ts)


def bc_dofs(mesh, order):
    return DirichletBC.from_space(
        FunctionSpace(mesh, order),
        mesh.locate_boundary_facets(poisson_bc_marker)).flat_dofs()

rng = np.random.default_rng(0)
if kind == "strip":
    for order, ndofs in ((3, 500000), (2, 500000), (3, 150000)):
        nx, ny, nz, _ = compute_box_size_structured(ndofs, True, 1, order, 1)
        mesh = BoxTetMesh(nx, ny, nz)
        dia = DiaOperator.try_const(mesh, order, "poisson",
                                    bc_dofs=bc_dofs(mesh, order),
                                    dtype=torch.float32)
        op = strip_op.StripOperator.from_dia(dia, dtype=torch.float32, device=dev)
        x = op.to_strips(torch.from_numpy(
            rng.standard_normal(op.layout.ndofs)).to(dev, torch.float32))
        y, yp = op.apply_strips(x), op.apply_strips_plain(x)
        err = float((y - yp).abs().max() / yp.abs().max())
        assert err < 2e-5, err
        run, staged = op.apply_shape(4)
        print(f"ROW strip_apply threads {{T}} (small blocks {{S}}) run {{R}} | P{{order}} "
              f"{{ndofs}} {{list(x.shape)}} runs of {{run}} delta weights staged "
              f"{{staged}} | device {{device_ms(lambda: op.apply_strips(x)):.4f}} ms, "
              f"per call {{call_ms(lambda: op.apply_strips(x)):.4f}} ms", flush=True)
else:
    nx, ny, nz, _ = compute_box_size_structured(500000, True, 1, 1, 1)
    cases = [((nx >> k, ny >> k, nz >> k), "const") for k in range(4)]
    cases.append(((nx, ny, nz), "dense"))
    for dims, mode in cases:
        mesh = BoxTetMesh(*dims)
        op = DiaOperator.build(mesh, 1, "poisson", bc_dofs=bc_dofs(mesh, 1),
                               dtype=torch.float32, mode=mode, device=dev)
        x = torch.from_numpy(rng.standard_normal(op.layout.ndofs)).to(
            dev, torch.float32)
        y = op.apply(x)
        yp = stencil.stencil_apply_plain(x, op.fields, op.offsets, op.grid_dims)
        err = float((y - yp).abs().max() / yp.abs().max())
        assert err < 1e-5, err
        print(f"ROW stencil_p1 tile {{T}} run {{R}} | grid "
              f"{{'x'.join(map(str, op.grid_dims))}} R={{op.fields.shape[1]}} | device "
              f"{{device_ms(lambda: op.apply(x)):.4f}} ms, per call "
              f"{{call_ms(lambda: op.apply(x)):.4f}} ms", flush=True)
'''


def ints(text):
    return tuple(int(v) for v in text.split(","))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strip", nargs="*", type=ints, default=None,
                    metavar="THREADS,SMALL,RUN")
    ap.add_argument("--stencil", nargs="*", type=ints, default=None,
                    metavar="TILE,RUN")
    args = ap.parse_args()
    if args.strip is None and args.stencil is None:
        args.strip = [(512, 256, 8), (512, 512, 8), (256, 256, 8), (128, 128, 8),
                      (512, 256, 4), (512, 256, 16)]
        args.stencil = [(256, 8), (128, 8), (256, 16), (256, 4)]
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for kind, shapes in (("strip", args.strip or []),
                         ("stencil", args.stencil or [])):
        for shape in shapes:
            out = subprocess.run(
                [sys.executable, "-c",
                 CHILD.format(root=ROOT, kind=kind, shape=tuple(shape))],
                capture_output=True, text=True)
            if out.returncode != 0:
                sys.stderr.write(out.stdout[-2000:] + out.stderr[-4000:])
                return out.returncode
            for line in out.stdout.splitlines():
                if line.startswith("ROW "):
                    print(f"{line[4:]}  [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
