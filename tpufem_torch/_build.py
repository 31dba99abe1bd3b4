"""Build and load the port's CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` of the package with ``nvcc``, one
process per source, all started together, links the objects into one
shared library with a plain C interface, at first use, and loads it
with ctypes.  The library lands in ``_build/<hash>/`` beside this file,
keyed by a hash of the sources, headers and flags, so an unchanged
checkout builds once.  Nothing here needs ninja or PyTorch's extension builder,
and a missing ``nvcc`` or a failed build raises with the compiler's
output.  Only the CUDA branch of a kernel wrapper imports this module.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libtpufem_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Bs3TableLaunch(ctypes.Structure):
    """What a launch of the three-component stencil needs
    beside x, y and the stream (csrc/stencil_p1.cu:Bs3TableLaunch): the
    table of distinct weight columns, the class bytes, the dims, the run,
    the segments of planes of one class pattern and the packed offsets,
    filled once per operator (fem.stencil.prepare_stencil_bs3)."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("table", "cls")]
                + [(k, ctypes.c_int)
                   for k in ("device", "Z", "Y", "X", "D", "C", "P", "run",
                             "per_point", "nseg")]
                + [("seg_z", ctypes.c_int * 9),
                   ("seg_first_run", ctypes.c_int * 9),
                   ("seg_pattern", ctypes.c_int * 8)]
                + [(k, ctypes.c_int8 * 27) for k in ("dx", "dy", "dz")])


class BrickFlatLaunch(ctypes.Structure):
    """What a brick-AMG level's flat stencil launch needs beside x, y and
    the stream (csrc/brick_flat.cu:BrickFlatLaunch): the fields, the
    plan, the dims and the tiling (la.brick_flat.brick_flat_tiling),
    filled once per level."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("F", "plan")]
                + [(k, ctypes.c_int)
                   for k in ("device", "az", "ay", "W", "nf", "rows", "lanes",
                             "reach", "threads")])


class CsrLaunch(ctypes.Structure):
    """What a CSR product needs beside x, y and the stream
    (csrc/csr_spmv.cu:CsrLaunch), filled once per matrix."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("indptr", "indices", "vals", "starts", "tile_row")]
                + [(k, ctypes.c_int)
                   for k in ("device", "n", "ncols", "nnz", "tiles")])


class DenseLaunch(ctypes.Structure):
    """What a bfloat16 dense level's product needs beside x, y and the
    stream (csrc/dense_gemv.cu:DenseLaunch), filled once per level."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("M", "partials")]
                + [(k, ctypes.c_int) for k in ("device", "n", "ld", "blocks")])


class DiaZonesLaunch(ctypes.Structure):
    """What a multi-kind DIA apply needs beside x, y and the stream
    (csrc/dia_zones.cu:DiaZonesLaunch), filled once per operator."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("F", "terms", "outputs", "kinds")]
                + [(k, ctypes.c_int)
                   for k in ("device", "nterms", "nout", "nkinds",
                             "max_terms", "max_points")])


class FlatLaunch(ctypes.Structure):
    """What a flat interior launch needs beside x, y and the stream
    (csrc/flat_interior.cu:FlatLaunch), filled once per operator."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("ptr", "ent", "val", "slot_of")]
                + [(k, ctypes.c_int)
                   for k in ("device", "CP", "Zc", "Zp", "LW", "TILE", "G",
                             "halo", "nnz", "nvar", "lanes")])


class MatfreeLaunch(ctypes.Structure):
    """What a matrix-free Poisson apply needs beside x, y and the stream
    (csrc/matfree_action.cu:MatfreeLaunch), filled once per operator."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("G6", "clusters", "gid", "ld", "sum_idx",
                           "sum_end", "halo_dof", "halo_off", "halo_src",
                           "partials")]
                + [(k, ctypes.c_int)
                   for k in ("device", "C", "n", "B", "K", "H",
                             "max_locals")])


class PermApplyLaunch(ctypes.Structure):
    """What a blocked per-perm apply needs beside x, y and the stream
    (csrc/perm_apply.cu:PermApplyLaunch), filled once per operator."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("W", "Y", "entries", "outputs", "sources",
                           "kinds", "chans", "mask", "bc")]
                + [(k, ctypes.c_int)
                   for k in ("device", "n", "ns", "nout", "nchan", "Nx", "Ny",
                             "Nz", "bx", "by", "bz", "max_points")])


class StencilLaunch(ctypes.Structure):
    """What a P1 stencil launch (scalar or three-component) needs beside
    x, y and the stream (csrc/stencil_p1.cu:StencilLaunch), filled once
    per operator."""

    _fields_ = ([("F", ctypes.c_void_p)]
                + [(k, ctypes.c_int)
                   for k in ("device", "Z", "Y", "X", "R", "D", "run")]
                + [(k, ctypes.c_int8 * 27) for k in ("dx", "dy", "dz")])


class StripLaunch(ctypes.Structure):
    """What a strip apply launch needs beside x, y and the stream
    (csrc/strip_apply.cu:StripLaunch), filled once per operator."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("mid", "dlt", "mid_ptr", "mid_ent", "dlt_ptr",
                           "dlt_ent", "zk", "order")]
                + [(k, ctypes.c_int)
                   for k in ("device", "C", "Zc", "Zp", "LW", "TILE", "G",
                             "halo", "nmid", "run", "dcap",
                             "stage_delta_weights")])


class TransferLaunch(ctypes.Structure):
    """What a GMG h-transfer needs beside its input, output and stream
    (csrc/gmg_transfer.cu:TransferLaunch): the fine and coarse Dirichlet
    masks (0: none), the device, the batch and the coarse vertex extents,
    filled once per level."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("fine_mask", "coarse_mask")]
                + [(k, ctypes.c_int) for k in ("device", "B", "Z", "Y", "X")])


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float   # 0.0 when the library was already built
    log: str               # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and under "
                       f"CUDA_HOME={CUDA_HOME!r}); the port's CUDA kernels "
                       "are built from tpufem_torch/csrc at first use")


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("tpufem_stencil_p1_f32", "tpufem_stencil_p1_f64",
                 "tpufem_stencil_p1_bs3_table_f32",
                 "tpufem_stencil_p1_bs3_table_f64"):
        fn = getattr(lib, name)
        # StencilLaunch* (Bs3TableLaunch* for the three-component form), x,
        # y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"tpufem_strip_apply_{suffix}")
        # StripLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(lib, f"tpufem_strip_cg_{suffix}")
        # device, b, mid, dlt, mid_ptr, mid_ent, dlt_ptr, dlt_ent, zk,
        # bricks, x, work, partials, it, rel, C, Zc, Zp, LW, TILE, G,
        # nbricks, halo, nmid, dcap, rtol2, maxit, nblk, stream
        fn.argtypes = ([ci] + [vp] * 14 + [ci] * 10
                       + [ctypes.c_double, ci, ci, vp])
        fn.restype = ci
        fn = getattr(lib, f"tpufem_strip_cg_blocks_{suffix}")
        # device, C, halo, nmid, dcap -> co-resident blocks, or -cuda error
        fn.argtypes = [ci] * 5
        fn.restype = ci
        fn = getattr(lib, f"tpufem_flat_interior_{suffix}")
        # FlatLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(lib, f"tpufem_brick_flat_{suffix}")
        # BrickFlatLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(lib, f"tpufem_dia_zones_{suffix}")
        # DiaZonesLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(lib, f"tpufem_perm_apply_{suffix}")
        # PermApplyLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(lib, f"tpufem_matfree_action_{suffix}")
        # MatfreeLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
        for kind in ("restrict", "prolong"):
            fn = getattr(lib, f"tpufem_gmg_{kind}_{suffix}")
            # TransferLaunch*, input, output, stream
            fn.argtypes = [vp] * 4
            fn.restype = ci
    for name in ("tpufem_csr_spmv_f32", "tpufem_csr_spmv_f64",
                 "tpufem_csr_spmv_bf16", "tpufem_dense_gemv_bf16"):
        fn = getattr(lib, name)
        # CsrLaunch* or DenseLaunch*, x, y, stream
        fn.argtypes = [vp] * 4
        fn.restype = ci
    # device, ld -> blocks of the dense kernel's persistent grid, or -error
    lib.tpufem_dense_gemv_grid.argtypes = [ci, ci]
    lib.tpufem_dense_gemv_grid.restype = ci
    # device, blocks, grid barriers, stream: the whole-CG kernel's grid
    # through the barriers alone
    lib.tpufem_strip_cg_sync_floor.argtypes = [ci, ci, ci, vp]
    lib.tpufem_strip_cg_sync_floor.restype = ci
    # shared memory of a block -> float32 blocks of the three-component
    # kernel with a thread a point resident on an SM, or -cuda error
    lib.tpufem_stencil_p1_bs3_blocks.argtypes = [ci]
    lib.tpufem_stencil_p1_bs3_blocks.restype = ci
    lib.tpufem_cuda_error_string.argtypes = [ci]
    lib.tpufem_cuda_error_string.restype = ctypes.c_char_p


def raw_stream_getter():
    """``device index -> the current stream's handle as an int``, without
    the Stream object of ``torch.cuda.current_stream``, which costs a
    prepared launch about as much host time as everything else in it."""
    import torch
    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is None:
        raise RuntimeError(
            "a prepared kernel launch needs "
            "torch._C._cuda_getCurrentRawStream (PyTorch 1.11 or later "
            f"built with CUDA); torch {torch.__version__} lacks it")
    return getter


def raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a kernel's C entry."""
    if rc != 0:
        msg = lib.tpufem_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} (cuda error {rc})")


@functools.lru_cache(maxsize=None)
def load() -> Kernels:
    """Build (if needed) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16] / LIB_NAME
    seconds, log = 0.0, ""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # build beside the target and rename: a concurrent loader never
        # sees a half-written library
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            objs = [os.path.join(tmp, s.stem + ".o") for s in sources]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                    for s, o in zip(sources, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            log = "".join(logs)
            for c, p, lg in zip(cmds, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                       f"{' '.join(c)}\n{lg}")
            tmp_lib = os.path.join(tmp, LIB_NAME)
            link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", tmp_lib, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                                   f"{' '.join(link)}\n{log}")
            os.replace(tmp_lib, out)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return Kernels(lib=lib, path=out, build_seconds=seconds, log=log)
