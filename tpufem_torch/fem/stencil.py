"""P1 stencil apply: the CUDA kernel's wrapper and its plain PyTorch
version.

    y[z,y,x] = sum_d F[d, row(z), y, x] * x[z+dz_d, y+dy_d, x+dx_d]

over the zero-padded vertex grid (x read as 0 outside it).  ``F`` is a
[D, R, Y, X] weight-field stack: R == Z holds one full field per
diagonal; R == 7 holds the z-lo (3 planes), z-mid (1 plane, broadcast
along z) and z-hi (3 planes) zone fields of a const-mode operator, for
grids of at least 7 planes (fem.dia_op builds both forms).

Replaces the TPU kernels K1 ``stencil_apply_pallas_scalar``
(tpufem/fem/pallas_stencil.py:72, with its ``apply_corrections`` pass)
and K2 ``stencil_apply_pallas`` (pallas_stencil.py:185): the CUDA kernel
(csrc/stencil_p1.cu) computes the whole BC-eliminated operator in one
pass over x, so an apply is ONE launch.  It is bound by bytes: one read
of x, one write of y, and O(D * 7 * Y * X) weights that stay in L2 (the
source file's header has the numbers and the design).

``stencil_apply`` takes the plain version only for tensors that lie on
the CPU; for a CUDA tensor it launches the kernel or raises.
``prepare_stencil`` packs what does not change between the applies of
one operator (fields, dims, offsets, the entry point) once and returns
the launcher ``x -> y`` that fem.dia_op.DiaOperator keeps.

The three-component form (``stencil_apply_bs3``, ``prepare_stencil_bs3``;
the same source's ``tpufem_stencil_p1_bs3_*`` entry points) applies the
planar bs = 3 elasticity operator in ONE launch: x and y are [3, Z, Y,
X] component grids and F a [3 (output r), D, 3 (source s), R, Y, X]
stack,

    y_r[z,y,x] = sum_d sum_s F[r, d, s, row(z), y, x] * x_s[z+dz_d, ...]

in that order, which is the term order of tpufem's planar
``_apply_zones`` (tpufem/fem/dia_op.py:462-546, XLA there: tpufem has no
Pallas kernel for it).  Its kernel (csrc/stencil_p1.cu's
``stencil_p1_bs3_kernel``) gives a block 128 points of the flat plane x a
z run x the three output components; ``stencil_bs3_walk`` walks that
plan in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_DIAGONALS = 27
MAX_DIAGONALS_BS3 = 15  # the three-component form: P1's 15 diagonals
ZONE_ROWS = 7
_HALO = 3  # z-lo / z-hi zone planes
# a block of the kernel: 256 points of the flat (y, x) plane over a z run
# of at most 8 planes (csrc/stencil_p1.cu's kTile, kRun); of the
# three-component kernel 128 points x 4 planes x 3 output components
# (kTile3, kRun3); 227 KB of shared memory a block (sm_90)
_TILE, _RUN, _MAX_SMEM = 256, 8, 232448
_TILE3, _RUN3 = 128, 4


def _check(x: torch.Tensor, fields: torch.Tensor,
           offsets: Sequence[Tuple[int, int, int]],
           dims: Tuple[int, int, int], comps: int = 1) -> None:
    """``comps`` = 1 (scalar) or 3 (the three-component form: x holds
    three grids, fields 9 per diagonal, at most 15 diagonals)."""
    Z, Y, X = dims
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil apply takes float32/float64, got {x.dtype}")
    if fields.dtype != x.dtype or fields.device != x.device:
        raise TypeError(f"fields {fields.dtype}@{fields.device} do not match "
                        f"x {x.dtype}@{x.device}")
    if not (x.is_contiguous() and fields.is_contiguous()):
        raise ValueError("stencil apply needs contiguous x and fields")
    if min(Z, Y, X) < 1 or x.shape != (comps * Z * Y * X,):
        raise ValueError(f"x of shape {tuple(x.shape)} is not {comps} flat "
                         f"{Z}x{Y}x{X} grid(s)")
    if fields.dim() != 4 or tuple(fields.shape[2:]) != (Y, X):
        raise ValueError(f"fields of shape {tuple(fields.shape)} do not "
                         f"match the grid {Z}x{Y}x{X}")
    T, R = fields.shape[:2]
    D = T // (comps * comps)
    most = MAX_DIAGONALS if comps == 1 else MAX_DIAGONALS_BS3
    if (not 1 <= D <= most or len(offsets) != D
            or T != comps * comps * D):
        raise ValueError(f"{len(offsets)} offsets for {T} fields of "
                         f"{comps} component(s) (1..{most} diagonals)")
    if not (R == Z or (R == ZONE_ROWS and Z >= ZONE_ROWS)):
        raise ValueError(f"{R} field rows for a grid of {Z} planes "
                         f"(need {Z}, or {ZONE_ROWS} zones when Z >= 7)")
    if any(len(o) != 3 or any(v not in (-1, 0, 1) for v in o)
           for o in offsets):
        raise ValueError(f"offsets must lie in {{-1,0,1}}^3: {offsets}")


def stencil_apply_plain(x: torch.Tensor, fields: torch.Tensor,
                        offsets: Sequence[Tuple[int, int, int]],
                        dims: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version: a padded grid, D shifted slices and zone
    multiply-adds, in the term order of tpufem's ``_apply_zones``
    (tpufem/fem/dia_op.py:462-546)."""
    Z, Y, X = dims
    xp = F.pad(x.reshape(Z, Y, X), (1, 1, 1, 1, 1, 1))
    zones = fields.shape[1] != Z
    m = _HALO
    acc = None
    for d, (dx, dy, dz) in enumerate(offsets):
        src = xp[1 + dz: 1 + dz + Z, 1 + dy: 1 + dy + Y, 1 + dx: 1 + dx + X]
        w = fields[d]
        if zones:
            parts = (w[0:m] * src[0:m], w[m: m + 1] * src[m: Z - m],
                     w[m + 1:] * src[Z - m:])
        else:
            parts = (w * src,)
        acc = list(parts) if acc is None else [u + v for u, v in
                                                zip(acc, parts)]
    return torch.cat(acc).reshape(-1)


def stencil_apply_bs3_plain(x: torch.Tensor, fields: torch.Tensor,
                            offsets: Sequence[Tuple[int, int, int]],
                            dims: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of the three-component form: per output
    component r, the 3 D products summed in (d, s) order into one
    accumulator, zone by zone, as tpufem's planar ``_apply_zones`` sums
    its zone terms (the three r are one batched product)."""
    Z, Y, X = dims
    D = len(offsets)
    xp = F.pad(x.reshape(3, Z, Y, X), (1, 1, 1, 1, 1, 1))
    w3 = fields.reshape(3, D, 3, fields.shape[1], Y, X)
    zones = fields.shape[1] != Z
    m = _HALO
    acc = None
    for d, (dx, dy, dz) in enumerate(offsets):
        for s in range(3):
            src = xp[s, 1 + dz: 1 + dz + Z, 1 + dy: 1 + dy + Y,
                     1 + dx: 1 + dx + X]
            w = w3[:, d, s]  # [3 (r), R, Y, X]
            if zones:
                parts = (w[:, 0:m] * src[0:m], w[:, m: m + 1] * src[m: Z - m],
                         w[:, m + 1:] * src[Z - m:])
            else:
                parts = (w * src,)
            acc = list(parts) if acc is None else [u + v for u, v in
                                                    zip(acc, parts)]
    return torch.cat(acc, dim=1).reshape(-1)


def stencil_bs3_walk(x: torch.Tensor, fields: torch.Tensor,
                     offsets: Sequence[Tuple[int, int, int]],
                     dims: Tuple[int, int, int]
                     ) -> Tuple[torch.Tensor, dict]:
    """The three-component kernel's plan walked in plain PyTorch (the
    product and the sum rounded apart where the kernel fuses them): per
    block (tile of _TILE3 points of the flat plane, z run of
    ``stencil_runs``), the run's planes and one either side of the three
    source components staged once, [3, run + 2, _TILE3 + 2 (X + 1)],
    zeros beyond the grid; then for each output component r and point its
    sums over d ascending and s, one weight per (r, d, s) a run read from
    the run's field row, zero where the neighbour lies past its row's or
    the plane's end, applied to every plane of the run from the stage.
    Returns (y, counts): ``y`` NaN where no block wrote, and the counts of
    blocks, staged values, weight loads and the largest stage in bytes."""
    Z, Y, X = dims
    PS, H = Y * X, X + 1
    R = fields.shape[1]
    D = len(offsets)
    F3 = fields.reshape(3, D, 3, R, PS)
    xg = x.reshape(3, Z * PS)
    y = torch.full_like(x, float("nan")).reshape(3, Z, PS)
    zero = torch.zeros((), dtype=x.dtype)
    n = dict(blocks=0, staged=0, weight_loads=0, smem=0)
    for z0, nz in stencil_runs(dims, R, x.element_size(), comps=3).tolist():
        row = z0 if R == Z else (z0 if z0 < _HALO else (
            _HALO if z0 < Z - _HALO else _HALO + 1 + z0 - (Z - _HALO)))
        for p0 in range(0, PS, _TILE3):
            zz = torch.arange(z0 - 1, z0 + nz + 1)[:, None]
            q = torch.arange(p0 - H, p0 + _TILE3 + H)[None, :]
            ok = (zz >= 0) & (zz < Z) & (q >= 0) & (q < PS)
            stage = torch.where(ok, xg[:, (zz * PS + q).clamp(0, Z * PS - 1)],
                                zero)  # [3, nz + 2, _TILE3 + 2 H]
            n["staged"] += stage.numel()
            n["smem"] = max(n["smem"], stage.numel() * x.element_size())
            p = torch.arange(p0, min(p0 + _TILE3, PS))
            iy, ix = p // X, p % X
            t = p - p0
            for r in range(3):
                acc = torch.zeros((nz, len(p)), dtype=x.dtype)
                for d, (dx, dy, dz) in enumerate(offsets):
                    inside = ((iy + dy >= 0) & (iy + dy < Y)
                              & (ix + dx >= 0) & (ix + dx < X))
                    cols = H + t + dy * X + dx
                    for c in range(3):
                        w = torch.where(inside, F3[r, d, c, row, p], zero)
                        n["weight_loads"] += 1
                        acc = acc + w * stage[c, 1 + dz: 1 + dz + nz][:, cols]
                y[r, z0: z0 + nz, p] = acc
            n["blocks"] += 1
    return y.reshape(-1), n


def pack_offsets(offsets: Sequence[Tuple[int, int, int]]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The D (dx, dy, dz) triples as the kernel takes them: three int8
    arrays of MAX_DIAGONALS entries (dx, dy, dz), zero beyond D."""
    packed = np.zeros((3, MAX_DIAGONALS), dtype=np.int8)
    packed[:, :len(offsets)] = np.asarray(offsets, dtype=np.int8).T
    return packed[0], packed[1], packed[2]


def stencil_smem_bytes(run: int, X: int, itemsize: int,
                       comps: int = 1) -> int:
    """Shared memory of a block whose z run has ``run`` planes: the run
    and one plane either side, the block's points (_TILE, or _TILE3 for
    the three-component kernel) and X + 1 either side, of each of
    ``comps`` source components."""
    tile = _TILE if comps == 1 else _TILE3
    return (run + 2) * comps * (tile + 2 * (X + 1)) * itemsize


def stencil_runs(dims: Tuple[int, int, int], R: int, itemsize: int,
                 comps: int = 1) -> np.ndarray:
    """The z runs of the kernel's blocks, int32 [n, 2]: (first plane,
    planes); every plane of a run has the same field row.  Full fields
    (R == Z): a run per plane.  Zone form: each of the three z-lo and
    three z-hi planes is a run, and the mid zone is cut into the fewest
    runs of at most 8 planes, of equal length but the last; where the
    staged planes of that run do not fit a block's shared memory, into
    shorter ones (the three-component kernel: of at most _RUN3 planes)."""
    Z, _, X = dims
    most = _RUN if comps == 1 else _RUN3
    if stencil_smem_bytes(1, X, itemsize, comps) > _MAX_SMEM:
        raise RuntimeError(f"stencil_p1: three planes of "
                           f"{_TILE if comps == 1 else _TILE3} points with "
                           f"a halo of {X + 1} do not fit a block's shared "
                           "memory ("
                           f"{stencil_smem_bytes(1, X, itemsize, comps)} "
                           "bytes)")
    if R == Z:
        return np.array([(z, 1) for z in range(Z)], dtype=np.int32)
    m, mid = _HALO, Z - 2 * _HALO
    run = -(-mid // -(-mid // most))
    while stencil_smem_bytes(run, X, itemsize, comps) > _MAX_SMEM:
        run -= 1
    return np.array([(z, 1) for z in range(m)]
                    + [(z0, min(run, Z - m - z0))
                       for z0 in range(m, Z - m, run)]
                    + [(z, 1) for z in range(Z - m, Z)], dtype=np.int32)


def prepare_stencil(fields: torch.Tensor,
                    offsets: Sequence[Tuple[int, int, int]],
                    dims: Tuple[int, int, int]
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on CUDA ``fields``, with the
    fields' pointer, the dims, the packed offsets and the entry point
    fixed once; a call checks x against them and passes x, y and the
    stream.  Counts its launches in ``stencil_apply.launches``."""
    return _prepare(fields, offsets, dims, 1, stencil_apply)


def prepare_stencil_bs3(fields: torch.Tensor,
                        offsets: Sequence[Tuple[int, int, int]],
                        dims: Tuple[int, int, int]
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``prepare_stencil`` for the three-component form; counts its
    launches in ``stencil_apply_bs3.launches``."""
    return _prepare(fields, offsets, dims, 3, stencil_apply_bs3)


def _prepare(fields, offsets, dims, comps: int, counted):
    from tpufem_torch import _build
    lib = _build.load().lib
    Z, Y, X = dims
    T, R = fields.shape[:2]
    D = T // (comps * comps)
    n = comps * Z * Y * X
    name = "stencil_p1" if comps == 1 else "stencil_p1_bs3"
    fn = getattr(lib, f"tpufem_{name}_"
                 + ("f32" if fields.dtype == torch.float32 else "f64"))
    args = _build.StencilLaunch(F=fields.data_ptr(),
                                device=fields.device.index, Z=Z, Y=Y, X=X,
                                R=R, D=D, run=int(stencil_runs(
                                    dims, R, fields.element_size(), comps)
                                    [:, 1].max()))
    for key, col in zip(("dx", "dy", "dz"), pack_offsets(offsets)):
        getattr(args, key)[:] = col.tolist()
    addr = ctypes.addressof(args)
    what = f"{name} on grid {Z}x{Y}x{X}, D={D}, R={R}"
    raw_stream = _build.raw_stream_getter()
    dtype, device, index = fields.dtype, fields.device, fields.device.index

    def launch(x: torch.Tensor) -> torch.Tensor:
        if (x.dtype != dtype or x.device != device or x.shape != (n,)
                or not x.is_contiguous()):
            raise ValueError(f"{what}: x is {tuple(x.shape)} {x.dtype}@"
                             f"{x.device}, expected a contiguous ({n},) "
                             f"{dtype}@{device}")
        y = torch.empty_like(x)
        rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
        if rc != 0:
            _build.raise_on(lib, rc, what)
        counted.launches += 1
        return y

    launch.keep = (args, fields)  # what ``addr`` points into
    return launch


def stencil_apply(x: torch.Tensor, fields: torch.Tensor,
                  offsets: Sequence[Tuple[int, int, int]],
                  dims: Tuple[int, int, int]) -> torch.Tensor:
    """y = stencil(x) for a flat x of the grid ``dims`` = (Z, Y, X).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``stencil_apply.launches``).  Anything else
    raises."""
    _check(x, fields, offsets, dims)
    if x.device.type == "cpu":
        return stencil_apply_plain(x, fields, offsets, dims)
    if x.device.type != "cuda":
        raise RuntimeError(f"no stencil kernel for device {x.device}")
    return prepare_stencil(fields, offsets, dims)(x)


stencil_apply.launches = 0


def stencil_apply_bs3(x: torch.Tensor, fields: torch.Tensor,
                      offsets: Sequence[Tuple[int, int, int]],
                      dims: Tuple[int, int, int]) -> torch.Tensor:
    """y = the three-component stencil of x, planar [3 * Z*Y*X].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``stencil_apply_bs3.launches``).  Anything
    else raises."""
    _check(x, fields, offsets, dims, comps=3)
    if x.device.type == "cpu":
        return stencil_apply_bs3_plain(x, fields, offsets, dims)
    if x.device.type != "cuda":
        raise RuntimeError(f"no stencil kernel for device {x.device}")
    return prepare_stencil_bs3(fields, offsets, dims)(x)


stencil_apply_bs3.launches = 0
