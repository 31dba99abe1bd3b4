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
the same source's ``tpufem_stencil_p1_bs3_table_*`` entry points)
applies the planar bs = 3 elasticity operator in ONE launch: x and y are
[3, Z, Y, X] component grids and F a [3 (output r), D, 3 (source s), R,
Y, X] stack,

    y_r[z,y,x] = sum_d sum_s F[r, d, s, row(z), y, x] * x_s[z+dz_d, ...]

in that order, which is the term order of tpufem's planar
``_apply_zones`` (tpufem/fem/dia_op.py:462-546, XLA there: tpufem has no
Pallas kernel for it).  Its kernels (csrc/stencil_p1.cu) give a block a
tile of the flat plane x a z run x the three output components;
``stencil_bs3_walk`` walks that plan in plain PyTorch.

The kernels do not read the fields.  The port's three-component
operators have constant coefficients, and their 135 zone fields carry
few distinct 135-weight columns (28 for P1 elasticity: 10 a zone row,
and rows 1 to 5 alike), so ``prepare_stencil_bs3`` has ``compress_bs3``
rewrite them exactly, once per operator, as a table of those columns and
a class byte a point (``Bs3Table``), and the kernels read a point's
weights from the table, which stays in L1.  On large grids
(``stencil_bs3_plan``) a thread is a point and its three output
components (``stencil_p1_bs3_table_kernel``), and the Kuhn stencil's
shifts (``P1_OFFSETS``) are compiled in, so a neighbour value two shifts
share is loaded once; where the blocks fit one wave of the card a thread
is an output component (``stencil_p1_bs3_kernel``).  At 161x161x129 (the
10M-dof elasticity grid) a kernel that read the fields loaded about 507
MB of weights an apply, 6.3 times x and y, and took 0.2556 ms; the
table's takes 0.094 ms against a bound of 0.0240 (x and y once, with
the table and class bytes).  Fields with more distinct columns than
``MAX_CLASSES_BS3`` or more segments of planes than ``MAX_SEGMENTS_BS3``
(a variable coefficient), or other shifts, have no kernel: the wrapper
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

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
# the three-component table: its most distinct weight columns and
# segments of planes of one class pattern (csrc/stencil_p1.cu's
# kMaxSegments; kMaxClasses is the byte's 256, this cap keeps the table in
# a few tens of KB of L1); the block of the kernel with a thread a point,
# 512 points (kTileT); the SMs of an H100, where the plan is made without a
# card; the shifts the kernels are built for, the Kuhn lattice's 15 in
# ascending (dx, dy, dz) order
MAX_CLASSES_BS3, MAX_SEGMENTS_BS3 = 64, 8
_TILE3T, _H100_SMS = 512, 132
P1_OFFSETS = ((-1, -1, -1), (-1, -1, 0), (-1, 0, -1), (-1, 0, 0),
              (0, -1, -1), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
              (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0),
              (1, 1, 1))


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


@dataclasses.dataclass(frozen=True)
class Bs3Table:
    """The three-component fields [3, D, 3, R, Y, X] rewritten exactly:
    ``table`` [C, 3, D, 3], the C distinct 135-weight columns (the
    fields' own bits); ``classes`` [P, Y, X] uint8, the column of each
    point under each of the P distinct row patterns; ``segments``, the
    planes in runs of one pattern, (first plane, end plane, pattern), in
    z order.  Plane z of pattern q holds ``table[classes[q]]``."""

    table: torch.Tensor
    classes: torch.Tensor
    segments: Tuple[Tuple[int, int, int], ...]


def _field_rows(Z: int, R: int) -> List[int]:
    """The field row of each plane: its own (R == Z), or its zone's."""
    if R == Z:
        return list(range(Z))
    return [z if z < _HALO else (_HALO if z < Z - _HALO
                                 else _HALO + 1 + z - (Z - _HALO))
            for z in range(Z)]


def compress_bs3(fields: torch.Tensor, dims: Tuple[int, int, int],
                 device: Optional[torch.device] = None) -> Bs3Table:
    """The fields' ``Bs3Table`` on ``device`` (None: the fields'; the
    fields on the host spare a copy back from the card); raises ValueError
    where they hold more than MAX_CLASSES_BS3 distinct columns or
    MAX_SEGMENTS_BS3 segments (a variable coefficient, which no operator
    of the port has).  On the host, in O(fields), by the columns' bits: a
    point whose column is its predecessor's (in the flat (row, y, x)
    order) bit for bit is of its class, so only the first point of each
    run of equal columns (3,367 of the 145,383 points of the 10M cell's
    grid) is sorted among the others; the R rows of classes are told
    apart row against row.  (On the card a sort first loads its kernels:
    0.24-0.29 s in a fresh process.)"""
    Z, Y, X = dims
    T, R = fields.shape[:2]
    bits = fields.detach().cpu().view(
        torch.int32 if fields.element_size() == 4 else torch.int64
    ).reshape(T, R * Y * X).numpy()
    head = np.ones(bits.shape[1], dtype=bool)
    np.any(bits[:, 1:] != bits[:, :-1], axis=0, out=head[1:])
    heads = np.ascontiguousarray(bits[:, head].T)  # [runs, T]
    _, first, of_head = np.unique(
        heads.view(np.dtype((np.void, T * heads.itemsize))).ravel(),
        return_index=True, return_inverse=True)
    if len(first) > MAX_CLASSES_BS3:
        raise ValueError(f"the three-component fields hold {len(first)} "
                         f"distinct weight columns, over the table's "
                         f"{MAX_CLASSES_BS3}")
    col = of_head.reshape(-1)[np.cumsum(head) - 1].reshape(R, Y * X)
    firsts: List[int] = []  # the first row of each pattern
    rows = []
    for r in range(R):
        q = next((i for i, f in enumerate(firsts)
                  if np.array_equal(col[f], col[r])), len(firsts))
        firsts += [r] if q == len(firsts) else []
        rows.append(q)
    segments: List[List[int]] = []
    for z, row in enumerate(_field_rows(Z, R)):
        if segments and segments[-1][2] == rows[row]:
            segments[-1][1] = z + 1
        else:
            segments.append([z, z + 1, rows[row]])
    if len(segments) > MAX_SEGMENTS_BS3:
        raise ValueError(f"the three-component fields' planes make "
                         f"{len(segments)} segments of one class pattern, "
                         f"over the kernels' {MAX_SEGMENTS_BS3}")
    device = fields.device if device is None else device
    table = torch.from_numpy(heads[first]).view(fields.dtype)
    return Bs3Table(
        table=table.reshape(len(first), 3, T // 9, 3).to(device),
        classes=torch.from_numpy(col[firsts].astype(np.uint8))
        .reshape(-1, Y, X).to(device),
        segments=tuple(tuple(g) for g in segments))


def bs3_table_smem_bytes(run: int, X: int, itemsize: int) -> int:
    """Shared memory of a block of the three-component kernel with a thread
    a point, whose runs have at most ``run`` planes: run + 2 planes of the
    three source components, _TILE3T points and X + 1 either side."""
    return (run + 2) * 3 * (_TILE3T + 2 * (X + 1)) * itemsize


def bs3_table_run(dims: Tuple[int, int, int], itemsize: int,
                  per_point: bool) -> int:
    """The kernels' longest run: _RUN3 planes, or fewer where their
    stage would not fit a block's shared memory (0: not one plane), for
    its kernel with a thread a point (``per_point``) or an output."""
    X = dims[2]
    run = _RUN3
    while run and (bs3_table_smem_bytes(run, X, itemsize) if per_point
                   else stencil_smem_bytes(run, X, itemsize, 3)) > _MAX_SMEM:
        run -= 1
    return run


@dataclasses.dataclass(frozen=True)
class Bs3Plan:
    """How the three-component kernels cover a grid: the ``table``,
    ``per_point`` (the kernel with a thread a point, else a thread an
    output component), the points of a block (``tile``), the most planes
    of a run (``run``), the z runs, (first plane, planes, the run's class
    pattern), and a block's shared memory in bytes."""

    table: Bs3Table
    per_point: bool
    tile: int
    run: int
    runs: List[Tuple[int, int, int]]
    smem: int


def _segment_runs(packed: Bs3Table, run: int) -> List[Tuple[int, int, int]]:
    return [(z0, min(run, z1 - z0), q) for s0, z1, q in packed.segments
            for z0 in range(s0, z1, run)]


def stencil_bs3_plan(fields: torch.Tensor,
                     offsets: Sequence[Tuple[int, int, int]],
                     dims: Tuple[int, int, int],
                     sms: Optional[int] = None,
                     table: Optional[Bs3Table] = None) -> Bs3Plan:
    """The three-component kernels' plan for ``fields`` on a card of
    ``sms`` SMs (None: the fields' card's, or an H100's): the fields'
    ``compress_bs3`` table (``table``, where the caller has it), its runs its segments' cut to
    ``bs3_table_run``; the kernel with a thread an output component
    (tiles of _TILE3) while those blocks fit one wave of the card, two an
    SM (then each block's latency is the time, and a thread with a third
    of a point's work is done sooner), else the kernel with a thread a
    point (tiles of _TILE3T), which loads a plane's neighbours once for
    the three components.  Raises ValueError for shifts other than
    ``P1_OFFSETS``, fields ``compress_bs3`` refuses, or a grid so wide
    that one plane's stage does not fit a block."""
    Z, Y, X = dims
    item = fields.element_size()
    if tuple(map(tuple, offsets)) != P1_OFFSETS:
        raise ValueError("the three-component kernels are built for the "
                         "Kuhn lattice's 15 shifts (P1_OFFSETS)")
    packed = compress_bs3(fields, dims) if table is None else table
    if sms is None:
        sms = (torch.cuda.get_device_properties(fields.device)
               .multi_processor_count if fields.device.type == "cuda"
               else _H100_SMS)
    run = bs3_table_run(dims, item, False)
    wide = bs3_table_run(dims, item, True)
    if wide and (not run or -(-(Y * X) // _TILE3)
                 * len(_segment_runs(packed, run)) > 2 * sms):
        return Bs3Plan(packed, True, _TILE3T, wide,
                       _segment_runs(packed, wide),
                       bs3_table_smem_bytes(wide, X, item))
    if not run:
        raise ValueError(f"grid {Z}x{Y}x{X}: one plane of the three "
                         f"components' stage does not fit a block's "
                         f"shared memory")
    return Bs3Plan(packed, False, _TILE3, run, _segment_runs(packed, run),
                   stencil_smem_bytes(run, X, item, comps=3))


def stencil_bs3_counts(fields: torch.Tensor,
                       offsets: Sequence[Tuple[int, int, int]],
                       dims: Tuple[int, int, int],
                       sms: Optional[int] = None) -> dict:
    """The counts ``stencil_bs3_walk`` makes, without the walk: the
    blocks, the staged values, the weight values the blocks load (one a
    class among the block's points and (r, d, s) term, which its warps
    read as broadcasts of the one table) and a block's shared memory in
    bytes."""
    Z, Y, X = dims
    PS, H = Y * X, X + 1
    T = fields.shape[0]
    plan = stencil_bs3_plan(fields, offsets, dims, sms)
    tiles = -(-PS // plan.tile)
    n = dict(blocks=tiles * len(plan.runs), smem=plan.smem,
             staged=sum(tiles * 3 * (nz + 2) * (plan.tile + 2 * H)
                        for _, nz, _ in plan.runs))
    # the distinct classes in each tile, summed over a pattern's tiles
    cls = F.pad(plan.table.classes.reshape(-1, PS).long() + 1,
                (0, tiles * plan.tile - PS)).reshape(-1, tiles, plan.tile)
    seen = torch.zeros(cls.shape[:2] + (MAX_CLASSES_BS3 + 1,),
                       dtype=torch.bool, device=cls.device)
    seen.scatter_(2, cls, True)
    per_tile = seen[..., 1:].sum((1, 2)).tolist()
    n["weight_loads"] = T * sum(per_tile[q] for _, _, q in plan.runs)
    return n


def stencil_bs3_walk(x: torch.Tensor, fields: torch.Tensor,
                     offsets: Sequence[Tuple[int, int, int]],
                     dims: Tuple[int, int, int], sms: Optional[int] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """The three-component kernels' plan (``stencil_bs3_plan`` on a card
    of ``sms`` SMs) walked in plain PyTorch (the product and the sum
    rounded apart where the kernel fuses them): per block (tile of the
    plan's points of the flat plane, z run), the run's planes and one
    either side of the three source components staged once, [3, run + 2,
    tile + 2 (X + 1)], zeros beyond the grid; then for each output
    component r and point its sums over d ascending and s, one weight per
    (r, d, s) a run, read from the table's column of the point's class
    under the run's pattern, zero where the neighbour lies past its row's
    or the plane's end, applied to every plane of the run from the stage.
    Returns (y, counts): ``y`` NaN where no block wrote, and the counts of
    ``stencil_bs3_counts``, counted as the blocks go."""
    Z, Y, X = dims
    PS, H = Y * X, X + 1
    plan = stencil_bs3_plan(fields, offsets, dims, sms)
    packed, tile = plan.table, plan.tile
    # [patterns, PS, 3, D, 3]
    W = packed.table[packed.classes.reshape(-1, PS).long()]
    xg = x.reshape(3, Z * PS)
    y = torch.full_like(x, float("nan")).reshape(3, Z, PS)
    zero = torch.zeros((), dtype=x.dtype)
    n = dict(blocks=0, staged=0, weight_loads=0, smem=plan.smem)
    for z0, nz, key in plan.runs:
        for p0 in range(0, PS, tile):
            zz = torch.arange(z0 - 1, z0 + nz + 1)[:, None]
            q = torch.arange(p0 - H, p0 + tile + H)[None, :]
            ok = (zz >= 0) & (zz < Z) & (q >= 0) & (q < PS)
            stage = torch.where(ok, xg[:, (zz * PS + q).clamp(0, Z * PS - 1)],
                                zero)  # [3, nz + 2, tile + 2 H]
            n["staged"] += stage.numel()
            p = torch.arange(p0, min(p0 + tile, PS))
            iy, ix = p // X, p % X
            t = p - p0
            loads = len(torch.unique(packed.classes.reshape(-1, PS)[key, p]))
            for r in range(3):
                acc = torch.zeros((nz, len(p)), dtype=x.dtype)
                for d, (dx, dy, dz) in enumerate(offsets):
                    inside = ((iy + dy >= 0) & (iy + dy < Y)
                              & (ix + dx >= 0) & (ix + dx < X))
                    cols = H + t + dy * X + dx
                    for c in range(3):
                        w = torch.where(inside, W[key, p, r, d, c], zero)
                        n["weight_loads"] += loads
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
                        dims: Tuple[int, int, int], sms: Optional[int] = None,
                        table: Optional[Bs3Table] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``prepare_stencil`` for the three-component form: the fields'
    table (``table``, where the caller has it) and the kernel
    ``stencil_bs3_plan`` picks for a card of ``sms`` SMs (None: the
    fields' card's; ValueError where it refuses them); the launcher's
    ``table`` is the ``Bs3Table``.  Counts its launches in
    ``stencil_apply_bs3.launches``."""
    plan = stencil_bs3_plan(fields, offsets, dims, sms, table)
    from tpufem_torch import _build
    lib = _build.load().lib
    Z, Y, X = dims
    packed, segs = plan.table, plan.table.segments
    n = 3 * Z * Y * X
    fn = getattr(lib, "tpufem_stencil_p1_bs3_table_"
                 + ("f32" if fields.dtype == torch.float32 else "f64"))
    args = _build.Bs3TableLaunch(
        table=packed.table.data_ptr(), cls=packed.classes.data_ptr(),
        device=fields.device.index, Z=Z, Y=Y, X=X, D=len(offsets),
        C=packed.table.shape[0], P=packed.classes.shape[0], run=plan.run,
        per_point=int(plan.per_point), nseg=len(segs))
    pad = MAX_SEGMENTS_BS3 - len(segs)
    args.seg_z[:] = [s0 for s0, _, _ in segs] + [Z] + [0] * pad
    args.seg_first_run[:] = np.cumsum(
        [0] + [-(-(z1 - s0) // plan.run) for s0, z1, _ in segs]).tolist() \
        + [0] * pad
    args.seg_pattern[:] = [q for _, _, q in segs] + [0] * pad
    for key, col in zip(("dx", "dy", "dz"), pack_offsets(offsets)):
        getattr(args, key)[:] = col.tolist()
    addr = ctypes.addressof(args)
    what = (f"stencil_p1_bs3 ({packed.table.shape[0]} weight columns, a "
            f"thread {'a point' if plan.per_point else 'an output'}) on "
            f"grid {Z}x{Y}x{X}")
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
        stencil_apply_bs3.launches += 1
        return y

    launch.keep = (args, packed)  # what ``addr`` points into
    launch.table = packed
    return launch


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
