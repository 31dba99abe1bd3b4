"""Flat stencil apply of a brick-AMG level: the CUDA kernel's wrapper and
its plain PyTorch version.

A brick-AMG coarse level (la.bramg) is a 27-point block stencil with
m x m blocks on its [az, ay, ax] node lattice, flattened to scalar
shift-diagonals on the [az, ay, ax * m] grid (flat minor index x' = x * m
+ i).  With F weight fields stacked as one [F, az, ay, ax * m] tensor and
the plan's (dz, dy, s) shifts,

    y[z, y, x'] = sum_k F[k, z, y, x'] * x[z + dz_k, y + dy_k, x' + s_k]

with x read as 0 outside the grid, and the terms summed in plan order
(the first term, then each next one added), as tpufem's ``flat_apply``
(tpufem/la/bramg.py:163-175, XLA there: tpufem has no Pallas kernel for
it) sums them.  m = 1 gives 27 fields; m = 6 (elasticity's rigid-body
modes) up to 9 (4m - 1) = 207.

``brick_flat_apply`` takes the plain version only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel of
csrc/brick_flat.cu (one launch an apply, counted in
``brick_flat_apply.launches``) or raises.  ``prepare_brick_flat`` packs
what does not change between the applies of one level (the fields, the
plan table, the dims, the tiling, the entry point) once and returns the
launcher ``x -> y`` that a level keeps.  ``brick_flat_tiling`` is the
kernel's tiling of a level (a block a tile of rows x lanes of one plane)
and ``brick_flat_walk`` walks it in plain PyTorch with the kernel's
staging and order (tests/test_torch_brick_flat_plan.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_FIELDS = 4096  # a block keeps an int32 a term in shared memory
# the kernel's tiling (csrc/brick_flat.cu): a tile is `rows` rows x `lanes`
# lanes of one plane, the whole row where W <= MAX_LANES, and as many rows
# (at most MAX_POINTS points) as leave MIN_BLOCKS blocks: two an SM of an
# H100's 132; a thread a point
MAX_LANES = 128
MAX_POINTS = 128
MIN_BLOCKS = 264


def _check_level(fields: torch.Tensor,
                 plan: Sequence[Tuple[int, int, int]],
                 adims: Tuple[int, int, int], m: int) -> None:
    """Refuses fields and a plan that do not make a level the kernel can
    apply: every shift within the box it stages (|dz|, |dy| <= 1, |s| <=
    2m - 1)."""
    az, ay, ax = adims
    if fields.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"brick flat apply takes float32/float64, got "
                        f"{fields.dtype}")
    if not fields.is_contiguous():
        raise ValueError("brick flat apply needs contiguous fields")
    if (min(az, ay, ax, m) < 1 or fields.dim() != 4
            or tuple(fields.shape[1:]) != (az, ay, ax * m)
            or not 1 <= fields.shape[0] <= MAX_FIELDS
            or len(plan) != fields.shape[0]):
        raise ValueError(f"fields of shape {tuple(fields.shape)} and a plan of "
                         f"{len(plan)} entries do not match the grid "
                         f"{az}x{ay}x{ax * m} (1..{MAX_FIELDS} fields)")
    reach = 2 * m - 1
    if any(len(e) != 3 or abs(e[0]) > 1 or abs(e[1]) > 1 or abs(e[2]) > reach
           for e in plan):
        raise ValueError(f"plan entries must be (dz, dy, s) with |dz|, |dy| "
                         f"<= 1 and |s| <= {reach}")


def _check(x: torch.Tensor, fields: torch.Tensor,
           plan: Sequence[Tuple[int, int, int]],
           adims: Tuple[int, int, int], m: int) -> None:
    _check_level(fields, plan, adims, m)
    if x.dtype != fields.dtype or x.device != fields.device:
        raise TypeError(f"x {x.dtype}@{x.device} does not match the fields "
                        f"{fields.dtype}@{fields.device}")
    if not x.is_contiguous() or x.shape != (fields[0].numel(),):
        raise ValueError(f"x of shape {tuple(x.shape)} is not the contiguous "
                         f"flat {'x'.join(map(str, fields.shape[1:]))} grid")


def brick_flat_apply_plain(x: torch.Tensor, fields: torch.Tensor,
                           plan: Sequence[Tuple[int, int, int]],
                           adims: Tuple[int, int, int], m: int) -> torch.Tensor:
    """Plain PyTorch version: a padded grid and one shifted-slice product
    per field, summed in plan order (tpufem's ``flat_apply``)."""
    az, ay, ax = adims
    W = ax * m
    P = 2 * m - 1 if m > 1 else 1
    xp = F.pad(x.reshape(az, ay, W), (P, P, 1, 1, 1, 1))
    out = None
    for (dz, dy, s), f in zip(plan, fields):
        t = f * xp[1 + dz: 1 + dz + az, 1 + dy: 1 + dy + ay,
                   P + s: P + s + W]
        out = t if out is None else out + t
    return out.reshape(-1)


@dataclasses.dataclass(frozen=True)
class BrickFlatTiling:
    """The kernel's blocks on a level: a tile of ``rows`` rows x ``lanes``
    lanes of one plane (rows > 1 only where lanes = W), ``ytiles`` x
    ``xtiles`` tiles a plane, ``blocks`` in all, ``reach`` halo lanes
    either side, a block of ``threads`` threads, one a point."""

    rows: int
    lanes: int
    reach: int
    threads: int
    ytiles: int
    xtiles: int
    blocks: int


def brick_flat_tiling(adims: Tuple[int, int, int], m: int
                      ) -> BrickFlatTiling:
    """The kernel's tiling of a level (see MAX_LANES, MAX_POINTS,
    MIN_BLOCKS): the most rows of whole rows that still leave MIN_BLOCKS
    blocks, or strips of MAX_LANES lanes of single rows where W is
    wider."""
    az, ay, ax = adims
    W = ax * m
    lanes = min(W, MAX_LANES)
    xtiles = -(-W // lanes)
    rows = 1
    if lanes == W:
        rows = max(1, min(ay, MAX_POINTS // W))
        while rows > 1 and az * -(-ay // rows) < MIN_BLOCKS:
            rows -= 1
    ytiles = -(-ay // rows)
    return BrickFlatTiling(rows=rows, lanes=lanes,
                           reach=2 * m - 1,
                           threads=32 * -(-rows * lanes // 32),
                           ytiles=ytiles, xtiles=xtiles,
                           blocks=az * ytiles * xtiles)


def brick_flat_walk(x: torch.Tensor, fields: torch.Tensor,
                    plan: Sequence[Tuple[int, int, int]],
                    adims: Tuple[int, int, int], m: int
                    ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The kernel's tiling walked in plain PyTorch, with its staging and
    its roundings: for each block (z, row tile, lane tile), the box of x
    (the planes either side, a row either side, ``reach`` lanes either
    side, zeros outside the grid); each thread's point sums the terms in
    plan order from -0.0, the product and the sum rounded apart, each
    field read at the point's place in the tile's run and x at the term's
    offset in the box (a thread past the run's end on the run's last
    point); the tile's points inside the grid stored.  Returns (y,
    counts): ``y`` NaN where no block wrote, and the counts of blocks and
    of points written twice."""
    az, ay, ax = adims
    W = ax * m
    n = az * ay * W
    t = brick_flat_tiling(adims, m)
    flat_f = fields.reshape(-1)
    xg = x.reshape(az, ay, W)
    rows, lanes, R = t.rows, t.lanes, t.reach
    bx, brow, P = lanes + 2 * R, rows + 2, rows * lanes
    tid = torch.arange(t.threads)
    y = torch.full_like(x, float("nan"))
    seen = torch.zeros(x.shape, dtype=torch.bool)
    counts = dict(blocks=0, twice=0)
    for z in range(az):
        for ty in range(t.ytiles):
            for tx in range(t.xtiles):
                y0, x0 = ty * rows, tx * lanes
                vrows, vlanes = min(rows, ay - y0), min(lanes, W - x0)
                p0 = (z * ay + y0) * W + x0
                run = (vrows - 1) * lanes + vlanes
                lj = torch.clamp(tid, max=run - 1)  # a thread's point
                xb = lj // lanes * bx + lj % lanes
                box = torch.zeros(3, brow, bx, dtype=x.dtype)
                for pz in range(3):
                    for py in range(brow):
                        gz, gy = z + pz - 1, y0 + py - 1
                        if 0 <= gz < az and 0 <= gy < ay:
                            lo, hi = max(0, x0 - R), min(W, x0 - R + bx)
                            box[pz, py, lo - (x0 - R): hi - (x0 - R)] = \
                                xg[gz, gy, lo:hi]
                box = box.reshape(-1)
                acc = torch.full(lj.shape, -0.0, dtype=x.dtype)
                for k, (dz, dy, s) in enumerate(plan):
                    xoff = ((1 + dz) * brow + 1 + dy) * bx + R + s
                    acc = acc + flat_f[k * n + p0 + lj] * box[xb + xoff]
                ok = (tid < P) & (tid // lanes < vrows) & (tid % lanes < vlanes)
                where = p0 + tid[ok]
                counts["twice"] += int(seen[where].sum())
                seen[where] = True
                y[where] = acc[ok]
                counts["blocks"] += 1
    return y, counts


def prepare_brick_flat(fields: torch.Tensor,
                       plan: Sequence[Tuple[int, int, int]],
                       adims: Tuple[int, int, int], m: int
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on CUDA ``fields``, with the
    fields' pointer, the plan table on the card, the dims,
    brick_flat_tiling's tiling and the entry point fixed once; a call
    checks x against them and passes x, y and the stream.  Counts its
    launches in ``brick_flat_apply.launches``.  Refuses fields and a plan
    that brick_flat_apply would refuse, and fields off the card."""
    _check_level(fields, plan, adims, m)
    if fields.device.type != "cuda":
        raise RuntimeError(f"no brick flat kernel for device {fields.device}")
    from tpufem_torch import _build
    lib = _build.load().lib
    az, ay, ax = adims
    n = az * ay * ax * m
    # the plan as the kernel takes it: int32 [F, 3] rows (dz, dy, s)
    table = torch.from_numpy(
        np.asarray(plan, dtype=np.int32).reshape(-1, 3)).to(fields.device)
    fn = (lib.tpufem_brick_flat_f32 if fields.dtype == torch.float32
          else lib.tpufem_brick_flat_f64)
    t = brick_flat_tiling(adims, m)
    args = _build.BrickFlatLaunch(F=fields.data_ptr(), plan=table.data_ptr(),
                                  device=fields.device.index, az=az, ay=ay,
                                  W=ax * m, nf=fields.shape[0], rows=t.rows,
                                  lanes=t.lanes, reach=t.reach,
                                  threads=t.threads)
    addr = ctypes.addressof(args)
    what = (f"brick_flat on grid {az}x{ay}x{ax * m}, {fields.shape[0]} "
            f"fields, tiles of {t.rows}x{t.lanes}")
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
        brick_flat_apply.launches += 1
        return y

    launch.keep = (args, fields, table)  # what ``addr`` points into
    return launch


def brick_flat_apply(x: torch.Tensor, fields: torch.Tensor,
                     plan: Sequence[Tuple[int, int, int]],
                     adims: Tuple[int, int, int], m: int) -> torch.Tensor:
    """y = the level's flat stencil of x, flat [az * ay * ax * m].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``brick_flat_apply.launches``).  Anything
    else raises."""
    _check(x, fields, plan, adims, m)
    if x.device.type == "cpu":
        return brick_flat_apply_plain(x, fields, plan, adims, m)
    if x.device.type != "cuda":
        raise RuntimeError(f"no brick flat kernel for device {x.device}")
    return prepare_brick_flat(fields, plan, adims, m)(x)


brick_flat_apply.launches = 0
