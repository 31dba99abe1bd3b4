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
plan table, the dims, the entry point) once and returns the launcher
``x -> y`` that a level keeps.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_FIELDS = 4096  # the kernel stages the plan in shared memory (16 B each)


def _check(x: torch.Tensor, fields: torch.Tensor,
           plan: Sequence[Tuple[int, int, int]],
           adims: Tuple[int, int, int], m: int) -> None:
    az, ay, ax = adims
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"brick flat apply takes float32/float64, got {x.dtype}")
    if fields.dtype != x.dtype or fields.device != x.device:
        raise TypeError(f"fields {fields.dtype}@{fields.device} do not match "
                        f"x {x.dtype}@{x.device}")
    if not (x.is_contiguous() and fields.is_contiguous()):
        raise ValueError("brick flat apply needs contiguous x and fields")
    if min(az, ay, ax, m) < 1 or x.shape != (az * ay * ax * m,):
        raise ValueError(f"x of shape {tuple(x.shape)} is not the flat "
                         f"{az}x{ay}x{ax * m} grid")
    if (fields.dim() != 4 or tuple(fields.shape[1:]) != (az, ay, ax * m)
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


def prepare_brick_flat(fields: torch.Tensor,
                       plan: Sequence[Tuple[int, int, int]],
                       adims: Tuple[int, int, int], m: int
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on CUDA ``fields``, with the
    fields' pointer, the plan table on the card, the dims and the entry
    point fixed once; a call checks x against them and passes x, y and
    the stream.  Counts its launches in ``brick_flat_apply.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    az, ay, ax = adims
    n = az * ay * ax * m
    # the plan as the kernel takes it: int32 [F, 3] rows (dz, dy, s)
    table = torch.from_numpy(
        np.asarray(plan, dtype=np.int32).reshape(-1, 3)).to(fields.device)
    fn = (lib.tpufem_brick_flat_f32 if fields.dtype == torch.float32
          else lib.tpufem_brick_flat_f64)
    args = _build.BrickFlatLaunch(F=fields.data_ptr(), plan=table.data_ptr(),
                                  device=fields.device.index, az=az, ay=ay,
                                  W=ax * m, nf=fields.shape[0])
    addr = ctypes.addressof(args)
    what = f"brick_flat on grid {az}x{ay}x{ax * m}, {fields.shape[0]} fields"
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
