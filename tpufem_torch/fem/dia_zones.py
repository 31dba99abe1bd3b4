"""Apply of the multi-kind (P2/P3) DIA operator: the CUDA kernel's wrapper,
its plain PyTorch version and the host packing of the operator.

A P2/P3 DiaOperator (fem.dia_op) couples the typed dof grids of
fem.structured_op.grid_layout (the vertex grid, 7 edge types with k - 1
slots each, 12 face types for P3) by shift-diagonal terms.  For every
output dof (ko, so, z, y, x):

    y = sum_terms field[zone(z), y, x] * x_grid[ki][z+dz, y+dy, x+dx, si]

over the terms of the output (ko, so) in plan order (the first term,
then each next one added), with a source outside its grid read as 0
(tpufem's zero pad of 2 per axis).  ``zone(z)`` picks the z-lo (z < 3),
z-hi (z >= Z - 3) or the broadcast z-mid field plane of a const-mode
term, whose fields are stored as [7, Y, X] rows (lo 0-2, mid 3, hi 4-6);
a grid shorter than 7 planes, or a dense-mode term, has one full [Z, Y,
X] field.  This is tpufem's ``DiaOperator._apply_zones`` for multi-kind
operators (tpufem/fem/dia_op.py:462-546), which XLA runs: tpufem has no
Pallas kernel for it.  P2 has 230 terms over 8 outputs, P3 1311 over 27.

``ZonePack`` holds the operator as the kernel takes it: every term's
fields in one flat buffer, and three int32 tables, kept on the host for
the plain version and on the operator's device for the kernel:

- ``terms`` [T, 8]: (ki, si, dx, dy, dz, field offset, zoned, 0), in
  plan order, grouped by output;
- ``outputs`` [O, 4]: (ko, so, first term, term count) for every (kind,
  slot) of the layout, heaviest first (the kernel's block order);
- ``kinds`` [K, 5]: the layout's (base, X, Y, Z, slots).

The kernel gives a block 256 consecutive points of one output's flattened
(z, y, x) grid, the outputs heaviest first; ``dia_zones_walk`` walks that
plan in plain PyTorch.

``dia_zones_apply`` takes the plain version only for tensors that lie on
the CPU; for a CUDA tensor it launches the kernel of csrc/dia_zones.cu
(one launch an apply, counted in ``dia_zones_apply.launches``) or
raises.  ``prepare_dia_zones`` fixes what does not change between the
applies of one operator and returns the launcher ``x -> y`` that a
DiaOperator keeps.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ZONE_ROWS = 7
_HALO = 3  # z-lo / z-hi zone planes
_PAD = 2   # the widest (dst dim) - (src dim) + shift excursion per axis
MAX_TERMS = 1536  # terms of one output: the kernel stages them (32 B each)
_THREADS = 256  # points of a block (csrc/dia_zones.cu's kThreads)


@dataclasses.dataclass(frozen=True)
class ZonePack:
    """A multi-kind operator as the kernel and its plain version take it
    (module docstring).  ``fields`` and the ``dev_*`` tables lie on the
    operator's device; ``terms``, ``outputs`` and ``kinds`` are their
    host copies."""

    fields: torch.Tensor
    terms: np.ndarray
    outputs: np.ndarray
    kinds: np.ndarray
    dev_terms: torch.Tensor
    dev_outputs: torch.Tensor
    dev_kinds: torch.Tensor

    @property
    def ndofs(self) -> int:
        b, X, Y, Z, s = self.kinds[-1]
        return int(b + X * Y * Z * s)

    @property
    def max_points(self) -> int:
        """The largest output grid, in points."""
        return int(max(X * Y * Z for _, X, Y, Z, _ in self.kinds))


def pack_terms(layout, term_fields, dtype: torch.dtype,
               device: Optional[torch.device] = None) -> ZonePack:
    """Pack ``term_fields``, a sequence of ``((ko, so, ki, si, (dx, dy,
    dz)), fields)`` in plan order with ``fields`` a (lo, mid, hi) triple
    or a one-element (full,) tuple of numpy arrays over the output grid,
    into a ZonePack of ``dtype`` on ``device`` (the CPU if None)."""
    kinds = np.array([(b, X, Y, Z, s) for b, (X, Y, Z), s in layout.kinds],
                     dtype=np.int64)
    by_out = {}
    parts, off = [], 0
    for (ko, so, ki, si, d), fields in term_fields:
        X, Y, Z = kinds[ko, 1:4]
        f = np.concatenate(fields, axis=0)
        zoned = len(fields) == 3
        if f.shape != ((ZONE_ROWS if zoned else Z), Y, X):
            raise ValueError(f"term {(ko, so, ki, si, d)}: fields of shape "
                             f"{f.shape} over a {Z}x{Y}x{X} output grid")
        if zoned and Z < ZONE_ROWS:
            raise ValueError(f"zone fields on a grid of {Z} planes")
        if any(abs(v) > _PAD for v in d):
            raise ValueError(f"shift {d} beyond +-{_PAD}")
        by_out.setdefault((ko, so), []).append(
            (ki, si, d[0], d[1], d[2], off, int(zoned), 0))
        parts.append(f.reshape(-1))
        off += f.size
    if off >= 2 ** 31:
        raise ValueError(f"{off} field values: past the kernel's int32 "
                         "offsets")
    terms, outputs = [], []
    for ko, (_, X, Y, Z, slots) in enumerate(kinds):
        for so in range(slots):
            ts = by_out.pop((ko, so), [])
            if len(ts) > MAX_TERMS:
                raise ValueError(f"output ({ko}, {so}) has {len(ts)} terms "
                                 f"(the kernel stages at most {MAX_TERMS})")
            outputs.append((ko, so, len(terms), len(ts)))
            terms += ts
    if by_out:
        raise ValueError(f"terms for outputs outside the layout: "
                         f"{sorted(by_out)}")
    outputs.sort(key=lambda o: -o[3])  # stable: heaviest first
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    field_buf = (np.concatenate(parts).astype(np_dtype) if parts
                 else np.zeros(0, dtype=np_dtype))
    t = np.array(terms, dtype=np.int32).reshape(-1, 8)
    o = np.array(outputs, dtype=np.int32).reshape(-1, 4)
    k = kinds.astype(np.int32)
    device = device or torch.device("cpu")
    return ZonePack(fields=torch.from_numpy(field_buf).to(device), terms=t,
                    outputs=o, kinds=k,
                    dev_terms=torch.from_numpy(t).to(device),
                    dev_outputs=torch.from_numpy(o).to(device),
                    dev_kinds=torch.from_numpy(k).to(device))


def _check(x: torch.Tensor, pack: ZonePack) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia zones apply takes float32/float64, got "
                        f"{x.dtype}")
    f = pack.fields
    if f.dtype != x.dtype or f.device != x.device:
        raise TypeError(f"fields {f.dtype}@{f.device} do not match x "
                        f"{x.dtype}@{x.device}")
    if not x.is_contiguous() or x.shape != (pack.ndofs,):
        raise ValueError(f"x of shape {tuple(x.shape)} is not a contiguous "
                         f"vector of the layout's {pack.ndofs} dofs")


def dia_zones_apply_plain(x: torch.Tensor, pack: ZonePack) -> torch.Tensor:
    """Plain PyTorch version: each source (kind, slot) grid zero-padded by
    2 per axis, one shifted-slice product per term and zone, summed per
    output in plan order (tpufem's ``_apply_zones``)."""
    m = _HALO
    fields = pack.fields
    src = {}
    y = torch.empty_like(x)
    for ko, so, start, count in pack.outputs:
        base, X, Y, Z, slots = (int(v) for v in pack.kinds[ko])
        acc = None
        for ki, si, dx, dy, dz, off, zoned, _ in pack.terms[start:
                                                           start + count]:
            key = (int(ki), int(si))
            if key not in src:
                bi, Xi, Yi, Zi, si_n = (int(v) for v in pack.kinds[ki])
                g = x[bi: bi + Xi * Yi * Zi * si_n].reshape(Zi, Yi, Xi, si_n)
                src[key] = F.pad(g[..., si], (_PAD,) * 6)
            s = src[key][_PAD + dz: _PAD + dz + Z, _PAD + dy: _PAD + dy + Y,
                         _PAD + dx: _PAD + dx + X]
            if zoned:
                w = fields[off: off + ZONE_ROWS * Y * X].reshape(
                    ZONE_ROWS, Y, X)
                parts = (w[0:m] * s[0:m], w[m: m + 1] * s[m: Z - m],
                         w[m + 1:] * s[Z - m:])
            else:
                parts = (fields[off: off + Z * Y * X].reshape(Z, Y, X) * s,)
            acc = list(parts) if acc is None else [u + v for u, v in
                                                    zip(acc, parts)]
        out = y[base: base + X * Y * Z * slots].view(Z, Y, X, slots)
        out[..., so] = 0.0 if acc is None else torch.cat(acc)
    return y


def dia_zones_walk(x: torch.Tensor, pack: ZonePack
                   ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The kernel's plan walked in plain PyTorch, with its roundings and
    its order: blocks of _THREADS consecutive points of each output's
    flattened (z, y, x) grid (blockIdx.x) for each output in the pack's
    order (blockIdx.y), a block wholly past its output's points skipped;
    each point's sum over the terms in plan order, the first product
    taken as it is and each next one added, the product and the sum
    rounded apart, a source outside its grid read as 0 and the weight
    read at the point's zone row (zone fields) or at the point itself
    (full fields).  Returns (y, counts): ``y`` NaN where no block wrote,
    and the counts of blocks that ran, blocks skipped and points written
    twice."""
    kinds, fields = pack.kinds, pack.fields
    y = torch.full_like(x, float("nan"))
    seen = torch.zeros(x.shape, dtype=torch.bool)
    n = dict(blocks=0, skipped=0, twice=0)
    most = max(int(X * Y * Z) for _, X, Y, Z, _ in kinds)
    for ko, so, start, count in pack.outputs.tolist():
        base, X, Y, Z, slots = (int(v) for v in kinds[ko])
        for p0 in range(0, most, _THREADS):
            if p0 >= X * Y * Z:
                n["skipped"] += 1
                continue
            p = torch.arange(p0, min(p0 + _THREADS, X * Y * Z))
            ix, iy, iz = p % X, p // X % Y, p // (X * Y)
            row = torch.where(iz < _HALO, iz, torch.where(
                iz >= Z - _HALO, ZONE_ROWS - (Z - iz), _HALO))
            zoned_at = (row * Y + iy) * X + ix
            acc = torch.zeros(len(p), dtype=x.dtype)
            for k, (ki, si, dx, dy, dz, off, zoned, _) in enumerate(
                    pack.terms[start: start + count].tolist()):
                bi, Xi, Yi, Zi, sl = (int(v) for v in kinds[ki])
                xs, ys, zs = ix + dx, iy + dy, iz + dz
                ok = ((xs >= 0) & (xs < Xi) & (ys >= 0) & (ys < Yi)
                      & (zs >= 0) & (zs < Zi))
                at = bi + si + ((zs * Yi + ys) * Xi + xs) * sl
                v = torch.where(ok, x[at.clamp(0, x.numel() - 1)],
                                torch.zeros((), dtype=x.dtype))
                t = fields[off + (zoned_at if zoned else p)] * v
                acc = t if k == 0 else acc + t
            at = base + p * slots + so
            n["twice"] += int(seen[at].sum())
            seen[at] = True
            y[at] = acc
            n["blocks"] += 1
    return y, n


def prepare_dia_zones(pack: ZonePack) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on a pack that lies on a CUDA
    device, with the pointers, counts and entry point fixed once; a call
    checks x against them and passes x, y and the stream.  Counts its
    launches in ``dia_zones_apply.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    f = pack.fields
    fn = (lib.tpufem_dia_zones_f32 if f.dtype == torch.float32
          else lib.tpufem_dia_zones_f64)
    max_terms = int(pack.outputs[:, 3].max()) if len(pack.outputs) else 0
    args = _build.DiaZonesLaunch(
        F=f.data_ptr(), terms=pack.dev_terms.data_ptr(),
        outputs=pack.dev_outputs.data_ptr(), kinds=pack.dev_kinds.data_ptr(),
        device=f.device.index, nterms=len(pack.terms),
        nout=len(pack.outputs), nkinds=len(pack.kinds), max_terms=max_terms,
        max_points=pack.max_points)
    addr = ctypes.addressof(args)
    n = pack.ndofs
    what = (f"dia_zones on {len(pack.kinds)} kinds, {len(pack.outputs)} "
            f"outputs, {len(pack.terms)} terms")
    raw_stream = _build.raw_stream_getter()
    dtype, device, index = f.dtype, f.device, f.device.index

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
        dia_zones_apply.launches += 1
        return y

    launch.keep = (args, pack)  # what ``addr`` points into
    return launch


def dia_zones_apply(x: torch.Tensor, pack: ZonePack) -> torch.Tensor:
    """y = A x for a flat x of the pack's layout.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``dia_zones_apply.launches``).  Anything
    else raises."""
    _check(x, pack)
    if x.device.type == "cpu":
        return dia_zones_apply_plain(x, pack)
    if x.device.type != "cuda":
        raise RuntimeError(f"no dia zones kernel for device {x.device}")
    return prepare_dia_zones(pack)(x)


dia_zones_apply.launches = 0
