"""Apply of the blocked (bs = 3) per-perm element-matrix operator of P2/P3
elasticity: the CUDA kernel's wrapper, its plain PyTorch version and the
host packing of the operator.

Every cube of the Kuhn lattice holds six tetrahedra (perms p), each with
one constant [3n, 3n] element matrix ``Ap[p]`` (dofs interleaved, 3 lo +
a), and every local dof lo of perm p sits on the typed dof grid ``kind``
at the cube offset ``off`` and slot ``slot`` of fem.structured_op's
``dof_slice_plan``.  On planar vectors (component a of scalar dof i at
``a * ns + i``) the BC-eliminated operator is

    y = where(bc, x, A(where(bc, 0, x))),
    (A u)[a, kind_lo, q, slot_lo] += sum_{li, b} Ap[p][3 lo + a][3 li + b]
                                      * u[b, kind_li, c + off_li, slot_li]

over every cube c = q - off_lo of the lattice and every perm p.  This is
tpufem's ``StructuredOperator.apply`` at bs = 3
(tpufem/fem/structured_op.py:263-323, an XLA einsum per perm over
stacked shifted slices; tpufem has no Pallas kernel for it), in the
component-planar layout the port solves in.

``PermPack`` holds the operator as the kernel takes it, with int32
tables kept on the host and on the operator's device:

- ``weights`` [6, 3n, 3n]: W[p, k, r] = Ap[p][r][k], a column of Ap a
  row, so that a thread's 6 rows of a column lie side by side;
- ``entries`` [E]: p << 8 | lo << 3 | off_lo (the cube offset's x, y, z
  bits), grouped by output in plan order;
- ``outputs`` [O, 4]: (kind, slot, first entry, entry count) for every
  (kind, slot) of the layout, heaviest first;
- ``chans`` [C, 5]: per channel, a (kind, slot) pair, (base + slot, X,
  Y, Z, slots): where its values sit in a planar component;
- ``sources`` [6 n]: per (p, li), 3 (ch * 81 + the tile offset of
  off_li): where the source of a cube sits in a brick's tile, relative
  to the cube's own position;
- ``kinds`` [K, 5]: the layout's (base, X, Y, Z, slots).

The first kernel's block owns a brick of 8 x 2 x 2 cubes (``bricks``),
stages the masked source values of its cubes, [C, 3, 3, 9, 3] (a halo of
one position on the high side; the mask is read only in the bricks that
``bc_bricks`` flags), and writes Y[p, :, c] = Ap[p] u(p, c) for them, 6
(P2) or 3 (P3) perms a block, into a scratch [6, 3n, ``y_cubes``]; the
second adds the Y of each output point's entries.  P2 has 60 entries
over 8 outputs (4-24 each) and 8 channels, P3 120 over 27 (2-24) and 27.

``perm_apply`` takes the plain version only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernels of csrc/perm_apply.cu
(the cube products, then the output sums: one launch of the wrapper an
apply, the mask fused, counted in ``perm_apply.launches``) or raises.
``prepare_perm_apply`` fixes what does not change between the applies
of one operator and returns the launcher ``x -> y`` that a
StructuredOperator keeps.

The plain version is tpufem's arithmetic (one [3n, 3n] x [3n, Q]
product per perm, the n results added at their slices in perm and plan
order); the kernel takes each Y value as a fused multiply-add chain of
its 3n products and sums each output point's entries in plan order.
Both are within (3n + E_o) eps sum |terms| of the exact sum, so they
agree to twice that (``perm_apply_bound``), not bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

_NLOCAL = (10, 20)        # scalar dofs of a P2 / P3 cell the kernel takes
_BRICK = (8, 2, 2)        # csrc/perm_apply.cu:kCX, kCY, kCZ: cubes a block
_TILE = tuple(b + 1 for b in _BRICK)      # positions: a high-side halo
_TILE_VOL = int(np.prod(_TILE))           # csrc/perm_apply.cu:kTileVol
_SMEM_LIMIT = 232448      # shared memory a block may take on sm_90
_PERMS = {10: 6, 20: 3}   # csrc/perm_apply.cu:Tiling::kPerms, perms a block


def _tile_offset(off) -> int:
    dx, dy, dz = off
    return (dz * _TILE[1] + dy) * _TILE[0] + dx


@dataclasses.dataclass(frozen=True)
class PermPack:
    """A blocked per-perm operator as the kernel and its plain version take
    it (module docstring).  ``Ap``, ``weights``, ``mask`` and the ``dev_*``
    tables lie on the operator's device; ``entries``, ``outputs``,
    ``sources``, ``kinds`` and ``chans`` are the host copies."""

    Ap: torch.Tensor        # [6, 3n, 3n]
    weights: torch.Tensor   # [6, 3n, 3n]: Ap transposed
    mask: torch.Tensor      # [3 ns] bool, planar
    plan: Tuple             # dof_slice_plan(order)
    dims: Tuple[int, int, int]  # cubes (Nx, Ny, Nz)
    entries: np.ndarray
    outputs: np.ndarray
    sources: np.ndarray
    kinds: np.ndarray
    chans: np.ndarray
    bc_bricks: np.ndarray
    dev_entries: torch.Tensor
    dev_outputs: torch.Tensor
    dev_sources: torch.Tensor
    dev_kinds: torch.Tensor
    dev_chans: torch.Tensor
    dev_bc_bricks: torch.Tensor

    @property
    def n(self) -> int:
        """Scalar dofs of a cell."""
        return len(self.plan[0])

    @property
    def ns(self) -> int:
        """Scalar dofs of the layout (a planar vector has 3 ns)."""
        b, X, Y, Z, s = self.kinds[-1]
        return int(b + X * Y * Z * s)

    @property
    def max_entries(self) -> int:
        return int(self.outputs[:, 3].max())

    @property
    def max_points(self) -> int:
        """Points of the largest output grid."""
        return int(np.prod(self.kinds[self.outputs[:, 0], 1:4],
                           axis=1).max())

    @property
    def bricks(self) -> Tuple[int, int, int]:
        """Bricks of 8 x 2 x 2 cubes along x, y, z (the last ones may hang
        past the lattice)."""
        return _bricks(self.dims)

    @property
    def y_cubes(self) -> int:
        """Cubes of the scratch Y: the bricks' cubes."""
        return int(np.prod(self.bricks) * np.prod(_BRICK))

    def smem_bytes(self, item: Optional[int] = None) -> int:
        """Shared memory a block of the first kernel takes: the source
        table and the tile [C, 3, 3, 9, 3] (to 16 bytes), and the element
        matrices of its perms, of ``item``-byte values (the pack's own)."""
        item = item or self.weights.element_size()
        head = -(-(6 * self.n * 4 + len(self.chans) * 3 * _TILE_VOL * item)
                 // 16) * 16
        return head + _PERMS[self.n] * (3 * self.n) ** 2 * item


def _bricks(dims) -> Tuple[int, int, int]:
    return tuple(-(-d // b) for d, b in zip(dims, _BRICK))


def _bc_bricks(mask: np.ndarray, chans: Sequence, ns: int,
               dims) -> np.ndarray:
    """Per brick, 1 where its tile holds a Dirichlet dof of the planar
    ``mask``: the kernel reads the mask only there."""
    bx, by, bz = _bricks(dims)
    flag = np.zeros((bz, by, bx), dtype=np.uint8)
    i = np.nonzero(mask.reshape(3, ns).any(axis=0))[0]
    for b0, X, Y, Z, slots in chans:  # b0: the base plus the slot
        mine = i[(i >= b0) & (i < b0 + X * Y * Z * slots)
                 & ((i - b0) % slots == 0)]
        pos = (mine - b0) // slots
        g = (pos % X, (pos // X) % Y, pos // (X * Y))
        # a tile holds positions [B k, B k + B]: g lies in brick g // B
        # and, on the brick's low face, in (g - 1) // B too
        for d in np.ndindex(2, 2, 2):
            k = [(gd - dd) // B for gd, dd, B in zip(g, d, _BRICK)]
            ok = ((k[0] >= 0) & (k[0] < bx) & (k[1] >= 0) & (k[1] < by)
                  & (k[2] >= 0) & (k[2] < bz))
            flag[k[2][ok], k[1][ok], k[0][ok]] = 1
    return flag.reshape(-1)


def pack_perm(Ap: np.ndarray, plan: Sequence, kinds: Sequence,
              dims: Tuple[int, int, int], mask: np.ndarray,
              dtype: torch.dtype,
              device: Optional[torch.device] = None) -> PermPack:
    """Pack the blocked element matrices ``Ap`` [6, 3n, 3n] of a layout
    (``kinds`` as fem.structured_op.GridLayout.kinds, ``plan`` its
    ``dof_slice_plan``, ``dims`` the cubes) and the planar Dirichlet
    ``mask`` [3 ns] into a PermPack of ``dtype`` on ``device`` (the CPU
    if None)."""
    n = len(plan[0])
    if Ap.shape != (6, 3 * n, 3 * n):
        raise ValueError(f"element matrices {Ap.shape}, expected "
                         f"(6, {3 * n}, {3 * n})")
    kt = np.array([(b, X, Y, Z, s) for b, (X, Y, Z), s in kinds],
                  dtype=np.int64)
    ns = int(kt[-1, 0] + np.prod(kt[-1, 1:4]) * kt[-1, 4])
    if mask.shape != (3 * ns,):
        raise ValueError(f"mask of {mask.shape} for {3 * ns} planar dofs")
    if 3 * ns >= 2 ** 31:
        raise ValueError(f"{3 * ns} dofs: past the kernel's int32 indices")
    chan_of, chans = {}, []
    for ki, (b, X, Y, Z, slots) in enumerate(kt):
        for si in range(slots):
            chan_of[ki, si] = len(chans)
            chans.append((b + si, X, Y, Z, slots))
    sources = [3 * (chan_of[ki, si] * _TILE_VOL + _tile_offset(off))
               for p in range(6) for ki, off, si in plan[p]]
    by_out = {}
    for p in range(6):
        for lo, (ko, off, so) in enumerate(plan[p]):
            code = ((p << 8) | (lo << 3) | off[0] | (off[1] << 1)
                    | (off[2] << 2))
            by_out.setdefault((ko, so), []).append(code)
    entries, outputs = [], []
    for ko, (_, _, _, _, slots) in enumerate(kt):
        for so in range(slots):
            es = by_out.pop((ko, so), [])
            outputs.append((ko, so, len(entries), len(es)))
            entries += es
    outputs.sort(key=lambda o: -o[3])  # stable: heaviest first
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    e = np.array(entries, dtype=np.int32)
    o = np.array(outputs, dtype=np.int32).reshape(-1, 4)
    s = np.array(sources, dtype=np.int32)
    k = kt.astype(np.int32)
    c = np.array(chans, dtype=np.int32).reshape(-1, 5)
    bc = _bc_bricks(mask, chans, ns, dims)
    device = device or torch.device("cpu")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PermPack(
        Ap=dev(Ap.astype(np_dtype)),
        weights=dev(Ap.transpose(0, 2, 1).astype(np_dtype)),
        mask=dev(mask.astype(bool)), plan=tuple(plan),
        dims=tuple(int(v) for v in dims), entries=e, outputs=o, sources=s,
        kinds=k, chans=c, bc_bricks=bc, dev_entries=dev(e),
        dev_outputs=dev(o), dev_sources=dev(s), dev_kinds=dev(k),
        dev_chans=dev(c), dev_bc_bricks=dev(bc))


def _check(x: torch.Tensor, pack: PermPack) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"perm apply takes float32/float64, got {x.dtype}")
    w = pack.weights
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"weights {w.dtype}@{w.device} do not match x "
                        f"{x.dtype}@{x.device}")
    if not x.is_contiguous() or x.shape != (3 * pack.ns,):
        raise ValueError(f"x of shape {tuple(x.shape)} is not a contiguous "
                         f"planar vector of {3 * pack.ns} dofs")


def per_perm_apply(u: torch.Tensor, Ap: torch.Tensor, plan: Sequence,
                   kinds: Sequence, dims: Tuple[int, int, int]
                   ) -> torch.Tensor:
    """A u without Dirichlet rows for the element matrices ``Ap`` [6, n bs,
    n bs] of a layout (``kinds`` rows (base, X, Y, Z, slots), ``plan`` its
    dof_slice_plan, ``dims`` the cubes), on u [bs ns] in planar component
    order (bs = 1: a scalar vector): per perm the n shifted slices of the
    bs component grids stacked to [n bs, Q], one ``torch.matmul`` with
    Ap[p] (float32 at full precision), the n results added at their
    slices (tpufem's order)."""
    Nx, Ny, Nz = dims
    n = len(plan[0])
    bs = Ap.shape[1] // n
    ur = u.reshape(bs, -1)
    grids = [ur[:, b: b + X * Y * Z * s].reshape(bs, Z, Y, X, s)
             for b, X, Y, Z, s in kinds]
    out = [torch.zeros_like(g) for g in grids]
    for p in range(6):
        cols = torch.stack([grids[kind][:, dz: dz + Nz, dy: dy + Ny,
                                        dx: dx + Nx, slot]
                            for kind, (dx, dy, dz), slot in plan[p]])
        y = torch.matmul(Ap[p], cols.reshape(n * bs, -1))
        y = y.reshape(cols.shape)
        for lo, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
            out[kind][:, dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += y[lo]
    return torch.cat([o.reshape(bs, -1) for o in out], dim=1).reshape(-1)


def perm_apply_plain(x: torch.Tensor, pack: PermPack) -> torch.Tensor:
    """Plain PyTorch version: y = where(bc, x, A(where(bc, 0, x)))."""
    y = per_perm_apply(torch.where(pack.mask, 0.0, x), pack.Ap, pack.plan,
                       pack.kinds, pack.dims)
    return torch.where(pack.mask, x, y)


def perm_apply_bound(x: torch.Tensor, pack: PermPack) -> torch.Tensor:
    """How far the kernel and the plain version may sit apart on x, per
    output: each is within (3n + E_o) eps sum |terms| of the exact sum
    (3n products in an entry's partial sum, at most E_o partial sums), so
    twice that, with sum |terms| = |A| |where(bc, 0, x)| (0 on the
    Dirichlet rows, where both return x)."""
    u = torch.where(pack.mask, 0.0, x).abs()
    y = per_perm_apply(u, pack.Ap.abs(), pack.plan, pack.kinds, pack.dims)
    eps = torch.finfo(x.dtype).eps
    terms = 3 * pack.n + pack.max_entries
    return torch.where(pack.mask, 0.0, 2 * terms * eps * y)


def prepare_perm_apply(pack: PermPack) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """A launcher ``x -> y`` of the kernel on a pack that lies on a CUDA
    device, with the pointers, counts and entry point fixed once; a call
    checks x against them and passes x, y and the stream.  Counts its
    launches in ``perm_apply.launches``."""
    from tpufem_torch import _build
    lib = _build.load().lib
    w = pack.weights
    if pack.n not in _NLOCAL:
        raise ValueError(f"perm apply kernel: cells of {pack.n} scalar dofs "
                         f"(it takes {_NLOCAL})")
    if pack.smem_bytes() > _SMEM_LIMIT:
        raise ValueError(f"perm apply kernel: {pack.smem_bytes()} bytes of "
                         f"shared memory a block, past {_SMEM_LIMIT}")
    fn = (lib.tpufem_perm_apply_f32 if w.dtype == torch.float32
          else lib.tpufem_perm_apply_f64)
    Nx, Ny, Nz = pack.dims
    bx, by, bz = pack.bricks
    Y = torch.empty(6 * 3 * pack.n * pack.y_cubes, dtype=w.dtype,
                    device=w.device)
    args = _build.PermApplyLaunch(
        W=w.data_ptr(), Y=Y.data_ptr(), entries=pack.dev_entries.data_ptr(),
        outputs=pack.dev_outputs.data_ptr(),
        sources=pack.dev_sources.data_ptr(),
        kinds=pack.dev_kinds.data_ptr(), chans=pack.dev_chans.data_ptr(),
        mask=pack.mask.data_ptr(), bc=pack.dev_bc_bricks.data_ptr(),
        device=w.device.index, n=pack.n,
        ns=pack.ns, nout=len(pack.outputs), nchan=len(pack.chans), Nx=Nx,
        Ny=Ny, Nz=Nz, bx=bx, by=by, bz=bz, max_points=pack.max_points)
    addr = ctypes.addressof(args)
    nd = 3 * pack.ns
    what = (f"perm_apply on {Nx}x{Ny}x{Nz} cubes, {len(pack.outputs)} "
            f"outputs, {len(pack.entries)} entries")
    raw_stream = _build.raw_stream_getter()
    dtype, device, index = w.dtype, w.device, w.device.index

    def launch(x: torch.Tensor) -> torch.Tensor:
        if (x.dtype != dtype or x.device != device or x.shape != (nd,)
                or not x.is_contiguous()):
            raise ValueError(f"{what}: x is {tuple(x.shape)} {x.dtype}@"
                             f"{x.device}, expected a contiguous ({nd},) "
                             f"{dtype}@{device}")
        y = torch.empty_like(x)
        rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
        if rc != 0:
            _build.raise_on(lib, rc, what)
        perm_apply.launches += 1
        return y

    launch.keep = (args, pack, Y)  # what ``addr`` points into
    return launch


def perm_apply(x: torch.Tensor, pack: PermPack) -> torch.Tensor:
    """y = where(bc, x, A(where(bc, 0, x))) for a planar x [3 ns].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``perm_apply.launches``).  Anything else
    raises."""
    _check(x, pack)
    if x.device.type == "cpu":
        return perm_apply_plain(x, pack)
    if x.device.type != "cuda":
        raise RuntimeError(f"no perm apply kernel for device {x.device}")
    return prepare_perm_apply(pack)(x)


perm_apply.launches = 0
