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

- ``weights`` [E, n, 3, 3]: entry e = (p, lo)'s rows of Ap[p], as
  W[e, li, b, a] = Ap[p][3 lo + a][3 li + b], entries grouped by output;
- ``entries`` [E]: p << 3 | off_lo (the cube offset's x, y, z bits);
- ``outputs`` [O, 5]: (kind, slot, first entry, entry count, lanes G)
  for every (kind, slot) of the layout, heaviest first (the kernel's
  block order); G lanes share an output point, each summing every G-th
  entry (``_lanes``: about 6 entries a lane, so the vertex output's 24
  entries cost a thread what an edge output's 6 do);
- ``sources`` [6 n, 4]: per (p, li), the scalar source index of cube c
  as ``s0 + cz * s1 + cy * s2 + cx * s3``;
- ``kinds`` [K, 5]: the layout's (base, X, Y, Z, slots).

P2 has 60 entries over 8 outputs (4-24 each), P3 120 over 27 (2-24).

``perm_apply`` takes the plain version only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernel of csrc/perm_apply.cu (one
launch an apply, the mask fused, counted in ``perm_apply.launches``) or
raises.  ``prepare_perm_apply`` fixes what does not change between the
applies of one operator and returns the launcher ``x -> y`` that a
StructuredOperator keeps.

The plain version is tpufem's arithmetic (one [3n, 3n] x [3n, Q]
product per perm, the n results added at their slices in perm and plan
order); the kernel sums each output point's entries in plan order, each
entry's 3n products in a fused multiply-add chain.  Both are within (3n
+ E_o) eps sum |terms| of the exact sum, so they agree to twice that
(``perm_apply_bound``), not bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

_THREADS = 256            # csrc/perm_apply.cu:kThreads
_SMEM_LIMIT = 48 * 1024   # static shared memory a block may take
_NLOCAL = (10, 20)        # scalar dofs of a P2 / P3 cell the kernel takes
_MAX_LANES = 8            # lanes sharing an output point: a power of 2


def _lanes(count: int) -> int:
    """Lanes G that share an output point of ``count`` entries: the largest
    power of two up to _MAX_LANES that leaves each lane 6 or more."""
    g = 1
    while 2 * g <= _MAX_LANES and count >= 12 * g:
        g *= 2
    return g


@dataclasses.dataclass(frozen=True)
class PermPack:
    """A blocked per-perm operator as the kernel and its plain version take
    it (module docstring).  ``Ap``, ``weights``, ``mask`` and the ``dev_*``
    tables lie on the operator's device; ``entries``, ``outputs``,
    ``sources`` and ``kinds`` are the host copies."""

    Ap: torch.Tensor        # [6, 3n, 3n]
    weights: torch.Tensor   # [E, n, 3, 3]
    mask: torch.Tensor      # [3 ns] bool, planar
    plan: Tuple             # dof_slice_plan(order)
    dims: Tuple[int, int, int]  # cubes (Nx, Ny, Nz)
    entries: np.ndarray
    outputs: np.ndarray
    sources: np.ndarray
    kinds: np.ndarray
    dev_entries: torch.Tensor
    dev_outputs: torch.Tensor
    dev_sources: torch.Tensor
    dev_kinds: torch.Tensor

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
    def max_blocks(self) -> int:
        """Blocks of the largest output: its points x lanes over a block's
        threads."""
        pts = np.prod(self.kinds[self.outputs[:, 0], 1:4].astype(np.int64),
                      axis=1)
        return int(((pts * self.outputs[:, 4] + _THREADS - 1)
                     // _THREADS).max())

    def smem_bytes(self) -> int:
        """Shared memory a block stages: the source table, and the weights
        and entry codes of the heaviest output."""
        item = self.weights.element_size()
        return (6 * self.n * 16
                + self.max_entries * (9 * self.n * item + 4))


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
    sources = []
    for p in range(6):
        for ki, (ix, iy, iz), si in plan[p]:
            b, X, Y, _, s = kt[ki]
            sX, sY, sZ = s, X * s, Y * X * s
            sources.append((b + si + iz * sZ + iy * sY + ix * sX, sZ, sY,
                            sX))
    by_out = {}
    for p in range(6):
        for lo, (ko, off, so) in enumerate(plan[p]):
            code = (p << 3) | off[0] | (off[1] << 1) | (off[2] << 2)
            by_out.setdefault((ko, so), []).append((code, p, lo))
    A = Ap.reshape(6, n, 3, n, 3)
    entries, outputs, rows = [], [], []
    for ko, (_, _, _, _, slots) in enumerate(kt):
        for so in range(slots):
            es = by_out.pop((ko, so), [])
            outputs.append((ko, so, len(entries), len(es), _lanes(len(es))))
            for code, p, lo in es:
                entries.append(code)
                # W[e, li, b, a] = Ap[p][3 lo + a][3 li + b]
                rows.append(A[p, lo].transpose(1, 2, 0))
    outputs.sort(key=lambda o: -o[3])  # stable: heaviest first
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    e = np.array(entries, dtype=np.int32)
    o = np.array(outputs, dtype=np.int32).reshape(-1, 5)
    s = np.array(sources, dtype=np.int32).reshape(-1, 4)
    k = kt.astype(np.int32)
    device = device or torch.device("cpu")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PermPack(
        Ap=dev(Ap.astype(np_dtype)), weights=dev(np.stack(rows).astype(
            np_dtype)), mask=dev(mask.astype(bool)), plan=tuple(plan),
        dims=tuple(int(v) for v in dims), entries=e, outputs=o, sources=s,
        kinds=k, dev_entries=dev(e), dev_outputs=dev(o), dev_sources=dev(s),
        dev_kinds=dev(k))


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
    args = _build.PermApplyLaunch(
        W=w.data_ptr(), entries=pack.dev_entries.data_ptr(),
        outputs=pack.dev_outputs.data_ptr(),
        sources=pack.dev_sources.data_ptr(),
        kinds=pack.dev_kinds.data_ptr(), mask=pack.mask.data_ptr(),
        device=w.device.index, n=pack.n, ns=pack.ns,
        nout=len(pack.outputs), Nx=Nx, Ny=Ny, Nz=Nz,
        max_entries=pack.max_entries, max_blocks=pack.max_blocks)
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

    launch.keep = (args, pack)  # what ``addr`` points into
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
